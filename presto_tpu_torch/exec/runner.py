"""LocalQueryRunner: SQL string -> results, single process, one device.

The port of presto_tpu/exec/runner.py's main path: parse -> plan ->
parameterize -> canonical plan cache -> optimize -> PlanCompiler ->
result pages (execute), the same with the rows decoded page by page as
they are produced (execute_streaming, the statement server's path),
EXPLAIN's plan text, EXPLAIN ANALYZE (the plan annotated with per-node
operator stats: rows, host walls, batches, estimated bytes, and the
footer's kernel and driver counters) and EXPLAIN (TYPE VALIDATE) (the
plan checker's diagnostics at every stage); DistributedQueryRunner /
BatchQueryRunner run the fragmented plan as stages of tasks through
exec/scheduler.py.  The runners run on the card by default; tests pass
device="cpu", where every kernel wrapper runs its plain torch version.
Asking for the card where CUDA is absent raises: the runner never moves
to the CPU on its own.  PREPARE / EXECUTE / DEALLOCATE run over the
port's prepared-statement registry (serving/prepared.py: a repeat
EXECUTE skips parse, plan and optimize), execute_prepared_batch runs
concurrent EXECUTEs of one template as one batched drain
(serving/batched.py), and CREATE TABLE AS / INSERT / DROP TABLE write a
writable connector (connectors/memory.py) through the TableWriter /
TableFinish pipeline, clearing every cached plan, fast path and shared
fragment.  A `tracer_provider` records the query's spans (the scheduler's
fragment, task and operator spans under the runner's `query` span), and a
`history` store (telemetry/history.py) records each successful run keyed
on its canonical plan template: with adaptive_history_sizing on, a repeat
of the template sizes its aggregation table (and, distributed, its hash
stages' task count) from what the last run observed.
DistributedQueryRunner(mesh=...) runs eligible hashed edges as the device
exchange over the mesh's positions (the "ici" fabric).
"""
from __future__ import annotations

import itertools
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Dict, List, Optional

import time

import torch

from ..common.block import block_to_values
from ..sql.planner import Planner
from .pipeline import (ExecutionConfig, PlanCompiler, TaskContext,
                       settle_node_stats, tuned_config)


@dataclass
class QueryResult:
    column_names: List[str]
    column_types: List
    rows: List[List]
    runtime_stats: dict = None
    peak_memory_bytes: int = 0
    # statement-protocol side channel: PREPARE sets (name, text) so the
    # server can answer with X-Presto-Added-Prepare; DEALLOCATE the name
    added_prepare: tuple = None
    deallocated_prepare: str = None
    # the profiler capture's directory when the `profile` session
    # property was set (telemetry/profiler.py); None when not captured
    profile_trace_dir: Optional[str] = None

    def sorted_rows(self):
        return sorted(self.rows, key=lambda r: tuple(
            (v is None, str(type(v)), v) for v in r))


def plan_template_digest(template_sk) -> str:
    """Stable short digest of a parameterized plan's structural key -- the
    join key between a query-history record ("planTemplate") and a later
    run of the same canonical plan (adaptive.history-sizing)."""
    import hashlib
    return hashlib.sha256(repr(template_sk).encode()).hexdigest()[:16]


_history_qid = itertools.count()


def pages_to_result(pages, names, types) -> "QueryResult":
    """Decode host pages into a QueryResult row list."""
    rows: List[List] = []
    for page in pages:
        cols = [block_to_values(t, b) for t, b in zip(types, page.blocks)]
        for i in range(page.position_count):
            rows.append([c[i] for c in cols])
    return QueryResult(names, types, rows)


def resolve_device(device) -> torch.device:
    """The explicit device a runner computes on.  "cuda" without CUDA
    raises instead of moving to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but CUDA is not available; pass "
                "device='cpu' to run the plain torch versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


@dataclass
class _Execution:
    """One checked-out canonical-cache execution: the optimized template,
    an exclusively-owned compiler, and how to give both back."""
    output: object
    compiler: PlanCompiler
    key: str
    fresh: bool                         # miss: insert; hit: checkin
    slot_types: list


class LocalQueryRunner:
    def __init__(self, schema: str = "sf0.01",
                 config: Optional[ExecutionConfig] = None,
                 catalog: str = "tpch", plan_cache=None, device="cuda",
                 tracer_provider=None, history=None):
        from ..serving import PlanCache
        self.schema = schema
        self.catalog = catalog
        self.device = resolve_device(device)
        self.config = config or tuned_config()
        self.tracer_provider = tracer_provider   # utils.runtime_stats
        # optional telemetry.history.QueryHistoryStore: successful runs
        # record template-keyed observations, and -- when the
        # adaptive.history-sizing knob is on -- a repeat of the same plan
        # template seeds its aggregation-table size from the record
        self.history = history
        self._last_template_digest: Optional[str] = None
        # the runner's OWN canonical plan cache: a process-global cache
        # would hand this runner another package's compiler on a key
        # collision
        self.plan_cache = plan_cache if plan_cache is not None \
            else PlanCache()
        # session-scoped prepared statements (name -> SQL text); the HTTP
        # path passes its header map per call instead
        self._prepared: Dict[str, str] = {}
        # EXPLAIN ANALYZE's side channel: node id -> operator stats of the
        # most recent analyzed execution
        self.last_operator_stats: Optional[dict] = None
        # the oracle's per-node stats of the last execute_reference
        self.last_reference_operator_stats: Optional[dict] = None

    def _validation(self):
        from ..analysis import use_validation_mode
        return use_validation_mode(self.config.plan_validation)

    def plan(self, sql: str):
        with self._validation():
            return Planner(default_schema=self.schema,
                           default_catalog=self.catalog).plan(sql)

    def _new_compiler(self, config: Optional[ExecutionConfig] = None
                      ) -> PlanCompiler:
        return PlanCompiler(TaskContext(config=config or self.config,
                                        device=self.device))

    def _checkout(self, ast, stats, bound_params=None,
                  record_fast=None) -> _Execution:
        """Plan `ast` to the parameterized template, then check the
        canonical cache: a hit skips optimize and reuses a pooled
        compiler; a miss optimizes and builds one.  `bound_params` are an
        EXECUTE's USING values, bound into the planner; `record_fast`
        takes the statement's fast-path record (serving/prepared.py)."""
        from ..serving import SERVING_METRICS
        from ..spi import plan as P
        from ..sql.canonical import cache_key_from_parts, parameterize
        with stats.record_wall("queryPlan"), self._validation():
            planner = Planner(default_schema=self.schema,
                              default_catalog=self.catalog,
                              bound_params=bound_params)
            unopt = planner.plan_query_unoptimized(ast)
        pp = parameterize(unopt)
        # structural key taken BEFORE optimization (the optimizer mutates
        # the template in place): the prepared fast path re-derives it
        template_sk = P.structural_key(pp.template)
        self._last_template_digest = plan_template_digest(template_sk)
        # adaptive.history-sizing: the effective config may carry the
        # prior run's observed group count -- a fingerprinted field, so
        # the cache key below re-keys on a changed hint
        cfg = self._history_sized_config()
        key = cache_key_from_parts(template_sk, cfg, self.catalog,
                                   self.schema)
        hit = self.plan_cache.checkout(key)
        if hit is not None:
            output, slot_types, compiler = hit
            if compiler is None:
                compiler = self._new_compiler(cfg)
                SERVING_METRICS.incr("executable_builds")
            exe = _Execution(output, compiler, key, False, list(slot_types))
        else:
            with stats.record_wall("queryOptimize"), self._validation():
                output = Planner.optimize_output(pp.template)
            compiler = self._new_compiler(cfg)
            SERVING_METRICS.incr("executable_builds")
            exe = _Execution(output, compiler, key, True,
                             [s.type for s in pp.slots])
        if record_fast is not None and pp.origins_complete:
            from ..serving.prepared import FastPath
            record_fast(FastPath(
                template_sk,
                [(s.origin, s.type,
                  None if s.origin is not None else s.value)
                 for s in pp.slots]))
        self._bind(exe, [s.value for s in pp.slots])
        return exe

    def _bind(self, exe: _Execution, values) -> None:
        from ..sql.canonical import device_params
        if exe.slot_types:
            dev, host = device_params(values, exe.slot_types, self.device)
            exe.compiler.ctx.params = dev
            exe.compiler.ctx.params_fingerprint = host
        else:
            exe.compiler.ctx.params = None
            exe.compiler.ctx.params_fingerprint = None

    def _release(self, exe: _Execution) -> None:
        """Return the compiler to the cache after a successful run."""
        if exe.fresh:
            self.plan_cache.insert(exe.key, exe.output, exe.slot_types,
                                   exe.compiler)
        else:
            self.plan_cache.checkin(exe.key, exe.compiler)

    # -- history-based sizing (adaptive.history-sizing) -------------------

    def _history_record(self) -> Optional[dict]:
        if (self.history is None or self._last_template_digest is None
                or not self.config.adaptive_history_sizing):
            return None
        return self.history.find_by_template(self._last_template_digest)

    def _history_sized_config(self) -> ExecutionConfig:
        """A prior FINISHED run of the same plan template seeds the
        aggregation table size: the observed group count replaces the
        optimizer's estimate (exec/pipeline.py _compile_AggregationNode)."""
        rec = self._history_record()
        groups = (rec or {}).get("aggGroups")
        if not groups:
            return self.config
        import dataclasses

        from .adaptive import ADAPTIVE_METRICS
        ADAPTIVE_METRICS.incr("history_sized_queries")
        return dataclasses.replace(self.config,
                                   history_agg_groups=int(groups))

    def _record_history(self, result: QueryResult, root,
                        subplan=None) -> None:
        """Record one template-keyed observation after a successful run.
        aggGroups is recorded only when the output chain is
        Output -> (Project|Sort)* -> grouped Aggregation, where the
        result row count IS the observed group count."""
        if self.history is None or self._last_template_digest is None:
            return
        from ..spi import plan as P
        node = getattr(root, "source", None)
        while isinstance(node, (P.ProjectNode, P.SortNode,
                                P.RemoteSourceNode)):
            if isinstance(node, P.RemoteSourceNode):
                # distributed: the chain continues in the (sole) child
                # fragment feeding this gather edge
                if subplan is None or len(node.source_fragment_ids) != 1:
                    break
                by_id = {c.fragment.fragment_id: c
                         for c in subplan.children}
                child = by_id.get(node.source_fragment_ids[0])
                if child is None:
                    break
                subplan, node = child, child.fragment.root
            else:
                node = node.source
        rec = {"queryId": f"run-{next(_history_qid)}",
               "state": "FINISHED",
               "planTemplate": self._last_template_digest,
               "rows": len(result.rows),
               "peakMemoryBytes": getattr(result, "peak_memory_bytes",
                                          0) or 0}
        if isinstance(node, P.AggregationNode) and node.grouping_keys:
            rec["aggGroups"] = len(result.rows)
        try:
            self.history.record(rec)
        except Exception:   # noqa: BLE001 -- history is advisory
            pass

    def _parse(self, sql: str, stats):
        """The statement's AST, its parse wall recorded."""
        from ..sql import parser as A
        with stats.record_wall("queryParse"):
            return A.parse_sql(sql)

    # -- prepared statements ----------------------------------------------

    def _checkout_cached(self, key: str) -> Optional[_Execution]:
        """A canonical-cache hit under `key` as an _Execution (None on a
        miss); a hit whose pooled compilers are all out builds one."""
        from ..serving import SERVING_METRICS
        hit = self.plan_cache.checkout(key)
        if hit is None:
            return None
        output, slot_types, compiler = hit
        if compiler is None:
            compiler = self._new_compiler()
            SERVING_METRICS.incr("executable_builds")
        return _Execution(output, compiler, key, False, list(slot_types))

    def _prepared_text(self, name: str, prepared) -> str:
        text = (prepared or {}).get(name) or self._prepared.get(name)
        if text is None:
            raise KeyError(f"prepared statement {name!r} does not exist")
        return text

    def _execute_prepared(self, ast, stats, prepared) -> _Execution:
        """EXECUTE name USING v1, ... -> a ready _Execution.  The fast
        path (statement seen before, all origins extracted) rebuilds the
        cache key from the recorded slots and skips parse and plan; any
        mismatch -- an unbindable value, NULL, a cold cache (this
        runner's own PlanCache) -- replans with the USING values bound
        into the planner."""
        from ..serving import PREPARED_REGISTRY, SERVING_METRICS
        from ..sql.canonical import (BindError, cache_key_from_parts,
                                     literal_value)
        text = self._prepared_text(ast.name, prepared)
        ps = PREPARED_REGISTRY.get_or_parse(text)
        if len(ast.values) != ps.param_count:
            raise ValueError(
                f"prepared statement {ast.name!r} expects "
                f"{ps.param_count} parameters, got {len(ast.values)}")
        fast = ps.fast
        if fast is not None:
            try:
                values = fast.bind([literal_value(v) for v in ast.values])
            except BindError:
                values = None
            if values is not None:
                self._last_template_digest = \
                    plan_template_digest(fast.template_key)
                exe = self._checkout_cached(cache_key_from_parts(
                    fast.template_key, self.config, self.catalog,
                    self.schema))
                if exe is not None:
                    self._bind(exe, values)
                    SERVING_METRICS.incr("prepared_fast_path")
                    return exe
        # full pipeline with the USING values bound into the planner;
        # record the fast path for the NEXT execution of this statement
        SERVING_METRICS.incr("prepared_replans")
        return self._checkout(ps.statement, stats,
                              bound_params=list(ast.values),
                              record_fast=ps.record_fast_path)

    # -- micro-batched execution ------------------------------------------

    def execute_prepared_batch(self, sqls: List[str], prepared=None
                               ) -> Optional[List[Optional[QueryResult]]]:
        """Execute N concurrent EXECUTE..USING statements that share one
        prepared template as ONE batched drain (serving/batched.py).

        `prepared` is a name->text map, or a list of such maps aligned
        with `sqls` (the HTTP path carries per-request header maps).
        Returns a list aligned with `sqls` -- a QueryResult for every
        lane the drain served, None for lanes the caller must run solo
        (bind errors, NULLs, arity mismatches: their solo run raises or
        replans as it should) -- or None when no batch was possible at
        all (a cold template, a plan outside the batched envelope, a
        cache miss).  Every returned lane's rows are bit-identical to its
        solo run."""
        from ..serving import PREPARED_REGISTRY, SERVING_METRICS
        from ..serving.batched import batched_runner_for, disable_for
        from ..sql import parser as A
        from ..sql.canonical import (BindError, cache_key_from_parts,
                                     device_params, literal_value)
        if len(sqls) < 2:
            return None
        pmaps = (list(prepared) if isinstance(prepared, (list, tuple))
                 else [prepared] * len(sqls))
        text = None
        asts = []
        try:
            for s, pm in zip(sqls, pmaps):
                ast = A.parse_sql(s)
                if not isinstance(ast, A.ExecuteStmt):
                    return None
                t = self._prepared_text(ast.name, pm)
                if text is None:
                    text = t
                elif t != text:
                    return None     # mixed templates: not one batch
                asts.append(ast)
        except Exception:   # noqa: BLE001 -- unknown name etc: solo runs
            return None
        ps = PREPARED_REGISTRY.get_or_parse(text)
        fast = ps.fast
        if fast is None:
            return None             # cold: a solo run records the path
        values_by_lane: List[Optional[list]] = [None] * len(sqls)
        for i, ast in enumerate(asts):
            if len(ast.values) != ps.param_count:
                continue            # isolated arity error -> solo run
            try:
                raw = [literal_value(v) for v in ast.values]
                values_by_lane[i] = fast.bind(raw)
            except BindError:
                continue            # isolated bind error -> solo run
        lanes = [i for i, v in enumerate(values_by_lane) if v is not None]
        if len(lanes) < 2:
            return None
        exe = self._checkout_cached(cache_key_from_parts(
            fast.template_key, self.config, self.catalog, self.schema))
        if exe is None:
            return None
        output, compiler = exe.output, exe.compiler
        if not exe.slot_types:
            self._release(exe)
            return None
        self._bind(exe, values_by_lane[lanes[0]])
        runner = batched_runner_for(compiler, output)
        if runner is None:
            self._release(exe)
            return None
        try:
            pages, launch_ns, demux_ns = runner.run(
                [device_params(values_by_lane[i], exe.slot_types,
                               self.device) for i in lanes])
        except Exception:   # noqa: BLE001 -- the whole drain failed: the
            # compiler may be poisoned (not returned to the pool) and the
            # template is pinned sequential; every lane re-runs solo
            disable_for(compiler)
            return None
        self._last_template_digest = plan_template_digest(
            fast.template_key)
        names = output.column_names
        types = [v.type for v in output.outputs]
        results: List[Optional[QueryResult]] = [None] * len(sqls)
        width = 1 << max(0, len(lanes) - 1).bit_length()
        for j, i in enumerate(lanes):
            res = pages_to_result([pages[j]], names, types)
            res.peak_memory_bytes = compiler.ctx.memory.peak
            res.runtime_stats = {
                "servingBatchOccupancy": {"sum": len(lanes), "unit": "NONE"},
                "servingBatchLaunchNanos": {"sum": launch_ns,
                                            "unit": "NANO"},
            }
            results[i] = res
            SERVING_METRICS.incr("prepared_fast_path")
            self._record_history(res, output)
        self._release(exe)
        SERVING_METRICS.record_batch(len(lanes), demux_ns,
                                     padded_lanes=width - len(lanes))
        return results

    # -- execution --------------------------------------------------------

    def execute(self, sql: str, prepared: Optional[Dict[str, str]] = None
                ) -> QueryResult:
        """Run one statement to a materialized QueryResult.  `prepared`
        is the client's prepared-statement map (name -> text, the HTTP
        path's headers)."""
        from ..common.types import BOOLEAN
        from ..serving import PREPARED_REGISTRY
        from ..sql import parser as A
        from ..utils.runtime_stats import RuntimeStats
        stats = RuntimeStats()
        tracer = self.tracer_provider.new_tracer(sql) \
            if self.tracer_provider else None
        ast = self._parse(sql, stats)
        if tracer:
            tracer.add_point("query parsed")
        if isinstance(ast, A.Explain):
            return self._explain(ast)
        if isinstance(ast, (A.CreateTableAs, A.InsertInto, A.DropTable)):
            return self._execute_ddl(ast)
        if isinstance(ast, A.Prepare):
            self._prepared[ast.name] = ast.text
            PREPARED_REGISTRY.get_or_parse(ast.text)   # warm the memo
            res = QueryResult(["result"], [BOOLEAN], [[True]])
            res.added_prepare = (ast.name, ast.text)
            return res
        if isinstance(ast, A.Deallocate):
            self._prepared.pop(ast.name, None)
            res = QueryResult(["result"], [BOOLEAN], [[True]])
            res.deallocated_prepare = ast.name
            return res
        if isinstance(ast, A.ExecuteStmt):
            exe = self._execute_prepared(ast, stats, prepared)
        else:
            exe = self._checkout(ast, stats)
        if tracer:
            tracer.add_point("query planned")
        output, compiler = exe.output, exe.compiler
        names = output.column_names
        types = [v.type for v in output.outputs]
        compiler.ctx.runtime_stats = stats
        from ..telemetry import profile_capture
        with (tracer.span("query", sql=sql) if tracer else nullcontext()):
            with profile_capture(self.config.profile_dir, "query",
                                 enabled=self.config.profile) as trace_dir:
                with stats.record_wall("queryExecute"):
                    result = pages_to_result(compiler.run_to_pages(output),
                                             names, types)
        result.profile_trace_dir = trace_dir
        result.runtime_stats = stats.to_dict()
        result.peak_memory_bytes = compiler.ctx.memory.peak
        if tracer:
            tracer.end_trace("query finished")
        self._release(exe)
        self._record_history(result, output)
        return result

    def execute_streaming(self, sql: str,
                          prepared: Optional[Dict[str, str]] = None):
        """(columns-meta, row iterator, RuntimeStats) for a SELECT or an
        EXECUTE: pages are decoded and yielded as they are produced, so
        callers (the statement protocol) never hold the full result set
        (reference Query.java:116 streams from the root-stage
        ExchangeClient).  Returns None for the statements that need
        materialized execution (EXPLAIN, DDL, PREPARE, DEALLOCATE)."""
        from ..sql import parser as A
        from ..utils.runtime_stats import RuntimeStats
        stats = RuntimeStats()
        ast = self._parse(sql, stats)
        if isinstance(ast, (A.Explain, A.CreateTableAs, A.InsertInto,
                            A.DropTable, A.Prepare, A.Deallocate)):
            return None
        if isinstance(ast, A.ExecuteStmt):
            exe = self._execute_prepared(ast, stats, prepared)
        else:
            exe = self._checkout(ast, stats)
        output, compiler = exe.output, exe.compiler
        names = output.column_names
        types = [v.type for v in output.outputs]
        compiler.ctx.runtime_stats = stats
        columns = [{"name": n, "type": str(t)}
                   for n, t in zip(names, types)]

        def rows():
            with stats.record_wall("queryExecute"):
                for page in compiler.run_to_pages(output):
                    cols = [block_to_values(t, b)
                            for t, b in zip(types, page.blocks)]
                    for i in range(page.position_count):
                        yield [c[i] for c in cols]
            # release only after a fully successful drain (as execute)
            self._release(exe)
        return columns, rows(), stats

    # -- writes -----------------------------------------------------------

    def _execute_ddl(self, ast) -> QueryResult:
        """CREATE TABLE AS / INSERT INTO / DROP TABLE (reference
        DataDefinitionExecution + TableWriter/TableFinish plans; writes run
        through the pipeline compiler on the runner's device)."""
        from ..common.types import BIGINT
        from ..connectors import catalog as cat
        from ..sql import parser as A
        writable = [cid for cid in cat._CONNECTORS
                    if hasattr(cat.module(cid), "begin_write")]
        if isinstance(ast, A.DropTable):
            # droppable catalogs win the name lookup: a generated tpch
            # table of the same name must not shadow the stored one
            cid = next((c for c in writable
                        if ast.table in cat.module(c).SCHEMAS), None)
            if cid is None or not hasattr(cat.module(cid), "drop_table"):
                if ast.if_exists:
                    return QueryResult(["rows"], [BIGINT], [[0]])
                raise KeyError(f"unknown or non-droppable table "
                               f"{ast.table!r}")
            # cached plans may reference the dropped table
            self._invalidate_plans()
            cat.module(cid).drop_table(ast.table)
            return QueryResult(["rows"], [BIGINT], [[0]])
        if isinstance(ast, A.CreateTableAs) and ast.if_not_exists:
            # IF NOT EXISTS consults only writable catalogs: a read-only
            # generated table of the same name does not shadow the target
            if any(ast.table in cat.module(cid).SCHEMAS for cid in writable):
                return QueryResult(["rows"], [BIGINT], [[0]])
        with self._validation():
            output = Planner(default_schema=self.schema,
                             default_catalog=self.catalog).plan_write(ast)
        compiler = self._new_compiler()
        names = output.column_names
        types = [v.type for v in output.outputs]
        # writes invalidate any cached plans that scanned the target table;
        # again once committed, so nothing the write's own run cached (its
        # source's fragments) outlives it
        self._invalidate_plans()
        result = pages_to_result(compiler.run_to_pages(output), names, types)
        self._invalidate_plans()
        return result

    def _invalidate_plans(self) -> None:
        """DDL changed table contents: every cached plan (this runner's
        PlanCache), every recorded prepared fast path (its template keys
        assume the old tables) and every shared fragment may be stale."""
        from ..serving import FRAGMENT_JIT_CACHE, PREPARED_REGISTRY
        self.plan_cache.invalidate_all()
        PREPARED_REGISTRY.invalidate_fast_paths()
        FRAGMENT_JIT_CACHE.invalidate_all()

    def _explain(self, ast) -> QueryResult:
        """EXPLAIN: the optimized plan as text with its row estimates
        (reference PlanPrinter).  EXPLAIN ANALYZE: execute with per-node
        instrumentation and annotate the plan (the reference's
        ExplainAnalyzeOperator); the fused chain and the scan kernels
        count their rows per step, so it profiles the fused path unless
        analyze_unfused asks for the streaming one.  EXPLAIN (TYPE
        VALIDATE): the plan checker at every stage."""
        from ..common.types import VarcharType
        from ..sql.explain import format_analyze_footer, format_plan
        from ..utils.runtime_stats import RuntimeStats
        if ast.explain_type == "VALIDATE":
            return self._explain_validate(ast)
        with self._validation():
            output = Planner(default_schema=self.schema,
                             default_catalog=self.catalog) \
                .plan_query_to_output(ast.query)
        stats = rstats = trace_dir = None
        if ast.analyze:
            from ..telemetry import profile_capture
            stats, rstats = {}, RuntimeStats()
            compiler = PlanCompiler(TaskContext(
                config=self.config, device=self.device, stats=stats,
                runtime_stats=rstats))
            # the local ANALYZE runs one driver on this thread: its thread
            # CPU against its wall gives the footer's driver line
            t0 = time.perf_counter()  # lint: allow-wall-clock
            c0 = time.thread_time()
            with profile_capture(self.config.profile_dir, "analyze",
                                 enabled=self.config.profile) as trace_dir:
                with rstats.record_wall("queryExecute"):
                    for _page in compiler.run_to_pages(output):
                        pass
            rstats.add("driverCpuNanos", (time.thread_time() - c0) * 1e9,
                       "NANO")
            wall = time.perf_counter() - t0  # lint: allow-wall-clock
            rstats.add("driverWallNanos", wall * 1e9, "NANO")
            settle_node_stats(stats)
            self.last_operator_stats = stats
        text = format_plan(output, stats)
        if rstats is not None:
            footer = format_analyze_footer(rstats, profile_dir=trace_dir)
            if footer:
                text += "\n\n" + footer
        return QueryResult(["Query Plan"], [VarcharType(max(1, len(text)))],
                           [[text]])

    def _fragmenter_config(self):
        from ..sql.fragmenter import FragmenterConfig
        return FragmenterConfig()

    def _explain_validate(self, ast) -> QueryResult:
        """EXPLAIN (TYPE VALIDATE): every checker stage (post-plan,
        post-optimize, post-fragment) with fail-fast raising off, so the
        whole diagnostic list is reported, then the scans' pushdown
        decisions (the reference's _explain_validate)."""
        from ..analysis import (VALIDATION_OFF, check_plan, check_subplan,
                                use_validation_mode)
        from ..common.types import VarcharType
        from ..parallel.mesh import mesh_size
        from ..spi import plan as P
        from ..sql.explain import format_validation
        from ..sql.fragmenter import (annotate_exchange_fabrics,
                                      plan_distributed)
        from ..sql.optimizer import optimize
        planner = Planner(default_schema=self.schema,
                          default_catalog=self.catalog)
        with use_validation_mode(VALIDATION_OFF):
            node, names, out_vars = planner.plan_query_any(ast.query)
            out = P.OutputNode(planner.new_id("output"), node, names,
                               out_vars)
            sections = [("post-plan", check_plan(out, "post-plan"))]
            out = optimize(out)
            sections.append(("post-optimize",
                             check_plan(out, "post-optimize")))
            # the scans' pushdown decisions, collected before
            # fragmentation moves the scans into fragments
            seen, decisions = set(), []
            for n in P.walk_plan(out):
                if id(n) in seen or not isinstance(n, P.TableScanNode):
                    continue
                seen.add(id(n))
                tname = f"{n.table.connector_id}.{n.table.table_name}"
                if getattr(n, "pushdown", None):
                    for e in n.pushdown:
                        decisions.append(
                            f"  {tname} [{n.id}]: "
                            f"{e['column']} {e['op']} {e['value']}")
                else:
                    decisions.append(f"  {tname} [{n.id}]: (no pushdown)")
            subplan = plan_distributed(out, self._fragmenter_config())
            annotate_exchange_fabrics(
                subplan, exec_config=self.config,
                mesh_size=mesh_size(getattr(self, "mesh", None)),
                batch_mode=getattr(self, "_batch_mode", False))
            sections.append(("post-fragment",
                             check_subplan(subplan, "post-fragment",
                                           exec_config=self.config)))
        text = format_validation(sections)
        text += "\n\n== scan-pushdown ==\n" + "\n".join(
            decisions if decisions else ["  (no table scans)"])
        return QueryResult(["Query Plan"], [VarcharType(max(1, len(text)))],
                           [[text]])

    def execute_reference(self, sql: str) -> QueryResult:
        """Same query through the numpy reference interpreter (the oracle,
        exec/reference.py), on the host whatever the runner's device.

        Per-node {rows, wall_s, batches} land in
        `last_reference_operator_stats` keyed by plan-node id, so
        differential tests can diff the stats surface against the
        engine's EXPLAIN ANALYZE / QueryInfo counters too."""
        from .reference import execute_reference
        output = self.plan(sql)
        stats: dict = {}
        rows = execute_reference(output, stats=stats)
        self.last_reference_operator_stats = stats
        types = [v.type for v in output.outputs]
        return QueryResult(output.column_names, types, rows)

    def assert_same_as_reference(self, sql: str, ordered: bool = False):
        got = self.execute(sql)
        exp = self.execute_reference(sql)
        _assert_rows_equal(got, exp, ordered)
        return got


class DistributedQueryRunner(LocalQueryRunner):
    """Plans with exchange insertion + fragmentation and executes the
    fragment DAG as multi-task stages through the in-process scheduler
    (exec/scheduler.py), every task on the runner's device -- the port of
    presto_tpu/exec/runner.py DistributedQueryRunner, with in-process
    "workers".  EXPLAIN prints the fragments; EXPLAIN ANALYZE runs them
    with per-task operator stats merged per node.  Writes run single-task
    through the local pipeline, as the reference runs them; a PREPARE,
    EXECUTE or DEALLOCATE reaches the planner and fails there, as in the
    reference.  With a mesh (parallel/mesh.py, positions of the runner's
    device kind) an eligible hashed edge runs as the device exchange; a
    tracer provider records the query's span tree; a history store sizes
    repeats of a plan template."""

    # materialized exchanges can't stay device-resident; overridden by
    # BatchQueryRunner so fabric resolution keeps its edges on http
    _batch_mode = False

    def __init__(self, schema: str = "sf0.01",
                 config: Optional[ExecutionConfig] = None,
                 n_tasks: int = 2, broadcast_threshold: int = 600_000,
                 catalog: str = "tpch", mesh=None, tracer_provider=None,
                 history=None, device="cuda"):
        super().__init__(schema, config, catalog, device=device,
                         tracer_provider=tracer_provider, history=history)
        if mesh is not None:
            mesh.check_on(self.device)
        self.n_tasks = n_tasks
        self.broadcast_threshold = broadcast_threshold
        # parallel/mesh.DeviceMesh: hashed exchanges between stages pinned
        # to its positions run as the device exchange
        self.mesh = mesh
        # history-seeded hash-stage task count for the CURRENT query
        # (adaptive.history-sizing); None means use n_tasks
        self._history_tasks: Optional[int] = None
        # the scheduler of the last execute(): its stages (task and stage
        # walls, lifespan shards) and adaptive decisions
        self.last_scheduler = None

    def _annotate_fabrics(self, subplan):
        """Resolve and stamp each remote-exchange edge's fabric on the
        fragment output schemes (sql/fragmenter annotate_exchange_fabrics)
        so EXPLAIN shows the choice the scheduler makes at runtime."""
        from ..parallel.mesh import mesh_size
        from ..sql.fragmenter import annotate_exchange_fabrics
        return annotate_exchange_fabrics(
            subplan, exec_config=self.config,
            mesh_size=mesh_size(self.mesh),
            batch_mode=self._batch_mode)

    def plan_subplan(self, sql: str, ast=None):
        from ..sql.fragmenter import plan_distributed
        with self._validation():
            if ast is not None:
                output = Planner(default_schema=self.schema,
                                 default_catalog=self.catalog) \
                    .plan_query_to_output(ast)
            else:
                output = self.plan(sql)
            names = output.column_names
            types = [v.type for v in output.outputs]
            subplan = plan_distributed(output, self._fragmenter_config(),
                                       exec_config=self.config)
            self._annotate_fabrics(subplan)
        return subplan, names, types

    def _fragmenter_config(self):
        from ..sql.fragmenter import FragmenterConfig
        return FragmenterConfig(
            broadcast_threshold=self.broadcast_threshold)

    def _explain_distributed(self, ast, sql: str = "") -> QueryResult:
        """EXPLAIN over the fragmented (distributed) plan: one section per
        fragment.  ANALYZE runs the fragment DAG through the in-process
        scheduler with per-task operator stats and annotates every
        fragment from their merged map; with a tracer provider it also
        records the query -> fragment -> task -> operator span tree."""
        from ..common.types import VarcharType
        from ..sql.explain import format_analyze_footer, format_subplan
        from ..sql.fragmenter import plan_distributed
        if ast.explain_type == "VALIDATE":
            return self._explain_validate(ast)
        with self._validation():
            output = Planner(default_schema=self.schema,
                             default_catalog=self.catalog) \
                .plan_query_to_output(ast.query)
            subplan = plan_distributed(output, self._fragmenter_config(),
                                       exec_config=self.config)
            self._annotate_fabrics(subplan)
        stats, footer = None, ""
        if ast.analyze:
            from ..telemetry import profile_capture
            from .scheduler import InProcessScheduler
            sched = InProcessScheduler(self._scheduler_config())
            self.last_scheduler = sched
            sched.node_stats = stats = {}
            # ANALYZE collects per-node stats, so the scheduler can also
            # emit the full query->fragment->task->operator span hierarchy
            tracer = self.tracer_provider.new_tracer(sql) \
                if (self.tracer_provider and sql) else None
            sched.tracer = tracer
            with (tracer.span("query", sql=sql) if tracer
                  else nullcontext()):
                with profile_capture(self.config.profile_dir, "analyze",
                                     enabled=self.config.profile) \
                        as trace_dir:
                    for _page in sched.execute(subplan):
                        pass
            if tracer:
                tracer.end_trace("query finished")
            self.last_operator_stats = stats
            footer = format_analyze_footer(sched.stats,
                                           profile_dir=trace_dir)
        text = format_subplan(subplan, stats)
        if footer:
            text += "\n\n" + footer
        return QueryResult(["Query Plan"], [VarcharType(max(1, len(text)))],
                           [[text]])

    def execute(self, sql: str, prepared: Optional[Dict[str, str]] = None
                ) -> QueryResult:
        from ..sql import parser as A
        from .scheduler import InProcessScheduler
        from ..utils.runtime_stats import RuntimeStats
        ast = self._parse(sql, RuntimeStats())
        if isinstance(ast, A.Explain):
            return self._explain_distributed(ast, sql=sql)
        if isinstance(ast, (A.CreateTableAs, A.InsertInto, A.DropTable)):
            # writes run single-task through the local pipeline (the
            # reference's scaled-writer distribution is future work)
            return self._execute_ddl(ast)
        from ..telemetry import profile_capture
        restore = self._apply_history_sizing(ast)
        try:
            subplan, names, types = self.plan_subplan(sql, ast=ast)
            sched = InProcessScheduler(self._scheduler_config())
            self.last_scheduler = sched
            tracer = self.tracer_provider.new_tracer(sql) \
                if self.tracer_provider else None
            sched.tracer = tracer
            with (tracer.span("query", sql=sql) if tracer
                  else nullcontext()):
                with profile_capture(self.config.profile_dir, "query",
                                     enabled=self.config.profile) \
                        as trace_dir:
                    result = pages_to_result(sched.execute(subplan),
                                             names, types)
        finally:
            restore()
        result.profile_trace_dir = trace_dir
        # fabric-tagged exchange stats (bytes / walls per fabric) and the
        # adaptive counters collected while the stages ran
        result.runtime_stats = sched.stats.to_dict()
        # query-level context peak (all tasks' reservations bubbled up)
        result.peak_memory_bytes = sched.memory.peak
        if tracer:
            tracer.end_trace("query finished")
        self._record_history(result, subplan.fragment.root, subplan=subplan)
        return result

    def _apply_history_sizing(self, ast):
        """adaptive.history-sizing (distributed): parameterize the plan
        to its template digest; when a prior FINISHED run matches, seed
        the aggregation-table hint (config, consumed by every task's
        compiler) and the hash-stage task count from what that run
        observed.  Returns a restore callback for the per-query state."""
        self._last_template_digest = None
        if self.history is None:
            return lambda: None
        from ..spi import plan as P
        from ..sql.canonical import parameterize
        try:
            with self._validation():
                unopt = Planner(default_schema=self.schema,
                                default_catalog=self.catalog) \
                    .plan_query_unoptimized(ast)
            self._last_template_digest = plan_template_digest(
                P.structural_key(parameterize(unopt).template))
        except Exception:   # noqa: BLE001 -- sizing is advisory
            return lambda: None
        rec = self._history_record()
        if rec is None:
            return lambda: None
        import dataclasses

        from .adaptive import ADAPTIVE_METRICS
        saved_cfg, saved_tasks = self.config, self._history_tasks
        changed = False
        groups = rec.get("aggGroups")
        if groups:
            self.config = dataclasses.replace(
                self.config, history_agg_groups=int(groups))
            changed = True
        rows = rec.get("rows")
        if rows is not None:
            # one hash task per ~500k observed output rows: a repeat of
            # a small query skips the fan-out cost the planned
            # parallelism assumed (never raised above n_tasks)
            seeded = max(1, min(self.n_tasks, -(-int(rows) // 500_000)))
            if seeded != self.n_tasks:
                self._history_tasks = seeded
                changed = True
        if changed:
            ADAPTIVE_METRICS.incr("history_sized_queries")

        def restore():
            self.config, self._history_tasks = saved_cfg, saved_tasks
        return restore

    def _scheduler_config(self):
        from .scheduler import SchedulerConfig
        return SchedulerConfig(
            exec_config=self.config, source_tasks=self.n_tasks,
            hash_tasks=self._history_tasks or self.n_tasks,
            mesh=self.mesh,
            broadcast_threshold=self.broadcast_threshold,
            device=self.device)


class BatchQueryRunner(DistributedQueryRunner):
    """Batch-mode execution -- the Presto-on-Spark analog.  The same
    fragment DAG runs stage by stage with every inter-stage exchange
    MATERIALIZED to local shuffle files and per-task retry from those
    durable inputs -- batch fault tolerance instead of fail-fast MPP."""

    _batch_mode = True

    def __init__(self, schema: str = "sf0.01", config=None,
                 n_tasks: int = 2, catalog: str = "tpch",
                 task_retries: int = 2, temp_dir=None,
                 fault_injector=None, device="cuda", tracer_provider=None,
                 history=None):
        super().__init__(schema, config, n_tasks=n_tasks, catalog=catalog,
                         device=device, tracer_provider=tracer_provider,
                         history=history)
        self.task_retries = task_retries
        self.temp_dir = temp_dir
        self.fault_injector = fault_injector

    def _scheduler_config(self):
        cfg = super()._scheduler_config()
        cfg.batch_mode = True
        cfg.task_retries = self.task_retries
        cfg.temp_dir = self.temp_dir
        cfg.fault_injector = self.fault_injector
        return cfg


def _assert_rows_equal(got: QueryResult, exp: QueryResult, ordered: bool):
    g = got.rows if ordered else got.sorted_rows()
    e = exp.rows if ordered else exp.sorted_rows()
    if len(g) != len(e):
        raise AssertionError(
            f"row count mismatch: engine {len(g)} vs reference {len(e)}\n"
            f"engine head: {g[:5]}\nreference head: {e[:5]}")
    for i, (rg, re_) in enumerate(zip(g, e)):
        if len(rg) != len(re_):
            raise AssertionError(f"column count mismatch at row {i}")
        for j, (a, b) in enumerate(zip(rg, re_)):
            if not _value_eq(a, b):
                raise AssertionError(
                    f"value mismatch at row {i} col {j} "
                    f"({got.column_names[j]}): engine {a!r} vs reference {b!r}\n"
                    f"engine row: {rg}\nreference row: {re_}")


def _value_eq(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, float) or isinstance(b, float):
        fa, fb = float(a), float(b)
        if fa == fb:
            return True
        denom = max(abs(fa), abs(fb), 1e-30)
        return abs(fa - fb) / denom < 1e-9
    return a == b
