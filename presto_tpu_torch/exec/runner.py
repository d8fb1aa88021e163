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
to the CPU on its own.  PREPARE / EXECUTE / DEALLOCATE and DDL raise
NotImplementedError.
"""
from __future__ import annotations

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
    # the profiler capture's directory when the `profile` session
    # property was set (telemetry/profiler.py); None when not captured
    profile_trace_dir: Optional[str] = None

    def sorted_rows(self):
        return sorted(self.rows, key=lambda r: tuple(
            (v is None, str(type(v)), v) for v in r))


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
                 catalog: str = "tpch", plan_cache=None, device="cuda"):
        from ..serving import PlanCache
        self.schema = schema
        self.catalog = catalog
        self.device = resolve_device(device)
        self.config = config or tuned_config()
        # the runner's OWN canonical plan cache: a process-global cache
        # would hand this runner another package's compiler on a key
        # collision
        self.plan_cache = plan_cache if plan_cache is not None \
            else PlanCache()
        # EXPLAIN ANALYZE's side channel: node id -> operator stats of the
        # most recent analyzed execution
        self.last_operator_stats: Optional[dict] = None

    def _validation(self):
        from ..analysis import use_validation_mode
        return use_validation_mode(self.config.plan_validation)

    def plan(self, sql: str):
        with self._validation():
            return Planner(default_schema=self.schema,
                           default_catalog=self.catalog).plan(sql)

    def _new_compiler(self) -> PlanCompiler:
        return PlanCompiler(TaskContext(config=self.config,
                                        device=self.device))

    def _checkout(self, ast, stats) -> _Execution:
        """Plan `ast` to the parameterized template, then check the
        canonical cache: a hit skips optimize and reuses a pooled
        compiler; a miss optimizes and builds one."""
        from ..serving import SERVING_METRICS
        from ..spi import plan as P
        from ..sql.canonical import cache_key_from_parts, parameterize
        with stats.record_wall("queryPlan"), self._validation():
            planner = Planner(default_schema=self.schema,
                              default_catalog=self.catalog)
            unopt = planner.plan_query_unoptimized(ast)
        pp = parameterize(unopt)
        template_sk = P.structural_key(pp.template)
        key = cache_key_from_parts(template_sk, self.config, self.catalog,
                                   self.schema)
        hit = self.plan_cache.checkout(key)
        if hit is not None:
            output, slot_types, compiler = hit
            if compiler is None:
                compiler = self._new_compiler()
                SERVING_METRICS.incr("executable_builds")
            exe = _Execution(output, compiler, key, False, list(slot_types))
        else:
            with stats.record_wall("queryOptimize"), self._validation():
                output = Planner.optimize_output(pp.template)
            compiler = self._new_compiler()
            SERVING_METRICS.incr("executable_builds")
            exe = _Execution(output, compiler, key, True,
                             [s.type for s in pp.slots])
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

    def _parse(self, sql: str, stats):
        """The statement's AST; raises NotImplementedError for the
        statements the port does not run."""
        from ..sql import parser as A
        with stats.record_wall("queryParse"):
            ast = A.parse_sql(sql)
        if isinstance(ast, (A.CreateTableAs, A.InsertInto, A.DropTable,
                            A.Prepare, A.Deallocate, A.ExecuteStmt)):
            raise NotImplementedError(
                f"{type(ast).__name__} statements are not ported yet")
        return ast

    def execute(self, sql: str, prepared: Optional[Dict[str, str]] = None
                ) -> QueryResult:
        """Run one statement to a materialized QueryResult.  `prepared`
        (the client's prepared-statement map) is the reference's
        signature; the port runs no EXECUTE yet."""
        from ..sql import parser as A
        from ..utils.runtime_stats import RuntimeStats
        stats = RuntimeStats()
        ast = self._parse(sql, stats)
        if isinstance(ast, A.Explain):
            return self._explain(ast)
        exe = self._checkout(ast, stats)
        output, compiler = exe.output, exe.compiler
        names = output.column_names
        types = [v.type for v in output.outputs]
        compiler.ctx.runtime_stats = stats
        from ..telemetry import profile_capture
        with profile_capture(self.config.profile_dir, "query",
                             enabled=self.config.profile) as trace_dir:
            with stats.record_wall("queryExecute"):
                result = pages_to_result(compiler.run_to_pages(output),
                                         names, types)
        result.profile_trace_dir = trace_dir
        result.runtime_stats = stats.to_dict()
        result.peak_memory_bytes = compiler.ctx.memory.peak
        self._release(exe)
        return result

    def execute_streaming(self, sql: str,
                          prepared: Optional[Dict[str, str]] = None):
        """(columns-meta, row iterator, RuntimeStats) for a plain SELECT:
        pages are decoded and yielded as they are produced, so callers
        (the statement protocol) never hold the full result set
        (reference Query.java:116 streams from the root-stage
        ExchangeClient).  Returns None for an EXPLAIN, which needs
        materialized execution."""
        from ..sql import parser as A
        from ..utils.runtime_stats import RuntimeStats
        stats = RuntimeStats()
        ast = self._parse(sql, stats)
        if isinstance(ast, A.Explain):
            return None
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
            t0, c0 = time.perf_counter(), time.thread_time()
            with profile_capture(self.config.profile_dir, "analyze",
                                 enabled=self.config.profile) as trace_dir:
                with rstats.record_wall("queryExecute"):
                    for _page in compiler.run_to_pages(output):
                        pass
            rstats.add("driverCpuNanos", (time.thread_time() - c0) * 1e9,
                       "NANO")
            rstats.add("driverWallNanos", (time.perf_counter() - t0) * 1e9,
                       "NANO")
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


class DistributedQueryRunner(LocalQueryRunner):
    """Plans with exchange insertion + fragmentation and executes the
    fragment DAG as multi-task stages through the in-process scheduler
    (exec/scheduler.py), every task on the runner's device -- the port of
    presto_tpu/exec/runner.py DistributedQueryRunner, with in-process
    "workers".  EXPLAIN prints the fragments; EXPLAIN ANALYZE runs them
    with per-task operator stats merged per node.  A mesh, a tracer
    provider, query history and DDL raise NotImplementedError."""

    # materialized exchanges can't stay device-resident; overridden by
    # BatchQueryRunner so fabric resolution keeps its edges on http
    _batch_mode = False

    def __init__(self, schema: str = "sf0.01",
                 config: Optional[ExecutionConfig] = None,
                 n_tasks: int = 2, broadcast_threshold: int = 600_000,
                 catalog: str = "tpch", mesh=None, tracer_provider=None,
                 history=None, device="cuda"):
        if mesh is not None:
            raise NotImplementedError(
                "a device mesh (the ICI exchange fabric) is not ported yet "
                "(ROADMAP queue 1: the multi-device exchange on "
                "torch.distributed)")
        if tracer_provider is not None or history is not None:
            raise NotImplementedError(
                "tracing and query history are not ported yet (telemetry: "
                "ROADMAP queue 1, item 7)")
        super().__init__(schema, config, catalog, device=device)
        self.n_tasks = n_tasks
        self.broadcast_threshold = broadcast_threshold
        self.mesh = mesh
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

    def _explain_distributed(self, ast) -> QueryResult:
        """EXPLAIN over the fragmented (distributed) plan: one section per
        fragment.  ANALYZE runs the fragment DAG through the in-process
        scheduler with per-task operator stats and annotates every
        fragment from their merged map (the reference's
        _explain_distributed, without a tracer)."""
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
            with profile_capture(self.config.profile_dir, "analyze",
                                 enabled=self.config.profile) as trace_dir:
                for _page in sched.execute(subplan):
                    pass
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
            return self._explain_distributed(ast)
        restore = self._apply_history_sizing(ast)
        try:
            subplan, names, types = self.plan_subplan(sql, ast=ast)
            sched = InProcessScheduler(self._scheduler_config())
            self.last_scheduler = sched
            result = pages_to_result(sched.execute(subplan), names, types)
        finally:
            restore()
        # fabric-tagged exchange stats (bytes / walls per fabric) and the
        # adaptive counters collected while the stages ran
        result.runtime_stats = sched.stats.to_dict()
        # query-level context peak (all tasks' reservations bubbled up)
        result.peak_memory_bytes = sched.memory.peak
        return result

    def _apply_history_sizing(self, ast):
        """adaptive.history-sizing: a no-op without query history (the
        reference's, history=None); returns the restore callback."""
        return lambda: None

    def _scheduler_config(self):
        from .scheduler import SchedulerConfig
        return SchedulerConfig(
            exec_config=self.config, source_tasks=self.n_tasks,
            hash_tasks=self.n_tasks, mesh=self.mesh,
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
                 fault_injector=None, device="cuda"):
        super().__init__(schema, config, n_tasks=n_tasks, catalog=catalog,
                         device=device)
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
