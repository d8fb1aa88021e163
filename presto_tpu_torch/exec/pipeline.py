"""Plan -> executable pipelines over torch tensors.

The port of presto_tpu/exec/pipeline.py for the ported slices: a
TableScan over device-resident encoded columns, streaming Filter/Project,
an Aggregation whose fused scan -> filter -> project -> fanout-1 join /
semi-join chain runs through the hand-written CUDA scan kernels (direct
slots for G <= 64, exec/kernels/scan_kernel.py; span or hash slots
beyond, exec/kernels/grouped.py; the probes inside them,
exec/kernels/join.py), with the join build sides drained from the
streaming sources, Sort, TopN, Limit, Window (every function of a
WindowNode in one launch of the CUDA window kernel over the sorted run,
exec/kernels/window.py; operators.window_batch after its metered
WindowFunctionShape decline) and Output.  Every tensor is allocated on the task's device
(TaskContext.device).  A plan shape or option outside the slices raises
NotImplementedError naming what is missing (a streaming Join / SemiJoin
outside a fused aggregation chain among them); nothing falls back
quietly.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch

from ..common.page import Page
from ..common.types import DoubleType, RealType, Type
from ..connectors import catalog
from ..spi import plan as P
from ..spi.expr import VariableReferenceExpression
from . import operators as ops
from .batch import Batch, Column, batch_to_page
from .lowering import (Lowering, canonical_name, compile_expr,
                       constant_device_value, expr_has_params, torch_dtype)
from .memory import MemoryContext, MemoryPool

DEFAULT_CAPACITY = 1 << 20
# the hash table's least first size
AGG_SLOTS = 4096
# capacities a sparse aggregation table is compacted to
_COMPACT_BUCKETS = (1 << 12, 1 << 16, 1 << 18, 1 << 20)


def _maybe_compact(batch: Batch) -> Batch:
    """Compact a single mostly-dead batch (a sparse aggregation table) to
    a bucketed capacity so downstream sorts don't pay full-capacity
    costs.  One host sync for the live count."""
    live = int(batch.mask.sum())
    if live * 4 >= batch.capacity:
        return batch
    bucket = next((s for s in _COMPACT_BUCKETS if s >= live), None)
    if bucket is None or bucket >= batch.capacity:
        return batch
    return ops.compact(batch, bucket)


@dataclass
class ExecutionConfig:
    batch_rows: int = DEFAULT_CAPACITY      # scan page/batch capacity
    splits_per_scan: int = 4
    # device-memory accounting (exec/memory.py); None = unlimited
    memory_budget_bytes: Optional[int] = None
    # query-level memory ceiling (query.max-memory); None = unlimited
    memory_max_query_bytes: Optional[int] = None
    # plan sanity/type validation (presto_tpu_torch/analysis)
    plan_validation: str = "on"
    # -- device-resident columnar storage (presto_tpu_torch/storage) -----
    storage_budget_bytes: Optional[int] = 6 << 30
    storage_max_column_bytes: int = 1 << 30
    storage_zone_rows: int = 1 << 16
    storage_encodings: bool = True
    # -- fused scan kernel (exec/kernels) --------------------------------
    # the reference's values (SCAN_KERNEL_MODES): "pallas" and "auto" both
    # run the hand-written CUDA kernels (their plain torch versions for
    # CPU tensors); "xla" names the reference's jnp paths, not ported: a
    # window or an aggregation meters kernelDeclinedDisabled and raises.
    # Config key scan.kernel / session scan_kernel
    scan_kernel: str = "auto"
    # staging discipline of the scan kernels' per-row input arrays
    # (SCAN_KERNEL_DMA_MODES): "single" loads them from device memory as
    # each tile computes; "double" keeps the next tiles of the arrays the
    # plan reads densely in flight into a shared-memory ring while the
    # current one computes (kernel #2, exec/kernels/scan_kernel.py
    # ScanPlan.staging; a plan with nothing worth staging runs unstaged),
    # metered as kernelDmaStagedBlocks / kernelDmaPrefetchedBlocks /
    # kernelDmaOverlapFraction.  Config key scan.kernel-dma
    scan_kernel_dma: str = "single"

    def __post_init__(self):
        if self.scan_kernel not in SCAN_KERNEL_MODES:
            raise ValueError(f"scan_kernel must be one of "
                             f"{SCAN_KERNEL_MODES}, got {self.scan_kernel!r}")
        if self.scan_kernel_dma not in SCAN_KERNEL_DMA_MODES:
            raise ValueError(f"scan_kernel_dma must be one of "
                             f"{SCAN_KERNEL_DMA_MODES}, got "
                             f"{self.scan_kernel_dma!r}")


# legal scan.kernel / scan_kernel values (the reference's)
SCAN_KERNEL_MODES = ("xla", "pallas", "auto")

# legal scan.kernel-dma / scan_kernel_dma values
SCAN_KERNEL_DMA_MODES = ("single", "double")


def tuned_config(**overrides) -> "ExecutionConfig":
    """The runner default ExecutionConfig: 64K-row scan batches."""
    return ExecutionConfig(batch_rows=1 << 16, **overrides)


@dataclass
class TaskContext:
    """Execution context for one task: configuration and device."""
    config: ExecutionConfig = field(default_factory=ExecutionConfig)
    # every tensor of the task is allocated here
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    # device byte accounting for this task (created by PlanCompiler if absent)
    memory: Optional[MemoryContext] = None
    # runner-provided RuntimeStats sink (utils/runtime_stats.py)
    runtime_stats: Optional[object] = None
    # bound-parameter vector (one int64 device tensor) and its host values
    params: Optional[torch.Tensor] = None
    params_fingerprint: Optional[Tuple] = None


class BatchSource:
    """A compiled sub-pipeline that can be iterated (possibly repeatedly)."""

    def __init__(self, fn: Callable[[], Iterator[Batch]],
                 names: List[str], types: List[Type]):
        self._fn = fn
        self.names = names
        self.types = types

    def batches(self) -> Iterator[Batch]:
        return self._fn()


def _concat(batches: List[Batch]) -> Batch:
    """One batch holding every input batch's rows (dictionaries must
    agree)."""
    if len(batches) == 1:
        return batches[0]
    cols = {}
    for name, c0 in batches[0].columns.items():
        parts = [b.columns[name] for b in batches]
        if any(p.dictionary != c0.dictionary for p in parts):
            raise NotImplementedError("concatenating batches whose "
                                      "dictionaries differ")
        nulls = None
        if any(p.nulls is not None for p in parts):
            nulls = torch.cat([p.null_mask() for p in parts])
        cols[name] = Column(torch.cat([p.values for p in parts]), nulls,
                            c0.dictionary)
    return Batch(cols, torch.cat([b.mask for b in batches]))


class PlanCompiler:
    def __init__(self, ctx: TaskContext):
        if ctx.memory is None:
            ctx.memory = MemoryContext(
                MemoryPool(ctx.config.memory_budget_bytes), "query",
                max_bytes=ctx.config.memory_max_query_bytes)
        self.ctx = ctx
        self._sources: Dict[str, BatchSource] = {}
        self.lowering = Lowering()

    # -- public -----------------------------------------------------------
    def compile(self, root: P.PlanNode) -> BatchSource:
        return self._compile(root)

    def run_to_pages(self, root: P.PlanNode) -> Iterator[Page]:
        src = self.compile(root)
        for batch in src.batches():
            page = batch_to_page(batch, src.names, src.types)
            if page.position_count:
                yield page

    # -- dispatch ---------------------------------------------------------
    def _compile(self, node: P.PlanNode) -> BatchSource:
        cached = self._sources.get(node.id)
        if cached is not None:
            return cached
        m = getattr(self, "_compile_" + type(node).__name__, None)
        if m is None:
            raise NotImplementedError(
                f"no compiler for {type(node).__name__} in the port yet")
        src = m(node)
        self._sources[node.id] = src
        return src

    def _materialize_node(self, node: P.PlanNode) -> Optional[Batch]:
        batches = list(self._compile(node).batches())
        return _concat(batches) if batches else None

    def _params_for(self, expr) -> Optional[torch.Tensor]:
        return self.ctx.params if expr_has_params(expr) else None

    def _meter_declined(self, reason: str) -> None:
        """One kernelDeclined{reason}: the process roll-up and the query's
        RuntimeStats."""
        from .kernels.scan_kernel import KERNEL_METRICS
        KERNEL_METRICS.record_declined(reason)
        rs = self.ctx.runtime_stats
        if rs is not None:
            rs.add(f"kernelDeclined{reason}", 1)

    # -- leaves -----------------------------------------------------------
    def _compile_TableScanNode(self, node: P.TableScanNode) -> BatchSource:
        """Scan over device-resident encoded columns (storage/).  On-the-fly
        generation, host-generated columns and late-materialized strings
        are not ported yet."""
        names = [v.name for v in node.outputs]
        types = [v.type for v in node.outputs]
        columns = [node.assignments[v].name for v in node.outputs]
        th = node.table
        sf = dict(th.extra).get("scaleFactor", 0.01)
        splits = catalog.make_splits(th.table_name, sf,
                                     self.ctx.config.splits_per_scan,
                                     th.connector_id)
        cfg = self.ctx.config
        cap = cfg.batch_rows
        table, cid = th.table_name, th.connector_id
        device = self.ctx.device
        from ..connectors import device_gen
        for colname in columns:
            if (table, colname) in catalog.OPEN_DOMAIN \
                    or not device_gen.supported(cid, table, colname):
                raise NotImplementedError(
                    f"scan of {cid}.{table}.{colname}: only device-generated "
                    f"columns are ported")
        if self.ctx.memory.limited:
            raise NotImplementedError(
                "scans under a memory budget (outside the resident "
                "store) are not ported")
        from ..storage import get_store, prune_chunks
        store = get_store(cfg.storage_budget_bytes,
                          cfg.storage_max_column_bytes, device)
        n_rows = catalog.table_row_count(table, sf, cid)
        cached_cols: Dict[str, object] = {}
        zone_maps: Dict[str, object] = {}
        for colname in columns:
            as_i32 = (colname.endswith("date")
                      or catalog.column_type(table, colname, cid).storage
                      == "INT_ARRAY")
            ent = store.get_or_build(
                cid, table, colname, sf, n_rows, cap, as_i32,
                zone_rows=cfg.storage_zone_rows,
                encodings=cfg.storage_encodings)
            if ent is not None:
                cached_cols[colname] = ent.column
                zone_maps[colname] = ent.zones
        pushdown = [dict(e) for e in getattr(node, "pushdown", ())]
        dicts = {name: device_gen.dictionary(cid, table, colname)
                 for name, colname in zip(names, columns)}

        def split_chunks(split):
            out = []
            p = split.start
            while p < split.end:
                out.append((p, min(cap, split.end - p)))
                p += cap
            if zone_maps and pushdown:
                out, _skipped = prune_chunks(out, zone_maps, pushdown,
                                             self.ctx.params_fingerprint,
                                             None, keep_one=False)
            return out

        def gen():
            missing = [c for c in columns if c not in cached_cols]
            if missing:
                raise NotImplementedError(
                    f"ColumnsNotResident: {missing} (on-the-fly generation "
                    f"is not ported)")
            idx0 = torch.arange(cap, device=device)
            for split in splits:
                for pos, n in split_chunks(split):
                    live = idx0 < n
                    cols = {}
                    for name, colname in zip(names, columns):
                        v = cached_cols[colname].slice_decode(pos, cap)
                        cols[name] = Column(
                            torch.where(live, v, torch.zeros_like(v)), None,
                            dicts[name])
                    yield Batch(cols, live)

        src = BatchSource(gen, names, types)
        src.fused_scan = {
            "splits": splits, "cap": cap, "cached_cols": cached_cols,
            "dicts": dicts, "table": table, "cid": cid, "sf": sf,
            "colmap": dict(zip(names, columns)),
            "types": dict(zip(names, types)),
            "zone_maps": zone_maps, "pushdown": pushdown,
        }
        return src

    # -- streaming transforms --------------------------------------------
    def _compile_FilterNode(self, node: P.FilterNode) -> BatchSource:
        src = self._compile(node.source)
        low = self.lowering

        def gen():
            for b in src.batches():
                pb = b.with_params(self._params_for(node.predicate))
                yield ops.apply_filter(b, low.eval(node.predicate, pb))
        return BatchSource(gen, src.names, src.types)

    def _compile_ProjectNode(self, node: P.ProjectNode) -> BatchSource:
        src = self._compile(node.source)
        names = [v.name for v in node.assignments]
        types = [v.type for v in node.assignments]
        items = list(node.assignments.items())
        low = self.lowering

        def gen():
            for b in src.batches():
                cols = {}
                for v, e in items:
                    cols[v.name] = low.eval(
                        e, b.with_params(self._params_for(e)))
                yield Batch(cols, b.mask)
        return BatchSource(gen, names, types)

    def _compile_OutputNode(self, node: P.OutputNode) -> BatchSource:
        src = self._compile(node.source)
        # OutputNode renames columns positionally
        inner = [v.name for v in node.source.output_variables]
        outer = [v.name for v in node.outputs]
        types = [v.type for v in node.outputs]
        if inner == outer:
            return BatchSource(src.batches, outer, types)

        def gen():
            for b in src.batches():
                yield Batch({o: b.columns[i] for i, o in zip(inner, outer)},
                            b.mask)
        return BatchSource(gen, outer, types)

    def _compile_SortNode(self, node: P.SortNode) -> BatchSource:
        vs = node.source.output_variables
        names, types = [v.name for v in vs], [v.type for v in vs]
        keys = [(v.name, order) for v, order in node.ordering_scheme.orderings]

        def gen():
            merged = self._materialize_node(node.source)
            if merged is None:
                return
            yield ops.sort_batch(merged, keys)
        return BatchSource(gen, names, types)

    # -- limit / topn / window --------------------------------------------
    def _compile_LimitNode(self, node: P.LimitNode) -> BatchSource:
        src = self._compile(node.source)
        n = node.count

        def gen():
            consumed = torch.zeros((), dtype=torch.int64,
                                   device=self.ctx.device)
            for b in src.batches():
                out, consumed = ops.limit(b, n, consumed)
                yield out
                if int(consumed) >= n:
                    break
        return BatchSource(gen, src.names, src.types)

    def _compile_TopNNode(self, node: P.TopNNode) -> BatchSource:
        """A streaming buffer merge: each batch is concatenated to the
        running top n and cut back to n rows."""
        src = self._compile(node.source)
        keys = [(v.name, order) for v, order in node.ordering_scheme.orderings]
        n = node.count

        def gen():
            buf = None
            for b in src.batches():
                merged = b if buf is None else _concat([buf, b])
                buf = ops.topn(merged, keys, n)
            if buf is not None:
                yield buf
        return BatchSource(gen, src.names, src.types)

    def _compile_WindowNode(self, node: P.WindowNode) -> BatchSource:
        """Materialize the source, then every window function of the node
        in one launch of the window kernel (kernels/window.py) over the
        sorted run.  After a metered WindowFunctionShape decline
        ops.window_batch computes them, as in the reference; a failed
        memory reservation (WindowInputSize) and scan_kernel="xla"
        (Disabled) are metered and raise."""
        src = self._compile(node.source)
        part_names = tuple(v.name for v in node.partition_by)
        orderings = tuple((v.name, o) for v, o in
                          node.ordering_scheme.orderings) \
            if node.ordering_scheme else ()
        specs = []
        for v, wf in node.window_functions.items():
            fname = canonical_name(wf.call.display_name)
            args = wf.call.arguments
            arg = None
            extra = ()
            if fname == "count" and not args:
                fname = "count_star"
            elif fname == "ntile":
                extra = (int(args[0].value),)
            elif args:
                arg = args[0].name
                extra = tuple(constant_device_value(a.value, a.type)
                              for a in args[1:])
            frame = None
            if wf.frame:
                f = wf.frame
                frame = (f["type"], f["startKind"], f["startOffset"],
                         f["endKind"], f["endOffset"])
            is_float = isinstance(v.type, (DoubleType, RealType))
            specs.append(ops.WindowSpec(fname, v.name, arg, is_float,
                                        frame, extra))
        specs = tuple(specs)
        out_names = src.names + [v.name for v in node.window_functions]
        out_types = src.types + [v.type for v in node.window_functions]

        def gen():
            merged = self._materialize_node(node.source)
            if merged is None:
                return
            if self.ctx.config.scan_kernel == "xla":
                self._meter_declined("Disabled")
                raise NotImplementedError(
                    "kernelDeclinedDisabled: the reference's XLA window "
                    "path (scan_kernel=xla) is not ported")
            from .kernels import window as wk
            kres = wk.try_window_kernel(
                merged, part_names, orderings, specs,
                declined=self._meter_declined,
                runtime_stats=self.ctx.runtime_stats,
                pool=self.ctx.memory)
            yield kres if kres is not None else ops.window_batch(
                merged, part_names, orderings, specs)
        return BatchSource(gen, out_names, out_types)

    # -- aggregation ------------------------------------------------------
    def _compile_AggregationNode(self, node: P.AggregationNode) -> BatchSource:
        """Aggregation over a fused scan chain, run by the scan kernels in
        the reference's mode order: direct slots (G <= 64), span slots
        (closed key domains, G <= KERNEL_SPAN_MAX_GROUPS), hashed slots.
        The chain's fanout-1 join / semi-join probes run inside the same
        launch.  The streaming (non-fused) aggregation, the XLA-chain
        span / sort / hash paths and spill are not ported yet."""
        if any(a.mask is not None or a.distinct
               for a in node.aggregations.values()):
            raise NotImplementedError(
                "masked or DISTINCT aggregates are not ported")
        src_node = node.source
        key_vars = node.grouping_keys
        key_names = tuple(v.name for v in key_vars)
        out_names = [v.name for v in key_vars] + \
            [v.name for v in node.aggregations]
        out_types = ([v.type for v in key_vars]
                     + [v.type for v in node.aggregations])
        specs = []
        input_exprs = {}
        for v, agg in node.aggregations.items():
            fname = canonical_name(agg.call.display_name)
            args = agg.call.arguments
            if fname == "count" and not args:
                fname = "count_star"
            is_float = isinstance(v.type, (DoubleType, RealType))
            specs.append(ops.AggSpec(fname, v.name, is_float))
            input_exprs[v.name] = args[0] if args else None
        specs = tuple(specs)
        basic = all(s.name in ops.BASIC_AGGS for s in specs)
        cfg = self.ctx.config
        fused_cache: dict = {}
        initial_slots = _initial_slots(node, key_names)

        def declined(reason: str) -> None:
            self._meter_declined(reason)
            fused_cache["declined"] = reason

        def refuse(reason: str):
            declined(reason)
            raise NotImplementedError(
                f"kernelDeclined{reason}: the torch fused chain is not "
                f"ported yet")

        def get_fused():
            if "chain" not in fused_cache:
                from .fused import assemble_chain
                fused_cache["chain"] = assemble_chain(self, src_node)
            return fused_cache["chain"]

        def prep(chain):
            """The chain's build tables, built once per compiled
            aggregation (generated data is immutable); a build subtree
            with bound parameters rebuilds when the values change."""
            pfp = self.ctx.params_fingerprint if chain.build_params else None
            res = fused_cache.get("prep")
            if res is None or fused_cache.get("prep_fp") != pfp:
                res = chain.prep()
                if res is None:
                    raise NotImplementedError(
                        "a join fanout beyond the fused chain's expansion "
                        "limits (the streaming join) is not ported")
                fused_cache["prep"], fused_cache["prep_fp"] = res, pfp
            return res

        def run_fused(chain) -> Batch:
            if self.ctx.memory.limited:
                raise NotImplementedError(
                    "budgeted aggregation (the streaming path) is not ported")
            aux, expands = prep(chain)
            key_cols = _chain_key_columns(chain, key_names, aux)
            info = (_direct_mode_info(key_names, key_cols)
                    if basic else None)
            if cfg.scan_kernel == "xla":
                refuse("Disabled")
            if not basic:
                refuse("AggFunctionShape")
            if info is not None:
                doms, G, strides, kdts, kdicts = info
                from .kernels.scan_kernel import try_direct_scan_kernel
                kres = try_direct_scan_kernel(
                    chain, self.ctx.params, specs=specs,
                    key_names=key_names, strides=strides, G=G,
                    agg_inputs=input_exprs, cache=fused_cache,
                    declined=declined, runtime_stats=self.ctx.runtime_stats,
                    aux=aux, expands=expands, pool=self.ctx.memory,
                    dma=cfg.scan_kernel_dma)
                if kres is not None:
                    state, _counts, _n_blocks = kres
                    return ops.agg_direct_finalize(
                        state, specs, key_names, doms, kdts, kdicts,
                        force_row=not key_names)
            else:
                # grouped (G > 64): span slots when the closed key domains
                # fit the span gate, hashed open addressing otherwise
                from .kernels.grouped import try_grouped_scan_kernel
                from .kernels.scan_kernel import KERNEL_SPAN_MAX_GROUPS
                kres = try_grouped_scan_kernel(
                    chain, self.ctx.params, specs=specs,
                    key_names=key_names,
                    key_dtypes=tuple(c.values.dtype for c in key_cols),
                    key_dicts={k: c.dictionary
                               for k, c in zip(key_names, key_cols)
                               if c.dictionary is not None},
                    span_info=_direct_mode_info(
                        key_names, key_cols, gmax=KERNEL_SPAN_MAX_GROUPS),
                    est_slots=initial_slots, agg_inputs=input_exprs,
                    cache=fused_cache, declined=declined,
                    pool=self.ctx.memory, state_bytes=_agg_state_bytes,
                    runtime_stats=self.ctx.runtime_stats, aux=aux,
                    expands=expands, dma=cfg.scan_kernel_dma)
                if kres is not None:
                    out, _counts, _n_blocks = kres
                    return _maybe_compact(out)
            reason = fused_cache["declined"]
            detail = (f" ({fused_cache['plan_error']})"
                      if reason == "PlanShape" and "plan_error" in fused_cache
                      else "")
            raise NotImplementedError(
                f"kernelDeclined{reason}{detail}: the torch fused chain is "
                f"not ported yet")

        def gen():
            chain = get_fused()
            if chain is None:
                raise NotImplementedError(
                    "aggregation over a source that is not a fused scan "
                    "chain (the streaming aggregation) is not ported")
            yield run_fused(chain)
        return BatchSource(gen, out_names, out_types)


def _initial_slots(node: P.AggregationNode, key_names) -> int:
    """The hash table's first size: AGG_SLOTS, raised to the pow2
    ceiling of twice the optimizer's group estimate (~2x probing
    headroom), the estimate term clamped to 2**20 so a wild overestimate
    cannot blow up device memory."""
    if not key_names:
        return AGG_SLOTS
    try:
        from ..sql.stats import StatsCalculator
        est_groups = StatsCalculator().rows(node)
    except Exception:   # noqa: BLE001 -- an estimate only
        est_groups = None
    if not est_groups:
        return AGG_SLOTS
    est_based = 1 << max(0, (int(2 * est_groups) - 1).bit_length())
    return max(AGG_SLOTS, min(est_based, 1 << 20))


def _agg_state_bytes(num_slots: int, key_names, specs) -> int:
    """Accumulator footprint estimate of a hash table (hash + occupied +
    per-key value/null + per-aggregate state columns), the reference's
    one formula for every aggregation budget check."""
    return num_slots * (16 + 12 * len(key_names) + 24 * max(1, len(specs)))


def _chain_key_columns(chain, key_names, aux):
    """Column metadata (dtype / nulls / dictionary) of each group key at
    the top of a fused chain, found by following the steps' definitions
    back to the scan or, through a join, to the build column it gathers
    (aux: FusedChain.prep's tables).  A gathered column is NULL-able when
    its join is LEFT or its build column has NULLs, a semi marker always.
    A key computed by an expression has no dictionary (and is
    direct-eligible only when boolean); it is NULL-able when it reads a
    NULL-able gathered column or can make a NULL itself
    (ExprProgram.nullable: a divide, NULL_IF, a NULL branch)."""
    from ..spi.expr import free_variables
    from .fused import _join_build_cols
    from .kernels.scan_kernel import substitute
    meta = chain.scan_meta
    env = {n: VariableReferenceExpression(n, t)
           for n, t in meta["types"].items()}
    gathered = {}       # probe output name -> (dtype, nullable, dictionary)
    ji = 0
    for step in chain.steps:
        kind = step[0]
        if kind == "project":
            env = {v.name: substitute(e, env) for v, e in step[1]}
        elif kind == "rename":
            env = {o: env[i] for o, i in step[1]}
        elif kind == "join":
            node, tbl = step[1], aux[ji + 1]
            ji += 1
            right = {v.name: v for v in node.right.output_variables}
            for n in _join_build_cols(node, [v.name for v in node.outputs],
                                      set(right)):
                c = tbl.columns[n]
                gathered[n] = (c.values.dtype,
                               node.join_type == P.LEFT
                               or c.nulls is not None, c.dictionary)
                env[n] = right[n]
        elif kind == "semi":
            out = step[1].semi_join_output
            ji += 1
            gathered[out.name] = (torch.bool, True, None)
            env[out.name] = out
    out = []
    for k in key_names:
        e = env[k]
        dictionary, nullable = None, False
        if isinstance(e, VariableReferenceExpression) and e.name in gathered:
            dtype, nullable, dictionary = gathered[e.name]
        elif isinstance(e, VariableReferenceExpression):
            dictionary = meta["dicts"].get(e.name)
            rc = meta["cached_cols"].get(meta["colmap"][e.name])
            dtype = rc.dtype if rc is not None else torch_dtype(e.type)
        else:
            dtype = torch_dtype(e.type)
            maybe_null = {v.name for v in free_variables(e)
                          if gathered.get(v.name, (0, False))[1]}
            try:
                nullable = compile_expr(e, maybe_null).nullable
            except NotImplementedError:
                # the plan build raises it, naming what is missing
                nullable = bool(maybe_null)
        out.append(SimpleNamespace(values=SimpleNamespace(dtype=dtype),
                                   nulls=True if nullable else None,
                                   dictionary=dictionary))
    return out


def _direct_mode_info(key_names, key_cols,
                      gmax: int = ops.DIRECT_AGG_MAX_GROUPS):
    """Closed-small-domain eligibility for direct aggregation (consistent
    with ops.agg_direct_finalize's slot decode).  Returns None when
    ineligible, else (doms, G, strides, key_dtypes, key_dicts)."""
    doms = []
    for c in key_cols:
        if c.nulls is not None:
            return None
        if c.dictionary is not None:
            doms.append(len(c.dictionary))
        elif c.values.dtype == torch.bool:
            doms.append(2)
        else:
            return None
    G = 1
    for d in doms:
        G *= max(1, d)
    if key_names and G > gmax:
        return None
    G = max(1, G)
    doms = tuple(max(1, d) for d in doms)
    strides, s = [], G
    for d in doms:
        s //= d
        strides.append(s)
    key_dicts = {k: c.dictionary for k, c in zip(key_names, key_cols)
                 if c.dictionary is not None}
    return (doms, G, tuple(strides),
            tuple(c.values.dtype for c in key_cols), key_dicts)
