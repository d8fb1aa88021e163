"""Plan -> executable pipelines over torch tensors.

The port of presto_tpu/exec/pipeline.py for the ported slices: a
TableScan over device-resident encoded columns, streaming Filter/Project,
Aggregation, MarkDistinct, Sort, TopN, Limit, Window and Output.  An
aggregation over a fused scan -> filter -> project -> join / semi-join
chain runs through the hand-written CUDA scan kernels (direct slots for
G <= 64, exec/kernels/scan_kernel.py; span or hash slots beyond,
exec/kernels/grouped.py; the fanout-1 probes inside them,
exec/kernels/join.py), the join build sides drained from the streaming
sources; after a kernel's metered decline, or under scan_kernel="xla",
the torch fused chain (exec/fused.py FusedChain.make) in the reference's
XLA-chain mode order; without a fused chain, the streaming aggregation.
A WindowNode's functions run in one launch of the CUDA window kernel over
the sorted run (exec/kernels/window.py), operators.window_batch after its
metered decline.  Every tensor is allocated on the task's device
(TaskContext.device).  A plan shape or option outside the slices raises
NotImplementedError naming what is missing (a streaming Join / SemiJoin
and spill among them); nothing falls back quietly.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch

from ..common.page import Page
from ..common.types import DoubleType, RealType, Type
from ..connectors import catalog
from ..spi import plan as P
from ..spi.expr import VariableReferenceExpression
from . import operators as ops
from .batch import Batch, Column, batch_to_page
from .lowering import (Lowering, canonical_name, constant_device_value,
                       expr_has_params)
from .memory import MemoryContext, MemoryPool, batch_bytes

DEFAULT_CAPACITY = 1 << 20
# ceiling on the materialized (keys + aggregate inputs) bytes of the
# fused chain's sort aggregation; beyond it the hashed table takes over
SORT_AGG_MAX_BYTES = 6 << 30
# rows of the empty chunk a fused chain is applied to once, to learn its
# output columns' dtypes, NULL-ability and dictionaries
PROBE_ROWS = 8
# rows the torch fused chain carries through one step: contiguous scan
# chunks are applied together, up to this many rows after the chain's
# fanout expansion (a step's ops cost the host the same at 64K rows as
# at 1M, so fewer, larger steps keep the card busy)
CHAIN_STEP_ROWS = 1 << 20
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
    agg_slots: int = 4096                   # initial group table size
    max_agg_retries: int = 6                # hashed-table collision retries
    splits_per_scan: int = 4
    # device-memory accounting (exec/memory.py); None = unlimited
    memory_budget_bytes: Optional[int] = None
    # query-level memory ceiling (query.max-memory); None = unlimited
    memory_max_query_bytes: Optional[int] = None
    # run an aggregation's scan -> filter/project -> join chain as one
    # fused chain (the CUDA scan kernels, or the torch chain after their
    # decline); False streams it operator by operator, metered as
    # fusionDeclinedDisabled.  Config key task.fuse-pipelines
    fuse_pipelines: bool = True
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
    # CPU tensors); "xla" runs the reference's non-kernel paths in torch:
    # a window or an aggregation meters kernelDeclinedDisabled and runs
    # operators.window_batch or the torch fused chain.
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

        def make_factory(cap2):
            """The scan leaf at chunk capacity cap2 (a fused chain with a
            fanout-k join shrinks its chunks): decode rows [pos, pos+cap2)
            of the resident columns, zeroed past the `valid` live rows."""
            idx0 = torch.arange(cap2, device=device)

            def make(pos, valid, cached):
                live = idx0 < valid
                outs = {}
                for name, colname in zip(names, columns):
                    v = cached[colname].slice_decode(pos, cap2)
                    outs[name] = torch.where(
                        live, v, torch.zeros((), dtype=v.dtype,
                                             device=device))
                return outs, live
            return make

        def gen():
            missing = [c for c in columns if c not in cached_cols]
            if missing:
                raise NotImplementedError(
                    f"ColumnsNotResident: {missing} (on-the-fly generation "
                    f"is not ported)")
            make = make_factory(cap)
            for split in splits:
                for pos, n in split_chunks(split):
                    outs, live = make(pos, n, cached_cols)
                    yield Batch({name: Column(outs[name], None, dicts[name])
                                 for name in names}, live)

        src = BatchSource(gen, names, types)
        src.fused_scan = {
            "make_factory": make_factory,
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
        sorted run.  After a metered WindowFunctionShape decline, and
        under scan_kernel="xla" (metered Disabled), ops.window_batch
        computes them, as in the reference; a failed memory reservation
        (WindowInputSize) is metered and raises."""
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
            kres = None
            if self.ctx.config.scan_kernel == "xla":
                self._meter_declined("Disabled")
            else:
                from .kernels import window as wk
                kres = wk.try_window_kernel(
                    merged, part_names, orderings, specs,
                    declined=self._meter_declined,
                    runtime_stats=self.ctx.runtime_stats,
                    pool=self.ctx.memory)
            yield kres if kres is not None else ops.window_batch(
                merged, part_names, orderings, specs)
        return BatchSource(gen, out_names, out_types)

    def _compile_MarkDistinctNode(self, node: P.MarkDistinctNode
                                  ) -> BatchSource:
        """Marker = first row of its distinct-key group: row_number()
        partitioned by the distinct keys (the window path), marker =
        (rn == 1)."""
        from ..common.types import BIGINT, BOOLEAN
        from ..spi.expr import CallExpression, call, constant
        rn = VariableReferenceExpression(f"{node.marker.name}__rn", BIGINT)
        win = P.WindowNode(
            node.id + ".rn", node.source, list(node.distinct_variables),
            None, {rn: P.WindowFunction(
                CallExpression("row_number", BIGINT, []), None)})
        assigns = {v: v for v in node.source.output_variables}
        assigns[node.marker] = call("eq", BOOLEAN, rn, constant(1, BIGINT))
        return self._compile(P.ProjectNode(node.id + ".mark", win, assigns))

    # -- aggregation ------------------------------------------------------
    def _compile_AggregationNode(self, node: P.AggregationNode) -> BatchSource:
        """Aggregation in the reference's mode order.  Over a fused scan
        chain: the CUDA scan kernels first (direct slots for G <= 64, span
        or hashed slots beyond; the chain's fanout-1 probes inside the
        launch); after a kernel's metered decline, or under
        scan_kernel="xla", the torch fused chain: direct one-hot, static
        span, runtime span (anchor key + dependency check), sort
        aggregation, hashed table with collision retries.  Otherwise the
        streaming aggregation over the compiled source (direct or hashed
        table, restarted on the hashed path when a NULL key shows up; the
        sort aggregation for approx_percentile).  Spill is not ported."""
        node = _rewrite_agg_masks(node)
        src_node = node.source
        key_vars = node.grouping_keys
        key_names = tuple(v.name for v in key_vars)
        out_names = [v.name for v in key_vars] + \
            [v.name for v in node.aggregations]
        out_types = ([v.type for v in key_vars]
                     + [v.type for v in node.aggregations])
        low = self.lowering
        specs = []
        input_exprs: Dict[str, Optional[object]] = {}
        input_exprs2: Dict[str, object] = {}
        for v, agg in node.aggregations.items():
            fname = canonical_name(agg.call.display_name)
            args = agg.call.arguments
            if fname == "count" and not args:
                fname = "count_star"
            is_float = isinstance(v.type, (DoubleType, RealType))
            param = None
            if fname == "approx_percentile" and len(args) > 1:
                param = float(args[1].value)
                is_float = isinstance(args[0].type, (DoubleType, RealType))
            if fname in ops.HLL_AGGS:
                # an optional max standard error -> the register count
                param = (ops.hll_buckets_for_error(float(args[1].value))
                         if len(args) > 1 else ops.HLL_DEFAULT_BUCKETS)
            if fname in ops.CORR_AGGS and len(args) > 1:
                input_exprs2[v.name] = args[1]
            specs.append(ops.AggSpec(fname, v.name, is_float, param))
            input_exprs[v.name] = args[0] if args else None
        specs = tuple(specs)
        basic_specs = all(s.name in ops.BASIC_AGGS for s in specs)
        sort_only_specs = any(s.name in ops.SORT_ONLY_AGGS for s in specs)
        cfg = self.ctx.config
        device = self.ctx.device
        fused_cache: dict = {}
        initial_slots = _initial_slots(node, key_names, cfg.agg_slots)
        est_state_bytes = _agg_state_bytes(initial_slots, key_names, specs)

        def _agg_exprs(b):
            return {out: (None if e is None else
                          low.eval(e, b.with_params(self._params_for(e))))
                    for out, e in input_exprs.items()}

        def _agg_exprs2(b):
            return {out: low.eval(e, b.with_params(self._params_for(e)))
                    for out, e in input_exprs2.items()}

        def stride_codes(b, strides):
            codes = None
            for k, stride in zip(key_names, strides):
                c = b.columns[k].values.to(torch.int64) * stride
                codes = c if codes is None else codes + c
            if codes is None:       # global aggregation: one group
                codes = torch.zeros(b.capacity, dtype=torch.int64,
                                    device=b.device)
            return codes

        def hash_update(num_slots, salt):
            def update(st, b):
                return ops.agg_update(
                    st, b, [b.columns[k] for k in key_names], _agg_exprs(b),
                    specs, num_slots, salt, key_names, _agg_exprs2(b))
            return update

        def hash_finalize(state, key_dicts):
            if not key_names and not bool(state["__occupied"].any()):
                # a global aggregation over empty input: one row
                state["__occupied"][0] = True
            return ops.agg_finalize(state, specs, key_names, key_dicts)

        # -- the streaming aggregation -----------------------------------
        def run_once(num_slots: int, salt: int, allow_direct: bool = True):
            batches = self._compile(src_node).batches()
            state, update, direct = None, None, None
            key_dicts: Dict[str, Tuple[str, ...]] = {}
            for batch in batches:
                if state is None:
                    key_cols = [batch.columns[k] for k in key_names]
                    key_dicts = {k: c.dictionary
                                 for k, c in zip(key_names, key_cols)
                                 if c.dictionary is not None}
                    # closed small domains: the combined code is the slot
                    info = (_direct_mode_info(key_names, key_cols)
                            if basic_specs and allow_direct else None)
                    if info is not None:
                        doms, G, strides, kdts, _kd = info
                        direct = (doms, kdts)
                        state = ops.agg_direct_init(G, specs, device)

                        def update(st, b, _s=strides, _g=G):
                            return ops.agg_direct_update(
                                st, b, stride_codes(b, _s), _agg_exprs(b),
                                specs, _g)
                    else:
                        state = ops.agg_init(
                            num_slots, specs, key_names,
                            [c.values.dtype for c in key_cols], device)
                        update = hash_update(num_slots, salt)
                if direct is not None and any(
                        batch.columns[k].nulls is not None
                        for k in key_names):
                    # direct mode was chosen on a NULL-free first batch,
                    # but this one carries a NULL key: the code grid has
                    # no NULL slot, so the whole aggregation restarts on
                    # the hashed path (the source closed first)
                    batches.close()
                    return run_once(num_slots, salt, allow_direct=False)
                state = update(state, batch)
            if state is None:
                state = ops.agg_init(num_slots, specs, key_names,
                                     [torch.int64] * len(key_names), device)
            return state, key_dicts, direct

        def run_retrying():
            num_slots, salt = initial_slots, 0
            for _attempt in range(cfg.max_agg_retries):
                state, key_dicts, direct = run_once(num_slots, salt)
                # one host sync per pass
                if direct is not None or not bool(state["__collision"]):
                    return state, key_dicts, direct
                num_slots *= 2
                salt += 1
            raise RuntimeError("aggregation collision retries exhausted")

        def sortagg(b: Batch) -> Batch:
            return ops.sort_group_aggregate(b, key_names, _agg_exprs(b),
                                            specs, _agg_exprs2(b))

        def drain_sort_input():
            """Drain the source once under per-batch reservation: (merged,
            None) when the whole input fit the budget, else (None, the
            stream of the collected batches and the rest of the source,
            still reserved)."""
            pool = self.ctx.memory
            collected, reserved = [], 0
            it = self._compile(src_node).batches()
            over_batch = None
            for b in it:
                nb = batch_bytes(b)
                if pool.try_reserve(nb):
                    collected.append(b)
                    reserved += nb
                else:
                    over_batch = b
                    break
            if over_batch is None:
                merged = _concat(collected) if collected else None
                pool.free(reserved)
                if merged is None:
                    # a zero-batch source: an all-masked batch, so a
                    # global aggregate still yields its row
                    from .fused import _empty_build_batch
                    merged = _empty_build_batch(src_node, device)
                return merged, None

            def stream():
                try:
                    yield from collected
                    yield over_batch
                    yield from it
                finally:
                    pool.free(reserved)
            return None, stream()

        # -- the fused chain -----------------------------------------------
        def _meter(name: str, n: int) -> None:
            rs = self.ctx.runtime_stats
            if rs is not None:
                rs.add(name, n)

        def _fusion_declined(reason: str) -> None:
            _meter(f"fusionDeclined{reason}", 1)

        def get_fused():
            if "chain" in fused_cache:
                return fused_cache["chain"]
            fused_cache["chain"] = None
            if not cfg.fuse_pipelines:
                _fusion_declined("Disabled")
                return None
            # masks were lowered to IF inputs by _rewrite_agg_masks
            if any(a.distinct for a in node.aggregations.values()):
                _fusion_declined("DistinctAgg")
                return None
            if any(s.name in ops.HLL_AGGS for s in specs):
                # HLL registers live in the hashed table only
                _fusion_declined("HllAgg")
                return None
            from .fused import assemble_chain
            chain = assemble_chain(self, src_node)
            if chain is None:
                _fusion_declined("PlanShape")
            elif chain.empty:
                _fusion_declined("NoChunks")
                chain = None
            fused_cache["chain"] = chain
            return chain

        def run_fused(chain) -> Optional[Batch]:
            """A fused chain to its finalized output Batch, or None for the
            streaming aggregation."""
            pool = self.ctx.memory
            if pool.limited:
                _fusion_declined("BudgetedPool")
                return None
            # the chain's build tables, built once per compiled aggregation
            # (generated data is immutable); a build subtree with bound
            # parameters rebuilds when the values change
            pfp = (self.ctx.params_fingerprint
                   if (chain.has_params or chain.build_params) else None)
            prep_res = fused_cache.get("prep")
            if prep_res is not None and chain.build_params \
                    and fused_cache.get("prep_fp") != pfp:
                prep_res = None
            if prep_res is None:
                prep_res = chain.prep()
                if prep_res is None:
                    _fusion_declined("PrepFanout")
                    return None
                fused_cache["prep"], fused_cache["prep_fp"] = prep_res, pfp
                fused_cache.pop("probe", None)
            aux, expands = prep_res

            def chunks_and_steps():
                """The pruned scan chunks and the chain's steps over them,
                found once per bound-parameter fingerprint when the torch
                chain first needs them (a kernel launch reads its own
                grid)."""
                key = ("steps", expands, self.ctx.params_fingerprint,
                       CHAIN_STEP_ROWS)
                res = fused_cache.get(key)
                if res is None:
                    chunks = chain.chunks_for(expands)
                    res = fused_cache[key] = (chunks, _chain_steps(
                        chunks, chain.leaf_cap(expands),
                        max(1, CHAIN_STEP_ROWS // chain.cap)))
                return res
            # the chain's output columns (dtype, NULL-ability, dictionary):
            # the chain applied once to an empty chunk of PROBE_ROWS rows
            probe = fused_cache.get("probe")
            if probe is None:
                try:
                    probe = chain.make(0, 0, aux, expands, PROBE_ROWS)
                except NotImplementedError:
                    _fusion_declined("ProbeUnsupported")
                    return None
                fused_cache["probe"] = probe
            key_cols = [probe.columns.get(k) for k in key_names]
            if any(c is None for c in key_cols):
                _fusion_declined("KeyMissing")
                return None
            key_dicts = {k: c.dictionary for k, c in zip(key_names, key_cols)
                         if c.dictionary is not None}
            key_dtypes = tuple(c.values.dtype for c in key_cols)

            def loop(update, state, mode):
                """The chunks through the chain into `state`: a Python loop
                of device ops with no host sync.  Metered per pass as
                torchChain{mode}, torchChainChunks and torchChainSteps."""
                chunks, steps = chunks_and_steps()
                _meter(f"torchChain{mode}", 1)
                _meter("torchChainChunks", len(chunks))
                _meter("torchChainSteps", len(steps))
                for pos, cnt, cap in steps:
                    state = update(state, chain.make(pos, cnt, aux, expands,
                                                     cap))
                return state

            declined = self._meter_declined
            info = (_direct_mode_info(key_names, key_cols)
                    if basic_specs else None)
            if info is not None:
                doms, G, strides, kdts, kdicts = info
                if cfg.scan_kernel == "xla":
                    declined("Disabled")
                else:
                    from .kernels.scan_kernel import try_direct_scan_kernel
                    kres = try_direct_scan_kernel(
                        chain, self.ctx.params, specs=specs,
                        key_names=key_names, strides=strides, G=G,
                        agg_inputs=input_exprs, cache=fused_cache,
                        declined=declined,
                        runtime_stats=self.ctx.runtime_stats,
                        aux=aux, expands=expands, pool=pool,
                        dma=cfg.scan_kernel_dma)
                    if kres is not None:
                        state, _counts, _n_blocks = kres
                        return ops.agg_direct_finalize(
                            state, specs, key_names, doms, kdts, kdicts,
                            force_row=not key_names)
                state = loop(lambda st, b: ops.agg_direct_update(
                    st, b, stride_codes(b, strides), _agg_exprs(b), specs,
                    G), ops.agg_direct_init(G, specs, device), "Direct")
                return ops.agg_direct_finalize(
                    state, specs, key_names, doms, kdts, kdicts,
                    force_row=not key_names)
            elif cfg.scan_kernel == "xla":
                declined("Disabled")
            elif not basic_specs:
                # moment / corr / percentile accumulators have no kernel
                # shape: the torch chain keeps them
                declined("AggFunctionShape")
            else:
                # grouped (G > 64): span slots when the closed key domains
                # fit the span gate, hashed open addressing otherwise
                from .kernels.grouped import try_grouped_scan_kernel
                from .kernels.scan_kernel import KERNEL_SPAN_MAX_GROUPS
                kres = try_grouped_scan_kernel(
                    chain, self.ctx.params, specs=specs,
                    key_names=key_names, key_dtypes=key_dtypes,
                    key_dicts=key_dicts,
                    span_info=_direct_mode_info(
                        key_names, key_cols, gmax=KERNEL_SPAN_MAX_GROUPS),
                    est_slots=initial_slots, agg_inputs=input_exprs,
                    cache=fused_cache, declined=declined,
                    pool=pool, state_bytes=_agg_state_bytes,
                    runtime_stats=self.ctx.runtime_stats, aux=aux,
                    expands=expands, dma=cfg.scan_kernel_dma)
                if kres is not None:
                    out, _counts, _n_blocks = kres
                    return _maybe_compact(out)

            # static span: closed dictionary / bool domains beyond the
            # grid; the combined stride code indexes the accumulators
            info = (_direct_mode_info(key_names, key_cols,
                                      gmax=ops.SPAN_AGG_MAX_GROUPS)
                    if basic_specs else None)
            if info is not None:
                doms, G, strides, kdts, kdicts = info
                nbytes = G * 24 * max(1, len(specs))
                if not pool.try_reserve(nbytes):
                    return None
                try:
                    state = loop(lambda st, b: ops.agg_span_update(
                        st, b, stride_codes(b, strides), _agg_exprs(b),
                        specs, G), ops.agg_span_init(G, specs, device),
                        "StaticSpan")
                    slot = torch.arange(G, dtype=torch.int64, device=device)
                    key_arrays = {}
                    stride = G
                    for k, dom, dt in zip(key_names, doms, kdts):
                        stride //= dom
                        key_arrays[k] = ((slot // stride) % dom).to(dt)
                    return _maybe_compact(ops.agg_span_finalize(
                        state, specs, key_names, key_arrays, kdicts))
                finally:
                    pool.free(nbytes)

            # runtime span: one integer anchor key indexes the accumulators
            # (base + slot); the other grouping keys must be constant within
            # an anchor group, verified per pass (depkey_*); on a violation
            # the next candidate, else the sort aggregation
            candidates = [i for i, c in enumerate(key_cols)
                          if c.nulls is None and c.values.dtype in
                          (torch.int64, torch.int32, torch.int16)]
            if basic_specs and candidates:
                cand_names = tuple(key_names[i] for i in candidates)
                span_key = ("span_range", cand_names, expands, pfp)
                ranges = fused_cache.get(span_key)
                if ranges is None:
                    _meter("torchChainSpanProbe", 1)
                    los = torch.full((len(cand_names),), ops.INT64_MAX,
                                     dtype=torch.int64, device=device)
                    his = torch.full_like(los, ops.INT64_MIN)
                    for pos, cnt, cap in chunks_and_steps()[1]:
                        b = chain.make(pos, cnt, aux, expands, cap)
                        vs = torch.stack([b.columns[k].values.to(torch.int64)
                                          for k in cand_names])
                        m = b.mask[None, :]
                        los = torch.minimum(los, torch.where(
                            m, vs, torch.full_like(vs, ops.INT64_MAX))
                            .amin(dim=1))
                        his = torch.maximum(his, torch.where(
                            m, vs, torch.full_like(vs, ops.INT64_MIN))
                            .amax(dim=1))
                    # one host sync for the range probe
                    ranges = list(zip(los.tolist(), his.tolist()))
                    fused_cache[span_key] = ranges
                # anchor order: "key"-named columns widest span first (the
                # finest key is the likeliest group identity), then the
                # rest; the first anchor that verifies is cached
                viable = []
                for ci, (lo, hi) in zip(candidates, ranges):
                    span = hi - lo + 1
                    if hi >= lo and span <= ops.SPAN_AGG_MAX_GROUPS:
                        rank = 0 if "key" in key_names[ci].lower() else 2
                        viable.append((rank, -span, ci, span, lo))
                viable.sort()
                anchor_key = ("span_anchor", cand_names, expands, pfp)
                cached_anchor = fused_cache.get(anchor_key)
                if cached_anchor is not None:
                    # -1: every candidate failed once
                    viable = [v for v in viable if v[2] == cached_anchor]
                attempts = [(v[2], v[3], v[4]) for v in viable[:2]]
                if not attempts and cached_anchor is None:
                    fused_cache[anchor_key] = -1
                for ci, span, lo in attempts:
                    dep_idx = [i for i in range(len(key_names)) if i != ci]
                    dep_names = tuple(key_names[i] for i in dep_idx)
                    kname = key_names[ci]
                    G = 1 << (span - 1).bit_length()
                    nacc = max(1, len(specs)) + len(dep_names)
                    if not pool.try_reserve(G * 24 * nacc):
                        return None
                    try:
                        def update(st, b, _k=kname, _dep=dep_names, _g=G,
                                   _base=lo):
                            codes = b.columns[_k].values.to(torch.int64) \
                                - _base
                            st = ops.agg_span_update(st, b, codes,
                                                     _agg_exprs(b), specs, _g)
                            return ops.depkey_update(
                                st, b, codes,
                                {k: b.columns[k] for k in _dep}, _g)
                        state = loop(update, {
                            **ops.agg_span_init(G, specs, device),
                            **ops.depkey_init(G, dep_names, device)},
                            "RuntimeSpan")
                        dep_ok = ops.depkey_verify(state, state["__seen"],
                                                   dep_names)
                        # one host sync for the dependency check
                        if dep_names and not bool(dep_ok):
                            continue
                        fused_cache[anchor_key] = ci
                        key_arrays = {kname: (
                            lo + torch.arange(G, dtype=torch.int64,
                                              device=device))
                            .to(key_dtypes[ci])}
                        key_nulls = {}
                        for i in dep_idx:
                            k = key_names[i]
                            key_arrays[k] = ops._depkey_restore(
                                state[f"__dep_{k}$min"], key_dtypes[i])
                            key_nulls[k] = state[f"__dep_{k}$nulls"] > 0
                        return _maybe_compact(ops.agg_span_finalize(
                            state, specs, key_names, key_arrays, key_dicts,
                            key_nulls))
                    finally:
                        pool.free(G * 24 * nacc)
                else:
                    if attempts and cached_anchor is None:
                        fused_cache[anchor_key] = -1

            # high-cardinality keys: the sort aggregation over the chain's
            # stacked output, when it fits SORT_AGG_MAX_BYTES
            kprod = 1
            for k in expands:
                kprod *= k
            width = len(key_names) + sum(
                1 for e in input_exprs.values() if e is not None)
            est_mat = chain.total_rows * kprod * width * 9
            if (est_mat <= SORT_AGG_MAX_BYTES or sort_only_specs) \
                    and pool.try_reserve(est_mat):
                try:
                    chunks, steps = chunks_and_steps()
                    _meter("torchChainSortAgg", 1)
                    _meter("torchChainChunks", len(chunks))
                    _meter("torchChainSteps", len(steps))
                    parts = []
                    for pos, cnt, cap in steps:
                        b = chain.make(pos, cnt, aux, expands, cap)
                        cols = {k: b.columns[k] for k in key_names}
                        for out, col in _agg_exprs(b).items():
                            if col is not None:
                                cols["$in_" + out] = col
                        for out, col in _agg_exprs2(b).items():
                            cols["$in2_" + out] = col
                        parts.append(Batch(cols, b.mask))
                    flat = _concat(parts)
                    inputs = {s.output: flat.columns.get("$in_" + s.output)
                              for s in specs}
                    inputs2 = {s.output: flat.columns["$in2_" + s.output]
                               for s in specs if s.name in ops.CORR_AGGS}
                    del parts
                    return _maybe_compact(ops.sort_group_aggregate(
                        Batch({k: flat.columns[k] for k in key_names},
                              flat.mask), key_names, inputs, specs, inputs2))
                finally:
                    pool.free(est_mat)
            if sort_only_specs:
                # percentiles need value-ordered segments: the streaming
                # drain takes over
                return None

            # the hashed table, sized from the scan row count; collision
            # retries double it with a new salt
            num_slots = max(cfg.agg_slots, 1 << (
                min(2 * chain.total_rows, 1 << 22) - 1).bit_length())
            salt = 0
            for _attempt in range(cfg.max_agg_retries):
                est = _agg_state_bytes(num_slots, key_names, specs)
                if not pool.try_reserve(est):
                    return None
                try:
                    state = loop(hash_update(num_slots, salt), ops.agg_init(
                        num_slots, specs, key_names, key_dtypes, device),
                        "Hash")
                    # one host sync per pass
                    if not bool(state["__collision"]):
                        return _maybe_compact(hash_finalize(state,
                                                            key_dicts))
                finally:
                    pool.free(est)
                num_slots *= 2
                salt += 1
            raise RuntimeError("fused aggregation collision retries "
                               "exhausted")

        def gen():
            # the reference's grouped (lifespan) runner is not ported: a
            # fused chain runs whole
            fused = get_fused()
            if fused is not None:
                out = run_fused(fused)
                if out is not None:
                    yield out
                    return
            pool = self.ctx.memory
            _meter("torchStreamingAggregation", 1)
            if sort_only_specs:
                if any(s.name in ops.HLL_AGGS for s in specs):
                    # percentiles need the sort path, HLL the hashed table
                    raise NotImplementedError(
                        "approx_percentile and approx_distinct in the "
                        "same aggregation are not supported; split the "
                        "query into two aggregations")
                merged, stream = drain_sort_input()
                if stream is None:
                    yield _maybe_compact(sortagg(merged))
                    return
                stream.close()
                raise NotImplementedError(
                    f"sort-aggregation input over the memory budget "
                    f"{pool.budget} bytes: spill is not ported")
            got = not key_names or pool.try_reserve(est_state_bytes)
            if not got:
                raise NotImplementedError(
                    f"aggregation table over the memory budget "
                    f"{pool.budget} bytes: spill is not ported")
            try:
                state, key_dicts, direct = run_retrying()
                if direct is not None:
                    yield ops.agg_direct_finalize(
                        state, specs, key_names, direct[0], direct[1],
                        key_dicts, force_row=not key_names)
                    return
                yield hash_finalize(state, key_dicts)
            finally:
                if key_names:
                    pool.free(est_state_bytes)
        return BatchSource(gen, out_names, out_types)


def _chain_steps(chunks, leaf_cap: int, per_step: int):
    """(pos, rows, capacity) steps of the torch fused chain: runs of up to
    `per_step` contiguous scan chunks, each but a run's last one full, as
    one step of per_step x leaf_cap rows or fewer (the scan leaf decodes
    [pos, pos + capacity), inside the resident columns' padding)."""
    steps = []
    for pos, cnt in chunks:
        if steps:
            p0, n0, c0 = steps[-1]
            if n0 == c0 and p0 + n0 == pos and c0 < per_step * leaf_cap:
                steps[-1] = (p0, n0 + cnt, c0 + leaf_cap)
                continue
        steps.append((pos, cnt, leaf_cap))
    return steps


def _rewrite_agg_masks(node: P.AggregationNode) -> P.AggregationNode:
    """Aggregation masks (FILTER (WHERE ...) / the mask channel) as masked
    inputs: every aggregate ignores NULL inputs, so agg(x) MASK m ==
    agg(IF(m, x, NULL)) and count(*) MASK m == count(IF(m, 1, NULL))."""
    if not any(a.mask is not None for a in node.aggregations.values()):
        return node
    from ..common.types import BIGINT
    from ..spi.expr import CallExpression, ConstantExpression, special
    aggs = {}
    for v, a in node.aggregations.items():
        if a.mask is None:
            aggs[v] = a
            continue
        call_ = a.call
        if call_.arguments:
            arg0 = call_.arguments[0]
            masked = special("IF", arg0.type, a.mask, arg0,
                             ConstantExpression(None, arg0.type))
            call_ = CallExpression(call_.display_name, call_.type,
                                   [masked] + list(call_.arguments[1:]))
        else:                       # count(*)
            masked = special("IF", BIGINT, a.mask,
                             ConstantExpression(1, BIGINT),
                             ConstantExpression(None, BIGINT))
            call_ = CallExpression(call_.display_name, call_.type, [masked])
        aggs[v] = P.Aggregation(call_, a.distinct, None)
    return P.AggregationNode(node.id, node.source, aggs,
                             node.grouping_keys, node.step)


def _initial_slots(node: P.AggregationNode, key_names, agg_slots: int) -> int:
    """The hash table's first size: agg_slots, raised to the pow2 ceiling
    of twice the optimizer's group estimate (~2x probing headroom), the
    estimate term clamped to 2**20 so a wild overestimate cannot blow up
    device memory."""
    if not key_names:
        return agg_slots
    try:
        from ..sql.stats import StatsCalculator
        est_groups = StatsCalculator().rows(node)
    except Exception:   # noqa: BLE001 -- an estimate only
        est_groups = None
    if not est_groups:
        return agg_slots
    est_based = 1 << max(0, (int(2 * est_groups) - 1).bit_length())
    return max(agg_slots, min(est_based, 1 << 20))


def _agg_state_bytes(num_slots: int, key_names, specs) -> int:
    """Accumulator footprint estimate of a hash table (hash + occupied +
    per-key value/null + per-aggregate state columns + HLL registers),
    the reference's one formula for every aggregation budget check."""
    return num_slots * (16 + 12 * len(key_names) + 24 * max(1, len(specs))
                        + ops.hll_state_bytes(specs))


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
