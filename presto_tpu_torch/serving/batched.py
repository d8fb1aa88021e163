"""Micro-batched execution of one compiled point-query template (the port
of presto_tpu/serving/batched.py).

The serving tier's bound-parameter design makes concurrent EXECUTE..USING
requests against the same canonical plan differ ONLY in the
bound-parameter vector (`Batch.with_params`, exec/lowering.py).  A
BatchedTemplateRunner runs N such lanes in ONE pass over the template's
scan: each scan chunk is decoded once and shared, and each lane applies
its own filter, projection and direct-slot aggregation update
(`operators.agg_direct_update`) with its own parameters, with no host
sync per lane.  Per-lane states are then finalized, and the projections
above the aggregation applied, lane by lane, so each query still gets
its own result page.

Eligibility is the envelope of the torch fused chain's direct mode
(exec/pipeline.py run_fused: a one-hot grid over closed small key
domains, BASIC_AGGS) under scan_kernel="xla", the only configuration in
which the sequential run takes that path: under "auto" and "pallas" the
sequential run launches kernel #1 on the card (its plain version on the
CPU), so the batch declines and the lanes run solo.  Within the
envelope every lane replays its solo run's exact update sequence: the
same scan chunks (pruned with the lane's own bound values), the same
steps of contiguous chunks (`pipeline._chain_steps`) and the same
reductions over tensors of the same shapes, so ints and float sums are
bit-identical to the solo run.  The lanes are a Python loop inside each
step, not a stacked lane axis: a (lanes, groups, rows) reduction may sum
in another order than the solo run's (groups, rows) one.

Batch widths are padded to powers of two, as the reference pads them
(padding lanes replicate lane 0's parameters and are discarded at demux).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

from ..common.types import DoubleType, RealType
from ..exec import operators as ops
from ..exec.batch import Batch, batch_to_page
from ..exec.fused import assemble_chain
from ..exec.lowering import canonical_name, expr_has_params
from ..exec.pipeline import (CHAIN_STEP_ROWS, PROBE_ROWS, _chain_steps,
                             _direct_mode_info, _rewrite_agg_masks)
from ..spi import plan as P


class BatchedTemplateRunner:
    """One compiled template's batched executor.  Built (once, cached on
    the owning PlanCompiler) from a checked-out canonical-cache entry;
    `run` takes per-lane (parameter vector, host fingerprint) pairs and
    returns one host Page per lane."""

    def __init__(self, compiler, output, chain, aux, expands, leaf_cap,
                 specs, input_exprs, key_names, info, projects):
        self.compiler = compiler
        self.output = output
        self.chain = chain
        self.aux = aux
        self.expands = expands
        self.leaf_cap = leaf_cap
        self.specs = specs
        self.input_exprs = input_exprs
        self.key_names = key_names
        self.doms, self.G, self.strides, self.kdts, self.kdicts = info
        self.projects = projects        # ProjectNodes root->down above agg
        self.low = compiler.lowering

    # -- one lane's pieces of the sequential direct path -------------------

    def _codes(self, b: Batch):
        """pipeline.py stride_codes: the combined direct-slot code."""
        import torch
        codes = None
        for k, stride in zip(self.key_names, self.strides):
            c = b.columns[k].values.to(torch.int64) * stride
            codes = c if codes is None else codes + c
        if codes is None:       # global aggregation: one group
            codes = torch.zeros(b.capacity, dtype=torch.int64,
                                device=b.device)
        return codes

    def _agg_inputs(self, b: Batch, params):
        return {out: (None if e is None else self.low.eval(
            e, b.with_params(params if expr_has_params(e) else None)))
            for out, e in self.input_exprs.items()}

    def _finish(self, state, params) -> Batch:
        """Finalize, then the projections above the aggregation and the
        OutputNode's renaming, as the sequential run applies them."""
        out = ops.agg_direct_finalize(
            state, self.specs, self.key_names, self.doms, self.kdts,
            self.kdicts, force_row=not self.key_names)
        for node in reversed(self.projects):
            out = Batch({v.name: self.low.eval(
                e, out.with_params(params if expr_has_params(e) else None))
                for v, e in node.assignments.items()}, out.mask)
        inner = [v.name for v in self.output.source.output_variables]
        outer = [v.name for v in self.output.outputs]
        return Batch({o: out.columns[i] for i, o in zip(inner, outer)},
                     out.mask)

    def _steps(self, fingerprint) -> tuple:
        """The lane's solo steps: its scan chunks, zone-map pruned with its
        own bound values, grouped as the sequential loop groups them."""
        ctx = self.compiler.ctx
        saved = ctx.params_fingerprint
        ctx.params_fingerprint = fingerprint
        try:
            chunks = self.chain.chunks_for(self.expands)
        finally:
            ctx.params_fingerprint = saved
        return tuple(_chain_steps(chunks, self.leaf_cap,
                                  max(1, CHAIN_STEP_ROWS // self.chain.cap)))

    # -- execution --------------------------------------------------------

    def run(self, lanes: List[Tuple]) -> Tuple[List, int, int]:
        """lanes: per-lane (device parameter vector, host fingerprint),
        `sql.canonical.device_params` of each lane's values.  Returns
        (pages, launch_nanos, demux_nanos) with one Page per lane."""
        n = len(lanes)
        width = 1 << max(0, n - 1).bit_length()
        lanes = list(lanes) + [lanes[0]] * (width - n)
        device = self.compiler.ctx.device
        t0 = time.perf_counter_ns()  # lint: allow-wall-clock
        # lanes whose pruned chunk lists agree share one pass (and each
        # decoded chunk); a lane pruned differently runs its own pass
        groups: Dict[tuple, List[int]] = {}
        for i, (_params, fp) in enumerate(lanes):
            groups.setdefault(self._steps(fp), []).append(i)
        states = [None] * width
        for steps, members in groups.items():
            for i in members:
                states[i] = ops.agg_direct_init(self.G, self.specs, device)
            for pos, cnt, cap in steps:
                leaf = self.chain.leaf(pos, cnt, self.aux, cap)
                for i in members:
                    params = lanes[i][0]
                    b = self.chain.apply(leaf, pos, self.aux, self.expands,
                                         params=params)
                    states[i] = ops.agg_direct_update(
                        states[i], b, self._codes(b),
                        self._agg_inputs(b, params), self.specs, self.G)
        outs = [self._finish(states[i], lanes[i][0]) for i in range(n)]
        launch = time.perf_counter_ns() - t0  # lint: allow-wall-clock

        t1 = time.perf_counter_ns()  # lint: allow-wall-clock
        names = [v.name for v in self.output.outputs]
        types = [v.type for v in self.output.outputs]
        pages = [batch_to_page(b, names, types) for b in outs]
        demux = time.perf_counter_ns() - t1  # lint: allow-wall-clock
        return pages, launch, demux


def _eligible(compiler, output) -> Optional[BatchedTemplateRunner]:
    ctx = compiler.ctx
    cfg = ctx.config
    # the sequential execution these lanes must match bit for bit is the
    # torch fused chain's direct mode; decline whenever that path would
    # not run
    if not cfg.fuse_pipelines or ctx.stats is not None:
        return None
    if ctx.memory is not None and ctx.memory.limited:
        return None
    if ctx.params is None:
        return None
    if cfg.scan_kernel != "xla":
        # "auto" and "pallas" run kernel #1 where the direct mode applies
        # (its plain version on the CPU): the lanes run solo, and each
        # launches the kernel
        return None

    projects = []
    node = output.source
    while isinstance(node, P.ProjectNode):
        projects.append(node)
        node = node.source
    if not isinstance(node, P.AggregationNode):
        return None
    agg = _rewrite_agg_masks(node)
    if any(a.distinct for a in agg.aggregations.values()):
        return None
    specs = []
    input_exprs: Dict[str, object] = {}
    for v, a in agg.aggregations.items():
        fname = canonical_name(a.call.display_name)
        args = a.call.arguments
        if fname == "count" and not args:
            fname = "count_star"
        if fname not in ops.BASIC_AGGS:
            return None
        is_float = isinstance(v.type, (DoubleType, RealType))
        specs.append(ops.AggSpec(fname, v.name, is_float, None))
        input_exprs[v.name] = args[0] if args else None
    specs = tuple(specs)
    key_names = tuple(v.name for v in agg.grouping_keys)

    chain = assemble_chain(compiler, agg.source)
    if chain is None or chain.empty:
        return None
    if not chain.has_params:
        return None                 # nothing varies between lanes
    if chain.build_params:
        # the build tables would be a function of the bound constants:
        # not shareable across lanes
        return None
    try:
        prep_res = chain.prep()
    except Exception:   # noqa: BLE001 -- decline, never fail the query
        return None
    if prep_res is None:
        return None
    aux, expands, _deferred = prep_res
    try:
        probe = chain.make(0, 0, aux, expands, PROBE_ROWS)
    except NotImplementedError:
        return None
    key_cols = [probe.columns.get(k) for k in key_names]
    if any(c is None for c in key_cols):
        return None
    info = _direct_mode_info(key_names, key_cols)
    if info is None:
        return None
    return BatchedTemplateRunner(compiler, output, chain, aux, expands,
                                 chain.leaf_cap(expands), specs,
                                 input_exprs, key_names, info, projects)


def batched_runner_for(compiler, output) -> Optional[BatchedTemplateRunner]:
    """Get-or-build the template's batched runner, cached on the owning
    PlanCompiler (the attribute rides the compiler through the PlanCache
    pool's checkin/checkout; a rebuilt compiler re-derives it once).
    Returns None -- and remembers the refusal -- when the template is
    outside the batchable envelope."""
    cached = getattr(compiler, "_batched_runner", None)
    if cached is not None:
        return cached or None       # False == remembered refusal
    runner = _eligible(compiler, output)
    compiler._batched_runner = runner if runner is not None else False
    return runner


def disable_for(compiler) -> None:
    """A batched drain failed at runtime: pin this compiler's template to
    the sequential path (callers already re-ran the lanes solo)."""
    compiler._batched_runner = False
