"""Grouped aggregation inside the fused scan (more than 64 groups).

The port of presto_tpu/exec/kernels/grouped.py.  The decode -> filter ->
project chain of the direct kernel stays; the aggregation tail takes one
of two slot-addressing modes, chosen as the reference chooses them:

  span   closed dictionary / boolean key domains whose stride product
         fits KERNEL_SPAN_MAX_GROUPS: the combined stride code IS the
         slot.  The state is agg_span_init's (= agg_direct_init's), and
         finalize rebuilds the key values from the slot index.
         Kernel: generated per chain shape like the direct kernel
         (codegen.py generate_span, NVRTC; wrapper scan_span, plain
         version scan_span_plain: agg_span_update).
  hash   everything else (open integer / decimal domains, mixed keys):
         an open-addressing table of 64-bit key hashes in device memory,
         claimed with atomicCAS and probed linearly for PROBE_ROUNDS
         slots.  A row still unplaced sets the collision flag; the host
         then doubles the table and relaunches with a new salt, up to
         KERNEL_HASH_MAX_SLOTS.  Kernel: csrc/scan_grouped.cu (wrapper
         scan_hash, plain version scan_hash_plain: agg_update).
         The kernel's slot layout differs from agg_update's; the groups,
         keyed by their key values, are the same.

An estimate over twice the table cap, a failed memory reservation or a
collision at the cap declines with AggGroupCardinality (the caller
raises: the torch fused chain that would take over is not ported yet).
A chain's fanout-1 join and semi-join probe steps run inside both modes'
launches (kernel #5, join.py), as in the direct kernel, and so does the
stage ring of dma="double" (kernel #2, scan_kernel.py ScanPlan.staging): a
persistent CTA keeps the next stages of the arrays its plan stages in
flight, across work items, while the current tile computes.  Where a
launch keeps its tables (on chip in each CTA's shared memory, or device
memory) is one decision, ScanPlan.layout, which the wrappers, the span
kernel's source, partial_bytes and the reservations all read.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .. import operators as ops
from ..batch import Column
from . import scan_kernel as sk
from .scan_kernel import (GROUPED_SUBTILE_ROWS, KERNEL_HASH_MAX_SLOTS,
                          ScanPlan, aligned_grid, block_rows_for,
                          cached_plan, check_launch_inputs, count_launch,
                          gather_encoded_arrays, init_outputs, join_kwargs,
                          check_dma, launch_staging, launch_tensors,
                          meter_kernel_run, plan_joins, plain_row_groups,
                          stacked_state, stage_ring_counts, state_of,
                          to_device, word_values)
# device memory the device-memory path's per-warp float partials may take;
# past it the grid has fewer CTAs
FLOAT_PARTIAL_BYTES = 1 << 29
# the reduce folds each slot's partials in REDUCE_LANES interleaved
# sequences, then a pairwise tree over them (csrc/scan_common.cuh
# grouped_reduce; reduce_partials)
REDUCE_LANES = 8
# grouped launches per wrapper whose tables stayed in shared memory
ONCHIP_LAUNCHES = {"scan_span": 0, "scan_hash": 0}


class HashTable(NamedTuple):
    """scan_hash's outputs: the keyhash of each slot (EMPTY_SLOT when
    free), each key's value bits (int64) and null flag per slot, the
    accumulator rows, the per-step row counters and the collision flag."""
    keyhash: torch.Tensor        # (S,) int64
    keys: torch.Tensor           # (n_keys, S) int64
    keynull: torch.Tensor        # (n_keys, S) int8
    acc_i: torch.Tensor          # (n_i, S) int64
    acc_f: torch.Tensor          # (max(n_f, 1), S) float64
    counts: torch.Tensor         # (1 + n_steps,) int64
    collision: torch.Tensor      # () bool


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _grid_shape(plan: ScanPlan, n_grid: int, br: int, G: int, device):
    """(rows per CTA slice, slices per grid entry, CTAs) of a launch."""
    rows_per_cta = min(int(br), GROUPED_SUBTILE_ROWS)
    n_sub = -(-int(br) // rows_per_cta)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    lay = plan.layout(G)
    n_ctas = min(n_grid * n_sub, lay.ctas_per_sm * sms)
    if plan.n_f and not lay.on_chip:
        n_ctas = min(n_ctas, FLOAT_PARTIAL_BYTES
                     // (8 * lay.f_tables * plan.n_f * G))
    return rows_per_cta, n_sub, max(1, n_ctas)


def partial_bytes(plan: ScanPlan, n_grid: int, br: int, G: int,
                  device) -> int:
    """Device bytes of a launch's partials: on chip, each CTA's integer
    tables; the float tables of each warp or, on chip where the layout
    keeps one per CTA, of each CTA (none for the plain versions on the
    CPU)."""
    if device.type != "cuda" or not n_grid:
        return 0
    _rows, _sub, n_ctas = _grid_shape(plan, n_grid, br, G, device)
    lay = plan.layout(G)
    return 8 * n_ctas * G * (plan.n_fold * lay.on_chip
                             + plan.n_f * lay.f_tables)


def stage_counts(plan: ScanPlan, columns, grid, br: int, G: int,
                 dma: str):
    """The stage ring's (staged, prefetched) stage copies of a grouped
    launch into G slots (none in single mode, for a plan that stages
    nothing, or on the CPU)."""
    device = columns[0].device
    st = launch_staging(plan, columns, dma, G)
    if st is None or device.type != "cuda" or not grid:
        return 0, 0
    return stage_ring_counts(st, grid, br,
                             *_grid_shape(plan, len(grid), br, G, device))


def span_kernel(plan: ScanPlan, columns, joins=None, dma: str = "single"):
    """The generated span kernel (codegen.SpanKernel) of the plan over
    these columns' encodings, built once per plan, shape and ring for the
    plan's layout."""
    from . import codegen
    staging = launch_staging(plan, columns, dma, plan.G)
    shape = codegen.column_shape(plan, columns, joins)
    key = ("span", shape, staging)
    kern = plan.dev.get(key)
    if kern is None:
        kern = plan.dev[key] = codegen.generate_span(
            plan, shape, staging, plan.layout(plan.G))
    return kern


def _launch(plan: ScanPlan, columns, grid, br: int, params, *, G: int,
            acc_i, acc_f, counts, salt: int = 0, table=None,
            joins=None, dma: str = "single"):
    """One launch of the plan's grouped kernel (plus its reduce) over a
    persistent grid of CTAs that stride over the grid entries'
    GROUPED_SUBTILE_ROWS-row slices: the generated span kernel, or the
    hash kernel of csrc/scan_grouped.cu.  Returns the partials the reduce
    folded, (part_i or None, part_f or None): on chip, the integer rows
    per CTA; the float rows per warp or per CTA (ScanPlan.layout)."""
    device = acc_i.device
    lay = plan.layout(G)
    rows_per_cta, n_sub, n_ctas = _grid_shape(plan, len(grid), br, G, device)
    n_fparts = n_ctas * lay.f_tables
    part_i = (torch.empty((n_ctas, plan.n_fold, G), dtype=torch.int64,
                          device=device) if lay.on_chip else None)
    part_f = (torch.empty((n_fparts, plan.n_f, G), dtype=torch.float64,
                          device=device) if plan.n_f else None)
    if plan.mode == "span":
        _launch_span(plan, columns, grid, br, params, acc_i, acc_f, counts,
                     joins, dma, (rows_per_cta, n_sub, n_ctas), part_i,
                     part_f, n_fparts)
        return part_i, part_f
    from .build import load
    fn = load("scan_grouped").scan_grouped_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                    ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int]
                   + [ctypes.c_void_p] * 9
                   + [ctypes.c_longlong] + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    n_params = 0 if params is None else int(params.numel())
    ln = launch_tensors(plan, columns, grid, device, joins, dma, n_params,
                        lay.table_bytes, G)

    def ptr(t):
        return None if t is None else t.data_ptr()
    keyhash, keys, keynull, meta = table or (None,) * 4
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = fn(ln.plan.data_ptr(), int(ln.plan.numel()),
            ln.grid.data_ptr(), len(grid), int(br), rows_per_cta, n_sub,
            ptr(params) if n_params else None, n_params, int(G), plan.n_i,
            plan.n_f, int(lay.on_chip), lay.f_tables, ptr(part_i),
            acc_i.data_ptr(),
            ptr(part_f), acc_f.data_ptr(), counts.data_ptr(), ptr(keyhash),
            ptr(keys), ptr(keynull), ptr(meta), int(salt), n_ctas,
            plan.threads, ln.stages, ln.passes, ln.stage_tab,
            ln.stage_bytes, ln.smem_bytes, int(plan.ext), stream)
    if rc != 0:
        raise RuntimeError(
            f"scan_grouped ({plan.mode}) launch failed: CUDA error {rc}")
    return part_i, part_f


def _launch_span(plan: ScanPlan, columns, grid, br: int, params, acc_i,
                 acc_f, counts, joins, dma: str, geometry, part_i, part_f,
                 n_fparts: int) -> None:
    """The generated span kernel and its reduce on the current stream:
    integer rows into part_i per CTA (on chip) or into acc_i by atomics,
    float rows into part_f; the reduce folds them into acc_i / acc_f."""
    from .build import load_generated
    device = acc_i.device
    kern = span_kernel(plan, columns, joins, dma)
    mod = load_generated(kern.source, device.index or 0)
    rows_per_cta, n_sub, n_ctas = geometry
    grid_dev = to_device(np.asarray(grid, dtype=np.int64).T, device)
    n_params = 0 if params is None else int(params.numel())

    def ptr(t):
        return 0 if t is None else t.data_ptr()
    words = word_values(kern, plan, columns, joins, {
        "grid": grid_dev.data_ptr(), "n_grid": len(grid), "br": int(br),
        "rows_per_cta": rows_per_cta, "n_sub": n_sub,
        "params": params.data_ptr() if n_params else 0,
        "part_i": ptr(part_i), "part_f": ptr(part_f),
        "counts": counts.data_ptr(), "acc_i": acc_i.data_ptr(),
        "acc_f": acc_f.data_ptr(), "n_parts": n_ctas,
        "n_fparts": n_fparts})
    stream = torch.cuda.current_stream(device).cuda_stream
    mod.launch("scan_span_gen", n_ctas, kern.threads, kern.smem_bytes,
               stream, words)
    mod.launch("scan_span_reduce", (-(-plan.G // 32), plan.n_i + plan.n_f),
               (32, REDUCE_LANES), 0, stream, words)


def reduce_partials(parts, op: int, init):
    """The reduce's fold of one accumulator row over its partials, in
    plain torch: parts (P, S) -> (S,).  Partial b joins sequence b mod
    REDUCE_LANES, each sequence folds in order from the op's identity,
    the sequences combine as a pairwise tree, ((0 1) (2 3)) ((4 5) (6 7)),
    and the row's initial value comes first.  The order depends only on
    P, so two launches give bit-identical floats."""
    is_f = parts.is_floating_point()
    ident = {sk._R_ADD: 0,
             sk._R_MIN: float("inf") if is_f else ops.INT64_MAX,
             sk._R_MAX: float("-inf") if is_f else ops.INT64_MIN}[op]

    def combine(acc, x):
        if op == sk._R_ADD:
            return acc + x
        pick = x < acc if op == sk._R_MIN else x > acc
        if is_f:    # csrc/scan_common.cuh fcombine: a NaN wins
            pick = torch.isnan(x) | (pick & ~torch.isnan(acc))
        return torch.where(pick, x, acc)
    lanes = []
    for p in range(REDUCE_LANES):
        acc = torch.full(parts.shape[1:], ident, dtype=parts.dtype,
                         device=parts.device)
        for b in range(p, parts.shape[0], REDUCE_LANES):
            acc = combine(acc, parts[b])
        lanes.append(acc)
    w = 1
    while w < REDUCE_LANES:
        for p in range(0, REDUCE_LANES, 2 * w):
            lanes[p] = combine(lanes[p], lanes[p + w])
        w *= 2
    return combine(torch.full_like(lanes[0], init), lanes[0])


def scan_span(plan: ScanPlan, columns, grid, br: int, params, joins=None,
              dma: str = "single"):
    """Span-mode fused scan over `grid` entries (bidx, lo, hi); `joins`
    (join.JoinPlan) holds the probe steps' build operands; dma="double"
    runs the stage ring of the plan's staging.  CUDA tensors launch the
    kernel; CPU tensors run scan_span_plain.  Returns (acc_i (n_i, G),
    acc_f (max(n_f, 1), G), counts)."""
    device = columns[0].device
    check_dma(dma)
    if device.type == "cpu":
        return scan_span_plain(plan, columns, grid, br, params, joins)
    check_launch_inputs(columns, params, device, plan, joins)
    acc_i, acc_f = init_outputs(plan, device)
    counts = torch.zeros(1 + plan.n_steps, dtype=torch.int64, device=device)
    if grid:
        _launch(plan, columns, grid, br, params, G=plan.G, acc_i=acc_i,
                acc_f=acc_f, counts=counts, joins=joins, dma=dma)
        count_launch("scan_span", plan,
                     launch_staging(plan, columns, dma, plan.G) is not None)
        sk.bump(ONCHIP_LAUNCHES, "scan_span", plan.layout(plan.G).on_chip)
    return acc_i, acc_f, counts


def scan_hash(plan: ScanPlan, columns, grid, br: int, params,
              num_slots: int, salt: int, joins=None,
              dma: str = "single") -> HashTable:
    """Hash-mode fused scan into a fresh table of `num_slots` slots keyed
    by hash_columns(keys, salt); `joins` and `dma` as in scan_span.  CUDA
    tensors launch the kernel; CPU tensors run scan_hash_plain."""
    device = columns[0].device
    check_dma(dma)
    if device.type == "cpu":
        return scan_hash_plain(plan, columns, grid, br, params, num_slots,
                               salt, joins)
    check_launch_inputs(columns, params, device, plan, joins)
    n_keys = len(plan.key_programs)
    acc_i, acc_f = init_outputs(plan, device, num_slots)
    counts = torch.zeros(1 + plan.n_steps, dtype=torch.int64, device=device)
    keyhash = torch.full((num_slots,), ops.EMPTY_SLOT, dtype=torch.int64,
                         device=device)
    keys = torch.zeros((n_keys, num_slots), dtype=torch.int64, device=device)
    keynull = torch.zeros((n_keys, num_slots), dtype=torch.int8,
                          device=device)
    # the collision flag and the number of groups claimed
    meta = torch.zeros(2, dtype=torch.int32, device=device)
    if grid:
        _launch(plan, columns, grid, br, params, G=num_slots, acc_i=acc_i,
                acc_f=acc_f, counts=counts, salt=salt,
                table=(keyhash, keys, keynull, meta), joins=joins, dma=dma)
        count_launch("scan_hash", plan,
                     launch_staging(plan, columns, dma, num_slots)
                     is not None)
        sk.bump(ONCHIP_LAUNCHES, "scan_hash", plan.layout(num_slots).on_chip)
    return HashTable(keyhash, keys, keynull, acc_i, acc_f, counts,
                     meta[0] != 0)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def scan_span_plain(plan: ScanPlan, columns, grid, br: int, params,
                    joins=None):
    """scan_span in plain torch: decode, the torch ExprProgram
    evaluator, the join appliers, agg_span_update's scatter."""
    device = columns[0].device
    state = ops.agg_span_init(plan.G, plan.specs, device)
    counts = torch.zeros(1 + plan.n_steps, dtype=torch.int64, device=device)
    for rows in plain_row_groups(plan, columns, grid, br, params, counts,
                                 joins):
        state = ops.agg_span_update(state, rows.batch, rows.codes(),
                                    rows.agg_inputs(), plan.specs, plan.G)
    return stacked_state(plan, state) + (counts,)


def scan_hash_plain(plan: ScanPlan, columns, grid, br: int, params,
                    num_slots: int, salt: int, joins=None) -> HashTable:
    """scan_hash in plain torch: agg_update's scatter-min probe rounds
    over each group of decoded rows, with __seen counted as one more
    count(*)."""
    device = columns[0].device
    n_keys = len(plan.key_programs)
    names = tuple(f"k{j}" for j in range(n_keys))
    specs = plan.specs + (ops.AggSpec("count_star", "__seen"),)
    state = ops.agg_init(num_slots, specs, names, (torch.int64,) * n_keys,
                         device)
    counts = torch.zeros(1 + plan.n_steps, dtype=torch.int64, device=device)
    for rows in plain_row_groups(plan, columns, grid, br, params, counts,
                                 joins):
        key_cols = []
        for prog in plan.key_programs:
            c = rows.run(prog)
            key_cols.append(Column(ops.key_bits(c), c.nulls))
        state = ops.agg_update(state, rows.batch, key_cols,
                               rows.agg_inputs(), specs, num_slots, salt,
                               names)
    acc_i, acc_f = stacked_state(plan, state)
    keys = torch.stack([state[f"__key_{k}"] for k in names])
    keynull = torch.stack([state[f"__keynull_{k}"]
                           for k in names]).to(torch.int8)
    return HashTable(state["__keyhash"], keys, keynull, acc_i, acc_f, counts,
                     state["__collision"])


def hash_state(plan: ScanPlan, table: HashTable, key_names,
               key_dtypes) -> dict:
    """A HashTable as agg_init's state dict (key bits cast back to each
    key's dtype), ready for agg_finalize."""
    state = {"__keyhash": table.keyhash,
             "__occupied": table.keyhash != ops.EMPTY_SLOT,
             "__collision": table.collision}
    for j, (k, dt) in enumerate(zip(key_names, key_dtypes)):
        bits = table.keys[j]
        if dt == torch.float64:
            value = bits.view(torch.float64)
        elif dt == torch.bool:
            value = bits != 0
        else:
            value = bits.to(dt)
        state[f"__key_{k}"] = value
        state[f"__keynull_{k}"] = table.keynull[j] != 0
    state.update(state_of(plan, table.acc_i, table.acc_f))
    return state


# ---------------------------------------------------------------------------
# pipeline entry
# ---------------------------------------------------------------------------

def try_grouped_scan_kernel(chain, params, *, specs, key_names, key_dtypes,
                            key_dicts, span_info, est_slots, agg_inputs,
                            cache, declined, pool, state_bytes,
                            runtime_stats=None, aux=None, expands=(),
                            dma: str = "single", key_lazy=None):
    """Run a grouped (G > 64) aggregation chain through the span kernel
    when `span_info` (the caller's _direct_mode_info at
    gmax=KERNEL_SPAN_MAX_GROUPS) is set, else through the hash kernel.
    Fanout-1 join/semi steps run their probes in the launch (join.py);
    `aux` and `expands` are FusedChain.prep's, and `pool` is charged the
    build operand bytes for each launch as well; dma="double" runs the
    stage ring (metered on the card).  Returns (finalized Batch,
    int64[1 + n_steps] row counters, grid length), or None after metering
    one kernelDeclined{reason}."""
    from .join import reserve_build_operands
    elig = plan_joins(chain, aux, expands, declined)
    if elig is None:
        return None
    cached, colmap, jplan = elig
    jkw = join_kwargs(jplan, dma)
    br = block_rows_for(chain.leaf_cap(()))
    grid = aligned_grid(chain.scan_meta, br,
                        chain.compiler.ctx.params_fingerprint)

    # each reservation covers the accumulator state and the launch's
    # partials
    if span_info is not None:
        doms, G, strides, kdts, kdicts = span_info
        plan = cached_plan(cache, chain, declined, mode="span", specs=specs,
                           key_names=key_names, strides=strides, G=G,
                           agg_inputs=agg_inputs, jplan=jplan)
        if plan is None:
            return None
        columns = gather_encoded_arrays(cached, colmap, plan.names)
        reserve = G * 24 * max(1, len(specs)) + partial_bytes(
            plan, len(grid), br, G, columns[0].device)
        if not pool.try_reserve(reserve):
            declined("AggGroupCardinality")
            return None
        try:
            if grid and not reserve_build_operands(pool,
                                                   jplan.reserve_bytes):
                declined("JoinBuildSize")
                return None
            try:
                acc_i, acc_f, counts = scan_span(plan, columns, grid, br,
                                                 params, **jkw)
            finally:
                if grid and jplan.reserve_bytes:
                    pool.free(jplan.reserve_bytes)
            slot = torch.arange(G, dtype=torch.int64, device=acc_i.device)
            key_arrays = {}
            stride = G
            for k, dom, dt in zip(key_names, doms, kdts):
                stride //= dom
                key_arrays[k] = ((slot // stride) % dom).to(dt)
            out = ops.agg_span_finalize(state_of(plan, acc_i, acc_f), specs,
                                        key_names, key_arrays, kdicts,
                                        key_lazy=key_lazy)
        finally:
            pool.free(reserve)
        meter_kernel_run(runtime_stats, len(grid),
                         *stage_counts(plan, columns, grid, br, G, dma))
        return out, counts, len(grid)

    # the caller's est_slots carries ~2x probing headroom over the group
    # estimate: only an estimate beyond twice the cap declines up front;
    # the runtime collision flag stays the ground truth
    if est_slots > 2 * KERNEL_HASH_MAX_SLOTS:
        declined("AggGroupCardinality")
        return None
    # the reference's collision discipline: double the table and take a
    # fresh salt per attempt, bounded by the slot cap
    num_slots = min(max(int(est_slots), 1024), KERNEL_HASH_MAX_SLOTS)
    plan = cached_plan(cache, chain, declined, mode="hash", specs=specs,
                       key_names=key_names, strides=(0,) * len(key_names),
                       G=0, agg_inputs=agg_inputs, jplan=jplan,
                       first_slots=num_slots)
    if plan is None:
        return None
    columns = gather_encoded_arrays(cached, colmap, plan.names)
    salt = 0
    while True:
        reserve = state_bytes(num_slots, key_names, specs) + partial_bytes(
            plan, len(grid), br, num_slots, columns[0].device)
        if not pool.try_reserve(reserve):
            declined("AggGroupCardinality")
            return None
        try:
            if grid and not reserve_build_operands(pool,
                                                   jplan.reserve_bytes):
                declined("JoinBuildSize")
                return None
            try:
                table = scan_hash(plan, columns, grid, br, params, num_slots,
                                  salt, **jkw)
            finally:
                if grid and jplan.reserve_bytes:
                    pool.free(jplan.reserve_bytes)
            if not bool(table.collision):
                out = ops.agg_finalize(
                    hash_state(plan, table, key_names, key_dtypes), specs,
                    key_names, key_dicts, key_lazy)
                meter_kernel_run(runtime_stats, len(grid),
                                 *stage_counts(plan, columns, grid, br,
                                               num_slots, dma))
                return out, table.counts, len(grid)
        finally:
            pool.free(reserve)
        if num_slots >= KERNEL_HASH_MAX_SLOTS:
            declined("AggGroupCardinality")
            return None
        num_slots = min(2 * num_slots, KERNEL_HASH_MAX_SLOTS)
        salt += 1
