"""Grouped aggregation inside the fused scan (more than 64 groups).

The port of presto_tpu/exec/kernels/grouped.py.  The decode -> filter ->
project chain of the direct kernel stays; the aggregation tail takes one
of two slot-addressing modes, chosen as the reference chooses them:

  span   closed dictionary / boolean key domains whose stride product
         fits KERNEL_SPAN_MAX_GROUPS: the combined stride code IS the
         slot.  The state is agg_span_init's (= agg_direct_init's), and
         finalize rebuilds the key values from the slot index.
         Kernel: csrc/scan_grouped.cu, mode span (wrapper scan_span,
         plain version scan_span_plain: agg_span_update).
  hash   everything else (open integer / decimal domains, mixed keys):
         an open-addressing table of 64-bit key hashes in device memory,
         claimed with atomicCAS and probed linearly for PROBE_ROUNDS
         slots.  A row still unplaced sets the collision flag; the host
         then doubles the table and relaunches with a new salt, up to
         KERNEL_HASH_MAX_SLOTS.  Kernel: csrc/scan_grouped.cu, mode hash
         (wrapper scan_hash, plain version scan_hash_plain: agg_update).
         The kernel's slot layout differs from agg_update's; the groups,
         keyed by their key values, are the same.

An estimate over twice the table cap, a failed memory reservation or a
collision at the cap declines with AggGroupCardinality (the caller
raises: the torch fused chain that would take over is not ported yet).
A chain's fanout-1 join and semi-join probe steps run inside both modes'
launches (kernel #5, join.py), as in the direct kernel.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import operators as ops
from ..batch import Column
from .scan_kernel import (GROUPED_SUBTILE_ROWS, KERNEL_HASH_MAX_SLOTS,
                          ScanPlan, aligned_grid, block_rows_for,
                          cached_plan, check_launch_inputs, count_launch,
                          gather_encoded_arrays, init_outputs, join_kwargs,
                          launch_tensors, meter_kernel_run, plan_joins,
                          plain_row_groups, stacked_state, state_of)

# CTAs of the persistent grouped grid per SM
CTAS_PER_SM = 2
# device memory the per-warp float partials may take; past it the grid
# has fewer CTAs
FLOAT_PARTIAL_BYTES = 1 << 29
_MODE_IDS = {"span": 0, "hash": 1}


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
    n_ctas = min(n_grid * n_sub, CTAS_PER_SM * sms)
    if plan.n_f:
        n_ctas = min(n_ctas, FLOAT_PARTIAL_BYTES
                     // (8 * (plan.threads // 32) * plan.n_f * G))
    return rows_per_cta, n_sub, max(1, n_ctas)


def partial_bytes(plan: ScanPlan, n_grid: int, br: int, G: int,
                  device) -> int:
    """Device bytes of a launch's per-CTA integer and per-warp float
    partials (none for the plain versions on the CPU)."""
    if device.type != "cuda" or not n_grid:
        return 0
    _rows, _sub, n_ctas = _grid_shape(plan, n_grid, br, G, device)
    per_cta = plan.n_i if plan.int_smem else 0
    per_cta += (plan.threads // 32) * plan.n_f
    return 8 * n_ctas * per_cta * G


def _launch(plan: ScanPlan, columns, grid, br: int, params, *, G: int,
            acc_i, acc_f, counts, salt: int = 0, table=None,
            joins=None) -> None:
    """One launch of scan_grouped_kernel in the plan's mode (plus its
    reduce) over a persistent grid of CTAs that stride over the grid
    entries' GROUPED_SUBTILE_ROWS-row slices."""
    device = acc_i.device
    from .build import load
    fn = load("scan_grouped").scan_grouped_launch
    fn.argtypes = ([ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                    ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                    ctypes.c_int]
                   + [ctypes.c_void_p] * 9
                   + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    plan_dev, grid_dev = launch_tensors(plan, columns, grid, device, joins)
    rows_per_cta, n_sub, n_ctas = _grid_shape(plan, len(grid), br, G, device)
    warps = plan.threads // 32
    part_i = (torch.empty((n_ctas, plan.n_i, G), dtype=torch.int64,
                          device=device) if plan.int_smem else None)
    # one float partial table per warp
    part_f = (torch.empty((n_ctas * warps, plan.n_f, G), dtype=torch.float64,
                          device=device) if plan.n_f else None)
    n_params = 0 if params is None else int(params.numel())

    def ptr(t):
        return None if t is None else t.data_ptr()
    keyhash, keys, keynull, meta = table or (None,) * 4
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = fn(_MODE_IDS[plan.mode], plan_dev.data_ptr(), int(plan_dev.numel()),
            grid_dev.data_ptr(), len(grid), int(br), rows_per_cta, n_sub,
            ptr(params) if n_params else None, n_params, int(G), plan.n_i,
            plan.n_f, ptr(part_i), acc_i.data_ptr(), ptr(part_f),
            acc_f.data_ptr(), counts.data_ptr(), ptr(keyhash), ptr(keys),
            ptr(keynull), ptr(meta), int(salt), n_ctas, plan.threads,
            plan.smem_bytes + 8 * n_params, stream)
    if rc != 0:
        raise RuntimeError(
            f"scan_grouped ({plan.mode}) launch failed: CUDA error {rc}")


def scan_span(plan: ScanPlan, columns, grid, br: int, params, joins=None):
    """Span-mode fused scan over `grid` entries (bidx, lo, hi); `joins`
    (join.JoinPlan) holds the probe steps' build operands.  CUDA tensors
    launch the kernel; CPU tensors run scan_span_plain.  Returns
    (acc_i (n_i, G), acc_f (max(n_f, 1), G), counts)."""
    device = columns[0].device
    if device.type == "cpu":
        return scan_span_plain(plan, columns, grid, br, params, joins)
    check_launch_inputs(columns, params, device, plan, joins)
    acc_i, acc_f = init_outputs(plan, device)
    counts = torch.zeros(1 + plan.n_steps, dtype=torch.int64, device=device)
    if grid:
        _launch(plan, columns, grid, br, params, G=plan.G, acc_i=acc_i,
                acc_f=acc_f, counts=counts, joins=joins)
        count_launch("scan_span", plan)
    return acc_i, acc_f, counts


def scan_hash(plan: ScanPlan, columns, grid, br: int, params,
              num_slots: int, salt: int, joins=None) -> HashTable:
    """Hash-mode fused scan into a fresh table of `num_slots` slots keyed
    by hash_columns(keys, salt); `joins` as in scan_span.  CUDA tensors
    launch the kernel; CPU tensors run scan_hash_plain."""
    device = columns[0].device
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
                table=(keyhash, keys, keynull, meta), joins=joins)
        count_launch("scan_hash", plan)
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
                            runtime_stats=None, aux=None, expands=()):
    """Run a grouped (G > 64) aggregation chain through the span kernel
    when `span_info` (the caller's _direct_mode_info at
    gmax=KERNEL_SPAN_MAX_GROUPS) is set, else through the hash kernel.
    Fanout-1 join/semi steps run their probes in the launch (join.py);
    `aux` and `expands` are FusedChain.prep's, and `pool` is charged the
    build operand bytes for each launch as well.  Returns (finalized
    Batch, int64[1 + n_steps] row counters, grid length), or None after
    metering one kernelDeclined{reason}."""
    from .join import reserve_build_operands
    elig = plan_joins(chain, aux, expands, declined)
    if elig is None:
        return None
    cached, colmap, jplan = elig
    jkw = join_kwargs(jplan)
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
            if grid and not reserve_build_operands(pool, jplan.nbytes):
                declined("JoinBuildSize")
                return None
            try:
                acc_i, acc_f, counts = scan_span(plan, columns, grid, br,
                                                 params, **jkw)
            finally:
                if grid and jplan.nbytes:
                    pool.free(jplan.nbytes)
            slot = torch.arange(G, dtype=torch.int64, device=acc_i.device)
            key_arrays = {}
            stride = G
            for k, dom, dt in zip(key_names, doms, kdts):
                stride //= dom
                key_arrays[k] = ((slot // stride) % dom).to(dt)
            out = ops.agg_span_finalize(state_of(plan, acc_i, acc_f), specs,
                                        key_names, key_arrays, kdicts)
        finally:
            pool.free(reserve)
        meter_kernel_run(runtime_stats, len(grid))
        return out, counts, len(grid)

    # the caller's est_slots carries ~2x probing headroom over the group
    # estimate: only an estimate beyond twice the cap declines up front;
    # the runtime collision flag stays the ground truth
    if est_slots > 2 * KERNEL_HASH_MAX_SLOTS:
        declined("AggGroupCardinality")
        return None
    plan = cached_plan(cache, chain, declined, mode="hash", specs=specs,
                       key_names=key_names, strides=(0,) * len(key_names),
                       G=0, agg_inputs=agg_inputs, jplan=jplan)
    if plan is None:
        return None
    columns = gather_encoded_arrays(cached, colmap, plan.names)
    # the reference's collision discipline: double the table and take a
    # fresh salt per attempt, bounded by the slot cap
    num_slots = min(max(int(est_slots), 1024), KERNEL_HASH_MAX_SLOTS)
    salt = 0
    while True:
        reserve = state_bytes(num_slots, key_names, specs) + partial_bytes(
            plan, len(grid), br, num_slots, columns[0].device)
        if not pool.try_reserve(reserve):
            declined("AggGroupCardinality")
            return None
        try:
            if grid and not reserve_build_operands(pool, jplan.nbytes):
                declined("JoinBuildSize")
                return None
            try:
                table = scan_hash(plan, columns, grid, br, params, num_slots,
                                  salt, **jkw)
            finally:
                if grid and jplan.nbytes:
                    pool.free(jplan.nbytes)
            if not bool(table.collision):
                out = ops.agg_finalize(
                    hash_state(plan, table, key_names, key_dtypes), specs,
                    key_names, key_dicts)
                meter_kernel_run(runtime_stats, len(grid))
                return out, table.counts, len(grid)
        finally:
            pool.free(reserve)
        if num_slots >= KERNEL_HASH_MAX_SLOTS:
            declined("AggGroupCardinality")
            return None
        num_slots = min(2 * num_slots, KERNEL_HASH_MAX_SLOTS)
        salt += 1
