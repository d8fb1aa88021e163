"""Prefix-scan window kernel, host side: gates, sort, wrapper.

The port of presto_tpu/exec/kernels/window.py.  Every window function of
one WindowNode that shares a (partition, order) spec and runs over the
default frame (RANGE UNBOUNDED PRECEDING .. CURRENT ROW) is evaluated in
ONE launch of a hand-written CUDA kernel (csrc/window_scan.cu) over the
sorted run:

  sort      stays OUTSIDE the kernel: ops.sort_indices is the single
            definition of order semantics (dictionary ranks, NULL
            sentinels, padding last), shared with ops.window_batch so
            both paths see the same permutation.
  segments  partition / peer boundaries from null-aware change flags
            over the sorted key columns (ops._row_change's rule), plus the
            live -> padding mask transition.
  kernel    one forward launch scans the run with decoupled look-back
            over tiles of tile_rows_for(slots) rows, carrying a segmented
            state (last partition start, last peer start, and per
            partition the peer starts, contributing rows and their sum per
            slot); a second launch fills the frames of peer groups still
            open at a tile's end.  Scratch is per tile (window_scratch).
  frames    running count / sum / avg are the state at the peer group's
            last row (the plain version: incl[fe] - incl[fs] +
            contrib[fs]).

Parity contract: every scan is an int64 max, min or add, exact under any
association, so the kernel, its plain version (window_scan_plain) and the
reference's Pallas kernel give bit-identical live rows whatever the
tiling.  Float sum / avg would re-associate, so they decline
(WindowFunctionShape), as in the reference.

Gates (kernelDeclined reasons, scan_kernel.KERNEL_DECLINE_REASONS), in
the reference's order:
  WindowFunctionShape  a function outside _SUPPORTED, an explicit frame,
                       constant extras, or float sum / avg
  WindowInputSize      the task's memory context cannot reserve the
                       sorted batch, the kernel's scratch and its outputs
                       (window_bytes); the reference's 8 MiB VMEM cap has
                       no counterpart on a multi-CTA scan over device
                       memory
  WindowKeyShape       a late-materialized (lazy) partition / order /
                       argument column: its values are row ids, which
                       the kernel's compares do not order as strings
After any decline the caller runs ops.window_batch, as the reference
does (presto_tpu/exec/pipeline.py:1566-1587).
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import operators as ops
from ..batch import Batch, Column
from .scan_kernel import _DTYPES, KERNEL_METRICS, LAUNCHES, bump

# the window kernel's operand dtypes: the scan kernels' and float32 (a
# REAL partition / order key or count argument; csrc/window_scan.cu
# DT_F32, compared as the float64 keys are: NaN equals NaN)
_WINDOW_DTYPES = {**_DTYPES, torch.float32: 6}

_SUPPORTED = ("row_number", "rank", "dense_rank", "count", "count_star",
              "sum", "avg")
# csrc/window_scan.cu K_* spec kinds
_KINDS = {"row_number": 0, "rank": 1, "dense_rank": 2, "count": 3,
          "count_star": 3, "sum": 4, "avg": 5}
# rows of one tile of the forward launch, most to least: the largest
# whose shared memory (forward_smem_bytes) stays within FORWARD_SMEM_BYTES,
# so two CTAs fit on an SM (csrc/window_scan.cu window_forward)
TILE_ROWS = (2048, 1024, 512, 256)
FORWARD_SMEM_BYTES = 96 * 1024
# the kernel's slot bounds (window_forward<MS> instances); a call with more
# prefix-sum slots runs one launch per group of at most 8
SLOT_BOUNDS = (1, 2, 4, 8)
# descriptor words the kernel stages in shared memory (csrc MAX_DESC)
MAX_DESC = 1024
_WARPS = 8


def _needed(partition_names, orderings, specs) -> List[str]:
    """The kernel's column operands, in input order, without repeats."""
    out: List[str] = []
    for nm in (tuple(partition_names) + tuple(o for o, _ in orderings)
               + tuple(s.arg for s in specs if s.arg)):
        if nm not in out:
            out.append(nm)
    return out


def _slots(specs) -> Tuple[List[Tuple[Optional[str], bool]], List[int]]:
    """The prefix-sum slots the count / sum / avg specs read, one per
    argument (None for count(*)): [(arg, needs the value sum)], and each
    spec's slot index (-1 for ranking functions)."""
    slots: List[Tuple[Optional[str], bool]] = []
    of_spec = []
    for s in specs:
        if s.name in ("row_number", "rank", "dense_rank"):
            of_spec.append(-1)
            continue
        arg = None if s.name == "count_star" else s.arg
        need_sum = s.name in ("sum", "avg")
        k = next((i for i, (a, _) in enumerate(slots) if a == arg), None)
        if k is None:
            k = len(slots)
            slots.append((arg, need_sum))
        elif need_sum:
            slots[k] = (arg, True)
        of_spec.append(k)
    return slots, of_spec


def forward_smem_bytes(tile_rows: int, n_slots: int) -> int:
    """Dynamic shared memory of the forward launch: the frame values at
    each peer group's end (2 words per slot per tile row, plus the leading
    group's), the warps' states and the look-back window (F = 3 + 2 x
    slots words each), the exclusive prefix, and each row's group-start
    slot (int16) and flags (a byte)."""
    F = 3 + 2 * n_slots
    return 8 * ((tile_rows + 1) * 2 * n_slots + (_WARPS + 32 + 1) * F) \
        + 3 * tile_rows


def tile_rows_for(n_slots: int) -> int:
    """The forward launch's tile for `n_slots` prefix-sum slots."""
    for t in TILE_ROWS:
        if forward_smem_bytes(t, n_slots) <= FORWARD_SMEM_BYTES:
            return t
    return TILE_ROWS[-1]


def window_scratch(n: int, n_slots: int) -> Tuple[int, int, int]:
    """(tile rows, int32 words, int64 words) of a launch's scratch over n
    rows: the ticket and one status word per tile; per tile the aggregate
    and inclusive states (F words each), the open peer group's start and
    one (count, sum) record per slot.  Nothing per row."""
    tile = tile_rows_for(n_slots)
    n_tiles = -(-n // tile)
    F = 3 + 2 * n_slots
    return tile, 1 + n_tiles, n_tiles * (2 * F + 1 + 2 * n_slots)


def _slot_groups(specs) -> List[Tuple[int, ...]]:
    """Spec indices split so that each launch sums at most SLOT_BOUNDS[-1]
    slots; the ranking functions ride with the first group."""
    groups: List[list] = [[]]
    args: List[set] = [set()]
    for i, s in enumerate(specs):
        if s.name in ("row_number", "rank", "dense_rank"):
            groups[0].append(i)
            continue
        arg = None if s.name == "count_star" else s.arg
        if arg not in args[-1] and len(args[-1]) == SLOT_BOUNDS[-1]:
            groups.append([])
            args.append(set())
        args[-1].add(arg)
        groups[-1].append(i)
    return [tuple(g) for g in groups if g]


def window_bytes(n: int, columns: Dict[str, tuple], specs) -> int:
    """Device bytes of one window launch over n rows: the permutation and
    the sorted batch (mask, and the values and nulls of every column in
    `columns`, {name: (values, nulls or None)}: the gather moves them all,
    the kernel's operands among them), the kernel's scratch (per tile,
    window_scratch: no per-row scratch) and the outputs (int64 values,
    plus a null byte for sum / avg)."""
    operands = n + 8 * n
    for v, nl in columns.values():
        operands += n * (v.element_size() + (1 if nl is not None else 0))
    scratch = 0
    for group in _slot_groups(specs):
        _tile, n32, n64 = window_scratch(
            n, len(_slots([specs[i] for i in group])[0]))
        scratch = max(scratch, 4 * n32 + 8 * n64)
    outputs = sum(n * (9 if s.name in ("sum", "avg") else 8) for s in specs)
    return operands + scratch + outputs


# ---------------------------------------------------------------------------
# kernel wrapper and its plain version
# ---------------------------------------------------------------------------

def window_scan(mask, arrays: Dict[str, tuple], partition_names, orderings,
                specs):
    """Window outputs of a sorted run: `mask` (N,) bool, `arrays` {name:
    (values, nulls or None)} for every partition / order key and argument
    column, in sorted order.  CUDA tensors launch csrc/window_scan.cu (or
    raise); CPU tensors run window_scan_plain.  Returns one (int64
    values, bool nulls or None) per spec; nulls only for sum / avg."""
    if mask.device.type == "cpu":
        return window_scan_plain(mask, arrays, partition_names, orderings,
                                 specs)
    device = mask.device
    if device.type != "cuda":
        raise NotImplementedError(f"window kernel on {device.type}")
    names = _needed(partition_names, orderings, specs)
    for t in [mask] + [a for nm in names for a in arrays[nm]
                       if a is not None]:
        if t.device != device or not t.is_contiguous():
            raise ValueError("window operands must be contiguous on one "
                             "device")
    if mask.dtype != torch.bool or any(
            arrays[nm][1] is not None and arrays[nm][1].dtype != torch.bool
            for nm in names):
        raise ValueError("the mask and null flags must be bool")
    if any(s.name in ("sum", "avg") and arrays[s.arg][0].is_floating_point()
           for s in specs):
        raise ValueError("the window kernel sums integers only")
    N = int(mask.numel())
    outs = [(torch.empty(N, dtype=torch.int64, device=device),
             torch.empty(N, dtype=torch.bool, device=device)
             if s.name in ("sum", "avg") else None) for s in specs]
    if N == 0:
        return outs
    for group in _slot_groups(specs):
        _launch(mask, arrays, names, partition_names, orderings,
                [specs[i] for i in group], [outs[i] for i in group])
    return outs


def _launch(mask, arrays, names, partition_names, orderings, specs, outs):
    """One forward launch and its fix-up over the sorted run."""
    from .scan_kernel import to_device
    device, N = mask.device, int(mask.numel())
    slots, of_spec = _slots(specs)
    tile, n32, n64 = window_scratch(N, len(slots))
    n_tiles = -(-N // tile)
    words = [N, len(names), len(partition_names), len(orderings),
             len(slots), len(specs), n_tiles, mask.data_ptr()]
    for nm in names:
        v, nl = arrays[nm]
        if v.dtype not in _WINDOW_DTYPES:
            raise ValueError(f"window operand {nm}: dtype {v.dtype}")
        words += [_WINDOW_DTYPES[v.dtype], v.data_ptr(),
                  0 if nl is None else nl.data_ptr()]
    words += [names.index(p) for p in partition_names]
    words += [names.index(o) for o, _ in orderings]
    for arg, need_sum in slots:
        words += [-1 if arg is None else names.index(arg), int(need_sum)]
    for spec, k, (vals, nulls) in zip(specs, of_spec, outs):
        words += [_KINDS[spec.name], k, vals.data_ptr(),
                  0 if nulls is None else nulls.data_ptr()]
    if len(words) > MAX_DESC:
        raise ValueError(f"window descriptor of {len(words)} words over "
                         f"{MAX_DESC}")
    desc = to_device(np.asarray(words, dtype=np.int64), device)
    status = torch.zeros(n32, dtype=torch.int32, device=device)
    scratch = torch.empty(n64, dtype=torch.int64, device=device)
    bound = next(b for b in SLOT_BOUNDS if b >= max(len(slots), 1))
    from .build import load
    fn = load("window_scan").window_scan_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = fn(desc.data_ptr(), len(words), n_tiles, tile, len(slots), bound,
            forward_smem_bytes(tile, len(slots)), status.data_ptr(),
            scratch.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"window_scan launch failed: CUDA error {rc}")
    bump(LAUNCHES, "window_scan")


def window_scan_plain(mask, arrays: Dict[str, tuple], partition_names,
                      orderings, specs):
    """The kernel's function in plain torch (the reference's
    _build_runner body, presto_tpu/exec/kernels/window.py:132-200), with
    torch.cummax / cummin / cumsum for the pairing scans: exact for int64
    under any association."""
    cols = {nm: Column(v, nl) for nm, (v, nl) in arrays.items()}
    part_start, peer_start = ops.window_flags(mask, cols, partition_names,
                                              orderings)
    seg_start, peer_start_idx, peer_end = ops.segment_bounds(part_start,
                                                             peer_start)
    return [ops.default_frame_window(spec, mask, cols, seg_start, peer_start,
                                     peer_start_idx, peer_end)
            for spec in specs]


# ---------------------------------------------------------------------------
# pipeline entry
# ---------------------------------------------------------------------------

def try_window_kernel(batch: Batch, partition_names, orderings, specs, *,
                      declined, runtime_stats=None, pool=None):
    """Evaluate a WindowNode's shared-spec functions through the window
    kernel when eligible.  Returns the output Batch (sorted row order, the
    same contract as ops.window_batch), or None after metering
    kernelDeclined{reason}, after which ops.window_batch computes the
    node's functions.  `pool` (the task's MemoryContext) is charged
    window_bytes for the launch; when it cannot hold them,
    kernelDeclinedWindowInputSize is metered and window_batch takes over,
    as in the reference (presto_tpu/exec/pipeline.py:1566-1587)."""
    for spec in specs:
        if (spec.name not in _SUPPORTED or spec.frame is not None
                or spec.extra):
            declined("WindowFunctionShape")
            return None
        if spec.name in ("sum", "avg") and spec.is_float:
            # float cumsum re-associates the reduction tree; declining
            # keeps the bit-identity contract
            declined("WindowFunctionShape")
            return None
    names = _needed(partition_names, orderings, specs)
    if any(batch.columns[nm].lazy is not None for nm in names):
        declined("WindowKeyShape")
        return None
    n = batch.capacity
    nbytes = window_bytes(
        n, {nm: (c.values, c.nulls) for nm, c in batch.columns.items()},
        specs)
    if pool is not None and not pool.try_reserve(nbytes):
        declined("WindowInputSize")
        return None
    try:
        # the sort and gather are shared with window_batch: one definition
        # of order semantics, one permutation
        sort_keys = [(p, "ASC_NULLS_FIRST") for p in partition_names] \
            + list(orderings)
        perm = ops.sort_indices(batch, sort_keys)
        cols = {nm: c.gather(perm) for nm, c in batch.columns.items()}
        mask = batch.mask[perm]
        outs = window_scan(mask, {nm: (cols[nm].values, cols[nm].nulls)
                                  for nm in names},
                           tuple(partition_names), tuple(orderings),
                           tuple(specs))
    finally:
        if pool is not None:
            pool.free(nbytes)
    out = dict(cols)
    for spec, (vals, nulls) in zip(specs, outs):
        out[spec.output] = Column(vals, nulls)
    KERNEL_METRICS.record_window_run()
    if runtime_stats is not None:
        runtime_stats.add("kernelWindowPrograms", 1)
    return Batch(out, mask)
