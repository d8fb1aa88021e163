"""Fused scan kernel, host side: grid, eligibility, plan, wrapper.

The port of presto_tpu/exec/kernels/scan_kernel.py.  The hot path of a
direct-slot aggregation over a fused scan -> filter -> project chain runs
as ONE CUDA kernel generated for the chain's shape (codegen.py, compiled
with NVRTC at first use) that decodes the resident encoded columns,
evaluates the chain's expression programs as straight-line code and folds
live rows into the aggregation accumulators.

  grid      one entry per SURVIVING block of `br` rows (br = the pow2
            ceiling of the chain's chunk capacity); each entry carries its
            block index and a block-relative [lo, hi) live row range.
            Zone-map pruning runs over this grid on the host, so pruned
            blocks are never launched.
  plan      ScanPlan: the chain's filter steps, join / semi-join probe
            steps, group keys and aggregate inputs compiled to
            ExprPrograms over the scan's columns (project steps are
            substituted into their consumers), the aggregate specs and
            the accumulator row layout, packed into one int64 vector the
            kernel reads.  A probe step (kernel #5, join.py) adds the
            build columns it gathers, or its semi marker, as virtual
            columns past the scan's, which later programs read like any
            other column.  The grouped kernels (grouped.py: the span
            kernel generated per chain like this one, the hash kernel
            csrc/scan_grouped.cu) read the same plan; where a grouped
            launch keeps its tables is ScanPlan.layout's decision.
  wrapper   scan_direct: CUDA tensors launch the kernel (or raise); CPU
            tensors run scan_direct_plain, the same function in torch.
  uploads   a launch leaves the stream asynchronous: a plan's words and
            initial rows stay on the device with the plan (ScanPlan.dev),
            and what changes per launch (the grid, a new column or build
            operand table) goes through pinned host memory with
            non_blocking copies (to_device).
  staging   dma="double" (scan_kernel_dma, kernel #2): the kernels keep
            the next stages of the arrays the plan reads densely in flight
            into a ring of 2-4 stages in shared memory, by bulk copies on
            mbarriers (csrc/scan_common.cuh ring_copy), while the current
            tile computes.  ScanPlan.staging is the one decision of what
            is staged and how deep the ring is; a plan with nothing worth
            staging launches unstaged.  It changes no result;
            stage_ring_counts meters it from the launch geometry.  The
            plain versions stage nothing.

Outputs: acc_i (n_i, G) int64 and acc_f (max(n_f, 1), G) float64 in
agg_direct_init's state order, and the per-step live-row counters
(1 + n_steps).  Integer accumulators and counters are exact; float64
sums may differ from the plain version in the last bits (another
summation order).
"""
from __future__ import annotations

import ctypes
import dataclasses
import threading
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import operators as ops
from ..batch import Batch, Column
from ..lowering import (KERNEL_OPS, OPS, ExprProgram, OP, compile_expr,
                        float_bits)
from ...common.types import BOOLEAN
from ...spi.expr import (CallExpression, RowExpression,
                         SpecialFormExpression, VariableReferenceExpression)

# Eligibility refusals, surfaced as kernelDeclined{reason} RuntimeStats
# counters (exec/pipeline.py _kernel_declined).
KERNEL_DECLINE_REASONS = (
    "Disabled",              # scan.kernel = xla (not ported)
    "AggFunctionShape",      # non-BASIC aggregate functions
    "AggGroupCardinality",   # group estimate beyond twice the hash slot
    #                          cap, a collision at the cap, or a failed
    #                          accumulator reservation
    "PlanShape",             # chain step the kernel does not run, or a
    #                          plan/expression shape the port lacks
    "ColumnsNotResident",    # a scanned column is not device-resident
    "JoinShape",             # fanout-k join, residual ON filter,
    #                          dictionary or lazy build column (join.py)
    "JoinBuildSize",         # build operands over the byte cap, or a
    #                          failed operand reservation (join.py)
    "WindowFunctionShape",   # a window function outside the kernel's
    #                          set, an explicit frame, constant extras, or
    #                          float sum / avg (window.py)
    "WindowInputSize",       # a failed reservation of the window launch's
    #                          sorted batch, scratch and outputs
    #                          (window.py); the query raises
    "WindowKeyShape",        # a late-materialized (lazy) partition /
    #                          order / argument column (window.py)
)

THREADS = 256
# the widest CTA of a hash plan whose table stays on chip (the grouped
# kernel's launch bounds: 512 threads of 128 registers per SM)
HASH_MAX_THREADS = 512
# threads of a persistent grouped grid per SM (the kernels' launch bounds:
# 128 registers each): two CTAs of 256 threads, one wider CTA, or fewer
# where the on-chip tables leave room for fewer
RESIDENT_THREADS = 512
# shared memory of one SM (H100: 228 KB, of which each resident CTA's
# share carries 1 KB the runtime reserves)
SMEM_PER_SM = 228 * 1024
SMEM_RESERVED_PER_CTA = 1024
# rows each kernel thread carries per pass (csrc/scan_common.cuh RPT)
ROWS_PER_THREAD = 4
# rows of a grid block one CTA takes (a 64K-row block is cut in 8)
ROWS_PER_CTA = 8192
# dynamic shared memory a kernel may ask for (H100: 227 KB a block)
MAX_SMEM_BYTES = 227 * 1024
# bound parameters a launch may stage in shared memory
MAX_PARAMS = 256
# rows the plain version decodes at once
PLAIN_ROWS = 1 << 22
# rows of a block one CTA of a grouped kernel takes per work item
GROUPED_SUBTILE_ROWS = 8192
# span mode's group gate (the reference's VMEM accumulator gate, kept so
# both packages pick the same mode for the same query)
KERNEL_SPAN_MAX_GROUPS = 1 << 15
# hash mode's table cap
KERNEL_HASH_MAX_SLOTS = 1 << 16

# the fused scan kernels' wrappers
SCAN_KERNELS = ("scan_direct", "scan_span", "scan_hash")
# kernel launches per wrapper: each wrapper adds one where it launches its
# kernel (plain-version runs on CPU tensors are not launches); window_scan
# is the window kernel's (window.py)
LAUNCHES: Dict[str, int] = {k: 0 for k in SCAN_KERNELS + ("window_scan",)}
# of the scan kernels' launches, those whose plan carries a join or
# semi-join probe step (kernel #5)
JOIN_LAUNCHES: Dict[str, int] = {k: 0 for k in SCAN_KERNELS}
# of the scan kernels' launches, those that ran the stage ring (kernel #2)
STAGED_LAUNCHES: Dict[str, int] = {k: 0 for k in SCAN_KERNELS}
# scan_kernel_dma values: "double" runs the stage ring (kernel #2)
DMA_MODES = ("single", "double")
# the ring's depth: a layout reserves MIN_STAGES stages of one pass, and a
# launch takes up to MAX_STAGES stages of up to MAX_PASSES passes each
# where the shared memory left at its CTA count holds them
MIN_STAGES, MAX_STAGES = 2, 4
MAX_PASSES = 8
# a plan with a probe step whose layout leaves at least this much of the
# SM's shared memory to the L1 beside the reserved ring keeps stages of
# one pass: longer ones would take the L1 its table gathers hit
PROBE_L1_BYTES = 64 * 1024
# a stage's two mbarriers (full, empty), 8 bytes each
_RING_BARRIER_BYTES = 16
# the hash kernel's producer state beside its ring (csrc/scan_common.cuh
# RingCtl, RING_CTL_BYTES), reserved with its stage table
_RING_CTL_BYTES = 128


class KernelMetrics:
    """Process-lifetime roll-up of the per-query kernel counters."""

    def __init__(self):
        self._lock = threading.Lock()
        self.declined: Dict[str, int] = {}
        self.scan_programs = 0
        self.window_programs = 0
        self.dma_staged_blocks = 0
        self.dma_prefetched_blocks = 0

    def record_declined(self, reason: str) -> None:
        with self._lock:
            self.declined[reason] = self.declined.get(reason, 0) + 1

    def record_run(self, n_staged_copies: int = 0,
                   n_prefetched: int = 0) -> None:
        with self._lock:
            self.scan_programs += 1
            self.dma_staged_blocks += n_staged_copies
            self.dma_prefetched_blocks += n_prefetched

    def record_window_run(self) -> None:
        with self._lock:
            self.window_programs += 1

    def snapshot(self) -> dict:
        with self._lock:
            staged = self.dma_staged_blocks
            return {"declined": dict(self.declined),
                    "scan_programs": self.scan_programs,
                    "window_programs": self.window_programs,
                    "dma_staged_blocks": staged,
                    "dma_prefetched_blocks": self.dma_prefetched_blocks,
                    "dma_overlap_fraction": (
                        self.dma_prefetched_blocks / staged
                        if staged else 0.0)}


KERNEL_METRICS = KernelMetrics()


# ---------------------------------------------------------------------------
# grid
# ---------------------------------------------------------------------------

def _merged_ranges(splits) -> List[Tuple[int, int]]:
    """The scan's owned row ranges, sorted and coalesced."""
    out: List[List[int]] = []
    for s, e in sorted((int(sp.start), int(sp.end)) for sp in splits):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _block_pruned(zone_maps, pushdown, params, pos: np.ndarray,
                  count: np.ndarray) -> np.ndarray:
    """storage/pushdown.prune_chunks' conservative unsatisfiability test
    (entry_unsatisfiable over ZoneMaps.chunk_bounds), vectorized over
    blocks: True where some pushed-down conjunct cannot hold anywhere in
    rows [pos, pos + count)."""
    from ...storage.pushdown import entry_unsatisfiable, resolve_entry_value
    pruned = np.zeros(pos.shape, dtype=bool)
    for e in pushdown:
        zm = zone_maps.get(e["column"])
        if zm is None:
            continue
        value = resolve_entry_value(e["value"], params)
        if value is None:
            continue
        nz = len(zm.zmin)
        z0 = pos // zm.zone_rows
        z1 = np.minimum((pos + count - 1) // zm.zone_rows, nz - 1)
        ok = z0 <= z1
        z0c = np.minimum(z0, nz - 1)
        zmin, zmax = zm.zmin[z0c], zm.zmax[z0c]
        for k in range(1, int((z1 - z0).max(initial=0)) + 1):
            z = np.minimum(z0 + k, z1)
            zmin = np.minimum(zmin, zm.zmin[z])
            zmax = np.maximum(zmax, zm.zmax[z])
        if isinstance(value, tuple):
            hit = np.array([entry_unsatisfiable(e["op"], value, a, b)
                            for a, b in zip(zmin, zmax)], dtype=bool)
        else:
            op = e["op"]
            hit = zmin > zmax
            if op == "eq":
                hit |= (value < zmin) | (value > zmax)
            elif op == "lt":
                hit |= zmin >= value
            elif op == "lte":
                hit |= zmin > value
            elif op == "gt":
                hit |= zmax <= value
            elif op == "gte":
                hit |= zmax < value
        pruned |= ok & hit
    return pruned


def block_rows_for(cap: int) -> int:
    """The kernel's block size for a chain with chunk capacity `cap`: the
    power-of-two ceiling (aggregation is order-insensitive, so any
    partition of the same row set is legal)."""
    return 1 << max(0, int(cap - 1).bit_length())


def aligned_grid(meta: dict, block_rows: int,
                 params) -> List[Tuple[int, int, int]]:
    """(block index, lo, hi) entries tiling the scan's split ranges with
    block_rows-aligned blocks; zone-map-pruned entries are dropped."""
    zone_maps = meta.get("zone_maps") or {}
    pushdown = meta.get("pushdown") or []
    entries: List[Tuple[int, int, int]] = []
    for s, e in _merged_ranges(meta["splits"]):
        for b in range(s // block_rows, (e - 1) // block_rows + 1):
            lo = max(s, b * block_rows) - b * block_rows
            hi = min(e, (b + 1) * block_rows) - b * block_rows
            entries.append((b, lo, hi))
    if not (zone_maps and pushdown and entries):
        return entries
    ent = np.asarray(entries, dtype=np.int64)
    pruned = _block_pruned(zone_maps, pushdown, params,
                           ent[:, 0] * block_rows + ent[:, 1],
                           ent[:, 2] - ent[:, 1])
    return [t for t, p in zip(entries, pruned.tolist()) if not p]


# ---------------------------------------------------------------------------
# eligibility and inputs
# ---------------------------------------------------------------------------

def chain_eligible(chain, declined):
    """Chain step shapes and residency.  Returns (cached, colmap) or None
    after metering one decline.  Join / semi steps pass here; the caller
    lays them out with join.plan_join_layout, which applies its own Join*
    gates."""
    allowed = ("filter", "project", "rename", "join", "semi")
    if any(s[0] not in allowed for s in chain.steps):
        declined("PlanShape")
        return None
    cached = chain.scan_meta.get("cached_cols") or {}
    colmap = chain.scan_meta.get("colmap") or {}
    if not colmap or any(colmap[n] not in cached for n in colmap):
        declined("ColumnsNotResident")
        return None
    return cached, colmap


def gather_encoded_arrays(cached, colmap, names) -> List:
    """The scan's ResidentColumns in kernel column order.  No tail padding
    is needed: the kernel and its plain version read only rows [lo, hi)."""
    return [cached[colmap[name]] for name in names]


def meter_kernel_run(runtime_stats, n_blocks: int,
                     n_staged_copies: int = 0, n_prefetched: int = 0) -> None:
    """One kernelScanPrograms tick per launched kernel; with the stage
    ring (stage_ring_counts) also its stage copies, those that landed
    while an earlier stage computed, and their ratio, under the
    reference's kernelDma* names."""
    KERNEL_METRICS.record_run(n_staged_copies, n_prefetched)
    if runtime_stats is None:
        return
    runtime_stats.add("kernelScanPrograms", 1)
    if n_staged_copies:
        runtime_stats.add("kernelDmaStagedBlocks", n_staged_copies)
        runtime_stats.add("kernelDmaPrefetchedBlocks", n_prefetched)
        runtime_stats.add("kernelDmaOverlapFraction",
                          n_prefetched / n_staged_copies)


# ---------------------------------------------------------------------------
# the stage ring (kernel #2)
# ---------------------------------------------------------------------------

def check_dma(dma: str) -> None:
    """Refuse a scan_kernel_dma value outside DMA_MODES."""
    if dma not in DMA_MODES:
        raise ValueError(f"scan_kernel_dma must be one of {DMA_MODES}, "
                         f"got {dma!r}")


class Staging(NamedTuple):
    """A plan's stage ring over one column shape (ScanPlan.staging): the
    one decision that the kernels' sources, the launches, the layout's
    reservation and the kernelDma* meters read."""
    staged: Tuple[int, ...]      # kernel column indices the ring copies
    stages: int                  # S, MIN_STAGES..MAX_STAGES; 0: unstaged
    passes: int                  # P, passes of a work item per stage
    rows: int                    # rows of a stage: P x ROWS_PER_THREAD x T
    stage_bytes: int             # one stage: a region per staged array
    offsets: Tuple[int, ...]     # per scan column: its region, -1 unstaged
    row_bytes: int               # staged bytes of one row

    @property
    def ring_bytes(self) -> int:
        """Shared memory of the ring: S stages, then a full and an empty
        mbarrier per stage."""
        return self.stages * (self.stage_bytes + _RING_BARRIER_BYTES)

    def staged_bytes(self, rows: int) -> int:
        """Device bytes the ring copies for `rows` rows: each staged
        array's rows once (its bound at the memory rate)."""
        return self.row_bytes * int(rows)


def _elem_bytes(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def scan_shape(columns) -> Tuple[tuple, ...]:
    """Per scan column (kind, dtype of its per-row array, dtype of its
    second array): the encodings the staging decision reads."""
    out = []
    for rc in columns:
        a1 = rc.arrays[1] if len(rc.arrays) > 1 else rc.arrays[0]
        out.append((rc.kind, rc.arrays[0].dtype, a1.dtype))
    return tuple(out)


def first_reads(names, step_programs, joins, key_programs, agg_programs,
                specs) -> Dict[int, bool]:
    """Per scan column the kernels read: whether its first read comes
    after a step has narrowed the rows (a filter, or an inner join's
    probe), in the kernels' order -- the steps (a probe step's keys), the
    group keys, then each aggregate's input (a count that equals __seen
    reads nothing; nor does a column only tested by IS NULL: resident
    columns hold no NULLs, so its value is dead code)."""
    col_idx = {n: i for i, n in enumerate(names)}
    reads: Dict[int, bool] = {}
    narrowed = False

    def see(prog):
        ops = prog.ops
        for i, (op, arg) in enumerate(ops):
            if op != OP["COL"] or prog.columns[arg] not in col_idx:
                continue
            if i + 1 < len(ops) and ops[i + 1][0] == OP["IS_NULL"]:
                continue
            reads.setdefault(col_idx[prog.columns[arg]], narrowed)
    probes = {jp.step.si: jp for jp in joins}
    for s, prog in enumerate(step_programs):
        if s in probes:
            step = probes[s].step
            for p in probes[s].key_programs:
                see(p)
            narrowed |= step.kind != "semi" and not step.is_left
        elif prog is not None:
            see(prog)
            narrowed = True
    for p in key_programs:
        see(p)
    for spec in specs:
        p = agg_programs.get(spec.output)
        if p is None or (spec.name in ("count", "count_star")
                         and not p.nullable):
            continue
        see(p)
    return reads


def staged_columns(reads: Dict[int, bool], shape) -> Tuple[int, ...]:
    """The arrays worth staging: the per-row arrays (plain values, dict
    codes) read under the tile's full row mask, and the 1- and 2-byte ones
    wherever they are read (their 32-byte sectors hold 16-32 rows, so a
    selective step still touches nearly every sector).  A 4- or 8-byte
    array first read after a narrowing step stays in device memory."""
    return tuple(c for c in sorted(reads)
                 if shape[c][0] in ("plain", "dict")
                 and (not reads[c] or _elem_bytes(shape[c][1]) <= 2))


def stage_regions(staged, shape, tile: int) -> Tuple[List[int], int]:
    """(per scan column its region's offset in a stage, -1 when not
    staged; bytes of one stage).  A region holds a tile of the array plus
    16 bytes, so the tile keeps its device-memory offset modulo 16
    (csrc/scan_common.cuh ring_copy); every region starts 16-byte
    aligned."""
    offsets, nbytes = [-1] * len(shape), 0
    for c in staged:
        offsets[c] = nbytes
        nbytes += -(-(tile * _elem_bytes(shape[c][1]) + 16) // 16) * 16
    return offsets, nbytes


def min_ring_bytes(staged, shape, threads: int) -> int:
    """The smallest ring (MIN_STAGES) of `staged` at CTAs of `threads`: what
    a layout reserves so that a single and a double launch run the same
    CTAs."""
    if not staged:
        return 0
    _offsets, stage = stage_regions(staged, shape, ROWS_PER_THREAD * threads)
    return MIN_STAGES * (stage + _RING_BARRIER_BYTES)


def stage_ring_counts(staging: Staging, grid, br: int, rows_per_cta: int,
                      n_sub: int, n_ctas: Optional[int] = None
                      ) -> Tuple[int, int]:
    """(staged copies, copies that land while an earlier stage computes) of
    a staged launch, from its geometry: a CTA copies each staged array
    once per stage (staging.rows rows of a work item) it computes, and
    every stage after a CTA's first lands while an earlier one computes.  n_ctas None:
    one CTA per (grid entry, slice); else the persistent CTAs, CTA b
    taking work items b, b + n_ctas, ... (item = entry x n_sub + slice).
    The unit is a stage of one staged array, where the reference counts
    64K-row grid blocks of every per-row array
    (presto_tpu/exec/kernels/scan_kernel.py meter_kernel_run :553)."""
    n_staged = len(staging.staged)
    if not staging.stages or not n_staged or not len(grid):
        return 0, 0
    tile = staging.rows
    g = np.asarray(grid, dtype=np.int64).reshape(-1, 3)
    lo = g[:, 1:2] + np.arange(n_sub, dtype=np.int64) * rows_per_cta
    hi = np.minimum(g[:, 2:3], lo + rows_per_cta)
    tiles = np.where(hi > lo, -(-(hi - lo) // tile), 0).reshape(-1)
    if n_ctas is not None:
        tiles = np.bincount(np.arange(len(tiles)) % n_ctas, weights=tiles,
                            minlength=n_ctas).astype(np.int64)
    staged = int(tiles.sum())
    prefetched = int(np.clip(tiles - 1, 0, None).sum())
    return staged * n_staged, prefetched * n_staged


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

_KINDS = {"plain": 0, "dict": 1, "rle": 2}
_DTYPES = {torch.int8: 0, torch.int16: 1, torch.int32: 2, torch.int64: 3,
           torch.float64: 4, torch.bool: 5}
_SPEC_KINDS = {"count_star": 0, "count": 1, "sum": 2, "avg": 3, "min": 4,
               "max": 5}
_R_ADD, _R_MIN, _R_MAX = 0, 1, 2
_HEADER = 16
_COL_WORDS = 6
_SPEC_WORDS = 7
# virtual column kinds (csrc/scan_common.cuh K_GATHER, K_SEMI)
_K_GATHER, _K_SEMI = 3, 4
# a probe step's record: table kind, form, key count, offset of its key
# program list, then per launch: operand 0 (slots | keyhash_sorted),
# operand 1 (base | perm), table size, semi null-key flag, a unique
# table's bucket directory and its shift, 64 - k (join.bucket_directory)
_JOIN_WORDS = 10
# header word holding the probe records' offset (scan_common.cuh
# H_OFF_JOINS)
_H_OFF_JOINS = 15
_TABLE_KINDS = {"direct": 0, "unique": 1}
_FORM_INNER, _FORM_LEFT, _FORM_SEMI = 0, 1, 2


def substitute(expr: RowExpression, env: Dict[str, RowExpression]):
    """`expr` with every variable reference replaced by its definition in
    `env` (project steps feed their consumers)."""
    if isinstance(expr, VariableReferenceExpression):
        return env[expr.name]
    if isinstance(expr, (CallExpression, SpecialFormExpression)):
        return dataclasses.replace(
            expr, arguments=[substitute(a, env) for a in expr.arguments])
    return expr


class JoinProgram(NamedTuple):
    """A probe step of the plan: its join.JoinStepPlan and its probe-key
    programs."""
    step: object
    key_programs: Tuple[ExprProgram, ...]


class VirtualColumn(NamedTuple):
    """A column a probe step adds: a gathered build column or a semi
    marker, read past the scan's columns."""
    name: str
    join: int                   # index into ScanPlan.joins
    kind: str                   # "gather" | "semi"
    gather: int                 # index into the step's gcols (gather)
    nullable: bool


@dataclasses.dataclass
class ScanPlan:
    mode: str                              # "direct" | "span" | "hash"
    names: Tuple[str, ...]                 # kernel column order
    n_steps: int
    step_programs: List[Optional[ExprProgram]]   # per step; None = no filter
    key_programs: List[ExprProgram]
    strides: Tuple[int, ...]
    G: int                                 # groups (hash: 0, slots per launch)
    specs: Tuple
    agg_programs: Dict[str, Optional[ExprProgram]]
    int_names: Tuple[str, ...]
    flt_names: Tuple[str, ...]
    init_i: torch.Tensor                   # (n_i,) host
    init_f: torch.Tensor                   # (n_f,) host
    words: np.ndarray                      # static plan vector (int64)
    threads: int
    smem_bytes: int
    # per integer row, the row its final value is copied from: itself when
    # the kernel folds it, 0 (__seen) for a count that equals __seen
    src_rows: Tuple[int, ...] = ()
    # hash mode: the largest slot count whose per-CTA tables fit in
    # shared memory (0: none) beside the double mode's smallest ring and
    # its stage table (ring_reserve bytes: the generated kernels' ring
    # alone; 0 when the plan stages nothing), and the largest whose float
    # rows fit once per warp -- read by layout
    onchip_slots: int = 0
    ring_reserve: int = 0
    warp_float_slots: int = 0
    # a program uses an opcode past the Q1 / Q6 set: the kernels' EXT
    # instances run the plan
    ext: bool = False
    joins: Tuple[JoinProgram, ...] = ()
    virtual: Tuple[VirtualColumn, ...] = ()
    # per device: the plan's words as launched and its initial rows, and
    # the kernels generated for it (to_device, init_outputs,
    # direct_kernel, grouped.span_kernel); a replaced plan starts empty
    dev: dict = dataclasses.field(default_factory=dict, init=False,
                                  repr=False, compare=False)

    @property
    def n_i(self) -> int:
        return len(self.int_names)

    @property
    def n_f(self) -> int:
        return len(self.flt_names)

    @property
    def n_fold(self) -> int:
        """Integer rows the kernel folds (the others copy __seen)."""
        return sum(1 for r, sr in enumerate(self.src_rows) if r == sr)

    def staging(self, columns, slots: int = 0) -> Staging:
        """The stage ring of a double launch over the ResidentColumns
        `columns` into `slots` slots (hash mode): the arrays worth staging
        (staged_columns over first_reads) and the ring that the shared
        memory left at the layout's CTA count holds: more than two stages
        where any fit, then the longest stages (P passes, a divisor of a
        work item's passes: a stage never spans two items), then the most
        of them (S).  It depends only on the plan and the encodings, so
        every launch of a plan takes the same ring and the same CTAs."""
        shape = scan_shape(columns)
        key = ("staging", shape, slots if self.mode == "hash" else 0)
        st = self.dev.get(key)
        if st is None:
            st = self.dev[key] = _staging(self, shape, slots)
        return st

    def ring_room(self, slots: int = 0) -> Tuple[int, int]:
        """(shared memory of a launch beside its ring, the CTAs per SM its
        layout fixes): the generated direct kernel's tables, the span
        layout's, or the hash kernel's layout with its parameters, tables
        and stage table."""
        if self.mode == "direct":
            return self.direct_smem(), self.direct_ctas_per_sm()
        if self.mode == "span":
            lay = self.layout(self.G)
            return lay.smem_bytes, lay.ctas_per_sm
        lay = self.layout(slots)
        return (self.smem_bytes + lay.table_bytes + 8 * MAX_PARAMS
                + 8 * len(self.names) + _RING_CTL_BYTES, lay.ctas_per_sm)

    def direct_smem(self) -> int:
        """Shared memory of the generated direct kernel beside its ring
        (codegen.generate): the CTA's integer table, 16-byte aligned, then
        per-thread float slots."""
        G = max(self.G, 1)
        return (-(-8 * self.n_fold * G // 16) * 16
                + 8 * self.n_f * G * self.threads)

    def direct_ctas_per_sm(self) -> int:
        """CTAs per SM of the direct kernel's persistent grid: two CTAs'
        threads, fewer where the tables and the reserved ring leave room
        for fewer -- the same for a single and a double launch."""
        return max(1, min(RESIDENT_THREADS // self.threads, SMEM_PER_SM // (
            self.direct_smem() + self.ring_reserve
            + SMEM_RESERVED_PER_CTA)))

    def layout(self, slots: int) -> "GroupedLayout":
        """Where a grouped launch into `slots` slots keeps its tables: the
        one decision the wrappers, the kernels' sources, partial_bytes and
        the reservations read.  It does not depend on the launch's stage
        ring (the double mode's smallest ring is reserved either way), so a
        single and a double launch take the same path over the same CTAs
        and fold in the same order."""
        warps = self.threads // 32
        if self.mode == "span":
            return _span_layout(self, slots, warps)
        on = 0 < slots <= self.onchip_slots
        wf = on and self.n_f > 0 and slots <= self.warp_float_slots
        f_tables = 0 if not self.n_f else 1 if on and not wf else warps
        tables = 8 * slots * (self.n_fold + 1 + f_tables * self.n_f) \
            if on else 0
        per_sm = max(1, RESIDENT_THREADS // self.threads)
        if on:
            need = self.smem_bytes + tables + self.ring_reserve \
                + 8 * MAX_PARAMS + SMEM_RESERVED_PER_CTA
            per_sm = max(1, min(per_sm, SMEM_PER_SM // need))
        return GroupedLayout(on, wf, f_tables, tables,
                             self.smem_bytes + tables, per_sm)


class GroupedLayout(NamedTuple):
    """A grouped launch's tables (ScanPlan.layout)."""
    on_chip: bool          # the tables in each CTA's shared memory
    warp_floats: bool      # on chip, a float table per warp (else per CTA)
    f_tables: int          # float partial tables per CTA (0: no float row)
    table_bytes: int       # shared memory of the on-chip tables
    # shared memory of a single launch (the hash kernel adds its
    # parameters per launch, a double launch its stage ring)
    smem_bytes: int
    ctas_per_sm: int


def _span_layout(plan: ScanPlan, slots: int, warps: int) -> GroupedLayout:
    """The generated span kernel's layout (codegen.py): the integer rows
    it folds in one table per CTA, the float rows in a table per warp
    where they fit (each warp stages its rows per row position: 16 bytes a
    row), else one table per CTA (every float row staged at once for one
    pair of CTA barriers per pass), beside the double mode's ring; else
    the device-memory path (integer rows by global atomics, a float table
    per warp in the partials)."""
    n_f = plan.n_f
    ints = 8 * plan.n_fold * slots
    stage = 16 * ROWS_PER_THREAD * plan.threads if n_f else 0
    room = MAX_SMEM_BYTES - plan.ring_reserve
    per_warp = ints + 8 * n_f * slots * warps
    per_cta = ints + 8 * n_f * slots
    if slots > 0 and n_f and per_warp + stage <= room:
        on, wf, f_tables, tables, smem = (True, True, warps, per_warp,
                                          per_warp + stage)
    elif slots > 0 and per_cta + stage * n_f <= room:
        on, wf, f_tables, tables, smem = (True, False, min(n_f, 1), per_cta,
                                          per_cta + stage * n_f)
    else:
        on, wf, f_tables, tables, smem = (False, False, warps * (n_f > 0),
                                          0, stage)
    per_sm = max(1, min(RESIDENT_THREADS // plan.threads, SMEM_PER_SM // (
        smem + plan.ring_reserve + SMEM_RESERVED_PER_CTA)))
    return GroupedLayout(on, wf, f_tables, tables, smem, per_sm)


def _staging(plan: ScanPlan, shape, slots: int) -> Staging:
    """ScanPlan.staging's decision."""
    tile = ROWS_PER_THREAD * plan.threads
    staged = staged_columns(first_reads(
        plan.names, plan.step_programs, plan.joins, plan.key_programs,
        plan.agg_programs, plan.specs), shape)
    if not staged:
        return Staging((), 0, 0, tile, 0, (-1,) * len(shape), 0)
    base, per_sm = plan.ring_room(slots)
    # the reserved ring (MIN_STAGES of one pass) unless a deeper one fits:
    # more than two stages first, then longer stages, which spread each
    # stage's barrier waits and copies over more rows.  A stage holds
    # passes of one work item, so P divides an item's passes (a shorter
    # last stage would add a boundary); a probe plan whose gathers need
    # the L1 keeps stages of one pass
    reserved = min_ring_bytes(staged, shape, plan.threads)
    keep_l1 = bool(plan.joins) and SMEM_PER_SM - per_sm * (
        base + reserved + SMEM_RESERVED_PER_CTA) >= PROBE_L1_BYTES
    item = ROWS_PER_CTA if plan.mode == "direct" else GROUPED_SUBTILE_ROWS
    item_passes = -(-item // tile)
    best = ((False, 1, MIN_STAGES), MIN_STAGES, 1)
    for p in range(1, 2 if keep_l1 else min(MAX_PASSES, item_passes) + 1):
        if item_passes % p:
            continue
        _o, stage = stage_regions(staged, shape, p * tile)
        for s in range(MIN_STAGES, MAX_STAGES + 1):
            need = base + s * (stage + _RING_BARRIER_BYTES)
            if need <= MAX_SMEM_BYTES and per_sm * (
                    need + SMEM_RESERVED_PER_CTA) <= SMEM_PER_SM:
                best = max(best, ((s > MIN_STAGES, p, s), s, p))
    _key, stages, passes = best
    offsets, stage_bytes = stage_regions(staged, shape, passes * tile)
    return Staging(staged, stages, passes, passes * tile, stage_bytes,
                   tuple(offsets),
                   sum(_elem_bytes(shape[c][1]) for c in staged))


def launch_staging(plan: ScanPlan, columns, dma: str,
                   slots: int = 0) -> Optional[Staging]:
    """The ring a launch of `plan` over `columns` (into `slots` slots)
    runs: the plan's staging under "double", None in single mode or when
    the plan stages nothing."""
    check_dma(dma)
    if dma != "double":
        return None
    st = plan.staging(columns, slots)
    return st if st.stages else None


def check_ring_fits(staging: Staging, smem_bytes: int) -> None:
    """Raise NotImplementedError naming the bytes when the ring does not
    fit beside a launch's `smem_bytes`: a launch never runs unstaged
    while its plan stages an array under "double"."""
    if smem_bytes + staging.ring_bytes > MAX_SMEM_BYTES:
        raise NotImplementedError(
            f"scan_kernel_dma=double: the {staging.ring_bytes}-byte stage "
            f"ring does not fit beside the kernel's {smem_bytes}-byte "
            f"shared-memory layout ({MAX_SMEM_BYTES} bytes at most)")


def build_scan_plan(chain, *, mode, specs, key_names, strides, G,
                    agg_inputs: Dict[str, Optional[RowExpression]],
                    jplan=None, first_slots: int = 0) -> ScanPlan:
    """Compile the chain's static shape into a ScanPlan for `mode`.
    `jplan` (join.JoinPlan) lays out the chain's join / semi steps.  The
    CTA count and the grouped modes' on-chip table size (onchip_slots)
    leave room for the double mode's smallest ring of the arrays the plan
    stages (ring_reserve); the hash mode's CTA width holds its first
    table of `first_slots` slots on chip where it can.  Raises
    NotImplementedError for an expression or shape the kernel lacks."""
    meta = chain.scan_meta
    names = tuple(meta["colmap"])
    col_idx = {n: i for i, n in enumerate(names)}
    env: Dict[str, RowExpression] = {
        n: VariableReferenceExpression(n, meta["types"][n]) for n in names}
    jsteps = {sp.si: sp for sp in jplan.steps} if jplan is not None else {}
    step_programs: List[Optional[ExprProgram]] = []
    joins: List[JoinProgram] = []
    virtual: List[VirtualColumn] = []

    def add_virtual(name, typ, **kw):
        if name in col_idx:
            raise NotImplementedError(f"probe output {name} shadows a column")
        col_idx[name] = len(col_idx)
        env[name] = VariableReferenceExpression(name, typ)
        virtual.append(VirtualColumn(name, len(joins) - 1, **kw))

    for si, step in enumerate(chain.steps):
        kind = step[0]
        if kind == "filter":
            step_programs.append(compile_expr(substitute(step[1], env)))
            continue
        step_programs.append(None)
        if kind == "project":
            env = {v.name: substitute(e, env) for v, e in step[1]}
        elif kind == "rename":
            env = {o: env[i] for o, i in step[1]}
        elif kind in ("join", "semi") and si in jsteps:
            sp, node = jsteps[si], step[1]
            joins.append(JoinProgram(sp, tuple(
                compile_expr(env[k]) for k in sp.probe_keys)))
            if kind == "semi":
                add_virtual(sp.out_name, BOOLEAN, kind="semi", gather=-1,
                            nullable=True)
                continue
            btypes = {v.name: v.type for v in node.right.output_variables}
            for g, (name, has_nulls) in enumerate(sp.gcols):
                add_virtual(name, btypes[name], kind="gather", gather=g,
                            nullable=sp.is_left or has_nulls)
        else:
            raise NotImplementedError(f"chain step {kind}")
    key_programs = [compile_expr(env[k]) for k in key_names]
    nullable = {v.name for v in virtual if v.nullable}
    agg_programs = {out: (None if e is None
                          else compile_expr(substitute(e, env), nullable))
                    for out, e in agg_inputs.items()}

    template = ops.agg_direct_init(max(G, 1), specs, "cpu")
    int_names = tuple(k for k, v in template.items()
                      if v.dtype == torch.int64)
    flt_names = tuple(k for k, v in template.items()
                      if v.dtype == torch.float64)
    assert int_names[0] == "__seen"
    init_i = torch.stack([template[k][0] for k in int_names])
    init_f = (torch.stack([template[k][0] for k in flt_names]) if flt_names
              else torch.zeros(0, dtype=torch.float64))
    ops_of = {}
    for spec in specs:
        if spec.name in ("min", "max"):
            ops_of[spec.output] = _R_MIN if spec.name == "min" else _R_MAX

    # -- the static plan vector (layout: csrc/scan_common.cuh) -----------
    progs: List[int] = []
    prog_base = None    # filled once the table sizes are known

    def add_prog(p: ExprProgram) -> int:
        off = len(progs)
        progs.append(len(p.ops))
        for op, arg in p.ops:
            progs.append(op)
            progs.append(col_idx[p.columns[arg]] if op == OP["COL"] else arg)
        return off

    step_offs = [-1 if p is None else add_prog(p) for p in step_programs]
    join_key_offs = [[add_prog(p) for p in jp.key_programs] for jp in joins]
    key_offs = [add_prog(p) for p in key_programs]
    spec_rows = []
    # integer row each row's final value is copied from (the grouped
    # kernels' reduce copies __seen into the counts it stands for)
    src_rows = list(range(len(int_names)))
    for spec in specs:
        p = agg_programs.get(spec.output)
        off = -1 if p is None else add_prog(p)
        if spec.name in ("count", "count_star"):
            vrow, crow = int_names.index(spec.output), -1
        else:
            vkey = spec.output + ("$sum" if spec.name == "avg" else "")
            rows = flt_names if spec.is_float else int_names
            vrow = rows.index(vkey)
            crow = int_names.index(spec.output + "$count")
        # the spec's row count is __seen's when its input is never NULL:
        # resident columns carry no NULLs; NULL constants, LEFT-join and
        # NULL-able gathered build columns, semi markers, divides and
        # NULL_IF can make one
        seen_count = p is None or not p.nullable
        if seen_count:
            src_rows[vrow if crow < 0 else crow] = 0
        spec_rows.append((_SPEC_KINDS[spec.name], int(spec.is_float), off,
                          vrow, crow, int(bool(p is not None
                                                and p.float_result)),
                          int(seen_count)))
    n_cols, n_steps = len(names), len(chain.steps)
    n_keys, n_joins = len(key_programs), len(joins)
    off_cols = _HEADER
    off_steps = off_cols + _COL_WORDS * (n_cols + len(virtual))
    off_keys = off_steps + n_steps
    off_specs = off_keys + 2 * n_keys
    off_rows = off_specs + _SPEC_WORDS * len(specs)
    off_src = off_rows + 2 * (len(int_names) + len(flt_names))
    off_joins = off_src + len(int_names)
    off_jkeys = off_joins + _JOIN_WORDS * n_joins
    prog_base = off_jkeys + sum(len(o) for o in join_key_offs)

    def rel(off):
        return -1 if off < 0 else prog_base + off

    programs = [p for p in step_programs + key_programs
                + list(agg_programs.values()) if p is not None]
    programs += [p for jp in joins for p in jp.key_programs]
    for p in programs:
        for op, _arg in p.ops:
            if op not in KERNEL_OPS:
                # the dictionary folds and the numeric forms after them
                # run in the torch chain only
                raise NotImplementedError(
                    f"opcode {OPS[op]} is not in the scan kernels' set")
    depth = max([p.depth for p in programs] + [1])
    # an opcode past the TPC-H Q1 / Q6 set (NEG_I on) takes the kernels'
    # EXT instances (csrc/scan_common.cuh eval_prog)
    ext = any(op >= OP["NEG_I"] for p in programs for op, _ in p.ops)
    words = [n_cols, n_steps, G, len(int_names), len(flt_names), len(specs),
             n_keys, off_cols, off_steps, off_keys, off_specs,
             off_rows, depth, off_src, n_joins, off_joins]
    # the column table: the scan's columns, then the probe steps' virtual
    # columns (kind, dtype, values, join, nulls, LEFT); pointers and dtypes
    # are filled per launch
    words += [0] * (_COL_WORDS * n_cols)
    for v in virtual:
        words += [_K_SEMI if v.kind == "semi" else _K_GATHER, 0, 0, v.join,
                  0, int(joins[v.join].step.is_left)]
    # a step word: a filter program's offset, -1 for none, -2 - j for the
    # probe step of join j
    join_of = {jp.step.si: j for j, jp in enumerate(joins)}
    words += [-2 - join_of[s] if s in join_of else rel(o)
              for s, o in enumerate(step_offs)]
    for o, s in zip(key_offs, strides):
        words += [rel(o), int(s)]
    for kind, is_f, off, vrow, crow, in_f, seen in spec_rows:
        words += [kind, is_f, rel(off), vrow, crow, in_f, seen]
    for k, v in zip(int_names, init_i.tolist()):  # lint: allow-host-sync
        words += [int(v), ops_of.get(k, _R_ADD)]
    for k, v in zip(flt_names, init_f.tolist()):  # lint: allow-host-sync
        words += [float_bits(v), ops_of.get(k, _R_ADD)]
    words += src_rows
    jkey_at = off_jkeys
    for jp, offs in zip(joins, join_key_offs):
        sp = jp.step
        form = (_FORM_SEMI if sp.kind == "semi"
                else _FORM_LEFT if sp.is_left else _FORM_INNER)
        words += [_TABLE_KINDS[sp.table], form, len(offs), jkey_at]
        words += [0] * (_JOIN_WORDS - 4)           # filled per launch
        jkey_at += len(offs)
    for offs in join_key_offs:
        words += [rel(o) for o in offs]
    words += progs

    # shared memory of the interpreter's layout (the hash kernel; the
    # direct kernel takes its CTA width from it): the staged plan vector
    # and parameters, the CTA's row counters, per-thread row counters,
    # stack slots (values for ROWS_PER_THREAD rows, one null mask) and, by
    # mode:
    #   direct  CTA integer accumulators and per-thread float slots;
    #   hash    with float rows, the warps' staged (slot, value) pairs;
    #           the integer rows' fold positions (one int each);
    # and per probe step each row's build-row index, hit and null masks.
    # A wide layout shrinks the CTA rather than exceed the limit.
    # smem_bytes leaves out the parameters and a grouped launch's on-chip
    # tables (table_bytes), added per launch.
    fixed = 8 * (len(words) + 1 + n_steps)
    per_thread = 8 * (1 + n_steps + depth * ROWS_PER_THREAD) + 4 * depth
    per_thread += n_joins * (4 * ROWS_PER_THREAD + 8)
    if mode == "direct":
        fixed += 8 * len(int_names) * G
        per_thread += 8 * len(flt_names) * G
    else:
        fixed += 4 * len(int_names)
        if flt_names:
            per_thread += 16 * ROWS_PER_THREAD
    cached = meta.get("cached_cols") or {}
    resident = [cached.get(meta["colmap"][n]) for n in names]
    staged, shape = (), ()
    if names and None not in resident:
        shape = scan_shape(resident)
        staged = staged_columns(first_reads(
            names, step_programs, joins, key_programs, agg_programs,
            specs), shape)

    def ring_at(threads):
        """The double mode's smallest ring and, for the hash kernel, its
        stage table and producer state for CTAs of `threads`."""
        ring = min_ring_bytes(staged, shape, threads)
        return ring + 8 * len(names) + _RING_CTL_BYTES if ring else 0
    if mode == "span":
        # the generated span kernel: no interpreter layout; its tables
        # beside the double mode's ring are ScanPlan.layout's
        ring = min_ring_bytes(staged, shape, THREADS)
        return ScanPlan(mode, names, n_steps, step_programs, key_programs,
                        tuple(strides), G, tuple(specs), agg_programs,
                        int_names, flt_names, init_i, init_f,
                        np.asarray(words, dtype=np.int64), THREADS, 0,
                        tuple(src_rows), 0, ring, 0, ext, tuple(joins),
                        tuple(virtual))
    n_fold = sum(1 for r, sr in enumerate(src_rows) if r == sr)
    slot_bytes = 8 * (n_fold + len(flt_names) + (mode == "hash"))
    threads = THREADS
    if mode == "hash":
        # an on-chip hash table leaves room for one CTA per SM: the widest
        # CTA whose table still holds the first table (first_slots),
        # beside the double mode's ring, keeps as many warps per SM as two
        # CTAs of THREADS would
        for t in range(HASH_MAX_THREADS, THREADS, -32):
            if (fixed + per_thread * t + ring_at(t) + 8 * MAX_PARAMS
                    + first_slots * slot_bytes <= MAX_SMEM_BYTES):
                threads = t
                break
    while threads > 32 and fixed + 8 * MAX_PARAMS + per_thread * threads \
            > MAX_SMEM_BYTES:
        threads -= 32
    smem = fixed + per_thread * threads
    if smem + 8 * MAX_PARAMS > MAX_SMEM_BYTES:
        raise NotImplementedError(
            f"accumulator layout of {smem} bytes exceeds the kernel's "
            f"shared memory")
    onchip_slots = warp_float_slots = 0
    # the generated direct kernel reserves its ring alone
    ring = min_ring_bytes(staged, shape, threads)
    if mode == "hash":
        # the largest table whose per-CTA accumulators (with the key-hash
        # mirror) fit beside this layout, the double mode's stage ring and
        # its stage table, and the parameters -- so a single and a double
        # launch take the same path and fold in the same order
        ring = ring_at(threads)
        room = max(0, MAX_SMEM_BYTES - smem - ring - 8 * MAX_PARAMS)
        onchip_slots = room // slot_bytes
        if flt_names:
            warp_float_slots = room // (slot_bytes + 8 * len(flt_names)
                                        * (threads // 32 - 1))
    return ScanPlan(mode, names, n_steps, step_programs, key_programs,
                    tuple(strides), G, tuple(specs), agg_programs,
                    int_names, flt_names, init_i, init_f,
                    np.asarray(words, dtype=np.int64), threads, smem,
                    tuple(src_rows), onchip_slots, ring, warp_float_slots,
                    ext, tuple(joins), tuple(virtual))


def _column_words(columns) -> List[int]:
    out: List[int] = []
    for rc in columns:
        a0 = rc.arrays[0]
        a1 = rc.arrays[1] if len(rc.arrays) > 1 else a0
        for a in rc.arrays:
            if not a.is_contiguous():
                raise ValueError("resident arrays must be contiguous")
        out += [_KINDS[rc.kind], _DTYPES[a0.dtype], a0.data_ptr(),
                _DTYPES[a1.dtype], a1.data_ptr(), int(a1.shape[0])]
    return out


def to_device(arr: np.ndarray, device) -> torch.Tensor:
    """`arr` on `device` through pinned host memory, copied without
    blocking the host: the caching host allocator keeps the pinned block
    until the copy has run."""
    host = torch.from_numpy(np.array(arr, copy=True, order="C"))
    if torch.device(device).type != "cuda":
        return host
    host = host.pin_memory()
    out = torch.empty(host.shape, dtype=host.dtype, device=device)
    out.copy_(host, non_blocking=True)
    return out


def init_outputs(plan: ScanPlan, device, G: Optional[int] = None):
    """acc_i (n_i, G) and acc_f (max(n_f, 1), G) filled with each row's
    initial value (G defaults to the plan's).  The initial rows are copied
    to the device once per plan."""
    G = plan.G if G is None else G
    init = plan.dev.get(("init", device))
    if init is None:
        init = plan.dev[("init", device)] = (
            to_device(plan.init_i.numpy(), device),
            to_device(plan.init_f.numpy(), device))
    acc_i = init[0][:, None].repeat(1, G)
    acc_f = (init[1][:, None].repeat(1, G) if plan.n_f
             else torch.zeros((1, G), dtype=torch.float64, device=device))
    return acc_i.contiguous(), acc_f.contiguous()


def step_operands(joins) -> List[tuple]:
    """A JoinPlan's flat operands cut per probe step."""
    out, off = [], 0
    for sp in joins.steps:
        out.append(joins.arrays[off:off + sp.arr_count])
        off += sp.arr_count
    return out


def _gathered(sp, arrs) -> List[tuple]:
    """(values, nulls or None) of each column a join step gathers."""
    out, i = [], 2
    for _name, has_nulls in sp.gcols:
        out.append((arrs[i], arrs[i + 1] if has_nulls else None))
        i += 2 if has_nulls else 1
    return out


def check_launch_inputs(columns, params, device, plan=None,
                        joins=None) -> None:
    """What every scan kernel takes: columns, parameters and the probe
    steps' build operands (contiguous) on `device`, at most MAX_PARAMS
    int64 parameters."""
    if device.type != "cuda":
        raise NotImplementedError(f"scan kernel on {device.type}")
    for rc in columns:
        if any(a.device != device for a in rc.arrays):
            raise ValueError("scan columns span devices")
    if params is not None and (params.device != device
                               or params.dtype != torch.int64
                               or params.numel() > MAX_PARAMS):
        raise ValueError(f"bound parameters must be at most {MAX_PARAMS} "
                         f"int64 values on the scan device")
    if plan is not None and plan.joins:
        if joins is None or len(joins.steps) != len(plan.joins):
            raise ValueError("the plan's probe steps need their join "
                             "operands")
        for a in joins.arrays:
            if a.device != device or not a.is_contiguous():
                raise ValueError("join operands must be contiguous on the "
                                 "scan device")


def directory_words(directory, size: int) -> Tuple[int, int]:
    """A probe step's (directory pointer, shift) words: a unique table's
    bucket directory (join.bucket_directory) and 64 - k; (0, 0) for a
    DirectTable."""
    if directory is None:
        return 0, 0
    from .join import directory_bits
    return directory.data_ptr(), 64 - directory_bits(size)


def _fill_join_words(plan: ScanPlan, words, joins) -> None:
    """This launch's operand pointers, table sizes and gathered columns'
    dtypes into the probe records and virtual column entries."""
    off_joins = int(words[_H_OFF_JOINS])
    per_step = step_operands(joins)
    for j, (jp, arrs) in enumerate(zip(plan.joins, per_step)):
        size = int(arrs[0].numel())
        bhn = arrs[2].data_ptr() if jp.step.kind == "semi" else 0
        rec = off_joins + _JOIN_WORDS * j
        words[rec + 4:rec + _JOIN_WORDS] = [
            arrs[0].data_ptr(), arrs[1].data_ptr(), size, bhn,
            *directory_words(joins.dirs[j], size)]
    base = _HEADER + _COL_WORDS * len(plan.names)
    for k, v in enumerate(plan.virtual):
        if v.kind != "gather":
            continue
        sp = plan.joins[v.join].step
        vals, nulls = _gathered(sp, per_step[v.join])[v.gather]
        off = base + _COL_WORDS * k
        words[off + 1] = _DTYPES[vals.dtype]
        words[off + 2] = vals.data_ptr()
        words[off + 4] = 0 if nulls is None else nulls.data_ptr()


class Launch(NamedTuple):
    """A launch's device inputs: the plan vector (with this launch's
    column table, probe operands and, for the stage ring, the stage table
    appended at word stage_tab), the grid as a (3, n_grid) int64 tensor,
    and the ring's stage count (1: unstaged), passes and bytes per stage
    and the launch's dynamic shared memory."""
    plan: torch.Tensor
    grid: torch.Tensor
    stages: int
    passes: int
    stage_tab: int
    stage_bytes: int
    smem_bytes: int


def launch_tensors(plan: ScanPlan, columns, grid, device, joins=None,
                   dma: str = "single", n_params: int = 0,
                   table_bytes: int = 0, slots: int = 0) -> Launch:
    """The launch's device inputs (Launch); `table_bytes` of on-chip tables
    (for `slots` slots) join its shared memory.  Under "double" the ring
    is the plan's staging (none when it stages nothing); raises
    NotImplementedError naming the bytes when the ring does not fit the
    kernel's shared memory beside the plan's layout."""
    words = plan.words.copy()
    words[_HEADER:_HEADER + _COL_WORDS * len(columns)] = \
        _column_words(columns)
    if plan.joins:
        _fill_join_words(plan, words, joins)
    smem = plan.smem_bytes + 8 * n_params + table_bytes
    stages, passes, stage_tab, stage_bytes = 1, 1, 0, 0
    st = launch_staging(plan, columns, dma, slots)
    if st is not None:
        stages, passes, stage_bytes = st.stages, st.passes, st.stage_bytes
        stage_tab = len(words)
        words = np.concatenate([words, np.asarray(st.offsets,
                                                  dtype=np.int64)])
        smem += 8 * len(st.offsets) + _RING_CTL_BYTES
        check_ring_fits(st, smem)
        smem += st.ring_bytes
    return Launch(_plan_words(plan, words, device),
                  to_device(np.asarray(grid, dtype=np.int64).T, device),
                  stages, passes, stage_tab, stage_bytes, smem)


# launched word vectors a plan keeps on the device (per column and build
# operand table)
_WORDS_KEPT = 8


def _plan_words(plan: ScanPlan, words: np.ndarray, device) -> torch.Tensor:
    """The launch's plan vector on the device: kept with the plan while its
    columns and build operands stay where they are, else uploaded."""
    kept = plan.dev.setdefault(("words", device), {})
    key = words.tobytes()
    dev = kept.get(key)
    if dev is None:
        if len(kept) >= _WORDS_KEPT:
            kept.pop(next(iter(kept)))
        dev = kept[key] = to_device(words, device)
    return dev


# ---------------------------------------------------------------------------
# kernel wrapper and its plain version
# ---------------------------------------------------------------------------

def join_kwargs(jplan, dma: str = "single") -> dict:
    """The wrappers' keywords for a JoinPlan's operands and the staging
    mode: none when the chain has no probe step and runs unstaged."""
    kw = {"joins": jplan} if jplan is not None and jplan.steps else {}
    if dma != "single":
        kw["dma"] = dma
    return kw


def direct_geometry(br: int) -> Tuple[int, int]:
    """(rows per work item, work items per grid entry) of a direct
    launch."""
    rows_per_cta = min(int(br), ROWS_PER_CTA)
    return rows_per_cta, -(-int(br) // rows_per_cta)


_SMS: Dict[int, int] = {}


def direct_kernel(plan: ScanPlan, columns, joins=None, dma: str = "single"):
    """The generated direct kernel (codegen.DirectKernel) of the plan over
    these columns' encodings, built once per plan, shape and ring: under
    "double" the plan's staging, unstaged where it stages nothing."""
    from . import codegen
    staging = launch_staging(plan, columns, dma)
    shape = codegen.column_shape(plan, columns, joins)
    key = ("direct", shape, staging)
    kern = plan.dev.get(key)
    if kern is None:
        kern = plan.dev[key] = codegen.generate(plan, shape, staging)
    return kern


def direct_ctas(kern, n_items: int, device) -> int:
    """CTAs of a direct launch: the persistent grid, SMs x the kernel's
    CTAs per SM (never more than work items)."""
    idx = device.index if device.index is not None else 0
    if idx not in _SMS:
        from .build import multiprocessors
        _SMS[idx] = multiprocessors(idx)
    return max(1, min(n_items, _SMS[idx] * kern.ctas_per_sm))


def direct_stage_counts(plan: ScanPlan, columns, grid, br: int,
                        joins=None) -> Tuple[int, int]:
    """The stage ring's (staged, prefetched) stage copies of a double-mode
    direct launch over `grid`; none when the plan stages nothing."""
    rows_per_cta, n_sub = direct_geometry(br)
    kern = direct_kernel(plan, columns, joins, "double")
    if kern.staging is None:
        return 0, 0
    n_ctas = direct_ctas(kern, len(grid) * n_sub, columns[0].device)
    return stage_ring_counts(kern.staging, grid, br, rows_per_cta, n_sub,
                             n_ctas)


def word_values(kern, plan: ScanPlan, columns, joins, fixed: dict):
    """The launch's argument words, by the kernel's recipe."""
    per_step = step_operands(joins) if plan.joins else []
    out = []
    for rec in kern.words:
        kind = rec[0]
        if kind in fixed:
            out.append(fixed[kind])
        elif kind == "lit":
            out.append(rec[1])
        elif kind in ("col0", "col1", "rle_n"):
            arrays = columns[rec[1]].arrays
            a1 = arrays[1] if len(arrays) > 1 else arrays[0]
            out.append(arrays[0].data_ptr() if kind == "col0"
                       else a1.data_ptr() if kind == "col1"
                       else int(a1.shape[0]))
        elif kind == "join":
            j, field = rec[1], rec[2]
            arrs = per_step[j]
            size = int(arrs[0].numel())
            out.append({"op0": arrs[0].data_ptr, "op1": arrs[1].data_ptr,
                        "size": lambda: size,
                        "bhn": lambda: arrs[2].data_ptr(),
                        "dir": lambda: directory_words(joins.dirs[j],
                                                       size)[0],
                        "shift": lambda: directory_words(joins.dirs[j],
                                                         size)[1],
                        }[field]())
        else:                                      # gval / gnull
            v = plan.virtual[rec[1]]
            vals, nulls = _gathered(plan.joins[v.join].step,
                                    per_step[v.join])[v.gather]
            t = vals if kind == "gval" else nulls
            out.append(0 if t is None else t.data_ptr())
    return (ctypes.c_longlong * len(out))(*out)


def scan_direct(plan: ScanPlan, columns, grid, br: int, params,
                joins=None, dma: str = "single"):
    """Run the fused scan over `grid` entries (bidx, lo, hi) of the
    ResidentColumns `columns` (plan.names order); `joins` (join.JoinPlan)
    holds the probe steps' build operands; dma="double" runs the stage
    ring of the plan's staging.  CUDA tensors launch the kernel generated
    for the plan's shape (codegen.py) and its reduce; CPU tensors run
    scan_direct_plain.  Returns (acc_i, acc_f, counts)."""
    device = columns[0].device
    check_dma(dma)
    if device.type == "cpu":
        return scan_direct_plain(plan, columns, grid, br, params, joins)
    check_launch_inputs(columns, params, device, plan, joins)
    counts = torch.zeros(1 + plan.n_steps, dtype=torch.int64, device=device)
    if not len(grid):
        return init_outputs(plan, device) + (counts,)
    from .build import load_generated
    kern = direct_kernel(plan, columns, joins, dma)
    mod = load_generated(kern.source, device.index or 0)
    rows_per_cta, n_sub = direct_geometry(br)
    n_ctas = direct_ctas(kern, len(grid) * n_sub, device)
    G = plan.G
    acc_i = torch.empty((plan.n_i, G), dtype=torch.int64, device=device)
    acc_f = (torch.empty((plan.n_f, G), dtype=torch.float64, device=device)
             if plan.n_f else
             torch.zeros((1, G), dtype=torch.float64, device=device))
    part_i = torch.empty((n_ctas, kern.n_fold, G), dtype=torch.int64,
                         device=device)
    part_f = torch.empty((n_ctas, max(plan.n_f, 1), G), dtype=torch.float64,
                         device=device)
    grid_dev = to_device(np.asarray(grid, dtype=np.int64).T, device)
    n_params = 0 if params is None else int(params.numel())
    words = word_values(kern, plan, columns, joins, {
        "grid": grid_dev.data_ptr(), "n_grid": len(grid), "br": int(br),
        "rows_per_cta": rows_per_cta, "n_sub": n_sub,
        "params": params.data_ptr() if n_params else 0,
        "part_i": part_i.data_ptr(), "part_f": part_f.data_ptr(),
        "counts": counts.data_ptr(), "acc_i": acc_i.data_ptr(),
        "acc_f": acc_f.data_ptr(), "n_parts": n_ctas})
    stream = torch.cuda.current_stream(device).cuda_stream
    mod.launch("scan_gen", n_ctas, kern.threads, kern.smem_bytes, stream,
               words)
    mod.launch("scan_gen_reduce", kern.n_slots, 256, 0, stream, words)
    count_launch("scan_direct", plan, kern.staging is not None)
    return acc_i, acc_f, counts


# guards the launch counters: the distributed scheduler's tasks launch
# kernels from several threads at once, and a bare += can lose a count
COUNT_LOCK = threading.Lock()


def bump(counts: Dict[str, int], name: str, n: int = 1) -> None:
    """counts[name] += n under COUNT_LOCK."""
    with COUNT_LOCK:
        counts[name] += n


def count_launch(name: str, plan: ScanPlan, staged: bool = False) -> None:
    """One launch of `name`; `staged`: it ran the stage ring."""
    with COUNT_LOCK:
        LAUNCHES[name] += 1
        if plan.joins:
            JOIN_LAUNCHES[name] += 1
        if staged:
            STAGED_LAUNCHES[name] += 1


def _truthy(c: Column):
    keep = c.values.to(torch.bool)
    return keep if c.nulls is None else keep & ~c.nulls


def scan_direct_plain(plan: ScanPlan, columns, grid, br: int, params,
                      joins=None):
    """The kernel's function in plain torch over the same grid entries:
    index_select / searchsorted decode, the torch ExprProgram evaluator,
    the join appliers (join.py) and agg_direct_update's one-hot grid."""
    device = columns[0].device
    state = ops.agg_direct_init(plan.G, plan.specs, device)
    counts = torch.zeros(1 + plan.n_steps, dtype=torch.int64, device=device)
    for rows in plain_row_groups(plan, columns, grid, br, params, counts,
                                 joins):
        state = ops.agg_direct_update(state, rows.batch, rows.codes(),
                                      rows.agg_inputs(), plan.specs, plan.G)
    return stacked_state(plan, state) + (counts,)


def stacked_state(plan: ScanPlan, state: dict):
    """(acc_i, acc_f) stacked in the plan's row order from a state dict."""
    acc_i = torch.stack([state[k] for k in plan.int_names])
    acc_f = (torch.stack([state[k] for k in plan.flt_names]) if plan.n_f
             else torch.zeros_like(acc_i[:1], dtype=torch.float64))
    return acc_i, acc_f


class PlainRows:
    """One group of decoded grid rows after the chain's steps: the
    plain versions' unit of work."""

    def __init__(self, plan: ScanPlan, cols, n: int, mask, params):
        self.plan = plan
        self.cols = cols
        self.n = n
        self.batch = Batch({}, mask)
        self.params = params

    def run(self, prog: ExprProgram) -> Column:
        return prog.run(self.cols, self.n, self.params, self.batch.device)

    def codes(self):
        """The combined stride code of the key programs."""
        codes = torch.zeros(self.n, dtype=torch.int64,
                            device=self.batch.device)
        for prog, stride in zip(self.plan.key_programs, self.plan.strides):
            codes = codes + self.run(prog).values.to(torch.int64) * stride
        return codes

    def agg_inputs(self) -> Dict[str, Optional[Column]]:
        return {out: (None if p is None else self.run(p))
                for out, p in self.plan.agg_programs.items()}


def plain_row_groups(plan: ScanPlan, columns, grid, br: int, params,
                     counts, joins=None):
    """Yield PlainRows over the grid entries, about PLAIN_ROWS rows at a
    time, adding each step's live rows to `counts`.  `joins` holds the
    probe steps' operands (join.JoinPlan)."""
    from .join import join_appliers
    if plan.joins and (joins is None or len(joins.steps) != len(plan.joins)):
        raise ValueError("the plan's probe steps need their join operands")
    appliers = join_appliers(joins, joins.arrays) if plan.joins else {}
    groups, rows = [], 0
    for ent in grid:
        groups.append(ent)
        rows += ent[2] - ent[1]
        if rows >= PLAIN_ROWS:
            yield _plain_group(plan, columns, groups, br, params, counts,
                               appliers)
            groups, rows = [], 0
    if groups:
        yield _plain_group(plan, columns, groups, br, params, counts,
                           appliers)


def _plain_group(plan, columns, entries, br, params, counts,
                 appliers) -> PlainRows:
    device = columns[0].device
    idx = torch.cat([torch.arange(b * br + lo, b * br + hi, device=device)
                     for b, lo, hi in entries])
    n = int(idx.numel())
    cols = {name: Column(rc.decode_rows(idx))
            for name, rc in zip(plan.names, columns)}
    mask = torch.ones(n, dtype=torch.bool, device=device)
    counts[0] += n
    joins = {jp.step.si: (j, jp) for j, jp in enumerate(plan.joins)}
    for s, prog in enumerate(plan.step_programs):
        if s in joins:
            # kernel #5's plain version: the probe keys' programs, then
            # the step's applier over them
            j, jp = joins[s]
            keys = {k: p.run(cols, n, params, device)
                    for k, p in zip(jp.step.probe_keys, jp.key_programs)}
            out = appliers[s](Batch(keys, mask))
            for v in plan.virtual:
                if v.join == j:
                    cols[v.name] = out.columns[v.name]
            mask = out.mask
        elif prog is not None:
            mask = mask & _truthy(prog.run(cols, n, params, device))
        counts[s + 1] += mask.sum()
    return PlainRows(plan, cols, n, mask, params)


# ---------------------------------------------------------------------------
# pipeline entry
# ---------------------------------------------------------------------------

def plan_joins(chain, aux, expands, declined):
    """chain_eligible with probe steps admitted, then the probe steps'
    operand layout (join.plan_join_layout under the byte cap).  Returns
    (cached, colmap, JoinPlan) or None after metering one decline."""
    from . import join as jk
    elig = chain_eligible(chain, declined)
    if elig is None:
        return None
    jplan = jk.plan_join_layout(chain.steps, aux, expands, declined,
                                max_bytes=jk.KERNEL_JOIN_MAX_BUILD_BYTES)
    if jplan is None:
        return None
    return elig + (jplan,)


def try_direct_scan_kernel(chain, params, *, specs, key_names, strides, G,
                           agg_inputs, cache, declined, runtime_stats=None,
                           aux=None, expands=(), pool=None,
                           dma: str = "single"):
    """Run the fused scan chain through the kernel when eligible.

    Chains with fanout-1 join/semi steps run their probes in the kernel
    (join.py); `aux` and `expands` are FusedChain.prep's tables and
    fanouts, and `pool` the MemoryContext charged the build operand bytes
    for the launch; dma="double" runs the stage ring (metered on the
    card).  Returns (agg_direct state dict, int64[1 + n_steps] row
    counters, grid length), or None after recording one
    kernelDeclined{reason}."""
    from .join import reserve_build_operands
    elig = plan_joins(chain, aux, expands, declined)
    if elig is None:
        return None
    cached, colmap, jplan = elig
    plan = cached_plan(cache, chain, declined, mode="direct", specs=specs,
                       key_names=key_names, strides=strides, G=G,
                       agg_inputs=agg_inputs, jplan=jplan)
    if plan is None:
        return None
    br = block_rows_for(chain.leaf_cap(()))
    grid = aligned_grid(chain.scan_meta, br,
                        chain.compiler.ctx.params_fingerprint)
    columns = gather_encoded_arrays(cached, colmap, plan.names)
    # the reference's gate order: the operand reservation comes last, and
    # only for a launch
    if grid and not reserve_build_operands(pool, jplan.reserve_bytes):
        declined("JoinBuildSize")
        return None
    try:
        acc_i, acc_f, counts = scan_direct(plan, columns, grid, br, params,
                                           **join_kwargs(jplan, dma))
    finally:
        if grid and pool is not None and jplan.reserve_bytes:
            pool.free(jplan.reserve_bytes)
    if grid:
        staged = (0, 0)
        if dma == "double" and columns[0].device.type == "cuda":
            staged = direct_stage_counts(plan, columns, grid, br, jplan)
        meter_kernel_run(runtime_stats, len(grid), *staged)
    return state_of(plan, acc_i, acc_f), counts, len(grid)


def cached_plan(cache, chain, declined, **kw) -> Optional[ScanPlan]:
    """The chain's ScanPlan for these arguments, built once per compiled
    aggregation and join layout; None after metering a PlanShape
    decline, with the plan build's message in cache["plan_error"]."""
    jplan = kw.get("jplan")
    key = ("plan", kw["mode"], kw["G"], tuple(kw["strides"]),
           jplan.sig if jplan is not None else ())
    plan = cache.get(key)
    if plan is None:
        try:
            plan = build_scan_plan(chain, **kw)
        except NotImplementedError as e:
            # the caller's raise names what the plan lacks
            cache["plan_error"] = str(e)
            declined("PlanShape")
            return None
        cache[key] = plan
    return plan


def state_of(plan: ScanPlan, acc_i, acc_f) -> dict:
    """Stacked accumulator rows -> the state dict they stand for."""
    state = {k: acc_i[j] for j, k in enumerate(plan.int_names)}
    state.update({k: acc_f[j] for j, k in enumerate(plan.flt_names)})
    return state
