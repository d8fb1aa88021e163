"""Fanout-1 join and semi-join probes inside the scan kernels (kernel #5).

The port of presto_tpu/exec/kernels/join.py.  A fused chain's join and
semi steps (exec/fused.py) run INSIDE the direct, span and hash scan
kernels, between the filter steps and the aggregation fold:
decode -> filter -> probe (-> probe ...) -> fold in one launch.  Two
probe forms, the same two the reference lowers:

  * DirectTable: dense integer key; the probe is one int32 slot gather,
    (key - base) bounds-checked.
  * the hash-sorted ops.BuildTable: multi-column or sparse keys; the
    probe hashes the keys with hash_columns, flips the sign bit
    (ops._orderable_hash) and finds its lower bound in keyhash_sorted.  A
    hit compares the key HASHES only, as the reference does (parity needs
    the same hits).  The kernels find the lower bound through the table's
    bucket directory (bucket_directory: one load of the hash's bucket,
    then a bisect inside it), which gives the reference's
    searchsorted(side="left") index by construction.

plan_join_layout inspects the chain's join/semi steps once per launch and
flattens every build operand (slot / hash arrays, gathered build columns,
the semi null-key flag) into one positional list; the kernels read them
from device memory (at SF10 they are at most 4 MiB and stay in the
H100's 50 MB L2).  The CUDA probe is csrc/scan_common.cuh probe_direct /
probe_unique (called by the generated direct and span kernels and by the
hash kernel's probe_step); join_appliers below are its plain torch
version, which the plain versions of all three scan kernels run.

Gates (kernelDeclined reasons, scan_kernel.KERNEL_DECLINE_REASONS):
  JoinShape      fanout-k expansion joins (expands[ji] > 1), residual
                 ON filters, non-INNER/LEFT forms, and dictionary build
                 columns (their decode state lives outside the kernel)
  JoinBuildSize  flattened operand bytes over
                 KERNEL_JOIN_MAX_BUILD_BYTES, or the MemoryContext
                 reservation for them failed
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ...spi import plan as P
from .. import operators as ops
from ..batch import Batch, Column

# cap on the flattened build-operand bytes one launch may hold (the
# reference's VMEM gate, kept so both packages pick the same path for the
# same query)
KERNEL_JOIN_MAX_BUILD_BYTES = 1 << 22


class JoinStepPlan(NamedTuple):
    si: int                            # chain step index
    kind: str                          # "join" | "semi"
    table: str                         # "direct" | "unique"
    is_left: bool                      # LEFT join (null-extend misses)
    probe_keys: Tuple[str, ...]        # probe-side key column names
    out_name: str                      # semi marker output ("" for join)
    gcols: Tuple[Tuple[str, bool], ...]  # (build column, has_nulls)
    arr_count: int                     # flat operands this step consumes


class JoinPlan(NamedTuple):
    steps: Tuple[JoinStepPlan, ...]
    arrays: tuple                      # flat device operands, step order
    sig: tuple                         # hashable layout key (plan cache)
    nbytes: int                        # flattened operand bytes (the gate)
    # per step, a unique table's bucket directory (None for a
    # DirectTable): read by the kernels, not by the plain version
    dirs: tuple
    dir_bytes: int

    @property
    def reserve_bytes(self) -> int:
        """Bytes a launch charges its MemoryContext: the operands and the
        directories the kernels read beside them."""
        return self.nbytes + self.dir_bytes


# buckets of a directory computed at once: at SF100 a 600 M-row build has
# 2^31 buckets, whose int64 bounds and search results at once took 32 GiB
DIRECTORY_CHUNK = 1 << 24


def bucket_directory(khs: torch.Tensor) -> torch.Tensor:
    """A unique table's bucket directory over its keyhash_sorted `khs`
    (n entries, order-preserving int64): for k = directory_bits(n), an
    int32 array D of 2^k + 1 entries with D[b] = searchsorted(khs,
    orderable(b << (64 - k)), side="left") for b < 2^k -- the lower bound
    of the first hash whose unsigned top k bits are b -- and D[2^k] = n.
    The lower bound of any hash in bucket b lies in [D[b], D[b + 1]]
    (csrc/scan_common.cuh probe_unique).  Built on the table's device,
    DIRECTORY_CHUNK buckets at a time, so its temporaries stay small
    beside the int32 directory itself."""
    n = int(khs.numel())
    k = directory_bits(n)
    half = 1 << (k - 1)
    out = torch.empty((1 << k) + 1, dtype=torch.int32, device=khs.device)
    out[1 << k] = n
    for lo in range(0, 1 << k, DIRECTORY_CHUNK):
        hi = min(1 << k, lo + DIRECTORY_CHUNK)
        if k == 1:
            starts = torch.tensor([ops.INT64_MIN, 0], dtype=torch.int64,
                                  device=khs.device)
        else:
            # orderable(b << (64 - k)) = (b - 2^(k-1)) * 2^(64-k), in range
            starts = torch.arange(lo - half, hi - half, dtype=torch.int64,
                                  device=khs.device) * (1 << (64 - k))
        out[lo:hi] = torch.searchsorted(khs, starts, side="left",
                                        out_int32=True)
    return out


def directory_bits(n: int) -> int:
    """k of a directory over n entries: 2^k > 2n buckets (at least 1
    bit)."""
    return max(1, n.bit_length() + 1)


def plan_join_layout(steps, aux, expands, declined, max_bytes=None):
    """Flatten the chain's join/semi build tables into a kernel operand
    layout.  `steps`/`aux`/`expands` use FusedChain.prep's layout
    (aux[0] = scan columns, aux[ji + 1] per join-ish step).  Returns a
    JoinPlan (empty when the chain has no join/semi steps) or None
    after metering one decline."""
    from ..fused import DirectTable, _join_build_cols
    jsteps = []
    arrays = []
    sig = []
    dirs = []
    nbytes = dir_bytes = 0
    ji = 0
    for si, step in enumerate(steps):
        kind = step[0]
        if kind not in ("join", "semi"):
            continue
        node = step[1]
        ent = aux[ji + 1]
        fanout = expands[ji]
        ji += 1
        if fanout != 1:
            # fanout-k expansion changes the chunk capacity mid-chain;
            # the kernel's fixed row geometry cannot follow it
            declined("JoinShape")
            return None
        is_left = False
        out_name = ""
        if kind == "semi":
            tbl, bhn = ent
            probe_keys = (node.source_join_variable.name,)
            gcols: Tuple[Tuple[str, bool], ...] = ()
            out_name = node.semi_join_output.name
        else:
            tbl = ent
            if node.filter is not None \
                    or node.join_type not in (P.INNER, P.LEFT):
                declined("JoinShape")
                return None
            is_left = node.join_type == P.LEFT
            probe_keys = tuple(l.name for l, _r in node.criteria)
            build_names = {v.name for v in node.right.output_variables}
            out_names = [v.name for v in node.outputs]
            gspec = []
            for n in _join_build_cols(node, out_names, build_names):
                c = tbl.columns[n]
                if c.dictionary is not None or c.lazy is not None:
                    declined("JoinShape")
                    return None
                gspec.append((n, c.nulls is not None))
            gcols = tuple(gspec)
        if isinstance(tbl, DirectTable):
            table_kind = "direct"
            step_arrays = [tbl.slots, tbl.base]
            dirs.append(None)
        elif isinstance(tbl, ops.BuildTable):
            table_kind = "unique"
            step_arrays = [tbl.keyhash_sorted, tbl.perm]
            dirs.append(tbl.directory)
            dir_bytes += 4 * int(tbl.directory.numel())
        else:
            declined("JoinShape")
            return None
        for n, has_nulls in gcols:
            c = tbl.columns[n]
            step_arrays.append(c.values)
            if has_nulls:
                step_arrays.append(c.nulls)
        if kind == "semi":
            step_arrays.append(torch.tensor(
                [bool(bhn)], dtype=torch.bool, device=step_arrays[0].device))
        nbytes += sum(int(a.numel()) * a.element_size() for a in step_arrays)
        jsteps.append(JoinStepPlan(si, kind, table_kind, is_left,
                                   probe_keys, out_name, gcols,
                                   len(step_arrays)))
        sig.append((si, kind, table_kind, is_left, probe_keys, out_name,
                    gcols))
        arrays += step_arrays
    if jsteps and max_bytes is not None and nbytes > max_bytes:
        declined("JoinBuildSize")
        return None
    return JoinPlan(tuple(jsteps), tuple(arrays), tuple(sig), nbytes,
                    tuple(dirs), dir_bytes)


def reserve_build_operands(pool, nbytes: int) -> bool:
    """Charge the kernel's build operands (JoinPlan.reserve_bytes: with
    the unique tables' directories) to the owning operator's
    MemoryContext for the launch: the launched kernel reads them, so they
    must stay resident until it ends.  The caller frees the same byte
    count after the launch."""
    if pool is None or not nbytes:
        return True
    return pool.try_reserve(nbytes)


def _bisect_left(a, v):
    """searchsorted(a, v, side="left"): the reference's fixed-trip bisect
    is an exact integer search, so torch's search gives the same index."""
    return torch.searchsorted(a, v, side="left")


def _make_applier(sp: JoinStepPlan, arrs):
    """One chain-step replacement closure over the step's operand arrays:
    Batch -> Batch, with the join's gathered build columns or the semi
    marker added."""
    if sp.table == "direct":
        from ..fused import DirectTable
        table = DirectTable(arrs[0], arrs[1], {})

        def probe(batch):
            return ops.direct_lookup(batch, table, sp.probe_keys[0])
    else:
        khs, perm = arrs[0], arrs[1]

        def probe(batch):
            # the hash-sorted unique probe: one left bisect per row
            cols = [batch.columns[k] for k in sp.probe_keys]
            kh = ops._orderable_hash(ops.hash_columns(cols))
            nb = perm.shape[0]
            lo = _bisect_left(khs, kh).clamp(0, nb - 1)
            hit = khs[lo] == kh
            for c in cols:
                if c.nulls is not None:
                    hit = hit & ~c.nulls
            return hit, torch.where(hit, perm[lo], torch.zeros_like(perm[lo]))

    if sp.kind == "semi":
        bhn = arrs[2]

        def semi_applier(batch):
            hit, _ = probe(batch)
            # three-valued marker: NULL probe key, or miss against a
            # build side that contained NULL
            nulls = ~hit & bhn[0]
            pn = batch.columns[sp.probe_keys[0]].nulls
            if pn is not None:
                nulls = nulls | pn
            cols = dict(batch.columns)
            cols[sp.out_name] = Column(hit, nulls)
            return Batch(cols, batch.mask)
        return semi_applier

    gathered = []
    i = 2
    for name, has_nulls in sp.gcols:
        gv = arrs[i]
        i += 1
        gn = None
        if has_nulls:
            gn = arrs[i]
            i += 1
        gathered.append((name, gv, gn))

    def join_applier(batch):
        hit, bidx = probe(batch)
        bidx = bidx.long()
        cols = dict(batch.columns)
        for name, gv, gn in gathered:
            vals = gv[bidx]
            nulls = gn[bidx] if gn is not None else None
            if sp.is_left:
                # null-extend build columns on misses; probe rows stay
                miss = ~hit
                nulls = (nulls | miss) if nulls is not None else miss
            cols[name] = Column(vals, nulls)
        if sp.is_left:
            return Batch(cols, batch.mask)
        return Batch(cols, batch.mask & hit)
    return join_applier


def join_appliers(plan: JoinPlan, arrs):
    """{step index: applier} closures over the flat operand arrays (in
    plan.arrays order)."""
    appliers = {}
    off = 0
    for sp in plan.steps:
        appliers[sp.si] = _make_applier(sp, arrs[off:off + sp.arr_count])
        off += sp.arr_count
    return appliers
