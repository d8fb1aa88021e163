"""Physical operators over device Batches (torch).

The subset of presto_tpu/exec/operators.py the port runs: the hash
mixer and key hashing, filter application, direct-slot, span and hashed
open-addressing aggregation (init / update / finalize: the BASIC
aggregates everywhere, the moment, corr and HyperLogLog states in the
hashed table), the runtime span's dependent-key check (depkey_*), the
sort aggregation (sort_group_aggregate, approx_percentile included), the
decimal average, the join build and probe primitives (the hash-sorted
BuildTable, the direct-address lookup, the semi-join markers), sort
permutations, TopN and Limit, window functions (default_frame_window,
the window kernel's function; window_batch, the path after its
WindowFunctionShape decline) and compaction.  Every function takes
tensors on one device and allocates on that device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .batch import Batch, Column

INT64_MIN = -(1 << 63)
INT64_MAX = (1 << 63) - 1


def as_int64(c: int) -> int:
    """An unsigned 64-bit constant as the int64 with the same bits."""
    return c - (1 << 64) if c >= (1 << 63) else c


def lsr(x, k: int):
    """Logical right shift of int64 bits: torch has no uint64 arithmetic,
    so the arithmetic shift's sign fill is masked off."""
    return (x >> k) & ((1 << (64 - k)) - 1)


_GOLDEN = as_int64(0x9E3779B97F4A7C15)
_MIX1 = as_int64(0xBF58476D1CE4E5B9)
_MIX2 = as_int64(0x94D049BB133111EB)


def splitmix64(x):
    """splitmix64 over int64 tensors holding uint64 bit patterns; int64
    addition and multiplication wrap exactly like their uint64 forms."""
    x = x.to(torch.int64) + _GOLDEN
    x = (x ^ lsr(x, 30)) * _MIX1
    x = (x ^ lsr(x, 27)) * _MIX2
    return x ^ lsr(x, 31)


def umod(x, n: int):
    """Unsigned remainder of int64-held uint64 bits by 0 < n < 2**62:
    x = 2 * (x >>> 1) + (x & 1), and both halves are non-negative."""
    half = lsr(x, 1) % n
    return (half * 2 + (x & 1)) % n


def key_bits(c: Column):
    """A key column's values as the int64 bits hash_columns mixes: float64
    bit patterns, booleans as 0/1, integers sign-extended."""
    v = c.values
    if v.dtype == torch.float64:
        return v.view(torch.int64)
    if v.dtype == torch.float32:
        return v.view(torch.int32).to(torch.int64)
    return v.to(torch.int64)


def hash_columns(cols: List[Column], salt: int = 0):
    """Combined 64-bit hash of key columns (nulls hash distinctly), as
    int64 bits; the reference's uint64 arithmetic wraps the same way."""
    h = torch.full(cols[0].values.shape, salt + 1, dtype=torch.int64,
                   device=cols[0].values.device)
    for c in cols:
        hv = splitmix64(key_bits(c))
        if c.nulls is not None:
            hv = torch.where(c.nulls, torch.full_like(hv, _GOLDEN), hv)
        h = splitmix64(h * 31 + hv)
    return h


# ---------------------------------------------------------------------------
# filter
# ---------------------------------------------------------------------------

def apply_filter(batch: Batch, predicate: Column) -> Batch:
    """SQL filter: keep rows where predicate is TRUE (not false, not null)."""
    keep = predicate.values.to(torch.bool)
    if predicate.nulls is not None:
        keep = keep & ~predicate.nulls
    return batch.with_mask(batch.mask & keep)


# ---------------------------------------------------------------------------
# aggregation
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class AggSpec:
    """One aggregate: function name, whether input is float, output column.
    param carries a constant argument (approx_percentile's p, an HLL
    register count)."""
    name: str          # sum/count/count_star/min/max/avg/stddev*/var*/
    #                    corr/covar_*/approx_distinct/approx_percentile
    output: str
    is_float: bool = False
    param: object = None


# aggregates every execution mode supports; anything else runs in the
# hashed table or the sort path
BASIC_AGGS = {"sum", "avg", "count", "count_star", "min", "max"}
# moment-based aggregates (count / mean / M2 state)
MOMENT_AGGS = {"stddev", "stddev_pop", "stddev_samp", "variance",
               "var_pop", "var_samp"}
CORR_AGGS = {"corr", "covar_pop", "covar_samp"}
# aggregates only the sort path implements (value-ordered segments)
SORT_ONLY_AGGS = {"approx_percentile"}
# HyperLogLog sketch aggregates (dense register arrays, scatter-max)
HLL_AGGS = {"approx_distinct"}

# 2^11 registers: standard error 1.04/sqrt(2048) = 2.3%, approx_distinct's
# default bound
HLL_DEFAULT_BUCKETS = 2048
HLL_MIN_STANDARD_ERROR = 0.0040625
HLL_MAX_STANDARD_ERROR = 0.26

DIRECT_AGG_MAX_GROUPS = 64


def hll_buckets_for_error(e: float) -> int:
    """max-standard-error -> power-of-two register count m with
    1.04/sqrt(m) <= e, clamped to [2^4, 2^16]."""
    if not (HLL_MIN_STANDARD_ERROR <= e <= HLL_MAX_STANDARD_ERROR):
        raise ValueError(
            f"approx_distinct standard error {e} out of range "
            f"[{HLL_MIN_STANDARD_ERROR}, {HLL_MAX_STANDARD_ERROR}]")
    m = 16
    while 1.04 / math.sqrt(m) > e and m < (1 << 16):
        m *= 2
    return m


def _bit_length64(x):
    """Per-element bit length of non-negative int64 values (0 for 0)."""
    bl = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    for s in (32, 16, 8, 4, 2, 1):
        big = x >= (1 << s)
        bl = bl + big.to(torch.int32) * s
        x = torch.where(big, lsr(x, s), x)
    return bl + (x > 0).to(torch.int32)


def _hll_bucket_rank(h, m: int):
    """uint64 hash bits (in int64) -> (bucket index, rank int8): bucket =
    the low log2(m) bits; rank = the leading-zero count of the remaining
    64-p bits + 1.  The shift is logical, so the rest is non-negative."""
    p = m.bit_length() - 1
    bucket = h & (m - 1)
    rem = lsr(h, p)
    rank = ((64 - p) - _bit_length64(rem) + 1).to(torch.int8)
    return bucket, rank


def _hll_alpha(m: int) -> float:
    if m == 16:
        return 0.673
    if m == 32:
        return 0.697
    if m == 64:
        return 0.709
    return 0.7213 / (1 + 1.079 / m)


def _hll_estimate(registers, m: int):
    """(G * m) int8 registers -> int64 cardinality estimates (G,):
    HyperLogLog with the small-range linear-counting correction."""
    R = registers.reshape(-1, m).to(torch.float64)
    Z = torch.exp2(-R).sum(dim=1)
    E = _hll_alpha(m) * m * m / Z
    V = (R == 0.0).sum(dim=1)
    lin = m * torch.log(m / torch.clamp(V.to(torch.float64), min=1.0))
    est = torch.where((E <= 2.5 * m) & (V > 0), lin, E)
    return torch.round(est).to(torch.int64)


def hll_state_bytes(specs) -> int:
    """Extra per-slot accumulator bytes for HLL register arrays."""
    return sum((s.param or HLL_DEFAULT_BUCKETS)
               for s in specs if s.name in HLL_AGGS)


def _chan_merge(na, ma, m2a, nb, mb, m2b):
    """Chan et al. parallel merge of central-moment states (n, mean, M2):
    an empty side contributes nothing (its mean is 0 and the delta term is
    scaled by na * nb)."""
    n = na + nb
    nf = torch.clamp(n.to(torch.float64), min=1.0)
    naf = na.to(torch.float64)
    nbf = nb.to(torch.float64)
    delta = mb - ma
    mean = ma + delta * nbf / nf
    m2 = m2a + m2b + delta * delta * naf * nbf / nf
    return n, mean, m2


def _moment_finalize(name, m2, n):
    """(value, is_null) for a variance-family aggregate from M2 and the
    count."""
    nf = n.to(torch.float64)
    pop = name in ("stddev_pop", "var_pop")
    denom = (torch.clamp(nf, min=1.0) if pop
             else torch.clamp(nf - 1.0, min=1.0))
    var = torch.clamp(m2, min=0.0) / denom
    if name.startswith("stddev"):
        var = torch.sqrt(var)
    return var, n < (1 if pop else 2)


def _corr_finalize(name, m2x, m2y, cxy, n):
    """(value, is_null) from central cross-moments."""
    nf = n.to(torch.float64)
    if name == "corr":
        den = torch.sqrt(torch.clamp(m2x, min=0.0)
                         * torch.clamp(m2y, min=0.0))
        null = (n < 1) | (den == 0)
        return cxy / torch.where(den == 0, torch.ones_like(den), den), null
    if name == "covar_samp":
        return cxy / torch.clamp(nf - 1.0, min=1.0), n < 2
    return cxy / torch.clamp(nf, min=1.0), n < 1


def _acc_dtype(spec: AggSpec):
    return torch.float64 if spec.is_float else torch.int64


def agg_direct_init(G: int, specs: Tuple[AggSpec, ...], device) -> dict:
    state = {"__seen": torch.zeros(G, dtype=torch.int64, device=device)}
    state.update(_spec_state(G, specs, device))
    return state


def _spec_state(G: int, specs: Tuple[AggSpec, ...], device,
                hashed: bool = False) -> dict:
    """The per-aggregate accumulator entries shared by every mode's state:
    the BASIC aggregates, and in the hashed table (hashed=True) the
    moment, corr and HLL states; any other function raises
    NotImplementedError."""
    def zeros(dt=torch.int64):
        return torch.zeros(G, dtype=dt, device=device)

    state = {}
    for spec in specs:
        if spec.name in ("count", "count_star"):
            state[spec.output] = zeros()
        elif spec.name == "avg":
            state[spec.output + "$sum"] = zeros(_acc_dtype(spec))
            state[spec.output + "$count"] = zeros()
        elif spec.name == "sum":
            state[spec.output] = zeros(_acc_dtype(spec))
            state[spec.output + "$count"] = zeros()
        elif spec.name in ("min", "max"):
            if spec.is_float:
                init = float("inf") if spec.name == "min" else float("-inf")
            else:
                init = INT64_MAX if spec.name == "min" else INT64_MIN
            state[spec.output] = torch.full((G,), init,
                                            dtype=_acc_dtype(spec),
                                            device=device)
            state[spec.output + "$count"] = zeros()
        elif hashed and spec.name in MOMENT_AGGS:
            for suffix in ("$mean", "$m2"):
                state[spec.output + suffix] = zeros(torch.float64)
            state[spec.output + "$count"] = zeros()
        elif hashed and spec.name in CORR_AGGS:
            for suffix in ("$mx", "$my", "$m2x", "$m2y", "$cxy"):
                state[spec.output + suffix] = zeros(torch.float64)
            state[spec.output + "$count"] = zeros()
        elif hashed and spec.name in HLL_AGGS:
            m = spec.param or HLL_DEFAULT_BUCKETS
            # a flat (G * m) register file: one scatter-max per batch
            state[spec.output + "$hll"] = torch.zeros(
                G * m, dtype=torch.int8, device=device)
        else:
            raise NotImplementedError(spec.name)
    return state


def agg_direct_update(state: dict, batch: Batch, codes,
                      agg_inputs: Dict[str, Optional[Column]],
                      specs: Tuple[AggSpec, ...], G: int) -> dict:
    """codes: combined group code per row (int, < G).  One-hot (G, rows)
    grid of the live rows, reduced per group."""
    groups = torch.arange(G, dtype=codes.dtype, device=codes.device)
    grid = (codes[None, :] == groups[:, None]) & batch.mask[None, :]
    out = dict(state)
    out["__seen"] = state["__seen"] + grid.sum(dim=1)
    for spec in specs:
        if spec.name == "count_star":
            out[spec.output] = state[spec.output] + grid.sum(dim=1)
            continue
        col = agg_inputs[spec.output]
        sel = grid if col.nulls is None else grid & ~col.nulls[None, :]
        nn = sel.sum(dim=1)
        x = col.values
        if x.dtype == torch.bool:
            x = x.to(torch.int8)
        if spec.name == "count":
            out[spec.output] = state[spec.output] + nn
        elif spec.name in ("sum", "avg"):
            dt = _acc_dtype(spec)
            xs = torch.where(sel, x[None, :].to(dt),
                             torch.zeros((), dtype=dt, device=x.device)
                             ).sum(dim=1)
            key = spec.output + "$sum" if spec.name == "avg" else spec.output
            out[key] = state[key] + xs
            out[spec.output + "$count"] = state[spec.output + "$count"] + nn
        elif spec.name in ("min", "max"):
            is_min = spec.name == "min"
            dt = _acc_dtype(spec)
            if spec.is_float:
                ident = float("inf") if is_min else float("-inf")
            else:
                ident = INT64_MAX if is_min else INT64_MIN
            vals = torch.where(sel, x[None, :].to(dt),
                               torch.full((), ident, dtype=dt,
                                          device=x.device))
            red = vals.amin(dim=1) if is_min else vals.amax(dim=1)
            out[spec.output] = (torch.minimum if is_min else torch.maximum)(
                state[spec.output], red)
            out[spec.output + "$count"] = state[spec.output + "$count"] + nn
        else:
            raise NotImplementedError(spec.name)
    return out


def _decimal_avg(s, cnt, empty):
    """Presto decimal avg: round-half-away-from-zero integer division at
    the input scale."""
    safe = torch.where(empty, torch.ones_like(cnt), cnt)
    q = torch.sign(s) * ((torch.abs(s) + safe // 2) // safe)
    return q.to(torch.int64)


def agg_direct_finalize(state: dict, specs: Tuple[AggSpec, ...],
                        key_names: Tuple[str, ...],
                        key_doms: Tuple[int, ...],
                        key_dtypes,
                        key_dicts: Dict[str, Tuple[str, ...]],
                        force_row: bool = False) -> Batch:
    """Decode slot index -> key codes, then the accumulators -> output
    columns.  force_row: a global aggregation yields one row even over no
    input."""
    G = 1
    for d in key_doms:
        G *= d
    seen = state["__seen"]
    device = seen.device
    occupied = (seen > 0) | force_row
    cols: Dict[str, Column] = {}
    slot = torch.arange(G, dtype=torch.int64, device=device)
    stride = G
    for k, dom, dt in zip(key_names, key_doms, key_dtypes):
        stride //= dom
        code = (slot // stride) % dom
        cols[k] = Column(code.to(dt), None, key_dicts.get(k))
    _finalize_specs(state, specs, cols)
    return Batch(cols, occupied)


def _finalize_specs(state: dict, specs: Tuple[AggSpec, ...],
                    cols: Dict[str, Column]) -> None:
    """Accumulators -> one output column per aggregate, into `cols`."""
    for spec in specs:
        if spec.name in ("count", "count_star"):
            cols[spec.output] = Column(state[spec.output], None)
        elif spec.name in ("sum", "min", "max"):
            # SQL: an aggregate over zero non-null inputs is NULL
            empty = state[spec.output + "$count"] == 0
            cols[spec.output] = Column(state[spec.output], empty)
        elif spec.name == "avg":
            s = state[spec.output + "$sum"]
            c = state[spec.output + "$count"]
            empty = c == 0
            if spec.is_float:
                safe_c = torch.where(empty, torch.ones_like(c), c)
                cols[spec.output] = Column(s / safe_c.to(torch.float64),
                                           empty)
            else:
                cols[spec.output] = Column(_decimal_avg(s, c, empty), empty)
        elif spec.name in MOMENT_AGGS:
            cols[spec.output] = Column(*_moment_finalize(
                spec.name, state[spec.output + "$m2"],
                state[spec.output + "$count"]))
        elif spec.name in CORR_AGGS:
            cols[spec.output] = Column(*_corr_finalize(
                spec.name, state[spec.output + "$m2x"],
                state[spec.output + "$m2y"], state[spec.output + "$cxy"],
                state[spec.output + "$count"]))
        elif spec.name in HLL_AGGS:
            # approx_distinct is never NULL: 0 over empty / all-NULL input
            cols[spec.output] = Column(_hll_estimate(
                state[spec.output + "$hll"],
                spec.param or HLL_DEFAULT_BUCKETS), None)
        else:
            raise NotImplementedError(spec.name)


# ---------------------------------------------------------------------------
# span aggregation: closed key domains, combined stride code = slot
# ---------------------------------------------------------------------------

# max accumulator length for span-direct (scatter-indexed) aggregation
SPAN_AGG_MAX_GROUPS = 1 << 26


def _scatter(dst, slot, vals, how: str):
    """dst.at[slot].<how>(vals, mode="drop"): a slot equal to len(dst)
    lands in an overflow entry that is dropped."""
    n = dst.shape[0]
    buf = torch.cat([dst, dst[:1]])
    vals = vals.to(dst.dtype)
    if how == "set":
        buf[slot] = vals
    elif how == "add":
        buf.index_add_(0, slot, vals)
    else:
        buf.scatter_reduce_(0, slot, vals, how, include_self=True)
    return buf[:n]


def _scatter_specs(state: dict, out: dict, slot, mask,
                   agg_inputs: Dict[str, Optional[Column]],
                   specs: Tuple[AggSpec, ...]) -> None:
    """Scatter each aggregate's live inputs into its accumulators at
    `slot` (rows outside `mask` carry the drop slot).  NULL inputs fold as
    the operation's identity and are not counted."""
    ones = mask.to(torch.int64)
    for spec in specs:
        o = spec.output
        if spec.name == "count_star":
            out[o] = _scatter(state[o], slot, ones, "add")
            continue
        col = agg_inputs[o]
        valid = mask & ~col.null_mask()
        vones = valid.to(torch.int64)
        if spec.name == "count":
            out[o] = _scatter(state[o], slot, vones, "add")
            continue
        if spec.name not in BASIC_AGGS:
            raise NotImplementedError(f"aggregate {spec.name}")
        dt = _acc_dtype(spec)
        v = col.values.to(dt)
        if spec.name in ("sum", "avg"):
            key = o if spec.name == "sum" else o + "$sum"
            out[key] = _scatter(state[key], slot,
                                torch.where(valid, v, torch.zeros_like(v)),
                                "add")
        else:
            is_min = spec.name == "min"
            if spec.is_float:
                fill = float("inf") if is_min else float("-inf")
            else:
                fill = INT64_MAX if is_min else INT64_MIN
            out[o] = _scatter(state[o], slot,
                              torch.where(valid, v, torch.full_like(v, fill)),
                              "amin" if is_min else "amax")
        out[o + "$count"] = _scatter(state[o + "$count"], slot, vones, "add")


def agg_span_init(G: int, specs: Tuple[AggSpec, ...], device) -> dict:
    """State for span-direct aggregation: integer group codes in [0, G)
    index the accumulators directly; the group keys are not stored (the
    caller rebuilds them from the slot index, agg_span_finalize)."""
    return agg_direct_init(G, specs, device)


def agg_span_update(state: dict, batch: Batch, codes,
                    agg_inputs: Dict[str, Optional[Column]],
                    specs: Tuple[AggSpec, ...], G: int) -> dict:
    """codes: per-row group index, in [0, G) for live rows; masked rows
    (and codes off the grid) are routed out of range and dropped."""
    codes = codes.to(torch.int64)
    mask = batch.mask & (codes >= 0) & (codes < G)
    slot = torch.where(mask, codes, torch.full_like(codes, G))
    out = dict(state)
    out["__seen"] = _scatter(state["__seen"], slot, mask.to(torch.int64),
                             "add")
    _scatter_specs(state, out, slot, mask, agg_inputs, specs)
    return out


def agg_span_finalize(state: dict, specs: Tuple[AggSpec, ...],
                      key_names: Tuple[str, ...],
                      key_arrays: Dict[str, torch.Tensor],
                      key_dicts: Dict[str, Tuple[str, ...]],
                      key_nulls: Optional[Dict[str, torch.Tensor]] = None,
                      key_lazy: Optional[Dict[str, Tuple]] = None
                      ) -> Batch:
    """key_arrays: slot index -> key value per key (rebuilt by the
    caller from the slot's stride decomposition, or the runtime span's
    base + slot and dependent keys)."""
    fake = dict(state)
    fake["__occupied"] = state["__seen"] > 0
    G = state["__seen"].shape[0]
    for k in key_names:
        fake[f"__key_{k}"] = key_arrays[k]
        fake[f"__keynull_{k}"] = (key_nulls or {}).get(
            k, torch.zeros(G, dtype=torch.bool,
                           device=key_arrays[k].device))
    return agg_finalize(fake, specs, key_names, key_dicts, key_lazy)


# ---------------------------------------------------------------------------
# runtime span: dependent grouping keys constant within an anchor group
# ---------------------------------------------------------------------------

def _depkey_restore(minv, dtype):
    if dtype == torch.float64:
        return minv.view(torch.float64)
    if dtype == torch.float32:
        return minv.to(torch.int32).view(torch.float32)
    return minv.to(dtype)


def depkey_init(G: int, names: Tuple[str, ...], device) -> dict:
    """Accumulators verifying that the grouping keys `names` are constant
    within each anchor-key group."""
    st = {}
    for k in names:
        st[f"__dep_{k}$min"] = torch.full((G,), INT64_MAX, dtype=torch.int64,
                                          device=device)
        st[f"__dep_{k}$max"] = torch.full((G,), INT64_MIN, dtype=torch.int64,
                                          device=device)
        st[f"__dep_{k}$nulls"] = torch.zeros(G, dtype=torch.int64,
                                             device=device)
    return st


def depkey_update(st: dict, batch: Batch, codes, key_cols: Dict[str, Column],
                  G: int) -> dict:
    """Per-group min / max (and NULL count) of each dependent key."""
    out = dict(st)
    if not key_cols:
        return out
    mask = batch.mask
    slot = torch.where(mask, codes, torch.full_like(codes, G))
    for k, c in key_cols.items():
        # exact int64 bits (floats bitcast): the check needs constancy
        v = key_bits(c)
        valid = mask if c.nulls is None else mask & ~c.nulls
        out[f"__dep_{k}$min"] = _scatter(
            st[f"__dep_{k}$min"], slot,
            torch.where(valid, v, torch.full_like(v, INT64_MAX)), "amin")
        out[f"__dep_{k}$max"] = _scatter(
            st[f"__dep_{k}$max"], slot,
            torch.where(valid, v, torch.full_like(v, INT64_MIN)), "amax")
        if c.nulls is not None:
            out[f"__dep_{k}$nulls"] = _scatter(
                st[f"__dep_{k}$nulls"], slot,
                (mask & c.nulls).to(torch.int64), "add")
    return out


def depkey_verify(st: dict, seen, names: Tuple[str, ...]):
    """All-groups scalar tensor: every dependent key is uniform (one
    non-NULL value, or all NULL) within every occupied group."""
    ok = torch.ones((), dtype=torch.bool, device=seen.device)
    for k in names:
        minv, maxv = st[f"__dep_{k}$min"], st[f"__dep_{k}$max"]
        nc = st[f"__dep_{k}$nulls"]
        uniform = ((nc == 0) & (minv == maxv)) | (nc == seen)
        ok = ok & torch.all(uniform | (seen == 0))
    return ok


# ---------------------------------------------------------------------------
# hashed aggregation: open addressing over 64-bit key hashes
# ---------------------------------------------------------------------------

# the reference's uint64 0xFFFFFFFFFFFFFFFF, as int64 bits
EMPTY_SLOT = -1
PROBE_ROUNDS = 16


def agg_init(num_slots: int, specs: Tuple[AggSpec, ...],
             key_names: Tuple[str, ...], key_dtypes, device) -> dict:
    """A fresh accumulator table: keyhash (EMPTY_SLOT when free),
    occupancy, the collision flag, per-key values and null flags, and the
    per-aggregate accumulators."""
    state = {
        "__keyhash": torch.full((num_slots,), EMPTY_SLOT, dtype=torch.int64,
                                device=device),
        "__occupied": torch.zeros(num_slots, dtype=torch.bool, device=device),
        "__collision": torch.zeros((), dtype=torch.bool, device=device),
    }
    for name, dtype in zip(key_names, key_dtypes):
        state[f"__key_{name}"] = torch.zeros(num_slots, dtype=dtype,
                                             device=device)
        state[f"__keynull_{name}"] = torch.zeros(num_slots, dtype=torch.bool,
                                                 device=device)
    state.update(_spec_state(num_slots, specs, device, hashed=True))
    return state


def _probe_place(table, kh, mask, num_slots: int):
    """PROBE_ROUNDS rounds of linear probing of the rows in `mask` into
    the keyhash table: each round the pending rows whose current slot is
    free propose their keyhash there, an unsigned scatter-min picks one
    winner per slot, rows whose keyhash now matches their slot's are
    placed, and the rest advance one slot.  Returns the new table (the
    given one is not written), each row's slot and the rows left
    pending.  The rounds touch only the rows' slots: the table is held
    with its sign bit flipped, so signed order is the unsigned order and
    EMPTY_SLOT, the largest uint64, loses every scatter-min."""
    flip = table ^ INT64_MIN
    empty = EMPTY_SLOT ^ INT64_MIN
    khf = kh ^ INT64_MIN
    slot = umod(kh, num_slots)
    pending = mask
    placed_slot = torch.zeros_like(slot)
    for _ in range(PROBE_ROUNDS):
        propose = pending & (flip[slot] == empty)
        flip.scatter_reduce_(0, slot, torch.where(propose, khf, empty),
                             "amin", include_self=True)
        win = pending & (flip[slot] == khf)
        placed_slot = torch.where(win, slot, placed_slot)
        pending = pending & ~win
        slot = torch.where(pending, (slot + 1) % num_slots, slot)
    return flip ^ INT64_MIN, placed_slot, pending


def agg_update(state: dict, batch: Batch, key_cols: List[Column],
               agg_inputs: Dict[str, Optional[Column]],
               specs: Tuple[AggSpec, ...], num_slots: int, salt: int,
               key_names: Tuple[str, ...] = (),
               agg_inputs2: Optional[Dict[str, Column]] = None) -> dict:
    """Scatter one batch into the accumulator table: open addressing,
    linear probing vectorized as PROBE_ROUNDS scatter rounds.  Each round
    the pending rows propose their keyhash for their current slot, an
    (unsigned) scatter-min picks one winner per free slot, rows whose
    keyhash now matches their slot's are placed, and the rest advance one
    slot.  Rows still pending after every round set __collision and are
    dropped; the caller re-runs with a doubled table."""
    mask = batch.mask
    out = dict(state)
    if key_cols:
        kh = hash_columns(key_cols, salt)
        kh = torch.where(kh == EMPTY_SLOT, torch.zeros_like(kh), kh)
    else:
        kh = torch.zeros(mask.shape, dtype=torch.int64, device=mask.device)
    table, placed_slot, pending = _probe_place(state["__keyhash"], kh, mask,
                                               num_slots)
    out["__collision"] = state["__collision"] | pending.any()
    out["__keyhash"] = table
    out["__occupied"] = table != EMPTY_SLOT
    mask = mask & ~pending          # unplaced rows drop (the retry redoes all)
    slot = torch.where(mask, placed_slot, torch.full_like(placed_slot,
                                                          num_slots))
    for kname, col in zip(key_names, key_cols):
        name = f"__key_{kname}"
        out[name] = _scatter(state[name], slot, col.values, "set")
        if col.nulls is not None:
            nname = f"__keynull_{kname}"
            out[nname] = _scatter(state[nname], slot, col.nulls, "set")
    _scatter_specs(state, out, slot, mask, agg_inputs,
                   tuple(s for s in specs if s.name in BASIC_AGGS))
    for spec in specs:
        if spec.name in MOMENT_AGGS:
            _moment_update(state, out, spec.output, slot, mask,
                           agg_inputs[spec.output], num_slots)
        elif spec.name in CORR_AGGS:
            _corr_update(state, out, spec.output, slot, mask,
                         agg_inputs[spec.output],
                         agg_inputs2[spec.output], num_slots)
        elif spec.name in HLL_AGGS:
            m = spec.param or HLL_DEFAULT_BUCKETS
            col = agg_inputs[spec.output]
            valid = mask & ~col.null_mask()
            # a salt-free value hash: registers are the same across the
            # probe salts of the retries
            bucket, rank = _hll_bucket_rank(hash_columns([col]), m)
            idx = torch.where(valid, slot * m + bucket,
                              torch.full_like(slot, num_slots * m))
            key = spec.output + "$hll"
            out[key] = _scatter(state[key], idx, rank, "amax")
    return out


def agg_merge(a: dict, b: dict, specs: Tuple[AggSpec, ...],
              key_names: Tuple[str, ...], num_slots: int) -> dict:
    """Merge accumulator state `b` into `a` (partial->final combining).

    With probing, the same key can occupy different slots in the two
    tables, so b's occupied slots are re-inserted into a as a
    pseudo-batch: the slot arrays of b become "rows" whose values are b's
    accumulators (the probe rounds of agg_update over b's keyhashes)."""
    out = dict(a)
    mask = b["__occupied"]
    table, placed_slot, pending = _probe_place(a["__keyhash"],
                                               b["__keyhash"], mask,
                                               num_slots)
    out["__collision"] = a["__collision"] | b["__collision"] | pending.any()
    out["__keyhash"] = table
    out["__occupied"] = table != EMPTY_SLOT
    mask = mask & ~pending
    slot = torch.where(mask, placed_slot,
                       torch.full_like(placed_slot, num_slots))

    for kname in key_names:
        for name in (f"__key_{kname}", f"__keynull_{kname}"):
            out[name] = _scatter(a[name], slot, b[name], "set")

    def _masked(key):
        return torch.where(mask, b[key], torch.zeros_like(b[key]))

    def _add(key):
        out[key] = _scatter(a[key], slot, _masked(key), "add")

    def _realign(key, dtype=torch.float64):
        # b's per-slot values re-addressed to a's slot space; distinct keys
        # land on distinct slots, so add-into-zeros is an exact placement
        return _scatter(torch.zeros(num_slots, dtype=dtype,
                                    device=mask.device),
                        slot, _masked(key), "add")

    for spec in specs:
        o = spec.output
        if spec.name in MOMENT_AGGS:
            n, mean, m2 = _chan_merge(
                a[o + "$count"], a[o + "$mean"], a[o + "$m2"],
                _realign(o + "$count", torch.int64), _realign(o + "$mean"),
                _realign(o + "$m2"))
            out[o + "$count"], out[o + "$mean"], out[o + "$m2"] = \
                n, mean, m2
        elif spec.name in CORR_AGGS:
            na = a[o + "$count"]
            nb = _realign(o + "$count", torch.int64)
            mxb = _realign(o + "$mx")
            myb = _realign(o + "$my")
            n, mx, m2x = _chan_merge(na, a[o + "$mx"], a[o + "$m2x"], nb,
                                     mxb, _realign(o + "$m2x"))
            _, my, m2y = _chan_merge(na, a[o + "$my"], a[o + "$m2y"], nb,
                                     myb, _realign(o + "$m2y"))
            nf = torch.clamp(n.to(torch.float64), min=1.0)
            dx = mxb - a[o + "$mx"]
            dy = myb - a[o + "$my"]
            out[o + "$cxy"] = (a[o + "$cxy"] + _realign(o + "$cxy")
                               + dx * dy * na.to(torch.float64)
                               * nb.to(torch.float64) / nf)
            out[o + "$count"], out[o + "$mx"], out[o + "$my"] = n, mx, my
            out[o + "$m2x"], out[o + "$m2y"] = m2x, m2y
        elif spec.name in ("count", "count_star"):
            _add(o)
        elif spec.name == "avg":
            _add(o + "$sum")
            _add(o + "$count")
        elif spec.name == "sum":
            _add(o)
            _add(o + "$count")
        elif spec.name in ("min", "max"):
            is_min = spec.name == "min"
            if spec.is_float:
                fill = float("inf") if is_min else float("-inf")
            else:
                fill = INT64_MAX if is_min else INT64_MIN
            out[o] = _scatter(a[o], slot,
                              torch.where(mask, b[o],
                                          torch.full_like(b[o], fill)),
                              "amin" if is_min else "amax")
            _add(o + "$count")
        elif spec.name in HLL_AGGS:
            m = spec.param or HLL_DEFAULT_BUCKETS
            key = o + "$hll"
            breg = torch.where(mask[:, None], b[key].reshape(-1, m),
                               torch.zeros((), dtype=torch.int8,
                                           device=mask.device))
            rows = a[key].shape[0] // m
            buf = torch.cat([a[key].reshape(-1, m),
                             torch.zeros((1, m), dtype=torch.int8,
                                         device=mask.device)])
            idx = torch.where(mask, slot, torch.full_like(slot, rows))
            buf.scatter_reduce_(0, idx[:, None].expand(-1, m), breg,
                                "amax", include_self=True)
            out[key] = buf[:rows].reshape(-1)
    return out


def _batch_moments(slot, valid, x, num_slots):
    """This batch's per-slot (count, mean) of x over the valid rows, and
    each row's deviation from its slot's mean (0 elsewhere)."""
    vslot = torch.where(valid, slot, torch.full_like(slot, num_slots))
    gslot = torch.where(valid, slot, torch.zeros_like(slot))
    nb = _scatter(torch.zeros(num_slots, dtype=torch.int64,
                              device=x.device), vslot,
                  torch.ones_like(vslot), "add")
    nbf = torch.clamp(nb.to(torch.float64), min=1.0)
    mb = _scatter(torch.zeros(num_slots, dtype=torch.float64,
                              device=x.device), vslot, x, "add") / nbf
    dev = torch.where(valid, x - mb[gslot], torch.zeros_like(x))
    return vslot, nb, mb, dev


def _moment_update(state, out, o, slot, mask, col, num_slots):
    """Two scatter passes per batch -- the batch's (n, mean), then its M2
    around that mean -- folded into the running state by _chan_merge."""
    valid = mask & ~col.null_mask()
    x = col.values.to(torch.float64)
    vslot, nb, mb, cx = _batch_moments(slot, valid, x, num_slots)
    m2b = _scatter(torch.zeros_like(mb), vslot, cx * cx, "add")
    n, mean, m2 = _chan_merge(state[o + "$count"], state[o + "$mean"],
                              state[o + "$m2"], nb, mb, m2b)
    out[o + "$count"], out[o + "$mean"], out[o + "$m2"] = n, mean, m2


def _corr_update(state, out, o, slot, mask, col, col2, num_slots):
    """The cross-moment form of _moment_update over (x, y) pairs."""
    valid = mask & ~col.null_mask() & ~col2.null_mask()
    x = col.values.to(torch.float64)
    y = col2.values.to(torch.float64)
    vslot, nb, mxb, cx = _batch_moments(slot, valid, x, num_slots)
    _vs, _nb, myb, cy = _batch_moments(slot, valid, y, num_slots)
    zeros = torch.zeros_like(mxb)
    m2xb = _scatter(zeros, vslot, cx * cx, "add")
    m2yb = _scatter(zeros, vslot, cy * cy, "add")
    cxyb = _scatter(zeros, vslot, cx * cy, "add")
    na = state[o + "$count"]
    n, mx, m2x = _chan_merge(na, state[o + "$mx"], state[o + "$m2x"],
                             nb, mxb, m2xb)
    _, my, m2y = _chan_merge(na, state[o + "$my"], state[o + "$m2y"],
                             nb, myb, m2yb)
    nf = torch.clamp(n.to(torch.float64), min=1.0)
    dx = mxb - state[o + "$mx"]
    dy = myb - state[o + "$my"]
    out[o + "$cxy"] = (state[o + "$cxy"] + cxyb
                       + dx * dy * na.to(torch.float64)
                       * nb.to(torch.float64) / nf)
    out[o + "$count"], out[o + "$mx"], out[o + "$my"] = n, mx, my
    out[o + "$m2x"], out[o + "$m2y"] = m2x, m2y


def agg_finalize(state: dict, specs: Tuple[AggSpec, ...],
                 key_names: Tuple[str, ...],
                 key_dicts: Dict[str, Tuple[str, ...]],
                 key_lazy: Optional[Dict[str, Tuple]] = None) -> Batch:
    """Accumulator table -> output Batch (capacity == num_slots, mask ==
    occupied).  key_lazy carries the late-materialization tags of
    open-domain string keys, which group by row identity (their values
    are source row ids)."""
    cols: Dict[str, Column] = {}
    for name in key_names:
        cols[name] = Column(state[f"__key_{name}"],
                            state.get(f"__keynull_{name}"),
                            key_dicts.get(name),
                            (key_lazy or {}).get(name))
    _finalize_specs(state, specs, cols)
    return Batch(cols, state["__occupied"])


# ---------------------------------------------------------------------------
# join: hash-sorted build, direct-address lookup, semi-join markers
# ---------------------------------------------------------------------------

def _orderable_hash(kh):
    """uint64 hash bits (held in int64) -> order-preserving int64: the
    sign bit flipped, so signed order is the unsigned order."""
    return kh ^ INT64_MIN


@dataclass
class BuildTable:
    """Materialized, hash-sorted build side."""
    keyhash_sorted: torch.Tensor     # order-preserving int64, padding = max
    perm: torch.Tensor               # sort permutation (int32)
    columns: Dict[str, Column]       # original (unsorted) build columns
    valid_count: torch.Tensor        # scalar int32
    run_len: torch.Tensor            # per-position equal-key run length
    # the kernels' bucket directory over keyhash_sorted
    # (kernels/join.py bucket_directory), set by the fused chain's prep
    directory: Optional[torch.Tensor] = None


def build_table(batch: Batch, key_names: List[str], salt: int = 0
                ) -> BuildTable:
    """Sort the build side by key hash (padding rows sort to the end),
    with per-position run lengths of equal key hashes.  The sort is
    stable, as the reference's, so equal hashes keep their row order."""
    key_cols = [batch.columns[k] for k in key_names]
    kh = _orderable_hash(hash_columns(key_cols, salt))
    kh = torch.where(batch.mask, kh, torch.full_like(kh, INT64_MAX))
    perm = torch.argsort(kh, stable=True).to(torch.int32)
    kh_sorted = kh[perm.long()]
    n = kh_sorted.shape[0]
    pos = torch.arange(n, dtype=torch.int32, device=kh.device)
    is_start = torch.cat([torch.ones(1, dtype=torch.bool, device=kh.device),
                          kh_sorted[1:] != kh_sorted[:-1]])
    run_start = torch.cummax(torch.where(is_start, pos, torch.zeros_like(pos)),
                             0).values
    run_len = _run_end(is_start, n) - run_start
    return BuildTable(kh_sorted, perm, dict(batch.columns),
                      batch.mask.sum().to(torch.int32), run_len)


def _run_end(is_start, n: int):
    """Per-position exclusive end of the containing equal-key run: the next
    run's start, filled backwards (reverse cummin of start positions)."""
    pos = torch.arange(n, dtype=torch.int32, device=is_start.device)
    starts_rev = torch.flip(torch.where(is_start, pos,
                                        torch.full_like(pos, n)), [0])
    ends = torch.flip(torch.cummin(starts_rev, 0).values, [0])
    return torch.cat([ends[1:], torch.full((1,), n, dtype=torch.int32,
                                           device=is_start.device)])


def direct_lookup(batch: Batch, dt, probe_key: str):
    """(hit, build_row_index) for a direct-address table lookup: the slot
    math shared by the join probe and the direct semi marker.  Misses
    return index 0 (callers mask or null those rows); NULL probe keys
    never match."""
    col = batch.columns[probe_key]
    v = col.values.to(torch.int64)
    size = dt.slots.shape[0]
    k = v - dt.base
    inb = (k >= 0) & (k < size)
    slot = dt.slots[k.clamp(0, size - 1)]
    hit = inb & (slot >= 0)
    if col.nulls is not None:
        hit = hit & ~col.nulls
    return hit, torch.where(hit, slot, torch.zeros_like(slot))


def _semi_marker(hit, probe_null, build_has_null) -> Column:
    """The three-valued semi-join marker: TRUE on a match, NULL when the
    probe key is NULL or when a miss meets a build side that held a NULL
    key (x IN (..., NULL) is UNKNOWN, never FALSE), else FALSE."""
    if probe_null is None and isinstance(build_has_null, bool) \
            and not build_has_null:
        return Column(hit, None)
    nulls = ~hit & build_has_null
    if probe_null is not None:
        nulls = nulls | probe_null
    return Column(hit, nulls)


def semi_join_mark_direct(batch: Batch, dt, probe_key: str,
                          build_has_null=False) -> Column:
    """semi_join_mark against a direct-address table."""
    hit, _ = direct_lookup(batch, dt, probe_key)
    return _semi_marker(hit, batch.columns[probe_key].nulls, build_has_null)


def semi_join_mark(batch: Batch, table: BuildTable, probe_keys: List[str],
                   salt: int = 0, build_has_null=False) -> Column:
    """SemiJoin marker with SQL three-valued semantics (reference
    HashSemiJoinOperator) against a hash-sorted build.  Callers exclude
    NULL build keys before building and pass `build_has_null` (a python
    bool or a bool tensor) to report them."""
    kh = _orderable_hash(hash_columns(
        [batch.columns[k] for k in probe_keys], salt))
    lo = torch.searchsorted(table.keyhash_sorted, kh, side="left").clamp(
        0, table.perm.shape[0] - 1)
    hit = table.keyhash_sorted[lo] == kh
    probe_null = None
    for k in probe_keys:
        nn = batch.columns[k].nulls
        if nn is not None:
            hit = hit & ~nn
            probe_null = nn if probe_null is None else probe_null | nn
    return _semi_marker(hit, probe_null, build_has_null)


def _pair_filter(pairs: Batch, filter_fn):
    """The ON filter's keep mask over joined pairs (NULL is not kept)."""
    pred = filter_fn(pairs)
    keep = pred.values.to(torch.bool)
    if pred.nulls is not None:
        keep = keep & ~pred.nulls
    return keep


def _mark_matched(matched, build_idx, alive):
    """FULL joins: OR each surviving pair into its build row's flag."""
    hits = torch.zeros(matched.shape[0], dtype=torch.int32,
                       device=matched.device)
    hits.index_add_(0, build_idx, alive.to(torch.int32))
    return matched | (hits > 0)


def probe_join(batch: Batch, table: BuildTable, probe_keys: List[str],
               build_output: List[str], out_capacity: int,
               salt: int = 0, join_type: str = "INNER", filter_fn=None,
               matched=None):
    """Equi-join probe: (joined Batch, overflow flag, live total, matched).

    One searchsorted over the hash-sorted build gives each probe row its
    run of equal key hashes; the runs are laid out end to end into
    `out_capacity` output rows (overflow when they do not fit).  Output
    columns are every probe column plus `build_output`.  INNER: one row
    per (probe row, build row) pair passing the optional ON filter
    `filter_fn` (Batch -> Column over the pairs).  LEFT: probe rows with
    no surviving pair (the filter applies to pairs BEFORE
    null-extension) add one row with NULL build columns, in an extra
    region of batch.capacity rows.  `matched` (FULL joins) records the
    build rows with a surviving pair.  The flag and total are device
    scalars (no host sync)."""
    dev = batch.device
    kh = _orderable_hash(hash_columns(
        [batch.columns[k] for k in probe_keys], salt))
    nb = table.perm.shape[0]
    lo = torch.searchsorted(table.keyhash_sorted, kh, side="left")
    lo_c = lo.clamp(0, nb - 1)
    hit = table.keyhash_sorted[lo_c] == kh
    # SQL equi-join: a NULL key never matches
    for k in probe_keys:
        nn = batch.columns[k].nulls
        if nn is not None:
            hit = hit & ~nn
    counts = torch.where(batch.mask & hit, table.run_len[lo_c].to(torch.int64),
                         torch.zeros_like(lo))
    offsets = torch.cumsum(counts, 0)
    total = offsets[-1]
    overflow = total > out_capacity
    starts = offsets - counts

    j = torch.arange(out_capacity, dtype=torch.int64, device=dev)
    # the probe row of output j: each row's index scattered at its start
    # slot, then forward-filled (cummax); starts past the capacity drop
    rows = torch.arange(batch.capacity, dtype=torch.int64, device=dev)
    at = torch.where((counts > 0) & (starts < out_capacity), starts,
                     torch.full_like(starts, out_capacity))
    rowmark = torch.zeros(out_capacity + 1, dtype=torch.int64, device=dev)
    rowmark.scatter_reduce_(0, at, rows, reduce="amax")
    row = torch.cummax(rowmark[:out_capacity], 0).values
    k = j - starts[row]                       # match ordinal within the row
    build_pos = (lo[row] + k).clamp(0, nb - 1)
    build_idx = table.perm[build_pos].to(torch.int64)
    out_mask = j < total

    out_cols: Dict[str, Column] = {
        name: col.gather(row) for name, col in batch.columns.items()}
    for name in build_output:
        out_cols[name] = table.columns[name].gather(build_idx)
    pairs = Batch(out_cols, out_mask)
    if filter_fn is not None:
        pairs = pairs.with_mask(pairs.mask & _pair_filter(pairs, filter_fn))
    if matched is not None:
        matched = _mark_matched(matched, build_idx, pairs.mask)
    if join_type == "INNER":
        return pairs, overflow, total, matched

    # LEFT / FULL: one null-extended row per probe row without a
    # surviving pair (an extra region of batch.capacity rows)
    has = torch.zeros(batch.capacity, dtype=torch.int32, device=dev)
    has.index_add_(0, row, pairs.mask.to(torch.int32))
    extra_mask = batch.mask & (has == 0)
    final_cols: Dict[str, Column] = {}
    for name, col in batch.columns.items():
        pc = pairs.columns[name]
        nulls = None
        if pc.nulls is not None or col.nulls is not None:
            nulls = torch.cat([pc.null_mask(), col.null_mask()])
        final_cols[name] = Column(
            torch.cat([pc.values, col.values]), nulls, col.dictionary,
            col.lazy, None if col.lengths is None
            else torch.cat([pc.lengths, col.lengths]))
    for name in build_output:
        pc = pairs.columns[name]
        src = table.columns[name]
        pad = torch.zeros((batch.capacity,) + tuple(pc.values.shape[1:]),
                          dtype=pc.values.dtype, device=dev)
        nulls = torch.cat([pc.null_mask(),
                           torch.ones(batch.capacity, dtype=torch.bool,
                                      device=dev)])
        final_cols[name] = Column(
            torch.cat([pc.values, pad]), nulls, src.dictionary, src.lazy,
            None if pc.lengths is None else torch.cat(
                [pc.lengths, torch.zeros(batch.capacity, dtype=torch.int32,
                                         device=dev)]))
    final_mask = torch.cat([pairs.mask, extra_mask])
    # the live total of the emitted batch (pairs + null-extended rows), so
    # callers can right-size compaction; overflow is the pair region's
    return (Batch(final_cols, final_mask), overflow,
            total + extra_mask.to(torch.int64).sum(), matched)


def probe_join_direct(batch: Batch, dt, probe_key: str,
                      build_output: List[str], join_type: str = "INNER",
                      filter_fn=None, matched=None):
    """Fanout-1 equi-join probe against a direct-address table
    (fused.DirectTable): one gather, and the output capacity is the probe
    capacity, so no overflow and no live count.  probe_join's semantics:
    the ON filter applies to pairs before null-extension, `matched`
    (FULL joins) records the build rows with a surviving pair."""
    hit, bidx = direct_lookup(batch, dt, probe_key)
    hit = hit & batch.mask
    bidx = torch.where(hit, bidx, torch.zeros_like(bidx)).to(torch.int64)
    out_cols: Dict[str, Column] = dict(batch.columns)
    for name in build_output:
        out_cols[name] = dt.columns[name].gather(bidx)
    pairs = Batch(out_cols, hit)
    if filter_fn is not None:
        hit = hit & _pair_filter(pairs, filter_fn)
        pairs = pairs.with_mask(hit)
    if matched is not None:
        matched = _mark_matched(matched, bidx, hit)
    if join_type == "INNER":
        return pairs, matched
    # LEFT / FULL: the null-extended row IS the probe row (fanout 1)
    final_cols = dict(batch.columns)
    for name in build_output:
        c = pairs.columns[name]
        nulls = ~hit if c.nulls is None else (~hit | c.nulls)
        final_cols[name] = Column(c.values, nulls, c.dictionary, c.lazy,
                                  c.lengths)
    return Batch(final_cols, batch.mask), matched


# ---------------------------------------------------------------------------
# sort / compaction
# ---------------------------------------------------------------------------

def sort_indices(batch: Batch, keys: List[Tuple[str, str]]):
    """Stable sort permutation honoring sort orders; padding rows last.
    keys: [(column, ASC_NULLS_FIRST|...)].  A lexicographic sort is a
    chain of stable sorts from the least significant key up."""
    device = batch.device
    arrays = []
    for name, order in reversed(keys):
        col = batch.columns[name]
        v = col.values
        desc = order.startswith("DESC")
        if col.lazy is not None:
            from ..connectors import catalog as _catalog
            _, table, column, _sf = col.lazy
            if (table, column) not in _catalog.ROWID_ORDERED:
                raise NotImplementedError(
                    "ORDER BY on a late-materialized string column")
            # values are row ids; the generator's id order is lex order
        if col.dictionary is not None:
            # codes -> lexical ranks (host-precomputed)
            rank = np.argsort(np.argsort(np.array(col.dictionary)))
            v = torch.from_numpy(rank.astype(np.int64)).to(device)[
                v.to(torch.int64)]
        if v.dtype == torch.bool:
            v = v.to(torch.int8)
        if v.is_floating_point():
            v = torch.where(torch.isnan(v), torch.full_like(v, float("inf")),
                            v)    # NaN sorts as largest (Presto)
            key = -v if desc else v
            nullv = float("inf")
        else:
            if (col.nulls is not None or desc) and v.dtype != torch.int64:
                v = v.to(torch.int64)
            key = -v if desc else v
            nullv = INT64_MAX
        if col.nulls is not None:
            fill = -nullv if order.endswith("NULLS_FIRST") else nullv
            key = torch.where(col.nulls, torch.full_like(key, fill), key)
        arrays.append(key)
    arrays.append((~batch.mask).to(torch.int8))     # padding sorts last
    perm = torch.arange(batch.capacity, device=device)
    for key in arrays:
        perm = perm[torch.argsort(key[perm], stable=True)]
    return perm


def topn(batch: Batch, keys: List[Tuple[str, str]], n: int) -> Batch:
    """Take first n rows by sort order; result capacity = min(n, rows)."""
    perm = sort_indices(batch, keys)[:n]
    cols = {name: c.gather(perm) for name, c in batch.columns.items()}
    return Batch(cols, batch.mask[perm])


def sort_batch(batch: Batch, keys: List[Tuple[str, str]]) -> Batch:
    perm = sort_indices(batch, keys)
    cols = {name: c.gather(perm) for name, c in batch.columns.items()}
    return Batch(cols, batch.mask[perm])


def limit(batch: Batch, n: int, already_consumed) -> Tuple[Batch, object]:
    """Keep first n valid rows across batches; returns new consumed count."""
    rank = torch.cumsum(batch.mask.to(torch.int64), 0) + already_consumed
    keep = batch.mask & (rank <= n)
    return (batch.with_mask(keep),
            already_consumed + batch.mask.to(torch.int64).sum())


# ---------------------------------------------------------------------------
# window functions
# (reference: presto-main-base/.../operator/WindowOperator.java:69; default
#  frame RANGE UNBOUNDED PRECEDING .. CURRENT ROW, i.e. running aggregates
#  include the current row's full peer group)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class WindowSpec:
    """One window function over the node's shared (partition, order) spec.

    frame: None = default (RANGE UNBOUNDED PRECEDING .. CURRENT ROW) or a
    normalized tuple (type, start_kind, start_off, end_kind, end_off) per
    the reference WindowFrame (presto-main-base/.../operator/window/).
    extra: constant arguments (lag/lead offset + default, nth_value n,
    ntile n)."""
    name: str
    output: str
    arg: Optional[str] = None   # input column (None for ranking / count(*))
    is_float: bool = False      # float accumulation (vs int64 / decimal)
    frame: Optional[tuple] = None
    extra: tuple = ()


def _row_change(col: Column):
    """[i] = row i differs from row i-1 (null-aware: two NULLs are equal,
    NaN equals NaN — grouping semantics, not comparison semantics)."""
    v = col.values
    a, b = v[1:], v[:-1]
    if v.is_floating_point():
        eq = (a == b) | (torch.isnan(a) & torch.isnan(b))
    else:
        eq = a == b
    if col.nulls is not None:
        na, nb = col.nulls[1:], col.nulls[:-1]
        eq = torch.where(na | nb, na & nb, eq)
    return torch.cat([torch.ones(1, dtype=torch.bool, device=v.device), ~eq])


def segment_bounds(part_start, peer_start):
    """(seg_start, peer_start_idx, peer_end) row indices of the sorted
    run from its partition-start and peer-start flags: inclusive max
    scans of the flagged indices, and the next peer group's start (a
    reverse min scan) less one.  Integer scans: exact in any order."""
    n = part_start.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=part_start.device)
    zero = torch.zeros_like(idx)
    seg_start = torch.cummax(torch.where(part_start, idx, zero), 0).values
    peer_start_idx = torch.cummax(torch.where(peer_start, idx, zero),
                                  0).values
    return seg_start, peer_start_idx, _next_start(peer_start, idx) - 1


def _next_start(starts, idx):
    """[i] = the first flagged index after i (n when none)."""
    n = idx.shape[0]
    at_or_after = torch.flip(torch.cummin(torch.flip(
        torch.where(starts, idx, torch.full_like(idx, n)), [0]), 0).values,
        [0])
    return torch.cat([at_or_after[1:],
                      torch.full((1,), n, dtype=torch.int64,
                                 device=idx.device)])


def window_flags(mask, arrays, partition_names, orderings):
    """(part_start, peer_start) of a sorted run: the first row, the
    live -> padding transition (so padding never joins, or extends the
    frame of, the last real partition) and each partition key's change
    start a partition; each order key's change also starts a peer group.
    `arrays`: {name: Column} of the sorted run."""
    n = mask.shape[0]
    part_start = torch.zeros(n, dtype=torch.bool, device=mask.device)
    if n:
        part_start[0] = True
        part_start[1:] |= mask[1:] != mask[:-1]
        for p in partition_names:
            part_start |= _row_change(arrays[p])
    peer_start = part_start.clone()
    if n:
        for o, _ in orderings:
            peer_start |= _row_change(arrays[o])
    return part_start, peer_start


def default_frame_window(spec: WindowSpec, mask, cols, seg_start,
                         peer_start, peer_start_idx, peer_end):
    """(int64 values, nulls or None) of a ranking function, or of an
    integer count / sum / avg over the default frame (RANGE UNBOUNDED
    PRECEDING .. CURRENT ROW), over a sorted run: the window kernel's
    function (kernels/window.py), shared by its plain version and
    window_batch.  Frame aggregates read two points of an inclusive
    prefix sum, incl[fe] - incl[fs] + contrib[fs]; int64 throughout, so
    exact under any association.  `cols`: {name: Column} of the run."""
    n = mask.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=mask.device)
    if spec.name == "row_number":
        return idx - seg_start + 1, None
    if spec.name == "rank":
        return peer_start_idx - seg_start + 1, None
    if spec.name == "dense_rank":
        cp = torch.cumsum(peer_start.to(torch.int64), 0)
        return cp - cp[seg_start] + 1, None
    fs, fe = seg_start, peer_end
    empty = fe < fs
    fs_c = fs.clamp(0, max(n - 1, 0))
    fe_c = fe.clamp(0, max(n - 1, 0))
    zero = torch.zeros_like(idx)
    if spec.name == "count_star":
        contrib = mask
    else:
        c = cols[spec.arg]
        contrib = mask if c.nulls is None else (mask & ~c.nulls)
    ci = contrib.to(torch.int64)
    cnt_incl = torch.cumsum(ci, 0)
    frame_cnt = torch.where(empty, zero,
                            cnt_incl[fe_c] - cnt_incl[fs_c] + ci[fs_c])
    if spec.name in ("count", "count_star"):
        return frame_cnt, None
    xv = torch.where(contrib, cols[spec.arg].values.to(torch.int64), zero)
    sum_incl = torch.cumsum(xv, 0)
    frame_sum = torch.where(empty, zero,
                            sum_incl[fe_c] - sum_incl[fs_c] + xv[fs_c])
    isempty = frame_cnt == 0     # SQL: aggregate of no rows is NULL
    if spec.name == "sum":
        return frame_sum, isempty
    return _decimal_avg(frame_sum, frame_cnt, isempty), isempty


def _range_reduce(x, fs, fe, is_min: bool, ident):
    """Per-row min/max of x over index range [fs, fe] (sparse doubling
    table: log2(n) precomputed levels, two gathers per query row).  Empty
    ranges (fe < fs) return ident."""
    n = x.shape[0]
    fill = torch.full((), ident, dtype=x.dtype, device=x.device)
    pick = torch.minimum if is_min else torch.maximum
    levels = [x]
    size = 1
    while size < n:
        cur = levels[-1]
        shifted = torch.cat([cur[size:], fill.expand(size)])
        levels.append(pick(cur, shifted))
        size <<= 1
    stacked = torch.stack(levels)                       # (L, n)
    length = torch.clamp(fe - fs + 1, min=1)
    # floor(log2(length)), exact for lengths below 2**53
    j = torch.frexp(length.to(torch.float64)).exponent.to(torch.int64) - 1
    fs_c = fs.clamp(0, n - 1)
    hi = (fe - (torch.ones_like(j) << j) + 1).clamp(0, n - 1)
    r = pick(stacked[j, fs_c], stacked[j, hi])
    return torch.where(fe < fs, fill, r)


def window_batch(batch: Batch, partition_names: Tuple[str, ...],
                 orderings: Tuple[Tuple[str, str], ...],
                 specs: Tuple[WindowSpec, ...]) -> Batch:
    """Evaluate all window functions sharing one (partition, order) spec.

    Sorts the whole batch by (partition keys, order keys) — padding rows
    last, forming their own segment — then computes every function with
    segmented prefix scans / sparse-table range reductions: no
    per-partition loop.  Frames per reference WindowOperator.java:69 +
    operator/window/: ROWS with offsets, RANGE with unbounded/current-row
    bounds.  Output row order is the sorted order (SQL does not guarantee
    WindowNode output order).  The window kernel (kernels/window.py) runs
    the functions it supports; this is the path for the others, after a
    WindowFunctionShape decline."""
    sort_keys = [(p, "ASC_NULLS_FIRST") for p in partition_names] \
        + list(orderings)
    perm = sort_indices(batch, sort_keys)   # [] keys still sorts padding last
    cols = {n: c.gather(perm) for n, c in batch.columns.items()}
    mask = batch.mask[perm]

    n = batch.capacity
    device = mask.device
    idx = torch.arange(n, dtype=torch.int64, device=device)
    part_start, peer_start = window_flags(mask, cols, partition_names,
                                          orderings)
    seg_start, peer_start_idx, peer_end = segment_bounds(part_start,
                                                         peer_start)
    seg_end = _next_start(part_start, idx) - 1

    def frame_bounds(spec: WindowSpec):
        """(fs, fe) row index bounds of the spec's frame, clamped to the
        partition; empty frames have fe < fs."""
        f = spec.frame
        if f is None:
            return seg_start, peer_end
        ftype, sk, so, ek, eo = f
        if ftype == "RANGE":
            fs = {"UNBOUNDED_PRECEDING": seg_start,
                  "CURRENT": peer_start_idx}.get(sk)
            fe = {"CURRENT": peer_end,
                  "UNBOUNDED_FOLLOWING": seg_end}.get(ek)
            if fs is None or fe is None:
                raise NotImplementedError(
                    "RANGE frame bounds with offsets")
            return fs, fe
        fs = {"UNBOUNDED_PRECEDING": seg_start, "CURRENT": idx,
              "PRECEDING": idx - (so or 0),
              "FOLLOWING": idx + (so or 0),
              "UNBOUNDED_FOLLOWING": seg_end + 1}[sk]
        fe = {"UNBOUNDED_FOLLOWING": seg_end, "CURRENT": idx,
              "PRECEDING": idx - (eo or 0),
              "FOLLOWING": idx + (eo or 0),
              "UNBOUNDED_PRECEDING": seg_start - 1}[ek]
        return torch.maximum(fs, seg_start), torch.minimum(fe, seg_end)

    out = dict(cols)
    for spec in specs:
        if spec.name in ("row_number", "rank", "dense_rank") or (
                spec.frame is None and (
                    spec.name in ("count", "count_star")
                    or (spec.name in ("sum", "avg") and not spec.is_float))):
            out[spec.output] = Column(*default_frame_window(
                spec, mask, cols, seg_start, peer_start, peer_start_idx,
                peer_end))
            continue
        if spec.name == "percent_rank":
            size = seg_end - seg_start + 1
            rank = peer_start_idx - seg_start + 1
            denom = torch.clamp(size - 1, min=1)
            v = (rank - 1).to(torch.float64) / denom
            out[spec.output] = Column(
                torch.where(size <= 1, torch.zeros_like(v), v), None)
            continue
        if spec.name == "cume_dist":
            size = seg_end - seg_start + 1
            thru = peer_end - seg_start + 1
            out[spec.output] = Column(
                thru.to(torch.float64) / torch.clamp(size, min=1), None)
            continue
        if spec.name == "ntile":
            nt = int(spec.extra[0])
            size = seg_end - seg_start + 1
            rn = idx - seg_start
            q, r = size // nt, size % nt
            big = r * (q + 1)
            bucket = torch.where(
                rn < big, rn // torch.clamp(q + 1, min=1),
                r + (rn - big) // torch.clamp(q, min=1))
            out[spec.output] = Column(bucket + 1, None)
            continue

        if spec.name in ("lag", "lead", "first_value", "last_value",
                         "nth_value"):
            col = cols[spec.arg]
            fs, fe = frame_bounds(spec)
            if spec.name in ("lag", "lead"):
                off = int(spec.extra[0] if spec.extra else 1)
                src = idx - off if spec.name == "lag" else idx + off
                valid = (src >= seg_start) & (src <= seg_end) & mask
            elif spec.name == "first_value":
                src = fs
                valid = (fe >= fs) & mask
            elif spec.name == "last_value":
                src = fe
                valid = (fe >= fs) & mask
            else:   # nth_value(x, k)
                k = int(spec.extra[0] if spec.extra else 1)
                src = fs + k - 1
                valid = (src >= fs) & (src <= fe) & mask
            src_c = src.clamp(0, max(n - 1, 0))
            vals = col.values[src_c]
            nulls = col.null_mask()[src_c] | ~valid
            default = spec.extra[1] if (spec.name in ("lag", "lead")
                                        and len(spec.extra) > 1) else None
            if default is not None:
                if col.dictionary is not None or col.lazy is not None:
                    raise NotImplementedError(
                        "lag/lead default over string columns")
                vals = torch.where(valid, vals, torch.full_like(vals,
                                                                default))
                nulls = torch.where(valid, col.null_mask()[src_c],
                                    torch.zeros_like(valid))
            out[spec.output] = Column(vals, nulls, col.dictionary,
                                      col.lazy)
            continue

        # frame aggregates
        fs, fe = frame_bounds(spec)
        empty = fe < fs
        fs_c = fs.clamp(0, max(n - 1, 0))
        fe_c = fe.clamp(0, max(n - 1, 0))
        if spec.name == "count_star":
            contrib = mask
            x = contrib.to(torch.int64)
        else:
            c = cols[spec.arg]
            contrib = mask if c.nulls is None else (mask & ~c.nulls)
            x = c.values
        zero1 = torch.zeros(1, dtype=torch.int64, device=device)
        cnt0 = torch.cat([zero1, torch.cumsum(contrib.to(torch.int64), 0)])
        frame_cnt = torch.where(empty, torch.zeros_like(fs),
                                cnt0[fe_c + 1] - cnt0[fs_c])
        if spec.name in ("count", "count_star"):
            out[spec.output] = Column(frame_cnt, None)
        elif spec.name in ("sum", "avg"):
            dt = torch.float64 if spec.is_float else torch.int64
            xv = torch.where(contrib, x.to(dt), torch.zeros((), dtype=dt,
                                                            device=device))
            ps0 = torch.cat([zero1.to(dt), torch.cumsum(xv, 0)])
            frame_sum = torch.where(empty, torch.zeros((), dtype=dt,
                                                       device=device),
                                    ps0[fe_c + 1] - ps0[fs_c])
            isempty = frame_cnt == 0     # SQL: aggregate of no rows is NULL
            if spec.name == "sum":
                out[spec.output] = Column(frame_sum, isempty)
            elif spec.is_float:
                safe = torch.where(isempty, torch.ones_like(frame_cnt),
                                   frame_cnt)
                out[spec.output] = Column(frame_sum / safe, isempty)
            else:
                out[spec.output] = Column(
                    _decimal_avg(frame_sum, frame_cnt, isempty), isempty)
        elif spec.name in ("min", "max"):
            is_min = spec.name == "min"
            col = cols[spec.arg]
            was_bool = x.dtype == torch.bool
            # string columns: dictionary codes compare by LEXICAL rank,
            # not code value
            code_of_rank = None
            if col.dictionary is not None:
                d = np.array(col.dictionary)
                rank_of_code = np.argsort(np.argsort(d)).astype(np.int64)
                code_of_rank = torch.from_numpy(
                    np.argsort(rank_of_code)).to(device)
                x = torch.from_numpy(rank_of_code).to(device)[
                    x.to(torch.int64)]
            if was_bool:
                x = x.to(torch.int8)
            if x.is_floating_point():
                ident = float("inf") if is_min else float("-inf")
            else:
                info = torch.iinfo(x.dtype)
                ident = info.max if is_min else info.min
            xv = torch.where(contrib, x, torch.full_like(x, ident))
            vals = _range_reduce(xv, fs, fe, is_min, ident)
            isempty = frame_cnt == 0
            if was_bool:
                vals = vals.to(torch.bool)
            if col.dictionary is not None:
                # rank -> code; empty frames hold the identity sentinel,
                # clamp before the gather (the result is NULL there)
                vals = code_of_rank[torch.where(isempty,
                                                torch.zeros_like(vals), vals)]
                out[spec.output] = Column(vals, isempty, col.dictionary)
            elif col.lazy is not None:
                # min / max over lazy row ids: ROWID_ORDERED columns only
                # (the compiler encodes the others first)
                vals = torch.where(isempty, torch.zeros_like(vals), vals)
                out[spec.output] = Column(vals, isempty, None, col.lazy)
            else:
                out[spec.output] = Column(vals, isempty)
        else:
            raise NotImplementedError(f"window function {spec.name}")
    return Batch(out, mask)


def compact(batch: Batch, out_capacity: Optional[int] = None) -> Batch:
    """Move live rows to a contiguous prefix (stable): cumsum + scatter,
    dead rows land in a dropped overflow slot."""
    cap = out_capacity or batch.capacity
    pos = torch.cumsum(batch.mask.to(torch.int64), 0) - 1
    idx = torch.where(batch.mask & (pos < cap), pos,
                      torch.full_like(pos, cap))

    def scat(v):
        out = torch.zeros((cap + 1,) + tuple(v.shape[1:]), dtype=v.dtype,
                          device=v.device)
        out[idx] = v
        return out[:cap]

    cols = {name: Column(scat(c.values),
                         None if c.nulls is None else scat(c.nulls),
                         c.dictionary, c.lazy,
                         None if c.lengths is None else scat(c.lengths))
            for name, c in batch.columns.items()}
    return Batch(cols, scat(batch.mask))


# ---------------------------------------------------------------------------
# mergeable percentile summaries (the spilled percentile paths): m
# equi-spaced order statistics per batch, each standing for count / m
# rows; rank error <= 1/(2m), and the union step is exact
# ---------------------------------------------------------------------------

PERCENTILE_SKETCH_POINTS = 8192


def _alive_first_order(v, alive):
    """Positions ordered alive rows first, each part by value (NaN last):
    the reference's lexsort((v, ~alive))."""
    perm = torch.argsort(v, stable=True)
    return perm[torch.argsort((~alive[perm]).to(torch.int8), stable=True)]


def percentile_batch_summary(values, alive,
                             m: int = PERCENTILE_SKETCH_POINTS):
    """(values, alive mask) -> (points: (m,) float64, count: int64): the m
    equi-spaced order statistics of the alive values (all NaN when the
    count is 0)."""
    v = values.to(torch.float64)
    vs = v[_alive_first_order(v, alive)]
    cnt = alive.to(torch.int64).sum()
    j = torch.arange(m, dtype=torch.int64, device=v.device)
    pos = torch.floor((j * torch.clamp(cnt - 1, min=0)).to(torch.float64)
                      / (m - 1) + 0.5).to(torch.int64)
    pts = vs[torch.clamp(pos, 0, vs.shape[0] - 1)]
    pts = torch.where(cnt > 0, pts, torch.full_like(pts, float("nan")))
    return pts, cnt


def percentile_union_value(points, counts, p: float):
    """(B, m) summary points + (B,) counts -> (value, is_null): the
    weighted nearest rank over the union, point i of batch b standing
    for counts[b] / m rows."""
    _b, m = points.shape
    w = (counts.to(torch.float64) / m).repeat_interleave(m)
    flat = points.reshape(-1)
    valid = ~torch.isnan(flat)
    w = torch.where(valid, w, torch.zeros_like(w))
    order = _alive_first_order(flat, valid)
    fv, fw = flat[order], w[order]
    cum = torch.cumsum(fw, dim=0)
    total = counts.sum()
    target = torch.floor(p * torch.clamp(total - 1, min=0)
                         .to(torch.float64) + 0.5)
    idx = torch.searchsorted(cum, target.reshape(1), right=True)[0]
    val = fv[torch.clamp(idx, 0, fv.shape[0] - 1)]
    return val, total == 0


# ---------------------------------------------------------------------------
# sort aggregation: argsort + segmented prefix sums, no scatter table
# ---------------------------------------------------------------------------

# XLA's CPU cumsum: a reduce-window rewritten into blocks of this length
_SCAN_BLOCK = 16


def scan_cumsum(x):
    """Inclusive prefix sum along the last dim.  Floats take the
    reference's association order (what XLA runs for jnp.cumsum off the
    TPU): a sequential prefix within each block of 16, the blocks' totals
    prefixed recursively, and each block's carry added to its prefix last
    -- so the float rounding, and every segment sum taken as a difference
    of two prefixes, is the reference's bit for bit.  Integers are exact
    in any order."""
    if not x.is_floating_point():
        return torch.cumsum(x, dim=-1)
    n, B = x.shape[-1], _SCAN_BLOCK
    nb = -(-n // B)
    pad = torch.zeros(x.shape[:-1] + (nb * B - n,), dtype=x.dtype,
                      device=x.device)
    inb = torch.cat([x, pad], dim=-1).reshape(x.shape[:-1] + (nb, B)).clone()
    for j in range(1, B):
        inb[..., j] = inb[..., j - 1] + inb[..., j]
    if nb > 1:
        carry = scan_cumsum(inb[..., -1])
        inb[..., 1:, :] = inb[..., 1:, :] + carry[..., :-1, None]
    return inb.reshape(x.shape[:-1] + (nb * B,))[..., :n]


def _prefix(x):
    """[0, x0, x0+x1, ...] along the last dim (scan_cumsum's order)."""
    zero = torch.zeros(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)
    return torch.cat([zero, scan_cumsum(x)], dim=-1)


def sort_group_aggregate(batch: Batch, key_names: Tuple[str, ...],
                         agg_inputs: Dict[str, Optional[Column]],
                         specs: Tuple[AggSpec, ...],
                         agg_inputs2: Optional[Dict[str, Column]] = None
                         ) -> Batch:
    """Grouped aggregation by sort + segmented prefix sums: the rows are
    ordered by the combined 64-bit key hash (distinct keys assumed to
    have distinct hashes, as the hashed table assumes), and each group is
    a segment.  Output: capacity == input capacity, one live row per
    group at its segment's start."""
    dev = batch.mask.device
    if key_names:
        kh = _orderable_hash(hash_columns(
            [batch.columns[k] for k in key_names]))
    else:
        # global aggregation: every live row in one segment
        kh = torch.zeros(batch.mask.shape, dtype=torch.int64, device=dev)
    kh = torch.where(batch.mask, kh, torch.full_like(kh, INT64_MAX))
    perm = torch.argsort(kh, stable=True)
    khs = kh[perm]
    n = khs.shape[0]
    live = khs != INT64_MAX
    is_start = live & torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                                 khs[1:] != khs[:-1]])
    if not key_names:
        # a global aggregate yields one row even over empty input
        is_start[0] = True
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    # exclusive end of each segment = the next segment's start
    nxt = torch.flip(torch.cummin(torch.flip(
        torch.where(is_start, idx, torch.full_like(idx, n)), [0]), 0).values,
        [0])
    seg_end = torch.cat([nxt[1:], torch.full((1,), n, dtype=torch.int64,
                                             device=dev)])
    s_lo = idx
    s_hi = torch.where(live, seg_end, idx + 1).clamp(0, n)
    seg_start_row = torch.cummax(torch.where(is_start, idx,
                                             torch.zeros_like(idx)), 0).values
    # each row's segment (dead rows, sorted last, carry no contribution)
    seg_id = (torch.cumsum(is_start.to(torch.int64), 0) - 1).clamp(min=0)

    def gathered(c: Column) -> Column:
        return c.gather(perm)

    cols: Dict[str, Column] = {}
    for k in key_names:
        cols[k] = gathered(batch.columns[k])
    for spec in specs:
        o = spec.output
        if spec.name in ("count_star", "approx_percentile"):
            contrib, x = live, None
        else:
            c = gathered(agg_inputs[o])
            contrib = live & ~c.null_mask()
            x = c.values
        cnt_p = _prefix(contrib.to(torch.int64))
        cnt = cnt_p[s_hi] - cnt_p[s_lo]
        if spec.name in ("count", "count_star"):
            cols[o] = Column(cnt, None)
            continue
        empty = cnt == 0
        if spec.name in ("sum", "avg"):
            dt = torch.float64 if spec.is_float else torch.int64
            xv = torch.where(contrib, x.to(dt), torch.zeros((), dtype=dt,
                                                             device=dev))
            p = _prefix(xv)
            ssum = p[s_hi] - p[s_lo]
            if spec.name == "sum":
                cols[o] = Column(ssum, empty)
            elif spec.is_float:
                safe = torch.where(empty, torch.ones_like(cnt), cnt)
                cols[o] = Column(ssum / safe.to(torch.float64), empty)
            else:
                cols[o] = Column(_decimal_avg(ssum, cnt, empty), empty)
        elif spec.name in ("min", "max"):
            is_min = spec.name == "min"
            dt = _acc_dtype(spec)
            if spec.is_float:
                ident = float("inf") if is_min else float("-inf")
            else:
                ident = INT64_MAX if is_min else INT64_MIN
            xv = torch.where(contrib, x.to(dt),
                             torch.full((), ident, dtype=dt, device=dev))
            red = torch.full((n,), ident, dtype=dt, device=dev)
            red.scatter_reduce_(0, seg_id, xv, "amin" if is_min else "amax",
                                include_self=True)
            cols[o] = Column(red[seg_id], empty)
        elif spec.name in MOMENT_AGGS:
            # two passes: the group mean, then centered squares
            xf = torch.where(contrib, x.to(torch.float64),
                             torch.zeros((), dtype=torch.float64, device=dev))
            ps = _prefix(xf)
            g_sum = ps[s_hi] - ps[seg_start_row]
            g_cnt = cnt_p[s_hi] - cnt_p[seg_start_row]
            mean_row = g_sum / torch.clamp(g_cnt, min=1).to(torch.float64)
            d = torch.where(contrib, x.to(torch.float64) - mean_row,
                            torch.zeros_like(mean_row))
            ps2 = _prefix(d * d)
            m2 = ps2[s_hi] - ps2[s_lo]
            # m2 is a difference of prefixes: a zero-variance group may
            # leave a negative rounding residual, whose sqrt is NaN, as
            # in the reference (no clamp here, unlike _moment_finalize)
            pop = spec.name in ("stddev_pop", "var_pop")
            denom = torch.clamp(cnt if pop else cnt - 1, min=1) \
                .to(torch.float64)
            v = m2 / denom
            if spec.name.startswith("stddev"):
                v = torch.sqrt(v)
            cols[o] = Column(v, cnt < (1 if pop else 2))
        elif spec.name in CORR_AGGS:
            c2 = gathered(agg_inputs2[o])
            contrib2 = contrib & ~c2.null_mask()
            c0 = _prefix(contrib2.to(torch.int64))
            n2 = c0[s_hi] - c0[s_lo]
            zero = torch.zeros((), dtype=torch.float64, device=dev)
            xs = x.to(torch.float64)
            ys = c2.values.to(torch.float64)
            xf = torch.where(contrib2, xs, zero)
            yf = torch.where(contrib2, ys, zero)
            p1 = _prefix(torch.stack([xf, yf]))
            g_cnt = torch.clamp(c0[s_hi] - c0[seg_start_row], min=1) \
                .to(torch.float64)
            mean_x = (p1[0, s_hi] - p1[0, seg_start_row]) / g_cnt
            mean_y = (p1[1, s_hi] - p1[1, seg_start_row]) / g_cnt
            dx = torch.where(contrib2, xs - mean_x, zero)
            dy = torch.where(contrib2, ys - mean_y, zero)
            p2 = _prefix(torch.stack([dx * dx, dy * dy, dx * dy]))
            seg = p2[:, s_hi] - p2[:, s_lo]
            cols[o] = Column(*_corr_finalize(spec.name, seg[0], seg[1],
                                             seg[2], n2))
        elif spec.name == "approx_percentile":
            # a value-ordered secondary sort: NULL / dead rows last within
            # their key-hash segment, then the nearest-rank element is one
            # gather at the segment start + round(p * (count - 1))
            p = float(spec.param if spec.param is not None else 0.5)
            xc = agg_inputs[o]
            vx = xc.values
            alive = batch.mask & ~xc.null_mask()
            perm_p = torch.argsort(vx, stable=True)
            perm_p = perm_p[torch.argsort(~alive[perm_p], stable=True)]
            perm_p = perm_p[torch.argsort(kh[perm_p], stable=True)]
            vx_sorted = vx[perm_p]
            a0 = _prefix(alive[perm_p].to(torch.int64))
            cntp = a0[s_hi] - a0[s_lo]
            pos = s_lo + torch.floor(
                p * torch.clamp(cntp - 1, min=0).to(torch.float64)
                + 0.5).to(torch.int64)
            cols[o] = Column(vx_sorted[pos.clamp(0, n - 1)], cntp == 0,
                             xc.dictionary, xc.lazy)
        else:
            raise NotImplementedError(spec.name)
    return Batch(cols, is_start)
