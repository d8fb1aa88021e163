"""The window kernel's single-pass decomposition (csrc/window_scan.cu) as a
numpy model, held against the plain version (window.window_scan_plain)
on the CPU.  The CUDA kernel runs only on the card (chip_smoke.py); this
model carries its arithmetic: the segmented state per row, tile
aggregates folded from sub-tile (warp) states, the look-back over
predecessors that show either an aggregate or an inclusive prefix, the
three in-tile passes, and the fix-up of peer groups still open at a
tile's end -- at tiny tiles (3, 4, 7 rows), so every group crosses tiles.
The batches are test_torch_window_kernel.py's: NULL keys and arguments,
NaN float keys, dead rows, DESC keys, one long peer group.  Then the
launch's reservation (window.window_bytes): per-tile scratch only."""
import numpy as np
import pytest
import torch

from presto_tpu_torch.exec import operators as ops
from presto_tpu_torch.exec.kernels import window as wk

from test_torch_window_kernel import (_BY_DF, _BY_P, _EDGE_FIELDS, _FIELDS,
                                      _batches, _columns, _spec_sets)
from torch_threads import one_torch_thread  # noqa: F401

MASK = (1 << 64) - 1


def _wrap(v: int) -> int:
    v &= MASK
    return v - (1 << 64) if v >> 63 else v


def _combine(a, b):
    """(p, q, d, c, x) state of a then b: max indices, counters reset by a
    partition start in b."""
    p, q = max(a[0], b[0]), max(a[1], b[1])
    if b[0] >= 0:
        return (p, q, b[2], b[3], b[4])
    return (p, q, a[2] + b[2], tuple(_wrap(u + v) for u, v in zip(a[3], b[3])),
            tuple(_wrap(u + v) for u, v in zip(a[4], b[4])))


def _identity(ns):
    return (-1, -1, 0, (0,) * ns, (0,) * ns)


def _fold(elems, state):
    out = []
    for e in elems:
        state = _combine(state, e)
        out.append(state)
    return state, out


def _model(mask, arrays, parts, orderings, specs, tile, sub, seed):
    """Every output of the kernel's decomposition over tiles of `tile`
    rows cut in sub-tiles of `sub` rows (the warps), with a look-back that
    sees an inclusive prefix at a random subset of its predecessors."""
    rng = np.random.default_rng(seed)
    n = int(mask.numel())
    cols = {nm: ops.Column(v, nl) for nm, (v, nl) in arrays.items()}
    pstart, qstart = (t.numpy() for t in ops.window_flags(
        mask, cols, parts, orderings))
    slots, of_spec = wk._slots(specs)
    ns = len(slots)
    live = mask.numpy()
    contrib, value = [], []
    for arg, need_sum in slots:
        nl = None if arg is None else arrays[arg][1]
        c = live.copy() if nl is None else live & ~nl.numpy()
        contrib.append(c)
        x = arrays[arg][0].numpy().astype(np.int64) if (arg and need_sum) \
            else np.zeros(n, dtype=np.int64)
        value.append(np.where(c, x, 0))
    elems = [(i if pstart[i] else -1, i if qstart[i] else -1,
              int(qstart[i]), tuple(int(c[i]) for c in contrib),
              tuple(int(x[i]) for x in value)) for i in range(n)]
    n_tiles = -(-n // tile)
    agg, incl = [], []
    outs = [np.zeros(n, dtype=np.int64) for _ in specs]
    nulls = [np.zeros(n, dtype=bool) for _ in specs]
    open_start, rec = [-1] * n_tiles, {}

    def frame(i, cx):
        for j, sp in enumerate(specs):
            if sp.name in ("row_number", "rank", "dense_rank"):
                continue
            cnt, sm = cx[0][of_spec[j]], cx[1][of_spec[j]]
            if sp.name in ("count", "count_star"):
                outs[j][i] = cnt
                continue
            nulls[j][i] = cnt == 0
            safe = cnt if cnt else 1
            q = (abs(sm) + safe // 2) // safe
            outs[j][i] = sm if sp.name == "sum" else (
                q if sm > 0 else -q if sm < 0 else 0)

    for t in range(n_tiles):
        ts, te = t * tile, min((t + 1) * tile, n)
        # pass 1: the sub-tiles' aggregates, exclusive per sub-tile
        subs, run = [], _identity(ns)
        for s0 in range(ts, te, sub):
            a, _ = _fold(elems[s0:min(s0 + sub, te)], _identity(ns))
            subs.append(run)
            run = _combine(run, a)
        agg.append(run)
        # the look-back
        acc = _identity(ns)
        for k in range(t - 1, -1, -1):
            shows_incl = k == 0 or rng.random() < 0.3
            acc = _combine(incl[k] if shows_incl else agg[k], acc)
            if shows_incl or acc[0] >= 0:
                break
        E = acc
        incl.append(_combine(E, run))
        # pass 2: every row's state; group ends keyed by the group's start
        gv, qloc, trail = {}, {}, None
        for w, s0 in enumerate(range(ts, te, sub)):
            _s, states = _fold(elems[s0:min(s0 + sub, te)],
                               _combine(E, subs[w]))
            for i, st in zip(range(s0, te), states):
                for j, sp in enumerate(specs):
                    if sp.name == "row_number":
                        outs[j][i] = i - st[0] + 1
                    elif sp.name == "rank":
                        outs[j][i] = st[1] - st[0] + 1
                    elif sp.name == "dense_rank":
                        outs[j][i] = st[2]
                end = i + 1 >= n or bool(qstart[i + 1])
                q = st[1] - ts if st[1] >= ts else tile
                qloc[i] = q
                if end:
                    gv[q] = (st[3], st[4])
                if i == te - 1:
                    trail = (not end, q, st[1])
        open_start[t] = trail[2] if trail[0] else -1
        if tile in gv:
            rec[E[1] // tile] = gv[tile]
        # pass 3
        for i in range(ts, te):
            if trail[0] and qloc[i] == trail[1]:
                continue
            frame(i, gv[qloc[i]])
    # the fix-up launch
    for t in range(n_tiles):
        gs = open_start[t]
        if gs < 0:
            continue
        for i in range(max(gs, t * tile), min((t + 1) * tile, n)):
            frame(i, rec[gs // tile])
    return outs, nulls


def _sorted_run(seed, n, n_part, keys, fields):
    parts, orderings = keys
    cols, live = _columns(seed, n, n_part)
    tb, _ = _batches(cols, live)
    specs, _ = _spec_sets(fields)
    perm = ops.sort_indices(tb, [(p, "ASC_NULLS_FIRST") for p in parts]
                            + list(orderings))
    arrays = {nm: (c.gather(perm).values, c.gather(perm).nulls)
              for nm, c in tb.columns.items()}
    return tb.mask[perm], arrays, parts, orderings, specs


# (seed, rows, partition cardinality, keys, fields): NULL / NaN / dead-row
# batches by several partition keys (DESC orderings among them), one
# partition of one long peer group, one partition per row
RUNS = [
    (41, 150, 6, _BY_P, _FIELDS),
    (44, 150, 5, _BY_DF, _FIELDS),
    (42, 120, 1, ((), (("o", "DESC_NULLS_LAST"),)), _FIELDS),
    (45, 90, 1, ((), ()), _EDGE_FIELDS),
    (43, 90, 1 << 40, _BY_P, _EDGE_FIELDS),
]


@pytest.mark.parametrize("tile,sub", [(3, 1), (4, 2), (7, 3)])
@pytest.mark.parametrize("seed,n,n_part,keys,fields", RUNS,
                         ids=[f"seed{r[0]}" for r in RUNS])
def test_lookback_model_equals_plain(seed, n, n_part, keys, fields, tile,
                                     sub):
    run = _sorted_run(seed, n, n_part, keys, fields)
    want = wk.window_scan_plain(*run)
    outs, nulls = _model(*run, tile, sub, seed)
    for sp, (wv, wn), got, gn in zip(run[4], want, outs, nulls):
        assert np.array_equal(got, wv.numpy()), (sp.name, tile)
        if wn is not None:
            assert np.array_equal(gn, wn.numpy()), (sp.name, tile)


def test_window_bytes_reserve_per_tile_scratch_only():
    n = 15_204_352
    specs = (ops.WindowSpec("sum", "s", "x"), ops.WindowSpec(
        "row_number", "rn"), ops.WindowSpec("count", "c", "x"))
    cols = {"p": (torch.zeros(1, dtype=torch.int64), None),
            "x": (torch.zeros(1, dtype=torch.int64), None)}
    need = wk.window_bytes(n, {k: (v.expand(n), nl)
                               for k, (v, nl) in cols.items()}, specs)
    operands = n + 8 * n + 2 * 8 * n
    outputs = n * (9 + 8 + 8)
    tile, n32, n64 = wk.window_scratch(n, 1)
    assert need == operands + outputs + 4 * n32 + 8 * n64
    assert tile == 2048 and n32 == 1 + -(-n // tile)
    assert 4 * n32 + 8 * n64 < n            # under a byte per row
    for ns in range(0, 12):
        t = wk.tile_rows_for(ns)
        assert wk.forward_smem_bytes(t, ns) <= wk.FORWARD_SMEM_BYTES \
            or t == wk.TILE_ROWS[-1]


def test_specs_past_eight_slots_split_into_launches():
    specs = tuple(ops.WindowSpec("sum", f"s{k}", f"x{k}") for k in range(10))
    specs += (ops.WindowSpec("rank", "rk"), ops.WindowSpec("count_star",
                                                           "c"))
    groups = wk._slot_groups(specs)
    assert sorted(i for g in groups for i in g) == list(range(len(specs)))
    for g in groups:
        assert len(wk._slots([specs[i] for i in g])[0]) <= 8
    assert 10 in groups[0]                     # ranks with the first
