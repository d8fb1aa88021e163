"""The scan kernel's plain version (presto_tpu_torch scan_direct_plain)
against the reference Pallas kernel (try_direct_scan_kernel, interpret
mode on the CPU) on the same encoded state: the reference package's
ResidentColumns, carried across with resident_from_numpy.

Integer accumulators and per-step row counters must be bit-identical;
float64 accumulators agree within rtol 1e-12 (another summation order)."""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import presto_tpu.common.types as JT
import presto_tpu.spi.expr as JE
from presto_tpu.exec import operators as jops
from presto_tpu.exec.kernels import scan_kernel as jsk
from presto_tpu.exec.lowering import Lowering as JLowering, _jnp_dtype
from presto_tpu.storage import encodings as jenc
import presto_tpu_torch.common.types as TT
import presto_tpu_torch.spi.expr as TE
from presto_tpu_torch.exec import operators as tops
from presto_tpu_torch.exec.kernels import scan_kernel as tsk
from presto_tpu_torch.exec.lowering import param_vector
from presto_tpu_torch.storage.encodings import resident_from_numpy
from torch_threads import one_torch_thread  # noqa: F401

N_ROWS = 10000
CAP = 4096
ZONE = 1024
PARAMS = [1, 600, 9000]                 # integer, decimal(12,2), date


def _param_types(T):
    return [T.INTEGER, T.DecimalType(12, 2), T.DATE]


def _schema(T):
    return {"v": T.DecimalType(12, 2), "q": T.DecimalType(12, 2),
            "dt": T.DATE, "f": T.DOUBLE, "k1": T.VarcharType(1),
            "k2": T.VarcharType(1)}


DICTS = {"k1": ("A", "N", "R"), "k2": ("F", "O")}


def _columns(enc: str):
    """Encoded columns via the reference encoder; `enc` is the value
    column's encoding."""
    rng = np.random.default_rng(5)
    n = N_ROWS
    pad = np.zeros(CAP, dtype=np.int64)
    if enc == "rle":
        v = np.repeat(rng.integers(-5000, 90000, n // 25 + 1), 25)[:n]
    elif enc == "dict":
        v = rng.integers(0, 40, n) * 250
    else:
        v = rng.integers(-10 ** 7, 10 ** 9, n)
    raw = {
        "v": (v.astype(np.int64), {"plain": "plain", "rle": "rle"}.get(enc)),
        "q": (rng.integers(1, 51, n).astype(np.int64) * 100, None),
        "dt": (np.sort(rng.integers(8000, 10000, n)).astype(np.int32),
               "plain"),
        "f": (np.round(rng.normal(100, 50, n), 3), "plain"),
        "k1": (rng.integers(0, 3, n).astype(np.int32), None),
        "k2": (rng.integers(0, 2, n).astype(np.int32), None),
    }
    out = {}
    for name, (body, hint) in raw.items():
        arr = np.concatenate([body, pad.astype(body.dtype)])
        col = jenc.encode_column(jnp.asarray(arr), n, hint=hint)
        zones = jenc.build_zone_maps(jnp.asarray(arr), n, ZONE)
        out[name] = (col, zones)
    assert out["v"][0].kind == enc
    return out


def _chain_parts(E, T, pred: str, keys: bool):
    """(steps, key names, strides, G, specs, agg inputs) for one package."""
    s = _schema(T)
    var = {n: E.variable(n, t) for n, t in s.items()}
    p = [E.BoundParameterExpression(k, t)
         for k, t in enumerate(_param_types(T))]
    B, D = T.BOOLEAN, T.DecimalType
    c = E.call
    preds = {
        "all": c("gt", B, var["v"], E.constant(-10 ** 12, T.BIGINT)),
        "empty": c("lt", B, var["q"], E.constant(0, T.BIGINT)),
        "selective": E.special(
            "AND", B, c("gte", B, var["dt"], p[2]),
            c("between", B, var["q"], E.constant(1000, D(12, 2)), p[1])),
        "nullable": E.special("OR", B, c("lt", B, var["q"], p[1]),
                              E.constant(None, B)),
    }
    disc = E.variable("disc", D(24, 2))
    steps = [("filter", preds[pred]),
             ("project", [
                 (disc, c("multiply", D(24, 2), var["v"],
                          c("subtract", D(13, 2), p[0], var["q"]))),
                 (var["v"], var["v"]), (var["q"], var["q"]),
                 (var["f"], var["f"]), (var["k1"], var["k1"]),
                 (var["k2"], var["k2"])])]
    if pred == "all":
        steps = steps[1:]
    key_names, strides, G = ((("k1", "k2"), (2, 1), 6) if keys
                             else ((), (), 1))
    return steps, key_names, strides, G, {
        "sum_v": var["v"], "sum_disc": disc, "avg_q": var["q"],
        "cnt": None, "cnt_v": var["v"], "min_v": var["v"],
        "max_q": var["q"], "sum_f": var["f"], "avg_f": var["f"],
        "max_f": var["f"]}


def _specs(ops_mod):
    S = ops_mod.AggSpec
    return (S("sum", "sum_v"), S("sum", "sum_disc"), S("avg", "avg_q"),
            S("count_star", "cnt"), S("count", "cnt_v"), S("min", "min_v"),
            S("max", "max_q"), S("sum", "sum_f", True),
            S("avg", "avg_f", True), S("max", "max_f", True))


SPLITS = {
    "aligned_tail": [(0, N_ROWS)],
    "gaps": [(100, 3000), (2900, 3500), (4500, N_ROWS - 7)],
}


def _meta(splits, zones, pushdown):
    return {"dicts": dict(DICTS), "colmap": {n: n for n in _schema(JT)},
            "splits": [SimpleNamespace(start=s, end=e) for s, e in splits],
            "cap": CAP, "zone_maps": zones, "pushdown": pushdown,
            "types": None}


CASES = [
    ("all", False, "plain", "aligned_tail", False),
    ("all", True, "dict", "gaps", False),
    ("empty", True, "plain", "aligned_tail", False),
    ("empty", False, "rle", "gaps", False),
    ("selective", True, "plain", "gaps", True),
    ("selective", False, "dict", "aligned_tail", True),
    ("selective", True, "rle", "aligned_tail", False),
    ("nullable", True, "dict", "gaps", False),
    ("nullable", False, "plain", "aligned_tail", False),
]


@pytest.mark.parametrize("pred,keys,enc,splits,prune", CASES,
                         ids=["-".join(str(x) for x in c) for c in CASES])
def test_plain_matches_pallas_kernel(pred, keys, enc, splits, prune):
    cols = _columns(enc)
    zones = {n: z for n, (_c, z) in cols.items()}
    # zone-map pushdown on the sorted date column prunes leading blocks
    pushdown = [{"column": "dt", "op": "gte", "value": ["param", 2]}] \
        if prune else []

    # -- reference: the Pallas kernel in interpret mode -----------------
    steps, key_names, strides, G, agg_in = _chain_parts(JE, JT, pred, keys)
    jparams = tuple(jnp.asarray(v, dtype=_jnp_dtype(t))
                    for v, t in zip(PARAMS, _param_types(JT)))
    jchain = SimpleNamespace(
        steps=steps, scan_meta=_meta(SPLITS[splits], zones, pushdown),
        has_params=True, leaf_cap=lambda _e: CAP,
        compiler=SimpleNamespace(ctx=SimpleNamespace(
            params_fingerprint=tuple(PARAMS))))
    jcached = {n: c for n, (c, _z) in cols.items()}
    low = JLowering()
    jres = jsk.try_direct_scan_kernel(
        jchain, (jcached, jparams), specs=_specs(jops), key_names=key_names,
        strides=strides, G=G,
        agg_exprs=lambda b: {o: (None if e is None else low.eval(e, b))
                             for o, e in agg_in.items()},
        lowering=low, cache={}, declined=lambda r: pytest.fail(r))
    assert jres is not None
    jstate, jcounts, jblocks = jres

    # -- port: the plain version on the same encoded state --------------
    steps, key_names, strides, G, agg_in = _chain_parts(TE, TT, pred, keys)
    tzones = {}
    tcols = {}
    for n, (c, z) in cols.items():
        tcols[n], tzones[n] = resident_from_numpy(
            c.kind, [np.asarray(a) for a in c.arrays], z, c.n_rows)
    meta = _meta(SPLITS[splits], tzones, pushdown)
    meta["types"] = _schema(TT)
    tchain = SimpleNamespace(steps=steps, scan_meta=meta)
    plan = tsk.build_scan_plan(tchain, mode="direct", specs=_specs(tops),
                               key_names=key_names, strides=strides, G=G,
                               agg_inputs=agg_in)
    br = tsk.block_rows_for(CAP)
    grid = tsk.aligned_grid(meta, br, tuple(PARAMS))
    assert grid == jsk.aligned_grid(jchain.scan_meta, br, tuple(PARAMS))
    assert len(grid) == jblocks
    if prune:
        assert grid[0][0] > 0, "the date pushdown should prune a block"
    params = param_vector(PARAMS, _param_types(TT), "cpu")
    acc_i, acc_f, counts = tsk.scan_direct(
        plan, [tcols[n] for n in plan.names], grid, br, params)

    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    for j, k in enumerate(plan.int_names):
        np.testing.assert_array_equal(acc_i[j].numpy(),
                                      np.asarray(jstate[k]), err_msg=k)
    for j, k in enumerate(plan.flt_names):
        np.testing.assert_allclose(acc_f[j].numpy(), np.asarray(jstate[k]),
                                   rtol=1e-12, atol=0, err_msg=k)
    if pred == "empty":
        assert int(counts[-1]) == 0
    if pred == "all":
        assert int(counts[-1]) == int(counts[0]) > 0


def test_wrapper_on_cpu_counts_no_launch():
    before = tsk.LAUNCHES["scan_direct"]
    cols = _columns("plain")
    steps, key_names, strides, G, agg_in = _chain_parts(TE, TT, "all", False)
    meta = _meta(SPLITS["aligned_tail"], {}, [])
    meta["types"] = _schema(TT)
    plan = tsk.build_scan_plan(SimpleNamespace(steps=steps, scan_meta=meta),
                               mode="direct", specs=_specs(tops),
                               key_names=key_names, strides=strides, G=G,
                               agg_inputs=agg_in)
    tc = [resident_from_numpy(c.kind, [np.asarray(a) for a in c.arrays],
                              None, c.n_rows)[0]
          for c, _z in (cols[n] for n in plan.names)]
    grid = tsk.aligned_grid(meta, CAP, None)
    params = param_vector(PARAMS, _param_types(TT), "cpu")
    out = tsk.scan_direct(plan, tc, grid, CAP, params)
    ref = tsk.scan_direct_plain(plan, tc, grid, CAP, params)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert tsk.LAUNCHES["scan_direct"] == before


def test_plan_rejects_unsupported_expression():
    steps, key_names, strides, G, agg_in = _chain_parts(TE, TT, "all", False)
    v = TE.variable("v", TT.DecimalType(12, 2))
    steps = [("filter", TE.call("like", TT.BOOLEAN, v, v))] + steps
    meta = _meta(SPLITS["aligned_tail"], {}, [])
    meta["types"] = _schema(TT)
    with pytest.raises(NotImplementedError):
        tsk.build_scan_plan(SimpleNamespace(steps=steps, scan_meta=meta),
                            mode="direct", specs=_specs(tops),
                            key_names=key_names, strides=strides, G=G,
                            agg_inputs=agg_in)


@pytest.mark.parametrize("seed", range(6))
def test_aligned_grid_matches_reference(seed):
    """The vectorized zone-map pruning keeps exactly the reference's
    grid entries (random splits, zone sizes, ops and constants)."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(5000, 40000))
    body = np.sort(rng.integers(0, 1000, n)) if seed % 2 else \
        rng.integers(0, 1000, n)
    arr = np.concatenate([body, np.zeros(CAP, dtype=body.dtype)])
    zone = int(rng.choice([512, 1024, 4096, 8192]))
    jz = jenc.build_zone_maps(jnp.asarray(arr), n, zone)
    tz = resident_from_numpy("plain", [arr], jz, n)[1]
    cuts = np.sort(rng.choice(np.arange(1, n), size=4, replace=False))
    splits = [(0, int(cuts[0])), (int(cuts[1]), int(cuts[2])),
              (int(cuts[2]) - 50, int(cuts[3])), (int(cuts[3]) + 9, n)]
    ops = ["eq", "lt", "lte", "gt", "gte"]
    pushdown = [{"column": "c", "op": str(rng.choice(ops)),
                 "value": int(rng.integers(-10, 1010))} for _ in range(2)]
    pushdown.append({"column": "c", "op": "gte", "value": ["param", 0]})
    params = (int(rng.integers(0, 1000)),)
    br = int(rng.choice([4096, 8192]))
    want = jsk.aligned_grid(_meta(splits, {"c": jz}, pushdown), br, params)
    got = tsk.aligned_grid(_meta(splits, {"c": tz}, pushdown), br, params)
    assert got == want
