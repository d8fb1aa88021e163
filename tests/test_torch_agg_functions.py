"""The aggregate functions beyond the BASIC set against the reference's
operators, on numpy inputs made from a seed (NULLs included), and through
both runners at sf0.01; the spilled percentile paths' mergeable summaries
against the reference's, bit for bit.

Tolerances: integers, HLL estimates, approx_percentile values, group keys
and NULL masks equal exactly.  Moments and corr fold batch states with
_chan_merge in the reference's chunk order; their float sums may differ
in the last bits (the reference's XLA program may reassociate), so they
are held at rtol 1e-9 (the values are O(1)-O(1e3), the data exact
decimals, the sums of at most 5000 terms); sort-path sums, whose prefix
order is the reference's (operators.scan_cumsum), at rtol 1e-12."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presto_tpu.exec import operators as JO
from presto_tpu.exec.batch import Batch as JB, Column as JC
from presto_tpu.exec.pipeline import tuned_config as jtuned
from presto_tpu.exec.runner import LocalQueryRunner as JRunner
from presto_tpu.serving import PlanCache as JPlanCache
from presto_tpu_torch.exec import operators as TO
from presto_tpu_torch.exec.batch import Batch as TB, Column as TC
from presto_tpu_torch.exec.pipeline import tuned_config
from presto_tpu_torch.exec.runner import LocalQueryRunner
from torch_rows import assert_rows_close
from torch_threads import one_torch_thread  # noqa: F401

MOMENTS = ("stddev", "stddev_pop", "stddev_samp", "variance", "var_pop",
           "var_samp")
CORRS = ("corr", "covar_pop", "covar_samp")


def _data(seed, n=5000, groups=40, null_frac=0.1):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, groups, n).astype(np.int64)
    x = (rng.integers(-5000, 5000, n) / 100.0)
    y = x * 0.5 + rng.integers(0, 300, n) / 10.0
    xn = rng.random(n) < null_frac
    yn = rng.random(n) < null_frac
    mask = rng.random(n) < 0.9
    return k, x, y, xn, yn, mask


def _jcol(v, nulls=None):
    return JC(jnp.asarray(v), None if nulls is None else jnp.asarray(nulls))


def _tcol(v, nulls=None):
    return TC(torch.from_numpy(np.ascontiguousarray(v)),
              None if nulls is None else torch.from_numpy(nulls))


def _specs(mod, names):
    out = []
    for n in names:
        param = None
        if n == "approx_distinct":
            param = mod.HLL_DEFAULT_BUCKETS
        elif n == "approx_distinct_e":
            n, param = "approx_distinct", mod.hll_buckets_for_error(0.01)
        out.append(mod.AggSpec(n, f"o_{len(out)}", True, param))
    return tuple(out)


@pytest.mark.parametrize("e", [0.0040625, 0.01, 0.023, 0.1, 0.26])
def test_hll_buckets_for_error(e):
    assert TO.hll_buckets_for_error(e) == JO.hll_buckets_for_error(e)


def test_hll_bucket_rank_bit_exact():
    rng = np.random.default_rng(7)
    bits = rng.integers(-(1 << 63), (1 << 63) - 1, 20000, dtype=np.int64)
    bits[:4] = [0, -1, 1, -(1 << 63)]
    for m in (16, 2048, 1 << 16):
        jb, jr = JO._hll_bucket_rank(jnp.asarray(bits.view(np.uint64)), m)
        tb, tr = TO._hll_bucket_rank(torch.from_numpy(bits), m)
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


@pytest.mark.parametrize("seed", [1, 2])
def test_hashed_table_states_equal_reference(seed):
    """agg_init / agg_update (two batches: the Chan merge) / agg_finalize
    of every moment, corr and HLL aggregate, slot by slot (both tables
    hash and probe alike)."""
    k, x, y, xn, yn, mask = _data(seed)
    names = MOMENTS + CORRS + ("approx_distinct", "approx_distinct_e",
                               "sum", "count")
    js, ts = _specs(JO, names), _specs(TO, names)
    S = 128
    jst = JO.agg_init(S, js, ("k",), (jnp.int64,))
    tst = TO.agg_init(S, ts, ("k",), (torch.int64,), "cpu")
    half = len(k) // 2
    for sl in (slice(0, half), slice(half, None)):
        jin = {s.output: _jcol(x[sl], xn[sl]) for s in js}
        tin = {s.output: _tcol(x[sl], xn[sl]) for s in ts}
        jin2 = {s.output: _jcol(y[sl], yn[sl]) for s in js
                if s.name in JO.CORR_AGGS}
        tin2 = {s.output: _tcol(y[sl], yn[sl]) for s in ts
                if s.name in TO.CORR_AGGS}
        jbt = JB({"k": _jcol(k[sl])}, jnp.asarray(mask[sl]))
        tbt = TB({"k": _tcol(k[sl])}, torch.from_numpy(mask[sl]))
        jst = jax.jit(lambda st, b, i, i2: JO.agg_update(
            st, b, [b.columns["k"]], i, js, S, 0, ("k",), i2))(
            jst, jbt, jin, jin2)
        tst = TO.agg_update(tst, tbt, [tbt.columns["k"]], tin, ts, S, 0,
                            ("k",), tin2)
    assert not bool(tst["__collision"])
    jout = JO.agg_finalize(jst, js, ("k",), {})
    tout = TO.agg_finalize(tst, ts, ("k",), {})
    occ = np.asarray(jout.mask)
    np.testing.assert_array_equal(tout.mask.numpy(), occ)
    np.testing.assert_array_equal(tout.columns["k"].values.numpy()[occ],
                                  np.asarray(jout.columns["k"].values)[occ])
    for sj, st in zip(js, ts):
        jc, tc = jout.columns[sj.output], tout.columns[st.output]
        np.testing.assert_array_equal(tc.null_mask().numpy()[occ],
                                      np.asarray(jc.null_mask())[occ])
        jv = np.asarray(jc.values)[occ]
        tv = tc.values.numpy()[occ]
        if st.name in TO.HLL_AGGS or st.name in ("sum", "count"):
            np.testing.assert_array_equal(tv, jv)
        else:
            live = ~np.asarray(jc.null_mask())[occ]
            np.testing.assert_allclose(tv[live], jv[live], rtol=1e-9)


@pytest.mark.parametrize("seed,keys", [(3, True), (4, False), (5, True)])
def test_sort_group_aggregate_equals_reference(seed, keys):
    """Every function of the sort aggregation (approx_percentile at three
    fractions over an integer and a float input included)."""
    k, x, y, xn, yn, mask = _data(seed, n=3000, groups=25)
    xi = (x * 100).astype(np.int64)
    plan = [("sum", x, xn, True), ("sum", xi, xn, False),
            ("avg", x, xn, True), ("avg", xi, xn, False),
            ("min", x, xn, True), ("max", xi, xn, False),
            ("count", x, xn, False), ("count_star", None, None, False)] + \
        [(m, x, xn, True) for m in MOMENTS] + \
        [(c, x, xn, True) for c in CORRS] + \
        [("approx_percentile", xi, xn, False, 0.5),
         ("approx_percentile", x, xn, True, 0.9),
         ("approx_percentile", xi, xn, False, 0.0)]
    js, ts, jin, tin, jin2, tin2 = [], [], {}, {}, {}, {}
    for i, p in enumerate(plan):
        name, v, vn, is_f = p[:4]
        param = p[4] if len(p) > 4 else None
        o = f"o{i}"
        js.append(JO.AggSpec(name, o, is_f, param))
        ts.append(TO.AggSpec(name, o, is_f, param))
        jin[o] = None if v is None else _jcol(v, vn)
        tin[o] = None if v is None else _tcol(v, vn)
        if name in CORRS:
            jin2[o], tin2[o] = _jcol(y, yn), _tcol(y, yn)
    js, ts = tuple(js), tuple(ts)
    kn = ("k",) if keys else ()
    jb = JB({"k": _jcol(k)}, jnp.asarray(mask))
    tb = TB({"k": _tcol(k)}, torch.from_numpy(mask))
    jout = jax.jit(lambda b, i, i2: JO.sort_group_aggregate(
        b, kn, i, js, i2))(jb, jin, jin2)
    tout = TO.sort_group_aggregate(tb, kn, tin, ts, tin2)
    live = np.asarray(jout.mask)
    np.testing.assert_array_equal(tout.mask.numpy(), live)
    for o in [s.output for s in ts] + list(kn):
        jc, tc = jout.columns[o], tout.columns[o]
        jnull = np.asarray(jc.null_mask())[live]
        np.testing.assert_array_equal(tc.null_mask().numpy()[live], jnull)
        jv = np.asarray(jc.values)[live][~jnull]
        tv = tc.values.numpy()[live][~jnull]
        spec = next((s for s in ts if s.output == o), None)
        if spec is not None and (spec.name in MOMENTS
                                 or spec.name in CORRS):
            np.testing.assert_allclose(tv, jv, rtol=1e-9, atol=1e-9)
        elif tv.dtype.kind == "f":
            np.testing.assert_allclose(tv, jv, rtol=1e-12)
        else:
            np.testing.assert_array_equal(tv, jv)


@pytest.mark.parametrize("dependent", [True, False],
                         ids=["verifies", "fails"])
def test_depkey_check_equals_reference(dependent):
    """The runtime span's dependency check: a key constant within each
    anchor group verifies, one that varies does not; the dependent key's
    values come back through _depkey_restore."""
    rng = np.random.default_rng(11)
    n, G = 2000, 64
    anchor = rng.integers(0, G, n).astype(np.int64)
    dep = (anchor * 7 + 3).astype(np.int32) if dependent \
        else rng.integers(0, 5, n).astype(np.int32)
    depf = anchor * 0.25
    nulls = (anchor % 9) == 0        # whole groups NULL: still uniform
    mask = rng.random(n) < 0.8
    names = ("d", "f")
    jst = JO.depkey_init(G, names)
    tst = TO.depkey_init(G, names, "cpu")
    jb = JB({}, jnp.asarray(mask))
    tb = TB({}, torch.from_numpy(mask))
    jst = JO.depkey_update(jst, jb, jnp.asarray(anchor),
                           {"d": _jcol(dep, nulls), "f": _jcol(depf)}, G)
    tst = TO.depkey_update(tst, tb, torch.from_numpy(anchor),
                           {"d": _tcol(dep, nulls), "f": _tcol(depf)}, G)
    seen = np.bincount(anchor[mask], minlength=G).astype(np.int64)
    jok = bool(JO.depkey_verify(jst, jnp.asarray(seen), names))
    tok = bool(TO.depkey_verify(tst, torch.from_numpy(seen), names))
    assert tok == jok == dependent
    occ = seen > 0
    for k, dt, jdt in (("d", torch.int32, jnp.int32),
                       ("f", torch.float64, jnp.float64)):
        np.testing.assert_array_equal(
            TO._depkey_restore(tst[f"__dep_{k}$min"], dt).numpy()[occ],
            np.asarray(JO._depkey_restore(jst[f"__dep_{k}$min"], jdt))[occ])
        np.testing.assert_array_equal(tst[f"__dep_{k}$nulls"].numpy(),
                                      np.asarray(jst[f"__dep_{k}$nulls"]))


QUERIES = {
    # sort path (fused chain, AggFunctionShape decline)
    "moments": ("select l_returnflag, stddev(l_quantity), "
                "variance(l_extendedprice), var_pop(l_discount), "
                "stddev_pop(l_tax) from lineitem group by l_returnflag"),
    "corr": ("select l_linestatus, corr(l_quantity, l_extendedprice), "
             "covar_samp(l_quantity, l_discount), "
             "covar_pop(l_tax, l_discount) from lineitem "
             "group by l_linestatus"),
    "global_moments": ("select stddev_samp(o_totalprice), "
                       "var_samp(o_totalprice) from orders"),
    # the streaming hashed table (fusion declined HllAgg)
    "approx_distinct": ("select l_shipmode, approx_distinct(l_orderkey), "
                        "approx_distinct(l_suppkey, 0.01) from lineitem "
                        "group by l_shipmode"),
    "approx_distinct_global": ("select approx_distinct(o_custkey) "
                               "from orders"),
    # the sort path, nearest rank
    "approx_percentile": ("select l_returnflag, "
                          "approx_percentile(l_quantity, 0.5), "
                          "approx_percentile(l_orderkey, 0.9) "
                          "from lineitem group by l_returnflag"),
}


@pytest.mark.parametrize("n_live,dtype", [
    ((9000, 20000, 0, 8193), np.float64),
    ((16384, 12000), np.int64)], ids=["floats", "ints_with_ties"])
def test_percentile_summaries_equal_reference_bit_for_bit(n_live, dtype):
    """The spilled percentile paths' mergeable summaries,
    percentile_batch_summary and percentile_union_value, against the
    reference's functions of the same names on batches past m live rows,
    with dead lanes (NaN payloads among the floats), an empty batch and,
    among the ints, ties."""
    rng = np.random.default_rng(12)
    pts, cnts, jpts, jcnts = [], [], [], []
    cap = 24000     # one shape, so the reference compiles once
    for n in n_live:
        if dtype is np.float64:
            v = rng.normal(1e4, 3e3, cap)
            v[rng.random(cap) < 0.05] = np.nan
        else:
            v = rng.integers(0, 500, cap)
        alive = np.zeros(cap, dtype=bool)
        alive[rng.permutation(cap)[:n]] = True
        if dtype is np.float64:
            v[alive & np.isnan(v)] = 7.0
        p_pts, p_cnt = TO.percentile_batch_summary(torch.from_numpy(v),
                                                   torch.from_numpy(alive))
        j_pts, j_cnt = JO.percentile_batch_summary(jnp.asarray(v),
                                                   jnp.asarray(alive))
        np.testing.assert_array_equal(p_pts.numpy(), np.asarray(j_pts))
        assert int(p_cnt) == int(j_cnt) == n
        pts.append(p_pts)
        cnts.append(p_cnt)
        jpts.append(j_pts)
        jcnts.append(j_cnt)
    for frac in (0.0, 0.01, 0.37, 0.5, 0.9, 1.0):
        val, null = TO.percentile_union_value(torch.stack(pts),
                                              torch.stack(cnts), frac)
        jval, jnull = JO.percentile_union_value(jnp.stack(jpts),
                                                jnp.stack(jcnts), frac)
        assert float(val) == float(jval) and bool(null) == bool(jnull), (
            frac, float(val), float(jval))


@pytest.fixture(scope="module")
def xla():
    return JRunner("sf0.01", config=jtuned(scan_kernel="xla"),
                   plan_cache=JPlanCache())


@pytest.fixture(scope="module")
def port():
    return LocalQueryRunner("sf0.01", device="cpu")


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_function_queries_equal_reference(xla, port, name):
    sql = QUERIES[name]
    exp = xla.execute(sql)
    got = port.execute(sql)
    assert got.column_names == exp.column_names
    moments = name in ("moments", "corr", "global_moments")
    assert_rows_close(got, exp, ordered=False,
                      rtol=1e-9 if moments else 1e-12)
