"""REAL columns in the port against the JAX package.

A REAL column is float32 on the device; an expression program carries it
in a float64 slot (exactly) and rounds every REAL-typed arithmetic result
and conversion back to float32 (the F2R opcode), which is bit for bit the
reference's float32 arithmetic.  Held here:

  * batches and pages: REAL travels as float32 bits in an INT_ARRAY block
    (scalar and ARRAY(REAL) elements), read into float32 device columns
    and written back bit-identical, readable by the JAX package's
    block_to_values;
  * every expression form over REAL columns through the port's evaluator
    and the reference's Lowering.eval on the same numpy inputs: REAL-typed
    + - * / and nested REAL arithmetic (IR typed REAL by hand: the planner
    types REAL arithmetic DOUBLE), REAL mixed with DOUBLE / BIGINT,
    comparisons, casts from REAL, IF / COALESCE / NULL_IF / negate / abs /
    greatest / least, constants and bound parameters: equal bit for bit;
    the transcendental functions typed DOUBLE bit for bit, typed REAL
    within 1 float32 ulp of numpy's float32;
  * queries over a Parquet file of float32 columns (the hive connector
    maps float32 to REAL): DOUBLE-typed results (sums, averages, REAL
    arithmetic, which the planner types DOUBLE) equal the JAX package's
    rows (rtol 1e-12); REAL-typed results (the column, min / max, group
    and order keys) equal numpy over the float32 values exactly.  The
    JAX package's engine and oracle both mis-read a REAL *output* column
    (its batch_to_page passes float64 values under REAL, its oracle
    turns REAL into int), so REAL outputs are held to numpy;
  * window keys: rank / row_number / counts partitioned and ordered by
    float32 keys (NaN, NULL, dead rows) through window_scan_plain against
    the reference's Pallas window kernel in interpret mode over the same
    values as float32;
  * the scan kernels: a chain whose columns are not resident (a hive
    scan's are host columns) declines ColumnsNotResident before any
    device code, and a REAL query over hive launches no scan kernel."""
import os
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import presto_tpu.common.types as JT
import presto_tpu.spi.expr as JE
from presto_tpu.exec.batch import Batch as JBatch, Column as JColumn
from presto_tpu.exec.lowering import Lowering as JLowering
import presto_tpu_torch.common.types as TT
import presto_tpu_torch.spi.expr as TE
from presto_tpu_torch.exec.batch import Batch as TBatch, Column as TColumn
from presto_tpu_torch.exec.lowering import (Lowering as TLowering,
                                            param_vector, torch_dtype)
from torch_rows import assert_rows_close
from torch_threads import one_torch_thread  # noqa: F401

N = 700


def _schema(T):
    return {"r": T.REAL, "s": T.REAL, "f": T.DOUBLE, "i": T.BIGINT,
            "d2": T.DecimalType(12, 2), "b": T.BOOLEAN}


def _exprs(E, T):
    v = {n: E.variable(n, t) for n, t in _schema(T).items()}
    c, sp, k = E.call, E.special, E.constant
    R, D, B = T.REAL, T.DOUBLE, T.BOOLEAN
    r, s = v["r"], v["s"]
    out = {}
    for op in ("add", "subtract", "multiply", "divide"):
        out[f"{op}_real"] = c(op, R, r, s)
        out[f"{op}_real_double"] = c(op, R, r, v["f"])
        out[f"{op}_real_bigint"] = c(op, R, r, v["i"])
        out[f"{op}_as_double"] = c(op, D, r, s)
        out[f"{op}_mixed_double"] = c(op, D, r, v["f"])
    out.update({
        "nested_real": c("multiply", R, c("add", R, r, s),
                         c("subtract", R, r, k(0.1, R))),
        "nested_real_div": c("divide", R, c("multiply", R, r, r),
                             c("add", R, s, k(3.0, R))),
        "modulus_real": c("modulus", R, r, s),
        "const_real": c("add", R, r, k(1.1, R)),
        "neg_real": c("negate", R, r),
        "abs_real": c("abs", R, s),
        "cast_double": c("cast", D, r),
        "cast_bigint": c("cast", T.BIGINT, r),
        "cast_integer": c("cast", T.INTEGER, s),
        "cast_decimal": c("cast", T.DecimalType(12, 2), r),
        "if_real": sp("IF", R, v["b"], r, s),
        "coalesce_real": sp("COALESCE", R, r, s, k(2.5, R)),
        "nullif_real": sp("NULL_IF", R, r, s),
        "is_null_real": sp("IS_NULL", B, r),
        "greatest_real": c("greatest", R, r, s),
        "least_real": c("least", R, r, s),
        "sqrt_double": c("sqrt", D, c("abs", R, r)),
        "exp_double": c("exp", D, c("divide", R, r, k(64.0, R))),
        "ln_double": c("ln", D, c("abs", R, s)),
    })
    for cmp in ("lt", "lte", "gt", "gte", "eq", "neq"):
        out[f"{cmp}_real"] = c(cmp, B, r, s)
        out[f"{cmp}_real_double"] = c(cmp, B, r, v["f"])
        out[f"{cmp}_real_const"] = c(cmp, B, r, k(0.5, D))
    return out


def _data(seed: int, with_nulls: bool):
    rng = np.random.default_rng(seed)
    r = (rng.normal(0, 200, N) * rng.choice([1e-3, 1.0, 1e4], N)) \
        .astype(np.float32)
    s = rng.normal(0, 30, N).astype(np.float32)
    # no subnormal float32: XLA's CPU backend flushes them to zero
    r[:8] = [0.5, -0.5, 1.5, 0.1, 3.4028235e38, 1e-30, np.nan, -0.0]
    s[:8] = [0.5, 0.25, -2.0, 0.0, 2.0, 1e-30, 1.0, 0.0]
    s[8:20] = r[8:20]                        # equal pairs
    vals = {
        "r": r, "s": s,
        "f": np.round(rng.normal(0, 300, N), 3),
        "i": rng.integers(-1000, 1000, N).astype(np.int64),
        "d2": rng.integers(-10 ** 6, 10 ** 6, N).astype(np.int64),
        "b": rng.integers(0, 2, N).astype(bool),
    }
    vals["f"][:10] = r[:10].astype(np.float64)
    nulls = {n: (rng.random(N) < 0.2) if with_nulls else None for n in vals}
    return vals, nulls, rng.random(N) < 0.9


def _jax_batch(vals, nulls, mask):
    return JBatch({n: JColumn(jnp.asarray(v), None if nulls[n] is None
                              else jnp.asarray(nulls[n]))
                   for n, v in vals.items()}, jnp.asarray(mask))


def _torch_batch(vals, nulls, mask):
    return TBatch({n: TColumn(torch.from_numpy(v.copy()),
                              None if nulls[n] is None
                              else torch.from_numpy(nulls[n].copy()))
                   for n, v in vals.items()}, torch.from_numpy(mask.copy()))


NAMES = sorted(_exprs(TE, TT))
_FN_DOUBLE = ("sqrt_double", "exp_double", "ln_double")
# the casts read REAL as the reference's scan leaves it: float64 values
# of float32 (the JAX package's engine never holds a REAL column as
# float32; its Lowering would scale a float32 value in float32)
_CASTS = ("cast_bigint", "cast_decimal", "cast_double", "cast_integer")


def _bits_equal(tv, jv):
    assert tv.dtype == jv.dtype, (tv.dtype, jv.dtype)
    nan = np.isnan(jv)
    np.testing.assert_array_equal(np.isnan(tv), nan)
    view = np.int32 if jv.dtype == np.float32 else np.int64
    np.testing.assert_array_equal(tv[~nan].view(view), jv[~nan].view(view))


@pytest.mark.parametrize("with_nulls", [True, False],
                         ids=["nulls", "no_nulls"])
@pytest.mark.parametrize("name", NAMES)
def test_real_expr_matches_reference_eval(name, with_nulls):
    vals, nulls, mask = _data(zlib.crc32(name.encode()), with_nulls)
    jvals = dict(vals)
    if name in _CASTS:
        jvals.update({n: vals[n].astype(np.float64) for n in ("r", "s")})
    jcol = JLowering().eval(_exprs(JE, JT)[name],
                            _jax_batch(jvals, nulls, mask))
    tcol = TLowering().eval(_exprs(TE, TT)[name],
                            _torch_batch(vals, nulls, mask))
    jv, tv = np.asarray(jcol.values), tcol.values.numpy()
    np.testing.assert_array_equal(tcol.null_mask().numpy(),
                                  np.asarray(jcol.null_mask()))
    live = ~tcol.null_mask().numpy()
    if name in _FN_DOUBLE:
        # XLA's and torch's float64 sqrt / exp / ln: within 1 ulp
        assert tv.dtype == jv.dtype == np.float64
        t, j = tv[live], jv[live]
        assert np.array_equal(np.isnan(t), np.isnan(j))
        ok = ~np.isnan(j)
        assert np.abs(t[ok].view(np.int64) - j[ok].view(np.int64)).max(
            initial=0) <= 1
    elif jv.dtype.kind == "f":
        _bits_equal(tv[live], jv[live])
    elif jv.dtype == np.bool_:
        np.testing.assert_array_equal(tv.astype(bool), jv.astype(bool))
    elif name == "cast_decimal":
        # in range: equal.  NaN and values past int64 (3.4e38 * 100): the
        # port's RINT_I gives INT64_MIN, as for a DOUBLE (and the scan
        # kernels' rint); XLA's conversion gives 0 / INT64_MAX; Presto
        # raises.  Held here as they are.
        src = vals["r"].astype(np.float64) * 100
        ok = np.isfinite(src) & (np.abs(src) < 2.0 ** 62)
        np.testing.assert_array_equal(tv[ok], jv[ok].astype(np.int64))
        assert (tv[~ok & live] == np.iinfo(np.int64).min).all()
    else:
        np.testing.assert_array_equal(tv.astype(np.int64),
                                      jv.astype(np.int64))


_NP = {"sqrt": np.sqrt, "exp": np.exp, "ln": np.log, "sin": np.sin,
       "cbrt": np.cbrt}


@pytest.mark.parametrize("fn", sorted(_NP))
def test_real_typed_transcendentals_within_one_ulp(fn):
    """A REAL-typed function: the float64 function of the float32 value,
    rounded once to float32.  sqrt is correctly rounded, so it equals
    numpy's float32 sqrt bit for bit; the transcendentals are within 1
    float32 ulp of numpy's float64 function rounded to float32 (torch's
    and numpy's float64 functions may differ in their last bit) and
    within 2 ulps of numpy's float32 functions (the stated tolerances)."""
    rng = np.random.default_rng(zlib.crc32(fn.encode()))
    x = rng.uniform(0.01, 20.0, N).astype(np.float32)
    expr = TE.call(fn, TT.REAL, TE.variable("r", TT.REAL))
    got = TLowering().eval(expr, TBatch(
        {"r": TColumn(torch.from_numpy(x))},
        torch.ones(N, dtype=torch.bool))).values.numpy()
    assert got.dtype == np.float32

    def ulps(want):
        return int(np.abs(got.view(np.int32).astype(np.int64)
                          - want.view(np.int32).astype(np.int64)).max())
    np_fn = _NP[fn]
    assert ulps(np_fn(x.astype(np.float64)).astype(np.float32)) \
        <= (0 if fn == "sqrt" else 1)
    assert ulps(np_fn(x)) <= (0 if fn == "sqrt" else 2)


def test_real_parameters_round_to_float32():
    """A REAL bound parameter carries the float32 value in its float64
    slot (the reference's jnp.asarray(v, float32)); the program's result
    equals the reference's with the same parameter."""
    words = param_vector([0.1, 2, 0.1], [TT.REAL, TT.BIGINT, TT.DOUBLE],
                         "cpu")
    f = words.view(torch.float64)
    assert f[0].item() == float(np.float32(0.1)) and f[2].item() == 0.1
    assert words[1].item() == 2
    vals, nulls, mask = _data(5, False)
    tb, jb_ = _torch_batch(vals, nulls, mask), _jax_batch(vals, nulls, mask)
    tb.params = words
    jb_.params = (jnp.asarray(0.1, dtype=jnp.float32), jnp.asarray(2),
                  jnp.asarray(0.1))
    for op in ("add", "multiply"):
        got, want = (
            lw().eval(E.call(op, T.REAL, E.variable("r", T.REAL),
                             E.BoundParameterExpression(0, T.REAL)), b)
            for E, T, lw, b in ((TE, TT, TLowering, tb),
                                (JE, JT, JLowering, jb_)))
        _bits_equal(got.values.numpy(), np.asarray(want.values))


def test_dtypes():
    assert torch_dtype(TT.REAL) == torch.float32
    assert torch_dtype(TT.DOUBLE) == torch.float64


# -- batches and pages -------------------------------------------------------

def test_real_pages_round_trip():
    from presto_tpu.common.block import block_to_values as jvalues
    from presto_tpu_torch.common.block import (ArrayBlock, FixedWidthBlock,
                                               block_from_values,
                                               block_to_values)
    from presto_tpu_torch.common.page import Page
    from presto_tpu_torch.exec.batch import (_host_column, batch_to_page,
                                             pages_to_batches)
    vals = [1.5, None, float(np.float32(0.1)), float(np.float32(-3e38)),
            float("inf"), 0.0]
    block = block_from_values(TT.REAL, vals)
    assert block.values.dtype == np.int32           # REAL's wire form
    v, nl, _d, _l = _host_column(TT.REAL, block)
    assert v.dtype == np.float32 and list(nl) == [False, True] + [False] * 4
    [batch] = pages_to_batches([Page([block], len(vals))], ["x"], [TT.REAL],
                               8)
    assert batch.columns["x"].values.dtype == torch.float32
    page = batch_to_page(batch, ["x"], [TT.REAL])
    out = page.blocks[0]
    assert out.values.dtype == np.int32
    assert block_to_values(TT.REAL, out) == vals
    assert jvalues(JT.REAL, out) == vals
    # ARRAY(REAL) elements
    arr_t = TT.ArrayType(TT.REAL)
    ablock = block_from_values(arr_t, [[1.25, 2.5], None, [float(
        np.float32(0.3))]])
    assert isinstance(ablock, ArrayBlock)
    assert isinstance(ablock.elements, FixedWidthBlock)
    [abatch] = pages_to_batches([Page([ablock], 3)], ["a"], [arr_t], 4)
    assert abatch.columns["a"].values.dtype == torch.float32
    apage = batch_to_page(abatch, ["a"], [arr_t])
    assert block_to_values(arr_t, apage.blocks[0]) == \
        block_to_values(arr_t, ablock)


# -- queries over a float32 Parquet file -------------------------------------

@pytest.fixture(scope="module")
def real_tables(tmp_path_factory):
    import pyarrow as pa
    import pyarrow.parquet as pq
    from presto_tpu.connectors import catalog as jcatalog
    from presto_tpu.connectors import hive as jhive
    from presto_tpu.exec.pipeline import ExecutionConfig as JConfig
    from presto_tpu.exec.runner import LocalQueryRunner as JRunner
    from presto_tpu_torch.connectors import catalog, hive
    from presto_tpu_torch.exec.pipeline import ExecutionConfig
    from presto_tpu_torch.exec.runner import LocalQueryRunner
    wh = tmp_path_factory.mktemp("real_wh")
    rng = np.random.default_rng(20)
    n = 5000
    q = rng.integers(1, 51, n).astype(np.float32)
    p = (rng.uniform(900, 1e5, n)).astype(np.float32)
    d = (rng.integers(0, 11, n) / 100).astype(np.float32)
    k = rng.integers(0, 25, n)
    qn = rng.random(n) < 0.03
    os.makedirs(wh / "rt")
    pq.write_table(pa.table({
        "k": pa.array(k, pa.int64()), "q": pa.array(q, mask=qn),
        "p": pa.array(p), "d": pa.array(d)}), wh / "rt" / "part-0.parquet")
    catalog.register_connector("hive", hive.HiveConnector(str(wh)))
    jcatalog.register_connector("hive", jhive.HiveConnector(str(wh)))
    try:
        yield (LocalQueryRunner("sf0.01", device="cpu",
                                config=ExecutionConfig(batch_rows=1 << 12)),
               JRunner("sf0.01", config=JConfig(batch_rows=1 << 12)),
               {"k": k, "q": np.where(qn, np.nan, q), "qn": qn, "p": p,
                "d": d})
    finally:
        catalog.unregister_connector("hive")
        jcatalog.unregister_connector("hive")


_DOUBLE_QUERIES = {
    "sums": "select k, sum(q) sq, sum(p * d) rev, avg(p) ap, count(q) cq, "
            "count(*) c from rt group by k",
    "filter_project": "select sum(p * (1 - d)) s, sum(q + p) t from rt "
                      "where d between 0.02 and 0.05 and q < 24",
    "casts": "select cast(p as double) * 2 x, cast(q as bigint) y, "
             "cast(p as decimal(12, 2)) z from rt where k = 3",
    "join_on_real": "select count(*) c, sum(a.p) s from rt a join rt b "
                    "on a.d = b.d and a.k = b.k where a.k < 3",
    "window_over_real": "select k, rank() over (partition by d order by q) "
                        "rk, row_number() over (order by p) rn from rt "
                        "where k < 2",
}


@pytest.mark.parametrize("name", sorted(_DOUBLE_QUERIES))
def test_double_results_equal_the_reference(real_tables, name):
    port, ref, _ = real_tables
    sql = _DOUBLE_QUERIES[name]
    assert [str(v.type) for v in port.plan(sql).outputs] == \
        [str(v.type) for v in ref.plan(sql).outputs]
    assert_rows_close(port.execute(sql), ref.execute(sql), ordered=False,
                      rtol=1e-12)


def test_real_results_equal_numpy(real_tables):
    port, _, a = real_tables
    got = port.execute("select k, min(q) mn, max(p) mx, min(d) md from rt "
                       "group by k order by k")
    assert [str(t) for t in got.column_types] == \
        ["bigint", "real", "real", "real"]
    for k, mn, mx, md in got.rows:
        sel = a["k"] == k
        qs = a["q"][sel & ~a["qn"]]
        assert mn == float(qs.min()) and mx == float(a["p"][sel].max()) \
            and md == float(a["d"][sel].min())
    got = port.execute("select d, count(*) c from rt group by d order by d")
    vals, counts = np.unique(a["d"], return_counts=True)
    assert got.rows == [[float(v), int(c)] for v, c in zip(vals, counts)]
    got = port.execute("select q, p from rt where k = 7 and q is not null "
                       "order by p desc limit 20")
    sel = (a["k"] == 7) & ~a["qn"]
    order = np.argsort(-a["p"][sel], kind="stable")[:20]
    assert got.rows == [[float(x), float(y)] for x, y in
                        zip(a["q"][sel][order], a["p"][sel][order])]
    assert port.execute_reference(
        "select max(p) from rt").rows == [[float(a["p"].max())]]


def test_hive_real_query_launches_no_scan_kernel(real_tables):
    from presto_tpu_torch.exec.kernels import scan_kernel as sk
    port, _, _ = real_tables
    before = dict(sk.LAUNCHES)
    res = port.execute("select sum(p) from rt where q < 10")
    assert dict(sk.LAUNCHES) == before
    assert not any(k.startswith("torchChain")
                   for k in (res.runtime_stats or {}))


def test_chain_without_resident_columns_declines():
    from presto_tpu_torch.exec.kernels import scan_kernel as sk

    class Chain:
        steps = [("filter", None)]
        scan_meta = {"cached_cols": {}, "colmap": {"q": "q", "p": "p"}}
    declined = []
    assert sk.chain_eligible(Chain(), declined.append) is None
    assert declined == ["ColumnsNotResident"]
    assert torch.float32 not in sk._DTYPES


# -- window keys: the plain version against the reference's Pallas kernel ----

@pytest.mark.parametrize("seed", [61, 62, 63])
def test_window_float32_keys_match_reference_kernel(seed):
    from presto_tpu.exec import batch as jb
    from presto_tpu.exec import operators as jops
    from presto_tpu.exec.kernels import window as jwk
    from presto_tpu_torch.exec import operators as ops
    from presto_tpu_torch.exec.kernels import scan_kernel as sk
    from presto_tpu_torch.exec.kernels import window as wk
    rng = np.random.default_rng(seed)
    n = 1500
    cols = {
        "p": (np.where(rng.random(n) < 0.05, np.nan,
                       rng.integers(0, 12, n) / 4).astype(np.float32),
              rng.random(n) < 0.05),
        "f": (np.where(rng.random(n) < 0.1, np.nan,
                       rng.integers(0, 8, n) / 3).astype(np.float32),
              rng.random(n) < 0.05),
        "x": (rng.integers(-10 ** 6, 10 ** 6, n).astype(np.int64),
              rng.random(n) < 0.1),
    }
    live = rng.random(n) >= 0.2
    fields = [("row_number", "rn", None), ("rank", "rk", None),
              ("dense_rank", "dr", None), ("count_star", "c0", None),
              ("count", "cf", "f"), ("sum", "sx", "x"), ("avg", "ax", "x")]
    tspecs = tuple(ops.WindowSpec(a, b, c) for a, b, c in fields)
    jspecs = tuple(jops.WindowSpec(a, b, c) for a, b, c in fields)
    tb = TBatch({k: TColumn(torch.from_numpy(v), torch.from_numpy(nl))
                 for k, (v, nl) in cols.items()}, torch.from_numpy(live))
    jbt = jb.Batch({k: jb.Column(jnp.asarray(v), jnp.asarray(nl))
                    for k, (v, nl) in cols.items()}, jnp.asarray(live))
    orderings = (("f", "DESC_NULLS_LAST"),)
    before = sk.LAUNCHES["window_scan"]
    got = wk.try_window_kernel(tb, ("p",), orderings, tspecs,
                               declined=pytest.fail)
    exp = jwk.try_window_kernel(jbt, ("p",), orderings, jspecs,
                                declined=pytest.fail)
    assert sk.LAUNCHES["window_scan"] == before     # the plain version
    mask = got.mask.numpy()
    assert np.array_equal(mask, np.asarray(exp.mask))
    for name in list(cols) + [f[1] for f in fields]:
        g, e = got.columns[name], exp.columns[name]
        gv, ev = g.values.numpy()[mask], np.asarray(e.values)[mask]
        if gv.dtype.kind == "f":
            assert gv.dtype == ev.dtype == np.float32
            _bits_equal(gv[~np.isnan(ev)], ev[~np.isnan(ev)])
        else:
            assert np.array_equal(gv, ev), name
        gn = None if g.nulls is None else g.nulls.numpy()[mask]
        en = None if e.nulls is None else np.asarray(e.nulls)[mask]
        assert (gn is None and (en is None or not en.any())) or \
            np.array_equal(gn, en), name
