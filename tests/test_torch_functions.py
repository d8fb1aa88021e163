"""The rest of the scalar function set in the port (presto_tpu_torch/exec/
lowering.py, the opcodes after F2I), held to the JAX package:

  * the queries of tests/test_functions.py -- MATH_QUERIES,
    STRING_QUERIES, DATE_QUERIES, BREADTH_QUERIES, SHIFT_EDGE_QUERIES, the
    pad, ISO week, URL / JSON and lazy-regexp cases -- through the port's
    LocalQueryRunner on the CPU against the reference's LocalQueryRunner
    rows (one JAX runner, its 8K-row batches, one run per query):
    integers, decimals and strings exactly, floats within rtol 1e-12 (the
    transcendental functions of torch and of XLA's CPU math may differ
    in the last bits), and the literal values the reference's test
    asserts;
  * each new opcode against the reference's Lowering.eval on numpy
    inputs made from a seed (NULLs, NaN, infinities, date and shift
    edges): values and NULL masks, floats within the same rtol;
  * every new opcode lies outside KERNEL_OPS, so a kernel-eligible chain
    that uses one meters kernelDeclinedPlanShape, naming the opcode;
  * DistinctLimit runs.

The array functions (repeat, cardinality) are tests/test_torch_arrays.py's."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import presto_tpu.common.types as JT
import presto_tpu.spi.expr as JE
from presto_tpu.exec.batch import Batch as JBatch, Column as JColumn
from presto_tpu.exec.lowering import Lowering as JLowering
from presto_tpu.exec.pipeline import ExecutionConfig as JConfig
from presto_tpu.exec.runner import LocalQueryRunner as JRunner
import presto_tpu_torch.common.types as TT
import presto_tpu_torch.spi.expr as TE
from presto_tpu_torch.exec import lowering as tlow
from presto_tpu_torch.exec.batch import Batch as TBatch, Column as TColumn
from presto_tpu_torch.exec.pipeline import ExecutionConfig, tuned_config
from presto_tpu_torch.exec.runner import LocalQueryRunner
from presto_tpu_torch.benchmarks import function_queries as FQ
import test_functions as F
from torch_rows import assert_rows_close
from torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-12
ALL = FQ.ALL


def test_bank_is_the_reference_tests_queries():
    """The port's function bank holds tests/test_functions.py's queries
    unchanged."""
    for name in ("MATH_QUERIES", "STRING_QUERIES", "DATE_QUERIES",
                 "BREADTH_QUERIES", "SHIFT_EDGE_QUERIES"):
        assert getattr(FQ, name) == getattr(F, name), name


@pytest.fixture(scope="module")
def expected():
    runner = JRunner("sf0.01", config=JConfig(batch_rows=1 << 13))
    cache = {}

    def get(sql):
        if sql not in cache:
            cache[sql] = runner.execute(sql)
        return cache[sql]
    return get


@pytest.fixture(scope="module")
def port():
    return LocalQueryRunner("sf0.01", device="cpu",
                            config=ExecutionConfig(batch_rows=1 << 13))


@pytest.mark.parametrize("sql", ALL, ids=[f"q{i}" for i in range(len(ALL))])
def test_query_rows_equal_reference(expected, port, sql):
    assert_rows_close(port.execute(sql), expected(sql), ordered=False,
                      rtol=RTOL)


def test_literal_values(port):
    """The reference test's asserted values: Presto's pads cycle from the
    start of the fill, shifts past the width shift everything out, and a
    negative count is NULL."""
    r = port.execute("SELECT lpad(linestatus, 5, 'ab') l, "
                     "rpad(linestatus, 5, 'ab') r FROM lineitem "
                     "WHERE orderkey = 1 AND linenumber = 1")
    assert r.rows == [["ababO", "Oabab"]]
    res = port.execute(
        "SELECT bitwise_left_shift(orderkey, 64) a, "
        "bitwise_right_shift(orderkey, 64) b, "
        "bitwise_arithmetic_shift_right(0 - orderkey, 64) c, "
        "bitwise_left_shift(orderkey, -1) d "
        "FROM orders WHERE orderkey = 7")
    assert res.rows == [[0, 0, -1, None]]


def test_distinct_limit(expected, port):
    """SELECT DISTINCT ... LIMIT n plans a DistinctLimitNode, which the
    port lowers to an aggregation and a limit: n distinct values of the
    column's set (which n is the engine's choice)."""
    from presto_tpu_torch.spi import plan as P
    sql = "select distinct l_shipmode from lineitem limit 2"
    nodes, stack = [], [port.plan(sql)]
    while stack:
        n = stack.pop()
        nodes.append(n)
        stack.extend(n.sources)
    assert any(isinstance(n, P.DistinctLimitNode) for n in nodes)
    rows = port.execute(sql).rows
    every = {r[0] for r in expected(
        "select distinct l_shipmode from lineitem").rows}
    assert len(rows) == 2 and len({r[0] for r in rows}) == 2
    assert {r[0] for r in rows} <= every
    ds = LocalQueryRunner("sf0.01", catalog="tpcds", device="cpu")
    rows = ds.execute("select distinct i_category from item limit 2").rows
    assert len(rows) == 2 and len({r[0] for r in rows}) == 2
    from presto_tpu_torch.connectors import tpcds
    assert {r[0] for r in rows} <= set(tpcds.CATEGORIES)


# -- each new opcode against the reference's Lowering ---------------------------

N = 512
D1 = ("A", "N", "R")
D2 = ("F", "O")


def _edge_days():
    """Dec 27 - Jan 5 around every third year boundary 1969-2031 (the
    ISO week wraps), then random days across 1900-2100."""
    rng = np.random.default_rng(3)
    edges = []
    for y in range(1969, 2032, 3):
        jan1 = (np.datetime64(f"{y}-01-01") - np.datetime64("1970-01-01")) \
            .astype(np.int64)
        edges.extend(range(jan1 - 5, jan1 + 5))
    edges = np.array(edges, dtype=np.int64)
    rand = rng.integers(-25567, 47482, N - len(edges))
    return np.concatenate([edges, rand]).astype(np.int32)


def _inputs():
    rng = np.random.default_rng(11)
    i = rng.integers(-(1 << 62), 1 << 62, N).astype(np.int64)
    i[:6] = [0, -1, 1, np.iinfo(np.int64).min, np.iinfo(np.int64).max, 7]
    f = rng.normal(size=N) * 1e3
    f[:6] = [np.nan, np.inf, -np.inf, 0.5, -2.5, -0.0]
    m = rng.integers(-10 ** 7, 10 ** 7, N).astype(np.int64)
    m[:6] = [50, -50, 150, -250, 5, 0]         # .5 edges at scale 2
    return {
        "d": (_edge_days(), rng.random(N) < 0.05, None),
        "d2": (np.roll(_edge_days(), 37), None, None),
        "i": (i, rng.random(N) < 0.05, None),
        "k": (rng.integers(-3, 70, N).astype(np.int64), None, None),
        "n": (rng.integers(-40, 40, N).astype(np.int64), None, None),
        "b": (rng.integers(-3, 12, N).astype(np.int64), None, None),
        "f": (f, rng.random(N) < 0.05, None),
        "m": (m, rng.random(N) < 0.05, None),
        "s1": (rng.integers(0, len(D1), N).astype(np.int32),
               rng.random(N) < 0.05, D1),
        "s2": (rng.integers(0, len(D2), N).astype(np.int32), None, D2),
    }


def _types(T):
    return {"d": T.DATE, "d2": T.DATE, "i": T.BIGINT, "k": T.BIGINT,
            "n": T.BIGINT, "b": T.BIGINT, "f": T.DOUBLE,
            "m": T.DecimalType(12, 2), "s1": T.VarcharType(),
            "s2": T.VarcharType()}


def _exprs(E, T):
    v = {n: E.variable(n, t) for n, t in _types(T).items()}
    B, BI, D, DA, V = T.BOOLEAN, T.BIGINT, T.DOUBLE, T.DATE, T.VarcharType()
    D12_0 = T.DecimalType(12, 0)

    def c(x, t=BI):
        return E.constant(x, t)
    out = {}
    for fn in ("day_of_week", "day_of_year", "week"):
        out[fn] = E.call(fn, BI, v["d"])
    for unit in ("day", "week", "month", "quarter", "year"):
        out[f"date_trunc_{unit}"] = E.call("date_trunc", DA, c(unit, V),
                                           v["d"])
        out[f"date_add_{unit}"] = E.call("date_add", DA, c(unit, V),
                                         v["n"], v["d"])
        out[f"date_diff_{unit}"] = E.call("date_diff", BI, c(unit, V),
                                          v["d"], v["d2"])
    for fn in ("bitwise_and", "bitwise_or", "bitwise_xor"):
        out[fn] = E.call(fn, BI, v["i"], v["k"])
    out["bitwise_not"] = E.call("bitwise_not", BI, v["i"])
    for fn in ("bitwise_left_shift", "bitwise_right_shift",
               "bitwise_arithmetic_shift_right"):
        out[fn] = E.call(fn, BI, v["i"], v["k"])
    out["width_bucket"] = E.call("width_bucket", BI, v["f"], c(-1e3, D),
                                 c(1e3, D), v["b"])
    out["round_decimal"] = E.call("round", D12_0, v["m"])
    out["round_decimal_1"] = E.call("round", T.DecimalType(12, 2), v["m"],
                                    c(1))
    out["round_double"] = E.call("round", D, v["f"])
    out["round_double_2"] = E.call("round", D, v["f"], c(2))
    out["round_double_neg"] = E.call("round", D, v["f"], c(-2))
    out["round_bigint"] = E.call("round", BI, v["n"], c(-1))
    out["ceil_decimal"] = E.call("ceiling", D12_0, v["m"])
    out["floor_decimal"] = E.call("floor", D12_0, v["m"])
    out["ceil_double"] = E.call("ceil", D, v["f"])
    out["floor_double"] = E.call("floor", D, v["f"])
    out["truncate"] = E.call("truncate", D, v["m"])
    out["sign_decimal"] = E.call("sign", T.DecimalType(1, 0), v["m"])
    out["sign_double"] = E.call("sign", D, v["f"])
    out["sign_bigint"] = E.call("sign", BI, v["i"])
    out["greatest_int"] = E.call("greatest", BI, v["i"], v["k"], v["n"])
    out["least_double"] = E.call("least", D, v["f"], c(1.5, D))
    out["greatest_decimal"] = E.call("greatest", T.DecimalType(12, 2),
                                     v["m"], v["n"])
    for fn in ("is_nan", "is_finite", "is_infinite"):
        out[fn] = E.call(fn, B, v["f"])
    for fn in ("sqrt", "exp", "ln", "log2", "log10", "sin", "cos", "tan",
               "asin", "acos", "atan", "cbrt", "degrees", "radians",
               "sinh", "cosh", "tanh"):
        out[fn] = E.call(fn, D, E.call("divide", D, v["f"], c(1e3, D)))
    out["power"] = E.call("power", D, v["f"], c(2.0, D))
    out["log"] = E.call("log", D, c(3.0, D), v["f"])
    out["atan2"] = E.call("atan2", D, v["f"], v["m"])
    out["concat_two"] = E.call("concat", V, v["s1"], v["s2"])
    out["concat_sep"] = E.call("concat", V, v["s1"], c("-", V), v["s2"])
    out["concat_one"] = E.call("concat", V, c("x", V), v["s1"])
    out["regexp_like"] = E.call("regexp_like", B, v["s1"], c("^[AN]", V))
    out["regexp_extract"] = E.call("regexp_extract", V, v["s1"],
                                   c("(N)", V), c(1))
    return out


CASES = sorted(_exprs(TE, TT))


@pytest.fixture(scope="module")
def batches():
    data = _inputs()
    mask = np.ones(N, dtype=bool)
    jcols, tcols = {}, {}
    for n, (vals, nulls, d) in data.items():
        jcols[n] = JColumn(jnp.asarray(vals),
                           None if nulls is None else jnp.asarray(nulls), d)
        tcols[n] = TColumn(torch.from_numpy(vals),
                           None if nulls is None else torch.from_numpy(nulls),
                           d)
    return (JBatch(jcols, jnp.asarray(mask)),
            TBatch(tcols, torch.from_numpy(mask)))


@pytest.mark.parametrize("case", CASES)
def test_opcode_equals_reference_lowering(batches, case):
    jb, tb = batches
    jcol = JLowering().eval(_exprs(JE, JT)[case], jb)
    tcol = tlow.Lowering().eval(_exprs(TE, TT)[case], tb)
    jn = np.asarray(jcol.null_mask())
    np.testing.assert_array_equal(tcol.null_mask().numpy(), jn)
    live = ~jn
    jv, tv = np.asarray(jcol.values)[live], tcol.values.numpy()[live]
    if jcol.dictionary is not None:
        assert [tcol.dictionary[int(x)] for x in tv] == \
            [jcol.dictionary[int(x)] for x in jv]
    elif jv.dtype.kind == "f":
        np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=0)
    else:
        np.testing.assert_array_equal(tv.astype(np.int64),
                                      jv.astype(np.int64))


# -- the kernels decline the new opcodes ------------------------------------------

NEW_OPS = tlow.OPS[tlow.OPS.index("F2I") + 1:]


def test_new_opcodes_are_outside_kernel_ops():
    assert tlow.KERNEL_OPS == frozenset(range(tlow.OP["CONST_S"]))
    for name in NEW_OPS:
        assert tlow.OP[name] not in tlow.KERNEL_OPS, name
    from presto_tpu_torch.exec.kernels import codegen
    assert not set(NEW_OPS) & set(codegen.EMITTERS)
    # every compiled case reaches at least one of them
    exprs = _exprs(TE, TT)
    for case in CASES:
        ops = {tlow.OPS[op] for op, _ in tlow.compile_expr(exprs[case]).ops}
        assert ops & (set(NEW_OPS) | {"MAP_S"}), case


@pytest.mark.parametrize("sql,opcode", [
    ("select sum(l_quantity) from lineitem "
     "where day_of_week(l_shipdate) = 3", "DOW"),
    ("select l_returnflag, sum(sqrt(l_extendedprice)) from lineitem "
     "group by l_returnflag", "FN_F"),
    ("select count(*) from lineitem "
     "where bitwise_and(l_orderkey, 7) = 1", "BAND"),
    ("select l_linestatus, sum(round(l_extendedprice, 0)) from lineitem "
     "group by l_linestatus", "ROUNDD_I"),
], ids=["dow", "sqrt", "bitwise_and", "round"])
def test_kernel_plan_build_declines_naming_the_opcode(monkeypatch, expected,
                                                      sql, opcode):
    from presto_tpu_torch.exec.kernels import scan_kernel as sk
    errors = []
    real = sk.cached_plan

    def cached_plan(cache, *a, **kw):
        out = real(cache, *a, **kw)
        errors.append(cache.get("plan_error"))
        return out
    monkeypatch.setattr(sk, "cached_plan", cached_plan)
    got = LocalQueryRunner("sf0.01", device="cpu").execute(sql)
    assert int(got.runtime_stats["kernelDeclinedPlanShape"]["sum"]) == 1
    assert errors and f"opcode {opcode}" in errors[-1]
    assert_rows_close(got, expected(sql), ordered=False, rtol=RTOL)


@pytest.mark.parametrize("family", sorted(FQ.AT_SCALE))
def test_at_scale_queries_decline_plan_shape(family):
    """The chip script's per-family lineitem aggregations reach the scan
    kernels' plan build and decline PlanShape on their new opcode; the
    torch chain's rows equal the xla run's under the same config (a
    larger batch would rebuild the process's resident lineitem columns
    under a larger pad, which plain-encodes the small columns a later
    runner then reads)."""
    sql = FQ.AT_SCALE[family]
    got = LocalQueryRunner("sf0.01", device="cpu").execute(sql)
    assert int(got.runtime_stats["kernelDeclinedPlanShape"]["sum"]) == 1
    xla = LocalQueryRunner("sf0.01", device="cpu",
                           config=tuned_config(scan_kernel="xla"))
    assert_rows_close(got, xla.execute(sql), ordered=False, rtol=RTOL)
