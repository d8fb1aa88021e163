"""The varchar expressions over dictionaries and the numeric forms added
with them, against the reference's Lowering.eval on the same numpy
inputs (made from a seed, NULLs included).  Every opcode after the
kernels' set -- CONST_S, NULL_S, CMP_S (a literal, one dictionary, a
remap across two), MAP_S (LIKE, IN, substr, the string functions and
length), IF_S (merged dictionaries), NULLIF_X and F2I -- the scaled
decimal divide DIVQS_I (in the kernels' set too, also exact past int64)
and IN with a NULL in its list.  Values, NULL masks and (for varchar results) the
decoded strings equal exactly.  Then the kernels' plan build declines
each new opcode, naming it."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import presto_tpu.common.types as JT
import presto_tpu.spi.expr as JE
from presto_tpu.exec.batch import Batch as JBatch, Column as JColumn
from presto_tpu.exec.lowering import Lowering as JLowering
import presto_tpu_torch.common.types as TT
import presto_tpu_torch.spi.expr as TE
from presto_tpu_torch.exec import lowering as tlow
from presto_tpu_torch.exec.batch import Batch as TBatch, Column as TColumn
from torch_threads import one_torch_thread  # noqa: F401

N = 400
D1 = ("AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK")
D2 = ("AIR", "MAIL", "PROMO BRASS", "TRUCK")


def _inputs():
    rng = np.random.default_rng(20)
    f = rng.normal(size=N) * 1e9
    f[:6] = [np.nan, np.inf, -np.inf, 3e9, -3e9, 1e19]
    return {
        "s1": (rng.integers(0, len(D1), N).astype(np.int32),
               rng.random(N) < 0.1, D1),
        "s3": (rng.integers(0, len(D1), N).astype(np.int32), None, D1),
        "s2": (rng.integers(0, len(D2), N).astype(np.int32),
               rng.random(N) < 0.1, D2),
        "i": (rng.integers(-3, 4, N).astype(np.int64),
              rng.random(N) < 0.1, None),
        "f": (np.where(rng.random(N) < 0.5, np.round(f, 0),
                       rng.integers(-3, 4, N).astype(np.float64)),
              rng.random(N) < 0.1, None),
    }


def _types(T):
    V = T.VarcharType()
    return {"s1": V, "s2": V, "s3": V, "i": T.BIGINT, "f": T.DOUBLE}


def _exprs(E, T):
    ty = _types(T)
    v = {n: E.variable(n, t) for n, t in ty.items()}
    V, B = T.VarcharType(), T.BOOLEAN

    def lit(s):
        return E.constant(s, V)
    out = {}
    for op in ("eq", "neq", "lt", "lte", "gt", "gte"):
        out[f"lit_{op}"] = E.call(op, B, v["s1"], lit("MAIL"))
        out[f"lit_left_{op}"] = E.call(op, B, lit("MAIL"), v["s1"])
        out[f"same_dict_{op}"] = E.call(op, B, v["s1"], v["s3"])
    out["remap_eq"] = E.call("eq", B, v["s1"], v["s2"])
    out["remap_neq"] = E.call("neq", B, v["s2"], v["s1"])
    out["lit_missing"] = E.call("eq", B, v["s2"], lit("NOPE"))
    out["between"] = E.call("between", B, v["s1"], lit("B"), lit("S"))
    for i, pat in enumerate(("%AI%", "M_IL", "%", "R%", "%R", "a%", "")):
        out[f"like_{i}"] = E.call("like", B, v["s1"], E.constant(pat, V))
    out["not_like"] = E.call("not", B, E.call("like", B, v["s2"],
                                              E.constant("PROMO%", V)))
    out["in"] = E.special("IN", B, v["s1"], lit("MAIL"), lit("SHIP"),
                          lit("XX"))
    out["in_null_const"] = E.special("IN", B, v["s2"], lit("AIR"),
                                     E.constant(None, V))
    out["substr_2_2"] = E.call("substr", V, v["s1"], E.constant(2, T.BIGINT),
                               E.constant(2, T.BIGINT))
    out["substr_neg"] = E.call("substr", V, v["s2"],
                               E.constant(-3, T.BIGINT))
    out["substr_eq"] = E.call("eq", B, E.call(
        "substr", V, v["s1"], E.constant(1, T.BIGINT),
        E.constant(1, T.BIGINT)), lit("R"))
    out["upper_lower"] = E.call("upper", V, E.call("lower", V, v["s2"]))
    out["replace"] = E.call("replace", V, v["s1"], lit("AI"), lit("-"))
    out["split_part"] = E.call("split_part", V, v["s1"], lit(" "),
                               E.constant(2, T.BIGINT))
    out["length"] = E.call("length", T.BIGINT, v["s1"])
    out["strpos"] = E.call("strpos", T.BIGINT, v["s2"], lit("A"))
    out["starts_with"] = E.call("starts_with", B, v["s1"], lit("R"))
    out["if_merge"] = E.special("IF", V, E.call("gt", B, v["i"],
                                                E.constant(0, T.BIGINT)),
                                v["s1"], v["s2"])
    out["if_literals"] = E.special("IF", V, E.call("eq", B, v["s1"],
                                                   lit("AIR")),
                                   lit("yes"), E.constant(None, V))
    out["if_cmp"] = E.call("eq", B, E.special(
        "IF", V, E.call("lt", B, v["i"], E.constant(0, T.BIGINT)),
        lit("MAIL"), v["s2"]), v["s1"])
    out["is_null"] = E.special("IS_NULL", B, v["s2"])
    out["nullif_int_double"] = E.special("NULL_IF", T.BIGINT, v["i"], v["f"])
    out["nullif_double_int"] = E.special("NULL_IF", T.DOUBLE, v["f"], v["i"])
    out["cast_double_integer"] = E.call("cast", T.INTEGER, v["f"])
    out["cast_double_bigint"] = E.call("cast", T.BIGINT, v["f"])
    out["in_null_int"] = E.special("IN", B, v["i"], E.constant(1, T.BIGINT),
                                   E.constant(None, T.BIGINT),
                                   E.constant(3, T.BIGINT))
    out["in_null_double"] = E.special("IN", B, v["f"],
                                      E.constant(1.0, T.DOUBLE),
                                      E.constant(None, T.DOUBLE))
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


def _decoded(values, dictionary):
    return [dictionary[int(c)] for c in values]


@pytest.mark.parametrize("case", CASES)
def test_opcode_equals_reference_lowering(batches, case):
    jb, tb = batches
    jcol = JLowering().eval(_exprs(JE, JT)[case], jb)
    tcol = tlow.Lowering().eval(_exprs(TE, TT)[case], tb)
    jn = np.asarray(jcol.null_mask())
    np.testing.assert_array_equal(tcol.null_mask().numpy(), jn)
    live = ~jn
    jv, tv = np.asarray(jcol.values), tcol.values.numpy()
    if jcol.dictionary is not None:
        assert tcol.dictionary == tuple(jcol.dictionary)
        assert _decoded(tv[live], tcol.dictionary) == \
            _decoded(jv[live], jcol.dictionary)
    elif jv.dtype == np.bool_:
        np.testing.assert_array_equal(tv.astype(bool)[live], jv[live])
    elif jv.dtype.kind == "f":
        np.testing.assert_array_equal(tv[live], jv[live])
    else:
        np.testing.assert_array_equal(tv[live].astype(np.int64),
                                      jv[live].astype(np.int64))


def test_opcodes_are_the_torch_interpreters_alone():
    """Every case compiles to at least one opcode past the kernels' set,
    except IS_NULL of a varchar and the numeric IN lists with a NULL
    (IN_I / IN_F over the other constants)."""
    exprs = _exprs(TE, TT)
    for case in CASES:
        prog = tlow.compile_expr(exprs[case])
        extra = {tlow.OPS[op] for op, _ in prog.ops
                 if op not in tlow.KERNEL_OPS}
        assert bool(extra) == (case not in ("is_null", "in_null_int",
                                            "in_null_double")), case


@pytest.mark.parametrize("sql,opcode", [
    ("select count(*) from lineitem where l_shipmode = 'MAIL'", "CONST_S"),
    ("select l_returnflag, count(*) from lineitem "
     "where l_shipinstruct like 'DELIVER%' group by l_returnflag", "MAP_S"),
    ("select sum(cast(cast(l_quantity as double) as bigint)) "
     "from lineitem", "F2I")], ids=["cmp", "like", "f2i"])
def test_kernel_plan_build_declines_naming_the_opcode(monkeypatch, sql,
                                                      opcode):
    from presto_tpu_torch.exec.kernels import scan_kernel as sk
    from presto_tpu_torch.exec.runner import LocalQueryRunner
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


def test_fold_tables_are_cached_per_dictionary(batches):
    """A chunk's lookup folds nothing: the per-code tables are built once
    per (spec, dictionary) and reused."""
    _jb, tb = batches
    e = _exprs(TE, TT)["like_0"]
    low = tlow.Lowering()
    low.eval(e, tb)
    n = len(tlow._FOLDS)
    low.eval(e, tb)
    assert len(tlow._FOLDS) == n


def test_scaled_decimal_divide():
    """A decimal divide whose numerator scales up (DIVQS_I): the
    reference's rows where its int64 rescale does not wrap, and the exact
    quotient (rounded half away from zero) where it would -- TPC-H Q14's
    100.00 * sum / sum at SF10."""
    def expr(E, T):
        return E.call("divide", T.DecimalType(38, 6),
                      E.variable("a", T.DecimalType(38, 6)),
                      E.variable("b", T.DecimalType(38, 4)))
    rng = np.random.default_rng(5)
    a = rng.integers(-10 ** 11, 10 ** 11, 500)
    b = rng.integers(-10 ** 6, 10 ** 6, 500)
    b[:3] = 0
    an = rng.random(500) < 0.1
    jb = JBatch({"a": JColumn(jnp.asarray(a), jnp.asarray(an)),
                 "b": JColumn(jnp.asarray(b))}, jnp.ones(500, dtype=bool))
    tb = TBatch({"a": TColumn(torch.from_numpy(a), torch.from_numpy(an)),
                 "b": TColumn(torch.from_numpy(b))},
                torch.ones(500, dtype=torch.bool))
    jcol = JLowering().eval(expr(JE, JT), jb)
    tcol = tlow.Lowering().eval(expr(TE, TT), tb)
    jn = np.asarray(jcol.null_mask())
    np.testing.assert_array_equal(tcol.null_mask().numpy(), jn)
    np.testing.assert_array_equal(tcol.values.numpy()[~jn],
                                  np.asarray(jcol.values)[~jn])
    assert "DIVQS_I" in {tlow.OPS[op] for op, _ in
                         tlow.compile_expr(expr(TE, TT)).ops}
    # 4.5e17 x 10**4 passes int64: exact here
    big = TBatch({"a": TColumn(torch.tensor([450000000000000007,
                                             -450000000000000007])),
                  "b": TColumn(torch.tensor([270000000000000,
                                             270000000000000]))},
                 torch.ones(2, dtype=torch.bool))
    got = tlow.Lowering().eval(expr(TE, TT), big).values.tolist()
    want = [(450000000000000007 * 10 ** 4 + 135000000000000)
            // 270000000000000]
    assert got == [want[0], -want[0]]
