"""The scan kernels' expression set against the reference's.

Each opcode of exec/lowering.py that the reference's kernels run through
presto_tpu/exec/lowering.py -- negate, abs, year / month / day /
quarter, divide and modulus in the integer, decimal and double domains,
the numeric casts, IS_NULL, IF, COALESCE, NULL_IF and IN -- goes through
the port's torch evaluator (the CPU path and the kernels' plain
versions) and through the reference's Lowering.eval on the same numpy
inputs, made from a seed: with NULLs, zero divisors, negative operands,
dates before 1970, the INT32 wrap and decimal scales 0-4.  Integers
equal, floats equal bit for bit (NaN where the reference's is NaN).

Then the queries on which the reference's scan kernel ran and the port
used to decline, through LocalQueryRunner at sf0.01: rows equal to the
JAX package's, one kernelScanPrograms and no decline on both sides.  And
the varchar predicates, which neither package's kernel runs: a metered
PlanShape decline naming the opcode, then the torch fused chain with the
reference's rows; a form the port still lacks raises naming it."""
import zlib
from decimal import Decimal

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import presto_tpu.common.types as JT
import presto_tpu.spi.expr as JE
from presto_tpu.exec.batch import Batch as JBatch, Column as JColumn
from presto_tpu.exec.lowering import Lowering as JLowering
from presto_tpu.exec.pipeline import tuned_config as jtuned
from presto_tpu.exec.runner import LocalQueryRunner as JRunner
from presto_tpu.exec.runner import _assert_rows_equal
from presto_tpu.serving import PlanCache as JPlanCache
import presto_tpu_torch.common.types as TT
import presto_tpu_torch.spi.expr as TE
from presto_tpu_torch.exec.batch import Batch as TBatch, Column as TColumn
from presto_tpu_torch.exec.lowering import Lowering as TLowering
from presto_tpu_torch.exec.lowering import OP, compile_expr
from presto_tpu_torch.benchmarks.expr_queries import QUERIES
from presto_tpu_torch.exec.runner import LocalQueryRunner
from torch_threads import one_torch_thread  # noqa: F401

N = 600
INT32_MIN = -2 ** 31


def _schema(T):
    D = T.DecimalType
    return {"d0": D(10, 0), "d1": D(11, 1), "d2": D(12, 2), "d3": D(13, 3),
            "d4": D(15, 4), "i": T.BIGINT, "j": T.BIGINT, "n": T.INTEGER,
            "m": T.INTEGER, "dt": T.DATE, "f": T.DOUBLE, "g": T.DOUBLE,
            "b": T.BOOLEAN}


def _exprs(E, T):
    """Named expressions over one package's spi and types."""
    v = {n: E.variable(n, t) for n, t in _schema(T).items()}
    c, sp, k = E.call, E.special, E.constant
    D, B = T.DecimalType, T.BOOLEAN
    out = {
        "neg_bigint": c("negate", T.BIGINT, v["i"]),
        "neg_int32_wraps": c("negate", T.INTEGER, v["n"]),
        "neg_dec": c("negate", D(12, 2), v["d2"]),
        "neg_double": c("negate", T.DOUBLE, v["f"]),
        "abs_bigint": c("abs", T.BIGINT, v["i"]),
        "abs_int32_wraps": c("abs", T.INTEGER, v["n"]),
        "abs_dec": c("abs", D(15, 4), v["d4"]),
        "abs_double": c("abs", T.DOUBLE, v["f"]),
        "div_bigint": c("divide", T.BIGINT, v["i"], v["j"]),
        "mod_bigint": c("modulus", T.BIGINT, v["i"], v["j"]),
        "div_int32": c("divide", T.INTEGER, v["n"], v["m"]),
        "mod_int32": c("modulus", T.INTEGER, v["n"], v["m"]),
        "div_bigint_int32": c("divide", T.BIGINT, v["i"], v["m"]),
        "mod_const": c("modulus", T.BIGINT, v["i"], k(5, T.INTEGER)),
        "div_double": c("divide", T.DOUBLE, v["f"], v["g"]),
        "mod_double": c("modulus", T.DOUBLE, v["f"], v["g"]),
        "div_double_dec": c("divide", T.DOUBLE, v["d2"], k(3, T.INTEGER)),
        "mod_double_dec": c("modulus", T.DOUBLE, v["f"], v["d1"]),
        "cast_double_div_3": c("divide", T.DOUBLE,
                               c("cast", T.DOUBLE, v["d2"]),
                               k(3, T.INTEGER)),
        "cast_double_dec2": c("cast", D(12, 2), v["f"]),
        "cast_double_dec0": c("cast", D(10, 0), v["f"]),
        "cast_dec_int_unscaled": c("cast", T.INTEGER, v["d2"]),
        "cast_bigint_dec": c("cast", D(18, 3), v["i"]),
        "is_null_bigint": sp("IS_NULL", B, v["i"]),
        "is_null_divide": sp("IS_NULL", B,
                             c("divide", T.BIGINT, v["i"], v["j"])),
        "not_null_double": c("not", B, sp("IS_NULL", B, v["f"])),
        "if_bigint": sp("IF", T.BIGINT, v["b"], v["i"], v["j"]),
        "if_null_else": sp("IF", D(12, 2), c("gt", B, v["d2"], v["d4"]),
                           v["d2"], k(None, D(12, 2))),
        "if_double_int_branch": sp("IF", T.DOUBLE, c("lt", B, v["i"], v["j"]),
                                   v["f"], v["i"]),
        "case_nested": sp("IF", T.BIGINT, c("gt", B, v["i"], v["j"]), v["i"],
                          sp("IF", T.BIGINT, v["b"], v["j"],
                             k(0, T.BIGINT))),
        "coalesce_bigint": sp("COALESCE", T.BIGINT, v["i"], v["j"],
                              k(7, T.BIGINT)),
        "coalesce_double": sp("COALESCE", T.DOUBLE, v["f"], v["g"]),
        "coalesce_dec_int": sp("COALESCE", D(12, 2), v["d2"],
                               k(0, T.INTEGER)),
        "coalesce_call": c("coalesce", T.BIGINT, v["i"], v["j"]),
        "nullif_bigint": sp("NULL_IF", T.BIGINT, v["i"], v["j"]),
        "nullif_double": sp("NULL_IF", T.DOUBLE, v["f"], v["g"]),
        "nullif_dec_zero": sp("NULL_IF", D(12, 2), v["d2"], k(0, T.INTEGER)),
        "in_bigint": sp("IN", B, v["i"], k(1, T.BIGINT), k(-3, T.BIGINT),
                        k(0, T.BIGINT)),
        "in_dec_ints_unscaled": sp("IN", B, v["d2"], k(1, T.INTEGER),
                                   k(2, T.INTEGER), k(-5, T.INTEGER)),
        "in_dec_decimals": sp("IN", B, v["d2"], k(Decimal("0.05"), D(3, 2)),
                              k(Decimal("-0.25"), D(3, 2))),
        "in_double": sp("IN", B, v["f"], k(0.5, T.DOUBLE),
                        k(-1.25, T.DOUBLE)),
        "in_int_double_const": sp("IN", B, v["i"], k(2.0, T.DOUBLE),
                                  k(0.5, T.DOUBLE)),
        "in_date": sp("IN", B, v["dt"], k("1969-12-31", T.DATE),
                      k("1995-03-01", T.DATE)),
        "not_in_int32": c("not", B, sp("IN", B, v["n"], k(0, T.INTEGER),
                                        k(INT32_MIN, T.INTEGER))),
    }
    for part in ("year", "month", "day", "quarter"):
        out[part] = c(part, T.BIGINT, v["dt"])
    for s in range(5):           # decimal divide / modulus at scales 0-4
        ds = f"d{s}"
        out[f"div_dec_s{s}"] = c("divide", D(38, s), v["d2"], v[ds])
        out[f"div_dec_by_bigint_s{s}"] = c("divide", D(38, s), v[ds],
                                           v["j"])
        out[f"mod_dec_s{s}"] = c("modulus", D(38, max(s, 2)), v["d2"],
                                 v[ds])
    return out


def _data(seed: int, with_nulls: bool):
    rng = np.random.default_rng(seed)

    def ints(lo, hi, zeros=0.0, dtype=np.int64):
        x = rng.integers(lo, hi, N).astype(dtype)
        x[rng.random(N) < zeros] = 0
        return x
    vals = {
        "d0": ints(-10 ** 4, 10 ** 4, 0.1),
        "d1": ints(-10 ** 5, 10 ** 5, 0.1),
        "d2": ints(-10 ** 6, 10 ** 6, 0.05),
        "d3": ints(-10 ** 7, 10 ** 7, 0.1),
        "d4": ints(-10 ** 8, 10 ** 8, 0.1),
        "i": ints(-50, 50, 0.05),
        "j": ints(-7, 8, 0.15),
        "n": ints(-2 ** 31, 2 ** 31 - 1, 0.0, np.int32),
        "m": ints(-9, 10, 0.15, np.int32),
        # days since 1970-01-01: before and after the epoch, and before
        # year 0 (z < 0 in the civil algorithm)
        "dt": ints(-800000, 40000, 0.0, np.int32),
        "f": np.round(rng.normal(0, 300, N), 2),
        "g": np.round(rng.normal(0, 20, N), 1),
        "b": rng.integers(0, 2, N).astype(bool),
    }
    vals["n"][:4] = [INT32_MIN, INT32_MIN, 2 ** 31 - 1, -1]
    vals["m"][:4] = [-1, 3, -1, INT32_MIN]
    vals["i"][:4] = [-7, 7, -7, 7]
    vals["j"][:4] = [2, -2, -2, 2]
    vals["d2"][:6] = [5, -5, 15, -15, 250, -250]     # rounding ties
    vals["d0"][:6] = [2, 2, -2, -2, 100, 100]
    vals["f"][:6] = [0.5, -0.5, 1.5, -2.5, 7.0, -7.0]
    vals["g"][:6] = [0.0, 2.0, -2.0, 0.0, 3.0, -3.0]
    vals["dt"][:6] = [0, -1, -719468, -719469, 9131, 11016]
    nulls = {n: (rng.random(N) < 0.2) if with_nulls else None for n in vals}
    mask = rng.random(N) < 0.9
    return vals, nulls, mask


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


@pytest.mark.parametrize("with_nulls", [True, False],
                         ids=["nulls", "no_nulls"])
@pytest.mark.parametrize("name", NAMES)
def test_op_matches_reference_eval(name, with_nulls):
    vals, nulls, mask = _data(zlib.crc32(name.encode()), with_nulls)
    jcol = JLowering().eval(_exprs(JE, JT)[name],
                            _jax_batch(vals, nulls, mask))
    tcol = TLowering().eval(_exprs(TE, TT)[name],
                            _torch_batch(vals, nulls, mask))
    jv, tv = np.asarray(jcol.values), tcol.values.numpy()
    np.testing.assert_array_equal(tcol.null_mask().numpy(),
                                  np.asarray(jcol.null_mask()))
    if jv.dtype == np.float64 or tv.dtype == np.float64:
        assert tv.dtype == np.float64 and jv.dtype == np.float64
        nan = np.isnan(jv)
        np.testing.assert_array_equal(np.isnan(tv), nan)
        np.testing.assert_array_equal(tv[~nan].view(np.int64),
                                      jv[~nan].view(np.int64))
    elif jv.dtype == np.bool_ or tv.dtype == np.bool_:
        np.testing.assert_array_equal(tv.astype(bool), jv.astype(bool))
    else:
        np.testing.assert_array_equal(tv.astype(np.int64),
                                      jv.astype(np.int64))


@pytest.mark.parametrize("name,nullable", [
    ("div_bigint", True), ("mod_const", True), ("nullif_bigint", True),
    ("if_null_else", True), ("is_null_divide", False), ("neg_dec", False),
    ("coalesce_dec_int", False), ("in_bigint", False), ("year", False)])
def test_program_nullability(name, nullable):
    """ExprProgram.nullable over NULL-free columns follows the reference's
    static rule (a divide or NULL_IF always carries a mask); it decides
    whether an aggregate's row count can be copied from __seen."""
    assert compile_expr(_exprs(TE, TT)[name]).nullable is nullable


def test_in_list_constants_follow_the_instruction():
    prog = compile_expr(_exprs(TE, TT)["in_bigint"])
    ops = [op for op, _ in prog.ops]
    at = ops.index(OP["IN_I"])
    assert prog.ops[at][1] == 3 and ops[at + 1:] == [OP["LIT"]] * 3
    assert [a for _, a in prog.ops[at + 1:]] == [1, -3, 0]
    assert prog.depth == 1


# -- through the runner ------------------------------------------------------



def _programs(res) -> int:
    return int((res.runtime_stats or {}).get(
        "kernelScanPrograms", {}).get("sum", 0))


def _declined(res):
    return [k for k in res.runtime_stats if k.startswith("kernelDeclined")]


@pytest.fixture(scope="module")
def ref():
    return JRunner("sf0.01", config=jtuned(scan_kernel="pallas"),
                   plan_cache=JPlanCache())


@pytest.fixture(scope="module")
def port():
    return LocalQueryRunner("sf0.01", device="cpu")


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_query_runs_in_the_kernel_like_the_reference(ref, port, name):
    sql = QUERIES[name]
    exp = ref.execute(sql)
    got = port.execute(sql)
    _assert_rows_equal(got, exp, ordered=False)
    assert got.column_names == exp.column_names
    assert _programs(exp) == 1 and not _declined(exp)
    assert _programs(got) == 1 and not _declined(got), got.runtime_stats


@pytest.mark.parametrize("sql,names", [
    ("select sum(ln(l_extendedprice)) from lineitem", "FN_F"),
    ("select sum(l_quantity) from lineitem where l_returnflag = 'R'",
     "CMP_S"),
    ("select count(*) from lineitem where l_shipmode in ('MAIL', 'SHIP')",
     "MAP_S"),
], ids=["ln", "varchar_eq", "varchar_in"])
def test_unported_form_raises_naming_itself(port, sql, names):
    """ln (an FN_F opcode since the rest of the scalar function set was
    ported) and the varchar opcodes decline the kernels' plan build
    (PlanShape), and the torch chain returns the reference's rows."""
    from presto_tpu_torch.exec.kernels import scan_kernel as sk
    before = sk.KERNEL_METRICS.snapshot()["declined"].get("PlanShape", 0)
    got = port.execute(sql)
    assert sk.KERNEL_METRICS.snapshot()["declined"]["PlanShape"] == before + 1
    assert _declined(got) == ["kernelDeclinedPlanShape"]
    # the reference's Pallas kernel captures the varchar truth table as a
    # constant and raises: its XLA chain computes these rows
    xla = JRunner("sf0.01", config=jtuned(scan_kernel="xla"),
                  plan_cache=JPlanCache())
    _assert_rows_equal(got, xla.execute(sql), ordered=False)
