"""operators.window_batch (the path after the window kernel's declines),
TopN and Limit on the CPU against the JAX package: the conformance bank of
tests/test_window.py that the port's lowering can express through
LocalQueryRunner(device="cpu") against the JAX package's numpy oracle
(exec/reference.py, the oracle tests/test_window.py holds the bank to;
integers exact, float sum / avg / percent_rank / cume_dist within rtol
1e-12), window_batch at the operator level against the reference's XLA
window_batch with NULL arguments and every frame kind (the bank's CASE is
not in the port's lowering), topn and limit at the operator level, and
ORDER BY ... LIMIT over TPC-H Q1 and S1 and a plain LIMIT at the query
level against the reference's XLA scans."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presto_tpu.exec import batch as jb
from presto_tpu.exec import operators as jops
from presto_tpu.exec.pipeline import tuned_config as jtuned
from presto_tpu.exec.runner import LocalQueryRunner as JRunner
from presto_tpu.exec.runner import _assert_rows_equal
from presto_tpu.serving import PlanCache as JPlanCache
from presto_tpu_torch.benchmarks import window_queries as WQ
from presto_tpu_torch.benchmarks.grouped_queries import S1
from presto_tpu_torch.benchmarks.tpch_queries import Q1
from presto_tpu_torch.exec import operators as ops
from presto_tpu_torch.exec.batch import Batch, Column
from presto_tpu_torch.exec.runner import LocalQueryRunner
from torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-12


@pytest.fixture(scope="module")
def xla():
    return JRunner("sf0.01", config=jtuned(scan_kernel="xla"),
                   plan_cache=JPlanCache())


@pytest.fixture(scope="module")
def port():
    return LocalQueryRunner("sf0.01", device="cpu")


def _assert_close_rows(got, exp):
    """Rows equal after sorting: every non-float value exactly, floats
    within RTOL (another association of the same float sums)."""
    g, e = got.sorted_rows(), exp.sorted_rows()
    assert len(g) == len(e)
    assert got.column_names == exp.column_names
    for rg, re_ in zip(g, e):
        for a, b in zip(rg, re_):
            if isinstance(a, float) or isinstance(b, float):
                assert (a is None) == (b is None), (rg, re_)
                assert a is None or a == b or abs(a - b) <= RTOL * max(
                    abs(a), abs(b)), (rg, re_)
            else:
                assert a == b, (rg, re_)


@pytest.mark.parametrize("name", sorted(WQ.SHAPES))
def test_window_shape_bank(port, xla, name):
    # the oracle compiles nothing: one XLA program per shape would cost
    # more than the rest of the file
    sql = WQ.SHAPES[name]
    _assert_close_rows(port.execute(sql), xla.execute_reference(sql))


# ---------------------------------------------------------------------------
# operator level: NULL arguments, min / max over a dictionary column
# ---------------------------------------------------------------------------

DICT = ("b", "a", "d", "c")


def _null_batches(seed: int, n: int):
    rng = np.random.default_rng(seed)
    cols = {
        "k": (rng.integers(0, 7, n).astype(np.int64), None, None),
        "o": (rng.permutation(n).astype(np.int64), None, None),
        "v": (rng.integers(-10 ** 6, 10 ** 6, n).astype(np.int64),
              rng.random(n) < 0.3, None),
        "f": (rng.random(n) * 100, rng.random(n) < 0.2, None),
        "s": (rng.integers(0, len(DICT), n).astype(np.int32),
              rng.random(n) < 0.1, DICT),
    }
    live = rng.random(n) >= 0.15
    tb = Batch({k: Column(torch.from_numpy(v),
                          None if nl is None else torch.from_numpy(nl), d)
                for k, (v, nl, d) in cols.items()}, torch.from_numpy(live))
    jbatch = jb.Batch({k: jb.Column(jnp.asarray(v),
                                    None if nl is None else jnp.asarray(nl),
                                    d)
                       for k, (v, nl, d) in cols.items()}, jnp.asarray(live))
    return tb, jbatch


_NULL_SPECS = [
    ("sum", "v", False, None, ()), ("count", "v", False, None, ()),
    ("avg", "v", False, None, ()), ("sum", "f", True, None, ()),
    ("avg", "f", True, None, ()), ("min", "v", False,
                                   ("ROWS", "PRECEDING", 2, "CURRENT", None),
                                   ()),
    ("max", "s", False, ("ROWS", "PRECEDING", 3, "FOLLOWING", 1), ()),
    ("min", "f", True, None, ()),
    ("lag", "v", False, None, (2, -1)), ("lead", "s", False, None, ()),
    ("first_value", "f", True, None, ()),
    ("sum", "v", False, ("ROWS", "FOLLOWING", 1, "FOLLOWING", 3), ()),
    ("count_star", None, False, ("RANGE", "CURRENT", None,
                                 "UNBOUNDED_FOLLOWING", None), ()),
    ("ntile", None, False, None, (3,)), ("percent_rank", None, True, None,
                                         ()),
    ("cume_dist", None, True, None, ()),
]


_NULL_ORDERINGS = (("o", "ASC_NULLS_LAST"),)
# one compiled program for every seed, not one compile per operation and
# shape
_jwindow_batch = jax.jit(lambda b: jops.window_batch(
    b, ("k",), _NULL_ORDERINGS,
    tuple(jops.WindowSpec(n, f"w{i}", a, fl, fr, ex)
          for i, (n, a, fl, fr, ex) in enumerate(_NULL_SPECS))))


@pytest.mark.parametrize("seed", [61, 62])
def test_window_batch_null_arguments(seed):
    tb, jbatch = _null_batches(seed, 600)
    tspecs = tuple(ops.WindowSpec(n, f"w{i}", a, fl, fr, ex)
                   for i, (n, a, fl, fr, ex) in enumerate(_NULL_SPECS))
    got = ops.window_batch(tb, ("k",), _NULL_ORDERINGS, tspecs)
    exp = _jwindow_batch(jbatch)
    mask = got.mask.numpy()
    assert np.array_equal(mask, np.asarray(exp.mask))
    for s in tspecs:
        g, e = got.columns[s.output], exp.columns[s.output]
        gn = g.null_mask().numpy()[mask]
        en = np.asarray(e.null_mask())[mask]
        assert np.array_equal(gn, en), s
        gv = g.values.numpy()[mask][~gn]
        ev = np.asarray(e.values)[mask][~en]
        if gv.dtype.kind == "f":
            np.testing.assert_allclose(gv, ev, rtol=RTOL, atol=0)
        else:
            assert np.array_equal(gv, ev), s
        assert g.dictionary == e.dictionary, s


# ---------------------------------------------------------------------------
# TopN and Limit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("keys,n", [
    ((("k", "ASC_NULLS_LAST"), ("o", "DESC_NULLS_LAST")), 25),
    ((("s", "DESC_NULLS_FIRST"), ("o", "ASC_NULLS_LAST")), 40),
    ((("f", "ASC_NULLS_FIRST"),), 10),
    ((("v", "DESC_NULLS_LAST"),), 1000),
], ids=["int_keys", "dictionary_desc", "float_nulls_first", "n_over_rows"])
def test_topn_matches_reference(keys, n):
    tb, jbatch = _null_batches(63, 300)
    got = ops.topn(tb, list(keys), n)
    exp = jops.topn(jbatch, list(keys), n)
    assert np.array_equal(got.mask.numpy(), np.asarray(exp.mask))
    for name in tb.columns:
        assert np.array_equal(got.columns[name].values.numpy(),
                              np.asarray(exp.columns[name].values)), name
        assert np.array_equal(got.columns[name].null_mask().numpy(),
                              np.asarray(exp.columns[name].null_mask()))


def test_limit_matches_reference_across_batches():
    tconsumed = torch.zeros((), dtype=torch.int64)
    jconsumed = jnp.zeros((), dtype=jnp.int64)
    for seed in (64, 65, 66):
        tb, jbatch = _null_batches(seed, 50)
        got, tconsumed = ops.limit(tb, 90, tconsumed)
        exp, jconsumed = jops.limit(jbatch, 90, jconsumed)
        assert np.array_equal(got.mask.numpy(), np.asarray(exp.mask))
        assert int(tconsumed) == int(jconsumed)


@pytest.mark.parametrize("sql", [
    Q1.strip().rstrip(";") + "\nlimit 3",
    S1.replace("order by l_returnflag, l_linestatus, l_shipmode, "
               "l_shipinstruct",
               "order by count_order desc, l_shipmode, l_shipinstruct, "
               "l_returnflag, l_linestatus limit 10"),
    "select o_orderkey, o_totalprice from orders "
    "order by o_totalprice desc, o_orderkey limit 17",
], ids=["q1", "s1", "orders_scan"])
def test_order_by_limit_queries(port, xla, sql):
    got = port.execute(sql)
    exp = xla.execute(sql)
    _assert_rows_equal(got, exp, ordered=True)
    assert got.rows


def test_limit_query_stops_early(port):
    full = port.execute("select l_orderkey, l_linenumber from lineitem "
                        "where l_quantity < 3")
    got = port.execute("select l_orderkey, l_linenumber from lineitem "
                       "where l_quantity < 3 limit 7")
    assert len(got.rows) == 7
    rows = {tuple(r) for r in full.rows}
    assert all(tuple(r) in rows for r in got.rows)
