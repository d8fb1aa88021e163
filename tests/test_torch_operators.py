"""Operators, batches and memory accounting of the port against the
reference package: direct-slot aggregation (with NULL, boolean and float
inputs), the decimal average, sort permutations, compaction, page <->
batch conversion and the memory pool / context accounting."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import presto_tpu.common.types as JT
from presto_tpu.exec import batch as jbatch
from presto_tpu.exec import memory as jmem
from presto_tpu.exec import operators as jops
import presto_tpu_torch.common.types as TT
from presto_tpu_torch.exec import batch as tbatch
from presto_tpu_torch.exec import memory as tmem
from presto_tpu_torch.exec import operators as tops
from torch_threads import one_torch_thread  # noqa: F401

N = 400


def _inputs(seed: int, G: int):
    rng = np.random.default_rng(seed)
    return {
        "codes": rng.integers(0, G, N).astype(np.int64),
        "mask": rng.random(N) < 0.8,
        "i": rng.integers(-10 ** 9, 10 ** 9, N).astype(np.int64),
        "i_nulls": rng.random(N) < 0.25,
        "f": rng.normal(0, 1e3, N),
        "f_nulls": rng.random(N) < 0.25,
        "b": rng.random(N) < 0.5,
    }


def _specs(ops):
    S = ops.AggSpec
    return (S("count_star", "cs"), S("count", "ci"), S("sum", "si"),
            S("avg", "ai"), S("min", "mi"), S("max", "xi"),
            S("sum", "sf", True), S("avg", "af", True), S("min", "mf", True),
            S("max", "xf", True), S("sum", "sb"), S("max", "xb"))


def _agg_inputs(d, mk_col):
    i = mk_col(d["i"], d["i_nulls"])
    f = mk_col(d["f"], d["f_nulls"])
    b = mk_col(d["b"], None)
    return {"cs": None, "ci": i, "si": i, "ai": i, "mi": i, "xi": i,
            "sf": f, "af": f, "mf": f, "xf": f, "sb": b, "xb": b}


@pytest.mark.parametrize("G", [1, 6, 64])
def test_direct_aggregation_matches_reference(G):
    d = _inputs(G, G)
    jspecs, tspecs = _specs(jops), _specs(tops)
    jst = jops.agg_direct_init(G, jspecs)
    jb = jbatch.Batch({}, jnp.asarray(d["mask"]))
    jcol = lambda v, n: jbatch.Column(jnp.asarray(v),
                                      None if n is None else jnp.asarray(n))
    tst = tops.agg_direct_init(G, tspecs, "cpu")
    tb = tbatch.Batch({}, torch.from_numpy(d["mask"]))
    tcol = lambda v, n: tbatch.Column(torch.from_numpy(v.copy()),
                                      None if n is None
                                      else torch.from_numpy(n.copy()))
    for half in (slice(0, N // 2), slice(N // 2, N)):
        part = {k: v[half] for k, v in d.items()}
        jst = jops.agg_direct_update(
            jst, jbatch.Batch({}, jnp.asarray(part["mask"])),
            jnp.asarray(part["codes"]), _agg_inputs(part, jcol), jspecs, G)
        tst = tops.agg_direct_update(
            tst, tbatch.Batch({}, torch.from_numpy(part["mask"].copy())),
            torch.from_numpy(part["codes"].copy()),
            _agg_inputs(part, tcol), tspecs, G)
    assert list(tst) == list(jst)
    for k in jst:
        want, got = np.asarray(jst[k]), tst[k].numpy()
        if want.dtype == np.float64:
            np.testing.assert_allclose(got, want, rtol=1e-12, err_msg=k)
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)
    doms = (G,) if G > 1 else ()
    keys = ("k",) if G > 1 else ()
    jout = jops.agg_direct_finalize(jst, jspecs, keys, doms, (jnp.int32,),
                                    {}, force_row=not keys)
    tout = tops.agg_direct_finalize(tst, tspecs, keys, doms, (torch.int32,),
                                    {}, force_row=not keys)
    np.testing.assert_array_equal(tout.mask.numpy(), np.asarray(jout.mask))
    for name, jc in jout.columns.items():
        tc = tout.columns[name]
        jv, tv = np.asarray(jc.values), tc.values.numpy()
        live = ~np.asarray(jc.null_mask())
        np.testing.assert_array_equal(tc.null_mask().numpy(), ~live)
        if jv.dtype == np.float64:
            np.testing.assert_allclose(tv[live], jv[live], rtol=1e-12)
        else:
            np.testing.assert_array_equal(tv[live].astype(np.int64),
                                          jv[live].astype(np.int64))


def test_decimal_avg_rounds_half_away_from_zero():
    s = np.array([5, -5, 15, -15, 7, -7, 0, 10 ** 15 + 1], dtype=np.int64)
    c = np.array([2, 2, 10, 10, 3, 3, 4, 2], dtype=np.int64)
    empty = np.array([False] * 7 + [True])
    want = np.asarray(jops._decimal_avg(jnp.asarray(s), jnp.asarray(c),
                                        jnp.asarray(empty)))
    got = tops._decimal_avg(torch.from_numpy(s), torch.from_numpy(c),
                            torch.from_numpy(empty)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("orders", [
    ("ASC_NULLS_LAST",), ("DESC_NULLS_FIRST",),
    ("ASC_NULLS_FIRST", "DESC_NULLS_LAST"), ("DESC_NULLS_LAST", "ASC_NULLS_LAST")])
def test_sort_indices_match_reference(orders):
    rng = np.random.default_rng(len(orders))
    n = 64
    dictionary = ("R", "A", "N")
    cols = {
        "k": (rng.integers(0, 3, n).astype(np.int32), None, dictionary),
        "v": (rng.integers(-5, 5, n).astype(np.int64), rng.random(n) < 0.2,
              None),
    }
    names = ("k", "v")[:len(orders)] if len(orders) == 2 else ("v",)
    keys = list(zip(names, orders))
    mask = rng.random(n) < 0.8
    jb = jbatch.Batch({k: jbatch.Column(jnp.asarray(v), None if nl is None
                                        else jnp.asarray(nl), dc)
                       for k, (v, nl, dc) in cols.items()}, jnp.asarray(mask))
    tb = tbatch.Batch({k: tbatch.Column(torch.from_numpy(v.copy()),
                                        None if nl is None
                                        else torch.from_numpy(nl.copy()), dc)
                       for k, (v, nl, dc) in cols.items()},
                      torch.from_numpy(mask.copy()))
    np.testing.assert_array_equal(tops.sort_indices(tb, keys).numpy(),
                                  np.asarray(jops.sort_indices(jb, keys)))


@pytest.mark.parametrize("out_cap", [None, 16])
def test_compact_matches_reference(out_cap):
    rng = np.random.default_rng(3)
    v = rng.integers(0, 100, 40).astype(np.int64)
    nl = rng.random(40) < 0.3
    mask = rng.random(40) < 0.5
    jb = jops.compact(jbatch.Batch({"v": jbatch.Column(
        jnp.asarray(v), jnp.asarray(nl))}, jnp.asarray(mask)), out_cap)
    tb = tops.compact(tbatch.Batch({"v": tbatch.Column(
        torch.from_numpy(v), torch.from_numpy(nl))},
        torch.from_numpy(mask)), out_cap)
    live = np.asarray(jb.mask)
    np.testing.assert_array_equal(tb.mask.numpy(), live)
    np.testing.assert_array_equal(tb.columns["v"].values.numpy()[live],
                                  np.asarray(jb.columns["v"].values)[live])
    np.testing.assert_array_equal(tb.columns["v"].nulls.numpy()[live],
                                  np.asarray(jb.columns["v"].nulls)[live])


def _page(T):
    from presto_tpu_torch.common.block import block_from_values as tbfv
    from presto_tpu.common.block import block_from_values as jbfv
    from decimal import Decimal
    bfv = tbfv if T is TT else jbfv
    page_mod = __import__(T.__name__.replace("types", "page"),
                          fromlist=["Page"])
    types = [T.BIGINT, T.DOUBLE, T.DecimalType(12, 2),
             T.DecimalType(38, 6), T.DATE, T.BOOLEAN, T.VarcharType(1)]
    values = [[1, None, -3], [0.5, 2.25, None],
              [Decimal("1.25"), None, Decimal("-7.00")],
              [Decimal("123456789012.123456"), Decimal("-1.000001"), None],
              [9000, 9001, None], [True, None, False], ["A", None, "N"]]
    return types, page_mod.Page([bfv(t, v) for t, v in zip(types, values)], 3)


def test_page_batch_round_trip_matches_reference():
    from presto_tpu.common.block import block_to_values as jb2v
    from presto_tpu_torch.common.block import block_to_values as tb2v
    names = [f"c{i}" for i in range(7)]
    jtypes, jpage = _page(JT)
    ttypes, tpage = _page(TT)
    jb = jbatch.page_to_batch(jpage, names, jtypes, 8)
    tb = tbatch.page_to_batch(tpage, names, ttypes, 8)
    np.testing.assert_array_equal(tb.mask.numpy(), np.asarray(jb.mask))
    for n in names:
        assert tb.columns[n].dictionary == jb.columns[n].dictionary
        np.testing.assert_array_equal(tb.columns[n].null_mask().numpy(),
                                      np.asarray(jb.columns[n].null_mask()))
    jp = jbatch.batch_to_page(jb, names, jtypes)
    tp = tbatch.batch_to_page(tb, names, ttypes)
    assert tp.position_count == jp.position_count == 3
    for jt, tt, jblk, tblk in zip(jtypes, ttypes, jp.blocks, tp.blocks):
        assert tb2v(tt, tblk) == jb2v(jt, jblk)


def test_memory_accounting_matches_reference():
    for mod in (jmem, tmem):
        pool = mod.MemoryPool(100)
        assert pool.try_reserve(60) and not pool.try_reserve(50)
        pool.free(20)
        assert pool.try_reserve(50) and pool.reserved == 90
        assert pool.peak == 90
        pool.free(1000)                      # an over-free clamps, counted
        assert pool.reserved == 0 and pool.over_free_count == 1
        ctx = mod.MemoryContext(mod.MemoryPool(None), "query", max_bytes=10)
        assert ctx.limited and ctx.try_reserve(8)
        with pytest.raises(mod.QueryMemoryLimitExceededError):
            ctx.try_reserve(5)
        ctx.free(8)
        assert ctx.reserved == 0 and ctx.peak == 8
        assert not mod.MemoryContext(mod.MemoryPool(None)).limited
