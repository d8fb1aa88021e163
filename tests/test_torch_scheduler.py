"""The distributed scheduler's host functions in the port
(presto_tpu_torch/exec/scheduler.py, exec/batch.py pages_to_batches,
exec/operators.py agg_merge, exec/grouped.py stage_shards_lifespans,
parallel/fabric.py) held to the reference's, bit for bit, on seeded
numpy pages with ints, decimals, doubles, dates, dictionary and flat
varchars and NULLs:

  * partition_targets and _fnv1a64_rows (the exchange's row routing);
  * split_page, and OutputBuffers.materialize: the shuffle files' bytes;
  * merge_node_stats and _summarize_page_block;
  * pages_to_batches: every batch's codes, NULL masks and union
    dictionaries (the port's vectorized union against the reference's
    row loop), the numeric columns, the masks;
  * agg_merge on small sum / count / min / max / avg, moment and HLL
    states (the reference tests' shapes);
  * stage_shards_lifespans on the reference test's plans;
  * resolve_fabric's decision table (the reference test's cases)."""
import os

import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401

ROWS = 700


def _package(name):
    """(block, page, types, scheduler) modules of one package."""
    import importlib
    return (importlib.import_module(f"{name}.common.block"),
            importlib.import_module(f"{name}.common.page"),
            importlib.import_module(f"{name}.common.types"),
            importlib.import_module(f"{name}.exec.scheduler"))


PORT = "presto_tpu_torch"
REF = "presto_tpu"


def _strings(rng, n, pool):
    return [None if rng.random() < 0.1 else pool[int(rng.integers(len(pool)))]
            for _ in range(n)]


def _columns(seed: int, n: int = ROWS):
    """One page's columns as plain numpy / Python data, from a seed."""
    rng = np.random.default_rng(seed)
    pool = [f"name#{i:03d}" for i in range(40)] + ["", "déjà vu", "x" * 50]
    dict_entries = sorted(set(pool[int(i)] for i in rng.integers(0, len(pool), 12)))
    ids = rng.integers(0, len(dict_entries), n).astype(np.int32)
    return {
        "bigint": (rng.integers(-10**12, 10**12, n).astype(np.int64),
                   rng.random(n) < 0.1),
        "int": (rng.integers(-1000, 1000, n).astype(np.int32), None),
        "decimal": (rng.integers(-10**9, 10**9, n).astype(np.int64),
                    rng.random(n) < 0.05),
        "double": (rng.normal(size=n) * 1e3, rng.random(n) < 0.05),
        "date": (rng.integers(8000, 11000, n).astype(np.int32), None),
        "flat": _strings(rng, n, pool),
        "dict": (ids, dict_entries + [None]),
        "dict_nulls": rng.random(n) < 0.1,
    }


def _types(T):
    return [T.BIGINT, T.INTEGER, T.DecimalType(12, 2), T.DOUBLE, T.DATE,
            T.VARCHAR, T.VARCHAR]


def _page(pkg: str, cols: dict):
    B, Pg, T, _S = _package(pkg)

    def nn(m):
        return None if m is None or not m.any() else m
    ids, entries = cols["dict"]
    ids = np.where(cols["dict_nulls"], len(entries) - 1, ids).astype(np.int32)
    blocks = [
        B.FixedWidthBlock(cols["bigint"][0], nn(cols["bigint"][1])),
        B.FixedWidthBlock(cols["int"][0]),
        B.FixedWidthBlock(cols["decimal"][0], nn(cols["decimal"][1])),
        B.FixedWidthBlock(cols["double"][0], nn(cols["double"][1])),
        B.FixedWidthBlock(cols["date"][0]),
        B.VariableWidthBlock.from_strings(cols["flat"]),
        B.DictionaryBlock(ids, B.VariableWidthBlock.from_strings(entries),
                          source_id=(1, 2, 3)),
    ]
    return Pg.Page(blocks, len(ids))


def _pages(pkg: str, seeds=(1, 2, 3)):
    return [_page(pkg, _columns(s)) for s in seeds]


@pytest.mark.parametrize("keys", [[0], [5], [6], [0, 6], [2, 5, 3],
                                  [1, 4]],
                         ids=["bigint", "flat", "dict", "bigint-dict",
                              "decimal-flat-double", "int-date"])
@pytest.mark.parametrize("n_parts", [2, 3, 7])
def test_partition_targets_bit_for_bit(keys, n_parts):
    _b, _p, jT, jS = _package(REF)
    _b, _p, tT, tS = _package(PORT)
    for jpage, tpage in zip(_pages(REF), _pages(PORT)):
        want = jS.partition_targets(jpage, _types(jT), keys, n_parts)
        got = tS.partition_targets(tpage, _types(tT), keys, n_parts)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_fnv1a64_rows_bit_for_bit():
    jB, _p, _t, jS = _package(REF)
    tB, _p, _t, tS = _package(PORT)
    strings = ["", "a", "hello world", "x" * 200, "unicode: déjà vu", None,
               "PROMO BURNISHED"] + _columns(9)["flat"]
    want = jS._fnv1a64_rows(jB.VariableWidthBlock.from_strings(strings))
    got = tS._fnv1a64_rows(tB.VariableWidthBlock.from_strings(strings))
    assert np.array_equal(got, want)


def _block_state(b):
    """A block's arrays as plain data, for cross-package equality."""
    out = [type(b).__name__]
    for attr in ("values", "offsets", "data", "ids", "nulls"):
        v = getattr(b, attr, None)
        out.append(None if v is None else np.asarray(v).tolist())
    if hasattr(b, "dictionary"):
        out.append(_block_state(b.dictionary))
    return out


def test_split_page_bit_for_bit():
    _b, _p, jT, jS = _package(REF)
    _b, _p, tT, tS = _package(PORT)
    jpage, tpage = _pages(REF, (4,))[0], _pages(PORT, (4,))[0]
    targets = jS.partition_targets(jpage, _types(jT), [0, 5], 3)
    jparts = jS.split_page(jpage, targets, 3)
    tparts = tS.split_page(tpage, targets, 3)
    for jp, tp in zip(jparts, tparts):
        assert (jp is None) == (tp is None)
        assert jp.position_count == tp.position_count
        assert [_block_state(b) for b in jp.blocks] == \
            [_block_state(b) for b in tp.blocks]
    assert jS._page_bytes(jpage) == tS._page_bytes(tpage)


def test_output_buffers_materialize_files_equal(tmp_path):
    """The batch mode's shuffle files: the same pages routed through the
    same partitions give byte-identical files."""
    import presto_tpu.common.block as jblock
    import presto_tpu_torch.common.block as tblock
    dirs = {}
    for pkg, mod in ((REF, jblock), (PORT, tblock)):
        _b, _p, T, S = _package(pkg)
        mod._DICT_ID_COUNTER[0] = 0
        buf = S.OutputBuffers(2, 3, broadcast=False)
        for ti, page in enumerate(_pages(pkg, (5, 6))):
            targets = S.partition_targets(page, _types(T), [6, 1], 3)
            for p, sub in enumerate(S.split_page(page, targets, 3)):
                if sub is not None:
                    buf.add(ti, p, sub)
        d = tmp_path / pkg
        buf.materialize(str(d))
        dirs[pkg] = d
        got = [p.position_count for p in buf.pages_for_consumer(1)]
        assert got == [p.position_count for p in buf.pages[0][1]] \
            + [p.position_count for p in buf.pages[1][1]]
    names = sorted(os.listdir(dirs[REF]))
    assert names == sorted(os.listdir(dirs[PORT])) and len(names) == 6
    for name in names:
        assert (dirs[REF] / name).read_bytes() == \
            (dirs[PORT] / name).read_bytes(), name


def test_output_buffers_read_all_and_broadcast():
    _b, _p, _t, S = _package(PORT)
    pages = _pages(PORT, (7, 8))
    buf = S.OutputBuffers(2, 2, broadcast=False)
    buf.add(0, 0, pages[0])
    buf.add(1, 1, pages[1])
    assert buf.pages_for_consumer(0) == [pages[0]]
    buf.read_all = True
    assert buf.pages_for_consumer(0) == pages
    buf.reset_task(1)
    assert buf.pages_for_consumer(1) == [pages[0]]
    bc = S.OutputBuffers(2, 1, broadcast=True)
    bc.add(0, 0, pages[0])
    bc.add(1, 0, pages[1])
    assert bc.pages_for_consumer(0) == bc.pages_for_consumer(1) == pages


def test_merge_node_stats_equal():
    from presto_tpu.exec.scheduler import merge_node_stats as jmerge
    from presto_tpu_torch.exec.scheduler import merge_node_stats as tmerge
    tasks = [{"n1": {"rows": 10, "wall_s": 0.5, "batches": 2, "bytes": 80,
                     "fused": True, "operatorType": "Scan",
                     "driver_walls": [0.1, 0.2]},
              "n2": {"rows": 3, "dynamicFilterRowsDropped": 7}},
             {"n1": {"rows": 5, "wall_s": 0.25, "batches": 1, "bytes": 40,
                     "fused": False, "driver_walls": [0.3]},
              "n3": {"operatorType": "Agg"}}]
    want, got = {}, {}
    for t in tasks:
        jmerge(want, t)
        tmerge(got, t)
    assert got == want


@pytest.mark.parametrize("col", [0, 1, 2, 4, 5, 6])
def test_summarize_page_block_equal(col):
    from presto_tpu.exec.scheduler import _summarize_page_block as jsum
    from presto_tpu_torch.exec.scheduler import _summarize_page_block as tsum
    for jpage, tpage in zip(_pages(REF), _pages(PORT)):
        for cap in (4, 1024):
            want = jsum("df_1", jpage.blocks[col], cap)
            got = tsum("df_1", tpage.blocks[col], cap)
            assert got.to_dict() == want.to_dict()


def _batches_equal(jbatches, tbatches):
    """The same rows, column for column (values, NULLs, dictionaries), in
    the same order: the reference makes a batch per page, the port packs
    pages into full batches (all but the last)."""
    assert jbatches and tbatches
    assert all(bool(b.mask.all()) for b in tbatches[:-1])
    assert list(jbatches[0].columns) == list(tbatches[0].columns)
    for name in jbatches[0].columns:
        def rows(batches, values):
            out = []
            for b in batches:
                m = np.asarray(b.mask) if values else b.mask.numpy()
                c = b.columns[name]
                v = np.asarray(c.values) if values else c.values.numpy()
                nn = (np.zeros(len(m), dtype=bool) if c.nulls is None
                      else (np.asarray(c.nulls) if values
                            else c.nulls.numpy()))
                out.append((v[m], nn[m], c.dictionary))
            return out
        want, got = rows(jbatches, True), rows(tbatches, False)
        assert {d for _v, _n, d in got} == {d for _v, _n, d in want}, name
        assert np.array_equal(np.concatenate([v for v, _n, _d in got]),
                              np.concatenate([v for v, _n, _d in want])), \
            name
        assert np.array_equal(np.concatenate([n for _v, n, _d in got]),
                              np.concatenate([n for _v, n, _d in want])), \
            name


@pytest.mark.parametrize("capacity", [256, 1024])
def test_pages_to_batches_codes_and_union_dictionaries(capacity):
    """Three producer pages with different dictionaries and NULLs: the
    port's vectorized union gives the reference's codes and sorted union
    dictionary for both string columns, chunked the same way."""
    from presto_tpu.exec.batch import pages_to_batches as jp2b
    from presto_tpu_torch.exec.batch import pages_to_batches as tp2b
    names = ["b", "i", "d", "f", "t", "s", "k"]
    jT, tT = _package(REF)[2], _package(PORT)[2]
    jbs = list(jp2b(_pages(REF), names, _types(jT), capacity))
    tbs = list(tp2b(_pages(PORT), names, _types(tT), capacity, "cpu"))
    _batches_equal(jbs, tbs)
    assert len(tbs[0].columns["s"].dictionary) > 40
    from presto_tpu_torch.exec.batch import _union_codes
    for i in (5, 6):
        uniq, _codes = _union_codes(_pages(PORT), i)
        assert list(uniq) == sorted(uniq)


def test_pages_to_batches_numeric_only_and_split_pages():
    """A numeric schema streams page by page; split sub-pages (taken
    dictionary blocks, whose dictionaries keep unreferenced entries) give
    the reference's union too."""
    from presto_tpu.exec.batch import pages_to_batches as jp2b
    from presto_tpu_torch.exec.batch import pages_to_batches as tp2b
    jB, _p, jT, jS = _package(REF)
    tB, _p, tT, tS = _package(PORT)
    names = ["b", "i", "d", "f", "t"]
    jnum = [type(p)(p.blocks[:5], p.position_count) for p in _pages(REF)]
    tnum = [type(p)(p.blocks[:5], p.position_count) for p in _pages(PORT)]
    _batches_equal(list(jp2b(jnum, names, _types(jT)[:5], 512)),
                   list(tp2b(tnum, names, _types(tT)[:5], 512, "cpu")))
    targets = jS.partition_targets(_pages(REF)[0], _types(jT), [0], 3)
    jsub = [p for p in jS.split_page(_pages(REF)[0], targets, 3)]
    tsub = [p for p in tS.split_page(_pages(PORT)[0], targets, 3)]
    names = ["b", "i", "d", "f", "t", "s", "k"]
    _batches_equal(list(jp2b(jsub, names, _types(jT), 128)),
                   list(tp2b(tsub, names, _types(tT), 128, "cpu")))


def test_pages_to_batches_row_path_for_nul_bytes():
    """Strings holding NUL bytes: the vectorized union keys each string
    by its padded bytes and then its length, so "a" and "a\\x00" stay two
    entries in Python's order, with the reference's row loop's codes."""
    from presto_tpu.exec.batch import pages_to_batches as jp2b
    from presto_tpu_torch.exec.batch import pages_to_batches as tp2b
    from presto_tpu_torch.exec import batch as tbatch
    strings = ["a\x00", "a", None, "b", "a\x00", ""]
    out = {}
    for pkg, fn in ((REF, jp2b), (PORT, tp2b)):
        B, Pg, T, _S = _package(pkg)
        page = Pg.Page([B.VariableWidthBlock.from_strings(strings)])
        args = ([page], ["s"], [T.VARCHAR], 8) + (("cpu",) if pkg == PORT
                                                  else ())
        out[pkg] = list(fn(*args))
    _batches_equal(out[REF], out[PORT])
    tB, tPg = _package(PORT)[:2]
    uniq, ((codes, nulls),) = tbatch._union_codes(
        [tPg.Page([tB.VariableWidthBlock.from_strings(strings)])], 0)
    assert uniq == ("", "a", "a\x00", "b")
    assert codes.tolist() == [2, 1, 0, 3, 2, 0]
    assert nulls.tolist() == [False, False, True, False, False, False]
    assert out[PORT][0].columns["s"].dictionary == ("", "a", "a\x00", "b")


# ---------------------------------------------------------------------------
# agg_merge
# ---------------------------------------------------------------------------

def _agg_states(pkg, specs_args, rows, slots, key_dtype):
    """Two partial tables and the table of all rows, in one package."""
    import importlib
    ops = importlib.import_module(f"{pkg}.exec.operators")
    bm = importlib.import_module(f"{pkg}.exec.batch")
    specs = tuple(ops.AggSpec(*a) for a in specs_args)
    if pkg == REF:
        import jax.numpy as jnp

        def arr(x):
            return jnp.asarray(x)

        def init():
            return ops.agg_init(slots, specs, ("k",), (key_dtype[0],))
    else:
        def arr(x):
            return torch.as_tensor(x)

        def init():
            return ops.agg_init(slots, specs, ("k",), (key_dtype[1],),
                                "cpu")

    def table(lo, hi):
        k = bm.Column(arr(rows["k"][lo:hi]))
        x = bm.Column(arr(rows["x"][lo:hi]))
        y = bm.Column(arr(rows["y"][lo:hi]))
        b = bm.Batch({"k": k}, arr(np.ones(hi - lo, dtype=bool)))
        inputs = {s.output: (y if s.name in ("approx_distinct",) else x)
                  for s in specs}
        return ops.agg_update(init(), b, [k], inputs, specs, slots, 0,
                              ("k",), agg_inputs2={s.output: y
                                                   for s in specs})
    n = len(rows["k"])
    merged = ops.agg_merge(table(0, n // 3), table(n // 3, n), specs,
                           ("k",), slots)
    return merged, ops, specs


AGG_CASES = {
    "basic": [("sum", "s", False), ("count", "c", False),
              ("count_star", "n", False), ("min", "lo", False),
              ("max", "hi", False), ("avg", "a", False)],
    "float": [("sum", "s", True), ("min", "lo", True), ("max", "hi", True),
              ("avg", "a", True)],
    "moments": [("var_samp", "v", True), ("stddev", "sd", True),
                ("corr", "cr", True)],
    "hll": [("approx_distinct", "d", False, 2048)],
}


@pytest.mark.parametrize("case", sorted(AGG_CASES))
def test_agg_merge_matches_the_reference(case):
    import jax.numpy as jnp
    rng = np.random.default_rng(11)
    n = 600
    rows = {"k": rng.integers(0, 37, n).astype(np.int64),
            "y": rng.integers(0, 5000, n).astype(np.int64)}
    is_float = case in ("float", "moments")
    rows["x"] = (rng.normal(size=n) * 100 if is_float
                 else rng.integers(-500, 500, n).astype(np.int64))
    slots = 64
    args = AGG_CASES[case]
    want, jops, jspecs = _agg_states(REF, args, rows, slots,
                                     (jnp.int64, torch.int64))
    got, tops, tspecs = _agg_states(PORT, args, rows, slots,
                                    (jnp.int64, torch.int64))
    assert set(got) == set(want)
    for name in want:
        w = np.asarray(want[name])
        g = got[name].numpy()
        if name == "__keyhash":
            w = w.view(np.int64)
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-9,
                                       err_msg=name)
        else:
            assert np.array_equal(g, w), name


def test_agg_merge_hll_equals_union_sketch():
    """The reference test's shape (tests/test_hll.py): merging the
    sketches of [0, 4000) and [2000, 6000) gives the sketch of
    [0, 6000)."""
    from presto_tpu_torch.exec import operators as ops
    from presto_tpu_torch.exec.batch import Batch, Column
    spec = (ops.AggSpec("approx_distinct", "d", False,
                        ops.HLL_DEFAULT_BUCKETS),)
    slots = 64

    def table(values):
        st = ops.agg_init(slots, spec, (), (), "cpu")
        col = Column(torch.as_tensor(values, dtype=torch.int64))
        b = Batch({"x": col}, torch.ones(len(values), dtype=torch.bool))
        return ops.agg_update(st, b, [], {"d": col}, spec, slots, 0, ())

    merged = ops.agg_merge(table(np.arange(0, 4000)),
                           table(np.arange(2000, 6000)), spec, (), slots)
    both = table(np.arange(0, 6000))
    ma = merged["d$hll"].reshape(slots, -1)
    mb = both["d$hll"].reshape(slots, -1)
    assert torch.equal(ma.max(dim=0).values, mb.max(dim=0).values)


# ---------------------------------------------------------------------------
# stage_shards_lifespans and resolve_fabric
# ---------------------------------------------------------------------------

SHARD_PLANS = [
    ("select l_orderkey, sum(l_quantity) q from lineitem "
     "group by l_orderkey", {}),
    ("select l_partkey, sum(l_quantity) q from lineitem "
     "group by l_partkey", {}),
    ("select sum(l_quantity) q from lineitem", {}),
    ("select l_orderkey, count(distinct l_partkey) c from lineitem "
     "group by l_orderkey", {}),
    ("select l_orderkey, sum(l_quantity) q from lineitem "
     "group by l_orderkey", {"grouped_lifespan_sharding": False}),
    ("select l_orderkey, sum(l_quantity) q from lineitem "
     "group by l_orderkey", {"grouped_lifespans": 1}),
    ("select l_orderkey, sum(l_quantity) q from lineitem "
     "group by l_orderkey", {"grouped_lifespans": 0}),
    ("select l_orderkey, sum(l_quantity) q from lineitem "
     "group by l_orderkey", {"memory_budget_bytes": 1 << 20}),
    ("select l_orderkey, sum(l_quantity) q from lineitem "
     "group by l_orderkey", {"fuse_pipelines": False}),
    ("select l_orderkey, stddev(l_quantity) q from lineitem "
     "group by l_orderkey", {}),
    ("select o_orderkey, count(*) from orders group by o_orderkey "
     "order by 2 desc limit 5", {}),
    ("select l_orderkey, o_orderdate, sum(l_quantity) from lineitem "
     "join orders on l_orderkey = o_orderkey "
     "group by l_orderkey, o_orderdate", {}),
]


@pytest.mark.parametrize("i", range(len(SHARD_PLANS)))
def test_stage_shards_lifespans_agrees_with_the_reference(i):
    """The reference test's plans (tests/test_grouped.py) and more: the
    predicate over the plan root and over each fragment of the
    distributed plan agrees with the reference's."""
    from presto_tpu.exec.grouped import stage_shards_lifespans as jpred
    from presto_tpu.exec.pipeline import ExecutionConfig as JCfg
    from presto_tpu.exec.runner import DistributedQueryRunner as JD
    from presto_tpu_torch.exec.grouped import stage_shards_lifespans as tpred
    from presto_tpu_torch.exec.pipeline import ExecutionConfig as TCfg
    from presto_tpu_torch.exec.runner import DistributedQueryRunner as TD
    sql, over = SHARD_PLANS[i]
    kw = {"grouped_lifespans": 4, **over}
    jcfg, tcfg = JCfg(**kw), TCfg(**kw)
    jr = JD("sf0.01", config=jcfg, n_tasks=2)
    tr = TD("sf0.01", config=tcfg, n_tasks=2, device="cpu")
    assert tpred(tr.plan(sql).source, tcfg) == \
        jpred(jr.plan(sql).source, jcfg)
    jfr = jr.plan_subplan(sql)[0].all_fragments()
    tfr = tr.plan_subplan(sql)[0].all_fragments()
    assert [tpred(f.root, tcfg) for f in tfr] == \
        [jpred(f.root, jcfg) for f in jfr]
    if i == 0:
        assert any(tpred(f.root, tcfg) for f in tfr)


def test_resolve_fabric_decision_table():
    """The reference test's decision table, and the port's resolution
    equal to the reference's on every combination."""
    from presto_tpu.parallel.fabric import resolve_fabric as jres
    from presto_tpu_torch.parallel.fabric import (FABRIC_HTTP, FABRIC_ICI,
                                                  resolve_fabric)

    def r(req="auto", handle="FIXED_HASH", prod="SOURCE",
          cons="FIXED_HASH", mesh=8, batch=False, fn=resolve_fabric):
        return fn(req, handle=handle, producer_partitioning=prod,
                  consumer_partitioning=cons, mesh_size=mesh,
                  batch_mode=batch)

    assert r() == (FABRIC_ICI, "mesh-eligible hash edge")
    assert r(req="ici")[0] == FABRIC_ICI
    assert r(req="http") == (FABRIC_HTTP, "requested")
    assert r(req=None)[0] == FABRIC_ICI
    for kw in ({"handle": "SINGLE"}, {"handle": "FIXED_BROADCAST"},
               {"mesh": 0}, {"mesh": 1}, {"batch": True},
               {"prod": "SINGLE"}, {"cons": "SINGLE"}):
        fabric, why = r(req="ici", **kw)
        assert fabric == FABRIC_HTTP, kw
        assert why and why != "requested", kw
    import itertools
    for req, handle, prod, cons, mesh, batch in itertools.product(
            (None, "auto", "http", "ici"),
            ("FIXED_HASH", "SINGLE", "FIXED_BROADCAST"),
            ("SOURCE", "FIXED_HASH", "SINGLE"),
            ("SOURCE", "FIXED_HASH", "SINGLE"), (0, 1, 4), (False, True)):
        args = dict(req=req, handle=handle, prod=prod, cons=cons,
                    mesh=mesh, batch=batch)
        assert r(**args) == r(fn=jres, **args), args


def test_mesh_and_ici_raise_naming_what_is_missing():
    """A mesh is ported: its size is its position count, a scheduler over
    CPU positions plans an eligible hashed edge as ici with one task per
    position, and only a mesh of another device kind than the
    scheduler's raises, naming the device."""
    from presto_tpu_torch.exec.scheduler import (InProcessScheduler,
                                                 SchedulerConfig)
    from presto_tpu_torch.parallel.fabric import FABRIC_ICI
    from presto_tpu_torch.parallel.mesh import (WORKER_AXIS, make_mesh,
                                                mesh_size)
    from presto_tpu_torch.exec.runner import DistributedQueryRunner
    assert mesh_size(None) == 0 and WORKER_AXIS == "workers"
    mesh = make_mesh(devices=["cpu"] * 4)
    assert mesh_size(mesh) == 4
    sched = InProcessScheduler(SchedulerConfig(
        mesh=mesh, device=torch.device("cpu")))
    runner = DistributedQueryRunner("sf0.01", n_tasks=2, mesh=mesh,
                                    device="cpu")
    subplan, _, _ = runner.plan_subplan(
        "select o_custkey, count(*) from orders group by o_custkey")
    root = sched._build_stages(subplan)
    sched._plan_fabrics(root)
    (child,) = root.children
    (grand,) = child.children
    assert grand.fabric == FABRIC_ICI and grand.n_tasks == 4
    assert child.n_tasks == 4
    with pytest.raises(ValueError, match="not on the runner's device"):
        InProcessScheduler(SchedulerConfig(
            mesh=make_mesh(devices=["cuda:0"] * 2),
            device=torch.device("cpu")))


def test_scheduler_defaults_to_the_card():
    """A scheduler built as the reference builds it (no config, or a
    config without a device) computes on the card, and raises without
    CUDA instead of running its tasks on the CPU beside a CUDA runner."""
    from presto_tpu_torch.exec.scheduler import (InProcessScheduler,
                                                 SchedulerConfig)
    if torch.cuda.is_available():
        assert SchedulerConfig().device.type == "cuda"
        assert InProcessScheduler().config.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            SchedulerConfig()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            InProcessScheduler()
    cfg = SchedulerConfig(device=torch.device("cpu"))
    assert InProcessScheduler(cfg).config.device == torch.device("cpu")


def test_launch_counters_lose_no_count_across_threads():
    """The kernels' launch counters are bumped under one lock: 16 threads
    of 2000 bumps each, with a short switch interval, leave exactly
    32000 (count_launch's three dicts alike)."""
    import sys
    import threading
    from presto_tpu_torch.exec.kernels import scan_kernel as sk
    counts = {"x": 0}
    plan = type("Plan", (), {"joins": (1,)})()
    before = (sk.LAUNCHES["scan_direct"], sk.JOIN_LAUNCHES["scan_direct"])

    def worker():
        for _ in range(2000):
            sk.bump(counts, "x")
        for _ in range(100):
            sk.count_launch("scan_direct", plan)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert counts["x"] == 32000
    got = (sk.LAUNCHES["scan_direct"] - before[0],
           sk.JOIN_LAUNCHES["scan_direct"] - before[1])
    sk.LAUNCHES["scan_direct"], sk.JOIN_LAUNCHES["scan_direct"] = before
    assert got == (1600, 1600)


def test_scheduler_fields_default_to_the_reference():
    from presto_tpu.exec.pipeline import ExecutionConfig as JCfg
    from presto_tpu.exec.scheduler import SchedulerConfig as JSched
    from presto_tpu_torch.exec.pipeline import ExecutionConfig as TCfg
    from presto_tpu_torch.exec.scheduler import SchedulerConfig as TSched
    for f in ("grouped_lifespan_sharding", "exchange_fabric",
              "exchange_client_threads", "adaptive_exchange"):
        assert getattr(TCfg(), f) == getattr(JCfg(), f), f
    cpu = torch.device("cpu")
    for f in ("source_tasks", "hash_tasks", "broadcast_threshold", "mesh",
              "batch_mode", "task_retries", "temp_dir", "fault_injector"):
        assert getattr(TSched(device=cpu), f) == getattr(JSched(), f), f
    with pytest.raises(ValueError, match="exchange_fabric must be one of"):
        TCfg(exchange_fabric="bogus")


def test_long_decimal_blocks_vectorized_bit_for_bit():
    """The exchange's long-decimal conversions (batch.py
    _int128_from_int64 / _int128_to_int64) build the blocks
    Int128Block.from_ints builds and read back what to_pylist reads,
    INT64_MIN and NULLs included; a value past int64 is left to the
    per-row path."""
    from presto_tpu_torch.common.block import Int128Block
    from presto_tpu_torch.exec.batch import (_int128_from_int64,
                                             _int128_to_int64)
    rng = np.random.default_rng(5)
    v = np.concatenate([rng.integers(-2**63, 2**63 - 1, 500, dtype=np.int64),
                        np.array([0, -1, 1, -2**63, 2**63 - 1],
                                 dtype=np.int64)])
    for nulls in (None, rng.random(len(v)) < 0.1):
        got = _int128_from_int64(v, nulls)
        want = Int128Block.from_ints(
            [None if (nulls is not None and nulls[i]) else int(x)
             for i, x in enumerate(v)], nulls)
        assert np.array_equal(got.values, want.values)
        assert (got.nulls is None) == (want.nulls is None)
        vals, nm = _int128_to_int64(got)
        assert [None if n else int(x) for x, n in zip(vals, nm)] == \
            want.to_pylist()
    assert _int128_to_int64(Int128Block.from_ints([2**70, -5])) is None


def test_lazy_string_blocks_read_as_their_strings():
    """A late-materialized string column crosses the exchange as row ids
    (batch.LazyStringBlock): every reader of its bytes -- the partition
    hash, the shuffle file, to_pylist, the union -- sees the block its
    strings make, take() keeps it lazy, and a consumer whose pages all
    carry it that way gets the lazy column back without a string."""
    from presto_tpu_torch.common.block import (FixedWidthBlock,
                                               VariableWidthBlock)
    from presto_tpu_torch.common.page import Page
    from presto_tpu_torch.common.serde import serialize_page
    from presto_tpu_torch.common.types import BIGINT, VARCHAR
    from presto_tpu_torch.connectors import catalog
    from presto_tpu_torch.exec import batch as tb
    from presto_tpu_torch.exec import scheduler as S
    lazy = ("tpch", "customer", "name", 0.01)
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 1500, 300).astype(np.int64)
    nulls = rng.random(300) < 0.1
    strings = catalog.generate_values_at("customer", "name", 0.01, ids,
                                         "tpch")
    flat = VariableWidthBlock.from_strings(
        [None if n else s for s, n in zip(strings, nulls)])
    lz = tb.LazyStringBlock(ids, lazy, nulls)
    sub = lz.take(np.arange(0, 300, 7))
    assert isinstance(sub, tb.LazyStringBlock) and sub._block is None
    assert sub.to_pylist() == flat.take(np.arange(0, 300, 7)).to_pylist()
    keys = tb.LazyStringBlock(ids, lazy, nulls)
    assert np.array_equal(S._hash_block(VARCHAR, keys, 300),
                          S._hash_block(VARCHAR, flat, 300))
    assert np.array_equal(lz.offsets, flat.offsets)
    assert np.array_equal(lz.data, flat.data)
    assert lz.to_pylist() == flat.to_pylist()
    assert serialize_page(Page([lz])) == serialize_page(Page([flat]))
    assert S._summarize_page_block("df", lz, 16).to_dict() == \
        S._summarize_page_block("df", flat, 16).to_dict()
    vals = np.arange(300, dtype=np.int64)
    pages = [Page([tb.LazyStringBlock(ids[:150], lazy, nulls[:150]),
                   FixedWidthBlock(vals[:150])]),
             Page([tb.LazyStringBlock(ids[150:], lazy, nulls[150:]),
                   FixedWidthBlock(vals[150:])])]
    out = list(tb.pages_to_batches(pages, ["s", "v"], [VARCHAR, BIGINT],
                                   256, "cpu"))
    col = out[0].columns["s"]
    assert col.lazy == lazy and col.dictionary is None
    assert torch.equal(col.values[:150], torch.as_tensor(ids[:150]))
    assert all(p.blocks[0]._block is None for p in pages)
    # a column that is lazy in one page only takes the union
    mixed = [pages[0], Page([flat.take(np.arange(150, 300)),
                             FixedWidthBlock(vals[150:])])]
    got = list(tb.pages_to_batches(mixed, ["s", "v"], [VARCHAR, BIGINT],
                                   256, "cpu"))
    want = list(tb.pages_to_batches(
        [Page([flat.take(np.arange(150)), FixedWidthBlock(vals[:150])]),
         mixed[1]], ["s", "v"], [VARCHAR, BIGINT], 256, "cpu"))
    assert got[0].columns["s"].dictionary == want[0].columns["s"].dictionary
    for g, w in zip(got, want):
        assert torch.equal(g.columns["s"].values, w.columns["s"].values)


def test_pages_to_batches_pack_rows():
    """With pack_rows over capacity, pages pack into batches of up to
    pack_rows rows, each of the power-of-two capacity its rows need (at
    least capacity), with every row in order."""
    from presto_tpu_torch.common.block import FixedWidthBlock
    from presto_tpu_torch.common.page import Page
    from presto_tpu_torch.common.types import BIGINT
    from presto_tpu_torch.exec.batch import pages_to_batches
    sizes = [100, 300, 7, 250, 40]
    vals = np.arange(sum(sizes), dtype=np.int64)
    pages, lo = [], 0
    for n in sizes:
        pages.append(Page([FixedWidthBlock(vals[lo:lo + n])], n))
        lo += n
    out = list(pages_to_batches(pages, ["v"], [BIGINT], 128, "cpu",
                                pack_rows=512))
    assert [(b.capacity, int(b.mask.sum())) for b in out] == \
        [(512, 512), (256, 185)]
    got = torch.cat([b.columns["v"].values[b.mask] for b in out])
    assert torch.equal(got, torch.as_tensor(vals))
    small = list(pages_to_batches(pages[:1], ["v"], [BIGINT], 128, "cpu",
                                  pack_rows=512))
    assert [b.capacity for b in small] == [128]
