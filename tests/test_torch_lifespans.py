"""Grouped (lifespan) execution in the port (presto_tpu_torch/exec/
grouped.py), held to the reference (presto_tpu/exec/grouped.py,
tests/test_grouped.py):

  * the connector's bucket layout equals the reference's and tiles both
    co-bucketed tables;
  * forced lifespans at sf0.01 (Q3 with K = 4, the runner reused on the
    warm run; the Q18 shape with K = 3; grouping keys not dependent on
    the anchor; a fanout-k self-join; prefetch depths 0-2) equal the
    reference's numpy oracle (LocalQueryRunner.execute_reference) with
    GroupedRunner.run engaged; auto stays off at sf0.01; partial split
    coverage is not grouped; no bucketed build covers more than ~1/K of
    its table;
  * a bucket's DirectTable and BuildTable are bit-identical to the
    reference's builders' tables over the same bucket rows;
  * a build whose key multiplicity passes the reserved fanout in a later
    lifespan raises as in the reference (_check_dups);
  * lifespan sharding through the distributed runner: each task stages
    its round-robin share of the buckets, and stage_shards_lifespans'
    auto decision agrees with the reference's at sf0.01 and SF100."""
import numpy as np
import pytest
import torch

from presto_tpu_torch.benchmarks.scale_run import SF100_QUERIES
from presto_tpu_torch.connectors import catalog, tpch
from presto_tpu_torch.exec import grouped as G
from presto_tpu_torch.exec.pipeline import ExecutionConfig, tuned_config
from presto_tpu_torch.exec.runner import LocalQueryRunner
from torch_rows import assert_rows_close
from torch_threads import one_torch_thread  # noqa: F401

Q3 = """
select l_orderkey, sum(l_extendedprice * (1 - l_discount)) as revenue,
       o_orderdate, o_shippriority
from customer, orders, lineitem
where c_mktsegment = 'BUILDING' and c_custkey = o_custkey
  and l_orderkey = o_orderkey and o_orderdate < date '1995-03-15'
  and l_shipdate > date '1995-03-15'
group by l_orderkey, o_orderdate, o_shippriority
order by revenue desc, o_orderdate limit 10
"""
Q18_SHAPE = """
select l_orderkey, o_orderdate, o_totalprice, sum(l_quantity) q
from lineitem join orders on l_orderkey = o_orderkey
group by l_orderkey, o_orderdate, o_totalprice
having sum(l_quantity) > 150
order by o_totalprice desc, o_orderdate limit 20
"""
NON_DEPENDENT = ("select l_orderkey, l_partkey, sum(l_quantity) "
                 "from lineitem group by l_orderkey, l_partkey")
# a fanout-k bucketed build: up to 7 lines per order on the build side
SELF_JOIN = ("select l1.l_orderkey, count(*), sum(l2.l_quantity) "
             "from lineitem l1 join lineitem l2 "
             "on l1.l_orderkey = l2.l_orderkey group by l1.l_orderkey")


@pytest.fixture(scope="module")
def oracle():
    """The reference's numpy oracle rows, one run per query."""
    from presto_tpu.exec.runner import LocalQueryRunner as JRunner
    runner = JRunner("sf0.01")
    memo = {}

    def rows(sql):
        if sql not in memo:
            memo[sql] = runner.execute_reference(sql)
        return memo[sql]
    return rows


def _runner(**kw):
    return LocalQueryRunner("sf0.01", device="cpu",
                            config=tuned_config(**kw))


def _spy_runs(monkeypatch):
    calls = []
    orig = G.GroupedRunner.run

    def spy(self):
        calls.append(self)
        return orig(self)
    monkeypatch.setattr(G.GroupedRunner, "run", spy)
    return calls


# -- connector bucket layout ------------------------------------------------

@pytest.mark.parametrize("sf,k", [(0.01, 1), (0.01, 4), (0.01, 7),
                                  (0.1, 16), (1.0, 13), (100.0, 36)])
def test_bucket_layout_tiles_tables(sf, k):
    from presto_tpu.connectors import tpch as jtpch
    layout = tpch.bucket_layout(sf, k)
    assert [(b.key_lo, b.key_hi, b.rows) for b in layout] \
        == [(b.key_lo, b.key_hi, b.rows) for b in jtpch.bucket_layout(sf, k)]
    assert 1 <= len(layout) <= k
    for table in ("orders", "lineitem"):
        pos = 0
        for b in layout:
            lo, hi = b.rows[table]
            assert lo == pos and hi > lo
            pos = hi
        assert pos == tpch.table_row_count(table, sf)
    pos = 1
    for b in layout:
        assert b.key_lo == pos
        pos = b.key_hi
    assert pos == tpch.table_row_count("orders", sf) + 1


def test_bucket_rows_match_key_ranges():
    """Every row a bucket holds carries an orderkey inside its key range,
    for orders and for the block-mapped lineitem rows."""
    sf = 0.01
    for b in tpch.bucket_layout(sf, 5):
        o_lo, o_hi = b.rows["orders"]
        ok = tpch.generate_column("orders", "orderkey", sf, o_lo,
                                  o_hi - o_lo)
        assert ok.min() >= b.key_lo and ok.max() < b.key_hi
        l_lo, l_hi = b.rows["lineitem"]
        lk = tpch.generate_column("lineitem", "orderkey", sf, l_lo,
                                  l_hi - l_lo)
        assert lk.min() >= b.key_lo and lk.max() < b.key_hi


def test_catalog_bucket_metadata():
    assert catalog.bucket_column("lineitem", "tpch") == "orderkey"
    assert catalog.bucket_column("orders", "tpch") == "orderkey"
    assert catalog.bucket_column("customer", "tpch") is None
    assert catalog.bucket_layout(0.01, 4, "tpch") is not None


def test_auto_lifespans_at_sf100():
    """Auto mode at SF100: 150 M orderkeys over AUTO_SPAN_THRESHOLD give
    ceil(150 M / TARGET_BUCKET_SPAN) = 36 buckets; the scale script runs
    Q18 there."""
    span = catalog.table_row_count("orders", 100.0, "tpch")
    assert span > G.AUTO_SPAN_THRESHOLD
    assert -(-span // G.TARGET_BUCKET_SPAN) == 36
    assert len(catalog.bucket_layout(100.0, 36, "tpch")) == 36
    assert 18 in SF100_QUERIES and 3 in SF100_QUERIES


def test_defaults_are_the_reference():
    from presto_tpu.exec.pipeline import ExecutionConfig as JConfig
    for f in ("grouped_lifespans", "grouped_prefetch_depth",
              "task_concurrency"):
        assert getattr(ExecutionConfig(), f) == getattr(JConfig(), f), f
    assert ExecutionConfig().grouped_prefetch_depth == 1
    assert G.AUTO_SPAN_THRESHOLD == 1 << 24
    assert G.TARGET_BUCKET_SPAN == 1 << 22


# -- execution --------------------------------------------------------------

def test_q3_grouped_parity(monkeypatch, oracle):
    calls = _spy_runs(monkeypatch)
    r = _runner(grouped_lifespans=4)
    exp = oracle(Q3)
    got = r.execute(Q3)
    assert_rows_close(got, exp, ordered=True)
    assert len(calls) == 1 and len(calls[0].layout) == 4
    # the orders build is per bucket: a direct table of G slots
    assert [b[5] for b in calls[0].per_bucket_builds] == [1]
    assert got.runtime_stats["groupedRunWallNanos"]["sum"] > 0
    assert got.runtime_stats["groupedBucketGenWallNanos"]["count"] == 4
    # the warm run reuses the runner and stays correct
    got2 = r.execute(Q3)
    assert_rows_close(got2, exp, ordered=True)
    assert len(calls) == 2 and calls[1] is calls[0]


@pytest.mark.parametrize("sql,k,ordered", [
    (Q18_SHAPE, 3, True), (NON_DEPENDENT, 3, False), (SELF_JOIN, 5, False)],
    ids=["q18_shape", "non_dependent_keys", "fanout_k_self_join"])
def test_forced_lifespans_parity(monkeypatch, oracle, sql, k, ordered):
    """The Q18 shape, grouping keys NOT functionally dependent on the
    anchor (l_partkey varies within an orderkey: the per-bucket sort
    aggregation is general over key tuples), and a self-join whose
    bucketed build has up to 7 rows per key (a BuildTable probed with an
    8-way expansion) equal the oracle."""
    calls = _spy_runs(monkeypatch)
    got = _runner(grouped_lifespans=k).execute(sql)
    assert_rows_close(got, oracle(sql), ordered=ordered)
    assert calls and len(calls[0].layout) == k
    if sql is SELF_JOIN:
        assert calls[0].expands == (8,)


def test_auto_mode_stays_off_at_small_scale(monkeypatch, oracle):
    """grouped_lifespans=0 (auto) does not engage below the span
    threshold: sf0.01's 15k-order keyspace is far under it."""
    calls = _spy_runs(monkeypatch)
    r = _runner()
    assert r.config.grouped_lifespans == 0
    got = r.execute(Q3)
    assert_rows_close(got, oracle(Q3), ordered=True)
    assert not calls
    assert "groupedRunWallNanos" not in got.runtime_stats


def test_lifespans_off(monkeypatch):
    calls = _spy_runs(monkeypatch)
    _runner(grouped_lifespans=1).execute(Q3)
    assert not calls


def test_partial_split_coverage_not_grouped():
    """A task owning a split subset must not re-bucket it."""
    full = catalog.make_splits("lineitem", 0.01, 4, "tpch")
    assert G._full_coverage(full, "lineitem", 0.01, "tpch")
    assert not G._full_coverage(full[:2], "lineitem", 0.01, "tpch")
    assert not G._full_coverage(full[1:], "lineitem", 0.01, "tpch")


def test_grouped_peak_build_rows_bounded(monkeypatch):
    """No bucketed build materialization covers more than ~1/K of the
    build table."""
    seen = []
    orig = G.GroupedRunner._bucket_aux

    def spy(self, bucket):
        o_lo, o_hi = bucket.rows["orders"]
        seen.append(o_hi - o_lo)
        return orig(self, bucket)
    monkeypatch.setattr(G.GroupedRunner, "_bucket_aux", spy)
    _runner(grouped_lifespans=4).execute(Q3)
    total = tpch.table_row_count("orders", 0.01)
    assert seen and max(seen) <= -(-total // 4) + 7


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_q3_grouped_prefetch_depths(monkeypatch, oracle, depth):
    """Rows do not depend on the depth: 0 is the serial bucket loop,
    depth >= 1 stages the next lifespans' builds first."""
    calls = _spy_runs(monkeypatch)
    staged = []
    orig = G.GroupedRunner._stage_bucket

    def spy(self, bi, aux0):
        staged.append(bi)
        return orig(self, bi, aux0)
    monkeypatch.setattr(G.GroupedRunner, "_stage_bucket", spy)
    consumed = []
    orig_agg = G.GroupedRunner._aggregate

    def spy_agg(self, chunks, aux):
        consumed.append(len(staged))
        return orig_agg(self, chunks, aux)
    monkeypatch.setattr(G.GroupedRunner, "_aggregate", spy_agg)
    got = _runner(grouped_lifespans=4, grouped_prefetch_depth=depth) \
        .execute(Q3)
    assert_rows_close(got, oracle(Q3), ordered=True)
    assert len(calls) == 1 and len(calls[0].layout) == 4
    # bucket i is aggregated once min(4, i + 1 + depth) buckets are staged
    assert consumed == [min(4, i + 1 + depth) for i in range(4)]


# -- per-bucket tables against the reference's builders --------------------

def _jbatch(b):
    import jax.numpy as jnp
    from presto_tpu.exec.batch import Batch as JBatch
    from presto_tpu.exec.batch import Column as JColumn
    return JBatch({n: JColumn(jnp.asarray(c.values.numpy()),
                              None if c.nulls is None
                              else jnp.asarray(c.nulls.numpy()),
                              c.dictionary)
                   for n, c in b.columns.items()},
                  jnp.asarray(b.mask.numpy()))


def _eligible_runner(sql, k):
    """The GroupedRunner the query's aggregation builds, without running
    it."""
    made = []
    orig = G.make_grouped_runner

    def spy(*a, **kw):
        r = orig(*a, **kw)
        made.append(r)
        return r
    G.make_grouped_runner = spy
    try:
        _runner(grouped_lifespans=k).execute(sql)
    finally:
        G.make_grouped_runner = orig
    return next(r for r in made if r is not None)


@pytest.mark.parametrize("sql,k,fanout", [(Q3, 4, 1), (SELF_JOIN, 3, 8)],
                         ids=["direct_table", "build_table"])
def test_bucket_tables_bit_identical(sql, k, fanout):
    """Each bucket's table (bucket_table over the bucket's materialized
    build) is bit-identical to the reference's: its _direct_builder
    slots and dup flag over the bucket's key base, or its build_table's
    sorted hashes, permutation, run lengths and live count, run eagerly
    on the same rows."""
    import jax
    from presto_tpu.exec import fused as jfused
    from presto_tpu.exec import operators as jops
    from presto_tpu_torch.exec.fused import DirectTable, _drop_null_keys
    from presto_tpu_torch.exec.operators import BuildTable
    runner = _eligible_runner(sql, k)
    (ai, jn, scan_node, btable, bkey, kk), = runner.per_bucket_builds
    assert kk == fanout
    whole = None
    for bucket in runner.layout:
        b = G._materialize_bucket_build(runner.compiler, jn, scan_node,
                                        btable, bucket.rows[btable])
        b = _drop_null_keys(b, (bkey,))
        keys = b.columns[bkey].values[b.mask]
        assert bool(((keys >= bucket.key_lo) & (keys < bucket.key_hi)).all())
        whole = keys if whole is None else torch.cat([whole, keys])
        tbl, dup = G.bucket_table(b, bkey, kk, runner.G, bucket.key_lo)
        jb = _jbatch(b)
        if kk == 1:
            assert isinstance(tbl, DirectTable)
            col = jb.columns[bkey]
            slots, jdup = jax.device_get(jfused._direct_builder(runner.G)(
                col.values, jb.mask, np.int64(bucket.key_lo)))
            np.testing.assert_array_equal(tbl.slots.numpy(), slots)
            assert bool(dup) == bool(jdup) is False
            assert int(tbl.base[0]) == bucket.key_lo
        else:
            assert isinstance(tbl, BuildTable)
            jt = jops.build_table(jb, (bkey,))
            np.testing.assert_array_equal(tbl.keyhash_sorted.numpy(),
                                          np.asarray(jt.keyhash_sorted))
            np.testing.assert_array_equal(tbl.perm.numpy(),
                                          np.asarray(jt.perm))
            np.testing.assert_array_equal(tbl.run_len.numpy(),
                                          np.asarray(jt.run_len))
            assert int(tbl.valid_count) == int(jt.valid_count)
            assert bool(dup) == bool(jfused._max_run(jt) > kk) is False
    # the buckets together hold the whole build's keys
    full = runner.compiler._materialize_node(jn.right)
    full = _drop_null_keys(full, (bkey,))
    np.testing.assert_array_equal(
        np.sort(whole.numpy()),
        np.sort(full.columns[bkey].values[full.mask].numpy()))


def test_check_dups_raises_as_the_reference():
    from presto_tpu.exec.grouped import GroupedRunner as JRunner
    import jax.numpy as jnp
    msg = "key multiplicity exceeds the reserved fanout"
    with pytest.raises(NotImplementedError, match=msg):
        JRunner._check_dups([jnp.asarray(False), jnp.asarray(True)])
    with pytest.raises(NotImplementedError, match=msg):
        G.GroupedRunner._check_dups(G._DupFlags(
            [torch.tensor(False), torch.tensor(True)]))
    G.GroupedRunner._check_dups(G._DupFlags([torch.tensor(False)]))
    G.GroupedRunner._check_dups(G._DupFlags([]))


def test_later_bucket_over_its_fanout_raises(monkeypatch):
    """A bucketed build whose multiplicity passes the fanout reserved
    from bucket 0 raises once earlier lifespans have streamed: nothing
    is caught or run again."""
    orig = G.bucket_table

    def later_dup(b, bkey, k, g, key_lo):
        tbl, dup = orig(b, bkey, k, g, key_lo)
        return tbl, dup | (key_lo > 1)
    monkeypatch.setattr(G, "bucket_table", later_dup)
    with pytest.raises(NotImplementedError,
                       match="exceeds the reserved fanout"):
        _runner(grouped_lifespans=4).execute(Q3)


def test_sharded_tasks_run_disjoint_bucket_subsets(monkeypatch, oracle):
    """Lifespan sharding through the distributed runner: with K = 4 over
    2 tasks, task 0 stages buckets 0 and 2 and task 1 buckets 1 and 3
    (GroupedRunner.run's shard branch), each over the full splits; the
    rows equal the oracle's."""
    from presto_tpu_torch.exec.runner import DistributedQueryRunner
    staged = []
    orig = G.GroupedRunner._stage_bucket

    def spy(self, bi, aux0):
        staged.append((self.compiler.ctx.grouped_shard, bi))
        return orig(self, bi, aux0)
    monkeypatch.setattr(G.GroupedRunner, "_stage_bucket", spy)
    r = DistributedQueryRunner("sf0.01", n_tasks=2, device="cpu",
                               config=tuned_config(grouped_lifespans=4))
    assert_rows_close(r.execute(Q18_SHAPE), oracle(Q18_SHAPE), ordered=True)
    by_shard = {}
    for shard, bi in staged:
        by_shard.setdefault(shard, []).append(bi)
    assert by_shard == {(0, 2): [0, 2], (1, 2): [1, 3]}


@pytest.mark.parametrize("schema,k", [("sf0.01", 0), ("sf100", 0),
                                      ("sf0.01", 4)])
def test_stage_shards_lifespans_auto_threshold(schema, k):
    """The predicate's auto decision (grouped_lifespans = 0) engages above
    AUTO_SPAN_THRESHOLD orderkeys only, as the reference's, on the source
    fragments of the distributed Q18 shape (planning only: nothing is
    generated at SF100)."""
    from presto_tpu.exec.grouped import stage_shards_lifespans as jpred
    from presto_tpu.exec.pipeline import ExecutionConfig as JCfg
    from presto_tpu.exec.runner import DistributedQueryRunner as JD
    from presto_tpu_torch.exec.runner import DistributedQueryRunner
    sql = ("select l_orderkey, sum(l_quantity) q from lineitem "
           "group by l_orderkey")
    tcfg = ExecutionConfig(grouped_lifespans=k)
    jcfg = JCfg(grouped_lifespans=k)
    tsub = DistributedQueryRunner(schema, config=tcfg, device="cpu") \
        .plan_subplan(sql)[0]
    jsub = JD(schema, config=jcfg).plan_subplan(sql)[0]
    got = [G.stage_shards_lifespans(f.root, tcfg)
           for f in tsub.all_fragments()]
    assert got == [jpred(f.root, jcfg) for f in jsub.all_fragments()]
    assert any(got) == (schema == "sf100" or k == 4)
