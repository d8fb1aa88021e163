"""The port's device exchange ("ici" fabric: parallel/mesh.py,
parallel/exchange.py and the scheduler's _ici_exchange) against the JAX
package's, on the CPU.

  * bucket_locally gives the reference _bucket_locally's bucket layout,
    mask and overflow flag on seeded inputs, with and without keys and
    with overflow; the exchange step moves bucket d of every producer to
    position d as the reference's all_to_all does;
  * Q3, Q5 and the GROUPBY of tests/test_ici_exchange.py through an
    8-position CPU mesh equal the JAX package's 8-device
    DistributedQueryRunner(mesh=...): integers exact, floats rtol 1e-9;
  * the ici path engages (the reference's spy, as a count);
  * the fabric cases of tests/test_exchange_fabric.py: the auto task
    count, forced http, forced ici without a mesh, a failed sibling
    aborting an ici stage, a metadata mismatch falling back to pages, the
    fabric stats, the chunk rows driving the chunk count, EXPLAIN, the
    chunk tuner's feedback;
  * Q1-Q22 through the mesh equal the golden rows, as the http fabric
    does (Q21 as the reference's distributed runners give it: through
    partitioned joins);
  * the mesh: make_mesh, its placements, and a mesh of another device
    kind than the runner's raising.
"""
import jax
import numpy as np
import pytest
import torch

from presto_tpu_torch.benchmarks.rows import golden_result
from presto_tpu_torch.benchmarks.tpch_queries import ALL, ORDERED
from presto_tpu_torch.exec.pipeline import ExecutionConfig
from presto_tpu_torch.exec.runner import (DistributedQueryRunner,
                                          LocalQueryRunner)
from presto_tpu_torch.parallel.fabric import (FABRIC_METRICS,
                                              ICI_CHUNK_TUNER)
from presto_tpu_torch.parallel.mesh import make_mesh
from torch_rows import assert_rows_close
import torch_tpch_golden as golden
from torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-9
CPU = torch.device("cpu")

GROUPBY = """
SELECT o.custkey, count(*) AS c, sum(o.totalprice) AS s
FROM orders o GROUP BY o.custkey
"""

Q3 = """
SELECT l.orderkey, sum(l.extendedprice * (1 - l.discount)) AS revenue,
       o.orderdate, o.shippriority
FROM customer c, orders o, lineitem l
WHERE c.mktsegment = 'BUILDING' AND c.custkey = o.custkey
  AND l.orderkey = o.orderkey
  AND o.orderdate < DATE '1995-03-15' AND l.shipdate > DATE '1995-03-15'
GROUP BY l.orderkey, o.orderdate, o.shippriority
ORDER BY revenue DESC, o.orderdate
LIMIT 10
"""

Q5 = """
SELECT n.name, sum(l.extendedprice * (1 - l.discount)) AS revenue
FROM customer c, orders o, lineitem l, supplier s, nation n, region r
WHERE c.custkey = o.custkey AND l.orderkey = o.orderkey
  AND l.suppkey = s.suppkey AND c.nationkey = s.nationkey
  AND s.nationkey = n.nationkey AND n.regionkey = r.regionkey
  AND r.name = 'ASIA' AND o.orderdate >= DATE '1994-01-01'
  AND o.orderdate < DATE '1995-01-01'
GROUP BY n.name
ORDER BY revenue DESC
"""


def cpu_mesh(n=8):
    return make_mesh(devices=[CPU] * n)


def _cfg(**kw):
    return ExecutionConfig(batch_rows=1 << 13, join_out_capacity=1 << 15,
                           **kw)


def _runner(fabric="auto", mesh="default", n_tasks=8, **kw):
    m = cpu_mesh() if mesh == "default" else mesh
    return DistributedQueryRunner("sf0.01", config=_cfg(
        exchange_fabric=fabric, **kw), n_tasks=n_tasks, mesh=m,
        device="cpu")


class _IciSpy:
    """Counts _ici_exchange calls and engagements (the device path
    actually taken), as the reference's test_ici_path_engaged does."""

    def __init__(self):
        self.engaged = 0
        self.called = 0

    def __enter__(self):
        from presto_tpu_torch.exec import scheduler as S
        self._S, self._orig = S, S.InProcessScheduler._ici_exchange
        spy = self

        def wrapper(sched, stage, task_batches, keys):
            spy.called += 1
            ok = spy._orig(sched, stage, task_batches, keys)
            if ok and stage.device_out is not None:
                spy.engaged += 1
            return ok
        S.InProcessScheduler._ici_exchange = wrapper
        return self

    def __exit__(self, *exc):
        self._S.InProcessScheduler._ici_exchange = self._orig


# ---------------------------------------------------------------------------
# bucket_locally against the reference's _bucket_locally
# ---------------------------------------------------------------------------

def _batches(seed, cap, n_live, with_nulls, dtype_f):
    """The same seeded batch in both packages: int64 keys of a few
    distinct values, a float column, a nullable int column."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 37, size=cap).astype(np.int64)
    vals = rng.standard_normal(cap).astype(dtype_f)
    other = rng.integers(-1000, 1000, size=cap).astype(np.int64)
    nulls = rng.random(cap) < 0.3 if with_nulls else None
    mask = np.zeros(cap, dtype=bool)
    mask[rng.permutation(cap)[:n_live]] = True

    from presto_tpu.exec.batch import Batch as JB
    from presto_tpu.exec.batch import Column as JC
    from presto_tpu_torch.exec.batch import Batch as TB
    from presto_tpu_torch.exec.batch import Column as TC
    import jax.numpy as jnp
    jb = JB({"k": JC(jnp.asarray(keys)), "v": JC(jnp.asarray(vals)),
             "o": JC(jnp.asarray(other),
                     None if nulls is None else jnp.asarray(nulls))},
            jnp.asarray(mask))
    tb = TB({"k": TC(torch.from_numpy(keys)),
             "v": TC(torch.from_numpy(vals)),
             "o": TC(torch.from_numpy(other),
                     None if nulls is None else torch.from_numpy(nulls))},
            torch.from_numpy(mask))
    return jb, tb


BUCKET_CASES = {
    # (seed, capacity, live rows, nulls, keys, n_parts, quota)
    "keys": (1, 512, 300, False, ["k"], 8, 128),
    "keys_nulls": (2, 512, 512, True, ["k"], 4, 256),
    "two_keys": (3, 256, 100, True, ["k", "o"], 5, 64),
    "round_robin": (4, 512, 333, False, [], 8, 64),
    "overflow": (5, 512, 400, False, ["k"], 2, 64),
    "round_robin_overflow": (6, 256, 200, True, [], 4, 16),
    "all_dead": (7, 128, 0, False, ["k"], 4, 32),
}


@pytest.mark.parametrize("name", sorted(BUCKET_CASES))
def test_bucket_locally_equals_the_reference(name):
    from presto_tpu.parallel.exchange import _bucket_locally
    from presto_tpu_torch.parallel.exchange import bucket_locally
    seed, cap, live, nulls, keys, n, quota = BUCKET_CASES[name]
    jb, tb = _batches(seed, cap, live, nulls, np.float64)
    jcols, jmask, jover = _bucket_locally(jb, keys, n, quota, 0)
    tcols, tmask, tover = bucket_locally(tb, keys, n, quota, 0)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    assert bool(tover) == bool(jover)
    assert bool(tover) == (name.endswith("overflow"))
    for col in ("k", "v", "o"):
        np.testing.assert_array_equal(tcols[col].values.numpy(),
                                      np.asarray(jcols[col].values))
        assert (tcols[col].nulls is None) == (jcols[col].nulls is None)
        if tcols[col].nulls is not None:
            np.testing.assert_array_equal(tcols[col].nulls.numpy(),
                                          np.asarray(jcols[col].nulls))


def test_exchange_step_moves_bucket_d_to_position_d():
    """Position d receives bucket d of every producer, stacked in producer
    order (the reference's all_to_all, split and concat on axis 0)."""
    from presto_tpu_torch.parallel.exchange import (bucket_locally,
                                                    make_partitioned_exchange)
    n, quota = 4, 64
    prods = [_batches(10 + p, 128, 90, True, np.float64)[1]
             for p in range(n)]
    exch = make_partitioned_exchange(cpu_mesh(n), ("k",), quota)
    outs, overflow = exch(prods)
    assert not bool(overflow) and len(outs) == n
    for d, out in enumerate(outs):
        assert out.capacity == n * quota
        for p, b in enumerate(prods):
            cols, mask, _ = bucket_locally(b, ["k"], n, quota)
            sl = slice(p * quota, (p + 1) * quota)
            rows = slice(d * quota, (d + 1) * quota)
            assert torch.equal(out.mask[sl], mask[rows])
            for c in ("k", "v", "o"):
                assert torch.equal(out.columns[c].values[sl],
                                   cols[c].values[rows])
    # every live row lands exactly once, on the position its hash picks
    total = sum(int(b.mask.sum()) for b in prods)
    assert sum(int(o.mask.sum()) for o in outs) == total


def test_bucket_counts_match_the_exchanged_rows():
    from presto_tpu_torch.parallel.exchange import (bucket_counts,
                                                    make_partitioned_exchange)
    n = 4
    prods = [_batches(20 + p, 256, 150, False, np.float64)[1]
             for p in range(n)]
    counts = bucket_counts(prods, ["k"], n)
    outs, _ = make_partitioned_exchange(cpu_mesh(n), ("k",), 256)(prods)
    for d in range(n):
        assert sum(int(c[d]) for c in counts) == int(outs[d].mask.sum())


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

def test_make_mesh_and_placements():
    from presto_tpu_torch.parallel.mesh import (WORKER_AXIS, mesh_size,
                                                replicated, row_sharding)
    m = make_mesh(n_devices=3, devices=["cpu"] * 5)
    assert mesh_size(m) == 3 and m.shape == {WORKER_AXIS: 3}
    assert mesh_size(None) == 0
    t = torch.arange(12)
    shards = row_sharding(m).place(t)
    assert [s.tolist() for s in shards] == [[0, 1, 2, 3], [4, 5, 6, 7],
                                            [8, 9, 10, 11]]
    assert all(torch.equal(s, t) for s in replicated(m).place(t))
    with pytest.raises(ValueError, match="shard evenly"):
        row_sharding(m).place(torch.arange(10))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_mesh()


def test_mesh_of_another_device_kind_raises():
    from presto_tpu_torch.exec.scheduler import (InProcessScheduler,
                                                 SchedulerConfig)
    card_mesh = make_mesh(devices=[torch.device("cuda", 0)] * 2)
    with pytest.raises(ValueError, match="not on the runner's device"):
        DistributedQueryRunner("sf0.01", mesh=card_mesh, device="cpu")
    with pytest.raises(ValueError, match="not on the runner's device"):
        InProcessScheduler(SchedulerConfig(mesh=card_mesh, device=CPU))


# ---------------------------------------------------------------------------
# queries through the mesh against the JAX package's 8-device mesh
# ---------------------------------------------------------------------------

_REF = {}


def _reference_rows(name, sql):
    """The JAX package's DistributedQueryRunner over its 8 virtual CPU
    devices (tests/conftest.py), one run per query."""
    if name not in _REF:
        from presto_tpu.exec.pipeline import ExecutionConfig as JCfg
        from presto_tpu.exec.runner import DistributedQueryRunner as JD
        from presto_tpu.parallel.mesh import WORKER_AXIS
        assert len(jax.devices()) >= 8
        mesh = jax.sharding.Mesh(jax.devices()[:8], (WORKER_AXIS,))
        _REF[name] = JD("sf0.01", config=JCfg(
            batch_rows=1 << 13, join_out_capacity=1 << 15), n_tasks=8,
            mesh=mesh).execute(sql)
    return _REF[name]


@pytest.mark.parametrize("name,sql,ordered", [
    ("q3", Q3, True), ("q5", Q5, True), ("groupby", GROUPBY, False)])
def test_ici_distributed_parity(name, sql, ordered):
    with _IciSpy() as spy:
        got = _runner().execute(sql)
    assert spy.engaged >= 1
    assert got.runtime_stats["exchangeFabricIciBytes"]["sum"] > 0
    assert_rows_close(got, _reference_rows(name, sql), ordered=ordered,
                      rtol=RTOL)


def test_ici_path_engaged():
    with _IciSpy() as spy:
        got = _runner().execute(GROUPBY)
    assert spy.engaged >= 1, "ICI exchange never engaged"
    assert_rows_close(got, _reference_rows("groupby", GROUPBY),
                      ordered=False, rtol=RTOL)


_GROUPBY_EXP = []


def groupby_expected():
    if not _GROUPBY_EXP:
        _GROUPBY_EXP.append(LocalQueryRunner(
            "sf0.01", config=_cfg(), device="cpu").execute(GROUPBY))
    return _GROUPBY_EXP[0]


def test_auto_selection_chooses_mesh_task_count():
    """A 3-task runner over an 8-position mesh: _plan_fabrics CHOOSES 8
    tasks for the eligible hashed edge and the exchange rides the mesh."""
    r = _runner(n_tasks=3)
    with _IciSpy() as spy:
        got = r.execute(GROUPBY)
    assert_rows_close(got, groupby_expected(), ordered=False, rtol=RTOL)
    assert spy.engaged >= 1, "ICI fabric never engaged"
    counts = {s.fragment.fragment_id: s.n_tasks
              for s in r.last_scheduler.stages()}
    assert sorted(counts.values()) == [1, 8, 8]


def test_forced_http_disables_ici():
    with _IciSpy() as spy:
        got = _runner(fabric="http").execute(GROUPBY)
    assert_rows_close(got, groupby_expected(), ordered=False, rtol=RTOL)
    assert spy.called == 0, "forced http still took the device path"


def test_forced_ici_without_mesh_falls_back():
    with _IciSpy() as spy:
        got = _runner(fabric="ici", mesh=None, n_tasks=2).execute(GROUPBY)
    assert_rows_close(got, groupby_expected(), ordered=False, rtol=RTOL)
    assert spy.called == 0


def test_fabric_differential_stats():
    """Both fabrics agree on rows; ici moves device bytes with ZERO host
    bytes and a sane overlap fraction, http meters its page bytes."""
    FABRIC_METRICS.reset()
    got_ici = _runner().execute(Q3)
    fi = FABRIC_METRICS.snapshot()["ici"]
    FABRIC_METRICS.reset()
    got_http = _runner(fabric="http").execute(Q3)
    fh = FABRIC_METRICS.snapshot()["http"]
    assert_rows_close(got_ici, got_http, ordered=True, rtol=RTOL)
    assert fi["exchanges"] >= 1 and fi["chunks"] >= 1
    assert fi["bytes_moved"] > 0
    assert fi["host_bytes"] == 0, "ici fabric staged bytes through host"
    assert fi["fallbacks"] == 0
    assert 0.0 <= fi["overlap_fraction"] <= 1.0
    assert fh["exchanges"] >= 1 and fh["bytes_moved"] > 0
    assert fh["host_bytes"] == fh["bytes_moved"]
    rs = got_ici.runtime_stats
    assert rs.get("exchangeFabricIciBytes", {}).get("sum", 0) > 0
    assert "exchangeFabricIciChunks" in rs


def test_metadata_mismatch_falls_back_to_pages(monkeypatch):
    from presto_tpu_torch.exec import scheduler as S
    monkeypatch.setattr(S, "_batch_meta", lambda b: object())
    FABRIC_METRICS.reset()
    with _IciSpy() as spy:
        got = _runner().execute(GROUPBY)
    assert_rows_close(got, groupby_expected(), ordered=False, rtol=RTOL)
    assert spy.called >= 1 and spy.engaged == 0
    assert FABRIC_METRICS.snapshot()["ici"]["fallbacks"] >= 1
    assert got.runtime_stats.get(
        "exchangeFabricIciFallbacks", {}).get("sum", 0) >= 1


def test_failed_sibling_aborts_ici_stage():
    class Boom(RuntimeError):
        pass

    def inject(fragment_id, task_index, attempt):
        if task_index == 1:
            raise Boom(f"injected failure in fragment {fragment_id}")

    class FaultyRunner(DistributedQueryRunner):
        def _scheduler_config(self):
            cfg = super()._scheduler_config()
            cfg.fault_injector = inject
            return cfg

    runner = FaultyRunner("sf0.01", config=_cfg(), n_tasks=8,
                          mesh=cpu_mesh(), device="cpu")
    with _IciSpy() as spy:
        with pytest.raises(Boom):
            runner.execute(GROUPBY)
    assert spy.engaged == 0, "ICI exchange ran despite a failed sibling"


def test_chunk_rows_drive_chunk_count():
    FABRIC_METRICS.reset()
    small = _runner(ici_chunk_rows=256).execute(GROUPBY)
    chunks_small = FABRIC_METRICS.snapshot()["ici"]["chunks"]
    FABRIC_METRICS.reset()
    big = _runner(ici_chunk_rows=1 << 14).execute(GROUPBY)
    chunks_big = FABRIC_METRICS.snapshot()["ici"]["chunks"]
    assert chunks_small > chunks_big >= 1
    assert_rows_close(small, big, ordered=False, rtol=RTOL)


def test_consumer_packs_chunks(monkeypatch):
    """Many small chunks reach a consumer packed into dense batches of
    about positions x the page path's pack (cut here to batch_rows = 512
    rows), with the rows of the page path."""
    from presto_tpu_torch.exec import scheduler as S
    monkeypatch.setattr(S, "EXCHANGE_PACK_ROWS", 64)
    packs = []
    orig = S._pack_chunks

    def spy(chunks):
        out = orig(chunks)
        live = sum(int(b.mask.sum()) for b in chunks)
        assert out.capacity == live == int(out.mask.sum())
        packs.append(len(chunks))
        return out
    monkeypatch.setattr(S, "_pack_chunks", spy)
    got = DistributedQueryRunner("sf0.01", config=ExecutionConfig(
        batch_rows=512, ici_chunk_rows=64), n_tasks=2, mesh=cpu_mesh(2),
        device="cpu").execute(GROUPBY)
    # each consumer: about 1,000 partial groups in chunks of 2 x 64
    # slots, packed 2 x 512 slots at a time
    assert packs.count(8) >= 2, packs
    assert_rows_close(got, groupby_expected(), ordered=False, rtol=RTOL)


def test_explain_shows_chosen_fabric():
    text = _runner().execute("EXPLAIN " + GROUPBY).rows[0][0]
    assert "fabric=ici" in text, text
    text = _runner(fabric="http").execute("EXPLAIN " + GROUPBY).rows[0][0]
    assert "fabric=http" in text and "fabric=ici" not in text, text
    text = _runner().execute("EXPLAIN (TYPE VALIDATE) " + GROUPBY).rows[0][0]
    assert "EXCHANGE_FABRIC" not in text, text


def test_ici_chunk_tuner_feedback():
    """The port's tuner (a host copy) against the reference's, observation
    for observation."""
    from presto_tpu.parallel.fabric import IciChunkTuner as JT
    from presto_tpu_torch.parallel.fabric import IciChunkTuner as TT
    j, t = JT(), TT()
    seq = [0.1, 0.7, 0.95] + [0.0] * 30 + [1.0] * 30 + [0.5, 0.2]
    assert t.chunk_rows() == j.chunk_rows() == TT.DEFAULT_ROWS
    for f in seq:
        j.observe(f)
        t.observe(f)
        assert t.chunk_rows() == j.chunk_rows()
    t.reset()
    assert t.chunk_rows() == TT.DEFAULT_ROWS


def test_auto_chunk_rows_feed_the_tuner():
    """exchange.ici-chunk-rows 0 asks the tuner for the chunk size and
    feeds it this run's overlap fraction."""
    from presto_tpu_torch.parallel.fabric import IciChunkTuner
    ICI_CHUNK_TUNER.reset()
    FABRIC_METRICS.reset()
    try:
        _runner().execute(GROUPBY)
        rows = ICI_CHUNK_TUNER.chunk_rows()
        assert IciChunkTuner.MIN_ROWS <= rows <= IciChunkTuner.MAX_ROWS
        assert FABRIC_METRICS.snapshot()["ici"]["chunks"] >= 1
    finally:
        ICI_CHUNK_TUNER.reset()


def test_exchange_properties_parse():
    from presto_tpu_torch.worker.properties import (
        SystemConfig, execution_config_from_properties)
    cfg = execution_config_from_properties(
        {"exchange.fabric": "ICI", "exchange.ici-chunk-rows": "2048"})
    assert cfg.exchange_fabric == "ici" and cfg.ici_chunk_rows == 2048
    with pytest.raises(ValueError):
        execution_config_from_properties({"exchange.ici-chunk-rows": "0"})
    assert SystemConfig({}).get("exchange.ici-chunk-rows") == 0
    assert ExecutionConfig().ici_chunk_rows == 0


# ---------------------------------------------------------------------------
# TPC-H through the mesh against the golden rows
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def golden_doc():
    return golden.load()


@pytest.fixture(scope="module")
def mesh_runner():
    return DistributedQueryRunner("sf0.01", n_tasks=2, mesh=cpu_mesh(4),
                                  device="cpu")


@pytest.fixture(scope="module")
def mesh_part_runner():
    return DistributedQueryRunner("sf0.01", n_tasks=3, broadcast_threshold=0,
                                  mesh=cpu_mesh(4), device="cpu")


@pytest.mark.parametrize("q", [q for q in sorted(ALL) if q != 21])
def test_tpch_through_the_mesh_equals_the_golden_rows(mesh_runner,
                                                      golden_doc, q):
    ent = golden_doc["queries"][str(q)]
    res = mesh_runner.execute(ALL[q])
    assert_rows_close(res, golden_result(ent), ordered=q in ORDERED,
                      rtol=RTOL)


def test_tpch_q21_partitioned_through_the_mesh(mesh_part_runner,
                                                golden_doc):
    with _IciSpy() as spy:
        res = mesh_part_runner.execute(ALL[21])
    assert spy.engaged >= 1
    assert_rows_close(res, golden_result(golden_doc["queries"]["21"]),
                      ordered=21 in ORDERED, rtol=RTOL)
