"""The intra-task local exchange and the scan drivers
(presto_tpu_torch/exec/local_exchange.py, ExecutionConfig.
task_concurrency), held to the reference (presto_tpu/exec/
local_exchange.py, tests/test_local_exchange.py):

  * ROUND_ROBIN, HASH and BROADCAST routing, the drains' overlap, error
    relay and early-exit paths, as the reference's cases;
  * HASH routing gives every int64 key the consumer the reference's
    LocalExchange gives it (eager jnp on the same keys);
  * task_concurrency > 1 drains a scan's splits on driver threads: the
    rows equal the single-driver rows and the reference's numpy oracle,
    and the per-driver walls land in the scan's operator stats."""
import threading
import time

import numpy as np
import pytest
import torch

from presto_tpu_torch.exec.batch import Batch, Column
from presto_tpu_torch.exec.local_exchange import (
    LocalExchange, background_drain, on_caller_stream, parallel_drain)
from presto_tpu_torch.exec.pipeline import (ExecutionConfig, PlanCompiler,
                                            TaskContext)
from presto_tpu_torch.exec.runner import LocalQueryRunner, pages_to_result
from presto_tpu_torch.spi import plan as P
from presto_tpu_torch.sql.planner import Planner
from torch_rows import assert_rows_close
from torch_threads import one_torch_thread  # noqa: F401

ORDERSTATUS = ("select o_orderstatus, count(*), sum(o_totalprice) "
               "from orders group by o_orderstatus")
Q1 = """
select l_returnflag, l_linestatus, sum(l_quantity), sum(l_extendedprice),
       sum(l_extendedprice * (1 - l_discount)), avg(l_quantity), count(*)
from lineitem where l_shipdate <= date '1998-09-02'
group by l_returnflag, l_linestatus
"""


def _batch(vals):
    v = torch.as_tensor(np.asarray(vals, dtype=np.int64))
    return Batch({"k": Column(v)}, torch.ones(len(v), dtype=torch.bool))


def _live_keys(batches):
    out = []
    for b in batches:
        out.extend(b.columns["k"].values[b.mask].tolist())
    return out


def test_round_robin_routes_all_batches():
    ex = LocalExchange(3, "ROUND_ROBIN")
    ex.add_producer()
    for i in range(7):
        ex.push(_batch([i]))
    ex.producer_finished()
    got = [sum(1 for _ in ex.consume(c)) for c in range(3)]
    assert sum(got) == 7
    assert max(got) - min(got) <= 1          # balanced


def test_hash_partitions_are_disjoint_and_complete():
    ex = LocalExchange(4, "HASH", keys=["k"])
    ex.add_producer()
    keys = list(range(100))
    ex.push(_batch(keys))
    ex.producer_finished()
    per_part = [set(_live_keys(ex.consume(c))) for c in range(4)]
    assert set().union(*per_part) == set(keys)
    for i in range(4):
        for j in range(i + 1, 4):
            assert not (per_part[i] & per_part[j])


def test_hash_routing_is_deterministic_per_key():
    # equal keys from DIFFERENT producers land on the same consumer
    ex1 = LocalExchange(4, "HASH", keys=["k"])
    ex2 = LocalExchange(4, "HASH", keys=["k"])
    for ex in (ex1, ex2):
        ex.add_producer()
        ex.push(_batch(list(range(50))))
        ex.producer_finished()
    for c in range(4):
        assert sorted(_live_keys(ex1.consume(c))) \
            == sorted(_live_keys(ex2.consume(c)))


@pytest.mark.parametrize("n_consumers", [2, 3, 4, 7])
def test_hash_routing_matches_reference(n_consumers):
    """Every key goes to the consumer the reference's LocalExchange sends
    it to: the reference hashes with its uint64 splitmix64 and takes the
    remainder in uint64; the port emulates both in int64."""
    import jax.numpy as jnp
    from presto_tpu.exec.batch import Batch as JBatch
    from presto_tpu.exec.batch import Column as JColumn
    from presto_tpu.exec.local_exchange import LocalExchange as JExchange
    rng = np.random.default_rng(13)
    keys = np.concatenate([
        np.arange(-50, 50, dtype=np.int64),
        rng.integers(-2 ** 62, 2 ** 62, 400, dtype=np.int64),
        np.array([np.iinfo(np.int64).min, np.iinfo(np.int64).max],
                 dtype=np.int64)])
    ex = LocalExchange(n_consumers, "HASH", keys=["k"], capacity=0)
    jex = JExchange(n_consumers, "HASH", keys=["k"], capacity=0)
    ex.add_producer()
    jex.add_producer()
    ex.push(_batch(keys))
    jex.push(JBatch({"k": JColumn(jnp.asarray(keys))},
                    jnp.ones(len(keys), dtype=bool)))
    ex.producer_finished()
    jex.producer_finished()
    for c in range(n_consumers):
        want = []
        for b in jex.consume(c):
            want.extend(np.asarray(b.columns["k"].values)[
                np.asarray(b.mask)].tolist())
        assert _live_keys(ex.consume(c)) == want, c


def test_broadcast_replicates():
    ex = LocalExchange(3, "BROADCAST")
    ex.add_producer()
    ex.push(_batch([1, 2]))
    ex.producer_finished()
    for c in range(3):
        assert _live_keys(ex.consume(c)) == [1, 2]


def test_parallel_drain_overlaps_sources():
    # overlap asserted structurally (peak simultaneous active sources
    # seen from inside the iterators), not by wall-clock inequalities
    active = [0]
    peak = [0]
    lock = threading.Lock()

    def slow(n):
        def it():
            with lock:
                active[0] += 1
                peak[0] = max(peak[0], active[0])
            try:
                for i in range(3):
                    time.sleep(0.05)
                    yield (n, i)
            finally:
                with lock:
                    active[0] -= 1
        return it
    stats = {}
    got = list(parallel_drain([slow(a) for a in range(4)], 4, stats))
    assert sorted(got) == sorted((a, i) for a in range(4) for i in range(3))
    assert peak[0] > 1                         # sources genuinely overlapped
    assert len(stats["driver_walls"]) == 4
    assert all(w > 0 for w in stats["driver_walls"])


def test_parallel_drain_propagates_errors():
    def boom():
        yield 1
        raise ValueError("driver failure")
    with pytest.raises(ValueError, match="driver failure"):
        list(parallel_drain([boom, boom], 2))


def test_parallel_drain_early_consumer_exit_unblocks_drivers():
    """A consumer that stops pulling (downstream LIMIT) must not leave
    driver threads blocked on the exchange."""
    before = threading.active_count()

    def source(n):
        def it():
            for i in range(100):
                yield (n, i)
        return it
    gen = parallel_drain([source(a) for a in range(4)], 4)
    got = [next(gen) for _ in range(3)]
    gen.close()                       # early exit
    assert len(got) == 3
    deadline = time.time() + 5
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before + 1   # drivers exited


def test_background_drain_close_stops_producer():
    before = threading.active_count()

    def it():
        for i in range(1000):
            yield i
    wall = [0.0]
    gen = background_drain(it(), wall_out=wall)
    assert next(gen) == 0
    gen.close()
    deadline = time.time() + 5
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before + 1


def test_cpu_thunks_run_as_given():
    thunks = [lambda: iter([1, 2])]
    assert on_caller_stream(thunks, torch.device("cpu")) == thunks


@pytest.fixture(scope="module")
def reference():
    """The JAX package's runner: only its numpy oracle runs."""
    from presto_tpu.exec.runner import LocalQueryRunner as JRunner
    return JRunner("sf0.01")


def _with_node_stats(config, sql):
    """The query through a compiler whose operator stats are on: its
    result and the stats."""
    planner = Planner(default_schema="sf0.01", default_catalog="tpch")
    from presto_tpu_torch.sql import parser as A
    output = planner.plan_query_to_output(A.parse_sql(sql))
    comp = PlanCompiler(TaskContext(config=config, stats={}))
    res = pages_to_result(comp.run_to_pages(output), output.column_names,
                          [v.type for v in output.outputs])
    return res, comp.ctx.stats, output


@pytest.mark.parametrize("sql", [ORDERSTATUS, Q1], ids=["orderstatus", "q1"])
def test_scan_driver_concurrency_parity_and_stats(reference, sql):
    """task_concurrency > 1 drains scan splits on driver threads: the rows
    equal the serial engine's and the reference's numpy oracle, and the
    scan's operator stats carry one wall per split driver."""
    serial = LocalQueryRunner("sf0.01", device="cpu", config=ExecutionConfig(
        batch_rows=1 << 13, splits_per_scan=4))
    cfg = ExecutionConfig(batch_rows=1 << 13, splits_per_scan=4,
                          task_concurrency=4, fuse_pipelines=False)
    conc = LocalQueryRunner("sf0.01", device="cpu", config=cfg)
    got = conc.execute(sql)
    assert sorted(got.rows) == sorted(serial.execute(sql).rows)
    assert_rows_close(got, reference.execute_reference(sql), ordered=False)
    res, stats, output = _with_node_stats(cfg, sql)
    assert sorted(res.rows) == sorted(got.rows)
    scans = [n.id for n in P.walk_plan(output)
             if isinstance(n, P.TableScanNode)]
    walls = stats[scans[0]]["driver_walls"]
    assert len(walls) == 4 and all(w > 0 for w in walls)


def test_scan_driver_failure_propagates(monkeypatch):
    """A driver's exception reaches the query (nothing is retried)."""
    from presto_tpu_torch.connectors import catalog
    orig = catalog.generate_column

    def fail(table, column, *a, **kw):
        if table == "nation":
            raise RuntimeError("generator failed in a driver")
        return orig(table, column, *a, **kw)
    monkeypatch.setattr(catalog, "generate_column", fail)
    conc = LocalQueryRunner("sf0.01", device="cpu", config=ExecutionConfig(
        splits_per_scan=4, task_concurrency=4, fuse_pipelines=False))
    with pytest.raises(RuntimeError, match="generator failed in a driver"):
        conc.execute("select sum(n_nationkey) from nation")


def test_drivers_stress_lose_no_batch_or_cache_entry():
    """More drivers than cores, with a short switch interval: every
    source's items arrive exactly once, and the whole-column string
    caches' FIFO insert (which drivers may reach from several threads)
    keeps its bound and loses no insert of the last window."""
    import os
    import sys

    from presto_tpu_torch.exec import pipeline as tp
    n = 4 * (os.cpu_count() or 4)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def source(a):
            return lambda: ((a, i) for i in range(50))
        got = list(parallel_drain([source(a) for a in range(n)], n))
        assert sorted(got) == [(a, i) for a in range(n) for i in range(50)]

        cache = {}
        errors = []

        def fill(t):
            try:
                for i in range(300):
                    tp._cache_put(cache, (t, i), i)
            except Exception as e:       # noqa: BLE001 -- reported below
                errors.append(e)
        threads = [threading.Thread(target=fill, args=(t,))
                   for t in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors
        assert len(cache) == tp._COLUMN_CACHE_MAX_ENTRIES
    finally:
        sys.setswitchinterval(old)
