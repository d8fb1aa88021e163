"""The port's memory accounting and spill store on the CPU
(presto_tpu_torch/exec/memory.py), held to the reference's
presto_tpu/exec/memory.py: the unit cases of the reference's
tests/test_spill.py run against the port's classes (pool accounting,
arbitration, revocation of a join build under cross pressure, a counted
over-free, revocable bytes exempt from the query limit, a shortened
small-pool no-deadlock stress), the spill store's bucket of every row
equal to the reference store's on the same numpy batches, and the disk
tier's round trip (its chunk bytes equal to the reference's)."""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presto_tpu.exec import batch as jb
from presto_tpu.exec import memory as jmem
from presto_tpu_torch.exec.batch import Batch, Column
from presto_tpu_torch.exec.memory import (
    MEMORY_METRICS, MemoryContext, MemoryExceededError, MemoryPool,
    PartitionedSpillStore, QueryMemoryLimitExceededError, _chunk_from_bytes,
    _chunk_to_bytes)
from presto_tpu_torch.exec.pipeline import (ExecutionConfig, PlanCompiler,
                                            TaskContext,
                                            _RevocableBuildBuffer)
from torch_threads import one_torch_thread  # noqa: F401


# ---------------------------------------------------------------------------
# pool accounting and arbitration
# ---------------------------------------------------------------------------

def test_pool_reserve_free_peak():
    p = MemoryPool(budget=100)
    assert p.try_reserve(60) and p.try_reserve(40)
    assert not p.try_reserve(1)
    p.free(50)
    assert p.try_reserve(30)
    assert p.peak == 100
    with pytest.raises(MemoryExceededError):
        p.reserve(1000)


def test_pool_unlimited_tracks_peak():
    p = MemoryPool()
    assert p.try_reserve(10 ** 12)
    assert p.peak == 10 ** 12


def test_arbitration_revokes_the_largest_holder():
    p = MemoryPool(budget=1000)
    freed = []

    def spiller(h):
        def cb():
            n = h[0].bytes
            h[0].free(n)
            freed.append(h[0].name)
            return n
        return cb

    small, large = [None], [None]
    small[0] = p.register_revocable("small", spiller(small))
    large[0] = p.register_revocable("large", spiller(large))
    assert small[0].try_reserve(300) and large[0].try_reserve(600)
    decliner = p.register_revocable("declines", lambda: 0)
    assert decliner.try_reserve(50)
    # 50 bytes left: the largest victim goes first, and only it
    assert p.try_reserve(500)
    assert freed == ["large"] and p.revocations == 1
    assert p.revoked_bytes == 600 and p.arbitrations == 1
    # nothing revocable left but a decliner and the small holder's 300
    assert not p.try_reserve(1000)
    for h in (small[0], large[0], decliner):
        h.close()
    p.free(500)
    assert p.reserved == 0 and p.revocable == 0


def test_join_build_revocation_under_cross_pressure():
    """An in-flight join build holds revocable memory; a concurrent
    operator's reservation makes the arbitrator revoke it into its grace
    join spill store, and the build keeps accepting batches."""
    before = MEMORY_METRICS.snapshot()
    ctx = TaskContext(config=ExecutionConfig(
        batch_rows=1 << 12, spill_partitions=4, spill_async_staging=False,
        memory_budget_bytes=300_000))
    compiler = PlanCompiler(ctx)
    pool = ctx.memory
    n = 4096

    def mk(i):
        v = torch.arange(n, dtype=torch.int64) + i * n
        return Batch({"k": Column(v)}, torch.ones(n, dtype=torch.bool))

    buf = _RevocableBuildBuffer(compiler, ["k"], spill_enabled=True)
    try:
        buf.add(mk(0))
        buf.add(mk(1))
        assert buf._holder.bytes > 0 and buf.spill is None
        pool.reserve(250_000)
        after = MEMORY_METRICS.snapshot()
        assert after["revocations"] > before["revocations"]
        assert after["revoked_bytes"] > before["revoked_bytes"]
        assert buf.spill is not None and buf._holder.bytes == 0
        buf.add(mk(2))
        collected, spill = buf.finish()
        assert collected == [] and spill is not None
        assert sum(spill.rows) == 3 * n
        pool.free(250_000)
    finally:
        buf.close()
    assert pool.pool.reserved == 0 and pool.pool.revocable == 0


def test_pool_over_free_is_counted_not_clamped_silently():
    before = MEMORY_METRICS.snapshot()
    p = MemoryPool(budget=1000)
    assert p.try_reserve(100)
    p.free(250)
    assert p.reserved == 0
    assert p.over_free_count == 1 and p.over_free_bytes == 150
    after = MEMORY_METRICS.snapshot()
    assert after["over_free"] - before["over_free"] == 1
    assert after["over_free_bytes"] - before["over_free_bytes"] == 150


def test_revocable_bytes_exempt_from_query_limit():
    ctx = MemoryContext(MemoryPool(), "query", max_bytes=100)
    h = ctx.register_revocable("build", lambda: 0)
    assert h.try_reserve(10_000)
    with pytest.raises(QueryMemoryLimitExceededError):
        ctx.reserve(200)
    assert ctx.revocable == 10_000 and ctx.reserved == 0
    h.close()
    assert ctx.revocable == 0 and ctx.pool.revocable == 0


def test_arbitration_stress_tiny_shared_pool_no_deadlock():
    """Threads hammer one tiny pool with holders whose callbacks take
    their own locks (the join-build shape) or decline (the aggregation
    shape): every thread finishes and the pool drains to zero (the
    reference's case, 8 threads x 10 rounds instead of 30)."""
    root = MemoryContext(MemoryPool(budget=64_000), "query")
    errors = []

    def worker(idx):
        try:
            ctx = root.new_child(f"task/{idx}")
            for _round in range(10):
                state_lock = threading.Lock()
                state = {"bytes": 0}

                def revoke():
                    if not state_lock.acquire(blocking=False):
                        return 0
                    try:
                        freed = state["bytes"]
                        state["bytes"] = 0
                        return freed
                    finally:
                        state_lock.release()

                cb = revoke if idx % 2 == 0 else (lambda: 0)
                h = ctx.register_revocable(f"holder/{idx}", cb)
                for _ in range(10):
                    nb = 1000 + idx * 37
                    if h.try_reserve(nb):
                        with state_lock:
                            state["bytes"] += nb
                    if h.revoke_requested:
                        with state_lock:
                            gone = state["bytes"]
                            state["bytes"] = 0
                        h.free(gone)
                h.close()
        except Exception as e:                  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads), "arbitration deadlocked"
    assert not errors, errors
    assert root.pool.reserved == 0 and root.pool.revocable == 0


# ---------------------------------------------------------------------------
# the spill store against the reference's
# ---------------------------------------------------------------------------

def _numpy_batch(seed: int, n: int = 3000):
    """Columns of every dtype the store carries, NULLs, a dictionary
    column and dead rows, as numpy arrays."""
    rng = np.random.default_rng(seed)
    cols = {
        "k64": (rng.integers(-50, 50, n).astype(np.int64),
                rng.random(n) < 0.1),
        "k32": (rng.integers(0, 7, n).astype(np.int32), None),
        "f": (rng.normal(size=n), rng.random(n) < 0.05),
        "b": (rng.random(n) < 0.5, None),
    }
    cols["f"][0][::97] = np.nan
    mask = rng.random(n) < 0.9
    return cols, mask


def _stores(salt, k, keys, batches):
    jst = jmem.PartitionedSpillStore(k, salt=salt)
    tst = PartitionedSpillStore(k, salt=salt)
    for cols, mask in batches:
        jst.add(jb.Batch({n: jb.Column(jnp.asarray(v), None if m is None
                                       else jnp.asarray(m),
                                       ("a", "b", "c", "d", "e", "f", "g")
                                       if n == "k32" else None)
                          for n, (v, m) in cols.items()},
                         jnp.asarray(mask)), keys)
        tst.add(Batch({n: Column(torch.from_numpy(v), None if m is None
                                 else torch.from_numpy(m),
                                 ("a", "b", "c", "d", "e", "f", "g")
                                 if n == "k32" else None)
                       for n, (v, m) in cols.items()},
                      torch.from_numpy(mask)), keys)
    return jst, tst


@pytest.mark.parametrize("keys", [["k64"], ["k32", "f"], ["b", "k64", "f"]],
                         ids=["int64", "dict_float", "bool_int_float"])
@pytest.mark.parametrize("salt", [jmem._SPILL_SALT, 0x511 * 33 + 0x9E37])
def test_bucket_of_every_row_equals_reference(keys, salt):
    batches = [_numpy_batch(s) for s in range(3)]
    jst, tst = _stores(salt, 4, keys, batches)
    assert tst.rows == jst.rows and tst.bytes == jst.bytes
    assert tst.meta == jst.meta
    for p in range(4):
        tchunks, jchunks = tst.bucket_chunks(p), jst.buckets[p]
        assert len(tchunks) == len(jchunks)
        for tc, jc in zip(tchunks, jchunks):
            for name in jc:
                tv, tm = tc[name]
                jv, jm = jc[name]
                np.testing.assert_array_equal(tv.view(np.uint8),
                                              jv.view(np.uint8))
                assert (tm is None) == (jm is None)
                if tm is not None:
                    np.testing.assert_array_equal(tm, jm)


def test_bucket_batches_upload_every_row_once():
    cols, mask = _numpy_batch(5)
    _jst, tst = _stores(jmem._SPILL_SALT, 4, ["k64"], [(cols, mask)])
    got = []
    for p in range(4):
        for b in tst.bucket_batches(p, 512):
            assert b.capacity == 512
            assert b.columns["k32"].dictionary == tuple("abcdefg")
            live = b.mask.numpy()
            got.extend(b.columns["k64"].values.numpy()[live].tolist())
    assert sorted(got) == sorted(cols["k64"][0][mask].tolist())


def test_spill_store_disk_tier_roundtrip(tmp_path):
    """Past the host budget the largest bucket overflows to LZ4 disk
    chunks; bucket_batches reads them back bit-identical, in chunk
    order, and the chunk bytes equal the reference's."""
    store = PartitionedSpillStore(2, budget_bytes=40_000,
                                  spill_path=str(tmp_path))
    n = 2048
    for i in range(8):
        v = torch.arange(n, dtype=torch.int64) + i * n
        store.add(Batch({"k": Column(v)}, torch.ones(n, dtype=torch.bool)),
                  ["k"])
    assert store.disk_bytes > 0, "host budget never overflowed to disk"
    assert store.host_bytes[0] + store.host_bytes[1] <= 40_000
    got = sorted(int(x) for p in range(2)
                 for b in store.bucket_batches(p, 4096)
                 for x in b.columns["k"].values.numpy()[b.mask.numpy()])
    assert got == list(range(8 * n))
    assert store.unspilled_bytes > 0
    store.close()
    assert not list(tmp_path.iterdir())

    rng = np.random.default_rng(3)
    rows = {"a": (rng.integers(-9, 9, 500).astype(np.int64),
                  rng.random(500) < 0.2),
            "d": (rng.normal(size=500), None),
            "c": (rng.integers(0, 3, 500).astype(np.int32), None)}
    payload, cols, nrows = _chunk_to_bytes(rows)
    assert (payload, cols, nrows) == jmem._chunk_to_bytes(rows)
    back = _chunk_from_bytes(payload, cols, nrows)
    for name, (v, m) in rows.items():
        np.testing.assert_array_equal(back[name][0], v)
        if m is None:
            assert back[name][1] is None
        else:
            np.testing.assert_array_equal(back[name][1], m)


def test_host_budget_without_disk_room_raises(tmp_path):
    """A spill path that cannot be written fails the spill: it raises
    instead of dropping rows."""
    blocker = tmp_path / "file"
    blocker.write_text("x")
    store = PartitionedSpillStore(2, budget_bytes=1_000,
                                  spill_path=str(blocker / "sub"))
    v = torch.arange(4096, dtype=torch.int64)
    with pytest.raises(OSError):
        store.add(Batch({"k": Column(v)}, torch.ones(4096, dtype=torch.bool)),
                  ["k"])


def test_async_staging_on_the_cpu_is_a_plain_copy():
    """On the CPU async staging routes each batch as it is added (the
    CUDA stream path runs on the card, in chip_smoke.py)."""
    cols, mask = _numpy_batch(9)
    batch = Batch({n: Column(torch.from_numpy(v), None if m is None
                             else torch.from_numpy(m))
                   for n, (v, m) in cols.items()}, torch.from_numpy(mask))
    sync = PartitionedSpillStore(4)
    asyn = PartitionedSpillStore(4, async_staging=True)
    sync.add(batch, ["k64"])
    asyn.add(batch, ["k64"])
    assert not asyn._inflight
    assert asyn.rows == sync.rows and asyn.bytes == sync.bytes
