"""The port's serving plane on the CPU at sf0.01: the micro-batcher
(presto_tpu_torch/serving/batching.py), the batched template runner
(serving/batched.py, LocalQueryRunner.execute_prepared_batch), the
plan-cache sidecar and the kernel cache (serving/persist.py), fragment
sharing (serving/fragments.py, PlanCompiler.fragment_jit) and the
server's batch intercept and warm restart -- a port of
tests/test_serving_batch.py.

The load-bearing property: a batched EXECUTE..USING gives ROWS
BIT-IDENTICAL to its solo run, and one lane's bind error never fails its
batchmates.  The port batches only under scan_kernel="xla": there the
solo run is the torch fused chain's direct mode, which the batched
runner replays lane by lane.  Under "auto" and "pallas" the solo run
launches kernel #1 (its plain version here, on the CPU), so the batch
declines (ROADMAP section 3: the reference batches under "auto" off the
TPU, where its solo run is the XLA chain).  So the batched tests run the
port under "xla" and the reference under its default; every lane is held
to the port's solo run exactly and to the reference's rows."""
import dataclasses
import random
import threading
from decimal import Decimal

import pytest
import torch

from presto_tpu.exec.runner import LocalQueryRunner as JRunner
from presto_tpu.serving import PREPARED_REGISTRY as JREGISTRY
from presto_tpu.serving import PlanCache as JPlanCache
from presto_tpu_torch.exec.pipeline import (PlanCompiler, TaskContext,
                                            tuned_config)
from presto_tpu_torch.exec.runner import LocalQueryRunner
from presto_tpu_torch.serving import (FRAGMENT_JIT_CACHE, MicroBatcher,
                                      PREPARED_REGISTRY, PlanCache,
                                      PlanCacheSidecar, SERVING_METRICS)
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _reset_serving():
    SERVING_METRICS.reset()
    PREPARED_REGISTRY.clear()
    JREGISTRY.clear()
    FRAGMENT_JIT_CACHE.invalidate_all()
    yield


def _snapshot():
    return SERVING_METRICS.snapshot()


def _runner(schema="sf0.01", scan_kernel="xla", **cfg):
    config = dataclasses.replace(tuned_config(scan_kernel=scan_kernel),
                                 **cfg)
    return LocalQueryRunner(schema, config=config, plan_cache=PlanCache(),
                            device="cpu")


@pytest.fixture(scope="module")
def ref():
    return JRunner("sf0.01", plan_cache=JPlanCache())


# ---------------------------------------------------------------------------
# MicroBatcher unit behavior
# ---------------------------------------------------------------------------

def test_micro_batcher_disabled_runs_inline():
    b = MicroBatcher(window_ms=50, max_batch=1)
    assert not b.enabled
    calls = []
    out = b.run("k", 1, lambda items: [i * 10 for i in items],
                lambda item: calls.append(item) or item + 100)
    assert out == 101 and calls == [1]


def test_micro_batcher_groups_concurrent_items():
    b = MicroBatcher(window_ms=200, max_batch=8)
    results, solo = {}, []

    def worker(i):
        results[i] = b.run(
            "k", i, lambda items: [x * 10 for x in items],
            lambda item: solo.append(item) or item)
    ts = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert results == {0: 0, 1: 10, 2: 20, 3: 30}
    assert solo == []       # everyone rode the batch


def test_micro_batcher_full_batch_short_circuits_window():
    b = MicroBatcher(window_ms=10_000, max_batch=2)
    results = {}

    def worker(i):
        results[i] = b.run("k", i, lambda items: [x + 1 for x in items],
                           lambda item: -item)
    ts = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in ts), "window was not cut short"
    assert results == {0: 1, 1: 2}


def test_micro_batcher_none_lane_falls_back_isolated():
    b = MicroBatcher(window_ms=200, max_batch=8)
    results = {}

    def execute_batch(items):
        return [None if x == 1 else x * 10 for x in items]

    def worker(i):
        results[i] = b.run("k", i, execute_batch, lambda item: -item)
    ts = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert results[1] == -1             # solo fallback, on its own thread
    assert results[0] == 0 and results[2] == 20
    assert _snapshot()["servingBatchFallbacks"] == 1


def test_micro_batcher_batch_exception_everyone_falls_back():
    b = MicroBatcher(window_ms=200, max_batch=8)
    results = {}

    def worker(i):
        results[i] = b.run(
            "k", i, lambda items: (_ for _ in ()).throw(RuntimeError()),
            lambda item: item + 100)
    ts = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert results == {0: 100, 1: 101, 2: 102}
    assert _snapshot()["servingBatchFallbacks"] == 3


def test_micro_batcher_single_item_runs_solo():
    b = MicroBatcher(window_ms=1, max_batch=8)
    batches = []
    out = b.run("k", 7, lambda items: batches.append(items) or [70],
                lambda item: item)
    assert out == 7 and batches == []   # occupancy 1: never drained


# ---------------------------------------------------------------------------
# batched execution: bit-identity with the solo runs
# ---------------------------------------------------------------------------

Q6_TEMPLATE = ("select sum(l_extendedprice * l_discount) as revenue "
               "from lineitem where l_shipdate >= ? and l_shipdate < ? "
               "and l_discount between ? and ? and l_quantity < ?")
GROUPED_TEMPLATE = ("select l_returnflag, count(*) as c, "
                    "sum(l_quantity) as q, min(l_extendedprice) as lo, "
                    "max(l_extendedprice) as hi from lineitem "
                    "where l_quantity < ? group by l_returnflag")
# float64 sums and averages: bit identity is the hard part
DOUBLE_TEMPLATE = ("select l_linestatus, sum(cast(l_extendedprice as "
                   "double) * ?) as s, avg(cast(l_discount as double)) "
                   "as a from lineitem where l_quantity < ? "
                   "group by l_linestatus")
Q6_BINDS = [
    "execute q6 using date '1994-01-01', date '1995-01-01', "
    "0.05, 0.07, 24",
    "execute q6 using date '1994-01-01', date '1995-01-01', "
    "0.04, 0.06, 30",
    "execute q6 using date '1995-01-01', date '1996-01-01', "
    "0.01, 0.03, 10",
]


def _rows_equal(a, b):
    return sorted(map(tuple, a)) == sorted(map(tuple, b))


def test_batched_q6_bit_identical_to_sequential(ref):
    r = _runner()
    r.execute(f"prepare q6 from {Q6_TEMPLATE}")
    ref.execute(f"prepare q6 from {Q6_TEMPLATE}")
    seq = [r.execute(s).rows for s in Q6_BINDS]
    SERVING_METRICS.reset()
    out = r.execute_prepared_batch(Q6_BINDS)
    assert out is not None
    for a, b, s in zip(seq, out, Q6_BINDS):
        assert b is not None and a == b.rows    # exact, order and all
        assert b.rows == ref.execute(s).rows
    sv = _snapshot()
    assert sv["servingBatches"] == 1
    assert sv["servingBatchQueries"] == 3
    assert sv["servingBatchLaunchesSaved"] == 2
    assert sv["servingBatchOccupancy"] == {"3": 1}
    assert sv["servingBatchPaddedLanes"] == 1   # 3 lanes -> width 4
    assert sv["preparedFastPath"] == 3
    assert out[0].runtime_stats["servingBatchOccupancy"]["sum"] == 3
    assert out[0].runtime_stats["servingBatchLaunchNanos"]["sum"] > 0


@pytest.mark.parametrize("template,values", [
    (GROUPED_TEMPLATE, ("11", "24", "37", "50")),
    (DOUBLE_TEMPLATE, ("1.5, 11", "0.5, 24", "3.0, 37", "1.0, 50",
                       "2.5, 7")),
], ids=["grouped", "double"])
def test_batched_grouped_bit_identical(ref, template, values):
    r = _runner()
    r.execute(f"prepare sp from {template}")
    ref.execute(f"prepare sp from {template}")
    binds = [f"execute sp using {v}" for v in values]
    seq = [r.execute(s).rows for s in binds]
    out = r.execute_prepared_batch(binds)
    assert out is not None
    for a, b, s in zip(seq, out, binds):
        assert b is not None and a == b.rows    # floats to the bit
        got, want = sorted(b.rows), sorted(ref.execute(s).rows)
        if template is GROUPED_TEMPLATE:
            assert got == want
        else:
            # the reference's float sums run in another order: rtol 1e-12
            assert [g[0] for g in got] == [w[0] for w in want]
            for g, w in zip(got, want):
                assert g[1:] == pytest.approx(w[1:], rel=1e-12)


@pytest.mark.parametrize("scan_kernel", ["auto", "pallas"])
def test_batched_declines_where_the_solo_run_launches_a_kernel(
        scan_kernel):
    """Under auto and pallas the solo run takes kernel #1 (its plain
    version on the CPU): the batch declines and the lanes run solo."""
    r = _runner(scan_kernel=scan_kernel)
    r.execute(f"prepare q6 from {Q6_TEMPLATE}")
    seq = [r.execute(s).rows for s in Q6_BINDS]
    assert r.execute_prepared_batch(Q6_BINDS) is None
    assert _snapshot()["servingBatches"] == 0
    assert [r.execute(s).rows for s in Q6_BINDS] == seq
    x = _runner()
    x.execute(f"prepare q6 from {Q6_TEMPLATE}")
    assert [x.execute(s).rows for s in Q6_BINDS] == seq


def test_batched_bind_error_lane_is_isolated():
    r = _runner()
    r.execute(f"prepare sp from {GROUPED_TEMPLATE}")
    binds = ["execute sp using 24",
             "execute sp using 'not a number'",     # bad bind mid-batch
             "execute sp using 30"]
    want0 = r.execute(binds[0]).rows
    want2 = r.execute(binds[2]).rows
    out = r.execute_prepared_batch(binds)
    assert out is not None
    assert out[1] is None                   # the caller runs it solo
    assert out[0].rows == want0 and out[2].rows == want2


def test_batched_null_bind_lane_is_isolated(ref):
    r = _runner()
    r.execute(f"prepare sp from {GROUPED_TEMPLATE}")
    ref.execute(f"prepare sp from {GROUPED_TEMPLATE}")
    binds = ["execute sp using 24", "execute sp using null",
             "execute sp using 30"]
    r.execute(binds[0])
    out = r.execute_prepared_batch(binds)
    assert out is not None and out[1] is None   # NULL replans solo
    assert out[0].rows == r.execute(binds[0]).rows
    assert out[2].rows == r.execute(binds[2]).rows
    assert r.execute(binds[1]).rows == ref.execute(binds[1]).rows == []


def test_batched_declines_mixed_templates_and_cold_cache():
    r = _runner()
    r.execute(f"prepare q6 from {Q6_TEMPLATE}")
    r.execute(f"prepare sp from {GROUPED_TEMPLATE}")
    # cold: no solo execution recorded the fast path yet
    assert r.execute_prepared_batch(
        ["execute sp using 1", "execute sp using 2"]) is None
    r.execute("execute sp using 24")
    assert r.execute_prepared_batch(
        ["execute sp using 24", Q6_BINDS[0]]) is None
    assert r.execute_prepared_batch(["execute sp using 24"]) is None
    assert r.execute_prepared_batch(
        ["execute sp using 24", "select 1"]) is None
    assert r.execute_prepared_batch(
        ["execute sp using 24", "execute nosuch using 1"]) is None


def test_batched_drain_failure_pins_the_template_sequential(monkeypatch):
    from presto_tpu_torch.serving import batched
    r = _runner()
    r.execute(f"prepare sp from {GROUPED_TEMPLATE}")
    r.execute("execute sp using 24")

    def boom(self, lanes):
        raise RuntimeError("drain failed")
    monkeypatch.setattr(batched.BatchedTemplateRunner, "run", boom)
    binds = ["execute sp using 24", "execute sp using 30"]
    assert r.execute_prepared_batch(binds) is None
    monkeypatch.undo()
    # disable_for pinned the (poisoned, not returned) compiler; the
    # pooled one still batches
    assert r.execute_prepared_batch(binds) is not None


def test_batched_fuzz_concurrent_mixed_binds():
    """Randomized concurrent EXECUTE..USING traffic through the batcher:
    mixed templates, bad binds mid-batch; every batched result equals
    the solo run of the same statement."""
    rng = random.Random(20260807)
    r = _runner()
    r.execute(f"prepare q6 from {Q6_TEMPLATE}")
    r.execute(f"prepare sp from {GROUPED_TEMPLATE}")

    def q6_stmt():
        y0 = rng.choice(["1993", "1994", "1995"])
        lo = rng.choice(["0.01", "0.03", "0.05"])
        q = rng.randint(5, 49)
        return (f"execute q6 using date '{y0}-01-01', "
                f"date '{int(y0) + 1}-01-01', {lo}, "
                f"{float(lo) + 0.02:.2f}, {q}")

    def sp_stmt():
        if rng.random() < 0.15:
            return "execute sp using 'bogus'"        # bind error lane
        return f"execute sp using {rng.randint(1, 50)}"

    stmts = [q6_stmt() if rng.random() < 0.5 else sp_stmt()
             for _ in range(24)]
    expected = []
    for s in stmts:
        try:
            expected.append(r.execute(s).rows)
        except Exception as e:    # noqa: BLE001 -- bind errors expected
            expected.append(type(e).__name__)

    batcher = MicroBatcher(window_ms=150, max_batch=8)
    got = [None] * len(stmts)

    def serve(i):
        s = stmts[i]

        def run_one(item):
            try:
                return r.execute(item).rows
            except Exception as e:  # noqa: BLE001
                return type(e).__name__

        def run_batch(items):
            out = r.execute_prepared_batch(items)
            return None if out is None else [
                (o.rows if o is not None else None) for o in out]
        got[i] = batcher.run((s.split()[1],), s, run_batch, run_one)

    threads = [threading.Thread(target=serve, args=(i,))
               for i in range(len(stmts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i, (want, have) in enumerate(zip(expected, got)):
        if isinstance(want, str):
            assert have == want, f"lane {i}: error class changed"
        else:
            assert want == have, f"lane {i} diverged"
    assert _snapshot()["servingBatches"] >= 1, "no batch ever formed"


def test_batched_results_stable_across_widths():
    """The same statement gives identical rows whatever batch it rides in
    (power-of-two padding, different batchmates)."""
    r = _runner()
    r.execute(f"prepare sp from {GROUPED_TEMPLATE}")
    pin = "execute sp using 24"
    want = r.execute(pin).rows
    others = [f"execute sp using {v}" for v in (5, 11, 17, 29, 35, 41)]
    for width in (2, 3, 5, 7):
        out = r.execute_prepared_batch([pin] + others[:width - 1])
        assert out is not None and out[0].rows == want, width
    assert _snapshot()["servingBatchPaddedLanes"] == 0 + 1 + 3 + 1


def test_checkout_contention_metrics():
    cache = PlanCache()
    r = LocalQueryRunner("sf0.01", plan_cache=cache, device="cpu")
    r.execute("select count(*) from lineitem where l_quantity < 24")
    key = [k for k in cache._entries][0]
    held = [cache.checkout(key) for _ in range(6)]   # drain the pool
    sv = _snapshot()
    assert sv["compilerCheckouts"] >= 6
    assert sv["compilerPoolExhausted"] >= 1
    assert sv["compilerCheckoutDepthPeak"] >= 6
    assert cache.info()["checkedOut"] == 6
    for _t, _s, comp in held:
        cache.checkin(key, comp)
    assert cache.info()["checkedOut"] == 0


# ---------------------------------------------------------------------------
# the plan-cache sidecar and the kernel cache
# ---------------------------------------------------------------------------

def test_sidecar_record_dedup_load_clear(tmp_path):
    p = tmp_path / "plans.jsonl"
    sc = PlanCacheSidecar(str(p))
    prepared = {"q6": Q6_TEMPLATE}
    assert sc.record("execute q6 using 1", prepared, "tpch", "sf0.01")
    assert not sc.record("execute q6 using 2", prepared, "tpch", "sf0.01")
    assert sc.record("execute q6 using 1", prepared, "tpch", "sf1")
    assert sc.record("select 1", None, "tpch", "sf0.01")
    assert not sc.record("select 1", None, "tpch", "sf0.01")
    recs = sc.load()
    assert len(recs) == 3 and recs[0]["prepared"] == prepared
    sc2 = PlanCacheSidecar(str(p))          # a restart re-reads the file
    assert not sc2.record("execute q6 using 9", prepared, "tpch", "sf0.01")
    sc2.clear()
    assert sc2.load() == [] and not p.exists()


def test_sidecar_tolerates_torn_tail(tmp_path):
    p = tmp_path / "plans.jsonl"
    sc = PlanCacheSidecar(str(p))
    sc.record("select 1", None, "tpch", "sf0.01")
    with open(p, "a", encoding="utf-8") as f:
        f.write('{"sql": "select 2", "cat')    # torn write at a crash
    assert [r["sql"] for r in PlanCacheSidecar(str(p)).load()] == \
        ["select 1"]


@pytest.fixture()
def gen_dir():
    from presto_tpu_torch.exec.kernels import build
    prev = build.GEN_DIR
    yield build
    build.set_gen_dir(prev)


def test_enable_compilation_cache(tmp_path, gen_dir):
    """The kernel cache is the generated kernels' cubin directory: it
    moves to the given path, and a module loaded before the move is
    written there at its next use (a restarted process loads it instead
    of compiling)."""
    from presto_tpu_torch.serving import enable_compilation_cache
    build = gen_dir
    d = tmp_path / "kernels"
    assert enable_compilation_cache(str(d))
    assert d.is_dir() and build.GEN_DIR == d
    source = "extern \"C\" __global__ void k() {}\n"
    key = build.gen_key(source)

    class Loaded:
        cubin = b"\x7fELF-cubin-bytes"
    build._MODULES[(key, 0)] = Loaded()
    try:
        assert build.load_generated(source, 0) is build._MODULES[(key, 0)]
        assert (d / f"{key}.cubin").read_bytes() == Loaded.cubin
    finally:
        del build._MODULES[(key, 0)]
    (tmp_path / "file").write_text("")
    assert not enable_compilation_cache(str(tmp_path / "file" / "x"))


# ---------------------------------------------------------------------------
# fragment-level step sharing
# ---------------------------------------------------------------------------

SQL_A = "select sum(l_extendedprice) from lineitem where l_quantity < 24"
SQL_B = ("select min(l_extendedprice), max(l_extendedprice) "
         "from lineitem where l_quantity < 24")
# a streaming filter and projection (no fused chain): the filter and
# project sites share too
SQL_S = ("select l_orderkey, l_extendedprice * 2 as x from lineitem "
         "where l_quantity < 2 and l_orderkey < ? order by 1, 2 limit 5")


def test_fragment_share_across_different_plans(ref):
    """Two DIFFERENT plans whose scan subchain is structurally identical
    share fragment entries; a fresh runner (new compilers, its own plan
    cache) shares them too; rows equal the unshared config's and the
    reference's."""
    r1 = _runner(scan_kernel="auto")
    rows_a = r1.execute(SQL_A).rows
    misses_after_a = _snapshot()["fragmentJitMisses"]
    rows_b = r1.execute(SQL_B).rows
    sv = _snapshot()
    assert misses_after_a > 0, "fragment cache never engaged"
    assert sv["fragmentJitHits"] > 0
    hits_before = sv["fragmentJitHits"]
    r2 = _runner(scan_kernel="auto")
    assert r2.execute(SQL_A).rows == rows_a
    assert _snapshot()["fragmentJitHits"] > hits_before
    r3 = _runner(scan_kernel="auto", fragment_share=False)
    assert r3.execute(SQL_A).rows == rows_a
    assert r3.execute(SQL_B).rows == rows_b
    assert rows_a == ref.execute(SQL_A).rows
    assert rows_b == ref.execute(SQL_B).rows


def test_fragment_share_streaming_filter_and_project(ref):
    r1 = _runner(fuse_pipelines=False)
    sql = SQL_S.replace("?", "1000")
    want = r1.execute(sql).rows
    hits = _snapshot()["fragmentJitHits"]
    r2 = _runner(fuse_pipelines=False)
    assert r2.execute(sql).rows == want
    # the scan, filter and project steps all came from the cache
    assert _snapshot()["fragmentJitHits"] >= hits + 3
    assert want == ref.execute(sql).rows
    # a bound parameter rides the shared step's call
    r2.execute(f"prepare s from {SQL_S}")
    r2.execute("execute s using 1000")
    assert r2.execute("execute s using 300").rows == \
        ref.execute(SQL_S.replace("?", "300")).rows


def test_fragment_share_off_uses_no_global_cache():
    r = _runner(fragment_share=False)
    r.execute("select count(*) from lineitem where l_quantity < 24")
    sv = _snapshot()
    assert sv["fragmentJitMisses"] == 0 and sv["fragmentJitHits"] == 0
    assert FRAGMENT_JIT_CACHE.info()["entries"] == 0


def test_fragment_cache_invalidated_by_ddl():
    r = _runner()
    r.execute("select count(*) from lineitem where l_quantity < 24")
    assert FRAGMENT_JIT_CACHE.info()["entries"] > 0
    r._invalidate_plans()
    assert FRAGMENT_JIT_CACHE.info()["entries"] == 0


def test_fragment_share_key_isolates_configs():
    """The key fingerprints the whole execution config: the same plan
    under another config shares nothing."""
    r1 = _runner()
    want = r1.execute(SQL_A).rows
    hits0 = _snapshot()["fragmentJitHits"]
    r2 = _runner(batch_rows=(1 << 16) * 2)
    assert r2.execute(SQL_A).rows == want
    assert _snapshot()["fragmentJitHits"] == hits0


def _scan_node(schema):
    from presto_tpu_torch.spi import plan as P
    out = _runner(schema).plan(SQL_A)
    return next(n for n in P.walk_plan(out)
                if isinstance(n, P.TableScanNode))


@pytest.mark.parametrize("other", ["device", "scale_factor"])
def test_fragment_share_key_isolates_devices_and_tables(other):
    """A CPU compiler and a CUDA compiler (one process holds both in the
    tests) never share a step, nor do the same scans of two scale
    factors; equal ones do."""
    cfg = tuned_config()
    cpu = PlanCompiler(TaskContext(config=cfg, device=torch.device("cpu")))
    node = _scan_node("sf0.01")
    a = cpu.fragment_jit(node, "scan_make", lambda: object(), extra=(1,))
    assert cpu.fragment_jit(node, "scan_make", lambda: object(),
                            extra=(1,)) is a
    if other == "device":
        cuda = PlanCompiler(TaskContext(config=cfg,
                                        device=torch.device("cuda", 0)))
        b = cuda.fragment_jit(node, "scan_make", lambda: object(),
                              extra=(1,))
    else:
        b = cpu.fragment_jit(_scan_node("sf10"), "scan_make",
                             lambda: object(), extra=(1,))
    assert b is not a
    assert FRAGMENT_JIT_CACHE.info()["entries"] == 2


def test_stage_cache_shares_steps_per_stage():
    """A compiler under a stage cache (the scheduler's tasks) shares its
    steps through it by node id, and never through the global cache."""
    stage = {}
    cfg = tuned_config()
    node = _scan_node("sf0.01")
    made = [PlanCompiler(TaskContext(
        config=cfg, device=torch.device("cpu"), shared_steps=stage))
        .fragment_jit(node, "scan_make", lambda: object(), extra=(1,))
        for _ in range(2)]
    assert made[0] is made[1] and len(stage) == 1
    assert FRAGMENT_JIT_CACHE.info()["entries"] == 0


# ---------------------------------------------------------------------------
# the server: batch intercept, properties, warm restart, DDL
# ---------------------------------------------------------------------------

XLA = {"scan_kernel": "xla"}


def test_http_concurrent_executes_one_batched_drain():
    from presto_tpu_torch.client import StatementClient
    from presto_tpu_torch.worker.server import WorkerServer
    srv = WorkerServer(coordinator=True, batch_window_ms=150,
                       max_batch_size=8, device="cpu")
    try:
        c = StatementClient(srv.uri, schema="sf0.01", session=XLA)
        c.execute(f"prepare q6 from {Q6_TEMPLATE}")
        stmts = ["execute q6 using date '1994-01-01', "
                 f"date '1995-01-01', 0.05, 0.07, {20 + i}"
                 for i in range(4)]
        c.execute(stmts[0])     # warm the template's fast path
        SERVING_METRICS.reset()
        results = [None] * 4

        def go(i):
            cc = StatementClient(srv.uri, schema="sf0.01", session=XLA)
            cc.prepared = dict(c.prepared)
            results[i] = cc.execute(stmts[i]).rows
        ts = [threading.Thread(target=go, args=(i,)) for i in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert all(r for r in results)
        sv = _snapshot()
        assert sv["servingBatchQueries"] >= 2, "no batch formed over HTTP"
        assert sv["servingBatchLaunchesSaved"] >= 1
        assert sv["servingBatchFallbacks"] == 0
        # batched lanes equal solo re-runs (occupancy 1 = the solo path)
        for i, s in enumerate(stmts):
            assert c.execute(s).rows == results[i], f"lane {i} diverged"
    finally:
        srv.close()


def test_http_batching_disabled_by_property():
    from presto_tpu_torch.client import StatementClient
    from presto_tpu_torch.worker.server import WorkerServer
    srv = WorkerServer(coordinator=True, max_batch_size=1, device="cpu")
    try:
        assert not srv._batcher.enabled
        c = StatementClient(srv.uri, schema="sf0.01")
        c.execute(f"prepare q6 from {Q6_TEMPLATE}")
        r = c.execute("execute q6 using date '1994-01-01', "
                      "date '1995-01-01', 0.05, 0.07, 24")
        assert r.rows
        assert _snapshot()["servingBatches"] == 0
    finally:
        srv.close()


def _write_etc(tmp_path, extra=""):
    etc = tmp_path / "etc"
    etc.mkdir(exist_ok=True)
    (etc / "config.properties").write_text(
        "coordinator=true\nhttp-server.http.port=0\n" + extra)
    return str(etc)


def test_server_properties_map_serving_keys(tmp_path):
    from presto_tpu.worker import properties as jprops
    from presto_tpu_torch.worker import properties as tprops
    from presto_tpu_torch.worker.server import WorkerServer
    etc = _write_etc(tmp_path,
                     "serving.batch-window-ms=7.5\n"
                     "serving.max-batch-size=32\n"
                     f"serving.compilation-cache-dir={tmp_path / 'k'}\n"
                     f"serving.plan-cache-path={tmp_path / 'p.jsonl'}\n")
    kw, _props = tprops.server_kwargs_from_etc(etc)
    jkw, _ = jprops.server_kwargs_from_etc(etc)
    for k in ("batch_window_ms", "max_batch_size",
              "compilation_cache_dir", "plan_cache_path"):
        assert kw[k] == jkw[k], k
    assert kw["batch_window_ms"] == 7.5 and kw["max_batch_size"] == 32
    for bad in ("serving.max-batch-size=0\n",
                "serving.batch-window-ms=-1\n"):
        with pytest.raises(ValueError):
            tprops.server_kwargs_from_etc(_write_etc(tmp_path, bad))
    # the server boots from them
    from presto_tpu_torch.exec.kernels import build
    prev = build.GEN_DIR
    kw.pop("port", None)
    srv = WorkerServer(device="cpu", **kw)
    try:
        assert srv._batcher.max_batch == 32
        assert srv._sidecar.path == str(tmp_path / "p.jsonl")
        assert build.GEN_DIR == tmp_path / "k"
    finally:
        srv.close()
        build.set_gen_dir(prev)


def test_warm_restart_zero_replans(tmp_path, gen_dir):
    """A server over the same sidecar replays its exemplars before the
    listener opens: the first EXECUTE after the restart is a plan-cache
    hit on the fast path.  In process here; the chip phase restarts in a
    subprocess, where the generated kernels load from the cache."""
    from presto_tpu_torch.client import StatementClient
    from presto_tpu_torch.worker.server import WorkerServer
    kw = {"compilation_cache_dir": str(tmp_path / "kernels"),
          "plan_cache_path": str(tmp_path / "plans.jsonl")}
    stmt = ("execute q6 using date '1994-01-01', "
            "date '1995-01-01', 0.05, 0.07, 24")
    srv = WorkerServer(coordinator=True, device="cpu", **kw)
    try:
        c = StatementClient(srv.uri, schema="sf0.01")
        c.execute(f"prepare q6 from {Q6_TEMPLATE}")
        want = c.execute(stmt).rows
    finally:
        srv.close()
    assert (tmp_path / "plans.jsonl").exists()
    PREPARED_REGISTRY.clear()
    FRAGMENT_JIT_CACHE.invalidate_all()
    srv = WorkerServer(coordinator=True, device="cpu", **kw)   # replays
    try:
        SERVING_METRICS.reset()
        c2 = StatementClient(srv.uri, schema="sf0.01")
        c2.prepared["q6"] = Q6_TEMPLATE
        assert c2.execute(stmt).rows == want
        sv = _snapshot()
        assert sv["planCacheMisses"] == 0, "the restart missed the cache"
        assert sv["preparedReplans"] == 0, "the restart replanned"
        assert sv["preparedFastPath"] == 1
    finally:
        srv.close()


def test_ddl_clears_sidecar(tmp_path):
    from presto_tpu_torch.client import StatementClient
    from presto_tpu_torch.connectors import catalog
    from presto_tpu_torch.connectors.memory import MemoryConnector
    from presto_tpu_torch.worker.server import WorkerServer
    catalog.register_connector("memory", MemoryConnector())
    srv = WorkerServer(coordinator=True, device="cpu",
                       plan_cache_path=str(tmp_path / "plans.jsonl"))
    try:
        c = StatementClient(srv.uri, schema="sf0.01")
        c.execute("select count(*) from lineitem where l_quantity < 24")
        assert srv._sidecar.info()["entries"] == 1
        assert len(srv._runner_cache) == 1
        cm = StatementClient(srv.uri, catalog="memory", schema="sf0.01")
        assert cm.execute("create table t_sidecar as select 1 as x").rows \
            == [[1]]
        assert srv._sidecar.info()["entries"] == 0
        assert srv._runner_cache == {}
        assert cm.execute("select x from t_sidecar").rows == [[1]]
        cm.execute("drop table t_sidecar")
    finally:
        srv.close()
        catalog.unregister_connector("memory")


def test_client_replays_prepare_on_unknown_statement(monkeypatch):
    from presto_tpu_torch.client import StatementClient
    from presto_tpu_torch.worker.server import WorkerServer
    srv = WorkerServer(coordinator=True, device="cpu")
    try:
        c = StatementClient(srv.uri, schema="sf0.01")
        c.execute(f"prepare q6 from {Q6_TEMPLATE}")
        assert "q6" in c.prepared
        stmt = ("execute q6 using date '1994-01-01', "
                "date '1995-01-01', 0.05, 0.07, 24")
        want = c.execute(stmt).rows
        assert want == [[Decimal("1198901.3955")]]
        # a restarted coordinator that lost its registry: the next
        # resolution fails once, and the client's re-PREPARE recovers
        real = LocalQueryRunner._prepared_text
        state = {"failed": False}

        def flaky(self, name, prepared):
            if not state["failed"]:
                state["failed"] = True
                raise KeyError(
                    f"prepared statement {name!r} does not exist")
            return real(self, name, prepared)
        monkeypatch.setattr(LocalQueryRunner, "_prepared_text", flaky)
        assert c.execute(stmt).rows == want
        assert state["failed"], "fault was never exercised"
    finally:
        srv.close()
