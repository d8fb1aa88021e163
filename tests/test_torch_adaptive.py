"""Adaptive execution in the port (presto_tpu_torch/exec/adaptive.py, a
copy of the reference's, and its use by exec/scheduler.py and the scan's
runtime filter), held to the reference:

  * the dynamic-filter summaries (summarize_key_column, merge, the wire
    form, the collector) and the exchange decisions equal the
    reference's on seeded inputs;
  * through the port's DistributedQueryRunner on the CPU (the reference
    test's AQE shape, tests/test_adaptive.py): the partitioned ->
    broadcast flip and the INNER side swap happen, each recorded in the
    decision log, ADAPTIVE_METRICS and RuntimeStats, and the rows equal
    the reference's numpy oracle; a dynamic filter collected from a
    finished build stage prunes a later stage's scan (rows and zone-map
    chunks), metered where the reference meters it; with adaptive
    execution off nothing is recorded and the rows stay equal."""
import numpy as np
import pytest

from presto_tpu_torch.exec import adaptive as TA
from presto_tpu_torch.exec.adaptive import (ADAPTIVE_METRICS,
                                            reset_adaptive_metrics)
from presto_tpu_torch.exec.pipeline import ExecutionConfig
from presto_tpu_torch.exec.runner import DistributedQueryRunner
from torch_rows import assert_rows_close
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _fresh_metrics():
    reset_adaptive_metrics()
    yield


def _inputs(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(0, 300))
    kind = seed % 4
    if kind == 0:
        values = rng.integers(-50, 50, n).astype(np.int64)
    elif kind == 1:
        values = rng.integers(0, 10**9, n).astype(np.int64)
    elif kind == 2:
        values = rng.integers(0, 20, n).astype(np.int32)
    else:
        values = rng.normal(size=n)
    mask = None if seed % 3 == 0 else rng.random(n) < 0.7
    return values, mask


@pytest.mark.parametrize("seed", range(12))
@pytest.mark.parametrize("cap", [4, 16, 256])
def test_summaries_equal_the_reference(seed, cap):
    from presto_tpu.exec import adaptive as JA
    values, mask = _inputs(seed)
    j = JA.summarize_key_column("df_0", values, mask, cap)
    t = TA.summarize_key_column("df_0", values, mask, cap)
    assert t.to_dict() == j.to_dict()
    values2, mask2 = _inputs(seed + 100)
    j2 = JA.summarize_key_column("df_0", values2, mask2, cap)
    t2 = TA.summarize_key_column("df_0", values2, mask2, cap)
    assert t.merge(t2, cap).to_dict() == j.merge(j2, cap).to_dict()
    jc, tc = JA.DynamicFilterCollector(cap), TA.DynamicFilterCollector(cap)
    for a, b in ((j, t), (j2, t2)):
        jc.publish(a)
        tc.publish(b)
    assert TA.summaries_to_runtime({"df_0": tc.get("df_0")}) == \
        JA.summaries_to_runtime({"df_0": jc.get("df_0")})
    assert TA.DynamicFilterSummary.from_dict(t.to_dict()) == t


def test_exchange_decisions_equal_the_reference():
    from presto_tpu.exec import adaptive as JA
    sizes = (None, 0, 1, 29, 100, 4_000, 5_000, 10_000, 15_000, 600_000,
             10_000_000)
    for planned in sizes:
        for observed in sizes[1:]:
            for threshold in (0, 5_000, 600_000):
                assert TA.decide_exchange(planned, observed, threshold) == \
                    JA.decide_exchange(planned, observed, threshold)
            assert TA.decide_side_swap(planned, observed) == \
                JA.decide_side_swap(planned, observed)


# the `+ 0` hides the range from the stats calculator, so the PLANNED
# build (about 0.9 x orders) sits far above the OBSERVED 29 rows -- the
# reference test's flip-to-broadcast setup
AQE_SQL = """
SELECT sum(l_extendedprice * (1 - l_discount)) AS revenue, count(*) AS cnt
FROM lineitem, orders
WHERE l_orderkey = o_orderkey AND o_orderkey + 0 < 30
"""
# the planner builds orders (the smaller estimate) and probes lineitem;
# the hidden filter leaves about 120 lineitem rows against 15,000 orders,
# so the scheduler swaps the sides before the join stage launches
SWAP_SQL = """
select count(*), sum(o_totalprice) from lineitem, orders
where l_orderkey = o_orderkey and l_orderkey + 0 < 30
"""
_AQE_CFG = dict(batch_rows=1 << 14, storage_zone_rows=4096)


def _dist_runner(threshold=5000, **over):
    return DistributedQueryRunner(
        "sf0.01", config=ExecutionConfig(**{**_AQE_CFG, **over}),
        n_tasks=2, broadcast_threshold=threshold, device="cpu")


@pytest.fixture(scope="module")
def oracle():
    from presto_tpu.exec.runner import LocalQueryRunner as JRunner
    runner = JRunner("sf0.01")
    return {sql: runner.execute_reference(sql) for sql in (AQE_SQL,
                                                           SWAP_SQL)}


def _stat(res, key):
    return (res.runtime_stats or {}).get(key, {}).get("sum", 0)


def test_underestimated_build_flips_to_broadcast(oracle):
    r = _dist_runner()
    from presto_tpu_torch.spi import plan as P
    sub = r.plan_subplan(AQE_SQL)[0]
    joins = [n for f in sub.all_fragments() for n in P.walk_plan(f.root)
             if isinstance(n, P.JoinNode)]
    assert any(j.distribution == P.PARTITIONED for j in joins), \
        "the join must plan partitioned"
    res = r.execute(AQE_SQL)
    assert_rows_close(res, oracle[AQE_SQL], ordered=False)
    actions = [d.action for d in r.last_scheduler.adaptive.decisions]
    assert actions == ["broadcast"]
    assert ADAPTIVE_METRICS.snapshot()["exchange_broadcast_flips"] == 1
    assert _stat(res, "adaptiveExchangeFlips") == 1


def test_observed_probe_far_smaller_swaps_the_sides(oracle):
    r = _dist_runner(threshold=0)
    res = r.execute(SWAP_SQL)
    assert_rows_close(res, oracle[SWAP_SQL], ordered=False)
    actions = [d.action for d in r.last_scheduler.adaptive.decisions]
    assert actions == ["swap_sides"]
    assert ADAPTIVE_METRICS.snapshot()["exchange_side_swaps"] == 1
    assert _stat(res, "adaptiveSideSwaps") == 1
    # with a broadcast budget the swapped build also flips
    reset_adaptive_metrics()
    r = _dist_runner()
    res = r.execute(SWAP_SQL)
    assert_rows_close(res, oracle[SWAP_SQL], ordered=False)
    assert [d.action for d in r.last_scheduler.adaptive.decisions] == \
        ["swap_sides", "broadcast"]


def test_build_stage_filter_prunes_a_later_scan(oracle):
    """The orders build stage's summary (o_orderkey < 30) reaches the
    lineitem scan of the probe stage: rows and zone-map chunks pruned,
    metered in ADAPTIVE_METRICS (the scan's row filter, as the
    reference's pipeline meters it) and in RuntimeStats."""
    r = _dist_runner(threshold=0)
    res = r.execute(AQE_SQL)
    assert_rows_close(res, oracle[AQE_SQL], ordered=False)
    m = ADAPTIVE_METRICS.snapshot()
    assert m["filters_collected"] > 0
    assert m["filters_applied"] >= 1
    assert m["filter_rows_in"] > m["filter_rows_pruned"] > 0
    assert m["filter_chunks_skipped"] > 0
    assert _stat(res, "dynamicFiltersCollected") >= 1
    assert _stat(res, "dynamicFilterRowsPruned") == m["filter_rows_pruned"]
    assert r.last_scheduler._dyn_filters


def test_adaptive_off_leaves_no_footprint(oracle):
    for sql in (AQE_SQL, SWAP_SQL):
        reset_adaptive_metrics()
        r = _dist_runner(dynamic_filtering=False, adaptive_exchange=False)
        res = r.execute(sql)
        assert_rows_close(res, oracle[sql], ordered=False)
        assert not any(ADAPTIVE_METRICS.snapshot().values())
        assert not r.last_scheduler.adaptive.decisions
