"""Execution under a memory budget on the CPU: the reference's TINY
config (tests/test_spill.py: a 200 KB budget, 16K-row batches, 4 spill
partitions) forces the grace hash join, the partitioned aggregation and
the spilled percentile paths of the port (presto_tpu_torch/exec/
pipeline.py).

  * TPC-H Q1-Q22 under TINY equal the JAX package's rows in the golden
    file (presto_tpu_torch/benchmarks/tpch_sf001_rows.json, held to the
    live reference by tests/test_torch_tpch_*.py): ordered queries in
    order, floats within rtol 1e-9 (a spilled bucket sums a group's
    floats in another order);
  * the reference's spill cases: the grace join (INNER, LEFT, a filter)
    and the spilled aggregation (small, high-cardinality, string keys)
    held to one JAX LocalQueryRunner in its default config, with
    spillBytes > 0 showing the spill ran; the streamed global and the
    skew-spilled grouped percentiles against the JAX package's numpy
    oracle (exact nearest rank, up to the summaries' documented rank
    error), the streamed one also bit for bit against the reference's
    summary functions over the same batches (tests/test_torch_agg_
    functions.py holds those functions on their own); spill disabled
    raising MemoryExceededError, no reservation left after a failure,
    query.max-memory raising the typed error; a grown aggregation
    table raising as in the reference (a reference behaviour the port
    mirrors; the one
    fixture, under a budget for that case);
  * W1 under a budget that declines the window kernel's reservation
    (WindowInputSize, then operators.window_batch) and under one that
    lets the launch through, both equal to the JAX package's numpy
    oracle."""
import bisect
import math

import numpy as np
import pytest

from presto_tpu.exec.pipeline import ExecutionConfig as JExecutionConfig
from presto_tpu.exec.runner import LocalQueryRunner as JRunner
from presto_tpu_torch.benchmarks.rows import golden_result
from presto_tpu_torch.benchmarks.tpch_queries import ALL, ORDERED
from presto_tpu_torch.benchmarks.window_queries import W1
from presto_tpu_torch.common.errors import is_retryable
from presto_tpu_torch.exec.memory import (MemoryExceededError,
                                          QueryMemoryLimitExceededError)
from presto_tpu_torch.exec import operators as ops
from presto_tpu_torch.exec.operators import PERCENTILE_SKETCH_POINTS
from presto_tpu_torch.exec.pipeline import ExecutionConfig, PlanCompiler
from presto_tpu_torch.exec.runner import LocalQueryRunner
from torch_rows import assert_rows_close
import torch_tpch_golden as golden
from torch_threads import one_torch_thread  # noqa: F401

TINY = dict(batch_rows=1 << 14, join_out_capacity=1 << 16,
            memory_budget_bytes=200_000, spill_partitions=4)
RTOL = 1e-9


@pytest.fixture(scope="module")
def tiny():
    return LocalQueryRunner(golden.SCHEMA, device="cpu",
                            config=ExecutionConfig(**TINY))


@pytest.fixture(scope="module")
def reference():
    """The JAX package's runner in its default (unbudgeted) config."""
    return JRunner(golden.SCHEMA)


def _spilled(res) -> float:
    return (res.runtime_stats or {}).get("spillBytes", {}).get("sum", 0)


@pytest.mark.parametrize("q", sorted(ALL))
def test_tpch_under_tiny_budget_equals_golden(tiny, q):
    ent = golden.load()["queries"][str(q)]
    res = tiny.execute(ALL[q])
    assert list(res.column_names) == ent["columns"]
    assert_rows_close(res, golden_result(ent), ordered=q in ORDERED,
                      rtol=RTOL)


SPILL_CASES = {
    "grace_join_inner": """
        select l_orderkey, o_orderdate, l_quantity from lineitem
        join orders on l_orderkey = o_orderkey
        where l_orderkey < 1000""",
    "grace_join_left_null_extension": """
        select c_custkey, o_orderkey from customer
        left join orders on c_custkey = o_custkey
        where c_custkey < 500""",
    "grace_join_with_filter": """
        select l_orderkey, l_suppkey from lineitem
        join orders on l_orderkey = o_orderkey
        where o_orderdate < date '1995-01-01' and l_quantity > 45""",
    "spilled_aggregation_small_groups": """
        select o_orderstatus, count(*), sum(o_totalprice), avg(o_totalprice)
        from orders group by o_orderstatus""",
    "spilled_aggregation_high_cardinality": """
        select l_orderkey, count(*), sum(l_quantity)
        from lineitem group by l_orderkey""",
    # a lazy open-domain key (o_clerk) is whole-column encoded before the
    # partitioner hashes it, or a value's group would split across buckets
    "spilled_aggregation_string_keys": """
        select o_clerk, count(*) from orders group by o_clerk""",
}


@pytest.mark.parametrize("name", sorted(SPILL_CASES))
def test_spill_case_equals_reference(tiny, reference, name):
    sql = SPILL_CASES[name]
    res = tiny.execute(sql)
    assert_rows_close(res, reference.execute(sql), ordered=False, rtol=RTOL)
    assert _spilled(res) > 0, res.runtime_stats
    if name == "spilled_aggregation_string_keys":
        assert len(res.rows) <= 30


# (sql, the percentile's column, its fraction, the grouping column or
# None): every global case streams 4 batches of 15000 live rows (past the
# m = 8192 points of a summary); every grouped one has a bucket that one
# key fills past the budget (the per-key summaries of
# _skewed_percentile_bucket, over host chunks of 16384 and 11735 rows)
PERCENTILE_CASES = {
    "global": (
        "select approx_percentile(l_extendedprice, 0.5), count(*), "
        "sum(l_quantity) from lineitem", 0, 0.5, None),
    "global_p90": (
        "select approx_percentile(l_extendedprice, 0.9), count(*) "
        "from lineitem", 0, 0.9, None),
    "global_composes_downstream": (
        "select approx_percentile(l_extendedprice, 0.123) p, count(*) c "
        "from lineitem order by p", 0, 0.123, None),
    "grouped_skewed": (
        "select l_returnflag, approx_percentile(l_quantity, 0.5), "
        "count(*) from lineitem group by l_returnflag", 1, 0.5,
        "l_returnflag"),
    "grouped_skewed_p37": (
        "select l_returnflag, approx_percentile(l_extendedprice, 0.37), "
        "count(*) from lineitem group by l_returnflag", 1, 0.37,
        "l_returnflag"),
}


@pytest.fixture(scope="module")
def lineitem_values(reference):
    """The numpy oracle's l_returnflag, l_quantity and l_extendedprice."""
    return reference.execute_reference(
        "select l_returnflag, l_quantity, l_extendedprice "
        "from lineitem").rows


@pytest.mark.parametrize("name", sorted(PERCENTILE_CASES))
def test_percentile_spills_equal_reference(tiny, reference, lineitem_values,
                                           monkeypatch, name):
    """Every other column equals the JAX package's numpy oracle
    (execute_reference); the percentile is the oracle's exact nearest
    rank up to the summaries' documented rank error, total / (2m) rows
    (presto_tpu/exec/operators.py, PERCENTILE_SKETCH_POINTS)."""
    sql, col, frac, key = PERCENTILE_CASES[name]
    skewed = []
    orig = PlanCompiler._skewed_percentile_bucket
    monkeypatch.setattr(PlanCompiler, "_skewed_percentile_bucket",
                        lambda self, *a: skewed.append(1) or orig(self, *a))
    got = tiny.execute(sql)
    want = reference.execute_reference(sql)
    if key is None:
        assert not skewed
    else:
        assert skewed and _spilled(got) > 0, got.runtime_stats
    pos = 2 if "extendedprice" in sql else 1
    assert len(got.rows) == len(want.rows)
    for g, w in zip(sorted(got.rows, key=str), sorted(want.rows, key=str)):
        assert [v for j, v in enumerate(g) if j != col] \
            == [v for j, v in enumerate(w) if j != col], (g, w)
        xs = sorted(r[pos] for r in lineitem_values
                    if key is None or r[0] == g[0])
        target = math.floor(frac * (len(xs) - 1) + 0.5)
        lo = bisect.bisect_left(xs, g[col])
        hi = bisect.bisect_right(xs, g[col]) - 1
        assert lo <= hi, (g, "not an input value")
        bound = math.ceil(len(xs) / (2 * PERCENTILE_SKETCH_POINTS))
        assert max(0, lo - target, target - hi) <= bound, (g, w, lo, hi)


def test_global_percentile_stream_is_the_references_arithmetic(
        tiny, monkeypatch):
    """The streamed global percentile equals, bit for bit, the reference's
    percentile_batch_summary and percentile_union_value (presto_tpu/exec/
    operators.py) over the same batches, each past m live rows."""
    import jax.numpy as jnp
    from presto_tpu.exec import operators as jops
    seen = []
    orig = ops.percentile_batch_summary

    def spy(values, alive, m=PERCENTILE_SKETCH_POINTS):
        out = orig(values, alive, m)
        seen.append((values.numpy().copy(), alive.numpy().copy(), out))
        return out
    monkeypatch.setattr(ops, "percentile_batch_summary", spy)
    got = tiny.execute("select approx_percentile(l_extendedprice, 0.9) "
                       "from lineitem")
    assert len(seen) > 1 and all(
        a.sum() > PERCENTILE_SKETCH_POINTS for _v, a, _o in seen)
    pts, cnts = [], []
    for values, alive, (p_pts, p_cnt) in seen:
        j_pts, j_cnt = jops.percentile_batch_summary(jnp.asarray(values),
                                                     jnp.asarray(alive))
        np.testing.assert_array_equal(p_pts.numpy(), np.asarray(j_pts))
        assert int(p_cnt) == int(j_cnt)
        pts.append(j_pts)
        cnts.append(j_cnt)
    val, is_null = jops.percentile_union_value(jnp.stack(pts),
                                               jnp.stack(cnts), 0.9)
    assert not bool(is_null)
    # l_extendedprice is decimal(12, 2): the summaries hold its unscaled
    # values
    assert got.rows[0][0].scaleb(2) == int(val), (got.rows, float(val))


def test_spill_disabled_raises():
    cfg = ExecutionConfig(batch_rows=1 << 14, memory_budget_bytes=50_000,
                          spill_enabled=False)
    r = LocalQueryRunner(golden.SCHEMA, device="cpu", config=cfg)
    with pytest.raises(MemoryExceededError):
        r.execute("select l_orderkey, o_orderdate from lineitem "
                  "join orders on l_orderkey = o_orderkey")
    with pytest.raises(MemoryExceededError):
        r.execute("select l_orderkey, count(*) from lineitem "
                  "group by l_orderkey")


def test_no_reservation_leak_on_failure():
    cfg = ExecutionConfig(batch_rows=1 << 14, memory_budget_bytes=150_000,
                          spill_enabled=False)
    r = LocalQueryRunner(golden.SCHEMA, device="cpu", config=cfg)
    sql = ("select c_custkey, o_orderkey from customer "
           "join orders on c_custkey = o_custkey")
    pools = []
    for _ in range(2):
        exe = r._checkout(r._parse(sql, _Stats()), _Stats())
        with pytest.raises(MemoryExceededError):
            list(exe.compiler.run_to_pages(exe.output))
        pools.append(exe.compiler.ctx.memory)
    for ctx in pools:
        assert ctx.reserved == 0 and ctx.revocable == 0
        assert ctx.pool.reserved == 0 and ctx.pool.revocable == 0
        assert not ctx.pool._holders
    ok = LocalQueryRunner(golden.SCHEMA, device="cpu", config=ExecutionConfig(
        batch_rows=1 << 14, memory_budget_bytes=150_000))
    assert ok.execute("select count(*) from region").rows == [[5]]


class _Stats:
    """A RuntimeStats stand-in for driving a checked-out compiler."""

    def record_wall(self, _name):
        import contextlib
        return contextlib.nullcontext()

    def add(self, *_a, **_k):
        pass


def test_query_max_memory_is_typed_user_error():
    """query.max-memory fails fast with the typed, non-retryable error
    though spill is enabled and the pool is unlimited."""
    r = LocalQueryRunner(golden.SCHEMA, device="cpu", config=ExecutionConfig(
        batch_rows=1 << 14, memory_max_query_bytes=50_000))
    with pytest.raises(QueryMemoryLimitExceededError) as ei:
        r.execute("select l_orderkey, o_orderdate from lineitem "
                  "join orders on l_orderkey = o_orderkey")
    assert "EXCEEDED_MEMORY_LIMIT" in str(ei.value)
    assert not is_retryable(ei.value)


@pytest.mark.parametrize("budget,path", [
    (200_000, "kernelDeclinedWindowInputSize"),
    (8 << 20, "kernelWindowPrograms")], ids=["declines", "fits"])
def test_budgeted_window_equals_reference(reference, budget, path):
    r = LocalQueryRunner(golden.SCHEMA, device="cpu", config=ExecutionConfig(
        batch_rows=1 << 14, join_out_capacity=1 << 16,
        memory_budget_bytes=budget, spill_partitions=4))
    res = r.execute(W1)
    assert res.runtime_stats[path]["sum"] == 1, res.runtime_stats
    assert_rows_close(res, reference.execute_reference(W1), ordered=True,
                      rtol=RTOL)


def test_grown_aggregation_table_raises_as_the_reference(reference,
                                                         monkeypatch):
    """A reference behaviour the port mirrors (ROADMAP section 3, once
    logged as fault 2), scaled to sf0.01 (one retry):
    under a budget between Q18's first aggregation table and its doubled
    one the first reservation fits, the table grows unreserved, and both
    packages run out of retries with the same error, neither spilling nor
    raising MemoryExceededError.  A repair shows here."""
    cfg = dict(memory_budget_bytes=2_500_000, max_agg_retries=1)
    r = LocalQueryRunner(golden.SCHEMA, device="cpu",
                         config=ExecutionConfig(**cfg))
    with pytest.raises(RuntimeError, match="collision retries exhausted"):
        r.execute(ALL[18])
    monkeypatch.setattr(reference, "config", JExecutionConfig(**cfg))
    with pytest.raises(RuntimeError, match="collision retries exhausted"):
        reference.execute(ALL[18])
