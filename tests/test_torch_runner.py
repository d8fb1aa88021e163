"""End to end on the CPU: TPC-H Q1 and Q6 (and a few neighbours of the
slice) through the port's LocalQueryRunner(device="cpu") return exactly
the reference package's rows, with the scan kernel engaged on both sides
(Pallas in interpret mode on the reference side); Q4, Q12, Q14 and Q19
(the last three through the torch fused chain after a metered
JoinShape decline) and the shapes the kernels decline return the
reference's rows too.  Integers and decimals must match exactly, floats
within rtol 1e-12 (torch_rows.assert_rows_close) where a test says so,
else within _assert_rows_equal's relative 1e-9."""
import pytest

from presto_tpu.exec.pipeline import tuned_config as jtuned
from presto_tpu.exec.runner import LocalQueryRunner as JRunner
from presto_tpu.exec.runner import _assert_rows_equal
from presto_tpu.serving import PlanCache as JPlanCache
from presto_tpu_torch.benchmarks.tpch_queries import Q1, Q4, Q6, Q12, Q14, Q19
from presto_tpu_torch.exec.kernels import scan_kernel as sk
from presto_tpu_torch.exec.pipeline import tuned_config
from presto_tpu_torch.exec.runner import LocalQueryRunner
from torch_rows import assert_rows_close
from torch_threads import one_torch_thread  # noqa: F401

FLOAT_Q = ("select sum(cast(l_extendedprice as double)) as s, "
           "avg(cast(l_quantity as double)) as a, "
           "max(cast(l_discount as double)) as m "
           "from lineitem where l_discount > 0.05")
MINMAX_Q = ("select l_linestatus, min(l_extendedprice), max(l_quantity), "
            "count(l_tax), avg(l_discount), count(*) from lineitem "
            "where l_shipdate between date '1995-01-01' and date '1996-06-30'"
            " group by l_linestatus order by l_linestatus")
Q6_OTHER = Q6.replace("date '1994-01-01'", "date '1995-01-01'") \
    .replace("l_quantity < 24", "l_quantity < 30")
SCAN_Q = ("select l_orderkey, l_quantity * 2 as q2, l_returnflag "
          "from lineitem where l_quantity < 3 and l_discount = 0.04")


def _declined(res):
    return {k[len("kernelDeclined"):]: int(v.get("sum", 0))
            for k, v in (res.runtime_stats or {}).items()
            if k.startswith("kernelDeclined")}


def _programs(res) -> int:
    return int((res.runtime_stats or {}).get(
        "kernelScanPrograms", {}).get("sum", 0))


@pytest.fixture(scope="module")
def ref():
    return JRunner("sf0.01", config=jtuned(scan_kernel="pallas"),
                   plan_cache=JPlanCache())


@pytest.fixture(scope="module")
def port():
    return LocalQueryRunner("sf0.01", device="cpu")


@pytest.mark.parametrize("name,sql,ordered", [
    ("q1", Q1, True), ("q6", Q6, True)], ids=["q1", "q6"])
def test_main_path_rows_equal_reference(ref, port, name, sql, ordered):
    exp = ref.execute(sql)
    got = port.execute(sql)
    _assert_rows_equal(got, exp, ordered=ordered)
    assert got.rows == exp.rows
    assert got.column_names == exp.column_names
    assert _programs(got) == 1 and _programs(exp) == 1
    assert not [k for k in got.runtime_stats
                if k.startswith("kernelDeclined")]


@pytest.mark.parametrize("name,sql,ordered", [
    ("q6_rebound", Q6_OTHER, True), ("float_accumulators", FLOAT_Q, True),
    ("min_max_count", MINMAX_Q, True), ("streaming_scan", SCAN_Q, False)],
    ids=["q6_rebound", "float_accumulators", "min_max_count",
         "streaming_scan"])
def test_slice_neighbours_equal_reference(ref, port, name, sql, ordered):
    exp = ref.execute(sql)
    got = port.execute(sql)
    _assert_rows_equal(got, exp, ordered=ordered)
    assert len(got.rows) > 0
    if name != "streaming_scan":
        assert _programs(got) == 1


@pytest.mark.parametrize("name,sql,declined", [
    ("q4", Q4, {}), ("q12", Q12, {"JoinShape": 1}),
    ("q14", Q14, {"JoinShape": 1}), ("q19", Q19, {"JoinShape": 1})],
    ids=["q4", "q12", "q14", "q19"])
def test_tpch_rows_equal_reference(ref, port, name, sql, declined):
    """Q12 (a lineitem build filtered by a varchar IN, a fanout-k probe of
    orders gathering o_orderpriority), Q14 (LIKE over the gathered
    p_type) and Q19 (a residual ON filter of varchar predicates) decline
    JoinShape in both packages and run the torch chain; Q4 runs in the
    kernel."""
    exp = ref.execute(sql)
    got = port.execute(sql)
    assert_rows_close(got, exp, ordered=True)
    assert got.column_names == exp.column_names
    assert _declined(got) == declined == _declined(exp)
    assert _programs(got) == (0 if declined else 1)


def test_plan_cache_reuses_compiler_across_literals(port):
    port.execute(Q6)
    hits = port.plan_cache.hits
    port.execute(Q6_OTHER)
    assert port.plan_cache.hits == hits + 1


def test_xla_mode_declines_and_raises(ref):
    """scan_kernel=xla meters Disabled and runs the torch fused chain
    (direct mode) with the kernel's rows."""
    r = LocalQueryRunner("sf0.01", config=tuned_config(scan_kernel="xla"),
                         device="cpu")
    before = sk.KERNEL_METRICS.snapshot()["declined"].get("Disabled", 0)
    got = r.execute(Q6)
    assert sk.KERNEL_METRICS.snapshot()["declined"]["Disabled"] == before + 1
    assert _declined(got) == {"Disabled": 1} and _programs(got) == 0
    assert got.rows == ref.execute(Q6).rows


@pytest.mark.parametrize("sql,gate", [
    # nation is host-generated: ported with the scan's host columns
    ("select count(*) from nation", None),
    # a moment aggregate over a wide GROUP BY has no kernel accumulator:
    # a metered AggFunctionShape decline, then the torch chain's sort
    # aggregation (no raise)
    ("select l_orderkey, stddev(l_quantity) from lineitem "
     "group by l_orderkey", "AggFunctionShape"),
    # a join whose rows are returned: the streaming join, ported
    ("select l_orderkey, o_orderdate from lineitem, orders "
     "where l_orderkey = o_orderkey", None),
], ids=["other_table", "wide_group_by", "join"])
def test_outside_the_slice_raises(ref, port, sql, gate):
    if gate is None:
        assert_rows_close(port.execute(sql), ref.execute(sql),
                          ordered=False)
        return
    before = sk.KERNEL_METRICS.snapshot()["declined"].get(
        "AggFunctionShape", 0)
    got = port.execute(sql)
    assert sk.KERNEL_METRICS.snapshot()["declined"][
        "AggFunctionShape"] == before + 1
    assert _declined(got) == {"AggFunctionShape": 1}
    # stddev: the sort path's two-pass moments over prefix sums (1-7 rows
    # a group): rtol 1e-9, zero-variance groups within torch_rows'
    # zero_tol 1e-4
    assert_rows_close(got, ref.execute(sql), ordered=False, rtol=1e-9,
                      zero_tol=1e-4)
