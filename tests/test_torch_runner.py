"""End to end on the CPU: TPC-H Q1 and Q6 (and a few neighbours of the
slice) through the port's LocalQueryRunner(device="cpu") return exactly
the reference package's rows, with the scan kernel engaged on both sides
(Pallas in interpret mode on the reference side)."""
import pytest

from presto_tpu.exec.pipeline import tuned_config as jtuned
from presto_tpu.exec.runner import LocalQueryRunner as JRunner
from presto_tpu.exec.runner import _assert_rows_equal
from presto_tpu.serving import PlanCache as JPlanCache
from presto_tpu_torch.benchmarks.tpch_queries import Q1, Q6
from presto_tpu_torch.exec.pipeline import tuned_config
from presto_tpu_torch.exec.runner import LocalQueryRunner

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


def test_plan_cache_reuses_compiler_across_literals(port):
    port.execute(Q6)
    hits = port.plan_cache.hits
    port.execute(Q6_OTHER)
    assert port.plan_cache.hits == hits + 1


def test_xla_mode_declines_and_raises():
    r = LocalQueryRunner("sf0.01", config=tuned_config(scan_kernel="xla"),
                         device="cpu")
    with pytest.raises(NotImplementedError, match="kernelDeclinedDisabled"):
        r.execute(Q6)


@pytest.mark.parametrize("sql", [
    # nation is not device-generated in the port
    "select count(*) from nation",
    # a wide GROUP BY runs through the hash kernel now; a moment aggregate
    # over it still has no kernel accumulator (AggFunctionShape)
    "select l_orderkey, stddev(l_quantity) from lineitem group by l_orderkey",
    # a fanout-1 join under an aggregation runs in the scan kernel now; a
    # join whose rows are returned needs the streaming join
    "select l_orderkey, o_orderdate from lineitem, orders "
    "where l_orderkey = o_orderkey",
], ids=["other_table", "wide_group_by", "join"])
def test_outside_the_slice_raises(port, sql):
    with pytest.raises(NotImplementedError):
        port.execute(sql)
