"""The torch fused chain (exec/fused.py FusedChain.make and the
XLA-chain modes of pipeline._compile_AggregationNode) against the
reference's XLA chain on the CPU at sf0.01, both packages under
scan_kernel="xla": direct one-hot, static span, runtime span (an anchor
that verifies, and anchors that fail over to the sort aggregation), the
sort aggregation, the hashed table with collision retries, fanout-k INNER
and LEFT joins with a residual ON filter, and a semi join whose build
holds a NULL.  Integers and decimals equal, floats within rtol 1e-12.
Also: the mode the port took (its torchChain{mode} counters), and a
kernel launch that raises propagates instead of running the chain."""
import pytest

from presto_tpu.exec import operators as jops
from presto_tpu.exec import pipeline as jpipe
from presto_tpu.exec.runner import LocalQueryRunner as JRunner
from presto_tpu.serving import PlanCache as JPlanCache
from presto_tpu_torch.benchmarks.tpch_queries import Q1, Q6
from presto_tpu_torch.exec import fused as tfused
from presto_tpu_torch.exec import operators as tops
from presto_tpu_torch.exec import pipeline as tpipe
from presto_tpu_torch.exec.kernels import scan_kernel as sk
from presto_tpu_torch.exec.runner import LocalQueryRunner
from torch_rows import assert_rows_close
from torch_threads import one_torch_thread  # noqa: F401

STATIC_SPAN = ("select l_shipmode, l_shipinstruct, l_returnflag, count(*), "
               "sum(l_quantity), min(l_discount) from lineitem "
               "group by l_shipmode, l_shipinstruct, l_returnflag")
# o_custkey is constant within an o_orderkey group: the widest "key"
# anchor verifies
SPAN_VERIFIES = ("select o_orderkey, o_custkey, sum(o_totalprice), count(*) "
                 "from orders where o_orderdate < date '1995-01-01' "
                 "group by o_orderkey, o_custkey")
# a part has four suppliers and a supplier many parts: both anchors fail
# the dependency check, the sort aggregation answers
SPAN_FAILS = ("select l_partkey, l_suppkey, count(*), sum(l_quantity) "
              "from lineitem group by l_partkey, l_suppkey")
SORT_FLOAT = ("select l_returnflag, l_linestatus, "
              "variance(cast(l_quantity as double)), "
              "sum(cast(l_extendedprice as double)) from lineitem "
              "group by l_returnflag, l_linestatus")
# a nullable expression key (a modulus can make NULL): no span anchor
HASH_Q = ("select cast(l_quantity as double) * 100 + l_linenumber as k, "
          "count(*), sum(l_extendedprice) from lineitem group by 1")
# the filtered lineitem is the build side: orders probe it fanout-k
FANOUT_INNER = ("select o_orderpriority, count(*), sum(l_quantity) "
                "from orders, lineitem where o_orderkey = l_orderkey "
                "and l_shipdate > o_orderdate + interval '60' day "
                "and l_shipmode in ('MAIL', 'SHIP') "
                "and l_receiptdate >= date '1994-01-01' "
                "and l_receiptdate < date '1995-01-01' "
                "group by o_orderpriority")
FANOUT_LEFT = ("select o_orderpriority, count(*), count(l_orderkey), "
               "sum(l_quantity) from orders left join lineitem "
               "on o_orderkey = l_orderkey and l_quantity > 45 "
               "group by o_orderpriority")
SEMI_NULL_BUILD = ("select count(*), sum(l_quantity) from lineitem "
                   "where l_suppkey not in (select case when s_suppkey = 5 "
                   "then null else s_suppkey end from supplier)")
SEMI_IN = ("select count(*), sum(l_quantity) from lineitem "
           "where l_suppkey in (select case when s_suppkey = 5 then null "
           "else s_suppkey end from supplier where s_nationkey < 12)")


def _stats(res, prefix):
    return {k[len(prefix):]: int(v.get("sum", 0))
            for k, v in (res.runtime_stats or {}).items()
            if k.startswith(prefix)}


@pytest.fixture(scope="module")
def xla():
    return JRunner("sf0.01", config=jpipe.tuned_config(scan_kernel="xla"),
                   plan_cache=JPlanCache())


@pytest.fixture(scope="module")
def port():
    return LocalQueryRunner("sf0.01",
                            config=tpipe.tuned_config(scan_kernel="xla"),
                            device="cpu")


@pytest.mark.parametrize("sql,mode,ordered", [
    (Q1, "Direct", True), (Q6, "Direct", True),
    (STATIC_SPAN, "StaticSpan", False),
    (SPAN_VERIFIES, "RuntimeSpan", False),
    (SORT_FLOAT, "SortAgg", False),
    (FANOUT_INNER, "Direct", False), (FANOUT_LEFT, "Direct", False),
    (SEMI_NULL_BUILD, "Direct", False), (SEMI_IN, "Direct", False),
], ids=["q1", "q6", "static_span", "runtime_span", "sort_float",
        "fanout_inner", "fanout_left", "semi_null_build", "semi_in"])
def test_mode_rows_equal_reference(xla, port, sql, mode, ordered):
    exp = xla.execute(sql)
    got = port.execute(sql)
    assert_rows_close(got, exp, ordered=ordered)
    assert got.column_names == exp.column_names
    assert _stats(got, "kernelDeclined") == {"Disabled": 1}
    modes = {k for k in _stats(got, "torchChain")
             if k not in ("Chunks", "Steps", "SpanProbe")}
    assert modes == {mode}, got.runtime_stats


def test_runtime_span_fails_over_to_the_sort_path(xla, port):
    """Two anchors, two failed dependency checks (one pass each), then the
    sort aggregation."""
    exp = xla.execute(SPAN_FAILS)
    got = port.execute(SPAN_FAILS)
    assert_rows_close(got, exp, ordered=False)
    st = _stats(got, "torchChain")
    assert st["RuntimeSpan"] == 2 and st["SortAgg"] == 1, st


def test_hash_table_retries_on_collision(xla, port, monkeypatch):
    """With the sort aggregation priced out and one probe round per
    insert, the first hashed tables collide; each retry doubles the table
    with the next salt until the groups fit, in both packages."""
    monkeypatch.setattr(jpipe, "SORT_AGG_MAX_BYTES", 0)
    monkeypatch.setattr(tpipe, "SORT_AGG_MAX_BYTES", 0)
    monkeypatch.setattr(jops, "PROBE_ROUNDS", 1)
    monkeypatch.setattr(tops, "PROBE_ROUNDS", 1)
    exp = JRunner("sf0.01", config=jpipe.tuned_config(scan_kernel="xla"),
                  plan_cache=JPlanCache()).execute(HASH_Q)
    got = LocalQueryRunner("sf0.01",
                           config=tpipe.tuned_config(scan_kernel="xla"),
                           device="cpu").execute(HASH_Q)
    assert_rows_close(got, exp, ordered=False)
    assert _stats(got, "torchChain")["Hash"] >= 2


def test_fusion_declined_streams_the_same_rows(xla):
    """fuse_pipelines=False meters fusionDeclinedDisabled and runs the
    streaming aggregation over the compiled source."""
    r = LocalQueryRunner("sf0.01",
                         config=tpipe.tuned_config(fuse_pipelines=False),
                         device="cpu")
    got = r.execute(Q1)
    assert_rows_close(got, xla.execute(Q1), ordered=True)
    assert _stats(got, "fusionDeclined") == {"Disabled": 1}
    assert _stats(got, "torchStreaming") == {"Aggregation": 1}


def test_kernel_launch_error_propagates(monkeypatch):
    """A kernel that fails to launch raises: nothing catches it and runs
    the torch chain instead."""
    def broken(*a, **kw):
        raise RuntimeError("launch failed")
    made = []
    real_make = tfused.FusedChain.make

    def make(self, *a, **kw):
        made.append(a[4])
        return real_make(self, *a, **kw)
    monkeypatch.setattr(sk, "scan_direct", broken)
    monkeypatch.setattr(tfused.FusedChain, "make", make)
    r = LocalQueryRunner("sf0.01", device="cpu")
    with pytest.raises(RuntimeError, match="launch failed"):
        r.execute(Q6)
    # only the empty probe chunk ran through the torch chain
    assert made == [tpipe.PROBE_ROWS]


def test_chain_steps_coalesce_contiguous_chunks():
    """Runs of full contiguous chunks become one step of up to per_step
    chunks; a partial chunk ends its step; a gap starts a new one."""
    chunks = [(0, 4), (4, 4), (8, 4), (12, 2), (20, 4), (24, 4)]
    assert tpipe._chain_steps(chunks, 4, 2) == [
        (0, 8, 8), (8, 6, 8), (20, 8, 8)]
    assert tpipe._chain_steps(chunks, 4, 1) == [
        (p, n, 4) for p, n in chunks]


def test_steps_fold_the_rows_of_single_chunks(xla, monkeypatch):
    """Steps of one scan chunk (the reference's granularity) and of
    CHAIN_STEP_ROWS rows give the same rows (at sf0.01 a lineitem split
    holds four chunks of 4,096 rows here)."""
    cfg = tpipe.ExecutionConfig(scan_kernel="xla", batch_rows=1 << 12)
    for rows in (1 << 12, tpipe.CHAIN_STEP_ROWS):
        monkeypatch.setattr(tpipe, "CHAIN_STEP_ROWS", rows)
        got = LocalQueryRunner("sf0.01", config=cfg,
                               device="cpu").execute(SORT_FLOAT)
        assert_rows_close(got, xla.execute(SORT_FLOAT), ordered=False)
        st = _stats(got, "torchChain")
        assert (st["Steps"] == st["Chunks"]) == (rows == 1 << 12), st


def test_kernel_shapes_still_launch_under_auto():
    """A shape the kernels accept takes the kernel, not the chain."""
    got = LocalQueryRunner("sf0.01", device="cpu").execute(Q1)
    assert int(got.runtime_stats["kernelScanPrograms"]["sum"]) == 1
    assert not _stats(got, "torchChain") and not _stats(got,
                                                         "kernelDeclined")
