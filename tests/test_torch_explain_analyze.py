"""EXPLAIN ANALYZE, EXPLAIN (TYPE VALIDATE) and the per-node operator
stats in the port (presto_tpu_torch/exec/pipeline.py _instrument, the
fused chain's and the scan kernels' row counters, exec/runner.py _explain
/ _explain_validate / _explain_distributed, the scheduler's per-task
merge, telemetry/profiler.py), on the CPU at sf0.01:

  * ports of the reference's tests: tests/test_explain_analyze.py's
    fused-vs-unfused row parity, footer and distributed cases (the tracer
    and cluster cases wait for the telemetry and the task plane),
    test_queries.py's ANALYZE rows, test_scan_kernel.py's row counters
    (the kernels' plain versions against the torch chain) and footer,
    test_window_kernel.py's footer, test_local_exchange.py's driver
    walls, test_adaptive.py's VALIDATE and footer cases,
    test_analysis_checker.py's VALIDATE surface and pushdown decisions,
    test_exchange_fabric.py's VALIDATE over an annotated plan and
    test_spill.py's Spilled footer with the presto_tpu_memory_* metrics;
  * per-node rows of last_operator_stats equal to the JAX package's,
    node for node, for Q1, Q6 and a join query;
  * the analyze_unfused and profile session properties through the
    statement server, and the profiler's Chrome trace on disk."""
import os
import re
import urllib.request

import pytest

from presto_tpu.exec.pipeline import ExecutionConfig as JConfig
from presto_tpu.exec.runner import LocalQueryRunner as JRunner
from presto_tpu.serving import PlanCache as JPlanCache
from presto_tpu_torch.benchmarks.window_queries import W1
from presto_tpu_torch.client import StatementClient
from presto_tpu_torch.connectors import catalog
from presto_tpu_torch.exec.pipeline import ExecutionConfig
from presto_tpu_torch.exec.runner import (DistributedQueryRunner,
                                          LocalQueryRunner)
from presto_tpu_torch.telemetry.profiler import TRACE_FILE
from presto_tpu_torch.worker import WorkerServer
from torch_threads import one_torch_thread  # noqa: F401

from test_queries import TPCH_Q1, TPCH_Q6

JOIN = ("select o_orderpriority, count(*), sum(l_quantity) from lineitem "
        "join orders on l_orderkey = o_orderkey "
        "where o_orderdate < date '1994-01-01' group by o_orderpriority")
RUNNING_SUM = """
    select custkey, orderkey,
           sum(totalprice) over (partition by custkey
                                 order by orderkey) as running
    from orders where orderkey < 4000
"""
AQE_SQL = """
SELECT sum(l_extendedprice * (1 - l_discount)) AS revenue, count(*) AS cnt
FROM lineitem, orders
WHERE l_orderkey = o_orderkey AND o_orderkey + 0 < 30
"""
SPILL_SQL = ("select l_orderkey, max(o_totalprice), sum(l_quantity) "
             "from lineitem join orders on l_orderkey = o_orderkey "
             "group by l_orderkey")
SPILL_SESSION = {"query_max_memory_per_node": "200kB",
                 "task_batch_rows": "16384", "spill_partitions": "4"}


def _rows(stats):
    return {nid: s["rows"] for nid, s in (stats or {}).items()}


def _runner(**cfg):
    return LocalQueryRunner("sf0.01", device="cpu",
                            config=ExecutionConfig(batch_rows=1 << 13,
                                                   **cfg))


# ---------------------------------------------------------------------------
# tests/test_explain_analyze.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sql", [TPCH_Q1, TPCH_Q6, JOIN],
                         ids=["q1", "q6", "join"])
def test_fused_vs_unfused_analyze_row_parity(sql):
    """The fused chain's device-side row counters agree with the
    streaming per-node instrumentation."""
    fused, unfused = _runner(), _runner(analyze_unfused=True)
    text_f = fused.execute("EXPLAIN ANALYZE " + sql).rows[0][0]
    text_u = unfused.execute("EXPLAIN ANALYZE " + sql).rows[0][0]
    assert "[fused]" in text_f
    if sql is not JOIN:
        # a join's build side is materialized through the fused chain
        # under the knob too, in both packages
        assert "[fused]" not in text_u
    assert "AnalyzeUnfused" in text_u
    sf, su = fused.last_operator_stats, unfused.last_operator_stats
    shared = set(sf) & set(su)
    assert shared
    for nid in shared:
        assert sf[nid]["rows"] == su[nid]["rows"], nid
    for s in sf.values():
        assert s["rows"] >= 0 and s["wall_s"] >= 0 and s["batches"] >= 1


def test_analyze_footer_reports_fused_programs():
    text = _runner().execute("EXPLAIN ANALYZE " + TPCH_Q6).rows[0][0]
    assert "Fused program wall:" in text
    assert "Driver CPU/wall:" in text


def test_distributed_analyze_annotates_every_fragment():
    r = DistributedQueryRunner("sf0.01", n_tasks=2, device="cpu",
                               config=ExecutionConfig(batch_rows=1 << 13))
    text = r.execute("EXPLAIN ANALYZE " + TPCH_Q1).rows[0][0]
    fragments = re.split(r"(?m)^Fragment ", text)[1:]
    assert len(fragments) >= 2
    for frag in fragments:
        assert "rows:" in frag and "wall:" in frag, frag
    assert r.last_operator_stats
    # the final stage's rows are the query's rows
    want = LocalQueryRunner("sf0.01", device="cpu").execute(TPCH_Q1)
    out = [s for nid, s in r.last_operator_stats.items()
           if nid.startswith("output")]
    assert out and out[0]["rows"] == len(want.rows)


# ---------------------------------------------------------------------------
# the JAX package's per-node rows
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def both():
    return (LocalQueryRunner("sf0.01", device="cpu"),
            JRunner("sf0.01", plan_cache=JPlanCache()))


@pytest.mark.parametrize("sql", [TPCH_Q1, TPCH_Q6, JOIN],
                         ids=["q1", "q6", "join"])
def test_node_rows_equal_the_reference(both, sql):
    port, ref = both
    port.execute("EXPLAIN ANALYZE " + sql)
    ref.execute("EXPLAIN ANALYZE " + sql)
    got, want = _rows(port.last_operator_stats), \
        _rows(ref.last_operator_stats)
    assert got and got == want


@pytest.mark.parametrize("unfused", [False, True], ids=["fused", "unfused"])
def test_unfused_node_rows_equal_the_reference(unfused):
    port = LocalQueryRunner("sf0.01", device="cpu", config=ExecutionConfig(
        batch_rows=1 << 13, analyze_unfused=unfused))
    ref = JRunner("sf0.01", config=JConfig(batch_rows=1 << 13,
                                           analyze_unfused=unfused),
                  plan_cache=JPlanCache())
    port.execute("EXPLAIN ANALYZE " + JOIN)
    ref.execute("EXPLAIN ANALYZE " + JOIN)
    assert _rows(port.last_operator_stats) == \
        _rows(ref.last_operator_stats)


# 60,000 groups against the optimizer's estimate of 6,000: the streaming
# aggregation's first table (16,384 slots) is retried four times
RETRY_SQL = ("select l_orderkey * 8 + l_linenumber, count(*) from lineitem "
             "group by 1")


@pytest.mark.parametrize("unfused", [False, True], ids=["fused", "unfused"])
def test_retried_aggregation_rows_against_the_reference(unfused):
    """Each collision retry of the streaming aggregation re-reads its
    input.  Fused, both packages count that input once, node for node.
    Unfused, the port counts it on every pass (5); the reference counts
    two passes, its later passes replaying the second pass's `_share`
    tee uncounted (the tee is not ported: ROADMAP section 3).  The
    aggregation's and the output's rows are equal."""
    sql = "EXPLAIN ANALYZE " + RETRY_SQL
    port = _runner(scan_kernel="xla", analyze_unfused=unfused)
    ref = JRunner("sf0.01", config=JConfig(batch_rows=1 << 13,
                                           scan_kernel="xla",
                                           analyze_unfused=unfused),
                  plan_cache=JPlanCache())
    port.execute(sql)
    ref.execute(sql)
    got, want = _rows(port.last_operator_stats), \
        _rows(ref.last_operator_stats)
    n = catalog.table_row_count("lineitem", 0.01)
    assert set(got) == set(want)
    for nid in got:
        if nid.startswith(("output", "agg")):
            assert got[nid] == want[nid] == n, (nid, got, want)
        elif unfused:                   # the scan and the key's project
            assert (got[nid], want[nid]) == (5 * n, 2 * n), (nid, got)
        else:
            assert got[nid] == want[nid] == n, (nid, got, want)


# ---------------------------------------------------------------------------
# test_queries.py, test_scan_kernel.py, test_window_kernel.py
# ---------------------------------------------------------------------------

def test_explain_analyze_has_stats(both):
    port, _ref = both
    text = port.execute("explain analyze select count(*) from nation") \
        .rows[0][0]
    assert "rows:" in text and "wall:" in text
    assert "rows: 25" in text


@pytest.fixture(scope="module")
def kernels():
    return _runner(scan_kernel="pallas"), _runner(scan_kernel="xla")


def test_row_counters_match_torch_chain(kernels):
    """The scan kernels' row counters (their plain versions here) and the
    torch chain's agree node for node."""
    pallas, xla = kernels
    from test_scan_kernel import Q1, Q6
    for q in (Q6, Q1):
        pallas.execute("EXPLAIN ANALYZE " + q.strip())
        xla.execute("EXPLAIN ANALYZE " + q.strip())
        prows, xrows = _rows(pallas.last_operator_stats), \
            _rows(xla.last_operator_stats)
        assert prows and prows == xrows


def test_explain_analyze_footer_reports_kernel(kernels):
    pallas, xla = kernels
    from test_scan_kernel import Q6
    text = pallas.execute("EXPLAIN ANALYZE " + Q6.strip()).rows[0][0]
    assert "CUDA scan kernels: 1" in text
    assert "Pallas" not in text
    stats = pallas.last_operator_stats
    scan = [s for nid, s in stats.items() if nid.startswith("scan")]
    aggs = [s for nid, s in stats.items() if nid.startswith("agg")]
    assert scan and scan[0]["rows"] > 0
    assert aggs and aggs[-1]["rows"] >= 1
    xtext = xla.execute("EXPLAIN ANALYZE " + Q6.strip()).rows[0][0]
    assert "Scan kernel declined" in xtext and "Disabled" in xtext
    assert "CUDA scan kernels" not in xtext


@pytest.mark.parametrize("sql", [RUNNING_SUM, W1], ids=["running_sum",
                                                        "w1"])
def test_explain_analyze_reports_window_kernel(sql):
    r = LocalQueryRunner("sf0.01", device="cpu",
                         config=ExecutionConfig(scan_kernel="pallas"))
    text = r.execute("EXPLAIN ANALYZE " + sql.strip()).rows[0][0]
    assert "CUDA window kernels: 1" in text


def test_scan_driver_walls_in_analyze():
    """test_local_exchange.py: scan drivers' walls reach EXPLAIN
    ANALYZE."""
    conc = LocalQueryRunner("sf0.01", device="cpu", config=ExecutionConfig(
        batch_rows=1 << 13, splits_per_scan=4, task_concurrency=4,
        fuse_pipelines=False))
    sql = ("select o_orderstatus, count(*), sum(o_totalprice) "
           "from orders group by o_orderstatus")
    plan = conc.execute("EXPLAIN ANALYZE " + sql).rows[0][0]
    assert "driver_walls" in plan


# ---------------------------------------------------------------------------
# test_adaptive.py, test_analysis_checker.py, test_exchange_fabric.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sql", [
    "SELECT count(*) FROM lineitem, orders WHERE l_orderkey = o_orderkey "
    "AND o_orderkey < 40",
    "SELECT count(*) FROM lineitem WHERE l_quantity < 10",
], ids=["dyn_annotations", "surface"])
def test_explain_type_validate(both, sql):
    port, ref = both
    text = port.execute("EXPLAIN (TYPE VALIDATE) " + sql).rows[0][0]
    for stage in ("post-plan", "post-optimize", "post-fragment"):
        assert f"== {stage} ==" in text
    assert "plan validation PASSED" in text
    assert text == ref.execute("EXPLAIN (TYPE VALIDATE) " + sql).rows[0][0]


def test_validate_reports_pushdown_decisions(both):
    port, _ref = both
    text = port.execute(
        "EXPLAIN (TYPE VALIDATE) SELECT count(*) FROM lineitem "
        "WHERE l_orderkey < 40 AND l_shipdate >= DATE '1994-01-01'") \
        .rows[0][0]
    assert "plan validation PASSED" in text
    assert "== scan-pushdown ==" in text
    assert "orderkey lt 40" in text
    assert "shipdate gte 8766" in text


@pytest.mark.parametrize("fabric", ["auto", "http"])
def test_validate_accepts_the_annotated_distributed_plan(fabric):
    r = DistributedQueryRunner("sf0.01", n_tasks=2, device="cpu",
                               config=ExecutionConfig(exchange_fabric=fabric))
    text = r.execute(
        "EXPLAIN (TYPE VALIDATE) SELECT o.custkey, count(*) AS c, "
        "sum(o.totalprice) AS s FROM orders o GROUP BY o.custkey") \
        .rows[0][0]
    assert "EXCHANGE_FABRIC" not in text
    assert "plan validation PASSED" in text


def _adaptive_runner():
    return DistributedQueryRunner(
        "sf0.01", n_tasks=2, broadcast_threshold=5000, device="cpu",
        config=ExecutionConfig(batch_rows=1 << 14, storage_zone_rows=4096))


def test_analyze_footer_reports_adaptive_flip_and_filters():
    text = _adaptive_runner().execute("EXPLAIN ANALYZE " + AQE_SQL) \
        .rows[0][0]
    assert "flipped to broadcast" in text
    line = next(ln for ln in text.splitlines()
                if ln.startswith("Dynamic filters:"))
    assert "collected" in line and "applied" in line \
        and "rows pruned" in line
    assert float(line.split("applied,")[1].split("%")[0]) > 0.0


# ---------------------------------------------------------------------------
# the statement server: session properties, spill footer, metrics
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def server():
    s = WorkerServer(coordinator=True, device="cpu")
    yield s
    s.close()


def test_analyze_unfused_session_property(server):
    sql = "EXPLAIN ANALYZE " + TPCH_Q6
    fused = StatementClient(server.uri, schema="sf0.01").execute(sql)
    unfused = StatementClient(server.uri, schema="sf0.01", session={
        "analyze_unfused": "true"}).execute(sql)
    assert "[fused]" in fused.rows[0][0]
    assert "[fused]" not in unfused.rows[0][0]
    assert "AnalyzeUnfused" in unfused.rows[0][0]


def _trace_dir(text: str) -> str:
    line = next(ln for ln in text.splitlines()
                if ln.startswith("Device profile: "))
    return line[len("Device profile: "):]


def test_profile_session_property_writes_a_trace(tmp_path):
    """profile=true wraps the run in a torch.profiler capture: the footer
    names the per-query directory under the config's profile_dir, which
    holds the Chrome trace -- from a runner, and from the statement
    server's session property."""
    runner = LocalQueryRunner("sf0.01", device="cpu", config=ExecutionConfig(
        profile=True, profile_dir=str(tmp_path / "runner")))
    text = runner.execute("EXPLAIN ANALYZE " + TPCH_Q6).rows[0][0]
    trace_dir = _trace_dir(text)
    assert trace_dir.startswith(str(tmp_path / "runner"))
    assert os.path.getsize(os.path.join(trace_dir, TRACE_FILE)) > 0
    res = runner.execute(TPCH_Q6)
    assert os.path.exists(os.path.join(res.profile_trace_dir, TRACE_FILE))
    # through the server: the session property reaches the runner, and
    # the trace lands under the server config's profile_dir
    server_dir = str(tmp_path / "server")
    s = WorkerServer(coordinator=True, device="cpu",
                     config=ExecutionConfig(profile_dir=server_dir))
    try:
        got = StatementClient(s.uri, schema="sf0.01",
                              session={"profile": "true"}).execute(
            "EXPLAIN ANALYZE select count(*) from nation").rows[0][0]
    finally:
        s.close()
    assert "rows: 25" in got
    trace_dir = _trace_dir(got)
    assert trace_dir.startswith(server_dir)
    assert os.path.getsize(os.path.join(trace_dir, TRACE_FILE)) > 0


def _metric(uri, name):
    with urllib.request.urlopen(uri + "/v1/metrics", timeout=30) as r:
        for line in r.read().decode().splitlines():
            if line.startswith(name + " "):
                return float(line.split()[1])
    return None


def test_spilled_analyze_and_memory_metrics(server):
    """test_spill.py's revocation case through the statement server: the
    ANALYZE footer prints the Spilled line and /v1/metrics exports
    presto_tpu_memory_spilled_bytes_total."""
    before = _metric(server.uri, "presto_tpu_memory_spilled_bytes_total")
    assert before is not None
    text = StatementClient(server.uri, schema="sf0.01",
                           session=SPILL_SESSION).execute(
        "EXPLAIN ANALYZE " + SPILL_SQL).rows[0][0]
    assert "Spilled:" in text
    after = _metric(server.uri, "presto_tpu_memory_spilled_bytes_total")
    assert after > before


def test_dynamic_filter_drops_equal_the_reference():
    """The streaming join's dynamic filter counts the probe rows it drops
    (dynamicFilterRowsDropped): every entry but the walls equals the
    reference's."""
    sql = ("explain analyze select count(*) from lineitem join orders "
           "on l_orderkey = o_orderkey where o_orderkey < 100")
    port = LocalQueryRunner("sf0.01", device="cpu", config=ExecutionConfig(
        fuse_pipelines=False))
    ref = JRunner("sf0.01", config=JConfig(fuse_pipelines=False),
                  plan_cache=JPlanCache())
    port.execute(sql)
    ref.execute(sql)

    def strip(stats):
        return {nid: {k: v for k, v in s.items() if k != "wall_s"}
                for nid, s in stats.items()}
    got = strip(port.last_operator_stats)
    assert got == strip(ref.last_operator_stats)
    assert any(s.get("dynamicFilterRowsDropped") for s in got.values())


CHAIN_MODES = {
    "direct": TPCH_Q6,
    "static_span": "select l_returnflag, l_linestatus, l_shipmode, "
                   "count(*) from lineitem group by 1, 2, 3",
    "runtime_span": "select o_custkey, count(*), sum(o_totalprice) "
                    "from orders group by o_custkey",
    "sort": "select l_orderkey, l_partkey, count(*) from lineitem "
            "where l_quantity < 10 group by l_orderkey, l_partkey",
}


@pytest.mark.parametrize("name", sorted(CHAIN_MODES))
def test_torch_chain_modes_count_rows(name):
    """Each torch-chain mode (scan_kernel="xla") carries the row counters
    in its pass: the fused per-node rows equal the unfused ones and the
    JAX package's."""
    sql = "EXPLAIN ANALYZE " + CHAIN_MODES[name]
    fused = _runner(scan_kernel="xla")
    unfused = _runner(scan_kernel="xla", analyze_unfused=True)
    ref = JRunner("sf0.01", config=JConfig(batch_rows=1 << 13,
                                           scan_kernel="xla"),
                  plan_cache=JPlanCache())
    assert "[fused]" in fused.execute(sql).rows[0][0]
    unfused.execute(sql)
    ref.execute(sql)
    got = _rows(fused.last_operator_stats)
    assert got == _rows(ref.last_operator_stats)
    u = _rows(unfused.last_operator_stats)
    assert {n: got[n] for n in set(got) & set(u)} == \
        {n: u[n] for n in set(got) & set(u)}
