"""The port's telemetry and query history (presto_tpu_torch/telemetry/)
against the JAX package's, on the CPU.

  * OTLP payloads: the same spans and metric points give equal payloads,
    dict for dict (ids, attributes, shapes), and the port's scrape covers
    every registry the reference's does.
  * the exporter's contract in both packages: an enqueue never blocks,
    drops are metered, the jittered-backoff retry budget holds, an
    unbounded queue is refused.
  * the history store: eviction, reload, malformed lines and the listener
    give equal records in both packages.
  * a traced cluster of the port's coordinator and two port workers
    stitches one trace (query -> fragment -> task -> operator, both
    resource roles, nothing dropped); /v1/metrics and /v1/cluster carry
    the counters; history survives a coordinator restart.
  * history-based sizing: the same history_sized_queries and initial
    aggregation slots in both packages.
"""
import dataclasses
import json
import threading
import time
import urllib.error
import urllib.request

import pytest

import presto_tpu.exec.pipeline as JPipe
import presto_tpu.telemetry as J
import presto_tpu_torch.exec.pipeline as TPipe
import presto_tpu_torch.telemetry as T
from presto_tpu.exec.adaptive import ADAPTIVE_METRICS as J_ADAPTIVE
from presto_tpu.exec.adaptive import reset_adaptive_metrics as j_reset
from presto_tpu.utils.runtime_stats import Span as JSpan
from presto_tpu.worker.events import QueryCompletedEvent as JEvent
from presto_tpu_torch.exec.adaptive import ADAPTIVE_METRICS as T_ADAPTIVE
from presto_tpu_torch.exec.adaptive import reset_adaptive_metrics as t_reset
from presto_tpu_torch.utils.runtime_stats import Span as TSpan
from presto_tpu_torch.worker.events import QueryCompletedEvent as TEvent
from torch_threads import one_torch_thread  # noqa: F401

PKGS = {"ref": (J, JSpan, JEvent), "port": (T, TSpan, TEvent)}


def _get_json(url):
    with urllib.request.urlopen(url, timeout=30) as resp:
        return json.loads(resp.read())


# ---------------------------------------------------------------------------
# OTLP payloads: equal dict for dict
# ---------------------------------------------------------------------------

SPAN_SETS = {
    "query_tree": [
        ("query", "", 10.0, 11.5, {"sql": "select 1", "rows": 3,
                                   "ok": True, "frac": 0.5}),
        ("fragment 0", "query", 10.1, 11.0,
         {"n_tasks": 2, "fabric": "ici"}),
        ("task 0.1", "fragment 0", 10.2, 10.9, {"task_index": 1}),
        ("operator 0.1.agg", "task 0.1", 10.2, 10.9,
         {"rows": 0, "wall_s": 0.25, "operator": "Aggregation"}),
    ],
    "open_span": [("query", "", 5.0, 0.0, {})],
    "worker_slice": [
        ("task 20261018_0.1.0.0", "fragment 1", 1.5, 2.5,
         {"presto.rows": 25, "presto.state": "FINISHED"}),
        ("operator 20261018_0.1.0.0.scan", "task 20261018_0.1.0.0", 1.5,
         2.5, {"presto.operator": "TableScan"}),
    ],
}


@pytest.mark.parametrize("name", sorted(SPAN_SETS))
@pytest.mark.parametrize("as_dict", [False, True], ids=["span", "dict"])
def test_span_payloads_equal(name, as_dict):
    def spans(Span):
        out = [Span(n, p, start=s, end=e, attributes=dict(a))
               for n, p, s, e, a in SPAN_SETS[name]]
        return [s.to_dict() for s in out] if as_dict else out
    resource = {"service.name": "presto-tpu", "presto.role": "worker"}
    got = T.spans_to_resource_spans("tok-1", spans(TSpan), resource)
    exp = J.spans_to_resource_spans("tok-1", spans(JSpan), resource)
    assert got == exp
    json.dumps(got)


@pytest.mark.parametrize("token,name", [("tok", "query"),
                                        ("tok", "fragment 1"),
                                        ("e2e-trace-0001", "task 1.0"),
                                        ("", "operator 1.0.x")])
def test_ids_equal(token, name):
    assert T.trace_id_for(token) == J.trace_id_for(token)
    assert T.span_id_for(token, name) == J.span_id_for(token, name)
    assert len(T.trace_id_for(token)) == 32
    assert len(T.span_id_for(token, name)) == 16


POINT_SETS = {
    "plain": [("presto_tpu.exchange.bytes", 42.0, {})],
    "tagged": [("presto_tpu.kernel.declined", 2.0, {"reason": "Backend"}),
               ("presto_tpu.exchange_fabric.bytes_moved", 7.0,
                {"fabric": "ici"})],
    "empty": [],
}


@pytest.mark.parametrize("name", sorted(POINT_SETS))
def test_metric_payloads_equal(name):
    pts = POINT_SETS[name]
    got = T.metrics_to_resource_metrics(pts, 123, {"service.name": "p"})
    exp = J.metrics_to_resource_metrics(pts, 123, {"service.name": "p"})
    assert got == exp
    json.dumps(got)


def test_scrape_covers_every_registry():
    names = {n for n, _v, _a in T.scrape_metric_points()}
    ref = {n for n, _v, _a in J.scrape_metric_points()}
    for prefix in ("presto_tpu.exchange.", "presto_tpu.exchange_fabric.",
                   "presto_tpu.serving.", "presto_tpu.storage.",
                   "presto_tpu.kernel.", "presto_tpu.memory.",
                   "presto_tpu.adaptive."):
        assert any(n.startswith(prefix) for n in names), prefix
        assert any(n.startswith(prefix) for n in ref), prefix
    assert "presto_tpu.kernel.scan_programs" in names
    assert "presto_tpu.memory.spilled_bytes" in names
    assert "presto_tpu.adaptive.history_sized_queries" in names
    # the fabric and adaptive registries are the same copies: same names
    for prefix in ("presto_tpu.exchange_fabric.", "presto_tpu.adaptive.",
                   "presto_tpu.exchange."):
        assert {n for n in names if n.startswith(prefix)} \
            == {n for n in ref if n.startswith(prefix)}, prefix


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_make_sink_dispatch(pkg, tmp_path):
    M = PKGS[pkg][0]
    assert M.make_sink("none") is None
    assert M.make_sink("") is None
    assert isinstance(M.make_sink("collector"), M.CollectorSink)
    assert isinstance(M.make_sink("jsonl", path=str(tmp_path / "t.jsonl")),
                      M.JsonlFileSink)
    assert isinstance(M.make_sink("http", endpoint="http://127.0.0.1:1"),
                      M.HttpOtlpSink)
    for kw in ({"kind": "jsonl"}, {"kind": "http"}, {"kind": "bogus"}):
        with pytest.raises(ValueError):
            M.make_sink(**kw)


# ---------------------------------------------------------------------------
# exporter: delivery, backpressure, retry budget (both packages)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_exporter_delivers_spans_and_metrics(pkg):
    M, Span, _ = PKGS[pkg]
    sink = M.CollectorSink()
    exp = M.TelemetryExporter(sink, queue_bound=16, flush_interval_s=0.02)
    try:
        exp.export_spans("tok", [Span("query", "", start=1.0, end=2.0)],
                         resource={"presto.role": "coordinator"})
        exp.scrape_metrics()
        assert exp.flush(timeout_s=5.0)
        assert sink.trace_ids() == [M.trace_id_for("tok")]
        assert "presto_tpu.serving.planCacheHits" in sink.metric_names()
        c = exp.counters()
        assert c["enqueued"] == 2 and c["exported"] == 2
        assert c["dropped"] == 0 and c["queue_depth"] == 0
    finally:
        exp.close()


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_exporter_backpressure_drops_metered_never_blocks(pkg):
    M = PKGS[pkg][0]
    release = threading.Event()

    class StallingSink(M.CollectorSink):
        def export(self, payload):
            release.wait(10)
            super().export(payload)

    exp = M.TelemetryExporter(StallingSink(), queue_bound=4,
                              flush_interval_s=0.01)
    try:
        t0 = time.perf_counter()
        results = [exp.enqueue({"resourceSpans": [], "i": i})
                   for i in range(32)]
        assert time.perf_counter() - t0 < 1.0, \
            "enqueue must never block on a stalled sink"
        c = exp.counters()
        assert c["dropped"] >= 32 - 4 - 1
        assert c["dropped"] + c["enqueued"] == 32
        assert results.count(False) == c["dropped"]
        release.set()
        assert exp.flush(timeout_s=5.0)
        assert exp.counters()["exported"] == c["enqueued"]
    finally:
        release.set()
        exp.close()


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_exporter_retry_budget_then_drop(pkg):
    M = PKGS[pkg][0]

    class DeadSink(M.CollectorSink):
        attempts = 0

        def export(self, payload):
            DeadSink.attempts += 1
            raise OSError("collector down")

    sink = DeadSink()
    exp = M.TelemetryExporter(sink, queue_bound=4, flush_interval_s=0.01,
                              max_error_duration_s=0.3)
    try:
        assert exp.enqueue({"resourceSpans": []})
        deadline = time.monotonic() + 10
        while (exp.counters()["dropped_after_retry"] == 0
               and time.monotonic() < deadline):
            time.sleep(0.02)
        c = exp.counters()
        assert c["dropped_after_retry"] == 1
        assert c["retries"] >= 1 and DeadSink.attempts >= 2
        assert c["exported"] == 0
    finally:
        exp.close()


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_exporter_rejects_unbounded_queue(pkg):
    M = PKGS[pkg][0]
    with pytest.raises(ValueError):
        M.TelemetryExporter(M.CollectorSink(), queue_bound=0)


def test_jsonl_sink_lines_equal(tmp_path):
    lines = {}
    for pkg, (M, Span, _) in PKGS.items():
        path = str(tmp_path / f"{pkg}.jsonl")
        exp = M.TelemetryExporter(M.JsonlFileSink(path), queue_bound=8,
                                  flush_interval_s=0.01)
        try:
            exp.export_spans("tok", [Span("query", "", start=1.0, end=2.0)])
            exp.export_spans("tok2", [Span("query", "", start=1.0,
                                           end=2.0)])
            assert exp.flush(timeout_s=5.0)
        finally:
            exp.close()
        lines[pkg] = [json.loads(ln) for ln in open(path) if ln.strip()]
    assert len(lines["port"]) == 2
    assert lines["port"] == lines["ref"]


def test_process_exporter_slot():
    assert T.get_process_exporter() is None
    exp = T.TelemetryExporter(T.CollectorSink())
    try:
        T.set_process_exporter(exp)
        assert T.get_process_exporter() is exp
    finally:
        T.set_process_exporter(None)
        exp.close()


# ---------------------------------------------------------------------------
# history store: equal records in both packages
# ---------------------------------------------------------------------------

def _rec(qid, state="FINISHED", **kw):
    return {"queryId": qid, "state": state, "query": f"select {qid}", **kw}


def _both(fn):
    """Run one scenario on each package's store; the results must be
    equal."""
    out = {pkg: fn(PKGS[pkg][0]) for pkg in PKGS}
    assert out["port"] == out["ref"]
    return out["port"]


def test_history_count_eviction():
    def run(M):
        store = M.QueryHistoryStore(max_count=3, clock=lambda: 1.0)
        for i in range(5):
            store.record(_rec(f"q{i}"))
        return store.list(), store.evicted, len(store)
    listed, evicted, n = _both(run)
    assert [r["queryId"] for r in listed] == ["q4", "q3", "q2"]
    assert evicted == 2 and n == 3


def test_history_age_eviction_with_injected_clock():
    def run(M):
        now = [1000.0]
        store = M.QueryHistoryStore(max_count=100, max_age_s=60.0,
                                    clock=lambda: now[0])
        store.record(_rec("old"))
        now[0] += 120.0
        store.record(_rec("fresh"))
        return store.list(), store.evicted, store.counts_by_state()
    listed, evicted, counts = _both(run)
    assert [r["queryId"] for r in listed] == ["fresh"]
    assert evicted == 1 and counts == {"FINISHED": 1}


def test_history_state_filter_rerecord_and_template():
    def run(M):
        store = M.QueryHistoryStore(max_count=10, clock=lambda: 5.0)
        store.record(_rec("a", state="FAILED", planTemplate="t1"))
        store.record(_rec("b", planTemplate="t1", aggGroups=3))
        store.record(_rec("a", state="FINISHED"))   # supersedes
        return (store.list(state="finished"), store.list(state="FAILED"),
                store.get("a"), store.find_by_template("t1"),
                store.find_by_template("t1", state=None),
                store.find_by_template(""), store.counters())
    listed, failed, a, t1, t1_any, none, counters = _both(run)
    assert [r["queryId"] for r in listed] == ["a", "b"]
    assert failed == [] and a["state"] == "FINISHED"
    assert t1["queryId"] == "b" and t1_any["queryId"] == "b"
    assert none is None and counters["recorded"] == 3


def test_history_restart_reload(tmp_path):
    def run(M):
        path = str(tmp_path / f"{M.__name__}.history.jsonl")
        store = M.QueryHistoryStore(path, max_count=10, clock=lambda: 7.0)
        store.record(_rec("q1"))
        store.record(_rec("q2", state="FAILED", errorMessage="boom"))
        del store
        reloaded = M.QueryHistoryStore(path, max_count=10)
        tight = M.QueryHistoryStore(path, max_count=1)
        return (reloaded.loaded, reloaded.get("q2"), reloaded.list(),
                len(tight), tight.list(), sum(1 for _ in open(path)))
    loaded, q2, listed, n_tight, tight, spool_lines = _both(run)
    assert loaded == 2 and q2["errorMessage"] == "boom"
    assert [r["queryId"] for r in listed] == ["q2", "q1"]
    assert n_tight == 1 and tight[0]["queryId"] == "q2"
    assert spool_lines == 1          # compacted on load


def test_history_tolerates_malformed_lines(tmp_path):
    def run(M):
        path = str(tmp_path / f"{M.__name__}.bad.jsonl")
        with open(path, "w") as f:
            f.write(json.dumps(_rec("good", recordedAt=1.0)) + "\n")
            f.write("{not json\n")
            f.write(json.dumps({"noQueryId": True}) + "\n")
        store = M.QueryHistoryStore(path, max_count=10)
        return store.loaded, store.load_errors, store.get("good")
    loaded, errors, good = _both(run)
    assert loaded == 1 and errors == 2 and good is not None


@pytest.mark.parametrize("state,error", [("FINISHED", None),
                                         ("FAILED", "boom")])
def test_history_listener_records_equal(state, error):
    def run(M):
        Event = PKGS["port" if M is T else "ref"][2]
        store = M.QueryHistoryStore(max_count=10, clock=lambda: 9.0)
        listener = M.HistoryEventListener(
            store, extra_fields=lambda ev: {"profileTraceDir": "/tmp/x"})
        listener.query_completed(Event(
            query_id="q1", sql="select 1", user="u", state=state,
            create_time=1.0, end_time=2.0, wall_time_s=1.0,
            queued_time_s=0.0, rows=1, trace_token="tok",
            resource_group="global", error=error))
        return store.get("q1")
    rec = _both(run)
    assert rec["traceToken"] == "tok" and rec["resourceGroup"] == "global"
    assert rec["profileTraceDir"] == "/tmp/x" and rec["state"] == state


def test_history_rejects_bad_input():
    for M in (J, T):
        with pytest.raises(ValueError):
            M.QueryHistoryStore(max_count=0)
        with pytest.raises(ValueError):
            M.QueryHistoryStore().record({"state": "FINISHED"})


# ---------------------------------------------------------------------------
# history-based sizing: both runners
# ---------------------------------------------------------------------------

AGG_SQL = "SELECT o_orderstatus, count(*) FROM orders GROUP BY o_orderstatus"
MANY_GROUPS = ("SELECT o_custkey, count(*), sum(o_totalprice) FROM orders "
               "GROUP BY o_custkey")


def _spy_slots(monkeypatch, module):
    """The first table size of every aggregation the package compiles
    (its _agg_state_bytes is called with it, in both packages)."""
    seen = []
    orig = module._agg_state_bytes

    def spy(num_slots, *a, **k):
        seen.append(num_slots)
        return orig(num_slots, *a, **k)
    monkeypatch.setattr(module, "_agg_state_bytes", spy)
    return seen


@pytest.mark.parametrize("sql", [AGG_SQL, MANY_GROUPS],
                         ids=["three_groups", "many_groups"])
def test_local_repeat_run_sizes_from_history(monkeypatch, sql):
    from presto_tpu.exec.runner import LocalQueryRunner as JRunner
    from presto_tpu_torch.exec.runner import LocalQueryRunner as TRunner
    out = {}
    for pkg, Runner, Cfg, reset, metrics, mod in (
            ("ref", JRunner, JPipe.ExecutionConfig, j_reset, J_ADAPTIVE,
             JPipe),
            ("port", lambda *a, **k: TRunner(*a, device="cpu", **k),
             TPipe.ExecutionConfig, t_reset, T_ADAPTIVE, TPipe)):
        M = PKGS[pkg][0]
        hist = M.QueryHistoryStore()
        cfg = Cfg(adaptive_history_sizing=True)
        r = Runner("sf0.01", config=cfg, history=hist)
        reset()
        slots = _spy_slots(monkeypatch, mod)
        first = r.execute(sql)
        rec = hist.list()[0]
        assert rec["planTemplate"] and rec["aggGroups"] == len(first.rows)
        assert metrics.snapshot()["history_sized_queries"] == 0
        first_slots = list(slots)
        del slots[:]
        second = r.execute(sql)
        assert sorted(second.rows) == sorted(first.rows)
        sized = r._history_sized_config()
        # the table sizes each run starts from (a run may size its
        # memory reservation from the same number again)
        out[pkg] = (metrics.snapshot()["history_sized_queries"],
                    sorted(set(first_slots)), sorted(set(slots)),
                    sized.history_agg_groups, first)
    assert out["port"][:4] == out["ref"][:4]
    assert out["port"][0] >= 1
    assert out["port"][3] == len(out["port"][4].rows)
    # integers exact; the float sums within 1e-9
    from torch_rows import assert_rows_close
    assert_rows_close(out["port"][4], out["ref"][4], ordered=False,
                      rtol=1e-9)


def test_history_sizing_off_by_default():
    from presto_tpu.exec.runner import LocalQueryRunner as JRunner
    from presto_tpu_torch.exec.runner import LocalQueryRunner as TRunner
    for M, runner, reset, metrics in (
            (J, JRunner("sf0.01", config=JPipe.ExecutionConfig(),
                        history=J.QueryHistoryStore()), j_reset,
             J_ADAPTIVE),
            (T, TRunner("sf0.01", config=TPipe.ExecutionConfig(),
                        history=T.QueryHistoryStore(), device="cpu"),
             t_reset, T_ADAPTIVE)):
        reset()
        runner.execute(AGG_SQL)
        runner.execute(AGG_SQL)
        assert runner.history.list()
        assert metrics.snapshot()["history_sized_queries"] == 0


def test_distributed_repeat_run_seeds_task_count():
    from presto_tpu.exec.runner import DistributedQueryRunner as JRunner
    from presto_tpu.sql import parser as JA
    from presto_tpu_torch.exec.runner import DistributedQueryRunner as TRunner
    from presto_tpu_torch.sql import parser as TA
    out = {}
    for pkg, runner, A, reset, metrics in (
            ("ref", JRunner("sf0.01", config=JPipe.ExecutionConfig(
                adaptive_history_sizing=True), n_tasks=4,
                history=J.QueryHistoryStore()), JA, j_reset, J_ADAPTIVE),
            ("port", TRunner("sf0.01", config=TPipe.ExecutionConfig(
                adaptive_history_sizing=True), n_tasks=4,
                history=T.QueryHistoryStore(), device="cpu"), TA, t_reset,
             T_ADAPTIVE)):
        reset()
        first = runner.execute(AGG_SQL)
        assert runner.history.list()
        restore = runner._apply_history_sizing(A.parse_sql(AGG_SQL))
        try:
            seeded = (runner.config.history_agg_groups,
                      runner._history_tasks,
                      runner._scheduler_config().hash_tasks)
        finally:
            restore()
        assert runner.config.history_agg_groups is None
        second = runner.execute(AGG_SQL)
        assert sorted(second.rows) == sorted(first.rows)
        out[pkg] = (seeded, metrics.snapshot()["history_sized_queries"],
                    sorted(first.rows))
    assert out["port"] == out["ref"]
    assert out["port"][0] == (3, 1, 1)


def test_plan_cache_rekeys_on_history_hint():
    from presto_tpu_torch.sql.canonical import cache_key_from_parts
    cfg = TPipe.ExecutionConfig()
    hinted = dataclasses.replace(cfg, history_agg_groups=512)
    assert cache_key_from_parts("t", cfg, "tpch", "sf0.01") \
        != cache_key_from_parts("t", hinted, "tpch", "sf0.01")


def test_tracer_spans_of_the_distributed_runner():
    """A tracer provider on the port's DistributedQueryRunner records the
    same span names as the reference's: query, one fragment per stage,
    one task per task (EXPLAIN ANALYZE adds the operators)."""
    from presto_tpu.exec.runner import DistributedQueryRunner as JRunner
    from presto_tpu.utils.runtime_stats import TracerProvider as JProv
    from presto_tpu_torch.exec.runner import DistributedQueryRunner as TRunner
    from presto_tpu_torch.utils.runtime_stats import TracerProvider as TProv
    sql = AGG_SQL
    names = {}
    for pkg, prov, runner in (
            ("ref", JProv("simple"), None), ("port", TProv("simple"), None)):
        runner = (JRunner("sf0.01", n_tasks=2, tracer_provider=prov)
                  if pkg == "ref" else
                  TRunner("sf0.01", n_tasks=2, tracer_provider=prov,
                          device="cpu"))
        runner.execute(sql)
        runner.execute("EXPLAIN ANALYZE " + sql)
        got = []
        for token in (sql, "EXPLAIN ANALYZE " + sql):
            tr = prov.get_trace(token)
            got.append(sorted((s.name, s.parent) for s in tr.spans))
        names[pkg] = got
    assert names["port"] == names["ref"]
    plain, analyzed = names["port"]
    assert ("query", "") in plain
    assert any(n.startswith("task ") for n, _ in plain)
    assert any(n.startswith("operator ") for n, _ in analyzed)


# ---------------------------------------------------------------------------
# the traced cluster: the port's coordinator and two port workers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def traced_cluster():
    from presto_tpu_torch.worker.server import WorkerServer
    sink = T.CollectorSink()
    coordinator = WorkerServer(coordinator=True, environment="test",
                               telemetry_sink=sink,
                               telemetry_flush_interval_s=0.02,
                               device="cpu")
    workers = [WorkerServer(discovery_uri=coordinator.uri,
                            announce_interval_s=0.1, environment="test",
                            device="cpu") for _ in range(2)]
    deadline = time.time() + 20
    while len(coordinator.worker_uris()) < 2 and time.time() < deadline:
        time.sleep(0.05)
    assert len(coordinator.worker_uris()) == 2, "workers failed to announce"
    yield coordinator, workers, sink
    for w in workers:
        w.close()
    coordinator.close()


def test_end_to_end_distributed_trace(traced_cluster):
    from presto_tpu_torch.client import StatementClient
    coordinator, _workers, sink = traced_cluster
    token = "e2e-trace-0001"
    client = StatementClient(coordinator.uri, schema="sf0.01",
                             trace_token=token)
    res = client.execute(
        "select n_regionkey, count(*) from nation group by n_regionkey")
    assert sorted(res.rows) == [[i, 5] for i in range(5)]
    assert coordinator.telemetry.flush(timeout_s=20.0)

    spans = [s for s in sink.spans()
             if s["traceId"] == T.trace_id_for(token)]
    assert len({s["traceId"] for s in spans}) == 1
    by_name = {s["name"]: s for s in spans}
    assert "query" in by_name, sorted(by_name)
    fragments = [s for s in spans if s["name"].startswith("fragment ")]
    tasks = [s for s in spans if s["name"].startswith("task ")]
    operators = [s for s in spans if s["name"].startswith("operator ")]
    assert fragments and tasks and operators
    qid = by_name["query"]["spanId"]
    assert all(f["parentSpanId"] == qid for f in fragments)
    frag_ids = {f["spanId"] for f in fragments}
    assert all(t["parentSpanId"] in frag_ids for t in tasks)
    task_ids = {t["spanId"] for t in tasks}
    assert all(o["parentSpanId"] in task_ids for o in operators)
    roles = set()
    for p in sink.payloads:
        for rs in p.get("resourceSpans", []):
            for a in rs["resource"]["attributes"]:
                if a["key"] == "presto.role":
                    roles.add(a["value"]["stringValue"])
    assert {"coordinator", "worker"} <= roles
    c = coordinator.telemetry.counters()
    assert c["dropped"] == 0 and c["dropped_after_retry"] == 0


def test_cluster_endpoint_shape(traced_cluster):
    coordinator, _workers, _sink = traced_cluster
    info = _get_json(f"{coordinator.uri}/v1/cluster")
    for key in ("runningQueries", "queuedQueries", "blockedQueries",
                "finishedQueries", "failedQueries", "activeWorkers",
                "runningTasks", "totalTasks", "reservedMemoryBytes",
                "fabricByteRates", "historyEntries", "telemetry"):
        assert key in info, key
    assert info["activeWorkers"] == 2
    assert info["finishedQueries"] >= 1
    assert info["historyEntries"] >= 1
    assert isinstance(info["fabricByteRates"], dict)
    assert info["telemetry"]["queue_bound"] > 0


def test_cluster_endpoint_is_coordinator_only(traced_cluster):
    _coordinator, workers, _sink = traced_cluster
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"{workers[0].uri}/v1/cluster", timeout=10)
    assert e.value.code == 404


def test_query_list_state_filter(traced_cluster):
    coordinator, _workers, _sink = traced_cluster
    finished = _get_json(f"{coordinator.uri}/v1/query?state=FINISHED")
    assert finished and all(q["state"] == "FINISHED" for q in finished)
    assert not _get_json(f"{coordinator.uri}/v1/query?state=CANCELED")


def test_server_metrics_expose_telemetry_counters(traced_cluster):
    coordinator, _workers, _sink = traced_cluster
    with urllib.request.urlopen(f"{coordinator.uri}/v1/metrics",
                                timeout=10) as resp:
        body = resp.read().decode()
    assert "presto_tpu_telemetry_enqueued_total" in body
    assert "presto_tpu_telemetry_dropped_total 0" in body
    assert "presto_tpu_history_entries" in body
    assert "presto_tpu_history_recorded_total" in body


def test_history_survives_coordinator_restart(tmp_path):
    from presto_tpu_torch.client import StatementClient
    from presto_tpu_torch.worker.server import WorkerServer
    hist = str(tmp_path / "history.jsonl")
    server = WorkerServer(coordinator=True, environment="test",
                          history_path=hist, device="cpu")
    try:
        res = StatementClient(server.uri, schema="sf0.01").execute(
            "select count(*) from nation")
        assert res.rows == [[25]]
        qids = [q["queryId"] for q in
                _get_json(f"{server.uri}/v1/query?state=FINISHED")]
        assert len(qids) == 1
    finally:
        server.close()

    revived = WorkerServer(coordinator=True, environment="test",
                           history_path=hist, device="cpu")
    try:
        assert revived.history.loaded == 1
        listed = _get_json(f"{revived.uri}/v1/query?state=FINISHED")
        assert [q["queryId"] for q in listed] == qids
        rec = _get_json(f"{revived.uri}/v1/query/{qids[0]}")
        assert rec["source"] == "history" and rec["state"] == "FINISHED"
        assert _get_json(f"{revived.uri}/v1/cluster")["finishedQueries"] \
            == 1
    finally:
        revived.close()


def test_admission_seeds_estimate_from_history():
    """adaptive_history_sizing at the admission gate: a repeat of a
    recorded statement claims 1.5x its observed peak, in both packages'
    DispatchManager."""
    from presto_tpu.worker.statement import DispatchManager as JDispatch
    from presto_tpu_torch.worker.statement import DispatchManager as TDispatch
    out = {}
    for pkg, Dispatch in (("ref", JDispatch), ("port", TDispatch)):
        M = PKGS[pkg][0]
        hist = M.QueryHistoryStore(clock=lambda: 1.0)
        hist.record({"queryId": "old", "state": "FINISHED",
                     "query": "select 1", "peakMemoryBytes": 4 << 20})
        d = Dispatch(lambda q: None, history=hist)
        q = d.submit("select 1", session={"adaptive_history_sizing": "true"})
        plain = d.submit("select 1")
        out[pkg] = (q.memory_estimate, plain.memory_estimate)
    assert out["port"] == out["ref"] == (int((4 << 20) * 1.5), None)
