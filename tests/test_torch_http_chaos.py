"""Fault tolerance of the port's HTTP task plane against the JAX package.

The HTTP cases of tests/test_distributed.py (its chaos tests, the
retry policies, the deadline, the poison split, the exchange client's
concurrency, backpressure and coalescing), run against the port's
WorkerServer(device="cpu") workers and HttpQueryRunner.  Rows are held to
the JAX package's LocalQueryRunner.  Every failure is injected by a hook
(the task manager's fault_injector, a scripted producer) or by the task
id's hash; where the reference's case waits a fixed time or compares
walls, this one waits on an event the hook sets and checks the order of
events, so no assertion depends on the machine's load."""
import threading
import time
import urllib.request

import pytest

from presto_tpu_torch.benchmarks.rows import assert_rows_close
from presto_tpu_torch.common.errors import InjectedTaskFailure
from presto_tpu_torch.worker.coordinator import (HeartbeatFailureDetector,
                                                 HttpQueryRunner)
from presto_tpu_torch.worker.server import WorkerServer
from torch_threads import one_torch_thread  # noqa: F401

WAIT_S = 30.0

CHAOS_SQL = ("select o_orderstatus, count(*), sum(o_totalprice) "
             "from orders, customer where c_custkey = o_custkey "
             "group by o_orderstatus")
# `+ 0` keeps the predicate opaque to the stats calculator; zones finer
# than the table give the runtime filter chunks to prune
AQE_CHAOS_SQL = ("select sum(l_extendedprice), count(*) "
                 "from lineitem, orders "
                 "where l_orderkey = o_orderkey and o_orderkey + 0 < 30")
AQE_SESSION = {"lock_validation": "on", "storage_zone_rows": "4096"}


@pytest.fixture(scope="module")
def expected():
    """The JAX package's rows of the module's statements."""
    from presto_tpu.exec.runner import LocalQueryRunner
    r = LocalQueryRunner("sf0.01")
    return {sql: r.execute(sql) for sql in (CHAOS_SQL, AQE_CHAOS_SQL)}


def _same(got, want):
    assert_rows_close(got, want, ordered=False)


def _workers(n):
    return [WorkerServer(device="cpu") for _ in range(n)]


def _runner(workers, **kw):
    return HttpQueryRunner([w.uri for w in workers], "sf0.01",
                           device="cpu", **kw)


def _metric(uri, name):
    with urllib.request.urlopen(uri + "/v1/metrics", timeout=WAIT_S) as r:
        text = r.read().decode()
    for line in text.splitlines():
        if line.startswith(name + " "):
            return float(line.split()[1])
    return None


def _base_lineage(task_id):
    import re
    return re.sub(r"\.r\d+$", "", task_id)


@pytest.fixture
def lock_validation():
    """Every chaos run is also a lock-order validation run: zero rank
    inversions across retries, worker death and drains."""
    from presto_tpu_torch.common.locks import LOCK_METRICS
    before = LOCK_METRICS.snapshot()["violations"]
    yield
    assert LOCK_METRICS.snapshot()["violations"] == before


def _killer(victim):
    """A fault injector that closes `victim` under its first task and
    fails that task."""
    killed = threading.Event()

    def hook(task_id):
        if not killed.is_set():
            killed.set()
            threading.Thread(target=victim.close, daemon=True).start()
            raise InjectedTaskFailure(
                f"chaos: worker dying under task {task_id}")
    return hook, killed


def _flaky_once():
    flaked = []
    lock = threading.Lock()

    def hook(task_id):
        with lock:
            if flaked:
                return
            flaked.append(task_id)
        raise InjectedTaskFailure(f"chaos: flaky task {task_id}")
    return hook, flaked


# -- chaos over the coordinator's retries --------------------------------------

def test_chaos_worker_killed_mid_query_recovers(lock_validation, expected):
    w1, w2, w3 = _workers(3)
    w2.task_manager.fault_injector, killed = _killer(w2)
    try:
        r = _runner([w1, w2, w3], n_tasks=2,
                    session={"exchange_max_error_duration": "5s",
                             "lock_validation": "on"})
        _same(r.execute(CHAOS_SQL), expected[CHAOS_SQL])
        assert killed.is_set(), "chaos hook never fired"
        assert r.tasks_retried >= 1
        assert sum(w.task_manager.tasks_retried for w in (w1, w3)) >= 1
        assert any(_metric(w.uri, "presto_tpu_task_retries_total") >= 1
                   for w in (w1, w3))
    finally:
        for w in (w1, w2, w3):
            w.close()


def test_chaos_injected_failure_exactly_once(lock_validation, expected):
    w1, w2 = _workers(2)
    hook, flaked = _flaky_once()
    w1.task_manager.fault_injector = w2.task_manager.fault_injector = hook
    try:
        r = _runner([w1, w2], n_tasks=2, session={"lock_validation": "on"})
        _same(r.execute(CHAOS_SQL), expected[CHAOS_SQL])
        assert len(flaked) == 1
        assert r.tasks_retried >= 1
        failed = sum(_metric(w.uri, "presto_tpu_tasks_failed_total")
                     for w in (w1, w2))
        retried = sum(_metric(w.uri, "presto_tpu_task_retries_total")
                      for w in (w1, w2))
        assert failed >= 1 and retried >= 1
    finally:
        w1.close()
        w2.close()


def test_chaos_user_error_fails_fast_without_retry(lock_validation):
    from presto_tpu_torch.common.errors import PrestoUserError
    w, = _workers(1)
    calls = []

    def user_bug(task_id):
        calls.append(task_id)
        raise ValueError("chaos: user's input is malformed")

    w.task_manager.fault_injector = user_bug
    try:
        r = _runner([w], n_tasks=1, session={"lock_validation": "on"})
        with pytest.raises(PrestoUserError):
            r.execute("select count(*) from nation")
        assert r.tasks_retried == 0
        assert w.task_manager.tasks_retried == 0
        assert all(".r" not in t for t in calls)
    finally:
        w.close()


def test_chaos_retry_budget_exhausts(lock_validation):
    from presto_tpu_torch.common.errors import PrestoQueryError
    w, = _workers(1)
    calls = []

    def always_fail(task_id):
        calls.append(task_id)
        raise InjectedTaskFailure(f"chaos: permanent failure {task_id}")

    w.task_manager.fault_injector = always_fail
    try:
        r = _runner([w], n_tasks=1,
                    session={"remote_task_retry_attempts": "1",
                             "lock_validation": "on"})
        with pytest.raises(PrestoQueryError, match="retry attempt"):
            r.execute("select count(*) from region")
        assert w.task_manager.tasks_retried >= 1
        budget_used = r.last_execution.budget_used
        assert budget_used and max(budget_used.values()) == 1
        assert len(calls) <= 6
    finally:
        w.close()


def test_probabilistic_fault_injection_session_property(lock_validation):
    """fault_injection_probability=1.0 trips the task-id hash's roll on
    every attempt; with retries off the query fails on the first."""
    from presto_tpu_torch.common.errors import PrestoQueryError
    w, = _workers(1)
    try:
        r = _runner([w], n_tasks=1,
                    session={"fault_injection_probability": "1.0",
                             "remote_task_retry_attempts": "0",
                             "lock_validation": "on"})
        with pytest.raises(PrestoQueryError):
            r.execute("select count(*) from region")
        assert w.task_manager.tasks_failed >= 1
    finally:
        w.close()


# -- adaptive execution under chaos ---------------------------------------------

def _build_stage_paths(r, sql):
    sub, _, _ = r.plan_subplan(sql)
    out = []

    def walk(sp, path):
        if sp.fragment.dynamic_filter_sources:
            out.append(path.replace(".", "_"))
        for i, c in enumerate(sp.children):
            walk(c, f"{path}.{i}")

    walk(sub, "0")
    return out


def test_chaos_build_worker_killed_scans_fall_back_unfiltered(
        lock_validation, expected):
    from presto_tpu_torch.exec.adaptive import ADAPTIVE_METRICS
    workers = _workers(3)
    killed = threading.Event()
    before = ADAPTIVE_METRICS.snapshot()
    try:
        r = _runner(workers, n_tasks=2,
                    session={**AQE_SESSION,
                             "dynamic_filtering_wait_timeout": "50ms",
                             "exchange_max_error_duration": "5s"})
        build_paths = _build_stage_paths(r, AQE_CHAOS_SQL)
        assert build_paths, "test premise broken: no dynamic-filter source"

        def kill_build(w):
            def injector(task_id):
                if killed.is_set():
                    return
                if any(f".{p}." in task_id for p in build_paths):
                    killed.set()
                    threading.Thread(target=w.close, daemon=True).start()
                    raise InjectedTaskFailure(
                        f"chaos: build worker dying under {task_id}")
            return injector

        for w in workers:
            w.task_manager.fault_injector = kill_build(w)
        _same(r.execute(AQE_CHAOS_SQL), expected[AQE_CHAOS_SQL])
        assert killed.is_set(), "chaos hook never saw a build task"
        assert r.tasks_retried >= 1
        after = ADAPTIVE_METRICS.snapshot()
        assert after["filter_wait_timeouts"] > before["filter_wait_timeouts"]
    finally:
        for w in workers:
            w.close()


def test_chaos_late_dynamic_filter_is_ignored_not_fatal(lock_validation,
                                                        expected):
    from presto_tpu_torch.exec.adaptive import ADAPTIVE_METRICS
    w, = _workers(1)
    try:
        r = _runner([w], n_tasks=1, session=dict(AQE_SESSION))
        _same(r.execute(AQE_CHAOS_SQL), expected[AQE_CHAOS_SQL])
        tasks = list(w.task_manager.tasks.values())
        assert tasks, "finished tasks already evicted"
        before = ADAPTIVE_METRICS.snapshot()["filter_late_arrivals"]
        tasks[0].deliver_dynamic_filters(
            {"df_late": {"filterId": "df_late", "rowCount": 1,
                         "min": 1, "max": 1}})
        assert ADAPTIVE_METRICS.snapshot()["filter_late_arrivals"] \
            == before + 1
    finally:
        w.close()


def test_chaos_lock_validation_over_adaptive_paths(lock_validation,
                                                   expected):
    """Filters collected and applied under lock validation.  The probe
    tasks wait for the build's summary as long as it takes (the wait
    timeout raised from the reference test's default, so a slow build
    cannot turn the filter into a late arrival).  The probe chain runs
    the torch chain (scan_kernel=xla), the path the reference's CPU run
    takes (its auto declines the Pallas kernel off the TPU): a scan
    kernel prunes by its static zone maps only, in both packages."""
    from presto_tpu_torch.exec.adaptive import ADAPTIVE_METRICS
    w1, w2 = _workers(2)
    before = ADAPTIVE_METRICS.snapshot()
    try:
        r = _runner([w1, w2], n_tasks=2,
                    session={**AQE_SESSION, "scan_kernel": "xla",
                             "dynamic_filtering_wait_timeout": "60s"})
        _same(r.execute(AQE_CHAOS_SQL), expected[AQE_CHAOS_SQL])
        after = ADAPTIVE_METRICS.snapshot()
        assert after["filters_collected"] > before["filters_collected"]
        assert after["filters_applied"] > before["filters_applied"]
        pruned = (after["filter_rows_pruned"] - before["filter_rows_pruned"]
                  + after["filter_chunks_skipped"]
                  - before["filter_chunks_skipped"])
        assert pruned > 0
        assert _metric(w1.uri,
                       "presto_tpu_adaptive_filters_applied_total") >= 1
    finally:
        w1.close()
        w2.close()


# -- the task manager --------------------------------------------------------------

def test_task_manager_abort_hook_and_counters():
    from presto_tpu_torch.worker.protocol import (OutputBuffersSpec,
                                                  TaskUpdateRequest)
    from presto_tpu_torch.worker.task import TaskManager
    tm = TaskManager(device="cpu")
    tm.create_or_update(TaskUpdateRequest(
        "qx.0.0", 0, None, [], OutputBuffersSpec("PARTITIONED", 1)))
    tm.abort("qx.0.0", "chaos abort")
    st = tm.get("qx.0.0").status()
    assert st.state == "FAILED" and st.error_type == "INTERNAL_ERROR"
    counts = tm.counts()
    assert counts["failed"] == 1 and counts["retried"] == 0
    tm.create_or_update(TaskUpdateRequest(
        "qx.0.0.r1", 0, None, [], OutputBuffersSpec("PARTITIONED", 1)))
    assert tm.counts()["retried"] == 1


def test_task_manager_periodic_reaper():
    from presto_tpu_torch.worker.protocol import (OutputBuffersSpec,
                                                  TaskUpdateRequest)
    from presto_tpu_torch.worker.task import TaskManager
    tm = TaskManager(device="cpu")
    tm.TASK_TTL_S = 0.05
    tm.create_or_update(TaskUpdateRequest(
        "qr.0.0", 0, None, [], OutputBuffersSpec("PARTITIONED", 1)))
    tm.abort("qr.0.0")
    tm.start_reaper(interval_s=0.05)
    try:
        deadline = time.time() + WAIT_S
        while "qr.0.0" in tm.tasks and time.time() < deadline:
            time.sleep(0.02)
        assert "qr.0.0" not in tm.tasks
    finally:
        tm.stop_reaper()


# -- the exchange client -----------------------------------------------------------

def test_exchange_lost_on_missing_task():
    from presto_tpu_torch.common.errors import ExchangeLostError
    from presto_tpu_torch.worker.exchange import pull_pages
    w, = _workers(1)
    try:
        loc = f"{w.uri}/v1/task/ghost.0.0/results/0"
        with pytest.raises(ExchangeLostError) as ei:
            list(pull_pages(loc, max_error_duration_s=0.5))
        assert ei.value.location == loc
    finally:
        w.close()


def test_exchange_budget_bounds_unreachable_source():
    from presto_tpu_torch.common.errors import ExchangeLostError
    from presto_tpu_torch.worker.exchange import pull_pages
    loc = "http://127.0.0.1:1/v1/task/gone.0.0/results/0"
    with pytest.raises(ExchangeLostError):
        list(pull_pages(loc, max_error_duration_s=0.3))


def test_error_classifier_taxonomy():
    import urllib.error
    from presto_tpu_torch.common.errors import (
        EXTERNAL, INSUFFICIENT_RESOURCES, INTERNAL_ERROR, PLAN_VALIDATION,
        USER_ERROR, PlanValidationError, classify_exception, is_retryable,
        parse_error_type, producer_task_from_text)
    assert classify_exception(ValueError("bad sql")) == USER_ERROR
    assert classify_exception(ConnectionRefusedError()) == EXTERNAL
    assert classify_exception(TimeoutError()) == EXTERNAL
    assert classify_exception(MemoryError()) == INSUFFICIENT_RESOURCES
    assert classify_exception(RuntimeError("boom")) == INTERNAL_ERROR
    assert classify_exception(
        urllib.error.HTTPError("u", 503, "busy", {}, None)) == EXTERNAL
    assert classify_exception(
        urllib.error.HTTPError("u", 400, "bad", {}, None)) == USER_ERROR
    assert parse_error_type("task q.0.0 failed [USER_ERROR]: x") \
        == USER_ERROR
    assert not is_retryable(RuntimeError("remote said [USER_ERROR] bad"))
    assert is_retryable(RuntimeError("remote said [EXTERNAL] net down"))
    assert classify_exception(PlanValidationError("bad")) == PLAN_VALIDATION
    assert not is_retryable(PlanValidationError("bad"))
    assert producer_task_from_text(
        "exchange source http://h:1/v1/task/q1.0_0.1.r2/results/3 "
        "vanished") == "q1.0_0.1.r2"


def _page_bytes(values):
    from presto_tpu_torch.common.block import long_array_block
    from presto_tpu_torch.common.page import Page
    from presto_tpu_torch.common.serde import serialize_page
    return serialize_page(Page([long_array_block(values)]))


class _FakeBufferServer:
    """A results-protocol producer scripted per task id: "pages" (the
    serialized pages, "per_round" of them a response), "hold" (an Event
    its first response waits on), "fail" ((code, body) served instead of
    data).  `arrived[task]` is set when the task's first request comes in;
    `in_flight_peak` is the most data requests open at once."""

    def __init__(self, specs):
        import http.server
        import re
        self.specs = specs
        self.arrived = {t: threading.Event() for t in specs}
        self.in_flight_peak = 0
        self._in_flight = 0
        self._lock = threading.Lock()
        rx = re.compile(
            r"^/v1/task/(?P<task>[^/]+)/results/(?P<buffer>\d+)"
            r"(?:/(?P<token>\d+)(?P<ack>/acknowledge)?)?$")
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _reply(self, code, body=b"", headers=()):
                self.send_response(code)
                for k, v in headers:
                    self.send_header(k, v)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                m = rx.match(self.path.split("?")[0])
                spec = outer.specs.get(m.group("task")) if m else None
                if spec is None:
                    return self._reply(404)
                if m.group("ack"):
                    return self._reply(200)
                outer.arrived[m.group("task")].set()
                if spec.get("fail"):
                    code, msg = spec["fail"]
                    return self._reply(code, msg.encode())
                with outer._lock:
                    outer._in_flight += 1
                    outer.in_flight_peak = max(outer.in_flight_peak,
                                               outer._in_flight)
                try:
                    hold = spec.pop("hold", None)
                    if hold is not None:
                        hold.wait(WAIT_S)
                    if spec.get("gate") is not None:
                        # every puller waits here until the gate opens
                        spec["gate"].wait()
                finally:
                    with outer._lock:
                        outer._in_flight -= 1
                pages = spec["pages"]
                token = int(m.group("token"))
                per_round = spec.get("per_round", 1)
                body = b"".join(pages[token:token + per_round])
                nxt = min(len(pages), token + per_round)
                return self._reply(200, body, [
                    ("X-Presto-Page-Sequence-Id", str(token)),
                    ("X-Presto-Page-End-Sequence-Id", str(nxt)),
                    ("X-Presto-Buffer-Complete",
                     "true" if nxt >= len(pages) else "false")])

            def do_DELETE(self):
                self._reply(200)

        self._httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                      Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        threading.Thread(target=self._httpd.serve_forever,
                         daemon=True).start()

    def location(self, task_id, buffer_id=0):
        return (f"http://127.0.0.1:{self.port}/v1/task/{task_id}"
                f"/results/{buffer_id}")

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()


def test_concurrent_client_beats_sequential_with_slow_producers():
    """4 producers whose responses wait at a gate that opens only once 4
    requests are open at the same time: the concurrent client drains them
    (its pullers run at once), with the sequential client's values; the
    sequential client alone never has more than one request open."""
    from presto_tpu_torch.worker.exchange import ExchangeClient, pull_pages
    pages = {f"t{i}": [_page_bytes([i * 10 + j]) for j in range(3)]
             for i in range(4)}
    seq = _FakeBufferServer({t: {"pages": p} for t, p in pages.items()})
    gate = threading.Event()
    conc = _FakeBufferServer({t: {"pages": p, "gate": gate}
                              for t, p in pages.items()})

    def open_gate_at_four():
        deadline = time.time() + WAIT_S
        while conc.in_flight_peak < 4 and time.time() < deadline:
            time.sleep(0.01)
        gate.set()
    try:
        seq_values = [page.blocks[0].values[0] for t in pages
                      for page in pull_pages(seq.location(t))]
        assert seq.in_flight_peak == 1
        opener = threading.Thread(target=open_gate_at_four, daemon=True)
        opener.start()
        client = ExchangeClient([conc.location(t) for t in pages],
                                client_threads=4)
        conc_values = [p.blocks[0].values[0] for p in client.pages()]
        opener.join(WAIT_S)
        assert conc.in_flight_peak == 4
        assert sorted(conc_values) == sorted(seq_values)
        assert len(conc_values) == 12
    finally:
        gate.set()
        seq.close()
        conc.close()


def test_stalled_producer_does_not_starve_other_pullers():
    """One producer holds its first response until every other
    producer's page has reached the consumer: the others keep flowing."""
    from presto_tpu_torch.worker.exchange import ExchangeClient
    hold = threading.Event()
    specs = {"slow": {"pages": [_page_bytes([999])], "hold": hold}}
    for i in range(3):
        specs[f"fast{i}"] = {
            "pages": [_page_bytes([i * 10 + j]) for j in range(2)]}
    srv = _FakeBufferServer(specs)
    try:
        client = ExchangeClient([srv.location(t) for t in specs],
                                client_threads=4)
        order = []
        for p in client.pages():
            order.append(p.blocks[0].values[0])
            if len(order) == 6:
                # all six fast pages came while the slow one is held
                assert 999 not in order
                hold.set()
        assert set(order) == {0, 1, 10, 11, 20, 21, 999}
        assert order[-1] == 999
    finally:
        hold.set()
        srv.close()


def test_exchange_client_backpressure_bounds_buffered_bytes():
    """A fast producer against a consumer that takes one page at a time
    parks at the buffer bound."""
    from presto_tpu_torch.worker.exchange import ExchangeClient
    pages = [_page_bytes(list(range(k * 256, (k + 1) * 256)))
             for k in range(48)]
    page_size = len(pages[0])
    limit = 4 * page_size
    srv = _FakeBufferServer({"t0": {"pages": pages, "per_round": 2}})
    try:
        client = ExchangeClient([srv.location("t0")], client_threads=2,
                                max_buffer_bytes=limit)
        got = 0
        for _ in client.pages():
            got += 1
            if got == 1:
                # the pullers fill the queue up to the bound before the
                # consumer takes a second page
                deadline = time.time() + WAIT_S
                while client.buffered_peak < 2 * page_size \
                        and time.time() < deadline:
                    time.sleep(0.005)
        assert got == len(pages)
        assert client.buffered_peak <= limit, (client.buffered_peak, limit)
        assert client.buffered_peak >= 2 * page_size
    finally:
        srv.close()


def test_failed_sibling_aborts_client_promptly():
    """A failing producer's typed error surfaces while a sibling location
    is still held: the held pull cannot delay the failure."""
    from presto_tpu_torch.common.errors import RemoteTaskError
    from presto_tpu_torch.worker.exchange import ExchangeClient
    hold = threading.Event()
    srv = _FakeBufferServer({
        "stalled": {"pages": [_page_bytes([1])], "hold": hold},
        "failing": {"pages": [], "fail": (
            500, "task failing failed [INTERNAL_ERROR]: boom")},
    })
    try:
        client = ExchangeClient(
            [srv.location("stalled"), srv.location("failing")],
            client_threads=2)
        with pytest.raises(RemoteTaskError, match="INTERNAL_ERROR"):
            list(client.pages())
        assert not hold.is_set()       # raised while the sibling was held
    finally:
        hold.set()
        srv.close()


def test_failed_task_aborts_worker_remote_source_promptly():
    """A task's remote source stops pulling once the task turns terminal,
    while its producer still holds the pull."""
    from presto_tpu_torch.exec.pipeline import ExecutionConfig
    from presto_tpu_torch.worker.exchange import (ExchangeAbortedError,
                                                  remote_page_reader)
    from presto_tpu_torch.worker.task import TpuTask
    hold = threading.Event()
    srv = _FakeBufferServer({"slow": {"pages": [_page_bytes([1])],
                                      "hold": hold}})
    task = TpuTask("q.1.0", "http://127.0.0.1:0", ExecutionConfig(),
                   device="cpu")
    outcome = []

    def consume():
        reader = remote_page_reader([srv.location("slow")],
                                    should_abort=task._exchange_abort)
        try:
            list(reader())
            outcome.append("drained")
        except ExchangeAbortedError:
            outcome.append("aborted")

    t = threading.Thread(target=consume, daemon=True)
    try:
        t.start()
        assert srv.arrived["slow"].wait(WAIT_S)   # the pull is held
        task.fail("chaos: sibling task failed")
        t.join(timeout=WAIT_S)
        assert not t.is_alive(), "remote source kept draining a dead task"
        assert outcome == ["aborted"]
        assert not hold.is_set()
    finally:
        hold.set()
        srv.close()


def test_chaos_worker_kill_exactly_once_with_four_producers(lock_validation,
                                                            expected):
    w1, w2, w3 = _workers(3)
    w2.task_manager.fault_injector, killed = _killer(w2)
    try:
        r = _runner([w1, w2, w3], n_tasks=4,
                    session={"exchange_max_error_duration": "5s",
                             "lock_validation": "on"})
        _same(r.execute(CHAOS_SQL), expected[CHAOS_SQL])
        assert killed.is_set(), "chaos hook never fired"
        assert r.tasks_retried >= 1
    finally:
        for w in (w1, w2, w3):
            w.close()


def test_exchange_metrics_and_buffer_bound_via_http(expected):
    from presto_tpu_torch.worker.exchange import EXCHANGE_METRICS
    w1, w2 = _workers(2)
    try:
        EXCHANGE_METRICS.reset()
        r = _runner([w1, w2], n_tasks=2,
                    session={"exchange_max_buffer_size": "1MB",
                             "exchange_max_response_size": "64kB"})
        _same(r.execute(CHAOS_SQL), expected[CHAOS_SQL])
        assert _metric(w1.uri, "presto_tpu_exchange_pages_total") > 0
        assert _metric(w1.uri, "presto_tpu_exchange_bytes_total") > 0
        assert _metric(w1.uri, "presto_tpu_exchange_clients_total") > 0
        peak = _metric(w1.uri, "presto_tpu_exchange_buffered_bytes_peak")
        assert 0 < peak <= 1 << 20, peak
        assert _metric(w1.uri, "presto_tpu_exchange_buffered_bytes") == 0
    finally:
        w1.close()
        w2.close()


def test_exchange_runtime_stats_surfaced(expected):
    w, = _workers(1)
    try:
        got = _runner([w], n_tasks=2).execute(CHAOS_SQL)
        _same(got, expected[CHAOS_SQL])
        stats = got.runtime_stats or {}
        for k in ("exchangeClientPages", "exchangeClientBytes",
                  "exchangeClientPullWallNanos",
                  "exchangeClientDrainWallNanos"):
            assert stats[k]["sum"] > 0, k
    finally:
        w.close()


# -- retry_policy=task: the spooled exchange, drain, deadline -------------------

def test_chaos_task_retry_policy_retries_only_failed_task(lock_validation,
                                                          expected):
    from presto_tpu_torch.worker.spooling import SPOOL_METRICS
    w1, w2 = _workers(2)
    hook, flaked = _flaky_once()
    w1.task_manager.fault_injector = w2.task_manager.fault_injector = hook
    SPOOL_METRICS.reset()
    try:
        r = _runner([w1, w2], n_tasks=2,
                    session={"retry_policy": "task",
                             "lock_validation": "on"})
        _same(r.execute(CHAOS_SQL), expected[CHAOS_SQL])
        assert len(flaked) == 1
        assert r.tasks_retried >= 1
        exe = r.last_execution
        failed_lineage = _base_lineage(flaked[0])
        assert dict(exe.budget_used) == {failed_lineage: 1}
        retry_ids = [t.task_id for t in exe.all_tasks
                     if _base_lineage(t.task_id) != t.task_id]
        assert retry_ids, "no retry attempt was placed"
        assert {_base_lineage(t) for t in retry_ids} == {failed_lineage}
        snap = SPOOL_METRICS.snapshot()
        assert snap["spooled_pages"] > 0 and snap["spooled_bytes"] > 0
        assert _metric(w1.uri, "presto_tpu_spool_spooled_bytes_total") > 0
    finally:
        w1.close()
        w2.close()


def test_chaos_worker_killed_task_policy_no_ancestor_rerun(lock_validation,
                                                          expected):
    w1, w2, w3 = _workers(3)
    w2.task_manager.fault_injector, killed = _killer(w2)
    try:
        r = _runner([w1, w2, w3], n_tasks=2,
                    session={"retry_policy": "task",
                             "exchange_max_error_duration": "10s",
                             "lock_validation": "on"})
        _same(r.execute(CHAOS_SQL), expected[CHAOS_SQL])
        assert killed.is_set(), "chaos hook never fired"
        assert r.tasks_retried >= 1
        exe = r.last_execution
        dead = {_base_lineage(t.task_id) for t in exe.all_tasks
                if t.worker_uri == w2.uri}
        assert set(exe.budget_used) <= dead
        retried = {_base_lineage(t.task_id) for t in exe.all_tasks
                   if _base_lineage(t.task_id) != t.task_id}
        assert retried and retried <= dead
        for t in exe.all_tasks:
            if _base_lineage(t.task_id) != t.task_id:
                assert t.worker_uri != w2.uri
    finally:
        for w in (w1, w2, w3):
            w.close()


def test_chaos_graceful_drain_zero_failures(lock_validation, expected):
    """SHUTTING_DOWN is PUT on a worker from its first task of two
    running queries (so both are in flight): both finish with the
    reference's rows, the detector stops placing tasks on the worker, and
    the worker closes itself once its output is consumed."""
    w1, w2, w3 = _workers(3)
    uris = [w1.uri, w2.uri, w3.uri]
    det = HeartbeatFailureDetector(uris, interval_s=0.1)
    session = {"retry_policy": "task", "lock_validation": "on"}
    runners = [HttpQueryRunner(uris, "sf0.01", n_tasks=2, device="cpu",
                               failure_detector=det, session=session)
               for _ in range(2)]
    results, errors = [], []
    fired = threading.Event()

    def drain(task_id):
        if not fired.is_set():
            fired.set()
            req = urllib.request.Request(
                w3.uri + "/v1/info/state", data=b'"SHUTTING_DOWN"',
                method="PUT", headers={"Content-Type": "application/json"})
            threading.Thread(
                target=lambda: urllib.request.urlopen(
                    req, timeout=WAIT_S).close(), daemon=True).start()

    def run_one(runner):
        try:
            results.append(runner.execute(CHAOS_SQL))
        except Exception as e:  # noqa: BLE001 -- asserted below
            errors.append(e)

    try:
        for r in runners:
            _same(r.execute(CHAOS_SQL), expected[CHAOS_SQL])
        w3.task_manager.fault_injector = drain
        threads = [threading.Thread(target=run_one, args=(r,))
                   for r in runners]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert fired.is_set(), "no task of the queries reached the worker"
        assert not errors, errors
        assert len(results) == 2
        for got in results:
            _same(got, expected[CHAOS_SQL])
        deadline = time.time() + WAIT_S
        while time.time() < deadline and \
                det.snapshot()[w3.uri]["draining"] is not True:
            time.sleep(0.05)
        assert det.snapshot()[w3.uri]["draining"] is True
        created_before = w3.task_manager.counts()["created"]
        _same(runners[0].execute(CHAOS_SQL), expected[CHAOS_SQL])
        assert w3.task_manager.counts()["created"] == created_before
        deadline = time.time() + 60
        while time.time() < deadline and not w3._closed:
            time.sleep(0.2)
        assert w3._closed, "graceful drain never completed"
    finally:
        det.close()
        for w in (w1, w2, w3):
            w.close()


def test_chaos_query_deadline_typed_error_no_retry(lock_validation):
    """query.max-execution-time: the query's task is held at its start
    until the query fails, so the 50 ms budget elapses whatever the
    machine's load; the typed EXCEEDED_TIME_LIMIT user error retries
    nothing."""
    from presto_tpu_torch.common.errors import (PrestoUserError,
                                                QueryDeadlineExceededError,
                                                is_retryable)
    w, = _workers(1)
    release = threading.Event()
    w.task_manager.fault_injector = lambda task_id: release.wait(WAIT_S)
    try:
        r = _runner([w], n_tasks=2,
                    session={"query_max_execution_time": "50ms",
                             "lock_validation": "on"})
        with pytest.raises(QueryDeadlineExceededError,
                           match="EXCEEDED_TIME_LIMIT"):
            r.execute(CHAOS_SQL)
        assert not release.is_set()
        assert r.tasks_retried == 0
        assert w.task_manager.tasks_retried == 0
        assert issubclass(QueryDeadlineExceededError, PrestoUserError)
        assert not is_retryable(QueryDeadlineExceededError(1.0, 0.05))
    finally:
        release.set()
        w.close()


def test_chaos_poison_split_quarantined(lock_validation):
    from presto_tpu_torch.common.errors import PoisonSplitError
    w1, w2 = _workers(2)
    target = []

    def poison(task_id):
        base = _base_lineage(task_id)
        if not target:
            target.append(base)
        if base == target[0]:
            raise InjectedTaskFailure("chaos: poison split crash")

    w1.task_manager.fault_injector = w2.task_manager.fault_injector = poison
    try:
        r = _runner([w1, w2], n_tasks=2,
                    session={"remote_task_retry_attempts": "4",
                             "lock_validation": "on"})
        with pytest.raises(PoisonSplitError, match="POISON_SPLIT") as ei:
            r.execute(CHAOS_SQL)
        assert target[0] in str(ei.value)
        assert r.last_execution.budget_used.get(target[0], 0) <= 2
    finally:
        w1.close()
        w2.close()


def test_producer_coalesces_small_pages_per_response():
    from presto_tpu_torch.worker.buffers import PageBuffer
    tiny = _page_bytes([1, 2, 3])
    buf = PageBuffer(coalesce_target_bytes=len(tiny) * 4)
    for _ in range(10):
        buf.add(tiny)
    buf.set_complete()
    pages, nxt, done = buf.get(0, max_wait_s=0.1)
    assert [len(p) // len(tiny) for p in pages] == [4, 4, 2]
    assert done and nxt == 3
    capped, nxt2, done2 = buf.get(0, max_wait_s=0.1,
                                  max_bytes=len(tiny) * 4)
    assert len(capped) == 1 and not done2 and nxt2 == 1
