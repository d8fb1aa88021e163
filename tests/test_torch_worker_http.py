"""The port's HTTP worker protocol against the JAX package.

The cases of tests/test_worker_http.py: real loopback HTTP between the
port's HttpQueryRunner and port WorkerServer(device="cpu") workers in one
process, rows held to the JAX package's (its golden TPC-H rows at
sf0.01, else its LocalQueryRunner).  Then what the port adds: every
task's TaskContext is on its server's device (the CPU here, the tensors
of every batch included), "cuda" without CUDA refuses to start, and the
wire interoperates both ways: the port's HttpQueryRunner over a port
worker and a JAX-package worker, and the JAX package's HttpQueryRunner
over the same pair, each Q1 equal to the reference's rows."""
import json
import os
import re
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest
import torch

from presto_tpu_torch.benchmarks.rows import (assert_rows_close,
                                              golden_result)
from presto_tpu_torch.benchmarks.tpch_queries import ALL
from presto_tpu_torch.worker import HttpQueryRunner, WorkerServer
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "presto_tpu_torch", "benchmarks",
                      "tpch_sf001_rows.json")
WAIT_S = 90.0


def _cpu_worker(**kw):
    return WorkerServer(device="cpu", **kw)


@pytest.fixture(scope="module")
def cluster():
    coordinator = WorkerServer(coordinator=True, environment="test",
                               device="cpu")
    workers = [_cpu_worker(discovery_uri=coordinator.uri,
                           announce_interval_s=0.1, environment="test")
               for _ in range(2)]
    deadline = time.time() + WAIT_S
    while len(coordinator.worker_uris()) < 2 and time.time() < deadline:
        time.sleep(0.05)
    yield coordinator, workers
    for w in workers:
        w.close()
    coordinator.close()


@pytest.fixture(scope="module")
def runner(cluster):
    coordinator, _ = cluster
    uris = coordinator.worker_uris()
    assert len(uris) == 2, "workers failed to announce"
    return HttpQueryRunner(uris, "sf0.01", n_tasks=2, device="cpu")


@pytest.fixture(scope="module")
def jrunner():
    from presto_tpu.exec.runner import LocalQueryRunner
    return LocalQueryRunner("sf0.01")


def _golden(q):
    with open(GOLDEN) as f:
        doc = json.load(f)
    return golden_result(doc["queries"][str(q)]), q in doc["ordered"]


def _get_json(url):
    with urllib.request.urlopen(url, timeout=WAIT_S) as resp:
        return json.loads(resp.read())


def _put_state(uri, state="SHUTTING_DOWN"):
    req = urllib.request.Request(
        uri + "/v1/info/state", data=json.dumps(state).encode(),
        method="PUT", headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=WAIT_S) as r:
        return json.loads(r.read())


# -- discovery / announcement protocol --------------------------------------

def test_announcement_discovery(cluster):
    coordinator, workers = cluster
    services = _get_json(f"{coordinator.uri}/v1/service")["services"]
    uris = {s["properties"]["http"] for s in services}
    assert {w.uri for w in workers} <= uris
    assert all(s["properties"]["pool_type"] == "TPU" for s in services)


def test_node_info(cluster):
    _, workers = cluster
    assert _get_json(f"{workers[0].uri}/v1/info")["coordinator"] is False
    assert _get_json(f"{workers[0].uri}/v1/info/state") == "ACTIVE"


def test_unknown_task_404(cluster):
    _, workers = cluster
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"{workers[0].uri}/v1/task/nope/status",
                               timeout=WAIT_S)
    assert e.value.code == 404


# -- end-to-end queries over the HTTP exchange -------------------------------

def test_http_scan_filter(runner, jrunner):
    sql = "select n_name, n_regionkey from nation where n_regionkey = 2"
    got = runner.execute(sql)
    assert_rows_close(got, jrunner.execute(sql), ordered=False)
    assert len(got.rows) == 5


@pytest.mark.parametrize("q", [6, 1, 3], ids=["q6", "q1", "q3"])
def test_http_tpch(runner, q):
    """Q6, Q1 and Q3 (its partitioned exchange) against the JAX
    package's golden rows (the reference's test_http_q6 / _q1 /
    _q3_partitioned_exchange)."""
    want, ordered = _golden(q)
    assert_rows_close(runner.execute(ALL[q]), want, ordered=ordered)


def test_http_join_group(runner, jrunner):
    sql = """
        select o_orderstatus, count(*), sum(o_totalprice)
        from orders, customer where c_custkey = o_custkey
          and c_mktsegment = 'BUILDING'
        group by o_orderstatus order by o_orderstatus"""
    assert_rows_close(runner.execute(sql), jrunner.execute(sql),
                      ordered=True)


def test_http_failure_propagates(runner):
    with pytest.raises(Exception):
        runner.execute("select unknown_column from nation")


def test_task_status_long_poll(cluster, runner):
    _, workers = cluster
    runner.execute("select count(*) from region")
    tm = workers[0].task_manager
    if not tm.tasks:
        tm = workers[1].task_manager
    task_id = next(iter(tm.tasks))
    t0 = time.time()
    status = _get_json(
        f"{tm.tasks[task_id].self_uri}/status?maxWaitMs=60000")
    assert time.time() - t0 < 30.0  # terminal state: no full 60 s wait
    assert status["state"] in ("FINISHED", "CANCELED")


def test_external_worker_process(cluster):
    """A worker subprocess through `python -m presto_tpu_torch.worker
    --device cpu` runs a query and announces to the coordinator."""
    coordinator, _ = cluster
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "presto_tpu_torch.worker", "--environment",
         "test", "--discovery-uri", coordinator.uri, "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
    try:
        line = proc.stdout.readline()
        m = re.search(r"listening on (http://[\d.:]+)", line)
        assert m, f"no startup line: {line!r}"
        uri = m.group(1)
        r = HttpQueryRunner([uri], "sf0.01", n_tasks=1, device="cpu")
        res = r.execute("select r_name from region order by r_name")
        assert [row[0] for row in res.rows] == [
            "AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
        deadline = time.time() + WAIT_S
        while uri not in coordinator.worker_uris() and time.time() < deadline:
            time.sleep(0.05)
        assert uri in coordinator.worker_uris()
    finally:
        proc.terminate()
        proc.wait(timeout=WAIT_S)


def test_status_and_metrics_endpoints():
    w = _cpu_worker()
    try:
        st = _get_json(w.uri + "/v1/status")
        assert st["nodeId"] == w.node_id and st["state"] == "ACTIVE"
        assert st["totalTasks"] == 0 and st["tasks"] == {}
        with urllib.request.urlopen(w.uri + "/v1/metrics",
                                    timeout=WAIT_S) as r:
            text = r.read().decode()
        assert "presto_tpu_uptime_seconds" in text
        assert "presto_tpu_tasks_created_total 0" in text
    finally:
        w.close()


def test_graceful_shutdown_refuses_new_tasks():
    w = _cpu_worker()
    try:
        assert _put_state(w.uri) == "SHUTTING_DOWN"
        assert _get_json(w.uri + "/v1/info/state") == "SHUTTING_DOWN"
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(urllib.request.Request(
                w.uri + "/v1/task/q.0.0", data=b"{}", method="POST"),
                timeout=WAIT_S)
        assert e.value.code == 503
    finally:
        w.close()


def test_failure_detector_drops_dead_and_draining_workers():
    from presto_tpu_torch.worker.coordinator import HeartbeatFailureDetector
    w1, w2, w3 = _cpu_worker(), _cpu_worker(), _cpu_worker()
    det = HeartbeatFailureDetector([w1.uri, w2.uri, w3.uri], interval_s=0.1,
                                   threshold=2)
    try:
        deadline = time.time() + WAIT_S
        while time.time() < deadline and len(det.alive()) != 3:
            time.sleep(0.1)
        assert sorted(det.alive()) == sorted([w1.uri, w2.uri, w3.uri])
        w3.close()
        _put_state(w2.uri)
        deadline = time.time() + WAIT_S
        while time.time() < deadline and det.alive() != [w1.uri]:
            time.sleep(0.1)
        assert det.alive() == [w1.uri]
        assert det.failed() == [w3.uri]
        r = HttpQueryRunner([w1.uri, w2.uri, w3.uri], "sf0.01",
                            failure_detector=det, n_tasks=2, device="cpu")
        assert r.execute("select count(*) from nation").rows == [[25]]
    finally:
        det.close()
        w1.close()
        w2.close()


def test_draining_worker_task_rerouted():
    w1, w2 = _cpu_worker(), _cpu_worker()
    try:
        _put_state(w2.uri)
        r = HttpQueryRunner([w2.uri, w1.uri], "sf0.01", n_tasks=2,
                            device="cpu")
        assert r.execute("select count(*) from nation").rows == [[25]]
    finally:
        w1.close()
        w2.close()


def test_session_properties_applied():
    from presto_tpu_torch.exec.pipeline import ExecutionConfig
    from presto_tpu_torch.worker.protocol import (apply_session_properties,
                                                  parse_data_size)
    assert parse_data_size("512MB") == 512 << 20
    assert parse_data_size("1GB") == 1 << 30
    assert parse_data_size(12345) == 12345
    cfg = apply_session_properties(ExecutionConfig(), {
        "query_max_memory_per_node": "64MB",
        "spill_enabled": "false",
        "task_batch_rows": "4096",
        "unknown_property": "ignored",
    })
    assert cfg.memory_budget_bytes == 64 << 20
    assert cfg.spill_enabled is False
    assert cfg.batch_rows == 4096


def test_session_properties_over_http():
    w = _cpu_worker()
    try:
        r = HttpQueryRunner([w.uri], "sf0.01", n_tasks=1, device="cpu",
                            session={"task_batch_rows": "8192"})
        assert r.execute("select count(*) from nation").rows == [[25]]
    finally:
        w.close()


def test_malformed_session_property_fails_task():
    w = _cpu_worker()
    try:
        r = HttpQueryRunner([w.uri], "sf0.01", n_tasks=1, device="cpu",
                            session={"task_batch_rows": "not-a-number"})
        with pytest.raises(RuntimeError, match="(?i)failed"):
            r.execute("select count(*) from nation")
        # the task is terminal (FAILED), not stranded in PLANNED
        assert w.task_manager.counts()["by_state"].get("PLANNED", 0) == 0
    finally:
        w.close()


WIDE = ("select orderkey, orderpriority, comment from orders "
        "where orderkey < 20000 order by orderkey limit 2000")


def test_exchange_compression_over_http(jrunner):
    """exchange_compression: pages crossing the exchange carry the
    COMPRESSED marker, and the rows equal the uncompressed run's and the
    JAX package's."""
    import struct
    import presto_tpu_torch.worker.task as task_mod
    from presto_tpu_torch.common.serde import COMPRESSED
    compressed_pages = [0]
    real = task_mod.serialize_page

    def recording(page, checksummed=True, compress=False, codec="LZ4"):
        data = real(page, checksummed=checksummed, compress=compress,
                    codec=codec)
        if struct.unpack_from("<ibiiq", data, 0)[1] & COMPRESSED:
            compressed_pages[0] += 1
        return data

    w1, w2 = _cpu_worker(), _cpu_worker()
    task_mod.serialize_page = recording
    try:
        plain = HttpQueryRunner([w1.uri, w2.uri], "sf0.01", n_tasks=2,
                                device="cpu")
        expect = plain.execute(WIDE)
        assert compressed_pages[0] == 0
        assert_rows_close(expect, jrunner.execute(WIDE), ordered=True)
        r = HttpQueryRunner([w1.uri, w2.uri], "sf0.01", n_tasks=2,
                            device="cpu",
                            session={"exchange_compression": "true"})
        assert r.execute(WIDE).rows == expect.rows
        assert compressed_pages[0] > 0, "no page was actually compressed"
    finally:
        task_mod.serialize_page = real
        w1.close()
        w2.close()


def test_exchange_compression_non_default_codec():
    w1, w2 = _cpu_worker(), _cpu_worker()
    try:
        expect = HttpQueryRunner([w1.uri, w2.uri], "sf0.01", n_tasks=2,
                                 device="cpu").execute(WIDE).rows
        r = HttpQueryRunner(
            [w1.uri, w2.uri], "sf0.01", n_tasks=2, device="cpu",
            session={"exchange_compression": "true",
                     "exchange_compression_codec": "ZSTD"})
        assert r.execute(WIDE).rows == expect
    finally:
        w1.close()
        w2.close()


def test_unsupported_codec_rejected_at_task_start():
    from presto_tpu_torch.exec.pipeline import ExecutionConfig
    from presto_tpu_torch.worker.protocol import apply_session_properties
    with pytest.raises(ValueError, match="LZO"):
        apply_session_properties(
            ExecutionConfig(), {"exchange_compression_codec": "LZO"})


# -- the task's device -------------------------------------------------------

def test_task_computes_on_the_servers_device(monkeypatch):
    """Every task's TaskContext is built with its server's device, and
    every batch its fragment produces lies there (the CPU here: a
    WorkerServer(device="cuda") task is on the card, never the CPU).  The
    context's own default is the CPU, so the constructor's arguments are
    recorded: a task that left the device out would pass the other
    checks on this server."""
    import presto_tpu_torch.worker.task as task_mod
    contexts, devices, ctx_kwargs = [], set(), []
    real_context = task_mod.TaskContext

    def recording_context(*args, **kwargs):
        ctx_kwargs.append(kwargs)
        return real_context(*args, **kwargs)

    class Recording(task_mod.PlanCompiler):
        def run_to_pages(self, root):
            contexts.append(self.ctx.device)
            src = self.compile(root)
            inner = src._fn

            def fn():
                for b in inner():
                    devices.add(b.mask.device)
                    devices.update(c.values.device
                                   for c in b.columns.values())
                    yield b
            src._fn = fn
            return super().run_to_pages(root)

    monkeypatch.setattr(task_mod, "PlanCompiler", Recording)
    monkeypatch.setattr(task_mod, "TaskContext", recording_context)
    w = _cpu_worker()
    try:
        assert w.task_manager.device == torch.device("cpu")
        r = HttpQueryRunner([w.uri], "sf0.01", n_tasks=2, device="cpu")
        want, _ = _golden(6)
        assert_rows_close(r.execute(ALL[6]), want, ordered=False)
        assert len(contexts) == 3       # 2 source tasks and the root
        assert len(ctx_kwargs) == 3
        assert all(kw.get("device") == w.task_manager.device
                   for kw in ctx_kwargs), ctx_kwargs
        assert set(contexts) == {torch.device("cpu")}
        assert devices == {torch.device("cpu")}
        assert {t.device for t in w.task_manager.tasks.values()} \
            == {torch.device("cpu")}
    finally:
        w.close()


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_cuda_without_a_card_refuses_to_start():
    from presto_tpu_torch.worker.task import TaskManager
    for make in (lambda: WorkerServer(), lambda: TaskManager(),
                 lambda: HttpQueryRunner([], "sf0.01")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


# -- wire compatibility with the JAX package, both ways ----------------------

def test_port_and_reference_workers_interoperate():
    """Q1 at sf0.01 over one port worker and one JAX-package worker:
    first through the port's HttpQueryRunner, then through the JAX
    package's, each equal to the golden rows.  Pages, task updates and
    status travel between the two packages' serde and protocol in both
    directions."""
    from presto_tpu.worker.coordinator import HttpQueryRunner as JRunner
    from presto_tpu.worker.server import WorkerServer as JServer
    port, ref = _cpu_worker(), JServer()
    want, ordered = _golden(1)
    try:
        for runner in (HttpQueryRunner([port.uri, ref.uri], "sf0.01",
                                       n_tasks=2, device="cpu"),
                       JRunner([port.uri, ref.uri], "sf0.01", n_tasks=2)):
            port_before = port.task_manager.counts()["created"]
            ref_before = ref.task_manager.counts()["created"]
            assert_rows_close(runner.execute(ALL[1]), want, ordered=ordered)
            assert port.task_manager.counts()["created"] > port_before
            assert ref.task_manager.counts()["created"] > ref_before
            assert port.task_manager.counts()["failed"] == 0
            assert ref.task_manager.counts()["failed"] == 0
    finally:
        port.close()
        ref.close()


def test_system_runtime_tasks_lists_the_servers_tasks():
    """system.runtime_tasks reads the server's task manager, as the
    reference's does: the tasks an HttpQueryRunner ran on a coordinator
    (with no announced workers, so its statements run locally) are listed
    with their states and output rows."""
    from presto_tpu_torch.client import StatementClient
    s = WorkerServer(coordinator=True, device="cpu")
    try:
        r = HttpQueryRunner([s.uri], "sf0.01", n_tasks=1, device="cpu")
        assert r.execute("select count(*) from nation").rows == [[25]]
        ids = set(s.task_manager.tasks)
        rows = StatementClient(s.uri, schema="sf0.01").execute(
            "SELECT task_id, state, output_rows FROM runtime_tasks").rows
        assert {row[0] for row in rows} == ids
        assert all(row[1] == "FINISHED" and row[2] >= 1 for row in rows)
    finally:
        s.close()
