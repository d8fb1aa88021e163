"""The port's query router (worker/router.py) and external-worker
launcher (worker/launcher.py) against the JAX package.

The cases of tests/test_router.py and test_launcher.py: the router
balances and plan-checks over port coordinators
(WorkerServer(coordinator=True, device="cpu")), its plan checks agree
with the reference's, and the launcher writes the reference's etc
layout and spawns `python -m presto_tpu_torch.worker` workers with an
explicit device ("cpu" here; the default "cuda" exits at start-up
without a card).  The Java-coordinator parity case skips under the
reference's own condition."""
import json
import os
import subprocess
import sys
import time
import urllib.request

import pytest
import torch

from presto_tpu_torch.client import StatementClient
from presto_tpu_torch.exec.pipeline import ExecutionConfig
from presto_tpu_torch.worker import HttpQueryRunner, WorkerServer
from presto_tpu_torch.worker.launcher import launch_worker, write_etc_dir
from presto_tpu_torch.worker.router import QueryRouter, plan_checks
from presto_tpu_torch.worker.statement import _is_retryable
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 60.0


def _orders_rows():
    from presto_tpu.connectors import catalog as jcatalog
    return jcatalog.table_row_count("orders", 0.01)


@pytest.fixture(scope="module")
def cluster():
    a, b = (WorkerServer(coordinator=True, environment="test", device="cpu",
                         config=ExecutionConfig(batch_rows=1 << 13))
            for _ in range(2))
    yield a, b
    a.close()
    b.close()


# -- the router -----------------------------------------------------------------

@pytest.mark.parametrize("sql", [
    "SELECT count(*) c FROM lineitem", "SELECT broken syntax FROM FROM",
    "SELECT no_such_fn(quantity) x FROM lineitem"])
def test_plan_checks(sql):
    from presto_tpu.worker.router import plan_checks as jplan_checks
    got = plan_checks(sql)
    assert (got is None) == (jplan_checks(sql) is None)
    assert (got is None) == sql.startswith("SELECT count")


def test_round_robin_routing(cluster):
    a, b = cluster
    router = QueryRouter([a.uri, b.uri])
    try:
        assert {router.route("SELECT 1 x") for _ in range(4)} \
            == {a.uri, b.uri}
        # end to end through the redirect: the client follows the 307
        r = StatementClient(router.uri, schema="sf0.01").execute(
            "SELECT count(*) c FROM orders")
        assert r.rows == [[_orders_rows()]]
    finally:
        router.close()


def test_plan_check_fallback(cluster):
    a, b = cluster
    router = QueryRouter([a.uri], scheduler="plan_check", fallback=b.uri)
    try:
        assert router.route("SELECT count(*) c FROM orders") == a.uri
        assert router.route("SELECT wat(no) FROM nowhere") == b.uri
    finally:
        router.close()


def test_plan_check_sidecar_endpoint(cluster):
    a, _ = cluster
    for sql, ok in ((b"SELECT count(*) c FROM orders", True),
                    (b"SELECT nope(1) FROM nope", False)):
        req = urllib.request.Request(f"{a.uri}/v1/plan-check", data=sql,
                                     method="POST")
        out = json.loads(urllib.request.urlopen(req, timeout=WAIT_S).read())
        assert out["ok"] is ok
        assert ("error" in out) is (not ok)


def test_router_clusters_endpoint(cluster):
    a, b = cluster
    router = QueryRouter([a.uri, b.uri])
    try:
        with urllib.request.urlopen(f"{router.uri}/v1/router/clusters",
                                    timeout=WAIT_S) as resp:
            assert set(json.loads(resp.read())["clusters"]) == {a.uri, b.uri}
    finally:
        router.close()


def test_retry_classification():
    from presto_tpu.worker.statement import _is_retryable as j_is_retryable
    for e, want in ((ConnectionRefusedError("connection refused"), True),
                    (RuntimeError("no live workers"), True),
                    (ValueError("column 'x' not found"), False)):
        assert _is_retryable(e) is want is j_is_retryable(e)


def test_ui_page(cluster):
    a, _ = cluster
    StatementClient(a.uri, schema="sf0.01").execute("SELECT 1 x")
    html = urllib.request.urlopen(f"{a.uri}/ui", timeout=WAIT_S).read() \
        .decode()
    assert "presto-tpu coordinator" in html
    assert "FINISHED" in html


# -- the launcher -----------------------------------------------------------------

def test_write_etc_dir_layout(tmp_path):
    from presto_tpu.worker.launcher import write_etc_dir as jwrite
    from presto_tpu_torch.worker.properties import load_properties
    etc = write_etc_dir(3, "http://127.0.0.1:9999", base_dir=str(tmp_path))
    jetc = jwrite(3, "http://127.0.0.1:9999", base_dir=str(tmp_path / "j"))
    cfg = load_properties(os.path.join(etc, "config.properties"))
    assert cfg == load_properties(os.path.join(jetc, "config.properties"))
    assert cfg["discovery.uri"] == "http://127.0.0.1:9999"
    assert cfg["http-server.http.port"] == "0"
    node = load_properties(os.path.join(etc, "node.properties"))
    assert node["node.environment"] == "testing"
    assert sorted(os.listdir(os.path.join(etc, "catalog"))) \
        == sorted(os.listdir(os.path.join(jetc, "catalog"))) \
        == ["tpchstandard.properties"]


def _wait_announced(coordinator):
    deadline = time.time() + WAIT_S
    while not coordinator.worker_uris() and time.time() < deadline:
        time.sleep(0.1)
    return coordinator.worker_uris()


def test_launcher_spawns_announcing_worker(tmp_path):
    coordinator = WorkerServer(coordinator=True, environment="testing",
                               device="cpu")
    proc = None
    try:
        proc = launch_worker(0, coordinator.uri, base_dir=str(tmp_path),
                             device="cpu")
        uris = _wait_announced(coordinator)
        assert uris, "worker never announced"
        r = HttpQueryRunner(uris, "sf0.01", n_tasks=1, device="cpu")
        assert r.execute("select count(*) from nation").rows == [[25]]
    finally:
        if proc is not None:
            proc.terminate()
            proc.wait(timeout=WAIT_S)
        coordinator.close()


def test_launcher_exec_form(tmp_path):
    coordinator = WorkerServer(coordinator=True, environment="testing",
                               device="cpu")
    env = dict(os.environ, PYTHONPATH=ROOT, TMPDIR=str(tmp_path))
    proc = subprocess.Popen(
        [sys.executable, "-m", "presto_tpu_torch.worker.launcher",
         "1", coordinator.uri, "--device", "cpu"],
        stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT, env=env)
    try:
        assert _wait_announced(coordinator), \
            "exec-form worker never announced"
    finally:
        proc.terminate()
        proc.wait(timeout=WAIT_S)
        coordinator.close()


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_launcher_default_device_needs_the_card(tmp_path):
    """Without --device the exec form's worker runs on the card: without
    CUDA it exits non-zero at start-up instead of running on the CPU."""
    env = dict(os.environ, PYTHONPATH=ROOT, TMPDIR=str(tmp_path))
    proc = subprocess.run(
        [sys.executable, "-m", "presto_tpu_torch.worker.launcher", "2",
         "http://127.0.0.1:9"], capture_output=True, text=True, env=env,
        timeout=WAIT_S)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stdout + proc.stderr


JAVA_URI = os.environ.get("PRESTO_JAVA_COORDINATOR_URI")


@pytest.mark.skipif(not JAVA_URI, reason="PRESTO_JAVA_COORDINATOR_URI not "
                    "set (no Java coordinator in this environment)")
def test_java_coordinator_parity():
    """A Java coordinator whose workers the launcher spawned, through the
    statement protocol, against the port's LocalQueryRunner."""
    from presto_tpu_torch.exec.runner import LocalQueryRunner
    for sql in ("select count(*) from nation",
                "select l_returnflag, l_linestatus, sum(l_quantity) "
                "from lineitem group by l_returnflag, l_linestatus "
                "order by l_returnflag, l_linestatus"):
        req = urllib.request.Request(
            JAVA_URI.rstrip("/") + "/v1/statement", data=sql.encode(),
            headers={"X-Presto-User": "parity",
                     "X-Presto-Catalog": "tpchstandard",
                     "X-Presto-Schema": "sf0.01"})
        d = json.loads(urllib.request.urlopen(req, timeout=30).read())
        rows = list(d.get("data", []))
        deadline = time.time() + 300
        while "nextUri" in d and time.time() < deadline:
            d = json.loads(urllib.request.urlopen(
                d["nextUri"], timeout=30).read())
            rows.extend(d.get("data", []))
        assert "error" not in d, d.get("error")
        local = LocalQueryRunner("sf0.01", device="cpu").execute(sql).rows
        assert [[*map(str, r)] for r in rows] == \
            [[*map(str, r)] for r in local]
