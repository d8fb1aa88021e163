"""The port's statement server against the reference's, on the CPU.

A reference WorkerServer(coordinator=True) and the port's
WorkerServer(coordinator=True, device="cpu") run in one process.  The
same statements go through the port's StatementClient and the reference's
(the protocol is the same): rows, column names and types must be equal.
Then the port alone: statements that fail with the port's
NotImplementedError text, session properties, cancel, queueing and
resource groups, /v1/query/{id}, two statements at once, the DB-API
cursor, the process booted from an etc directory, and its refusal to
start on a missing card."""
import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.request

import pytest

from presto_tpu.client import StatementClient as JClient
from presto_tpu.worker.server import WorkerServer as JServer
from presto_tpu_torch.benchmarks.grouped_queries import S1
from presto_tpu_torch.benchmarks.join_queries import J1
from presto_tpu_torch.benchmarks.tpch_queries import Q1, Q6
from presto_tpu_torch.benchmarks.window_queries import W1
from presto_tpu_torch.client import QueryError, StatementClient
from presto_tpu_torch.worker import WorkerServer
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DECIMALS_AND_NULLS = (
    "select sum(l_extendedprice) as s, avg(l_discount) as a, "
    "max(l_tax) as m, count(l_quantity) as c from lineitem "
    "where l_quantity < 0")
DECIMAL_GROUPS = (
    "select l_returnflag, sum(l_extendedprice * (1 - l_discount)) as r, "
    "avg(l_quantity) as q, min(l_discount) as d from lineitem "
    "group by l_returnflag order by l_returnflag")
# about 9000 rows: three result chunks of 4096
PAGED = ("select l_orderkey, l_linenumber, l_quantity from lineitem "
         "where l_quantity < 9")
EXPLAIN = ("explain select l_returnflag, count(*) from lineitem "
           "where l_quantity < 5 group by l_returnflag")

STATEMENTS = [("q6", Q6, True), ("q1", Q1, True), ("s1", S1, False),
              ("j1", J1, True), ("w1", W1, True),
              ("explain", EXPLAIN, True),
              ("decimals_and_nulls", DECIMALS_AND_NULLS, True),
              ("decimal_groups", DECIMAL_GROUPS, True),
              ("paged", PAGED, False)]


@pytest.fixture(scope="module")
def servers():
    ref = JServer(coordinator=True)
    port = WorkerServer(coordinator=True, device="cpu")
    yield ref, port
    port.close()
    ref.close()


def _rows(result, ordered):
    return result.rows if ordered else sorted(
        result.rows, key=lambda r: tuple((v is None, str(v)) for v in r))


@pytest.mark.parametrize("client_cls", [StatementClient, JClient],
                         ids=["port_client", "reference_client"])
@pytest.mark.parametrize("name,sql,ordered", STATEMENTS,
                         ids=[s[0] for s in STATEMENTS])
def test_statements_equal_the_reference_server(servers, client_cls, name,
                                               sql, ordered):
    ref, port = servers
    exp = client_cls(ref.uri, schema="sf0.01").execute(sql)
    got = client_cls(port.uri, schema="sf0.01").execute(sql)
    assert got.columns == exp.columns          # names and types
    assert _rows(got, ordered) == _rows(exp, ordered)
    if name == "paged":
        assert len(got.rows) > 2 * 4096
    if name == "decimals_and_nulls":
        assert got.rows == [[None, None, None, 0]]


def _post(uri, sql, headers=None):
    req = urllib.request.Request(uri + "/v1/statement", data=sql.encode(),
                                 headers={"X-Presto-User": "t",
                                          "X-Presto-Schema": "sf0.01",
                                          **(headers or {})})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


@pytest.mark.parametrize("sql,session,match", [
    # an EXPLAIN ANALYZE whose execution raises (a varchar COALESCE,
    # which raises in both packages) carries the error
    ("explain analyze select coalesce(n_name, r_name) from nation join "
     "region on n_regionkey = r_regionkey", {},
     "NotImplementedError: varchar operands"),
    # PREPARE is ported since: an EXECUTE of a name no PREPARE made
    # carries the reference server's error text
    ("execute nosuch using 1", {},
     "KeyError: \"prepared statement 'nosuch' does not exist\""),
    # every session property is ported since: a bad retry_policy fails
    # in both servers with the same error
    (Q6, {"retry_policy": "sometimes"},
     "ValueError: retry_policy must be one of"),
    (Q6, {"scan_kernel": "bogus"}, "ValueError: scan_kernel must be one"),
], ids=["explain_analyze", "prepare", "unported_session", "bad_session"])
def test_failed_statements_carry_the_error(servers, sql, session, match):
    ref, port = servers
    with pytest.raises(QueryError, match=re.escape(match)):
        StatementClient(port.uri, schema="sf0.01",
                        session=session).execute(sql)
    if sql.startswith("execute") or "retry_policy" in session:
        from presto_tpu.client import QueryError as JQueryError
        with pytest.raises(JQueryError, match=re.escape(match)):
            JClient(ref.uri, schema="sf0.01",
                    session=session).execute(sql)


def test_session_properties_reach_the_runner(servers):
    ref, port = servers
    session = {"scan_kernel": "pallas", "task_batch_rows": "8192",
               "scan_kernel_dma": "double"}
    exp = JClient(ref.uri, schema="sf0.01", session=session).execute(S1)
    got = StatementClient(port.uri, schema="sf0.01",
                          session=session).execute(S1)
    assert _rows(got, False) == _rows(exp, False)
    with port._runner_lock:
        cfgs = [r.config for r in port._runner_cache.values()]
    assert any(c.batch_rows == 8192 and c.scan_kernel == "pallas"
               for c in cfgs)


def test_query_info_carries_kernel_stats(servers):
    _ref, port = servers
    d = _post(port.uri, Q1)
    qid = d["id"]
    while "nextUri" in d:
        d = _get(d["nextUri"])
    info = _get(f"{port.uri}/v1/query/{qid}")
    assert info["state"] == "FINISHED"
    rs = info["runtimeStats"]
    assert rs["kernelScanPrograms"]["sum"] == 1
    assert not [k for k in rs if k.startswith("kernelDeclined")]
    kernel = info["processMetrics"]["kernel"]
    assert {"scan_programs", "dma_staged_blocks", "dma_prefetched_blocks",
            "dma_overlap_fraction"} <= set(kernel)
    assert info["processMetrics"]["memory"]["device"] == "cpu"
    listed = _get(f"{port.uri}/v1/query?state=FINISHED")
    assert qid in [q["queryId"] for q in listed]
    text = urllib.request.urlopen(port.uri + "/v1/metrics").read().decode()
    assert "presto_tpu_kernel_scan_programs_total" in text
    assert "presto_tpu_kernel_dma_staged_blocks_total" in text


def _metric_types(uri, prefixes):
    text = urllib.request.urlopen(uri + "/v1/metrics").read().decode()
    return sorted(line for line in text.splitlines()
                  if line.startswith("# TYPE ")
                  and line.split()[2].startswith(prefixes))


def test_metrics_carry_adaptive_and_fabric_sections(servers):
    """/v1/metrics has the reference's presto_tpu_adaptive_* and
    presto_tpu_exchange_fabric_* sections, metric for metric."""
    ref, port = servers
    prefixes = ("presto_tpu_adaptive_", "presto_tpu_exchange_fabric_")
    got = _metric_types(port.uri, prefixes)
    assert got and got == _metric_types(ref.uri, prefixes)
    assert any("adaptive_filters_applied_total" in t for t in got)
    assert any("exchange_fabric_bytes_total" in t for t in got)


def test_metrics_carry_the_memory_section(servers):
    """/v1/metrics has the reference's presto_tpu_memory_* section (the
    process's MEMORY_METRICS), metric for metric, beside the port's
    presto_tpu_memory_device_* gauges."""
    from presto_tpu_torch.exec.memory import MEMORY_METRICS
    ref, port = servers
    got = [t for t in _metric_types(port.uri, ("presto_tpu_memory_",))
           if "presto_tpu_memory_device_" not in t]
    assert got and got == _metric_types(ref.uri, ("presto_tpu_memory_",))
    text = urllib.request.urlopen(port.uri + "/v1/metrics").read().decode()
    assert f"presto_tpu_memory_revocations_total " \
        f"{MEMORY_METRICS.snapshot()['revocations']}" in text


def test_unported_routes_name_what_is_missing(servers):
    """The task routes and /v1/plan-check are ported since the task
    plane: no route answers 501 any more, and each answers as the
    reference server's does (an unknown task 404, a malformed update
    404, an unplannable statement ok=false with its error)."""
    ref, port = servers
    for method, path, body in (("GET", "/v1/task/t1", None),
                               ("GET", "/v1/task/t1/status", None),
                               ("POST", "/v1/task/t1", b"{}")):
        codes = []
        for srv in (ref, port):
            req = urllib.request.Request(srv.uri + path, method=method,
                                         data=body)
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(req, timeout=30)
            codes.append(e.value.code)
        assert codes == [404, 404], (path, codes)
    for sql in (b"select count(*) from lineitem", b"select nope(1) from x"):
        got = []
        for srv in (ref, port):
            req = urllib.request.Request(srv.uri + "/v1/plan-check",
                                         data=sql, method="POST")
            got.append(json.loads(urllib.request.urlopen(
                req, timeout=30).read()))
        assert got[0]["ok"] == got[1]["ok"]
        assert ("error" in got[0]) == ("error" in got[1])
    info = _get(port.uri + "/v1/info")
    assert info["coordinator"] is True
    assert _get(port.uri + "/v1/status")["nodeId"] == port.node_id


def test_two_statements_at_once(servers):
    _ref, port = servers
    want = {q: StatementClient(port.uri, schema="sf0.01").execute(q).rows
            for q in (Q1, S1)}
    got, errors = {}, []

    def run(q):
        try:
            got[q] = StatementClient(port.uri, schema="sf0.01") \
                .execute(q).rows
        except Exception as e:   # noqa: BLE001 -- reported below
            errors.append(e)
    threads = [threading.Thread(target=run, args=(q,))
               for q in (Q1, S1, Q1, S1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not errors, errors
    assert got == want


def _queue_states(server_cls, **kw):
    """A group of one running slot and one queue place: a streaming
    statement holds its slot until drained, the next one queues, the third
    is rejected; the queued one is cancelled, then the first drains."""
    from presto_tpu_torch.worker.statement import (ResourceGroupManager,
                                                   ResourceGroupSpec,
                                                   Selector)
    if server_cls is JServer:
        from presto_tpu.worker.statement import (ResourceGroupManager,
                                                 ResourceGroupSpec,
                                                 Selector)
    rg = ResourceGroupManager(
        [ResourceGroupSpec("tiny", hard_concurrency_limit=1, max_queued=1)],
        selectors=[Selector("tiny")])
    s = server_cls(coordinator=True, resource_groups=rg, **kw)
    try:
        first = _post(s.uri, PAGED)
        while "data" not in first and "nextUri" in first:
            first = _get(first["nextUri"])
        second = _post(s.uri, Q6)
        third = _post(s.uri, Q6)
        states = [_get(f"{s.uri}/v1/query/{d['id']}")["state"]
                  for d in (first, second, third)]
        req = urllib.request.Request(second["nextUri"], method="DELETE")
        urllib.request.urlopen(req, timeout=30).close()
        states.append(_get(f"{s.uri}/v1/query/{second['id']}")["state"])
        while "nextUri" in first:
            first = _get(first["nextUri"])
        states.append(_get(f"{s.uri}/v1/query/{first['id']}")["state"])
        states.append(third.get("error", {}).get("message", ""))
        return states
    finally:
        s.close()


def test_queueing_resource_groups_and_cancel():
    exp = _queue_states(JServer)
    got = _queue_states(WorkerServer, device="cpu")
    assert got[:5] == exp[:5] == ["RUNNING", "QUEUED", "FAILED", "CANCELED",
                                  "FINISHED"]
    assert "Too many queued queries" in got[5] and got[5] == exp[5]


def test_dbapi_cursor_with_qmark_parameters(servers):
    """Client-side '?' binding gives equal rows on both servers, and so
    does the default server-side binding (PREPARE, then EXECUTE ...
    USING)."""
    from presto_tpu import dbapi as jdbapi
    from presto_tpu_torch import dbapi
    ref, port = servers
    sql = ("select l_returnflag, count(*) from lineitem "
           "where l_quantity < ? and l_discount > ? "
           "group by l_returnflag order by l_returnflag")
    out = []
    for mod, uri in ((dbapi, port.uri), (jdbapi, ref.uri)):
        cur = mod.connect(uri, schema="sf0.01",
                          server_side_binding=False).cursor()
        cur.execute(sql, (7, 0.02))
        out.append((cur.fetchall(), [d[0] for d in cur.description]))
    assert out[0] == out[1] and len(out[0][0]) == 3
    for mod, uri in ((dbapi, port.uri), (jdbapi, ref.uri)):
        cur = mod.connect(uri, schema="sf0.01").cursor()
        cur.execute(sql, (7, 0.02))
        assert (cur.fetchall(), [d[0] for d in cur.description]) == out[0]


def _write_etc(tmp_path, events_path):
    etc = tmp_path / "etc"
    (etc / "catalog").mkdir(parents=True)
    (etc / "config.properties").write_text(
        "coordinator=true\nhttp-server.http.port=0\n"
        "scan.kernel=auto\nscan.kernel-dma=double\n")
    (etc / "node.properties").write_text("node.id=node-cfg-1\n")
    (etc / "catalog" / "tpch.properties").write_text("connector.name=tpch\n")
    (etc / "event-listener.properties").write_text(
        f"event-listener.name=file\nevent-listener.path={events_path}\n")
    return str(etc)


def test_worker_boots_from_etc_dir(tmp_path):
    events_path = str(tmp_path / "events.jsonl")
    etc = _write_etc(tmp_path, events_path)
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "presto_tpu_torch.worker", "--etc-dir", etc,
         "--device", "cpu"], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT)
    try:
        line = proc.stdout.readline()
        m = re.search(r"(node-cfg-1) listening on (http://[\d.:]+)", line)
        assert m, line
        sql = "select count(*) from lineitem where l_quantity < 10"
        res = StatementClient(m.group(2), user="etc-test",
                              schema="sf0.01").execute(sql)
        from presto_tpu_torch.exec.runner import LocalQueryRunner
        assert res.rows == LocalQueryRunner(device="cpu").execute(sql).rows
        assert res.rows[0][0] > 0
        deadline = time.time() + 30
        while time.time() < deadline:
            if os.path.exists(events_path) and sum(
                    json.loads(x)["event"] == "query_completed"
                    for x in open(events_path)) >= 1:
                break
            time.sleep(0.1)
        events = [json.loads(x) for x in open(events_path)]
        assert any(e["event"] == "query_created" and e["user"] == "etc-test"
                   for e in events)
        assert any(e["event"] == "query_completed"
                   and e["state"] == "FINISHED" for e in events)
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_worker_without_cuda_exits_at_start(tmp_path):
    etc = _write_etc(tmp_path, str(tmp_path / "events.jsonl"))
    code = ("import sys, torch; torch.cuda.is_available = lambda: False; "
            "from presto_tpu_torch.worker.__main__ import main; "
            f"sys.exit(main(['--etc-dir', {etc!r}]))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
    assert "listening on" not in out.stdout
