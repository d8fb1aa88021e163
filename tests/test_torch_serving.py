"""Prepared statements and the serving plane's DDL invalidation in the port
(presto_tpu_torch/serving/prepared.py, exec/runner.py _execute_prepared
and _invalidate_plans, worker/server.py), held to the JAX package on the
CPU at sf0.01 -- a port of tests/test_serving.py's prepared, DDL,
DB-API and status / metrics tests:

  * PREPARE / EXECUTE / DEALLOCATE through both packages'
    LocalQueryRunner: the same rows exactly, and the fast path, replan
    and executable-build counters move as the reference's test asserts;
    a NULL binding replans, a wrong arity raises, a deallocated name is
    unknown, the client's header map serves a runner that never saw the
    PREPARE;
  * each runner keeps its own PlanCache: a fast path recorded by one
    runner replans in another, as the reference does on a miss;
  * a CREATE TABLE AS / DROP TABLE empties the runner's plan cache, the
    fast-path records and the fragment cache;
  * the distributed runner raises on a PREPARE where the reference's
    raises (its planner), and writes through the local pipeline;
  * over HTTP: concurrent EXECUTEs against the reference's rows, the
    DB-API cursor binding on the server by default, /v1/status's
    preparedStatements and /v1/metrics' serving section, metric for
    metric the reference's."""
import threading
import urllib.request

import pytest

from presto_tpu.connectors import catalog as jcatalog
from presto_tpu.connectors.memory import MemoryConnector as JMemory
from presto_tpu.exec.runner import DistributedQueryRunner as JDist
from presto_tpu.exec.runner import LocalQueryRunner as JRunner
from presto_tpu.serving import PlanCache as JPlanCache
from presto_tpu.serving import PREPARED_REGISTRY as JREGISTRY
from presto_tpu_torch.connectors import catalog
from presto_tpu_torch.connectors.memory import MemoryConnector
from presto_tpu_torch.exec.runner import (DistributedQueryRunner,
                                          LocalQueryRunner)
from presto_tpu_torch.serving import (FRAGMENT_JIT_CACHE, PREPARED_REGISTRY,
                                      SERVING_METRICS, PlanCache)
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _reset_serving():
    SERVING_METRICS.reset()
    PREPARED_REGISTRY.clear()
    JREGISTRY.clear()
    yield


def _snapshot():
    return SERVING_METRICS.snapshot()


def _port():
    return LocalQueryRunner("sf0.01", plan_cache=PlanCache(), device="cpu")


@pytest.fixture(scope="module")
def ref():
    return JRunner("sf0.01", plan_cache=JPlanCache())


Q6ISH = ("select sum(l_extendedprice * l_discount) from lineitem "
         "where l_discount between ? - 0.01 and ? + 0.01 "
         "and l_quantity < ?")
GROUPED = ("select l_returnflag, count(*), sum(l_quantity), "
           "min(l_extendedprice) from lineitem where l_quantity < ? "
           "and l_shipdate >= ? group by l_returnflag")


def test_prepare_execute_fast_path_skips_parse_and_plan(ref):
    r = _port()
    res = r.execute(f"prepare q6 from {Q6ISH}")
    assert res.added_prepare == ("q6", Q6ISH)
    assert res.rows == [[True]]
    ref.execute(f"prepare q6 from {Q6ISH}")
    first = "execute q6 using 0.06, 0.06, 24"
    assert r.execute(first).rows == ref.execute(first).rows
    assert _snapshot()["preparedReplans"] == 1    # records the fast path
    builds = _snapshot()["executableBuilds"]
    out = r.execute("execute q6 using 0.05, 0.05, 30")
    s = _snapshot()
    assert s["preparedFastPath"] == 1
    assert s["preparedReplans"] == 1
    assert s["executableBuilds"] == builds           # no rebuild
    want = ref.execute(
        "select sum(l_extendedprice * l_discount) from lineitem "
        "where l_discount between 0.04 and 0.06 and l_quantity < 30")
    assert out.rows == want.rows
    assert PREPARED_REGISTRY.info() == {"statements": 1, "fastPaths": 1}


@pytest.mark.parametrize("values", [
    "10, date '1994-01-01'", "24, date '1995-06-17'",
    "50, date '1992-01-01'", "1, date '1998-12-01'"],
    ids=["q10", "q24", "q50", "q1"])
def test_prepared_bindings_equal_the_reference(ref, values):
    """Each binding through the fast path (after one replan that records
    it) gives the reference's rows exactly."""
    r = _port()
    for runner in (r, ref):
        runner.execute(f"prepare g from {GROUPED}")
    r.execute("execute g using 7, date '1993-01-01'")
    sql = f"execute g using {values}"
    got = r.execute(sql)
    assert _snapshot()["preparedFastPath"] == 1
    assert sorted(got.rows) == sorted(ref.execute(sql).rows)
    assert got.column_names == ref.execute(sql).column_names


def test_execute_streaming_runs_prepared_statements(ref):
    r = _port()
    assert r.execute_streaming(f"prepare q6 from {Q6ISH}") is None
    r.execute(f"prepare q6 from {Q6ISH}")
    ref.execute(f"prepare q6 from {Q6ISH}")
    sql = "execute q6 using 0.06, 0.06, 24"
    columns, rows, _stats = r.execute_streaming(sql)
    assert list(rows) == ref.execute(sql).rows
    assert len(columns) == 1
    assert r.execute_streaming("deallocate prepare q6") is None


def test_execute_null_parameter_replans(ref):
    r = _port()
    for runner in (r, ref):
        runner.execute("prepare pn from select count(*) from lineitem "
                       "where l_quantity < ?")
    assert r.execute("execute pn using 24").rows == \
        ref.execute("execute pn using 24").rows
    # NULL cannot ride the fast path (BindError): a full replan, which
    # folds `x < NULL`
    out = r.execute("execute pn using null")
    assert _snapshot()["preparedReplans"] == 2
    assert out.rows == ref.execute("execute pn using null").rows == [[0]]


def test_execute_wrong_arity_raises(ref):
    r = _port()
    for runner in (r, ref):
        runner.execute("prepare pa from select count(*) from region "
                       "where r_regionkey < ?")
        with pytest.raises(ValueError, match="expects 1 parameters"):
            runner.execute("execute pa using 1, 2")


def test_deallocate_removes_statement(ref):
    r = _port()
    for runner in (r, ref):
        runner.execute("prepare pd from select count(*) from region")
        res = runner.execute("deallocate prepare pd")
        assert res.deallocated_prepare == "pd"
        with pytest.raises(KeyError, match="'pd' does not exist"):
            runner.execute("execute pd")


def test_prepared_header_map_is_stateless(ref):
    # the statement text arrives in the header map of each request: a
    # runner that never saw the PREPARE serves it
    header = {"h1": "select count(*) from region where r_regionkey < ?"}
    out = _port().execute("execute h1 using 3", prepared=header)
    assert out.rows == ref.execute("execute h1 using 3",
                                   prepared=header).rows == [[3]]


def test_fast_path_misses_in_another_runners_cache():
    """The registry is process-global, each runner's PlanCache its own:
    the fast path recorded by runner a misses in b's cache and replans
    (the reference's miss path), then b takes the fast path too."""
    a, b = _port(), _port()
    a.execute(f"prepare q6 from {Q6ISH}")
    a.execute("execute q6 using 0.06, 0.06, 24")
    want = a.execute("execute q6 using 0.05, 0.05, 30").rows
    SERVING_METRICS.reset()
    header = {"q6": Q6ISH}
    assert b.execute("execute q6 using 0.05, 0.05, 30",
                     prepared=header).rows == want
    assert _snapshot()["preparedReplans"] == 1
    assert _snapshot()["preparedFastPath"] == 0
    assert b.execute("execute q6 using 0.05, 0.05, 30",
                     prepared=header).rows == want
    assert _snapshot()["preparedFastPath"] == 1


@pytest.fixture()
def memory_catalogs():
    catalog.register_connector("memory", MemoryConnector())
    jcatalog.register_connector("memory", JMemory())
    try:
        yield
    finally:
        catalog.unregister_connector("memory")
        jcatalog.unregister_connector("memory")


def test_ddl_invalidates_plan_cache(memory_catalogs):
    cache = PlanCache()
    r = LocalQueryRunner("sf0.01", catalog="memory", plan_cache=cache,
                         device="cpu")
    jr = JRunner("sf0.01", catalog="memory", plan_cache=JPlanCache())
    for runner in (r, jr):
        assert runner.execute("create table t1 as select 1 as x").rows \
            == [[1]]
    sql = "select count(*) from t1 where x < 5"
    assert r.execute(sql).rows == jr.execute(sql).rows == [[1]]
    r.execute("select count(*) from lineitem where l_quantity < 24")
    assert cache.info()["entries"] >= 1
    assert FRAGMENT_JIT_CACHE.info()["entries"] > 0
    r.execute("prepare p from select count(*) from t1 where x < ?")
    r.execute("execute p using 3")
    assert PREPARED_REGISTRY.info()["fastPaths"] == 1
    r.execute("drop table t1")
    info = cache.info()
    assert info["entries"] == 0
    assert info["invalidations"] >= 1
    assert PREPARED_REGISTRY.info()["fastPaths"] == 0
    assert FRAGMENT_JIT_CACHE.info()["entries"] == 0
    jr.execute("drop table t1")
    for runner in (r, jr):
        with pytest.raises(Exception, match="t1"):
            runner.execute(sql)


def test_distributed_runner_prepare_and_writes(memory_catalogs):
    """PREPARE through the distributed runner reaches the planner and
    raises there in both packages; a write runs through the local
    pipeline and is read back through the stages."""
    port = DistributedQueryRunner("sf0.01", n_tasks=2, device="cpu")
    jref = JDist("sf0.01", n_tasks=2)
    for runner in (port, jref):
        with pytest.raises(AttributeError, match="ctes"):
            runner.execute("prepare p from select count(*) from nation")
        with pytest.raises(KeyError, match="non-droppable table 't'"):
            runner.execute("drop table t")
        assert runner.execute("drop table if exists t").rows == [[0]]
    got = port.execute("create table dn as select n_nationkey, n_name "
                       "from nation where n_regionkey < 3")
    want = jref.execute("create table dn as select n_nationkey, n_name "
                        "from nation where n_regionkey < 3")
    assert got.rows == want.rows == [[15]]
    sql = "select count(*), sum(n_nationkey) from dn"
    assert port.execute(sql).rows == jref.execute(sql).rows
    port.execute("drop table dn")
    jref.execute("drop table dn")


def test_plan_cache_lru_evicts_and_counts():
    cache = PlanCache(max_entries=2)
    r = LocalQueryRunner("sf0.01", plan_cache=cache, device="cpu")
    r.execute("select count(*) from region")
    r.execute("select count(*) from nation")
    r.execute("select count(*) from supplier")
    info = cache.info()
    assert info["entries"] == 2
    assert info["evictions"] >= 1


# ---------------------------------------------------------------------------
# end to end over HTTP
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def coordinator():
    from presto_tpu_torch.worker.server import WorkerServer
    s = WorkerServer(coordinator=True, device="cpu")
    yield s
    s.close()


def test_http_concurrent_parameterized_serving(coordinator, ref):
    """Threads send repeated parameterized shapes: every result equals
    the reference's and the plan cache absorbs the repeats."""
    from presto_tpu_torch.client import StatementClient
    shapes = [
        ("cq", "select count(*) from lineitem where l_quantity < ?",
         ["10", "20", "30"]),
        ("sq", "select sum(l_extendedprice) from lineitem "
               "where l_orderkey < ?", ["500", "1500", "2500"]),
    ]
    want = {}
    for name, template, values in shapes:
        for v in values:
            want[(name, v)] = ref.execute(template.replace("?", v)).rows
    warm = StatementClient(coordinator.uri, schema="sf0.01")
    warm.prepared = {n: t for n, t, _ in shapes}
    for name, _t, values in shapes:
        warm.execute(f"execute {name} using {values[0]}")
    SERVING_METRICS.reset()
    errors = []

    def worker(tid):
        c = StatementClient(coordinator.uri, schema="sf0.01",
                            source=f"t{tid}")
        c.prepared = {n: t for n, t, _ in shapes}
        for i in range(4):
            name, _t, values = shapes[(tid + i) % len(shapes)]
            v = values[(tid * 7 + i) % len(values)]
            got = c.execute(f"execute {name} using {v}").rows
            if [list(r) for r in got] != [list(r) for r in want[(name, v)]]:
                errors.append((name, v, got, want[(name, v)]))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors[:3]
    s = _snapshot()
    assert SERVING_METRICS.hit_rate() > 0.0
    assert s["planCacheHits"] > 0 and s["preparedFastPath"] > 0


def test_dbapi_server_side_binding_hits_cache(coordinator):
    import presto_tpu_torch.dbapi as dbapi
    cur = dbapi.connect(coordinator.uri, schema="sf0.01").cursor()
    cur.execute("select count(*) from region where r_regionkey < ?", (3,))
    assert cur.fetchall() == [(3,)]
    SERVING_METRICS.reset()
    cur.execute("select count(*) from region where r_regionkey < ?", (4,))
    assert cur.fetchall() == [(4,)]
    assert _snapshot()["preparedFastPath"] >= 1   # bound server-side
    # the explicit fallback: textual substitution still works
    cur2 = dbapi.connect(coordinator.uri, schema="sf0.01",
                         server_side_binding=False).cursor()
    cur2.execute("select count(*) from region where r_regionkey < ?", (2,))
    assert cur2.fetchall() == [(2,)]


def test_status_and_metrics_expose_serving_section(coordinator):
    import json
    from presto_tpu.worker.server import WorkerServer as JServer
    from presto_tpu_torch.client import StatementClient
    c = StatementClient(coordinator.uri, schema="sf0.01")
    c.execute("prepare st from select count(*) from region "
              "where r_regionkey < ?")
    c.execute("execute st using 2")
    status = json.loads(
        urllib.request.urlopen(coordinator.uri + "/v1/status").read())
    sv = status["serving"]
    assert {"planCache", "preparedStatements", "metrics",
            "resourceGroups"} <= set(sv)
    assert sv["preparedStatements"]["statements"] >= 1
    assert sv["preparedStatements"]["fastPaths"] >= 1
    assert "global" in sv["resourceGroups"]

    def types(uri):
        text = urllib.request.urlopen(uri + "/v1/metrics").read().decode()
        return text, sorted(line for line in text.splitlines()
                            if line.startswith("# TYPE presto_tpu_serving_"))
    text, got = types(coordinator.uri)
    jsrv = JServer(coordinator=True)
    try:
        assert got == types(jsrv.uri)[1]
    finally:
        jsrv.close()
    assert "presto_tpu_serving_prepared_fast_path_total " \
        f"{_snapshot()['preparedFastPath']}" in text
    assert 'presto_tpu_serving_group_running{group="global"' in text
