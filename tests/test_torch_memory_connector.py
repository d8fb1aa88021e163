"""Writes in the port: the memory and blackhole connectors
(presto_tpu_torch/connectors/memory.py), the TableWriter / TableFinish
pipeline (exec/pipeline.py) and CREATE TABLE AS / INSERT / DROP TABLE
(exec/runner.py _execute_ddl) -- a port of tests/test_memory_connector.py
plus the blackhole sink and DROP, each statement run through both
packages' LocalQueryRunner at sf0.01 and the rows held equal exactly;
and the system runtime tables through the port's server."""
import pytest

from presto_tpu.connectors import catalog as jcatalog
from presto_tpu.connectors.memory import BlackholeConnector as JBlackhole
from presto_tpu.connectors.memory import MemoryConnector as JMemory
from presto_tpu.exec.pipeline import ExecutionConfig as JConfig
from presto_tpu.exec.runner import LocalQueryRunner as JRunner
from presto_tpu_torch.connectors import catalog
from presto_tpu_torch.connectors.memory import (BlackholeConnector,
                                                MemoryConnector)
from presto_tpu_torch.exec.pipeline import ExecutionConfig
from presto_tpu_torch.exec.runner import LocalQueryRunner
from torch_threads import one_torch_thread  # noqa: F401

CFG = dict(batch_rows=1 << 13, join_out_capacity=1 << 15)


@pytest.fixture()
def runners():
    """(port, reference): each package's runner over its own memory and
    blackhole catalogs."""
    catalog.register_connector("memory", MemoryConnector())
    catalog.register_connector("blackhole", BlackholeConnector())
    jcatalog.register_connector("memory", JMemory())
    jcatalog.register_connector("blackhole", JBlackhole())
    try:
        yield (LocalQueryRunner("sf0.01", config=ExecutionConfig(**CFG),
                                device="cpu"),
               JRunner("sf0.01", config=JConfig(**CFG)))
    finally:
        for reg in (catalog, jcatalog):
            reg.unregister_connector("memory")
            reg.unregister_connector("blackhole")


def _both(runners, sql):
    port, ref = runners
    got, want = port.execute(sql), ref.execute(sql)
    assert got.column_names == want.column_names
    assert sorted(got.rows) == sorted(want.rows), sql
    return got.rows


def test_memory_ctas_round_trip(runners):
    assert _both(runners, "CREATE TABLE mem_orders AS "
                 "SELECT orderkey, totalprice, orderpriority, orderdate "
                 "FROM orders WHERE orderkey < 200") == [[199]]
    got = _both(runners, "SELECT count(*), sum(totalprice) FROM mem_orders")
    want = _both(runners, "SELECT count(*), sum(totalprice) FROM orders "
                 "WHERE orderkey < 200")
    assert got == want
    # joins against the generated tables
    j = _both(runners, "SELECT count(*) FROM mem_orders m JOIN orders o "
              "ON m.orderkey = o.orderkey")
    assert j[0][0] == want[0][0]
    _both(runners, "SELECT orderpriority, count(*), min(orderdate), "
          "max(totalprice) FROM mem_orders GROUP BY orderpriority")


def test_memory_insert_appends(runners):
    _both(runners, "CREATE TABLE mem_t AS "
          "SELECT orderkey FROM orders WHERE orderkey < 100")
    before = _both(runners, "SELECT count(*) FROM mem_t")[0][0]
    assert _both(runners, "INSERT INTO mem_t SELECT orderkey FROM orders "
                 "WHERE orderkey < 100") == [[before]]
    after = _both(runners, "SELECT count(*) FROM mem_t")[0][0]
    assert after == 2 * before > 0


@pytest.mark.parametrize("if_exists", [False, True])
def test_memory_drop_table(runners, if_exists):
    _both(runners, "CREATE TABLE mem_d AS SELECT 1 AS x")
    clause = "IF EXISTS " if if_exists else ""
    assert _both(runners, f"DROP TABLE {clause}mem_d") == [[0]]
    for r in runners:
        with pytest.raises(Exception, match="mem_d"):
            r.execute("SELECT count(*) FROM mem_d")
        if if_exists:
            assert r.execute("DROP TABLE IF EXISTS mem_d").rows == [[0]]
        else:
            with pytest.raises(KeyError, match="non-droppable"):
                r.execute("DROP TABLE mem_d")


def test_memory_ctas_if_not_exists_and_empty_result(runners):
    assert _both(runners, "CREATE TABLE mem_e AS SELECT orderkey, "
                 "totalprice FROM orders WHERE orderkey < 0") == [[0]]
    assert _both(runners, "SELECT count(*), sum(totalprice) "
                 "FROM mem_e") == [[0, None]]
    assert _both(runners, "CREATE TABLE IF NOT EXISTS mem_e AS "
                 "SELECT 1 AS orderkey") == [[0]]


def test_memory_nulls_and_strings(runners):
    _both(runners, "CREATE TABLE mem_c AS "
          "SELECT clerk, CASE WHEN orderkey % 3 = 0 THEN NULL "
          "ELSE totalprice END AS tp, orderstatus = 'F' AS done "
          "FROM orders WHERE orderkey < 300")
    got = _both(runners, "SELECT count(*), count(tp), "
                "count(DISTINCT clerk) FROM mem_c")
    want = _both(runners, "SELECT count(*), count(CASE WHEN orderkey % 3 "
                 "= 0 THEN NULL ELSE totalprice END), count(DISTINCT "
                 "clerk) FROM orders WHERE orderkey < 300")
    assert got == want
    _both(runners, "SELECT done, count(*), sum(tp) FROM mem_c "
          "GROUP BY done")
    _both(runners, "SELECT clerk, tp FROM mem_c WHERE tp IS NULL "
          "ORDER BY clerk LIMIT 5")


def test_blackhole_swallows_writes():
    """With the blackhole the only writable catalog, a CTAS lands in the
    sink (the planner writes into the first writable connector): the row
    count comes back and no table appears."""
    catalog.register_connector("blackhole", BlackholeConnector())
    jcatalog.register_connector("blackhole", JBlackhole())
    try:
        port = LocalQueryRunner("sf0.01", config=ExecutionConfig(**CFG),
                                device="cpu")
        ref = JRunner("sf0.01", config=JConfig(**CFG))
        assert _both((port, ref), "CREATE TABLE sink AS SELECT orderkey, "
                     "totalprice FROM orders") == [[15000]]
        for r, reg in zip((port, ref), (catalog, jcatalog)):
            assert reg.module("blackhole")._staged == {}
            with pytest.raises(Exception, match="sink"):
                r.execute("SELECT count(*) FROM sink")
    finally:
        catalog.unregister_connector("blackhole")
        jcatalog.unregister_connector("blackhole")


def test_failed_write_stages_nothing(runners, monkeypatch):
    """A write that fails mid-stream aborts its staged part: the table
    never appears, in either package."""
    from presto_tpu.connectors import memory as jmemory
    from presto_tpu_torch.connectors import memory as tmemory

    def fail(self, page):
        raise RuntimeError("disk full")
    for mod in (tmemory, jmemory):
        monkeypatch.setattr(mod._WriteHandle, "write_page", fail)
    for r, reg in zip(runners, (catalog, jcatalog)):
        with pytest.raises(RuntimeError, match="disk full"):
            r.execute("CREATE TABLE mem_w AS SELECT orderkey FROM orders")
        conn = reg.module("memory")
        assert conn._staged == {} and "mem_w" not in conn.SCHEMAS


def test_system_runtime_tables():
    from presto_tpu_torch.client import StatementClient
    from presto_tpu_torch.worker.server import WorkerServer
    s = WorkerServer(coordinator=True, device="cpu")
    try:
        c = StatementClient(s.uri, schema="sf0.01")
        c.execute("SELECT 1")
        r = c.execute("SELECT node_id, coordinator, state "
                      "FROM runtime_nodes")
        assert any(row[0] == s.node_id and row[1] for row in r.rows)
        r = c.execute("SELECT query_id, state FROM runtime_queries")
        assert len(r.rows) >= 1
        assert all(row[1] in ("QUEUED", "RUNNING", "FINISHED", "FAILED",
                              "CANCELED") for row in r.rows)
    finally:
        s.close()


def test_memory_catalog_mounts_from_etc(tmp_path):
    """An etc directory's memory and blackhole catalogs mount, as the
    reference mounts them."""
    from presto_tpu.worker import properties as jprops
    from presto_tpu_torch.worker import properties as tprops
    cat = tmp_path / "etc" / "catalog"
    cat.mkdir(parents=True)
    (cat / "mem2.properties").write_text("connector.name=memory\n")
    (cat / "bh2.properties").write_text("connector.name=blackhole\n")
    try:
        assert tprops.register_catalogs_from_etc(str(tmp_path / "etc")) \
            == jprops.register_catalogs_from_etc(str(tmp_path / "etc")) \
            == {"bh2": "blackhole", "mem2": "memory"}
        assert isinstance(catalog.module("mem2"), MemoryConnector)
        assert isinstance(catalog.module("bh2"), BlackholeConnector)
    finally:
        for reg in (catalog, jcatalog):
            reg.unregister_connector("mem2")
            reg.unregister_connector("bh2")
