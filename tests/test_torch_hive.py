"""The port's hive connector (presto_tpu_torch/connectors/hive.py) on the
CPU: the 15 cases of tests/test_hive.py through the port's runner (CTAS /
INSERT / DROP, scans against the port's numpy oracle, nulls, commit
semantics, external Parquet and ORC files), the two hive cases of
tests/test_stats.py, and warehouses written by one package and read by
the other (the same presto_type field metadata): the port's rows equal
the JAX package's over the same files."""
import os
from decimal import Decimal

import pytest

from presto_tpu_torch.connectors import catalog, hive
from presto_tpu_torch.exec.pipeline import ExecutionConfig
from presto_tpu_torch.exec.runner import LocalQueryRunner
from torch_rows import assert_rows_close
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture
def runner(tmp_path):
    conn = hive.HiveConnector(str(tmp_path / "warehouse"))
    catalog.register_connector("hive", conn)
    try:
        yield LocalQueryRunner("sf0.01", device="cpu",
                               config=ExecutionConfig(batch_rows=1 << 13))
    finally:
        catalog.unregister_connector("hive")


def test_ctas_and_scan_parity(runner):
    r = runner.execute("""
        CREATE TABLE hv_lineitem AS
        SELECT orderkey, quantity, extendedprice, discount, shipdate,
               returnflag
        FROM lineitem WHERE orderkey < 500""")
    written = r.rows[0][0]
    assert written > 0
    got = runner.execute("SELECT count(*) c FROM hv_lineitem")
    assert got.rows[0][0] == written
    runner.assert_same_as_reference("""
        SELECT returnflag, sum(quantity) sq, sum(extendedprice*discount) rev,
               count(*) c
        FROM hv_lineitem
        WHERE shipdate >= DATE '1994-01-01'
        GROUP BY returnflag ORDER BY returnflag""", ordered=True)
    a = runner.execute("""
        SELECT orderkey, quantity, extendedprice FROM hv_lineitem
        ORDER BY orderkey, quantity, extendedprice""")
    b = runner.execute("""
        SELECT orderkey, quantity, extendedprice FROM lineitem
        WHERE orderkey < 500
        ORDER BY orderkey, quantity, extendedprice""")
    assert a.rows == b.rows


def test_strings_round_trip(runner):
    runner.execute("""
        CREATE TABLE hv_cust AS
        SELECT custkey, mktsegment, nationkey FROM customer
        WHERE custkey <= 200""")
    a = runner.execute(
        "SELECT mktsegment, count(*) c FROM hv_cust GROUP BY mktsegment")
    b = runner.execute(
        "SELECT mktsegment, count(*) c FROM customer WHERE custkey <= 200 "
        "GROUP BY mktsegment")
    assert a.sorted_rows() == b.sorted_rows()
    a = runner.execute("SELECT count(*) c FROM hv_cust "
                       "WHERE mktsegment = 'BUILDING'")
    b = runner.execute("SELECT count(*) c FROM customer WHERE custkey <= 200 "
                       "AND mktsegment = 'BUILDING'")
    assert a.rows == b.rows


def test_nulls_round_trip(runner):
    runner.execute("""
        CREATE TABLE hv_nulls AS
        SELECT orderkey,
               CASE WHEN quantity < 2500 THEN NULL ELSE quantity END q
        FROM lineitem WHERE orderkey < 200""")
    runner.assert_same_as_reference(
        "SELECT count(*) c, count(q) cq, sum(q) sq FROM hv_nulls")
    got = runner.execute("SELECT count(*) n FROM hv_nulls WHERE q IS NULL")
    assert got.rows[0][0] > 0


def test_insert_appends(runner):
    runner.execute("CREATE TABLE hv_t AS SELECT orderkey FROM orders "
                   "WHERE orderkey < 100")
    before = runner.execute("SELECT count(*) c FROM hv_t").rows[0][0]
    r = runner.execute("INSERT INTO hv_t SELECT orderkey FROM orders "
                       "WHERE orderkey >= 100 AND orderkey < 200")
    after = runner.execute("SELECT count(*) c FROM hv_t").rows[0][0]
    assert after == before + r.rows[0][0]


def test_insert_uses_target_schema_names(runner):
    runner.execute("CREATE TABLE hv_pos AS SELECT orderkey, totalprice "
                   "FROM orders WHERE orderkey < 50")
    runner.execute("INSERT INTO hv_pos SELECT orderkey + 1000000 AS weird, "
                   "totalprice AS other FROM orders WHERE orderkey < 10")
    got = runner.execute("SELECT count(orderkey) c FROM hv_pos")
    all_rows = runner.execute("SELECT count(*) c FROM hv_pos")
    assert got.rows[0][0] == all_rows.rows[0][0]
    with pytest.raises(ValueError):
        runner.execute("INSERT INTO hv_pos SELECT orderkey FROM orders "
                       "WHERE orderkey < 5")
    with pytest.raises(ValueError):
        runner.execute("INSERT INTO hv_pos SELECT orderkey, orderkey "
                       "FROM orders WHERE orderkey < 5")


def test_if_not_exists_ignores_readonly_catalogs(runner):
    r = runner.execute("CREATE TABLE IF NOT EXISTS nation AS "
                       "SELECT orderkey FROM orders WHERE orderkey < 20")
    assert r.rows[0][0] > 0
    runner.execute("DROP TABLE nation")


def test_drop_invalidates_plan_cache(runner):
    runner.execute("CREATE TABLE hv_gone AS SELECT orderkey FROM orders "
                   "WHERE orderkey < 30")
    runner.execute("SELECT count(*) c FROM hv_gone")
    runner.execute("DROP TABLE hv_gone")
    with pytest.raises(Exception) as ei:
        runner.execute("SELECT count(*) c FROM hv_gone")
    assert "hv_gone" in str(ei.value)


def test_joins_over_hive(runner):
    runner.execute("CREATE TABLE hv_orders AS SELECT orderkey, custkey, "
                   "totalprice FROM orders WHERE orderkey < 1000")
    runner.assert_same_as_reference("""
        SELECT c.mktsegment, count(*) c, sum(o.totalprice) tp
        FROM hv_orders o JOIN customer c ON o.custkey = c.custkey
        GROUP BY c.mktsegment""")


def test_empty_ctas_defines_schema(runner):
    r = runner.execute("CREATE TABLE hv_empty AS SELECT orderkey, totalprice "
                       "FROM orders WHERE orderkey < 0")
    assert r.rows[0][0] == 0
    got = runner.execute("SELECT count(*) c, sum(totalprice) s FROM hv_empty")
    assert got.rows[0][0] == 0
    runner.execute("DROP TABLE hv_empty")


def test_create_if_not_exists_and_drop(runner):
    runner.execute("CREATE TABLE hv_x AS SELECT orderkey FROM orders "
                   "WHERE orderkey < 50")
    with pytest.raises(ValueError):
        runner.execute("CREATE TABLE hv_x AS SELECT orderkey FROM orders "
                       "WHERE orderkey < 50")
    r = runner.execute("CREATE TABLE IF NOT EXISTS hv_x AS "
                       "SELECT orderkey FROM orders WHERE orderkey < 50")
    assert r.rows[0][0] == 0
    runner.execute("DROP TABLE hv_x")
    with pytest.raises(Exception):
        runner.execute("SELECT count(*) c FROM hv_x")
    runner.execute("DROP TABLE IF EXISTS hv_x")


def _external_table():
    import pyarrow as pa
    return pa.table({
        "k": pa.array([1, 2, 3], type=pa.int64()),
        "price": pa.array([Decimal("1.50"), Decimal("2.25"), None],
                          type=pa.decimal128(10, 2)),
        "name": pa.array(["a", "b", "a"], type=pa.string()),
    })


def test_external_parquet_without_metadata(runner, tmp_path):
    import pyarrow.parquet as pq
    tdir = tmp_path / "warehouse" / "ext"
    os.makedirs(tdir)
    pq.write_table(_external_table(), tdir / "part-0.parquet")
    catalog.module("hive").refresh()
    runner.assert_same_as_reference(
        "SELECT name, count(*) c, sum(price) p FROM ext GROUP BY name")
    got = runner.execute("SELECT sum(price) p FROM ext")
    assert str(got.rows[0][0]) == "3.75"


@pytest.fixture
def orc_runner(tmp_path):
    conn = hive.HiveConnector(str(tmp_path / "warehouse"),
                              storage_format="ORC")
    catalog.register_connector("hive", conn)
    try:
        yield LocalQueryRunner("sf0.01", device="cpu",
                               config=ExecutionConfig(batch_rows=1 << 13))
    finally:
        catalog.unregister_connector("hive")


def test_orc_ctas_and_scan_parity(orc_runner):
    orc_runner.execute(
        "CREATE TABLE lineitem_orc AS SELECT l_orderkey, l_quantity, "
        "l_extendedprice, l_shipdate, l_returnflag FROM lineitem "
        "WHERE l_orderkey < 2000")
    conn = catalog.module("hive")
    tdir = os.path.join(conn.warehouse, "lineitem_orc")
    assert all(f.endswith(".orc") for f in os.listdir(tdir))
    orc_runner.assert_same_as_reference(
        "SELECT l_returnflag, count(*), sum(l_quantity), "
        "sum(l_extendedprice) FROM lineitem_orc GROUP BY l_returnflag")
    a = orc_runner.execute("SELECT sum(l_extendedprice) FROM lineitem_orc")
    b = orc_runner.execute("SELECT sum(l_extendedprice) FROM lineitem "
                           "WHERE l_orderkey < 2000")
    assert a.rows == b.rows


def test_orc_dates_and_filters(orc_runner):
    orc_runner.execute(
        "CREATE TABLE orders_orc AS SELECT o_orderkey, o_orderdate, "
        "o_totalprice FROM orders WHERE o_orderkey < 4000")
    orc_runner.assert_same_as_reference(
        "SELECT count(*) FROM orders_orc "
        "WHERE o_orderdate < date '1995-01-01'")


def test_external_orc_file(orc_runner, tmp_path):
    from pyarrow import orc as pa_orc
    tdir = tmp_path / "warehouse" / "extorc"
    os.makedirs(tdir)
    pa_orc.write_table(_external_table(), str(tdir / "part-0.orc"))
    catalog.module("hive").refresh()
    orc_runner.assert_same_as_reference(
        "SELECT name, count(*) c, sum(price) p FROM extorc GROUP BY name")
    got = orc_runner.execute("SELECT sum(price) FROM extorc")
    assert str(got.rows[0][0]) == "3.75"


def test_orc_insert_appends(orc_runner):
    orc_runner.execute("CREATE TABLE t_orc AS SELECT n_nationkey, n_name "
                       "FROM nation WHERE n_nationkey < 5")
    orc_runner.execute("INSERT INTO t_orc SELECT n_nationkey, n_name "
                       "FROM nation WHERE n_nationkey >= 20")
    got = orc_runner.execute("SELECT count(*) FROM t_orc")
    assert got.rows == [[10]]


# -- tests/test_stats.py's hive cases ----------------------------------------

def test_hive_external_decimal_stats_logical(tmp_path):
    import pyarrow as pa
    import pyarrow.parquet as pq
    os.makedirs(tmp_path / "ext2")
    pq.write_table(pa.table({
        "price": pa.array([Decimal("100.00"), Decimal("250.50")],
                          type=pa.decimal128(10, 2))}),
        tmp_path / "ext2" / "part-0.parquet")
    conn = hive.HiveConnector(str(tmp_path))
    cs = conn.column_stats("ext2", "price", 0.01)
    assert cs.low == 100.0 and cs.high == 250.5


def test_hive_parquet_stats(tmp_path):
    from presto_tpu_torch.sql.planner import Planner
    from presto_tpu_torch.sql.stats import StatsCalculator
    conn = hive.HiveConnector(str(tmp_path))
    catalog.register_connector("hive", conn)
    try:
        r = LocalQueryRunner("sf0.01", device="cpu", config=ExecutionConfig(
            batch_rows=1 << 13))
        r.execute("CREATE TABLE st AS SELECT orderkey, totalprice "
                  "FROM orders WHERE orderkey <= 1000")
        cs = conn.column_stats("st", "orderkey", 0.01)
        assert cs.low == 1 and cs.high == 1000
        tp = conn.column_stats("st", "totalprice", 0.01)
        assert tp.low is not None and tp.high <= 500000.01
        out = Planner("sf0.01").plan(
            "SELECT orderkey FROM st WHERE orderkey <= 100")
        assert StatsCalculator().rows(out) == pytest.approx(100, rel=0.2)
    finally:
        catalog.unregister_connector("hive")


# -- warehouses written by one package, read by the other --------------------

_CTAS = ("CREATE TABLE x_{t} AS SELECT orderkey, custkey, orderstatus, "
         "totalprice, orderdate, orderpriority, shippriority FROM orders "
         "WHERE orderkey < 3000 AND (orderkey % 7 <> 3 OR custkey < 100)")
_NULLS = ("CREATE TABLE x_{t}_nulls AS SELECT orderkey, CASE WHEN quantity "
          "< 2000 THEN NULL ELSE quantity END q, CASE WHEN linenumber = 1 "
          "THEN NULL ELSE shipmode END m FROM lineitem WHERE orderkey < 300")
_READS = [
    "SELECT orderstatus, orderpriority, count(*) c, sum(totalprice) s, "
    "min(orderdate) d FROM x_{t} GROUP BY orderstatus, orderpriority",
    "SELECT m, count(*), count(q), sum(q) FROM x_{t}_nulls GROUP BY m",
    "SELECT o.orderkey, o.totalprice, c.name FROM x_{t} o JOIN customer c "
    "ON o.custkey = c.custkey WHERE o.orderkey < 200 ORDER BY o.orderkey",
]


@pytest.mark.parametrize("fmt", ["PARQUET", "ORC"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_warehouse_interchange(tmp_path, writer, fmt):
    """One package writes the warehouse, both read it: equal rows."""
    from presto_tpu.connectors import catalog as jcatalog
    from presto_tpu.connectors import hive as jhive
    from presto_tpu.exec.pipeline import ExecutionConfig as JConfig
    from presto_tpu.exec.runner import LocalQueryRunner as JRunner
    wh = str(tmp_path / "wh")
    catalog.register_connector("hive", hive.HiveConnector(wh, fmt))
    jcatalog.register_connector("hive", jhive.HiveConnector(wh, fmt))
    try:
        port = LocalQueryRunner("sf0.01", device="cpu",
                                config=ExecutionConfig(batch_rows=1 << 13))
        ref = JRunner("sf0.01", config=JConfig(batch_rows=1 << 13))
        w = port if writer == "port" else ref
        for sql in (_CTAS, _NULLS):
            w.execute(sql.format(t=writer))
        catalog.module("hive").refresh()
        jcatalog.module("hive").refresh()
        def schemas(conn):
            return {t: [(n, str(ty)) for n, ty in cols]
                    for t, cols in conn.SCHEMAS.items()}
        assert schemas(catalog.module("hive")) == \
            schemas(jcatalog.module("hive"))
        for sql in _READS:
            sql = sql.format(t=writer)
            assert_rows_close(port.execute(sql), ref.execute(sql),
                              ordered="ORDER BY" in sql, rtol=0.0)
    finally:
        catalog.unregister_connector("hive")
        jcatalog.unregister_connector("hive")


def test_worker_cli_mounts_a_hive_warehouse(tmp_path):
    """`python -m presto_tpu_torch.worker --hive-warehouse DIR` mounts the
    warehouse as the 'hive' catalog: a table the JAX package wrote there
    answers through the port's statement server."""
    import re
    import subprocess
    import sys
    from presto_tpu.connectors import catalog as jcatalog
    from presto_tpu.connectors import hive as jhive
    from presto_tpu.exec.runner import LocalQueryRunner as JRunner
    from presto_tpu_torch.client import StatementClient
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    wh = str(tmp_path / "wh")
    jcatalog.register_connector("hive", jhive.HiveConnector(wh))
    try:
        want = JRunner("sf0.01").execute(
            "CREATE TABLE cli_t AS SELECT orderkey, totalprice FROM orders "
            "WHERE orderkey < 500").rows[0][0]
    finally:
        jcatalog.unregister_connector("hive")
    proc = subprocess.Popen(
        [sys.executable, "-m", "presto_tpu_torch.worker", "--coordinator",
         "--http-port", "0", "--hive-warehouse", wh, "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, PYTHONPATH=root), cwd=root)
    try:
        line = proc.stdout.readline()
        m = re.search(r"listening on (http://[\d.:]+)", line)
        assert m, line
        res = StatementClient(m.group(1), catalog="hive",
                              schema="sf0.01").execute(
            "select count(*), sum(totalprice) from cli_t")
        assert res.rows[0][0] == want > 0
    finally:
        proc.terminate()
        proc.wait(timeout=30)
