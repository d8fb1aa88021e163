"""TPC-DS through the port on the CPU against the JAX package: the cases of
tests/test_tpcds.py (BASELINE config 5 is TPC-DS Q95).

Since the TPC-DS device generators were ported, the store_sales,
web_sales and web_returns scans are all device-generated: fused-chain
leaves and resident columns, as in the reference.  Each query runs
through the port's LocalQueryRunner under scan_kernel "auto" (the
kernels' plain versions where a chain reaches them) and "xla" (the torch
fused chain), held to the reference's LocalQueryRunner rows (one JAX
runner and one run per query for the module): ordered queries in order,
floats within rtol 1e-12.  The Q95 cores under forced lifespans are held
to the same rows; the golden file's entries for these queries equal the
live reference rows."""
import numpy as np
import pytest

from presto_tpu_torch.benchmarks import tpcds_queries as T
from presto_tpu_torch.connectors import catalog, tpcds
from presto_tpu_torch.exec import grouped as G
from presto_tpu_torch.exec.pipeline import tuned_config
from presto_tpu_torch.exec.runner import (DistributedQueryRunner,
                                          LocalQueryRunner)
from torch_rows import assert_rows_close
import torch_tpcds_golden as golden
from torch_threads import one_torch_thread  # noqa: F401

SCHEMA = golden.SCHEMA
SHAPES = sorted(T.SHAPES)
CALENDAR = """
    select d_year, d_qoy, count(*) from date_dim
    where d_year between 1999 and 2000 group by d_year, d_qoy"""


@pytest.fixture(scope="module")
def expected():
    """The reference's rows, one JAX runner (its default config, as
    tests/test_tpcds.py runs) and one run per query."""
    from presto_tpu.exec.runner import LocalQueryRunner as JRunner
    runner = JRunner(SCHEMA, catalog="tpcds")
    cache = {}

    def get(sql):
        if sql not in cache:
            cache[sql] = runner.execute(sql)
        return cache[sql]
    return get


@pytest.fixture(scope="module")
def ports():
    return {mode: LocalQueryRunner(SCHEMA, catalog="tpcds", device="cpu",
                                   config=tuned_config(scan_kernel=mode))
            for mode in ("auto", "xla")}


def _spy_runs(monkeypatch):
    calls = []
    orig = G.GroupedRunner.run

    def spy(self):
        calls.append(self)
        return orig(self)
    monkeypatch.setattr(G.GroupedRunner, "run", spy)
    return calls


# -- connector / catalog basics ---------------------------------------------

def test_catalog_resolution_prefers_session_catalog(ports):
    res = ports["auto"].execute("select count(*) from customer")
    assert res.rows[0][0] == tpcds.table_row_count("customer", 0.01)
    assert catalog.resolve_table("customer", "tpcds") == "tpcds"
    assert catalog.resolve_table("lineitem", "tpcds") == "tpch"


def test_cross_catalog_table_visible(ports):
    assert ports["auto"].execute("select count(*) from region").rows \
        == [[5]]


@pytest.mark.parametrize("mode", ["auto", "xla"])
def test_date_dim_calendar_consistency(expected, ports, mode):
    assert_rows_close(ports[mode].execute(CALENDAR), expected(CALENDAR),
                      ordered=False)
    res = ports[mode].execute(
        "select d_date, d_year, d_moy, d_dom, d_day_name from date_dim "
        "where d_date = date '2000-02-29'")
    assert res.rows == [["2000-02-29", 2000, 2, 29, "Tuesday"]]


# -- the shapes, Q95 and distributed Q3 -------------------------------------

@pytest.mark.parametrize("mode", ["auto", "xla"])
@pytest.mark.parametrize("name", SHAPES)
def test_shape_rows_equal_reference(expected, ports, name, mode):
    sql = T.SHAPES[name]
    assert_rows_close(ports[mode].execute(sql), expected(sql),
                      ordered=name in T.ORDERED)


@pytest.mark.parametrize("mode", ["auto", "xla"])
def test_q95_official(expected, ports, mode):
    """The BASELINE config-5 query verbatim: a 60-day window, empty at
    sf0.01 (one row of a zero count and NULL sums)."""
    res = ports[mode].execute(T.Q95_OFFICIAL)
    assert len(res.rows) == 1
    assert_rows_close(res, expected(T.Q95_OFFICIAL), ordered=False)


@pytest.mark.parametrize("mode", ["auto", "xla"])
def test_q95_widened_window(expected, ports, mode):
    """The widened window whose intersection is non-empty: the self-join
    <>, both IN semi joins and the mixed distinct aggregation."""
    res = ports[mode].execute(T.Q95_WIDE)
    assert res.rows[0][0] > 0
    assert_rows_close(res, expected(T.Q95_WIDE), ordered=False)


def test_distributed_q3(expected):
    d = DistributedQueryRunner(SCHEMA, n_tasks=3, broadcast_threshold=0,
                               catalog="tpcds", device="cpu")
    got = d.execute(T.DISTRIBUTED_Q3)
    assert_rows_close(got, expected(T.DISTRIBUTED_Q3), ordered=False)
    assert len(got.rows) > 0
    assert len(d.last_scheduler.stages()) > 1


# -- device-generated TPC-DS scans --------------------------------------------

STORE_AGG = ("select ss_store_sk, count(*), sum(ss_net_paid) "
             "from store_sales group by ss_store_sk")


def test_store_sales_scan_is_a_fused_leaf(expected, ports):
    """Every store_sales column is device-generated: the scan is a fused
    chain leaf (the torch chain's counters under xla, one scan kernel
    program under auto) and its columns are resident."""
    from presto_tpu_torch.storage import get_store
    xla = ports["xla"].execute(STORE_AGG)
    stats = xla.runtime_stats
    assert stats["torchChainChunks"]["sum"] >= 1
    assert any(k.startswith("torchChain") and k not in (
        "torchChainChunks", "torchChainSteps") for k in stats)
    auto = ports["auto"].execute(STORE_AGG)
    assert auto.runtime_stats["kernelScanPrograms"]["sum"] == 1
    for res in (xla, auto):
        assert_rows_close(res, expected(STORE_AGG), ordered=False)
    cfg = ports["auto"].config
    store = get_store(cfg.storage_budget_bytes, cfg.storage_max_column_bytes,
                      "cpu")
    resident = {k[2] for k in store.entries
                if k[:2] == ("tpcds", "store_sales") and k[3] == 0.01}
    assert {"ss_store_sk", "ss_net_paid"} <= resident


def test_fact_scans_are_device_generated():
    from presto_tpu_torch.connectors import device_gen
    for table in ("store_sales", "web_sales", "web_returns"):
        for col, _t in tpcds.SCHEMAS[table]:
            assert device_gen.supported("tpcds", table, col), (table, col)
    # a host column keeps the dimension scan mixed, as in the reference
    assert not device_gen.supported("tpcds", "item", "i_item_id")


# -- ws_order_number co-bucket layout -----------------------------------------

@pytest.mark.parametrize("sf,k", [(0.01, 1), (0.01, 2), (0.01, 4),
                                  (0.01, 7), (100.0, 18)])
def test_bucket_layout_tiles_tables(sf, k):
    from presto_tpu.connectors import tpcds as jtpcds
    layout = tpcds.bucket_layout(sf, k)
    assert [(b.key_lo, b.key_hi, b.rows) for b in layout] == \
        [(b.key_lo, b.key_hi, b.rows) for b in jtpcds.bucket_layout(sf, k)]
    assert 1 <= len(layout) <= k
    n_ws = tpcds.table_row_count("web_sales", sf)
    n_wr = tpcds.table_row_count("web_returns", sf)
    assert layout[0].key_lo == 1
    assert layout[-1].key_hi == -(-n_ws // tpcds.LINES_PER_ORDER) + 1
    for t, n in (("web_sales", n_ws), ("web_returns", n_wr)):
        assert layout[0].rows[t][0] == 0 and layout[-1].rows[t][1] == n
    for prev, cur in zip(layout, layout[1:]):
        assert cur.key_lo == prev.key_hi
        for t in ("web_sales", "web_returns"):
            assert cur.rows[t][0] == prev.rows[t][1]
    for b in layout:
        assert b.key_lo < b.key_hi
        assert b.rows["web_sales"][0] < b.rows["web_sales"][1]
        assert b.rows["web_returns"][0] <= b.rows["web_returns"][1]


@pytest.mark.parametrize("k", [2, 5])
def test_bucket_rows_match_key_ranges(k):
    """Every bucket's rows carry keys inside its range, read through the
    port's device generator (the column the scan serves)."""
    import torch
    from presto_tpu_torch.connectors import device_gen
    sf = 0.01
    for b in tpcds.bucket_layout(sf, k):
        for table, col in tpcds.BUCKET_COLUMNS.items():
            lo, hi = b.rows[table]
            if lo == hi:
                continue
            keys = device_gen.column("tpcds", table, col, sf,
                                     torch.arange(lo, hi)).numpy()
            assert keys.min() >= b.key_lo and keys.max() < b.key_hi
            assert np.all(np.diff(keys) >= 0)


def test_catalog_bucket_metadata():
    assert catalog.bucket_column("web_sales", "tpcds") == "ws_order_number"
    assert catalog.bucket_column("web_returns", "tpcds") == \
        "wr_order_number"
    assert catalog.bucket_column("store_sales", "tpcds") is None
    assert catalog.bucket_layout(0.01, 4, "tpcds") is not None


# -- grouped (lifespan) execution of the Q95 cores ----------------------------

@pytest.mark.parametrize("name", sorted(T.CORES))
def test_q95_core_grouped_parity(monkeypatch, expected, name):
    sql = T.CORES[name]
    calls = _spy_runs(monkeypatch)
    r = LocalQueryRunner(SCHEMA, catalog="tpcds", device="cpu",
                         config=tuned_config(grouped_lifespans=4))
    assert_rows_close(r.execute(sql), expected(sql), ordered=True)
    assert len(calls) == 1 and len(calls[0].layout) == 4


def test_q95_core_grouped_auto_engages(monkeypatch, expected):
    """With the thresholds shrunk to toy scale, auto mode
    (grouped_lifespans=0) picks a multi-bucket layout by itself."""
    calls = _spy_runs(monkeypatch)
    monkeypatch.setattr(G, "AUTO_SPAN_THRESHOLD", 1024)
    monkeypatch.setattr(G, "TARGET_BUCKET_SPAN", 512)
    r = LocalQueryRunner(SCHEMA, catalog="tpcds", device="cpu",
                         config=tuned_config(grouped_lifespans=0))
    assert_rows_close(r.execute(T.Q95_JOIN_CORE),
                      expected(T.Q95_JOIN_CORE), ordered=True)
    assert len(calls) == 1 and len(calls[0].layout) >= 2


def test_q95_official_with_forced_lifespans(expected):
    """Q95 carries count(distinct ...), so grouped execution declines;
    forced lifespans do not disturb its rows."""
    r = LocalQueryRunner(SCHEMA, catalog="tpcds", device="cpu",
                         config=tuned_config(grouped_lifespans=4))
    assert_rows_close(r.execute(T.Q95_WIDE), expected(T.Q95_WIDE),
                      ordered=False)


# -- the golden file ------------------------------------------------------------

GOLDEN = ([(n, T.SHAPES[n]) for n in SHAPES]
          + [("q95_official", T.Q95_OFFICIAL), ("q95_wide", T.Q95_WIDE)]
          + [(f"core_{k}", T.CORES[k]) for k in sorted(T.CORES)])


@pytest.mark.parametrize("name,sql", GOLDEN, ids=[n for n, _s in GOLDEN])
def test_golden_rows_are_current(expected, name, sql):
    assert golden.load()["queries"][name] == golden.entry(expected(sql))
