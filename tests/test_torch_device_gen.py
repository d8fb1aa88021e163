"""Device column generation: the port's torch generators (uint64 emulated
in int64) are bit-identical to the reference package's jnp generators,
for lineitem and the TPC-H dimensions the join slice builds from."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presto_tpu.connectors import catalog as jcatalog
from presto_tpu.connectors import device_gen as jgen
from presto_tpu.exec import operators as jops
from presto_tpu_torch.connectors import device_gen as tgen
from presto_tpu_torch.exec import operators as tops
from torch_threads import one_torch_thread  # noqa: F401

INT64_MIN = np.iinfo(np.int64).min
INT64_MAX = np.iinfo(np.int64).max
EDGES = np.array([0, -1, 1, INT64_MIN, INT64_MAX, INT64_MIN + 1,
                  INT64_MAX - 1, 1 << 32, -(1 << 32)], dtype=np.int64)
LINEITEM = sorted(tgen._TABLES[("tpch", "lineitem")][1])
DIMENSIONS = [(t, c) for t in ("orders", "customer", "part", "partsupp",
                               "supplier")
              for c in sorted(tgen._TABLES[("tpch", t)][1])]


def _values():
    rng = np.random.default_rng(7)
    rand = rng.integers(INT64_MIN, INT64_MAX, size=4096, dtype=np.int64,
                        endpoint=True)
    return np.concatenate([EDGES, rand])


@pytest.mark.parametrize("which", ["ops.splitmix64", "_dsplitmix64"])
def test_splitmix64_bit_exact(which):
    x = _values()
    if which == "ops.splitmix64":
        want = np.asarray(jops.splitmix64(jnp.asarray(x)))
        got = tops.splitmix64(torch.from_numpy(x)).numpy()
    else:
        want = np.asarray(jgen._dsplitmix64(jnp.asarray(x)))
        got = tgen._dsplitmix64(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want.view(np.int64))


@pytest.mark.parametrize("n", [1, 3, 7, 28, 5040, (1 << 61) + 5])
def test_unsigned_remainder(n):
    x = _values()
    want = (x.view(np.uint64) % np.uint64(n)).astype(np.int64)
    got = tops.umod(torch.from_numpy(x), n).numpy()
    np.testing.assert_array_equal(got, want)


def _compare(column, sf, lo, hi, table="lineitem"):
    idx = np.arange(lo, hi, dtype=np.int64)
    want = np.asarray(jgen.column("tpch", table, column, sf,
                                  jnp.asarray(idx)))
    got = tgen.column("tpch", table, column, sf,
                      torch.from_numpy(idx)).numpy()
    assert got.dtype == want.dtype, (column, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("column", LINEITEM)
def test_lineitem_sf001_bit_exact(column):
    n = jcatalog.table_row_count("lineitem", 0.01, "tpch")
    _compare(column, 0.01, 0, n)


@pytest.mark.parametrize("column", LINEITEM)
def test_lineitem_sf10_window_bit_exact(column):
    """The last 1M rows at SF10: includes the order map's tail branch."""
    n = jcatalog.table_row_count("lineitem", 10.0, "tpch")
    _compare(column, 10.0, n - (1 << 20), n)


@pytest.mark.parametrize("table,column", DIMENSIONS,
                         ids=[f"{t}.{c}" for t, c in DIMENSIONS])
def test_dimension_sf001_bit_exact(table, column):
    n = jcatalog.table_row_count(table, 0.01, "tpch")
    _compare(column, 0.01, 0, n, table)


@pytest.mark.parametrize("table,column", DIMENSIONS,
                         ids=[f"{t}.{c}" for t, c in DIMENSIONS])
def test_dimension_sf10_window_bit_exact(table, column):
    """The last 64K rows of each dimension at SF10."""
    n = jcatalog.table_row_count(table, 10.0, "tpch")
    _compare(column, 10.0, max(0, n - (1 << 16)), n, table)


def test_dictionaries_and_support_match_reference():
    for t, c in [("lineitem", c) for c in LINEITEM] + DIMENSIONS:
        assert tgen.supported("tpch", t, c)
        assert tgen.dictionary("tpch", t, c) == \
            jgen.dictionary("tpch", t, c)
        assert tgen.encoding_hint("tpch", t, c) == \
            jgen.encoding_hint("tpch", t, c)
    for t in ("orders", "customer", "part", "partsupp", "supplier"):
        assert tgen._TABLES[("tpch", t)][1] == jgen._TABLES[("tpch", t)][1]
    assert not tgen.supported("tpch", "nation", "nationkey")


# -- TPC-DS: the fact tables (every column) and the dimension subsets -----

TPCDS = [(t, c) for (cid, t), (_fn, cols) in sorted(jgen._TABLES.items())
         if cid == "tpcds" for c in sorted(cols)]


def _compare_ds(table, column, sf, idx):
    want = np.asarray(jgen.column("tpcds", table, column, sf,
                                  jnp.asarray(idx)))
    got = tgen.column("tpcds", table, column, sf,
                      torch.from_numpy(idx)).numpy()
    assert got.dtype == want.dtype, (column, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("table,column", TPCDS,
                         ids=[f"{t}.{c}" for t, c in TPCDS])
def test_tpcds_bit_exact(table, column):
    """Head and tail rows at sf0.01, and row indices past 2**32 (as at
    SF100 and beyond no table reaches, but the arithmetic must hold)."""
    n = jcatalog.table_row_count(table, 0.01, "tpcds")
    head = np.arange(0, min(4096, n), dtype=np.int64)
    tail = np.arange(max(0, n - 1024), n, dtype=np.int64)
    far = np.arange((1 << 32) - 512, (1 << 32) + 512, dtype=np.int64)
    for idx in (head, tail, far):
        _compare_ds(table, column, 0.01, idx)
    # the SF100 fact tables' last rows
    n100 = jcatalog.table_row_count(table, 100.0, "tpcds")
    _compare_ds(table, column, 100.0,
                np.arange(n100 - 512, n100, dtype=np.int64))


@pytest.mark.parametrize("table,column", TPCDS,
                         ids=[f"{t}.{c}" for t, c in TPCDS])
def test_tpcds_matches_host_generator(table, column):
    """Codes and values equal to the host generator the scan would
    otherwise copy (tests/test_device_gen.py's check, for the port)."""
    n = jcatalog.table_row_count(table, 0.01, "tpcds")
    for start, count in [(0, min(4096, n)), (max(0, n - 100), min(100, n))]:
        idx = torch.arange(start, start + count, dtype=torch.int64)
        dev = tgen.column("tpcds", table, column, 0.01, idx).numpy()
        host = jcatalog.generate_column(table, column, 0.01, start, count,
                                        "tpcds")
        if isinstance(host, tuple):
            codes, values = host
            assert tgen.dictionary("tpcds", table, column) == tuple(values)
            np.testing.assert_array_equal(dev, codes)
        else:
            np.testing.assert_array_equal(dev, np.asarray(host))


def test_tpcds_registry_matches_reference():
    for key in [k for k in jgen._TABLES if k[0] == "tpcds"]:
        assert tgen._TABLES[key][1] == jgen._TABLES[key][1], key
        for c in jgen._TABLES[key][1]:
            assert tgen.supported(*key, c)
            assert tgen.dictionary(*key, c) == jgen.dictionary(*key, c)
            assert tgen.encoding_hint(*key, c) == \
                jgen.encoding_hint(*key, c)
    assert {k for k in jgen._DICTS if k[0] == "tpcds"} == \
        {k for k in tgen._DICTS if k[0] == "tpcds"}
    assert {k for k in jgen._ENCODING_HINTS if k[0] == "tpcds"} == \
        {k for k in tgen._ENCODING_HINTS if k[0] == "tpcds"}
    assert not tgen.supported("tpcds", "date_dim", "d_date_sk")
    assert not tgen.supported("tpcds", "item", "i_item_id")
