"""Resident storage: the port picks the same encoding, holds the same
encoded arrays and builds the same zone maps as the reference package."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presto_tpu.connectors import catalog as jcatalog
from presto_tpu.storage import encodings as jenc
from presto_tpu.storage.store import ResidentStore as JStore
from presto_tpu_torch.storage import encodings as tenc
from presto_tpu_torch.storage.store import ResidentStore as TStore
from torch_threads import one_torch_thread  # noqa: F401

PAD = 1 << 12


def _synthetic(kind: str, n: int):
    rng = np.random.default_rng(11)
    if kind == "wide_i64":
        body = rng.integers(-(1 << 40), 1 << 40, size=n, dtype=np.int64)
    elif kind == "low_card_i64":
        body = rng.integers(0, 9, size=n).astype(np.int64) * 1000 - 3000
    elif kind == "mid_card_i32":
        body = rng.integers(0, 3000, size=n).astype(np.int32)
    elif kind == "runs_i64":
        body = np.repeat(np.arange(n // 40 + 1, dtype=np.int64) * 7,
                         40)[:n]
    elif kind == "short_runs_i64":
        body = np.repeat(np.arange(n // 4 + 1, dtype=np.int64), 4)[:n]
    elif kind == "f64":
        body = rng.integers(0, 50, size=n).astype(np.float64) / 4
    elif kind == "bool":
        body = rng.integers(0, 2, size=n).astype(bool)
    else:
        raise KeyError(kind)
    return np.concatenate([body, np.zeros(PAD, dtype=body.dtype)])


def _assert_same_column(tcol, jcol):
    assert tcol.kind == jcol.kind
    assert tcol.n_rows == jcol.n_rows
    assert len(tcol.arrays) == len(jcol.arrays)
    for t, j in zip(tcol.arrays, jcol.arrays):
        j = np.asarray(j)
        t = t.numpy()
        assert t.dtype == j.dtype, (tcol.kind, t.dtype, j.dtype)
        np.testing.assert_array_equal(t, j)
    assert tcol.nbytes == jcol.nbytes
    assert tcol.logical_nbytes == jcol.logical_nbytes


def _assert_same_zones(tz, jz):
    assert tz.zone_rows == jz.zone_rows
    for a in ("zmin", "zmax", "null_count"):
        np.testing.assert_array_equal(np.asarray(getattr(tz, a)),
                                      np.asarray(getattr(jz, a)))


@pytest.mark.parametrize("on_host", [True, False], ids=["host", "device"])
@pytest.mark.parametrize("hint", [None, "rle", "dict", "plain"])
@pytest.mark.parametrize("kind", ["wide_i64", "low_card_i64",
                                  "mid_card_i32", "runs_i64",
                                  "short_runs_i64", "f64", "bool"])
def test_encode_column_matches_reference(kind, hint, on_host):
    n = 20000
    arr = _synthetic(kind, n)
    jcol = jenc.encode_column(jnp.asarray(arr), n, hint=hint,
                              host=arr if on_host else None)
    tcol = tenc.encode_column(torch.from_numpy(arr.copy()), n, hint=hint,
                              host=arr if on_host else None)
    _assert_same_column(tcol, jcol)
    np.testing.assert_array_equal(tcol.decode_full()[:n].numpy(),
                                  np.asarray(jcol.decode_full())[:n])


@pytest.mark.parametrize("with_nulls", [False, True])
@pytest.mark.parametrize("on_host", [True, False], ids=["host", "device"])
@pytest.mark.parametrize("kind", ["wide_i64", "mid_card_i32", "f64"])
def test_zone_maps_match_reference(kind, on_host, with_nulls):
    n = 10007                       # a ragged last zone
    arr = _synthetic(kind, n)
    nulls = None
    if with_nulls:
        nulls = np.zeros(arr.shape[0], dtype=bool)
        nulls[::13] = True
    host = arr if on_host else None
    jz = jenc.build_zone_maps(jnp.asarray(arr), n, 1024,
                              None if nulls is None else jnp.asarray(nulls),
                              host=host)
    tz = tenc.build_zone_maps(torch.from_numpy(arr.copy()), n, 1024,
                              None if nulls is None
                              else torch.from_numpy(nulls), host=host)
    _assert_same_zones(tz, jz)


@pytest.mark.parametrize("column", ["orderkey", "quantity", "extendedprice",
                                    "discount", "tax", "returnflag",
                                    "linestatus", "shipdate", "commitdate",
                                    "shipmode", "shipinstruct",
                                    "linenumber"])
def test_store_builds_the_same_lineitem_columns(column):
    sf = 0.01
    n = jcatalog.table_row_count("lineitem", sf, "tpch")
    as_i32 = column.endswith("date")
    jent = JStore().get_or_build("tpch", "lineitem", column, sf, n,
                                 1 << 16, as_i32)
    tent = TStore(device="cpu").get_or_build("tpch", "lineitem", column, sf,
                                             n, 1 << 16, as_i32)
    _assert_same_column(tent.column, jent.column)
    _assert_same_zones(tent.zones, jent.zones)


def test_resident_from_numpy_round_trip():
    n = 5000
    arr = _synthetic("short_runs_i64", n)
    jcol = jenc.encode_column(jnp.asarray(arr), n, hint="rle")
    jz = jenc.build_zone_maps(jnp.asarray(arr), n, 512)
    tcol, tz = tenc.resident_from_numpy(
        jcol.kind, [np.asarray(a) for a in jcol.arrays], jz, n)
    _assert_same_column(tcol, jcol)
    _assert_same_zones(tz, jz)
    idx = torch.tensor([0, 3, 4, 4999, 1234])
    np.testing.assert_array_equal(tcol.decode_rows(idx).numpy(),
                                  arr[idx.numpy()])


def test_store_rejects_oversized_columns():
    st = TStore(max_column_bytes=1 << 10, device="cpu")
    assert st.get_or_build("tpch", "lineitem", "quantity", 0.01, 60175,
                           1 << 16, False) is None
