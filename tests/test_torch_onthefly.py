"""Scans beyond the resident store on the CPU: columns generated on the
fly per chunk (presto_tpu_torch/connectors/device_gen.py through
pipeline._compile_TableScanNode).

  * device_gen.column equals the reference's presto_tpu device_gen.column
    bit for bit, for every supported TPC-H column, at a few thousand
    seeded indices at SF1 and SF100, the last rows of each table among
    them (lineitem's order-map tail);
  * TPC-H Q1-Q22 with storage_enabled=False (every column on the fly),
    and with a storage_max_column_bytes that keeps the int32 lineitem
    columns and the small tables resident and the int64 lineitem and
    orders columns on the fly, equal the JAX package's golden rows
    (presto_tpu_torch/benchmarks/tpch_sf001_rows.json); the scan kernels
    meter kernelDeclinedColumnsNotResident before the torch chain takes
    the query."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presto_tpu.connectors import catalog as jcatalog
from presto_tpu.connectors import device_gen as jgen
from presto_tpu_torch.benchmarks.rows import golden_result
from presto_tpu_torch.benchmarks.tpch_queries import ALL, ORDERED
from presto_tpu_torch.connectors import device_gen as tgen
from presto_tpu_torch.exec.pipeline import tuned_config
from presto_tpu_torch.exec.runner import LocalQueryRunner
from presto_tpu_torch.storage import get_store
from torch_rows import assert_rows_close
import torch_tpch_golden as golden
from torch_threads import one_torch_thread  # noqa: F401

COLUMNS = [(t, c) for (cid, t), (_fn, cols) in sorted(tgen._TABLES.items())
           if cid == "tpch" for c in sorted(cols)]
# keeps a column resident when its padded int32 form fits (lineitem's at
# sf0.01: (60175 + 65536) x 4 bytes) and its int64 form does not
MIXED_MAX_COLUMN_BYTES = 600_000


def _indices(table: str, sf: float) -> np.ndarray:
    n = jcatalog.table_row_count(table, sf, "tpch")
    rng = np.random.default_rng(int(sf * 100) + len(table))
    return np.concatenate([rng.integers(0, n, 3000),
                           np.arange(max(0, n - 64), n)]).astype(np.int64)


@pytest.mark.parametrize("sf", [1.0, 100.0], ids=["sf1", "sf100"])
@pytest.mark.parametrize("table,column", COLUMNS,
                         ids=[f"{t}.{c}" for t, c in COLUMNS])
def test_device_gen_column_equals_reference(table, column, sf):
    idx = _indices(table, sf)
    want = np.asarray(jgen.column("tpch", table, column, sf,
                                  jnp.asarray(idx)))
    got = tgen.column("tpch", table, column, sf,
                      torch.from_numpy(idx)).numpy()
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def runners():
    return {
        "on_the_fly": LocalQueryRunner(
            golden.SCHEMA, device="cpu",
            config=tuned_config(storage_enabled=False)),
        "mixed": LocalQueryRunner(
            golden.SCHEMA, device="cpu",
            config=tuned_config(
                storage_max_column_bytes=MIXED_MAX_COLUMN_BYTES)),
    }


@pytest.mark.parametrize("residency", ["on_the_fly", "mixed"])
@pytest.mark.parametrize("q", sorted(ALL))
def test_tpch_beyond_the_store_equals_golden(runners, residency, q):
    ent = golden.load()["queries"][str(q)]
    res = runners[residency].execute(ALL[q])
    assert_rows_close(res, golden_result(ent), ordered=q in ORDERED,
                      rtol=1e-9)
    if q in (1, 6):
        # every scan of Q1 / Q6 reads a lineitem int64 column: the kernel
        # declines it, metered, and the torch chain runs the query
        rs = res.runtime_stats
        assert rs["kernelDeclinedColumnsNotResident"]["sum"] >= 1, rs
        assert not rs.get("kernelScanPrograms")


def test_mixed_residency_keeps_some_columns_resident(runners):
    runners["mixed"].execute(ALL[3])
    store = get_store(6 << 30, MIXED_MAX_COLUMN_BYTES, "cpu")
    resident = {(k[1], k[2]) for k in store.entries}
    assert ("lineitem", "shipdate") in resident
    assert ("customer", "custkey") in resident
    assert ("lineitem", "extendedprice") not in resident
    assert ("orders", "orderkey") not in resident
