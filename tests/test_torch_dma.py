"""scan_kernel_dma="double" (kernel #2, the stage ring) in the port.

On the CPU the wrappers run their plain versions, which stage nothing, so
a double-mode query returns the same rows as the reference's double-mode
Pallas kernel (interpret mode) and meters no kernelDma* counter.  The
ring's geometry meter is held to a brute-force walk of the launch's
tiles over the staged arrays, the stage regions to a hand count, and
illegal modes raise."""
import dataclasses
import math

import numpy as np
import pytest
import torch

from presto_tpu.exec.pipeline import ExecutionConfig as JConfig
from presto_tpu.exec.runner import LocalQueryRunner as JRunner
from presto_tpu.serving import PlanCache as JPlanCache
from presto_tpu_torch.benchmarks.grouped_queries import S1
from presto_tpu_torch.benchmarks.join_queries import J1
from presto_tpu_torch.benchmarks.tpch_queries import Q1
from presto_tpu_torch.exec.kernels import grouped as gk
from presto_tpu_torch.exec.kernels import scan_kernel as sk
from presto_tpu_torch.exec.pipeline import ExecutionConfig
from presto_tpu_torch.exec.runner import LocalQueryRunner
from presto_tpu_torch.storage.encodings import ResidentColumn
from torch_threads import one_torch_thread  # noqa: F401

# the reference's double-buffer test query (tests/test_scan_kernel.py:176)
REF_SQL = ("select l_orderkey, sum(l_quantity), count(*) from lineitem "
           "where l_orderkey < 3000 group by l_orderkey")
DMA_STATS = ("kernelDmaStagedBlocks", "kernelDmaPrefetchedBlocks",
             "kernelDmaOverlapFraction")


def _programs(res) -> int:
    return int((res.runtime_stats or {}).get(
        "kernelScanPrograms", {}).get("sum", 0))


def _rows_equal(got, exp):
    """Integers and decimals exact, floats within rtol 1e-12, any order."""
    assert got.column_names == exp.column_names
    g, e = got.sorted_rows(), exp.sorted_rows()
    assert len(g) == len(e) > 0
    for rg, re_ in zip(g, e):
        for a, b in zip(rg, re_):
            if isinstance(a, float) or isinstance(b, float):
                assert math.isclose(a, b, rel_tol=1e-12, abs_tol=0), (rg, re_)
            else:
                assert a == b, (rg, re_)


@pytest.fixture(scope="module")
def ref():
    return JRunner("sf0.01", config=JConfig(
        scan_kernel="pallas", scan_kernel_dma="double", batch_rows=8192),
        plan_cache=JPlanCache())


@pytest.fixture(scope="module")
def port():
    return LocalQueryRunner("sf0.01", config=ExecutionConfig(
        scan_kernel_dma="double", batch_rows=8192), device="cpu")


@pytest.mark.parametrize("sql", [REF_SQL, Q1, S1, J1],
                         ids=["reference_query", "q1", "s1", "j1"])
def test_double_mode_rows_equal_reference(ref, port, sql):
    exp = ref.execute(sql)
    got = port.execute(sql)
    _rows_equal(got, exp)
    assert _programs(got) >= 1 and _programs(exp) >= 1
    assert not [k for k in got.runtime_stats
                if k.startswith("kernelDeclined")]
    # the reference's interpret-mode kernel stages its slabs; the plain
    # versions stage nothing and meter none of the three
    assert exp.runtime_stats["kernelDmaOverlapFraction"]["max"] > 0
    assert not [k for k in DMA_STATS if k in got.runtime_stats]


def test_single_and_double_agree_on_the_cpu(port):
    single = LocalQueryRunner("sf0.01", config=dataclasses.replace(
        port.config, scan_kernel_dma="single"), device="cpu")
    assert single.execute(REF_SQL).rows == port.execute(REF_SQL).rows


# -- the geometry meter ------------------------------------------------------

def _walk(grid, br, rows_per_cta, n_sub, tile, n_ctas):
    """Per CTA, the tiles it computes, by walking its work items."""
    items = []
    for b, lo, hi in grid:
        for sub in range(n_sub):
            s_lo = lo + sub * rows_per_cta
            s_hi = min(hi, s_lo + rows_per_cta)
            items.append(max(0, -(-(s_hi - s_lo) // tile))
                         if s_hi > s_lo else 0)
    if n_ctas is None:
        return items
    per_cta = [0] * n_ctas
    for i, n in enumerate(items):
        per_cta[i % n_ctas] += n
    return per_cta


def _columns(kinds):
    cols = []
    for kind, dtype in kinds:
        vals = torch.zeros(64, dtype=dtype)
        if kind == "dict":
            cols.append(ResidentColumn("dict", (vals, torch.zeros(
                4, dtype=torch.int64)), 64))
        elif kind == "rle":
            cols.append(ResidentColumn("rle", (torch.zeros(4, dtype=dtype),
                                               torch.zeros(
                                                   4, dtype=torch.int64)),
                                       64))
        else:
            cols.append(ResidentColumn("plain", (vals,), 64))
    return cols


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("n_ctas", [None, 1, 7, 264])
def test_stage_ring_counts_equal_a_walk_of_the_tiles(seed, n_ctas):
    rng = np.random.default_rng(seed)
    br = int(rng.choice([4096, 8192, 65536]))
    rows_per_cta = min(br, int(rng.choice([2048, 8192])))
    n_sub = -(-br // rows_per_cta)
    threads = int(rng.choice([64, 128, 256]))
    grid = []
    for b in sorted(rng.choice(200, size=int(rng.integers(1, 40)),
                               replace=False).tolist()):
        lo = int(rng.integers(0, br))
        hi = int(rng.integers(lo + 1, br + 1))
        grid.append((b, lo, hi))
    shape = sk.scan_shape(_columns([("plain", torch.int8),
                                    ("dict", torch.int16),
                                    ("rle", torch.int32),
                                    ("plain", torch.int64)]))
    # the int64 array is first read after a filter: not staged
    staged = sk.staged_columns({0: False, 1: True, 2: False, 3: True},
                               shape)
    tile = sk.ROWS_PER_THREAD * threads
    offsets, stage = sk.stage_regions(staged, shape, tile)
    staging = sk.Staging(staged, int(rng.integers(2, 5)), 1, tile, stage,
                         tuple(offsets), 3)
    got = sk.stage_ring_counts(staging, grid, br, rows_per_cta, n_sub,
                               n_ctas)
    tiles = _walk(grid, br, rows_per_cta, n_sub, tile, n_ctas)
    assert staged == (0, 1)                  # plain int8, dict int16
    assert got == (2 * sum(tiles), 2 * sum(max(0, t - 1) for t in tiles))
    assert 0 <= got[1] < got[0]
    # a plan that stages nothing meters nothing
    none = sk.Staging((), 0, 0, tile, 0, (-1,) * 4, 0)
    assert sk.stage_ring_counts(none, grid, br, rows_per_cta, n_sub,
                                n_ctas) == (0, 0)


def test_stage_layout_regions():
    shape = sk.scan_shape(_columns([("plain", torch.int8),
                                    ("rle", torch.int64),
                                    ("dict", torch.int32),
                                    ("plain", torch.bool),
                                    ("plain", torch.float64),
                                    ("plain", torch.int32)]))
    # column: first read after a narrowing step
    reads = {0: True, 1: False, 2: False, 3: True, 4: True, 5: False}
    staged = sk.staged_columns(reads, shape)
    # RLE never; 1-byte wherever read; the others where read under the
    # full mask: not the float64 array read after a filter
    assert staged == (0, 2, 3, 5)
    tile = sk.ROWS_PER_THREAD * 128
    offsets, stage = sk.stage_regions(staged, shape, tile)
    sizes = [tile * 1 + 16, tile * 4 + 16, tile * 1 + 16, tile * 4 + 16]
    assert offsets[1] == offsets[4] == -1
    assert [offsets[i] for i in staged] == list(np.cumsum([0] + sizes[:-1]))
    assert stage == sum(sizes) and all(o % 16 == 0 for o in offsets
                                       if o >= 0)
    # the reservation: two stages and their four 8-byte mbarriers
    assert sk.min_ring_bytes(staged, shape, 128) == 2 * stage + 32
    assert sk.min_ring_bytes((), shape, 128) == 0
    st = sk.Staging(staged, 3, 1, tile, stage, tuple(offsets), 10)
    assert st.ring_bytes == 3 * (stage + 16)
    assert st.staged_bytes(1000) == 10 * 1000


def test_meter_records_the_reference_names():
    from presto_tpu_torch.utils.runtime_stats import RuntimeStats
    before = sk.KERNEL_METRICS.snapshot()
    rs = RuntimeStats()
    sk.meter_kernel_run(rs, 4, 12, 9)
    d = rs.to_dict()
    assert d["kernelDmaStagedBlocks"]["sum"] == 12
    assert d["kernelDmaPrefetchedBlocks"]["sum"] == 9
    assert d["kernelDmaOverlapFraction"]["sum"] == 0.75
    after = sk.KERNEL_METRICS.snapshot()
    assert after["dma_staged_blocks"] - before["dma_staged_blocks"] == 12
    assert after["dma_prefetched_blocks"] \
        - before["dma_prefetched_blocks"] == 9
    assert after["scan_programs"] == before["scan_programs"] + 1
    rs = RuntimeStats()
    sk.meter_kernel_run(rs, 4)
    assert not [k for k in DMA_STATS if k in rs.to_dict()]


# -- illegal modes and a ring that does not fit -------------------------------

@pytest.mark.parametrize("kw", [{"scan_kernel_dma": "triple"},
                                {"scan_kernel": "kernel"},
                                {"scan_kernel": "XLA"}])
def test_illegal_modes_raise(kw):
    with pytest.raises(ValueError, match="must be one of"):
        ExecutionConfig(**kw)


def _recorded_call(sql, wrapper):
    calls = []
    mod = sk if wrapper == "scan_direct" else gk
    real = getattr(mod, wrapper)

    def rec(*a, **kw):
        calls.append((a, kw))
        return real(*a, **kw)
    setattr(mod, wrapper, rec)
    try:
        LocalQueryRunner("sf0.01", device="cpu").execute(sql)
    finally:
        setattr(mod, wrapper, real)
    return calls[-1]


def test_wrappers_refuse_an_illegal_mode():
    (a, kw) = _recorded_call(Q1, "scan_direct")
    with pytest.raises(ValueError, match="scan_kernel_dma"):
        sk.scan_direct(*a, **dict(kw, dma="quad"))
    (a, kw) = _recorded_call(S1, "scan_span")
    with pytest.raises(ValueError, match="scan_kernel_dma"):
        gk.scan_span(*a, **dict(kw, dma="quad"))


def test_a_ring_that_does_not_fit_raises_naming_its_bytes():
    (a, kw) = _recorded_call(Q1, "scan_direct")
    plan, columns, grid = a[0], a[1], a[2]
    ln = sk.launch_tensors(plan, columns, grid, torch.device("cpu"),
                           dma="double")
    st = plan.staging(columns)
    ring = st.ring_bytes
    assert ln.stages == st.stages >= 2 and ln.stage_bytes == st.stage_bytes
    assert ring == st.stages * (st.stage_bytes + 16)
    # the ring, the stage table and the hash kernel's 128-byte producer
    # state
    assert ln.smem_bytes == plan.smem_bytes + ring + 8 * len(columns) + 128
    assert ln.plan.numel() == len(plan.words) + len(columns)
    full = dataclasses.replace(plan,
                               smem_bytes=sk.MAX_SMEM_BYTES - ring // 2)
    with pytest.raises(NotImplementedError, match=f"{ring}-byte stage ring"):
        sk.launch_tensors(full, columns, grid, torch.device("cpu"),
                          dma="double")
    single = sk.launch_tensors(full, columns, grid, torch.device("cpu"))
    assert single.stages == 1 and single.smem_bytes == full.smem_bytes
