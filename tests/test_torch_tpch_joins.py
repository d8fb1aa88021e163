"""TPC-H at sf0.01 through the port on the CPU against the JAX package:
the queries that need joins only (every column device-generated):
Q1, Q3, Q4, Q6, Q12, Q14, Q17 and Q19.

Each query runs through the port's LocalQueryRunner under scan_kernel
"auto" (the kernels' plain versions where a chain reaches them) and
"xla" (the torch fused chain), held to the reference's LocalQueryRunner
in its default config (as tests/test_tpch_full.py runs it): ordered
queries in order, floats within rtol 1e-9.  The golden file the chip
script holds its CUDA rows to equals the live reference rows."""
import pytest

from presto_tpu.exec.runner import LocalQueryRunner as JRunner
from presto_tpu_torch.benchmarks.tpch_queries import ALL, ORDERED
from presto_tpu_torch.exec.pipeline import tuned_config
from presto_tpu_torch.exec.runner import LocalQueryRunner
from torch_rows import assert_rows_close
import torch_tpch_golden as golden
from torch_threads import one_torch_thread  # noqa: F401

QUERIES = (1, 3, 4, 6, 12, 14, 17, 19)


@pytest.fixture(scope="module")
def expected():
    runner = JRunner(golden.SCHEMA)
    cache = {}

    def get(q):
        if q not in cache:
            cache[q] = runner.execute(ALL[q])
        return cache[q]
    return get


@pytest.fixture(scope="module")
def ports():
    return {mode: LocalQueryRunner(golden.SCHEMA, device="cpu",
                                   config=tuned_config(scan_kernel=mode))
            for mode in ("auto", "xla")}


@pytest.mark.parametrize("mode", ["auto", "xla"])
@pytest.mark.parametrize("q", QUERIES)
def test_tpch_rows_equal_reference(expected, ports, q, mode):
    assert_rows_close(ports[mode].execute(ALL[q]), expected(q),
                      ordered=q in ORDERED, rtol=1e-9)


@pytest.mark.parametrize("q", QUERIES)
def test_golden_rows_are_current(expected, q):
    assert golden.load()["queries"][str(q)] == golden.entry(expected(q))
