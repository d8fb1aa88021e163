"""The TPC-DS conformance bank (tests/test_tpcds_queries.py `QUERIES`,
held as data in presto_tpu_torch/benchmarks/tpcds_queries.py) through the
port on the CPU against the JAX package, under the bank's config
(16K-row batches, 64K-row join output):

  * each of the 21 queries under scan_kernel "auto" and "xla" equals the
    reference's LocalQueryRunner rows (one JAX runner and one run per
    query for the module), floats within rtol 1e-12;
  * a subset with storage_enabled=False (every device-generated column
    made per chunk: the on-the-fly path) equals the same rows;
  * the kernels' gates on TPC-DS shapes decide as the reference's do
    (the reference's Pallas kernels in interpret mode): the same
    kernelDeclined{reason} counters and scan-kernel programs;
  * the golden file's bank entries equal the live reference rows."""
import pytest

from presto_tpu_torch.benchmarks import tpcds_queries as T
from presto_tpu_torch.exec.pipeline import ExecutionConfig
from presto_tpu_torch.exec.runner import LocalQueryRunner
from torch_rows import assert_rows_close
import torch_tpcds_golden as golden
from torch_threads import one_torch_thread  # noqa: F401

NAMES = sorted(T.QUERIES)
# one query per shape family: a star join, a multi-dimension report, a
# fact-fact join, an EXISTS, a window over an aggregation
ON_THE_FLY = ("q03", "q19", "q25_shape", "q16_shape_exists", "q98")


@pytest.fixture(scope="module")
def expected():
    runner = golden.reference_runners()["bank"]
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = runner.execute(T.QUERIES[name])
        return cache[name]
    return get


def _port(**kw):
    return LocalQueryRunner(golden.SCHEMA, catalog="tpcds", device="cpu",
                            config=ExecutionConfig(**T.BANK_CONFIG, **kw))


@pytest.fixture(scope="module")
def ports():
    return {"auto": _port(scan_kernel="auto"), "xla": _port(scan_kernel="xla"),
            "onthefly": _port(storage_enabled=False)}


@pytest.mark.parametrize("mode", ["auto", "xla"])
@pytest.mark.parametrize("name", NAMES)
def test_bank_rows_equal_reference(expected, ports, name, mode):
    assert_rows_close(ports[mode].execute(T.QUERIES[name]), expected(name),
                      ordered=False)


@pytest.mark.parametrize("name", ON_THE_FLY)
def test_bank_on_the_fly(expected, ports, name):
    assert_rows_close(ports["onthefly"].execute(T.QUERIES[name]),
                      expected(name), ordered=False)


@pytest.mark.parametrize("name", NAMES)
def test_golden_rows_are_current(expected, name):
    assert golden.load()["queries"][name] == golden.entry(expected(name))


def test_golden_covers_the_bank():
    assert sorted(golden.load()["queries"]) == sorted(T.bank())


# -- the kernels' gates on TPC-DS shapes ----------------------------------------

GATES = {
    # a store_sales aggregation by store: one scan-kernel program
    "store": "select ss_store_sk, count(*), sum(ss_net_paid) "
             "from store_sales group by ss_store_sk",
    "store_qty": "select ss_store_sk, ss_quantity, sum(ss_ext_sales_price) "
                 "from store_sales group by ss_store_sk, ss_quantity",
    # a semi join probe in the kernel
    "semi": T.SHAPES["returned_orders_semi"],
    # a fanout-k build: JoinShape
    "q62": T.QUERIES["q62"],
    "q96": T.QUERIES["q96"],
}


def _gates(res):
    stats = res.runtime_stats or {}
    declined = {k[len("kernelDeclined"):]: int(v["sum"])
                for k, v in stats.items() if k.startswith("kernelDeclined")}
    return declined, int(stats.get("kernelScanPrograms", {}).get("sum", 0))


@pytest.fixture(scope="module")
def gate_runners():
    from presto_tpu.exec.pipeline import tuned_config as jtuned
    from presto_tpu.exec.runner import LocalQueryRunner as JRunner
    from presto_tpu.serving import PlanCache as JPlanCache
    return (JRunner(golden.SCHEMA, catalog="tpcds",
                    config=jtuned(scan_kernel="pallas"),
                    plan_cache=JPlanCache()),
            LocalQueryRunner(golden.SCHEMA, catalog="tpcds", device="cpu"))


@pytest.mark.parametrize("name", sorted(GATES))
def test_gates_match_reference(gate_runners, name):
    ref, port = gate_runners
    want, got = ref.execute(GATES[name]), port.execute(GATES[name])
    assert _gates(got) == _gates(want)
    assert_rows_close(got, want, ordered=False)
