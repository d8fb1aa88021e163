"""The port's verifier (presto_tpu_torch/verifier.py, a host copy of
presto_tpu/verifier.py): the reference's cases through the port's
runners on the CPU, and the port's checksums equal to the JAX package's
on the same results."""
import pytest

from presto_tpu import verifier as JV
from presto_tpu_torch.exec.pipeline import ExecutionConfig
from presto_tpu_torch.exec.runner import (DistributedQueryRunner,
                                          LocalQueryRunner)
from presto_tpu_torch.verifier import (CONTROL_ERROR, MATCH, MISMATCH,
                                       TEST_ERROR, checksum_result, verify)
from torch_threads import one_torch_thread  # noqa: F401

QUERIES = [
    "select count(*), sum(l_quantity) from lineitem",
    "select o_orderstatus, count(*) from orders group by o_orderstatus",
    "select n_name, r_name from nation join region "
    "on n_regionkey = r_regionkey",
    "select c_custkey, avg(o_totalprice) from customer "
    "left join orders on c_custkey = o_custkey group by c_custkey",
]


@pytest.fixture(scope="module")
def runner():
    return LocalQueryRunner("sf0.01", device="cpu")


def test_engine_vs_reference_matches(runner):
    results = verify(runner.execute_reference, runner.execute, QUERIES)
    assert [v.status for v in results] == [MATCH] * len(QUERIES)


def test_local_vs_distributed_matches(runner):
    dist = DistributedQueryRunner("sf0.01", n_tasks=3, broadcast_threshold=0,
                                  device="cpu")
    results = verify(runner.execute, dist.execute, QUERIES[:2])
    assert [v.status for v in results] == [MATCH, MATCH]


def test_spill_config_vs_default_matches(runner):
    b = LocalQueryRunner("sf0.01", device="cpu", config=ExecutionConfig(
        batch_rows=1 << 14, join_out_capacity=1 << 16,
        memory_budget_bytes=200_000, spill_partitions=4))
    results = verify(runner.execute, b.execute, QUERIES)
    assert [v.status for v in results] == [MATCH] * len(QUERIES)


def test_mismatch_detected(runner):
    results = verify(
        lambda s: runner.execute("select 1 k from region"),
        lambda s: runner.execute("select 2 k from region"), ["q"])
    assert results[0].status == MISMATCH and "k" in results[0].detail


def test_errors_classified(runner):
    bad = "select * from no_such_table"
    good = "select count(*) from region"
    assert verify(runner.execute, runner.execute, [bad])[0].status \
        == CONTROL_ERROR
    results = verify(lambda s: runner.execute(good),
                     lambda s: runner.execute(bad), ["q"])
    assert results[0].status == TEST_ERROR


def test_float_tolerance(runner):
    a = runner.execute("select avg(c_acctbal) from customer")
    b = runner.execute_reference("select avg(c_acctbal) from customer")
    assert checksum_result(a)[0].matches(checksum_result(b)[0],
                                         rel_tol=1e-9)


def test_duplicate_column_names_not_collapsed(runner):
    results = verify(
        lambda s: runner.execute("select 1 a, 2 a from region"),
        lambda s: runner.execute("select 1 a, 3 a from region"), ["q"])
    assert results[0].status == MISMATCH


@pytest.mark.parametrize("sql", QUERIES)
def test_checksums_equal_the_reference(runner, sql):
    """The port's checksums of its engine's rows equal the JAX package's
    checksums of its oracle's rows, field for field (floats within the
    verifier's rel_tol)."""
    from presto_tpu.exec.runner import LocalQueryRunner as JRunner
    got = checksum_result(runner.execute(sql))
    want = JV.checksum_result(JRunner("sf0.01").execute_reference(sql))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.count, a.nulls, a.hash_sum, a.float_nan) == \
            (b.count, b.nulls, b.hash_sum, b.float_nan)
        assert abs(a.float_sum - b.float_sum) <= \
            1e-9 * max(abs(b.float_sum), 1.0)
