"""GROUP BY beyond 64 groups on the CPU: the slice's queries through the
port's LocalQueryRunner(device="cpu") -- span and hash kernels' plain
versions -- return exactly the reference package's rows, with the
Pallas span / hash kernel engaged on the reference side (interpret mode);
and the grouped path's gates: the slot-cap decline, the collision loop
(table doubled, salt bumped) and the non-BASIC aggregate decline, each
decline metered and followed by the torch fused chain with the
reference's rows."""
import pytest

from presto_tpu.exec.pipeline import tuned_config as jtuned
from presto_tpu.exec.runner import LocalQueryRunner as JRunner
from presto_tpu.exec.runner import _assert_rows_equal
from presto_tpu.serving import PlanCache as JPlanCache
from presto_tpu_torch.benchmarks.grouped_queries import H1, H2, S1, S2
from presto_tpu_torch.exec.kernels import grouped as gk
from presto_tpu_torch.exec.kernels import scan_kernel as sk
from presto_tpu_torch.exec.pipeline import tuned_config
from presto_tpu_torch.exec.runner import LocalQueryRunner
from torch_rows import assert_rows_close
from torch_threads import one_torch_thread  # noqa: F401

ORDERKEY = "select l_orderkey, count(*) from lineitem group by l_orderkey"


def _programs(res) -> int:
    return int((res.runtime_stats or {}).get(
        "kernelScanPrograms", {}).get("sum", 0))


def _declined(res):
    return [k for k in res.runtime_stats if k.startswith("kernelDeclined")]


@pytest.fixture(scope="module")
def ref():
    return JRunner("sf0.01", config=jtuned(scan_kernel="pallas"),
                   plan_cache=JPlanCache())


@pytest.fixture(scope="module")
def port():
    return LocalQueryRunner("sf0.01", device="cpu")


@pytest.mark.parametrize("name,sql,ordered,mode", [
    ("s1", S1, True, "span"), ("h1", H1, True, "hash"),
    ("h2", H2, True, "hash"), ("s2", S2, False, "span"),
    ("orderkey", ORDERKEY, False, "hash")],
    ids=["s1", "h1", "h2", "s2", "orderkey"])
def test_slice_rows_equal_reference(ref, port, monkeypatch, name, sql,
                                    ordered, mode):
    used = []
    real = getattr(gk, "scan_" + mode)

    def recording(*a):
        used.append(a[0].mode)
        return real(*a)
    monkeypatch.setattr(gk, "scan_" + mode, recording)
    exp = ref.execute(sql)
    got = port.execute(sql)
    _assert_rows_equal(got, exp, ordered=ordered)
    assert got.column_names == exp.column_names
    assert _programs(got) == 1 and _programs(exp) == 1
    assert not _declined(got) and not _declined(exp)
    # a hash retry after a collision is a second call of the same kernel
    assert used and set(used) == {mode}


def test_grouped_wrappers_on_cpu_count_no_launch(port):
    before = dict(sk.LAUNCHES)
    port.execute(S1)
    port.execute(H2)
    assert sk.LAUNCHES == before


def test_hash_slot_cap_declines(ref, monkeypatch):
    """An estimate beyond twice the slot cap declines with
    AggGroupCardinality (the reference's
    test_decline_agg_group_cardinality, with the cap shrunk); the torch
    chain's runtime span (l_orderkey as the anchor) returns the
    reference's rows."""
    monkeypatch.setattr(gk, "KERNEL_HASH_MAX_SLOTS", 16)
    r = LocalQueryRunner("sf0.01", device="cpu")
    before = sk.KERNEL_METRICS.snapshot()["declined"].get(
        "AggGroupCardinality", 0)
    got = r.execute(ORDERKEY)
    after = sk.KERNEL_METRICS.snapshot()["declined"]["AggGroupCardinality"]
    assert after == before + 1
    assert _declined(got) == ["kernelDeclinedAggGroupCardinality"]
    assert_rows_close(got, ref.execute(ORDERKEY), ordered=False)


def test_collision_doubles_the_table_with_a_new_salt(ref, monkeypatch):
    """A group estimate far too low: the first tables overflow their probe
    rounds, and each retry doubles the table and takes the next salt until
    the groups fit; the rows still equal the reference's."""
    from presto_tpu_torch.sql.stats import StatsCalculator
    monkeypatch.setattr(StatsCalculator, "rows", lambda self, node: 1.0)
    tables = []
    real = gk.scan_hash

    def recording(plan, columns, grid, br, params, num_slots, salt):
        out = real(plan, columns, grid, br, params, num_slots, salt)
        tables.append((num_slots, salt, bool(out.collision)))
        return out
    monkeypatch.setattr(gk, "scan_hash", recording)
    r = LocalQueryRunner("sf0.01", config=tuned_config(agg_slots=1024),
                         device="cpu")
    got = r.execute(ORDERKEY)
    _assert_rows_equal(got, ref.execute(ORDERKEY), ordered=False)
    assert len(tables) >= 2, tables
    assert tables[0][:2] == (1024, 0)
    for (s0, salt0, hit0), (s1, salt1, _hit1) in zip(tables, tables[1:]):
        assert hit0 and s1 == 2 * s0 and salt1 == salt0 + 1, tables
    assert not tables[-1][2]
    assert _programs(got) == 1


def test_moment_aggregate_declines(ref, port):
    """stddev has no kernel accumulator: a metered AggFunctionShape
    decline, then the torch chain's sort aggregation (its two-pass
    moments over prefix sums in the reference's order: rtol 1e-12)."""
    sql = ("select l_returnflag, stddev(l_quantity) from lineitem "
           "group by l_returnflag")
    before = sk.KERNEL_METRICS.snapshot()["declined"].get(
        "AggFunctionShape", 0)
    got = port.execute(sql)
    after = sk.KERNEL_METRICS.snapshot()["declined"]["AggFunctionShape"]
    assert after == before + 1
    assert _declined(got) == ["kernelDeclinedAggFunctionShape"]
    assert_rows_close(got, ref.execute(sql), ordered=False)
