"""The join slice's gates and reservations on the CPU: shapes kernel #5
does not run decline with kernelDeclinedJoinShape, build operands over the
byte cap or a failed operand reservation with kernelDeclinedJoinBuildSize
-- each where the reference package declines the same reason -- and the
port then runs the torch fused chain, whose rows equal the reference's.
Reservations are freed on every path.
The reference's randomized join queries (seeds 21-25) return the same
rows through both packages, one kernel program each."""
import pytest

from presto_tpu.exec.kernels import join as jjoin
from presto_tpu.exec.pipeline import tuned_config as jtuned
from presto_tpu.exec.runner import LocalQueryRunner as JRunner
from presto_tpu.exec.runner import _assert_rows_equal
from presto_tpu.serving import PlanCache as JPlanCache
from presto_tpu_torch.benchmarks import join_queries as JQ
from presto_tpu_torch.exec import memory as tmem
from presto_tpu_torch.exec.kernels import join as tjoin
from presto_tpu_torch.exec.kernels import scan_kernel as sk
from presto_tpu_torch.exec.runner import LocalQueryRunner
from presto_tpu_torch.spi import plan as TP
from torch_rows import assert_rows_close
from torch_threads import one_torch_thread  # noqa: F401

JOIN_SHAPE = {
    # LEFT join onto a build whose keys repeat: fanout-k
    "fanout": ("select count(*), sum(ps_availqty) from supplier left join "
               "(select ps_suppkey, ps_availqty from partsupp "
               "where ps_availqty < 2000) p on s_suppkey = p.ps_suppkey"),
    # a residual ON predicate beyond the equi-criteria
    "residual_on_filter": ("select count(*) from lineitem join orders on "
                           "l_orderkey = o_orderkey "
                           "and l_shipdate > o_orderdate"),
    # a gathered build column that is dictionary-coded
    "dictionary_column": ("select c_mktsegment, count(*) from customer, "
                          "orders where c_custkey = o_custkey "
                          "group by c_mktsegment"),
}


def _programs(res) -> int:
    return int((res.runtime_stats or {}).get(
        "kernelScanPrograms", {}).get("sum", 0))


def _declined(res):
    return {k[len("kernelDeclined"):]: int(v.get("sum", 0))
            for k, v in (res.runtime_stats or {}).items()
            if k.startswith("kernelDeclined")}


@pytest.fixture(scope="module")
def ref():
    return JRunner("sf0.01", config=jtuned(scan_kernel="pallas"),
                   plan_cache=JPlanCache())


@pytest.fixture(scope="module")
def port():
    return LocalQueryRunner("sf0.01", device="cpu")


def _declines(port, sql, reason, exp):
    """One metered decline of `reason`, then the torch chain's rows equal
    the reference's `exp` (floats rtol 1e-12)."""
    before = sk.KERNEL_METRICS.snapshot()["declined"].get(reason, 0)
    got = port.execute(sql)
    assert sk.KERNEL_METRICS.snapshot()["declined"][reason] == before + 1
    assert _declined(got) == {reason: 1} and _programs(got) == 0
    assert_rows_close(got, exp, ordered=False)


@pytest.mark.parametrize("case", sorted(JOIN_SHAPE))
def test_join_shape_declines_like_the_reference(ref, port, case):
    sql = JOIN_SHAPE[case]
    exp = ref.execute(sql)
    assert _declined(exp) == {"JoinShape": 1}
    _declines(port, sql, "JoinShape", exp)


@pytest.mark.parametrize("case", ["residual_on_filter", "fanout"])
def test_layout_gates_decline_join_shape(case):
    """plan_join_layout alone (the reference's unit form of the gate)."""
    class _Node:
        filter = object() if case == "residual_on_filter" else None
    reasons = []
    expands = (2,) if case == "fanout" else (1,)
    plan = tjoin.plan_join_layout([("join", _Node())], (None, object()),
                                  expands, reasons.append)
    assert plan is None and reasons == ["JoinShape"]


def test_build_size_cap_declines_like_the_reference(monkeypatch):
    monkeypatch.setattr(jjoin, "KERNEL_JOIN_MAX_BUILD_BYTES", 64)
    monkeypatch.setattr(tjoin, "KERNEL_JOIN_MAX_BUILD_BYTES", 64)
    res = JRunner("sf0.01", config=jtuned(scan_kernel="pallas"),
                  plan_cache=JPlanCache()).execute(JQ.Q3_SHAPE)
    assert _programs(res) == 0 and _declined(res) == {"JoinBuildSize": 1}
    _declines(LocalQueryRunner("sf0.01", device="cpu"), JQ.Q3_SHAPE,
              "JoinBuildSize", res)


def _watch_reservations(monkeypatch, refuse_operands: bool):
    """Record every MemoryContext reservation and the join layouts' operand
    bytes; with refuse_operands the operand reservation fails."""
    layouts, calls = [], []
    real_layout = tjoin.plan_join_layout

    def layout(*a, **kw):
        out = real_layout(*a, **kw)
        layouts.append(out.nbytes)
        return out
    real_reserve = tmem.MemoryContext.try_reserve

    def try_reserve(self, n):
        calls.append((self, n))
        if refuse_operands and n == layouts[-1]:
            return False
        return real_reserve(self, n)
    monkeypatch.setattr(tjoin, "plan_join_layout", layout)
    monkeypatch.setattr(tmem.MemoryContext, "try_reserve", try_reserve)
    return layouts, calls


@pytest.mark.parametrize("sql", [JQ.J2, JQ.J3, JQ.J1],
                         ids=["direct", "span", "hash"])
def test_failed_operand_reservation_declines(ref, monkeypatch, sql):
    exp = ref.execute(sql)
    layouts, calls = _watch_reservations(monkeypatch, refuse_operands=True)
    _declines(LocalQueryRunner("sf0.01", device="cpu"), sql,
              "JoinBuildSize", exp)
    assert layouts and layouts[-1] > 0
    # the operand reservation was asked for (and refused); the torch
    # chain's span / hash reservations after it are freed too
    assert layouts[-1] in [n for _c, n in calls]
    assert all(c.reserved == 0 for c, _n in calls)


@pytest.mark.parametrize("sql", [JQ.J2, JQ.J3, JQ.J1],
                         ids=["direct", "span", "hash"])
def test_operand_reservation_is_freed(monkeypatch, sql):
    layouts, calls = _watch_reservations(monkeypatch, refuse_operands=False)
    LocalQueryRunner("sf0.01", device="cpu").execute(sql)
    assert layouts[-1] in [n for _c, n in calls]
    assert all(c.reserved == 0 for c, _n in calls)


@pytest.mark.parametrize("seed", [21, 22, 23, 24, 25])
def test_join_parity_fuzz(ref, port, seed):
    sql = JQ.join_fuzz_sql(seed)
    exp = ref.execute(sql)
    got = port.execute(sql)
    _assert_rows_equal(got, exp, ordered=False)
    assert _programs(got) == 1 and _programs(exp) == 1, sql
    assert not _declined(got) and not _declined(exp), sql


def test_uid_step_is_not_ported():
    """The torch fused chain carries AssignUniqueId as its uid step; the
    scan kernels do not run it, so a chain holding one declines
    PlanShape."""
    class _Chain:
        steps = [("filter", None), ("uid", TP.AssignUniqueIdNode(
            "uid", None, None))]
    seen = []
    assert sk.chain_eligible(_Chain, seen.append) is None
    assert seen == ["PlanShape"]


def test_semi_join_outside_an_aggregation_raises(ref, port):
    """The streaming SemiJoin is ported: a semi join whose rows are
    returned streams the fused chain and equals the reference."""
    sql = ("select l_orderkey from lineitem where l_suppkey in "
           "(select s_suppkey from supplier where s_nationkey = 7)")
    assert_rows_close(port.execute(sql), ref.execute(sql), ordered=False)
