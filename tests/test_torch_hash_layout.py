"""The hash kernel's on-chip layout (csrc/scan_grouped.cu), on the CPU.

- build_scan_plan's grouped layout: which slot counts keep their tables in
  shared memory (ScanPlan.layout), the bytes of those tables and of the
  rest of the layout against a hand count, and the device-memory path
  past the fit -- on the plans of H1, H2, J1, HASH_F and COLLIDE.
- The reduce's fixed order (grouped.reduce_partials) against a
  brute-force fold of per-CTA partials.
- scan_hash_plain, which the CPU runs for the hash kernel, still equal to
  the reference's interpret-mode hash kernel on H1, H2, J1 and the
  collision query at sf0.01; the collision loop doubles the table."""
import numpy as np
import pytest
import torch

from presto_tpu.exec.pipeline import tuned_config as jtuned
from presto_tpu.exec.runner import LocalQueryRunner as JRunner
from presto_tpu.exec.runner import _assert_rows_equal
from presto_tpu.serving import PlanCache as JPlanCache
from presto_tpu_torch.benchmarks.grouped_queries import H1, H2
from presto_tpu_torch.benchmarks.hash_split import COLLIDE, HASH_F
from presto_tpu_torch.benchmarks.join_queries import J1
from presto_tpu_torch.exec import operators as ops
from presto_tpu_torch.exec import pipeline
from presto_tpu_torch.exec.kernels import grouped as gk
from presto_tpu_torch.exec.kernels import scan_kernel as sk
from presto_tpu_torch.exec.runner import LocalQueryRunner
from presto_tpu_torch.sql.stats import StatsCalculator
from torch_threads import one_torch_thread  # noqa: F401

QUERIES = {"h1": H1, "h2": H2, "j1": J1, "hash_f": HASH_F,
           "collide": COLLIDE}


def _hash_calls(sql, monkeypatch, stats_rows=None):
    """Every scan_hash call of one port run at sf0.01 on the CPU."""
    calls = []
    real = gk.scan_hash

    def rec(*a, **kw):
        calls.append((a, kw))
        return real(*a, **kw)
    monkeypatch.setattr(gk, "scan_hash", rec)
    if stats_rows is not None:
        monkeypatch.setattr(StatsCalculator, "rows",
                            lambda self, node: stats_rows)
    res = LocalQueryRunner("sf0.01", device="cpu").execute(sql)
    return res, calls


def _hand_smem(plan, threads=None):
    """The grouped layout's shared memory outside the tables, by hand:
    the staged plan, the CTA's and each thread's row counters, the stack
    (ROWS_PER_THREAD values and a 4-byte null mask per slot), the warps'
    float staging, each probe step's build rows, hit and null masks, and
    one int per integer row."""
    rpt = sk.ROWS_PER_THREAD
    depth = int(plan.words[12])
    per_thread = (8 * (1 + plan.n_steps) + 8 * depth * rpt + 4 * depth
                  + len(plan.joins) * (4 * rpt + 4 + 4)
                  + (16 * rpt if plan.n_f else 0))
    return (8 * (len(plan.words) + 1 + plan.n_steps) + 4 * plan.n_i
            + per_thread * (threads or plan.threads))


def _ring(plan, columns, threads):
    """The double mode's reserved ring and stage table at `threads`, by
    hand: two stages of a tile of each array the plan stages plus 16
    bytes, 16-byte aligned, a full and an empty 8-byte mbarrier per stage,
    one word per column and the producer's 128-byte state; nothing when
    the plan stages nothing."""
    staged = plan.staging(columns).staged
    if not staged:
        return 0
    tile = sk.ROWS_PER_THREAD * threads
    stage = sum(-(-(tile * columns[c].arrays[0].element_size() + 16) // 16)
                * 16 for c in staged)
    return 2 * (stage + 16) + 8 * len(columns) + 128


# folded integer rows (the counts equal to __seen are copied) and float
# rows of each query's plan
EXPECTED_ROWS = {"h1": (2, 0), "h2": (1, 1), "j1": (2, 0),
                 "hash_f": (3, 2), "collide": (2, 1)}


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_hash_layout_against_a_hand_count(name, monkeypatch):
    _res, calls = _hash_calls(QUERIES[name], monkeypatch)
    plan, columns = calls[-1][0][:2]
    assert plan.mode == "hash"
    assert (plan.n_fold, plan.n_f) == EXPECTED_ROWS[name]
    assert plan.smem_bytes == _hand_smem(plan)
    assert plan.ring_reserve == _ring(plan, columns, plan.threads)
    slot_bytes = 8 * (1 + plan.n_fold + plan.n_f)      # mirror + rows

    def room(threads):
        return (sk.MAX_SMEM_BYTES - _hand_smem(plan, threads)
                - _ring(plan, columns, threads) - 8 * sk.MAX_PARAMS)
    assert plan.onchip_slots == room(plan.threads) // slot_bytes
    warps = plan.threads // 32
    if plan.n_f:        # the float rows once per warp where they fit
        assert plan.warp_float_slots == room(plan.threads) // (
            slot_bytes + 8 * plan.n_f * (warps - 1))
    # the widest CTA whose table holds the first table (the first call's
    # slot count), or THREADS
    first = calls[0][0][5]
    fits = [t for t in range(sk.THREADS, sk.HASH_MAX_THREADS + 1, 32)
            if room(t) >= first * slot_bytes]
    assert plan.threads == max(fits, default=sk.THREADS)
    # the largest table that fits is on chip, one slot more is not
    s = plan.onchip_slots
    assert plan.layout(s).on_chip and not plan.layout(s + 1).on_chip
    assert plan.layout(s).table_bytes == s * slot_bytes
    assert plan.layout(s + 1).table_bytes == 0
    # and the double mode's ring still fits beside the largest table
    assert (plan.smem_bytes + plan.layout(s).table_bytes
            + plan.ring_reserve
            + 8 * sk.MAX_PARAMS) <= sk.MAX_SMEM_BYTES


def test_which_tables_stay_on_chip(monkeypatch):
    """At the first table size (agg_slots = 4096 slots) H1, H2 and J1 keep
    their tables on chip in CTAs wider than THREADS; HASH_F's five rows
    per slot and the mirror do not fit beside its layout; the collision
    loop's first table does, its doubled ones do not."""
    got = {}
    for name in ("h1", "h2", "j1", "hash_f"):
        _res, calls = _hash_calls(QUERIES[name], monkeypatch)
        a = calls[-1][0]
        got[name] = (a[0].layout(a[5]).on_chip, a[0].threads > sk.THREADS)
        assert a[5] == pipeline.ExecutionConfig().agg_slots
    assert got == {"h1": (True, True), "h2": (True, True),
                   "j1": (True, True), "hash_f": (False, False)}
    _res, calls = _hash_calls(COLLIDE, monkeypatch, stats_rows=1.0)
    slots = [a[5] for a, _kw in calls]
    assert slots == [4096, 8192, 16384]
    assert [calls[0][0][0].layout(s).on_chip for s in slots] == \
        [True, False, False]


SPAN_FLOAT = ("select l_returnflag, l_linestatus, l_shipmode, "
              "l_shipinstruct, sum(cast(l_extendedprice as double)) as s, "
              "max(cast(l_discount as double)) as mx, count(*) as n "
              "from lineitem group by 1, 2, 3, 4")


def test_small_tables_keep_a_float_table_per_warp(monkeypatch):
    """Span mode's 168 slots hold a float table per warp beside the
    integer rows (no CTA barrier); H2's 4096 slots hold one per CTA."""
    calls = []
    real = gk.scan_span

    def rec(*a, **kw):
        calls.append(a)
        return real(*a, **kw)
    monkeypatch.setattr(gk, "scan_span", rec)
    LocalQueryRunner("sf0.01", device="cpu").execute(SPAN_FLOAT)
    plan = calls[-1][0]
    warps = plan.threads // 32
    assert plan.mode == "span" and plan.G == 168 and plan.n_f == 2
    assert plan.layout(168).on_chip and plan.layout(168).warp_floats
    assert plan.layout(168).table_bytes == \
        8 * 168 * (plan.n_fold + warps * 2)
    _res, hcalls = _hash_calls(H2, monkeypatch)
    h2 = hcalls[-1][0][0]
    assert h2.layout(4096).on_chip and not h2.layout(4096).warp_floats
    assert h2.layout(4096).table_bytes == \
        8 * 4096 * (h2.n_fold + 1 + h2.n_f)


def test_reservation_counts_per_cta_partials(monkeypatch):
    """On chip a launch's partials are each CTA's folded integer and float
    tables, one CTA per SM for a hash table: its CTA takes the threads of
    two, and its table leaves no room for another."""
    from types import SimpleNamespace
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda _d: SimpleNamespace(multi_processor_count=132))
    _res, calls = _hash_calls(H2, monkeypatch)
    a = calls[-1][0]
    plan, grid, br, slots = a[0], a[2], a[3], a[5]
    per_sm = plan.layout(slots).ctas_per_sm
    assert plan.layout(slots).on_chip and per_sm == 1
    need = (plan.smem_bytes + plan.layout(slots).table_bytes
            + plan.ring_reserve
            + 8 * sk.MAX_PARAMS + sk.SMEM_RESERVED_PER_CTA)
    assert sk.SMEM_PER_SM // need == 1 \
        and sk.RESIDENT_THREADS // plan.threads == 1
    n_ctas = min(len(grid) * -(-br // min(br, sk.GROUPED_SUBTILE_ROWS)),
                 per_sm * 132)
    assert gk.partial_bytes(plan, len(grid), br, slots,
                            SimpleNamespace(type="cuda")) \
        == 8 * n_ctas * (plan.n_fold + plan.n_f) * slots


# -- the reduce's order ------------------------------------------------------

def _brute(parts, op, init):
    acc = torch.full(parts.shape[1:], init, dtype=parts.dtype)
    for p in parts:
        if op == sk._R_ADD:
            acc = acc + p
        elif op == sk._R_MIN:
            acc = torch.minimum(acc, p)
        else:
            acc = torch.maximum(acc, p)
    return acc


@pytest.mark.parametrize("n_parts", [1, 5, 8, 13, 132, 264])
@pytest.mark.parametrize("op", [sk._R_ADD, sk._R_MIN, sk._R_MAX],
                         ids=["add", "min", "max"])
def test_reduce_matches_a_brute_force_fold(n_parts, op):
    rng = np.random.default_rng(n_parts * 3 + op)
    ints = torch.from_numpy(rng.integers(-2 ** 40, 2 ** 40,
                                         (n_parts, 64)).astype(np.int64))
    init_i = {sk._R_ADD: 0, sk._R_MIN: ops.INT64_MAX,
              sk._R_MAX: ops.INT64_MIN}[op]
    assert torch.equal(gk.reduce_partials(ints, op, init_i),
                       _brute(ints, op, init_i))
    flts = torch.from_numpy(rng.normal(0, 1e6, (n_parts, 64)))
    init_f = {sk._R_ADD: 0.0, sk._R_MIN: float("inf"),
              sk._R_MAX: float("-inf")}[op]
    got, want = gk.reduce_partials(flts, op, init_f), _brute(flts, op, init_f)
    if op == sk._R_ADD:
        exact = flts.abs().sum(0)
        assert bool(((got - want).abs() <= 1e-12 * exact).all())
    else:
        assert torch.equal(got, want)


def test_reduce_order_is_the_fixed_tree():
    """Partials whose sum depends on the order: each of the eight
    sequences folds b = lane, lane + 8, ...; then ((0 1) (2 3)) ((4 5)
    (6 7)); the initial value first."""
    vals = [1e16, 1.0, -1e16, 1.0, 3.0, -1e16, 1e16, 1.0,
            1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 2.0]
    parts = torch.tensor(vals, dtype=torch.float64)[:, None]
    lanes = [0.0] * 8
    for b, x in enumerate(vals):
        lanes[b % 8] = lanes[b % 8] + x
    want = 0.0 + (((lanes[0] + lanes[1]) + (lanes[2] + lanes[3]))
                  + ((lanes[4] + lanes[5]) + (lanes[6] + lanes[7])))
    got = gk.reduce_partials(parts, sk._R_ADD, 0.0)
    assert got.item() == want
    assert got.item() != sum(vals)          # another order, another sum
    nan = torch.tensor([[1.0], [float("nan")], [3.0]], dtype=torch.float64)
    assert torch.isnan(gk.reduce_partials(nan, sk._R_MIN, float("inf")))


# -- the plain version against the reference's hash kernel -------------------

@pytest.fixture(scope="module")
def ref():
    return JRunner("sf0.01", config=jtuned(scan_kernel="pallas"),
                   plan_cache=JPlanCache())


def _programs(res) -> int:
    return int((res.runtime_stats or {}).get(
        "kernelScanPrograms", {}).get("sum", 0))


@pytest.mark.parametrize("name", ["h1", "h2", "j1", "collide"])
def test_plain_hash_equals_the_reference_kernel(ref, monkeypatch, name):
    exp = ref.execute(QUERIES[name])
    got, calls = _hash_calls(QUERIES[name], monkeypatch,
                             stats_rows=1.0 if name == "collide" else None)
    _assert_rows_equal(got, exp, ordered=False)
    assert _programs(exp) == 1 and _programs(got) == 1
    assert calls and all(a[0].mode == "hash" for a, _kw in calls)
    if name == "collide":     # the loop doubled the table with a new salt
        assert [(a[5], a[6]) for a, _kw in calls] == \
            [(4096, 0), (8192, 1), (16384, 2)]
