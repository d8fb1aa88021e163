"""The port's DistributedQueryRunner and BatchQueryRunner
(presto_tpu_torch/exec/runner.py over exec/scheduler.py) on the CPU,
held to the reference:

  * plan_subplan's fragments structurally equal to the reference's
    (host-only planning), the shapes of tests/test_distributed.py among
    them, and plain EXPLAIN's fragments;
  * the query list of tests/test_distributed.py through a broadcast
    runner (n_tasks=2) and a partitioned one (n_tasks=3,
    broadcast_threshold=0), the FULL join of tests/test_queries.py and
    one query under the reference's TINY budget (tasks run one after
    another), each against the reference's numpy oracle
    (LocalQueryRunner.execute_reference);
  * TPC-H Q1-Q22 at sf0.01 against the golden rows wherever the
    reference's distributed runner answers them: every query but Q21 with
    broadcast joins (the reference returns other rows there too, and the
    port's rows equal the reference's: ROADMAP section 3), Q21 through
    partitioned joins;
  * batch mode: an injected failure retries exactly once with equal rows
    and the shuffle files are written; a user error fails fast;
  * lifespan sharding: tasks run shards (0, 2) and (1, 2), and when
    grouped execution declines, shard 0 alone runs the fallback;
  * the repaired fault: plan_distributed runs;
  * the entry points default to the card; a mesh of CPU positions, a
    tracer and a history store are taken (a mesh of card positions on
    a CPU runner raises); PREPARE and DDL fail as in the reference."""
import pytest
import torch

from presto_tpu_torch.benchmarks.rows import golden_result
from presto_tpu_torch.benchmarks.tpch_queries import ALL, ORDERED
from presto_tpu_torch.exec.pipeline import ExecutionConfig, tuned_config
from presto_tpu_torch.exec.runner import (BatchQueryRunner,
                                          DistributedQueryRunner)
from presto_tpu_torch.spi import plan as P
from torch_rows import assert_rows_close
import torch_tpch_golden as golden
from torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-9
TINY = dict(batch_rows=1 << 14, join_out_capacity=1 << 16,
            memory_budget_bytes=200_000, spill_partitions=4)


@pytest.fixture(scope="module")
def runner():
    # broadcast joins (everything under threshold at sf0.01)
    return DistributedQueryRunner("sf0.01", n_tasks=2, device="cpu")


@pytest.fixture(scope="module")
def part_runner():
    # hash-partitioned joins and exchanges everywhere
    return DistributedQueryRunner("sf0.01", n_tasks=3, broadcast_threshold=0,
                                  device="cpu")


@pytest.fixture(scope="module")
def oracle():
    """The reference's numpy oracle rows, one run per query."""
    from presto_tpu.exec.runner import LocalQueryRunner as JRunner
    runner = JRunner("sf0.01")
    memo = {}

    def rows(sql):
        if sql not in memo:
            memo[sql] = runner.execute_reference(sql)
        return memo[sql]
    return rows


def check(r, oracle, sql, ordered=False):
    got = r.execute(sql)
    assert_rows_close(got, oracle(sql), ordered=ordered, rtol=RTOL)
    return got


# ---------------------------------------------------------------------------
# planning: the fragments are the reference's
# ---------------------------------------------------------------------------

def _shape(node):
    """A plan subtree as nested plain data, comparable across packages."""
    attrs = []
    for a in ("step", "distribution", "join_type", "count",
              "source_fragment_ids"):
        v = getattr(node, a, None)
        if v is not None:
            attrs.append((a, str(v)))
    if hasattr(node, "grouping_keys"):
        attrs.append(("keys", [v.name for v in node.grouping_keys]))
    if hasattr(node, "aggregations"):
        attrs.append(("aggs", sorted(
            (v.name, a.call.display_name) for v, a
            in node.aggregations.items())))
    return (type(node).__name__, node.id,
            [v.name for v in node.output_variables], attrs,
            [_shape(s) for s in node.sources])


def _fragments(subplan):
    out = []
    for f in subplan.all_fragments():
        scheme = f.output_partitioning_scheme
        out.append((f.fragment_id, f.partitioning, scheme.handle,
                    [v.name for v in scheme.arguments],
                    [v.name for v in scheme.output_layout], scheme.fabric,
                    sorted(f.dynamic_filter_sources.items()),
                    _shape(f.root)))
    return out


PLAN_CASES = [
    ("select o_orderstatus, count(*) from orders group by o_orderstatus",
     {}),
    ("select n_name, r_name from nation join region "
     "on n_regionkey = r_regionkey", {"broadcast_threshold": 0}),
    ("select n_name, r_name from nation join region "
     "on n_regionkey = r_regionkey", {}),
    ("select count(*), sum(l_quantity), avg(l_extendedprice) "
     "from lineitem", {}),
    ("select o_custkey, o_orderkey, row_number() over (partition by "
     "o_custkey order by o_orderkey) from orders where o_custkey < 200",
     {"broadcast_threshold": 0}),
    ("select n_regionkey k from nation union all select r_regionkey "
     "from region", {"broadcast_threshold": 0}),
    (ALL[3], {}),
    (ALL[18], {}),
    (ALL[9], {"broadcast_threshold": 0}),
]


@pytest.mark.parametrize("i", range(len(PLAN_CASES)))
def test_plan_subplan_equals_the_reference(i):
    from presto_tpu.exec.runner import DistributedQueryRunner as JD
    sql, kw = PLAN_CASES[i]
    jsub = JD("sf0.01", n_tasks=2, **kw).plan_subplan(sql)
    tsub = DistributedQueryRunner("sf0.01", n_tasks=2, device="cpu",
                                  **kw).plan_subplan(sql)
    assert tsub[1] == jsub[1]
    assert [str(t) for t in tsub[2]] == [str(t) for t in jsub[2]]
    assert _fragments(tsub[0]) == _fragments(jsub[0])


def test_plan_distributed_runs_where_it_raised():
    """The fault repaired here: the port's plan_distributed imported
    stage_shards_lifespans and parallel.fabric, which it lacked."""
    from presto_tpu_torch.exec.runner import LocalQueryRunner
    from presto_tpu_torch.sql.fragmenter import plan_distributed
    out = LocalQueryRunner("sf0.01", device="cpu").plan(
        "select o_orderstatus, count(*) from orders group by o_orderstatus")
    sub = plan_distributed(out)
    frags = sub.all_fragments()
    assert len(frags) == 3
    assert {f.fragment_id: f.partitioning for f in frags} == {
        "0": P.SINGLE_DISTRIBUTION, "1": P.FIXED_HASH_DISTRIBUTION,
        "2": P.SOURCE_DISTRIBUTION}
    steps = sorted(n.step for f in frags for n in P.walk_plan(f.root)
                   if isinstance(n, P.AggregationNode))
    assert steps == [P.FINAL, P.PARTIAL]


def test_explain_prints_the_fragments(runner):
    text = runner.execute("explain select o_orderstatus, count(*) from "
                          "orders group by o_orderstatus").rows[0][0]
    assert "Fragment 0 [SINGLE]" in text
    assert "PARTIAL" in text and "FINAL" in text
    assert "RemoteSource" in text and "fabric=http" in text


# ---------------------------------------------------------------------------
# the reference's distributed query list against the oracle
# ---------------------------------------------------------------------------

BROADCAST_QUERIES = {
    "global_agg": ("select count(*), sum(l_quantity), avg(l_extendedprice), "
                   "min(l_discount), max(l_tax) from lineitem", False),
    "group_by": ("select o_orderstatus, count(*), sum(o_totalprice), "
                 "avg(o_totalprice) from orders group by o_orderstatus",
                 False),
    "join_broadcast": ("select n_name, r_name from nation "
                       "join region on n_regionkey = r_regionkey", False),
    "order_by_limit": ("select c_custkey, c_acctbal from customer "
                       "order by c_acctbal desc, c_custkey limit 20", True),
    "tpch_q5": (ALL[5], True),
    "tpch_q6": (ALL[6], False),
}

PARTITIONED_QUERIES = {
    "group_by_high_cardinality": (
        "select l_orderkey, count(*), sum(l_quantity) "
        "from lineitem group by l_orderkey", False),
    "join_partitioned": ("select c_custkey, o_orderkey from customer "
                         "join orders on c_custkey = o_custkey", False),
    "left_join_partitioned": ("""
        select c_custkey, o_orderkey from customer
        left join orders on c_custkey = o_custkey
        where c_custkey < 50""", False),
    "string_group_keys_cross_task": (
        "select c_mktsegment, count(*) from customer "
        "group by c_mktsegment", False),
    "distinct": ("select distinct o_orderstatus from orders", False),
    "tpch_q3": (ALL[3], True),
    "tpch_q5": (ALL[5], True),
    "left_join_empty_build_varchar": ("""
        select c_custkey, o_orderstatus from customer
        left join (select o_custkey, o_orderstatus from orders
                   where o_totalprice < 0) t
        on c_custkey = o_custkey where c_custkey < 5""", False),
    "window_repartitioned": ("""
        select o_custkey, o_orderkey,
               row_number() over (partition by o_custkey order by o_orderkey),
               sum(o_totalprice) over (partition by o_custkey)
        from orders where o_custkey < 200""", False),
    "window_no_partition": ("""
        select c_custkey, rank() over (order by c_acctbal desc)
        from customer where c_custkey < 100""", False),
    "union_all": ("""
        select n_regionkey k from nation
        union all select r_regionkey from region
        union all select o_custkey from orders where o_orderkey < 50""",
                  False),
    "union_distinct": ("""
        select o_orderstatus from orders
        union select o_orderpriority from orders""", False),
    "intersect": ("""
        select n_nationkey from nation
        intersect select c_nationkey from customer where c_custkey < 40""",
                  False),
    # tests/test_queries.py's FULL join through the partitioned runner
    "full_join": ("""
        select a.n_nationkey, b.k from nation a
        full outer join (select n_nationkey + 20 k from nation) b
        on a.n_nationkey = b.k""", False),
}


@pytest.mark.parametrize("name", sorted(BROADCAST_QUERIES))
def test_broadcast_runner_equals_the_oracle(runner, oracle, name):
    sql, ordered = BROADCAST_QUERIES[name]
    check(runner, oracle, sql, ordered)


@pytest.mark.parametrize("name", sorted(PARTITIONED_QUERIES))
def test_partitioned_runner_equals_the_oracle(part_runner, oracle, name):
    sql, ordered = PARTITIONED_QUERIES[name]
    res = check(part_runner, oracle, sql, ordered)
    sched = part_runner.last_scheduler
    hashed = [s for s in sched.stages()
              if s.fragment.output_partitioning_scheme.handle
              == P.FIXED_HASH_DISTRIBUTION]
    moved = sched.stats.to_dict().get("exchangeFabricHttpBytes", {})
    assert (moved.get("sum", 0) > 0) == bool(hashed)
    assert all(s.fabric in (None, "http") for s in sched.stages())
    assert res.peak_memory_bytes >= 0


def test_under_the_tiny_budget_tasks_run_in_turn(oracle):
    """tests/test_spill.py's distributed count under the reference's
    TINY budget, and a partitioned join that spills in its tasks."""
    r = DistributedQueryRunner("sf0.01", n_tasks=2, device="cpu",
                               config=ExecutionConfig(**TINY))
    check(r, oracle, "select count(*) from lineitem")
    sql = ("select o_orderstatus, count(*), sum(l_quantity) from lineitem "
           "join orders on l_orderkey = o_orderkey group by o_orderstatus")
    r = DistributedQueryRunner("sf0.01", n_tasks=2, broadcast_threshold=0,
                               device="cpu", config=ExecutionConfig(**TINY))
    check(r, oracle, sql)
    walls = [s.task_walls for s in r.last_scheduler.stages()
             if s.n_tasks > 1]
    assert walls and all(len(w) == 2 for w in walls)


# ---------------------------------------------------------------------------
# TPC-H against the golden rows
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def golden_doc():
    return golden.load()


@pytest.mark.parametrize("q", [q for q in sorted(ALL) if q != 21])
def test_tpch_equals_the_golden_rows(runner, golden_doc, q):
    ent = golden_doc["queries"][str(q)]
    res = runner.execute(ALL[q])
    assert list(res.column_names) == ent["columns"]
    assert_rows_close(res, golden_result(ent), ordered=q in ORDERED,
                      rtol=RTOL)
    st = runner.last_scheduler.stages()
    assert len(st) >= 2 and st[0].fragment.partitioning == \
        P.SINGLE_DISTRIBUTION


def test_tpch_q21_partitioned_equals_the_golden_rows(part_runner,
                                                     golden_doc):
    ent = golden_doc["queries"]["21"]
    assert_rows_close(part_runner.execute(ALL[21]), golden_result(ent),
                      ordered=True, rtol=RTOL)


# ---------------------------------------------------------------------------
# batch mode
# ---------------------------------------------------------------------------

Q_JOIN_AGG = """
select o_orderstatus, count(*) c, sum(l_quantity) q
from lineitem join orders on l_orderkey = o_orderkey
where l_shipdate > date '1995-03-15'
group by o_orderstatus
"""


def test_batch_mode_retries_once_from_the_shuffle_files(oracle, tmp_path):
    seen = []

    def inject(fragment_id, task_index, attempt):
        if task_index == 0 and fragment_id != "0":
            seen.append((fragment_id, attempt))
            if attempt == 0 and len(seen) == 1:
                raise RuntimeError("injected executor loss")

    cfg = ExecutionConfig(batch_rows=1 << 13, join_out_capacity=1 << 15)
    r = BatchQueryRunner("sf0.01", config=cfg, n_tasks=2, task_retries=2,
                         temp_dir=str(tmp_path), fault_injector=inject,
                         device="cpu")
    check(r, oracle, Q_JOIN_AGG)
    failed = seen[0][0]
    assert [a for f, a in seen if f == failed] == [0, 1]
    files = list(tmp_path.rglob("*.shuffle"))
    assert len(files) >= 2 and any(f.stat().st_size > 0 for f in files)


def test_batch_mode_user_error_fails_fast():
    from presto_tpu_torch.common.errors import is_retryable
    calls = []

    def user_bug(fragment_id, task_index, attempt):
        calls.append(attempt)
        raise ValueError("user's input is malformed")

    assert not is_retryable(ValueError("x"))
    r = BatchQueryRunner("sf0.01", n_tasks=2, task_retries=3,
                         fault_injector=user_bug, device="cpu")
    with pytest.raises(ValueError, match="malformed"):
        r.execute("select count(*) from nation")
    assert calls and max(calls) == 0


def test_batch_mode_retries_exhausted_fail_the_query():
    def always_fail(fragment_id, task_index, attempt):
        raise RuntimeError("permanent task failure")
    r = BatchQueryRunner("sf0.01", n_tasks=2, task_retries=1,
                         fault_injector=always_fail, device="cpu")
    with pytest.raises(RuntimeError, match="permanent task failure"):
        r.execute("select count(*) from nation")


# ---------------------------------------------------------------------------
# lifespan sharding
# ---------------------------------------------------------------------------

Q3 = ALL[3]


def test_lifespan_sharding_runs_disjoint_shards(monkeypatch, oracle):
    from presto_tpu_torch.exec import grouped as G
    shards = []
    orig = G.GroupedRunner.run

    def spy(self):
        shards.append(self.compiler.ctx.grouped_shard)
        return orig(self)
    monkeypatch.setattr(G.GroupedRunner, "run", spy)
    r = DistributedQueryRunner("sf0.01", n_tasks=2, device="cpu",
                               config=tuned_config(grouped_lifespans=4))
    check(r, oracle, Q3, ordered=True)
    assert sorted(s for s in shards if s is not None) == [(0, 2), (1, 2)]
    sharded = [s for s in r.last_scheduler.stages()
               if s.task_shards and s.task_shards[0] is not None]
    assert [s.task_shards for s in sharded] == [[(0, 2), (1, 2)]]


def test_sharded_fallback_when_grouped_declines(monkeypatch, oracle):
    from presto_tpu_torch.exec import grouped as G
    monkeypatch.setattr(G, "make_grouped_runner", lambda *a, **k: None)
    r = DistributedQueryRunner("sf0.01", n_tasks=2, device="cpu",
                               config=tuned_config(grouped_lifespans=4))
    check(r, oracle, Q3, ordered=True)
    assert [s.task_shards for s in r.last_scheduler.stages()
            if s.task_shards[0] is not None] == [[(0, 2), (1, 2)]]


# ---------------------------------------------------------------------------
# what raises
# ---------------------------------------------------------------------------

def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DistributedQueryRunner("sf0.01")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BatchQueryRunner("sf0.01")


def test_unported_options_raise_naming_what_is_missing(runner):
    """The mesh, the tracer provider and the history store are ported:
    each is taken and used; a mesh of card positions on a CPU runner
    raises naming the device."""
    from presto_tpu_torch.parallel.mesh import make_mesh
    from presto_tpu_torch.telemetry import QueryHistoryStore
    from presto_tpu_torch.utils.runtime_stats import TracerProvider
    with pytest.raises(ValueError, match="not on the runner's device"):
        DistributedQueryRunner("sf0.01", device="cpu",
                               mesh=make_mesh(devices=["cuda:0"] * 2))
    mesh = make_mesh(devices=["cpu"] * 2)
    provider, hist = TracerProvider("simple"), QueryHistoryStore()
    sql = "select n_regionkey, count(*) from nation group by n_regionkey"
    r = DistributedQueryRunner("sf0.01", device="cpu", mesh=mesh,
                               tracer_provider=provider, history=hist)
    assert sorted(r.execute(sql).rows) == [[i, 5] for i in range(5)]
    assert r.mesh is mesh
    assert provider.get_trace(sql).span_children("")[0].name == "query"
    (rec,) = hist.list()
    assert rec["aggGroups"] == 5 and rec["planTemplate"]
    # ported since: a PREPARE reaches the planner and raises there, and a
    # DROP of an unknown table raises, both as in the reference's
    # distributed runner
    from presto_tpu.exec.runner import DistributedQueryRunner as JD
    jrunner = JD("sf0.01", n_tasks=2)
    for r in (runner, jrunner):
        with pytest.raises(AttributeError, match="'Prepare' object"):
            r.execute("prepare p from select count(*) from nation")
        with pytest.raises(KeyError, match="non-droppable table 't'"):
            r.execute("drop table t")


def test_remote_batches_raise_naming_the_ici_fabric():
    """Device batches wired as a remote source's input (the ici fabric's
    TaskContext.remote_batches) are consumed as they are, and the host
    pages are not read."""
    from presto_tpu_torch.exec.batch import Batch, Column
    from presto_tpu_torch.exec.pipeline import PlanCompiler, TaskContext
    from presto_tpu_torch.common.types import BIGINT
    from presto_tpu_torch.spi.plan import Variable
    node = P.RemoteSourceNode("rs", ["1"], [Variable("x", BIGINT)])
    ctx = TaskContext(device=torch.device("cpu"))
    chunk = Batch({"x": Column(torch.arange(4))},
                  torch.tensor([True, False, True, True]))
    ctx.remote_batches["rs"] = lambda: iter([chunk])

    def no_pages():
        raise AssertionError("the page path was read")
    ctx.remote_pages["rs"] = no_pages
    src = PlanCompiler(ctx).compile(node)
    (got,) = list(src.batches())
    assert got is chunk


def test_local_exchange_node_renames_its_inputs():
    """A local ExchangeNode with several sources concatenates them, each
    renamed positionally onto the scheme's layout."""
    from presto_tpu_torch.exec.pipeline import PlanCompiler, TaskContext
    from presto_tpu_torch.common.types import BIGINT
    from presto_tpu_torch.spi.expr import ConstantExpression
    from presto_tpu_torch.spi.plan import Variable
    a, b, o = (Variable(n, BIGINT) for n in ("a", "b", "o"))

    def lit(v):
        return [ConstantExpression(v, BIGINT)]
    va = P.ValuesNode("va", [a], [lit(1), lit(2)])
    vb = P.ValuesNode("vb", [b], [lit(3)])
    ex = P.ExchangeNode("ex", P.GATHER, P.LOCAL,
                        P.PartitioningScheme(P.SINGLE_DISTRIBUTION, [], [o]),
                        [va, vb], [[a], [b]])
    src = PlanCompiler(TaskContext(device=torch.device("cpu"))).compile(ex)
    got = [int(v) for bt in src.batches()
           for v in bt.columns["o"].values[bt.mask]]
    assert got == [1, 2, 3]


def test_final_aggregation_over_many_exchange_rows_aggregates_by_sort():
    """A FINAL aggregation over an exchange has no plan estimate.  The
    reference's hashed table starts at agg_slots there and doubles with a
    new salt per retry: on the 75,000-odd orderkeys of each of two FINAL
    tasks at sf0.1 every table of that schedule leaves a key unplaced, so
    the reference raises "collision retries exhausted".  Shown on the
    host: the reference's plan and its table sizing inputs, and the
    port's agg_update (bit for bit the reference's) over each task's keys
    in one batch.  The port reads the rows its exchange input holds
    (TaskContext.remote_rows): more than half of agg_slots, so each FINAL
    task aggregates by sort, with the oracle's rows (ROADMAP section 3).
    A FINAL fed a few rows hashes into agg_slots, as the reference's."""
    import numpy as np
    from presto_tpu.exec.pipeline import ExecutionConfig as JConfig
    from presto_tpu.exec.runner import DistributedQueryRunner as JD
    from presto_tpu.exec.runner import LocalQueryRunner as JRunner
    from presto_tpu.sql.stats import StatsCalculator as JStats
    from presto_tpu.spi import plan as JP
    from presto_tpu_torch.common.block import FixedWidthBlock
    from presto_tpu_torch.common.page import Page
    from presto_tpu_torch.common.types import BIGINT
    from presto_tpu_torch.exec import operators as ops
    from presto_tpu_torch.exec.batch import Batch, Column
    from presto_tpu_torch.exec.scheduler import partition_targets
    sql = ("select l_orderkey, sum(l_quantity), count(*) from lineitem "
           "group by l_orderkey")

    def nodes(n):
        yield n
        for c in n.sources:
            yield from nodes(c)
    jsub = JD("sf0.1", n_tasks=2).plan_subplan(sql)[0]
    finals = [n for f in jsub.all_fragments() for n in nodes(f.root)
              if isinstance(n, JP.AggregationNode) and n.step == JP.FINAL]
    assert len(finals) == 1 and not JStats().rows(finals[0])
    want = JRunner("sf0.1").execute_reference(sql)
    keys = np.array([r[0] for r in want.rows], dtype=np.int64)
    targets = partition_targets(Page([FixedWidthBlock(keys)], len(keys)),
                                [BIGINT], [0], 2)
    jcfg, cpu = JConfig(), torch.device("cpu")
    specs = (ops.AggSpec("count_star", "c"),)
    for task in range(2):
        col = Column(torch.from_numpy(keys[targets == task]))
        batch = Batch({"k": col}, torch.ones(len(col.values),
                                             dtype=torch.bool))
        for attempt in range(jcfg.max_agg_retries):
            slots = jcfg.agg_slots << attempt
            state = ops.agg_update(
                ops.agg_init(slots, specs, ("k",), [torch.int64], cpu),
                batch, [col], {"c": None}, specs, slots, attempt, ("k",))
            assert bool(state["__collision"]), (task, slots)

    got = DistributedQueryRunner("sf0.1", n_tasks=2, device="cpu") \
        .execute(sql)
    assert got.runtime_stats["exchangeSortAggregation"]["sum"] == 2
    assert_rows_close(got, want, ordered=False, rtol=RTOL)

    few = ("select l_returnflag, l_linestatus, count(*), sum(l_quantity) "
           "from lineitem group by l_returnflag, l_linestatus")
    got = DistributedQueryRunner("sf0.01", n_tasks=2, device="cpu") \
        .execute(few)
    assert got.runtime_stats["torchStreamingAggregation"]["sum"] >= 2
    assert "exchangeSortAggregation" not in got.runtime_stats
    assert_rows_close(got, JRunner("sf0.01").execute_reference(few),
                      ordered=False, rtol=RTOL)
