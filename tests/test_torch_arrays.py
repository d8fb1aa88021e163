"""ARRAY columns, UNNEST and the array functions in the port
(presto_tpu_torch/exec/batch.py Column.lengths, exec/lowering.py
ArrayNode, exec/pipeline.py _compile_UnnestNode), held to the JAX package
on the CPU at sf0.01:

  * the array / Unnest statements of tests/test_queries.py and the
    repeat clamps of tests/test_functions.py through both packages'
    LocalQueryRunner: integers and decimals exactly, doubles within
    rtol 1e-12;
  * each array function against the reference's Lowering.eval over
    padded element matrices made from a seed with numpy (out-of-bounds
    and negative subscripts, empty and NULL arrays, padding past the
    lengths), and the reference's raises (NULL elements, string
    elements, non-constant counts);
  * lengths carried by compact, _concat, TopN, a join's output, the
    page boundary (batch_to_page / pages_to_batches, the serialized
    bytes equal to the reference's), an exchange of DistributedQueryRunner
    with 2 tasks, the TINY memory budget and grouped lifespans: the
    reference's rows, or the reference's raise.  A LEFT join's
    null-extended rows carry the array where the reference drops its
    lengths and raises (ROADMAP section 3): the port is held to the
    reference's numpy oracle there;
  * an ARRAY output column through the statement server;
  * the chip phase's array queries (U1-U4) at sf0.01 against the
    reference and against their array-free twins;
  * the scan kernels' decline of an array chain: the port meters
    PlanShape (ARR lies past KERNEL_OPS); the reference's Pallas kernel
    traces the array forms and launches (ROADMAP section 3)."""
import numpy as np
import pytest
import torch

import presto_tpu.common.types as JT
import presto_tpu.spi.expr as JE
from presto_tpu.common.serde import serialize_page as jserialize
from presto_tpu.exec.batch import Batch as JBatch, Column as JColumn
from presto_tpu.exec.batch import batch_to_page as jbatch_to_page
from presto_tpu.exec.lowering import Lowering as JLowering
from presto_tpu.exec.pipeline import ExecutionConfig as JConfig
from presto_tpu.exec.pipeline import tuned_config as jtuned
from presto_tpu.exec.runner import DistributedQueryRunner as JDist
from presto_tpu.exec.runner import LocalQueryRunner as JRunner
from presto_tpu.serving import PlanCache as JPlanCache
import presto_tpu_torch.common.types as TT
import presto_tpu_torch.spi.expr as TE
from presto_tpu_torch.benchmarks import array_queries as AQ
from presto_tpu_torch.common.serde import serialize_page
from presto_tpu_torch.exec import operators as ops
from presto_tpu_torch.exec.batch import (Batch, Column, batch_to_page,
                                         pages_to_batches)
from presto_tpu_torch.exec.lowering import Lowering
from presto_tpu_torch.exec.pipeline import ExecutionConfig, _concat
from presto_tpu_torch.exec.runner import (DistributedQueryRunner,
                                          LocalQueryRunner)
from torch_rows import assert_rows_close
from torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-12
TINY = dict(batch_rows=1 << 14, join_out_capacity=1 << 16,
            memory_budget_bytes=200_000, spill_partitions=4)

# tests/test_queries.py's array / Unnest statements (ordered or not)
STATEMENTS = [
    ("select array[1, 2, 3][2], array[10, 20][1]", False),
    ("select array[n_nationkey, n_regionkey][1] from nation "
     "where n_nationkey < 5", False),
    ("select cardinality(array[1,2,3]), element_at(array[10,20], 2), "
     "element_at(array[10,20], 7)", False),
    ("select contains(array[1,2,3], n_regionkey), "
     "array_max(array[n_nationkey, n_regionkey]), "
     "array_min(array[n_nationkey, n_regionkey]), "
     "array_position(array[2,4,6], n_regionkey * 2) from nation", False),
    ("select x from unnest(array[3,1,2]) as u(x)", False),
    ("select x from unnest(sequence(1, 6)) as u(x) where x % 2 = 0", False),
    ("select x, y from unnest(array[1,2], array[10,20,30]) as u(x, y)",
     False),
    ("""select n_name, x, i from nation
        cross join unnest(array[n_nationkey, n_regionkey])
            with ordinality as u(x, i)
        where n_nationkey < 5 order by n_name, i""", True),
    ("""select sum(x), count(*) from nation
        cross join unnest(array[n_nationkey, n_regionkey, 7]) as u(x)""",
     False),
    ("select n_name, array[n_nationkey, n_regionkey] "
     "from nation where n_nationkey < 4", False),
]

# tests/test_functions.py's repeat cases (its 8K-row batches)
REPEAT = [
    "SELECT orderkey, cardinality(repeat(orderkey, -3)) c "
    "FROM orders WHERE orderkey < 10",
    "SELECT cardinality(repeat(orderkey, -1)) a, "
    "cardinality(repeat(orderkey, 0)) b, "
    "cardinality(repeat(orderkey, 2)) c "
    "FROM orders WHERE orderkey = 3",
]

# an ARRAY column through the operators that move rows
MOVED = {
    "topn": "select o_orderkey, a from (select o_orderkey, "
            "array[o_custkey, o_shippriority] a from orders) "
            "order by o_orderkey desc limit 5",
    "topn_by_element": "select o_orderkey, cardinality(a) c, a[1] f from "
                       "(select o_orderkey, array[o_custkey, o_orderkey] a "
                       "from orders) order by a[1] desc, o_orderkey limit 7",
    "sort": "select n_nationkey, a from (select n_nationkey, "
            "array[n_regionkey, n_nationkey] a from nation) "
            "order by n_nationkey desc",
    "join": "select n_name, r_name, a from (select n_name, n_regionkey, "
            "array[n_nationkey, n_regionkey] a from nation) join region "
            "on n_regionkey = r_regionkey",
    "filter_on_element": "select c_nationkey, a from (select c_nationkey, "
                         "array[c_custkey, c_nationkey] a from customer) "
                         "where c_nationkey < 2",
    "unnest_group": "select o_orderpriority, sum(x), count(*) from orders "
                    "cross join unnest(array[o_custkey, o_shippriority, 7]) "
                    "as u(x) group by o_orderpriority",
}
LEFT_JOIN = ("select r_name, a from region left join (select n_regionkey, "
             "array[n_nationkey] a from nation where n_nationkey < 3) "
             "on n_regionkey = r_regionkey")


def _outcome(runner, sql):
    """A runner's rows, or the type and text of what it raised."""
    try:
        return runner.execute(sql), None
    except Exception as e:  # noqa: BLE001 -- compared with the reference
        return None, (type(e).__name__, str(e))


def _same_outcome(port, ref, sql, ordered=False):
    got, gerr = _outcome(port, sql)
    exp, eerr = _outcome(ref, sql)
    assert gerr == eerr
    if eerr is None:
        assert_rows_close(got, exp, ordered=ordered, rtol=RTOL)
    return eerr


@pytest.fixture(scope="module")
def local():
    return (LocalQueryRunner("sf0.01", device="cpu"),
            JRunner("sf0.01", plan_cache=JPlanCache()))


@pytest.mark.parametrize("sql,ordered", STATEMENTS,
                         ids=[f"s{i}" for i in range(len(STATEMENTS))])
def test_statements_equal_the_reference(local, sql, ordered):
    port, ref = local
    assert_rows_close(port.execute(sql), ref.execute(sql), ordered=ordered,
                      rtol=RTOL)


def test_literal_rows(local):
    port, _ref = local
    assert port.execute("select array[1, 2, 3][2], array[10, 20][1]") \
        .rows == [[2, 10]]
    assert port.execute("select x, y from unnest(array[1,2], "
                        "array[10,20,30]) as u(x, y)").rows \
        == [[1, 10], [2, 20], [None, 30]]


@pytest.fixture(scope="module")
def small_batches():
    return (LocalQueryRunner("sf0.01", device="cpu",
                             config=ExecutionConfig(batch_rows=1 << 13)),
            JRunner("sf0.01", config=JConfig(batch_rows=1 << 13),
                    plan_cache=JPlanCache()))


@pytest.mark.parametrize("sql", REPEAT, ids=["repeat_negative",
                                             "repeat_counts"])
def test_repeat_clamps_as_the_reference(small_batches, sql):
    port, ref = small_batches
    got = port.execute(sql)
    assert_rows_close(got, ref.execute(sql), ordered=False)
    if "orderkey = 3" in sql:
        assert got.rows == [[0, 0, 2]]


# ---------------------------------------------------------------------------
# each function against the reference's Lowering over seeded matrices
# ---------------------------------------------------------------------------

N, W = 64, 4


def _matrix(seed, dtype=np.int64):
    rng = np.random.default_rng(seed)
    if dtype == np.float64:
        vals = rng.normal(size=(N, W)) * 100
    else:
        vals = rng.integers(-50, 50, size=(N, W)).astype(dtype)
    lens = rng.integers(0, W + 1, size=N).astype(np.int32)
    nulls = rng.random(N) < 0.1
    idx = rng.integers(-W - 1, W + 2, size=N).astype(np.int64)
    probe = rng.integers(-50, 50, size=N).astype(dtype)
    mask = rng.random(N) < 0.9
    return vals, lens, nulls, idx, probe, mask


def _batches(vals, lens, nulls, idx, probe, mask, etyp):
    import jax.numpy as jnp
    jb = JBatch({"a": JColumn(jnp.asarray(vals), jnp.asarray(nulls), None,
                              None, jnp.asarray(lens)),
                 "i": JColumn(jnp.asarray(idx)),
                 "x": JColumn(jnp.asarray(probe))}, jnp.asarray(mask))
    tb = Batch({"a": Column(torch.from_numpy(vals), torch.from_numpy(nulls),
                            None, None, torch.from_numpy(lens)),
                "i": Column(torch.from_numpy(idx)),
                "x": Column(torch.from_numpy(probe))},
               torch.from_numpy(mask))
    return jb, tb


CALLS = [
    ("cardinality", ("a",), "BIGINT"),
    ("subscript", ("a", "i"), None),
    ("element_at", ("a", "i"), None),
    ("contains", ("a", "x"), "BOOLEAN"),
    ("array_max", ("a",), None),
    ("array_min", ("a",), None),
    ("array_position", ("a", "x"), "BIGINT"),
]


def _call(mod, types, name, argnames, rtype, etyp):
    vtypes = {"a": types.ArrayType(etyp), "i": types.BIGINT,
              "x": etyp}
    args = [mod.VariableReferenceExpression(a, vtypes[a]) for a in argnames]
    rt = getattr(types, rtype) if rtype else etyp
    return mod.CallExpression(name, rt, args)


@pytest.mark.parametrize("etype", ["BIGINT", "DOUBLE"])
@pytest.mark.parametrize("name,args,rtype", CALLS,
                         ids=[c[0] for c in CALLS])
def test_function_equals_reference_lowering(name, args, rtype, etype):
    import jax
    dtype = np.float64 if etype == "DOUBLE" else np.int64
    jb, tb = _batches(*_matrix(7 + len(name), dtype), etype)
    jcol = JLowering().eval(_call(JE, JT, name, args, rtype,
                                  getattr(JT, etype)), jb)
    tcol = Lowering().eval(_call(TE, TT, name, args, rtype,
                                 getattr(TT, etype)), tb)
    jv = np.asarray(jax.device_get(jcol.values))
    jn = (np.zeros(N, dtype=bool) if jcol.nulls is None
          else np.asarray(jax.device_get(jcol.nulls)))
    tn = tcol.null_mask().numpy()
    np.testing.assert_array_equal(tn, jn)
    live = ~jn
    np.testing.assert_array_equal(tcol.values.numpy()[live], jv[live])


def test_constructor_repeat_sequence_equal_reference_lowering():
    import jax
    import jax.numpy as jnp
    vals = np.random.default_rng(3).integers(0, 100, size=N)
    jb = JBatch({"v": JColumn(jnp.asarray(vals))},
                jnp.ones(N, dtype=bool))
    tb = Batch({"v": Column(torch.from_numpy(vals))},
               torch.ones(N, dtype=torch.bool))
    for mod, types, low, b, get in (
            (JE, JT, JLowering(), jb, jax.device_get),
            (TE, TT, Lowering(), tb, lambda t: t)):
        v = mod.VariableReferenceExpression("v", types.BIGINT)
        at = types.ArrayType(types.BIGINT)
        exprs = [
            mod.CallExpression("array_constructor", at, [
                v, mod.ConstantExpression(5, types.BIGINT), v]),
            mod.CallExpression("repeat", at, [
                v, mod.ConstantExpression(3, types.BIGINT)]),
            mod.CallExpression("repeat", at, [
                v, mod.ConstantExpression(-2, types.BIGINT)]),
            mod.CallExpression("sequence", at, [
                mod.ConstantExpression(9, types.BIGINT),
                mod.ConstantExpression(1, types.BIGINT),
                mod.ConstantExpression(-3, types.BIGINT)]),
        ]
        outs = [low.eval(e, b) for e in exprs]
        got = [(np.asarray(get(c.values)), np.asarray(get(c.lengths)))
               for c in outs]
        if mod is JE:
            want = got
        else:
            for (tv, tl), (jv, jl) in zip(got, want):
                np.testing.assert_array_equal(tl, jl)
                np.testing.assert_array_equal(tv, jv)


@pytest.mark.parametrize("sql,match", [
    ("select array[n_nationkey % 5] from nation",
     "NULL array elements not supported"),
    ("select array[n_name] from nation", "scalar numerics"),
    ("select cardinality(repeat(n_nationkey, n_regionkey)) from nation",
     "repeat with non-constant count"),
], ids=["null_elements", "string_elements", "repeat_count"])
def test_raises_as_the_reference(local, sql, match):
    port, ref = local
    with pytest.raises(NotImplementedError, match=match):
        port.execute(sql)
    with pytest.raises(NotImplementedError, match=match):
        ref.execute(sql)


# ---------------------------------------------------------------------------
# lengths through every path that moves a column
# ---------------------------------------------------------------------------

def test_compact_and_concat_preserve_array_lengths():
    """tests/test_functions.py's carry-lengths case against the port's
    compact and _concat."""
    vals = torch.arange(12, dtype=torch.int64).reshape(6, 2)
    lens = torch.tensor([2, 1, 2, 0, 1, 2], dtype=torch.int32)
    mask = torch.tensor([True, False, True, True, False, True])
    b = Batch({"a": Column(vals, None, None, None, lens)}, mask)

    out = ops.compact(b)
    assert out.columns["a"].lengths is not None
    live = [int(x) for x in out.columns["a"].lengths[:int(mask.sum())]]
    assert live == [2, 2, 0, 2]

    cat = _concat([b, out])
    assert cat.columns["a"].lengths is not None
    assert tuple(cat.columns["a"].lengths.shape) == (12,)
    assert [int(x) for x in cat.columns["a"].lengths[:6]] == \
        [int(x) for x in lens]

    s = Batch({"x": Column(torch.arange(6, dtype=torch.int64))}, mask)
    assert ops.compact(s).columns["x"].lengths is None
    assert _concat([s, s]).columns["x"].lengths is None


def test_concat_pads_to_the_widest_matrix():
    a = Batch({"a": Column(torch.ones((2, 1), dtype=torch.int64), None,
                           None, None, torch.ones(2, dtype=torch.int32))},
              torch.ones(2, dtype=torch.bool))
    b = Batch({"a": Column(torch.full((2, 4), 7, dtype=torch.int64), None,
                           None, None,
                           torch.full((2,), 3, dtype=torch.int32))},
              torch.ones(2, dtype=torch.bool))
    cat = _concat([a, b])
    assert tuple(cat.columns["a"].values.shape) == (4, 4)
    types = [TT.ArrayType(TT.BIGINT)]
    page = batch_to_page(cat, ["a"], types)
    from presto_tpu_torch.common.block import block_to_values
    assert block_to_values(types[0], page.blocks[0]) == \
        [[1], [1], [7, 7, 7], [7, 7, 7]]


def test_pages_carry_arrays_as_the_reference():
    """batch_to_page makes the reference's ArrayBlock (the same serialized
    bytes); pages_to_batches packs pages of different widths into one
    batch whose matrix is as wide as the widest."""
    import jax.numpy as jnp
    vals, lens, nulls, _i, _x, mask = _matrix(11)
    jt, tt = JT.ArrayType(JT.BIGINT), TT.ArrayType(TT.BIGINT)
    jpage = jbatch_to_page(
        JBatch({"a": JColumn(jnp.asarray(vals), jnp.asarray(nulls), None,
                             None, jnp.asarray(lens))}, jnp.asarray(mask)),
        ["a"], [jt])
    tpage = batch_to_page(
        Batch({"a": Column(torch.from_numpy(vals), torch.from_numpy(nulls),
                           None, None, torch.from_numpy(lens))},
              torch.from_numpy(mask)), ["a"], [tt])
    assert serialize_page(tpage) == jserialize(jpage)
    narrow = batch_to_page(
        Batch({"a": Column(torch.zeros((3, 1), dtype=torch.int64), None,
                           None, None, torch.ones(3, dtype=torch.int32))},
              torch.ones(3, dtype=torch.bool)), ["a"], [tt])
    (batch,) = list(pages_to_batches([tpage, narrow], ["a"], [tt], 1 << 10,
                                     pack_rows=1 << 10))
    col = batch.columns["a"]
    assert col.values.shape[1] == 4
    back = batch_to_page(batch, ["a"], [tt])
    assert back.blocks[0].to_pylist() == \
        tpage.blocks[0].to_pylist() + narrow.blocks[0].to_pylist()


@pytest.mark.parametrize("name", sorted(MOVED))
def test_array_columns_move_as_the_reference(local, name):
    port, ref = local
    assert _same_outcome(port, ref, MOVED[name]) is None


def test_left_join_carries_arrays_the_reference_drops(local):
    """The port's LEFT-join null extension carries the array's lengths;
    the reference's drops them and raises (ROADMAP section 3).  The port
    gives the reference's numpy oracle's rows."""
    port, ref = local
    with pytest.raises(TypeError, match="dimensions"):
        ref.execute(LEFT_JOIN)
    assert_rows_close(port.execute(LEFT_JOIN),
                      ref.execute_reference(LEFT_JOIN), ordered=False)


@pytest.fixture(scope="module")
def distributed():
    return (DistributedQueryRunner("sf0.01", n_tasks=2, device="cpu"),
            JDist("sf0.01", n_tasks=2))


@pytest.mark.parametrize("name", ["topn", "join", "filter_on_element",
                                  "unnest_group"])
def test_distributed_equals_the_reference(distributed, name):
    port, ref = distributed
    assert _same_outcome(port, ref, MOVED[name]) is None


def test_array_column_crosses_an_exchange(distributed):
    """The array is projected in the source fragment and crosses the
    gather exchange as an ArrayBlock."""
    port, _ref = distributed
    sql = AQ.QUERIES["X1"]
    subplan, _names, _types = port.plan_subplan(sql)
    assert [v for _n, v in AQ.exchanged_arrays(subplan)] == ["a_3"]
    assert "array_constructor" in port.execute("explain " + sql).rows[0][0]
    local = LocalQueryRunner("sf0.01", device="cpu")
    assert_rows_close(port.execute(sql), local.execute(sql), ordered=False)


@pytest.fixture(scope="module")
def tiny():
    return (LocalQueryRunner("sf0.01", device="cpu",
                             config=ExecutionConfig(**TINY)),
            JRunner("sf0.01", config=JConfig(**TINY),
                    plan_cache=JPlanCache()))


@pytest.mark.parametrize("name", sorted(MOVED) + ["left_join"])
def test_tiny_budget_as_the_reference(tiny, name):
    """Under the 200 KB budget: the reference's rows, or its raise (its
    spill encodes fixed-width channels only, so a spilled join build that
    holds an array raises in both packages)."""
    port, ref = tiny
    sql = LEFT_JOIN if name == "left_join" else MOVED[name]
    err = _same_outcome(port, ref, sql)
    if name in ("join", "left_join"):
        assert err is not None and err[0] == "ValueError"


def test_grouped_lifespans_as_the_reference():
    sql = ("select sum(element_at(array[l_partkey, l_suppkey], 2)), "
           "count(*) from lineitem join orders on l_orderkey = o_orderkey "
           "where o_orderdate < date '1995-01-01'")
    port = LocalQueryRunner("sf0.01", device="cpu",
                            config=ExecutionConfig(grouped_lifespans=4))
    ref = JRunner("sf0.01", config=jtuned(grouped_lifespans=4),
                  plan_cache=JPlanCache())
    assert _same_outcome(port, ref, sql) is None


def test_array_output_through_the_statement_server():
    from presto_tpu.client import StatementClient as JClient
    from presto_tpu.worker.server import WorkerServer as JServer
    from presto_tpu_torch.client import StatementClient
    from presto_tpu_torch.worker import WorkerServer
    sql = STATEMENTS[-1][0]
    ref = JServer(coordinator=True)
    port = WorkerServer(coordinator=True, device="cpu")
    try:
        exp = JClient(ref.uri, schema="sf0.01").execute(sql)
        got = StatementClient(port.uri, schema="sf0.01").execute(sql)
    finally:
        port.close()
        ref.close()
    assert got.columns == exp.columns
    assert sorted(got.rows) == sorted(exp.rows)
    # both servers render an array value as its text
    assert ["ALGERIA", "[0, 0]"] in got.rows


# ---------------------------------------------------------------------------
# the chip phase's queries, and the scan kernels' decline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(AQ.QUERIES))
def test_chip_queries_equal_the_reference(local, name):
    port, ref = local
    sql = AQ.QUERIES[name]
    assert_rows_close(port.execute(sql), ref.execute(sql),
                      ordered=name in AQ.ORDERED, rtol=RTOL)


@pytest.mark.parametrize("name", sorted(AQ.TWINS))
def test_chip_queries_equal_their_twins(local, name):
    port, _ref = local
    got = port.execute(AQ.QUERIES[name])
    AQ.check_twin(name, got.rows, AQ.run_twin(port, name))


def test_array_chain_declines_the_scan_kernels(local):
    """An array form in a kernel-eligible chain: the port meters
    kernelDeclinedPlanShape and runs the torch chain; the reference's
    Pallas kernel traces the array forms and launches (ROADMAP section
    3, a divergence by design: arrays are not compiled into the CUDA
    kernels)."""
    port, _ref = local
    sql = ("select sum(element_at(array[l_partkey, l_suppkey], 2)) "
           "from lineitem")
    got = port.execute(sql)
    rs = got.runtime_stats
    declined = {k: v["sum"] for k, v in rs.items()
                if k.startswith("kernelDeclined")}
    assert declined == {"kernelDeclinedPlanShape": 1}
    assert "kernelScanPrograms" not in rs
    ref = JRunner("sf0.01", config=jtuned(scan_kernel="pallas"),
                  plan_cache=JPlanCache())
    want = ref.execute(sql)
    assert got.rows == want.rows
    rrs = want.runtime_stats
    assert not [k for k in rrs if k.startswith("kernelDeclined")]
    assert rrs["kernelScanPrograms"]["sum"] == 1


def test_array_column_crosses_a_hashed_exchange():
    """A partitioned join's probe side carries an ARRAY column through a
    hash-partitioned exchange (3 tasks): the reference's rows."""
    sql = ("select o_orderkey, c_name, a from (select o_orderkey, o_custkey, "
           "array[o_custkey, o_shippriority] a from orders "
           "where o_orderkey < 2000) join customer on o_custkey = c_custkey")
    port = DistributedQueryRunner("sf0.01", n_tasks=3, broadcast_threshold=0,
                                  device="cpu")
    subplan, _names, _types = port.plan_subplan(sql)
    assert any(n.startswith("x_repart")
               for n, _v in AQ.exchanged_arrays(subplan))
    ref = JDist("sf0.01", n_tasks=3, broadcast_threshold=0)
    assert _same_outcome(port, ref, sql) is None
