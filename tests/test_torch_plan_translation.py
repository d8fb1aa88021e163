"""The port's reference-PlanFragment translation (worker/
plan_translation.py) and GroupId (PlanCompiler._compile_GroupIdNode)
against the JAX package.

The cases of tests/test_plan_translation.py:
 1. the Java-produced fixtures of the reference tree, which skip under
    the reference test's own condition where that tree is absent; each
    translation is held equal to the JAX package's;
 2. the round trip: a query planned by the port, re-shaped into
    coordinator JSON by tests/reference_shapes.py, translated back by the
    port and executed on the CPU, equal to the port's direct execution
    and to the JAX package's rows;
 3. the hand-written wire samples: each node translated by both packages
    (the same IR) and executed by both (the port on the CPU, the JAX
    package through its own PlanCompiler), with equal rows -- GroupId's
    among them -- and the SQL oracle through the port's runner;
 4. a port WorkerServer(device="cpu") driven by a fully reference-shaped
    update (envelope, fragment and splits)."""
import base64
import json
import os
import time
import urllib.request

import pytest

from presto_tpu.spi import plan as JP
from presto_tpu.worker import plan_translation as JT
from presto_tpu_torch.benchmarks.rows import assert_rows_close
from presto_tpu_torch.spi import plan as P
from presto_tpu_torch.worker import plan_translation as T
from torch_threads import one_torch_thread  # noqa: F401

import reference_shapes as RS

# the reference test's own fixture directories and skip condition
from test_plan_translation import PROTO_FIXTURES, TYPES_FIXTURES  # noqa: E402

needs_fixtures = pytest.mark.skipif(
    not os.path.isdir(TYPES_FIXTURES), reason="reference tree not present")


def _load(path, name):
    with open(os.path.join(path, name)) as f:
        return json.load(f)


def _fragment_both(d, twi=None):
    """The port's translation of a reference fragment, held equal to the
    JAX package's."""
    frag = T.translate_fragment(json.loads(json.dumps(d)), twi)
    ref = JT.translate_fragment(json.loads(json.dumps(d)), twi)
    assert frag.to_dict() == ref.to_dict()
    return frag


def _node_both(d):
    node = T.translate_node(json.loads(json.dumps(d)))
    assert node.to_dict() == JT.translate_node(
        json.loads(json.dumps(d))).to_dict()
    return node


# -- 1. Java-produced fixtures ------------------------------------------------

@needs_fixtures
def test_scan_agg_fragment_fixture():
    frag = _fragment_both(_load(TYPES_FIXTURES, "ScanAgg.json"))
    assert frag.fragment_id == "2"
    agg = frag.root
    assert isinstance(agg, P.AggregationNode) and agg.step == "PARTIAL"
    assert [v.name for v in agg.grouping_keys] == ["regionkey"]
    const = {v.name: e for v, e in agg.source.assignments.items()}["expr"]
    assert const.value == 1 and const.type.signature == "bigint"
    assert frag.partitioning == P.SOURCE_DISTRIBUTION
    assert [a.name for a in frag.output_partitioning_scheme.arguments] \
        == ["regionkey"]


@needs_fixtures
def test_final_agg_fragment_fixture():
    agg = _fragment_both(_load(TYPES_FIXTURES, "FinalAgg.json")).root
    assert isinstance(agg, P.AggregationNode) and agg.step == "FINAL"
    assert isinstance(agg.source, P.ExchangeNode)
    assert agg.source.exchange_sources[0].source_fragment_ids


@needs_fixtures
def test_output_fragment_fixture():
    out = _fragment_both(_load(TYPES_FIXTURES, "Output.json")).root
    assert isinstance(out, P.OutputNode) and out.column_names


@needs_fixtures
def test_offset_limit_fragment_fixture():
    frag = _fragment_both(_load(TYPES_FIXTURES, "OffsetLimit.json"))
    kinds = {type(n).__name__ for n in P.walk_plan(frag.root)}
    assert {"LimitNode", "FilterNode", "WindowNode"} <= kinds


@needs_fixtures
@pytest.mark.parametrize("name", ["PartitionedOutput.json",
                                  "ScanAggBatch.json",
                                  "ScanAggCustomConnectorId.json"])
def test_more_fragment_fixtures_parse(name):
    frag = _fragment_both(_load(TYPES_FIXTURES, name))
    assert any(isinstance(n, P.TableScanNode) for n in P.walk_plan(frag.root))


@needs_fixtures
def test_plan_node_fixtures_parse():
    for name, expect in [("FilterNode.json", P.FilterNode),
                         ("ExchangeNode.json", P.ExchangeNode),
                         ("OutputNode.json", P.OutputNode),
                         ("ValuesNode.json", P.ValuesNode)]:
        assert isinstance(_node_both(_load(PROTO_FIXTURES, name)), expect)


@needs_fixtures
def test_task_update_request_fixture_fragment():
    from presto_tpu.worker.protocol import from_reference_update as jfrom
    from presto_tpu_torch.worker.protocol import from_reference_update
    with open(os.path.join(PROTO_FIXTURES, "TaskUpdateRequest.1")) as f:
        d = json.load(f)
    upd = from_reference_update("q.1.0.3.0", d)
    assert upd.task_index == 3
    frag = upd.fragment()
    assert frag.to_dict() == jfrom("q.1.0.3.0", d).fragment().to_dict()
    kinds = {type(n).__name__ for n in P.walk_plan(frag.root)}
    assert {"TableScanNode", "AggregationNode"} <= kinds


@needs_fixtures
def test_constant_decodes_java_bytes():
    c = T.decode_constant({"@type": "constant", "type": "bigint",
                           "valueBlock":
                           "CgAAAExPTkdfQVJSQVkBAAAAAAEAAAAAAAAA"})
    assert c.value == 1
    c = T.decode_constant({"@type": "constant", "type": "boolean",
                           "valueBlock": "CgAAAEJZVEVfQVJSQVkBAAAAAAE="})
    assert c.value is True


# -- 2. the round trip through tests/reference_shapes.py ---------------------

PARITY_QUERIES = {
    "q6_shape": """
        SELECT sum(l_extendedprice * l_discount) AS revenue
        FROM lineitem
        WHERE l_shipdate >= date '1994-01-01'
          AND l_shipdate < date '1995-01-01'
          AND l_discount BETWEEN 0.05 AND 0.07 AND l_quantity < 24""",
    "q1_shape": """
        SELECT l_returnflag, l_linestatus, sum(l_quantity) AS sum_qty,
               sum(l_extendedprice) AS sum_base_price,
               avg(l_discount) AS avg_disc, count(*) AS count_order
        FROM lineitem WHERE l_shipdate <= date '1998-09-02'
        GROUP BY l_returnflag, l_linestatus
        ORDER BY l_returnflag, l_linestatus""",
    "q3_shape": """
        SELECT o_orderkey, sum(l_extendedprice * (1 - l_discount)) AS rev
        FROM customer, orders, lineitem
        WHERE c_mktsegment = 'BUILDING' AND c_custkey = o_custkey
          AND l_orderkey = o_orderkey AND o_orderdate < date '1995-03-15'
          AND l_shipdate > date '1995-03-15'
        GROUP BY o_orderkey ORDER BY rev DESC LIMIT 10""",
}


def _config(cls):
    return cls(batch_rows=1 << 14, join_out_capacity=1 << 16)


@pytest.fixture(scope="module")
def runner():
    from presto_tpu_torch.exec.pipeline import ExecutionConfig
    from presto_tpu_torch.exec.runner import LocalQueryRunner
    return LocalQueryRunner("sf0.01", config=_config(ExecutionConfig),
                            device="cpu")


@pytest.fixture(scope="module")
def jrunner():
    from presto_tpu.exec.pipeline import ExecutionConfig
    from presto_tpu.exec.runner import LocalQueryRunner
    return LocalQueryRunner("sf0.01", config=_config(ExecutionConfig))


def _run_node(runner, node):
    """The port's rows of a translated node, on the runner's device."""
    from presto_tpu_torch.exec.pipeline import PlanCompiler, TaskContext
    from presto_tpu_torch.exec.runner import pages_to_result
    comp = PlanCompiler(TaskContext(config=runner.config,
                                    device=runner.device))
    return pages_to_result(comp.run_to_pages(node),
                           [v.name for v in node.output_variables],
                           [v.type for v in node.output_variables])


def _run_ref_node(jrunner, d):
    """The JAX package's rows of the same wire node."""
    from presto_tpu.exec.pipeline import PlanCompiler, TaskContext
    from presto_tpu.exec.runner import pages_to_result
    node = JT.translate_node(json.loads(json.dumps(d)))
    comp = PlanCompiler(TaskContext(config=jrunner.config))
    return pages_to_result(comp.run_to_pages(node),
                           [v.name for v in node.output_variables],
                           [v.type for v in node.output_variables])


@pytest.mark.parametrize("name", sorted(PARITY_QUERIES))
def test_reference_shaped_execution_parity(runner, jrunner, name):
    """Plan with the port, re-shape to coordinator JSON, translate back
    through the port's plan_translation, execute: the rows equal the
    port's direct execution and the JAX package's."""
    from presto_tpu_torch.exec.runner import pages_to_result
    from presto_tpu_torch.exec.pipeline import PlanCompiler, TaskContext
    sql = PARITY_QUERIES[name]
    direct = runner.execute(sql)
    out = runner.plan(sql)
    frag = P.PlanFragment("0", out, P.SOURCE_DISTRIBUTION,
                          P.PartitioningScheme(
                              P.SINGLE_DISTRIBUTION, [],
                              list(out.output_variables)),
                          [n.id for n in P.walk_plan(out)
                           if isinstance(n, P.TableScanNode)])
    # reference_shapes.py emits from the JAX package's IR, whose dict
    # form is the port's
    ref_json = RS.fragment_json(JP.PlanFragment.from_dict(
        json.loads(json.dumps(frag.to_dict()))))
    assert T.is_reference_fragment(ref_json)
    back = _fragment_both(ref_json)
    comp = PlanCompiler(TaskContext(config=runner.config,
                                    device=runner.device))
    translated = pages_to_result(comp.run_to_pages(back.root),
                                 back.root.column_names,
                                 [v.type for v in back.root.outputs])
    assert [tuple(r) for r in translated.rows] \
        == [tuple(r) for r in direct.rows], name
    assert_rows_close(translated, jrunner.execute(sql), ordered=True)


# -- 3. hand-written wire samples ---------------------------------------------

def _nation_scan_json(cols):
    return {
        "@type": ".TableScanNode", "id": "scan",
        "table": {"connectorId": "tpch",
                  "connectorHandle": {"@type": "tpch",
                                      "tableName": "nation",
                                      "scaleFactor": 0.01},
                  "transaction": {"@type": "tpch", "instance": "test"}},
        "outputVariables": [{"@type": "variable", "name": n,
                             "type": "bigint"} for n in cols],
        "assignments": {f"{n}<bigint>": {"@type": "tpch",
                                         "columnName": n.split("_", 1)[1],
                                         "type": "bigint"}
                        for n in cols}}


def _vj(name, typ="bigint"):
    return {"@type": "variable", "name": name, "type": typ}


def _sig(name, kind, ret, args, variadic=False):
    return {"@type": "$static", "signature": {
        "name": name, "kind": kind, "returnType": ret,
        "argumentTypes": args, "typeVariableConstraints": [],
        "longVariableConstraints": [], "variableArity": variadic}}


def _count_call(arg):
    return {"@type": "call", "displayName": "count",
            "functionHandle": _sig("presto.default.count", "AGGREGATE",
                                   "bigint", ["bigint"]),
            "returnType": "bigint", "arguments": [_vj(arg)]}


def _compare(name, ret_args, const_b64):
    return {"@type": "call", "displayName": name.upper(),
            "functionHandle": _sig(f"presto.default.$operator${name}",
                                   "SCALAR", "boolean",
                                   ["bigint", "bigint"]),
            "returnType": "boolean",
            "arguments": [_vj(ret_args),
                          {"@type": "constant", "type": "bigint",
                           "valueBlock": const_b64}]}


TWO = "CgAAAExPTkdfQVJSQVkBAAAAAAIAAAAAAAAA"     # BIGINT 2, Java's bytes
TWENTY = base64.b64encode(b"\x0a\x00\x00\x00LONG_ARRAY\x01\x00\x00\x00\x00"
                          b"\x14\x00\x00\x00\x00\x00\x00\x00").decode()


def _key(r):
    return tuple((v is None, v) for v in r)


def _both_rows(runner, jrunner, d):
    """The node of wire sample `d` executed by both packages: equal
    rows (sorted); returns the port's."""
    node = _node_both(d)
    got = _run_node(runner, node)
    want = _run_ref_node(jrunner, d)
    assert sorted(map(tuple, got.rows), key=_key) \
        == sorted(map(tuple, want.rows), key=_key)
    return node, got


def test_table_writer_finish_wire_sample():
    """A coordinator-shaped write: TableWriterNode with the update's
    tableWriteInfo target, then a TableFinishNode committing it; the
    written table scans back.  Over the memory connector in both
    packages (the hive connector of the reference's case is not
    ported)."""
    from presto_tpu.connectors import catalog as jcat
    from presto_tpu.connectors.memory import MemoryConnector as JMem
    from presto_tpu.exec.pipeline import ExecutionConfig as JConfig
    from presto_tpu.exec.runner import LocalQueryRunner as JRunner
    from presto_tpu_torch.connectors import catalog as cat
    from presto_tpu_torch.connectors.memory import MemoryConnector
    from presto_tpu_torch.exec.pipeline import ExecutionConfig
    from presto_tpu_torch.exec.runner import LocalQueryRunner
    cat.register_connector("memory", MemoryConnector())
    jcat.register_connector("memory", JMem())
    try:
        runner = LocalQueryRunner("sf0.01", device="cpu",
                                  config=ExecutionConfig(batch_rows=1 << 13))
        jrunner = JRunner("sf0.01", config=JConfig(batch_rows=1 << 13))
        writer = {
            "@type": "com.facebook.presto.sql.planner.plan.TableWriterNode",
            "id": "writer",
            "source": _nation_scan_json(["n_nationkey", "n_regionkey"]),
            "rowCountVariable": _vj("rows"),
            "fragmentVariable": _vj("frag", "varchar"),
            "tableCommitContextVariable": _vj("ctx", "varchar"),
            "columns": [_vj("n_nationkey"), _vj("n_regionkey")],
            "columnNames": ["nationkey", "regionkey"],
            "notNullColumnVariables": []}
        single = {"handle": {"connectorId": "$remote", "connectorHandle": {
            "@type": "$remote", "partitioning": "SINGLE",
            "function": "UNKNOWN"}}, "arguments": []}
        frag = {
            "id": "1", "root": writer,
            "partitioning": {"connectorId": "$remote", "connectorHandle": {
                "@type": "$remote", "partitioning": "SOURCE",
                "function": "UNKNOWN"}},
            "tableScanSchedulingOrder": ["scan"],
            "partitioningScheme": {
                "partitioning": single,
                "outputLayout": [_vj("rows"), _vj("frag", "varchar"),
                                 _vj("ctx", "varchar")]}}
        twi = {"writerTarget": {
            "@type": "CreateHandle",
            "handle": {"connectorId": "memory",
                       "transactionHandle": {"@type": "memory"},
                       "connectorHandle": {"@type": "memory",
                                           "tableName": "wt_nation"}},
            "schemaTableName": {"schema": "default", "table": "wt_nation"}}}
        wnode = _fragment_both(frag, twi).root
        assert isinstance(wnode, P.TableWriterNode)
        assert (wnode.connector_id, wnode.table_name) \
            == ("memory", "wt_nation")
        finish = {"@type": "com.facebook.presto.spi.plan.TableFinishNode",
                  "id": "finish", "source": writer,
                  "rowCountVariable": _vj("total")}
        frag2 = dict(frag, root=finish, partitioningScheme={
            "partitioning": single, "outputLayout": [_vj("total")]})
        fnode = _fragment_both(frag2, twi).root
        assert isinstance(fnode, P.TableFinishNode)
        assert _run_node(runner, fnode).rows[0][0] == 25
        jnode = JT.translate_fragment(json.loads(json.dumps(frag2)),
                                      twi).root
        from presto_tpu.exec.pipeline import PlanCompiler, TaskContext
        from presto_tpu.exec.runner import pages_to_result
        jres = pages_to_result(
            PlanCompiler(TaskContext(config=jrunner.config))
            .run_to_pages(jnode), ["total"],
            [v.type for v in jnode.output_variables])
        assert jres.rows[0][0] == 25
        sql = "select count(*), sum(nationkey) from wt_nation"
        assert runner.execute(sql).rows[0] == jrunner.execute(sql).rows[0] \
            == [25, 300]
    finally:
        cat.unregister_connector("memory")
        jcat.unregister_connector("memory")


def test_unnest_node_wire_sample(runner, jrunner):
    arr_call = {"@type": "call", "displayName": "ARRAY_CONSTRUCTOR",
                "functionHandle": _sig("presto.default.array_constructor",
                                       "SCALAR", "array(bigint)",
                                       ["bigint", "bigint"], True),
                "returnType": "array(bigint)",
                "arguments": [_vj("n_nationkey"), _vj("n_regionkey")]}
    proj = {"@type": ".ProjectNode", "id": "mkarr",
            "source": _nation_scan_json(["n_nationkey", "n_regionkey"]),
            "assignments": {"assignments": {
                "n_nationkey<bigint>": _vj("n_nationkey"),
                "arr<array(bigint)>": arr_call}},
            "locality": "LOCAL"}
    unnest = {
        "@type": "com.facebook.presto.spi.plan.UnnestNode",
        "id": "unnest", "source": proj,
        "replicateVariables": [_vj("n_nationkey")],
        "unnestVariables": {"arr<array(bigint)>": [_vj("x")]},
        "ordinalityVariable": _vj("ord")}
    node, got = _both_rows(runner, jrunner, unnest)
    assert isinstance(node, P.UnnestNode)
    assert node.ordinality_variable is not None
    want = runner.execute(
        "SELECT n_nationkey, x, i FROM nation CROSS JOIN "
        "UNNEST(ARRAY[n_nationkey, n_regionkey]) WITH ORDINALITY "
        "AS u(x, i)")
    assert sorted(map(tuple, got.rows), key=_key) \
        == sorted(map(tuple, want.rows), key=_key)


GROUP_ID = {
    "@type": "com.facebook.presto.sql.planner.plan.GroupIdNode",
    "id": "groupid",
    "source": _nation_scan_json(["n_regionkey", "n_nationkey"]),
    "groupingSets": [[_vj("n_regionkey$gid")], []],
    "groupingColumns": {"n_regionkey$gid<bigint>": _vj("n_regionkey")},
    "aggregationArguments": [_vj("n_nationkey")],
    "groupIdVariable": _vj("groupid")}


def test_group_id_node_wire_sample(runner, jrunner):
    """GroupIdNode under the grouping AggregationNode, as the coordinator
    plans ROLLUP: the port's rows equal the JAX package's, and the SQL
    ROLLUP's."""
    agg = {
        "@type": ".AggregationNode", "id": "agg", "source": GROUP_ID,
        "aggregations": {"cnt<bigint>": {"call": _count_call("n_nationkey"),
                                         "distinct": False}},
        "groupingSets": {"groupingKeys": [_vj("n_regionkey$gid"),
                                          _vj("groupid")],
                         "groupingSetCount": 1, "globalGroupingSets": []},
        "preGroupedVariables": [], "step": "SINGLE"}
    node, got = _both_rows(runner, jrunner, agg)
    assert isinstance(node, P.AggregationNode)
    assert isinstance(node.source, P.GroupIdNode)
    got_rows = sorted(((r[0], r[2]) for r in got.rows), key=_key)
    want = runner.execute("SELECT n_regionkey, count(n_nationkey) "
                          "FROM nation GROUP BY ROLLUP(n_regionkey)")
    assert got_rows == sorted((tuple(r) for r in want.rows), key=_key)


def test_group_id_source_runs_once(runner, jrunner):
    """GroupId's grouping sets read one source: the scan below produces
    its batches once, whatever the number of sets, and the expanded rows
    equal the JAX package's."""
    import presto_tpu_torch.exec.pipeline as pl
    node = _node_both(GROUP_ID)
    comp = pl.PlanCompiler(pl.TaskContext(config=runner.config,
                                          device=runner.device))
    src = comp.compile(node.source)
    inner, calls = src._fn, []

    def counted():
        calls.append(1)
        yield from inner()
    src._fn = counted
    from presto_tpu_torch.exec.runner import pages_to_result
    names = [v.name for v in node.output_variables]
    types = [v.type for v in node.output_variables]
    for _ in range(2):          # a re-execution reads the source again
        calls.clear()
        got = pages_to_result(comp.run_to_pages(node), names, types)
        assert len(calls) == 1, calls
        assert len(got.rows) == 2 * 25
    want = _run_ref_node(jrunner, GROUP_ID)
    assert sorted(map(tuple, got.rows), key=_key) \
        == sorted(map(tuple, want.rows), key=_key)


def test_group_id_varchar_sets_wire_sample(runner, jrunner):
    """Three grouping sets over a varchar and a bigint column, counted by
    the grouping AggregationNode, the varchar NULLed in the first two:
    the rows equal the JAX package's and the SQL GROUPING SETS'."""
    scan = _nation_scan_json(["n_regionkey", "n_nationkey"])
    scan["outputVariables"].append(_vj("n_name", "varchar(25)"))
    scan["assignments"]["n_name<varchar(25)>"] = {
        "@type": "tpch", "columnName": "name", "type": "varchar(25)"}
    gid = {
        "@type": "com.facebook.presto.sql.planner.plan.GroupIdNode",
        "id": "groupid", "source": scan,
        "groupingSets": [[], [_vj("n_regionkey$gid")],
                         [_vj("n_name$gid", "varchar(25)")]],
        "groupingColumns": {
            "n_name$gid<varchar(25)>": _vj("n_name", "varchar(25)"),
            "n_regionkey$gid<bigint>": _vj("n_regionkey")},
        "aggregationArguments": [_vj("n_nationkey")],
        "groupIdVariable": _vj("groupid")}
    agg = {
        "@type": ".AggregationNode", "id": "agg", "source": gid,
        "aggregations": {"cnt<bigint>": {"call": _count_call("n_nationkey"),
                                         "distinct": False}},
        "groupingSets": {"groupingKeys": [
            _vj("n_name$gid", "varchar(25)"), _vj("n_regionkey$gid"),
            _vj("groupid")],
            "groupingSetCount": 1, "globalGroupingSets": []},
        "preGroupedVariables": [], "step": "SINGLE"}
    _node, got = _both_rows(runner, jrunner, agg)
    assert len(got.rows) == 25 + 5 + 1
    want = runner.execute("SELECT n_name, n_regionkey, count(n_nationkey) "
                          "FROM nation GROUP BY GROUPING SETS "
                          "((n_name), (n_regionkey), ())")
    assert sorted(((r[0], r[1], r[3]) for r in got.rows), key=_key) \
        == sorted((tuple(r) for r in want.rows), key=_key)


def test_filter_aggregate_wire_sample(runner, jrunner):
    agg = {
        "@type": ".AggregationNode", "id": "agg",
        "source": _nation_scan_json(["n_regionkey", "n_nationkey"]),
        "aggregations": {"cnt<bigint>": {
            "call": _count_call("n_nationkey"),
            "filter": _compare("greater_than", "n_regionkey", TWO),
            "distinct": False}},
        "groupingSets": {"groupingKeys": [], "groupingSetCount": 1,
                         "globalGroupingSets": []},
        "preGroupedVariables": [], "step": "SINGLE"}
    node, got = _both_rows(runner, jrunner, agg)
    (_, a), = node.aggregations.items()
    assert a.mask is not None
    want = runner.execute("SELECT count(n_nationkey) FROM nation "
                          "WHERE n_regionkey > 2")
    assert got.rows[0][0] == want.rows[0][0]


def test_filter_plus_mask_aggregate_executes(runner, jrunner):
    proj = {"@type": ".ProjectNode", "id": "bindmask",
            "source": _nation_scan_json(["n_regionkey", "n_nationkey"]),
            "assignments": {"assignments": {
                "n_regionkey<bigint>": _vj("n_regionkey"),
                "n_nationkey<bigint>": _vj("n_nationkey"),
                "m<boolean>": _compare("less_than", "n_nationkey", TWENTY)}},
            "locality": "LOCAL"}
    agg = {
        "@type": ".AggregationNode", "id": "agg", "source": proj,
        "aggregations": {"cnt<bigint>": {
            "call": _count_call("n_nationkey"),
            "filter": _compare("greater_than", "n_regionkey", TWO),
            "mask": _vj("m", "boolean"), "distinct": False}},
        "groupingSets": {"groupingKeys": [], "groupingSetCount": 1,
                         "globalGroupingSets": []},
        "preGroupedVariables": [], "step": "SINGLE"}
    _node, got = _both_rows(runner, jrunner, agg)
    want = runner.execute("SELECT count(n_nationkey) FROM nation "
                          "WHERE n_regionkey > 2 AND n_nationkey < 20")
    assert got.rows[0][0] == want.rows[0][0]


def test_range_frame_with_offsets_rejected():
    win = {"@type": "com.facebook.presto.sql.planner.plan.WindowNode",
           "id": "win",
           "source": _nation_scan_json(["n_regionkey", "n_nationkey"]),
           "specification": {
               "partitionBy": [],
               "orderingScheme": {"orderBy": [
                   {"variable": _vj("n_nationkey"),
                    "sortOrder": "ASC_NULLS_LAST"}]}},
           "windowFunctions": {"s<bigint>": {
               "functionCall": _count_call("n_nationkey"),
               "frame": {"type": "RANGE", "startType": "PRECEDING",
                         "originalStartValue": "2",
                         "startValue": _vj("$off"),
                         "endType": "CURRENT_ROW"},
               "ignoreNulls": False}},
           "prePartitionedInputs": [], "preSortedOrderPrefix": 0}
    with pytest.raises(T.PlanTranslationError, match="RANGE"):
        T.translate_node(json.loads(json.dumps(win)))
    with pytest.raises(JT.PlanTranslationError, match="RANGE"):
        JT.translate_node(json.loads(json.dumps(win)))


def test_topn_row_number_wire_sample(runner, jrunner):
    d = {"@type": "com.facebook.presto.sql.planner.plan.TopNRowNumberNode",
         "id": "topnrn",
         "source": _nation_scan_json(["n_regionkey", "n_nationkey"]),
         "specification": {
             "partitionBy": [_vj("n_regionkey")],
             "orderingScheme": {"orderBy": [
                 {"variable": _vj("n_nationkey"),
                  "sortOrder": "DESC_NULLS_LAST"}]}},
         "rowNumberVariable": _vj("rn"),
         "maxRowCountPerPartition": 2, "partial": False}
    _node, got = _both_rows(runner, jrunner, d)
    want = runner.execute(
        "SELECT * FROM (SELECT n_regionkey, n_nationkey, row_number() "
        "OVER (PARTITION BY n_regionkey ORDER BY n_nationkey DESC) rn "
        "FROM nation) t WHERE rn <= 2")
    assert sorted((r[0], r[1]) for r in got.rows) \
        == sorted((r[0], r[1]) for r in want.rows)


def test_window_value_offset_frame_wire_sample(runner, jrunner):
    proj = {"@type": ".ProjectNode", "id": "bindoffsets",
            "source": _nation_scan_json(["n_regionkey", "n_nationkey"]),
            "assignments": {"assignments": {
                "n_regionkey<bigint>": _vj("n_regionkey"),
                "n_nationkey<bigint>": _vj("n_nationkey"),
                "$off<bigint>": {"@type": "constant", "type": "bigint",
                                 "valueBlock": TWO}}},
            "locality": "LOCAL"}
    sum_call = {"@type": "call", "displayName": "sum",
                "functionHandle": _sig("presto.default.sum", "WINDOW",
                                       "bigint", ["bigint"]),
                "returnType": "bigint", "arguments": [_vj("n_nationkey")]}
    win = {"@type": "com.facebook.presto.sql.planner.plan.WindowNode",
           "id": "win", "source": proj,
           "specification": {
               "partitionBy": [],
               "orderingScheme": {"orderBy": [
                   {"variable": _vj("n_nationkey"),
                    "sortOrder": "ASC_NULLS_LAST"}]}},
           "windowFunctions": {"s<bigint>": {
               "functionCall": sum_call,
               "frame": {"type": "ROWS", "startType": "PRECEDING",
                         "startValue": _vj("$off"),
                         "originalStartValue": "2",
                         "endType": "CURRENT_ROW"},
               "ignoreNulls": False}},
           "prePartitionedInputs": [], "preSortedOrderPrefix": 0}
    node, got = _both_rows(runner, jrunner, win)
    (_, wf), = node.window_functions.items()
    assert wf.frame == {"type": "ROWS", "startKind": "PRECEDING",
                        "startOffset": 2, "endKind": "CURRENT",
                        "endOffset": None}
    want = runner.execute(
        "SELECT n_nationkey, sum(n_nationkey) OVER (ORDER BY n_nationkey "
        "ROWS BETWEEN 2 PRECEDING AND CURRENT ROW) s FROM nation")
    assert sorted((r[1], r[3]) for r in got.rows) \
        == sorted(tuple(r) for r in want.rows)


def test_mark_distinct_executes(runner, jrunner):
    from presto_tpu.common.types import BOOLEAN
    from presto_tpu.spi.expr import VariableReferenceExpression as V
    scan = JT.translate_node(json.loads(json.dumps(
        _nation_scan_json(["n_regionkey", "n_nationkey"]))))
    md = JP.MarkDistinctNode("md", scan, V("marker", BOOLEAN),
                             [V("n_regionkey", scan.outputs[0].type)])
    back, got = _both_rows(runner, jrunner, RS.node_json(md))
    assert isinstance(back, P.MarkDistinctNode)
    want = runner.execute("SELECT count(DISTINCT n_regionkey) FROM nation")
    assert len([r for r in got.rows if r[2]]) == want.rows[0][0]


def test_group_id_round_trip_via_emitter():
    from presto_tpu.spi.expr import VariableReferenceExpression as V
    scan = JT.translate_node(json.loads(json.dumps(
        _nation_scan_json(["n_regionkey", "n_nationkey"]))))
    rk = V("n_regionkey$gid", scan.outputs[0].type)
    gid = JP.GroupIdNode("gid", scan, [[rk], []], {rk: scan.outputs[0]},
                         [scan.outputs[1]],
                         V("groupid", scan.outputs[0].type))
    back = _node_both(RS.node_json(gid))
    assert isinstance(back, P.GroupIdNode)
    assert [[v.name for v in s] for s in back.grouping_sets] \
        == [["n_regionkey$gid"], []]
    assert {o.name: i.name for o, i in back.grouping_columns.items()} \
        == {"n_regionkey$gid": "n_regionkey"}
    assert back.group_id_variable.name == "groupid"


# -- 4. a port worker driven by a fully reference-shaped update -------------

def test_worker_runs_reference_fragment_end_to_end(jrunner):
    from presto_tpu_torch.common.block import block_to_values
    from presto_tpu_torch.common.serde import deserialize_page
    from presto_tpu_torch.common.types import BIGINT
    from presto_tpu_torch.sql.planner import Planner
    from presto_tpu_torch.worker import presto_protocol as PP
    from presto_tpu_torch.worker.server import WorkerServer

    sql = ("SELECT count(*) AS n, sum(n_regionkey) AS s FROM nation "
           "WHERE n_nationkey < 20")
    w = WorkerServer(device="cpu")
    try:
        out = Planner(default_schema="sf0.01",
                      default_catalog="tpch").plan(sql)
        frag = P.PlanFragment(
            "0", out, P.SOURCE_DISTRIBUTION,
            P.PartitioningScheme(P.SINGLE_DISTRIBUTION, [],
                                 list(out.output_variables)),
            [n.id for n in P.walk_plan(out)
             if isinstance(n, P.TableScanNode)])
        ref_json = RS.fragment_json(JP.PlanFragment.from_dict(
            json.loads(json.dumps(frag.to_dict()))))
        body = {
            "session": PP.SessionRepresentation(
                queryId="q_ref", user="test").to_json(),
            "extraCredentials": {},
            "fragment": base64.b64encode(
                json.dumps(ref_json).encode()).decode(),
            "sources": [
                {"planNodeId": sid,
                 "splits": [{"sequenceId": i, "planNodeId": sid,
                             "split": RS.tpch_split_json(
                                 "nation", 0.01, i, 2)}
                            for i in range(2)],
                 "noMoreSplits": True} for sid in frag.partitioned_sources],
            "outputIds": PP.OutputBuffers(
                "PARTITIONED", 0, True, {"0": 0}).to_json(),
        }
        req = urllib.request.Request(
            f"{w.uri}/v1/task/q_ref.0.0.0.0",
            data=json.dumps(body).encode(), method="POST",
            headers={"Content-Type": "application/json"})
        st = json.load(urllib.request.urlopen(req, timeout=30))
        assert st["state"] in ("PLANNED", "RUNNING", "FINISHED"), st
        rows, token = [], 0
        deadline = time.time() + 60
        while time.time() < deadline:
            r = urllib.request.urlopen(
                f"{w.uri}/v1/task/q_ref.0.0.0.0/results/0/{token}",
                timeout=30)
            data = r.read()
            complete = r.headers.get("X-Presto-Buffer-Complete") == "true"
            nxt = r.headers.get("X-Presto-Page-End-Sequence-Id")
            pos = 0
            while pos < len(data):
                page, pos = deserialize_page(data, pos)
                rows.append([block_to_values(BIGINT, b)[0]
                             for b in page.blocks])
            if complete:
                break
            token = int(nxt) if nxt else token + 1
            time.sleep(0.05)
        assert rows, "no pages returned"
    finally:
        w.close()
    want = jrunner.execute(sql).rows[0]
    assert rows[0] == [int(want[0]), int(want[1])]
