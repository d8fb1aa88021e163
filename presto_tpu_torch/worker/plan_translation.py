"""Reference-shaped PlanFragment / RowExpression / Split JSON -> engine IR.

The TPU worker's analog of the native worker's plan-translation layer — the
piece that makes a Java coordinator able to drive this worker.  The
reference implements it as one converter per plan-node type plus expression
/ split / type converters:

  presto_cpp/main/types/PrestoToVeloxQueryPlan.{h,cpp}  (h:30-183: one
      toVeloxQueryPlan per node type; cpp 2,358 LoC)
  presto_cpp/main/types/PrestoToVeloxExpr.cpp           (RowExpressions)
  presto_cpp/main/types/PrestoToVeloxSplit.cpp          (splits)
  presto_cpp/main/types/TypeParser.cpp                  (type signatures —
      here: common.types.parse_type)

Input shapes are the JSON the Java coordinator's HttpRemoteTask actually
produces (struct layouts: presto_cpp/presto_protocol/core/
presto_protocol_core.h; golden fixtures: presto_cpp/main/types/tests/data/
and presto_cpp/presto_protocol/tests/data/ — the unit tests parse those
Java-produced files directly).  Notable wire conventions:

  * plan nodes dispatch on "@type", either ".FilterNode" style or the full
    Java class name (presto_protocol_core.cpp:764 from_json dispatch);
  * map keys for VariableReferenceExpression are "name<type>" strings
    (presto_protocol_core.h:387-400);
  * ConstantExpression carries a base64 "valueBlock" — ONE position of a
    standard Block wire encoding (the repo's common.serde reads the Java
    bytes directly);
  * function identities live in functionHandle.signature.name as
    "presto.default.sum" / "presto.default.$operator$equal"
    (BuiltInFunctionHandle, "@type":"$static").
"""
from __future__ import annotations

import base64
import contextvars
from typing import Dict, List, Optional, Tuple

from ..common.block import block_to_values
from ..common.serde import read_block
from ..common.types import BIGINT, Type, parse_type
from ..connectors import catalog
from ..spi import plan as P
from ..spi.expr import (CallExpression, ConstantExpression, LambdaExpression,
                        RowExpression, SpecialFormExpression,
                        VariableReferenceExpression)


class PlanTranslationError(ValueError):
    """A reference-shaped fragment uses a feature the worker cannot map."""


# ---------------------------------------------------------------------------
# types / variables
# ---------------------------------------------------------------------------

def parse_variable(d: dict) -> VariableReferenceExpression:
    return VariableReferenceExpression(d["name"], parse_type(d["type"]))


def parse_map_key_variable(key: str) -> VariableReferenceExpression:
    """Decode a "name<type>" map key (reference
    VariableReferenceExpression(String), presto_protocol_core.h:392-400:
    split at the FIRST '<', drop the trailing '>')."""
    name, _, sig = key.partition("<")
    if not sig or not sig.endswith(">"):
        raise PlanTranslationError(f"bad variable map key {key!r}")
    return VariableReferenceExpression(name, parse_type(sig[:-1]))


# ---------------------------------------------------------------------------
# expressions (PrestoToVeloxExpr analog)
# ---------------------------------------------------------------------------

def decode_constant(d: dict) -> ConstantExpression:
    """ConstantExpression JSON -> value.  The wire carries a base64 Block
    with exactly one position (presto_protocol_core.h:899); the repo serde
    reads the Java bytes as-is and block_to_values applies the type
    semantics (double/real bit views, decimal rescale, date rendering)."""
    typ = parse_type(d["type"])
    raw = base64.b64decode(d["valueBlock"])
    block, _ = read_block(memoryview(raw), 0)
    values = block_to_values(typ, block)
    if len(values) != 1:
        raise PlanTranslationError(
            f"constant valueBlock has {len(values)} positions")
    return ConstantExpression(values[0], typ)


def function_name(d: dict) -> str:
    """Engine-facing function name from a CallExpression JSON.  Prefer the
    handle's signature name ("presto.default.$operator$equal") over
    displayName ("EQUAL" / "presto.default.sum"), then strip the namespace;
    lowering's canonical_name maps "$operator$..." to the engine names."""
    handle = d.get("functionHandle") or {}
    sig = handle.get("signature") or {}
    name = sig.get("name") or d.get("displayName") or ""
    if not name:
        raise PlanTranslationError("call with no function name")
    return name.split(".")[-1].lower()


def translate_expr(d: dict) -> RowExpression:
    kind = d.get("@type")
    if kind == "variable":
        return parse_variable(d)
    if kind == "constant":
        return decode_constant(d)
    if kind == "call":
        return CallExpression(
            function_name(d), parse_type(d["returnType"]),
            [translate_expr(a) for a in d["arguments"]])
    if kind == "special":
        return SpecialFormExpression(
            d["form"], parse_type(d["returnType"]),
            [translate_expr(a) for a in d["arguments"]])
    if kind == "lambda":
        return LambdaExpression(
            list(d["argumentTypes"]), list(d["arguments"]),
            translate_expr(d["body"]))
    raise PlanTranslationError(f"unknown RowExpression @type {kind!r}")


def _ordering_scheme(d: Optional[dict]) -> Optional[P.OrderingScheme]:
    if not d:
        return None
    return P.OrderingScheme([(parse_variable(o["variable"]), o["sortOrder"])
                             for o in d["orderBy"]])


# ---------------------------------------------------------------------------
# connector handles / splits (PrestoToVeloxSplit analog)
# ---------------------------------------------------------------------------

def _table_handle(d: dict) -> P.TableHandle:
    """Reference TableHandle {connectorId, connectorHandle, transaction,
    connectorTableLayout?} -> repo handle.  Per-connector payloads mirror
    presto_cpp/presto_protocol/connector/ (tpch: tableName+scaleFactor;
    hive/system: schemaName+tableName)."""
    cid = d["connectorId"]
    ch = d.get("connectorHandle") or {}
    if cid.startswith("tpch") or ch.get("@type") == "tpch":
        sf = float(ch.get("scaleFactor", 1.0))
        # repo tpch handles carry the scale in extra (schema is cosmetic)
        return P.TableHandle("tpch", f"sf{sf:g}", ch["tableName"],
                             (("scaleFactor", sf),))
    if cid.startswith("tpcds"):
        sf = float(ch.get("scaleFactor", 1.0))
        return P.TableHandle("tpcds", f"sf{sf:g}", ch["tableName"],
                             (("scaleFactor", sf),))
    schema = ch.get("schemaName", "default")
    table = ch.get("tableName")
    if table is None:
        raise PlanTranslationError(
            f"unsupported connector table handle for {cid!r}")
    return P.TableHandle(cid, schema, table, ())


def _column_handle(d: dict, var: VariableReferenceExpression) -> P.ColumnHandle:
    """ColumnHandle payloads: tpch TpchColumnHandle{columnName,type}
    (presto_protocol_tpch.h:37), hive HiveColumnHandle{name,typeSignature}."""
    name = d.get("columnName") or d.get("name") or var.name
    sig = d.get("type") or d.get("typeSignature")
    typ = parse_type(sig) if sig else var.type
    return P.ColumnHandle(name, typ)


def translate_split(d: dict) -> dict:
    """Reference Split JSON -> the worker's internal split dict.  Handles
    the wrapper {connectorId, connectorSplit, lifespan} (ScheduledSplit
    carries {sequenceId, planNodeId, split}), tpch TpchSplit
    {tableHandle, partNumber, totalParts} (row-range derived the same way
    TpchSplitManager shards the table), and $remote RemoteSplit
    {location:{location}, remoteSourceTaskId}."""
    if "split" in d and "connectorSplit" not in d:
        d = d["split"]                      # ScheduledSplit wrapper
    cs = d.get("connectorSplit", d)
    if cs.get("remote"):
        return cs                           # already the repo remote shape
    t = cs.get("@type", "")
    if t == "$remote" or "remoteSourceTaskId" in cs:
        loc = cs["location"]
        url = loc["location"] if isinstance(loc, dict) else loc
        return {"remote": True, "location": url}
    if t in ("tpch", "tpcds") or "tableHandle" in cs:
        th = cs["tableHandle"]
        table = th["tableName"]
        sf = float(th.get("scaleFactor", 1.0))
        cid = "tpcds" if t == "tpcds" else "tpch"
        total = catalog.table_row_count(table, sf, cid)
        part = int(cs.get("partNumber", 0))
        nparts = max(int(cs.get("totalParts", 1)), 1)
        per = (total + nparts - 1) // nparts
        return catalog.TableSplit(cid, table, sf, min(part * per, total),
                                  min((part + 1) * per, total)).to_dict()
    # repo-internal shapes and connector splits we have no mapping for pass
    # through unchanged; an alien connector split then fails the task at
    # scan setup with a clear message (same failure point as
    # PrestoToVeloxSplit's unknown-connector throw)
    return cs


# ---------------------------------------------------------------------------
# plan nodes (PrestoToVeloxQueryPlan analog, one handler per node type)
# ---------------------------------------------------------------------------

_JAVA = "com.facebook.presto.sql.planner.plan."


def _src(d: dict) -> P.PlanNode:
    return translate_node(d["source"])


def _t_tablescan(d: dict) -> P.PlanNode:
    outputs = [parse_variable(v) for v in d["outputVariables"]]
    assignments = {}
    for key, ch in (d.get("assignments") or {}).items():
        var = parse_map_key_variable(key)
        assignments[var] = _column_handle(ch, var)
    return P.TableScanNode(d["id"], _table_handle(d["table"]), outputs,
                           assignments)


def _t_filter(d: dict) -> P.PlanNode:
    return P.FilterNode(d["id"], _src(d), translate_expr(d["predicate"]))


def _t_project(d: dict) -> P.PlanNode:
    inner = (d.get("assignments") or {}).get("assignments") or {}
    assignments = {parse_map_key_variable(k): translate_expr(e)
                   for k, e in inner.items()}
    return P.ProjectNode(d["id"], _src(d), assignments)


def _t_output(d: dict) -> P.PlanNode:
    return P.OutputNode(d["id"], _src(d), list(d.get("columnNames") or []),
                        [parse_variable(v) for v in d["outputVariables"]])


def _t_values(d: dict) -> P.PlanNode:
    return P.ValuesNode(d["id"],
                        [parse_variable(v) for v in d["outputVariables"]],
                        [[translate_expr(e) for e in row]
                         for row in d.get("rows") or []])


def _t_limit(d: dict) -> P.PlanNode:
    step = d.get("step", "FINAL")
    return P.LimitNode(d["id"], _src(d), int(d["count"]),
                       P.PARTIAL if step == "PARTIAL" else P.FINAL)


def _t_topn(d: dict) -> P.PlanNode:
    step = d.get("step", "SINGLE")
    return P.TopNNode(d["id"], _src(d), int(d["count"]),
                      _ordering_scheme(d["orderingScheme"]), step)


def _t_sort(d: dict) -> P.PlanNode:
    return P.SortNode(d["id"], _src(d),
                      _ordering_scheme(d["orderingScheme"]),
                      bool(d.get("isPartial", False)))


def _t_distinct_limit(d: dict) -> P.PlanNode:
    return P.DistinctLimitNode(
        d["id"], _src(d), int(d["limit"]),
        [parse_variable(v) for v in d["distinctVariables"]])


def _t_mark_distinct(d: dict) -> P.PlanNode:
    return P.MarkDistinctNode(
        d["id"], _src(d), parse_variable(d["markerVariable"]),
        [parse_variable(v) for v in d["distinctVariables"]])


def _t_enforce_single_row(d: dict) -> P.PlanNode:
    return P.EnforceSingleRowNode(d["id"], _src(d))


def _t_assign_unique_id(d: dict) -> P.PlanNode:
    return P.AssignUniqueIdNode(d["id"], _src(d),
                                parse_variable(d["idVariable"]))


def _t_aggregation(d: dict) -> P.PlanNode:
    gsets = d["groupingSets"]
    if int(gsets.get("groupingSetCount", 1)) != 1:
        raise PlanTranslationError(
            "multiple grouping sets arrive via GroupIdNode; a plain "
            "AggregationNode must have exactly one")
    keys = [parse_variable(v) for v in gsets["groupingKeys"]]
    source = _src(d)
    aggregations: Dict[VariableReferenceExpression, P.Aggregation] = {}
    filter_projections: Dict[VariableReferenceExpression, RowExpression] = {}
    for key, agg in (d.get("aggregations") or {}).items():
        var = parse_map_key_variable(key)
        call = translate_expr(agg["call"])
        mask = parse_variable(agg["mask"]) if agg.get("mask") else None
        if agg.get("filter"):
            # FILTER (WHERE p): the engine's Aggregation.mask is exactly
            # the reference's filter semantics (AggregationNode.java pairs
            # them; the coordinator plans FILTER as either field).  A
            # non-variable filter expression is bound below via a
            # synthesized pass-through projection.
            fexpr = translate_expr(agg["filter"])
            if mask is not None:
                # combine with the existing mask INLINE (both operands
                # must resolve against the input batch: projection
                # assignments cannot reference sibling assignments)
                from ..spi.expr import special as _mkspecial
                combined = VariableReferenceExpression(
                    f"{var.name}__filtermask", parse_type("boolean"))
                filter_projections[combined] = _mkspecial(
                    "AND", parse_type("boolean"), mask, fexpr)
                mask = combined
            elif isinstance(fexpr, VariableReferenceExpression):
                mask = fexpr
            else:
                fvar = VariableReferenceExpression(
                    f"{var.name}__filter", parse_type("boolean"))
                filter_projections[fvar] = fexpr
                mask = fvar
        if agg.get("orderBy"):
            raise PlanTranslationError("ORDER BY aggregates are not "
                                       "supported")
        aggregations[var] = P.Aggregation(call, bool(agg.get("distinct")),
                                          mask)
    if filter_projections:
        assigns = {v: v for v in source.output_variables}
        assigns.update(filter_projections)
        source = P.ProjectNode(d["id"] + ".aggfilter", source, assigns)
    return P.AggregationNode(d["id"], source, aggregations, keys,
                             d.get("step", "SINGLE"))


def _t_group_id(d: dict) -> P.PlanNode:
    """GroupIdNode (presto_protocol_core.h:1340-1349): groupingSets are
    lists of OUTPUT grouping columns; groupingColumns maps each output
    column to its input ("name<type>" map keys)."""
    grouping_columns = {parse_map_key_variable(k): parse_variable(v)
                        for k, v in (d.get("groupingColumns") or {}).items()}
    return P.GroupIdNode(
        d["id"], _src(d),
        [[parse_variable(v) for v in s] for s in d["groupingSets"]],
        grouping_columns,
        [parse_variable(v) for v in d.get("aggregationArguments") or []],
        parse_variable(d["groupIdVariable"]))


def _t_join(d: dict) -> P.PlanNode:
    jt = d["type"]
    if jt not in (P.INNER, P.LEFT, P.RIGHT, P.FULL):
        raise PlanTranslationError(f"join type {jt!r}")
    criteria = [(parse_variable(c["left"]), parse_variable(c["right"]))
                for c in d.get("criteria") or []]
    filt = translate_expr(d["filter"]) if d.get("filter") else None
    dyn = {fid: parse_variable(v).name
           for fid, v in (d.get("dynamicFilters") or {}).items()}
    return P.JoinNode(d["id"], jt, translate_node(d["left"]),
                      translate_node(d["right"]), criteria,
                      [parse_variable(v) for v in d["outputVariables"]],
                      filt, d.get("distributionType"), dyn)


def _t_semi_join(d: dict) -> P.PlanNode:
    return P.SemiJoinNode(
        d["id"], _src(d), translate_node(d["filteringSource"]),
        parse_variable(d["sourceJoinVariable"]),
        parse_variable(d["filteringSourceJoinVariable"]),
        parse_variable(d["semiJoinOutput"]))


def _t_remote_source(d: dict) -> P.PlanNode:
    return P.RemoteSourceNode(
        d["id"], [str(f) for f in d["sourceFragmentIds"]],
        [parse_variable(v) for v in d["outputVariables"]],
        bool(d.get("ensureSourceOrdering", False)),
        _ordering_scheme(d.get("orderingScheme")))


def _t_exchange(d: dict) -> P.PlanNode:
    scheme = _partitioning_scheme(d["partitioningScheme"])
    return P.ExchangeNode(
        d["id"], d["type"], d["scope"], scheme,
        [translate_node(s) for s in d["sources"]],
        [[parse_variable(v) for v in row] for row in d.get("inputs") or []])


_BOUND = {"UNBOUNDED_PRECEDING": "UNBOUNDED_PRECEDING",
          "PRECEDING": "PRECEDING", "CURRENT_ROW": "CURRENT",
          "FOLLOWING": "FOLLOWING",
          "UNBOUNDED_FOLLOWING": "UNBOUNDED_FOLLOWING"}


def _resolve_constant_int(src: P.PlanNode, expr: RowExpression):
    """Resolve a frame-offset RowExpression to a Python int.  The
    coordinator binds offsets as variables assigned constants by a
    projection below the window (WindowNode.Frame startValue/endValue are
    variable references); walk the source subtree's projections for the
    binding (the constant-propagation step the native worker performs in
    toVeloxQueryPlan's frame conversion)."""
    if isinstance(expr, ConstantExpression):
        return int(expr.value)
    if isinstance(expr, VariableReferenceExpression):
        for n in P.walk_plan(src):
            if isinstance(n, P.ProjectNode):
                for v, e in n.assignments.items():
                    if v.name == expr.name and \
                            isinstance(e, ConstantExpression):
                        return int(e.value)
    raise PlanTranslationError(
        f"window frame offset is not a resolvable constant: {expr!r}")


def _t_window(d: dict) -> P.PlanNode:
    spec = d["specification"]
    part = [parse_variable(v) for v in spec.get("partitionBy") or []]
    ordering = _ordering_scheme(spec.get("orderingScheme"))
    source = _src(d)
    funcs: Dict[VariableReferenceExpression, P.WindowFunction] = {}
    for key, f in (d.get("windowFunctions") or {}).items():
        var = parse_map_key_variable(key)
        call = translate_expr(f["functionCall"])
        frame_j = f.get("frame") or {}
        frame = None
        if frame_j:
            start = _BOUND[frame_j["startType"]]
            end = _BOUND[frame_j["endType"]]
            def _offset(which):
                if not frame_j.get(which + "Value"):
                    return None
                try:
                    return _resolve_constant_int(
                        source, translate_expr(frame_j[which + "Value"]))
                except PlanTranslationError:
                    # Frame.originalStartValue/originalEndValue carry the
                    # source text of the offset (presto_protocol_core.h:
                    # 1324-1325) — a literal offset parses directly
                    orig = frame_j.get("original" + which.capitalize()
                                       + "Value")
                    if orig is not None:
                        try:
                            return int(str(orig))
                        except ValueError:
                            pass
                    raise

            so = _offset("start")
            eo = _offset("end")
            if frame_j["type"] != "ROWS" and (so is not None
                                              or eo is not None):
                # the window executor implements offset bounds for ROWS
                # frames only (operators.py frame_bounds); RANGE/GROUPS
                # offsets must stay a translate-time rejection
                raise PlanTranslationError(
                    f"{frame_j['type']} frames with value offsets are "
                    f"not supported")
            if not (frame_j["type"] == "RANGE" and so is None and eo is None
                    and start == "UNBOUNDED_PRECEDING" and end == "CURRENT"):
                frame = {"type": frame_j["type"], "startKind": start,
                         "startOffset": so, "endKind": end,
                         "endOffset": eo}
        funcs[var] = P.WindowFunction(call, frame)
    return P.WindowNode(d["id"], source, part, ordering, funcs)


def _row_number_limited(node_id: str, source: P.PlanNode,
                        part: List[VariableReferenceExpression],
                        ordering: Optional[P.OrderingScheme],
                        rn: VariableReferenceExpression,
                        limit: Optional[int]) -> P.PlanNode:
    """row_number() window, optionally filtered to rn <= limit — the
    shared lowering for RowNumberNode.maxRowCountPerPartition and
    TopNRowNumberNode (the reference's TopNRowNumberOperator is an
    execution-time optimization of exactly this pair)."""
    from ..spi.expr import call as _mkcall, constant as _mkconst
    win = P.WindowNode(node_id, source, part, ordering,
                       {rn: P.WindowFunction(
                           CallExpression("row_number", BIGINT, []), None)})
    if limit is None:
        return win
    pred = _mkcall("lte", parse_type("boolean"), rn,
                   _mkconst(int(limit), BIGINT))
    return P.FilterNode(node_id + ".topn", win, pred)


def _t_topn_row_number(d: dict) -> P.PlanNode:
    """TopNRowNumberNode (presto_protocol_core.h:2417-2426)."""
    spec = d["specification"]
    return _row_number_limited(
        d["id"], _src(d),
        [parse_variable(v) for v in spec.get("partitionBy") or []],
        _ordering_scheme(spec.get("orderingScheme")),
        parse_variable(d["rowNumberVariable"]),
        int(d["maxRowCountPerPartition"]))


def _t_row_number(d: dict) -> P.PlanNode:
    return _row_number_limited(
        d["id"], _src(d),
        [parse_variable(v) for v in d.get("partitionBy") or []],
        None, parse_variable(d["rowNumberVariable"]),
        d.get("maxRowCountPerPartition"))


_TABLE_WRITE_INFO = contextvars.ContextVar("table_write_info",
                                           default=None)


def _write_target():
    """The task update's TableWriteInfo writer target
    (presto_protocol_core.h:726; ExecutionWriterTarget subtypes
    CreateHandle/InsertHandle — ExecutionWriterTarget.java:30-35).
    Returns (connector_id, table_name)."""
    twi = _TABLE_WRITE_INFO.get() or {}
    target = twi.get("writerTarget") or {}
    handle = target.get("handle") or {}
    cid = handle.get("connectorId")
    stn = target.get("schemaTableName") or {}
    table = stn.get("table")
    if not cid or not table:
        raise PlanTranslationError(
            "TableWriterNode needs TaskUpdateRequest.tableWriteInfo "
            "with a CreateHandle/InsertHandle writer target")
    return cid, table


def _t_table_writer(d: dict) -> P.PlanNode:
    """TableWriterNode (presto_protocol_core.h:2279-2292,
    TableWriterOperator.java:78).  The wire node carries the output
    variables and column names; the TARGET rides the task update's
    TableWriteInfo (the struct's own target is 'TODO' upstream too)."""
    cid, table = _write_target()
    outputs = [parse_variable(d["rowCountVariable"]),
               parse_variable(d["fragmentVariable"])]
    if d.get("tableCommitContextVariable"):
        outputs.append(parse_variable(d["tableCommitContextVariable"]))
    return P.TableWriterNode(
        d["id"], _src(d), cid, table,
        [str(c) for c in d.get("columnNames") or []], outputs)


def _t_table_finish(d: dict) -> P.PlanNode:
    """TableFinishNode (TableFinishNode.java:46-52,
    TableFinishOperator.java): commits the staged fragments, emits the
    row count."""
    cid, table = _write_target()
    return P.TableFinishNode(
        d["id"], _src(d), cid, table,
        [parse_variable(d["rowCountVariable"])])


def _t_unnest(d: dict) -> P.PlanNode:
    """UnnestNode (presto_protocol_core.h:2431-2438,
    PrestoToVeloxQueryPlan's toVeloxQueryPlan(UnnestNode),
    UnnestOperator.java): unnestVariables is a Jackson map keyed by the
    serialized variable."""
    unnest = []
    for k, elems in (d.get("unnestVariables") or {}).items():
        unnest.append((parse_map_key_variable(k),
                       [parse_variable(e) for e in elems]))
    ov = d.get("ordinalityVariable")
    return P.UnnestNode(
        d["id"], _src(d),
        [parse_variable(v) for v in d.get("replicateVariables") or []],
        unnest, None if ov is None else parse_variable(ov))


_NODE_HANDLERS = {
    ".TableScanNode": _t_tablescan,
    ".FilterNode": _t_filter,
    ".ProjectNode": _t_project,
    ".OutputNode": _t_output,
    ".ValuesNode": _t_values,
    ".LimitNode": _t_limit,
    ".TopNNode": _t_topn,
    ".SortNode": _t_sort,
    ".DistinctLimitNode": _t_distinct_limit,
    ".MarkDistinctNode": _t_mark_distinct,
    ".AggregationNode": _t_aggregation,
    ".GroupIdNode": _t_group_id,
    ".TopNRowNumberNode": _t_topn_row_number,
    ".JoinNode": _t_join,
    ".SemiJoinNode": _t_semi_join,
    ".WindowNode": _t_window,
    ".EnforceSingleRowNode": _t_enforce_single_row,
    ".AssignUniqueId": _t_assign_unique_id,
    ".ExchangeNode": _t_exchange,
    ".RemoteSourceNode": _t_remote_source,
    ".RowNumberNode": _t_row_number,
    ".UnnestNode": _t_unnest,
    ".TableWriterNode": _t_table_writer,
    ".TableFinishNode": _t_table_finish,
}


def translate_node(d: dict) -> P.PlanNode:
    """Dispatch on "@type".  Jackson emits either the MINIMAL_CLASS form
    (".FilterNode") or a full class name depending on which package the
    node class lives in — and that has shifted across releases — so both
    spellings normalize to the bare ".Name" key."""
    t = d.get("@type") or ""
    key = "." + t.rsplit(".", 1)[-1] if "." in t[1:] else t
    handler = _NODE_HANDLERS.get(key)
    if handler is None:
        raise PlanTranslationError(f"unsupported plan node @type {t!r}")
    return handler(d)


# ---------------------------------------------------------------------------
# fragment (toVeloxQueryPlan(PlanFragment) analog)
# ---------------------------------------------------------------------------

def _system_partitioning(handle: dict) -> str:
    """PartitioningHandle {connectorHandle: $remote SystemPartitioningHandle
    {partitioning, function}} -> repo *_DISTRIBUTION constant
    (SystemPartitioningHandle.java:62-68)."""
    ch = (handle or {}).get("connectorHandle") or {}
    if not ch:
        return P.SOURCE_DISTRIBUTION        # absent handle: leaf default
    if "partitioning" not in ch:
        # a connector partitioning handle (e.g. hive bucketing) — mapping
        # it to a system distribution would silently mis-partition output
        raise PlanTranslationError(
            f"non-system partitioning handle {ch.get('@type')!r}")
    part = ch["partitioning"]
    func = ch.get("function", "UNKNOWN")
    if part == "SOURCE":
        return P.SOURCE_DISTRIBUTION
    if part == "SINGLE" or part == "COORDINATOR_ONLY":
        return P.SINGLE_DISTRIBUTION
    if part == "SCALED":
        return P.SCALED_WRITER_DISTRIBUTION
    if part in ("FIXED", "ARBITRARY"):
        if func == "HASH":
            return P.FIXED_HASH_DISTRIBUTION
        if func == "BROADCAST":
            return P.FIXED_BROADCAST_DISTRIBUTION
        return P.FIXED_ARBITRARY_DISTRIBUTION
    raise PlanTranslationError(f"partitioning {part!r}/{func!r}")


def _partitioning_scheme(d: dict) -> P.PartitioningScheme:
    part = d["partitioning"]
    handle = _system_partitioning(part.get("handle"))
    args = []
    for a in part.get("arguments") or []:
        e = translate_expr(a)
        if isinstance(e, VariableReferenceExpression):
            args.append(e)
        elif not isinstance(e, ConstantExpression):
            raise PlanTranslationError(
                "unsupported partitioning argument")
        # constants (hive bucket-function payloads) hash identically for
        # every row — dropping them still yields a consistent partition
        # mapping for a system exchange
    return P.PartitioningScheme(
        handle, args, [parse_variable(v) for v in d["outputLayout"]])


def is_reference_fragment(d: dict) -> bool:
    """Distinguish a coordinator-shaped fragment from the repo's own
    serialization (both tag nodes with "@type"): the reference shape
    carries tableScanSchedulingOrder / stageExecutionDescriptor / a
    variables list (PlanFragment, presto_protocol_core.h:1936-1946)."""
    return ("tableScanSchedulingOrder" in d or "stageExecutionDescriptor"
            in d or "variables" in d)


def translate_fragment(d: dict,
                       table_write_info: Optional[dict] = None
                       ) -> P.PlanFragment:
    token = _TABLE_WRITE_INFO.set(table_write_info)
    try:
        return _translate_fragment_inner(d)
    finally:
        _TABLE_WRITE_INFO.reset(token)


def _translate_fragment_inner(d: dict) -> P.PlanFragment:
    root = translate_node(d["root"])
    partitioning = _system_partitioning(d.get("partitioning"))
    scheme = _partitioning_scheme(d["partitioningScheme"])
    scan_ids = [str(x) for x in d.get("tableScanSchedulingOrder") or []]
    if not scan_ids:
        scan_ids = [n.id for n in P.walk_plan(root)
                    if isinstance(n, P.TableScanNode)]
    return P.PlanFragment(str(d["id"]), root, partitioning, scheme, scan_ids)
