"""Plan pretty-printer for EXPLAIN / EXPLAIN ANALYZE.

The analog of the reference's PlanPrinter
(presto-main-base/.../sql/planner/planPrinter/PlanPrinter.java) in its
text mode: one indented line per node with the node's distinguishing
details, optionally annotated with runtime stats collected during an
EXPLAIN ANALYZE execution (ExplainAnalyzeOperator.java +
RuntimeStats, presto-common/.../common/RuntimeStats.java)."""
from __future__ import annotations

from typing import Dict, List, Optional

from ..spi import plan as P


def _vars(vs, limit: int = 6) -> str:
    names = [v.name for v in vs]
    if len(names) > limit:
        names = names[:limit] + [f"... {len(vs) - limit} more"]
    return ", ".join(names)


def _details(node: P.PlanNode) -> str:
    if isinstance(node, P.TableScanNode):
        s = (f"table = {node.table.connector_id}.{node.table.table_name}"
             f" [{_vars(node.outputs)}]")
        pd = getattr(node, "pushdown", None)
        if pd:
            s += ", pushdown = [" + ", ".join(
                f"{e['column']} {e['op']} {e['value']}" for e in pd) + "]"
        return s
    if isinstance(node, P.FilterNode):
        return f"predicate = {node.predicate}"
    if isinstance(node, P.ProjectNode):
        exprs = [f"{v.name} := {e}" for v, e in node.assignments.items()
                 if str(getattr(e, 'name', None)) != v.name]
        s = "; ".join(exprs[:4])
        if len(exprs) > 4:
            s += f"; ... {len(exprs) - 4} more"
        return s
    if isinstance(node, P.AggregationNode):
        aggs = [f"{v.name} := {a.call}" for v, a in node.aggregations.items()]
        return (f"step = {node.step}, keys = [{_vars(node.grouping_keys)}], "
                + "; ".join(aggs[:4]))
    if isinstance(node, P.JoinNode):
        crit = ", ".join(f"{l.name} = {r.name}" for l, r in node.criteria)
        extra = f", filter = {node.filter}" if node.filter is not None else ""
        if node.dynamic_filters:
            dfs = ", ".join(f"{df}:{v}" for v, df in
                            sorted(node.dynamic_filters.items()))
            extra += f", dynamicFilters = [{dfs}]"
        return f"type = {node.join_type}, criteria = [{crit}]{extra}"
    if isinstance(node, P.SemiJoinNode):
        return (f"{node.source_join_variable.name} IN "
                f"{node.filtering_source_join_variable.name} "
                f"-> {node.semi_join_output.name}")
    if isinstance(node, (P.SortNode, P.TopNNode)):
        keys = ", ".join(f"{v.name} {o}" for v, o in
                         node.ordering_scheme.orderings)
        n = f", count = {node.count}" if isinstance(node, P.TopNNode) else ""
        return f"orderBy = [{keys}]{n}"
    if isinstance(node, P.LimitNode):
        return f"count = {node.count}"
    if isinstance(node, P.WindowNode):
        funcs = ", ".join(f"{v.name} := {f.call}"
                          for v, f in node.window_functions.items())
        order = ""
        if node.ordering_scheme:
            order = " orderBy = [" + ", ".join(
                f"{v.name} {o}" for v, o in
                node.ordering_scheme.orderings) + "]"
        return (f"partitionBy = [{_vars(node.partition_by)}]{order} | "
                + funcs)
    if isinstance(node, P.ExchangeNode):
        fabric = ("" if node.partitioning_scheme.fabric is None
                  else f", fabric = {node.partitioning_scheme.fabric}")
        return (f"type = {node.exchange_type}, scope = {node.scope}, "
                f"partitioning = {node.partitioning_scheme.handle}"
                f"{fabric}")
    if isinstance(node, P.RemoteSourceNode):
        return f"sourceFragments = {node.source_fragment_ids}"
    if isinstance(node, P.OutputNode):
        return f"[{', '.join(node.column_names)}]"
    if isinstance(node, P.UnionNode):
        return f"{len(node.inputs)} inputs [{_vars(node.outputs)}]"
    if isinstance(node, P.ValuesNode):
        return f"{len(node.rows)} rows"
    if isinstance(node, P.DistinctLimitNode):
        return f"count = {node.count}, keys = [{_vars(node.distinct_variables)}]"
    return ""


def format_plan(node: P.PlanNode,
                stats: Optional[Dict[str, dict]] = None) -> str:
    """Indented textual plan with cost-based row estimates (the PlanPrinter's
    `Estimates: {rows: N}` annotations backed by sql/stats.py); stats
    (node id -> {rows, wall_s, invocations}) annotate each line when given
    (EXPLAIN ANALYZE)."""
    from .stats import StatsCalculator
    calc = StatsCalculator()
    lines: List[str] = []

    def walk(n: P.PlanNode, depth: int) -> None:
        name = type(n).__name__.replace("Node", "")
        detail = _details(n)
        line = "   " * depth + f"- {name}"
        if detail:
            line += f" [{detail}]"
        try:
            est = calc.rows(n)
        except Exception:
            est = None
        if est is not None:
            line += f"  {{rows≈{est:,.0f}}}"
        if stats is not None and n.id in stats:
            s = stats[n.id]
            line += (f"  {{rows: {s['rows']:,}, "
                     f"wall: {s['wall_s'] * 1e3:,.1f}ms, "
                     f"batches: {s['batches']}}}")
            if s.get("bytes"):
                line += f"  {{bytes≈{s['bytes']:,}}}"
            if s.get("fused"):
                # the node ran inside ONE fused XLA program: rows are its
                # device-side counter; the wall is the whole program's
                line += "  [fused]"
            if s.get("driver_walls"):
                # per-driver walls from task_concurrency leaf drains
                # (local_exchange.parallel_drain): sum(driver walls) -
                # stage wall is the measured overlap
                dw = ", ".join(f"{w * 1e3:,.0f}ms"
                               for w in s["driver_walls"])
                line += f"  {{driver_walls: [{dw}]}}"
            if s.get("dynamicFilterRowsDropped"):
                line += (f"  {{dynamicFilterRowsDropped: "
                         f"{s['dynamicFilterRowsDropped']:,}}}")
        lines.append(line)
        for ch in n.sources:
            walk(ch, depth + 1)

    walk(node, 0)
    rule_stats = getattr(node, "rule_stats", None)
    if rule_stats:
        # per-rule hit counts from the iterative optimizer (sql/rules.py;
        # the reference's optimizerInformation in the query plan JSON)
        fired = ", ".join(f"{k}: {v}"
                          for k, v in sorted(rule_stats.items()))
        lines.append(f"Optimizer rules fired: {{{fired}}}")
    return "\n".join(lines)


def format_analyze_footer(runtime_stats, profile_dir: str = None) -> str:
    """EXPLAIN ANALYZE footer: fusion-declined counters (the reasons a
    scan chain stayed on the streaming path) and the fused program wall,
    pulled from the execution's RuntimeStats; plus the device-profiler
    capture directory when the `profile` session property wrapped the
    run.  Empty string when nothing was recorded."""
    if runtime_stats is None:
        if profile_dir:
            return f"Device profile: {profile_dir}"
        return ""
    rs = runtime_stats.to_dict() if hasattr(runtime_stats, "to_dict") \
        else dict(runtime_stats)
    declined = {k[len("fusionDeclined"):]: int(v["sum"])
                for k, v in rs.items() if k.startswith("fusionDeclined")}
    lines: List[str] = []
    if declined:
        body = ", ".join(f"{k}: {v}" for k, v in sorted(declined.items()))
        lines.append(f"Fusion declined: {{{body}}}")
    # the scan-kernel twin of the fusion counters: how many fused scans
    # ran a hand-written CUDA kernel, and why the rest stayed on the torch
    # chain (exec/kernels KERNEL_DECLINE_REASONS)
    kdeclined = {k[len("kernelDeclined"):]: int(v["sum"])
                 for k, v in rs.items() if k.startswith("kernelDeclined")}
    if kdeclined:
        body = ", ".join(f"{k}: {v}" for k, v in sorted(kdeclined.items()))
        lines.append(f"Scan kernel declined: {{{body}}}")
    kp = rs.get("kernelScanPrograms")
    if kp:
        lines.append(f"CUDA scan kernels: {int(kp['sum'])}")
    kw = rs.get("kernelWindowPrograms")
    if kw:
        lines.append(f"CUDA window kernels: {int(kw['sum'])}")
    ov = rs.get("kernelDmaOverlapFraction")
    if ov and ov.get("count"):
        # scan.kernel-dma = double: fraction of staged block slabs whose
        # copy into the shared-memory ring was issued while the previous
        # block computed
        lines.append(f"Kernel DMA overlap: "
                     f"{ov['sum'] / ov['count']:.2f} "
                     f"(double-buffered, {ov['count']} kernel(s))")
    fw = rs.get("fusedProgramWallNanos")
    if fw:
        lines.append(f"Fused program wall: {fw['sum'] / 1e6:,.1f}ms "
                     f"over {fw['count']} program(s)")
    cpu = rs.get("driverCpuNanos")
    wall = rs.get("driverWallNanos")
    if cpu and wall and wall.get("sum"):
        # cumulative thread-time vs wall at the driver boundaries: a low
        # ratio means drivers sat waiting (device, exchange, admission)
        # rather than computing
        lines.append(f"Driver CPU/wall: {cpu['sum'] / 1e6:,.1f}ms / "
                     f"{wall['sum'] / 1e6:,.1f}ms "
                     f"({cpu['sum'] / wall['sum']:.2f} busy)")
    sp = rs.get("spillBytes")
    if sp and sp.get("sum"):
        # two-tier spill: bytes staged to the host tier, the fraction of
        # device->host eviction that overlapped operator compute (async
        # staging), and what overflowed on to disk
        ovf = rs.get("spillOverlapFraction")
        frac = (ovf["sum"] / ovf["count"]
                if ovf and ovf.get("count") else 0.0)
        line = (f"Spilled: {sp['sum'] / (1 << 20):,.1f} MB "
                f"({frac * 100:.0f}% overlapped)")
        dk = rs.get("spillDiskBytes")
        if dk and dk.get("sum"):
            line += f", {dk['sum'] / (1 << 20):,.1f} MB to disk"
        lines.append(line)
    sb = rs.get("spoolBytes")
    if sb and sb.get("sum"):
        # retry-policy=task: raw page bytes durably staged through the
        # spooled exchange before the producers acknowledged them
        lines.append(f"Spooled: {sb['sum'] / (1 << 20):,.1f} MB "
                     f"across {sb['count']} task(s)")
    dfc = rs.get("dynamicFiltersCollected")
    dfi = rs.get("dynamicFilterRowsIn")
    if dfc or dfi:
        # runtime dynamic filters: how many build-side domains arrived,
        # how many scans applied one, and the fraction of scanned rows
        # the applied filters removed before the join
        collected = int(dfc["sum"]) if dfc else 0
        applied = int(dfi["count"]) if dfi else 0
        rows_in = int(dfi["sum"]) if dfi else 0
        dfp = rs.get("dynamicFilterRowsPruned")
        pruned = int(dfp["sum"]) if dfp else 0
        pct = 100.0 * pruned / rows_in if rows_in else 0.0
        lines.append(f"Dynamic filters: {collected} collected, "
                     f"{applied} applied, {pct:.1f}% rows pruned")
    flips = rs.get("adaptiveExchangeFlips")
    swaps = rs.get("adaptiveSideSwaps")
    if (flips and flips.get("sum")) or (swaps and swaps.get("sum")):
        # cardinality-driven exchange re-decisions made at stage
        # boundaries from OBSERVED build-side rows (adaptive.exchange)
        lines.append(f"Adaptive decisions: "
                     f"{int(flips['sum']) if flips else 0} "
                     f"exchange(s) flipped to broadcast, "
                     f"{int(swaps['sum']) if swaps else 0} "
                     f"join side swap(s)")
    # serving-plane micro-batching: process-wide counters (the batcher
    # lives above any single execution, so per-run RuntimeStats cannot
    # carry them); shown only once batches have actually formed
    try:
        from ..serving import SERVING_METRICS
        sv = SERVING_METRICS.snapshot()
        if sv.get("servingBatches"):
            occ = (sv["servingBatchQueries"] / sv["servingBatches"])
            lines.append(
                f"Serving micro-batches: {sv['servingBatches']} "
                f"({occ:.1f} avg occupancy, "
                f"{sv['servingBatchLaunchesSaved']} launch(es) saved, "
                f"demux {sv['servingBatchDemuxNanos'] / 1e6:,.1f}ms)")
    except Exception:   # noqa: BLE001 — footer is advisory
        pass
    if profile_dir:
        # where the device profiler wrote this run's capture (a
        # torch.profiler Chrome trace, telemetry/profiler.py)
        lines.append(f"Device profile: {profile_dir}")
    return "\n".join(lines)


def format_validation(diags_by_stage) -> str:
    """EXPLAIN (TYPE VALIDATE) body: one section per checker stage with
    its diagnostic list, "PASSED" for clean stages (the reference's
    VALIDATE explain prints nothing on success; listing each stage shows
    WHICH passes ran)."""
    lines: List[str] = []
    total = 0
    for stage, diags in diags_by_stage:
        lines.append(f"== {stage} ==")
        if not diags:
            lines.append("PASSED")
        else:
            total += len(diags)
            lines.extend(f"  {d}" for d in diags)
        lines.append("")
    lines.append(f"{total} diagnostic(s)"
                 if total else "plan validation PASSED")
    return "\n".join(lines)


def format_subplan(subplan, stats: Optional[Dict[str, dict]] = None) -> str:
    """Fragmented (distributed) plan: one section per fragment."""
    lines: List[str] = []

    def walk(sp, depth: int) -> None:
        f = sp.fragment
        scheme = f.output_partitioning_scheme
        fabric = ("" if getattr(scheme, "fabric", None) is None
                  else f" fabric={scheme.fabric}")
        lines.append(f"Fragment {f.fragment_id} [{f.partitioning}]"
                     f"{fabric}")
        lines.append(format_plan(f.root, stats))
        lines.append("")
        for ch in sp.children:
            walk(ch, depth + 1)

    walk(subplan, 0)
    return "\n".join(lines).rstrip()
