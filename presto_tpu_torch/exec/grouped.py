"""Grouped (lifespan) execution: run a fused join + aggregation pipeline
bucket by bucket, so peak device memory is about 1/K of the whole-table
footprint (the port of presto_tpu/exec/grouped.py).

When the tables under a join are bucketed on the join key, a stage runs
one bucket Lifespan at a time instead of building the whole hash table
at once (Presto's Lifespan / GroupedExecutionTagger, session
grouped_execution): this is how Presto bounds memory for huge joins
without spilling.

  * Buckets come from the connector's co-bucketed layout
    (connectors/catalog.py bucket_layout): a key range maps to contiguous
    ROW RANGES in every co-bucketed table, so "repartitioning" is split
    arithmetic -- no shuffle pass, no spill files.
  * One bucket = the fused chain applied to the bucket's scan chunks (in
    steps of up to pipeline.CHAIN_STEP_ROWS rows), its keys and
    aggregate inputs concatenated and aggregated by sort
    (operators.sort_group_aggregate): fully general over grouping keys,
    no functional-dependency requirement.  No kernel: the reference
    computes this with XLA ops outside any Pallas kernel.
  * Bucketed builds are restricted to the bucket's row range (a
    DirectTable over the bucket's key span for a unique key, a
    hash-sorted BuildTable probed with a k-way expansion otherwise);
    other builds are shared by every bucket.
  * Lifespan sharding: the distributed scheduler gives every task of a
    grouped-eligible source stage (stage_shards_lifespans) the full
    splits and TaskContext.grouped_shard = (i, N); task i then runs
    buckets i, i+N, ... and the FINAL stage merges the per-bucket
    partial aggregates.

Correctness: the anchor group key IS the bucket key, so every output
group lives in exactly one bucket; a bucketed build restricted to the
bucket's key range drops only build rows no probe row of this bucket can
match.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import torch

from ..connectors import catalog
from ..spi import plan as P
from ..spi.expr import VariableReferenceExpression
from . import operators as ops
from .batch import Batch

# keyspace span above which auto mode engages, and the per-bucket span it
# targets (accumulator footprint and build-table size scale with the span)
AUTO_SPAN_THRESHOLD = 1 << 24
TARGET_BUCKET_SPAN = 1 << 22


def _resolve_to_scan(node: P.PlanNode, var_name: str):
    """Walk pass-through nodes to the TableScan column `var_name` reads, or
    None when the variable is computed (the identity-lineage check a
    bucketing decision needs)."""
    while True:
        if isinstance(node, P.ProjectNode):
            expr = next((e for v, e in node.assignments.items()
                         if v.name == var_name), None)
            if not isinstance(expr, VariableReferenceExpression):
                return None
            var_name = expr.name
            node = node.source
        elif isinstance(node, P.FilterNode):
            node = node.source
        elif isinstance(node, P.ExchangeNode) and not node.inputs \
                and len(node.exchange_sources) == 1:
            src = node.exchange_sources[0]
            outer = [v.name for v in node.partitioning_scheme.output_layout]
            inner = [v.name for v in src.output_variables]
            try:
                var_name = inner[outer.index(var_name)]
            except ValueError:
                return None
            node = src
        elif isinstance(node, P.JoinNode):
            left_names = {v.name for v in node.left.output_variables}
            node = node.left if var_name in left_names else node.right
        elif isinstance(node, P.SemiJoinNode):
            if var_name == node.semi_join_output.name:
                return None
            node = node.source
        elif isinstance(node, P.TableScanNode):
            for v, col in node.assignments.items():
                if v.name == var_name:
                    return node, col.name
            return None
        else:
            return None


def _materialize_bucket_build(compiler, jn, scan_node, btable: str,
                              rows: Tuple[int, int]) -> Batch:
    """A join's build subtree restricted to one bucket's row range of its
    bucketed scan, through the fused chain (fused_materialize,
    cache=False).

    The compiler memoizes BatchSources per node id, so the scan's cached
    source (whose fused_scan metadata holds the whole table's splits) is
    evicted around the materialization and restored after; other
    consumers of the same node id keep their view.  Raises
    NotImplementedError when the subtree does not run as a fused chain
    (an empty stand-in would drop the bucket's matches)."""
    from .fused import fused_materialize
    cid = scan_node.table.connector_id
    sf = dict(scan_node.table.extra).get("scaleFactor", 0.01)
    ctx = compiler.ctx
    saved_split = ctx.splits.get(scan_node.id)
    saved_src = compiler._sources.pop(scan_node.id, None)
    ctx.splits[scan_node.id] = [catalog.TableSplit(
        cid, btable, sf, rows[0], rows[1])]
    try:
        b = fused_materialize(compiler, jn.right, cache=False)
    finally:
        if saved_split is None:
            ctx.splits.pop(scan_node.id, None)
        else:
            ctx.splits[scan_node.id] = saved_split
        if saved_src is None:
            compiler._sources.pop(scan_node.id, None)
        else:
            compiler._sources[scan_node.id] = saved_src
    if b is None:
        raise NotImplementedError(
            f"grouped execution: the bucketed build over {btable} did not "
            f"run as a fused chain")
    return b


def _full_coverage(splits, table: str, sf: float, cid: str) -> bool:
    """Whether the scan's splits cover the whole table contiguously (a
    task owning a split subset must not re-bucket it)."""
    total = catalog.table_row_count(table, sf, cid)
    ranges = sorted((s.start, s.end) for s in splits)
    pos = 0
    for lo, hi in ranges:
        if lo != pos:
            return False
        pos = hi
    return pos == total


def bucket_table(b: Batch, bkey: str, k: int, G: int, key_lo: int):
    """One bucket's build table and its overflow flag (a device bool): a
    fanout-1 build becomes a DirectTable of G slots keyed off the
    bucket's key_lo (flag: a key duplicated), a fanout-k build the
    hash-sorted BuildTable (flag: a key run longer than k)."""
    from .fused import DirectTable, _direct_builder, _max_run_device
    if k == 1:
        col = b.columns[bkey]
        slots, dup = _direct_builder(G)(col.values, b.mask, key_lo)
        base = torch.tensor([key_lo], dtype=torch.int64,
                            device=col.values.device)
        return DirectTable(slots, base, dict(b.columns)), dup
    tbl = ops.build_table(b, [bkey])
    return tbl, _max_run_device(tbl) > k


class _DupFlags:
    """A bucket's build overflow flags, copied to the host as soon as
    they are computed: on a CUDA device into pinned memory with a
    non-blocking copy and an event, so reading them waits for that
    bucket's builds only, not for whatever was queued after them (the
    next buckets' staging)."""

    def __init__(self, flags: List[torch.Tensor]):
        self._event = None
        self._host = None
        if not flags:
            return
        dev = torch.stack(flags)
        if dev.device.type == "cuda":
            self._host = torch.empty(dev.shape, dtype=torch.bool,
                                     pin_memory=True)
            self._host.copy_(dev, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(dev.device))
        else:
            self._host = dev

    def any(self) -> bool:
        if self._host is None:
            return False
        if self._event is not None:
            self._event.synchronize()  # lint: allow-host-sync
        return bool(self._host.any())


class GroupedRunner:
    """Layout and per-bucket pieces; .run() yields one aggregated batch
    per lifespan.  Built once per compiled aggregation and reused across
    re-executions."""

    def __init__(self, compiler, chain, layout, anchor, dep_names,
                 key_names, specs, agg_exprs_fn, G, expands, shared_aux,
                 per_bucket_builds, key_dtypes, key_dicts, probe_table):
        self.compiler = compiler
        self.chain = chain
        self.layout = layout
        self.anchor = anchor
        self.dep_names = dep_names
        self.key_names = key_names
        self.specs = specs
        self.agg_exprs_fn = agg_exprs_fn
        self.G = G
        self.expands = expands
        self.shared_aux = shared_aux          # None entries = per-bucket
        self.per_bucket_builds = per_bucket_builds
        self.key_dtypes = key_dtypes
        self.key_dicts = key_dicts
        self.probe_table = probe_table
        self.leaf_cap = chain.leaf_cap(expands)
        # parameter fingerprint the shared aux / bucket-0 probe / fanout
        # reservations were built under; the caller rebuilds the runner
        # when a parameterized BUILD subtree sees a different fingerprint
        self.params_fp = compiler.ctx.params_fingerprint
        # bucket 0's (aux, dup flags) built during eligibility; consumed
        # by the first run() so the build work is not repeated
        self._aux0 = None

    # -- per-bucket pieces -------------------------------------------------

    def _bucket_chunks(self, rows: Tuple[int, int]):
        p, end = rows
        out = []
        while p < end:
            n = min(self.leaf_cap, end - p)
            out.append((p, n))
            p += n
        return out

    def _bucket_aux(self, bucket):
        """aux tuple for this bucket: the shared entries plus the bucketed
        build tables, materialized over the bucket's row range (bucket_
        table), and the builds' overflow flags."""
        from .fused import _drop_null_keys
        aux = list(self.shared_aux)
        dups: List[torch.Tensor] = []
        for (ai, jn, scan_node, btable, bkey, k) in self.per_bucket_builds:
            b = _materialize_bucket_build(self.compiler, jn, scan_node,
                                          btable, bucket.rows[btable])
            b = _drop_null_keys(b, (bkey,))
            aux[ai], dup = bucket_table(b, bkey, k, self.G, bucket.key_lo)
            dups.append(dup)
        return tuple(aux), _DupFlags(dups)

    def _aggregate(self, chunks, aux) -> Batch:
        """One bucket: the chain over its chunks in steps of up to
        CHAIN_STEP_ROWS rows, the keys and aggregate inputs concatenated,
        then the sort aggregation."""
        from .pipeline import CHAIN_STEP_ROWS, _chain_steps, _concat
        steps = _chain_steps(chunks, self.leaf_cap,
                             max(1, CHAIN_STEP_ROWS // self.chain.cap))
        parts = []
        for pos, cnt, cap in steps:
            b = self.chain.make(pos, cnt, aux, self.expands, cap)
            cols = {k: b.columns[k] for k in self.key_names}
            for out, col in self.agg_exprs_fn(b).items():
                if col is not None:
                    cols["$in_" + out] = col
            parts.append(Batch(cols, b.mask))
        flat = _concat(parts)
        del parts
        inputs = {s.output: flat.columns.get("$in_" + s.output)
                  for s in self.specs}
        return ops.sort_group_aggregate(
            Batch({k: flat.columns[k] for k in self.key_names}, flat.mask),
            self.key_names, inputs, self.specs, {})

    # -- driver ------------------------------------------------------------

    @staticmethod
    def _check_dups(dup_flags: _DupFlags) -> None:
        if dup_flags.any():
            # a bucketed build's key multiplicity exceeds what was
            # reserved for this bucket (duplicates against a direct
            # table, or a run longer than the fanout-k expansion): the
            # probe would keep an arbitrary subset of matches, and earlier
            # lifespans already streamed downstream, so fail loudly (the
            # single-lifespan path handles any fanout via shared builds)
            raise NotImplementedError(
                "grouped execution: bucketed build key multiplicity "
                "exceeds the reserved fanout within a lifespan")

    def _stage_bucket(self, bi: int, aux0):
        """Stage one bucket: split arithmetic and the bucketed builds.
        Returns (chunks, aux, dup flags), or None for an empty bucket."""
        bucket = self.layout[bi]
        chunks = self._bucket_chunks(bucket.rows[self.probe_table])
        if not chunks:
            return None
        if bi == 0 and aux0 is not None:
            aux, dups = aux0
        else:
            aux, dups = self._bucket_aux(bucket)
        return chunks, aux, dups

    def run(self):
        """Pipelined lifespan loop: keep up to grouped_prefetch_depth
        buckets STAGED (builds materialized) beyond the one being
        consumed, so bucket k+1's build work is queued while bucket k is
        computed and consumed.  Depth 0 is the strictly serial loop.

        With lifespan sharding (TaskContext.grouped_shard = (i, n)) this
        task runs only buckets i, i+n, ... -- the scheduler hands every
        task full splits and disjoint bucket subsets.

        RuntimeStats (the runner's sink in the context):
        groupedBucketGenWallNanos -- host wall staging each bucket;
        groupedBucketComputeWallNanos -- wall from starting a bucket's
        aggregation until downstream finished consuming it;
        groupedRunWallNanos -- the whole loop (overlap shows as run wall
        < gen sum + compute sum)."""
        ctx = self.compiler.ctx
        depth = max(0, ctx.config.grouped_prefetch_depth)
        stats = ctx.runtime_stats
        aux0 = self._aux0
        self._aux0 = None           # one-shot: don't pin memory across runs
        indices = range(len(self.layout))
        shard = ctx.grouped_shard
        if shard is not None:
            indices = range(shard[0], len(self.layout), shard[1])
        t_run = time.perf_counter_ns()  # lint: allow-wall-clock
        it = iter(indices)
        ran = 0
        staged = deque()
        exhausted = False
        while True:
            while not exhausted and len(staged) <= depth:
                bi = next(it, None)
                if bi is None:
                    exhausted = True
                    break
                t0 = time.perf_counter_ns()  # lint: allow-wall-clock
                ent = self._stage_bucket(bi, aux0)
                if stats is not None:
                    stats.add("groupedBucketGenWallNanos",
                              time.perf_counter_ns() - t0)  # lint: allow-wall-clock
                if ent is not None:
                    staged.append(ent)
            if not staged:
                break
            chunks, aux, dups = staged.popleft()
            self._check_dups(dups)
            t0 = time.perf_counter_ns()  # lint: allow-wall-clock
            yield self._aggregate(chunks, aux)
            ran += 1
            if stats is not None:
                stats.add("groupedBucketComputeWallNanos",
                          time.perf_counter_ns() - t0)  # lint: allow-wall-clock
        if stats is not None:
            stats.add("groupedRunWallNanos",
                      time.perf_counter_ns() - t_run)  # lint: allow-wall-clock
            if shard is not None:
                # a stage's tasks share one RuntimeStats: the lifespans
                # each shard ran, under a name of its own
                stats.add(f"groupedShard{shard[0]}of{shard[1]}Lifespans",
                          ran)


def make_grouped_runner(compiler, node, chain, key_names, specs,
                        agg_exprs_fn, basic_specs, has_exprs2,
                        cfg) -> Optional[GroupedRunner]:
    """Eligibility + one-time prep.  Returns a GroupedRunner, or None to
    keep the single-lifespan path.  Called once per compiled
    aggregation; cached by the aggregation compiler."""
    from .fused import MAX_EXPAND, _drop_null_keys, _max_run, assemble_chain
    from .pipeline import PROBE_ROWS
    pool = compiler.ctx.memory
    if pool.budget is not None or has_exprs2 or not key_names:
        return None
    if not basic_specs:
        return None
    # PARTIAL is safe: each bucket's exact aggregate is a valid partial
    # state for the decomposable basic aggregates
    if getattr(node, "step", P.SINGLE) not in (P.SINGLE, P.PARTIAL):
        return None
    K_conf = cfg.grouped_lifespans
    if K_conf == 1:
        return None
    meta = chain.scan_meta
    table, cid, sf = meta.get("table"), meta.get("cid"), meta.get("sf")
    if table is None:
        return None
    bcol = catalog.bucket_column(table, cid)
    if bcol is None:
        return None
    if not _full_coverage(meta["splits"], table, sf, cid):
        return None

    # lineage: which live column names carry the scan's bucket column
    colmap = meta.get("colmap", {})
    carriers = {n for n, c in colmap.items() if c == bcol}
    if not carriers:
        return None
    bucketed_joins: Dict[int, tuple] = {}
    for si, step in enumerate(chain.steps):
        kind = step[0]
        if kind == "project":
            carriers = {v.name for v, e in step[1]
                        if isinstance(e, VariableReferenceExpression)
                        and e.name in carriers}
        elif kind == "rename":
            carriers = {o for o, i in step[1] if i in carriers}
        elif kind == "join":
            jn = step[1]
            hit = None
            for left, right in jn.criteria:
                if left.name not in carriers:
                    continue
                res = _resolve_to_scan(jn.right, right.name)
                if res is None:
                    continue
                scan_node, col2 = res
                t2 = scan_node.table.table_name
                c2 = scan_node.table.connector_id
                if c2 == cid and catalog.bucket_column(t2, c2) == col2:
                    hit = (jn, scan_node, t2, right.name)
                    break
            if hit is not None:
                bucketed_joins[si] = hit
                if jn.join_type == P.INNER:
                    # the matched build key equals the probe key
                    carriers |= {r.name for l, r in jn.criteria
                                 if l.name in carriers}
            # non-bucketed joins share their build: correct, no memory win
        if not carriers:
            return None
    anchor = next((k for k in key_names if k in carriers), None)
    if anchor is None:
        return None     # groups would straddle buckets

    layout1 = catalog.bucket_layout(sf, 1, cid)
    if not layout1:
        return None
    span_total = layout1[-1].key_hi - layout1[0].key_lo
    if K_conf >= 2:
        K = K_conf
    else:               # auto: engage only for huge keyspaces
        if span_total <= AUTO_SPAN_THRESHOLD:
            return None
        K = -(-span_total // TARGET_BUCKET_SPAN)
    layout = catalog.bucket_layout(sf, K, cid)
    if len(layout) <= 1 and K_conf < 2:
        return None
    max_span = max(b.key_hi - b.key_lo for b in layout)
    if max_span > ops.SPAN_AGG_MAX_GROUPS:
        return None
    G = 1 << (max_span - 1).bit_length()

    # shared (bucket-invariant) builds once; bucketed builds defer to the
    # per-bucket lifespan (FusedChain.prep owns the aux-slot layout).  A
    # bucketed build must materialize through the fused chain -- its
    # chunks re-derive from the per-bucket split override -- so a
    # bucketed build that does not fuse is shared instead.
    #
    # Fanout: each deferred join's expansion k is fixed for every bucket,
    # so bucket 0's build is probed now and k sized from its longest key
    # run (k == 1 -> direct table; k > 1 -> hash table probed with a
    # k-way expansion).  A later bucket exceeding k fails loudly
    # (_check_dups).
    fanouts: Dict[int, int] = {}
    for si, (jn, scan_node, t2, bkey) in bucketed_joins.items():
        if assemble_chain(compiler, jn.right) is None:
            continue                    # not fusible: shared instead
        try:
            b0 = _materialize_bucket_build(compiler, jn, scan_node, t2,
                                           layout[0].rows[t2])
        except NotImplementedError:
            continue
        b0 = _drop_null_keys(b0, (bkey,))
        # a one-off sync at eligibility
        kmax = _max_run(ops.build_table(b0, [bkey]))
        if kmax > MAX_EXPAND:
            continue                    # too wide to reserve: shared
        fanouts[si] = 1 if kmax <= 1 else 1 << (kmax - 1).bit_length()

    def _defer(si, jn):
        return fanouts.get(si, 0)

    try:
        prep_res = chain.prep(defer=_defer)
    except NotImplementedError:
        return None
    if prep_res is None:
        return None
    shared_aux, expands, deferred = prep_res
    shared_aux = list(shared_aux)
    per_bucket_builds = [
        (ai, jn, bucketed_joins[si][1], bucketed_joins[si][2],
         bucketed_joins[si][3], fanouts[si])
        for ai, si, jn in deferred]

    runner = GroupedRunner(compiler, chain, layout, anchor,
                           tuple(k for k in key_names if k != anchor),
                           key_names, specs, agg_exprs_fn, G, expands,
                           shared_aux, per_bucket_builds, {}, {}, table)

    # the grouping keys' dtypes and dictionaries: the chain applied once
    # to an empty chunk with bucket 0's aux; the materialized builds are
    # kept on the runner so the first run() does not repeat them
    try:
        aux0, dups0 = runner._bucket_aux(layout[0])
    except NotImplementedError:
        return None
    if dups0.any():
        return None     # non-unique bucketed build key: single lifespan
    runner._aux0 = (aux0, dups0)
    try:
        probe = chain.make(0, 0, aux0, expands, PROBE_ROWS)
    except NotImplementedError:
        return None
    key_dtypes, key_dicts = {}, {}
    for k in key_names:
        c = probe.columns.get(k)
        if c is None or c.lazy is not None:
            return None
        key_dtypes[k] = c.values.dtype
        if c.dictionary is not None:
            key_dicts[k] = c.dictionary
    if probe.columns[anchor].dictionary is not None:
        return None
    if probe.columns[anchor].nulls is not None:
        # nullable bucket key: a NULL anchor has no home bucket, so its
        # group would be duplicated across lifespans (catalog.py
        # bucket_column contract) -- keep the single-lifespan path
        return None
    runner.key_dtypes = key_dtypes
    runner.key_dicts = key_dicts
    return runner


# wrappers a fragment plants above its aggregation that don't change
# whether the agg itself can run grouped
_PEELABLE = (P.ProjectNode, P.FilterNode, P.SortNode, P.TopNNode,
             P.LimitNode)

_SHARDABLE_AGGS = {"sum", "avg", "count", "count_star", "min", "max"}


def stage_shards_lifespans(root: P.PlanNode, cfg) -> bool:
    """Plan-time predicate for the scheduler: may the tasks of this
    SOURCE-distributed fragment be given FULL splits plus disjoint
    round-robin lifespan subsets (TaskContext.grouped_shard) instead of
    the usual split round-robin?

    Mirrors make_grouped_runner's STATIC eligibility conditions (the
    ones decidable without compiling): one bucketed scan, a grouped
    basic aggregation keyed on its bucket column, config gates, and the
    force/auto lifespan-count decision.  A misprediction is safe in
    both directions -- if grouped execution then fails to engage at
    runtime, shard 0 runs the ordinary fallback over the full splits
    and the other shards contribute nothing (the aggregation's gen());
    if it would have engaged but this predicate said no, tasks fall back
    to split subsets, which _full_coverage rejects, and each task runs
    the ordinary single-lifespan path over its subset."""
    from .lowering import canonical_name
    if not cfg.grouped_lifespan_sharding or not cfg.fuse_pipelines:
        return False
    if cfg.grouped_lifespans == 1 or cfg.memory_budget_bytes is not None \
            or cfg.memory_max_query_bytes is not None:
        return False
    node = root
    while isinstance(node, _PEELABLE):
        node = node.source
    if not isinstance(node, P.AggregationNode):
        return False
    if getattr(node, "step", P.SINGLE) not in (P.SINGLE, P.PARTIAL):
        return False
    if not node.grouping_keys:
        return False
    for agg in node.aggregations.values():
        if agg.distinct or agg.mask is not None:
            return False
        fname = canonical_name(agg.call.display_name)
        if fname == "count" and not agg.call.arguments:
            fname = "count_star"
        if fname not in _SHARDABLE_AGGS:
            return False
    # exactly one scan subtree: broadcast build sides arrive as
    # RemoteSources in a SOURCE fragment, so >1 scan means a co-located
    # join shape the runtime walker would have to re-verify per task
    scans = [n for n in P.walk_plan(node)
             if isinstance(n, P.TableScanNode)]
    if len(scans) != 1:
        return False
    scan = scans[0]
    table = scan.table.table_name
    cid = scan.table.connector_id
    bcol = catalog.bucket_column(table, cid)
    if bcol is None:
        return False
    if not any((_resolve_to_scan(node.source, k.name) or (None, None))
               == (scan, bcol) for k in node.grouping_keys):
        return False
    if cfg.grouped_lifespans >= 2:
        return True
    sf = dict(scan.table.extra).get("scaleFactor", 0.01)
    layout1 = catalog.bucket_layout(sf, 1, cid)
    if not layout1:
        return False
    return layout1[-1].key_hi - layout1[0].key_lo > AUTO_SPAN_THRESHOLD
