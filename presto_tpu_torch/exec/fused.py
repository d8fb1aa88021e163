"""Fused scan -> filter/project -> fanout-1 join chains (the port of
presto_tpu/exec/fused.py).

`assemble_chain` walks a Filter/Project/Join/SemiJoin chain down to a
device-generated TableScan and describes it as a `FusedChain`: the steps
in leaf->root order plus the scan's metadata (resident columns, zone
maps, pushdown).  `FusedChain.prep` materializes every join and semi-join
build side through the streaming Scan/Filter/Project sources and builds
its lookup table:

  * DirectTable -- dense integer key: a direct-address int32 slot array
    keyed by (key - base); the probe is one gather.
  * the hash-sorted ops.BuildTable -- multi-column or sparse keys; the
    probe is one binary search over the sorted key hashes.

Build rows with NULL keys are dropped (SQL equi-join: NULL never
matches); a semi build records whether it held one, for the marker's
three-valued output.  The scan kernels (kernels/scan_kernel.py,
kernels/grouped.py) run the chain, join probes included (kernel #5,
kernels/join.py).  After a kernel's metered decline (or under
scan_kernel="xla") the aggregation runs the chain in torch, one scan
chunk at a time: `FusedChain.make` applies the scan leaf and every step
to a chunk, a join through `_apply_join` (fanout 1: LEFT null-extension
and the residual ON filter included) or `_apply_join_expand` (fanout k:
each probe row expands into k candidate build slots, the chunk shrunk by
the chain's fanout product), a semi step as the three-valued marker, a uid
step as position-keyed unique ids.  `fused_materialize` runs a whole
chain into one batch (join build sides, cached per structural key), and
`fused_stream` yields it chunk by chunk (the streaming Join / SemiJoin
compilers).  Not ported: the packed gather (each build column is
gathered by index).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..spi import plan as P
from . import operators as ops
from .batch import Batch, Column
from .lowering import expr_has_params

# absolute cap on a direct-address table (entries), and the max ratio of
# key span to build rows before the hash-sorted table takes over
DIRECT_TABLE_MAX = 1 << 26
DIRECT_TABLE_SPAN_RATIO = 8
# largest per-join fanout the (reference's) in-loop expansion handles,
# and the largest combined expansion across a chain
MAX_EXPAND = 64
MAX_EXPAND_PRODUCT = 256


@dataclass
class DirectTable:
    """Direct-address build table for a dense integer key."""
    slots: torch.Tensor               # int32 build-row index, -1 = absent
    base: torch.Tensor                # int64 [1]: smallest key
    columns: Dict[str, Column]        # original build columns


def _direct_builder(size: int):
    def build(values, mask, base: int):
        k = torch.where(mask, values.to(torch.int64) - base,
                        torch.full_like(values, size, dtype=torch.int64))
        k = k.clamp(0, size)                   # size = the drop slot
        rows = torch.arange(values.shape[0], dtype=torch.int32,
                            device=values.device)
        # index_put_ with repeated slots keeps one writer, which one is
        # unspecified: a join build (allow_dup=False) rejects duplicates
        # below, and a semi build reads only a slot's existence
        slots = torch.full((size + 1,), -1, dtype=torch.int32,
                           device=values.device)
        slots[k] = rows
        counts = torch.zeros(size + 1, dtype=torch.int32,
                             device=values.device)
        counts.index_add_(0, k, mask.to(torch.int32))
        # the dup flag stays on the device (a bool tensor): the grouped
        # runner reads it without a host sync
        return slots[:size], (counts[:size] > 1).any()
    return build


def _key_stats(values, mask):
    """(min, max, live count) of a key column over live rows."""
    v = values.to(torch.int64)
    vmin = torch.where(mask, v, torch.full_like(v, ops.INT64_MAX)).min()
    vmax = torch.where(mask, v, torch.full_like(v, ops.INT64_MIN)).max()
    return int(vmin), int(vmax), int(mask.sum())  # lint: allow-host-sync


def _max_run_device(table: ops.BuildTable) -> torch.Tensor:
    """Largest live-key duplicate run (the join's max fanout; padding runs
    excluded), as a device scalar."""
    n = table.run_len.shape[0]
    pos = torch.arange(n, dtype=torch.int32, device=table.run_len.device)
    return torch.where(pos < table.valid_count, table.run_len,
                       torch.zeros_like(table.run_len)).max()


def _max_run(table: ops.BuildTable) -> int:
    """_max_run_device on the host."""
    return int(_max_run_device(table))


def _build_has_null_key(batch: Batch, key_names: Tuple[str, ...]) -> bool:
    """Whether any live build row has a NULL key -- needed for the semi-join
    marker's three-valued output (x IN (...NULL...) is UNKNOWN on a miss)."""
    for k in key_names:
        c = batch.columns[k]
        if c.nulls is not None and bool((batch.mask & c.nulls).any()):
            return True
    return False


def _drop_null_keys(batch: Batch, key_names: Tuple[str, ...]) -> Batch:
    """Exclude build rows with NULL keys (SQL equi-join: NULL never
    matches)."""
    m = batch.mask
    for k in key_names:
        c = batch.columns[k]
        if c.nulls is not None:
            m = m & ~c.nulls
    return batch.with_mask(m)


class FusedChain:
    """A compile-time description of a fusible probe pipeline.

    steps (leaf->root order):
      ("filter", predicate)
      ("project", [(variable, expr), ...])
      ("rename", [(out_name, in_name), ...])
      ("join", JoinNode)         aux entry: DirectTable | BuildTable
      ("semi", SemiJoinNode)     aux entry: (DirectTable | BuildTable,
                                             build-had-null-key)
      ("uid", AssignUniqueIdNode)
    """

    def __init__(self, compiler, steps: List[tuple], scan_meta: dict,
                 step_ids: Optional[List[str]] = None,
                 scan_id: Optional[str] = None):
        self.compiler = compiler
        self.steps = steps
        self.scan_meta = scan_meta
        # plan-node ids for EXPLAIN ANALYZE's row counters: node_ids[0] is
        # the scan, node_ids[i + 1] the node step i came from
        self.node_ids = [scan_id] + list(step_ids or [None] * len(steps))
        self.cap = scan_meta["cap"]
        # probe expressions with bound parameters read ctx.params
        self.has_params = any(
            (s[0] == "filter" and expr_has_params(s[1]))
            or (s[0] == "project"
                and any(expr_has_params(e) for _v, e in s[1]))
            for s in steps)
        # a build subtree with bound parameters: its tables are a function
        # of the bound constants, so prep re-runs when they change
        self.build_params = any(
            '"@type": "parameter"' in P.structural_key(
                s[1].right if s[0] == "join" else s[1].filtering_source)
            for s in steps if s[0] in ("join", "semi"))
        self._leaf_make: Dict[int, object] = {}

    @property
    def empty(self) -> bool:
        """No split holds a row (chunks_for keeps a chunk otherwise)."""
        return all(s.end <= s.start for s in self.scan_meta["splits"])

    @functools.cached_property
    def chunks(self) -> List[Tuple[int, int]]:
        """The pruned scan chunks at the unexpanded leaf cap, found when
        the torch chain first needs them (a kernel launch prunes its own
        grid)."""
        return self.chunks_for((1,) * sum(
            1 for s in self.steps if s[0] in ("join", "semi")))

    @functools.cached_property
    def total_rows(self) -> int:
        return sum(n for _, n in self.chunks)

    def chunks_for(self, expands: Tuple[int, ...],
                   meter: bool = False) -> List[Tuple[int, int]]:
        """The scan chunks (pos, rows) at leaf_cap(expands), zone-map
        pruned against the scan's pushed-down conjuncts and the runtime
        dynamic filters delivered so far (at least one kept, so a fully
        pruned scan still folds an empty chunk).  meter=True (a caller's
        one computation per execution) counts an engaged dynamic filter as
        applied: the chain never reaches the streaming scan's row-level
        filter, so chunk pruning is its application."""
        cap = self.leaf_cap(expands)
        chunks = []
        for split in self.scan_meta["splits"]:
            p = split.start
            while p < split.end:
                chunks.append((p, min(cap, split.end - p)))
                p += cap
        zm = self.scan_meta.get("zone_maps")
        pd = self.scan_meta.get("pushdown")
        if zm and pd:
            from ..storage import prune_chunks
            dyn = self.scan_meta.get("dyn_summaries")
            detail: dict = {}
            chunks, _skipped = prune_chunks(
                chunks, zm, pd, self.compiler.ctx.params_fingerprint,
                dyn() if dyn is not None else None, detail=detail)
            if meter and detail.get("dyn_engaged"):
                from .adaptive import ADAPTIVE_METRICS
                ADAPTIVE_METRICS.incr("filters_applied")
                ADAPTIVE_METRICS.incr("filter_rows_in", detail["rows_in"])
                ADAPTIVE_METRICS.incr("filter_rows_pruned",
                                      detail["dyn_rows_pruned"])
                ADAPTIVE_METRICS.incr("filter_chunks_skipped",
                                      detail["dyn_chunks_pruned"])
                rs = self.compiler.ctx.runtime_stats
                if rs is not None:
                    rs.add("dynamicFilterRowsIn", detail["rows_in"])
                    rs.add("dynamicFilterRowsPruned",
                           detail["dyn_rows_pruned"])
        return chunks

    def leaf_cap(self, expands: Tuple[int, ...]) -> int:
        kprod = 1
        for k in expands:
            kprod *= k
        return max(1 << 12, self.cap // kprod)

    def prep(self, defer: Optional[Callable] = None
             ) -> Optional[Tuple[tuple, Tuple[int, ...], List[tuple]]]:
        """Materialize every build side and construct its lookup table.
        Returns (aux, expands, deferred): aux[0] is the scan's resident
        columns and aux[ji + 1] the table of the ji-th join or semi step;
        expands is each join's fanout (1 = unique build keys).  None when
        a fanout exceeds the expansion limits.  defer(step_index,
        JoinNode) -> k (falsy = build here) reserves the join's aux slot
        (None) instead of building it, with fanout k (grouped execution
        fills those slots per bucket lifespan: k == 1 a unique-key direct
        table, k > 1 a hash-sorted table probed with k-way expansion);
        deferred lists (aux_index, step_index, JoinNode)."""
        aux: List = [self.scan_meta.get("cached_cols", {})]
        expands: List[int] = []
        deferred: List[tuple] = []
        for si, step in enumerate(self.steps):
            kind = step[0]
            if kind == "join":
                node = step[1]
                k_defer = defer(si, node) if defer is not None else 0
                if k_defer:
                    aux.append(None)
                    deferred.append((len(aux) - 1, si, node))
                    expands.append(int(k_defer))
                    continue
                res = build_lookup(
                    self.compiler, node.right,
                    tuple(r.name for _l, r in node.criteria), for_join=True)
                if res is None:
                    return None
                tbl, k, _ = res
                aux.append(tbl)
                expands.append(k)
            elif kind == "semi":
                node = step[1]
                fkey = node.filtering_source_join_variable.name
                tbl, _k, had_null = build_lookup(
                    self.compiler, node.filtering_source, (fkey,),
                    for_join=False)
                aux.append((tbl, had_null))
                expands.append(1)
        kprod = 1
        for k in expands:
            kprod *= k
        if kprod > MAX_EXPAND_PRODUCT:
            return None
        return tuple(aux), tuple(expands), deferred


    # -- runtime: the chain over one scan chunk (torch) --------------------
    def make(self, pos: int, valid: int, aux, expands: Tuple[int, ...],
             leaf_cap: int, counts: Optional[ChainCounts] = None) -> Batch:
        """Apply the chain to the scan chunk [pos, pos + leaf_cap) whose
        first `valid` rows are live.  Tensor ops only: no host sync.  With
        `counts` (EXPLAIN ANALYZE), the scan's live rows and the live rows
        after each step are added to it."""
        return self.apply(self.leaf(pos, valid, aux, leaf_cap), pos, aux,
                          expands, counts)

    def leaf(self, pos: int, valid: int, aux, leaf_cap: int) -> Batch:
        """The scan chunk [pos, pos + leaf_cap) decoded, its first `valid`
        rows live (the chain's input)."""
        meta = self.scan_meta
        mk = self._leaf_make.get(leaf_cap)
        if mk is None:
            mk = self._leaf_make[leaf_cap] = meta["make_factory"](leaf_cap)
        outs, live = mk(pos, valid, aux[0])
        dicts = meta["dicts"]
        return Batch({n: Column(v, None, dicts.get(n))
                      for n, v in outs.items()}, live)

    def apply(self, batch: Batch, pos: int, aux, expands: Tuple[int, ...],
              counts: Optional[ChainCounts] = None,
              params: Optional[torch.Tensor] = None) -> Batch:
        """The chain's steps over a decoded leaf chunk starting at scan
        row `pos`.  `params` is the bound-parameter vector the steps read
        (None: the compiler's ctx.params); the batched template runner
        (serving/batched.py) applies one leaf chunk once per lane."""
        step_rows = [batch.mask.sum()] if counts is not None else None
        low = self.compiler.lowering
        if params is None:
            params = self.compiler.ctx.params
        if not self.has_params:
            params = None

        def _pb(b):
            return b.with_params(params) if params is not None else b
        ji = 0                      # join/semi ordinal; aux[0] = scan cache
        for step in self.steps:
            kind = step[0]
            if kind == "filter":
                batch = ops.apply_filter(batch,
                                         low.eval(step[1], _pb(batch)))
            elif kind == "project":
                pb = _pb(batch)
                batch = Batch({v.name: low.eval(e, pb)
                               for v, e in step[1]}, batch.mask)
            elif kind == "rename":
                batch = Batch({o: batch.columns[i] for o, i in step[1]},
                              batch.mask)
            elif kind == "join":
                if expands[ji] == 1:
                    batch = self._apply_join(batch, step[1], aux[ji + 1],
                                             low)
                else:
                    batch = self._apply_join_expand(
                        batch, step[1], aux[ji + 1], expands[ji], low)
                ji += 1
            elif kind == "semi":
                node = step[1]
                key = node.source_join_variable.name
                tbl, bhn = aux[ji + 1]
                hit, _ = (probe_direct(batch, tbl, key)
                          if isinstance(tbl, DirectTable)
                          else probe_unique(batch, tbl, (key,)))
                # three-valued marker: a NULL probe key, or a miss against
                # a build side that held a NULL key
                nulls = ~hit & bhn
                pn = batch.columns[key].nulls
                if pn is not None:
                    nulls = nulls | pn
                cols = dict(batch.columns)
                cols[node.semi_join_output.name] = Column(hit, nulls)
                batch = Batch(cols, batch.mask)
                ji += 1
            elif kind == "uid":
                # position-keyed unique ids: the id of (global leaf row r,
                # expansion branch b) is (r * K + b) above the task's
                # base, K the join expansion applied so far -- disjoint
                # across chunks and steps, and the same for a deep-copied
                # subtree (the decorrelated EXISTS plans join on them)
                kprod = 1
                for e in expands[:ji]:
                    kprod *= e
                cap_here = batch.capacity
                leaf_c = cap_here // kprod
                base = self.compiler.ctx.task_index << 40
                sidx = torch.arange(cap_here, dtype=torch.int64,
                                    device=batch.device)
                ids = base + (pos + sidx % leaf_c) * kprod + sidx // leaf_c
                batch = batch.with_columns(
                    {step[1].id_variable.name: Column(ids)})
            else:
                raise NotImplementedError(f"chain step {kind}")
            if counts is not None:
                step_rows.append(batch.mask.sum())
        if counts is not None:
            counts.add(torch.stack(step_rows).to(torch.int64))
        return batch

    def _apply_join(self, batch: Batch, node: P.JoinNode, tbl, low) -> Batch:
        probe_keys = tuple(l.name for l, _r in node.criteria)
        if isinstance(tbl, DirectTable):
            hit, bidx = probe_direct(batch, tbl, probe_keys[0])
        else:
            hit, bidx = probe_unique(batch, tbl, probe_keys)
        build_names = {v.name for v in node.right.output_variables}
        out_names = [v.name for v in node.outputs]
        cols = dict(batch.columns)
        gcols = _join_build_cols(node, out_names, build_names)
        bidx = bidx.long()
        for n in gcols:
            cols[n] = tbl.columns[n].gather(bidx)
        matched = hit
        if node.filter is not None:
            pred = low.eval(node.filter, Batch(cols, batch.mask))
            keep = pred.values.to(torch.bool)
            if pred.nulls is not None:
                keep = keep & ~pred.nulls
            matched = matched & keep
        if node.join_type == P.INNER:
            return Batch(cols, batch.mask & matched)
        # LEFT: keep every probe row; null-extend build columns on misses
        miss = ~matched
        for n in gcols:
            c = cols[n]
            cols[n] = Column(c.values, c.null_mask() | miss, c.dictionary,
                             c.lazy)
        return Batch(cols, batch.mask)

    def _apply_join_expand(self, batch: Batch, node: P.JoinNode,
                           tbl: ops.BuildTable, k: int, low) -> Batch:
        """Fanout-k join: each probe row expands into k candidate build
        slots (k = the pow2-rounded longest key run of the build).  Output
        capacity = k * input capacity; flat index j*C + i is (probe row i,
        match j)."""
        C = batch.capacity
        dev = batch.device
        probe_keys = tuple(l.name for l, _r in node.criteria)
        pcols = [batch.columns[kk] for kk in probe_keys]
        kh = ops._orderable_hash(ops.hash_columns(pcols))
        nb = tbl.perm.shape[0]
        lo = torch.searchsorted(tbl.keyhash_sorted, kh, side="left") \
            .clamp(0, nb - 1)
        hit = tbl.keyhash_sorted[lo] == kh
        for c in pcols:
            if c.nulls is not None:
                hit = hit & ~c.nulls
        cnt = torch.where(hit & batch.mask, tbl.run_len[lo].to(torch.int64),
                          torch.zeros_like(lo))                     # (C,)
        j = torch.arange(k, dtype=torch.int64, device=dev)[:, None]  # (k,1)
        sub = j < cnt[None, :]                                       # (k,C)
        bpos = (lo[None, :] + j).clamp(0, nb - 1)
        bidx = torch.where(sub, tbl.perm.long()[bpos],
                           torch.zeros_like(bpos)).reshape(k * C)
        build_names = {v.name for v in node.right.output_variables}
        out_names = [v.name for v in node.outputs]
        cols: Dict[str, Column] = {}
        for n, c in batch.columns.items():
            cols[n] = Column(c.values.repeat(k),
                             None if c.nulls is None else c.nulls.repeat(k),
                             c.dictionary, c.lazy)
        gcols = _join_build_cols(node, out_names, build_names)
        for n in gcols:
            cols[n] = tbl.columns[n].gather(bidx)
        pair_mask = (batch.mask[None, :] & sub).reshape(k * C)
        matched = pair_mask
        if node.filter is not None:
            pred = low.eval(node.filter, Batch(cols, pair_mask))
            keep = pred.values.to(torch.bool)
            if pred.nulls is not None:
                keep = keep & ~pred.nulls
            matched = matched & keep
        if node.join_type == P.INNER:
            return Batch(cols, matched)
        # LEFT: a probe row none of whose candidates survived emits one
        # null-extended row in its j == 0 slot
        any_match = matched.reshape(k, C).any(dim=0)                 # (C,)
        first = torch.arange(k, device=dev)[:, None] == 0
        fill = (first & (batch.mask & ~any_match)[None, :]).reshape(k * C)
        for n in gcols:
            c = cols[n]
            cols[n] = Column(c.values, c.null_mask() | fill, c.dictionary,
                             c.lazy)
        return Batch(cols, matched | fill)


def probe_direct(batch: Batch, dt: DirectTable, key_name: str):
    """(hit, build_row_index) for a direct-address lookup (the slot math
    of ops.direct_lookup)."""
    return ops.direct_lookup(batch, dt, key_name)


def probe_unique(batch: Batch, table: ops.BuildTable,
                 key_names: Tuple[str, ...]):
    """(hit, build_row_index) against a hash-sorted unique-key build."""
    cols = [batch.columns[k] for k in key_names]
    kh = ops._orderable_hash(ops.hash_columns(cols))
    nb = table.perm.shape[0]
    lo = torch.searchsorted(table.keyhash_sorted, kh, side="left") \
        .clamp(0, nb - 1)
    hit = table.keyhash_sorted[lo] == kh
    for c in cols:
        if c.nulls is not None:
            hit = hit & ~c.nulls
    return hit, torch.where(hit, table.perm[lo].long(), torch.zeros_like(lo))


def try_direct_table(batch: Batch, key: str,
                     allow_dup: bool) -> Optional[DirectTable]:
    """Direct-address table for a dense single integer key, or None when
    the key is non-integer / sparse / (for joins) duplicated."""
    col = batch.columns[key]
    if col.values.dtype not in (torch.int64, torch.int32, torch.int16):
        return None
    vmin, vmax, live = _key_stats(col.values, batch.mask)
    span = vmax - vmin + 1
    if not (live > 0 and span <= DIRECT_TABLE_MAX
            and span <= max(1024, DIRECT_TABLE_SPAN_RATIO * live)):
        return None
    size = 1 << (span - 1).bit_length()
    slots, dup = _direct_builder(size)(col.values, batch.mask, vmin)
    if not allow_dup and bool(dup):
        return None
    base = torch.tensor([vmin], dtype=torch.int64, device=col.values.device)
    return DirectTable(slots, base, dict(batch.columns))


def build_lookup(compiler, build_node: P.PlanNode, keys: Tuple[str, ...],
                 for_join: bool):
    """Returns (table, fanout, build_had_null_key) -- fanout is the
    pow2-rounded max key multiplicity (1 = unique keys) -- or None when
    fanout > MAX_EXPAND.  The null flag is computed only for semi builds
    (for_join=False); join builds report False (they drop NULL keys
    either way).  The build side is materialized once and cached per
    structural key (compiler._materialize_node(cache=True))."""
    from .kernels.join import bucket_directory
    batch = compiler._materialize_node(build_node, cache=True)
    if batch is None:
        batch = _empty_build_batch(build_node, compiler.ctx.device)
    had_null = False if for_join else _build_has_null_key(batch, keys)
    batch = _drop_null_keys(batch, keys)
    if len(keys) == 1:
        dt = try_direct_table(batch, keys[0], allow_dup=not for_join)
        if dt is not None:
            return dt, 1, had_null
    table = ops.build_table(batch, list(keys))
    # the kernels' probe reads it beside the table (kernel #5)
    table.directory = bucket_directory(table.keyhash_sorted)
    if not for_join:
        return table, 1, had_null
    kmax = _max_run(table)
    if kmax <= 1:
        return table, 1, False
    if kmax > MAX_EXPAND:
        return None
    return table, 1 << (kmax - 1).bit_length(), False


def assemble_chain(compiler, node: P.PlanNode) -> Optional[FusedChain]:
    """Walk a Filter/Project/Join/SemiJoin chain down to a device-generated
    TableScan.  Returns None when the plan shape is not fusible."""
    steps: List[tuple] = []
    step_ids: List[str] = []
    nd = node
    while True:
        if isinstance(nd, P.FilterNode):
            steps.append(("filter", nd.predicate))
            step_ids.append(nd.id)
            nd = nd.source
        elif isinstance(nd, P.ProjectNode):
            steps.append(("project", list(nd.assignments.items())))
            step_ids.append(nd.id)
            nd = nd.source
        elif isinstance(nd, P.ExchangeNode) and not nd.inputs \
                and len(nd.exchange_sources) == 1:
            src = nd.exchange_sources[0]
            outer = [v.name for v in nd.partitioning_scheme.output_layout]
            inner = [v.name for v in src.output_variables]
            if outer != inner:
                steps.append(("rename", list(zip(outer, inner))))
                step_ids.append(nd.id)
            nd = src
        elif isinstance(nd, P.JoinNode) \
                and nd.join_type in (P.INNER, P.LEFT) and nd.criteria:
            steps.append(("join", nd))
            step_ids.append(nd.id)
            nd = nd.left
        elif isinstance(nd, P.SemiJoinNode):
            steps.append(("semi", nd))
            step_ids.append(nd.id)
            nd = nd.source
        elif isinstance(nd, P.AssignUniqueIdNode):
            # unique ids derive from the scan position (see make), so the
            # decorrelated EXISTS stacks stay in one chain
            steps.append(("uid", nd))
            step_ids.append(nd.id)
            nd = nd.source
        elif isinstance(nd, P.TableScanNode):
            meta = getattr(compiler._compile(nd), "fused_scan", None)
            if meta is None:
                return None
            steps.reverse()
            step_ids.reverse()
            return FusedChain(compiler, steps, meta, step_ids, nd.id)
        else:
            return None


def _join_build_cols(node: P.JoinNode, out_names, build_names):
    """Build columns a join step must gather: join outputs plus any
    build-side columns the ON filter reads (pruning may have dropped the
    latter from the output list)."""
    needed = [n for n in out_names if n in build_names]
    if node.filter is not None:
        from ..spi.expr import free_variables
        for v in free_variables(node.filter):
            if v.name in build_names and v.name not in needed:
                needed.append(v.name)
    return needed


# process-wide cap on device-resident cached build materializations (a
# runner's plan cache holds many live compilers; a compiler's share is
# returned when it is garbage-collected)
_FMAT_CACHE_BYTES = 1 << 31
_fmat_pool = {"bytes": 0}


def _fmat_reserve(compiler, nb: int) -> bool:
    import weakref
    if _fmat_pool["bytes"] + nb > _FMAT_CACHE_BYTES:
        return False
    _fmat_pool["bytes"] += nb

    def _release(n=nb):
        _fmat_pool["bytes"] -= n
    weakref.finalize(compiler, _release)
    return True


def _renamed_batch(batch: Batch, names: List[str],
                   new_names: List[str]) -> Batch:
    """Positionally rename a cached twin's columns to this subtree's
    output names (structural equality aligns the output order)."""
    if names == new_names:
        return batch
    return Batch({new: batch.columns[old]
                  for old, new in zip(names, new_names)}, batch.mask)


def _result_key(compiler, tag: str, node: P.PlanNode) -> tuple:
    """The structural result-cache key of a materialized subtree: twins
    (scalar-subquery re-plans, decorrelated copies: fresh node ids, same
    shape) over the same splits share one entry; a subtree with bound
    parameters is pinned to this execution's values."""
    sk = P.structural_key(node)
    key = (tag, sk, compiler._splits_fingerprint(node))
    if '"@type": "parameter"' in sk:
        key += (compiler.ctx.params_fingerprint,)
    return key


def _ready_chain(compiler, node: P.PlanNode):
    """(chain, aux, expands) for a fusible subtree whose build sides
    prepared and whose chain applies to an empty chunk, else None.  A
    chain step the torch chain cannot apply (an expression over a
    late-materialized build column, which the streaming operators hoist
    to the host) is metered as fusionDeclinedProbeUnsupported, a fanout
    past the expansion limits as fusionDeclinedPrepFanout."""
    from .pipeline import PROBE_ROWS
    chain = assemble_chain(compiler, node)
    if chain is None or chain.empty:
        return None
    rs = compiler.ctx.runtime_stats
    prep_res = chain.prep()
    if prep_res is None:
        if rs is not None:
            rs.add("fusionDeclinedPrepFanout", 1)
        return None
    aux, expands, _ = prep_res
    try:
        chain.make(0, 0, aux, expands, PROBE_ROWS)
    except NotImplementedError:
        if rs is not None:
            rs.add("fusionDeclinedProbeUnsupported", 1)
        return None
    return chain, aux, expands


def fused_materialize(compiler, node: P.PlanNode,
                      cache: bool = False) -> Optional[Batch]:
    """A fusible chain's whole output as one batch: the chain applied to
    every scan chunk (in steps of up to CHAIN_STEP_ROWS rows), the pieces
    concatenated and compacted when mostly dead.  cache=True keeps the result on the
    device across re-executions and structural twins (generated data is
    immutable).  None when the subtree is not a fusible chain (the caller
    drains the streaming source)."""
    from .memory import batch_bytes
    from .pipeline import (CHAIN_STEP_ROWS, _chain_steps, _concat,
                           _maybe_compact)
    if compiler.ctx.memory.limited:
        return None
    ckey = _result_key(compiler, "fmat_result", node)
    names = [v.name for v in node.output_variables]
    if cache and ckey in compiler._cache:
        cached, cnames = compiler._cache[ckey]
        return _renamed_batch(cached, cnames, names)
    ready = _ready_chain(compiler, node)
    if ready is None:
        return None
    chain, aux, expands = ready
    chunks = chain.chunks_for(expands, meter=True)
    steps = _chain_steps(chunks, chain.leaf_cap(expands),
                         max(1, CHAIN_STEP_ROWS // chain.cap))
    acc = ChainCounts(len(chunks)) if compiler.ctx.stats is not None \
        else None
    parts = [chain.make(pos, cnt, aux, expands, cap, acc)
             for pos, cnt, cap in steps]
    record_chain_stats(compiler.ctx.stats, chain, acc)
    out = _maybe_compact(_concat(parts))
    if cache and _fmat_reserve(compiler, batch_bytes(out)):
        compiler._cache[ckey] = (out, names)
    return out


def fused_stream(compiler, node: P.PlanNode):
    """A fusible chain's output chunk by chunk (one batch per scan chunk,
    no host sync: the fanout-bounded probes need no overflow checks), for
    the streaming Join / SemiJoin compilers.  Returns a Batch iterator,
    or None (the caller keeps the operator path)."""
    if compiler.ctx.memory.limited:
        return None
    cfg = compiler.ctx.config
    rs = compiler.ctx.runtime_stats
    if not cfg.fuse_pipelines:
        if rs is not None:
            rs.add("fusionDeclinedDisabled", 1)
        return None
    analyzing = compiler.ctx.stats is not None
    if analyzing and cfg.analyze_unfused:
        # the knob keeps the per-operator streaming profile for join /
        # semi-join chains too
        if rs is not None:
            rs.add("fusionDeclinedAnalyzeUnfused", 1)
        return None
    key = ("fstream", node.id)
    ent = compiler._cache.get(key, False)
    if ent is None:                     # negative-cached
        return None
    cur_fp = compiler.ctx.params_fingerprint
    if ent is False:
        ready = _ready_chain(compiler, node)
        if ready is None:
            compiler._cache[key] = None
            return None
        chain, aux, expands = ready
        ent = (chain, aux, expands, cur_fp)
        compiler._cache[key] = ent
    chain, aux, expands, ent_fp = ent
    if chain.build_params and cur_fp != ent_fp:
        # the build tables are a function of the bound constants
        prep_res = chain.prep()
        if prep_res is None or prep_res[1] != expands:
            compiler._cache.pop(key, None)
            return fused_stream(compiler, node)
        aux = prep_res[0]
        compiler._cache[key] = (chain, aux, expands, cur_fp)
    leaf_cap = chain.leaf_cap(expands)
    chunks = chain.chunks_for(expands)

    def gen():
        acc = ChainCounts(len(chunks)) if analyzing else None
        try:
            for pos, cnt in chunks:
                yield chain.make(pos, cnt, aux, expands, leaf_cap, acc)
        finally:
            # the chain's root rows are the consumer's _instrument's
            record_chain_stats(compiler.ctx.stats, chain, acc,
                               skip_root=True)
    return gen()


class ChainCounts:
    """A chain pass's device-side row counters under EXPLAIN ANALYZE:
    `counts` is int64[1 + n_steps] (the scan's live rows, then the live
    rows after each step), summed over the pass's chunks by
    FusedChain.make or set by a scan kernel; `n_chunks` the pass's scan
    chunks."""

    def __init__(self, n_chunks: int = 0):
        self.counts: Optional[torch.Tensor] = None
        self.n_chunks = n_chunks

    def add(self, counts: torch.Tensor) -> None:
        self.counts = counts if self.counts is None \
            else self.counts + counts

    def restart(self, n_chunks: int) -> None:
        """A pass that starts over (a collision retry) counts anew."""
        self.counts, self.n_chunks = None, n_chunks


def record_chain_stats(stats, chain: FusedChain,
                       acc: Optional[ChainCounts], wall_s: float = 0.0,
                       skip_root: bool = False) -> None:
    """Fold the chain's device-side row counters into the EXPLAIN ANALYZE
    stats map (one host read): one entry per chain plan node, marked
    fused.  The wall is the whole fused program's -- operators fused into
    one pass share it.  skip_root leaves the root's rows and wall to the
    consumer's _instrument wrapper (fused_stream yields through it)."""
    if stats is None or acc is None or acc.counts is None:
        return
    n_chunks = acc.n_chunks
    vals = [int(v) for v in acc.counts.tolist()]
    root = chain.node_ids[-1] if chain.node_ids else None
    for nid, rows in zip(chain.node_ids, vals):
        if nid is None:
            continue
        ent = stats.setdefault(
            nid, {"rows": 0, "wall_s": 0.0, "batches": 0})
        ent["fused"] = True
        if skip_root and nid == root:
            continue
        ent["rows"] += rows
        ent["batches"] += n_chunks
        ent["wall_s"] += wall_s


def _empty_build_batch(build_node: P.PlanNode, device) -> Batch:
    """8-row all-masked batch with the build schema (empty build side)."""
    from ..common.types import CharType, VarcharType
    from .lowering import torch_dtype
    cols = {}
    for v in build_node.output_variables:
        if isinstance(v.type, (VarcharType, CharType)):
            cols[v.name] = Column(torch.zeros(8, dtype=torch.int32,
                                              device=device), None, ("",))
        else:
            cols[v.name] = Column(torch.zeros(8, dtype=torch_dtype(v.type),
                                              device=device))
    return Batch(cols, torch.zeros(8, dtype=torch.bool, device=device))
