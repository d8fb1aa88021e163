"""In-process distributed scheduler: runs a fragmented SubPlan as stages of
parallel tasks with partitioned / broadcast / gather exchanges between them
(the port of presto_tpu/exec/scheduler.py, less its ICI half).

The single-process analog of Presto's SqlQueryScheduler +
SqlStageExecution + exchange plumbing: stages execute bottom-up, each
stage as N tasks; every task runs the fragment through the PlanCompiler
on the scheduler's device and partitions its output pages into
per-consumer-task buffers (PartitionedOutputOperator semantics), which
downstream tasks read as their RemoteSourceNode input (ExchangeOperator
pull).  Pages cross the host at every exchange: that is the "http"
fabric in-process.  The reference's device-resident exchange (an
all_to_all over a mesh, the "ici" fabric) needs a mesh, which the port
does not have yet: a mesh or an edge resolved to ici raises.

Partition routing hashes the LOGICAL value (strings by their bytes, not
their dictionary codes) so producers with different dictionaries agree;
the hashes are the reference's, bit for bit.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..common.block import (Block, DictionaryBlock, FixedWidthBlock,
                            VariableWidthBlock, decode_to_flat)
from ..common.page import Page
from ..common.types import CharType, Type, VarcharType
from ..connectors import catalog
from ..spi import plan as P
from .adaptive import (AdaptiveState, DynamicFilterCollector,
                       DynamicFilterSummary, ExchangeDecision,
                       decide_exchange, decide_side_swap,
                       summaries_to_runtime, summarize_key_column)
from .pipeline import (ExecutionConfig, PlanCompiler, TaskContext,
                       settle_node_stats)

_ICI_MISSING = ("the ICI exchange fabric is not ported yet (ROADMAP queue "
                "1: the multi-device exchange on torch.distributed)")


def _card() -> torch.device:
    from .runner import resolve_device
    return resolve_device("cuda")


@dataclass
class SchedulerConfig:
    exec_config: ExecutionConfig = field(default_factory=ExecutionConfig)
    # tasks per source-partitioned (scan) stage -- the "worker count"
    source_tasks: int = 2
    # tasks per FIXED_HASH intermediate stage
    hash_tasks: int = 2
    # broadcast row budget for runtime partitioned->broadcast flips
    # (exec/adaptive.decide_exchange) -- mirrors the fragmenter's
    # plan-time FragmenterConfig.broadcast_threshold
    broadcast_threshold: int = 600_000
    # the reference's jax.sharding.Mesh; any mesh raises here (no
    # device-pinned tasks yet)
    mesh: object = None
    # BATCH MODE -- the Presto-on-Spark analog: stage outputs MATERIALIZE
    # to local shuffle files between stages, so a failed task retries
    # from durable inputs instead of failing the query
    batch_mode: bool = False
    # per-task retry attempts on failure (0 = fail-fast MPP, the
    # streaming default)
    task_retries: int = 0
    # directory for materialized shuffle files (None = TemporaryDirectory)
    temp_dir: Optional[str] = None
    # test hook: fault_injector(stage_fragment_id, task_index, attempt)
    # raises to simulate a task failure
    fault_injector: Optional[Callable] = None
    # the device every task's tensors live on (the runner's); the tasks
    # of a stage share it.  The default is the card, and raises without
    # CUDA, as the runners' does; the CPU is asked for by name
    device: torch.device = field(default_factory=lambda: _card())


def merge_node_stats(dst: Dict[str, dict], src: Dict[str, dict]) -> None:
    """Merge one task's per-plan-node operator stats into a rollup map --
    the task -> stage -> coordinator merge semantics (OperatorStats.add):
    additive fields sum, markers (fused / operatorType) are kept from the
    first task that reported them, and per-driver walls concatenate."""
    for nid, s in src.items():
        ent = dst.setdefault(nid, {"rows": 0, "wall_s": 0.0, "batches": 0})
        for k, v in s.items():
            if k in ("rows", "batches", "bytes",
                     "dynamicFilterRowsDropped"):
                ent[k] = ent.get(k, 0) + v
            elif k == "wall_s":
                ent[k] = ent.get(k, 0.0) + v
            elif k == "driver_walls":
                ent.setdefault(k, []).extend(v)
            else:
                ent.setdefault(k, v)


# ---------------------------------------------------------------------------
# host-side partition hashing (value-based, dictionary-independent)
# ---------------------------------------------------------------------------

_M1 = np.uint64(0xBF58476D1CE4E5B9)
_M2 = np.uint64(0x94D049BB133111EB)
_NULL_HASH = np.uint64(0x9E3779B97F4A7C15)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        x = x + np.uint64(0x9E3779B97F4A7C15)
        x = (x ^ (x >> np.uint64(30))) * _M1
        x = (x ^ (x >> np.uint64(27))) * _M2
        return x ^ (x >> np.uint64(31))


_FNV_OFFSET = np.uint64(0xCBF29CE484222325)
_FNV_PRIME = np.uint64(0x100000001B3)


def _fnv1a64_rows(block) -> np.ndarray:
    """Vectorized FNV-1a over every row of a flat VariableWidthBlock: one
    numpy pass per BYTE POSITION (strings are short; rows are many), not a
    python loop per byte."""
    offsets = block.offsets.astype(np.int64)
    data = block.data
    lengths = offsets[1:] - offsets[:-1]
    n = len(lengths)
    h = np.full(n, _FNV_OFFSET, dtype=np.uint64)
    if n == 0:
        return h
    # active-set shrink keeps this O(total_bytes): each pass only touches
    # rows still longer than j, so one long outlier string doesn't make
    # every row pay for its length
    active = np.flatnonzero(lengths > 0)
    j = 0
    with np.errstate(over="ignore"):
        while active.size:
            b = data[offsets[active] + j].astype(np.uint64)
            h[active] = (h[active] ^ b) * _FNV_PRIME
            j += 1
            active = active[lengths[active] > j]
    return h


# dictionary entry hashes by the dictionary block's identity: the pages of
# one column share their dictionary block (batch._dictionary_block), so
# each dictionary is hashed once, not once per page
_ENTRY_HASHES: Dict[int, tuple] = {}
_ENTRY_HASHES_MAX = 64
_ENTRY_HASHES_LOCK = threading.Lock()


def _dictionary_hashes(dictionary: Block) -> np.ndarray:
    with _ENTRY_HASHES_LOCK:
        ent = _ENTRY_HASHES.get(id(dictionary))
    if ent is not None and ent[0] is dictionary:
        return ent[1]
    inner = decode_to_flat(dictionary)
    entry_hash = _fnv1a64_rows(inner)
    if inner.nulls is not None:
        entry_hash = np.where(inner.nulls, _NULL_HASH, entry_hash)
    with _ENTRY_HASHES_LOCK:
        if len(_ENTRY_HASHES) >= _ENTRY_HASHES_MAX:
            _ENTRY_HASHES.pop(next(iter(_ENTRY_HASHES)))
        _ENTRY_HASHES[id(dictionary)] = (dictionary, entry_hash)
    return entry_hash


def _hash_block(typ: Type, block: Block, n: int) -> np.ndarray:
    """Per-row uint64 value hash of one column."""
    if isinstance(typ, (VarcharType, CharType)):
        if isinstance(block, DictionaryBlock):
            # hash the dictionary once, then one gather per page
            return _dictionary_hashes(block.dictionary)[block.ids]
        flat = decode_to_flat(block)
        h = _fnv1a64_rows(flat)
        if flat.nulls is not None:
            h = np.where(flat.nulls, _NULL_HASH, h)
        return h
    flat = decode_to_flat(block)
    values = flat.values
    if values.dtype.kind == "f":
        values = values.view(np.uint64 if values.itemsize == 8 else np.uint32)
    h = _splitmix64(values.astype(np.int64).view(np.uint64))
    if flat.may_have_null:
        h = np.where(flat.null_mask(), _NULL_HASH, h)
    return h


def partition_targets(page: Page, types: List[Type], key_indices: List[int],
                      n_parts: int) -> np.ndarray:
    """Row -> target partition, combining the key columns' value hashes."""
    n = page.position_count
    h = np.full(n, np.uint64(1), dtype=np.uint64)
    with np.errstate(over="ignore"):
        for i in key_indices:
            hv = _hash_block(types[i], page.blocks[i], n)
            h = _splitmix64(h * np.uint64(31) + hv)
    return (h % np.uint64(n_parts)).astype(np.int64)


class StageAbortedError(RuntimeError):
    """A sibling task of the same stage failed terminally: this task stops
    early instead of finishing work whose stage is already doomed."""


def _block_bytes(b: Block) -> int:
    """Host bytes one block occupies on the exchange wire (a
    late-materialized string block: its row ids, what moves)."""
    from .batch import LazyStringBlock
    if isinstance(b, LazyStringBlock):
        n = b.row_ids.nbytes
    elif isinstance(b, DictionaryBlock):
        n = b.ids.nbytes + _block_bytes(b.dictionary)
    elif isinstance(b, VariableWidthBlock):
        n = b.data.nbytes + b.offsets.nbytes
    elif isinstance(b, FixedWidthBlock):
        n = b.values.nbytes
    else:  # RunLengthBlock and friends: count the payload if it has one
        inner = getattr(b, "value", None)
        n = _block_bytes(inner) if inner is not None else 0
    nulls = getattr(b, "nulls", None)
    return n + (nulls.nbytes if nulls is not None else 0)


def _page_bytes(page: Page) -> int:
    return sum(_block_bytes(b) for b in page.blocks)


def split_page(page: Page, targets: np.ndarray, n_parts: int) -> List[Page]:
    out = []
    for p in range(n_parts):
        idx = np.flatnonzero(targets == p)
        if len(idx) == 0:
            out.append(None)
            continue
        out.append(Page([b.take(idx) for b in page.blocks], len(idx)))
    return out


# ---------------------------------------------------------------------------
# stage / buffer model
# ---------------------------------------------------------------------------

class OutputBuffers:
    """Per-fragment output: buffers[producer_task][partition] -> [Page].

    Partition semantics by output scheme (OutputBuffers):
      SINGLE            everything in partition 0 (gather consumers)
      FIXED_HASH        partition = hash(keys) % consumer task count
      FIXED_BROADCAST   partition 0 holds the full output; every consumer
                        task reads it (BroadcastOutputBuffer)
    """

    def __init__(self, n_tasks: int, n_partitions: int, broadcast: bool):
        self.broadcast = broadcast
        # runtime partitioned->broadcast flip (InProcessScheduler.
        # _adapt_exchanges): every consumer reads the UNION of the hash
        # partitions -- the full producer output -- instead of its slice
        self.read_all = False
        self.pages: List[Dict[int, List[Page]]] = [
            {p: [] for p in range(max(1, n_partitions))}
            for _ in range(n_tasks)]

    def add(self, task: int, partition: int, page: Page) -> None:
        self.pages[task][partition].append(page)

    def reset_task(self, task: int) -> None:
        """Drop a task's staged output (retry must not duplicate rows)."""
        self.pages[task] = {p: [] for p in self.pages[task]}

    def materialize(self, stage_dir: str) -> None:
        """Spill every (task, partition) page list to a shuffle file and
        replace the in-memory lists with lazy file readers -- the batch
        (Presto-on-Spark) mode's durable-exchange step (ShuffleWrite /
        LocalPersistentShuffle semantics over SerializedPage framing)."""
        from ..common.serde import deserialize_page, serialize_page
        os.makedirs(stage_dir, exist_ok=True)

        class _FilePages:
            def __init__(self, path: str, count: int, rows: int):
                self.path, self.count, self.rows = path, count, rows

            def __iter__(self):
                with open(self.path, "rb") as f:
                    raw = f.read()
                pos = 0
                for _ in range(self.count):
                    page, pos = deserialize_page(raw, pos)
                    yield page

            def __len__(self):
                return self.count

        for ti, parts in enumerate(self.pages):
            for p, pages in parts.items():
                if not isinstance(pages, list):
                    continue
                path = os.path.join(stage_dir, f"t{ti}_p{p}.shuffle")
                with open(path, "wb") as f:
                    for page in pages:
                        f.write(serialize_page(page))
                parts[p] = _FilePages(
                    path, len(pages), sum(pg.position_count for pg in pages))

    def _consumer_parts(self, consumer_task: int):
        """The (task, partition) page lists one consumer task reads."""
        if self.read_all:
            return [task_pages[part] for task_pages in self.pages
                    for part in sorted(task_pages)]
        part = 0 if self.broadcast else consumer_task
        return [task_pages[part] for task_pages in self.pages
                if part in task_pages]

    def pages_for_consumer(self, consumer_task: int) -> List[Page]:
        out: List[Page] = []
        for pages in self._consumer_parts(consumer_task):
            out.extend(pages)
        return out

    def rows_for_consumer(self, consumer_task: int) -> int:
        """The rows pages_for_consumer holds, without reading a shuffle
        file."""
        return sum(pages.rows if not isinstance(pages, list)
                   else sum(p.position_count for p in pages)
                   for pages in self._consumer_parts(consumer_task))


@dataclass
class StageInfo:
    fragment: P.PlanFragment
    children: List["StageInfo"]
    n_tasks: int = 1
    n_partitions: int = 1      # consumer task count (output fan-out)
    buffers: Optional[OutputBuffers] = None
    out_names: Optional[List[str]] = None
    # resolved fabric of this stage's OUTPUT edge ("http", parallel/
    # fabric.py; None for the root stage) + why, set by _plan_fabrics
    fabric: Optional[str] = None
    fabric_reason: Optional[str] = None
    # set when the first task of this stage fails terminally: sibling
    # tasks abort promptly instead of draining a doomed stage
    abort: object = None
    # concurrency telemetry: per-task wall seconds and the stage wall --
    # overlap quality = stage_wall / sum(task_walls)
    task_walls: Optional[List[float]] = None
    stage_wall: Optional[float] = None
    # lifespan sharding: each task's grouped_shard, None where unsharded
    task_shards: Optional[List[Optional[Tuple[int, int]]]] = None


class InProcessScheduler:
    """Executes a SubPlan bottom-up, each stage's tasks on threads over
    the scheduler's one device."""

    def __init__(self, config: Optional[SchedulerConfig] = None):
        from ..utils.runtime_stats import RuntimeStats
        self.config = config or SchedulerConfig()
        if self.config.mesh is not None:
            raise NotImplementedError(
                "a device mesh is not ported yet: " + _ICI_MISSING)
        # per-query exchange stats (bytes moved, walls), shared by every
        # task and merged into QueryResult.runtime_stats by the runner
        self.stats = RuntimeStats()
        # per-plan-node operator stats of EVERY task, merged across tasks
        # (set to {} by a caller that wants them)
        self.node_stats: Optional[Dict[str, dict]] = None
        self._stats_lock = threading.Lock()
        # query-level memory context (created per execute()): every task
        # gets a CHILD context over ONE shared pool; budgeted stages run
        # their tasks sequentially, so the pool never sees two tasks'
        # peaks stacked
        self.memory = None
        # adaptive execution: the per-query dynamic-filter collector plus
        # the exchange-decision log (exec/adaptive.py).  _dyn_filters is
        # the SHARED wire-form map handed to every TaskContext -- scans
        # read it lazily, so summaries collected from a finished build
        # stage prune scans of later stages without any recompile
        self.adaptive = AdaptiveState(DynamicFilterCollector(
            self.config.exec_config.dynamic_filtering_max_distinct))
        self._dyn_filters: Dict[str, dict] = {}
        # the last execution's stage tree (stages())
        self.root: Optional[StageInfo] = None

    # -- planning the stage tree -----------------------------------------
    def _build_stages(self, subplan: P.SubPlan) -> StageInfo:
        children = [self._build_stages(c) for c in subplan.children]
        frag = subplan.fragment
        if frag.partitioning == P.SOURCE_DISTRIBUTION:
            n_tasks = self.config.source_tasks
        elif frag.partitioning == P.FIXED_HASH_DISTRIBUTION:
            n_tasks = self.config.hash_tasks
        else:
            n_tasks = 1
        return StageInfo(frag, children, n_tasks)

    def _plan_fabrics(self, stage: StageInfo) -> None:
        """Resolve the fabric of every remote-exchange edge (sql/fragmenter
        annotate_exchange_fabrics and this call share parallel/fabric
        resolve_fabric) and write it back onto the child's scheme.  With
        no mesh every edge resolves to http; an ici edge raises."""
        from ..parallel.fabric import FABRIC_HTTP, FABRIC_ICI, resolve_fabric
        msize = self._mesh_size()
        requested = self.config.exec_config.exchange_fabric
        child_by_fid = {c.fragment.fragment_id: c for c in stage.children}
        for node in P.walk_plan(stage.fragment.root):
            if not isinstance(node, P.RemoteSourceNode):
                continue
            edges = []
            for fid in node.source_fragment_ids:
                child = child_by_fid.get(fid)
                if child is None:
                    continue
                scheme = child.fragment.output_partitioning_scheme
                fabric, why = resolve_fabric(
                    scheme.fabric or requested, handle=scheme.handle,
                    producer_partitioning=child.fragment.partitioning,
                    consumer_partitioning=stage.fragment.partitioning,
                    mesh_size=msize, batch_mode=self.config.batch_mode)
                edges.append((child, scheme, fabric, why))
            # a multi-source reader consumes all-device or nothing: mixed
            # resolutions demote every edge of this reader to http
            if len({f for _, _, f, _ in edges}) > 1:
                edges = [(c, s, FABRIC_HTTP, "mixed-fabric source set")
                         for c, s, _, w in edges]
            for child, scheme, fabric, why in edges:
                if fabric == FABRIC_ICI:
                    raise NotImplementedError(
                        f"fragment {child.fragment.fragment_id}'s output "
                        f"edge resolved to ici ({why}): " + _ICI_MISSING)
                child.fabric = scheme.fabric = fabric
                child.fabric_reason = why
        for child in stage.children:
            self._plan_fabrics(child)

    def _assign_partitions(self, stage: StageInfo,
                           consumer_tasks: int) -> None:
        stage.n_partitions = consumer_tasks
        handle = stage.fragment.output_partitioning_scheme.handle
        broadcast = handle == P.FIXED_BROADCAST_DISTRIBUTION
        n_parts = 1 if handle in (P.SINGLE_DISTRIBUTION,) or broadcast \
            else consumer_tasks
        stage.buffers = OutputBuffers(stage.n_tasks, n_parts, broadcast)
        for c in stage.children:
            self._assign_partitions(c, stage.n_tasks)

    # -- execution --------------------------------------------------------
    def execute(self, subplan: P.SubPlan) -> Iterator[Page]:
        from .memory import MemoryContext, MemoryPool
        cfg = self.config.exec_config
        self.memory = MemoryContext(
            MemoryPool(cfg.memory_budget_bytes), "query",
            max_bytes=cfg.memory_max_query_bytes)
        root = self._build_stages(subplan)
        self.root = root
        self._plan_fabrics(root)
        self._assign_partitions(root, 1)
        self._run_stage(root)
        yield from root.buffers.pages_for_consumer(0)

    def _mesh_size(self) -> int:
        from ..parallel.mesh import mesh_size
        return mesh_size(self.config.mesh)

    def _batch_dir(self, fragment_id: str) -> str:
        """Shuffle-file directory for one stage (batch mode)."""
        if self.config.temp_dir is None:
            import tempfile
            self._tmp = getattr(self, "_tmp", None) \
                or tempfile.TemporaryDirectory(prefix="presto_tpu_shuffle_")
            base = self._tmp.name
        else:
            base = self.config.temp_dir
        return os.path.join(base, f"stage_{fragment_id}")

    # -- adaptive exchange strategy ---------------------------------------
    def _observed_rows(self, side, child_by_fid) -> Optional[int]:
        """Rows a completed child stage actually produced behind one join
        side, or None when they cannot be counted without file reads
        (batch-mode shuffle files) or the side is not a direct remote
        source."""
        while isinstance(side, P.FilterNode):
            side = side.source
        if not isinstance(side, P.RemoteSourceNode):
            return None
        total = 0
        for fid in side.source_fragment_ids:
            ch = child_by_fid.get(fid)
            if ch is None or ch.buffers is None:
                return None
            for task_pages in ch.buffers.pages:
                for pages in task_pages.values():
                    if not isinstance(pages, list):
                        return None
                    total += sum(p.position_count for p in pages)
        return total

    def _adapt_exchanges(self, stage: StageInfo) -> None:
        """Re-decide exchange strategy at the stage boundary, AFTER the
        producer stages ran but BEFORE this consumer stage launches.

        Two moves, both plan mutations on the consumer fragment only:

        - INNER side swap: when the observed build is far larger than
          the observed probe, build the probe instead (same hash, same
          partition alignment -- only the roles flip).
        - partitioned -> broadcast: when the observed build undershoots
          the planner's estimate by ADAPTIVE_RATIO and fits the
          broadcast threshold, every consumer task reads the UNION of
          the build's hash partitions (OutputBuffers.read_all) so the
          downstream join sees the full build side; the probe stays
          partitioned, so no output row duplicates.  FULL joins are
          excluded -- their unmatched-build emission would duplicate
          across tasks."""
        if not self.config.exec_config.adaptive_exchange:
            return
        child_by_fid = {c.fragment.fragment_id: c
                        for c in stage.children}
        for node in P.walk_plan(stage.fragment.root):
            if not isinstance(node, P.JoinNode) \
                    or node.distribution != P.PARTITIONED \
                    or node.join_type not in (P.INNER, P.LEFT):
                continue
            observed_b = self._observed_rows(node.right, child_by_fid)
            observed_p = self._observed_rows(node.left, child_by_fid)
            acted = False
            if node.join_type == P.INNER and observed_b is not None \
                    and observed_p is not None \
                    and decide_side_swap(observed_p, observed_b):
                node.left, node.right = node.right, node.left
                node.criteria = [(r, l) for l, r in node.criteria]
                detail = (f"planned build {observed_b} rows >= 2x "
                          f"probe {observed_p}; sides swapped")
                observed_p, observed_b = observed_b, observed_p
                self.adaptive.record(ExchangeDecision(
                    node.id, "swap_sides", node.planned_build_rows,
                    observed_b, detail))
                self.stats.add("adaptiveSideSwaps", 1)
                acted = True
            if observed_b is not None and decide_exchange(
                    node.planned_build_rows, observed_b,
                    self.config.broadcast_threshold):
                side = node.right
                while isinstance(side, P.FilterNode):
                    side = side.source
                for fid in side.source_fragment_ids:
                    child_by_fid[fid].buffers.read_all = True
                node.distribution = P.REPLICATED
                self.adaptive.record(ExchangeDecision(
                    node.id, "broadcast", node.planned_build_rows,
                    observed_b,
                    f"observed {observed_b} rows vs planned "
                    f"{node.planned_build_rows}"))
                self.stats.add("adaptiveExchangeFlips", 1)
                acted = True
            if not acted and observed_b is not None:
                self.adaptive.record(ExchangeDecision(
                    node.id, "keep", node.planned_build_rows, observed_b))

    def _run_stage(self, stage: StageInfo) -> None:
        # dynamic-filter producers run before sibling consumers: stage
        # execution here is sequential bottom-up, so finishing the build
        # side first means its summaries are already collected when the
        # probe-side scan stage launches
        for child in sorted(
                stage.children,
                key=lambda c: not c.fragment.dynamic_filter_sources):
            self._run_stage(child)
        self._adapt_exchanges(stage)
        frag = stage.fragment
        scheme = frag.output_partitioning_scheme
        out_names = [v.name for v in frag.root.output_variables]
        out_types = [v.type for v in frag.root.output_variables]
        key_indices = [out_names.index(a.name) for a in scheme.arguments]
        hashed = scheme.handle == P.FIXED_HASH_DISTRIBUTION
        stage.out_names = out_names
        cfg = self.config.exec_config
        device = self.config.device

        # producer-side dynamic-filter summarization: the fragmenter
        # marked which of this fragment's output columns feed downstream
        # filters (PlanFragment.dynamic_filter_sources); each task folds
        # its output pages into one summary per filter id as they stream
        max_distinct = cfg.dynamic_filtering_max_distinct
        dyn_idx: List[Tuple[int, str]] = (
            [(out_names.index(col), fid)
             for col, fid in frag.dynamic_filter_sources.items()
             if col in out_names]
            if cfg.dynamic_filtering else [])

        from ..parallel.fabric import FABRIC_METRICS

        # split assignment per scan node: task i takes splits[i::n]
        scan_splits: Dict[str, List] = {}
        for node in P.walk_plan(frag.root):
            if isinstance(node, P.TableScanNode):
                th = node.table
                sf = dict(th.extra).get("scaleFactor", 0.01)
                n_splits = max(stage.n_tasks, cfg.splits_per_scan)
                scan_splits[node.id] = catalog.make_splits(
                    th.table_name, sf, n_splits, th.connector_id)

        remote_nodes = [n for n in P.walk_plan(frag.root)
                        if isinstance(n, P.RemoteSourceNode)]
        child_by_fid = {c.fragment.fragment_id: c for c in stage.children}

        # first terminal task failure aborts the siblings promptly
        stage.abort = abort = threading.Event()

        # lifespan sharding: a grouped-eligible source stage gives every
        # task the FULL split set plus a disjoint round-robin subset of
        # the bucket layout -- K lifespans spread over N tasks instead of
        # each task re-bucketing a split subset (which _full_coverage
        # would reject, forfeiting grouped execution entirely)
        from .grouped import stage_shards_lifespans
        grouped_shards = (
            stage.n_tasks > 1
            and frag.partitioning == P.SOURCE_DISTRIBUTION
            and stage_shards_lifespans(frag.root, cfg))
        stage.task_shards = [(i, stage.n_tasks) if grouped_shards else None
                             for i in range(stage.n_tasks)]

        # every task issues its work on the caller's device and CUDA
        # stream (torch's current device and stream are per thread)
        stream = (torch.cuda.current_stream(device)
                  if device.type == "cuda" else None)

        def on_device():
            if stream is None:
                return contextlib.nullcontext()
            ctx = contextlib.ExitStack()
            ctx.enter_context(torch.cuda.device(device))
            ctx.enter_context(torch.cuda.stream(stream))
            return ctx

        # the stage's tasks build each scan / filter / project step once
        # (PlanCompiler.fragment_jit under a stage cache)
        stage_steps: Dict = {}

        def run_task(task_index: int) -> float:
            """One task's fragment execution; returns its wall seconds."""
            t0 = time.perf_counter()  # lint: allow-wall-clock
            # thread CPU time at the driver boundary: each task runs on
            # its own thread, so thread_time isolates ITS compute from
            # the waits that wall time folds in
            c0 = time.thread_time()
            task_mem = self.memory.new_child(
                f"task/{frag.fragment_id}.{task_index}")
            ctx = TaskContext(config=cfg, device=device,
                              task_index=task_index, memory=task_mem,
                              shared_steps=stage_steps,
                              runtime_stats=self.stats,
                              dynamic_filters=self._dyn_filters)
            if self.node_stats is not None:
                ctx.stats = {}
            ctx.grouped_shard = stage.task_shards[task_index]
            for node_id, splits in scan_splits.items():
                ctx.splits[node_id] = (list(splits) if grouped_shards
                                       else splits[task_index::stage.n_tasks])
            for rnode in remote_nodes:
                sources = [child_by_fid[fid] for fid in
                           rnode.source_fragment_ids]
                ctx.remote_pages[rnode.id] = _remote_reader(
                    sources, task_index,
                    client_threads=cfg.exchange_client_threads)
                ctx.remote_rows[rnode.id] = sum(
                    src.buffers.rows_for_consumer(task_index)
                    for src in sources)
            compiler = PlanCompiler(ctx)
            split_wall, split_bytes = 0.0, 0
            task_sums: Dict[str, DynamicFilterSummary] = {}

            with on_device():
                for page in compiler.run_to_pages(frag.root):
                    if abort.is_set():
                        raise StageAbortedError(
                            f"sibling task of stage {frag.fragment_id} "
                            f"failed")
                    for j, fid in dyn_idx:
                        s = _summarize_page_block(fid, page.blocks[j],
                                                  max_distinct)
                        prev = task_sums.get(fid)
                        task_sums[fid] = s if prev is None \
                            else prev.merge(s, max_distinct)
                    if hashed and stage.n_partitions > 1:
                        s0 = time.perf_counter()  # lint: allow-wall-clock
                        targets = partition_targets(
                            page, out_types, key_indices,
                            stage.n_partitions)
                        for p, sub in enumerate(split_page(
                                page, targets, stage.n_partitions)):
                            if sub is not None:
                                stage.buffers.add(task_index, p, sub)
                        split_wall += time.perf_counter() - s0  # lint: allow-wall-clock
                        split_bytes += _page_bytes(page)
                    else:
                        stage.buffers.add(task_index, 0, page)
            if dyn_idx:
                # a task that produced no pages still publishes EMPTY
                # summaries -- a zero-row build side legitimately prunes
                # every downstream chunk (min>max convention), which is
                # different from "never heard back" (prunes nothing)
                for _j, fid in dyn_idx:
                    if fid not in task_sums:
                        task_sums[fid] = DynamicFilterSummary(
                            fid, row_count=0)
                for s in task_sums.values():
                    self.adaptive.collector.publish(s)
            if self.node_stats is not None and ctx.stats:
                # the task's device-side row counts read once, then merged
                settle_node_stats(ctx.stats)
                with self._stats_lock:
                    merge_node_stats(self.node_stats, ctx.stats)
            if split_bytes or split_wall:
                # the hashed page path IS the http fabric in-process
                FABRIC_METRICS.record(
                    "http", exchanges=1, chunks=1, bytes_moved=split_bytes,
                    host_bytes=split_bytes, exchange_wall_s=split_wall)
                self.stats.add("exchangeFabricHttpBytes", split_bytes,
                               "BYTE")
                self.stats.add("exchangeFabricHttpExchangeWallNanos",
                               split_wall * 1e9, "NANO")
            wall = time.perf_counter() - t0  # lint: allow-wall-clock
            self.stats.add("driverCpuNanos",
                           (time.thread_time() - c0) * 1e9, "NANO")
            self.stats.add("driverWallNanos", wall * 1e9, "NANO")
            return wall

        def run_task_retrying(task_index: int) -> float:
            """Batch (Presto-on-Spark) mode: a failed task re-runs from
            its materialized inputs (children already spilled their
            shuffle files).  Streaming mode keeps fail-fast MPP semantics
            (task_retries=0).  Retry is gated by the shared error
            classifier: USER_ERROR -- bad SQL, bad input -- fails fast;
            only infrastructure-shaped failures consume retry attempts."""
            from ..common.errors import is_retryable
            attempts = 1 + max(0, self.config.task_retries)
            for attempt in range(attempts):
                if abort.is_set():
                    raise StageAbortedError(
                        f"sibling task of stage {frag.fragment_id} failed")
                try:
                    if self.config.fault_injector is not None:
                        self.config.fault_injector(
                            frag.fragment_id, task_index, attempt)
                    return run_task(task_index)
                except StageAbortedError:
                    raise               # echo of a sibling's failure
                except Exception as e:
                    stage.buffers.reset_task(task_index)
                    if attempt + 1 >= attempts or not is_retryable(e):
                        abort.set()
                        raise
            return 0.0

        # a stage's N tasks run CONCURRENTLY (SqlStageExecution.scheduleTask
        # / the worker TaskExecutor thread pool); under a memory budget
        # their per-task pools would stack to n_tasks x budget on the one
        # device, so those run sequentially
        stage_t0 = time.perf_counter()  # lint: allow-wall-clock
        concurrent = stage.n_tasks > 1 and cfg.memory_budget_bytes is None
        if not concurrent:
            walls = [run_task_retrying(i) for i in range(stage.n_tasks)]
        else:
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(max_workers=stage.n_tasks) as pool_ex:
                walls = list(pool_ex.map(run_task_retrying,
                                         range(stage.n_tasks)))
        stage.task_walls = [round(w, 4) for w in walls]
        stage.stage_wall = round(
            time.perf_counter() - stage_t0, 4)  # lint: allow-wall-clock
        if dyn_idx:
            # the stage is complete, so each filter's merged summary is
            # final: expose it to every LATER stage's tasks through the
            # shared wire-form map (late binding -- scans read it at
            # split drain time)
            ready = {}
            for _j, fid in dyn_idx:
                s = self.adaptive.collector.get(fid)
                if s is not None:
                    ready[fid] = s
            if ready:
                self._dyn_filters.update(summaries_to_runtime(ready))
                self.stats.add("dynamicFiltersCollected", len(ready))
        if self.config.batch_mode:
            # durable inter-stage exchange (the Spark-shuffle analog)
            stage.buffers.materialize(self._batch_dir(frag.fragment_id))

    def stages(self) -> List[StageInfo]:
        """The last execution's stages, root first (depth-first)."""
        out, todo = [], [self.root]
        while todo:
            s = todo.pop()
            if s is None:
                continue
            out.append(s)
            todo.extend(reversed(s.children))
        return out


def _summarize_page_block(fid: str, block: Block,
                          max_distinct: int) -> DynamicFilterSummary:
    """Dynamic-filter summary over one output page column (host blocks).
    Variable-width (string) keys publish the row count only: zone maps
    hold stored-unit ints, but a zero-row build side still prunes
    everything downstream via the empty-summary convention."""
    flat = decode_to_flat(block)
    if isinstance(flat, FixedWidthBlock):
        mask = ~flat.null_mask() if flat.may_have_null else None
        return summarize_key_column(fid, flat.values, mask, max_distinct)
    n = flat.position_count if isinstance(flat, VariableWidthBlock) else 0
    if getattr(flat, "nulls", None) is not None:
        n = int(n - np.count_nonzero(flat.nulls))
    return DynamicFilterSummary(fid, row_count=max(0, n))


def _remote_reader(sources: List[StageInfo], consumer_task: int,
                   client_threads: int = 1):
    """Page reader of one consumer task.  With client_threads > 1 the
    sources drain concurrently through the local-exchange arrival-order
    queue (the in-process mirror of the HTTP ExchangeClient; cross-source
    page order carries no semantics -- ordering, if any, is applied
    inside the consuming fragment)."""
    def read() -> Iterator[Page]:
        if client_threads > 1 and len(sources) > 1:
            from .local_exchange import parallel_drain
            thunks = [(lambda s=src: iter(
                s.buffers.pages_for_consumer(consumer_task)))
                for src in sources]
            yield from parallel_drain(thunks, client_threads)
        else:
            for src in sources:
                yield from src.buffers.pages_for_consumer(consumer_task)
    return read
