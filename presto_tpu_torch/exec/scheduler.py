"""In-process distributed scheduler: runs a fragmented SubPlan as stages of
parallel tasks with partitioned / broadcast / gather exchanges between them
(the port of presto_tpu/exec/scheduler.py).

The single-process analog of Presto's SqlQueryScheduler +
SqlStageExecution + exchange plumbing: stages execute bottom-up, each
stage as N tasks; every task runs the fragment through the PlanCompiler
on the scheduler's device and partitions its output pages into
per-consumer-task buffers (PartitionedOutputOperator semantics), which
downstream tasks read as their RemoteSourceNode input (ExchangeOperator
pull).  Pages cross the host at such an exchange: that is the "http"
fabric in-process.  With a mesh (parallel/mesh.py), a hashed edge whose
stages are pinned 1:1 to the mesh positions is the "ici" fabric: each
producer task's output stays on its position's device and the device
exchange (parallel/exchange.py) moves every row to its consumer's
position in fixed-size chunks, with one host read of the live counts.

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
from .pipeline import (EXCHANGE_PACK_ROWS, ExecutionConfig, PlanCompiler,
                       TaskContext, settle_node_stats)

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
    # parallel/mesh.DeviceMesh: when set, an eligible hashed edge's
    # producer and consumer stages get one task per mesh position, pinned
    # to it, and the edge runs as the device exchange
    # (parallel/exchange.py) instead of host page splitting; other edges
    # (gather / broadcast / batch mode) keep the page path.  Every
    # position must be of the scheduler's device type
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
    # resolved fabric of this stage's OUTPUT edge ("http" | "ici",
    # parallel/fabric.py; None for the root stage) + why, set by
    # _plan_fabrics before partition assignment
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
    # device exchange result ("ici" fabric): consumer task -> its
    # device-resident chunk Batches, the rows each consumer receives, and
    # per chunk the CUDA event its exchange completes at (None on the CPU)
    device_out: Optional[list] = None
    device_rows: Optional[List[int]] = None
    device_ready: Optional[list] = None


class InProcessScheduler:
    """Executes a SubPlan bottom-up, each stage's tasks on threads over
    the scheduler's device, or pinned one per mesh position."""

    def __init__(self, config: Optional[SchedulerConfig] = None):
        from ..utils.runtime_stats import RuntimeStats
        self.config = config or SchedulerConfig()
        if self.config.mesh is not None:
            # no fallback hides the device: a mesh position of another
            # kind than the scheduler's device is refused
            self.config.mesh.check_on(self.config.device)
        # per-query exchange stats (bytes moved, walls), shared by every
        # task and merged into QueryResult.runtime_stats by the runner
        self.stats = RuntimeStats()
        # per-plan-node operator stats of EVERY task, merged across tasks
        # (set to {} by a caller that wants them)
        self.node_stats: Optional[Dict[str, dict]] = None
        self._stats_lock = threading.Lock()
        # span-recording tracer (utils/runtime_stats.Tracer); spans open
        # per fragment and per task under the caller's "query" span
        self.tracer = None
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
        """Resolve the fabric of every remote-exchange edge and CHOOSE
        task counts to fit the mesh: an ici edge needs producer and
        consumer tasks pinned 1:1 to mesh positions, so both endpoint
        stages of an eligible hashed edge get n_tasks = mesh size.  Runs
        BEFORE _assign_partitions so the chosen counts drive the output
        fan-out.  sql/fragmenter annotate_exchange_fabrics and this call
        share parallel/fabric resolve_fabric; the resolution is written
        back onto the child's scheme for EXPLAIN and stats parity."""
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
                child.fabric = scheme.fabric = fabric
                child.fabric_reason = why
                if fabric == FABRIC_ICI:
                    child.n_tasks = msize
                    stage.n_tasks = msize
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
        side, or None when they cannot be counted without device syncs /
        file reads (device exchange output, batch-mode shuffle files) or
        the side is not a direct remote source."""
        while isinstance(side, P.FilterNode):
            side = side.source
        if not isinstance(side, P.RemoteSourceNode):
            return None
        total = 0
        for fid in side.source_fragment_ids:
            ch = child_by_fid.get(fid)
            if ch is None or ch.buffers is None \
                    or ch.device_out is not None:
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

        # fabric resolution happened in _plan_fabrics.  The task-count
        # re-check is defensive: _plan_fabrics chose n_tasks to fit the
        # mesh, so an ici stage that no longer matches is a planner bug
        # better demoted than crashed
        from ..parallel.fabric import FABRIC_ICI, FABRIC_METRICS
        mesh = self.config.mesh
        ici = (stage.fabric == FABRIC_ICI and hashed
               and stage.n_partitions > 1
               and stage.n_tasks == stage.n_partitions
               and stage.n_tasks == self._mesh_size())

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

        # consuming device chunks requires task<->position pinning too; a
        # node mixing device and page children, or device children whose
        # string dictionaries disagree, reads everything as pages (the
        # device children are converted lazily in _remote_reader)
        device_inputs = {}
        for rnode in remote_nodes:
            sources = [child_by_fid[fid]
                       for fid in rnode.source_fragment_ids]
            device_inputs[rnode.id] = (
                all(s.device_out is not None for s in sources)
                and _device_dicts_agree(sources))
        pin = (ici or any(device_inputs.values())) \
            and stage.n_tasks == self._mesh_size()
        devices = (list(mesh.devices) if pin
                   else [device] * stage.n_tasks)

        # first terminal task failure aborts the siblings and any
        # in-flight device exchange consumption promptly
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

        # every task issues its work on its device's CUDA stream current
        # in the caller's thread (torch's current device and stream are
        # per thread): the caller's device and stream unless pinned
        streams = {d: torch.cuda.current_stream(d) for d in set(devices)
                   if d.type == "cuda"}

        def on_device(dev: torch.device):
            if dev.type != "cuda":
                return contextlib.nullcontext()
            ctx = contextlib.ExitStack()
            ctx.enter_context(torch.cuda.device(dev))
            ctx.enter_context(torch.cuda.stream(streams[dev]))
            return ctx

        # the stage's tasks build each scan / filter / project step once
        # (PlanCompiler.fragment_jit under a stage cache)
        stage_steps: Dict = {}

        def run_task(task_index: int):
            """One task's fragment execution; returns (its output batch
            for an ici stage, else None; its wall seconds)."""
            t0 = time.perf_counter()  # lint: allow-wall-clock
            # thread CPU time at the driver boundary: each task runs on
            # its own thread, so thread_time isolates ITS compute from
            # the waits that wall time folds in
            c0 = time.thread_time()
            task_dev = devices[task_index]
            # device-pinned concurrent tasks keep PER-TASK pools (each
            # owns a position, so budgets must not stack in one pool);
            # everything else charges a child of the query context
            if pin and stage.n_tasks > 1 and self.memory.budget is not None:
                from .memory import MemoryContext, MemoryPool
                task_mem = MemoryContext(
                    MemoryPool(self.memory.budget),
                    f"task/{frag.fragment_id}.{task_index}",
                    max_bytes=cfg.memory_max_query_bytes)
            else:
                task_mem = self.memory.new_child(
                    f"task/{frag.fragment_id}.{task_index}")
            ctx = TaskContext(config=cfg, device=task_dev,
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
                if device_inputs[rnode.id] and pin:
                    ctx.remote_batches[rnode.id] = _device_reader(
                        sources, task_index, rnode, abort=abort,
                        stats=self.stats, pack_rows=max(
                            cfg.batch_rows, EXCHANGE_PACK_ROWS))
                else:
                    ctx.remote_pages[rnode.id] = _remote_reader(
                        sources, task_index,
                        client_threads=cfg.exchange_client_threads)
                ctx.remote_rows[rnode.id] = sum(
                    _rows_for_consumer(src, task_index) for src in sources)
            compiler = PlanCompiler(ctx)
            span_ctx = (self.tracer.span(
                f"task {frag.fragment_id}.{task_index}",
                parent=f"fragment {frag.fragment_id}",
                task_index=task_index)
                if self.tracer is not None else contextlib.nullcontext())
            out = None
            split_wall, split_bytes = 0.0, 0
            task_sums: Dict[str, DynamicFilterSummary] = {}

            with span_ctx, on_device(task_dev):
                if ici:
                    # device path: the output stays on this position; a
                    # host summarization here would sync the exchange, so
                    # ici edges publish no dynamic filter (absent summary
                    # == unknown == prune nothing)
                    from .pipeline import _compact_concat
                    batches = list(compiler.run_to_batches(frag.root))
                    out = _compact_concat(batches) if batches else None
                else:
                    for page in compiler.run_to_pages(frag.root):
                        if abort.is_set():
                            raise StageAbortedError(
                                f"sibling task of stage {frag.fragment_id}"
                                f" failed")
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
            if dyn_idx and not ici:
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
            if ctx.stats:
                # the task's device-side row counts read once
                settle_node_stats(ctx.stats)
            if self.node_stats is not None and ctx.stats:
                with self._stats_lock:
                    merge_node_stats(self.node_stats, ctx.stats)
            if self.tracer is not None and ctx.stats:
                # operator spans close out the query->fragment->task->
                # operator hierarchy; operators stream interleaved so their
                # intervals don't nest in real time -- each span is emitted
                # at task end carrying its measured wall as an attribute
                for nid, st in ctx.stats.items():
                    with self.tracer.span(
                            f"operator {frag.fragment_id}.{task_index}."
                            f"{nid}",
                            parent=f"task {frag.fragment_id}.{task_index}",
                            plan_node_id=nid,
                            operator=st.get("operatorType", ""),
                            rows=st.get("rows", 0),
                            wall_s=st.get("wall_s", 0.0)):
                        pass
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
            return out, wall

        def run_task_retrying(task_index: int):
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
                        # terminal: stop siblings and any in-flight
                        # device exchange consumers of this stage
                        abort.set()
                        raise
            return None, 0.0

        # a stage's N tasks run CONCURRENTLY (SqlStageExecution.scheduleTask
        # / the worker TaskExecutor thread pool).  Pinned tasks own their
        # position (per-task pools); unpinned tasks share one device, so
        # under a memory budget their per-task pools would stack to
        # n_tasks x budget -- those run sequentially
        stage_t0 = time.perf_counter()  # lint: allow-wall-clock
        concurrent = stage.n_tasks > 1 and (
            pin or cfg.memory_budget_bytes is None)
        # fabric / partitioning ride on the fragment span, so an exported
        # OTLP trace shows which wire each inter-stage edge took
        frag_span = (self.tracer.span(
            f"fragment {frag.fragment_id}", parent="query",
            n_tasks=stage.n_tasks, partitioning=str(frag.partitioning),
            fabric=str(getattr(scheme, "fabric", None) or "http"))
            if self.tracer is not None else contextlib.nullcontext())
        with frag_span:
            if not concurrent:
                results = [run_task_retrying(i)
                           for i in range(stage.n_tasks)]
            else:
                from concurrent.futures import ThreadPoolExecutor
                with ThreadPoolExecutor(
                        max_workers=stage.n_tasks) as pool_ex:
                    results = list(pool_ex.map(run_task_retrying,
                                               range(stage.n_tasks)))
        task_batches = [r[0] for r in results]
        stage.task_walls = [round(r[1], 4) for r in results]
        stage.stage_wall = round(
            time.perf_counter() - stage_t0, 4)  # lint: allow-wall-clock
        if dyn_idx and not ici:
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
        if ici:
            keys = tuple(out_names[i] for i in key_indices)
            if not self._ici_exchange(stage, task_batches, keys):
                # metadata disagreement across tasks (dictionaries /
                # schema / ARRAY columns): demote this edge to the page
                # fabric -- correctness over the fast path
                from ..parallel.fabric import FABRIC_HTTP
                FABRIC_METRICS.record("ici", fallbacks=1)
                self.stats.add("exchangeFabricIciFallbacks", 1)
                stage.fabric = FABRIC_HTTP
                stage.fabric_reason = \
                    "runtime fallback: task batch metadata disagreed"
                self._spill_batches_to_pages(
                    stage, task_batches, out_names, out_types,
                    key_indices)
        if self.config.batch_mode and stage.device_out is None:
            # durable inter-stage exchange (the Spark-shuffle analog)
            stage.buffers.materialize(self._batch_dir(frag.fragment_id))

    # -- device exchange ("ici" fabric) -----------------------------------

    def _ici_exchange(self, stage: StageInfo, task_batches: List,
                      keys: Tuple[str, ...]) -> bool:
        """Exchange the per-task output batches across the mesh in
        fixed-size row chunks; on success stage.device_out[consumer]
        holds that consumer's rows on its position as a list of chunk
        Batches.  Returns False when per-task batch metadata
        (dictionaries / null-ness / schema / ARRAY columns) disagrees
        with what the exchange can carry -- the caller then falls back to
        the page exchange.

        With quota == chunk rows, bucket overflow is statically
        impossible (a chunk of C rows per position can never put more
        than C rows in one bucket), so every chunk's exchange is queued
        back to back with no host sync: the one host read is the live
        counts before the loop (each producer's live rows, and the rows
        each consumer will receive, which size its aggregation)."""
        from ..parallel.exchange import (bucket_counts,
                                         make_partitioned_exchange)
        from ..parallel.fabric import FABRIC_METRICS, ICI_CHUNK_TUNER
        from .batch import Batch, Column
        from .operators import compact
        mesh = self.config.mesh
        devices = list(mesh.devices)
        n = stage.n_tasks

        template = next((b for b in task_batches if b is not None), None)
        if template is None:
            stage.device_out = [[] for _ in range(n)]
            stage.device_ready = [[] for _ in range(n)]
            stage.device_rows = [0] * n
            return True
        # schema / metadata must agree across tasks (scan dictionaries are
        # table-stable, so they normally do); ARRAY columns carry a
        # ragged `lengths` companion the exchange does not ship
        if any(c.lengths is not None for c in template.columns.values()):
            return False
        tstruct = _batch_meta(template)
        for b in task_batches:
            if b is not None and _batch_meta(b) != tstruct:
                return False

        t0 = time.perf_counter()  # lint: allow-wall-clock
        # ONE device->host transfer covers every task's live-row count
        # and the rows routed to each consumer -- the only host sync on
        # this path
        present = [b for b in task_batches if b is not None]
        routed = bucket_counts(present, list(keys), n)
        host = torch.stack([  # lint: allow-host-sync
            torch.cat([b.mask.sum().reshape(1), r]).to(devices[0])
            for b, r in zip(present, routed)]).tolist()
        max_live = max(int(row[0]) for row in host)
        stage.device_rows = [sum(int(row[1 + d]) for row in host)
                             for d in range(n)]

        # explicit exchange.ici-chunk-rows pins the chunk size; the
        # default (0) asks the tuner, which adapts the NEXT run's size
        # from this run's observed compute / exchange overlap
        rows_cfg = int(self.config.exec_config.ici_chunk_rows)
        C = rows_cfg if rows_cfg >= 1 else ICI_CHUNK_TUNER.chunk_rows()
        # no program is compiled per chunk shape here, so a chunk is cut
        # to the largest producer's live rows (the power of two above):
        # the same single chunk, without the padding to C
        C = min(C, 1 << max(0, max_live - 1).bit_length())
        n_chunks = max(1, -(-max_live // C))
        B = n_chunks * C

        norm = []
        for i, b in enumerate(task_batches):
            with _on(devices[i]):
                # compact packs live rows into a contiguous prefix, so the
                # fixed-size chunk slices below tile the live set
                norm.append(_zeros_like_batch(template, B, devices[i])
                            if b is None else compact(b, B))

        exch = make_partitioned_exchange(mesh, keys, quota=C)

        abort = stage.abort
        stage.device_out = [[] for _ in range(n)]
        stage.device_ready = [[] for _ in range(n)]
        bytes_moved = 0
        for k in range(n_chunks):
            if abort is not None and abort.is_set():
                raise StageAbortedError(
                    f"stage {stage.fragment.fragment_id} aborted "
                    f"mid-exchange")
            lo, hi = k * C, (k + 1) * C
            chunk = []
            for nb in norm:
                cols = {}
                for name, c in template.columns.items():
                    nc = nb.columns[name]
                    nulls = (nc.null_mask()[lo:hi]
                             if c.nulls is not None else None)
                    cols[name] = Column(nc.values[lo:hi], nulls,
                                        c.dictionary, c.lazy)
                    bytes_moved += _nbytes(cols[name].values) + (
                        _nbytes(nulls) if nulls is not None else 0)
                bytes_moved += _nbytes(nb.mask[lo:hi])
                chunk.append(Batch(cols, nb.mask[lo:hi]))
            # overflow is statically impossible at quota == C, so the
            # flag is dropped without a host read: nothing in this loop
            # blocks
            outs, _overflow = exch(chunk)
            for i, out in enumerate(outs):
                cols = {name: Column(_shard_on(c.values, devices[i]),
                                     (_shard_on(c.nulls, devices[i])
                                      if c.nulls is not None else None),
                                     c.dictionary, c.lazy)
                        for name, c in out.columns.items()}
                stage.device_out[i].append(
                    Batch(cols, _shard_on(out.mask, devices[i])))
                stage.device_ready[i].append(_ready_event(devices[i]))
        wall = time.perf_counter() - t0  # lint: allow-wall-clock
        FABRIC_METRICS.record("ici", exchanges=1, chunks=n_chunks,
                              bytes_moved=bytes_moved,
                              exchange_wall_s=wall)
        if rows_cfg < 1:
            # auto-tune feedback: the consumer-side walls land in
            # FABRIC_METRICS as the stage drains, so the fraction seen
            # here reflects completed exchanges up to this one
            ICI_CHUNK_TUNER.observe(FABRIC_METRICS.overlap_fraction("ici"))
        self.stats.add("exchangeFabricIciBytes", bytes_moved, "BYTE")
        self.stats.add("exchangeFabricIciChunks", n_chunks)
        self.stats.add("exchangeFabricIciDispatchWallNanos",
                       wall * 1e9, "NANO")
        return True

    def _spill_batches_to_pages(self, stage: StageInfo, task_batches,
                                out_names, out_types, key_indices) -> None:
        """The runtime fallback of an ici stage: its tasks' device output
        split into the page buffers, as the http fabric would have."""
        from .batch import batch_to_page
        for task_index, b in enumerate(task_batches):
            if b is None:
                continue
            page = batch_to_page(b, out_names, out_types)
            if not page.position_count:
                continue
            targets = partition_targets(page, out_types, key_indices,
                                        stage.n_partitions)
            for p, sub in enumerate(
                    split_page(page, targets, stage.n_partitions)):
                if sub is not None:
                    stage.buffers.add(task_index, p, sub)

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


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _on(device: torch.device):
    """`device` made current on this thread (nothing to do on the CPU)."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def _ready_event(device: torch.device):
    """A CUDA event recorded on `device`'s current stream after the work
    queued so far (None on the CPU, where every op has completed)."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


def _batch_meta(b) -> tuple:
    return tuple(sorted(
        (name, str(c.values.dtype), c.nulls is not None,
         c.lengths is not None, c.dictionary, c.lazy)
        for name, c in b.columns.items()))


def _zeros_like_batch(template, B: int, device: torch.device):
    """An all-dead batch of `template`'s columns with B rows on `device`
    (a producer task that emitted nothing)."""
    from .batch import Batch, Column
    cols = {}
    for name, c in template.columns.items():
        v = torch.zeros((B,) + tuple(c.values.shape[1:]),
                        dtype=c.values.dtype, device=device)
        nn = (torch.zeros(B, dtype=torch.bool, device=device)
              if c.nulls is not None else None)
        cols[name] = Column(v, nn, c.dictionary, c.lazy)
    return Batch(cols, torch.zeros(B, dtype=torch.bool, device=device))


def _shard_on(arr: torch.Tensor, device: torch.device) -> torch.Tensor:
    """The exchanged tensor of the position on `device` (the reference
    picks it out of a global array's shards; here each position's output
    is its own tensor, which must already lie there)."""
    if arr.device != device:
        raise RuntimeError(f"no shard on {device} (found on {arr.device})")
    return arr


def _rows_for_consumer(src: StageInfo, consumer_task: int) -> int:
    """The rows one consumer task reads from a source stage, counted
    without a device sync or a shuffle-file read."""
    if src.device_out is not None:
        return src.device_rows[consumer_task]
    return src.buffers.rows_for_consumer(consumer_task)


def _device_reader(sources: List[StageInfo], consumer_task: int, rnode,
                   abort=None, stats=None, pack_rows: int = 1 << 18):
    """Consumer-side ici input: this task's device-resident chunk of each
    exchange, renamed positionally to the RemoteSourceNode's outputs.

    The chunks were queued by the producer stage (_ici_exchange), so the
    first touch of each may wait for its exchange.  The wait is measured
    by polling the chunk's CUDA event (so a sibling abort is honored
    promptly instead of being stuck in a blocking sync) and reported
    against the generator's total drain wall: overlap = 1 - wait /
    drain.  A consumer's chunk holds about one producer chunk of live
    rows in (positions x chunk) slots, so consecutive chunks are packed
    (_pack_chunks) until they hold about `pack_rows` live rows, as the
    page path packs its pages: the operators over an exchange pay their
    host dispatch per batch, and a sort or a join per slot."""
    from ..parallel.fabric import FABRIC_METRICS
    from .batch import Batch
    names = [v.name for v in rnode.outputs]

    def chunks():
        for src in sources:
            prod = src.out_names
            ready = src.device_ready[consumer_task]
            for j, b in enumerate(src.device_out[consumer_task]):
                yield ready[j], len(src.device_out), Batch(
                    {names[k]: b.columns[prod[k]]
                     for k in range(len(names))}, b.mask)

    def read():
        drain0 = time.perf_counter()  # lint: allow-wall-clock
        wait = 0.0
        group, cap = [], 0
        try:
            for ev, positions, b in chunks():
                w0 = time.perf_counter()  # lint: allow-wall-clock
                while ev is not None and not ev.query():
                    if abort is not None and abort.is_set():
                        raise StageAbortedError(
                            "stage aborted while draining the device "
                            "exchange")
                    time.sleep(0)
                wait += time.perf_counter() - w0  # lint: allow-wall-clock
                group.append(b)
                cap += b.capacity
                if cap >= positions * pack_rows:
                    yield _pack_chunks(group)
                    group, cap = [], 0
            if group:
                yield _pack_chunks(group)
        finally:
            drain = time.perf_counter() - drain0  # lint: allow-wall-clock
            FABRIC_METRICS.record("ici", compute_wall_s=drain,
                                  wait_wall_s=wait)
            if stats is not None:
                stats.add("exchangeFabricIciDrainWallNanos",
                          drain * 1e9, "NANO")
                stats.add("exchangeFabricIciWaitWallNanos",
                          wait * 1e9, "NANO")
    return read


def _pack_chunks(chunks: List) -> "Batch":
    """Consecutive exchanged chunks as one dense batch: each chunk's live
    rows moved to its prefix and cut there (one host read of the chunks'
    live counts), then concatenated."""
    from .operators import compact
    from .pipeline import _concat
    counts = torch.stack(  # lint: allow-host-sync
        [b.mask.sum() for b in chunks]).tolist()
    live = [compact(b, n) for b, n in zip(chunks, counts) if n]
    return _concat(live) if live else compact(chunks[0], 1)


def _device_dicts_agree(sources: List[StageInfo]) -> bool:
    """Device batches skip the union-dictionary remap of the page path
    (exec/batch.py pages_to_batches), so the device reader is only safe
    when every source fragment ships identical per-column dictionary /
    lazy metadata."""
    seen: Dict[int, tuple] = {}
    for src in sources:
        for chunks in src.device_out or []:
            for b in chunks or ():
                cols = [b.columns[n] for n in src.out_names]
                for j, c in enumerate(cols):
                    meta = (c.dictionary, c.lazy)
                    if seen.setdefault(j, meta) != meta:
                        return False
    return True


def _remote_reader(sources: List[StageInfo], consumer_task: int,
                   client_threads: int = 1):
    """Page reader of one consumer task; device-exchange sources
    (device_out) are converted to pages lazily so mixed device / page
    source sets lose no rows.  With client_threads > 1 the sources drain
    concurrently through the local-exchange arrival-order queue (the
    in-process mirror of the HTTP ExchangeClient; cross-source page order
    carries no semantics -- ordering, if any, is applied inside the
    consuming fragment)."""
    def _source_pages(src: StageInfo) -> Iterator[Page]:
        if src.device_out is not None:
            from .batch import batch_to_page
            types = [v.type for v in src.fragment.root.output_variables]
            for b in src.device_out[consumer_task]:
                page = batch_to_page(b, src.out_names, types)
                if page.position_count:
                    yield page
            return
        yield from src.buffers.pages_for_consumer(consumer_task)

    def read() -> Iterator[Page]:
        if client_threads > 1 and len(sources) > 1:
            from .local_exchange import parallel_drain
            thunks = [(lambda s=src: _source_pages(s)) for src in sources]
            yield from parallel_drain(thunks, client_threads)
        else:
            for src in sources:
                yield from _source_pages(src)
    return read
