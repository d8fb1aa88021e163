"""Plan -> executable pipelines over torch tensors.

The port of presto_tpu/exec/pipeline.py for the ported slices: a
TableScan over device-resident encoded columns or columns generated on
the fly, host-generated columns and late-materialized strings (row ids,
the string forms over them hoisted to whole-column host caches),
streaming Filter/Project,
Aggregation, MarkDistinct, Sort, TopN, Limit, Window, Values, Union,
Join (INNER / LEFT / FULL), SemiJoin, AssignUniqueId, EnforceSingleRow,
Output, a local Exchange and a RemoteSource (the distributed scheduler's
exchange input, host pages moved to the task's device).  A Join or
SemiJoin over a fusible chain streams the torch
fused chain (fused.fused_stream); otherwise the build side is
materialized (cached per structural key) and the probe batches stream
through operators.probe_join / probe_join_direct.  An
aggregation over a fused scan -> filter -> project -> join / semi-join
chain runs through the hand-written CUDA scan kernels (direct slots for
G <= 64, exec/kernels/scan_kernel.py; span or hash slots beyond,
exec/kernels/grouped.py; the fanout-1 probes inside them,
exec/kernels/join.py), the join build sides drained from the streaming
sources; after a kernel's metered decline, or under scan_kernel="xla",
the torch fused chain (exec/fused.py FusedChain.make) in the reference's
XLA-chain mode order; without a fused chain, the streaming aggregation.
A WindowNode's functions run in one launch of the CUDA window kernel over
the sorted run (exec/kernels/window.py), operators.window_batch after its
metered decline.  An aggregation grouped by the bucket key of a
co-bucketed scan runs one bucket lifespan at a time when the key span
is large or the lifespans are forced (exec/grouped.py), and a scan with
several splits drains them on task_concurrency driver threads
(exec/local_exchange.py).  A column the resident store does not hold, and every
column under a memory budget, is generated on the fly per chunk; under a
budget a join build past it spills into the grace hash join and an
aggregation into a key-partitioned store (exec/memory.py).  Every tensor
is allocated on the task's device (TaskContext.device).  The scan,
filter and project steps share their compiled state across plans and
runners by the subtree's structural key (PlanCompiler.fragment_jit,
serving/fragments.py); a TableWriter streams its input into a writable
connector and a TableFinish commits it.  A GroupId (a translated
reference fragment's grouping sets) yields one projection per set of
each source batch.  A plan shape or option outside the slices raises
NotImplementedError naming what is missing; nothing falls back quietly.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..common.page import Page
from ..common.types import (BOOLEAN, ArrayType, CharType, DoubleType,
                            RealType, Type, VarcharType)
from ..connectors import catalog
from ..spi import plan as P
from ..spi.expr import (CallExpression, ConstantExpression, RowExpression,
                        SpecialFormExpression, VariableReferenceExpression)
from . import operators as ops
from .batch import Batch, Column, batch_to_page, pages_to_batches
from .lowering import (Lowering, canonical_name, constant_device_value,
                       expr_has_params, torch_dtype)
from .memory import (MemoryContext, MemoryExceededError, MemoryPool,
                     PartitionedSpillStore, batch_bytes)

DEFAULT_CAPACITY = 1 << 20
# ceiling on the materialized (keys + aggregate inputs) bytes of the
# fused chain's sort aggregation; beyond it the hashed table takes over
SORT_AGG_MAX_BYTES = 6 << 30
# rows of the empty chunk a fused chain is applied to once, to learn its
# output columns' dtypes, NULL-ability and dictionaries
PROBE_ROWS = 8
# rows the torch fused chain carries through one step: contiguous scan
# chunks are applied together, up to this many rows after the chain's
# fanout expansion (a step's ops cost the host the same at 64K rows as
# at 1M, so fewer, larger steps keep the card busy)
CHAIN_STEP_ROWS = 1 << 20
# rows an exchange consumer packs its input pages into per batch (at
# least batch_rows): the operators over an exchange stream batch by batch,
# and their host dispatch is the same at 64K rows as at 256K
EXCHANGE_PACK_ROWS = 1 << 18
# capacities a sparse aggregation table is compacted to
_COMPACT_BUCKETS = (1 << 12, 1 << 16, 1 << 18, 1 << 20)


def _bucket_for(live: int):
    """Smallest standard bucket holding `live` rows (None above the
    largest bucket)."""
    return next((s for s in _COMPACT_BUCKETS if s >= live), None)


def _maybe_compact(batch: Batch) -> Batch:
    """Compact a single mostly-dead batch (a sparse aggregation table) to
    a bucketed capacity so downstream sorts don't pay full-capacity
    costs.  One host sync for the live count."""
    live = int(batch.mask.sum())
    if live * 4 >= batch.capacity:
        return batch
    bucket = _bucket_for(live)
    if bucket is None or bucket >= batch.capacity:
        return batch
    return ops.compact(batch, bucket)


def _compact_concat(batches: List[Batch]) -> Batch:
    """Concatenate batches, dropping masked-out padding when it
    dominates: when under 1/4 of the merged rows are live, each batch is
    compacted to a power-of-two bucket first (one host sync for the live
    counts), so a materialized selective input does not carry its dead
    capacity into sorts, windows and join builds."""
    if len(batches) == 1:
        return batches[0]
    total_cap = sum(b.capacity for b in batches)
    counts = torch.stack(  # lint: allow-host-sync
        [b.mask.sum() for b in batches]).tolist()
    if sum(counts) * 4 >= total_cap:
        return _concat(batches)
    out = []
    for b, n in zip(batches, counts):
        if n == 0:
            continue
        bucket = _bucket_for(n) or 1 << (int(n) - 1).bit_length()
        out.append(b if bucket >= b.capacity else ops.compact(b, bucket))
    if not out:
        return batches[0]      # all rows masked: keep an all-dead batch
    return _concat(out)


def _split_batch(batch: Batch) -> List[Batch]:
    """A probe batch halved (the join's overflow recursion)."""
    cap = batch.capacity
    half = cap // 2
    return [Batch({n: c.slice_rows(lo, hi) for n, c in batch.columns.items()},
                  batch.mask[lo:hi]) for lo, hi in ((0, half), (half, cap))]


@dataclass
class ExecutionConfig:
    batch_rows: int = DEFAULT_CAPACITY      # scan page/batch capacity
    agg_slots: int = 4096                   # initial group table size
    max_agg_retries: int = 6                # hashed-table collision retries
    splits_per_scan: int = 4
    # device-memory accounting and spill (exec/memory.py); None =
    # unlimited.  Config key query.max-memory-per-node
    memory_budget_bytes: Optional[int] = None
    # spill a join build or an aggregation that outgrows the budget into
    # a partitioned host store (experimental.spill-enabled); False raises
    # MemoryExceededError instead
    spill_enabled: bool = True
    spill_partitions: int = 8
    # host-RAM ceiling for spill staging (None = unlimited); past it whole
    # buckets overflow to LZ4-compressed disk files (config keys
    # experimental.spiller-max-used-space / spill.host-budget-bytes)
    spill_budget_bytes: Optional[int] = None
    # directory of the disk tier (experimental.spiller-spill-path /
    # spill.path); None = the system temp dir
    spill_path: Optional[str] = None
    # on the card, stage device -> host spill copies on the store's own
    # CUDA stream into pinned buffers, two in flight, so eviction overlaps
    # the operator's compute (spillOverlapFraction); False copies
    # synchronously.  Config key spill.async-staging
    spill_async_staging: bool = True
    # query-level memory ceiling (query.max-memory): a typed user error
    # that fails fast; revocable (spillable) bytes are exempt.  None =
    # unlimited
    memory_max_query_bytes: Optional[int] = None
    # run an aggregation's scan -> filter/project -> join chain as one
    # fused chain (the CUDA scan kernels, or the torch chain after their
    # decline); False streams it operator by operator, metered as
    # fusionDeclinedDisabled.  Config key task.fuse-pipelines
    fuse_pipelines: bool = True
    # EXPLAIN ANALYZE profiles the FUSED execution by default (the chain
    # and the scan kernels count live rows per step); True turns fusion
    # off under ANALYZE, so every operator streams through its
    # instrumented source (session property analyze_unfused)
    analyze_unfused: bool = False
    # session property `profile = true`: a torch.profiler capture of the
    # query's execution, written as a Chrome trace into a per-query
    # directory under profile_dir, named by the EXPLAIN ANALYZE footer
    # (telemetry/profiler.py).  Config key telemetry.profile-dir (the
    # reference's default); "" disables the capture
    profile: bool = False
    profile_dir: str = "/tmp/presto_tpu_profiles"
    # plan sanity/type validation (presto_tpu_torch/analysis)
    plan_validation: str = "on"
    # -- device-resident columnar storage (presto_tpu_torch/storage) -----
    # scans read device-generated columns from the resident store; False
    # (and any column the store does not take) generates them per chunk
    storage_enabled: bool = True
    storage_budget_bytes: Optional[int] = 6 << 30
    storage_max_column_bytes: int = 1 << 30
    storage_zone_rows: int = 1 << 16
    storage_encodings: bool = True
    # -- fused scan kernel (exec/kernels) --------------------------------
    # the reference's values (SCAN_KERNEL_MODES): "pallas" and "auto" both
    # run the hand-written CUDA kernels (their plain torch versions for
    # CPU tensors); "xla" runs the reference's non-kernel paths in torch:
    # a window or an aggregation meters kernelDeclinedDisabled and runs
    # operators.window_batch or the torch fused chain.
    # Config key scan.kernel / session scan_kernel
    scan_kernel: str = "auto"
    # output capacity of a streaming join probe (operators.probe_join):
    # a probe batch whose pairs overflow it is halved and retried
    join_out_capacity: int = 1 << 21
    # runtime dynamic filters: a streaming INNER join narrows its probe
    # stream to the build keys' [min, max]; scans read the summaries
    # delivered in TaskContext.dynamic_filters (config key
    # optimizer.dynamic-filtering / session dynamic_filtering)
    dynamic_filtering: bool = True
    # bounded wait for an expected summary (the remote scheduler's; the
    # local runner delivers none) and the distinct-value cap of a set
    # summary (dynamic-filtering.wait-timeout / .max-distinct-values)
    dynamic_filtering_wait_timeout_s: float = 0.5
    dynamic_filtering_max_distinct: int = 256
    # staging discipline of the scan kernels' per-row input arrays
    # (SCAN_KERNEL_DMA_MODES): "single" loads them from device memory as
    # each tile computes; "double" keeps the next tiles of the arrays the
    # plan reads densely in flight into a shared-memory ring while the
    # current one computes (kernel #2, exec/kernels/scan_kernel.py
    # ScanPlan.staging; a plan with nothing worth staging runs unstaged),
    # metered as kernelDmaStagedBlocks / kernelDmaPrefetchedBlocks /
    # kernelDmaOverlapFraction.  Config key scan.kernel-dma
    scan_kernel_dma: str = "single"
    # grouped (lifespan) execution over connector co-bucketed tables
    # (exec/grouped.py): 0 = auto (engage when the anchor keyspace exceeds
    # grouped.AUTO_SPAN_THRESHOLD), 1 = off, N >= 2 = force N bucket
    # lifespans.  Config key task.grouped-lifespans / session
    # grouped_lifespans
    grouped_lifespans: int = 0
    # lifespans staged AHEAD of the one being computed (their builds
    # materialized, their dup flags copied to the host without a sync);
    # 0 = strictly serial.  Config key task.grouped-prefetch-depth /
    # session grouped_prefetch_depth
    grouped_prefetch_depth: int = 1
    # distributed grouped stages: when a source stage is grouped-eligible
    # (exec/grouped.py stage_shards_lifespans), every task gets the FULL
    # split set plus a disjoint round-robin subset of the bucket layout
    # (task i runs lifespans i, i+N, ...); the per-bucket partial
    # aggregates merge at the FINAL stage.  Config key
    # task.grouped-lifespan-sharding / session grouped_lifespan_sharding
    grouped_lifespan_sharding: bool = True
    # intra-task driver concurrency (driver-per-split, exec/
    # local_exchange.py): a leaf scan with more than one split drains its
    # splits on this many threads.  Config key task.max-drivers-per-task
    task_concurrency: int = 1
    # concurrent readers of a multi-source exchange input
    # (exec/scheduler.py _remote_reader over local_exchange.parallel_drain;
    # config key exchange.client-threads / session exchange_client_threads)
    exchange_client_threads: int = 4
    # -- the HTTP task plane (worker/task.py, coordinator.py) ------------
    # compress exchange pages on the wire (SerializedPage COMPRESSED
    # marker; config key exchange.compression-enabled) with this codec
    # (exchange.compression-codec: LZ4 | SNAPPY | ZSTD | GZIP | ZLIB | NONE)
    exchange_compression: bool = False
    exchange_compression_codec: str = "LZ4"
    # per-lineage retry attempts for FAILED / lost remote tasks (0 =
    # fail-fast); > 0 also makes worker output buffers RETAIN acknowledged
    # pages until task teardown, so a restarted consumer replays from
    # token 0 (config key task.remote-task-retry-attempts)
    remote_task_retry_attempts: int = 2
    # how long an exchange client retries an unreachable source before
    # declaring the producer lost (exchange.max-error-duration)
    exchange_max_error_duration_s: float = 60.0
    # bytes buffered inside one ExchangeClient before its pullers park
    # (exchange.max-buffer-size), and the results endpoint's response
    # target that producers coalesce small pages up to
    # (exchange.max-response-size)
    exchange_max_buffer_bytes: int = 32 << 20
    exchange_max_response_bytes: int = 1 << 20
    # RETRY_POLICY_MODES: "query" restarts a failed lineage with its
    # ancestors over retained in-memory buffers; "task" spools every
    # stage's output durably (worker/spooling.py) so a failed task is
    # retried alone (config key retry-policy / session retry_policy)
    retry_policy: str = "query"
    # spool directory under retry_policy="task" (spool.path; None: the
    # spill path, then the system temp dir) and its host-RAM staging
    # ceiling per task (spool.staging-budget-bytes)
    spool_path: Optional[str] = None
    spool_staging_budget_bytes: int = 16 << 20
    # query wall-clock budget (query.max-execution-time): the coordinator
    # forwards each task's remaining budget as X-Presto-Task-Deadline.
    # 0 = no deadline
    query_max_execution_time_s: float = 0.0
    # the coordinator drops a worker whose last successful probe is older
    # than this (failure-detector.heartbeat-timeout); 0 = streak only
    failure_detector_heartbeat_timeout_s: float = 0.0
    # chaos hook: the probability a task fails at start, rolled from a
    # hash of the task id (task.fault-injection-probability)
    fault_injection_probability: float = 0.0
    # runtime lock-order validation of the task threads (common/locks.py;
    # debug.lock-validation / session lock_validation)
    lock_validation: bool = False
    # which fabric hashed remote-exchange edges ride (parallel/fabric.py
    # FABRICS): "auto", "http" (host pages) or "ici" (the device
    # all_to_all over the runner's mesh, parallel/exchange.py; with no
    # mesh every edge resolves to http).  Config key exchange.fabric
    exchange_fabric: str = "auto"
    # chunk granularity of the chunked device exchange
    # (exchange.ici-chunk-rows): each producer's rows split into
    # fixed-size chunks exchanged back to back with no host sync between
    # them, so chunk k+1's exchange is queued while the consumer computes
    # on chunk k.  0 = auto-tune: the scheduler picks the next run's
    # chunk size from the observed overlap_fraction in FabricMetrics
    # (parallel/fabric.py IciChunkTuner)
    ici_chunk_rows: int = 0
    # re-decide broadcast-vs-partitioned exchange (and INNER join sides)
    # at stage boundaries from the OBSERVED build cardinality
    # (exec/adaptive.py; config key adaptive.exchange / session
    # adaptive_exchange)
    adaptive_exchange: bool = True
    # seed task counts, agg slot sizing and admission memory estimates
    # from matching query-history records keyed on the canonical plan
    # template (adaptive.history-sizing / session adaptive_history_sizing)
    adaptive_history_sizing: bool = False
    # observed group count from a prior run of the same plan template
    # (set by the runner's history-sizing pass, never by hand): when
    # present it REPLACES the optimizer's group estimate for aggregation
    # table sizing.  A dataclass field so the plan-cache config
    # fingerprint re-keys compiled plans on a changed hint
    history_agg_groups: Optional[int] = None
    # -- serving plane (presto_tpu_torch/serving) --------------------------
    # share the scan / filter / project steps' compiled state across
    # DIFFERENT plans by subtree structural key (serving/fragments.py):
    # queries sharing a scan -> filter subchain reuse one artifact.  Only
    # engages for compilers without a stage-scoped cache (the scheduler's
    # tasks share theirs per stage); a fingerprinted field, so flipping
    # it re-keys the canonical plan cache
    fragment_share: bool = True

    def __post_init__(self):
        if self.scan_kernel not in SCAN_KERNEL_MODES:
            raise ValueError(f"scan_kernel must be one of "
                             f"{SCAN_KERNEL_MODES}, got {self.scan_kernel!r}")
        from ..parallel.fabric import FABRICS
        if self.exchange_fabric not in FABRICS:
            raise ValueError(f"exchange_fabric must be one of {FABRICS}, "
                             f"got {self.exchange_fabric!r}")
        if self.scan_kernel_dma not in SCAN_KERNEL_DMA_MODES:
            raise ValueError(f"scan_kernel_dma must be one of "
                             f"{SCAN_KERNEL_DMA_MODES}, got "
                             f"{self.scan_kernel_dma!r}")


# legal retry-policy / retry_policy values (worker/properties.py and the
# session property both validate against this)
RETRY_POLICY_MODES = ("query", "task")

# legal scan.kernel / scan_kernel values (the reference's)
SCAN_KERNEL_MODES = ("xla", "pallas", "auto")

# legal scan.kernel-dma / scan_kernel_dma values
SCAN_KERNEL_DMA_MODES = ("single", "double")


def tuned_config(**overrides) -> "ExecutionConfig":
    """The runner default ExecutionConfig: 64K-row scan batches and
    256K-row join output."""
    return ExecutionConfig(batch_rows=1 << 16, join_out_capacity=1 << 18,
                           **overrides)


@dataclass
class TaskContext:
    """Execution context for one task: configuration and device."""
    config: ExecutionConfig = field(default_factory=ExecutionConfig)
    # every tensor of the task is allocated here
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    # table-scan node id -> the splits this task scans (absent: the whole
    # table in splits_per_scan splits); grouped execution overrides a
    # bucketed build's scan with one bucket's row range
    splits: Dict[str, List[catalog.TableSplit]] = field(default_factory=dict)
    # device byte accounting for this task (created by PlanCompiler if absent)
    memory: Optional[MemoryContext] = None
    # runner-provided RuntimeStats sink (utils/runtime_stats.py)
    runtime_stats: Optional[object] = None
    # per-node operator stats, node id -> {rows, wall_s, batches, ...}
    # (None = off): a scan's driver walls land here, and the aggregation
    # keeps the single-lifespan path while it is on
    stats: Optional[Dict[str, dict]] = None
    # bound-parameter vector (one int64 device tensor) and its host values
    params: Optional[torch.Tensor] = None
    params_fingerprint: Optional[Tuple] = None
    # this task's index in its stage: namespaces AssignUniqueId's ids
    task_index: int = 0
    # runtime dynamic-filter summaries (filter id -> wire dict), read by
    # the scans lazily at drain time; the scheduler shares one dict
    # across a query's tasks and fills it as build stages finish
    dynamic_filters: Dict[str, dict] = field(default_factory=dict)
    # remote-source node id -> callable returning an iterator of host
    # Pages (the exchange input the scheduler wires per task)
    remote_pages: Dict[str, Callable[[], Iterator[Page]]] = field(
        default_factory=dict)
    # remote-source node id -> the rows those pages hold, counted by the
    # scheduler before the task starts (an aggregation with no group
    # estimate reads them)
    remote_rows: Dict[str, int] = field(default_factory=dict)
    # remote-source node id -> callable returning device Batches (the
    # "ici" fabric's input: chunks the device exchange placed on this
    # task's mesh position, exec/scheduler.py _device_reader)
    remote_batches: Dict[str, Callable[[], Iterator[Batch]]] = field(
        default_factory=dict)
    # lifespan sharding (exec/grouped.py stage_shards_lifespans): when set
    # to (shard_index, shard_count) this task owns bucket lifespans
    # shard_index, shard_index + shard_count, ... of the grouped layout;
    # its scans hold the FULL split set, and if grouped execution does
    # not engage only shard 0 runs the aggregation's fallback, so no row
    # is counted twice
    grouped_shard: Optional[Tuple[int, int]] = None
    # a stage's shared step states, keyed by (node id, purpose, extra):
    # the scheduler installs one dict per stage, so its tasks build each
    # scan / filter / project step once (PlanCompiler.fragment_jit)
    shared_steps: Optional[Dict] = None


class BatchSource:
    """A compiled sub-pipeline that can be iterated (possibly repeatedly)."""

    def __init__(self, fn: Callable[[], Iterator[Batch]],
                 names: List[str], types: List[Type]):
        self._fn = fn
        self.names = names
        self.types = types

    def batches(self) -> Iterator[Batch]:
        return self._fn()


class _RevocableBuildBuffer:
    """A join build side staged under a REVOCABLE reservation: under
    memory pressure (this build's own reservation miss, or the
    arbitrator serving another operator) the collected batches move into
    a partitioned host spill store, the grace join's build input, instead
    of the query failing.

    `add` reserves before taking the buffer lock (the arbitrator may pick
    this holder as its victim while the reservation waits), and the
    revoke callback never blocks: mid-mutation it declines (returns 0)."""

    def __init__(self, compiler: "PlanCompiler", keys, spill_enabled: bool):
        self._compiler = compiler
        self._pool = compiler.ctx.memory
        self._keys = list(keys)
        self._spill_enabled = spill_enabled
        self._lock = threading.Lock()
        self._finished = False
        self.collected: List[Batch] = []
        self.spill = None
        self._reserved = 0
        self._table_bytes = 0
        self._holder = self._pool.register_revocable(
            "join-build", self._revoke)

    # -- arbitrator-facing -------------------------------------------------
    def _revoke(self) -> int:
        if not self._spill_enabled:
            return 0
        if not self._lock.acquire(blocking=False):
            return 0   # mid-mutation: decline, never block
        try:
            if self._finished or not self._reserved:
                return 0
            return self._spill_locked()
        finally:
            self._lock.release()

    def _spill_locked(self) -> int:
        freed = self._reserved
        if self.spill is None:
            self.spill = self._compiler._new_spill_store()
        for cb in self.collected:
            self.spill.add(cb, self._keys)
        self.collected = []
        if freed:
            self._holder.free(freed)
            self._reserved = 0
        return freed

    # -- build-loop-facing -------------------------------------------------
    def add(self, b: Batch) -> None:
        nb = batch_bytes(b)
        ok = self.spill is None and self._holder.try_reserve(nb)
        with self._lock:
            if ok and self.spill is None:
                self.collected.append(b)
                self._reserved += nb
                return
            if ok:
                # revoked between the reservation and the lock: the batch
                # goes to the store, so the bytes go back
                self._holder.free(nb)
            if self.spill is None:
                if not self._spill_enabled:
                    raise MemoryExceededError(
                        f"join build side exceeds memory budget "
                        f"{self._pool.budget} bytes and spill is disabled")
                self._spill_locked()
            self.spill.add(b, self._keys)

    def finish(self):
        """-> (collected, spill).  Past this point the batches feed the
        device hash table, which spilling cannot shrink: the bytes stop
        being revocable and are re-charged as plain user memory (where
        the query.max-memory ceiling fires); pool pressure at the handoff
        instead turns the build into a grace join spill."""
        with self._lock:
            if self._reserved and self.spill is None:
                n = self._reserved
                self._holder.free(n)
                self._reserved = 0
                if self._pool.try_reserve(n):
                    self._table_bytes = n
                elif self._spill_enabled:
                    self._spill_locked()
                else:
                    self._finished = True
                    raise MemoryExceededError(
                        f"join build table of {n} bytes exceeds memory "
                        f"budget {self._pool.budget} bytes and spill is "
                        f"disabled")
            self._finished = True
            return self.collected, self.spill

    def close(self) -> None:
        with self._lock:
            self._finished = True
            self._holder.close()   # frees whatever is still reserved
            if self._table_bytes:
                self._pool.free(self._table_bytes)
                self._table_bytes = 0
            self.collected = []
            self._reserved = 0


def _concat(batches: List[Batch]) -> Batch:
    """One batch holding every input batch's rows.  A varchar column
    whose batches disagree on their dictionary or lazy tag is re-encoded
    to one merged dictionary first (_recode_strings)."""
    if len(batches) == 1:
        return batches[0]
    cols = {}
    for name, c0 in batches[0].columns.items():
        parts = [b.columns[name] for b in batches]
        if any(p.dictionary != c0.dictionary or p.lazy != c0.lazy
               for p in parts):
            parts = _recode_strings(parts)
            c0 = parts[0]
        nulls = None
        if any(p.nulls is not None for p in parts):
            nulls = torch.cat([p.null_mask() for p in parts])
        values = [p.values for p in parts]
        lengths = None
        if c0.lengths is not None:
            # ARRAY columns: lengths ride along like nulls, and each
            # element matrix is padded to the widest
            W = max(v.shape[1] for v in values)
            values = [torch.nn.functional.pad(v, (0, W - v.shape[1]))
                      for v in values]
            lengths = torch.cat([p.lengths for p in parts])
        cols[name] = Column(torch.cat(values), nulls, c0.dictionary,
                            c0.lazy, lengths)
    return Batch(cols, torch.cat([b.mask for b in batches]))


def _settle_entry(ent: dict) -> None:
    """Fold an operator-stats entry's device-side live-row count into its
    rows and bytes (one host read)."""
    pending = ent.pop("_pending", None)
    if pending is not None:
        rows = int(pending)
        ent["rows"] += rows
        ent["bytes"] = ent.get("bytes", 0) + rows * ent.get("_row_bytes", 0)
    dropped = ent.pop("_dropped", None)
    if dropped is not None:
        ent["dynamicFilterRowsDropped"] = \
            ent.get("dynamicFilterRowsDropped", 0) + int(dropped)


def settle_node_stats(stats: Optional[Dict[str, dict]]) -> None:
    """Every entry's pending device counts read into its numbers, and the
    private keys dropped (a stream its consumer stopped early never
    reached its end)."""
    for ent in (stats or {}).values():
        _settle_entry(ent)
        ent.pop("_row_bytes", None)


def _lazy_strings(col: Column) -> List[str]:
    """The strings of every row of a late-materialized column (host)."""
    cid, table, column, sf = col.lazy
    n = catalog.table_row_count(table, sf, cid)
    ids = col.values.cpu().numpy().astype(np.int64)  # lint: allow-host-sync
    ids = np.clip(ids, 0, n - 1)
    return catalog.generate_values_at(table, column, sf, ids, cid)


def _recode_strings(parts: List[Column]) -> List[Column]:
    """Varchar columns re-encoded onto one sorted merged dictionary (the
    reference's union re-encoding; lazy columns are generated for every
    row).  Each dictionary is remapped through a lookup table; a part
    already on the merged dictionary is kept."""
    strings = [p.dictionary if p.dictionary is not None
               else _lazy_strings(p) for p in parts]
    merged = tuple(sorted({s for ss in strings for s in ss})) or ("",)
    index = {s: i for i, s in enumerate(merged)}
    out = []
    for p, ss in zip(parts, strings):
        if p.dictionary == merged:
            out.append(p)
            continue
        codes = torch.tensor([index[s] for s in ss], dtype=torch.int32,
                             device=p.values.device)
        if p.dictionary is not None:     # a lookup table per code
            codes = codes[p.values.to(torch.int64).clamp(0, len(ss) - 1)]
        out.append(Column(codes, p.nulls, merged))
    return out


def _fragment_batch_sig(batch: Batch) -> tuple:
    """Hashable digest of the first-batch column structure a step's
    expression resolution depends on (names, dtypes, laziness, dictionary
    presence, NULL-ability, arrays): part of the fragment_jit key, so
    structurally equal subtrees whose resolution would differ never
    share a step."""
    out = []
    for n in sorted(batch.columns):
        c = batch.columns[n]
        out.append((n, str(c.values.dtype), c.values.ndim,
                    None if c.dictionary is None else len(c.dictionary),
                    c.lazy, c.nulls is not None, c.lengths is not None))
    return tuple(out)


class _ExprStep:
    """A filter's or projection's compiled step state, the unit
    fragment_jit shares: the expressions after the string hoister's
    resolution of the first batch, the hoisted host calls, and the
    ExprPrograms lowered from them (one Lowering per step).  Evaluation
    reads the batch and the bound-parameter vector only."""

    def __init__(self, hoister: "_StringHoister", first: Batch):
        self.exprs, self.hoisted = hoister.resolve(first)
        self.low = Lowering()
        for e in self.exprs:
            if not isinstance(e, VariableReferenceExpression):
                self.low.compile(e)

    def _eval(self, e, b: Batch, params) -> Column:
        return self.low.eval(
            e, b.with_params(params if expr_has_params(e) else None))

    def filter(self, b: Batch, params) -> Batch:
        b = _add_hoisted(b, self.hoisted)
        return ops.apply_filter(b, self._eval(self.exprs[0], b, params))

    def project(self, b: Batch, params, names) -> Batch:
        b = _add_hoisted(b, self.hoisted)
        return Batch({n: self._eval(e, b, params)
                      for n, e in zip(names, self.exprs)}, b.mask)


class PlanCompiler:
    def __init__(self, ctx: TaskContext):
        if ctx.memory is None:
            ctx.memory = MemoryContext(
                MemoryPool(ctx.config.memory_budget_bytes), "query",
                max_bytes=ctx.config.memory_max_query_bytes)
        self.ctx = ctx
        self._sources: Dict[str, BatchSource] = {}
        self.lowering = Lowering()
        # materialized results (join builds, keyed structurally) and
        # fused-stream entries, kept across re-executions of the plan
        self._cache: Dict = {}
        # this execution's spill stores, closed (disk files deleted, host
        # rows dropped) when its pages are drained
        self._spill_stores: List[PartitionedSpillStore] = []

    def _new_spill_store(self, salt: Optional[int] = None
                         ) -> PartitionedSpillStore:
        """An operator's spill store under the task's spill config: its
        bytes and walls land in this query's RuntimeStats and memory
        context."""
        cfg = self.ctx.config
        kw = {} if salt is None else {"salt": salt}
        store = PartitionedSpillStore(
            cfg.spill_partitions, budget_bytes=cfg.spill_budget_bytes,
            spill_path=cfg.spill_path, stats=self.ctx.runtime_stats,
            async_staging=cfg.spill_async_staging, pool=self.ctx.memory,
            **kw)
        self._spill_stores.append(store)
        return store

    def fragment_jit(self, node: P.PlanNode, purpose: str,
                     build: Callable, extra=()):
        """Fragment-level step sharing (serving/fragments.py): the state
        `build()` makes for a scan / filter / project step is cached
        PROCESS-GLOBALLY on the subtree's structural key, so two
        different plans (or runners) sharing a scan -> filter subchain
        share one artifact.  With a stage cache installed (the
        scheduler's tasks) the state is shared per stage under the
        node's id; with the fragment_share knob off each compiler builds
        its own.  `extra` must carry every host constant the state bakes
        in beyond (subtree, config, device) -- chunk capacity, output
        names, the first batch's column signature -- since a false share
        would run the wrong program, while a missed share only costs one
        rebuild."""
        cfg = self.ctx.config
        stage = self.ctx.shared_steps
        if stage is not None:
            key = (node.id, purpose) + tuple(extra)
            ent = stage.get(key)
            if ent is None:
                ent = stage.setdefault(key, build())
            return ent
        if not cfg.fragment_share:
            return build()
        from ..serving.fragments import FRAGMENT_JIT_CACHE
        from ..sql.canonical import config_fingerprint
        key = (purpose, P.structural_key(node), tuple(extra),
               config_fingerprint(cfg), str(self.ctx.device))
        return FRAGMENT_JIT_CACHE.get_or_build(key, build)

    # -- public -----------------------------------------------------------
    def compile(self, root: P.PlanNode) -> BatchSource:
        return self._compile(root)

    def run_to_pages(self, root: P.PlanNode) -> Iterator[Page]:
        src = self.compile(root)
        try:
            for batch in src.batches():
                page = batch_to_page(batch, src.names, src.types)
                if page.position_count:
                    yield page
        finally:
            while self._spill_stores:
                self._spill_stores.pop().close()

    def run_to_batches(self, root: P.PlanNode) -> Iterator[Batch]:
        """Device-resident drain of the fragment (the "ici" fabric's
        producer side: output rows stay on the device for the exchange)."""
        src = self.compile(root)
        try:
            yield from src.batches()
        finally:
            while self._spill_stores:
                self._spill_stores.pop().close()

    # -- dispatch ---------------------------------------------------------
    def _compile(self, node: P.PlanNode) -> BatchSource:
        cached = self._sources.get(node.id)
        if cached is not None:
            return cached
        m = getattr(self, "_compile_" + type(node).__name__, None)
        if m is None:
            raise NotImplementedError(
                f"no compiler for {type(node).__name__} in the port yet")
        src = m(node)
        if self.ctx.stats is not None:
            src = self._instrument(node, src)
        self._sources[node.id] = src
        return src

    def _instrument(self, node: P.PlanNode, src: BatchSource) -> BatchSource:
        """EXPLAIN ANALYZE wrapper (the reference's _instrument): per plan
        node the cumulative host wall of producing its batches (children
        included, as the reference's operator getOutput accounting), the
        live rows, the batches and an estimate of the output bytes (9 per
        column and row).  The walls are host walls around asynchronous
        launches; a batch's live count is added on the device and read
        once, when the stream ends or settle_node_stats runs, so no batch
        waits on the device."""
        stats = self.ctx.stats
        row_bytes = 9 * max(1, len(node.output_variables))

        def gen():
            ent = stats.setdefault(
                node.id, {"rows": 0, "wall_s": 0.0, "batches": 0})
            ent.setdefault("bytes", 0)
            ent.setdefault("operatorType", type(node).__name__)
            ent["_row_bytes"] = row_bytes
            it = src.batches()
            while True:
                t0 = time.perf_counter()  # lint: allow-wall-clock
                try:
                    b = next(it)
                except StopIteration:
                    t1 = time.perf_counter()  # lint: allow-wall-clock
                    ent["wall_s"] += t1 - t0
                    _settle_entry(ent)
                    return
                t1 = time.perf_counter()  # lint: allow-wall-clock
                ent["wall_s"] += t1 - t0
                live = b.mask.sum()
                pending = ent.get("_pending")
                ent["_pending"] = live if pending is None else pending + live
                ent["batches"] += 1
                yield b
        out = BatchSource(gen, src.names, src.types)
        # the fused-chain assembler reads the scan's metadata off the
        # compiled source (assemble_chain): the wrapper passes it on
        meta = getattr(src, "fused_scan", None)
        if meta is not None:
            out.fused_scan = meta
        return out

    def _materialize(self, src: BatchSource) -> Optional[Batch]:
        batches = list(src.batches())
        if not batches:
            return None
        return _compact_concat(batches)

    def _materialize_node(self, node: P.PlanNode,
                          cache: bool = False) -> Optional[Batch]:
        """A subtree's whole output as one batch: the fused chain when the
        subtree is a fusible chain, else the streaming source drained.
        cache=True keeps the result on the device across re-executions
        and structurally identical replays of the subtree (join build
        sides; generated data is immutable)."""
        from .fused import (_fmat_reserve, _renamed_batch, _result_key,
                            fused_materialize)
        b = fused_materialize(self, node, cache=cache)
        if b is not None:
            return b
        skey = None
        names = [v.name for v in node.output_variables]
        if cache and not self.ctx.memory.limited:
            skey = _result_key(self, "mat_result", node)
            ent = self._cache.get(skey)
            if ent is not None:
                cached, cnames = ent
                return (None if cached is None
                        else _renamed_batch(cached, cnames, names))
        out = self._materialize(self._compile(node))
        if skey is not None:
            nb = 0 if out is None else batch_bytes(out)
            if _fmat_reserve(self, nb):
                self._cache[skey] = (out, names)
        return out

    def _splits_fingerprint(self, node: P.PlanNode) -> str:
        """Task-assigned splits under a subtree, in walk order -- part of
        the structural result-cache key: two structurally equal subtrees
        only share data when their scans cover the same splits."""
        parts = []
        for n in P.walk_plan(node):
            if isinstance(n, P.TableScanNode):
                sp = self.ctx.splits.get(n.id)
                parts.append("-" if sp is None else json.dumps(
                    [s.to_dict() for s in sp], sort_keys=True))
        return "|".join(parts)

    def _params_for(self, expr) -> Optional[torch.Tensor]:
        return self.ctx.params if expr_has_params(expr) else None

    def _exchange_rows(self, node: P.PlanNode) -> Optional[int]:
        """The rows an exchange feeds into `node`'s stream, as the
        scheduler counted them (TaskContext.remote_rows): the stream
        followed through filters, projections and the probe sides of joins
        to a remote source.  None where it ends elsewhere."""
        while True:
            if isinstance(node, (P.FilterNode, P.ProjectNode,
                                 P.AssignUniqueIdNode, P.SemiJoinNode)):
                node = node.source
            elif isinstance(node, P.JoinNode):
                node = node.left
            elif isinstance(node, P.RemoteSourceNode):
                return self.ctx.remote_rows.get(node.id)
            else:
                return None

    def _meter_declined(self, reason: str) -> None:
        """One kernelDeclined{reason}: the process roll-up and the query's
        RuntimeStats."""
        from .kernels.scan_kernel import KERNEL_METRICS
        KERNEL_METRICS.record_declined(reason)
        rs = self.ctx.runtime_stats
        if rs is not None:
            rs.add(f"kernelDeclined{reason}", 1)

    # -- leaves -----------------------------------------------------------
    def _compile_TableScanNode(self, node: P.TableScanNode) -> BatchSource:
        """Scan over device-generated columns: device-resident encoded
        columns (storage/) outside a memory budget, and on the fly per
        chunk (connectors/device_gen.py) for a column the store does not
        hold and for every column under a budget; plus host-generated
        columns (catalog.generate_column per chunk, copied to the device:
        nation, region) and late-materialized open-domain strings (kind
        "lazy": the column holds global row ids, strings are generated at
        the output boundary or hoisted to whole-column host caches).  Only
        an all-device-generated scan is a fused-chain leaf
        (`fused_scan`)."""
        names = [v.name for v in node.outputs]
        types = [v.type for v in node.outputs]
        columns = [node.assignments[v].name for v in node.outputs]
        th = node.table
        sf = dict(th.extra).get("scaleFactor", 0.01)
        splits = self.ctx.splits.get(node.id)
        if splits is None:
            splits = catalog.make_splits(th.table_name, sf,
                                         self.ctx.config.splits_per_scan,
                                         th.connector_id)
        cfg = self.ctx.config
        cap = cfg.batch_rows
        table, cid = th.table_name, th.connector_id
        device = self.ctx.device
        from ..connectors import device_gen
        # device-generated (resident store), late-materialized (row ids)
        # and host-generated columns
        dev: List[Tuple[str, str, str]] = []   # (out name, column, kind)
        host: List[Tuple[str, str]] = []
        for name, colname in zip(names, columns):
            if (table, colname) in catalog.OPEN_DOMAIN:
                dev.append((name, colname, "lazy"))
            elif device_gen.supported(cid, table, colname):
                dev.append((name, colname, "gen"))
            else:
                host.append((name, colname))
        i32 = {colname: (colname.endswith("date")
                         or catalog.column_type(table, colname, cid).storage
                         == "INT_ARRAY")
               for _n, colname, kind in dev if kind == "gen"}
        # the resident store, outside a memory budget (its residency is
        # outside the query's accounting); a column it does not take (over
        # the per-column cap, a full store, storage_enabled=False, every
        # column under a budget) is generated on the fly per chunk
        from ..storage import get_store, prune_chunks
        cached_cols: Dict[str, object] = {}
        zone_maps: Dict[str, object] = {}
        if not self.ctx.memory.limited and i32 and cfg.storage_enabled:
            store = get_store(cfg.storage_budget_bytes,
                              cfg.storage_max_column_bytes, device)
            n_rows = catalog.table_row_count(table, sf, cid)
            for colname, as_i32 in i32.items():
                ent = store.get_or_build(
                    cid, table, colname, sf, n_rows, cap, as_i32,
                    zone_rows=cfg.storage_zone_rows,
                    encodings=cfg.storage_encodings)
                if ent is not None:
                    cached_cols[colname] = ent.column
                    zone_maps[colname] = ent.zones
        pushdown = [dict(e) for e in getattr(node, "pushdown", ())]
        # runtime dynamic filters this scan may consume, read lazily at
        # drain time from ctx.dynamic_filters
        runtime_filters = ([dict(e) for e in
                            getattr(node, "runtime_filters", ())]
                           if cfg.dynamic_filtering else [])

        def dyn_summaries():
            if not runtime_filters:
                return None
            return self.ctx.dynamic_filters or None

        dicts = {name: device_gen.dictionary(cid, table, colname)
                 for name, colname, kind in dev if kind == "gen"}

        def split_chunks(split):
            out = []
            p = split.start
            while p < split.end:
                out.append((p, min(cap, split.end - p)))
                p += cap
            if zone_maps and pushdown:
                out, _skipped = prune_chunks(out, zone_maps, pushdown,
                                             self.ctx.params_fingerprint,
                                             dyn_summaries(),
                                             keep_one=False)
            return out

        def make_factory(cap2):
            """The scan leaf at chunk capacity cap2 (a fused chain with a
            fanout-k join shrinks its chunks): rows [pos, pos+cap2) of
            each column, decoded from the resident store or generated on
            the fly (device_gen.column), zeroed past the `valid` live rows;
            a lazy column's live rows hold their row ids (padding row 0,
            a valid id)."""
            idx0 = torch.arange(cap2, device=device)

            def make(pos, valid, cached):
                live = idx0 < valid
                outs = {}
                for name, colname, kind in dev:
                    if kind == "lazy":
                        outs[name] = torch.where(live, idx0 + pos,
                                                 torch.zeros_like(idx0))
                        continue
                    arr = cached.get(colname)
                    if arr is not None:
                        v = arr.slice_decode(pos, cap2)
                    else:
                        v = device_gen.column(cid, table, colname, sf,
                                              idx0 + pos)
                        if v.dtype == torch.int64 and i32[colname]:
                            v = v.to(torch.int32)
                    outs[name] = torch.where(
                        live, v, torch.zeros((), dtype=v.dtype,
                                             device=device))
                return outs, live
            return make

        def host_column(split, colname, pos, n) -> Column:
            """One chunk of a host-generated column as a device column."""
            raw = catalog.generate_column(table, colname, split.sf, pos, n,
                                          split.connector)
            nulls = None
            if isinstance(raw, catalog.HostColumn):
                if raw.nulls is not None:
                    nbuf = np.zeros(cap, dtype=bool)
                    nbuf[:n] = raw.nulls
                    nulls = torch.from_numpy(nbuf).to(device)
                raw = raw.values
            if isinstance(raw, tuple):
                codes, values = raw
                buf = np.zeros(cap, dtype=np.int32)
                buf[:n] = codes
                return Column(torch.from_numpy(buf).to(device), nulls,
                              tuple(values))
            if isinstance(raw, list):
                raise NotImplementedError(
                    f"host-generated string column {table}.{colname} "
                    f"outside the late-materialized set")
            if raw.dtype == np.bool_:
                dtype = np.bool_
            elif raw.dtype in (np.float64, np.float32):
                # a REAL column is float32 on the device (exact: the
                # connector's values are float32 values)
                dtype = (np.float32 if isinstance(
                    catalog.column_type(table, colname, split.connector),
                    RealType) else np.float64)
            elif (raw.dtype == np.int32 or colname.endswith("date")
                  or catalog.column_type(table, colname,
                                         split.connector).storage
                  == "INT_ARRAY"):
                dtype = np.int32
            else:
                dtype = np.int64
            buf = np.zeros(cap, dtype=dtype)
            buf[:n] = raw
            return Column(torch.from_numpy(buf).to(device), nulls)

        # the scan leaf is a function of the table's identity (its scale
        # factor included: both inside the node's structural key), the
        # chunk capacity, the config and the device; the resident columns
        # ride as an argument, so plans sharing this scan share one make
        # closure.  The output names are baked in but canonicalized away
        # by the structural key, so they join the key
        make = self.fragment_jit(node, "scan_make",
                                 lambda: make_factory(cap),
                                 extra=(cap, tuple(names)))

        def split_gen(split):
            for pos, n in split_chunks(split):
                cols = {}
                if dev:
                    outs, mask = make(pos, n, cached_cols)
                    for name, colname, kind in dev:
                        cols[name] = Column(
                            outs[name], None, dicts.get(name),
                            (split.connector, table, colname, split.sf)
                            if kind == "lazy" else None)
                else:
                    mask = torch.arange(cap, device=device) < n
                for name, colname in host:
                    cols[name] = host_column(split, colname, pos, n)
                yield Batch(cols, mask)

        def gen():
            tc = cfg.task_concurrency
            if tc > 1 and len(splits) > 1:
                # driver-per-split leaf parallelism (LocalExchange +
                # task_concurrency): split drains overlap host work; the
                # batches arrive in no fixed order
                from .local_exchange import on_caller_stream, parallel_drain
                dstats = None
                if self.ctx.stats is not None:
                    dstats = self.ctx.stats.setdefault(
                        node.id, {"rows": 0, "wall_s": 0.0, "batches": 0})
                yield from parallel_drain(on_caller_stream(
                    [lambda s=s: split_gen(s) for s in splits], device),
                    tc, dstats)
                return
            for split in splits:
                yield from split_gen(split)

        # the row-level runtime filter: plain integer device columns only
        # (dictionary codes and lazy row ids are not in key units); a
        # dropped row is one the annotated join would drop anyway
        rf_cols = []
        for e in runtime_filters:
            for v, ch in node.assignments.items():
                if ch.name == e["column"]:
                    rf_cols.append((e["id"], v.name))

        def apply_runtime_filters(batches):
            from .adaptive import ADAPTIVE_METRICS
            rows_in = rows_out = None
            for b in batches:
                dyn = dyn_summaries()
                for fid, vname in (rf_cols if dyn else ()):
                    summ = dyn.get(fid)
                    if not (isinstance(summ, dict)
                            and isinstance(summ.get("min"), int)
                            and isinstance(summ.get("max"), int)):
                        continue
                    c = b.columns.get(vname)
                    if c is None or c.dictionary is not None \
                            or c.lazy is not None \
                            or c.values.is_floating_point() \
                            or c.values.dtype == torch.bool:
                        continue
                    keep = b.mask & (c.values >= summ["min"]) \
                        & (c.values <= summ["max"])
                    inn, kept = b.mask.sum(), keep.sum()
                    if rows_in is None:
                        ADAPTIVE_METRICS.incr("filters_applied")
                    rows_in = inn if rows_in is None else rows_in + inn
                    rows_out = kept if rows_out is None else rows_out + kept
                    b = b.with_mask(keep)
                yield b
            if rows_in is not None:
                inn, out = int(rows_in), int(rows_out)
                ADAPTIVE_METRICS.incr("filter_rows_in", inn)
                ADAPTIVE_METRICS.incr("filter_rows_pruned", inn - out)
                rs = self.ctx.runtime_stats
                if rs is not None:
                    rs.add("dynamicFilterRowsIn", inn)
                    rs.add("dynamicFilterRowsPruned", inn - out)

        def gen_filtered():
            yield from apply_runtime_filters(gen())

        src = BatchSource(gen_filtered if rf_cols else gen, names, types)
        if not host and all(kind == "gen" for _n, _c, kind in dev):
            src.fused_scan = {
                "make_factory": make_factory,
                "splits": splits, "cap": cap, "cached_cols": cached_cols,
                "dicts": dicts, "table": table, "cid": cid, "sf": sf,
                "colmap": dict(zip(names, columns)),
                "types": dict(zip(names, types)),
                "zone_maps": zone_maps, "pushdown": pushdown,
                "dyn_summaries": dyn_summaries,
            }
        return src

    def _compile_RemoteSourceNode(self, node: P.RemoteSourceNode
                                  ) -> BatchSource:
        """Exchange input.  The "ici" fabric's device batches
        (TaskContext.remote_batches: the chunks the device exchange left
        on this task's mesh position) are consumed as they are; otherwise
        the host pages the scheduler wired for this task
        (TaskContext.remote_pages) move to the task's device with every
        string column on one union dictionary (batch.pages_to_batches)."""
        names = [v.name for v in node.outputs]
        types = [v.type for v in node.outputs]
        cfg = self.ctx.config
        ctx = self.ctx

        def gen():
            dev = ctx.remote_batches.get(node.id)
            if dev is not None:
                yield from dev()
                return
            yield from pages_to_batches(
                ctx.remote_pages[node.id](), names, types, cfg.batch_rows,
                ctx.device, pack_rows=max(cfg.batch_rows,
                                          EXCHANGE_PACK_ROWS))
        return BatchSource(gen, names, types)

    def _compile_ValuesNode(self, node: P.ValuesNode) -> BatchSource:
        """Literal rows (LIMIT 0 plans as an empty one) as one batch."""
        from ..common.block import block_from_values
        from .batch import block_to_column
        from .lowering import constant_device_value
        names = [v.name for v in node.outputs]
        types = [v.type for v in node.outputs]
        device = self.ctx.device

        def gen():
            n = len(node.rows)
            cap = max(n, 1)
            cols = {}
            for i, (name, typ) in enumerate(zip(names, types)):
                vals = [constant_device_value(r[i].value, typ)
                        for r in node.rows]
                if isinstance(typ, (VarcharType, CharType)):
                    vals = [None if v is None else str(v) for v in vals]
                cols[name] = block_to_column(
                    typ, block_from_values(typ, vals), cap, device)
            mask = torch.arange(cap, device=device) < n
            yield Batch(cols, mask)
        return BatchSource(gen, names, types)

    # -- streaming transforms --------------------------------------------
    def _compile_FilterNode(self, node: P.FilterNode) -> BatchSource:
        """A streaming filter.  LIKE / substr / starts_with / ends_with /
        concat over a late-materialized column are hoisted: the first
        batch shows which columns are lazy, and those calls become host
        columns read from whole-column caches (_StringHoister)."""
        src = self._compile(node.source)
        hoister = _StringHoister([node.predicate])
        # bound parameters ride the step's calls, so one step serves every
        # binding of the template
        purpose = ("filter_p" if expr_has_params(node.predicate)
                   else "filter")
        cache: dict = {}

        def gen():
            for b in src.batches():
                if "step" not in cache:
                    cache["step"] = self.fragment_jit(
                        node, purpose, lambda b=b: _ExprStep(hoister, b),
                        extra=(_fragment_batch_sig(b),))
                yield cache["step"].filter(b, self.ctx.params)
        return BatchSource(gen, src.names, src.types)

    def _compile_ProjectNode(self, node: P.ProjectNode) -> BatchSource:
        src = self._compile(node.source)
        names = [v.name for v in node.assignments]
        types = [v.type for v in node.assignments]
        items = list(node.assignments.items())
        hoister = _StringHoister([e for _v, e in items])
        purpose = ("project_p" if any(expr_has_params(e) for _v, e in items)
                   else "project")
        cache: dict = {}

        def gen():
            for b in src.batches():
                if "step" not in cache:
                    cache["step"] = self.fragment_jit(
                        node, purpose, lambda b=b: _ExprStep(hoister, b),
                        extra=(_fragment_batch_sig(b), tuple(names)))
                yield cache["step"].project(b, self.ctx.params, names)
        return BatchSource(gen, names, types)

    def _compile_OutputNode(self, node: P.OutputNode) -> BatchSource:
        src = self._compile(node.source)
        # OutputNode renames columns positionally
        inner = [v.name for v in node.source.output_variables]
        outer = [v.name for v in node.outputs]
        types = [v.type for v in node.outputs]
        if inner == outer:
            return BatchSource(src.batches, outer, types)

        def gen():
            for b in src.batches():
                yield Batch({o: b.columns[i] for i, o in zip(inner, outer)},
                            b.mask)
        return BatchSource(gen, outer, types)

    def _compile_UnnestNode(self, node: P.UnnestNode) -> BatchSource:
        """One output row per array element, the source columns
        replicated (the reference's _compile_UnnestNode, UnnestOperator):
        output capacity cap * W, slot i*W + j = (source row i, element j);
        several arrays zip by position, the shorter ones NULL-padded, and
        WITH ORDINALITY numbers the elements from 1."""
        src = self._compile(node.source)
        names = [v.name for v in node.output_variables]
        types = [v.type for v in node.output_variables]
        rep_names = [v.name for v in node.replicate_variables]
        pairs = [(av.name, elems[0].name)
                 for av, elems in node.unnest_variables]
        ord_name = (None if node.ordinality_variable is None
                    else node.ordinality_variable.name)

        def step(batch: Batch) -> Batch:
            cap, dev = batch.capacity, batch.device
            arrs = {an: batch.columns[an] for an, _en in pairs}
            W = max([a.values.shape[1] for a in arrs.values()] + [1])
            # rows per source row: the longest of the zipped arrays
            rowlen = None
            for a in arrs.values():
                ln = torch.where(a.null_mask(), 0, a.lengths)
                rowlen = ln if rowlen is None else torch.maximum(rowlen, ln)
            j = torch.arange(W, dtype=torch.int32, device=dev)
            cols = {}
            for rn in rep_names:
                c = batch.columns[rn]
                cols[rn] = Column(
                    c.values.repeat_interleave(W, dim=0),
                    None if c.nulls is None
                    else c.nulls.repeat_interleave(W),
                    c.dictionary, c.lazy,
                    None if c.lengths is None
                    else c.lengths.repeat_interleave(W))
            for an, en in pairs:
                a = arrs[an]
                aw = a.values.shape[1]
                padded = (a.values if aw == W else torch.nn.functional.pad(
                    a.values, (0, W - aw)))
                ln = torch.where(a.null_mask(), 0, a.lengths)
                valid = (j[None, :] < ln[:, None]).reshape(cap * W)
                cols[en] = Column(padded.reshape(cap * W), ~valid)
            if ord_name is not None:
                cols[ord_name] = Column(
                    (j.to(torch.int64) + 1).repeat(cap))
            mask = (batch.mask[:, None]
                    & (j[None, :] < rowlen[:, None])).reshape(cap * W)
            return Batch(cols, mask)

        def gen():
            for b in src.batches():
                yield step(b).select(names)
        return BatchSource(gen, names, types)

    def _compile_SortNode(self, node: P.SortNode) -> BatchSource:
        vs = node.source.output_variables
        names, types = [v.name for v in vs], [v.type for v in vs]
        keys = [(v.name, order) for v, order in node.ordering_scheme.orderings]

        def gen():
            merged = self._materialize_node(node.source)
            if merged is None:
                return
            merged = _encode_unordered_lazy_keys(merged,
                                                 [k for k, _o in keys])
            yield ops.sort_batch(merged, keys)
        return BatchSource(gen, names, types)

    # -- limit / topn / window --------------------------------------------
    def _compile_LimitNode(self, node: P.LimitNode) -> BatchSource:
        src = self._compile(node.source)
        n = node.count

        def gen():
            consumed = torch.zeros((), dtype=torch.int64,
                                   device=self.ctx.device)
            for b in src.batches():
                out, consumed = ops.limit(b, n, consumed)
                yield out
                if int(consumed) >= n:
                    break
        return BatchSource(gen, src.names, src.types)

    def _compile_TopNNode(self, node: P.TopNNode) -> BatchSource:
        """A streaming buffer merge: each batch is concatenated to the
        running top n and cut back to n rows."""
        src = self._compile(node.source)
        keys = [(v.name, order) for v, order in node.ordering_scheme.orderings]
        n = node.count

        def gen():
            key_names = [k for k, _o in keys]
            buf = None
            for b in src.batches():
                b = _encode_unordered_lazy_keys(b, key_names)
                merged = b if buf is None else _concat([buf, b])
                buf = ops.topn(merged, keys, n)
            if buf is not None:
                yield buf
        return BatchSource(gen, src.names, src.types)

    def _compile_WindowNode(self, node: P.WindowNode) -> BatchSource:
        """Materialize the source, then every window function of the node
        in one launch of the window kernel (kernels/window.py) over the
        sorted run.  After a metered WindowFunctionShape decline, and
        under scan_kernel="xla" (metered Disabled) or a failed memory
        reservation (WindowInputSize), ops.window_batch computes them, as
        in the reference."""
        src = self._compile(node.source)
        part_names = tuple(v.name for v in node.partition_by)
        orderings = tuple((v.name, o) for v, o in
                          node.ordering_scheme.orderings) \
            if node.ordering_scheme else ()
        specs = []
        for v, wf in node.window_functions.items():
            fname = canonical_name(wf.call.display_name)
            args = wf.call.arguments
            arg = None
            extra = ()
            if fname == "count" and not args:
                fname = "count_star"
            elif fname == "ntile":
                extra = (int(args[0].value),)
            elif args:
                arg = args[0].name
                extra = tuple(constant_device_value(a.value, a.type)
                              for a in args[1:])
            frame = None
            if wf.frame:
                f = wf.frame
                frame = (f["type"], f["startKind"], f["startOffset"],
                         f["endKind"], f["endOffset"])
            is_float = isinstance(v.type, (DoubleType, RealType))
            specs.append(ops.WindowSpec(fname, v.name, arg, is_float,
                                        frame, extra))
        specs = tuple(specs)
        out_names = src.names + [v.name for v in node.window_functions]
        out_types = src.types + [v.type for v in node.window_functions]

        def gen():
            merged = self._materialize_node(node.source)
            if merged is None:
                return
            # late-materialized keys: the window both sorts by and
            # compares every key, so a lazy column's row ids must sort
            # like its values AND be distinct per value (min / max
            # arguments need the sort property only); otherwise encode to
            # whole-column dictionaries on the host
            minmax_args = {s.arg for s in specs
                           if s.name in ("min", "max") and s.arg}
            key_cols = set(part_names) | {k for k, _ in orderings}
            encode = []
            for k in sorted(key_cols | minmax_args):
                col = merged.columns[k]
                if col.lazy is None:
                    continue
                _, tbl, coln, _sf = col.lazy
                if not ((tbl, coln) in catalog.ROWID_ORDERED and (
                        k not in key_cols
                        or (tbl, coln) in catalog.ROWID_DISTINCT)):
                    encode.append(k)
            if encode:
                merged = _encode_lazy_keys(merged, encode)
            kres = None
            if self.ctx.config.scan_kernel == "xla":
                self._meter_declined("Disabled")
            else:
                from .kernels import window as wk
                kres = wk.try_window_kernel(
                    merged, part_names, orderings, specs,
                    declined=self._meter_declined,
                    runtime_stats=self.ctx.runtime_stats,
                    pool=self.ctx.memory)
            yield kres if kres is not None else ops.window_batch(
                merged, part_names, orderings, specs)
        return BatchSource(gen, out_names, out_types)

    def _compile_MarkDistinctNode(self, node: P.MarkDistinctNode
                                  ) -> BatchSource:
        """Marker = first row of its distinct-key group: row_number()
        partitioned by the distinct keys (the window path), marker =
        (rn == 1)."""
        from ..common.types import BIGINT, BOOLEAN
        from ..spi.expr import CallExpression, call, constant
        rn = VariableReferenceExpression(f"{node.marker.name}__rn", BIGINT)
        win = P.WindowNode(
            node.id + ".rn", node.source, list(node.distinct_variables),
            None, {rn: P.WindowFunction(
                CallExpression("row_number", BIGINT, []), None)})
        assigns = {v: v for v in node.source.output_variables}
        assigns[node.marker] = call("eq", BOOLEAN, rn, constant(1, BIGINT))
        return self._compile(P.ProjectNode(node.id + ".mark", win, assigns))

    # -- union / joins / unique ids ---------------------------------------
    def _compile_UnionNode(self, node: P.UnionNode) -> BatchSource:
        """UNION ALL: the source streams concatenated.  Numeric columns
        stream straight through; varchar columns are re-encoded onto one
        merged dictionary (lazy columns generated), which makes the union
        a materialization point only when strings are involved."""
        srcs = [self._compile(s) for s in node.inputs]
        out_names = [v.name for v in node.outputs]
        out_types = [v.type for v in node.outputs]
        string_cols = [n for n, t in zip(out_names, out_types)
                       if isinstance(t, (VarcharType, CharType))]

        # the planner projects every source onto the output variables
        def gen():
            if not string_cols:
                for s in srcs:
                    yield from s.batches()
                return
            all_b = [b for s in srcs for b in s.batches()]
            if not all_b:
                return
            for n in string_cols:
                parts = _recode_strings([b.columns[n] for b in all_b])
                all_b = [b.with_columns({n: c})
                         for b, c in zip(all_b, parts)]
            yield _concat(all_b)
        return BatchSource(gen, out_names, out_types)

    def _compile_JoinNode(self, node: P.JoinNode) -> BatchSource:
        """INNER / LEFT / FULL equi-join.  Over a fusible probe chain the
        torch fused chain streams it (fused_stream).  Otherwise the build
        side is materialized (cached structurally; under a memory budget
        staged under a revocable reservation, and past the budget spilled
        into the grace hash join, `grace`) and the probe batches
        stream through probe_join_direct (a dense unique integer key: no
        host sync) or probe_join, whose output overflow halves the probe
        batch and retries (one host sync per window of in-flight
        batches).  An INNER join with dynamic filters first narrows the
        probe stream to the build keys' [min, max]."""
        if node.join_type not in (P.INNER, P.LEFT, P.FULL):
            raise NotImplementedError(f"join type {node.join_type}")
        if not node.criteria:
            raise NotImplementedError("a join without equi-join criteria "
                                      "(cross join)")
        full = node.join_type == P.FULL
        probe_src_node, build_src_node = node.left, node.right
        probe_keys = [l.name for l, _r in node.criteria]
        build_keys = [r.name for _l, r in node.criteria]
        out_names = [v.name for v in node.outputs]
        out_types = [v.type for v in node.outputs]
        from .fused import (_drop_null_keys, _join_build_cols, fused_stream,
                            try_direct_table)
        from .lowering import torch_dtype
        build_names = [v.name for v in build_src_node.output_variables]
        # join outputs plus ON-filter-referenced build columns
        build_out = _join_build_cols(node, out_names, set(build_names))
        probe_names = [n for n in out_names if n not in build_out]
        build_types = {v.name: v.type
                       for v in build_src_node.output_variables}
        probe_types = {v.name: v.type for v in node.left.output_variables}
        cfg = self.ctx.config
        low = self.lowering
        jtype = "LEFT" if full else node.join_type
        filter_fn = (None if node.filter is None
                     else (lambda pairs: low.eval(node.filter, pairs)))
        device = self.ctx.device

        def null_column(t, n):
            if isinstance(t, ArrayType):
                return Column(torch.zeros((n, 1), dtype=torch.int64,
                                          device=device),
                              torch.ones(n, dtype=torch.bool, device=device),
                              None, None,
                              torch.zeros(n, dtype=torch.int32,
                                          device=device))
            if isinstance(t, (VarcharType, CharType)):
                return Column(torch.zeros(n, dtype=torch.int32,
                                          device=device),
                              torch.ones(n, dtype=torch.bool, device=device),
                              ("",))
            return Column(torch.zeros(n, dtype=torch_dtype(t),
                                      device=device),
                          torch.ones(n, dtype=torch.bool, device=device))

        def null_extended(batch):
            """LEFT join rows against an empty build side."""
            cols = dict(batch.columns)
            for name in build_out:
                cols[name] = null_column(build_types[name], batch.capacity)
            return Batch(cols, batch.mask).select(out_names)

        def unmatched_build(build_batch, matched):
            """FULL: build rows no probe row matched, probe side NULL."""
            cap = build_batch.capacity
            cols = {name: build_batch.columns[name] for name in build_out}
            for name in probe_names:
                cols[name] = null_column(probe_types[name], cap)
            return Batch(cols, build_batch.mask & ~matched) \
                .select(out_names)

        def shrink(joined, live: int):
            """Compact a joined batch whose output padding dominates."""
            bucket = _bucket_for(live)
            if bucket is None or bucket * 4 > joined.capacity:
                return joined
            return ops.compact(joined, bucket)

        def make_dynamic_filter(build_batch):
            """INNER only (a LEFT join's probe is preserved): the probe
            rows outside the integer build keys' [min, max]."""
            if node.join_type != P.INNER or not node.dynamic_filters \
                    or not cfg.dynamic_filtering:
                return None
            numeric = []
            for ln, rn in zip(probe_keys, build_keys):
                c = build_batch.columns[rn]
                if c.dictionary is None and c.lazy is None \
                        and not c.values.is_floating_point() \
                        and c.values.dtype != torch.bool:
                    numeric.append((ln, c))
            if not numeric:
                return None
            bounds = []
            for ln, c in numeric:
                m = build_batch.mask if c.nulls is None \
                    else build_batch.mask & ~c.nulls
                v = c.values.to(torch.int64)
                bounds.append((ln, torch.where(m, v, torch.full_like(
                    v, ops.INT64_MAX)).min(), torch.where(
                        m, v, torch.full_like(v, ops.INT64_MIN)).max()))

            def apply(batch):
                keep = batch.mask
                for ln, lo, hi in bounds:
                    v = batch.columns[ln].values
                    keep = keep & (v >= lo) & (v <= hi)
                return batch.with_mask(keep)
            return apply

        def apply_dynamic_filter(dyn, batches):
            """The probe stream through the dynamic filter; under EXPLAIN
            ANALYZE the rows it drops are counted on the device into the
            join's entry (read when the stats settle)."""
            stats = self.ctx.stats
            ent = None
            if stats is not None:
                ent = stats.setdefault(
                    node.id, {"rows": 0, "wall_s": 0.0, "batches": 0})
                ent.setdefault("dynamicFilterRowsDropped", 0)
            for b in batches:
                nb = dyn(b)
                if ent is not None:
                    d = b.mask.sum() - nb.mask.sum()
                    prev = ent.get("_dropped")
                    ent["_dropped"] = d if prev is None else prev + d
                yield nb

        def probe_stream_direct(dt, batches, build_batch):
            matched = (torch.zeros(build_batch.capacity, dtype=torch.bool,
                                   device=device) if full else None)
            for b in batches:
                out, matched = ops.probe_join_direct(
                    b, dt, probe_keys[0], build_out, join_type=jtype,
                    filter_fn=filter_fn, matched=matched)
                yield out.select(out_names)
            if full:
                yield unmatched_build(build_batch, matched)

        def probe_stream(table, batches, build_batch):
            """Windowed drain: up to K probe batches in flight, then one
            host sync for all their (overflow, live) scalars; a piece
            whose pairs overflow join_out_capacity is halved and
            retried."""
            matched = (torch.zeros(build_batch.capacity, dtype=torch.bool,
                                   device=device) if full else None)
            work: deque = deque()
            inflight: deque = deque()
            K = max(2, min(8, (1 << 22) // max(1, cfg.join_out_capacity)))
            batches = iter(batches)
            exhausted = False
            while True:
                while len(inflight) < K:
                    if work:
                        piece = work.popleft()
                    elif exhausted:
                        break
                    else:
                        piece = next(batches, None)
                        if piece is None:
                            exhausted = True
                            break
                    joined, overflow, total, matched = ops.probe_join(
                        piece, table, probe_keys, build_out,
                        cfg.join_out_capacity, join_type=jtype,
                        filter_fn=filter_fn, matched=matched)
                    inflight.append((piece, joined, overflow, total))
                if not inflight:
                    break
                metas = torch.stack(  # lint: allow-host-sync
                    [torch.stack([ov.to(torch.int64), tot])
                     for _p, _j, ov, tot in inflight]).tolist()
                window = list(inflight)
                inflight.clear()
                for (piece, joined, _o, _t), (ovv, livev) in zip(window,
                                                                 metas):
                    if ovv:
                        # recursive halving: a high-fanout probe splits
                        # until each piece fits
                        if piece.capacity <= 1:
                            raise RuntimeError(
                                "join output overflow on a single probe "
                                "row: raise join_out_capacity")
                        work.extendleft(reversed(_split_batch(piece)))
                        continue
                    yield shrink(joined, livev).select(out_names)
            if full:
                yield unmatched_build(build_batch, matched)

        def grace(spill):
            """The grace hash join: the probe partitioned like the build,
            then joined bucket by bucket.  A bucket whose build side still
            does not fit the budget is re-partitioned with a new salt, up
            to depth 4; only a bucket that stops shrinking (one key's
            rows) fails."""
            pool = self.ctx.memory
            probe_store = self._new_spill_store()
            for b in self._compile(probe_src_node).batches():
                probe_store.add(b, probe_keys)
            work = [(spill, probe_store, p, 0)
                    for p in range(cfg.spill_partitions)]
            while work:
                bstore, pstore, p, depth = work.pop()
                p_rows = pstore.bucket_rows(p)
                b_rows = bstore.bucket_rows(p)
                # FULL still visits probe-empty buckets: their build rows
                # come out null-extended
                if p_rows == 0 and (not full or b_rows == 0):
                    continue
                if b_rows == 0:
                    if node.join_type == P.INNER:
                        continue
                    yield from map(null_extended, pstore.bucket_batches(
                        p, cfg.batch_rows))
                    continue
                # the bucket goes back on the device at a power-of-two
                # capacity: account for it
                bcap = 1 << max(0, b_rows - 1).bit_length()
                nbytes = bstore.bucket_bytes(p) * bcap // max(1, b_rows)
                if not pool.try_reserve(nbytes):
                    if depth >= 4:
                        raise MemoryExceededError(
                            f"join build bucket of {nbytes} bytes "
                            f"exceeds memory budget {pool.budget} after "
                            f"{depth} re-partitions (key skew)")
                    salt2 = bstore.salt * 33 + 0x9E37
                    sub_b = self._new_spill_store(salt2)
                    for bb in bstore.bucket_batches(p, cfg.batch_rows):
                        sub_b.add(bb, build_keys)
                    sub_p = self._new_spill_store(salt2)
                    for pb in pstore.bucket_batches(p, cfg.batch_rows):
                        sub_p.add(pb, probe_keys)
                    work.extend((sub_b, sub_p, q, depth + 1)
                                for q in range(cfg.spill_partitions))
                    continue
                try:
                    bucket = next(bstore.bucket_batches(p, bcap))
                    table = ops.build_table(
                        _drop_null_keys(bucket, tuple(build_keys)),
                        list(build_keys))
                    yield from probe_stream(
                        table, pstore.bucket_batches(p, cfg.batch_rows),
                        bucket)
                finally:
                    pool.free(nbytes)

        def gen():
            fs = fused_stream(self, node)
            if fs is not None:
                for b in fs:
                    yield b.select(out_names)
                return
            if not self.ctx.memory.limited:
                yield from probe_built(
                    self._materialize_node(build_src_node, cache=True))
                return
            # under a budget the build is staged under a revocable
            # reservation; a miss, or the arbitrator, turns it into the
            # grace join's partitioned store
            buf = _RevocableBuildBuffer(self, build_keys, cfg.spill_enabled)
            try:
                for b in self._compile(build_src_node).batches():
                    buf.add(b)
                collected, spill = buf.finish()
                if spill is None:
                    yield from probe_built(_compact_concat(collected)
                                           if collected else None)
                else:
                    yield from grace(spill)
            finally:
                buf.close()

        def probe_built(build_batch):
            """The probe stream against a materialized build side."""
            probe = self._compile(probe_src_node)
            if build_batch is None:
                if node.join_type == P.INNER:
                    return
                for batch in probe.batches():
                    yield null_extended(batch)
                return
            dyn = make_dynamic_filter(build_batch)
            batches = probe.batches()
            if dyn is not None:
                batches = apply_dynamic_filter(dyn, batches)
            dropped = _drop_null_keys(build_batch, tuple(build_keys))
            dt = (try_direct_table(dropped, build_keys[0], allow_dup=False)
                  if len(build_keys) == 1 else None)
            if dt is not None:
                yield from probe_stream_direct(dt, batches, build_batch)
                return
            table = ops.build_table(dropped, list(build_keys))
            yield from probe_stream(table, batches, build_batch)
        return BatchSource(gen, out_names, out_types)

    def _compile_SemiJoinNode(self, node: P.SemiJoinNode) -> BatchSource:
        """The three-valued IN marker over a materialized build (direct
        table or hash-sorted), or the fused chain's semi step."""
        src = self._compile(node.source)
        names = src.names + [node.semi_join_output.name]
        types = src.types + [BOOLEAN]
        key = node.source_join_variable.name
        fkey = node.filtering_source_join_variable.name
        mark = node.semi_join_output.name
        from .fused import (_build_has_null_key, _drop_null_keys,
                            fused_stream, try_direct_table)

        def gen():
            fs = fused_stream(self, node)
            if fs is not None:
                yield from (b.select(names) for b in fs)
                return
            build_batch = self._materialize_node(node.filtering_source,
                                                 cache=True)
            if build_batch is None:
                for b in src.batches():
                    yield b.with_columns({mark: Column(torch.zeros(
                        b.capacity, dtype=torch.bool, device=b.device))})
                return
            has_null = _build_has_null_key(build_batch, (fkey,))
            dropped = _drop_null_keys(build_batch, (fkey,))
            dt = try_direct_table(dropped, fkey, allow_dup=True)
            if dt is not None:
                for b in src.batches():
                    yield b.with_columns({mark: ops.semi_join_mark_direct(
                        b, dt, key, build_has_null=has_null)})
                return
            table = ops.build_table(dropped, [fkey])
            for b in src.batches():
                yield b.with_columns({mark: ops.semi_join_mark(
                    b, table, [key], build_has_null=has_null)})
        return BatchSource(gen, names, types)

    def _compile_AssignUniqueIdNode(self, node: P.AssignUniqueIdNode
                                    ) -> BatchSource:
        """Row ids unique within the query: the task index in the high
        bits, a running per-task offset below.  Deterministic for a fixed
        split set, so a deep-copied subtree replays identical ids."""
        src = self._compile(node.source)
        names = src.names + [node.id_variable.name]
        types = src.types + [node.id_variable.type]
        base = self.ctx.task_index << 40
        id_name = node.id_variable.name

        def gen():
            offset = 0
            for b in src.batches():
                ids = torch.arange(b.capacity, dtype=torch.int64,
                                   device=b.device) + (base + offset)
                offset += b.capacity
                yield b.with_columns({id_name: Column(ids)})
        return BatchSource(gen, names, types)

    def _compile_EnforceSingleRowNode(self, node) -> BatchSource:
        """A scalar subquery's source: more than one row raises."""
        src = self._compile(node.source)

        def gen():
            seen = 0
            for b in src.batches():
                seen += int(b.mask.sum())
                if seen > 1:
                    raise RuntimeError(
                        "scalar subquery produced more than one row")
                yield b
        return BatchSource(gen, src.names, src.types)

    def _compile_ExchangeNode(self, node: P.ExchangeNode) -> BatchSource:
        """A local exchange: one source passes through; several are
        concatenated stream after stream, each renamed positionally onto
        the scheme's output layout (node.inputs)."""
        if len(node.exchange_sources) == 1 and not node.inputs:
            return self._compile(node.exchange_sources[0])
        sources = [self._compile(s) for s in node.exchange_sources]
        out_vars = node.partitioning_scheme.output_layout
        names = [v.name for v in out_vars]
        types = [v.type for v in out_vars]

        def gen():
            for i, s in enumerate(sources):
                in_names = ([v.name for v in node.inputs[i]]
                            if node.inputs else s.names)
                for b in s.batches():
                    cols = {o: b.columns[n] for o, n in zip(names, in_names)}
                    yield Batch(cols, b.mask)
        return BatchSource(gen, names, types)

    # -- aggregation ------------------------------------------------------
    def _compile_GroupIdNode(self, node: P.GroupIdNode) -> BatchSource:
        """Grouping-set expansion (reference GroupIdOperator.java): each
        source batch is pulled once and yielded once per grouping set,
        its grouping columns outside the set all NULL and group_id the
        set's index.  A NULLed column keeps its values, dictionary and
        lazy tag, so every batch of the stream shares one encoding.  The
        downstream aggregation groups by (grouping columns..., group_id),
        exactly the reference pairing, and does not depend on the order
        of the sets."""
        src = self._compile(node.source)
        names = [v.name for v in node.output_variables]
        types = [v.type for v in node.output_variables]
        gid = node.group_id_variable
        sets = [{v.name for v in gset} for gset in node.grouping_sets]

        def gen():
            for b in src.batches():
                for i, in_set in enumerate(sets):
                    cols = {}
                    for out_v, in_v in node.grouping_columns.items():
                        c = b.columns[in_v.name]
                        cols[out_v.name] = c if out_v.name in in_set \
                            else Column(c.values, torch.ones_like(
                                b.mask), c.dictionary, c.lazy, c.lengths)
                    for v in node.aggregation_arguments:
                        cols[v.name] = b.columns[v.name]
                    cols[gid.name] = Column(torch.full(
                        (b.capacity,), i, dtype=torch_dtype(gid.type),
                        device=b.device))
                    yield Batch(cols, b.mask)
        return BatchSource(gen, names, types)

    def _compile_DistinctLimitNode(self, node: P.DistinctLimitNode
                                   ) -> BatchSource:
        """SELECT DISTINCT ... LIMIT n: a SINGLE aggregation with no
        aggregates over the distinct variables, then the Limit (the
        reference's lowering)."""
        agg = P.AggregationNode(node.id + ".agg", node.source, {},
                                node.distinct_variables, P.SINGLE)
        return self._compile(P.LimitNode(node.id + ".limit", agg,
                                         node.count))

    def _compile_TableWriterNode(self, node: P.TableWriterNode) -> BatchSource:
        """Stream source batches into a connector write handle (reference
        TableWriterOperator.java:78): pages are staged, not visible until
        TableFinish commits.  Emits one row (rows-written, staging token)
        on the task's device."""
        src = self._compile(node.source)
        names = [v.name for v in node.outputs]
        types = [v.type for v in node.outputs]
        device = self.ctx.device

        def gen():
            conn = catalog.module(node.connector_id)
            # the handle takes the SQL-visible column names, not the
            # planner's internal variable names
            handle = conn.begin_write(node.table_name,
                                      list(node.column_names),
                                      list(src.types))
            rows = 0
            wrote = False
            try:
                for b in src.batches():
                    page = batch_to_page(b, src.names, src.types)
                    if page.position_count:
                        rows += handle.write_page(page)
                        wrote = True
                if not wrote:
                    # an empty result still defines the table's schema:
                    # stage one zero-row part so scans of the empty table
                    # see real columns (the reference's CTAS semantics)
                    from ..common.block import block_from_values
                    handle.write_page(Page(
                        [block_from_values(t, []) for t in src.types], 0))
            except BaseException:
                handle.abort()
                raise
            rv, fv = node.outputs[:2]
            zero = torch.zeros(1, dtype=torch.int32, device=device)
            cols = {rv.name: Column(torch.tensor([rows], dtype=torch.int64,
                                                 device=device)),
                    fv.name: Column(zero, None, (handle.staging_id,))}
            if len(node.outputs) > 2:
                # coordinator-shaped fragments carry a third
                # tableCommitContext output (TableCommitContext.java); a
                # task-wide single-commit context is constant
                cols[node.outputs[2].name] = Column(
                    zero, None,
                    ('{"lifespan":"TaskWide","pageSinkCommitStrategy":'
                     '"NO_COMMIT"}',))
            yield Batch(cols, torch.ones(1, dtype=torch.bool, device=device))
        return BatchSource(gen, names, types)

    def _compile_TableFinishNode(self, node: P.TableFinishNode
                                 ) -> BatchSource:
        """Commit every staged fragment from the writer(s) and emit the
        total row count (reference TableFinishOperator.java)."""
        src = self._compile(node.source)
        names = [v.name for v in node.outputs]
        types = [v.type for v in node.outputs]
        device = self.ctx.device

        def gen():
            from ..common.block import block_to_values
            conn = catalog.module(node.connector_id)
            total = 0
            for b in src.batches():
                page = batch_to_page(b, src.names, src.types)
                rows = block_to_values(src.types[0], page.blocks[0])
                frags = block_to_values(src.types[1], page.blocks[1])
                for r, f in zip(rows, frags):
                    total += int(r)
                    conn.staged(f).commit()
            cols = {node.outputs[0].name: Column(torch.tensor(
                [total], dtype=torch.int64, device=device))}
            yield Batch(cols, torch.ones(1, dtype=torch.bool, device=device))
        return BatchSource(gen, names, types)

    def _compile_AggregationNode(self, node: P.AggregationNode) -> BatchSource:
        """Aggregation in the reference's mode order.  Over a fused scan
        chain: the CUDA scan kernels first (direct slots for G <= 64, span
        or hashed slots beyond; the chain's fanout-1 probes inside the
        launch); after a kernel's metered decline, or under
        scan_kernel="xla", the torch fused chain: direct one-hot, static
        span, runtime span (anchor key + dependency check), sort
        aggregation, hashed table with collision retries.  Otherwise the
        streaming aggregation over the compiled source (direct or hashed
        table, restarted on the hashed path when a NULL key shows up; the
        sort aggregation for approx_percentile).  Past a memory budget
        the input spills into a key-partitioned host store and aggregates
        bucket by bucket (run_hash_spilled, run_sorted_spilled); a global
        percentile streams mergeable summaries
        (run_global_percentile_stream)."""
        node = _rewrite_agg_masks(node)
        src_node = node.source
        key_vars = node.grouping_keys
        key_names = tuple(v.name for v in key_vars)
        out_names = [v.name for v in key_vars] + \
            [v.name for v in node.aggregations]
        out_types = ([v.type for v in key_vars]
                     + [v.type for v in node.aggregations])
        low = self.lowering
        specs = []
        input_exprs: Dict[str, Optional[object]] = {}
        input_exprs2: Dict[str, object] = {}
        for v, agg in node.aggregations.items():
            fname = canonical_name(agg.call.display_name)
            args = agg.call.arguments
            if fname == "count" and not args:
                fname = "count_star"
            is_float = isinstance(v.type, (DoubleType, RealType))
            param = None
            if fname == "approx_percentile" and len(args) > 1:
                param = float(args[1].value)
                is_float = isinstance(args[0].type, (DoubleType, RealType))
            if fname in ops.HLL_AGGS:
                # an optional max standard error -> the register count
                param = (ops.hll_buckets_for_error(float(args[1].value))
                         if len(args) > 1 else ops.HLL_DEFAULT_BUCKETS)
            if fname in ops.CORR_AGGS and len(args) > 1:
                input_exprs2[v.name] = args[1]
            specs.append(ops.AggSpec(fname, v.name, is_float, param))
            input_exprs[v.name] = args[0] if args else None
        specs = tuple(specs)
        basic_specs = all(s.name in ops.BASIC_AGGS for s in specs)
        sort_only_specs = any(s.name in ops.SORT_ONLY_AGGS for s in specs)
        cfg = self.ctx.config
        device = self.ctx.device
        fused_cache: dict = {}
        if key_names and cfg.history_agg_groups:
            # history-based sizing (adaptive.history-sizing): the OBSERVED
            # group count of a prior run of this plan template replaces the
            # estimate and, being a measurement, may size BELOW agg_slots
            # too (floored so a tiny count cannot degenerate the probing)
            est_groups = int(cfg.history_agg_groups)
            hist_based = 1 << max(0, (2 * est_groups - 1).bit_length())
            initial_slots = max(256, min(hist_based, 1 << 20))
        else:
            est_groups = _group_estimate(node) if key_names else None
            initial_slots = _initial_slots(est_groups, key_names,
                                           cfg.agg_slots)
        # with no group estimate (a FINAL step, a join in a hash stage) the
        # rows the exchange input holds decide: more than half the first
        # table's slots aggregate by sort (a table started at agg_slots
        # runs out of retries past about 10^5 groups, and one sized from
        # those rows, bounding groups far from above, ran the distributed
        # TPC-H phase slower on the card); fewer hash into agg_slots as in
        # the reference.  HLL needs the hashed table
        exchange_rows = (self._exchange_rows(node.source)
                         if key_names and not est_groups else None)
        exchange_sort = (exchange_rows is not None
                         and 2 * exchange_rows > cfg.agg_slots
                         and not any(s.name in ops.HLL_AGGS for s in specs))
        est_state_bytes = _agg_state_bytes(initial_slots, key_names, specs)

        def _agg_exprs(b):
            return {out: (None if e is None else
                          low.eval(e, b.with_params(self._params_for(e))))
                    for out, e in input_exprs.items()}

        def _agg_exprs2(b):
            return {out: low.eval(e, b.with_params(self._params_for(e)))
                    for out, e in input_exprs2.items()}

        def stride_codes(b, strides):
            codes = None
            for k, stride in zip(key_names, strides):
                c = b.columns[k].values.to(torch.int64) * stride
                codes = c if codes is None else codes + c
            if codes is None:       # global aggregation: one group
                codes = torch.zeros(b.capacity, dtype=torch.int64,
                                    device=b.device)
            return codes

        def hash_update(num_slots, salt):
            def update(st, b):
                return ops.agg_update(
                    st, b, [b.columns[k] for k in key_names], _agg_exprs(b),
                    specs, num_slots, salt, key_names, _agg_exprs2(b))
            return update

        def hash_finalize(state, key_dicts, key_lazy):
            if not key_names and not bool(state["__occupied"].any()):
                # a global aggregation over empty input: one row
                state["__occupied"][0] = True
            return ops.agg_finalize(state, specs, key_names, key_dicts,
                                    key_lazy)

        hll_outs = [s.output for s in specs if s.name in ops.HLL_AGGS]

        def lazy_keys(batch):
            """(key_lazy, encode_keys) of the first batch: a lazy key
            whose row id is its value's identity (ROWID_DISTINCT) keeps
            its tag; any other lazy key, and a lazy HLL input (the sketch
            hashes the device values), is whole-column encoded."""
            key_lazy, encode = {}, []
            for k in key_names:
                col = batch.columns[k]
                if col.lazy is not None:
                    _, tbl, coln, _sf = col.lazy
                    if (tbl, coln) in catalog.ROWID_DISTINCT:
                        key_lazy[k] = col.lazy
                    else:
                        encode.append(k)
            for out in hll_outs:
                expr = input_exprs[out]
                if isinstance(expr, VariableReferenceExpression):
                    col = batch.columns.get(expr.name)
                    if col is not None and col.lazy is not None \
                            and (col.lazy[1], col.lazy[2]) \
                            not in catalog.ROWID_DISTINCT \
                            and expr.name not in encode:
                        encode.append(expr.name)
            return key_lazy, encode

        # -- the streaming aggregation -----------------------------------
        def run_once(num_slots: int, salt: int, batches_fn=None,
                     allow_direct: bool = True):
            batches = (self._compile(src_node).batches()
                       if batches_fn is None else batches_fn())
            state, update, direct = None, None, None
            key_dicts: Dict[str, Tuple[str, ...]] = {}
            key_lazy: Dict[str, Tuple] = {}
            encode_keys: List[str] = []
            for batch in batches:
                if state is None:
                    key_lazy, encode_keys = lazy_keys(batch)
                    if encode_keys:
                        batch = _encode_lazy_keys(batch, encode_keys)
                    key_cols = [batch.columns[k] for k in key_names]
                    key_dicts = {k: c.dictionary
                                 for k, c in zip(key_names, key_cols)
                                 if c.dictionary is not None}
                    # closed small domains: the combined code is the slot
                    info = (_direct_mode_info(key_names, key_cols)
                            if basic_specs and allow_direct else None)
                    if info is not None:
                        doms, G, strides, kdts, _kd = info
                        direct = (doms, kdts)
                        state = ops.agg_direct_init(G, specs, device)

                        def update(st, b, _s=strides, _g=G):
                            return ops.agg_direct_update(
                                st, b, stride_codes(b, _s), _agg_exprs(b),
                                specs, _g)
                    else:
                        state = ops.agg_init(
                            num_slots, specs, key_names,
                            [c.values.dtype for c in key_cols], device)
                        update = hash_update(num_slots, salt)
                elif encode_keys:
                    batch = _encode_lazy_keys(batch, encode_keys)
                if direct is not None and any(
                        batch.columns[k].nulls is not None
                        for k in key_names):
                    # direct mode was chosen on a NULL-free first batch,
                    # but this one carries a NULL key: the code grid has
                    # no NULL slot, so the whole aggregation restarts on
                    # the hashed path (the source closed first)
                    batches.close()
                    return run_once(num_slots, salt, batches_fn,
                                    allow_direct=False)
                state = update(state, batch)
            if state is None:
                state = ops.agg_init(num_slots, specs, key_names,
                                     [torch.int64] * len(key_names), device)
            return state, key_dicts, key_lazy, direct

        def run_retrying():
            num_slots, salt = initial_slots, 0
            for _attempt in range(cfg.max_agg_retries):
                state, key_dicts, key_lazy, direct = run_once(num_slots,
                                                              salt)
                # one host sync per pass
                if direct is not None or not bool(state["__collision"]):
                    return state, key_dicts, key_lazy, direct
                num_slots *= 2
                salt += 1
            raise RuntimeError("aggregation collision retries exhausted")

        def sortagg(b: Batch) -> Batch:
            return ops.sort_group_aggregate(b, key_names, _agg_exprs(b),
                                            specs, _agg_exprs2(b))

        def drain_sort_input():
            """Drain the source once under per-batch reservation: (merged,
            None) when the whole input fit the budget, else (None, the
            stream of the collected batches and the rest of the source,
            still reserved)."""
            pool = self.ctx.memory
            collected, reserved = [], 0
            it = self._compile(src_node).batches()
            over_batch = None
            for b in it:
                nb = batch_bytes(b)
                if pool.try_reserve(nb):
                    collected.append(b)
                    reserved += nb
                else:
                    over_batch = b
                    break
            if over_batch is None:
                merged = _compact_concat(collected) if collected else None
                pool.free(reserved)
                if merged is None:
                    # a zero-batch source: an all-masked batch, so a
                    # global aggregate still yields its row
                    from .fused import _empty_build_batch
                    merged = _empty_build_batch(src_node, device)
                return merged, None

            def stream():
                try:
                    yield from collected
                    yield over_batch
                    yield from it
                finally:
                    pool.free(reserved)
            return None, stream()

        # -- spill: the partitioned store, bucket by bucket ---------------
        def fill_spill_store(batches=None):
            """The source streamed into a key-partitioned host store.  A
            lazy key whose row ids are not its value's identity is
            whole-column encoded first (row ids would split a value's
            group across buckets)."""
            store = self._new_spill_store()
            encode_keys = None
            if batches is None:
                batches = self._compile(src_node).batches()
            for batch in batches:
                if encode_keys is None:
                    encode_keys = []
                    for k in key_names:
                        col = batch.columns[k]
                        if col.lazy is not None and (
                                col.lazy[1], col.lazy[2]) \
                                not in catalog.ROWID_DISTINCT:
                            encode_keys.append(k)
                if encode_keys:
                    batch = _encode_lazy_keys(batch, encode_keys)
                store.add(batch, list(key_names))
            return store

        def subdivide_bucket(bstore, p, depth, work):
            """A K-way sub-partition of an over-budget bucket with a new
            salt (the grace join's re-partition), for the sorted and the
            hashed spill paths; the sort path stops at depth 2 (only one
            key's rows remain to split), the hashed one at 4."""
            salt2 = bstore.salt * 33 + 0x9E37
            sub = self._new_spill_store(salt2)
            for bb in bstore.bucket_batches(p, cfg.batch_rows):
                sub.add(bb, list(key_names))
            work.extend((sub, q, depth + 1)
                        for q in range(cfg.spill_partitions))

        def run_sorted_spilled(batches):
            """A grouped percentile-class aggregation over the budget: the
            rows hash-partitioned by group key (disjoint key sets), then
            the exact sort aggregation bucket by bucket."""
            store = fill_spill_store(batches)
            pool = self.ctx.memory
            work = [(store, p, 0) for p in range(cfg.spill_partitions)]
            while work:
                bstore, p, depth = work.pop()
                rows_p = bstore.bucket_rows(p)
                if rows_p == 0:
                    continue
                bcap = 1 << max(0, rows_p - 1).bit_length()
                nb = bstore.bucket_bytes(p) * bcap // max(1, rows_p)
                if not pool.try_reserve(nb):
                    if depth >= 2:
                        # one key owns more rows than the budget: per-key
                        # streaming summaries instead of the sort
                        yield self._skewed_percentile_bucket(
                            bstore, p, key_names, specs, input_exprs,
                            input_exprs2)
                        continue
                    subdivide_bucket(bstore, p, depth, work)
                    continue
                try:
                    bucket = next(bstore.bucket_batches(p, bcap))
                    yield _maybe_compact(sortagg(bucket))
                finally:
                    pool.free(nb)

        def run_global_percentile_stream(batches):
            """A global approx_percentile over an input past the budget:
            one streaming pass keeping an m-point mergeable summary per
            batch (rank error <= 1/(2m)), plus the running state of the
            sibling aggregates; host memory O(batches x m)."""
            m = ops.PERCENTILE_SKETCH_POINTS
            pct_specs = tuple(s for s in specs
                              if s.name == "approx_percentile")
            other_specs = tuple(s for s in specs
                                if s.name != "approx_percentile")
            state = (ops.agg_init(256, other_specs, (), (), device)
                     if other_specs else None)
            summaries = {s.output: [] for s in pct_specs}
            for b in batches:
                for s in pct_specs:
                    col = low.eval(input_exprs[s.output], b.with_params(
                        self._params_for(input_exprs[s.output])))
                    summaries[s.output].append(ops.percentile_batch_summary(
                        col.values, b.mask & ~col.null_mask(), m))
                if state is not None:
                    ins = _agg_exprs(b)
                    ins2 = _agg_exprs2(b)
                    state = ops.agg_update(
                        state, b, [], {s.output: ins[s.output]
                                       for s in other_specs},
                        other_specs, 256, 0, (),
                        {s.output: ins2[s.output] for s in other_specs
                         if s.name in ops.CORR_AGGS})
            if state is not None:
                if not bool(state["__occupied"].any()):
                    state["__occupied"][0] = True
                row = ops.agg_finalize(state, other_specs, (), {}, {})
            else:
                row = Batch({}, torch.ones(1, dtype=torch.bool,
                                           device=device))
            cols = dict(row.columns)
            for s in pct_specs:
                chunks = summaries[s.output]
                if chunks:
                    pts = torch.stack([c[0] for c in chunks])
                    cnts = torch.stack([c[1] for c in chunks])
                else:
                    pts = torch.full((1, m), float("nan"),
                                     dtype=torch.float64, device=device)
                    cnts = torch.zeros(1, dtype=torch.int64, device=device)
                p = float(s.param if s.param is not None else 0.5)
                val, is_null = ops.percentile_union_value(pts, cnts, p)
                if not s.is_float:
                    val = val.to(torch.int64)
                # every column of a Batch shares the finalize row's
                # capacity
                cap = row.capacity
                cols[s.output] = Column(val.reshape(1).expand(cap).clone(),
                                        is_null.reshape(1).expand(cap)
                                        .clone())
            order = [v.name for v in node.aggregations]
            return Batch({o: cols[o] for o in order}, row.mask)

        def run_hash_spilled():
            """The hashed aggregation past the budget: the input
            hash-partitioned by group keys into host buckets (disjoint key
            sets, so each bucket's finalize is exact), each bucket
            aggregated in a table sized to its rows, halved until the
            reservation fits, sub-partitioned when even the 256-slot
            table does not (up to depth 4)."""
            pool = self.ctx.memory
            store = fill_spill_store()
            per_slot = max(1, est_state_bytes // max(1, initial_slots))
            work = [(store, pp, 0) for pp in range(cfg.spill_partitions)]
            while work:
                bstore, p, depth = work.pop()
                rows_p = bstore.bucket_rows(p)
                if rows_p == 0:
                    continue
                bucket_slots = max(
                    256, min(initial_slots // cfg.spill_partitions,
                             1 << (2 * rows_p - 1).bit_length()))
                held = 0
                while True:
                    nbytes = bucket_slots * per_slot
                    if pool.try_reserve(nbytes):
                        held = nbytes
                        break
                    if bucket_slots <= 256:
                        break
                    bucket_slots = max(256, bucket_slots // 2)
                if not held:
                    if depth < 4:
                        subdivide_bucket(bstore, p, depth, work)
                        continue
                    # even the smallest table exceeds the budget after 4
                    # re-partitions
                    pool.reserve(nbytes)
                    held = nbytes
                # a collision doubles the table, re-reserved each time;
                # a table that cannot grow sub-partitions instead
                num_slots, salt = bucket_slots, 0
                done = False
                try:
                    for _attempt in range(cfg.max_agg_retries):
                        state, key_dicts, key_lazy, direct = run_once(
                            num_slots, salt,
                            lambda b=bstore, p=p: b.bucket_batches(
                                p, cfg.batch_rows))
                        if direct is not None:
                            yield ops.agg_direct_finalize(
                                state, specs, key_names, direct[0],
                                direct[1], key_dicts)
                            done = True
                            break
                        if not bool(state["__collision"]):
                            yield ops.agg_finalize(state, specs, key_names,
                                                   key_dicts, key_lazy)
                            done = True
                            break
                        grown = 2 * num_slots * per_slot
                        pool.free(held)
                        held = 0
                        if not pool.try_reserve(grown):
                            if depth < 4:
                                subdivide_bucket(bstore, p, depth, work)
                                done = True
                                break
                            raise MemoryExceededError(
                                f"aggregation table of {grown} bytes "
                                f"exceeds memory budget {pool.budget} "
                                f"after {depth} re-partitions")
                        held = grown
                        num_slots *= 2
                        salt += 1
                    if not done:
                        raise RuntimeError(
                            "aggregation collision retries exhausted")
                finally:
                    pool.free(held)

        # -- the fused chain -----------------------------------------------
        def _meter(name: str, n: int) -> None:
            rs = self.ctx.runtime_stats
            if rs is not None:
                rs.add(name, n)

        def _fusion_declined(reason: str) -> None:
            _meter(f"fusionDeclined{reason}", 1)

        def get_fused():
            if "chain" in fused_cache:
                return fused_cache["chain"]
            fused_cache["chain"] = None
            if not cfg.fuse_pipelines:
                _fusion_declined("Disabled")
                return None
            if self.ctx.stats is not None and cfg.analyze_unfused:
                _fusion_declined("AnalyzeUnfused")
                return None
            # masks were lowered to IF inputs by _rewrite_agg_masks
            if any(a.distinct for a in node.aggregations.values()):
                _fusion_declined("DistinctAgg")
                return None
            if any(s.name in ops.HLL_AGGS for s in specs):
                # HLL registers live in the hashed table only
                _fusion_declined("HllAgg")
                return None
            from .fused import assemble_chain
            chain = assemble_chain(self, src_node)
            if chain is None:
                _fusion_declined("PlanShape")
            elif chain.empty:
                _fusion_declined("NoChunks")
                chain = None
            fused_cache["chain"] = chain
            return chain

        def run_fused(chain) -> Optional[Batch]:
            """A fused chain to its finalized output Batch, or None for the
            streaming aggregation.  Under EXPLAIN ANALYZE it times the
            whole fused pass (host wall, its result's row count read once)
            and folds the chain's row counters -- the torch chain's, or
            the scan kernel's -- into ctx.stats."""
            from .fused import ChainCounts, record_chain_stats
            acc = ChainCounts() if self.ctx.stats is not None else None
            t0 = time.perf_counter()  # lint: allow-wall-clock
            out = _run_fused_inner(chain, acc)
            if out is None or acc is None:
                return out
            # every pass carries the counters (the reference's runtime
            # span and sort aggregation count in one more pass)
            if acc.counts is not None:
                # the pass's end: one read
                acc.counts = acc.counts.cpu()  # lint: allow-host-sync
            wall = time.perf_counter() - t0  # lint: allow-wall-clock
            record_chain_stats(self.ctx.stats, chain, acc, wall_s=wall)
            if self.ctx.runtime_stats is not None:
                self.ctx.runtime_stats.add("fusedProgramWallNanos",
                                           wall * 1e9, "NANO")
            return out

        def _run_fused_inner(chain, acc) -> Optional[Batch]:
            """run_fused's pass; `acc` (a fused.ChainCounts, None unless
            analyzing) takes the pass's row counters."""
            pool = self.ctx.memory
            if pool.limited:
                _fusion_declined("BudgetedPool")
                return None
            # the chain's build tables, built once per compiled aggregation
            # (generated data is immutable); a build subtree with bound
            # parameters rebuilds when the values change
            pfp = (self.ctx.params_fingerprint
                   if (chain.has_params or chain.build_params) else None)
            prep_res = fused_cache.get("prep")
            if prep_res is not None and chain.build_params \
                    and fused_cache.get("prep_fp") != pfp:
                prep_res = None
            if prep_res is None:
                prep_res = chain.prep()
                if prep_res is None:
                    _fusion_declined("PrepFanout")
                    return None
                fused_cache["prep"], fused_cache["prep_fp"] = prep_res, pfp
                fused_cache.pop("probe", None)
            aux, expands, _ = prep_res

            def chunks_and_steps():
                """The pruned scan chunks and the chain's steps over them,
                found once per bound-parameter fingerprint when the torch
                chain first needs them (a kernel launch reads its own
                grid)."""
                key = ("steps", expands, self.ctx.params_fingerprint,
                       CHAIN_STEP_ROWS)
                res = fused_cache.get(key)
                if res is None:
                    chunks = chain.chunks_for(expands, meter=True)
                    res = fused_cache[key] = (chunks, _chain_steps(
                        chunks, chain.leaf_cap(expands),
                        max(1, CHAIN_STEP_ROWS // chain.cap)))
                return res
            # the chain's output columns (dtype, NULL-ability, dictionary):
            # the chain applied once to an empty chunk of PROBE_ROWS rows
            probe = fused_cache.get("probe")
            if probe is None:
                try:
                    probe = chain.make(0, 0, aux, expands, PROBE_ROWS)
                except NotImplementedError:
                    _fusion_declined("ProbeUnsupported")
                    return None
                fused_cache["probe"] = probe
            key_cols = [probe.columns.get(k) for k in key_names]
            if any(c is None for c in key_cols):
                _fusion_declined("KeyMissing")
                return None
            key_lazy: Dict[str, Tuple] = {}
            for k, c in zip(key_names, key_cols):
                if c.lazy is not None:
                    if (c.lazy[1], c.lazy[2]) not in catalog.ROWID_DISTINCT:
                        # needs a host dictionary encoding
                        _fusion_declined("KeyEncoding")
                        return None
                    key_lazy[k] = c.lazy
            key_dicts = {k: c.dictionary for k, c in zip(key_names, key_cols)
                         if c.dictionary is not None}
            key_dtypes = tuple(c.values.dtype for c in key_cols)

            def loop(update, state, mode):
                """The chunks through the chain into `state`: a Python loop
                of device ops with no host sync.  Metered per pass as
                torchChain{mode}, torchChainChunks and torchChainSteps."""
                chunks, steps = chunks_and_steps()
                _meter(f"torchChain{mode}", 1)
                _meter("torchChainChunks", len(chunks))
                _meter("torchChainSteps", len(steps))
                if acc is not None:
                    acc.restart(len(chunks))
                for pos, cnt, cap in steps:
                    state = update(state, chain.make(pos, cnt, aux, expands,
                                                     cap, acc))
                return state

            declined = self._meter_declined
            info = (_direct_mode_info(key_names, key_cols)
                    if basic_specs else None)
            if info is not None:
                doms, G, strides, kdts, kdicts = info
                if cfg.scan_kernel == "xla":
                    declined("Disabled")
                else:
                    from .kernels.scan_kernel import try_direct_scan_kernel
                    kres = try_direct_scan_kernel(
                        chain, self.ctx.params, specs=specs,
                        key_names=key_names, strides=strides, G=G,
                        agg_inputs=input_exprs, cache=fused_cache,
                        declined=declined,
                        runtime_stats=self.ctx.runtime_stats,
                        aux=aux, expands=expands, pool=pool,
                        dma=cfg.scan_kernel_dma)
                    if kres is not None:
                        state, counts, n_chunks = kres
                        if acc is not None:
                            acc.counts, acc.n_chunks = counts, n_chunks
                        return ops.agg_direct_finalize(
                            state, specs, key_names, doms, kdts, kdicts,
                            force_row=not key_names)
                state = loop(lambda st, b: ops.agg_direct_update(
                    st, b, stride_codes(b, strides), _agg_exprs(b), specs,
                    G), ops.agg_direct_init(G, specs, device), "Direct")
                return ops.agg_direct_finalize(
                    state, specs, key_names, doms, kdts, kdicts,
                    force_row=not key_names)
            elif cfg.scan_kernel == "xla":
                declined("Disabled")
            elif not basic_specs:
                # moment / corr / percentile accumulators have no kernel
                # shape: the torch chain keeps them
                declined("AggFunctionShape")
            else:
                # grouped (G > 64): span slots when the closed key domains
                # fit the span gate, hashed open addressing otherwise
                from .kernels.grouped import try_grouped_scan_kernel
                from .kernels.scan_kernel import KERNEL_SPAN_MAX_GROUPS
                kres = try_grouped_scan_kernel(
                    chain, self.ctx.params, specs=specs,
                    key_names=key_names, key_dtypes=key_dtypes,
                    key_dicts=key_dicts, key_lazy=key_lazy,
                    span_info=_direct_mode_info(
                        key_names, key_cols, gmax=KERNEL_SPAN_MAX_GROUPS),
                    est_slots=initial_slots, agg_inputs=input_exprs,
                    cache=fused_cache, declined=declined,
                    pool=pool, state_bytes=_agg_state_bytes,
                    runtime_stats=self.ctx.runtime_stats, aux=aux,
                    expands=expands, dma=cfg.scan_kernel_dma)
                if kres is not None:
                    out, counts, n_chunks = kres
                    if acc is not None:
                        acc.counts, acc.n_chunks = counts, n_chunks
                    return _maybe_compact(out)

            # static span: closed dictionary / bool domains beyond the
            # grid; the combined stride code indexes the accumulators
            info = (_direct_mode_info(key_names, key_cols,
                                      gmax=ops.SPAN_AGG_MAX_GROUPS)
                    if basic_specs else None)
            if info is not None:
                doms, G, strides, kdts, kdicts = info
                nbytes = G * 24 * max(1, len(specs))
                if not pool.try_reserve(nbytes):
                    return None
                try:
                    state = loop(lambda st, b: ops.agg_span_update(
                        st, b, stride_codes(b, strides), _agg_exprs(b),
                        specs, G), ops.agg_span_init(G, specs, device),
                        "StaticSpan")
                    slot = torch.arange(G, dtype=torch.int64, device=device)
                    key_arrays = {}
                    stride = G
                    for k, dom, dt in zip(key_names, doms, kdts):
                        stride //= dom
                        key_arrays[k] = ((slot // stride) % dom).to(dt)
                    return _maybe_compact(ops.agg_span_finalize(
                        state, specs, key_names, key_arrays, kdicts,
                        key_lazy=key_lazy))
                finally:
                    pool.free(nbytes)

            # runtime span: one integer anchor key indexes the accumulators
            # (base + slot); the other grouping keys must be constant within
            # an anchor group, verified per pass (depkey_*); on a violation
            # the next candidate, else the sort aggregation
            candidates = [i for i, c in enumerate(key_cols)
                          if c.nulls is None and c.values.dtype in
                          (torch.int64, torch.int32, torch.int16)]
            if basic_specs and candidates:
                cand_names = tuple(key_names[i] for i in candidates)
                span_key = ("span_range", cand_names, expands, pfp)
                ranges = fused_cache.get(span_key)
                if ranges is None:
                    _meter("torchChainSpanProbe", 1)
                    los = torch.full((len(cand_names),), ops.INT64_MAX,
                                     dtype=torch.int64, device=device)
                    his = torch.full_like(los, ops.INT64_MIN)
                    for pos, cnt, cap in chunks_and_steps()[1]:
                        b = chain.make(pos, cnt, aux, expands, cap)
                        vs = torch.stack([b.columns[k].values.to(torch.int64)
                                          for k in cand_names])
                        m = b.mask[None, :]
                        los = torch.minimum(los, torch.where(
                            m, vs, torch.full_like(vs, ops.INT64_MAX))
                            .amin(dim=1))
                        his = torch.maximum(his, torch.where(
                            m, vs, torch.full_like(vs, ops.INT64_MIN))
                            .amax(dim=1))
                    # one host sync for the range probe
                    lo = los.tolist()  # lint: allow-host-sync
                    hi = his.tolist()  # lint: allow-host-sync
                    ranges = list(zip(lo, hi))
                    fused_cache[span_key] = ranges
                # anchor order: "key"-named columns widest span first (the
                # finest key is the likeliest group identity), then lazy
                # row ids (row identity), then the rest; the first anchor
                # that verifies is cached
                viable = []
                for ci, (lo, hi) in zip(candidates, ranges):
                    span = hi - lo + 1
                    if hi >= lo and span <= ops.SPAN_AGG_MAX_GROUPS:
                        rank = (0 if "key" in key_names[ci].lower()
                                else 1 if key_cols[ci].lazy is not None
                                else 2)
                        viable.append((rank, -span, ci, span, lo))
                viable.sort()
                anchor_key = ("span_anchor", cand_names, expands, pfp)
                cached_anchor = fused_cache.get(anchor_key)
                if cached_anchor is not None:
                    # -1: every candidate failed once
                    viable = [v for v in viable if v[2] == cached_anchor]
                attempts = [(v[2], v[3], v[4]) for v in viable[:2]]
                if not attempts and cached_anchor is None:
                    fused_cache[anchor_key] = -1
                for ci, span, lo in attempts:
                    dep_idx = [i for i in range(len(key_names)) if i != ci]
                    dep_names = tuple(key_names[i] for i in dep_idx)
                    kname = key_names[ci]
                    G = 1 << (span - 1).bit_length()
                    nacc = max(1, len(specs)) + len(dep_names)
                    if not pool.try_reserve(G * 24 * nacc):
                        return None
                    try:
                        def update(st, b, _k=kname, _dep=dep_names, _g=G,
                                   _base=lo):
                            codes = b.columns[_k].values.to(torch.int64) \
                                - _base
                            st = ops.agg_span_update(st, b, codes,
                                                     _agg_exprs(b), specs, _g)
                            return ops.depkey_update(
                                st, b, codes,
                                {k: b.columns[k] for k in _dep}, _g)
                        state = loop(update, {
                            **ops.agg_span_init(G, specs, device),
                            **ops.depkey_init(G, dep_names, device)},
                            "RuntimeSpan")
                        dep_ok = ops.depkey_verify(state, state["__seen"],
                                                   dep_names)
                        # one host sync for the dependency check
                        if dep_names and not bool(dep_ok):
                            continue
                        fused_cache[anchor_key] = ci
                        key_arrays = {kname: (
                            lo + torch.arange(G, dtype=torch.int64,
                                              device=device))
                            .to(key_dtypes[ci])}
                        key_nulls = {}
                        for i in dep_idx:
                            k = key_names[i]
                            key_arrays[k] = ops._depkey_restore(
                                state[f"__dep_{k}$min"], key_dtypes[i])
                            key_nulls[k] = state[f"__dep_{k}$nulls"] > 0
                        return _maybe_compact(ops.agg_span_finalize(
                            state, specs, key_names, key_arrays, key_dicts,
                            key_nulls, key_lazy))
                    finally:
                        pool.free(G * 24 * nacc)
                else:
                    if attempts and cached_anchor is None:
                        fused_cache[anchor_key] = -1

            # high-cardinality keys: the sort aggregation over the chain's
            # stacked output, when it fits SORT_AGG_MAX_BYTES
            kprod = 1
            for k in expands:
                kprod *= k
            width = len(key_names) + sum(
                1 for e in input_exprs.values() if e is not None)
            est_mat = chain.total_rows * kprod * width * 9
            if (est_mat <= SORT_AGG_MAX_BYTES or sort_only_specs) \
                    and pool.try_reserve(est_mat):
                try:
                    chunks, steps = chunks_and_steps()
                    _meter("torchChainSortAgg", 1)
                    _meter("torchChainChunks", len(chunks))
                    _meter("torchChainSteps", len(steps))
                    parts = []
                    if acc is not None:
                        acc.restart(len(chunks))
                    for pos, cnt, cap in steps:
                        b = chain.make(pos, cnt, aux, expands, cap, acc)
                        cols = {k: b.columns[k] for k in key_names}
                        for out, col in _agg_exprs(b).items():
                            if col is not None:
                                cols["$in_" + out] = col
                        for out, col in _agg_exprs2(b).items():
                            cols["$in2_" + out] = col
                        parts.append(Batch(cols, b.mask))
                    flat = _concat(parts)
                    inputs = {s.output: flat.columns.get("$in_" + s.output)
                              for s in specs}
                    inputs2 = {s.output: flat.columns["$in2_" + s.output]
                               for s in specs if s.name in ops.CORR_AGGS}
                    del parts
                    return _maybe_compact(ops.sort_group_aggregate(
                        Batch({k: flat.columns[k] for k in key_names},
                              flat.mask), key_names, inputs, specs, inputs2))
                finally:
                    pool.free(est_mat)
            if sort_only_specs:
                # percentiles need value-ordered segments: the streaming
                # drain takes over
                return None

            # the hashed table, sized from the scan row count; collision
            # retries double it with a new salt
            num_slots = max(cfg.agg_slots, 1 << (
                min(2 * chain.total_rows, 1 << 22) - 1).bit_length())
            salt = 0
            for _attempt in range(cfg.max_agg_retries):
                est = _agg_state_bytes(num_slots, key_names, specs)
                if not pool.try_reserve(est):
                    return None
                try:
                    state = loop(hash_update(num_slots, salt), ops.agg_init(
                        num_slots, specs, key_names, key_dtypes, device),
                        "Hash")
                    # one host sync per pass
                    if not bool(state["__collision"]):
                        return _maybe_compact(hash_finalize(
                            state, key_dicts, key_lazy))
                finally:
                    pool.free(est)
                num_slots *= 2
                salt += 1
            raise RuntimeError("fused aggregation collision retries "
                               "exhausted")

        def gen():
            fused = get_fused()
            # grouped (lifespan) execution first, so an eligible chain
            # never reaches a scan kernel; per-node operator stats keep
            # the single-lifespan path
            if fused is not None and self.ctx.stats is None:
                grouped = fused_cache.get("grouped", False)
                if grouped is not False and grouped is not None \
                        and fused.build_params \
                        and grouped.params_fp != self.ctx.params_fingerprint:
                    # parameterized build tables (shared builds, bucket-0
                    # fanout probe) were sized under the old constants:
                    # rebuild the runner for this fingerprint
                    grouped = False
                if grouped is False:
                    from .grouped import make_grouped_runner
                    grouped = make_grouped_runner(
                        self, node, fused, key_names, specs, _agg_exprs,
                        basic_specs, bool(input_exprs2), cfg)
                    fused_cache["grouped"] = grouped
                if grouped is not None:
                    yield from grouped.run()
                    return
            shard = self.ctx.grouped_shard
            if shard is not None and shard[0] != 0:
                # the scheduler promised this stage disjoint lifespan
                # subsets over FULL splits, but grouped execution did not
                # engage: shard 0 alone runs the fallback over everything,
                # the other shards contribute nothing
                return
            if fused is not None:
                out = run_fused(fused)
                if out is not None:
                    yield out
                    return
            pool = self.ctx.memory
            _meter("torchStreamingAggregation", 1)
            if exchange_sort:
                _meter("exchangeSortAggregation", 1)
            if sort_only_specs or exchange_sort:
                if any(s.name in ops.HLL_AGGS for s in specs):
                    # percentiles need the sort path, HLL the hashed table
                    raise NotImplementedError(
                        "approx_percentile and approx_distinct in the "
                        "same aggregation are not supported; split the "
                        "query into two aggregations")
                merged, stream = drain_sort_input()
                if stream is None:
                    encode = lazy_keys(merged)[1]
                    if encode:
                        merged = _encode_lazy_keys(merged, encode)
                    yield _maybe_compact(sortagg(merged))
                    return
                if not cfg.spill_enabled:
                    stream.close()
                    raise MemoryExceededError(
                        f"sort-aggregation input exceeds memory budget "
                        f"{pool.budget} bytes and spill is disabled")
                if key_names:
                    yield from run_sorted_spilled(stream)
                else:
                    yield run_global_percentile_stream(stream)
                return
            # the grouped table is a revocable holder, so arbitration sees
            # it, whose callback declines (a table mid-scatter cannot be
            # spilled consistently): this operator spills itself only when
            # its own reservation misses
            agg_holder = (pool.register_revocable("agg-state", lambda: 0)
                          if key_names else None)
            if agg_holder is not None \
                    and not agg_holder.try_reserve(est_state_bytes):
                agg_holder.close()
                if not cfg.spill_enabled:
                    raise MemoryExceededError(
                        f"aggregation table exceeds memory budget "
                        f"{pool.budget} bytes and spill is disabled")
                yield from run_hash_spilled()
                return
            try:
                state, key_dicts, key_lazy, direct = run_retrying()
                if direct is not None:
                    yield ops.agg_direct_finalize(
                        state, specs, key_names, direct[0], direct[1],
                        key_dicts, force_row=not key_names)
                    return
                yield hash_finalize(state, key_dicts, key_lazy)
            finally:
                if agg_holder is not None:
                    agg_holder.close()
        return BatchSource(gen, out_names, out_types)


    def _skewed_percentile_bucket(self, bstore, p, key_names, specs,
                                  input_exprs, input_exprs2) -> Batch:
        """A percentile aggregation over a spill bucket still over the
        budget after re-partitioning (single keys own more rows than fit;
        no key-hash split helps a sort).  The percentiles come from
        per-key mergeable summaries computed chunk by chunk over the
        bucket's host rows (the m-point construction of
        operators.percentile_batch_summary, rank error <= 1/(2m)); every
        other aggregate runs exactly through the hashed table over the
        bucket (per-key state, small under skew); the two join on the
        grouping keys."""
        cfg = self.ctx.config
        pool = self.ctx.memory
        device = self.ctx.device
        low = self.lowering
        pct_specs = [s for s in specs if s.name == "approx_percentile"]
        other_specs = tuple(s for s in specs
                            if s.name != "approx_percentile")
        for s in pct_specs:
            if not isinstance(input_exprs[s.output],
                              VariableReferenceExpression):
                raise NotImplementedError(
                    "approx_percentile over a computed expression on a "
                    "skew-spilled bucket")

        # per-key percentile summaries over the host chunks (numpy); a
        # summary carries min(m, cnt) points
        m = ops.PERCENTILE_SKETCH_POINTS
        per_key: Dict[tuple, Dict[str, list]] = {}
        for rows in bstore.bucket_chunks(p):
            n = len(next(iter(rows.values()))[0])
            arrs = []
            for k in key_names:
                vals, nulls = rows[k]
                arrs.append(vals)
                arrs.append(nulls if nulls is not None
                            else np.zeros(n, dtype=bool))
            rec = np.rec.fromarrays(arrs)
            uniq, inverse = np.unique(rec, return_inverse=True)
            inverse = inverse.reshape(-1)
            order = np.argsort(inverse, kind="stable")
            bounds = np.searchsorted(inverse[order],
                                     np.arange(len(uniq) + 1))
            for g in range(len(uniq)):
                t = tuple(None if uniq[g][2 * j + 1] else
                          uniq[g][2 * j].item()  # lint: allow-host-sync
                          for j in range(len(key_names)))
                idxs = order[bounds[g]:bounds[g + 1]]
                ent = per_key.setdefault(
                    t, {s.output: [] for s in pct_specs})
                for s in pct_specs:
                    vals, nulls = rows[input_exprs[s.output].name]
                    v = vals[idxs]
                    if nulls is not None:
                        v = v[~nulls[idxs]]
                    cnt = len(v)
                    if cnt == 0:
                        continue
                    v = np.sort(v.astype(np.float64))
                    k_pts = min(m, cnt)
                    if k_pts < cnt:
                        pos = np.floor(np.arange(k_pts) * (cnt - 1)
                                       / (k_pts - 1) + 0.5) \
                            .astype(np.int64)
                        v = v[np.clip(pos, 0, cnt - 1)]
                    ent[s.output].append((v, cnt))

        def pct_value(chunks, frac):
            if not chunks:
                return 0.0, True
            pts = np.concatenate([c[0] for c in chunks])
            w = np.concatenate([np.full(len(c[0]), c[1] / len(c[0]))
                                for c in chunks])
            order = np.argsort(pts, kind="stable")
            cum = np.cumsum(w[order])
            total = sum(c[1] for c in chunks)
            target = np.floor(frac * max(total - 1, 0) + 0.5)
            idx = int(np.searchsorted(cum, target, side="right"))
            return float(pts[order][min(idx, len(pts) - 1)]), False

        def pct_column(vals, nulls, s):
            arr = torch.from_numpy(vals).to(device)
            if not s.is_float:
                arr = arr.to(torch.int64)
            return Column(arr, torch.from_numpy(nulls).to(device))

        key_batch0 = next(iter(bstore.bucket_batches(p, cfg.batch_rows)))
        key_cols0 = [key_batch0.columns[k] for k in key_names]
        key_dtypes = [c.values.dtype for c in key_cols0]
        key_dicts = {k: c.dictionary for k, c in zip(key_names, key_cols0)
                     if c.dictionary is not None}
        key_lazy = {k: c.lazy for k, c in zip(key_names, key_cols0)
                    if c.lazy is not None}
        if other_specs:
            # the other aggregates: the exact hashed table over the bucket
            out_batch = None
            num_slots, salt = 256, 0
            for _attempt in range(cfg.max_agg_retries):
                est = _agg_state_bytes(num_slots, key_names, other_specs)
                pool.reserve(est)
                try:
                    state = ops.agg_init(num_slots, other_specs,
                                         tuple(key_names), key_dtypes,
                                         device)
                    for b in bstore.bucket_batches(p, cfg.batch_rows):
                        ins = {s.output: (
                            None if input_exprs[s.output] is None
                            else low.eval(input_exprs[s.output], b))
                            for s in other_specs}
                        ins2 = {s.output: low.eval(input_exprs2[s.output], b)
                                for s in other_specs
                                if s.name in ops.CORR_AGGS}
                        state = ops.agg_update(
                            state, b, [b.columns[k] for k in key_names],
                            ins, other_specs, num_slots, salt,
                            tuple(key_names), ins2)
                    if not bool(state["__collision"]):
                        out_batch = ops.agg_finalize(
                            state, other_specs, tuple(key_names),
                            key_dicts, key_lazy)
                        break
                finally:
                    pool.free(est)
                num_slots *= 2
                salt += 1
            if out_batch is None:
                raise RuntimeError("skewed-bucket aggregation collision "
                                   "retries exhausted")
            # the percentile columns attached by key lookup on the host
            kc = [out_batch.columns[k] for k in key_names]
            kcols = [c.values.cpu().numpy()  # lint: allow-host-sync
                     for c in kc]
            knulls = [None if c.nulls is None
                      else c.nulls.cpu().numpy()  # lint: allow-host-sync
                      for c in kc]
            mask = out_batch.mask.cpu().numpy()  # lint: allow-host-sync
            cap = out_batch.capacity
            new_cols = dict(out_batch.columns)
            for s in pct_specs:
                frac = float(s.param if s.param is not None else 0.5)
                vals = np.zeros(cap, dtype=np.float64)
                nulls = np.ones(cap, dtype=bool)
                for i in range(cap):
                    if not mask[i]:
                        continue
                    t = tuple(
                        (None if (knulls[j] is not None and knulls[j][i])
                         else kcols[j][i].item())  # lint: allow-host-sync
                        for j in range(len(key_names)))
                    ent = per_key.get(t)
                    if ent is None:
                        continue
                    vals[i], nulls[i] = pct_value(ent[s.output], frac)
                new_cols[s.output] = pct_column(vals, nulls, s)
            return Batch(new_cols, out_batch.mask)

        # a percentile-only aggregation: the output from the host map
        keys = sorted(per_key, key=lambda t: tuple(
            (v is None, v) for v in t))
        cap = max(1, len(keys))
        cols: Dict[str, Column] = {}
        np_dtypes = [torch.empty(0, dtype=d)  # lint: allow-host-sync
                     .numpy().dtype for d in key_dtypes]
        for j, k in enumerate(key_names):
            kv = np.zeros(cap, dtype=np_dtypes[j])
            kn = np.zeros(cap, dtype=bool)
            for i, t in enumerate(keys):
                if t[j] is None:
                    kn[i] = True
                else:
                    kv[i] = t[j]
            cols[k] = Column(torch.from_numpy(kv).to(device),
                             torch.from_numpy(kn).to(device)
                             if kn.any() else None,
                             key_dicts.get(k), key_lazy.get(k))
        for s in pct_specs:
            frac = float(s.param if s.param is not None else 0.5)
            vals = np.zeros(cap, dtype=np.float64)
            nulls = np.ones(cap, dtype=bool)
            for i, t in enumerate(keys):
                vals[i], nulls[i] = pct_value(per_key[t][s.output], frac)
            cols[s.output] = pct_column(vals, nulls, s)
        mask = np.zeros(cap, dtype=bool)
        mask[:len(keys)] = True
        return Batch(cols, torch.from_numpy(mask).to(device))


def _chain_steps(chunks, leaf_cap: int, per_step: int):
    """(pos, rows, capacity) steps of the torch fused chain: runs of up to
    `per_step` contiguous scan chunks, each but a run's last one full, as
    one step of per_step x leaf_cap rows or fewer (the scan leaf decodes
    [pos, pos + capacity), inside the resident columns' padding)."""
    steps = []
    for pos, cnt in chunks:
        if steps:
            p0, n0, c0 = steps[-1]
            if n0 == c0 and p0 + n0 == pos and c0 < per_step * leaf_cap:
                steps[-1] = (p0, n0 + cnt, c0 + leaf_cap)
                continue
        steps.append((pos, cnt, leaf_cap))
    return steps


def _rewrite_agg_masks(node: P.AggregationNode) -> P.AggregationNode:
    """Aggregation masks (FILTER (WHERE ...) / the mask channel) as masked
    inputs: every aggregate ignores NULL inputs, so agg(x) MASK m ==
    agg(IF(m, x, NULL)) and count(*) MASK m == count(IF(m, 1, NULL))."""
    if not any(a.mask is not None for a in node.aggregations.values()):
        return node
    from ..common.types import BIGINT
    from ..spi.expr import CallExpression, ConstantExpression, special
    aggs = {}
    for v, a in node.aggregations.items():
        if a.mask is None:
            aggs[v] = a
            continue
        call_ = a.call
        if call_.arguments:
            arg0 = call_.arguments[0]
            masked = special("IF", arg0.type, a.mask, arg0,
                             ConstantExpression(None, arg0.type))
            call_ = CallExpression(call_.display_name, call_.type,
                                   [masked] + list(call_.arguments[1:]))
        else:                       # count(*)
            masked = special("IF", BIGINT, a.mask,
                             ConstantExpression(1, BIGINT),
                             ConstantExpression(None, BIGINT))
            call_ = CallExpression(call_.display_name, call_.type, [masked])
        aggs[v] = P.Aggregation(call_, a.distinct, None)
    return P.AggregationNode(node.id, node.source, aggs,
                             node.grouping_keys, node.step)


def _group_estimate(node: P.AggregationNode) -> Optional[float]:
    """The optimizer's group-count estimate of an aggregation, or None."""
    try:
        from ..sql.stats import StatsCalculator
        return StatsCalculator().rows(node)
    except Exception:   # noqa: BLE001 -- an estimate only
        return None


def _initial_slots(est_groups, key_names, agg_slots: int) -> int:
    """The hash table's first size: agg_slots, raised to the pow2 ceiling
    of twice the optimizer's group estimate (~2x probing headroom), the
    estimate term clamped to 2**20 so a wild overestimate cannot blow up
    device memory."""
    if not key_names or not est_groups:
        return agg_slots
    est_based = 1 << max(0, (int(2 * est_groups) - 1).bit_length())
    return max(agg_slots, min(est_based, 1 << 20))


def _agg_state_bytes(num_slots: int, key_names, specs) -> int:
    """Accumulator footprint estimate of a hash table (hash + occupied +
    per-key value/null + per-aggregate state columns + HLL registers),
    the reference's one formula for every aggregation budget check."""
    return num_slots * (16 + 12 * len(key_names) + 24 * max(1, len(specs))
                        + ops.hll_state_bytes(specs))


def _direct_mode_info(key_names, key_cols,
                      gmax: int = ops.DIRECT_AGG_MAX_GROUPS):
    """Closed-small-domain eligibility for direct aggregation (consistent
    with ops.agg_direct_finalize's slot decode).  Returns None when
    ineligible, else (doms, G, strides, key_dtypes, key_dicts)."""
    doms = []
    for c in key_cols:
        if c.nulls is not None or c.lazy is not None:
            return None
        if c.dictionary is not None:
            doms.append(len(c.dictionary))
        elif c.values.dtype == torch.bool:
            doms.append(2)
        else:
            return None
    G = 1
    for d in doms:
        G *= max(1, d)
    if key_names and G > gmax:
        return None
    G = max(1, G)
    doms = tuple(max(1, d) for d in doms)
    strides, s = [], G
    for d in doms:
        s //= d
        strides.append(s)
    key_dicts = {k: c.dictionary for k, c in zip(key_names, key_cols)
                 if c.dictionary is not None}
    return (doms, G, tuple(strides),
            tuple(c.values.dtype for c in key_cols), key_dicts)


# ---------------------------------------------------------------------------
# host hoisting of string functions over late-materialized columns
#
# LIKE / substr / starts_with / ends_with / concat over an open-domain
# column (catalog.OPEN_DOMAIN) cannot run on the device: the column holds
# row ids, the strings exist only in the generator.  The compiler rewrites
# such calls into synthetic variables, computed per batch as a gather of a
# whole-column host result (generated once per column and call, in bounded
# FIFO caches).
# ---------------------------------------------------------------------------

# batch-independent substr dictionaries, keyed by (cid, table, column, sf,
# start, length)
_SUBSTR_DICT_CACHE: Dict[Tuple, Tuple[str, ...]] = {}
# whole-column substr codes / LIKE masks / transform codes / predicate
# values, indexed by row id (entries are O(table rows): FIFO-bounded)
_SUBSTR_CODES_CACHE: Dict[Tuple, np.ndarray] = {}
_LIKE_MASK_CACHE: Dict[Tuple, np.ndarray] = {}
_XFORM_DICT_CACHE: Dict[Tuple, Tuple[str, ...]] = {}
_XFORM_CODES_CACHE: Dict[Tuple, np.ndarray] = {}
_PRED_VALUE_CACHE: Dict[Tuple, np.ndarray] = {}
# whole-column codes on a device (the sort keys' gathers)
_DEV_CODES_CACHE: Dict[Tuple, torch.Tensor] = {}
_COLUMN_CACHE_MAX_ENTRIES = 64
# rows generated per host step of a whole-column pass
_HOST_CHUNK = 1 << 18


# the FIFO eviction is a read-modify-write; scan drivers
# (task_concurrency) may fill the caches from several threads
_CACHE_LOCK = threading.Lock()


def _cache_put(cache: Dict, key, value) -> None:
    with _CACHE_LOCK:
        if len(cache) >= _COLUMN_CACHE_MAX_ENTRIES:
            cache.pop(next(iter(cache)))
        cache[key] = value


def _column_chunks(cid: str, table: str, column: str, sf: float):
    """(pos, strings) over every row of the column, _HOST_CHUNK at a
    time."""
    n = catalog.table_row_count(table, sf, cid)
    for pos in range(0, n, _HOST_CHUNK):
        cnt = min(_HOST_CHUNK, n - pos)
        yield pos, catalog.generate_values_at(
            table, column, sf, np.arange(pos, pos + cnt, dtype=np.int64),
            cid)


def _py_substr(s: str, start: int, length) -> str:
    i = start - 1 if start > 0 else len(s) + start
    return s[i:i + length] if length is not None else s[i:]


def _canonical_substr_dict(cid: str, table: str, column: str, sf: float,
                           start: int, length) -> Tuple[str, ...]:
    """Whole-column (batch-independent) sorted dictionary of substr over
    an open-domain column: codes are stable across batches and rank
    ordered for ORDER BY / GROUP BY consumers."""
    key = (cid, table, column, sf, start, length)
    if key not in _SUBSTR_DICT_CACHE:
        uniq = set()
        for _pos, strings in _column_chunks(cid, table, column, sf):
            uniq.update(_py_substr(s, start, length) for s in strings)
        _SUBSTR_DICT_CACHE[key] = tuple(sorted(uniq))
    return _SUBSTR_DICT_CACHE[key]


def substr_codes_plain(strings, start: int, length, index) -> np.ndarray:
    """native.substr_dict_encode's plain version: each string's substr
    looked up in the dictionary's index."""
    return np.fromiter((index[_py_substr(s, start, length)]
                        for s in strings), dtype=np.int32, count=len(strings))


def like_mask_plain(strings, match) -> np.ndarray:
    """native.like_match's plain version: the Python matcher per string."""
    return np.fromiter((match(s) for s in strings), dtype=bool,
                       count=len(strings))


def _column_substr_codes(cid: str, table: str, column: str, sf: float,
                         start: int, length) -> np.ndarray:
    """int32 substr dictionary codes for every row of the column: the
    native library per chunk (the reference's pipeline.py:3732-3750), the
    Python loop where it declines."""
    from .. import native
    key = (cid, table, column, sf, start, length)
    codes_all = _SUBSTR_CODES_CACHE.get(key)
    if codes_all is None:
        cdict = _canonical_substr_dict(cid, table, column, sf, start,
                                       length)
        index = None
        codes_all = np.empty(catalog.table_row_count(table, sf, cid),
                             dtype=np.int32)
        for pos, strings in _column_chunks(cid, table, column, sf):
            chunk = native.substr_dict_encode(strings, start, length, cdict)
            if chunk is None:
                if index is None:
                    index = {s: i for i, s in enumerate(cdict)}
                chunk = substr_codes_plain(strings, start, length, index)
            codes_all[pos:pos + len(strings)] = chunk
        _cache_put(_SUBSTR_CODES_CACHE, key, codes_all)
    return codes_all


def _column_like_mask(cid: str, table: str, column: str, sf: float,
                      pattern: str) -> np.ndarray:
    """LIKE results for every row of the column: the native library per
    chunk (the reference's pipeline.py:3757-3774), the Python matcher
    where it declines."""
    from .lowering import like_matcher
    from .. import native
    key = (cid, table, column, sf, pattern)
    mask_all = _LIKE_MASK_CACHE.get(key)
    if mask_all is None:
        match = None
        mask_all = np.empty(catalog.table_row_count(table, sf, cid),
                            dtype=bool)
        for pos, strings in _column_chunks(cid, table, column, sf):
            chunk = native.like_match(strings, pattern)
            if chunk is None:
                if match is None:
                    match = like_matcher(pattern)
                chunk = like_mask_plain(strings, match)
            mask_all[pos:pos + len(strings)] = chunk
        _cache_put(_LIKE_MASK_CACHE, key, mask_all)
    return mask_all


def _column_xform_codes(cid, table, column, sf, tag, fn):
    """(sorted dictionary, int32 codes of every row) of a per-string
    transform of the column."""
    key = (cid, table, column, sf, tag)
    cdict = _XFORM_DICT_CACHE.get(key)
    codes_all = _XFORM_CODES_CACHE.get(key)
    if cdict is None or codes_all is None:
        mapped = np.empty(catalog.table_row_count(table, sf, cid),
                          dtype=object)
        for pos, strings in _column_chunks(cid, table, column, sf):
            mapped[pos:pos + len(strings)] = [fn(x) for x in strings]
        cdict = tuple(sorted(set(mapped.tolist())))
        index = {x: i for i, x in enumerate(cdict)}
        codes_all = np.fromiter((index[x] for x in mapped), dtype=np.int32,
                                count=len(mapped))
        _cache_put(_XFORM_DICT_CACHE, key, cdict)
        _cache_put(_XFORM_CODES_CACHE, key, codes_all)
    return cdict, codes_all


def _column_pred_values(cid, table, column, sf, tag, fn, dtype):
    """Per-row results of a value-returning string function over the
    whole column."""
    key = (cid, table, column, sf, tag)
    out = _PRED_VALUE_CACHE.get(key)
    if out is None:
        out = np.empty(catalog.table_row_count(table, sf, cid), dtype=dtype)
        for pos, strings in _column_chunks(cid, table, column, sf):
            out[pos:pos + len(strings)] = np.fromiter(
                (fn(x) for x in strings), dtype=dtype, count=len(strings))
        _cache_put(_PRED_VALUE_CACHE, key, out)
    return out


# string functions hoisted over lazy columns: column first, constant
# extras, never-NULL results (the whole-column caches carry no null
# channel); a transform gives codes over a new dictionary, a predicate
# per-row values
_HOIST_XFORM = ("regexp_replace",)
_HOIST_PRED = ("regexp_like", "starts_with", "ends_with")


def _gather_rows(table_all: np.ndarray, col: Column) -> torch.Tensor:
    """table_all[row id] for every row of a lazy column, on its device
    (padding rows hold id 0; ids are clamped for the gather)."""
    ids = col.values.cpu().numpy()  # lint: allow-host-sync
    ids = np.clip(ids, 0, len(table_all) - 1)
    return torch.from_numpy(np.ascontiguousarray(table_all[ids])).to(
        col.values.device)


def _host_string_column(call_expr: CallExpression, batch: Batch) -> Column:
    col = batch.columns[_hoistable_var(call_expr).name]
    cid, table, column, sf = col.lazy
    name = canonical_name(call_expr.display_name)
    if name in _HOIST_XFORM:
        from .lowering import STRING_TO_STRING
        extra = tuple(a.value for a in call_expr.arguments[1:])
        kern = STRING_TO_STRING[name]
        cdict, codes_all = _column_xform_codes(
            cid, table, column, sf, (name,) + extra,
            lambda x, _k=kern, _e=extra: _k(x, *_e))
        return Column(_gather_rows(codes_all, col), col.nulls, cdict)
    if name in _HOIST_PRED:
        from .lowering import STRING_TO_VALUE
        extra = tuple(a.value for a in call_expr.arguments[1:])
        kern, dtype = STRING_TO_VALUE[name]
        vals_all = _column_pred_values(
            cid, table, column, sf, (name,) + extra,
            lambda x, _k=kern, _e=extra: _k(x, *_e), dtype)
        return Column(_gather_rows(vals_all, col), col.nulls)
    if name == "concat":
        parts = tuple(None if isinstance(a, VariableReferenceExpression)
                      else str(a.value) for a in call_expr.arguments)
        cdict, codes_all = _column_xform_codes(
            cid, table, column, sf, ("concat", parts),
            lambda x, _p=parts: "".join(x if p is None else p for p in _p))
        return Column(_gather_rows(codes_all, col), col.nulls, cdict)
    if name == "like":
        pattern = str(call_expr.arguments[1].value)
        mask_all = _column_like_mask(cid, table, column, sf, pattern)
        return Column(_gather_rows(mask_all, col), col.nulls)
    start = int(call_expr.arguments[1].value)
    length = (int(call_expr.arguments[2].value)
              if len(call_expr.arguments) > 2 else None)
    cdict = _canonical_substr_dict(cid, table, column, sf, start, length)
    codes_all = _column_substr_codes(cid, table, column, sf, start, length)
    return Column(_gather_rows(codes_all, col), col.nulls, cdict)


def _add_hoisted(batch: Batch, hoisted: Dict[str, CallExpression]) -> Batch:
    if not hoisted:
        return batch
    return batch.with_columns({name: _host_string_column(c, batch)
                               for name, c in hoisted.items()})


class _StringHoister:
    """Finds the hoistable string calls rooted at a variable, and -- once
    the first batch shows which of those variables are late-materialized
    -- rewrites them into host-computed columns."""

    def __init__(self, exprs):
        self.exprs = list(exprs)
        self.candidates: Dict[str, CallExpression] = {}
        for e in self.exprs:
            _find_string_calls(e, self.candidates)

    def resolve(self, first_batch: Batch):
        active: Dict[str, Tuple] = {}
        for key, c in self.candidates.items():
            col = first_batch.columns.get(_hoistable_var(c).name)
            if col is not None and col.lazy is not None:
                var = VariableReferenceExpression(
                    f"__hoist_{len(active)}_{abs(hash(key)) % 10**8}",
                    c.type)
                active[key] = (var, c)
        if not active:
            return self.exprs, {}
        table = {k: v for k, (v, _) in active.items()}
        rewritten = [_rewrite_expr(e, table) for e in self.exprs]
        return rewritten, {v.name: c for v, c in active.values()}


def _hoist_key(e: RowExpression) -> str:
    return json.dumps(e.to_dict(), sort_keys=True, default=str)


def _hoistable_var(e: CallExpression):
    """The single column argument of a host-hoistable string call, or
    None: like / substr / regexp_replace / regexp_like / starts_with /
    ends_with take the column first and constants after; concat takes one
    column among non-NULL constant parts."""
    name = canonical_name(e.display_name)
    if name in ("like", "substr") + _HOIST_XFORM + _HOIST_PRED \
            and e.arguments and isinstance(
                e.arguments[0], VariableReferenceExpression) \
            and all(isinstance(a, ConstantExpression)
                    for a in e.arguments[1:]):
        return e.arguments[0]
    if name == "concat":
        var_args = [a for a in e.arguments
                    if isinstance(a, VariableReferenceExpression)]
        # a NULL constant part makes every result NULL: not a transform
        if len(var_args) == 1 and all(
                isinstance(a, ConstantExpression) and a.value is not None
                for a in e.arguments
                if not isinstance(a, VariableReferenceExpression)):
            return var_args[0]
    return None


def _find_string_calls(e: RowExpression, out: Dict[str, CallExpression]):
    if isinstance(e, CallExpression) and _hoistable_var(e) is not None:
        out[_hoist_key(e)] = e
        return
    for a in getattr(e, "arguments", None) or []:
        _find_string_calls(a, out)


def _rewrite_expr(e: RowExpression, table: Dict[str, RowExpression]):
    if isinstance(e, CallExpression):
        k = _hoist_key(e)
        if k in table:
            return table[k]
        return CallExpression(e.display_name, e.type,
                              [_rewrite_expr(a, table) for a in e.arguments])
    if isinstance(e, SpecialFormExpression):
        return SpecialFormExpression(
            e.form, e.type, [_rewrite_expr(a, table) for a in e.arguments])
    return e


def _encode_unordered_lazy_keys(batch: Batch, keys: List[str]) -> Batch:
    """Whole-column dictionary-encode every sort-key column whose lazy row
    ids do not sort like its values (catalog.ROWID_ORDERED).  The codes
    table is copied to the device once; each batch is a device gather, so
    a streamed consumer (TopN) adds no host sync."""
    new_cols = {}
    for k in keys:
        col = batch.columns.get(k)
        if col is None or col.lazy is None:
            continue
        cid, tbl, coln, sf = col.lazy
        if (tbl, coln) in catalog.ROWID_ORDERED:
            continue
        cdict = _canonical_substr_dict(cid, tbl, coln, sf, 1, None)
        ck = (cid, tbl, coln, sf, str(col.values.device))
        codes_dev = _DEV_CODES_CACHE.get(ck)
        if codes_dev is None:
            codes_dev = torch.from_numpy(_column_substr_codes(
                cid, tbl, coln, sf, 1, None)).to(col.values.device)
            _cache_put(_DEV_CODES_CACHE, ck, codes_dev)
        ids = col.values.to(torch.int64).clamp(0, codes_dev.shape[0] - 1)
        new_cols[k] = Column(codes_dev[ids], col.nulls, cdict)
    return batch.with_columns(new_cols) if new_cols else batch


def _encode_lazy_keys(batch: Batch, keys: List[str]) -> Batch:
    """Late-materialized key columns replaced by whole-column dictionary
    codes (GROUP BY on a small-pool open-domain column, where row ids
    would split value groups)."""
    new_cols = {}
    for k in keys:
        col = batch.columns[k]
        cid, table, column, sf = col.lazy
        cdict = _canonical_substr_dict(cid, table, column, sf, 1, None)
        codes_all = _column_substr_codes(cid, table, column, sf, 1, None)
        new_cols[k] = Column(_gather_rows(codes_all, col), col.nulls, cdict)
    return batch.with_columns(new_cols)
