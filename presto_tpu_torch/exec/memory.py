"""Device-memory accounting, revocable arbitration and two-tier (host RAM
-> LZ4 disk) spill staging: the port of presto_tpu/exec/memory.py.

- `MemoryPool` is the worker pool's byte accounting with the RESERVED vs
  REVOCABLE split: a revocable reservation names bytes an operator can
  give back on demand by spilling (a join build's staged batches, an
  aggregation's state).  Under pressure the pool's arbitrator revokes the
  LARGEST revocable holder through its registered callback instead of
  failing the reservation, so `MemoryExceededError` is raised only when
  nothing revocable remains.
- `MemoryContext` is one node of the query -> task -> operator tree:
  reservations bubble up to the root, and a root `max_bytes` is the
  `query.max-memory` ceiling, whose breach is the typed, non-retryable
  user error.  Revocable bytes are exempt from it.
- `PartitionedSpillStore` holds K key-hash buckets of rows staged to host
  RAM, up to a host budget; past it whole buckets overflow to an
  LZ4-compressed disk file in the SerializedPage block serde.  With
  `async_staging` on a CUDA device, each batch is copied device -> host
  on the store's own CUDA stream into pinned buffers, at most
  `_STAGING_DEPTH` copies in flight; the host routes a batch's rows only
  after its copy's event has completed, and the producer waits only when
  both slots are busy.  The overlap fraction (1 - wait / stage) is
  metered through RuntimeStats with the spill and unspill bytes and
  walls.  On the CPU a batch is staged by a plain copy.
"""
from __future__ import annotations

import os
import struct
import tempfile
import time
from collections import deque
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..common.locks import OrderedLock
from .batch import Batch, Column

NANO = 1_000_000_000


class MemoryExceededError(RuntimeError):
    """Pool pressure that spill and arbitration could not absorb
    (reference EXCEEDED_LOCAL_MEMORY_LIMIT; retryable)."""


class QueryMemoryLimitExceededError(MemoryExceededError):
    """The `query.max-memory` limit: the query asked for more than its
    configured ceiling (reference EXCEEDED_GLOBAL_MEMORY_LIMIT).  The
    user's to fix, so it fails fast and is never retried."""

    error_type = "USER_ERROR"
    error_code = "EXCEEDED_MEMORY_LIMIT"

    def __init__(self, used: int, requested: int, limit: int,
                 context: str = ""):
        super().__init__(
            f"[USER_ERROR] EXCEEDED_MEMORY_LIMIT: query memory "
            f"{used} + {requested} bytes exceeds query.max-memory "
            f"{limit} bytes" + (f" (context {context})" if context else ""))
        self.used = used
        self.requested = requested
        self.limit = limit


# ---------------------------------------------------------------------------
# process-wide memory metrics
# ---------------------------------------------------------------------------

class MemoryMetrics:
    _COUNTERS = ("spilled_bytes", "disk_spilled_bytes", "unspilled_bytes",
                 "spill_wall_s", "spill_wait_wall_s", "unspill_wall_s",
                 "revocations", "revoked_bytes", "arbitrations",
                 "arbitration_failures", "over_free", "over_free_bytes",
                 "query_limit_failures")
    # the reference's two gauges of /v1/metrics; nothing sets them, in
    # either package, so both serve 0
    _GAUGES = ("reserved_bytes", "revocable_bytes")

    def __init__(self):
        # a leaf lock: bumped from every thread while other locks are held
        self._lock = OrderedLock("metrics:memory", 100)
        self.reset()

    def reset(self) -> None:
        with self._lock:
            for name in self._COUNTERS + self._GAUGES:
                setattr(self, name, 0)

    def incr(self, name: str, delta=1) -> None:
        with self._lock:
            setattr(self, name, getattr(self, name) + delta)

    def snapshot(self) -> dict:
        with self._lock:
            out = {name: getattr(self, name)
                   for name in self._COUNTERS + self._GAUGES}
        stage, wait = out["spill_wall_s"], out["spill_wait_wall_s"]
        out["spill_overlap_fraction"] = (
            max(0.0, 1.0 - wait / stage) if stage > 0 else 0.0)
        return out


MEMORY_METRICS = MemoryMetrics()


# ---------------------------------------------------------------------------
# revocable holders + the arbitrated pool
# ---------------------------------------------------------------------------

class RevocableHolder:
    """One registered revocable reservation and its revoke callback.
    `revoke_cb() -> bytes freed` must not block: a holder that cannot
    spill right now returns 0 and the arbitrator moves to the next
    victim."""

    def __init__(self, pool, name: str, revoke_cb: Callable[[], int]):
        self._pool = pool
        self.name = name
        self._revoke_cb = revoke_cb
        self.bytes = 0
        self.revoke_requested = False
        self.closed = False

    def try_reserve(self, n: int, arbitrate: bool = True) -> bool:
        """A revocable reservation, arbitrating OTHER holders.  A caller
        that holds its own operator lock while charging passes
        arbitrate=False and spills itself on failure."""
        if not self._pool.try_reserve(n, revocable=True, exclude=self,
                                      arbitrate=arbitrate):
            return False
        self.bytes += n
        return True

    def free(self, n: int) -> None:
        n = min(int(n), self.bytes)
        if n <= 0:
            return
        self.bytes -= n
        self._pool.free(n, revocable=True)

    def close(self) -> None:
        """Release whatever is still held and unregister."""
        if self.closed:
            return
        self.closed = True
        self.free(self.bytes)
        self._pool._unregister(self)

    def _run_revoke(self) -> int:
        try:
            freed = int(self._revoke_cb() or 0)
        except Exception:   # noqa: BLE001 -- a failing victim declines
            return 0
        if freed > 0:
            self.revoke_requested = False
        return freed


class MemoryPool:
    """Byte accounting for device materializations with the reserved /
    revocable split and the arbitrator.  budget=None means unlimited
    (accounting only; the peak is still tracked).  Thread-safe."""

    def __init__(self, budget: Optional[int] = None):
        self.budget = budget
        self.reserved = 0
        self.revocable = 0
        self.peak = 0
        self.over_free_count = 0
        self.over_free_bytes = 0
        self.revocations = 0
        self.revoked_bytes = 0
        self.arbitrations = 0
        self.spilled_bytes = 0        # host-staged by stores under this pool
        self.disk_spilled_bytes = 0   # overflowed from host RAM to disk
        self.unspilled_bytes = 0      # read back from disk
        # reentrant: MemoryContext composes multi-step updates under it
        self._lock = OrderedLock("memory-pool", 40, reentrant=True)
        # one arbitration pass at a time; revoke callbacks run outside the
        # accounting lock (they free into it) but inside this one
        self._arb_lock = OrderedLock("memory-arbitrator", 20)
        self._holders: List[RevocableHolder] = []

    # -- reservation ------------------------------------------------------
    @property
    def total_reserved(self) -> int:
        return self.reserved + self.revocable

    @property
    def limited(self) -> bool:
        return self.budget is not None

    def _try_locked(self, n: int, revocable: bool) -> bool:
        with self._lock:
            if self.budget is not None \
                    and self.reserved + self.revocable + n > self.budget:
                return False
            if revocable:
                self.revocable += n
            else:
                self.reserved += n
            self.peak = max(self.peak, self.reserved + self.revocable)
            return True

    def try_reserve(self, n: int, revocable: bool = False,
                    exclude: Optional[RevocableHolder] = None,
                    arbitrate: bool = True) -> bool:
        if self._try_locked(n, revocable):
            return True
        if not arbitrate:
            return False
        return self._arbitrate(n, revocable, exclude)

    def reserve(self, n: int, revocable: bool = False) -> None:
        if not self.try_reserve(n, revocable=revocable):
            raise MemoryExceededError(
                f"memory budget exceeded: reserved {self.reserved} "
                f"(+{self.revocable} revocable) + {n} > {self.budget} "
                f"bytes and no revocable memory remains")

    def free(self, n: int, revocable: bool = False) -> None:
        with self._lock:
            held = self.revocable if revocable else self.reserved
            if n > held:
                # a double free or a wrong size: clamp, and count it so
                # the leak is visible
                self.over_free_count += 1
                self.over_free_bytes += n - held
                MEMORY_METRICS.incr("over_free")
                MEMORY_METRICS.incr("over_free_bytes", n - held)
                n = held
            if revocable:
                self.revocable -= n
            else:
                self.reserved -= n

    # -- revocable holder registry + arbitration --------------------------
    def register_revocable(self, name: str,
                           revoke_cb: Callable[[], int]) -> RevocableHolder:
        h = RevocableHolder(self, name, revoke_cb)
        with self._lock:
            self._holders.append(h)
        return h

    def _unregister(self, holder: RevocableHolder) -> None:
        with self._lock:
            if holder in self._holders:
                self._holders.remove(holder)

    def _arbitrate(self, n: int, revocable: bool,
                   exclude: Optional[RevocableHolder]) -> bool:
        """Revoke the largest revocable holder, retry the reservation,
        repeat until it fits or nothing revocable remains.  A holder that
        declines (returns 0) is skipped for this pass."""
        with self._lock:
            self.arbitrations += 1
        MEMORY_METRICS.incr("arbitrations")
        declined: set = set()
        with self._arb_lock:
            while True:
                if self._try_locked(n, revocable):
                    return True
                with self._lock:
                    candidates = [h for h in self._holders
                                  if h is not exclude and not h.closed
                                  and h.bytes > 0 and id(h) not in declined]
                if not candidates:
                    MEMORY_METRICS.incr("arbitration_failures")
                    return False
                victim = max(candidates, key=lambda h: h.bytes)
                victim.revoke_requested = True
                freed = victim._run_revoke()
                if freed <= 0:
                    declined.add(id(victim))
                else:
                    with self._lock:
                        self.revocations += 1
                        self.revoked_bytes += freed
                    MEMORY_METRICS.incr("revocations")
                    MEMORY_METRICS.incr("revoked_bytes", freed)

    # -- spill accounting (fed by PartitionedSpillStore) ------------------
    def note_spill(self, n: int) -> None:
        with self._lock:
            self.spilled_bytes += n

    def note_disk_spill(self, n: int) -> None:
        with self._lock:
            self.disk_spilled_bytes += n

    def note_unspill(self, n: int) -> None:
        with self._lock:
            self.unspilled_bytes += n

    def stats_dict(self) -> dict:
        with self._lock:
            return {
                "reservedBytes": self.reserved,
                "revocableBytes": self.revocable,
                "totalReservedBytes": self.reserved + self.revocable,
                "peakBytes": self.peak,
                "spilledBytes": self.spilled_bytes,
                "diskSpilledBytes": self.disk_spilled_bytes,
                "unspilledBytes": self.unspilled_bytes,
                "revocations": self.revocations,
                "revokedBytes": self.revoked_bytes,
                "arbitrations": self.arbitrations,
                "memoryOverFree": self.over_free_count,
                "memoryOverFreeBytes": self.over_free_bytes,
            }


class MemoryContext:
    """One node of the query -> task -> operator context tree;
    reservations bubble up to the root.  A root `max_bytes` is the
    query.max-memory ceiling; revocable bytes are exempt from it.
    Duck-types the MemoryPool surface."""

    def __init__(self, pool: MemoryPool, name: str = "query",
                 parent: Optional["MemoryContext"] = None,
                 max_bytes: Optional[int] = None):
        self.pool = pool
        self.name = name
        self.parent = parent
        self.max_bytes = max_bytes
        self.reserved = 0
        self.revocable = 0
        self.peak = 0

    def new_child(self, name: str) -> "MemoryContext":
        return MemoryContext(self.pool, name, parent=self)

    @property
    def budget(self):
        return self.pool.budget

    @property
    def limited(self) -> bool:
        """True when the pool carries a budget or this context (or an
        ancestor) carries a query.max-memory ceiling."""
        if self.pool.budget is not None:
            return True
        node = self
        while node is not None:
            if node.max_bytes is not None:
                return True
            node = node.parent
        return False

    # -- tree bookkeeping -------------------------------------------------
    def _check_limit_up(self, n: int) -> None:
        node = self
        while node is not None:
            if node.max_bytes is not None \
                    and node.reserved + n > node.max_bytes:
                MEMORY_METRICS.incr("query_limit_failures")
                raise QueryMemoryLimitExceededError(
                    node.reserved, n, node.max_bytes, context=node.name)
            node = node.parent

    def _apply_up(self, n: int, revocable: bool) -> None:
        node = self
        while node is not None:
            if revocable:
                node.revocable += n
            else:
                node.reserved += n
            node.peak = max(node.peak, node.reserved + node.revocable)
            node = node.parent

    # -- reservation (pool surface) ---------------------------------------
    def try_reserve(self, n: int, revocable: bool = False,
                    exclude: Optional[RevocableHolder] = None,
                    arbitrate: bool = True) -> bool:
        with self.pool._lock:
            if not revocable:
                self._check_limit_up(n)
        if not self.pool.try_reserve(n, revocable=revocable,
                                     exclude=exclude, arbitrate=arbitrate):
            return False
        with self.pool._lock:
            self._apply_up(n, revocable)
        return True

    def reserve(self, n: int, revocable: bool = False) -> None:
        if not self.try_reserve(n, revocable=revocable):
            raise MemoryExceededError(
                f"memory budget exceeded: reserved {self.pool.reserved} "
                f"(+{self.pool.revocable} revocable) + {n} > "
                f"{self.pool.budget} bytes and no revocable memory remains")

    def free(self, n: int, revocable: bool = False) -> None:
        self.pool.free(n, revocable=revocable)
        with self.pool._lock:
            held = self.revocable if revocable else self.reserved
            self._apply_up(-min(n, held), revocable)

    # -- pass-throughs ----------------------------------------------------
    def register_revocable(self, name: str,
                           revoke_cb: Callable[[], int]) -> RevocableHolder:
        # the holder charges through this context (revocable bytes bubble
        # up the tree) and registers with the root pool, where the
        # arbitrator looks for victims
        h = RevocableHolder(self, f"{self.name}/{name}", revoke_cb)
        with self.pool._lock:
            self.pool._holders.append(h)
        return h

    def _unregister(self, holder: RevocableHolder) -> None:
        self.pool._unregister(holder)

    def note_spill(self, n: int) -> None:
        self.pool.note_spill(n)

    def note_disk_spill(self, n: int) -> None:
        self.pool.note_disk_spill(n)

    def note_unspill(self, n: int) -> None:
        self.pool.note_unspill(n)

    @property
    def spilled_bytes(self) -> int:
        return self.pool.spilled_bytes

    @property
    def total_reserved(self) -> int:
        return self.reserved + self.revocable

    def stats_dict(self) -> dict:
        d = self.pool.stats_dict()
        d["contextReservedBytes"] = self.reserved
        d["contextRevocableBytes"] = self.revocable
        d["contextPeakBytes"] = self.peak
        return d


def batch_bytes(batch) -> int:
    """Device bytes of a Batch: every column's values and NULL mask, and
    the row mask."""
    n = batch.mask.numel() * batch.mask.element_size()
    for c in batch.columns.values():
        n += c.values.numel() * c.values.element_size()
        if c.nulls is not None:
            n += c.nulls.numel() * c.nulls.element_size()
    return n


# ---------------------------------------------------------------------------
# two-tier partitioned spill store
# ---------------------------------------------------------------------------

_SPILL_SALT = 0x511

# device -> host copies in flight at once: double buffering (the operator
# fills batch k+1 while batch k copies)
_STAGING_DEPTH = 2


def _np_to_block_view(v: np.ndarray):
    """An array viewed as the width-matched signed-int dtype the
    fixed-width block serde carries; None when it has no such form."""
    if v.ndim != 1 or v.dtype.itemsize not in (1, 2, 4, 8) \
            or v.dtype.kind not in "fuib":
        return None
    return v.view(np.dtype(f"i{v.dtype.itemsize}"))


class _Staged:
    """One batch's device -> host copy: the pinned host buffers, the
    device tensors they copy from (kept alive until the copy completes),
    and the copy's events on the staging stream."""

    __slots__ = ("names", "host", "source", "start", "done")

    def __init__(self, names, host, source, start, done):
        self.names = names
        self.host = host
        self.source = source
        self.start = start
        self.done = done


class PartitionedSpillStore:
    """K key-hash buckets of host-staged rows, column encodings kept.

    `add` groups a batch's live rows by bucket hash(keys, salt) mod K
    on its device (operators.hash_columns, the reference's splitmix64
    mix in int64 bits; a stable sort, so each bucket keeps the batch's
    row order), stages them to the host and appends each bucket's range;
    `bucket_batches` uploads one bucket
    as Batches on the store's device.  The same key columns and salt on
    two stores route equal keys to equal buckets (the grace join and the
    partitioned aggregation rely on it).

    Staged rows live in host RAM up to `budget_bytes`; past it the
    largest resident bucket overflows to an LZ4-compressed disk file
    under `spill_path` (the system temp dir when None), chunk order kept
    so a read is bit-identical to the resident run."""

    def __init__(self, k: int, salt: int = _SPILL_SALT,
                 budget_bytes: Optional[int] = None,
                 spill_path: Optional[str] = None,
                 stats=None, async_staging: bool = False,
                 pool=None):
        self.k = k
        self.salt = salt
        self.buckets: List[List[Dict[str, Tuple[np.ndarray,
                                                Optional[np.ndarray]]]]] = \
            [[] for _ in range(k)]
        self.meta: Dict[str, Tuple] = {}     # column -> (dictionary, lazy)
        self.rows = [0] * k
        self.bytes = [0] * k                 # logical bytes (both tiers)
        self.host_bytes = [0] * k            # resident host-RAM bytes only
        self.spilled_bytes = 0               # cumulative staged bytes
        self.disk_bytes = 0                  # cumulative disk-written bytes
        self.unspilled_bytes = 0             # cumulative disk re-reads
        self.budget_bytes = budget_bytes
        self.spill_path = spill_path
        self.stats = stats                   # RuntimeStats sink (optional)
        self.pool = pool                     # MemoryPool/MemoryContext sink
        self.device: Optional[torch.device] = None
        self._disk_file: Optional[str] = None
        self._disk_records: List[List[Tuple[int, int, list, int]]] = \
            [[] for _ in range(k)]           # (offset, length, cols, rows)
        self.async_staging = bool(async_staging)
        self._stream = None                  # the staging CUDA stream
        self._inflight: deque = deque()      # _Staged, oldest first
        self._stage_wall = 0.0               # copy + routing wall
        self._wait_wall = 0.0                # producer blocked on a copy
        self._reported = False

    # -- staging (device -> host, tier 1) ---------------------------------
    def _bucket_ids(self, batch: Batch, key_names: List[str]):
        from .operators import hash_columns, umod
        return umod(hash_columns([batch.columns[n] for n in key_names],
                                 self.salt), self.k)

    def add(self, batch: Batch, key_names: List[str]) -> None:
        if self.device is None:
            self.device = batch.device
        for name, c in batch.columns.items():
            self.meta.setdefault(name, (c.dictionary, c.lazy))
        names, tensors = self._partitioned(
            batch, self._bucket_ids(batch, list(key_names)))
        if not (self.async_staging and batch.device.type == "cuda"):
            host = [t.cpu().numpy() for t in tensors]  # lint: allow-host-sync
            self._route(names, host)
            return
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=batch.device)
        stream = self._stream
        ready = torch.cuda.Event()
        ready.record()
        start = torch.cuda.Event(enable_timing=True)
        done = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(stream):
            stream.wait_event(ready)
            start.record(stream)
            host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    for t in tensors]
            for hb, t in zip(host, tensors):
                hb.copy_(t, non_blocking=True)
            done.record(stream)
        self._inflight.append(_Staged(names, host, tensors, start, done))
        while len(self._inflight) > _STAGING_DEPTH:
            self._retire()

    def _partitioned(self, batch: Batch, h) -> Tuple[list, list]:
        """(names, tensors), partitioned on the batch's device: the rows
        per bucket (K + 1 counts, dead rows last), then each column's
        values and (where present) NULL mask with the live rows grouped
        by bucket in a stable order, so a bucket keeps the batch's row
        order (the reference's per-bucket boolean selection)."""
        key = torch.where(batch.mask, h, torch.full_like(h, self.k))
        order = torch.argsort(key, stable=True)
        names = []
        tensors = [torch.bincount(key, minlength=self.k + 1)]
        for name, c in batch.columns.items():
            names.append((name, c.nulls is not None))
            tensors.append(c.values[order])
            if c.nulls is not None:
                tensors.append(c.nulls[order])
        return names, tensors

    def _retire(self) -> None:
        """Route the oldest in-flight copy once its event has completed
        (the producer's wait for it is metered)."""
        st = self._inflight.popleft()
        if not st.done.query():
            t0 = time.perf_counter()  # lint: allow-wall-clock
            st.done.synchronize()  # lint: allow-host-sync
            t1 = time.perf_counter()  # lint: allow-wall-clock
            self._wait_wall += t1 - t0
        self._stage_wall += st.start.elapsed_time(st.done) / 1e3
        arrays = [hb.numpy() for hb in st.host]
        t0 = time.perf_counter()  # lint: allow-wall-clock
        self._route(st.names, arrays)
        self._stage_wall += time.perf_counter() - t0  # lint: allow-wall-clock
        # the host buffers and the device sources go only now, after the
        # copy has completed
        st.host = st.source = None

    def _route(self, names, arrays) -> None:
        """Append each bucket's rows (a contiguous range of the
        partitioned arrays, copied out of the staging buffers)."""
        counts = arrays[0]
        cols_np = {}
        i = 1
        for name, has_nulls in names:
            v = arrays[i]
            i += 1
            m = None
            if has_nulls:
                m = arrays[i]
                i += 1
            cols_np[name] = (v, m)
        lo = 0
        for p in range(self.k):
            n = int(counts[p])
            if n == 0:
                continue
            hi = lo + n
            rows = {name: (v[lo:hi].copy(),
                           None if m is None else m[lo:hi].copy())
                    for name, (v, m) in cols_np.items()}
            lo = hi
            self.buckets[p].append(rows)
            self.rows[p] += n
            nb = sum(v.nbytes + (0 if m is None else m.nbytes)
                     for v, m in rows.values())
            self.bytes[p] += nb
            self.host_bytes[p] += nb
            self.spilled_bytes += nb
            MEMORY_METRICS.incr("spilled_bytes", nb)
            if self.pool is not None:
                self.pool.note_spill(nb)
        self._enforce_host_budget()

    def drain(self) -> None:
        """Route every in-flight copy and report the spill walls and the
        overlap fraction once.  Reads go through here, so every consumer
        sees fully staged buckets."""
        while self._inflight:
            self._retire()
        self._report_staging()

    def _report_staging(self) -> None:
        if self._reported or self.spilled_bytes == 0:
            return
        self._reported = True
        MEMORY_METRICS.incr("spill_wall_s", self._stage_wall)
        MEMORY_METRICS.incr("spill_wait_wall_s", self._wait_wall)
        if self.stats is not None:
            self.stats.add("spillBytes", self.spilled_bytes, "BYTE")
            if self.disk_bytes:
                self.stats.add("spillDiskBytes", self.disk_bytes, "BYTE")
            if self._stage_wall > 0:
                self.stats.add("spillStageWallNanos",
                               self._stage_wall * NANO, "NANO")
                self.stats.add("spillWaitWallNanos",
                               self._wait_wall * NANO, "NANO")
                self.stats.add(
                    "spillOverlapFraction",
                    max(0.0, 1.0 - self._wait_wall / self._stage_wall))

    # -- tier 2: disk overflow --------------------------------------------
    def _enforce_host_budget(self) -> None:
        if self.budget_bytes is None:
            return
        while sum(self.host_bytes) > self.budget_bytes:
            p = max(range(self.k), key=lambda i: self.host_bytes[i])
            if self.host_bytes[p] == 0 or not self._flush_bucket(p):
                raise MemoryExceededError(
                    f"spill store exceeds host budget "
                    f"{self.budget_bytes} bytes "
                    f"({sum(self.host_bytes)} staged) and no disk "
                    f"spill path is configured")

    def _open_disk(self):
        if self._disk_file is None:
            d = self.spill_path
            if d:
                os.makedirs(d, exist_ok=True)
            fd, self._disk_file = tempfile.mkstemp(
                prefix="presto-spill-", suffix=".bin", dir=d or None)
            os.close(fd)
        return open(self._disk_file, "ab")

    def _flush_bucket(self, p: int) -> bool:
        """Move bucket p's resident chunks to the disk file, in chunk
        order.  Without a spill path the system temp dir takes them."""
        if self.spill_path is None and self._disk_file is None:
            self.spill_path = tempfile.gettempdir()
        chunks, self.buckets[p] = self.buckets[p], []
        freed = self.host_bytes[p]
        self.host_bytes[p] = 0
        with self._open_disk() as f:
            for rows in chunks:
                offset = f.tell()
                payload, cols, nrows = _chunk_to_bytes(rows)
                f.write(payload)
                self._disk_records[p].append(
                    (offset, len(payload), cols, nrows))
                self.disk_bytes += len(payload)
                MEMORY_METRICS.incr("disk_spilled_bytes", len(payload))
                if self.pool is not None:
                    self.pool.note_disk_spill(len(payload))
        return freed > 0

    def _load_disk_chunks(self, p: int) -> List[dict]:
        records = self._disk_records[p]
        if not records:
            return []
        t0 = time.perf_counter()  # lint: allow-wall-clock
        out = []
        with open(self._disk_file, "rb") as f:
            for offset, length, cols, nrows in records:
                f.seek(offset)
                out.append(_chunk_from_bytes(f.read(length), cols, nrows))
                self.unspilled_bytes += length
                if self.pool is not None:
                    self.pool.note_unspill(length)
        wall = time.perf_counter() - t0  # lint: allow-wall-clock
        total = sum(r[1] for r in records)
        MEMORY_METRICS.incr("unspilled_bytes", total)
        MEMORY_METRICS.incr("unspill_wall_s", wall)
        if self.stats is not None:
            self.stats.add("unspillBytes", total, "BYTE")
            self.stats.add("unspillWallNanos", wall * NANO, "NANO")
        return out

    def bucket_chunks(self, p: int) -> List[dict]:
        """Bucket p's staged chunks in staging order, both tiers: the
        disk chunks (each flush took every resident chunk staged before
        it), then the resident ones."""
        self.drain()
        return self._load_disk_chunks(p) + self.buckets[p]

    def close(self) -> None:
        """Drop in-flight copies (after they complete), the staged rows
        and the disk file (idempotent)."""
        while self._inflight:
            done = self._inflight.popleft().done
            done.synchronize()  # lint: allow-host-sync
        self.buckets = [[] for _ in range(self.k)]
        if self._disk_file is not None:
            try:
                os.unlink(self._disk_file)
            except OSError:
                pass
            self._disk_file = None

    def __del__(self):
        try:
            if self._disk_file is not None:
                os.unlink(self._disk_file)
        except Exception:   # noqa: BLE001 -- best effort at teardown
            pass

    # -- reads (host -> device) -------------------------------------------
    def bucket_batches(self, p: int, capacity: int) -> Iterator[Batch]:
        """Bucket p as Batches of at most `capacity` rows on the store's
        device."""
        chunks = self.bucket_chunks(p)
        if not chunks:
            return
        device = self.device
        merged = {}
        for name in chunks[0]:
            vs = np.concatenate([c[name][0] for c in chunks])
            if any(c[name][1] is not None for c in chunks):
                ms = np.concatenate([
                    c[name][1] if c[name][1] is not None
                    else np.zeros(len(c[name][0]), dtype=bool)
                    for c in chunks])
            else:
                ms = None
            merged[name] = (vs, ms)
        total = self.rows[p]
        for lo in range(0, total, capacity):
            n = min(capacity, total - lo)
            cols = {}
            for name, (vs, ms) in merged.items():
                buf = np.zeros(capacity, dtype=vs.dtype)
                buf[:n] = vs[lo:lo + n]
                nulls = None
                if ms is not None:
                    nb = np.zeros(capacity, dtype=bool)
                    nb[:n] = ms[lo:lo + n]
                    nulls = torch.from_numpy(nb).to(device)
                dictionary, lazy = self.meta[name]
                cols[name] = Column(torch.from_numpy(buf).to(device), nulls,
                                    dictionary, lazy)
            mask = torch.arange(capacity, device=device) < n
            yield Batch(cols, mask)

    def bucket_rows(self, p: int) -> int:
        self.drain()
        return self.rows[p]

    def bucket_bytes(self, p: int) -> int:
        self.drain()
        return self.bytes[p]


# ---------------------------------------------------------------------------
# disk-chunk serde (the SerializedPage block framing, LZ4)
# ---------------------------------------------------------------------------

def _chunk_to_bytes(rows: Dict[str, Tuple[np.ndarray, Optional[np.ndarray]]]
                    ) -> Tuple[bytes, list, int]:
    """One staged chunk -> a length-prefixed LZ4-compressed SerializedPage
    plus its column descriptors.  Values ride as width-matched fixed-width
    blocks; NULL masks as their own byte channel, so the value bits of
    NULL rows survive the round trip."""
    from ..common import serde
    from ..common.block import FixedWidthBlock
    from ..common.page import Page
    blocks, cols = [], []
    nrows = 0
    for name in rows:
        v, m = rows[name]
        nrows = len(v)
        iv = _np_to_block_view(v)
        if iv is None:
            raise MemoryExceededError(
                f"column {name!r} dtype {v.dtype}/{v.ndim}d has no "
                f"fixed-width disk-spill encoding")
        blocks.append(FixedWidthBlock(iv))
        cols.append([name, v.dtype.str, m is not None])
        if m is not None:
            blocks.append(FixedWidthBlock(m.view(np.int8)))
    page = serde.serialize_page(Page(blocks, nrows), compress=True,
                                codec="LZ4")
    return struct.pack("<i", len(page)) + page, cols, nrows


def _chunk_from_bytes(payload: bytes, cols: list, nrows: int
                      ) -> Dict[str, Tuple[np.ndarray, Optional[np.ndarray]]]:
    from ..common import serde
    (plen,) = struct.unpack_from("<i", payload, 0)
    page, _ = serde.deserialize_page(payload[4:4 + plen], codec="LZ4")
    out: Dict[str, Tuple[np.ndarray, Optional[np.ndarray]]] = {}
    i = 0
    for name, dtype_str, has_nulls in cols:
        values = page.blocks[i].values.view(np.dtype(dtype_str))
        i += 1
        nulls = None
        if has_nulls:
            nulls = page.blocks[i].values.view(np.bool_)
            i += 1
        out[name] = (values, nulls)
    return out
