"""Durable spooled exchange storage for fault-tolerant execution
(retry-policy=task).

The analog of the reference's fault-tolerant execution exchange
(presto-main/.../exchange/LocalFileSystemExchangeStorage and the
spooling OutputBuffer written for retry-policy=TASK): every page a
stage produces is staged DURABLY before the producer acknowledges it,
and the spool outlives the producing task — a consumer (or a retried
consumer attempt) replays any token range long after the producer
finished, and a failed task can be retried ALONE because its inputs
still exist.

Built as a composition over the PR 15 two-tier spill design rather
than a new storage engine:

- tier 1 is host RAM: pages are LZ4-compressed on append and staged in
  memory, charged REVOCABLE to the owning task's MemoryContext, so the
  PR 15 arbitrator sees them and can reclaim them under pool pressure
  through the registered revoke callback;
- tier 2 is an append-only LZ4 block file under `spool.path` (falling
  back to `spill.path`, then the system temp dir) using the same
  length-prefixed record framing as the retained-buffer spill: staged
  pages overflow to it when the staging budget fills, when the
  arbitrator revokes, or when the worker begins a graceful drain
  (`flush()` — the block file survives the process exit).

Reads are token-indexed and tier-transparent: a record is decompressed
from RAM if still staged, else pread back from the block file, so the
exchange client's existing token-resume protocol needs no new wire
surface.
"""
from __future__ import annotations

import os
import re
import struct
import tempfile
import time
from typing import Dict, List, Optional

from ..common.compression import compress, decompress
from ..common.locks import OrderedLock

DEFAULT_STAGING_BUDGET_BYTES = 16 << 20

_SAFE_ID = re.compile(r"[^A-Za-z0-9._-]+")


class SpoolMetrics:
    """Process-wide spool counters (the /v1/metrics presto_tpu_spool_*
    section, same singleton shape as ExchangeMetrics/MemoryMetrics)."""

    _COUNTERS = ("spooled_pages", "spooled_bytes", "spooled_raw_bytes",
                 "disk_bytes", "read_pages", "read_bytes", "flushes",
                 "spools_opened", "spools_released", "spool_wall_s")
    _GAUGES = ("staged_bytes",)

    def __init__(self):
        # rank 100: metrics registries are leaf locks
        self._lock = OrderedLock("metrics:spool", 100)  # lint: guarded-by(_lock)
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
            return {name: getattr(self, name)
                    for name in self._COUNTERS + self._GAUGES}


SPOOL_METRICS = SpoolMetrics()


class TaskSpool:
    """Durable page store for ONE task's output buffers.

    `append` returns only once the page is durably staged (compressed in
    host RAM charged revocable, or already on disk) — that return is the
    producer's acknowledgement point under retry-policy=task.  Records
    are retained past task completion until `close()` (query release or
    task eviction); `flush()` forces every staged record to the block
    file so a draining worker's spool survives its exit."""

    def __init__(self, task_id: str, n_buffers: int,
                 spool_dir: Optional[str] = None, memory=None,
                 staging_budget_bytes: int = DEFAULT_STAGING_BUDGET_BYTES):
        self.task_id = task_id
        self._dir = spool_dir or tempfile.gettempdir()
        self._memory = memory
        self._budget = max(0, int(staging_budget_bytes))
        # reentrant: append -> _charge_locked -> _flush_locked re-enters;
        # rank 32 sits between the output buffer (30) and the pool (40)
        self._lock = OrderedLock(
            "task-spool", 32, reentrant=True)  # lint: guarded-by(_lock)
        # token t of buffer b -> [raw_len, compressed_len, ram|None, offset]
        self._records: Dict[int, List[list]] = \
            {b: [] for b in range(max(1, n_buffers))}
        self._staged_bytes = 0            # compressed bytes resident in RAM
        self._spooled_bytes = 0           # cumulative raw bytes appended
        self._holder = None               # lazy revocable registration
        self._fd: Optional[int] = None
        self._path: Optional[str] = None
        self._end = 0                     # block-file append offset
        self._closed = False
        SPOOL_METRICS.incr("spools_opened")

    # -- producer side ----------------------------------------------------
    def append(self, buffer_id: int, data: bytes) -> int:
        """Durably stage one serialized page; returns its token."""
        t0 = time.perf_counter()
        cp = compress("LZ4", data)
        with self._lock:
            if self._closed:
                raise BufferError(f"spool for task {self.task_id} released")
            rec = [len(data), len(cp), cp, -1]
            self._records[buffer_id].append(rec)
            token = len(self._records[buffer_id]) - 1
            self._staged_bytes += len(cp)
            self._spooled_bytes += len(data)
            self._charge_locked(len(cp))
            if self._budget and self._staged_bytes > self._budget:
                self._flush_locked()
        SPOOL_METRICS.incr("spooled_pages")
        SPOOL_METRICS.incr("spooled_bytes", len(cp))
        SPOOL_METRICS.incr("spooled_raw_bytes", len(data))
        SPOOL_METRICS.incr("staged_bytes", len(cp))
        SPOOL_METRICS.incr("spool_wall_s", time.perf_counter() - t0)
        return token

    def _charge_locked(self, nb: int) -> None:
        if self._memory is None or nb <= 0:
            return
        if self._holder is None:
            self._holder = self._memory.register_revocable(
                "spool", self._revoke)
        if not self._holder.try_reserve(nb, arbitrate=False):
            # no revocable headroom: give the staged prefix to disk now
            # (self-spill, same discipline as the retained output buffer)
            self._flush_locked()

    def _revoke(self) -> int:
        """Arbitrator callback: flush every staged record to the block
        file.  Never blocks — a contended spool declines this pass."""
        if not self._lock.acquire(timeout=0.05):
            return 0
        try:
            return self._flush_locked()
        finally:
            self._lock.release()

    def _open_disk_locked(self) -> int:
        if self._fd is None:
            os.makedirs(self._dir, exist_ok=True)
            safe = _SAFE_ID.sub("_", self.task_id)[:80]
            self._fd, self._path = tempfile.mkstemp(
                prefix=f"presto-spool-{safe}-", suffix=".spool",
                dir=self._dir)
        return self._fd

    def _flush_locked(self) -> int:
        """Move every RAM-staged record to the block file (length-prefixed
        LZ4 records, append order) and free the revocable charge."""
        if self._closed:
            return 0
        chunks, freed = [], 0
        base = None
        for recs in self._records.values():
            for rec in recs:
                if rec[2] is None:
                    continue
                if base is None:
                    base = self._end
                rec[3] = self._end + 4
                chunks.append(struct.pack("<i", rec[1]) + rec[2])
                self._end += 4 + rec[1]
                freed += rec[1]
                rec[2] = None
        if not chunks:
            return 0
        os.pwrite(self._open_disk_locked(), b"".join(chunks), base)
        self._staged_bytes -= freed
        if self._holder is not None:
            self._holder.free(freed)
        from ..exec.memory import MEMORY_METRICS
        MEMORY_METRICS.incr("spilled_bytes", freed)
        MEMORY_METRICS.incr("disk_spilled_bytes", freed)
        if self._memory is not None:
            self._memory.note_spill(freed)
            self._memory.note_disk_spill(freed)
        SPOOL_METRICS.incr("flushes")
        SPOOL_METRICS.incr("disk_bytes", freed)
        SPOOL_METRICS.incr("staged_bytes", -freed)
        return freed

    def flush(self) -> int:
        """Force-stage everything to the block file (graceful drain: the
        spool must survive the process exit).  Returns bytes flushed."""
        with self._lock:
            return self._flush_locked()

    # -- consumer side ----------------------------------------------------
    def page_count(self, buffer_id: int) -> int:
        with self._lock:
            return len(self._records.get(buffer_id, ()))

    def read(self, buffer_id: int, token: int) -> bytes:
        """One page back, tier-transparently (RAM decompress or disk
        pread).  IndexError past the appended range."""
        with self._lock:
            rec = self._records[buffer_id][token]
            raw_len, clen, ram, offset = rec
            payload = ram if ram is not None \
                else os.pread(self._fd, clen, offset)
        data = decompress("LZ4", payload, raw_len)
        SPOOL_METRICS.incr("read_pages")
        SPOOL_METRICS.incr("read_bytes", raw_len)
        if ram is None:
            from ..exec.memory import MEMORY_METRICS
            MEMORY_METRICS.incr("unspilled_bytes", raw_len)
            if self._memory is not None:
                self._memory.note_unspill(raw_len)
        return data

    # -- accounting / lifecycle -------------------------------------------
    @property
    def spooled_bytes(self) -> int:
        """Cumulative raw page bytes appended (TaskInfo spooledBytes)."""
        with self._lock:
            return self._spooled_bytes

    @property
    def staged_bytes(self) -> int:
        with self._lock:
            return self._staged_bytes

    @property
    def disk_path(self) -> Optional[str]:
        with self._lock:
            return self._path

    def close(self) -> None:
        """Release everything (query done / task evicted): free the
        revocable charge, drop staged pages, unlink the block file."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            if self._staged_bytes:
                SPOOL_METRICS.incr("staged_bytes", -self._staged_bytes)
            self._staged_bytes = 0
            self._records = {}
            if self._holder is not None:
                self._holder.close()
                self._holder = None
            if self._fd is not None:
                try:
                    os.close(self._fd)
                    os.unlink(self._path)
                except OSError:
                    pass
                self._fd = None
        SPOOL_METRICS.incr("spools_released")
