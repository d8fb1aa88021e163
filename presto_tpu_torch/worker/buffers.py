"""Task output buffers with the token-acknowledge pull protocol.

The analog of the reference's OutputBuffer family
(presto-main-base/.../execution/buffer/PartitionedOutputBuffer.java,
BroadcastOutputBuffer.java) and the results endpoint semantics of
TaskResource (presto-main/.../server/TaskResource.java:256-308): a consumer
GETs /results/{bufferId}/{token}, pages at sequence numbers >= token are
returned, an acknowledge GET frees everything below the new token, and a
complete flag tells the consumer the stream is finished.
"""
from __future__ import annotations

import os
import struct
import tempfile
from typing import List, Optional, Tuple

from ..common.compression import compress, decompress
from ..common.locks import OrderedCondition


DEFAULT_MAX_BUFFERED_BYTES = 64 << 20


class PageBuffer:
    """One buffer id: an append-only sequence of serialized pages with
    client-driven compaction and producer backpressure (the reference's
    OutputBufferMemoryManager bounds buffered bytes and blocks the
    producer; acknowledges free memory and unblock it).

    With `retain=True` (fault-tolerant streaming: remote task retry
    enabled) acknowledged pages stay resident instead of being freed, so
    a RESTARTED consumer task can replay the stream from token 0 exactly
    — the streaming analog of the batch scheduler's durable shuffle
    files, paid in buffer memory.  Backpressure still counts only
    UNacknowledged bytes, matching the non-retain threshold behavior.

    With a `memory` context the retained (acknowledged) bytes are charged
    to the owning task as a REVOCABLE reservation — they were previously
    invisible to every pool — and the arbitrator can reclaim them by
    spilling the acknowledged prefix to an LZ4-compressed disk file
    (`revoke_to_disk`); a replaying consumer transparently reads spilled
    pages back.  The charge uses arbitrate=False + self-spill because it
    runs under this buffer's own condition lock (see
    RevocableHolder.try_reserve).

    With a `spool` (retry-policy=task: worker/spooling.TaskSpool) the
    buffer stores NOTHING itself: every page is durably staged in the
    spool before add() returns (the producer's acknowledgement point),
    gets replay token-indexed from the spool, and the consumer's
    end-of-stream DELETE only marks the stream consumed — the spool
    outlives both the task and this buffer, released by destroy_all().
    Durability decouples producer and consumer lifetimes, so spool mode
    has no consumer backpressure: resident bytes are bounded by the
    spool's revocable staging budget and its disk tier instead."""

    def __init__(self, max_buffered_bytes: int = DEFAULT_MAX_BUFFERED_BYTES,
                 retain: bool = False, coalesce_target_bytes: int = 0,
                 memory=None, spill_dir: Optional[str] = None,
                 spool=None, buffer_id: int = 0):
        self._spool = spool
        self._buffer_id = buffer_id
        self._spool_count = 0             # pages appended to the spool
        self._client_released = False     # consumer DELETE seen (drain gate)
        self._pages: List[bytes] = []
        self._base = 0                    # sequence number of _pages[0]
        self._bytes = 0                   # UNacknowledged bytes (backpressure)
        self._max_bytes = max_buffered_bytes
        self._retain = retain
        self._acked = 0                   # retain mode: acknowledge watermark
        self._memory = memory             # task MemoryContext (or pool)
        self._holder = None               # lazy revocable registration
        self._spill_dir = spill_dir
        self._disk_fd: Optional[int] = None
        self._disk_path: Optional[str] = None
        # token t (t < _base) -> (offset, compressed_len, raw_len)
        self._disk_records: List[Tuple[int, int, int]] = []
        self._disk_end = 0                # file append offset
        # coalescing (exchange.max-response-size): small serialized pages
        # accumulate in _pending until ~target bytes, then flush as ONE
        # buffer entry so tiny-page stages stop paying a pull round trip
        # per page.  SerializedPages are self-delimiting, so concatenation
        # is transparent to every consumer.  A get() that would otherwise
        # wait flushes first — coalescing never withholds available data.
        self._coalesce_target = max(0, int(coalesce_target_bytes))
        self._pending: List[bytes] = []
        self._pending_bytes = 0
        self._complete = False
        self._destroyed = False
        self._error: Optional[str] = None
        # rank 30: nests INTO the task spool (32) on _store_locked and
        # the memory pool (40) on the retained-page charge; acquired
        # UNDER the arbitrator (20) in _revoke
        self._cond = OrderedCondition(
            "output-buffer", 30)  # lint: guarded-by(_cond)

    def _store_locked(self, data: bytes) -> None:
        if self._spool is not None:
            self._spool.append(self._buffer_id, data)  # durable before return
            self._spool_count += 1
        else:
            self._pages.append(data)

    def _end_locked(self) -> int:
        return (self._spool_count if self._spool is not None
                else self._base + len(self._pages))

    def _flush_pending_locked(self) -> None:
        if self._pending:
            self._store_locked(b"".join(self._pending))
            self._pending = []
            self._pending_bytes = 0
            self._cond.notify_all()

    def add(self, page_bytes: bytes) -> None:
        with self._cond:
            while (self._spool is None and self._bytes >= self._max_bytes
                   and not self._destroyed and self._error is None):
                self._cond.wait(1.0)
            if self._destroyed:
                return
            if self._spool is None:
                self._bytes += len(page_bytes)  # pending counts toward limit
            if self._coalesce_target > 0:
                self._pending.append(page_bytes)
                self._pending_bytes += len(page_bytes)
                if self._pending_bytes >= self._coalesce_target:
                    self._flush_pending_locked()
                else:
                    # wake a parked long-poll getter: a caught-up consumer
                    # demand-flushes rather than sleeping out its maxWait
                    self._cond.notify_all()
            else:
                self._store_locked(page_bytes)
                self._cond.notify_all()

    def set_complete(self) -> None:
        with self._cond:
            self._flush_pending_locked()  # flush boundaries are now final:
            self._complete = True         # replay after retry is identical
            self._cond.notify_all()

    def set_error(self, message: str) -> None:
        with self._cond:
            self._error = message
            self._complete = True
            self._cond.notify_all()

    def get(self, token: int, max_wait_s: float,
            max_bytes: Optional[int] = None
            ) -> Tuple[List[bytes], int, bool]:
        """Pages from `token` on; blocks up to max_wait_s for data.
        Returns (pages, next_token, buffer_complete).  `max_bytes` caps the
        response size (always at least one page) — the consumer's
        X-Presto-Max-Size.  Raises on task failure (propagates the
        producer's error to the consumer)."""
        deadline = None
        with self._cond:
            while True:
                if self._error is not None:
                    raise BufferError(self._error)
                end = self._end_locked()
                if token >= end and self._pending:
                    # the consumer caught up to the coalescer: flush the
                    # partial batch rather than make it wait for more data
                    self._flush_pending_locked()
                    end = self._end_locked()
                if token < end or self._complete:
                    if self._spool is not None:
                        # token-indexed replay straight from the durable
                        # spool (RAM-staged or disk, tier-transparent)
                        pages, size, t = [], 0, max(0, token)
                        while t < end:
                            p = self._spool.read(self._buffer_id, t)
                            if (pages and max_bytes is not None
                                    and size + len(p) > max_bytes):
                                break
                            pages.append(p)
                            size += len(p)
                            t += 1
                        next_token = t if pages else token
                        at_end = self._complete and next_token >= end
                        return pages, next_token, at_end
                    if self._retain and 0 <= token < self._base:
                        # replaying consumer asked for pages already
                        # revoked to disk: read them back transparently
                        pages = (self._read_spilled_locked(token)
                                 + self._pages)
                        first = token
                    else:
                        pages = self._pages[max(0, token - self._base):]
                        first = max(token, self._base)
                    if max_bytes is not None and len(pages) > 1:
                        taken, size = [], 0
                        for p in pages:
                            if taken and size + len(p) > max_bytes:
                                break
                            taken.append(p)
                            size += len(p)
                        pages = taken
                    next_token = first + len(pages)
                    at_end = self._complete and next_token >= end
                    return pages, next_token, at_end
                import time
                if deadline is None:
                    deadline = time.monotonic() + max_wait_s
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return [], token, False
                self._cond.wait(remaining)

    def acknowledge(self, token: int) -> None:
        with self._cond:
            if self._spool is not None:
                # spooled pages are never freed by acks (a retried consumer
                # replays from 0); just track consumption for the drain gate
                self._acked = max(self._acked, min(token, self._spool_count))
                self._cond.notify_all()
                return
            if self._retain:
                # advance the watermark and release backpressure, but keep
                # the pages for replay by a retried consumer — now CHARGED
                # to the task's memory context as revocable bytes
                upto = max(self._acked,
                           min(token, self._base + len(self._pages)))
                if upto > self._acked:
                    newly = sum(
                        len(p) for p in
                        self._pages[self._acked - self._base:
                                    upto - self._base])
                    self._bytes -= newly
                    self._acked = upto
                    self._charge_retained_locked(newly)
                    self._cond.notify_all()
                return
            drop = max(0, min(token - self._base, len(self._pages)))
            if drop:
                self._bytes -= sum(len(p) for p in self._pages[:drop])
                self._pages = self._pages[drop:]
                self._base += drop
                self._cond.notify_all()  # unblock a backpressured producer

    # -- retained-page memory charge + disk revocation ---------------------
    def _charge_retained_locked(self, nb: int) -> None:
        if self._memory is None or nb <= 0:
            return
        if self._holder is None:
            self._holder = self._memory.register_revocable(
                "output-buffer", self._revoke)
        if not self._holder.try_reserve(nb, arbitrate=False):
            # no headroom for the retained pages: give them to disk now
            # (self-spill) rather than fail a fault-tolerance feature
            self._spill_acked_locked()

    def _revoke(self) -> int:
        """Arbitrator callback: spill the acknowledged prefix to disk.
        Never blocks — if the buffer lock is contended, decline."""
        if not self._cond.acquire(timeout=0.05):
            return 0
        try:
            return self._spill_acked_locked()
        finally:
            self._cond.release()

    def _spill_acked_locked(self) -> int:
        """Write pages [_base, _acked) as length-prefixed LZ4 records,
        advance _base, and free their revocable charge.  Returns bytes
        freed."""
        n = self._acked - self._base
        if n <= 0 or self._destroyed:
            return 0
        if self._disk_fd is None:
            d = self._spill_dir or tempfile.gettempdir()
            os.makedirs(d, exist_ok=True)
            self._disk_fd, self._disk_path = tempfile.mkstemp(
                prefix="presto-tpu-buffer-", suffix=".spill", dir=d)
        freed = 0
        chunks = []
        for p in self._pages[:n]:
            cp = compress("LZ4", p)
            self._disk_records.append((self._disk_end + 4, len(cp), len(p)))
            chunks.append(struct.pack("<i", len(cp)) + cp)
            self._disk_end += 4 + len(cp)
            freed += len(p)
        os.pwrite(self._disk_fd, b"".join(chunks),
                  self._disk_records[-n][0] - 4)
        self._pages = self._pages[n:]
        self._base = self._acked
        if self._holder is not None:
            self._holder.free(freed)
        from ..exec.memory import MEMORY_METRICS
        MEMORY_METRICS.incr("spilled_bytes", freed)
        MEMORY_METRICS.incr("disk_spilled_bytes", freed)
        if self._memory is not None:
            self._memory.note_spill(freed)
            self._memory.note_disk_spill(freed)
        return freed

    def _read_spilled_locked(self, token: int) -> List[bytes]:
        """Replay path: pages [token, _base) back from the spill file."""
        out = []
        for off, clen, rawlen in self._disk_records[token:self._base]:
            out.append(decompress("LZ4", os.pread(self._disk_fd, clen, off),
                                  rawlen))
        if out:
            from ..exec.memory import MEMORY_METRICS
            MEMORY_METRICS.incr("unspilled_bytes", sum(len(p) for p in out))
            if self._memory is not None:
                self._memory.note_unspill(sum(len(p) for p in out))
        return out

    @property
    def retained_bytes(self) -> int:
        return 0 if self._holder is None else self._holder.bytes

    @property
    def spilled_tokens(self) -> int:
        return self._base if self._retain else 0

    @property
    def consumed(self) -> bool:
        """True once the consumer is definitively done with this stream:
        acked (or DELETEd) through end-of-stream, errored, or destroyed.
        The graceful-drain gate — a SHUTTING_DOWN worker may only exit
        after every buffer it produced has been consumed."""
        with self._cond:
            if (self._destroyed or self._error is not None
                    or self._client_released):
                return True
            if not self._complete:
                return False
            if self._retain or self._spool is not None:
                return self._acked >= self._end_locked()
            return not self._pages and not self._pending

    def destroy(self, force: bool = True) -> None:
        # a retained/spooled buffer survives the consumer's end-of-stream
        # DELETE (a retried consumer may still need to replay it); only
        # task teardown (cancel/evict -> destroy_all) reclaims it.  The
        # DELETE still marks the stream consumed for the drain gate.
        with self._cond:
            if not force and (self._retain or self._spool is not None):
                self._client_released = True
                self._cond.notify_all()
                return
            self._pages = []
            self._pending = []
            self._pending_bytes = 0
            self._bytes = 0
            self._complete = True
            self._destroyed = True
            if self._holder is not None:
                self._holder.close()   # frees the retained charge
                self._holder = None
            if self._disk_fd is not None:
                try:
                    os.close(self._disk_fd)
                    os.unlink(self._disk_path)
                except OSError:
                    pass
                self._disk_fd = None
                self._disk_records = []
            self._cond.notify_all()


class OutputBufferManager:
    """All buffers of one task.  PARTITIONED routes page partition p to
    buffer p; BROADCAST replicates every page into each consumer's buffer."""

    def __init__(self, buffer_type: str, n_buffers: int,
                 retain: bool = False, coalesce_target_bytes: int = 0,
                 memory=None, spill_dir: Optional[str] = None, spool=None):
        self.buffer_type = buffer_type
        self.spool = spool                # shared TaskSpool (or None)
        self.buffers = [PageBuffer(retain=retain,
                                   coalesce_target_bytes=coalesce_target_bytes,
                                   memory=memory, spill_dir=spill_dir,
                                   spool=spool, buffer_id=i)
                        for i in range(max(1, n_buffers))]

    @property
    def retained_bytes(self) -> int:
        return sum(b.retained_bytes for b in self.buffers)

    @property
    def spooled_bytes(self) -> int:
        """Cumulative raw bytes durably spooled (TaskInfo spooledBytes)."""
        return 0 if self.spool is None else self.spool.spooled_bytes

    def flush_spool(self) -> int:
        """Graceful drain: force the spool's staged pages onto disk so the
        output survives this process exiting."""
        return 0 if self.spool is None else self.spool.flush()

    def all_consumed(self) -> bool:
        """Every buffer acked/DELETEd through end-of-stream (drain gate)."""
        return all(b.consumed for b in self.buffers)

    def add(self, partition: int, page_bytes: bytes) -> None:
        if self.buffer_type == "BROADCAST":
            for b in self.buffers:
                b.add(page_bytes)
        else:
            self.buffers[partition].add(page_bytes)

    def set_complete(self) -> None:
        for b in self.buffers:
            b.set_complete()

    def set_error(self, message: str) -> None:
        for b in self.buffers:
            b.set_error(message)

    def get(self, buffer_id: int, token: int, max_wait_s: float,
            max_bytes: Optional[int] = None):
        return self.buffers[buffer_id].get(token, max_wait_s,
                                           max_bytes=max_bytes)

    def acknowledge(self, buffer_id: int, token: int) -> None:
        self.buffers[buffer_id].acknowledge(token)

    def destroy(self, buffer_id: int) -> None:
        # consumer-driven destroy: honored immediately unless retained
        self.buffers[buffer_id].destroy(force=False)

    def destroy_all(self) -> None:
        for b in self.buffers:
            b.destroy(force=True)
        if self.spool is not None:
            self.spool.close()
