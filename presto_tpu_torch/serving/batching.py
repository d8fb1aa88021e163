"""Request micro-batcher for the serving plane (a host copy of
presto_tpu/serving/batching.py).

Collects concurrent EXECUTE..USING statements that target the same
prepared template (same canonical cache key) inside a bounded window and
hands them to `LocalQueryRunner.execute_prepared_batch` as ONE batched
drain — the inference-server batching pattern applied to point queries,
where the batch dimension is QPS itself.

Leader/follower protocol: the first arrival for a group key becomes the
leader, waits up to `window_ms` (cut short when `max_batch` lanes have
joined), closes the group, and runs the batch.  Followers block on
per-slot events.  Every slot whose batched result is unavailable — the
template is cold or ineligible, its binds failed, or the whole drain
errored — falls back to a SEQUENTIAL run on its own thread, so one
query's failure never fails its batchmates and a fallback never
serializes behind the leader.

Adaptive accumulation: while a drain for the same key is already
executing, the next group's leader holds its group open until that
drain completes (or the group fills) — under sustained load batch
occupancy converges on the offered concurrency instead of on however
many requests land inside one fixed window, exactly like continuous
batching in inference servers.  At low load the in-flight gate is
never taken and the fixed window is the only added latency.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

from .metrics import SERVING_METRICS

DEFAULT_BATCH_WINDOW_MS = 3.0
DEFAULT_MAX_BATCH_SIZE = 16


class _Slot:
    __slots__ = ("item", "result", "event", "batched")

    def __init__(self, item):
        self.item = item
        self.result = None
        self.event = threading.Event()
        self.batched = False    # joined a >=2-lane drain attempt


class _Group:
    __slots__ = ("slots", "full", "closed")

    def __init__(self):
        self.slots: List[_Slot] = []
        self.full = threading.Event()
        self.closed = False


class MicroBatcher:
    def __init__(self, window_ms: float = DEFAULT_BATCH_WINDOW_MS,
                 max_batch: int = DEFAULT_MAX_BATCH_SIZE):
        self.window_s = max(0.0, float(window_ms)) / 1000.0
        self.max_batch = int(max_batch)
        # plain mutex (not an OrderedLock): only guards the group map and
        # slot lists; nothing else is ever acquired under it
        self._lock = threading.Lock()
        self._groups: dict = {}
        # key -> event set when that key's executing drain finishes
        self._inflight: Dict[object, threading.Event] = {}

    @property
    def enabled(self) -> bool:
        return self.max_batch > 1

    def run(self, key, item, execute_batch: Callable, run_one: Callable):
        """Run `item` through the batcher.  `execute_batch(items)` must
        return a list aligned with its input — each entry a result or
        None (= run that item sequentially) — or None when no batch was
        possible at all.  `run_one(item)` is the sequential path; it is
        invoked on the CALLER's thread, so per-query errors propagate to
        the right request."""
        if not self.enabled:
            return run_one(item)
        with self._lock:
            g = self._groups.get(key)
            if (g is not None and not g.closed
                    and len(g.slots) < self.max_batch):
                slot = _Slot(item)
                g.slots.append(slot)
                if len(g.slots) >= self.max_batch:
                    g.full.set()
                leader = False
            else:
                g = _Group()
                slot = _Slot(item)
                g.slots.append(slot)
                self._groups[key] = g
                leader = True

        if leader:
            g.full.wait(self.window_s)
            with self._lock:
                prev = self._inflight.get(key)
            if prev is not None and not g.full.is_set():
                # adaptive accumulation: a drain for this key is on the
                # device right now — keep the group open until it
                # finishes (or this group fills), so the next launch
                # carries everyone who arrived meanwhile.  Bounded: a
                # wedged drain must not serialize this group forever.
                prev.wait(120.0)
                g.full.wait(self.window_s)
            with self._lock:
                g.closed = True
                if self._groups.get(key) is g:
                    del self._groups[key]
                slots = list(g.slots)
                done = None
                if len(slots) > 1:
                    done = threading.Event()
                    self._inflight[key] = done
            results: Optional[list] = None
            if len(slots) > 1:
                for s in slots:
                    s.batched = True
                try:
                    results = execute_batch([s.item for s in slots])
                except Exception:   # noqa: BLE001 — isolate to fallbacks
                    results = None
                finally:
                    done.set()
                    with self._lock:
                        if self._inflight.get(key) is done:
                            del self._inflight[key]
            for i, s in enumerate(slots):
                s.result = results[i] if results is not None else None
                if s is not slot:
                    s.event.set()
        else:
            # generous ceiling over the window: the leader may be waiting
            # out an in-flight drain (<=120s) and then running a cold
            # compile; a lost leader (process-fatal error paths) must not
            # wedge followers forever
            slot.event.wait(self.window_s + 300.0)

        if slot.result is None:
            if slot.batched:
                SERVING_METRICS.incr("serving_batch_fallbacks")
            return run_one(item)
        return slot.result
