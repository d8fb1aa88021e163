"""Intra-task local exchange: repartition batches between pipelines
inside one task (the port of presto_tpu/exec/local_exchange.py).

The analog of Presto's LocalExchange (LocalExchange.java:62 with
PartitioningExchanger / BroadcastExchanger / round-robin) plus the
`task_concurrency` driver model (SqlTaskExecution.java:548 enqueues one
driver per split).  A "driver" is a Python thread draining one
sub-pipeline: torch launches are asynchronous, so threads overlap HOST
work (split staging, host string generation, page decoding) with the
device's work and with each other.  On a CUDA device every driver issues
its work on the consumer's current stream (`on_caller_stream`), so a
batch is written before the consumer's later work on that stream reads
it.

LocalExchange is the single producer/consumer mechanism: bounded queues,
producer-finished accounting, and a close() path that unblocks producers
when the consumer stops early (downstream LIMIT, cancellation, error) --
producers use timed puts and observe the stop flag, so no thread is left
blocked on a full queue.  background_drain and parallel_drain are thin
drivers over it.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Iterator, List, Optional

import torch

from . import operators as ops

# the HASH partitioning's salt (the reference's)
HASH_SALT = 0x10CA1


class LocalExchange:
    """Bounded multi-producer multi-consumer batch router.

    partitioning: "ROUND_ROBIN" | "HASH" | "BROADCAST".  HASH routes by
    key-hash % M (the reference's splitmix64 hash and unsigned remainder,
    emulated in int64), so consumers see disjoint key sets and a key goes
    to the same consumer as in the reference.

    Exceptions may be pushed as items; consumers re-raise them.  close()
    stops producers (their next push returns False) and drains the
    queues so a blocked producer wakes up."""

    _DONE = object()

    def __init__(self, n_consumers: int, partitioning: str = "ROUND_ROBIN",
                 keys: Optional[List[str]] = None, capacity: int = 4):
        self.n_consumers = n_consumers
        self.partitioning = partitioning
        self.keys = keys or []
        self.queues = [queue.Queue(maxsize=capacity)
                       for _ in range(n_consumers)]
        self._rr = 0
        self._lock = threading.Lock()
        self._producers = 0
        self._finished = False
        self._stop = threading.Event()

    # -- producer side ----------------------------------------------------
    def add_producer(self) -> None:
        with self._lock:
            self._producers += 1

    def producer_finished(self) -> None:
        with self._lock:
            self._producers -= 1
            if self._producers == 0 and not self._finished:
                self._finished = True
                for q in self.queues:
                    self._put(q, self._DONE)

    def _put(self, q: "queue.Queue", item) -> bool:
        """Timed put observing the stop flag; False = exchange closed."""
        while not self._stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def partition_of(self, batch):
        """Each row's HASH consumer (int64 device tensor)."""
        cols = [batch.columns[k] for k in self.keys]
        return ops.umod(ops.hash_columns(cols, HASH_SALT), self.n_consumers)

    def push(self, batch) -> bool:
        """Route one batch; returns False when the exchange was closed
        (the producer should stop draining its pipeline)."""
        if self.partitioning == "BROADCAST":
            ok = True
            for q in self.queues:
                ok = self._put(q, batch) and ok
            return ok
        if self.partitioning == "HASH" and self.keys:
            h = self.partition_of(batch)
            ok = True
            for p in range(self.n_consumers):
                ok = self._put(self.queues[p],
                               batch.with_mask(batch.mask & (h == p))) and ok
            return ok
        with self._lock:
            p = self._rr
            self._rr = (self._rr + 1) % self.n_consumers
        return self._put(self.queues[p], batch)

    # -- consumer side ----------------------------------------------------
    def consume(self, consumer: int) -> Iterator:
        q = self.queues[consumer]
        while True:
            item = q.get()
            if item is self._DONE:
                return
            if isinstance(item, BaseException):
                raise item
            yield item

    def close(self) -> None:
        """Consumer-side shutdown: stop producers and drain the queues so
        any producer blocked on a full queue wakes up and exits."""
        self._stop.set()
        for q in self.queues:
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break


def on_caller_stream(thunks: List[Callable[[], Iterator]],
                     device: torch.device) -> List[Callable[[], Iterator]]:
    """The thunks, each draining its iterator on `device` and on the
    CALLING thread's current CUDA stream (captured here), whatever
    thread drains it: torch's current device and stream are per thread,
    and a driver on a stream of its own would hand the consumer batches
    whose writes the consumer's stream does not wait for.  CPU thunks
    are returned as they are."""
    if device.type != "cuda":
        return list(thunks)
    stream = torch.cuda.current_stream(device)

    def wrap(thunk):
        def it():
            with torch.cuda.device(device), torch.cuda.stream(stream):
                yield from thunk()
        return it
    return [wrap(t) for t in thunks]


def background_drain(it: Iterator, wall_out: Optional[list] = None,
                     capacity: int = 4):
    """Drain `it` on a background thread, yielding items as they arrive.
    The producer's wall lands in wall_out[0] BEFORE the done signal, so
    a consumer that observed completion also observes the wall.  Closing
    the returned generator (early exit, cancellation) stops and unblocks
    the producer."""
    ex = LocalExchange(1, "ROUND_ROBIN", capacity=capacity)
    ex.add_producer()

    def producer():
        t0 = time.perf_counter()  # lint: allow-wall-clock
        try:
            for item in it:
                if not ex.push(item):
                    return
        except BaseException as e:     # relayed to the consumer
            ex.push(e)
        finally:
            if wall_out is not None:
                wall_out[0] = time.perf_counter() - t0  # lint: allow-wall-clock
            ex.producer_finished()

    threading.Thread(target=producer, daemon=True,
                     name="local-exchange-drain").start()

    def gen():
        try:
            yield from ex.consume(0)
        finally:
            ex.close()
    return gen()


def parallel_drain(sources: List[Callable[[], Iterator]],
                   concurrency: int, stats: Optional[dict] = None):
    """Drain `sources` (thunks returning batch iterators) on up to
    `concurrency` driver threads through one LocalExchange, yielding
    batches as they arrive (in no fixed order).

    Per-driver wall times land in stats["driver_walls"] (each written
    before its driver signals completion); sum(driver walls) - consumer
    wall > 0 is the measured overlap.  A driver's exception is re-raised
    in the consumer."""
    if concurrency <= 1 or len(sources) <= 1:
        for thunk in sources:
            yield from thunk()
        return
    n_threads = min(concurrency, len(sources))
    ex = LocalExchange(1, "ROUND_ROBIN", capacity=concurrency * 2)
    walls = [0.0] * len(sources)
    idx_q: "queue.Queue" = queue.Queue()
    for i in range(len(sources)):
        idx_q.put(i)

    def driver():
        while True:
            try:
                i = idx_q.get_nowait()
            except queue.Empty:
                return
            t0 = time.perf_counter()  # lint: allow-wall-clock
            try:
                for b in sources[i]():
                    if not ex.push(b):
                        return
            except BaseException as e:
                ex.push(e)
                return
            finally:
                walls[i] = time.perf_counter() - t0  # lint: allow-wall-clock

    for _ in range(n_threads):
        ex.add_producer()

    def run_driver():
        try:
            driver()
        finally:
            ex.producer_finished()

    threads = []
    for _ in range(n_threads):
        t = threading.Thread(target=run_driver, daemon=True,
                             name="local-exchange-driver")
        threads.append(t)
        t.start()
    try:
        yield from ex.consume(0)
    finally:
        ex.close()
        if stats is not None:
            # drivers observe the stop flag within one timed-put window;
            # join briefly so every wall entry is final before the snapshot
            for t in threads:
                t.join(timeout=1.0)
            stats["driver_walls"] = [round(w, 4) for w in walls]
