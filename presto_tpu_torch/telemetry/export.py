"""The telemetry export pipeline: bounded queue -> background flush
thread -> pluggable sink.

Design contract (the acceptance bar for this subsystem):

  * the query path NEVER blocks on telemetry: enqueue is put_nowait on a
    bounded queue; when the sink cannot keep up, payloads are DROPPED and
    the drop is metered (`dropped`), exactly like the reference's
    query-completion event queue under load.
  * delivery failures retry with the exchange client's exponential-backoff + full-
    jitter error budget (worker/exchange.py _backoff): transient sink
    outages are absorbed, a sink dead past `max_error_duration_s` drops
    the payload (`dropped_after_retry`) instead of wedging the flush
    thread forever.
  * sinks are pluggable: JSONL file (ops spool), HTTP OTLP-JSON (a real
    collector's /v1/traces + /v1/metrics), and an in-process collector
    for tests/e2e assertions.
"""
from __future__ import annotations

import json
import queue
import random
import threading
import time
from typing import Callable, Dict, List, Optional

from ..common.locks import OrderedCondition, OrderedLock
from .otlp import (metrics_to_resource_metrics, scrape_metric_points,
                   spans_to_resource_spans)

_BACKOFF_BASE_S = 0.05
_BACKOFF_CAP_S = 2.0


class TelemetrySink:
    """SPI: receives OTLP-shaped payload dicts (one export call per
    batch item).  Implementations must be thread-safe enough for ONE
    flush thread plus close()."""

    def export(self, payload: dict) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class CollectorSink(TelemetrySink):
    """In-process collector for tests: keeps every payload, with helpers
    that answer the questions e2e tests ask (which trace ids arrived,
    which spans, which metric names)."""

    def __init__(self):
        # rank 74: sink locks are taken by the flush thread holding nothing
        self._lock = OrderedLock("telemetry-sink", 74)  # lint: guarded-by(_lock)
        self.payloads: List[dict] = []

    def export(self, payload: dict) -> None:
        with self._lock:
            self.payloads.append(payload)

    def spans(self) -> List[dict]:
        with self._lock:
            snap = list(self.payloads)
        out = []
        for p in snap:
            for rs in p.get("resourceSpans", []):
                for ss in rs.get("scopeSpans", []):
                    out.extend(ss.get("spans", []))
        return out

    def trace_ids(self) -> List[str]:
        return sorted({s["traceId"] for s in self.spans()})

    def metric_names(self) -> List[str]:
        with self._lock:
            snap = list(self.payloads)
        names = set()
        for p in snap:
            for rm in p.get("resourceMetrics", []):
                for sm in rm.get("scopeMetrics", []):
                    names.update(m["name"] for m in sm.get("metrics", []))
        return sorted(names)


class JsonlFileSink(TelemetrySink):
    """One JSON payload per line, append-only (the ops spool shape the
    FileEventListener uses for query events)."""

    def __init__(self, path: str):
        self.path = path
        self._lock = OrderedLock("telemetry-sink", 74)  # lint: guarded-by(_lock)

    def export(self, payload: dict) -> None:
        line = json.dumps(payload, default=str)
        with self._lock:
            with open(self.path, "a") as f:
                f.write(line + "\n")


class HttpOtlpSink(TelemetrySink):
    """POST OTLP-JSON to a collector endpoint: trace payloads go to
    {endpoint}/v1/traces, metric payloads to {endpoint}/v1/metrics (the
    OTLP/HTTP default paths)."""

    def __init__(self, endpoint: str, timeout_s: float = 5.0):
        self.endpoint = endpoint.rstrip("/")
        self.timeout_s = timeout_s

    def export(self, payload: dict) -> None:
        import urllib.request
        path = ("/v1/traces" if "resourceSpans" in payload
                else "/v1/metrics")
        req = urllib.request.Request(
            self.endpoint + path,
            data=json.dumps(payload, default=str).encode(),
            headers={"Content-Type": "application/json"},
            method="POST")
        with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
            resp.read()


def make_sink(kind: str, endpoint: str = "",
              path: str = "") -> Optional[TelemetrySink]:
    """telemetry.sink property -> sink instance (None disables export)."""
    kind = (kind or "none").lower()
    if kind in ("", "none", "off"):
        return None
    if kind == "jsonl":
        if not path:
            raise ValueError("telemetry.sink=jsonl needs telemetry.path")
        return JsonlFileSink(path)
    if kind in ("http", "otlp"):
        if not endpoint:
            raise ValueError(
                "telemetry.sink=http needs telemetry.otlp-endpoint")
        return HttpOtlpSink(endpoint)
    if kind == "collector":
        return CollectorSink()
    raise ValueError(f"unknown telemetry.sink {kind!r}; "
                     "expected none|jsonl|http|collector")


class TelemetryExporter:
    """Bounded batching exporter.

    enqueue() is wait-free for callers; a daemon flush thread drains the
    queue every `flush_interval_s` (or immediately when woken by
    flush()/close()) and delivers each payload through the sink with the
    budgeted-backoff retry loop.  `metrics_interval_s` > 0 additionally
    self-scrapes the process metric registries into OTLP gauge payloads
    on that period."""

    def __init__(self, sink: TelemetrySink, queue_bound: int = 256,
                 flush_interval_s: float = 0.2,
                 max_error_duration_s: float = 10.0,
                 metrics_interval_s: float = 0.0,
                 resource: Optional[dict] = None):
        if queue_bound <= 0:
            raise ValueError("queue_bound must be positive")
        self._sink = sink
        self._queue: "queue.Queue[dict]" = queue.Queue(maxsize=queue_bound)
        self.queue_bound = queue_bound
        self.flush_interval_s = flush_interval_s
        self.max_error_duration_s = max_error_duration_s
        self.metrics_interval_s = metrics_interval_s
        self.resource = dict(resource or {})
        # counters (exported via counters() into /v1/metrics)
        self._clock = 0
        self.enqueued = 0                # lint: guarded-by(_lock)
        self.exported = 0                # lint: guarded-by(_lock)
        self.dropped = 0                 # lint: guarded-by(_lock)
        self.dropped_after_retry = 0     # lint: guarded-by(_lock)
        self.retries = 0                 # lint: guarded-by(_lock)
        self.export_errors = 0           # lint: guarded-by(_lock)
        self.flushes = 0                 # lint: guarded-by(_lock)
        # rank 70: counter lock; the idle condition (72) is never held
        # while taking it, and neither nests into engine locks
        self._lock = OrderedLock("telemetry-exporter", 70)
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._idle = OrderedCondition("telemetry-idle", 72)
        self._in_flight = 0              # lint: guarded-by(_idle)
        self._thread = threading.Thread(
            target=self._flush_loop, name="telemetry-flush", daemon=True)
        self._thread.start()

    # -- producer side (query path: must never block) ----------------------

    def enqueue(self, payload: dict) -> bool:
        try:
            self._queue.put_nowait(payload)
        except queue.Full:
            with self._lock:
                self.dropped += 1
            return False
        with self._lock:
            self.enqueued += 1
        return True

    def export_spans(self, trace_token: str, spans,
                     resource: Optional[dict] = None) -> bool:
        """Convert one process's span slice for `trace_token` and queue
        it.  `resource` augments the exporter-level resource attributes
        (service.name etc.)."""
        spans = list(spans)
        if not spans:
            return True
        merged = dict(self.resource)
        merged.update(resource or {})
        return self.enqueue(
            spans_to_resource_spans(trace_token, spans, merged))

    def scrape_metrics(self) -> bool:
        """One scrape of the process metric registries -> one queued
        OTLP metrics payload."""
        points = scrape_metric_points()
        return self.enqueue(metrics_to_resource_metrics(
            points, time_unix_nano=int(time.time() * 1e9),
            resource=self.resource))

    # -- consumer side (flush thread) --------------------------------------

    def _deliver(self, payload: dict) -> bool:
        """Budgeted retry loop: the exchange client's _backoff pattern
        (exp backoff + full jitter under a wall-clock error budget),
        except exhaustion DROPS the payload instead of raising — a dead
        collector must never wedge the flush thread."""
        error_since = None
        attempt = 0
        while True:
            try:
                self._sink.export(payload)
                with self._lock:
                    self.exported += 1
                return True
            except Exception:
                now = time.monotonic()
                if error_since is None:
                    error_since = now
                with self._lock:
                    self.export_errors += 1
                if (now - error_since >= self.max_error_duration_s
                        or self._stop.is_set()):
                    with self._lock:
                        self.dropped_after_retry += 1
                    return False
                with self._lock:
                    self.retries += 1
                delay = min(_BACKOFF_CAP_S, _BACKOFF_BASE_S * (2 ** attempt))
                # full jitter keeps a worker fleet from re-probing a
                # recovering collector in lockstep
                self._stop.wait(delay * (0.5 + random.random() * 0.5))
                attempt += 1

    def _drain_once(self) -> int:
        n = 0
        while True:
            try:
                payload = self._queue.get_nowait()
            except queue.Empty:
                break
            with self._idle:
                self._in_flight += 1
            try:
                self._deliver(payload)
            finally:
                with self._idle:
                    self._in_flight -= 1
                    self._idle.notify_all()
            n += 1
        if n:
            with self._lock:
                self.flushes += 1
        return n

    def _flush_loop(self) -> None:
        last_scrape = time.monotonic()
        while not self._stop.is_set():
            self._wake.wait(self.flush_interval_s)
            self._wake.clear()
            if (self.metrics_interval_s > 0
                    and time.monotonic() - last_scrape
                    >= self.metrics_interval_s):
                last_scrape = time.monotonic()
                self.scrape_metrics()
            self._drain_once()
        self._drain_once()  # final drain on close

    # -- control -----------------------------------------------------------

    def flush(self, timeout_s: float = 10.0) -> bool:
        """Block (caller, never the query path) until everything queued
        so far has been delivered or dropped."""
        deadline = time.monotonic() + timeout_s
        self._wake.set()
        with self._idle:
            while not self._queue.empty() or self._in_flight:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._wake.set()
                self._idle.wait(min(remaining, 0.05))
        return True

    def counters(self) -> Dict[str, float]:
        with self._lock:
            return {
                "enqueued": self.enqueued,
                "exported": self.exported,
                "dropped": self.dropped,
                "dropped_after_retry": self.dropped_after_retry,
                "retries": self.retries,
                "export_errors": self.export_errors,
                "flushes": self.flushes,
                "queue_depth": self._queue.qsize(),
                "queue_bound": self.queue_bound,
            }

    def close(self, timeout_s: float = 5.0) -> None:
        self.flush(timeout_s)
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=timeout_s)
        self._sink.close()


# ---------------------------------------------------------------------------
# process-wide exporter registry
# ---------------------------------------------------------------------------
# Worker tasks and coordinator executions run deep inside the engine with
# no handle on the server that owns telemetry; like the metric registry
# singletons they reach the exporter through a process slot.  The
# WorkerServer that configured telemetry owns (and closes) it.

_process_exporter: Optional[TelemetryExporter] = None
_process_lock = threading.Lock()


def set_process_exporter(exp: Optional[TelemetryExporter]) -> None:
    global _process_exporter
    with _process_lock:
        _process_exporter = exp


def get_process_exporter() -> Optional[TelemetryExporter]:
    with _process_lock:
        return _process_exporter
