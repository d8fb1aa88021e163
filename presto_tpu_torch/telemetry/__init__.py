"""Telemetry export: OTLP-shaped span/metric export, the query history
store, and per-query device profiler capture (the host copies of
presto_tpu/telemetry/; profiler.py runs on torch.profiler).

This package is the boundary where in-process observability (the
Tracer spans, the exchange/fabric/serving/storage metric registries,
terminal QueryInfo snapshots) leaves the worker process — the analog of
the reference's OpenTelemetry TracerProvider plugin, event-listener
shipping of QueryCompletedEvents, and ClusterStatsResource.

Layers:

  * otlp.py     — pure conversion: Tracer span trees -> OTLP
                  `resourceSpans`, metric registry snapshots -> OTLP
                  `resourceMetrics`.  Trace ids derive from the
                  X-Presto-Trace-Token so coordinator and worker spans
                  stitch into ONE distributed trace.
  * export.py   — the pipeline: bounded queue + background flush thread
                  with the exchange client's jittered-backoff error budget, pluggable
                  sinks (JSONL file / HTTP OTLP-JSON / in-process
                  collector), drop/flush/retry counters.
  * history.py  — retention-bounded JSONL query history store (count +
                  age limits, reload across worker restarts).
  * profiler.py — `profile` session property: wrap one query's execution
                  in a torch.profiler capture writing a per-query
                  directory.
"""
from .otlp import (trace_id_for, span_id_for, spans_to_resource_spans,
                   metrics_to_resource_metrics, scrape_metric_points)
from .export import (TelemetrySink, CollectorSink, JsonlFileSink,
                     HttpOtlpSink, TelemetryExporter, make_sink,
                     set_process_exporter, get_process_exporter)
from .history import QueryHistoryStore, HistoryEventListener
from .profiler import profile_capture

__all__ = [
    "trace_id_for", "span_id_for", "spans_to_resource_spans",
    "metrics_to_resource_metrics", "scrape_metric_points",
    "TelemetrySink", "CollectorSink", "JsonlFileSink", "HttpOtlpSink",
    "TelemetryExporter", "make_sink",
    "set_process_exporter", "get_process_exporter",
    "QueryHistoryStore", "HistoryEventListener",
    "profile_capture",
]
