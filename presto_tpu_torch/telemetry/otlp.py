"""Tracer spans / metric registry snapshots -> OTLP-JSON shaped payloads.

Pure conversion, no IO.  The payloads follow the OTLP/JSON encoding of
ExportTraceServiceRequest / ExportMetricsServiceRequest closely enough
that a real collector's /v1/traces //v1/metrics endpoints accept them:

  {"resourceSpans": [{"resource": {"attributes": [...]},
                      "scopeSpans": [{"scope": {"name": ...},
                                      "spans": [{traceId, spanId,
                                                 parentSpanId, name,
                                                 startTimeUnixNano,
                                                 endTimeUnixNano,
                                                 attributes}]}]}]}

Identity model: the trace id is derived deterministically from the
X-Presto-Trace-Token (sha256, 16 bytes hex) and every span id from
(token, span name) (sha256, 8 bytes hex).  Span names are unique within
one query's span tree by construction — "query", "fragment {fid}",
"task {fid}.{ti}", "operator {fid}.{ti}.{nid}" — so the coordinator and
each worker can export their span subsets independently and the ids
stitch into one distributed trace without any id handshake beyond the
trace token that already rides every coordinator<->worker request.
"""
from __future__ import annotations

import hashlib
from typing import Dict, Iterable, List, Optional, Tuple

OTLP_SCOPE = {"name": "presto_tpu.telemetry", "version": "1"}


def trace_id_for(trace_token: str) -> str:
    """Deterministic 16-byte (32 hex chars) OTLP trace id."""
    return hashlib.sha256(
        ("trace:" + trace_token).encode()).hexdigest()[:32]


def span_id_for(trace_token: str, span_name: str) -> str:
    """Deterministic 8-byte (16 hex chars) OTLP span id.  Derived from
    (token, name) so independently-exporting processes agree on ids."""
    return hashlib.sha256(
        ("span:" + trace_token + "\x00" + span_name).encode()
    ).hexdigest()[:16]


def _attr_value(v) -> dict:
    """AnyValue encoding (intValue is a decimal string per OTLP/JSON)."""
    if isinstance(v, bool):
        return {"boolValue": v}
    if isinstance(v, int):
        return {"intValue": str(v)}
    if isinstance(v, float):
        return {"doubleValue": v}
    return {"stringValue": str(v)}


def _attrs(d: Optional[dict]) -> List[dict]:
    return [{"key": str(k), "value": _attr_value(v)}
            for k, v in (d or {}).items()]


def _span_fields(s) -> dict:
    """Accept Span dataclasses or their to_dict() form."""
    if isinstance(s, dict):
        return s
    return {"name": s.name, "parent": s.parent, "start": s.start,
            "end": s.end, "attributes": dict(s.attributes)}


def spans_to_resource_spans(trace_token: str, spans: Iterable,
                            resource: Optional[dict] = None) -> dict:
    """Convert one process's slice of a query span tree into an OTLP
    ExportTraceServiceRequest-shaped dict.  `spans` are
    utils.runtime_stats.Span objects (or their dict form) whose `parent`
    is the parent span's NAME ("" = root)."""
    tid = trace_id_for(trace_token)
    out = []
    for s in spans:
        f = _span_fields(s)
        name = f["name"]
        parent = f.get("parent", "")
        end = f.get("end", 0.0) or f.get("start", 0.0)
        out.append({
            "traceId": tid,
            "spanId": span_id_for(trace_token, name),
            "parentSpanId": (span_id_for(trace_token, parent)
                             if parent else ""),
            "name": name,
            "kind": 1,  # SPAN_KIND_INTERNAL
            "startTimeUnixNano": str(int(f.get("start", 0.0) * 1e9)),
            "endTimeUnixNano": str(int(end * 1e9)),
            "attributes": _attrs(f.get("attributes")),
        })
    return {"resourceSpans": [{
        "resource": {"attributes": _attrs(resource)},
        "scopeSpans": [{"scope": dict(OTLP_SCOPE), "spans": out}],
    }]}


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def metrics_to_resource_metrics(points: Iterable[Tuple[str, float, dict]],
                                time_unix_nano: int,
                                resource: Optional[dict] = None) -> dict:
    """(name, value, attributes) points -> ExportMetricsServiceRequest-
    shaped dict.  Everything is encoded as a gauge: the registries expose
    monotonically-growing process counters, but a scrape reports their
    current value, which is gauge semantics for a pull-less export."""
    metrics = []
    for name, value, attrs in points:
        dp = {"timeUnixNano": str(time_unix_nano),
              "asDouble": float(value)}
        if attrs:
            dp["attributes"] = _attrs(attrs)
        metrics.append({"name": name,
                        "gauge": {"dataPoints": [dp]}})
    return {"resourceMetrics": [{
        "resource": {"attributes": _attrs(resource)},
        "scopeMetrics": [{"scope": dict(OTLP_SCOPE), "metrics": metrics}],
    }]}


def scrape_metric_points() -> List[Tuple[str, float, dict]]:
    """Flatten the process metric registries (exchange, fabric, serving,
    storage, kernel decline/DMA counters, memory arbitration/spill) into
    OTLP gauge points.  Import
    inside the function: the registries live in packages this one must
    not import at module load (telemetry is imported by worker startup)."""
    points: List[Tuple[str, float, dict]] = []

    from ..worker.exchange import EXCHANGE_METRICS
    for k, v in EXCHANGE_METRICS.snapshot().items():
        points.append((f"presto_tpu.exchange.{k}", float(v), {}))

    from ..parallel.fabric import FABRIC_METRICS
    for fabric, fields in FABRIC_METRICS.snapshot().items():
        for k, v in fields.items():
            points.append((f"presto_tpu.exchange_fabric.{k}", float(v),
                           {"fabric": fabric}))

    from ..serving.metrics import SERVING_METRICS
    for k, v in SERVING_METRICS.snapshot().items():
        if isinstance(v, dict):
            # servingBatchOccupancy histogram: lanes-per-drain -> count
            for occupancy, n in v.items():
                points.append((f"presto_tpu.serving.{k}", float(n),
                               {"occupancy": str(occupancy)}))
        else:
            points.append((f"presto_tpu.serving.{k}", float(v), {}))

    from ..storage.store import STORAGE_METRICS
    for k, v in STORAGE_METRICS.snapshot().items():
        points.append((f"presto_tpu.storage.{k}", float(v), {}))

    from ..exec.kernels.scan_kernel import KERNEL_METRICS
    for k, v in KERNEL_METRICS.snapshot().items():
        if isinstance(v, dict):
            for reason, n in v.items():
                points.append((f"presto_tpu.kernel.{k}", float(n),
                               {"reason": reason}))
        else:
            points.append((f"presto_tpu.kernel.{k}", float(v), {}))

    from ..exec.memory import MEMORY_METRICS
    for k, v in MEMORY_METRICS.snapshot().items():
        points.append((f"presto_tpu.memory.{k}", float(v), {}))

    from ..exec.adaptive import ADAPTIVE_METRICS
    for k, v in ADAPTIVE_METRICS.snapshot().items():
        points.append((f"presto_tpu.adaptive.{k}", float(v), {}))

    return points
