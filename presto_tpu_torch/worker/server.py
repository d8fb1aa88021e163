"""Worker HTTP server: the task REST protocol, the coordinator's client
statement plane, node info and discovery.

The port of presto_tpu/worker/server.py: the HTTP surface of the
reference (presto_cpp/main/TaskResource.cpp:59-129 registerUris,
PrestoServer.cpp:327-390 endpoint setup) on Python's stdlib threading
HTTP server.

  POST   /v1/task/{taskId}                      create/update task
  GET    /v1/task/{taskId}                      task info
  GET    /v1/task/{taskId}/status               long-poll task status
  DELETE /v1/task/{taskId}                      cancel
  GET    /v1/task/{taskId}/results/{b}/{token}  pull pages (SerializedPage)
  GET    /v1/task/{taskId}/results/{b}/{token}/acknowledge
  DELETE /v1/task/{taskId}/results/{b}
  POST   /v1/statement                          client statement intake
  GET    /v1/statement/{queued,executing}/...   nextUri pages
  DELETE /v1/statement/...                      cancel
  GET    /v1/query, /v1/query/{id}              query list / QueryInfo
  GET    /v1/info, /v1/info/state, /v1/status, /v1/cluster
  PUT    /v1/info/state                         graceful shutdown (drain)
  GET    /v1/metrics                            Prometheus text exposition
  POST   /v1/plan-check                         sidecar plan validation
  PUT    /v1/announcement/{nodeId}, GET /v1/service   discovery
  GET    /ui                                    query list page

Every task and statement runs on the server's device (`device`, "cuda" by
default: without CUDA the server refuses to start).  A coordinator with
no announced workers runs statements through one LocalQueryRunner per
(schema, catalog, session), each with its own PlanCache; with announced
workers it runs them through worker/coordinator.py's HttpQueryRunner,
with a heartbeat failure detector, retries and drain.  The serving plane
is the reference's: concurrent EXECUTEs of one prepared template pass
the micro-batcher (serving/batching.py, `batch_window_ms` /
`max_batch_size`), served statements are recorded in the plan-cache
sidecar (`plan_cache_path`) and replayed before the listener opens, the
generated kernels' cubins persist in `compilation_cache_dir`, and a
CREATE, INSERT or DROP drops the runners and clears the sidecar.  The
telemetry arguments configure the OTLP exporter (telemetry/export.py):
the coordinator exports each traced query's `query` and `fragment` spans
and every worker task its `task` and `operator` spans, stitched into one
trace by the trace token; a coordinator keeps a query history store
(telemetry/history.py, `history_path` reloads it across restarts) behind
/v1/query, /v1/cluster and admission sizing.
"""
from __future__ import annotations

import json
import re
import threading
import time
import weakref
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional
from urllib.parse import parse_qs, urlparse

from ..exec.pipeline import ExecutionConfig, tuned_config
from .protocol import TaskUpdateRequest, make_announcement
from .task import TaskManager

# routes subject to the internal JWT filter (worker-to-worker and
# coordinator-to-worker surfaces; client-facing statement/query/UI
# endpoints authenticate separately in the reference, so enabling the
# internal filter must not lock clients out)
_INTERNAL = {"task_update", "task_status", "task_info", "task_delete",
             "results", "results_ack", "results_destroy", "announce",
             "service", "info_state_put"}

_ROUTES = [
    ("POST", re.compile(r"^/v1/statement$"), "statement_post"),
    ("GET", re.compile(
        r"^/v1/statement/queued/(?P<qid>[^/]+)/(?P<slug>[^/]+)"
        r"/(?P<token>\d+)$"), "statement_queued"),
    ("GET", re.compile(
        r"^/v1/statement/executing/(?P<qid>[^/]+)/(?P<slug>[^/]+)"
        r"/(?P<token>\d+)$"), "statement_executing"),
    ("DELETE", re.compile(
        r"^/v1/statement/(?:queued/|executing/)?(?P<qid>[^/]+)"
        r"/(?P<slug>[^/]+)/\d+$"), "statement_cancel"),
    ("GET", re.compile(r"^/v1/query$"), "query_list"),
    ("GET", re.compile(r"^/v1/query/(?P<qid>[^/]+)$"), "query_info"),
    ("GET", re.compile(r"^/v1/cluster$"), "cluster"),
    ("POST", re.compile(r"^/v1/plan-check$"), "plan_check"),
    ("GET", re.compile(r"^/ui/?$"), "ui"),
    ("GET", re.compile(r"^/v1/info/state$"), "info_state"),
    ("PUT", re.compile(r"^/v1/info/state$"), "info_state_put"),
    ("GET", re.compile(r"^/v1/status$"), "status"),
    ("GET", re.compile(r"^/v1/metrics$"), "metrics"),
    ("GET", re.compile(r"^/v1/info$"), "info"),
    ("GET", re.compile(r"^/v1/service$"), "service"),
    ("PUT", re.compile(r"^/v1/announcement/(?P<node>[^/]+)$"), "announce"),
    ("POST", re.compile(r"^/v1/task/(?P<task>[^/]+)$"), "task_update"),
    ("GET", re.compile(r"^/v1/task/(?P<task>[^/]+)/status$"), "task_status"),
    ("GET", re.compile(
        r"^/v1/task/(?P<task>[^/]+)/results/(?P<buffer>\d+)/(?P<token>\d+)"
        r"/acknowledge$"), "results_ack"),
    ("GET", re.compile(
        r"^/v1/task/(?P<task>[^/]+)/results/(?P<buffer>\d+)/(?P<token>\d+)$"),
     "results"),
    ("DELETE", re.compile(
        r"^/v1/task/(?P<task>[^/]+)/results/(?P<buffer>\d+)$"),
     "results_destroy"),
    ("GET", re.compile(r"^/v1/task/(?P<task>[^/]+)$"), "task_info"),
    ("DELETE", re.compile(r"^/v1/task/(?P<task>[^/]+)$"), "task_delete"),
]



class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_ref: "WorkerServer" = None  # set by subclassing in WorkerServer

    # quiet request logging
    def log_message(self, fmt, *args):  # noqa: D102
        pass

    def _dispatch(self, method: str):
        parsed = urlparse(self.path)
        # internal JWT filter (InternalAuthenticationFilter.cpp decision
        # table) runs before routing, like the reference's proxygen
        # filter chain
        for m, rx, name in _ROUTES:
            if m != method:
                continue
            match = rx.match(parsed.path)
            if match:
                if name in _INTERNAL:
                    # internal JWT filter (InternalAuthenticationFilter
                    # decision table) guards the internal surfaces only
                    err = self.server_ref.auth.check_inbound(
                        self.headers.get("X-Presto-Internal-Bearer"))
                    if err is not None:
                        self._send(401, {"error": err})
                        return
                try:
                    getattr(self, "do_" + name)(
                        match.groupdict(), parse_qs(parsed.query))
                except KeyError:
                    self._send(404, {"error": "unknown task"})
                except BufferError as e:
                    self._send(500, {"error": str(e)})
                except (BrokenPipeError, ConnectionResetError):
                    pass
                except Exception:  # noqa: BLE001 — surface, don't drop conn
                    import traceback
                    self._send(500, {"error": traceback.format_exc()})
                return
        self._send(404, {"error": f"no route {method} {parsed.path}"})

    def do_GET(self):
        self._dispatch("GET")

    def do_POST(self):
        self._dispatch("POST")

    def do_PUT(self):
        self._dispatch("PUT")

    def do_DELETE(self):
        self._dispatch("DELETE")

    # -- helpers ----------------------------------------------------------
    def _send(self, code: int, obj=None, body: bytes = b"",
              headers: Optional[Dict[str, str]] = None):
        if obj is not None:
            body = json.dumps(obj).encode()
        self.send_response(code)
        hdrs = dict(headers or {})
        if "Content-Type" not in hdrs:
            self.send_header("Content-Type",
                             "application/json" if obj is not None
                             else "application/x-presto-pages")
        self.send_header("Content-Length", str(len(body)))
        for k, v in hdrs.items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _body(self) -> bytes:
        length = int(self.headers.get("Content-Length", 0))
        return self.rfile.read(length)

    def _body_json(self):
        """Request body as a JSON value, honoring the binary transport:
        Content-Type application/x-jackson-smile bodies (the
        coordinator's HttpRemoteTask.java:915-931 negotiation) decode
        through worker/smile.py; everything else parses as JSON text."""
        raw = self._body()
        ctype = (self.headers.get("Content-Type") or "").lower()
        from . import smile
        if smile.CONTENT_TYPE in ctype or raw[:3] == b":)\n":
            return smile.decode(raw)
        return json.loads(raw)

    def _accepts_smile(self) -> bool:
        from . import smile
        return smile.CONTENT_TYPE in (self.headers.get("Accept")
                                      or "").lower()

    def _accepts_thrift(self) -> bool:
        from . import thrift
        return thrift.CONTENT_TYPE in (self.headers.get("Accept")
                                       or "").lower()

    def _send_negotiated(self, code: int, obj,
                         thrift_encoder=None) -> None:
        """JSON by default; SMILE or Thrift when the client's Accept asks
        for it (the TaskStatus/TaskInfo hot path the reference serves over
        a negotiated binary transport — HttpRemoteTask.java:915-931 /
        TaskResource.cpp:218-224).  Thrift needs a typed schema, so only
        endpoints passing a thrift_encoder serve it."""
        if thrift_encoder is not None and self._accepts_thrift():
            from . import thrift
            self._send(code, None, thrift_encoder(obj),
                       headers={"Content-Type": thrift.CONTENT_TYPE})
        elif self._accepts_smile():
            from . import smile
            self._send(code, None, smile.encode(obj),
                       headers={"Content-Type": smile.CONTENT_TYPE})
        else:
            self._send(code, obj)



    # -- endpoints --------------------------------------------------------
    def do_info(self, groups, query):
        s = self.server_ref
        self._send(200, {"nodeVersion": {"version": "presto-tpu-0.1"},
                         "environment": s.environment,
                         "coordinator": s.coordinator,
                         "uptime": f"{time.time() - s.started_at:.0f}s"})

    def do_info_state(self, groups, query):
        self._send(200, self.server_ref.state)

    def do_info_state_put(self, groups, query):
        """Graceful shutdown (reference GracefulShutdownHandler /
        presto_cpp PrestoServer.cpp:648-688): stop accepting tasks, drain
        running ones, then report SHUTTING_DOWN until the process exits."""
        body = json.loads(self._body())
        if body != "SHUTTING_DOWN":
            self._send(400, {"error": f"unsupported state {body!r}"})
            return
        self.server_ref.begin_shutdown()
        self._send(200, "SHUTTING_DOWN")

    def do_status(self, groups, query):
        """Node status (reference server/NodeStatus.java: the payload the
        coordinator's memory manager and UI poll); heapUsed is the device
        allocator's peak."""
        s = self.server_ref
        c = s.task_manager.counts()
        det = s.failure_detector
        self._send(200, {
            "nodeId": s.node_id,
            "nodeVersion": {"version": "presto-tpu-0.1"},
            "environment": s.environment,
            "coordinator": s.coordinator,
            "state": s.state,
            "uptime": f"{time.time() - s.started_at:.0f}s",
            "tasks": c["by_state"],
            "totalTasks": c["created"],
            "tasksFailed": c["failed"],
            "tasksRetried": c["retried"],
            "heapUsed": s.device_memory()["peak_allocated_bytes"],
            **({"failureDetector": det.snapshot()} if det else {}),
            **self._serving_status(),
        })

    def _serving_status(self) -> dict:
        """Serving section of /v1/status (coordinator role): the runners'
        plan caches, the serving counters, per-group admission state."""
        s = self.server_ref
        if s.dispatch is None:
            return {}
        from ..serving import PREPARED_REGISTRY, SERVING_METRICS
        return {"serving": {
            "planCache": s.plan_cache_info(),
            "preparedStatements": PREPARED_REGISTRY.info(),
            "metrics": SERVING_METRICS.snapshot(),
            "resourceGroups": s.dispatch.resource_groups.info(),
        }}

    def do_metrics(self, groups, query):
        """Prometheus text exposition (reference
        presto_cpp/main/runtime-metrics/PrometheusStatsReporter.h:40) of
        the registries the port has: tasks, the failure detector, the
        spool, the exchange client, serving, storage, the scan and window
        kernels (with the stage ring's counters), device memory, locks and
        resource groups."""
        s = self.server_ref
        c = s.task_manager.counts()
        lines = [
            "# TYPE presto_tpu_uptime_seconds gauge",
            f"presto_tpu_uptime_seconds {time.time() - s.started_at:.1f}",
            "# TYPE presto_tpu_tasks_created_total counter",
            f"presto_tpu_tasks_created_total {c['created']}",
            "# TYPE presto_tpu_tasks_failed_total counter",
            f"presto_tpu_tasks_failed_total {c['failed']}",
            "# TYPE presto_tpu_task_retries_total counter",
            f"presto_tpu_task_retries_total {c['retried']}",
            "# TYPE presto_tpu_task_memory_peak_bytes gauge",
            f"presto_tpu_task_memory_peak_bytes {c['memory_peak']}",
            "# TYPE presto_tpu_tasks gauge",
        ]
        for state, n in sorted(c["by_state"].items()):
            lines.append(
                'presto_tpu_tasks{state="%s"} %d' % (state.lower(), n))
        det = s.failure_detector
        if det is not None:
            lines.append("# TYPE presto_tpu_worker_probe_failures gauge")
            lines.append("# TYPE presto_tpu_worker_alive gauge")
            for uri, w in sorted(det.snapshot().items()):
                lines.append(
                    'presto_tpu_worker_probe_failures{worker="%s"} %d'
                    % (uri, w["streak"]))
                lines.append(
                    'presto_tpu_worker_alive{worker="%s",draining="%s"} %d'
                    % (uri, str(w["draining"]).lower(),
                       1 if w["alive"] else 0))
        # durable spooled-exchange section (worker/spooling.py): bytes
        # staged/flushed by fault-tolerant (retry-policy=task) executions
        from .spooling import SPOOL_METRICS
        sp = SPOOL_METRICS.snapshot()
        for k in sorted(sp):
            if k == "staged_bytes":
                lines.append(f"# TYPE presto_tpu_spool_{k} gauge")
                lines.append(f"presto_tpu_spool_{k} {sp[k]}")
            else:
                lines.append(f"# TYPE presto_tpu_spool_{k}_total counter")
                lines.append(f"presto_tpu_spool_{k}_total {sp[k]}")
        # exchange-client section: process-wide (one worker per process in
        # a real deployment; in-process test clusters aggregate, so tests
        # reset() the singleton before asserting)
        from .exchange import EXCHANGE_METRICS
        x = EXCHANGE_METRICS.snapshot()
        lines += [
            "# TYPE presto_tpu_exchange_pages_total counter",
            f"presto_tpu_exchange_pages_total {x['pages']}",
            "# TYPE presto_tpu_exchange_bytes_total counter",
            f"presto_tpu_exchange_bytes_total {x['bytes']}",
            "# TYPE presto_tpu_exchange_uncompressed_bytes_total counter",
            "presto_tpu_exchange_uncompressed_bytes_total "
            f"{x['uncompressed_bytes']}",
            "# TYPE presto_tpu_exchange_responses_total counter",
            f"presto_tpu_exchange_responses_total {x['responses']}",
            "# TYPE presto_tpu_exchange_clients_total counter",
            f"presto_tpu_exchange_clients_total {x['clients']}",
            "# TYPE presto_tpu_exchange_pull_wall_seconds_total counter",
            f"presto_tpu_exchange_pull_wall_seconds_total "
            f"{x['pull_wall_s']:.6f}",
            "# TYPE presto_tpu_exchange_decode_wall_seconds_total counter",
            f"presto_tpu_exchange_decode_wall_seconds_total "
            f"{x['decode_wall_s']:.6f}",
            "# TYPE presto_tpu_exchange_wait_wall_seconds_total counter",
            f"presto_tpu_exchange_wait_wall_seconds_total "
            f"{x['wait_wall_s']:.6f}",
            "# TYPE presto_tpu_exchange_buffered_bytes gauge",
            f"presto_tpu_exchange_buffered_bytes {x['buffered_bytes']}",
            "# TYPE presto_tpu_exchange_buffered_bytes_peak gauge",
            "presto_tpu_exchange_buffered_bytes_peak "
            f"{x['buffered_bytes_peak']}",
        ]
        from ..serving import SERVING_METRICS
        sv = SERVING_METRICS.snapshot()
        pc = s.plan_cache_info()
        lines += [
            "# TYPE presto_tpu_serving_plan_cache_hits_total counter",
            f"presto_tpu_serving_plan_cache_hits_total {sv['planCacheHits']}",
            "# TYPE presto_tpu_serving_plan_cache_misses_total counter",
            "presto_tpu_serving_plan_cache_misses_total "
            f"{sv['planCacheMisses']}",
            "# TYPE presto_tpu_serving_plan_cache_evictions_total counter",
            "presto_tpu_serving_plan_cache_evictions_total "
            f"{sv['planCacheEvictions']}",
            "# TYPE presto_tpu_serving_plan_cache_invalidations_total counter",
            "presto_tpu_serving_plan_cache_invalidations_total "
            f"{sv['planCacheInvalidations']}",
            "# TYPE presto_tpu_serving_plan_cache_entries gauge",
            f"presto_tpu_serving_plan_cache_entries {pc['entries']}",
            "# TYPE presto_tpu_serving_executable_builds_total counter",
            f"presto_tpu_serving_executable_builds_total "
            f"{sv['executableBuilds']}",
            "# TYPE presto_tpu_serving_prepared_fast_path_total counter",
            "presto_tpu_serving_prepared_fast_path_total "
            f"{sv['preparedFastPath']}",
            "# TYPE presto_tpu_serving_prepared_replans_total counter",
            f"presto_tpu_serving_prepared_replans_total "
            f"{sv['preparedReplans']}",
            # compiler-pool contention (serving/cache.py checkout)
            "# TYPE presto_tpu_serving_compiler_checkouts_total counter",
            "presto_tpu_serving_compiler_checkouts_total "
            f"{sv['compilerCheckouts']}",
            "# TYPE presto_tpu_serving_compiler_pool_exhausted_total counter",
            "presto_tpu_serving_compiler_pool_exhausted_total "
            f"{sv['compilerPoolExhausted']}",
            "# TYPE presto_tpu_serving_compiler_checkout_wait_seconds_total"
            " counter",
            "presto_tpu_serving_compiler_checkout_wait_seconds_total "
            f"{sv['compilerCheckoutWaitNanos'] / 1e9:.6f}",
            "# TYPE presto_tpu_serving_compiler_checkout_depth_peak gauge",
            "presto_tpu_serving_compiler_checkout_depth_peak "
            f"{sv['compilerCheckoutDepthPeak']}",
            # micro-batched point queries (serving/batching.py)
            "# TYPE presto_tpu_serving_batch_batches_total counter",
            f"presto_tpu_serving_batch_batches_total {sv['servingBatches']}",
            "# TYPE presto_tpu_serving_batch_queries_total counter",
            "presto_tpu_serving_batch_queries_total "
            f"{sv['servingBatchQueries']}",
            "# TYPE presto_tpu_serving_batch_launches_saved_total counter",
            "presto_tpu_serving_batch_launches_saved_total "
            f"{sv['servingBatchLaunchesSaved']}",
            "# TYPE presto_tpu_serving_batch_fallbacks_total counter",
            "presto_tpu_serving_batch_fallbacks_total "
            f"{sv['servingBatchFallbacks']}",
            "# TYPE presto_tpu_serving_batch_demux_seconds_total counter",
            "presto_tpu_serving_batch_demux_seconds_total "
            f"{sv['servingBatchDemuxNanos'] / 1e9:.6f}",
            # fragment-level step sharing (serving/fragments.py)
            "# TYPE presto_tpu_serving_fragment_jit_hits_total counter",
            "presto_tpu_serving_fragment_jit_hits_total "
            f"{sv['fragmentJitHits']}",
            "# TYPE presto_tpu_serving_fragment_jit_misses_total counter",
            "presto_tpu_serving_fragment_jit_misses_total "
            f"{sv['fragmentJitMisses']}",
        ]
        from ..storage.store import STORAGE_METRICS
        st = STORAGE_METRICS.snapshot()
        for k in sorted(st):
            if k == "resident_bytes":
                lines.append(f"# TYPE presto_tpu_storage_{k} gauge")
                lines.append(f"presto_tpu_storage_{k} {st[k]}")
            else:
                lines.append(f"# TYPE presto_tpu_storage_{k}_total counter")
                lines.append(f"presto_tpu_storage_{k}_total {st[k]}")
        # adaptive-execution counters (exec/adaptive.py ADAPTIVE_METRICS):
        # dynamic-filter collection/application/pruning plus the runtime
        # exchange-strategy decisions; all monotonic counters
        from ..exec.adaptive import ADAPTIVE_METRICS
        for k, v in sorted(ADAPTIVE_METRICS.snapshot().items()):
            lines.append(f"# TYPE presto_tpu_adaptive_{k}_total counter")
            lines.append(f"presto_tpu_adaptive_{k}_total {v}")
        # per-fabric shuffle section (parallel/fabric.py FABRIC_METRICS):
        # the http/ici comparison surface — bytes moved per fabric, the
        # dispatch/compute/wait walls, and the measured overlap fraction
        from ..parallel.fabric import FABRIC_METRICS
        fm = FABRIC_METRICS.snapshot()
        lines += [
            "# TYPE presto_tpu_exchange_fabric_exchanges_total counter",
            "# TYPE presto_tpu_exchange_fabric_chunks_total counter",
            "# TYPE presto_tpu_exchange_fabric_bytes_total counter",
            "# TYPE presto_tpu_exchange_fabric_host_bytes_total counter",
            "# TYPE presto_tpu_exchange_fabric_exchange_wall_seconds_total"
            " counter",
            "# TYPE presto_tpu_exchange_fabric_compute_wall_seconds_total"
            " counter",
            "# TYPE presto_tpu_exchange_fabric_wait_wall_seconds_total"
            " counter",
            "# TYPE presto_tpu_exchange_fabric_fallbacks_total counter",
            "# TYPE presto_tpu_exchange_fabric_overlap_fraction gauge",
        ]
        for fabric in sorted(fm):
            f = fm[fabric]
            tag = 'fabric="%s"' % fabric
            lines += [
                f"presto_tpu_exchange_fabric_exchanges_total{{{tag}}} "
                f"{f['exchanges']}",
                f"presto_tpu_exchange_fabric_chunks_total{{{tag}}} "
                f"{f['chunks']}",
                f"presto_tpu_exchange_fabric_bytes_total{{{tag}}} "
                f"{f['bytes_moved']}",
                f"presto_tpu_exchange_fabric_host_bytes_total{{{tag}}} "
                f"{f['host_bytes']}",
                f"presto_tpu_exchange_fabric_exchange_wall_seconds_total"
                f"{{{tag}}} {f['exchange_wall_s']:.6f}",
                f"presto_tpu_exchange_fabric_compute_wall_seconds_total"
                f"{{{tag}}} {f['compute_wall_s']:.6f}",
                f"presto_tpu_exchange_fabric_wait_wall_seconds_total"
                f"{{{tag}}} {f['wait_wall_s']:.6f}",
                f"presto_tpu_exchange_fabric_fallbacks_total{{{tag}}} "
                f"{f['fallbacks']}",
                f"presto_tpu_exchange_fabric_overlap_fraction{{{tag}}} "
                f"{f['overlap_fraction']:.6f}",
            ]
        # lock-order validation + contention metering (common/locks.py):
        # populated when debug.lock-validation (or a session's
        # lock_validation override) armed the OrderedLock bookkeeping
        from ..common.locks import LOCK_METRICS, validation_enabled
        lk = LOCK_METRICS.snapshot()
        lines += [
            "# TYPE presto_tpu_lock_validation_enabled gauge",
            f"presto_tpu_lock_validation_enabled "
            f"{1 if validation_enabled() else 0}",
            "# TYPE presto_tpu_lock_acquisitions_total counter",
            f"presto_tpu_lock_acquisitions_total {lk['acquisitions']}",
            "# TYPE presto_tpu_lock_contended_total counter",
            f"presto_tpu_lock_contended_total {lk['contended']}",
            "# TYPE presto_tpu_lock_contention_wall_seconds_total counter",
            f"presto_tpu_lock_contention_wall_seconds_total "
            f"{lk['contention_wall_s']}",
            "# TYPE presto_tpu_lock_hold_wall_seconds_total counter",
            f"presto_tpu_lock_hold_wall_seconds_total {lk['hold_wall_s']}",
            "# TYPE presto_tpu_lock_order_violations_total counter",
            f"presto_tpu_lock_order_violations_total {lk['violations']}",
        ]
        km = s.process_metrics()["kernel"]
        for k in ("scan_programs", "window_programs", "dma_staged_blocks",
                  "dma_prefetched_blocks"):
            lines.append(f"# TYPE presto_tpu_kernel_{k}_total counter")
            lines.append(f"presto_tpu_kernel_{k}_total {km[k]}")
        lines.append("# TYPE presto_tpu_kernel_dma_overlap_fraction gauge")
        lines.append("presto_tpu_kernel_dma_overlap_fraction "
                     f"{km['dma_overlap_fraction']:.6f}")
        for k in ("launches", "staged_launches"):
            lines.append(f"# TYPE presto_tpu_kernel_{k}_total counter")
            for name, n in sorted(km[k].items()):
                lines.append('presto_tpu_kernel_%s_total{kernel="%s"} %d'
                             % (k, name, n))
        lines.append("# TYPE presto_tpu_kernel_declined_total counter")
        for reason, n in sorted(km["declined"].items()):
            lines.append('presto_tpu_kernel_declined_total{reason="%s"} %d'
                         % (reason, n))
        # memory arbitration + two-tier spill (exec/memory.py): counters
        # for spilled/unspilled bytes and revocations, gauges for the
        # live reserved/revocable split and the eviction overlap fraction
        from ..exec.memory import MEMORY_METRICS
        mem = MEMORY_METRICS.snapshot()
        for k in sorted(mem):
            if k in ("reserved_bytes", "revocable_bytes",
                     "spill_overlap_fraction"):
                lines.append(f"# TYPE presto_tpu_memory_{k} gauge")
                lines.append(f"presto_tpu_memory_{k} {mem[k]}")
            else:
                lines.append(f"# TYPE presto_tpu_memory_{k}_total counter")
                lines.append(f"presto_tpu_memory_{k}_total {mem[k]}")
        for k, v in sorted(s.device_memory().items()):
            if k == "device":
                continue
            lines.append(f"# TYPE presto_tpu_memory_device_{k} gauge")
            lines.append(f"presto_tpu_memory_device_{k} {v}")
        # telemetry export pipeline + history store counters
        if s.telemetry is not None:
            tc = s.telemetry.counters()
            lines += [
                "# TYPE presto_tpu_telemetry_enqueued_total counter",
                f"presto_tpu_telemetry_enqueued_total {tc['enqueued']}",
                "# TYPE presto_tpu_telemetry_exported_total counter",
                f"presto_tpu_telemetry_exported_total {tc['exported']}",
                "# TYPE presto_tpu_telemetry_dropped_total counter",
                "presto_tpu_telemetry_dropped_total "
                f"{tc['dropped'] + tc['dropped_after_retry']}",
                "# TYPE presto_tpu_telemetry_retries_total counter",
                f"presto_tpu_telemetry_retries_total {tc['retries']}",
                "# TYPE presto_tpu_telemetry_queue_depth gauge",
                f"presto_tpu_telemetry_queue_depth {tc['queue_depth']}",
            ]
        if s.history is not None:
            hc = s.history.counters()
            lines += [
                "# TYPE presto_tpu_history_entries gauge",
                f"presto_tpu_history_entries {hc['entries']}",
                "# TYPE presto_tpu_history_recorded_total counter",
                f"presto_tpu_history_recorded_total {hc['recorded']}",
                "# TYPE presto_tpu_history_evicted_total counter",
                f"presto_tpu_history_evicted_total {hc['evicted']}",
            ]
        if s.dispatch is not None:
            lines += [
                "# TYPE presto_tpu_serving_group_running gauge",
                "# TYPE presto_tpu_serving_group_queued gauge",
            ]
            for name, g in sorted(s.dispatch.resource_groups.info().items()):
                if name.startswith("__"):
                    continue
                lines.append('presto_tpu_serving_group_running{group="%s"'
                             ',weight="%g"} %d'
                             % (name, g["weight"], g["running"]))
                lines.append('presto_tpu_serving_group_queued{group="%s"} %d'
                             % (name, g["queued"]))
        self._send(200, None, ("\n".join(lines) + "\n").encode(),
                   headers={"Content-Type":
                            "text/plain; version=0.0.4; charset=utf-8"})

    def do_service(self, groups, query):
        s = self.server_ref
        if s.discovery is None:
            self._send(404, {"error": "not a coordinator"})
            return
        with s.discovery_lock:
            services = [a["services"][0] for a in s.discovery.values()]
        self._send(200, {"services": services})

    def do_announce(self, groups, query):
        s = self.server_ref
        if s.discovery is None:
            self._send(404, {"error": "not a coordinator"})
            return
        body = json.loads(self._body())
        with s.discovery_lock:
            s.discovery[groups["node"]] = body
        self._send(202, {"ok": True})

    # -- statement protocol (coordinator role; QueuedStatementResource /
    # ExecutingStatementResource analog — see worker/statement.py) ---------
    def _dispatch_mgr(self):
        d = self.server_ref.dispatch
        if d is None:
            self._send(404, {"error": "not a coordinator"})
        return d

    def _session_headers(self):
        session = {}
        for raw in self.headers.get_all("X-Presto-Session") or []:
            for pair in raw.split(","):
                if "=" in pair:
                    k, v = pair.split("=", 1)
                    session[k.strip()] = v.strip()
        return session

    def _prepared_headers(self):
        """X-Presto-Prepared-Statement: name=urlencoded-sql, repeatable and
        comma-joinable (reference PrestoHeaders.PRESTO_PREPARED_STATEMENT:
        the client replays its prepared map on every request, keeping the
        server stateless across coordinator restarts)."""
        from urllib.parse import unquote_plus
        prepared = {}
        for raw in self.headers.get_all("X-Presto-Prepared-Statement") or []:
            for pair in raw.split(","):
                if "=" in pair:
                    k, v = pair.split("=", 1)
                    prepared[unquote_plus(k.strip())] = \
                        unquote_plus(v.strip())
        return prepared

    @staticmethod
    def _prepare_headers_out(q) -> Dict[str, str]:
        """Response headers the client folds back into its prepared map
        (reference PRESTO_ADDED_PREPARE / PRESTO_DEALLOCATED_PREPARE)."""
        from urllib.parse import quote_plus
        hdrs = {}
        if getattr(q, "added_prepare", None):
            name, text = q.added_prepare
            hdrs["X-Presto-Added-Prepare"] = \
                f"{quote_plus(name)}={quote_plus(text)}"
        if getattr(q, "deallocated_prepare", None):
            hdrs["X-Presto-Deallocated-Prepare"] = \
                quote_plus(q.deallocated_prepare)
        return hdrs

    def do_statement_post(self, groups, query):
        d = self._dispatch_mgr()
        if d is None:
            return
        sql = self._body().decode()
        q = d.submit(
            sql,
            user=self.headers.get("X-Presto-User", "user"),
            source=self.headers.get("X-Presto-Source", ""),
            session=self._session_headers(),
            catalog=self.headers.get("X-Presto-Catalog", "tpch"),
            schema=self.headers.get("X-Presto-Schema", "sf0.01"),
            prepared=self._prepared_headers(),
            trace_token=self.headers.get("X-Presto-Trace-Token", ""))
        self._send(200, d.queued_response(q, 0, self.server_ref.uri,
                                          wait_s=0.0),
                   headers=self._prepare_headers_out(q))

    def _statement_query(self, d, groups):
        try:
            q = d.get(groups["qid"])
        except KeyError:
            self._send(404, {"error": "unknown query"})
            return None
        if q.slug != groups["slug"]:
            self._send(404, {"error": "bad slug"})
            return None
        return q

    def do_statement_queued(self, groups, query):
        d = self._dispatch_mgr()
        if d is None:
            return
        q = self._statement_query(d, groups)
        if q is not None:
            self._send(200, d.queued_response(
                q, int(groups["token"]), self.server_ref.uri),
                headers=self._prepare_headers_out(q))

    def do_statement_executing(self, groups, query):
        d = self._dispatch_mgr()
        if d is None:
            return
        q = self._statement_query(d, groups)
        if q is not None:
            self._send(200, d.executing_response(
                q, int(groups["token"]), self.server_ref.uri),
                headers=self._prepare_headers_out(q))

    def do_statement_cancel(self, groups, query):
        d = self._dispatch_mgr()
        if d is None:
            return
        # the slug is the per-query secret: without it a query id (guessable,
        # sequential) would suffice to cancel other clients' queries
        q = self._statement_query(d, groups)
        if q is None:
            return
        d.cancel(q.query_id)
        self._send(204)


    def do_query_list(self, groups, query):
        """/v1/query[?state=...]: the live dispatch registry merged with
        the durable history store -- after a coordinator restart the live
        registry is empty but ?state=FINISHED still lists what the spool
        reloaded (reference QueryResource list + system.runtime.queries
        over completed queries)."""
        d = self._dispatch_mgr()
        if d is None:
            return
        state = (query.get("state", [None])[0] or "").upper() or None
        live = d.list_queries()
        out = [q for q in live if state is None or q["state"] == state]
        hist = self.server_ref.history
        if hist is not None:
            live_ids = {q["queryId"] for q in live}
            for rec in hist.list(state=state):
                if rec["queryId"] in live_ids:
                    continue  # live registry wins (same terminal record)
                out.append({
                    "queryId": rec["queryId"],
                    "state": rec.get("state", "UNKNOWN"),
                    "query": rec.get("query", ""),
                    "user": rec.get("user", ""),
                    "resourceGroup": rec.get("resourceGroup", ""),
                    **({"errorMessage": rec["errorMessage"]}
                       if rec.get("errorMessage") else {})})
        self._send(200, out)

    def do_cluster(self, groups, query):
        """/v1/cluster (reference ClusterStatsResource): query counts by
        lifecycle bucket, task and worker totals, admission memory, the
        per-fabric shuffle byte rates, the history store's size and the
        exporter's counters.  Terminal counts take the durable history
        store when it is ahead of the (restart-lossy, eviction-bounded)
        live registry."""
        s = self.server_ref
        d = s.dispatch
        if d is None:
            self._send(404, {"error": "not a coordinator"})
            return
        c = s.task_manager.counts()
        by_state: Dict[str, int] = {}
        for q in d.list_queries():
            by_state[q["state"]] = by_state.get(q["state"], 0) + 1
        hist_counts = s.history.counts_by_state() if s.history else {}
        queued = by_state.get("QUEUED", 0)
        adm = d.resource_groups.info().get("__admission", {})
        headroom = adm.get("memoryHeadroomBytes")
        reserved = max(adm.get("memoryAdmittedBytes", 0),
                       adm.get("memoryReservedBytes", 0)
                       + adm.get("memoryRevocableBytes", 0))
        blocked = queued if (headroom is not None and queued
                             and reserved >= headroom) else 0
        from ..parallel.fabric import FABRIC_METRICS
        self._send(200, {
            "runningQueries": by_state.get("RUNNING", 0),
            "queuedQueries": queued,
            "blockedQueries": blocked,
            "finishedQueries": max(by_state.get("FINISHED", 0),
                                   hist_counts.get("FINISHED", 0)),
            "failedQueries": max(by_state.get("FAILED", 0),
                                 hist_counts.get("FAILED", 0)),
            "canceledQueries": max(by_state.get("CANCELED", 0),
                                   hist_counts.get("CANCELED", 0)),
            "activeWorkers": len(s.worker_uris()),
            "runningTasks": c["by_state"].get("RUNNING", 0),
            "totalTasks": c["created"],
            "reservedMemoryBytes": reserved,
            "revocableMemoryBytes": adm.get("memoryRevocableBytes", 0),
            **({"memoryHeadroomBytes": headroom}
               if headroom is not None else {}),
            "fabricByteRates": FABRIC_METRICS.byte_rates(),
            **({"workers": s.failure_detector.snapshot()}
               if s.failure_detector else {}),
            "historyEntries": len(s.history) if s.history else 0,
            **({"telemetry": s.telemetry.counters()}
               if s.telemetry else {}),
        })

    def do_query_info(self, groups, query):
        d = self._dispatch_mgr()
        if d is None:
            return
        try:
            q = d.get(groups["qid"])
        except KeyError:
            # fall back to the durable history record: terminal queries
            # outlive the in-memory registry (eviction, restarts)
            hist = self.server_ref.history
            rec = hist.get(groups["qid"]) if hist is not None else None
            if rec is not None:
                self._send(200, {**rec, "source": "history"})
                return
            self._send(404, {"error": "unknown query"})
            return
        # stage/task/operator drill-down: the terminal snapshot captured
        # by the executor, else a LIVE snapshot from the running
        # distributed execution matched by trace token
        extra = q.query_info_extra
        if extra is None and not q.done.is_set():
            extra = self.server_ref.live_query_info(q.trace_token)
        self._send(200, {
            "queryId": q.query_id, "query": q.sql, "state": q.state,
            "traceToken": q.trace_token,
            "queryStats": q.stats(), "session": q.session,
            "resourceGroupId": [q.resource_group],
            "peakMemoryBytes": q.peak_memory_bytes,
            **({"runtimeStats": q.runtime_stats}
               if q.runtime_stats else {}),
            **({"failureInfo": {"message": q.error}} if q.error else {}),
            **({"stages": extra.get("stages"),
                "operatorStats": extra.get("operatorStats")}
               if extra else {}),
            "processMetrics": self.server_ref.process_metrics(),
            "resourceGroups": d.resource_groups.info()})

    def do_plan_check(self, groups, query):
        """Sidecar plan validation (presto-native-sidecar-plugin
        nativechecker analog): can the native planner handle this SQL?
        Consumed by the plan-check router scheduler."""
        from .router import plan_checks
        sql = self._body().decode()
        err = plan_checks(sql,
                          schema=self.headers.get("X-Presto-Schema",
                                                  "sf0.01"),
                          catalog=self.headers.get("X-Presto-Catalog",
                                                   "tpch"))
        self._send(200, {"ok": err is None,
                         **({"error": err} if err else {})})

    def do_ui(self, groups, query):
        """Minimal cluster console (the presto-ui query-list analog)."""
        from html import escape
        from urllib.parse import quote
        s = self.server_ref
        rows = []
        if s.dispatch is not None:
            for q in reversed(s.dispatch.list_queries()):
                state = q["state"]
                color = {"FINISHED": "#2d7", "FAILED": "#d55",
                         "RUNNING": "#27d", "QUEUED": "#fa0"}.get(state,
                                                                  "#999")
                sql = (q["query"][:120] + "…") if len(q["query"]) > 120 \
                    else q["query"]
                # query text and ids are client-controlled: escape
                rows.append(
                    f"<tr><td><a href='/v1/query/"
                    f"{quote(q['queryId'])}'>"
                    f"{escape(q['queryId'])}</a></td>"
                    f"<td style='color:{color}'>{escape(state)}</td>"
                    f"<td>{escape(q['resourceGroup'])}</td>"
                    f"<td><code>{escape(sql)}</code></td></tr>")
        # worker URIs arrive via the unauthenticated announcement endpoint:
        # escape like every other client-controlled field
        workers = "".join(f"<li>{escape(u)}</li>" for u in s.worker_uris())
        html = f"""<!doctype html><html><head><title>presto-tpu</title>
<style>body{{font-family:sans-serif;margin:2em}}table{{border-collapse:
collapse}}td,th{{border:1px solid #ccc;padding:4px 8px;text-align:left}}
</style></head><body>
<h1>presto-tpu {'coordinator' if s.coordinator else 'worker'}
 <small>{s.node_id}</small></h1>
<p>state: {s.state} &middot; uptime: {time.time() - s.started_at:.0f}s</p>
<h2>workers</h2><ul>{workers or '<li>(none announced)</li>'}</ul>
<h2>queries</h2>
<table><tr><th>query</th><th>state</th><th>group</th><th>sql</th></tr>
{''.join(rows) or '<tr><td colspan=4>(none)</td></tr>'}</table>
</body></html>"""
        self._send(200, None, html.encode(),
                   headers={"Content-Type": "text/html; charset=utf-8"})

    def do_task_update(self, groups, query):
        if self.server_ref.state != "ACTIVE":
            # draining node refuses new work; the coordinator reroutes
            self._send(503, {"error": "node is shutting down"})
            return
        body = self._body_json()
        if "outputIds" in body or "extraCredentials" in body:
            # reference-shaped request (HttpRemoteTask.java:883-936)
            from .protocol import from_reference_update
            update = from_reference_update(groups["task"], body)
        else:
            update = TaskUpdateRequest.from_dict(body)
        # X-Presto-Task-Deadline carries the query's REMAINING execution
        # budget in ms (no cross-node clock sync needed): the TaskManager
        # reaper and the pipeline drain loop both enforce it
        deadline_ms = None
        raw_deadline = self.headers.get("X-Presto-Task-Deadline")
        if raw_deadline:
            try:
                deadline_ms = float(raw_deadline)
            except ValueError:
                deadline_ms = None
        status = self.server_ref.task_manager.create_or_update(
            update, deadline_ms=deadline_ms)
        from .thrift import task_status_to_thrift
        self._send_negotiated(200, status.to_dict(),
                              thrift_encoder=task_status_to_thrift)

    def do_task_status(self, groups, query):
        task = self.server_ref.task_manager.get(groups["task"])
        current = self.headers.get("X-Presto-Current-State") or \
            (query.get("currentState", [None])[0])
        max_wait = float(query.get("maxWaitMs", ["1000"])[0]) / 1000.0
        status = task.wait_status(current, max_wait)
        from .thrift import task_status_to_thrift
        self._send_negotiated(200, status.to_dict(),
                              thrift_encoder=task_status_to_thrift)

    def do_task_info(self, groups, query):
        task = self.server_ref.task_manager.get(groups["task"])
        self._send_negotiated(200, task.info())

    def do_task_delete(self, groups, query):
        task = self.server_ref.task_manager.get(groups["task"])
        task.cancel()
        from .thrift import task_status_to_thrift
        self._send_negotiated(200, task.status().to_dict(),
                              thrift_encoder=task_status_to_thrift)

    def do_results(self, groups, query):
        task = self.server_ref.task_manager.get(groups["task"])
        max_wait = float(query.get("maxWaitMs", ["1000"])[0]) / 1000.0
        # X-Presto-Max-Size (PrestoHeaders.java:57): the consumer caps how
        # many bytes one response may carry; absent means uncapped
        max_size = self.headers.get("X-Presto-Max-Size")
        max_bytes = None
        if max_size:
            from .protocol import parse_data_size
            try:
                max_bytes = parse_data_size(max_size)
            except (ValueError, TypeError):
                max_bytes = None
        pages, next_token, complete = task.buffers.get(
            int(groups["buffer"]), int(groups["token"]), max_wait,
            max_bytes=max_bytes)
        body = b"".join(pages)
        # reference header names (PrestoHeaders.java:51-52 /
        # presto_protocol_core.cpp:82-84): the Java ExchangeClient reads
        # X-Presto-Page-Sequence-Id / X-Presto-Page-End-Sequence-Id.  The
        # pre-round-4 repo names are kept as aliases for older peers.
        self._send(200, None, body, headers={
            "X-Presto-Page-Sequence-Id": groups["token"],
            "X-Presto-Page-End-Sequence-Id": str(next_token),
            "X-Presto-Page-Token": groups["token"],
            "X-Presto-Page-Next-Token": str(next_token),
            "X-Presto-Buffer-Complete": "true" if complete else "false",
            "X-Presto-Task-Instance-Id": task.task_id,
        })

    def do_results_ack(self, groups, query):
        task = self.server_ref.task_manager.get(groups["task"])
        task.buffers.acknowledge(int(groups["buffer"]), int(groups["token"]))
        self._send(200, {"acknowledged": True})

    def do_results_destroy(self, groups, query):
        task = self.server_ref.task_manager.get(groups["task"])
        task.buffers.destroy(int(groups["buffer"]))
        self._send(200, {"destroyed": True})




class _QuerySpanListener:
    """EventListener bridging terminal queries to the telemetry exporter
    (a plain class with the listener surface: the manager dispatches by
    method name)."""

    def __init__(self, server: "WorkerServer"):
        self._server = server

    def query_created(self, event) -> None:
        pass

    def task_completed(self, event) -> None:
        pass

    def query_completed(self, event) -> None:
        self._server._export_query_spans(event)


class WorkerServer:
    """One worker (or coordinator) process node.  With coordinator=True the
    server also hosts the embedded discovery service, like the reference
    coordinator embeds Airlift discovery (PrestoServer.java:122).  Every
    task and every statement the server runs computes on `device`."""

    # every not-yet-closed server in this process (weak: a dropped server
    # must not be kept alive by the registry)
    _live: "weakref.WeakSet" = weakref.WeakSet()

    def __init__(self, port: int = 0, node_id: Optional[str] = None,
                 coordinator: bool = False,
                 discovery_uri: Optional[str] = None,
                 environment: str = "test",
                 config: Optional[ExecutionConfig] = None,
                 announce_interval_s: float = 1.0,
                 resource_groups=None, events=None,
                 jwt_enabled: bool = False, jwt_secret: str = "",
                 jwt_expiration_s: int = 300,
                 https_cert_path: Optional[str] = None,
                 https_key_path: Optional[str] = None,
                 internal_ca_path: Optional[str] = None,
                 plan_cache_entries: Optional[int] = None,
                 total_concurrency: Optional[int] = None,
                 admission_headroom_fraction: Optional[float] = None,
                 admission_memory_pool=None,
                 batch_window_ms: float = 3.0,
                 max_batch_size: int = 16,
                 compilation_cache_dir: Optional[str] = None,
                 plan_cache_path: Optional[str] = None,
                 telemetry_sink=None, telemetry_path: str = "",
                 telemetry_endpoint: str = "",
                 telemetry_flush_interval_s: float = 0.2,
                 telemetry_queue_bound: int = 256,
                 telemetry_metrics_interval_s: float = 0.0,
                 history_path: Optional[str] = None,
                 history_max_count: int = 200,
                 history_max_age_s: Optional[float] = None,
                 device="cuda"):
        from ..exec.runner import resolve_device
        # the device every runner computes on, resolved before the
        # listener opens: without CUDA, "cuda" fails the start-up
        self.device = resolve_device(device)
        self.environment = environment
        self.coordinator = coordinator
        self.state = "ACTIVE"            # ACTIVE | SHUTTING_DOWN
        self.discovery: Optional[Dict[str, dict]] = {} if coordinator else None
        self.discovery_lock = threading.Lock()
        self.started_at = time.time()
        self.exec_config = config or tuned_config()
        self.plan_cache_entries = plan_cache_entries
        if getattr(self.exec_config, "lock_validation", False):
            # debug.lock-validation=on arms the worker-wide base flag;
            # per-query session overrides compose scopes on top of it
            from ..common.locks import set_validation
            set_validation(True)

        handler = type("Handler", (_Handler,), {"server_ref": self})
        self.httpd = ThreadingHTTPServer(("127.0.0.1", port), handler)
        self.port = self.httpd.server_port
        scheme = "http"
        if https_cert_path:
            # TLS listener (reference https-cert-path / https-key-path,
            # Configs.h:211-212); the handshake is deferred to the
            # per-connection handler thread, so a silent peer cannot stall
            # the accept loop
            import ssl
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(https_cert_path,
                                https_key_path or None)
            base_get_request = self.httpd.get_request

            def tls_get_request():
                sock, addr = base_get_request()
                sock.settimeout(30)
                return ctx.wrap_socket(sock, server_side=True,
                                       do_handshake_on_connect=False), addr
            self.httpd.get_request = tls_get_request
            scheme = "https"
        self.scheme = scheme
        self.uri = f"{scheme}://127.0.0.1:{self.port}"
        self.node_id = node_id or f"node-{self.port}"
        from .auth import InternalAuth, set_process_auth
        self.auth = InternalAuth(jwt_enabled, jwt_secret, self.node_id,
                                 jwt_expiration_s)
        if jwt_enabled:
            set_process_auth(self.auth)
        if internal_ca_path:
            from .auth import set_internal_ca
            set_internal_ca(internal_ca_path)
        # the task plane: every task's fragment runs on this server's
        # device and its executor thread enters it
        self.task_manager = TaskManager(self.uri, config, events=events,
                                        device=self.device)
        # terminal-task eviction must not depend on new tasks arriving
        # (reference PeriodicTaskManager)
        self.task_manager.start_reaper()
        # coordinator role: liveness probing over discovered workers,
        # attached lazily when the first distributed statement runs
        self.failure_detector = None

        # persistent kernel cache (serving/persist.py): point the
        # generated kernels' cubin directory at disk BEFORE anything
        # compiles, so every kernel this process builds is reloadable
        # after a restart
        if compilation_cache_dir:
            from ..serving import enable_compilation_cache
            enable_compilation_cache(compilation_cache_dir)

        # coordinator role: client statement intake (worker/statement.py)
        self.dispatch = None
        self._runner_cache: Dict = {}
        self._runner_lock = threading.Lock()
        self._batcher = None
        self._sidecar = None
        if coordinator:
            from .statement import DispatchManager, ResourceGroupManager
            # micro-batched point queries: concurrent same-template
            # EXECUTEs collapse into one batched drain (max_batch_size=1
            # disables the window entirely)
            from ..serving import MicroBatcher
            self._batcher = MicroBatcher(window_ms=batch_window_ms,
                                         max_batch=max_batch_size)
            if plan_cache_path:
                from ..serving import PlanCacheSidecar
                self._sidecar = PlanCacheSidecar(plan_cache_path)
            if resource_groups is None and (
                    total_concurrency is not None
                    or admission_memory_pool is not None):
                resource_groups = ResourceGroupManager(
                    total_concurrency=total_concurrency,
                    memory_pool=admission_memory_pool,
                    **({"headroom_fraction": admission_headroom_fraction}
                       if admission_headroom_fraction is not None else {}))
            self.dispatch = DispatchManager(self._execute_statement,
                                            resource_groups, events=events)

        # telemetry export pipeline (telemetry/): bounded-queue
        # OTLP span/metric export through the configured sink.  The first
        # server to configure telemetry owns the process exporter slot that
        # deep execution layers (tasks, coordinator executions) publish
        # through; test clusters with several in-process servers share it.
        self.telemetry = None
        self._owns_process_exporter = False
        from ..telemetry import (TelemetryExporter, TelemetrySink,
                                 get_process_exporter, make_sink,
                                 set_process_exporter)
        sink = (telemetry_sink if isinstance(telemetry_sink, TelemetrySink)
                else make_sink(telemetry_sink or "none",
                               endpoint=telemetry_endpoint,
                               path=telemetry_path))
        if sink is not None:
            self.telemetry = TelemetryExporter(
                sink, queue_bound=telemetry_queue_bound,
                flush_interval_s=telemetry_flush_interval_s,
                metrics_interval_s=telemetry_metrics_interval_s,
                resource={"service.name": "presto-tpu",
                          "service.instance.id": self.node_id,
                          "deployment.environment": environment})
            if get_process_exporter() is None:
                set_process_exporter(self.telemetry)
                self._owns_process_exporter = True

        # query history service (coordinator role): terminal QueryInfo
        # records, retention-bounded, reloaded from the JSONL spool across
        # restarts; fed by QueryCompletedEvent through the dispatch event
        # manager so failures isolate like any other listener
        self.history = None
        self._history_listener = None
        if coordinator:
            from ..telemetry import HistoryEventListener, QueryHistoryStore
            self.history = QueryHistoryStore(
                history_path or None, max_count=history_max_count,
                max_age_s=history_max_age_s)
            self._history_listener = HistoryEventListener(
                self.history, extra_fields=self._history_extra_fields)
            self.dispatch.events.register(self._history_listener)
            # admission-time history sizing (adaptive.history-sizing):
            # the dispatch manager consults the same store for a repeat
            # query's observed peak memory
            self.dispatch.history = self.history
            # coordinator slice of the distributed trace: query +
            # per-stage fragment spans exported at terminal state (worker
            # processes export their own task/operator spans under the
            # same trace-token-derived trace id)
            self._span_listener = _QuerySpanListener(self)
            self.dispatch.events.register(self._span_listener)

        # system runtime tables (reference system connector): only the
        # coordinator registers, so the last-built worker of a
        # multi-server test cannot take the catalog over
        self._registered_system = False
        if coordinator:
            from ..connectors import catalog as _catalog
            from ..connectors.system_tables import SystemTablesConnector
            _catalog.register_connector("system",
                                        SystemTablesConnector(self))
            self._registered_system = True

        # warm restart: replay recorded exemplars BEFORE the listener
        # opens -- the planning and kernel loads land at boot, not on the
        # first client (the kernels load from the compilation cache)
        if self._sidecar is not None:
            self._warm_start_replay()

        self._serve_thread = threading.Thread(
            target=self.httpd.serve_forever, name=f"http-{self.port}",
            daemon=True)
        self._serve_thread.start()

        self._announcer: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._closed = False
        WorkerServer._live.add(self)
        if discovery_uri:
            self._announcer = threading.Thread(
                target=self._announce_loop,
                args=(discovery_uri, announce_interval_s),
                name=f"announcer-{self.node_id}", daemon=True)
            self._announcer.start()

    def _announce_loop(self, discovery_uri: str, interval_s: float) -> None:
        """PUT /v1/announcement/{nodeId} periodically (reference
        presto_cpp/main/Announcer.cpp:59-74)."""
        import urllib.request
        body = json.dumps(make_announcement(
            self.node_id, self.uri, self.environment)).encode()
        url = f"{discovery_uri}/v1/announcement/{self.node_id}"
        while not self._stop.is_set():
            try:
                from .auth import outbound_headers, urlopen_internal
                req = urllib.request.Request(
                    url, data=body, method="PUT",
                    headers={"Content-Type": "application/json",
                             **outbound_headers()})
                urlopen_internal(req, timeout=5).close()
            except OSError:
                pass  # coordinator not up yet; retry next tick
            self._stop.wait(interval_s)

    def worker_uris(self) -> list:
        """Discovered worker URIs (coordinator role)."""
        with self.discovery_lock:
            return [a["services"][0]["properties"]["http"]
                    for a in (self.discovery or {}).values()]

    def _runner_for(self, schema, catalog, session):
        """Get-or-build the cached query runner for one (workers, schema,
        catalog, session) combination, on the server's device.  With
        workers announced it is an HttpQueryRunner over them (with a
        failure detector); otherwise a LocalQueryRunner with its own
        PlanCache (serving.plan-cache-entries bounds each).  Runners are
        cached so repeated statements reuse the plan cache and warm
        pipelines; DDL invalidates the cache (it may change any
        catalog's tables)."""
        from .protocol import apply_session_properties
        cfg = apply_session_properties(self.exec_config, session)
        uris = tuple(sorted(u for u in self.worker_uris() if u != self.uri))
        key = (uris, schema, catalog, tuple(sorted(session.items())))
        with self._runner_lock:
            runner = self._runner_cache.get(key)
            if runner is None:
                if uris:
                    from .coordinator import (HeartbeatFailureDetector,
                                              HttpQueryRunner)
                    det = HeartbeatFailureDetector(
                        list(uris),
                        heartbeat_timeout_s=(
                            cfg.failure_detector_heartbeat_timeout_s
                            or None))
                    runner = HttpQueryRunner(list(uris), schema=schema,
                                             config=cfg, session=session,
                                             failure_detector=det,
                                             catalog=catalog,
                                             device=self.device)
                    self.failure_detector = det
                else:
                    from ..exec.runner import LocalQueryRunner
                    from ..serving import PlanCache
                    cache = (PlanCache(self.plan_cache_entries)
                             if self.plan_cache_entries is not None
                             else PlanCache())
                    runner = LocalQueryRunner(schema, config=cfg,
                                              catalog=catalog,
                                              plan_cache=cache,
                                              device=self.device)
                self._runner_cache[key] = runner
                while len(self._runner_cache) > 16:
                    old = self._runner_cache.pop(
                        next(iter(self._runner_cache)))
                    self._close_runner(old)
        return runner, uris

    @staticmethod
    def _batch_template_text(runner, q) -> Optional[str]:
        """The prepared-template text behind an EXECUTE..USING statement,
        or None when the statement is not batchable traffic.  The text is
        the micro-batch group key: requests resolve to the same key only
        when a single canonical plan serves them."""
        m = re.match(r"\s*execute\s+([A-Za-z_][A-Za-z0-9_]*)\s+using\b",
                     q.sql, re.IGNORECASE)
        if m is None:
            return None
        name = m.group(1)
        return ((q.prepared or {}).get(name)
                or getattr(runner, "_prepared", {}).get(name))

    def _execute_statement(self, q):
        """DispatchManager executor: run a managed query over the
        discovered workers (HttpQueryRunner) or in-process when none are
        announced.  Single-node EXECUTE..USING traffic first passes
        the micro-batcher: requests against the same template that land
        inside one batching window run as ONE batched drain
        (exec/runner.py execute_prepared_batch); everything else -- and
        every lane the drain declines -- takes `_run_single`, the
        sequential path."""
        runner, uris = self._runner_for(q.schema, q.catalog, q.session)
        result = None
        served = False
        if (not uris and self._batcher is not None
                and self._batcher.enabled):
            text = self._batch_template_text(runner, q)
            if text is not None:
                result = self._batcher.run(
                    (id(runner), text), q,
                    lambda items: runner.execute_prepared_batch(
                        [it.sql for it in items],
                        prepared=[it.prepared for it in items]),
                    lambda item: self._run_single(runner, uris, item))
                served = True
        if not served:
            result = self._run_single(runner, uris, q)
        if self._sidecar is not None:
            self._record_sidecar(q)
        return result

    def _record_sidecar(self, q) -> None:
        """Persist a warm-start exemplar for a successfully served
        statement (PlanCacheSidecar dedups per template)."""
        head = q.sql.lstrip().split(None, 1)
        word = head[0].lower() if head else ""
        if word not in ("select", "with", "prepare", "execute"):
            return
        try:
            self._sidecar.record(q.sql, q.prepared, q.catalog, q.schema,
                                 q.session)
        except Exception:   # noqa: BLE001 -- persistence is advisory
            pass

    def _warm_start_replay(self) -> int:
        """Replay the sidecar's recorded exemplars through the same runner
        path that serves traffic: each replay re-registers its prepared
        statement, re-records the skip-parse fast path and re-inserts the
        canonical PlanCache entry, its generated kernels loading from the
        compilation cache instead of compiling.  Runs before the HTTP
        listener starts, so the first client request after a restart is
        already a warm hit."""
        n = 0
        for rec in self._sidecar.load():
            try:
                runner, uris = self._runner_for(
                    rec["schema"], rec["catalog"],
                    rec.get("session") or {})
                if uris:
                    continue    # warm start serves the single-node plane
                runner.execute(rec["sql"],
                               prepared=rec.get("prepared") or {})
                n += 1
            except Exception:   # noqa: BLE001 -- a stale exemplar (dropped
                continue        # table, bad session) must not block boot
        return n

    def _run_single(self, runner, uris, q):
        """The sequential path.  Single-node: a SELECT or EXECUTE streams
        its rows chunk by chunk (the coordinator never materializes the
        full result, reference Query.java); an EXPLAIN, a PREPARE, a
        DEALLOCATE or a write runs materialized.  Distributed: the
        HttpQueryRunner runs the statement over the workers and its
        execution's stage / task snapshot is kept for /v1/query/{id}.  A
        write drops every cached runner and clears the sidecar (their
        plans and recorded exemplars may read the changed table)."""
        if not uris:
            sr = runner.execute_streaming(q.sql, prepared=q.prepared)
            if sr is not None:
                from .statement import StreamingResult, _json_value
                columns, row_iter, stats = sr
                return StreamingResult(
                    columns,
                    ([_json_value(v) for v in row] for row in row_iter),
                    stats)
            result = runner.execute(q.sql, prepared=q.prepared)
        else:
            result = runner.execute(q.sql, trace_token=q.trace_token)
            exe = getattr(runner, "last_execution", None)
            if exe is not None and getattr(exe, "trace_token",
                                           "") == q.trace_token:
                try:
                    # terminal snapshot: tasks stay queryable on workers
                    # until TTL eviction
                    q.query_info_extra = exe.query_info_snapshot()
                except Exception:  # noqa: BLE001 -- snapshot best-effort
                    pass
        if q.sql.lstrip()[:6].lower() in ("create", "insert") \
                or q.sql.lstrip()[:4].lower() == "drop":
            with self._runner_lock:
                for r in self._runner_cache.values():
                    self._close_runner(r)
                self._runner_cache.clear()
            if self._sidecar is not None:
                # a replayed exemplar would re-plan against changed tables
                self._sidecar.clear()
        return result

    def live_query_info(self, trace_token: str) -> Optional[dict]:
        """Live stage/task/operator snapshot for a RUNNING distributed
        query, matched to its execution by trace token (the runner cache
        is shared across queries, so the token is the join key)."""
        if not trace_token:
            return None
        with self._runner_lock:
            runners = list(self._runner_cache.values())
        for r in runners:
            exe = getattr(r, "last_execution", None)
            if exe is not None and getattr(exe, "trace_token",
                                           "") == trace_token:
                try:
                    return exe.query_info_snapshot()
                except Exception:  # noqa: BLE001 -- snapshot best-effort
                    return None
        return None

    @staticmethod
    def _close_runner(runner) -> None:
        det = getattr(runner, "failure_detector", None)
        if det is not None:
            det.close()

    def _history_extra_fields(self, event) -> dict:
        """Enrich the history record with state the completed event does
        not carry: the profiler capture dir and the per-stage breakdown
        summary of a distributed run."""
        try:
            q = self.dispatch.get(event.query_id)
        except KeyError:
            return {}
        extra = {}
        if q.profile_trace_dir:
            extra["profileTraceDir"] = q.profile_trace_dir
        stages = (q.query_info_extra or {}).get("stages")
        if stages:
            extra["nStages"] = len(stages)
            extra["nTasks"] = sum(st.get("nTasks", 0) for st in stages)
        return extra

    def _export_query_spans(self, event) -> None:
        """Coordinator-side slice of the distributed trace for one
        terminal query: a `query` root span plus a `fragment {fid}` span
        per stage, exported under the trace id derived from the query's
        trace token.  Worker processes export their own `task ...` /
        `operator ...` spans with `fragment {fid}` parents, so the
        deterministic (token, name) span ids stitch both slices into ONE
        OTLP trace with no id handshake."""
        exp = self.telemetry
        if exp is None:
            from ..telemetry import get_process_exporter
            exp = get_process_exporter()
        if exp is None or not event.trace_token:
            return
        from ..utils.runtime_stats import Span
        try:
            q = self.dispatch.get(event.query_id)
        except KeyError:
            q = None
        started = (q.started_at if q is not None and q.started_at
                   else event.create_time)
        spans = [Span("query", "", start=started, end=event.end_time,
                      attributes={"queryId": event.query_id,
                                  "sql": event.sql, "user": event.user,
                                  "state": event.state,
                                  "rows": event.rows})]
        extra = q.query_info_extra if q is not None else None
        for st in (extra or {}).get("stages") or []:
            fid = st.get("fragmentId", st.get("stageId", 0))
            wall = float(st.get("wallTimeInNanos", 0) or 0) / 1e9
            spans.append(Span(
                f"fragment {fid}", "query", start=started,
                end=(min(event.end_time, started + wall) if wall
                     else event.end_time),
                attributes={"nTasks": st.get("nTasks", 0),
                            "partitioning": st.get("partitioning", "")}))
        exp.export_spans(event.trace_token, spans,
                         resource={"presto.role": "coordinator",
                                   "presto.node_id": self.node_id})

    def plan_cache_info(self) -> dict:
        """The runners' plan caches, summed."""
        with self._runner_lock:
            infos = [r.plan_cache.info()
                     for r in self._runner_cache.values()]
        keys = ("entries", "hits", "misses", "evictions", "invalidations",
                "poolExhausted", "checkedOut")
        out = {k: sum(i[k] for i in infos) for k in keys}
        out["runners"] = len(infos)
        out["maxEntriesPerRunner"] = (infos[0]["maxEntries"] if infos
                                      else self.plan_cache_entries)
        return out

    def device_memory(self) -> dict:
        """The device allocator's gauges (zeros on the CPU)."""
        import torch
        out = {"device": str(self.device), "allocated_bytes": 0,
               "peak_allocated_bytes": 0, "reserved_bytes": 0}
        if self.device.type == "cuda":
            out.update(
                allocated_bytes=torch.cuda.memory_allocated(self.device),
                peak_allocated_bytes=torch.cuda.max_memory_allocated(
                    self.device),
                reserved_bytes=torch.cuda.memory_reserved(self.device))
        return out

    def process_metrics(self) -> dict:
        """Process-wide metric registries, namespaced like the /v1/metrics
        sections -- included in QueryInfo so one snapshot carries both
        query- and process-scoped state."""
        from ..exec.kernels import scan_kernel as sk
        from ..serving import SERVING_METRICS
        from ..storage.store import STORAGE_METRICS
        # the kernel roll-up with each wrapper's launch count and, of
        # those, the launches that ran the stage ring
        kernel = dict(sk.KERNEL_METRICS.snapshot(),
                      launches=dict(sk.LAUNCHES),
                      staged_launches=dict(sk.STAGED_LAUNCHES))
        return {"serving": SERVING_METRICS.snapshot(),
                "storage": STORAGE_METRICS.snapshot(),
                "kernel": kernel,
                "memory": self.device_memory()}

    def _unregister_system(self) -> None:
        if self._registered_system:
            from ..connectors import catalog as _catalog
            conn = _catalog._CONNECTORS.get("system")
            if conn is not None and getattr(conn, "server", None) is self:
                _catalog.unregister_connector("system")
            self._registered_system = False

    def shutdown(self) -> None:
        """Stop serving (alias of close())."""
        self.close()

    def begin_shutdown(self) -> None:
        """Refuse new tasks, wait for running ones to drain, then stop the
        server (reference GracefulShutdownHandler / native
        PrestoServer.cpp:648-688)."""
        with self.discovery_lock:
            if self.state != "ACTIVE":
                return
            self.state = "SHUTTING_DOWN"

        def drain():
            # grace period first, so the coordinator observes the drain
            # state before the endpoints disappear (the reference waits
            # 2x the announcement interval for the same reason)
            time.sleep(2.0)
            deadline = time.time() + 30.0
            while time.time() < deadline:
                counts = self.task_manager.counts()["by_state"]
                if not any(s in ("RUNNING", "PLANNED") for s in counts):
                    break
                time.sleep(0.1)
            # spooled output (retry-policy=task) outlives task completion:
            # make it durable, then keep serving /results until every
            # consumer has drained it (final DELETE or acked-to-end), so
            # in-flight queries finish with zero failures before we exit
            try:
                self.task_manager.flush_spools()
            except Exception:  # noqa: BLE001 -- drain is best-effort
                pass
            while time.time() < deadline:
                if self.task_manager.all_output_consumed():
                    break
                time.sleep(0.1)
            self.close()
        threading.Thread(target=drain, name="drain", daemon=True).start()

    def close(self) -> None:
        from .auth import clear_process_auth
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        try:
            clear_process_auth(self.auth)
            self._unregister_system()
            with self._runner_lock:
                for r in self._runner_cache.values():
                    self._close_runner(r)
                self._runner_cache.clear()
            self.task_manager.cancel_all()
            if self.dispatch is not None:
                if self._history_listener is not None:
                    self.dispatch.events.unregister(self._history_listener)
                span_listener = getattr(self, "_span_listener", None)
                if span_listener is not None:
                    self.dispatch.events.unregister(span_listener)
            if self.telemetry is not None:
                from ..telemetry import (get_process_exporter,
                                         set_process_exporter)
                if self._owns_process_exporter and \
                        get_process_exporter() is self.telemetry:
                    set_process_exporter(None)
                self.telemetry.close()
            if getattr(self.exec_config, "lock_validation", False):
                # disarm the base flag this server armed at init (session
                # scopes are counted separately and unwind on their own)
                from ..common.locks import set_validation
                set_validation(False)
        finally:
            # the listener MUST die even if teardown raised
            WorkerServer._live.discard(self)
            self.httpd.shutdown()
            self.httpd.server_close()

    @classmethod
    def close_all_live(cls) -> None:
        """Close every still-open server in this process (test sweep)."""
        for server in list(cls._live):
            try:
                server.close()
            except Exception:   # noqa: BLE001 -- a sweep closes the rest
                pass
