"""Worker HTTP server: the coordinator's client statement plane.

The port of presto_tpu/worker/server.py for a single-node coordinator
(WorkerServer(coordinator=True)), the path `python -m
presto_tpu_torch.worker --etc-dir DIR` boots: the HTTP surface of the
reference (presto_cpp/main/TaskResource.cpp / PrestoServer.cpp endpoint
setup) on Python's stdlib threading HTTP server.

  POST   /v1/statement                          client statement intake
  GET    /v1/statement/{queued,executing}/...   nextUri pages
  DELETE /v1/statement/...                      cancel
  GET    /v1/query, /v1/query/{id}              query list / QueryInfo
  GET    /v1/info, /v1/info/state, /v1/status, /v1/cluster
  PUT    /v1/info/state                         graceful shutdown (drain)
  GET    /v1/metrics                            Prometheus text exposition
  PUT    /v1/announcement/{nodeId}, GET /v1/service   discovery
  GET    /ui                                    query list page

Statements run on DispatchManager threads through one LocalQueryRunner
per (schema, catalog, session) on the server's device (`device`, "cuda"
by default: without CUDA the server refuses to start), each runner with
its own PlanCache.  The serving plane is the reference's: concurrent
EXECUTEs of one prepared template pass the micro-batcher
(serving/batching.py, `batch_window_ms` / `max_batch_size`), served
statements are recorded in the plan-cache sidecar (`plan_cache_path`)
and replayed before the listener opens, the generated kernels' cubins
persist in `compilation_cache_dir`, and a CREATE, INSERT or DROP drops
the runners and clears the sidecar.  What the port lacks answers with an
error naming it, never a quiet default: the task plane (/v1/task/...,
worker/task.py with its buffers and exchange) and /v1/plan-check answer
501; a statement on a coordinator that other workers announced to fails
(the distributed HttpQueryRunner, worker/coordinator.py); the telemetry
and history arguments raise at construction.
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
from .protocol import make_announcement

# the reference WorkerServer's arguments the port lacks, with what they
# configure
_UNPORTED_ARGS = {
    "telemetry_sink": "telemetry export (telemetry/)",
    "telemetry_path": "telemetry export (telemetry/)",
    "telemetry_endpoint": "telemetry export (telemetry/)",
    "telemetry_flush_interval_s": "telemetry export (telemetry/)",
    "telemetry_queue_bound": "telemetry export (telemetry/)",
    "telemetry_metrics_interval_s": "telemetry export (telemetry/)",
    "history_path": "query history (telemetry/history.py)",
    "history_max_count": "query history (telemetry/history.py)",
    "history_max_age_s": "query history (telemetry/history.py)",
}
# what the unported task routes name
_TASK_PLANE = ("the task plane (worker/task.py, buffers.py, exchange.py) "
               "is not ported")

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
        presto_cpp PrestoServer.cpp:648-688): stop accepting work, then
        report SHUTTING_DOWN until the process exits."""
        body = json.loads(self._body())
        if body != "SHUTTING_DOWN":
            self._send(400, {"error": f"unsupported state {body!r}"})
            return
        self.server_ref.begin_shutdown()
        self._send(200, "SHUTTING_DOWN")

    def do_status(self, groups, query):
        """Node status (reference server/NodeStatus.java).  The port runs
        no tasks (the task plane is not ported), so the task counts are
        zero; heapUsed is the device allocator's peak."""
        s = self.server_ref
        self._send(200, {
            "nodeId": s.node_id,
            "nodeVersion": {"version": "presto-tpu-0.1"},
            "environment": s.environment,
            "coordinator": s.coordinator,
            "state": s.state,
            "uptime": f"{time.time() - s.started_at:.0f}s",
            "tasks": {},
            "totalTasks": 0,
            "tasksFailed": 0,
            "tasksRetried": 0,
            "heapUsed": s.device_memory()["peak_allocated_bytes"],
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
        the registries the port has: serving, storage, the scan and
        window kernels (with the stage ring's counters), device memory
        and resource groups."""
        s = self.server_ref
        lines = [
            "# TYPE presto_tpu_uptime_seconds gauge",
            f"presto_tpu_uptime_seconds {time.time() - s.started_at:.1f}",
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
        """/v1/query[?state=...]: the live dispatch registry (the
        reference merges its history store, which is not ported)."""
        d = self._dispatch_mgr()
        if d is None:
            return
        state = (query.get("state", [None])[0] or "").upper() or None
        self._send(200, [q for q in d.list_queries()
                         if state is None or q["state"] == state])

    def do_cluster(self, groups, query):
        """/v1/cluster (reference ClusterStatsResource): query counts by
        lifecycle bucket, workers, admission memory."""
        s = self.server_ref
        d = s.dispatch
        if d is None:
            self._send(404, {"error": "not a coordinator"})
            return
        by_state: Dict[str, int] = {}
        for q in d.list_queries():
            by_state[q["state"]] = by_state.get(q["state"], 0) + 1
        queued = by_state.get("QUEUED", 0)
        adm = d.resource_groups.info().get("__admission", {})
        headroom = adm.get("memoryHeadroomBytes")
        reserved = max(adm.get("memoryAdmittedBytes", 0),
                       adm.get("memoryReservedBytes", 0)
                       + adm.get("memoryRevocableBytes", 0))
        blocked = queued if (headroom is not None and queued
                             and reserved >= headroom) else 0
        self._send(200, {
            "runningQueries": by_state.get("RUNNING", 0),
            "queuedQueries": queued,
            "blockedQueries": blocked,
            "finishedQueries": by_state.get("FINISHED", 0),
            "failedQueries": by_state.get("FAILED", 0),
            "canceledQueries": by_state.get("CANCELED", 0),
            "activeWorkers": len(s.worker_uris()),
            "runningTasks": 0,
            "totalTasks": 0,
            "reservedMemoryBytes": reserved,
            "revocableMemoryBytes": adm.get("memoryRevocableBytes", 0),
            **({"memoryHeadroomBytes": headroom}
               if headroom is not None else {}),
        })

    def do_query_info(self, groups, query):
        d = self._dispatch_mgr()
        if d is None:
            return
        try:
            q = d.get(groups["qid"])
        except KeyError:
            self._send(404, {"error": "unknown query"})
            return
        self._send(200, {
            "queryId": q.query_id, "query": q.sql, "state": q.state,
            "traceToken": q.trace_token,
            "queryStats": q.stats(), "session": q.session,
            "resourceGroupId": [q.resource_group],
            "peakMemoryBytes": q.peak_memory_bytes,
            **({"runtimeStats": q.runtime_stats}
               if q.runtime_stats else {}),
            **({"failureInfo": {"message": q.error}} if q.error else {}),
            "processMetrics": self.server_ref.process_metrics(),
            "resourceGroups": d.resource_groups.info()})

    # -- what the port lacks ----------------------------------------------
    def do_task_update(self, groups, query):
        self._send(501, {"error": _TASK_PLANE})

    do_task_status = do_task_info = do_task_delete = do_task_update
    do_results = do_results_ack = do_results_destroy = do_task_update

    def do_plan_check(self, groups, query):
        self._send(501, {"error": "the plan-check sidecar (worker/router.py) "
                                  "is not ported"})

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




class WorkerServer:
    """One coordinator process node (coordinator=True: statement intake
    and the embedded discovery service, like the reference coordinator
    embeds Airlift discovery, PrestoServer.java:122).  Without
    coordinator=True the server answers /v1/info-style endpoints only:
    the worker's task plane is not ported."""

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
                 device="cuda", **unported):
        for name in unported:
            if name not in _UNPORTED_ARGS:
                raise TypeError(f"WorkerServer got an unexpected keyword "
                                f"argument {name!r}")
            raise NotImplementedError(
                f"WorkerServer({name}=...): {_UNPORTED_ARGS[name]} is not "
                f"ported")
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
        """Get-or-build the cached LocalQueryRunner for one (schema,
        catalog, session) combination, on the server's device and with
        its own PlanCache (serving.plan-cache-entries bounds each).  A
        coordinator other workers announced to would run the statement
        distributed in the reference (HttpQueryRunner), which is not
        ported: the statement fails naming it."""
        from .protocol import apply_session_properties
        cfg = apply_session_properties(self.exec_config, session)
        uris = tuple(sorted(u for u in self.worker_uris() if u != self.uri))
        if uris:
            raise NotImplementedError(
                f"distributed execution over {len(uris)} announced "
                f"worker(s) (worker/coordinator.py HttpQueryRunner) is not "
                f"ported")
        key = (schema, catalog, tuple(sorted(session.items())))
        with self._runner_lock:
            runner = self._runner_cache.get(key)
            if runner is None:
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
                    self._runner_cache.pop(next(iter(self._runner_cache)))
        return runner

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
        """DispatchManager executor.  EXECUTE..USING traffic first passes
        the micro-batcher: requests against the same template that land
        inside one batching window run as ONE batched drain
        (exec/runner.py execute_prepared_batch); everything else -- and
        every lane the drain declines -- takes `_run_single`, the
        sequential path."""
        runner = self._runner_for(q.schema, q.catalog, q.session)
        result = None
        served = False
        if self._batcher is not None and self._batcher.enabled:
            text = self._batch_template_text(runner, q)
            if text is not None:
                result = self._batcher.run(
                    (id(runner), text), q,
                    lambda items: runner.execute_prepared_batch(
                        [it.sql for it in items],
                        prepared=[it.prepared for it in items]),
                    lambda item: self._run_single(runner, item))
                served = True
        if not served:
            result = self._run_single(runner, q)
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
                runner = self._runner_for(rec["schema"], rec["catalog"],
                                          rec.get("session") or {})
                runner.execute(rec["sql"],
                               prepared=rec.get("prepared") or {})
                n += 1
            except Exception:   # noqa: BLE001 -- a stale exemplar (dropped
                continue        # table, bad session) must not block boot
        return n

    def _run_single(self, runner, q):
        """The sequential path: a single-node SELECT or EXECUTE streams
        its rows chunk by chunk (the coordinator never materializes the
        full result, reference Query.java); an EXPLAIN, a PREPARE, a
        DEALLOCATE or a write runs materialized, and a write drops every
        cached runner and clears the sidecar (their plans and recorded
        exemplars may read the changed table)."""
        sr = runner.execute_streaming(q.sql, prepared=q.prepared)
        if sr is not None:
            from .statement import StreamingResult, _json_value
            columns, row_iter, stats = sr
            return StreamingResult(
                columns,
                ([_json_value(v) for v in row] for row in row_iter),
                stats)
        result = runner.execute(q.sql, prepared=q.prepared)
        if q.sql.lstrip()[:6].lower() in ("create", "insert") \
                or q.sql.lstrip()[:4].lower() == "drop":
            with self._runner_lock:
                self._runner_cache.clear()
            if self._sidecar is not None:
                # a replayed exemplar would re-plan against changed tables
                self._sidecar.clear()
        return result

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
        """Refuse new work, then stop the server after a grace period
        (reference GracefulShutdownHandler / native
        PrestoServer.cpp:648-688; the reference then drains tasks, and
        the port runs none)."""
        with self.discovery_lock:
            if self.state != "ACTIVE":
                return
            self.state = "SHUTTING_DOWN"

        def drain():
            # the coordinator observes the drain state before the
            # endpoints disappear (the reference waits 2x the
            # announcement interval for the same reason)
            time.sleep(2.0)
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
                self._runner_cache.clear()
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
