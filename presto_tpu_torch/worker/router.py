"""Stateless query router across coordinators/clusters.

The analog of presto-router (RouterResource + pluggable scheduler,
presto-router/.../router/) combined with the plan-checker router plugin
(presto-plan-checker-router-plugin: send a query to the TPU-native cluster
only if its planner accepts it, else fall back to another cluster —
`javaClusterFallbackEnabled`, PlanCheckerRouterPluginConfig.java:36).

The router serves the same `POST /v1/statement` surface clients already
speak and answers with an HTTP 307 redirect to the chosen cluster's
statement endpoint — the reference router does exactly this (clients
follow the redirect and then poll `nextUri` on the target coordinator
directly, so the router stays stateless and off the data path).

Schedulers: round_robin (RandomChoice/RoundRobin analogs) and
plan_check — validate the SQL against the native planner first and route
unplannable queries to the configured fallback cluster (the sidecar plan
validation seam, presto-native-sidecar-plugin/.../nativechecker/)."""
from __future__ import annotations

import itertools
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional


def plan_checks(sql: str, schema: str = "sf0.01",
                catalog: str = "tpch") -> Optional[str]:
    """None when the native planner accepts the statement, else the
    planning error (the /v1/plan-check validation used by the router and
    exposed by the coordinator as a sidecar endpoint)."""
    from ..sql.planner import Planner, PlanningError
    from ..sql import parser as A
    try:
        ast = A.parse_sql(sql)
        if isinstance(ast, (A.CreateTableAs, A.InsertInto)):
            Planner(schema, catalog).plan_write(ast)
        elif isinstance(ast, A.DropTable):
            pass
        else:
            q = ast.query if isinstance(ast, A.Explain) else ast
            Planner(schema, catalog).plan_query_to_output(q)
        return None
    except Exception as e:  # noqa: BLE001 — any failure = not plannable
        return f"{type(e).__name__}: {e}"


class QueryRouter:
    """HTTP router process: POST /v1/statement -> 307 to a cluster."""

    def __init__(self, clusters: List[str], port: int = 0,
                 scheduler: str = "round_robin",
                 fallback: Optional[str] = None):
        """clusters: coordinator base URIs the router balances over.
        scheduler 'plan_check': route to clusters[...] only when the native
        planner accepts the query, else to `fallback`."""
        self.clusters = list(clusters)
        self.scheduler = scheduler
        self.fallback = fallback
        self._rr = itertools.count()
        self._lock = threading.Lock()

        router = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # noqa: D102
                pass

            def do_POST(self):
                if not re.match(r"^/v1/statement/?$", self.path):
                    self._reply(404, b'{"error": "not found"}')
                    return
                length = int(self.headers.get("Content-Length", 0))
                sql = self.rfile.read(length).decode()
                target = router.route(
                    sql,
                    schema=self.headers.get("X-Presto-Schema", "sf0.01"),
                    catalog=self.headers.get("X-Presto-Catalog", "tpch"))
                if target is None:
                    self._reply(503, b'{"error": "no cluster available"}')
                    return
                self.send_response(307)
                self.send_header("Location", f"{target}/v1/statement")
                self.send_header("Content-Length", "0")
                self.end_headers()

            def do_GET(self):
                if self.path == "/v1/router/clusters":
                    import json
                    body = json.dumps({
                        "clusters": router.clusters,
                        "scheduler": router.scheduler,
                        "fallback": router.fallback}).encode()
                    self._reply(200, body)
                    return
                self._reply(404, b'{"error": "not found"}')

            def _reply(self, code: int, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self.httpd.server_port
        self.uri = f"http://127.0.0.1:{self.port}"
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        name=f"router-{self.port}",
                                        daemon=True)
        self._thread.start()

    def route(self, sql: str, schema: str = "sf0.01",
              catalog: str = "tpch") -> Optional[str]:
        if self.scheduler == "plan_check":
            if plan_checks(sql, schema, catalog) is None:
                return self._next()
            return self.fallback
        return self._next()

    def _next(self) -> Optional[str]:
        if not self.clusters:
            return self.fallback
        with self._lock:
            return self.clusters[next(self._rr) % len(self.clusters)]

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
