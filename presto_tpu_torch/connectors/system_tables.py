"""System runtime tables: SQL-queryable cluster state — the analog of the
reference's system connector (presto-main-base/.../connector/system/:
system.runtime.nodes, system.runtime.queries; native SystemConnector in
presto_cpp/main/connectors/SystemConnector.{h,cpp} serves task info the
same way).

A SystemTablesConnector binds to a live WorkerServer and snapshots its
discovery map / dispatch registry at scan time, so
`SELECT * FROM runtime_nodes` (catalog "system") answers from the
coordinator's own state.

The port of presto_tpu/connectors/system_tables.py.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..common.types import BIGINT, BOOLEAN, Type, VarcharType
from .memory import _to_connector_column

V = VarcharType(128)

SCHEMAS_DEF: Dict[str, List[Tuple[str, Type]]] = {
    "runtime_nodes": [
        ("node_id", V), ("http_uri", V), ("node_version", V),
        ("coordinator", BOOLEAN), ("state", V),
    ],
    "runtime_queries": [
        ("query_id", V), ("state", V), ("user", V), ("source", V),
        ("resource_group_id", V), ("queued_time_ms", BIGINT),
        ("elapsed_time_ms", BIGINT),
    ],
    "runtime_tasks": [
        ("task_id", V), ("state", V), ("output_rows", BIGINT),
        ("output_bytes", BIGINT), ("memory_reservation", BIGINT),
    ],
}


class SystemTablesConnector:
    OPEN_DOMAIN: set = set()
    ROWID_ORDERED: set = set()
    ROWID_DISTINCT: set = set()
    SCHEMAS = SCHEMAS_DEF
    PREFIXES = {t: "" for t in SCHEMAS_DEF}

    def __init__(self, server):
        self.server = server
        # per-table snapshot, refreshed when a scan sizes its splits
        # (table_row_count) so every column of one scan reads one
        # consistent view of the live server state
        self._snap: Dict[str, List[list]] = {}

    # -- snapshots --------------------------------------------------------
    def _rows(self, table: str) -> List[list]:
        s = self.server
        if table == "runtime_nodes":
            out = [[s.node_id, s.uri, "presto-tpu-0.1", s.coordinator,
                    s.state]]
            if s.discovery is not None:
                with s.discovery_lock:
                    for nid, svc in s.discovery.items():
                        if nid == s.node_id:
                            continue
                        out.append([nid, svc.get("uri", ""),
                                    "presto-tpu-0.1", False, "ACTIVE"])
            return out
        if table == "runtime_queries":
            if getattr(s, "dispatch", None) is None:
                return []
            import time
            out = []
            with s.dispatch._lock:
                qs = list(s.dispatch._queries.values())
            for q in qs:
                now = q.finished_at or time.time()
                out.append([q.query_id, q.state, q.user, q.source,
                            q.resource_group,
                            int(((q.started_at or now) - q.created_at)
                                * 1000),
                            int((now - q.created_at) * 1000)])
            return out
        if table == "runtime_tasks":
            with s.task_manager._lock:
                tasks = list(s.task_manager.tasks.values())
            return [[t.task_id, t.state, t.output_rows, t.output_bytes,
                     t.memory_peak] for t in tasks]
        raise KeyError(table)

    # -- connector contract ----------------------------------------------
    def column_type(self, table: str, column: str) -> Type:
        return dict(SCHEMAS_DEF[table])[column]

    def table_row_count(self, table: str, sf: float) -> int:
        self._snap[table] = self._rows(table)
        return len(self._snap[table])

    def _snapshot(self, table: str) -> List[list]:
        snap = self._snap.get(table)
        if snap is None:
            snap = self._snap[table] = self._rows(table)
        return snap

    def generate_column(self, table: str, column: str, sf: float,
                        start: int, count: int):
        schema = SCHEMAS_DEF[table]
        ci = [n for n, _ in schema].index(column)
        typ = schema[ci][1]
        rows = self._snapshot(table)[start:start + count]
        vals = [r[ci] for r in rows]
        return _to_connector_column(typ, vals, [False] * len(vals))

    def generate_values_at(self, table: str, column: str, sf: float, ids):
        schema = SCHEMAS_DEF[table]
        ci = [n for n, _ in schema].index(column)
        rows = self._snapshot(table)
        return [rows[int(i)][ci] if int(i) < len(rows) else None
                for i in np.asarray(ids)]

    def column_stats(self, table: str, column: str, sf: float):
        return None
