"""Durable serving-plane state: warm restarts without recompiling (the
port of presto_tpu/serving/persist.py).

Two pieces, both wired by the worker server when the corresponding etc/
properties are set:

1. `enable_compilation_cache(dir)` points the generated kernels' NVRTC
   cubin cache (exec/kernels/build.py GEN_DIR, read by load_generated)
   at a directory -- the port's counterpart of JAX's persistent
   compilation cache.  A kernel this process compiles or loads is
   written there, so a restarted process loads each cubin instead of
   compiling it again.  The nvcc-built libraries (scan_grouped,
   window_scan) stay in build/presto_tpu_torch/: they are built once per
   source hash, not per query shape.

2. `PlanCacheSidecar` -- a JSONL record of the statements the serving
   tier served (one exemplar per prepared template / catalog / schema /
   session combination), a host copy of the reference's.  On restart the
   coordinator REPLAYS each record through the same runner path that
   serves traffic: the replay re-registers the prepared statement,
   re-records the fast path and re-inserts the canonical PlanCache entry
   (its generated kernels loading from the compilation cache above), so
   the first real client request after a restart is a warm hit.

DDL invalidates the sidecar along with the plan cache: a replayed plan
against changed tables would resurrect stale state.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

from ..common.locks import OrderedLock

DEFAULT_SIDECAR_MAX_COUNT = 512


def enable_compilation_cache(path: str) -> bool:
    """Point the generated kernels' cubin cache at `path` (created when
    missing).  Returns True when the directory was accepted; persistence
    is advisory, so a directory that cannot be made returns False."""
    try:
        os.makedirs(path, exist_ok=True)
    except OSError:
        return False
    from ..exec.kernels import build
    build.set_gen_dir(path)
    return True


class PlanCacheSidecar:
    """Append-mostly JSONL of served statement exemplars.

    A record is `{"sql", "prepared", "catalog", "schema", "session"}` —
    everything `LocalQueryRunner.execute` needs to replay it.  Dedup is
    by (resolved statement text, catalog, schema, session): EXECUTE
    traffic against one template collapses to a single exemplar, since
    replaying ANY binding re-creates the template's cache entry."""

    def __init__(self, path: str,
                 max_count: int = DEFAULT_SIDECAR_MAX_COUNT):
        self.path = str(path)
        self.max_count = int(max_count)
        # rank 55: taken after serving-cache (50) would be wrong — record()
        # and load() run with NO other serving lock held (server layer,
        # post-execution), and SERVING_METRICS (100) nests fine
        self._lock = OrderedLock("serving-sidecar", 55)  # lint: guarded-by(_lock)
        self._seen = set()
        self._count = 0
        self._load_seen()

    # -- internal ---------------------------------------------------------

    def _dedup_key(self, rec: dict) -> tuple:
        prepared = rec.get("prepared") or {}
        text = "\x00".join(sorted(prepared.values())) or rec.get("sql", "")
        session = tuple(sorted((rec.get("session") or {}).items()))
        return (text, rec.get("catalog"), rec.get("schema"), session)

    def _load_seen(self) -> None:
        with self._lock:
            self._seen.clear()
            self._count = 0
            for rec in self._read_all():
                self._seen.add(self._dedup_key(rec))
                self._count += 1

    def _read_all(self) -> List[dict]:
        out: List[dict] = []
        try:
            with open(self.path, "r", encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        out.append(json.loads(line))
                    except ValueError:
                        continue    # torn tail write: keep the prefix
        except OSError:
            pass
        return out

    # -- recording --------------------------------------------------------

    def record(self, sql: str, prepared: Optional[Dict[str, str]],
               catalog: str, schema: str,
               session: Optional[Dict[str, str]] = None) -> bool:
        """Record one successfully-served statement; returns True when a
        new exemplar was appended."""
        rec = {"sql": sql, "prepared": dict(prepared or {}),
               "catalog": catalog, "schema": schema,
               "session": dict(session or {})}
        key = self._dedup_key(rec)
        with self._lock:
            if key in self._seen or self._count >= self.max_count:
                return False
            self._seen.add(key)
            self._count += 1
            try:
                d = os.path.dirname(self.path)
                if d:
                    os.makedirs(d, exist_ok=True)
                with open(self.path, "a", encoding="utf-8") as f:
                    f.write(json.dumps(rec) + "\n")
                    f.flush()
            except OSError:
                return False
        return True

    # -- replay -----------------------------------------------------------

    def load(self) -> List[dict]:
        with self._lock:
            return self._read_all()

    def clear(self) -> None:
        """DDL: the recorded plans may reference changed tables."""
        with self._lock:
            self._seen.clear()
            self._count = 0
            try:
                os.unlink(self.path)
            except OSError:
                pass

    def info(self) -> dict:
        with self._lock:
            return {"path": self.path, "entries": self._count,
                    "maxEntries": self.max_count}
