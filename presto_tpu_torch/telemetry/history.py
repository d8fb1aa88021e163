"""Retention-bounded query history: terminal QueryInfo snapshots that
survive worker restarts.

The in-memory DispatchManager keeps a bounded dict of done queries for
/v1/query, but it dies with the process; this store is the durable tier
(the reference's QueryHistory / system.runtime.queries over completed
queries).  One JSON record per line, append-on-record; retention is
enforced by count AND age, and the file is compacted (rewritten from the
live entries) once the appended backlog doubles the retention bound, so
an immortal worker cannot grow the spool without bound.
"""
from __future__ import annotations

import json
import os
import time
from collections import OrderedDict
from typing import Dict, List, Optional

from ..common.locks import OrderedLock
from ..worker.events import EventListener


class QueryHistoryStore:
    """`path=None` keeps history in memory only (tests, embedded runs);
    with a path, records append to a JSONL spool reloaded on restart."""

    def __init__(self, path: Optional[str] = None, max_count: int = 200,
                 max_age_s: Optional[float] = None,
                 clock=time.time):
        if max_count <= 0:
            raise ValueError("history max_count must be positive")
        self.path = path
        self.max_count = max_count
        self.max_age_s = max_age_s
        self._clock = clock
        # rank 60: held across the spool file I/O, never nests deeper
        self._lock = OrderedLock("query-history", 60)  # lint: guarded-by(_lock)
        self._entries: "OrderedDict[str, dict]" = OrderedDict()
        self._appended_since_compact = 0
        self.loaded = 0          # records reloaded from the spool
        self.recorded = 0
        self.evicted = 0
        self.load_errors = 0     # malformed spool lines skipped
        if path:
            self._load()

    # -- persistence -------------------------------------------------------

    def _load(self) -> None:
        if not os.path.exists(self.path):
            return
        # locked even though only __init__ calls it: subclasses / reload
        # paths must not mutate _entries while readers hold the lock
        with self._lock:
            with open(self.path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                        qid = rec["queryId"]
                    except Exception:
                        self.load_errors += 1
                        continue
                    # later lines win: a re-recorded id supersedes
                    self._entries.pop(qid, None)
                    self._entries[qid] = rec
                    self.loaded += 1
            self._evict_locked()
            self._compact_locked()

    def _compact_locked(self) -> None:
        if not self.path:
            return
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            for rec in self._entries.values():
                f.write(json.dumps(rec, default=str) + "\n")
        os.replace(tmp, self.path)
        self._appended_since_compact = 0

    # -- retention ---------------------------------------------------------

    def _evict_locked(self) -> None:
        if self.max_age_s is not None:
            cutoff = self._clock() - self.max_age_s
            stale = [qid for qid, rec in self._entries.items()
                     if rec.get("recordedAt", 0) < cutoff]
            for qid in stale:
                del self._entries[qid]
                self.evicted += 1
        while len(self._entries) > self.max_count:
            self._entries.popitem(last=False)
            self.evicted += 1

    # -- API ---------------------------------------------------------------

    def record(self, info: dict) -> None:
        """Persist one terminal QueryInfo-shaped record (must carry
        queryId).  Re-recording a query id supersedes the old record."""
        qid = info.get("queryId")
        if not qid:
            raise ValueError("history record needs a queryId")
        rec = dict(info)
        rec.setdefault("recordedAt", self._clock())
        with self._lock:
            self._entries.pop(qid, None)
            self._entries[qid] = rec
            self.recorded += 1
            self._evict_locked()
            if self.path:
                with open(self.path, "a") as f:
                    f.write(json.dumps(rec, default=str) + "\n")
                self._appended_since_compact += 1
                if self._appended_since_compact > 2 * self.max_count:
                    self._compact_locked()

    def get(self, query_id: str) -> Optional[dict]:
        with self._lock:
            self._evict_locked()
            rec = self._entries.get(query_id)
            return dict(rec) if rec else None

    def list(self, state: Optional[str] = None) -> List[dict]:
        """Newest-first listing, optionally filtered by terminal state
        (FINISHED / FAILED / CANCELED)."""
        with self._lock:
            self._evict_locked()
            recs = [dict(r) for r in reversed(self._entries.values())]
        if state:
            state = state.upper()
            recs = [r for r in recs if r.get("state") == state]
        return recs

    def find_by_template(self, template_key: str,
                         state: Optional[str] = "FINISHED"
                         ) -> Optional[dict]:
        """Newest record whose "planTemplate" matches — the lookup behind
        history-based sizing (exec/runner.py): a repeat run of the same
        canonical plan template seeds its task counts / aggregation slots
        / admission estimate from what the last run actually observed."""
        if not template_key:
            return None
        with self._lock:
            self._evict_locked()
            for rec in reversed(self._entries.values()):
                if rec.get("planTemplate") != template_key:
                    continue
                if state and rec.get("state") != state:
                    continue
                return dict(rec)
        return None

    def counts_by_state(self) -> Dict[str, int]:
        with self._lock:
            self._evict_locked()
            out: Dict[str, int] = {}
            for rec in self._entries.values():
                s = rec.get("state", "UNKNOWN")
                out[s] = out.get(s, 0) + 1
            return out

    def __len__(self) -> int:
        with self._lock:
            self._evict_locked()
            return len(self._entries)

    def counters(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries),
                    "recorded": self.recorded, "loaded": self.loaded,
                    "evicted": self.evicted,
                    "load_errors": self.load_errors}


class HistoryEventListener(EventListener):
    """Bridges QueryCompletedEvent -> the history store.  Registered by
    the WorkerServer on its dispatch event manager; the extra fields
    callback lets the server enrich records with state the event does
    not carry (profiler trace dir, query_info_extra)."""

    def __init__(self, store: QueryHistoryStore, extra_fields=None):
        self.store = store
        self._extra_fields = extra_fields

    def query_completed(self, event) -> None:
        rec = {
            "queryId": event.query_id,
            "query": event.sql,
            "user": event.user,
            "state": event.state,
            "traceToken": getattr(event, "trace_token", ""),
            "resourceGroup": getattr(event, "resource_group", ""),
            "createTime": event.create_time,
            "endTime": event.end_time,
            "wallTimeSeconds": event.wall_time_s,
            "queuedTimeSeconds": event.queued_time_s,
            "rows": event.rows,
            "errorMessage": event.error,
            "peakMemoryBytes": event.peak_memory_bytes,
        }
        if self._extra_fields is not None:
            try:
                rec.update(self._extra_fields(event) or {})
            except Exception:
                pass  # enrichment is best-effort; the base record lands
        self.store.record(rec)
