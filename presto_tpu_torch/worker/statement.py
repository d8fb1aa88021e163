"""Coordinator statement protocol + dispatch queueing + resource groups.

The analog of the reference coordinator's query intake path:

  POST /v1/statement                    QueuedStatementResource.java:200
  GET  /v1/statement/queued/{id}/{slug}/{token}      queued polling :339
  GET  /v1/statement/executing/{id}/{slug}/{token}   ExecutingStatementResource.java:97
  DELETE ...                            client cancel
  GET  /v1/query, /v1/query/{id}        QueryResource (UI / ops listing)

with DispatchManager.java:70-style admission through resource groups
(InternalResourceGroupManager.java:84): each query is matched to a group by
(user, source) selectors; a group runs at most `hardConcurrencyLimit`
queries, queues at most `maxQueued` more (FIFO), and rejects beyond that —
the same semantics as the reference's static resource-group configs
(presto-resource-group-managers).

The client walks `nextUri` exactly like StatementClientV1.advance()
(StatementClientV1.java:359-372): queued URIs poll admission, the executing
URI streams result rows in chunks with a monotonically increasing token.
"""
from __future__ import annotations

import itertools
import json
import re
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass, field
from decimal import Decimal
from typing import Callable, Dict, List, Optional

from ..common.locks import OrderedLock

QUEUED = "QUEUED"
RUNNING = "RUNNING"
FINISHED = "FINISHED"
FAILED = "FAILED"
CANCELED = "CANCELED"

_query_ids = itertools.count(1)


class QueryQueueFullError(RuntimeError):
    pass


class QueryMemoryLimitError(RuntimeError):
    """The query's memory estimate can NEVER be admitted (it exceeds the
    admission pool's total headroom) — immediate rejection, the reference
    coordinator's INSUFFICIENT_RESOURCES."""


@dataclass
class ResourceGroupSpec:
    name: str
    hard_concurrency_limit: int = 10
    max_queued: int = 100
    # fair-share weight (reference schedulingWeight): under a global
    # concurrency cap, a group with weight 2 is admitted twice as often
    # as a weight-1 group when both have queued work
    weight: float = 1.0


@dataclass
class Selector:
    """First matching selector wins (reference StaticSelector)."""
    group: str
    user: Optional[str] = None      # regex
    source: Optional[str] = None    # regex

    def matches(self, user: str, source: str) -> bool:
        if self.user and not re.fullmatch(self.user, user or ""):
            return False
        if self.source and not re.fullmatch(self.source, source or ""):
            return False
        return True


class ResourceGroupManager:
    """Admission control (InternalResourceGroupManager.java:84).

    Per-group: FIFO up to hard_concurrency_limit running, max_queued
    waiting, reject beyond.  Across groups, two serving-tier additions:

    - WEIGHTED FAIR SHARE (reference WEIGHTED_FAIR scheduling policy):
      under a global `total_concurrency` cap, each admission advances the
      group's virtual time by 1/weight; when capacity frees, the eligible
      group with the LEAST virtual time admits next.  Two groups with
      equal weights hammering the coordinator interleave ~1:1 regardless
      of arrival order; a weight-3 group gets ~3x the admissions.

    - MEMORY HEADROOM (reference ClusterMemoryManager / resource-group
      softMemoryLimit): admission holds each query's memory estimate
      against `memory_pool` (exec/memory.MemoryPool) capped at
      headroom_fraction * budget.  An estimate that can never fit rejects
      immediately (QueryMemoryLimitError); one that is only temporarily
      blocked queues until running queries release their claim.
    """

    DEFAULT_QUERY_MEMORY_ESTIMATE = 64 << 20

    def __init__(self, groups: Optional[List[ResourceGroupSpec]] = None,
                 selectors: Optional[List[Selector]] = None,
                 total_concurrency: Optional[int] = None,
                 memory_pool=None, headroom_fraction: float = 0.8,
                 query_memory_estimate: Optional[int] = None):
        self.groups = {g.name: g for g in (groups or [])}
        if "global" not in self.groups:
            self.groups["global"] = ResourceGroupSpec("global")
        self.selectors = list(selectors or [])
        self.total_concurrency = total_concurrency
        self.memory_pool = memory_pool
        self.headroom_fraction = headroom_fraction
        self.query_memory_estimate = (
            query_memory_estimate if query_memory_estimate is not None
            else self.DEFAULT_QUERY_MEMORY_ESTIMATE)
        self._running: Dict[str, set] = {n: set() for n in self.groups}
        self._queues: Dict[str, deque] = {n: deque() for n in self.groups}
        self._vtime: Dict[str, float] = {n: 0.0 for n in self.groups}
        self._total_running = 0
        self._mem_admitted = 0
        # rank 12: admission reads the memory pool's gauges but never
        # acquires its lock; sits between dispatch (10) and tasks (14)
        self._lock = OrderedLock("resource-groups", 12)  # lint: guarded-by(_lock)

    def select(self, user: str, source: str) -> str:
        for s in self.selectors:
            if s.matches(user, source) and s.group in self.groups:
                return s.group
        return "global"

    # -- admission --------------------------------------------------------
    def _mem_cap(self) -> Optional[int]:
        if self.memory_pool is None or self.memory_pool.budget is None:
            return None
        return int(self.memory_pool.budget * self.headroom_fraction)

    def _estimate(self, query: "ManagedQuery") -> int:
        est = getattr(query, "memory_estimate", None)
        return est if est is not None else self.query_memory_estimate

    def _mem_used(self) -> int:
        """The claim admission holds new queries against: the larger of
        the admission-time estimates and the pool's LIVE arbitrated
        accounting (reserved + revocable) — a running query whose actual
        reservations outgrew its estimate shrinks the headroom for
        everyone else, exactly like the reference ClusterMemoryManager
        tracking real pool reservation, not estimates."""
        live = (self.memory_pool.total_reserved
                if self.memory_pool is not None
                and hasattr(self.memory_pool, "total_reserved") else 0)
        return max(self._mem_admitted, live)

    def _can_run_locked(self, g: str, est: int) -> bool:
        if len(self._running[g]) >= self.groups[g].hard_concurrency_limit:
            return False
        if self.total_concurrency is not None \
                and self._total_running >= self.total_concurrency:
            return False
        cap = self._mem_cap()
        if cap is not None and self._mem_used() + est > cap:
            return False
        return True

    def _admit_locked(self, query: "ManagedQuery", est: int) -> None:
        g = query.resource_group
        self._running[g].add(query.query_id)
        self._total_running += 1
        self._mem_admitted += est
        query._admitted_bytes = est
        # virtual-time fair queueing: each admission costs 1/weight of
        # virtual service, so min-vtime selection interleaves groups in
        # proportion to their weights
        self._vtime[g] += 1.0 / max(self.groups[g].weight, 1e-9)

    def admit(self, query: "ManagedQuery") -> bool:
        """True = run now; False = queued.  Raises QueryQueueFullError on
        a full queue (reference QUERY_QUEUE_FULL) and
        QueryMemoryLimitError when the memory estimate exceeds the
        admission pool's total headroom (can never run)."""
        g = query.resource_group
        spec = self.groups[g]
        est = self._estimate(query)
        with self._lock:
            cap = self._mem_cap()
            if cap is not None and est > cap:
                raise QueryMemoryLimitError(
                    f"query memory estimate {est} bytes exceeds the "
                    f"admission headroom {cap} bytes "
                    f"({self.headroom_fraction:g} of pool budget "
                    f"{self.memory_pool.budget})")
            if self._can_run_locked(g, est):
                self._admit_locked(query, est)
                return True
            if len(self._queues[g]) >= spec.max_queued:
                raise QueryQueueFullError(
                    f"Too many queued queries for {g!r} "
                    f"(maxQueued {spec.max_queued})")
            self._queues[g].append(query)
            return False

    def release(self, query: "ManagedQuery") -> List["ManagedQuery"]:
        """Free the slot + memory claim; admit every now-eligible queued
        query, fair-share order (least virtual time first).  Returns the
        admitted queries — one release can unblock several when it was
        the memory claim, not a concurrency slot, that gated them."""
        with self._lock:
            g = query.resource_group
            if query.query_id in self._running[g]:
                self._running[g].discard(query.query_id)
                self._total_running -= 1
                self._mem_admitted -= getattr(
                    query, "_admitted_bytes", self._estimate(query))
            admitted: List["ManagedQuery"] = []
            while True:
                best = None
                for name, qd in self._queues.items():
                    while qd and qd[0].state != QUEUED:
                        qd.popleft()      # cancelled while queued
                    if not qd or not self._can_run_locked(
                            name, self._estimate(qd[0])):
                        continue
                    if best is None \
                            or self._vtime[name] < self._vtime[best]:
                        best = name
                if best is None:
                    return admitted
                nxt = self._queues[best].popleft()
                self._admit_locked(nxt, self._estimate(nxt))
                admitted.append(nxt)

    def remove_queued(self, query: "ManagedQuery") -> None:
        with self._lock:
            try:
                self._queues[query.resource_group].remove(query)
            except ValueError:
                pass

    def info(self) -> dict:
        with self._lock:
            out = {n: {"running": len(self._running[n]),
                       "queued": len(self._queues[n]),
                       "hardConcurrencyLimit":
                           self.groups[n].hard_concurrency_limit,
                       "maxQueued": self.groups[n].max_queued,
                       "weight": self.groups[n].weight,
                       "virtualTime": self._vtime[n]}
                   for n in self.groups}
            pool = self.memory_pool
            out["__admission"] = {
                "totalRunning": self._total_running,
                "totalConcurrency": self.total_concurrency,
                "memoryAdmittedBytes": self._mem_admitted,
                "memoryHeadroomBytes": self._mem_cap(),
                # live arbitrated accounting (what _can_run_locked gates
                # on, and what /v1/cluster reports as reservedMemoryBytes)
                "memoryReservedBytes": (
                    getattr(pool, "reserved", 0) if pool is not None else 0),
                "memoryRevocableBytes": (
                    getattr(pool, "revocable", 0)
                    if pool is not None else 0),
            }
            return out


@dataclass
class StreamingResult:
    """Executor return value for streamed results: rows are pulled chunk
    by chunk as the client advances tokens, so the coordinator never
    materializes the full result set (reference Query.java streams from
    the root-stage buffer via its ExchangeClient)."""
    columns: List[dict]
    row_iter: object            # iterator of JSON-ready row lists
    stats: object = None        # RuntimeStats-like (to_dict), read at drain


@dataclass
class ManagedQuery:
    query_id: str
    sql: str
    user: str
    source: str
    session: Dict[str, str]
    catalog: str
    schema: str
    resource_group: str = "global"
    # server-side prepared statements visible to this request
    # (X-Presto-Prepared-Statement headers, QueryPreparer analog)
    prepared: Dict[str, str] = field(default_factory=dict)
    added_prepare: Optional[tuple] = None       # (name, text) from PREPARE
    deallocated_prepare: Optional[str] = None   # name from DEALLOCATE
    slug: str = field(default_factory=lambda: uuid.uuid4().hex[:12])
    state: str = QUEUED
    error: Optional[str] = None
    columns: Optional[List[dict]] = None
    rows: Optional[list] = None
    runtime_stats: Optional[dict] = None
    # observability: the query's trace token (minted at submit or taken
    # from the client's X-Presto-Trace-Token) and the stage/task/operator
    # drill-down captured by the executor for /v1/query/{id}
    trace_token: str = ""
    query_info_extra: Optional[dict] = None
    peak_memory_bytes: int = 0
    # per-query device profiler capture dir (telemetry/profiler.py),
    # surfaced on /v1/query/{id} and the history record
    profile_trace_dir: Optional[str] = None
    created_at: float = field(default_factory=time.time)
    started_at: Optional[float] = None
    finished_at: Optional[float] = None
    done: threading.Event = field(default_factory=threading.Event)
    # set once the executor has a result to serve: its row stream (a
    # streaming result is done only when drained) or, at the finish, its
    # rows or error; an executing poll wakes on it
    ready: threading.Event = field(default_factory=threading.Event)
    _cancelled: bool = False
    _admitted: bool = False     # holds a resource-group running slot
    memory_estimate: Optional[int] = None   # admission claim, bytes
    _admitted_bytes: int = 0    # what admission actually reserved
    # streaming result state (StreamingResult executors)
    _row_iter: object = None
    _stats_src: object = None
    _iter_lock: threading.Lock = field(default_factory=threading.Lock)
    _chunks: dict = field(default_factory=dict)
    _max_token: int = -1
    _drained: bool = False
    rows_served: int = 0
    last_access: float = field(default_factory=time.time)

    def stats(self) -> dict:
        now = self.finished_at or time.time()
        return {
            "state": self.state,
            "queued": self.state == QUEUED,
            "scheduled": self.state not in (QUEUED,),
            "queuedTimeMillis": int(
                ((self.started_at or now) - self.created_at) * 1000),
            "elapsedTimeMillis": int((now - self.created_at) * 1000),
            "resourceGroup": self.resource_group,
        }


class DispatchManager:
    """Query registry + admission + async execution
    (DispatchManager.java:70, createQueryInternal :260)."""

    RESULT_CHUNK_ROWS = 4096
    MAX_QUERY_HISTORY = 200

    def __init__(self, executor: Callable[["ManagedQuery"], "object"],
                 resource_groups: Optional[ResourceGroupManager] = None,
                 events=None, history=None):
        """executor(query) runs the SQL and returns an exec.runner
        QueryResult (column_names / column_types / rows).  `events` is an
        EventListenerManager receiving created/completed events (the
        QueryMonitor analog, QueryMonitor.java:106).  `history` is an
        optional telemetry.history.QueryHistoryStore consulted at
        admission time (adaptive.history-sizing): a repeat of a recorded
        query seeds its memory claim from the observed peak instead of
        the flat default estimate."""
        from .events import EventListenerManager
        self._executor = executor
        self.resource_groups = resource_groups or ResourceGroupManager()
        self.events = events or EventListenerManager()
        self.history = history
        self._queries: Dict[str, ManagedQuery] = {}
        # rank 10: the outermost lock in the intake path — held only for
        # registry mutation, released before admission (12) or task work
        self._lock = OrderedLock("dispatch-manager", 10)  # lint: guarded-by(_lock)

    # -- intake -----------------------------------------------------------
    # a streaming query whose client stopped polling is canceled so its
    # resource-group slot frees (the reference's client abandonment
    # timeout, query.client.timeout)
    ABANDONED_AFTER_S = 300.0

    def _reap_abandoned(self) -> None:
        now = time.time()
        with self._lock:
            stale = [q for q in self._queries.values()
                     if q._row_iter is not None and not q.done.is_set()
                     and now - q.last_access > self.ABANDONED_AFTER_S]
        for q in stale:
            q._cancelled = True
            self._finish(q, CANCELED, "client abandoned the query")

    def submit(self, sql: str, user: str = "user", source: str = "",
               session: Optional[Dict[str, str]] = None,
               catalog: str = "tpch", schema: str = "sf0.01",
               prepared: Optional[Dict[str, str]] = None,
               trace_token: str = "") -> ManagedQuery:
        self._reap_abandoned()
        qid = f"{time.strftime('%Y%m%d_%H%M%S')}_{next(_query_ids):05d}"
        q = ManagedQuery(qid, sql, user, source, dict(session or {}),
                         catalog, schema, prepared=dict(prepared or {}))
        q.resource_group = self.resource_groups.select(user, source)
        # honor a client-supplied trace token (X-Presto-Trace-Token), else
        # mint one from the query id.  Kept OFF q.session: the executor's
        # runner cache is keyed by session items, and a per-query token
        # there would defeat plan/runner reuse.  The executor hands it to
        # the distributed runner out-of-band.
        q.trace_token = (trace_token or q.session.get("trace_token")
                         or f"trace-{qid}")
        est = (session or {}).get("query_memory_bytes")
        if est is not None:
            try:
                q.memory_estimate = max(0, int(est))
            except (TypeError, ValueError):
                pass
        if q.memory_estimate is None:
            self._seed_estimate_from_history(q)
        from .events import QueryCreatedEvent
        self.events.query_created(QueryCreatedEvent(
            query_id=qid, sql=sql, user=user, source=source,
            resource_group=q.resource_group, catalog=catalog,
            schema=schema, create_time=q.created_at))
        with self._lock:
            self._queries[qid] = q
            if len(self._queries) > self.MAX_QUERY_HISTORY:
                for k in list(self._queries)[:len(self._queries)
                                             - self.MAX_QUERY_HISTORY]:
                    old = self._queries[k]
                    if old.done.is_set():
                        del self._queries[k]
        try:
            if self.resource_groups.admit(q):
                q._admitted = True
                self._start(q)
        except (QueryQueueFullError, QueryMemoryLimitError) as e:
            # through _finish so the completed event fires (the reference
            # emits an immediate-failure event for queue rejection /
            # INSUFFICIENT_RESOURCES)
            self._finish(q, FAILED, str(e))
        return q

    def _seed_estimate_from_history(self, q: ManagedQuery) -> None:
        """adaptive.history-sizing at the admission gate: a repeat of a
        recorded query claims ~1.5x its last observed peak instead of the
        flat default estimate -- small queries stop over-claiming headroom
        and large ones stop sneaking under the cap.  Opt-in per session
        (adaptive_history_sizing); text-keyed because admission runs
        before planning, so no plan template exists yet."""
        if self.history is None:
            return
        if str(q.session.get("adaptive_history_sizing", "")) \
                .strip().lower() not in ("true", "1"):
            return
        try:
            recs = self.history.list(state="FINISHED")
        except Exception:   # noqa: BLE001 -- sizing is advisory
            return
        for rec in recs:
            peak = rec.get("peakMemoryBytes")
            if rec.get("query") == q.sql and peak:
                q.memory_estimate = max(1 << 20, int(int(peak) * 1.5))
                from ..exec.adaptive import ADAPTIVE_METRICS
                ADAPTIVE_METRICS.incr("history_sized_queries")
                return

    def _start(self, q: ManagedQuery) -> None:
        t = threading.Thread(target=self._run, args=(q,),
                             name=f"query-{q.query_id}", daemon=True)
        t.start()

    MAX_RETRIES = 2

    def _run(self, q: ManagedQuery) -> None:
        if q._cancelled:
            self._finish(q, CANCELED, None)
            return
        q.state = RUNNING
        q.started_at = time.time()
        attempt = 0
        while True:
            try:
                result = self._executor(q)
                if isinstance(result, StreamingResult):
                    # rows are pulled lazily by executing_response; the
                    # query finishes (and frees its resource-group slot)
                    # when the client drains the iterator
                    q.columns = result.columns
                    q._stats_src = result.stats
                    q._row_iter = iter(result.row_iter)
                    q.ready.set()
                    return
                q.columns = [{"name": n, "type": str(t)}
                             for n, t in zip(result.column_names,
                                             result.column_types)]
                q.rows = [[_json_value(v) for v in row]
                          for row in result.rows]
                q.runtime_stats = getattr(result, "runtime_stats", None)
                q.peak_memory_bytes = int(
                    getattr(result, "peak_memory_bytes", 0) or 0)
                q.profile_trace_dir = getattr(
                    result, "profile_trace_dir", None)
                q.added_prepare = getattr(result, "added_prepare", None)
                q.deallocated_prepare = getattr(
                    result, "deallocated_prepare", None)
                self._finish(q, CANCELED if q._cancelled else FINISHED,
                             None)
                return
            except Exception as e:  # noqa: BLE001 — becomes client error
                # transient infrastructure failures retry the whole query
                # (the ErrorClassifier analog, presto-spark-base
                # ErrorClassifier.java: worker death / connection loss is
                # retryable, user errors are not).  Writes never retry: a
                # partially-committed INSERT/CTAS re-executed would
                # duplicate data.
                word = q.sql.lstrip()[:6].lower()
                is_write = word.startswith(("create", "insert", "drop"))
                if _is_retryable(e) and not is_write \
                        and attempt < self.MAX_RETRIES \
                        and not q._cancelled:
                    attempt += 1
                    time.sleep(0.2 * attempt)
                    continue
                self._finish(q, FAILED, f"{type(e).__name__}: {e}")
                return

    def _finish(self, q: ManagedQuery, state: str, error: Optional[str]):
        if q.done.is_set():
            return
        q.state = state
        if state == CANCELED and error is None:
            error = "Query was canceled"   # clients must not see success
        q.error = error
        q.finished_at = time.time()
        q.done.set()
        q.ready.set()
        from .events import QueryCompletedEvent
        now = q.finished_at
        self.events.query_completed(QueryCompletedEvent(
            query_id=q.query_id, sql=q.sql, user=q.user, state=state,
            create_time=q.created_at, end_time=now,
            wall_time_s=now - q.created_at,
            queued_time_s=(q.started_at or now) - q.created_at,
            rows=(q.rows_served if q._row_iter is not None
                  else len(q.rows or [])),
            error=error,
            runtime_stats=q.runtime_stats,
            peak_memory_bytes=q.peak_memory_bytes,
            trace_token=q.trace_token,
            resource_group=q.resource_group))
        # only a query that held a running slot frees one; cancelling a
        # QUEUED query must not over-admit past hardConcurrencyLimit
        if q._admitted:
            for nxt in self.resource_groups.release(q):
                nxt._admitted = True
                self._start(nxt)

    # -- lookup / cancel --------------------------------------------------
    def get(self, query_id: str) -> ManagedQuery:
        with self._lock:
            return self._queries[query_id]

    def cancel(self, query_id: str) -> None:
        q = self.get(query_id)
        q._cancelled = True
        if q.state == QUEUED:
            self.resource_groups.remove_queued(q)
            self._finish(q, CANCELED, None)

    def list_queries(self) -> List[dict]:
        with self._lock:
            qs = list(self._queries.values())
        return [{"queryId": q.query_id, "state": q.state,
                 "query": q.sql, "user": q.user,
                 "resourceGroup": q.resource_group,
                 **({"errorMessage": q.error} if q.error else {})}
                for q in qs]

    # -- protocol responses ----------------------------------------------
    def queued_response(self, q: ManagedQuery, token: int,
                        base_uri: str, wait_s: float = 0.1) -> dict:
        if q.state == QUEUED:
            q.done.wait(wait_s)
        resp = {"id": q.query_id,
                "infoUri": f"{base_uri}/v1/query/{q.query_id}",
                "stats": q.stats()}
        if q.state == QUEUED:
            resp["nextUri"] = (f"{base_uri}/v1/statement/queued/"
                               f"{q.query_id}/{q.slug}/{token + 1}")
        elif q.state in (FAILED, CANCELED) and q.rows is None:
            if q.error:
                resp["error"] = {
                    "message": q.error,
                    "errorName": ("USER_CANCELED" if q.state == CANCELED
                                  else "QUERY_FAILED")}
        else:
            resp["nextUri"] = (f"{base_uri}/v1/statement/executing/"
                               f"{q.query_id}/{q.slug}/0")
        return resp

    # chunks retained behind the client's token (re-GET of the current
    # token must work; anything older is gone, like the reference's
    # acknowledged pages)
    _CHUNK_KEEP = 2

    def _ensure_chunk(self, q: ManagedQuery, token: int) -> None:
        """Pull rows from the streaming iterator until chunk `token`
        exists or the stream is drained; forget acknowledged chunks."""
        while not q._drained and q._max_token < token:
            rows = list(itertools.islice(q._row_iter,
                                         self.RESULT_CHUNK_ROWS))
            if not rows:
                q._drained = True
                if q._stats_src is not None:
                    q.runtime_stats = q._stats_src.to_dict()
                break
            q._max_token += 1
            q._chunks[q._max_token] = rows
            q.rows_served += len(rows)
        for t in [t for t in q._chunks if t < token - self._CHUNK_KEEP + 1]:
            del q._chunks[t]

    def _executing_streaming(self, q: ManagedQuery, token: int,
                             base_uri: str) -> dict:
        resp = {"id": q.query_id,
                "infoUri": f"{base_uri}/v1/query/{q.query_id}",
                "stats": q.stats()}
        if q._cancelled and not q.done.is_set():
            self._finish(q, CANCELED, None)
        if not (q._cancelled or q.done.is_set()):
            with q._iter_lock:
                try:
                    self._ensure_chunk(q, token)
                except Exception as e:  # noqa: BLE001 — surfaces to client
                    self._finish(q, FAILED, f"{type(e).__name__}: {e}")
        if q.state in (FAILED, CANCELED):
            if q.error:
                resp["error"] = {
                    "message": q.error,
                    "errorName": ("USER_CANCELED" if q.state == CANCELED
                                  else "QUERY_FAILED")}
            return resp
        resp["columns"] = q.columns
        chunk = q._chunks.get(token)
        if chunk:
            resp["data"] = chunk
        if q._drained and token >= q._max_token:
            self._finish(q, FINISHED, None)
            resp["stats"] = q.stats()     # reflect the final state
        else:
            resp["nextUri"] = (f"{base_uri}/v1/statement/executing/"
                               f"{q.query_id}/{q.slug}/{token + 1}")
        return resp

    def executing_response(self, q: ManagedQuery, token: int,
                           base_uri: str, wait_s: float = 0.5) -> dict:
        q.last_access = time.time()
        if q._row_iter is None and not q.done.is_set():
            # still planning, or waiting out a micro-batching window: wake
            # when the row stream is ready, not only at the finish (a
            # streaming result finishes when its rows are drained)
            q.ready.wait(wait_s)
        if q._row_iter is not None:
            return self._executing_streaming(q, token, base_uri)
        resp = {"id": q.query_id,
                "infoUri": f"{base_uri}/v1/query/{q.query_id}",
                "stats": q.stats()}
        if not q.done.is_set():
            # still running: poll the same token
            resp["nextUri"] = (f"{base_uri}/v1/statement/executing/"
                               f"{q.query_id}/{q.slug}/{token}")
            return resp
        if q.state in (FAILED, CANCELED):
            if q.error:
                resp["error"] = {
                    "message": q.error,
                    "errorName": ("USER_CANCELED" if q.state == CANCELED
                                  else "QUERY_FAILED")}
            return resp
        lo = token * self.RESULT_CHUNK_ROWS
        hi = lo + self.RESULT_CHUNK_ROWS
        resp["columns"] = q.columns
        if lo < len(q.rows):
            resp["data"] = q.rows[lo:hi]
        if hi < len(q.rows):
            resp["nextUri"] = (f"{base_uri}/v1/statement/executing/"
                               f"{q.query_id}/{q.slug}/{token + 1}")
        return resp


def _is_retryable(e: Exception) -> bool:
    """Worker/connection failures are retryable; planning, semantic, and
    storage errors are the user's.  Delegates to the shared error
    classifier (common/errors.py, the ErrorClassifier.java analog) so the
    statement layer, the HTTP coordinator, and the batch scheduler agree
    on one taxonomy.  Planning errors raised coordinator-side (before any
    task ran) arrive untyped; the classifier's USER_ERROR shape check
    (ValueError/TypeError/KeyError/...) keeps them fail-fast, and query
    text that only references a dead cluster stays retryable."""
    from ..common.errors import INTERNAL_ERROR, classify_exception
    et = classify_exception(e)
    if et != INTERNAL_ERROR:
        from ..common.errors import is_retryable_type
        return is_retryable_type(et)
    # untagged INTERNAL_ERROR: an engine exception whose retryability the
    # type system cannot prove — retry only message shapes known to be
    # cluster-transient (the pre-classifier behavior)
    msg = str(e).lower()
    return any(s in msg for s in ("connection refused", "no live workers",
                                  "node is shutting down", "timed out",
                                  "remote task failed",
                                  "retry attempt", "unreachable"))


def _json_value(v):
    if isinstance(v, Decimal):
        return str(v)
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    return str(v)
