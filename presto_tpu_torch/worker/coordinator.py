"""Coordinator-side distributed execution over the HTTP task protocol.

The port of presto_tpu/worker/coordinator.py, the analog of the reference coordinator's scheduling + remote-task stack
(SqlQueryScheduler.java:114 stage scheduling, SqlStageExecution.scheduleTask
:513, HttpRemoteTask.java:883-936 update POSTs) and of the result pump
(server/protocol/Query.java:116 holding an ExchangeClient on the root
stage): fragments are assigned round-robin to discovered workers, each task
gets its splits + upstream buffer locations in a TaskUpdateRequest, and the
coordinator pulls the root stage's buffers over the same results protocol.

Fault tolerance (reference HttpRemoteTask error budgets + presto-spark's
ErrorClassifier-driven task retry): every failure observed at the
coordinator — a FAILED task status, a 404 on a task the coordinator
created, a worker dropping off the failure detector, an exchange source
exhausting its error budget — is classified by error type.  USER_ERROR
fails the query fast with no retry; everything infrastructure-shaped
restarts the failed task under a per-task attempt budget
(remote_task_retry_attempts), on a surviving worker, with the SAME task-id
lineage and the SAME splits.  Because consumer TaskSources bake in producer
locations, restarting a producer restarts every ancestor stage up to the
root; the root's restart resets the coordinator's collected pages, and
retained producer buffers replay from token 0, so output stays
exactly-once.

The coordinator itself computes nothing on a device: the workers' tasks
run their fragments on each worker's device, and the root stage's pages
are decoded on the host.  HttpQueryRunner still takes the runner's
explicit device ("cuda" by default, raising without CUDA), which its
EXPLAIN (TYPE VALIDATE) and any local fallback run on.
"""
from __future__ import annotations

import itertools
import json
import re
import threading
import time
import urllib.error
import urllib.request
from typing import Dict, List, Optional, Set, Tuple

from ..common.locks import OrderedLock
from ..common.errors import (INTERNAL_ERROR, PrestoQueryError,
                             PrestoUserError, ExchangeLostError,
                             PoisonSplitError, QueryDeadlineExceededError,
                             RemoteTaskError, WorkerLostError,
                             is_retryable_type, parse_error_type)
from ..connectors import catalog, tpch
from ..exec.adaptive import DynamicFilterCollector, DynamicFilterSummary
from ..exec.pipeline import ExecutionConfig
from ..exec.runner import LocalQueryRunner, QueryResult, pages_to_result
from ..spi import plan as P
from ..utils.runtime_stats import RuntimeStats
from .exchange import ExchangeClient
from .protocol import (DONE_STATES, FAILED, OutputBuffersSpec, TaskSource,
                       TaskStatus, TaskUpdateRequest, parse_data_size,
                       parse_duration)

_query_counter = itertools.count()

_RETRY_SUFFIX = re.compile(r"\.r\d+$")
_RESULT_LOCATIONS = re.compile(r"/v1/task/([^/\s]+)/results/")
_SOURCE_LOCATIONS = re.compile(r"(https?://[^/\s\"\\]+)/v1/task/([^/\s\"\\]+)/results/")
_SIG_JUNK_LINE = re.compile(r"[\"'}\\\s]+")


def _failure_signature(message: str) -> str:
    """Canonical signature for an INTERNAL failure.  The same root cause
    can be observed directly (the failed task's own traceback in a status
    event) or through any number of consumer exchange wrappers, each of
    which JSON-escapes the quoted producer error one level deeper.
    Collapse the escape layers, then take the deepest meaningful line —
    the root exception — with digits masked so ports, attempt counters
    and line numbers don't fragment the signature."""
    text = message or ""
    for _ in range(8):  # escape depth doubles per wrapper; 8 is plenty
        collapsed = text.replace("\\\\", "\\")
        if collapsed == text:
            break
        text = collapsed
    text = text.replace("\\r", "").replace("\\n", "\n").replace('\\"', '"')
    lines = [ln.strip() for ln in text.splitlines()]
    lines = [ln for ln in lines if ln and not _SIG_JUNK_LINE.fullmatch(ln)]
    last = lines[-1] if lines else ""
    return re.sub(r"\d+", "#", last)[:200]


class HeartbeatFailureDetector:
    """Coordinator-side liveness probing (reference
    presto-main/.../failureDetector/HeartbeatFailureDetector.java:77 +
    DiscoveryNodeManager.refreshNodesInternal): each worker's
    /v1/info/state is polled on an interval; a node failing `threshold`
    consecutive probes — or reporting SHUTTING_DOWN — is dropped from
    scheduling until it responds ACTIVE again.

    `heartbeat_timeout_s` adds an absolute-age trigger on top of the
    consecutive-miss streak (failure-detector.heartbeat-timeout): a
    worker whose last successful heartbeat is older than the timeout is
    failed even if individual probes are still timing out slowly enough
    to not build a streak."""

    def __init__(self, worker_uris: List[str], interval_s: float = 0.5,
                 threshold: int = 3,
                 heartbeat_timeout_s: Optional[float] = None):
        self.worker_uris = list(worker_uris)
        self.threshold = threshold
        self.heartbeat_timeout_s = heartbeat_timeout_s or None
        self._streak = {u: 0 for u in self.worker_uris}
        # last SUCCESSFUL probe per worker (monotonic); seeded now so a
        # worker that never answers still ages out of scheduling
        now = time.monotonic()
        self._last_seen = {u: now for u in self.worker_uris}
        self._draining = set()
        # rank 80: prober bookkeeping only — never nests into engine locks
        self._lock = OrderedLock("failure-detector", 80)  # lint: guarded-by(_lock)
        self._stop = threading.Event()
        # one prober per worker: a hung node must not delay detection of
        # the others (the reference probes asynchronously per service)
        self._threads = [
            threading.Thread(target=self._loop, args=(uri, interval_s),
                             name=f"failure-detector-{i}", daemon=True)
            for i, uri in enumerate(self.worker_uris)]
        for t in self._threads:
            t.start()

    def _probe(self, uri: str):
        from .auth import outbound_headers, urlopen_internal
        try:
            req = urllib.request.Request(uri + "/v1/info/state",
                                         headers=outbound_headers())
            with urlopen_internal(req, timeout=2.0) as resp:
                return json.loads(resp.read())
        except (OSError, ValueError):
            return None

    def _loop(self, uri: str, interval_s: float) -> None:
        while not self._stop.is_set():
            state = self._probe(uri)
            with self._lock:
                if state is None:
                    self._streak[uri] += 1
                else:
                    self._streak[uri] = 0
                    self._last_seen[uri] = time.monotonic()
                    if state == "SHUTTING_DOWN":
                        self._draining.add(uri)
                    else:
                        self._draining.discard(uri)
            self._stop.wait(interval_s)

    def heartbeat_age_s(self, uri: str) -> float:
        """Seconds since the worker last answered a probe."""
        with self._lock:
            return time.monotonic() - self._last_seen.get(
                uri, time.monotonic())

    def _failed_locked(self, uri: str) -> bool:
        if self._streak[uri] >= self.threshold:
            return True
        return (self.heartbeat_timeout_s is not None
                and time.monotonic() - self._last_seen[uri]
                > self.heartbeat_timeout_s)

    def alive(self) -> List[str]:
        with self._lock:
            return [u for u in self.worker_uris
                    if not self._failed_locked(u)
                    and u not in self._draining]

    def failed(self) -> List[str]:
        with self._lock:
            return [u for u in self.worker_uris
                    if self._failed_locked(u)]

    def snapshot(self) -> Dict[str, dict]:
        """Per-worker probe state for /v1/status and /v1/metrics."""
        with self._lock:
            now = time.monotonic()
            return {u: {"streak": self._streak[u],
                        "draining": u in self._draining,
                        "heartbeatAgeSeconds": round(
                            now - self._last_seen[u], 3),
                        "alive": (not self._failed_locked(u)
                                  and u not in self._draining)}
                    for u in self.worker_uris}

    def close(self) -> None:
        self._stop.set()


class RemoteTask:
    """Client-side handle for one worker task (reference HttpRemoteTask)."""

    def __init__(self, worker_uri: str, task_id: str,
                 trace_token: str = ""):
        self.worker_uri = worker_uri
        self.task_id = task_id
        self.task_uri = f"{worker_uri}/v1/task/{task_id}"
        # X-Presto-Trace-Token rides on EVERY coordinator->worker request
        # for this task (the reference's trace-token propagation on the
        # task protocol), so worker access logs join to the query trace
        self.trace_token = trace_token

    def _headers(self) -> dict:
        from .auth import outbound_headers
        headers = outbound_headers()
        if self.trace_token:
            headers["X-Presto-Trace-Token"] = self.trace_token
        return headers

    def update(self, request: TaskUpdateRequest,
               deadline_ms: Optional[float] = None) -> TaskStatus:
        body = json.dumps(request.to_dict()).encode()
        headers = {"Content-Type": "application/json", **self._headers()}
        if deadline_ms is not None:
            # the query's REMAINING wall budget at dispatch (relative ms,
            # so no coordinator<->worker clock agreement is needed): the
            # worker arms a local monotonic deadline from it
            headers["X-Presto-Task-Deadline"] = str(int(deadline_ms))
        req = urllib.request.Request(
            self.task_uri, data=body, method="POST", headers=headers)
        from .auth import urlopen_internal
        with urlopen_internal(req, timeout=30) as resp:
            return TaskStatus.from_dict(json.loads(resp.read()))

    def status(self, current_state: Optional[str] = None,
               max_wait_ms: int = 1000,
               timeout_s: float = 60.0) -> TaskStatus:
        url = f"{self.task_uri}/status?maxWaitMs={max_wait_ms}"
        req = urllib.request.Request(url, headers=self._headers())
        if current_state:
            req.add_header("X-Presto-Current-State", current_state)
        from .auth import urlopen_internal
        with urlopen_internal(req, timeout=timeout_s) as resp:
            return TaskStatus.from_dict(json.loads(resp.read()))

    def info(self, timeout_s: float = 10.0) -> dict:
        """Full TaskInfo (GET /v1/task/{id}): per-task stats + the plan-node
        inventory with per-operator stats when the worker collected them."""
        req = urllib.request.Request(self.task_uri, headers=self._headers())
        from .auth import urlopen_internal
        with urlopen_internal(req, timeout=timeout_s) as resp:
            return json.loads(resp.read())

    def cancel(self) -> None:
        req = urllib.request.Request(self.task_uri, method="DELETE",
                                     headers=self._headers())
        try:
            from .auth import urlopen_internal
            urlopen_internal(req, timeout=10).close()
        except OSError:
            pass

    def result_location(self, buffer_id: int) -> str:
        return f"{self.task_uri}/results/{buffer_id}"


class _Stage:
    def __init__(self, fragment: P.PlanFragment, children: List["_Stage"],
                 n_tasks: int, stage_path: str = "0"):
        self.fragment = fragment
        self.children = children
        self.n_tasks = n_tasks
        self.stage_path = stage_path
        self.parent: Optional["_Stage"] = None
        for c in children:
            c.parent = self
        # filled by _QueryExecution._prepare: immutable per query, reused
        # verbatim on task restart (same splits, same buffer spec)
        self.spec: Optional[OutputBuffersSpec] = None
        self.scan_splits: Dict[str, List[catalog.TableSplit]] = {}
        self.remote_nodes: List[P.RemoteSourceNode] = []
        self.tasks: List[Optional[RemoteTask]] = [None] * n_tasks

    def postorder(self) -> List["_Stage"]:
        out: List[_Stage] = []
        for c in self.children:
            out.extend(c.postorder())
        out.append(self)
        return out


class _FailureSignal(Exception):
    """Internal control flow: the status watcher observed task failures;
    unwind the root pull and let the retry loop classify them."""

    def __init__(self, events: List[dict]):
        super().__init__(f"{len(events)} task failure(s) observed")
        self.events = events


class _StatusWatcher:
    """Background poller over every live task's /status (the coordinator
    side of the reference's continuous task-status long-poll in
    HttpRemoteTask).  Feeds failures to the query's retry loop the moment
    they happen, so the root pull aborts early instead of draining all
    pages first.  Transport errors build a per-worker streak; two straight
    misses — or the failure detector dropping the worker — count every
    unfinished task there as lost."""

    TRANSPORT_STREAK = 2

    def __init__(self, execution: "_QueryExecution",
                 interval_s: float = 0.15):
        self._exec = execution
        self._stop = threading.Event()
        # rank 82: event-list lock, leaf-like (only above the registries)
        self._lock = OrderedLock("status-watcher", 82)  # lint: guarded-by(_lock)
        self._events: List[dict] = []
        self._streaks: Dict[str, int] = {}
        self._done: Set[str] = set()
        self._thread = threading.Thread(target=self._loop,
                                        args=(interval_s,),
                                        name="status-watcher", daemon=True)
        self._thread.start()

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def _emit(self, **event) -> None:
        with self._lock:
            self._events.append(event)

    def _loop(self, interval_s: float) -> None:
        while not self._stop.is_set():
            dead_workers = set()
            det = self._exec.runner.failure_detector
            if det is not None:
                dead_workers.update(det.failed())
            for task in self._exec.current_tasks():
                if self._stop.is_set():
                    return
                if task.task_id in self._done:
                    continue
                if task.worker_uri in dead_workers:
                    self._emit(kind="worker_lost", task_id=task.task_id,
                               worker_uri=task.worker_uri,
                               message=f"worker {task.worker_uri} dropped "
                                       "by failure detector")
                    continue
                try:
                    st = task.status(max_wait_ms=0, timeout_s=2.0)
                except urllib.error.HTTPError as e:
                    if e.code in (404, 410):
                        # the worker restarted and lost its task registry:
                        # the task is gone, not the query (TaskLostError)
                        self._emit(kind="task_lost", task_id=task.task_id,
                                   worker_uri=task.worker_uri,
                                   message=f"task {task.task_id} not found "
                                           f"on {task.worker_uri} "
                                           f"({e.code})")
                    else:
                        self._bump_streak(task)
                except (urllib.error.URLError, TimeoutError, OSError,
                        ValueError):
                    self._bump_streak(task)
                else:
                    with self._lock:
                        self._streaks[task.worker_uri] = 0
                    if st.state == FAILED:
                        msg = st.failures[0] if st.failures else "unknown"
                        self._emit(kind="failed", task_id=task.task_id,
                                   worker_uri=task.worker_uri,
                                   error_type=st.error_type, message=msg)
                    elif st.state in DONE_STATES:
                        self._done.add(task.task_id)
            self._stop.wait(interval_s)

    def _bump_streak(self, task: RemoteTask) -> None:
        with self._lock:
            n = self._streaks.get(task.worker_uri, 0) + 1
            self._streaks[task.worker_uri] = n
        if n >= self.TRANSPORT_STREAK:
            self._emit(kind="worker_lost", task_id=task.task_id,
                       worker_uri=task.worker_uri,
                       message=f"worker {task.worker_uri} unreachable "
                               f"({n} consecutive status probes failed)")

    def close(self) -> None:
        self._stop.set()


class _DynamicFilterPump:
    """Coordinator-side dynamic-filter distribution (the analog of the
    reference DynamicFilterService): build-stage tasks summarize their
    dynamic-filter key domains into TaskInfo ("dynamicFilterSummaries");
    this pump polls those infos, merges the per-task partials per filter
    id once EVERY task of every producing stage has reported, and pushes
    the merged domains to the downstream scan tasks via fragment-less
    task updates.  Consumer tasks wait a bounded
    dynamic-filtering.wait-timeout then proceed unfiltered, so a slow or
    dead producer degrades to the unfiltered plan instead of stalling —
    a late delivery after the wait is ignored (and metered) worker-side."""

    def __init__(self, execution: "_QueryExecution",
                 interval_s: float = 0.1):
        self._exec = execution
        cfg = execution.runner.config
        max_distinct = int(execution.session.get(
            "dynamic_filtering_max_distinct_values",
            cfg.dynamic_filtering_max_distinct))
        self._collector = DynamicFilterCollector(max_distinct)
        # fid -> producing stages (several source fragments can feed the
        # same filter id); a filter is ready only when ALL have reported
        self._producers: Dict[str, List[_Stage]] = {}
        # consumer stages paired with the filter ids their scans await
        self._consumers: List[Tuple[_Stage, Set[str]]] = []
        for stage in execution.stages:
            for fid in stage.fragment.dynamic_filter_sources.values():
                self._producers.setdefault(fid, []).append(stage)
            fids = {e["id"] for node in P.walk_plan(stage.fragment.root)
                    if isinstance(node, P.TableScanNode)
                    for e in getattr(node, "runtime_filters", None) or []}
            if fids:
                self._consumers.append((stage, fids))
        self._stage_done: Set[int] = set()
        self._ready: Dict[str, dict] = {}    # fid -> merged wire dict
        self._pushed: Set[Tuple[str, frozenset]] = set()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop,
                                        args=(interval_s,),
                                        name="dynamic-filter-pump",
                                        daemon=True)
        if self._producers and self._consumers:
            self._thread.start()

    def _collect(self) -> None:
        """Merge summaries from producer stages whose tasks ALL report."""
        for stages in self._producers.values():
            for stage in stages:
                if id(stage) in self._stage_done:
                    continue
                want = set(stage.fragment.dynamic_filter_sources.values())
                partials: List[Dict[str, dict]] = []
                for task in stage.tasks:
                    if task is None:
                        break
                    try:
                        info = task.info(timeout_s=2.0)
                    except (OSError, ValueError):
                        break
                    sums = info.get("dynamicFilterSummaries") or {}
                    if not want <= set(sums):
                        break  # task still running (or retried attempt)
                    partials.append(sums)
                else:
                    for sums in partials:
                        for fid in want:
                            self._collector.publish(
                                DynamicFilterSummary.from_dict(sums[fid]))
                    self._stage_done.add(id(stage))
        for fid, stages in self._producers.items():
            if fid not in self._ready and all(
                    id(s) in self._stage_done for s in stages):
                self._ready[fid] = self._collector.get(fid).to_dict()
                self._exec.stats.add("dynamicFiltersCollected", 1)

    def _push(self) -> None:
        """Deliver ready filters to every live consumer task exactly once
        per (task attempt, filter set); a restarted attempt has a new task
        id, so it is re-delivered automatically."""
        for stage, fids in self._consumers:
            have = {f: self._ready[f] for f in fids if f in self._ready}
            if not have:
                continue
            for ti, task in enumerate(stage.tasks):
                if task is None:
                    continue
                key = (task.task_id, frozenset(have))
                if key in self._pushed:
                    continue
                req = TaskUpdateRequest(
                    task.task_id, ti, None, [], stage.spec,
                    session=self._exec.session, dynamic_filters=have)
                try:
                    task.update(req,
                                deadline_ms=self._exec._deadline_ms())
                except (urllib.error.URLError, urllib.error.HTTPError,
                        TimeoutError, OSError):
                    pass  # consumer proceeds unfiltered after its wait
                else:
                    self._pushed.add(key)

    def _loop(self, interval_s: float) -> None:
        while not self._stop.is_set():
            self._collect()
            self._push()
            if len(self._ready) == len(self._producers):
                # everything collected; keep pushing only for restarts
                if all((t.task_id, frozenset(
                        {f: self._ready[f] for f in fids
                         if f in self._ready})) in self._pushed
                       for stage, fids in self._consumers
                       for t in stage.tasks if t is not None):
                    return
            self._stop.wait(interval_s)

    def close(self) -> None:
        self._stop.set()


class _QueryExecution:
    """One query's distributed run: scheduling, the failure watcher, and
    the classify-restart loop (the coordinator analog of presto-spark's
    per-task retry over durable shuffle — here over retained buffers)."""

    def __init__(self, runner: "HttpQueryRunner", root: _Stage, qid: str,
                 trace_token: str = ""):
        self.runner = runner
        self.root = root
        self.qid = qid
        self.stages = root.postorder()
        cfg = runner.config
        self.max_attempts = int(runner.session.get(
            "remote_task_retry_attempts", cfg.remote_task_retry_attempts))
        self.max_error_s = parse_duration(runner.session.get(
            "exchange_max_error_duration",
            cfg.exchange_max_error_duration_s))
        self.session = dict(runner.session)
        if self.max_attempts > 0:
            # workers must retain acknowledged buffer pages so a restarted
            # consumer can replay its inputs from token 0
            self.session.setdefault("remote_task_retry_attempts",
                                    str(self.max_attempts))
        # retry-policy=task (fault-tolerant execution): workers spool every
        # stage's output durably and a failed task restarts ALONE — the
        # policy rides to workers in the session so their tasks build
        # TaskSpools and their exchange consumers park on producer loss
        self.retry_policy = str(runner.session.get(
            "retry_policy",
            getattr(cfg, "retry_policy", "query"))).strip().lower()
        self.session.setdefault("retry_policy", self.retry_policy)
        # query.max-execution-time -> a coordinator-local monotonic
        # deadline; 0 disables.  Minted HERE as the typed non-retryable
        # EXCEEDED_TIME_LIMIT user error; the remaining budget is also
        # forwarded per task via X-Presto-Task-Deadline
        self.deadline_limit_s = parse_duration(self.session.get(
            "query_max_execution_time",
            getattr(cfg, "query_max_execution_time_s", 0.0)))
        self.started_at = time.monotonic()
        self.deadline = (self.started_at + self.deadline_limit_s
                         if self.deadline_limit_s > 0 else None)
        # poison-split quarantine: (lineage, normalized INTERNAL error
        # signature) -> distinct workers it failed on
        self.failure_workers: Dict[Tuple[str, str], Set[str]] = {}
        self.codec = str(self.session.get(
            "exchange_compression_codec",
            cfg.exchange_compression_codec)).upper()
        # concurrent root-pull client knobs (exchange.client-threads /
        # .max-buffer-size / .max-response-size and session equivalents)
        self.client_threads = int(self.session.get(
            "exchange_client_threads", cfg.exchange_client_threads))
        self.max_buffer_bytes = parse_data_size(self.session.get(
            "exchange_max_buffer_size", cfg.exchange_max_buffer_bytes))
        self.max_response_bytes = parse_data_size(self.session.get(
            "exchange_max_response_size", cfg.exchange_max_response_bytes))
        self.stats = RuntimeStats()             # root-pull exchange stats
        # trace token: honor one handed down by the statement layer (it
        # minted per-query), else mint from the query id; propagated to
        # every task via session + X-Presto-Trace-Token headers
        self.trace_token = str(
            trace_token or runner.session.get("trace_token")
            or f"trace-{qid}")
        self.session.setdefault("trace_token", self.trace_token)
        # per-operator stats collection is always on for distributed
        # executions: TaskInfo carries the per-node breakdown that
        # /v1/query/{id} rolls up (a per-batch dict update on the worker —
        # the device-side fused counters make it cheap even on hot paths)
        self.session.setdefault("collect_operator_stats", "true")
        # shuffle fabric: session override > config.  The HTTP coordinator
        # only drives the page wire, so a requested "ici" is honored
        # inside each worker's local scheduler (if it has a mesh) while
        # every CROSS-process edge here stays http — tag the stats so
        # fabric comparisons see which wire this run used
        self.fabric = str(runner.session.get(
            "exchange_fabric", cfg.exchange_fabric)).strip().lower()
        self.stats.add("exchangeFabricHttpQueries", 1)
        self.id_attempt: Dict[str, int] = {}    # lineage -> id generation
        self.budget_used: Dict[str, int] = {}   # lineage -> retries charged
        self.suspects: Set[str] = set()         # workers seen failing
        self.retries = 0
        self.all_tasks: List[RemoteTask] = []   # every attempt, for cleanup
        self.lineage_index: Dict[str, Tuple[_Stage, int]] = {}
        self._watcher: Optional[_StatusWatcher] = None
        self._df_pump: Optional[_DynamicFilterPump] = None
        self.dynamic_filtering = str(self.session.get(
            "dynamic_filtering",
            getattr(cfg, "dynamic_filtering", True))).strip().lower() \
            in ("true", "1")

    # -- identity ---------------------------------------------------------
    def lineage(self, stage: _Stage, ti: int) -> str:
        return f"{self.qid}.{stage.stage_path.replace('.', '_')}.{ti}"

    def task_id_for(self, lineage: str) -> str:
        """Retry attempts keep the base lineage and add `.rN` (same task,
        attempt N — the worker counts these in tasks_retried)."""
        attempt = self.id_attempt.get(lineage, 0)
        return lineage if attempt == 0 else f"{lineage}.r{attempt}"

    def current_tasks(self) -> List[RemoteTask]:
        return [t for s in self.stages for t in s.tasks if t is not None]

    # -- scheduling -------------------------------------------------------
    def _prepare(self, stage: _Stage, consumer_tasks: int) -> None:
        """Fix a stage's buffer spec, split assignment, and remote-source
        set once; restarts reuse them verbatim."""
        frag = stage.fragment
        scheme = frag.output_partitioning_scheme
        if scheme.handle == P.FIXED_HASH_DISTRIBUTION:
            stage.spec = OutputBuffersSpec(
                "PARTITIONED", consumer_tasks,
                [a.name for a in scheme.arguments])
        elif scheme.handle == P.FIXED_BROADCAST_DISTRIBUTION:
            stage.spec = OutputBuffersSpec("BROADCAST", consumer_tasks)
        else:  # SINGLE: one buffer, one consumer
            stage.spec = OutputBuffersSpec("PARTITIONED", 1)
        # split assignment (reference SourcePartitionedScheduler)
        for node in P.walk_plan(frag.root):
            if isinstance(node, P.TableScanNode):
                th = node.table
                sf = dict(th.extra).get("scaleFactor", 0.01)
                n_splits = max(stage.n_tasks,
                               self.runner.config.splits_per_scan)
                stage.scan_splits[node.id] = catalog.make_splits(
                    th.table_name, sf, n_splits, th.connector_id)
        stage.remote_nodes = [n for n in P.walk_plan(frag.root)
                              if isinstance(n, P.RemoteSourceNode)]
        for ti in range(stage.n_tasks):
            self.lineage_index[self.lineage(stage, ti)] = (stage, ti)

    def _make_sources(self, stage: _Stage, ti: int) -> List[TaskSource]:
        sources = []
        for node_id, splits in stage.scan_splits.items():
            own = [s.to_dict() for s in splits[ti::stage.n_tasks]]
            sources.append(TaskSource(node_id, own))
        child_by_fid = {c.fragment.fragment_id: c for c in stage.children}
        for rnode in stage.remote_nodes:
            locations = []
            for fid in rnode.source_fragment_ids:
                child = child_by_fid[fid]
                child_scheme = \
                    child.fragment.output_partitioning_scheme.handle
                buffer_id = 0 if child_scheme == P.SINGLE_DISTRIBUTION \
                    else ti
                for ct in child.tasks:
                    locations.append(
                        {"remote": True,
                         "location": ct.result_location(buffer_id)})
            sources.append(TaskSource(rnode.id, locations))
        return sources

    def _place_task(self, stage: _Stage, ti: int) -> RemoteTask:
        """Create one task attempt on a live, non-suspect worker.  A 503
        (draining) or a transport error reroutes to the next candidate
        (reference SqlStageExecution retrying placement on node refusal)."""
        lineage = self.lineage(stage, ti)
        task_id = self.task_id_for(lineage)
        req = TaskUpdateRequest.make(task_id, ti, stage.fragment,
                                     self._make_sources(stage, ti),
                                     stage.spec, session=self.session)
        live = self.runner._live_uris()
        preferred = [u for u in live if u not in self.suspects] or live
        worker = preferred[next(self.runner._rr) % len(preferred)]
        candidates = [worker] + [u for u in preferred if u != worker] \
            + [u for u in live if u not in preferred]
        last_err: Optional[Exception] = None
        for cand in candidates:
            task = RemoteTask(cand, task_id, trace_token=self.trace_token)
            try:
                task.update(req, deadline_ms=self._deadline_ms())
            except urllib.error.HTTPError as e:
                if e.code != 503:
                    raise
                last_err = e
            except (urllib.error.URLError, TimeoutError, OSError) as e:
                # the worker died between discovery and placement
                self.suspects.add(cand)
                last_err = e
            else:
                stage.tasks[ti] = task
                self.all_tasks.append(task)
                return task
        raise WorkerLostError(
            worker, f"no worker accepted task {task_id}: {last_err}")

    def schedule_all(self) -> None:
        for stage in self.stages:
            consumer = stage.parent.n_tasks if stage.parent else 1
            self._prepare(stage, consumer)
        for stage in self.stages:  # postorder: producers before consumers
            for ti in range(stage.n_tasks):
                self._place_task(stage, ti)

    # -- the retry loop ---------------------------------------------------
    def run(self) -> List:
        self.schedule_all()
        if self.dynamic_filtering and self._df_pump is None:
            self._df_pump = _DynamicFilterPump(self)
        while True:
            self._watcher = _StatusWatcher(self)
            # one concurrent client over every root-task buffer (reference
            # Query.java holding an ExchangeClient on the root stage): a
            # restart discards this client and builds a fresh one, and the
            # producers' retained buffers replay from token 0 — so a
            # half-drained attempt stays exactly-once
            client = ExchangeClient(
                [task.result_location(0) for task in self.root.tasks],
                codec=self.codec, max_error_duration_s=self.max_error_s,
                should_abort=self._raise_pending_failures,
                client_threads=self.client_threads,
                max_buffer_bytes=self.max_buffer_bytes,
                max_response_bytes=self.max_response_bytes,
                stats=self.stats)
            try:
                pages = list(client.pages())
                self._raise_pending_failures()
                return pages
            except (ExchangeLostError, RemoteTaskError,
                    _FailureSignal) as e:
                failed = self._classify_failure(e)
                self._restart(failed, cause=e)
            finally:
                client.close()
                self._watcher.close()

    def _deadline_ms(self) -> Optional[float]:
        """Remaining wall budget in ms for X-Presto-Task-Deadline."""
        if self.deadline is None:
            return None
        return max(0.0, (self.deadline - time.monotonic()) * 1000.0)

    def _check_deadline(self) -> None:
        if self.deadline is not None and time.monotonic() > self.deadline:
            raise QueryDeadlineExceededError(
                time.monotonic() - self.started_at, self.deadline_limit_s,
                context=f"query {self.qid}")

    def _raise_pending_failures(self) -> None:
        """should_abort hook for the root pull: unwind as soon as the
        watcher has seen ANY task fail, instead of discovering it after
        all pages are drained.  Also where the query deadline is minted —
        the hook runs every root pull round, so EXCEEDED_TIME_LIMIT
        surfaces within one round of the budget elapsing (and, being a
        typed USER_ERROR, is never retried)."""
        self._check_deadline()
        events = self._watcher.events() if self._watcher else []
        if events:
            raise _FailureSignal(events)

    def _lineage_of_task(self, task_id: str) -> Optional[str]:
        base = _RETRY_SUFFIX.sub("", task_id)
        return base if base in self.lineage_index else None

    def _culprit_lineage(self, text: str, fallback_task_id: str
                         ) -> Optional[str]:
        """Failure text may embed producer buffer locations (a consumer
        failing on its exchange pull quotes the source).  The DEEPEST
        mentioned task is the true culprit; its restart set covers every
        ancestor including the quoting consumer."""
        for tid in reversed(_RESULT_LOCATIONS.findall(text or "")):
            lin = self._lineage_of_task(tid)
            if lin is not None:
                return lin
        return self._lineage_of_task(fallback_task_id)

    def _classify_failure(self, exc: Exception) -> Set[str]:
        """Failure -> set of lineages to charge and restart.  Raises a
        typed query error for anything non-retryable."""
        failed: Set[str] = set()
        if isinstance(exc, RemoteTaskError):
            if not is_retryable_type(exc.error_type):
                # only USER_ERROR is non-retryable: surface the typed
                # user error so upper layers also skip query-level retry
                raise PrestoUserError(
                    f"query failed [{exc.error_type}]: {exc}") from exc
            self._add_culprit(failed, str(exc), exc.location)
            if exc.error_type == INTERNAL_ERROR:
                worker = exc.location.split("/v1/task/", 1)[0]
                for lin in failed:
                    self._note_internal_failure(lin, worker, str(exc))
        elif isinstance(exc, ExchangeLostError):
            worker = exc.location.split("/v1/task/", 1)[0]
            self.suspects.add(worker)
            self._add_culprit(failed, str(exc), exc.location)
        else:
            assert isinstance(exc, _FailureSignal)
            for ev in exc.events:
                kind = ev["kind"]
                if kind == "failed":
                    et = ev.get("error_type") or parse_error_type(
                        ev.get("message", ""))
                    if not is_retryable_type(et):
                        raise PrestoUserError(
                            f"task {ev['task_id']} failed [{et}]: "
                            f"{ev['message']}") from exc
                    self._add_culprit(failed, ev.get("message", ""),
                                      ev["task_id"])
                    if et == INTERNAL_ERROR:
                        self._note_internal_failure(
                            self._lineage_of_task(ev["task_id"]),
                            ev.get("worker_uri", ""),
                            ev.get("message", ""))
                else:  # task_lost / worker_lost
                    self.suspects.add(ev["worker_uri"])
                    lin = self._lineage_of_task(ev["task_id"])
                    if lin is not None:
                        failed.add(lin)
        if not failed:
            raise PrestoQueryError(
                f"query failed (unattributable): {exc}") from exc
        return failed

    def _add_culprit(self, failed: Set[str], text: str,
                     fallback: str) -> None:
        # fallback may be a buffer location or a bare task id
        tid = fallback.rsplit("/v1/task/", 1)[-1].split("/", 1)[0]
        lin = self._culprit_lineage(text, tid)
        if lin is not None:
            failed.add(lin)

    def _note_internal_failure(self, lineage: Optional[str], worker: str,
                               message: str) -> None:
        """Poison-split quarantine bookkeeping: the same INTERNAL error
        signature for the same task lineage on >= 2 DISTINCT workers is
        deterministic, not infrastructure — fail fast with the split
        identity instead of burning the remaining attempt budget."""
        # A consumer observing its producer's failure quotes the producer's
        # buffer location; the DEEPEST quoted location names the true
        # culprit AND the worker that hosted it (the caller only knows the
        # outermost wrapper's worker, which is the wrong attribution).
        for wkr, tid in reversed(_SOURCE_LOCATIONS.findall(message or "")):
            lin = self._lineage_of_task(tid)
            if lin is not None:
                lineage, worker = lin, wkr
                break
        if not lineage or not worker:
            return
        sig = _failure_signature(message)
        key = (lineage, sig)
        workers = self.failure_workers.setdefault(key, set())
        workers.add(worker)
        if len(workers) >= 2:
            raise PoisonSplitError(lineage, workers, sig)

    def _restart(self, lineages: Set[str], cause: Exception) -> None:
        """Restart every failed lineage.  Under retry-policy=query the
        restart set also covers ALL tasks of every ancestor stage
        (consumer locations are baked into TaskSources, so a new producer
        attempt invalidates its consumers; the root's restart resets the
        collected output — exactly-once).  Under retry-policy=task the
        failed lineage restarts ALONE: its output replays from the durable
        spool and surviving consumers get their source locations refreshed
        in place, so no ancestor stage re-runs.  Only the originally
        failed lineages are charged against the attempt budget."""
        if self.max_attempts <= 0:
            raise PrestoQueryError(
                f"query failed (task retry disabled): {cause}") from cause
        for lin in sorted(lineages):
            used = self.budget_used.get(lin, 0) + 1
            if used > self.max_attempts:
                raise PrestoQueryError(
                    f"task {lin} failed after {self.max_attempts} retry "
                    f"attempt(s): {cause}") from cause
            self.budget_used[lin] = used
        self.retries += len(lineages)
        restart: Dict[int, Set[int]] = {}  # id(stage) -> task indices
        stage_by_id = {id(s): s for s in self.stages}
        for lin in lineages:
            stage, ti = self.lineage_index[lin]
            restart.setdefault(id(stage), set()).add(ti)
            if self.retry_policy == "task":
                continue  # spooled output: no ancestor cascade
            anc = stage.parent
            while anc is not None:
                restart[id(anc)] = set(range(anc.n_tasks))
                anc = anc.parent
        # cancel superseded attempts first so workers stop computing and
        # release buffer memory (retained buffers only die on teardown)
        for sid, indices in restart.items():
            stage = stage_by_id[sid]
            for ti in indices:
                old = stage.tasks[ti]
                if old is not None:
                    threading.Thread(target=old.cancel, daemon=True).start()
                stage.tasks[ti] = None
                self.id_attempt[self.lineage(stage, ti)] = \
                    self.id_attempt.get(self.lineage(stage, ti), 0) + 1
        for stage in self.stages:  # postorder: new producers first
            if id(stage) not in restart:
                continue
            for ti in sorted(restart[id(stage)]):
                self._place_task(stage, ti)
        if self.retry_policy == "task":
            self._refresh_consumers(restart, stage_by_id)

    def _refresh_consumers(self, restarted: Dict[int, Set[int]],
                           stage_by_id: Dict[int, _Stage]) -> None:
        """retry-policy=task: each SURVIVING consumer of a restarted
        producer gets a fragment-less task update carrying refreshed
        source locations, so its live exchange pulls redirect to the
        replacement attempt's buffers mid-stream (consumers that were
        themselves restarted already baked in the new locations)."""
        parents: Dict[int, _Stage] = {}
        for sid in restarted:
            parent = stage_by_id[sid].parent
            if parent is not None:
                parents[id(parent)] = parent
        for pid, parent in parents.items():
            replaced = restarted.get(pid, set())
            for ti, task in enumerate(parent.tasks):
                if task is None or ti in replaced:
                    continue
                req = TaskUpdateRequest(
                    task.task_id, ti, None,
                    self._make_sources(parent, ti), parent.spec,
                    session=self.session)
                try:
                    task.update(req, deadline_ms=self._deadline_ms())
                except (urllib.error.URLError, urllib.error.HTTPError,
                        TimeoutError, OSError):
                    pass  # the watcher surfaces a truly dead consumer

    def query_info_snapshot(self) -> dict:
        """Stage/task/operator breakdown for /v1/query/{id} (the reference
        QueryInfo.outputStage drill-down): one TaskInfo fetch per current
        task plus the cross-task per-plan-node operator rollup, keyed the
        same way the EXPLAIN ANALYZE annotator reads it.  Unreachable
        workers degrade to a stub entry instead of failing the snapshot."""
        from ..exec.scheduler import merge_node_stats
        merged: Dict[str, dict] = {}
        stages = []
        for stage in self.stages:
            tasks = []
            stage_cpu = 0
            stage_wall = 0
            stage_peak = 0
            for task in stage.tasks:
                if task is None:
                    continue
                try:
                    info = task.info()
                except (OSError, ValueError):
                    info = {"taskId": task.task_id, "unreachable": True}
                for pipe in info.get("pipelines", []):
                    for op in pipe.get("operators", []):
                        if op.get("stats"):
                            merge_node_stats(
                                merged, {op["planNodeId"]: op["stats"]})
                tstats = info.get("stats", {})
                stage_cpu += int(tstats.get("totalCpuTimeInNanos", 0))
                stage_wall += int(tstats.get("driverWallTimeInNanos", 0))
                stage_peak += int(
                    tstats.get("peakTotalMemoryInBytes", 0) or 0)
                tasks.append({"worker": task.worker_uri, **info})
            stages.append({"stageId": f"{self.qid}.{stage.stage_path}",
                           "fragmentId": stage.fragment.fragment_id,
                           "partitioning": stage.fragment.partitioning,
                           "nTasks": stage.n_tasks,
                           # cumulative driver thread-time vs wall across
                           # the stage's tasks (the reference StageStats
                           # totalCpuTime/totalScheduledTime pair): the
                           # gap is scheduling + device + exchange waits
                           "cpuTimeInNanos": stage_cpu,
                           "wallTimeInNanos": stage_wall,
                           "peakMemoryBytes": stage_peak,
                           "tasks": tasks})
        return {"traceToken": self.trace_token, "stages": stages,
                "peakMemoryBytes": sum(st.get("peakMemoryBytes", 0)
                                       for st in stages),
                "operatorStats": merged}

    def peak_memory_bytes(self) -> int:
        """Cluster-wide peak: the sum of per-task memory-pool peaks
        (reference peakTotalMemoryReservation).  Fetched task-by-task
        AFTER the drain, so admission history seeding records what the
        distributed run actually reserved instead of 0."""
        total = 0
        for t in self.all_tasks:
            if t is None:
                continue
            try:
                stats = t.info(timeout_s=5).get("stats") or {}
                total += int(stats.get("peakTotalMemoryInBytes", 0) or 0)
            except (OSError, ValueError):
                continue
        return total

    def close(self) -> None:
        if self._watcher is not None:
            self._watcher.close()
        if self._df_pump is not None:
            self._df_pump.close()
        for t in self.all_tasks:
            t.cancel()


class HttpQueryRunner(LocalQueryRunner):
    """Schedules fragment DAGs over real HTTP workers — the external-worker
    integration point the reference reaches through
    DistributedQueryRunner.setExternalWorkerLauncher
    (presto-tests/.../DistributedQueryRunner.java:190-215)."""

    def __init__(self, worker_uris: List[str], schema: str = "sf0.01",
                 failure_detector: Optional[HeartbeatFailureDetector] = None,
                 config: Optional[ExecutionConfig] = None,
                 n_tasks: int = 2, broadcast_threshold: int = 600_000,
                 session: Optional[Dict[str, str]] = None,
                 catalog: str = "tpch", device="cuda"):
        super().__init__(schema, config, catalog, device=device)
        self.worker_uris = worker_uris
        self.failure_detector = failure_detector
        self.n_tasks = n_tasks
        self.broadcast_threshold = broadcast_threshold
        self.session = session or {}
        self._rr = itertools.count()
        # lifetime counters across queries (surfaced via /v1/metrics when
        # this runner backs a coordinator's statement endpoint)
        self.tasks_retried = 0
        self.queries_failed = 0
        # observability side channels: the most recent _QueryExecution
        # (QueryInfo drill-down) and ANALYZE rollup / snapshot
        self.last_execution: Optional[_QueryExecution] = None
        self.last_query_info: Optional[dict] = None

    def _live_uris(self) -> List[str]:
        """Schedulable workers (reference NodeScheduler.createNodeSelector
        consuming the failure detector's view)."""
        if self.failure_detector is None:
            return self.worker_uris
        live = self.failure_detector.alive()
        if not live:
            raise RuntimeError("no live workers")
        return live

    # -- planning ---------------------------------------------------------
    def plan_subplan(self, sql: str):
        from ..sql.fragmenter import FragmenterConfig, plan_distributed
        output = self.plan(sql)
        names = output.column_names
        types = [v.type for v in output.outputs]
        cfg = FragmenterConfig(broadcast_threshold=self.broadcast_threshold)
        with self._validation():
            sub = plan_distributed(output, cfg, exec_config=self.config)
        return sub, names, types

    def _build_stages(self, subplan: P.SubPlan,
                      stage_path: str = "0") -> _Stage:
        children = [self._build_stages(c, f"{stage_path}.{i}")
                    for i, c in enumerate(subplan.children)]
        frag = subplan.fragment
        if frag.partitioning in (P.SOURCE_DISTRIBUTION,
                                 P.FIXED_HASH_DISTRIBUTION):
            n_tasks = self.n_tasks
        else:
            n_tasks = 1
        return _Stage(frag, children, n_tasks, stage_path)

    def _explain_http(self, ast, trace_token: str = "") -> QueryResult:
        """EXPLAIN over the HTTP-distributed plan.  ANALYZE executes the
        fragment DAG on the real workers with per-operator stats collection
        enabled in every task's session, then annotates each fragment from
        the TaskInfo rollup (the coordinator side of the task -> stage ->
        coordinator merge)."""
        from ..common.types import VarcharType
        from ..sql.explain import format_analyze_footer, format_subplan
        from ..sql.fragmenter import FragmenterConfig, plan_distributed
        from ..sql.planner import Planner
        if ast.explain_type == "VALIDATE":
            return self._explain_validate(ast)
        with self._validation():
            output = Planner(default_schema=self.schema,
                             default_catalog=self.catalog) \
                .plan_query_to_output(ast.query)
            subplan = plan_distributed(
                output,
                FragmenterConfig(
                    broadcast_threshold=self.broadcast_threshold),
                exec_config=self.config)
        stats = None
        footer = ""
        if ast.analyze:
            from ..telemetry import profile_capture
            root = self._build_stages(subplan)
            qid = (f"q{next(_query_counter)}_"
                   f"{int(time.time() * 1000) % 100000}")
            saved = self.session
            self.session = {**self.session,
                            "collect_operator_stats": "true"}
            try:
                execution = _QueryExecution(self, root, qid,
                                            trace_token=trace_token)
                self.last_execution = execution
                try:
                    # device capture covers only the coordinator's slice
                    # (root pull + in-process loopback workers); remote
                    # workers profile their own processes
                    with profile_capture(self.config.profile_dir, qid,
                                         enabled=self.config.profile) \
                            as trace_dir:
                        execution.run()
                    snapshot = execution.query_info_snapshot()
                finally:
                    self.tasks_retried += execution.retries
                    execution.close()
            finally:
                self.session = saved
            stats = snapshot["operatorStats"]
            self.last_operator_stats = stats
            self.last_query_info = snapshot
            # footer counters (fusionDeclined*/fusedProgramWallNanos) are
            # recorded in each TASK's RuntimeStats on its worker: merge
            # them across tasks, on top of the coordinator's own root-pull
            # stats
            merged_rs = execution.stats.to_dict()
            for st in snapshot["stages"]:
                for t in st["tasks"]:
                    src = (t.get("stats") or {}).get("runtimeStats") or {}
                    for k, v in src.items():
                        e = merged_rs.get(k)
                        if e is None:
                            merged_rs[k] = dict(v)
                        else:
                            e["sum"] += v["sum"]
                            e["count"] += v["count"]
                            e["min"] = min(e["min"], v["min"])
                            e["max"] = max(e["max"], v["max"])
            footer = format_analyze_footer(merged_rs,
                                           profile_dir=trace_dir)
        text = format_subplan(subplan, stats)
        if footer:
            text += "\n\n" + footer
        return QueryResult(["Query Plan"],
                           [VarcharType(max(1, len(text)))], [[text]])

    # -- execution --------------------------------------------------------
    def execute(self, sql: str, trace_token: str = "") -> QueryResult:
        from ..sql import parser as A
        try:
            ast = A.parse_sql(sql)
        except Exception:
            ast = None
        if ast is not None and isinstance(ast, A.Explain):
            return self._explain_http(ast, trace_token=trace_token)
        subplan, names, types = self.plan_subplan(sql)
        root = self._build_stages(subplan)
        qid = f"q{next(_query_counter)}_{int(time.time() * 1000) % 100000}"
        execution = _QueryExecution(self, root, qid,
                                    trace_token=trace_token)
        self.last_execution = execution
        try:
            pages = execution.run()
            result = pages_to_result(iter(pages), names, types)
            result.runtime_stats = execution.stats.to_dict()
            try:
                # per-task memory-pool peaks roll into the result so the
                # QueryCompletedEvent / history record carries a real
                # peak for adaptive admission seeding (was always 0)
                result.peak_memory_bytes = execution.peak_memory_bytes()
            except Exception:   # noqa: BLE001 — stats are best-effort
                pass
            return result
        except Exception:
            self.queries_failed += 1
            raise
        finally:
            self.tasks_retried += execution.retries
            execution.close()
