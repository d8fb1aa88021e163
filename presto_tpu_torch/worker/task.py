"""Worker-side task manager: TaskUpdateRequest -> running pipeline.

The port of presto_tpu/worker/task.py, the analog of the reference
SqlTaskManager/SqlTaskExecution (presto-main-base/.../execution/
SqlTaskManager.java:103, SqlTaskExecution.java:83) and the native TaskManager
(presto_cpp/main/TaskManager.cpp:493): decode the base64 plan fragment,
build a TaskContext from the shipped splits and remote-source locations,
run the compiled pipeline on an executor thread, and stream output pages
into token-acknowledged output buffers, hash-partitioned per the fragment's
output partitioning scheme.

Every task computes on its manager's device: the TaskContext of each task
is built on it (a task of a WorkerServer(device="cuda") never runs on the
CPU), and the task's executor thread enters that device and the stream
the manager was built on, since torch's current device and stream are
per thread.  A traced task (one that carries a trace token) exports its
span subtree -- the task span and one span per operator -- into the
process telemetry exporter when it ends (telemetry/export.py).
"""
from __future__ import annotations

import contextlib
import threading
import traceback
from typing import Callable, Dict, List, Optional

import torch

from ..common.errors import (INTERNAL_ERROR, USER_ERROR, InjectedTaskFailure,
                             QueryDeadlineExceededError, classify_exception)
from ..common.locks import OrderedCondition, OrderedLock, validation_scope
from ..common.serde import serialize_page
from ..connectors import catalog, tpch
from ..exec.pipeline import (ExecutionConfig, PlanCompiler, TaskContext,
                             tuned_config)
from ..exec.scheduler import partition_targets, split_page
from ..spi import plan as P
from .buffers import OutputBufferManager
from .exchange import remote_page_reader
from .protocol import (DONE_STATES, FAILED, FINISHED, PLANNED, RUNNING,
                       CANCELED, TaskStatus, TaskUpdateRequest)


class TpuTask:
    """One task: state machine + executor thread + output buffers."""

    def __init__(self, task_id: str, self_uri: str, config: ExecutionConfig,
                 events=None, manager=None, device="cuda", stream=None):
        from ..exec.runner import resolve_device
        self.task_id = task_id
        # where the fragment computes ("cuda" without CUDA raises), and
        # the CUDA stream its thread issues work on (None on the CPU)
        self.device = resolve_device(device)
        self.stream = stream
        self.self_uri = self_uri
        self.config = config
        self.events = events
        self.manager = manager
        self.state = PLANNED              # lint: guarded-by(_cond)
        self.version = 0                  # lint: guarded-by(_cond)
        self.failures: List[str] = []     # lint: guarded-by(_cond)
        self.error_type = ""              # lint: guarded-by(_cond)
        self.buffers: Optional[OutputBufferManager] = None
        self.done_at: Optional[float] = None  # lint: guarded-by(_cond)
        self.memory_peak = 0
        self.memory_ctx = None            # task MemoryContext (set by start)
        # TaskInfo stats surface (reference TaskInfo/TaskStats): the
        # coordinator-side aggregation and UI drill-down consume these
        import time as _t
        self.created_at = _t.time()
        self.output_rows = 0
        self.output_pages = 0
        self.output_bytes = 0
        self.plan_nodes: List[dict] = []
        from ..utils.runtime_stats import RuntimeStats
        self.stats = RuntimeStats()       # exchange-client walls/bytes etc.
        # X-Presto-Trace-Token propagated by the coordinator (session key
        # "trace_token"); echoed back in TaskInfo so a trace id observed at
        # the coordinator can be joined against worker-side task records
        self.trace_token = ""
        # X-Presto-Task-Deadline: the query's remaining wall budget at
        # dispatch time, converted to a worker-local monotonic deadline
        # (relative ms avoids any coordinator<->worker clock agreement);
        # enforced by the _run page loop and the TaskManager reaper
        self._deadline: Optional[float] = None
        self._deadline_budget_s = 0.0
        # remote-source locations by plan node, shared BY REFERENCE with
        # this task's exchange readers so a coordinator task-retry can
        # redirect live pulls to the replacement attempt's buffers
        self._remote_locations: Dict[str, List[str]] = {}
        self._remote_clients: Dict[str, list] = {}
        # runtime dynamic filters (exec/adaptive.py): summaries RECEIVED
        # from the coordinator (filter id -> wire dict, shared by
        # reference with the TaskContext so late deliveries still prune
        # splits not yet drained) and summaries PRODUCED by this task's
        # own output (published through TaskInfo for collection)
        self.dynamic_filters: Dict[str, dict] = {}  # lint: guarded-by(_cond)
        self.dynamic_filter_summaries: Dict[str, dict] = {}
        self._df_wait_done = False        # lint: guarded-by(_cond)
        # rank 16: above the task manager (14), below every data-plane
        # lock; _set_state never nests (events and the manager counter
        # fire after release)
        self._cond = OrderedCondition("task-state", 16)
        self._thread: Optional[threading.Thread] = None

    def info(self) -> dict:
        """TaskInfo payload (reference TaskInfo.java shape, scoped to the
        fields our coordinator consumes: status + task-level stats + the
        fragment's plan-node inventory)."""
        import time as _t
        status = self.status()
        return {
            "taskId": self.task_id,
            "taskStatus": status.to_dict(),
            "traceToken": self.trace_token,
            "noMoreSplits": True,
            # build-side dynamic-filter summaries this task produced
            # (fragment.dynamic_filter_sources); the coordinator merges
            # them across the stage's tasks and pushes the result to the
            # downstream scan tasks (worker/coordinator.py)
            "dynamicFilterSummaries": dict(self.dynamic_filter_summaries),
            "stats": {
                "createTime": self.created_at,
                # drain-pipeline wall when task_concurrency > 1: serialize
                # wall overlapping it is (elapsed - drain) — the local-
                # exchange overlap surface (TaskStats per-pipeline walls)
                "drainPipelineWallS": round(
                    getattr(self, "_drain_wall", [0.0])[0], 4),
                "elapsedTimeInNanos": int(
                    (_t.time() - self.created_at) * 1e9),
                # driver thread-time vs driver wall (sampled at the _run
                # boundaries): the per-stage CPU/wall attribution in
                # /v1/query/{id} sums these across the stage's tasks
                "totalCpuTimeInNanos": getattr(
                    self, "_driver_cpu_nanos", 0),
                "driverWallTimeInNanos": getattr(
                    self, "_driver_wall_nanos", 0),
                "outputPositions": self.output_rows,
                "outputDataSizeInBytes": self.output_bytes,
                "bufferedPages": self.output_pages,
                "peakTotalMemoryInBytes": self.memory_peak,
                # arbitrated-pool surface: revocation is observable per
                # task (spilledBytes > 0 after a revoke/self-spill), and
                # retained output pages appear as revocable bytes
                "spilledBytes": (
                    0 if self.memory_ctx is None
                    else self.memory_ctx.pool.spilled_bytes),
                # fault-tolerant mode: raw bytes durably staged through the
                # task's output spool (0 under retry-policy=query)
                "spooledBytes": (
                    0 if self.buffers is None
                    else self.buffers.spooled_bytes),
                "memoryReservedBytes": (
                    0 if self.memory_ctx is None
                    else self.memory_ctx.pool.reserved),
                "memoryRevocableBytes": (
                    0 if self.memory_ctx is None
                    else self.memory_ctx.pool.revocable),
                "memoryOverFree": (
                    0 if self.memory_ctx is None
                    else self.memory_ctx.pool.over_free_count),
                "state": self.state,
                # the wire this task's remote-source inputs rode: the
                # worker protocol pulls pages over HTTP regardless of the
                # configured preference (ICI engages only inside a
                # mesh-pinned in-process stage, exec/scheduler.py)
                "exchangeFabric": "http",
                "exchangeFabricRequested": getattr(
                    self.config, "exchange_fabric", "auto"),
                # which fused-scan implementation this task's config
                # requested (the CUDA scan kernels vs the torch chain); actual
                # engagement is per-scan via the kernelScanPrograms /
                # kernelDeclined{reason} runtime-stats counters
                "scanKernel": getattr(
                    self.config, "scan_kernel", "auto"),
                "runtimeStats": self.stats.to_dict(),
            },
            "pipelines": [{
                "operators": self.plan_nodes,
            }],
        }

    # -- state ------------------------------------------------------------
    def _set_state(self, state: str, failure: Optional[str] = None,
                   error_type: str = "") -> None:
        import time
        with self._cond:
            if self.state in DONE_STATES:
                return
            self.state = state
            self.version += 1
            if failure:
                self.failures.append(failure)
                if not self.error_type:
                    self.error_type = error_type or INTERNAL_ERROR
            if state in DONE_STATES:
                self.done_at = time.monotonic()
            self._cond.notify_all()
        if state == FAILED and self.manager is not None:
            # lifetime counter: incremented under the MANAGER's lock (this
            # used to be a bare cross-object `+= 1` racing every executor
            # thread), and only after _cond is released — task-state (16)
            # never nests into task-manager (14)
            self.manager.note_task_failed()
        if state in DONE_STATES and self.events is not None:
            # task-level terminal event from the WORKER path (reference
            # QueryMonitor per-task stats; listener isolation inside the
            # manager keeps a broken listener from failing the task)
            from .events import TaskCompletedEvent
            now = time.time()
            self.events.task_completed(TaskCompletedEvent(
                task_id=self.task_id, state=state,
                create_time=self.created_at, end_time=now,
                wall_time_s=now - self.created_at,
                output_rows=self.output_rows,
                output_pages=self.output_pages,
                output_bytes=self.output_bytes,
                peak_memory_bytes=self.memory_peak,
                error=failure.splitlines()[-1] if failure else None))

    def status(self) -> TaskStatus:
        with self._cond:
            return TaskStatus(self.task_id, self.state, self.version,
                              self.self_uri, list(self.failures),
                              memory_reservation=self.memory_peak,
                              error_type=self.error_type)

    def wait_status(self, current_state: Optional[str],
                    max_wait_s: float) -> TaskStatus:
        """Long-poll: return when state differs from current_state or the
        wait expires (reference TaskResource.getTaskStatus :189)."""
        import time
        deadline = time.monotonic() + max_wait_s
        with self._cond:
            while (current_state is not None
                   and self.state == current_state
                   and self.state not in DONE_STATES):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
        return self.status()

    def cancel(self) -> None:
        self._set_state(CANCELED)
        if self.buffers:
            # drop undelivered pages and unblock a backpressured producer
            self.buffers.destroy_all()

    def fail(self, message: str, error_type: str = INTERNAL_ERROR) -> None:
        """Force-fail a RUNNING task (TaskManager.abort chaos hook): the
        executor thread observes the terminal state at its next page and
        stops; consumers see the tagged error on their next pull."""
        if self.buffers:
            self.buffers.set_error(
                f"task {self.task_id} failed [{error_type}]: {message}")
        self._set_state(FAILED, message, error_type)

    # -- deadline (X-Presto-Task-Deadline) --------------------------------
    def set_deadline(self, remaining_ms: float) -> None:
        """Arm the task's wall deadline from the header's REMAINING budget
        (the coordinator forwards what's left of query.max-execution-time
        at dispatch; monotonic-local, no clock sync needed)."""
        import time
        self._deadline = time.monotonic() + max(0.0, remaining_ms) / 1000.0
        self._deadline_budget_s = max(0.0, remaining_ms) / 1000.0

    def deadline_exceeded(self) -> bool:
        import time
        return (self._deadline is not None
                and time.monotonic() > self._deadline
                and self.state not in DONE_STATES)

    def _check_deadline(self) -> None:
        """Raise the typed non-retryable time-limit error past deadline
        (called from the _run page loop so device work stops promptly)."""
        import time
        if self._deadline is not None and time.monotonic() > self._deadline:
            over = time.monotonic() - self._deadline
            raise QueryDeadlineExceededError(
                self._deadline_budget_s + over, self._deadline_budget_s,
                context=f"task {self.task_id}")

    def fail_deadline(self) -> None:
        """Reaper-side enforcement: a stuck (or executor-less) task past
        its deadline fails with the same typed user error."""
        import time
        over = (time.monotonic() - self._deadline
                if self._deadline is not None else 0.0)
        err = QueryDeadlineExceededError(
            self._deadline_budget_s + max(0.0, over),
            self._deadline_budget_s, context=f"task {self.task_id}")
        self.fail(str(err), USER_ERROR)

    def _exchange_abort(self) -> None:
        """should_abort hook for this task's exchange clients: once the
        task is terminal (FAILED sibling propagated, canceled, finished)
        every remote-source pull stops promptly instead of draining."""
        if self.state in DONE_STATES:
            from .exchange import ExchangeAbortedError
            raise ExchangeAbortedError(
                f"task {self.task_id} is {self.state}; aborting exchange "
                f"pull")

    def deliver_dynamic_filters(self, filters: Dict[str, dict]) -> None:
        """Coordinator push of collected build-side summaries.  The dict
        handed to this task's TaskContext is SHARED and updated in place,
        so a summary landing while the task runs still prunes splits not
        yet drained (late binding, no recompile).  One arriving after the
        bounded pre-start wait already expired is metered as a late
        arrival — never an error (the scan simply ran unfiltered)."""
        from ..exec.adaptive import ADAPTIVE_METRICS
        with self._cond:
            self.dynamic_filters.update(filters)
            late = self._df_wait_done
            self._cond.notify_all()
        if late:
            ADAPTIVE_METRICS.incr("filter_late_arrivals", len(filters))

    def _await_dynamic_filters(self, fragment: P.PlanFragment,
                               ctx: TaskContext) -> None:
        """Bounded pre-execution wait for the dynamic filters this
        fragment's scans are annotated to consume
        (dynamic-filtering.wait-timeout; reference
        DynamicFilterService#blockUntilDynamicFilter).  On timeout the
        scan proceeds unfiltered — pruning is advisory, so waiting
        forever for a filter that may never arrive (killed build worker)
        would trade availability for nothing."""
        import time
        from ..exec.adaptive import ADAPTIVE_METRICS
        expected = set()
        if ctx.config.dynamic_filtering:
            for n in P.walk_plan(fragment.root):
                if isinstance(n, P.TableScanNode):
                    for e in getattr(n, "runtime_filters", ()) or ():
                        expected.add(e["id"])
        timed_out = False
        deadline = time.monotonic() + max(
            0.0, ctx.config.dynamic_filtering_wait_timeout_s)
        with self._cond:
            while expected - set(self.dynamic_filters) \
                    and self.state not in DONE_STATES:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    timed_out = True
                    break
                self._cond.wait(remaining)
            self._df_wait_done = True
        if timed_out:
            ADAPTIVE_METRICS.incr("filter_wait_timeouts")

    def update_remote_sources(self, sources) -> None:
        """Fragment-less task update (coordinator task-retry under
        retry-policy=task): a failed PRODUCER was replaced by a new
        attempt, so this consumer's exchange pulls must redirect to the
        replacement's buffer locations.  The stored location lists are
        mutated IN PLACE (fresh clients pick them up) and every live
        client is told to relocate, resuming each stream at its delivered
        token — exactly-once because the spool replays deterministically
        from 0."""
        from .plan_translation import translate_split
        for source in sources:
            old = self._remote_locations.get(source.plan_node_id)
            if old is None:
                continue
            splits = [translate_split(s) for s in source.splits]
            new_locs = [s["location"] for s in splits if s.get("remote")]
            if not new_locs:
                continue
            old[:] = new_locs
            for client in self._remote_clients.get(source.plan_node_id, []):
                try:
                    client.update_locations(new_locs)
                except Exception:
                    pass  # a closed client has nothing to redirect

    # -- execution ----------------------------------------------------------
    def start(self, update: TaskUpdateRequest) -> None:
        try:
            fragment = update.fragment()
            spec = update.output_buffers
            from ..exec.memory import MemoryContext, MemoryPool
            from .protocol import apply_session_properties
            cfg = apply_session_properties(self.config, update.session)
            # the task's node of the query->task->operator context tree:
            # the arbitrated pool below it serves both the executor's
            # operators and the output buffers' retained-page charge, and
            # a query.max-memory ceiling rides in as max_bytes
            self.memory_ctx = MemoryContext(
                MemoryPool(cfg.memory_budget_bytes),
                f"task/{self.task_id}",
                max_bytes=cfg.memory_max_query_bytes)
            # retry mode makes buffers replayable: a retried consumer
            # re-reads from token 0, so acknowledged pages must survive —
            # charged to this task's context as revocable bytes (spilled
            # to disk by the arbitrator under pressure).  retry-policy=task
            # goes further: output pages are DURABLY spooled (host-RAM
            # staging -> LZ4 block file) and retained past task completion,
            # so a failed task retries alone — no ancestor restart — and a
            # draining worker's output survives its exit
            spool = None
            if getattr(cfg, "retry_policy", "query") == "task":
                from .spooling import TaskSpool
                spool = TaskSpool(
                    self.task_id, spec.n_buffers,
                    spool_dir=cfg.spool_path or cfg.spill_path,
                    memory=self.memory_ctx,
                    staging_budget_bytes=cfg.spool_staging_budget_bytes)
            self.buffers = OutputBufferManager(
                spec.type, spec.n_buffers,
                retain=spool is None and cfg.remote_task_retry_attempts > 0,
                coalesce_target_bytes=cfg.exchange_max_response_bytes,
                memory=self.memory_ctx, spill_dir=cfg.spill_path,
                spool=spool)
            if update.dynamic_filters:
                # summaries known at dispatch time (build stage already
                # finished) ride the create request — no wait needed
                self.dynamic_filters.update(update.dynamic_filters)
            ctx = TaskContext(config=cfg, device=self.device,
                              task_index=update.task_index,
                              memory=self.memory_ctx,
                              runtime_stats=self.stats,
                              dynamic_filters=self.dynamic_filters)
            self.trace_token = update.session.get("trace_token", "")
            if self.trace_token:
                print(f"[trace {self.trace_token}] task {self.task_id} "
                      f"starting")
            if str(update.session.get(
                    "collect_operator_stats", "")).lower() == "true":
                # coordinator-requested per-node operator stats (EXPLAIN
                # ANALYZE / QueryInfo drill-down): enable the same node-id
                # keyed stats dict the local ANALYZE path uses; merged into
                # the TaskInfo plan-node inventory when the task finishes
                ctx.stats = {}
            from .plan_translation import translate_split
            for source in update.sources:
                splits = [translate_split(s) for s in source.splits]
                remote = [s["location"] for s in splits if s.get("remote")]
                conn = [s for s in splits if not s.get("remote")]
                if remote:
                    # should_abort: a sibling failure (or cancel) puts this
                    # task in a terminal state, and the exchange pull must
                    # stop with it instead of draining a doomed query.
                    # The location list is kept (by reference) and every
                    # client created is registered, so a coordinator task
                    # retry can redirect live pulls mid-stream
                    # (update_remote_sources).
                    self._remote_locations[source.plan_node_id] = remote
                    nid = source.plan_node_id
                    ctx.remote_pages[nid] = \
                        remote_page_reader(
                            remote, codec=cfg.exchange_compression_codec,
                            max_error_duration_s=
                            cfg.exchange_max_error_duration_s,
                            should_abort=self._exchange_abort,
                            client_threads=cfg.exchange_client_threads,
                            max_buffer_bytes=cfg.exchange_max_buffer_bytes,
                            max_response_bytes=
                            cfg.exchange_max_response_bytes,
                            stats=self.stats,
                            park_on_failure=(
                                getattr(cfg, "retry_policy", "query")
                                == "task"),
                            on_client=lambda c, n=nid: (
                                self._remote_clients.setdefault(
                                    n, []).append(c)))
                if conn:
                    ctx.splits[source.plan_node_id] = [
                        catalog.TableSplit.from_dict(s) for s in conn]
        except Exception as e:
            # a malformed update (bad fragment, bad session property) must
            # fail the task, not strand it in PLANNED (the coordinator
            # sees FAILED on its next status poll, TaskResource.cpp:242-255)
            error_type = classify_exception(e)
            message = traceback.format_exc()
            if self.buffers is None:
                self.buffers = OutputBufferManager("PARTITIONED", 1)
            self.buffers.set_error(
                f"task {self.task_id} failed to start "
                f"[{error_type}]:\n{message}")
            self._set_state(FAILED, message, error_type)
            return

        self._set_state(RUNNING)
        self._thread = threading.Thread(
            target=self._run, args=(fragment, spec, ctx),
            name=f"task-{self.task_id}", daemon=True)
        self._thread.start()

    def _inject_fault(self, ctx: TaskContext) -> None:
        """Chaos hooks (the HTTP-worker mirror of the batch scheduler's
        SchedulerConfig.fault_injector): a manager-level injector callable
        and a config/session probability.  The probabilistic roll is a
        DETERMINISTIC hash of the task id, so a given chaos run replays
        exactly and a retry (new attempt id) rolls independently."""
        if self.manager is not None and self.manager.fault_injector:
            self.manager.fault_injector(self.task_id)
        p = ctx.config.fault_injection_probability
        if p > 0.0:
            import hashlib
            h = int.from_bytes(hashlib.sha256(
                self.task_id.encode()).digest()[:8], "big")
            if h % 1_000_000 < p * 1_000_000:
                raise InjectedTaskFailure(
                    f"injected task failure (p={p}, task {self.task_id})")

    def _on_device(self):
        """The task's device and stream, entered on its executor thread."""
        if self.stream is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(self.device))
        stack.enter_context(torch.cuda.stream(self.stream))
        return stack

    def _run(self, fragment: P.PlanFragment, spec, ctx: TaskContext) -> None:
        # debug.lock-validation=on (worker property or lock_validation
        # session override): every OrderedLock acquisition made while this
        # task executes — by ANY thread, the flag is process-global and
        # counting so concurrent scoped tasks compose — is checked against
        # the declared rank order and metered into presto_tpu_lock_*
        with self._on_device():
            if getattr(ctx.config, "lock_validation", False):
                with validation_scope():
                    return self._run_impl(fragment, spec, ctx)
            return self._run_impl(fragment, spec, ctx)

    def _run_impl(self, fragment: P.PlanFragment, spec,
                  ctx: TaskContext) -> None:
        # driver-boundary CPU vs wall: _run IS the task's driver thread,
        # so thread_time measures its compute and the wall-minus-CPU gap
        # is time spent waiting (device syncs, buffer backpressure,
        # exchange pulls) -- surfaced as totalCpuTimeInNanos in TaskInfo
        # and rolled up per stage by the coordinator
        import time as _t
        t0 = _t.perf_counter()  # lint: allow-wall-clock
        c0 = _t.thread_time()
        try:
            self.plan_nodes = [
                {"planNodeId": n.id, "operatorType": type(n).__name__}
                for n in P.walk_plan(fragment.root)]
            self._inject_fault(ctx)
            out_vars = fragment.root.output_variables
            out_types = [v.type for v in out_vars]
            out_names = [v.name for v in out_vars]
            keys = spec.partition_keys
            if keys:
                # explicit keys: a name the fragment doesn't output is a
                # malformed update and must fail loudly
                key_indices = [out_names.index(k) for k in keys]
            else:
                # reference-shaped updates carry no keys in OutputBuffers:
                # the fragment's own partitioning scheme defines them
                scheme = getattr(fragment, "output_partitioning_scheme",
                                 None)
                key_indices = [out_names.index(a.name)
                               for a in (scheme.arguments if scheme
                                         else [])
                               if a.name in out_names]
            n_parts = len(self.buffers.buffers)
            partitioned = (spec.type == "PARTITIONED" and n_parts > 1
                           and key_indices)
            # bounded wait for runtime dynamic filters BEFORE the drain
            # starts, so the scan's first split resolution already sees
            # them; producer-side summarization setup mirrors the
            # in-process scheduler (exec/scheduler._summarize_page_block)
            self._await_dynamic_filters(fragment, ctx)
            from ..exec.scheduler import _summarize_page_block
            dyn_max = ctx.config.dynamic_filtering_max_distinct
            dyn_idx = ([(out_names.index(c), fid)
                        for c, fid in fragment.dynamic_filter_sources.items()
                        if c in out_names]
                       if ctx.config.dynamic_filtering else [])
            task_sums: Dict[str, object] = {}
            compiler = PlanCompiler(ctx)
            pages = compiler.run_to_pages(fragment.root)
            if ctx.config.task_concurrency > 1:
                # overlap pipeline drain (device dispatch + page decode)
                # with serialization + buffering — the two-pipeline shape
                # the reference gets from separate drivers connected by a
                # local exchange.  background_drain owns the thread
                # lifecycle: cancelling the task closes the generator,
                # which stops and unblocks the producer.
                from ..exec.local_exchange import background_drain
                drain_wall = [0.0]
                pages = background_drain(pages, wall_out=drain_wall)
                self._drain_wall = drain_wall
            for page in pages:
                self.memory_peak = ctx.memory.peak
                self._check_deadline()
                if self.state in DONE_STATES:
                    # deterministic shutdown of the drain pipeline (the
                    # generator's close() stops background producers)
                    if hasattr(pages, "close"):
                        pages.close()
                    return
                self.output_rows += page.position_count
                for j, fid in dyn_idx:
                    s = _summarize_page_block(fid, page.blocks[j], dyn_max)
                    prev = task_sums.get(fid)
                    task_sums[fid] = s if prev is None \
                        else prev.merge(s, dyn_max)
                compress = ctx.config.exchange_compression
                codec = ctx.config.exchange_compression_codec
                if partitioned:
                    targets = partition_targets(page, out_types, key_indices,
                                                n_parts)
                    for p, sub in enumerate(
                            split_page(page, targets, n_parts)):
                        if sub is not None:
                            data = serialize_page(sub, compress=compress,
                                                  codec=codec)
                            self.output_pages += 1
                            self.output_bytes += len(data)
                            self.buffers.add(p, data)
                else:
                    data = serialize_page(page, compress=compress,
                                          codec=codec)
                    self.output_pages += 1
                    self.output_bytes += len(data)
                    self.buffers.add(0, data)
            self.memory_peak = ctx.memory.peak
            if dyn_idx:
                # a task with no output still publishes EMPTY summaries:
                # a zero-row build side legitimately prunes every
                # downstream chunk, unlike an absent summary (unknown)
                from ..exec.adaptive import DynamicFilterSummary
                for _j, fid in dyn_idx:
                    if fid not in task_sums:
                        task_sums[fid] = DynamicFilterSummary(
                            fid, row_count=0)
                self.dynamic_filter_summaries = {
                    fid: s.to_dict() for fid, s in task_sums.items()}
            if ctx.stats:
                # attach the collected per-node operator stats to the plan-
                # node inventory (TaskInfo pipelines[].operators[].stats) so
                # the coordinator can roll them up across tasks; everything
                # in the stats dicts is already JSON-safe
                for op in self.plan_nodes:
                    s = ctx.stats.get(op["planNodeId"])
                    if s is not None:
                        op["stats"] = s
            self.buffers.set_complete()
            if self.buffers.spooled_bytes:
                # EXPLAIN ANALYZE footer + coordinator roll-up surface
                self.stats.add("spoolBytes", self.buffers.spooled_bytes,
                               "BYTE")
            self._set_state(FINISHED)
        except Exception as e:
            # tag the failure with its reference error type so consumers
            # (and the coordinator behind them) can decide retryability —
            # a propagated USER_ERROR stays non-retryable end to end
            error_type = classify_exception(e)
            message = traceback.format_exc()
            self.buffers.set_error(
                f"task {self.task_id} failed [{error_type}]:\n{message}")
            self._set_state(FAILED, message, error_type)
        finally:
            wall = _t.perf_counter() - t0  # lint: allow-wall-clock
            self._driver_cpu_nanos = int((_t.thread_time() - c0) * 1e9)
            self._driver_wall_nanos = int(wall * 1e9)
            self.stats.add("driverCpuNanos", self._driver_cpu_nanos,
                           "NANO")
            self.stats.add("driverWallNanos", self._driver_wall_nanos,
                           "NANO")
            try:
                self._export_spans(fragment)
            except Exception:
                pass  # telemetry must never fail a task

    def _export_spans(self, fragment: P.PlanFragment) -> None:
        """Export this task's span subtree into the process telemetry
        exporter.  Span names embed the task id and parent the owning
        fragment's span by NAME — span ids are derived from
        (trace token, name) on both sides (telemetry/otlp.py), so the
        coordinator's `fragment {id}` span and this worker's
        `task {id}` span stitch into one distributed trace without any
        coordinator<->worker handshake."""
        if not self.trace_token:
            return
        from ..telemetry import get_process_exporter
        exp = get_process_exporter()
        if exp is None:
            return
        import time as _t
        from ..utils.runtime_stats import Span
        end = _t.time()
        task_name = f"task {self.task_id}"
        spans = [Span(
            name=task_name,
            parent=f"fragment {fragment.fragment_id}",
            start=self.created_at, end=end,
            attributes={
                "presto.task_id": self.task_id,
                "presto.state": self.state,
                "presto.rows": self.output_rows,
                "presto.pages": self.output_pages,
                "presto.bytes": self.output_bytes,
                "presto.cpu_nanos": getattr(self, "_driver_cpu_nanos", 0),
                "presto.peak_memory_bytes": self.memory_peak,
            })]
        for op in self.plan_nodes:
            attrs = {"presto.operator": op.get("operatorType", ""),
                     "presto.plan_node_id": op.get("planNodeId", "")}
            for k, v in (op.get("stats") or {}).items():
                if isinstance(v, (bool, int, float, str)):
                    attrs[k] = v
            spans.append(Span(
                name=f"operator {self.task_id}.{op.get('planNodeId', '')}",
                parent=task_name,
                start=self.created_at, end=end, attributes=attrs))
        exp.export_spans(self.trace_token, spans,
                         resource={"presto.role": "worker",
                                   "presto.task_uri": self.self_uri})


class TaskManager:
    """Task registry (reference SqlTaskManager.java:103) on one device
    (`device`, "cuda" by default).  Terminal tasks
    are evicted after a grace period — both inline on task creation and by
    a periodic reaper thread (the reference's PeriodicTaskManager task
    cleanup), so a worker that stops receiving new tasks still frees
    terminal tasks and their retained buffers."""

    TASK_TTL_S = 300.0
    REAPER_INTERVAL_S = 15.0

    def __init__(self, base_uri: str = "",
                 config: Optional[ExecutionConfig] = None, events=None,
                 device="cuda"):
        from ..exec.runner import resolve_device
        self.base_uri = base_uri
        # every task computes here ("cuda" without CUDA raises), issuing
        # its work on the stream current where the manager was built
        self.device = resolve_device(device)
        self.stream = (torch.cuda.current_stream(self.device)
                       if self.device.type == "cuda" else None)
        self.config = config or tuned_config()
        self.events = events
        # rank 14: held across _evict_locked -> buffers.destroy_all, which
        # takes buffer conditions (30) and the spool (32) underneath
        self._lock = OrderedLock("task-manager", 14)
        self.tasks: Dict[str, TpuTask] = {}       # lint: guarded-by(_lock)
        self.tasks_created = 0                    # lint: guarded-by(_lock)
        self.tasks_failed = 0                     # lint: guarded-by(_lock)
        self.tasks_retried = 0                    # lint: guarded-by(_lock)
        # chaos hook: fault_injector(task_id) raises to fail the task at
        # start (the worker mirror of SchedulerConfig.fault_injector)
        self.fault_injector: Optional[Callable[[str], None]] = None
        self._reaper_stop: Optional[threading.Event] = None

    def counts(self) -> Dict[str, int]:
        """Live task-state counts + lifetime counters (metrics/status)."""
        with self._lock:
            by_state: Dict[str, int] = {}
            mem_peak = 0
            for t in self.tasks.values():
                by_state[t.state] = by_state.get(t.state, 0) + 1
                mem_peak = max(mem_peak, t.memory_peak)
            return {"created": self.tasks_created, "by_state": by_state,
                    "memory_peak": mem_peak,
                    "failed": self.tasks_failed,
                    "retried": self.tasks_retried}

    def note_task_failed(self) -> None:
        """Lifetime failure counter, bumped by tasks entering FAILED.
        Taken under the manager lock: executor threads from many tasks
        race on it, and a bare `+= 1` loses increments."""
        with self._lock:
            self.tasks_failed += 1

    def _evict_locked(self) -> None:
        import time
        now = time.monotonic()
        dead = [tid for tid, t in self.tasks.items()
                if t.done_at is not None and now - t.done_at > self.TASK_TTL_S]
        for tid in dead:
            if self.tasks[tid].buffers is not None:
                self.tasks[tid].buffers.destroy_all()
            del self.tasks[tid]

    def evict_terminal(self) -> None:
        with self._lock:
            self._evict_locked()
            overdue = [t for t in self.tasks.values()
                       if t.deadline_exceeded()]
        for t in overdue:
            # reaper-side deadline enforcement: even a task whose executor
            # is stuck (device sync, backpressure) fails its deadline
            t.fail_deadline()

    def flush_spools(self) -> int:
        """Graceful drain: force every task's spool staging to disk so
        spooled output survives this worker's exit."""
        with self._lock:
            tasks = list(self.tasks.values())
        return sum(t.buffers.flush_spool() for t in tasks
                   if t.buffers is not None)

    def all_output_consumed(self) -> bool:
        """Drain gate: every COMPLETE task output stream has been acked or
        released by its consumer (tasks still running don't count yet)."""
        with self._lock:
            tasks = list(self.tasks.values())
        return all(t.buffers.all_consumed() for t in tasks
                   if t.buffers is not None)

    def start_reaper(self, interval_s: Optional[float] = None) -> None:
        """Periodic terminal-task eviction (reference PeriodicTaskManager):
        without it a worker that stops receiving create_or_update calls
        never evicts done tasks or frees their buffers."""
        if self._reaper_stop is not None:
            return
        stop = threading.Event()
        self._reaper_stop = stop
        interval = interval_s or self.REAPER_INTERVAL_S

        def loop():
            while not stop.wait(interval):
                self.evict_terminal()
        threading.Thread(target=loop, name="task-reaper",
                         daemon=True).start()

    def stop_reaper(self) -> None:
        if self._reaper_stop is not None:
            self._reaper_stop.set()
            self._reaper_stop = None

    def create_or_update(self, update: TaskUpdateRequest,
                         deadline_ms: Optional[float] = None) -> TaskStatus:
        import re
        with self._lock:
            self._evict_locked()
            task = self.tasks.get(update.task_id)
            if task is None:
                if not update.fragment_b64 and update.sources:
                    # source-refresh for a task we don't know (it already
                    # finished and was evicted): answer with a terminal
                    # stub instead of stranding a PLANNED zombie in the
                    # registry
                    return TaskStatus(update.task_id, CANCELED, 0,
                                      f"{self.base_uri}/v1/task/"
                                      f"{update.task_id}", [])
                self.tasks_created += 1
                if re.search(r"\.r\d+$", update.task_id):
                    # coordinator retry lineage suffix (taskId.rATTEMPT)
                    self.tasks_retried += 1
                task = TpuTask(update.task_id,
                               f"{self.base_uri}/v1/task/{update.task_id}",
                               self.config, events=self.events, manager=self,
                               device=self.device, stream=self.stream)
                self.tasks[update.task_id] = task
                fresh = True
            else:
                fresh = False
        if deadline_ms is not None:
            task.set_deadline(deadline_ms)
        if fresh and update.fragment_b64:
            task.start(update)
        elif not fresh:
            if update.sources:
                # coordinator task-retry: redirect this consumer's
                # exchange pulls to the replacement attempt's locations
                task.update_remote_sources(update.sources)
            if update.dynamic_filters:
                # coordinator push of collected build-side summaries to
                # a task created before they existed (it may be waiting
                # on them, running unfiltered, or already done)
                task.deliver_dynamic_filters(update.dynamic_filters)
        return task.status()

    def get(self, task_id: str) -> TpuTask:
        task = self.tasks.get(task_id)
        if task is None:
            raise KeyError(task_id)
        return task

    def abort(self, task_id: str,
              message: str = "aborted by chaos hook") -> None:
        """Force-fail one running task (chaos testing: the deterministic
        'kill this task mid-query' lever next to the probabilistic
        injection)."""
        self.get(task_id).fail(message)

    def cancel_all(self) -> None:
        self.stop_reaper()
        for t in list(self.tasks.values()):
            t.cancel()
