"""Coordinator<->worker protocol DTOs (JSON), session properties and the
protocol's unit parsers.

The port of presto_tpu/worker/protocol.py.  The task-update DTOs mirror
the reference task protocol surface (presto-main-base/.../server/
TaskUpdateRequest.java:37): the plan fragment rides base64-encoded inside
the update request exactly like HttpRemoteTask.sendUpdate builds it
(presto-main/.../server/remotetask/HttpRemoteTask.java:883-889).  A
Java-coordinator-shaped update (presto_protocol.py) maps onto the compact
request through from_reference_update, and its fragment is translated by
worker/plan_translation.py.

apply_session_properties maps session properties onto the port's
ExecutionConfig; a property whose field the port lacks raises
NotImplementedError naming it, so a statement carrying it FAILS with that
message instead of running without it.
"""
from __future__ import annotations

import base64
import json
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..spi import plan as P

# Task states (reference TaskState.java)
PLANNED = "PLANNED"
RUNNING = "RUNNING"
FINISHED = "FINISHED"
CANCELED = "CANCELED"
ABORTED = "ABORTED"
FAILED = "FAILED"

DONE_STATES = {FINISHED, CANCELED, ABORTED, FAILED}


@dataclass
class TaskSource:
    """Splits for one plan node (reference TaskSource.java).  A split is
    either a connector split dict or a remote-location dict
    ({"remote": true, "location": ".../results/<buffer>"}) feeding a
    RemoteSourceNode, matching how the reference ships remote splits to the
    ExchangeOperator."""
    plan_node_id: str
    splits: List[dict] = field(default_factory=list)
    no_more_splits: bool = True

    def to_dict(self):
        return {"planNodeId": self.plan_node_id, "splits": self.splits,
                "noMoreSplits": self.no_more_splits}

    @staticmethod
    def from_dict(d):
        return TaskSource(d["planNodeId"], d.get("splits", []),
                          d.get("noMoreSplits", True))


@dataclass
class OutputBuffersSpec:
    """Which output buffers a task must expose (reference OutputBuffers):
    PARTITIONED -> buffer i holds hash partition i; BROADCAST -> every buffer
    holds the full output; one buffer per consumer task either way."""
    type: str                      # "PARTITIONED" | "BROADCAST"
    n_buffers: int = 1
    partition_keys: List[str] = field(default_factory=list)

    def to_dict(self):
        return {"type": self.type, "nBuffers": self.n_buffers,
                "partitionKeys": self.partition_keys}

    @staticmethod
    def from_dict(d):
        return OutputBuffersSpec(d["type"], d.get("nBuffers", 1),
                                 d.get("partitionKeys", []))


@dataclass
class TaskUpdateRequest:
    task_id: str
    task_index: int
    fragment_b64: Optional[str]    # base64(json(PlanFragment))
    sources: List[TaskSource]
    output_buffers: OutputBuffersSpec
    session: Dict[str, str] = field(default_factory=dict)
    # reference TaskUpdateRequest.tableWriteInfo (presto_protocol_core.h:726):
    # the writer target a TableWriterNode in the fragment commits into
    table_write_info: Optional[dict] = None
    # runtime dynamic-filter summaries pushed by the coordinator once the
    # build-side stage completes (filter id -> DynamicFilterSummary wire
    # dict, exec/adaptive.py) — the analog of the reference coordinator's
    # DynamicFilterService fan-out to waiting scan tasks
    dynamic_filters: Optional[Dict[str, dict]] = None

    @staticmethod
    def make(task_id: str, task_index: int, fragment: P.PlanFragment,
             sources: List[TaskSource], output_buffers: OutputBuffersSpec,
             session: Optional[Dict[str, str]] = None) -> "TaskUpdateRequest":
        raw = json.dumps(fragment.to_dict()).encode()
        return TaskUpdateRequest(task_id, task_index,
                                 base64.b64encode(raw).decode(),
                                 sources, output_buffers, session or {})

    def fragment(self) -> P.PlanFragment:
        raw = base64.b64decode(self.fragment_b64)
        d = json.loads(raw)
        from .plan_translation import is_reference_fragment, translate_fragment
        if is_reference_fragment(d):
            # a Java-coordinator-shaped fragment (PrestoToVeloxQueryPlan
            # seam): translate the reference plan-node/RowExpression JSON
            return translate_fragment(d, self.table_write_info)
        return P.PlanFragment.from_dict(d)

    def to_dict(self):
        out = {"taskId": self.task_id, "taskIndex": self.task_index,
               "fragment": self.fragment_b64,
               "sources": [s.to_dict() for s in self.sources],
               "outputBuffers": self.output_buffers.to_dict(),
               "session": self.session}
        if self.table_write_info is not None:
            out["tableWriteInfo"] = self.table_write_info
        if self.dynamic_filters is not None:
            out["dynamicFilters"] = self.dynamic_filters
        return out

    @staticmethod
    def from_dict(d):
        return TaskUpdateRequest(
            d["taskId"], d.get("taskIndex", 0), d.get("fragment"),
            [TaskSource.from_dict(s) for s in d.get("sources", [])],
            OutputBuffersSpec.from_dict(d["outputBuffers"]),
            d.get("session", {}), d.get("tableWriteInfo"),
            d.get("dynamicFilters"))


def from_reference_update(task_id: str, d: dict) -> "TaskUpdateRequest":
    """Accept an HttpRemoteTask-shaped TaskUpdateRequest
    (presto_protocol_core.h:807: session/extraCredentials/fragment/
    sources/outputIds/tableWriteInfo) and map it onto the worker's compact
    internal request.  Output partitioning keys are not carried by the
    reference OutputBuffers — the task derives them from the fragment's
    partitioning scheme (same seam as PrestoToVeloxQueryPlan).  The task
    index (AssignUniqueId namespacing) comes from the reference taskId's
    partition component (queryId.stageId.stageExecutionId.partition.attempt,
    TaskId.java)."""
    from .presto_protocol import TaskUpdateRequest as RefUpdate
    ref = RefUpdate.from_json(d)
    parts = task_id.split(".")
    try:
        task_index = int(parts[3]) if len(parts) >= 4 else 0
    except ValueError:
        task_index = 0
    sources = []
    for ts in ref.sources:
        # raw reference split dicts; Task.start translates them inside its
        # fail-the-task guard (a malformed split must FAIL the task, not
        # 404/500 the update request)
        splits = [s.split or {} for s in ts.splits]
        sources.append(TaskSource(ts.planNodeId, splits, ts.noMoreSplits))
    bufs = ref.outputIds.buffers
    # buffers maps bufferId -> partition; BROADCAST repeats partition 0 for
    # every consumer, so the buffer COUNT comes from the ids
    n_buffers = (max(int(k) for k in bufs.keys()) + 1) if bufs else 1
    ob = OutputBuffersSpec(
        "BROADCAST" if ref.outputIds.type == "BROADCAST"
        else "PARTITIONED", n_buffers, [])
    session = dict(ref.session.systemProperties)
    return TaskUpdateRequest(task_id, task_index, ref.fragment, sources,
                             ob, session, ref.tableWriteInfo)


@dataclass
class TaskStatus:
    task_id: str
    state: str
    version: int
    self_uri: str
    failures: List[str] = field(default_factory=list)
    memory_reservation: int = 0
    completed_drivers: int = 0
    # reference ErrorType.java classification of the FIRST failure
    # (ExecutionFailureInfo.errorCode.type): the coordinator's retry
    # decision — USER_ERROR never retries, infra errors may
    error_type: str = ""

    def to_dict(self):
        # reference-shaped TaskStatus fields (presto_protocol_core.h:2358:
        # failures are ExecutionFailureInfo-shaped dicts) merged with the
        # compact extra fields in-repo clients read
        from ..common.errors import is_retryable_type
        from .presto_protocol import TaskStatus as RefStatus
        et = self.error_type or "INTERNAL_ERROR"
        ref = RefStatus(
            version=self.version, state=self.state, self_uri=self.self_uri,
            failures=[{"message": f, "type": "TASK_FAILURE",
                       "errorCode": {"name": "GENERIC_" + et, "code": 0,
                                     "type": et,
                                     "retriable": is_retryable_type(et)}}
                      for f in self.failures],
            memoryReservationInBytes=self.memory_reservation).to_json()
        ref.update({"taskId": self.task_id,
                    "completedDrivers": self.completed_drivers})
        return ref

    @staticmethod
    def from_dict(d):
        failures = [f["message"] if isinstance(f, dict) else f
                    for f in d.get("failures", [])]
        error_type = ""
        for f in d.get("failures", []):
            if isinstance(f, dict):
                error_type = (f.get("errorCode") or {}).get("type", "")
                break
        return TaskStatus(d["taskId"], d["state"], d["version"], d["self"],
                          failures,
                          d.get("memoryReservationInBytes", 0),
                          d.get("completedDrivers", 0),
                          error_type=error_type)


def make_announcement(node_id: str, uri: str, environment: str = "test",
                      pool_type: str = "TPU") -> dict:
    """Worker service announcement body (reference
    presto_cpp/main/Announcer.cpp:26-57)."""
    return {
        "environment": environment,
        "pool": "general",
        "location": f"/{node_id}",
        "services": [{
            "id": node_id,
            "type": "presto",
            "properties": {
                "node_version": "presto-tpu-0.1",
                "coordinator": "false",
                "pool_type": pool_type,
                "connectorIds": "tpch,tpcds",
                "http": uri,
            },
        }],
        "announced_at": time.time(),
    }


_SIZE_UNITS = {"B": 1, "kB": 1 << 10, "MB": 1 << 20, "GB": 1 << 30,
               "TB": 1 << 40}


def parse_data_size(s) -> int:
    """'512MB' / '1GB' / plain int -> bytes (reference DataSize parsing)."""
    if isinstance(s, int):
        return s
    s = str(s).strip()
    for unit, mult in sorted(_SIZE_UNITS.items(), key=lambda x: -len(x[0])):
        if s.endswith(unit):
            return int(float(s[:-len(unit)]) * mult)
    return int(s)


_DURATION_UNITS = {"ns": 1e-9, "us": 1e-6, "ms": 1e-3, "s": 1.0,
                   "m": 60.0, "h": 3600.0, "d": 86400.0}


def parse_duration(s) -> float:
    """'1m' / '10s' / '500ms' / plain number -> seconds (reference
    io.airlift.units.Duration parsing)."""
    if isinstance(s, (int, float)):
        return float(s)
    s = str(s).strip()
    for unit, mult in sorted(_DURATION_UNITS.items(),
                             key=lambda x: -len(x[0])):
        if s.endswith(unit):
            return float(s[:-len(unit)]) * mult
    return float(s)


def apply_session_properties(config, session: Dict[str, str]):
    """Session overrides -> a task-local ExecutionConfig (the analog of
    presto_cpp QueryContextManager::toVeloxConfigs mapping Presto session
    properties onto the execution engine's config,
    QueryContextManager.cpp:224).  Unknown keys are ignored, like the
    reference does for properties a worker does not understand."""
    import dataclasses
    if not session:
        return config
    kw = PortOverrides(config_fields(config), session, "session property",
                       "ExecutionConfig")
    session = kw.source
    if "query_max_memory_per_node" in session:
        kw["memory_budget_bytes"] = parse_data_size(
            session["query_max_memory_per_node"])
    if "query_max_memory" in session:
        kw["memory_max_query_bytes"] = parse_data_size(
            session["query_max_memory"])
    if "spill_enabled" in session:
        kw["spill_enabled"] = str(session["spill_enabled"]).lower() == "true"
    if "spill_partitions" in session:
        kw["spill_partitions"] = int(session["spill_partitions"])
    if "spill_path" in session:
        kw["spill_path"] = session["spill_path"] or None
    if "spill_host_budget_bytes" in session:
        kw["spill_budget_bytes"] = int(session["spill_host_budget_bytes"])
    if "spill_async_staging" in session:
        kw["spill_async_staging"] = (
            str(session["spill_async_staging"]).lower() == "true")
    if "task_batch_rows" in session:
        kw["batch_rows"] = int(session["task_batch_rows"])
    if "exchange_compression" in session:
        kw["exchange_compression"] = (
            str(session["exchange_compression"]).lower() == "true")
    if "exchange_compression_codec" in session:
        codec = str(session["exchange_compression_codec"]).upper()
        from ..common.compression import supported_codecs
        if codec not in supported_codecs():
            # reject at task creation (fails the task with a clear error)
            # rather than KeyError deep inside the output loop
            raise ValueError(
                f"unsupported exchange_compression_codec {codec!r}; "
                f"supported: {', '.join(supported_codecs())}")
        kw["exchange_compression_codec"] = codec
    # grouped (lifespan) execution knobs (reference grouped_execution /
    # concurrent_lifespans_per_task session properties)
    if "grouped_lifespans" in session:
        kw["grouped_lifespans"] = int(session["grouped_lifespans"])
    if "grouped_prefetch_depth" in session:
        kw["grouped_prefetch_depth"] = int(
            session["grouped_prefetch_depth"])
    if "grouped_lifespan_sharding" in session:
        kw["grouped_lifespan_sharding"] = (
            str(session["grouped_lifespan_sharding"]).lower() == "true")
    # fault-tolerance knobs (coordinator propagates its retry mode so
    # workers enable replayable output buffers; reference
    # exchange.max-error-duration / presto-spark retry budget)
    if "remote_task_retry_attempts" in session:
        kw["remote_task_retry_attempts"] = int(
            session["remote_task_retry_attempts"])
    if "exchange_max_error_duration" in session:
        kw["exchange_max_error_duration_s"] = parse_duration(
            session["exchange_max_error_duration"])
    if "retry_policy" in session:
        mode = str(session["retry_policy"]).strip().lower()
        from ..exec.pipeline import RETRY_POLICY_MODES
        if mode not in RETRY_POLICY_MODES:
            raise ValueError(
                f"retry_policy must be one of {RETRY_POLICY_MODES}, "
                f"got {mode!r}")
        kw["retry_policy"] = mode
    if "query_max_execution_time" in session:
        kw["query_max_execution_time_s"] = parse_duration(
            session["query_max_execution_time"])
    # durable-spool knobs (retry-policy=task; fall back to spill.path)
    if "spool_path" in session:
        kw["spool_path"] = session["spool_path"] or None
    if "spool_staging_budget_bytes" in session:
        kw["spool_staging_budget_bytes"] = parse_data_size(
            session["spool_staging_budget_bytes"])
    # concurrent exchange client knobs (reference exchange.client-threads /
    # exchange.max-buffer-size / exchange.max-response-size)
    if "exchange_client_threads" in session:
        n = int(session["exchange_client_threads"])
        if n < 1:
            raise ValueError(
                f"exchange_client_threads must be >= 1, got {n}")
        kw["exchange_client_threads"] = n
    if "exchange_max_buffer_size" in session:
        kw["exchange_max_buffer_bytes"] = int(parse_data_size(
            session["exchange_max_buffer_size"]))
    if "exchange_max_response_size" in session:
        kw["exchange_max_response_bytes"] = int(parse_data_size(
            session["exchange_max_response_size"]))
    if "fault_injection_probability" in session:
        p = float(session["fault_injection_probability"])
        if not 0.0 <= p <= 1.0:
            raise ValueError(
                f"fault_injection_probability must be in [0, 1], got {p}")
        kw["fault_injection_probability"] = p
    if "analyze_unfused" in session:
        # EXPLAIN ANALYZE compatibility knob: disable scan-chain fusion so
        # per-operator stats come from the interpreted streaming path
        kw["analyze_unfused"] = (
            str(session["analyze_unfused"]).lower() == "true")
    if "plan_validation" in session:
        mode = str(session["plan_validation"]).strip().lower()
        from ..analysis import VALIDATION_MODES
        if mode not in VALIDATION_MODES:
            # reject at task creation like a bad codec: a clear USER_ERROR
            # beats a silent fall-through to the default mode
            raise ValueError(
                f"plan_validation must be one of {VALIDATION_MODES}, "
                f"got {mode!r}")
        kw["plan_validation"] = mode
    if "lock_validation" in session:
        mode = str(session["lock_validation"]).strip().lower()
        if mode not in ("on", "off", "true", "false"):
            raise ValueError(
                "lock_validation must be one of on/off/true/false, "
                f"got {mode!r}")
        kw["lock_validation"] = mode in ("on", "true")
    if "scan_kernel" in session:
        mode = str(session["scan_kernel"]).strip().lower()
        from ..exec.pipeline import SCAN_KERNEL_MODES
        if mode not in SCAN_KERNEL_MODES:
            raise ValueError(
                f"scan_kernel must be one of {SCAN_KERNEL_MODES}, "
                f"got {mode!r}")
        kw["scan_kernel"] = mode
    if "profile" in session:
        # per-query device profiler capture (telemetry/profiler.py):
        # wraps execution in a torch.profiler capture under profile_dir
        kw["profile"] = str(session["profile"]).lower() == "true"
    # adaptive execution knobs (reference enable_dynamic_filtering /
    # dynamic-filtering.* session properties)
    if "dynamic_filtering" in session:
        kw["dynamic_filtering"] = (
            str(session["dynamic_filtering"]).lower() == "true")
    if "dynamic_filtering_wait_timeout" in session:
        kw["dynamic_filtering_wait_timeout_s"] = parse_duration(
            session["dynamic_filtering_wait_timeout"])
    if "dynamic_filtering_max_distinct_values" in session:
        kw["dynamic_filtering_max_distinct"] = int(
            session["dynamic_filtering_max_distinct_values"])
    if "adaptive_exchange" in session:
        kw["adaptive_exchange"] = (
            str(session["adaptive_exchange"]).lower() == "true")
    if "adaptive_history_sizing" in session:
        kw["adaptive_history_sizing"] = (
            str(session["adaptive_history_sizing"]).lower() == "true")
    if "storage_zone_rows" in session:
        # zone-map granularity: dynamic-filter pruning needs zones finer
        # than the scanned table to discriminate chunks at small scale
        n = int(session["storage_zone_rows"])
        if n < 1:
            raise ValueError(f"storage_zone_rows must be >= 1, got {n}")
        kw["storage_zone_rows"] = n
    return dataclasses.replace(config, **kw) if kw else config


class _Source(dict):
    """A property mapping that remembers the last key found in it (the
    mapping code reads each key as `key in props` before using it)."""
    last = None

    def __contains__(self, key):
        found = super().__contains__(key)
        if found:
            self.last = key
        return found

    def get(self, key, default=None):
        if super().__contains__(key):
            self.last = key
        return super().get(key, default)


class PortOverrides(dict):
    """The overrides one mapping collects from `source` (read through
    .source) for the arguments `names` of `owner`.  The reference's
    mapping code runs as it is; a key whose argument the port lacks raises
    NotImplementedError naming the key, instead of being dropped."""

    def __init__(self, names, source, what: str, owner: str):
        super().__init__()
        self._names = set(names)
        self._what = what
        self._owner = owner
        self.source = _Source(source)

    def __setitem__(self, name, value):
        if name not in self._names:
            raise NotImplementedError(
                f"{self._what} {self.source.last!r} is not ported (it sets "
                f"{self._owner}.{name}, which the port lacks)")
        super().__setitem__(name, value)


def config_fields(config) -> list:
    """The field names of an ExecutionConfig."""
    import dataclasses
    return [f.name for f in dataclasses.fields(config)]
