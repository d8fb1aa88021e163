"""Reference-shaped protocol DTOs: the Java coordinator's wire JSON.

Field names and nesting mirror the reference protocol structs that the
native worker generates from the Java sources
(presto-native-execution/presto_cpp/presto_protocol/presto_protocol.yml →
presto_protocol_core.h: TaskUpdateRequest :807, TaskSource :797,
ScheduledSplit :782, OutputBuffers :558, SessionRepresentation :697,
TaskStatus :2358; TaskInfo fixture at presto_cpp/main/tests/data/
TaskInfo.json) — scoped to the subset this worker consumes, exactly the
codegen's own strategy.

The worker ACCEPTS this shape on POST /v1/task/{id} alongside its native
compact shape (worker/protocol.py), so an HttpRemoteTask-style
coordinator can drive it; TaskStatus/TaskInfo responses carry these field
names (plus the compact legacy fields for in-repo clients).

Round-trip conformance: tests/test_presto_protocol.py re-serializes the
reference's own TaskInfo.json fixture through these DTOs and diffs
field-by-field (the fixtures are read from the reference Presto checkout
at test time).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

# TaskState enum ordinals follow reference TaskState.java
TASK_STATES = ("PLANNED", "RUNNING", "FINISHED", "CANCELED", "ABORTED",
               "FAILED")


def _opt(d: dict, key: str, value) -> None:
    if value is not None:
        d[key] = value


@dataclass
class SessionRepresentation:
    """presto_protocol_core.h:697 (subset the worker reads)."""
    queryId: str = ""
    user: str = "user"
    clientTransactionSupport: bool = False
    principal: Optional[str] = None
    source: Optional[str] = None
    catalog: Optional[str] = None
    schema: Optional[str] = None
    traceToken: Optional[str] = None
    timeZoneKey: int = 0
    locale: str = "en-US"
    remoteUserAddress: Optional[str] = None
    userAgent: Optional[str] = None
    clientInfo: Optional[str] = None
    clientTags: List[str] = field(default_factory=list)
    startTime: int = 0
    systemProperties: Dict[str, str] = field(default_factory=dict)
    catalogProperties: Dict[str, Dict[str, str]] = field(
        default_factory=dict)

    def to_json(self) -> dict:
        out = {"queryId": self.queryId,
               "clientTransactionSupport": self.clientTransactionSupport,
               "user": self.user, "timeZoneKey": self.timeZoneKey,
               "locale": self.locale, "clientTags": list(self.clientTags),
               "startTime": self.startTime,
               "systemProperties": dict(self.systemProperties),
               "catalogProperties": dict(self.catalogProperties)}
        for k in ("principal", "source", "catalog", "schema", "traceToken",
                  "remoteUserAddress", "userAgent", "clientInfo"):
            _opt(out, k, getattr(self, k))
        return out

    @staticmethod
    def from_json(d: dict) -> "SessionRepresentation":
        return SessionRepresentation(
            queryId=d.get("queryId", ""), user=d.get("user", "user"),
            clientTransactionSupport=d.get("clientTransactionSupport",
                                           False),
            principal=d.get("principal"), source=d.get("source"),
            catalog=d.get("catalog"), schema=d.get("schema"),
            traceToken=d.get("traceToken"),
            timeZoneKey=d.get("timeZoneKey", 0),
            locale=d.get("locale", "en-US"),
            remoteUserAddress=d.get("remoteUserAddress"),
            userAgent=d.get("userAgent"), clientInfo=d.get("clientInfo"),
            clientTags=d.get("clientTags", []),
            startTime=d.get("startTime", 0),
            systemProperties=d.get("systemProperties", {}),
            catalogProperties=d.get("catalogProperties", {}))


@dataclass
class ScheduledSplit:
    """presto_protocol_core.h:782: {sequenceId, planNodeId, split}."""
    sequenceId: int
    planNodeId: str
    split: dict          # {connectorId, transactionHandle?, connectorSplit}

    def to_json(self) -> dict:
        return {"sequenceId": self.sequenceId,
                "planNodeId": self.planNodeId, "split": self.split}

    @staticmethod
    def from_json(d: dict) -> "ScheduledSplit":
        return ScheduledSplit(d.get("sequenceId", 0), d["planNodeId"],
                              d.get("split", {}))


@dataclass
class TaskSource:
    """presto_protocol_core.h:797."""
    planNodeId: str
    splits: List[ScheduledSplit] = field(default_factory=list)
    noMoreSplitsForLifespan: List[dict] = field(default_factory=list)
    noMoreSplits: bool = True

    def to_json(self) -> dict:
        return {"planNodeId": self.planNodeId,
                "splits": [s.to_json() for s in self.splits],
                "noMoreSplitsForLifespan": list(
                    self.noMoreSplitsForLifespan),
                "noMoreSplits": self.noMoreSplits}

    @staticmethod
    def from_json(d: dict) -> "TaskSource":
        return TaskSource(
            d["planNodeId"],
            [ScheduledSplit.from_json(s) for s in d.get("splits", [])],
            d.get("noMoreSplitsForLifespan", []),
            d.get("noMoreSplits", True))


@dataclass
class OutputBuffers:
    """presto_protocol_core.h:558: buffers maps OutputBufferId -> logical
    partition number."""
    type: str = "PARTITIONED"      # PARTITIONED | BROADCAST | ARBITRARY
    version: int = 0
    noMoreBufferIds: bool = True
    buffers: Dict[str, int] = field(default_factory=dict)

    def to_json(self) -> dict:
        return {"type": self.type, "version": self.version,
                "noMoreBufferIds": self.noMoreBufferIds,
                "buffers": dict(self.buffers)}

    @staticmethod
    def from_json(d: dict) -> "OutputBuffers":
        return OutputBuffers(d.get("type", "PARTITIONED"),
                             d.get("version", 0),
                             d.get("noMoreBufferIds", True),
                             {str(k): int(v)
                              for k, v in d.get("buffers", {}).items()})


@dataclass
class TaskUpdateRequest:
    """presto_protocol_core.h:807 — the exact field set HttpRemoteTask
    POSTs (HttpRemoteTask.java:883-936)."""
    session: SessionRepresentation = field(
        default_factory=SessionRepresentation)
    extraCredentials: Dict[str, str] = field(default_factory=dict)
    fragment: Optional[str] = None       # base64(plan fragment json)
    sources: List[TaskSource] = field(default_factory=list)
    outputIds: OutputBuffers = field(default_factory=OutputBuffers)
    tableWriteInfo: Optional[dict] = None

    def to_json(self) -> dict:
        out = {"session": self.session.to_json(),
               "extraCredentials": dict(self.extraCredentials),
               "sources": [s.to_json() for s in self.sources],
               "outputIds": self.outputIds.to_json()}
        _opt(out, "fragment", self.fragment)
        _opt(out, "tableWriteInfo", self.tableWriteInfo)
        return out

    @staticmethod
    def from_json(d: dict) -> "TaskUpdateRequest":
        return TaskUpdateRequest(
            SessionRepresentation.from_json(d.get("session", {})),
            d.get("extraCredentials", {}), d.get("fragment"),
            [TaskSource.from_json(s) for s in d.get("sources", [])],
            OutputBuffers.from_json(d.get("outputIds", {})),
            d.get("tableWriteInfo"))


@dataclass
class TaskStatus:
    """presto_protocol_core.h:2358 / tests/data/TaskInfo.json taskStatus."""
    taskInstanceIdLeastSignificantBits: int = 0
    taskInstanceIdMostSignificantBits: int = 0
    version: int = 0
    state: str = "PLANNED"
    self_uri: str = ""
    completedDriverGroups: List[str] = field(default_factory=list)
    failures: List[dict] = field(default_factory=list)
    queuedPartitionedDrivers: int = 0
    runningPartitionedDrivers: int = 0
    outputBufferUtilization: float = 0.0
    outputBufferOverutilized: bool = False
    physicalWrittenDataSizeInBytes: int = 0
    memoryReservationInBytes: int = 0
    systemMemoryReservationInBytes: int = 0
    fullGcCount: int = 0
    fullGcTimeInMillis: int = 0
    peakNodeTotalMemoryReservationInBytes: int = 0
    totalCpuTimeInNanos: int = 0
    taskAgeInMillis: int = 0
    queuedPartitionedSplitsWeight: int = 0
    runningPartitionedSplitsWeight: int = 0

    _FIELDS = ("taskInstanceIdLeastSignificantBits",
               "taskInstanceIdMostSignificantBits", "version", "state",
               "completedDriverGroups", "failures",
               "queuedPartitionedDrivers", "runningPartitionedDrivers",
               "outputBufferUtilization", "outputBufferOverutilized",
               "physicalWrittenDataSizeInBytes",
               "memoryReservationInBytes",
               "systemMemoryReservationInBytes", "fullGcCount",
               "fullGcTimeInMillis",
               "peakNodeTotalMemoryReservationInBytes",
               "totalCpuTimeInNanos", "taskAgeInMillis",
               "queuedPartitionedSplitsWeight",
               "runningPartitionedSplitsWeight")

    def to_json(self) -> dict:
        out = {k: getattr(self, k) for k in self._FIELDS}
        out["self"] = self.self_uri
        return out

    @staticmethod
    def from_json(d: dict) -> "TaskStatus":
        kw = {k: d[k] for k in TaskStatus._FIELDS if k in d}
        return TaskStatus(self_uri=d.get("self", ""), **kw)
