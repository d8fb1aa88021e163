"""Thrift binary-protocol serde for the TaskStatus/TaskInfo hot path.

The reference negotiates three transports for coordinator<->worker
control messages: JSON, SMILE, and Thrift (HttpRemoteTask.java:915-931;
native worker: TaskResource.cpp:218-224 switches on the
"application/x-thrift+binary" mime type, HttpConstants.h:27).  This
module implements the Apache Thrift BINARY protocol from the public
Thrift specification (field header = type byte + i16 field id,
big-endian fixed-width ints, varint-free) — not a port of fbthrift — and
the struct schemas from the reference IDL
(presto-native-execution/presto_cpp/main/thrift/presto_thrift.thrift:
TaskStatus :292-314, ExecutionFailureInfo :505-515, Lifespan :99-102,
ErrorCode :315-320, TaskInfo :547-557).

Schemas are declarative tables, so decode skips unknown fields and
encode skips absent ones — the same forward-compatibility contract
Thrift gives the reference.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

CONTENT_TYPE = "application/x-thrift+binary"

# Thrift protocol type ids (Thrift spec, TBinaryProtocol)
T_STOP = 0
T_BOOL = 2
T_BYTE = 3
T_DOUBLE = 4
T_I16 = 6
T_I32 = 8
T_I64 = 10
T_STRING = 11
T_STRUCT = 12
T_MAP = 13
T_SET = 14
T_LIST = 15

_WIRE_TYPE = {"bool": T_BOOL, "byte": T_BYTE, "double": T_DOUBLE,
              "i16": T_I16, "i32": T_I32, "i64": T_I64,
              "string": T_STRING, "enum": T_I32}


def _wire_type(spec) -> int:
    if isinstance(spec, str):
        return _WIRE_TYPE[spec]
    kind = spec[0]
    if kind in ("list",):
        return T_LIST
    if kind == "set":
        return T_SET
    if kind == "struct":
        return T_STRUCT
    if kind == "enum":
        return T_I32
    if kind == "map":
        return T_MAP
    raise ValueError(f"bad type spec {spec!r}")


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------

def _enc_value(out: List[bytes], spec, value) -> None:
    if isinstance(spec, str):
        if spec == "bool":
            out.append(b"\x01" if value else b"\x00")
        elif spec == "byte":
            out.append(struct.pack(">b", int(value)))
        elif spec == "double":
            out.append(struct.pack(">d", float(value)))
        elif spec == "i16":
            out.append(struct.pack(">h", int(value)))
        elif spec == "i32":
            out.append(struct.pack(">i", int(value)))
        elif spec == "i64":
            out.append(struct.pack(">q", int(value)))
        elif spec == "string":
            raw = str(value).encode("utf-8")
            out.append(struct.pack(">i", len(raw)))
            out.append(raw)
        else:
            raise ValueError(spec)
        return
    kind = spec[0]
    if kind == "enum":
        out.append(struct.pack(">i", int(spec[1].get(value, 0))
                               if isinstance(value, str) else int(value)))
    elif kind in ("list", "set"):
        elem = spec[1]
        items = list(value)
        out.append(struct.pack(">bi", _wire_type(elem), len(items)))
        for it in items:
            _enc_value(out, elem, it)
    elif kind == "struct":
        _enc_struct(out, spec[1], value)
    else:
        raise ValueError(spec)


def _enc_struct(out: List[bytes], fields, value: dict) -> None:
    for fid, name, fspec in _fields(fields):
        v = value.get(name)
        if v is None:
            continue
        out.append(struct.pack(">bh", _wire_type(fspec), fid))
        _enc_value(out, fspec, v)
    out.append(b"\x00")         # T_STOP


def encode_struct(fields, value: dict) -> bytes:
    out: List[bytes] = []
    _enc_struct(out, fields, value)
    return b"".join(out)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def _skip(buf: memoryview, pos: int, ttype: int) -> int:
    if ttype == T_BOOL or ttype == T_BYTE:
        return pos + 1
    if ttype in (T_I16,):
        return pos + 2
    if ttype in (T_I32,):
        return pos + 4
    if ttype in (T_I64, T_DOUBLE):
        return pos + 8
    if ttype == T_STRING:
        n, = struct.unpack_from(">i", buf, pos)
        return pos + 4 + n
    if ttype in (T_LIST, T_SET):
        et, n = struct.unpack_from(">bi", buf, pos)
        pos += 5
        for _ in range(n):
            pos = _skip(buf, pos, et)
        return pos
    if ttype == T_STRUCT:
        while True:
            ft, = struct.unpack_from(">b", buf, pos)
            pos += 1
            if ft == T_STOP:
                return pos
            pos += 2
            pos = _skip(buf, pos, ft)
    if ttype == T_MAP:
        kt, vt, n = struct.unpack_from(">bbi", buf, pos)
        pos += 6
        for _ in range(n):
            pos = _skip(buf, pos, kt)
            pos = _skip(buf, pos, vt)
        return pos
    raise ValueError(f"cannot skip thrift type {ttype}")


def _dec_value(buf: memoryview, pos: int, spec):
    if isinstance(spec, str):
        if spec == "bool":
            return bool(buf[pos]), pos + 1
        if spec == "byte":
            return struct.unpack_from(">b", buf, pos)[0], pos + 1
        if spec == "double":
            return struct.unpack_from(">d", buf, pos)[0], pos + 8
        if spec == "i16":
            return struct.unpack_from(">h", buf, pos)[0], pos + 2
        if spec == "i32":
            return struct.unpack_from(">i", buf, pos)[0], pos + 4
        if spec == "i64":
            return struct.unpack_from(">q", buf, pos)[0], pos + 8
        if spec == "string":
            n, = struct.unpack_from(">i", buf, pos)
            pos += 4
            return bytes(buf[pos:pos + n]).decode("utf-8"), pos + n
        raise ValueError(spec)
    kind = spec[0]
    if kind == "enum":
        v, = struct.unpack_from(">i", buf, pos)
        rev = {n: s for s, n in spec[1].items()}
        return rev.get(v, v), pos + 4
    if kind in ("list", "set"):
        et, n = struct.unpack_from(">bi", buf, pos)
        pos += 5
        out = []
        for _ in range(n):
            v, pos = _dec_value(buf, pos, spec[1])
            out.append(v)
        return out, pos
    if kind == "struct":
        return decode_struct(spec[1], buf, pos)
    raise ValueError(spec)


def decode_struct(fields, buf: memoryview, pos: int = 0):
    by_id = {fid: (name, fspec) for fid, name, fspec in _fields(fields)}
    out: dict = {}
    while True:
        ft, = struct.unpack_from(">b", buf, pos)
        pos += 1
        if ft == T_STOP:
            return out, pos
        fid, = struct.unpack_from(">h", buf, pos)
        pos += 2
        ent = by_id.get(fid)
        if ent is None or _wire_type(ent[1]) != ft:
            pos = _skip(buf, pos, ft)       # forward compatibility
            continue
        name, fspec = ent
        out[name], pos = _dec_value(buf, pos, fspec)


def _fields(fields):
    return fields() if callable(fields) else fields


# ---------------------------------------------------------------------------
# presto_thrift.thrift schemas
# ---------------------------------------------------------------------------

TASK_STATE = ("enum", {"PLANNED": 0, "RUNNING": 1, "FINISHED": 2,
                       "CANCELED": 3, "ABORTED": 4, "FAILED": 5})
ERROR_TYPE = ("enum", {"USER_ERROR": 0, "INTERNAL_ERROR": 1,
                       "INSUFFICIENT_RESOURCES": 2, "EXTERNAL": 3})
ERROR_CAUSE = ("enum", {"UNKNOWN": 0, "LOW_PARTITION_COUNT": 1,
                        "EXCEEDS_BROADCAST_MEMORY_LIMIT": 2})

LIFESPAN = [(1, "grouped", "bool"), (2, "groupId", "i32")]

ERROR_LOCATION = [(1, "lineNumber", "i32"), (2, "columnNumber", "i32")]

ERROR_CODE = [(1, "code", "i32"), (2, "name", "string"),
              (3, "type", ERROR_TYPE), (4, "retriable", "bool")]

HOST_ADDRESS = [(1, "hostPortString", "string")]


def _failure_fields():
    # ExecutionFailureInfo is self-recursive (field 3 cause, field 4
    # suppressed); a callable schema breaks the definition cycle
    return [(1, "type", "string"),
            (2, "message", "string"),
            (3, "cause", ("struct", _failure_fields)),
            (4, "suppressed", ("list", ("struct", _failure_fields))),
            (5, "stack", ("list", "string")),
            (6, "errorLocation", ("struct", ERROR_LOCATION)),
            (7, "errorCode", ("struct", ERROR_CODE)),
            (8, "remoteHost", ("struct", HOST_ADDRESS)),
            (9, "errorCause", ERROR_CAUSE)]


EXECUTION_FAILURE_INFO = _failure_fields

# presto_thrift.thrift:292-314
TASK_STATUS = [
    (1, "taskInstanceIdLeastSignificantBits", "i64"),
    (2, "taskInstanceIdMostSignificantBits", "i64"),
    (3, "version", "i64"),
    (4, "state", TASK_STATE),
    (5, "selfUri", "string"),
    (6, "completedDriverGroups", ("set", ("struct", LIFESPAN))),
    (7, "failures", ("list", ("struct", EXECUTION_FAILURE_INFO))),
    (8, "queuedPartitionedDrivers", "i32"),
    (9, "runningPartitionedDrivers", "i32"),
    (10, "outputBufferUtilization", "double"),
    (11, "outputBufferOverutilized", "bool"),
    (12, "physicalWrittenDataSizeInBytes", "i64"),
    (13, "memoryReservationInBytes", "i64"),
    (14, "systemMemoryReservationInBytes", "i64"),
    (15, "fullGcCount", "i64"),
    (16, "fullGcTimeInMillis", "i64"),
    (17, "peakNodeTotalMemoryReservationInBytes", "i64"),
    (18, "totalCpuTimeInNanos", "i64"),
    (19, "taskAgeInMillis", "i64"),
    (20, "queuedPartitionedSplitsWeight", "i64"),
    (21, "runningPartitionedSplitsWeight", "i64"),
]


# ---------------------------------------------------------------------------
# JSON-dict <-> thrift bridges for the repo's wire DTOs
# ---------------------------------------------------------------------------

def task_status_to_thrift(d: dict) -> bytes:
    """Repo/reference JSON TaskStatus dict -> thrift bytes.  JSON field
    names match the thrift names except selfUri, which Jackson spells
    "self" (TaskStatus.java @JsonProperty("self"))."""
    msg = {k: v for k, v in d.items() if k != "failures"}
    if "self" in d:
        msg["selfUri"] = d["self"]
    failures = []
    for f in d.get("failures") or []:
        if isinstance(f, str):
            f = {"message": f, "type": "TASK_FAILURE"}
        failures.append(f)
    msg["failures"] = failures
    return encode_struct(TASK_STATUS, msg)


def task_status_from_thrift(raw: bytes) -> dict:
    """thrift bytes -> JSON-shaped TaskStatus dict (the inverse bridge the
    coordinator-side fetcher uses)."""
    msg, _ = decode_struct(TASK_STATUS, memoryview(raw))
    if "selfUri" in msg:
        msg["self"] = msg.pop("selfUri")
    return msg
