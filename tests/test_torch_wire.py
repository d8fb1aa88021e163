"""The port's wire encodings against the JAX package's: SMILE
(worker/smile.py), the Thrift TaskStatus (worker/thrift.py) and the
reference-shaped protocol DTOs (worker/presto_protocol.py,
protocol.from_reference_update, protocol.TaskStatus).

The cases of tests/test_smile.py, test_thrift.py and
test_presto_protocol.py, run against the port's modules; wherever a case
encodes, the port's bytes are held equal to the reference module's on
the same input, and the live-worker cases drive a port
WorkerServer(device="cpu")."""
import base64
import json
import math
import os
import struct
import time
import urllib.request

import pytest

from presto_tpu.worker import presto_protocol as JPP
from presto_tpu.worker import smile as jsmile
from presto_tpu.worker import thrift as jthrift
from presto_tpu_torch.worker import presto_protocol as PP
from presto_tpu_torch.worker import smile, thrift
from torch_threads import one_torch_thread  # noqa: F401

# the reference test's own fixture directory and skip condition
from test_presto_protocol import FIXTURES  # noqa: E402
needs_fixtures = pytest.mark.skipif(
    not os.path.isdir(FIXTURES), reason="reference fixtures not present")


def _smile_equal(value, **kw):
    """The port's SMILE bytes, held equal to the reference's."""
    got = smile.encode(value, **kw)
    assert got == jsmile.encode(value, **kw), value
    return got


# -- SMILE: the spec goldens ----------------------------------------------

def test_golden_simple_object():
    golden = b":)\n\x00\xfa\x80a\xc2\xfb"
    assert smile.decode(golden) == {"a": 1}
    assert _smile_equal({"a": 1}, shared_names=False) == golden


def test_golden_scalars():
    for raw, want in ((b":)\n\x00\x21", None), (b":)\n\x00\x22", False),
                      (b":)\n\x00\x23", True), (b":)\n\x00\x20", ""),
                      (b":)\n\x00\xc0", 0), (b":)\n\x00\xc1", -1),
                      (b":)\n\x00\xdf", -16),
                      (b":)\n\x00\x24\x1f\x90", 1000),
                      (b":)\n\x00\x42abc", "abc"),
                      (b":)\n\x00\xf8\xc2\xc4\xf9", [1, 2])):
        assert smile.decode(raw) == want == jsmile.decode(raw)
        _smile_equal(want)


def test_golden_double():
    bits = 0x3FF0000000000000
    packed = bytes((bits >> (7 * i)) & 0x7F for i in reversed(range(10)))
    assert smile.decode(b":)\n\x00\x29" + packed) == 1.0
    assert _smile_equal(1.0)[4:] == b"\x29" + packed


def test_golden_shared_names():
    doc = b":)\n\x01\xf8\xfa\x81ab\xc2\xfb\xfa\x40\xc4\xfb\xf9"
    assert smile.decode(doc) == [{"ab": 1}, {"ab": 2}]
    assert _smile_equal([{"ab": 1}, {"ab": 2}], shared_names=True) == doc


# -- SMILE: round trips over the protocol value model ---------------------

CASES = [
    None, True, False, 0, 1, -1, 15, -16, 16, 63, 64, 1234567,
    -987654321, 2**31 - 1, -(2**31), 2**62, -(2**62), 2**70, -(2**70),
    0.0, 1.5, -3.25, math.pi, 1e300, -1e-300,
    "", "x", "a" * 32, "a" * 33, "a" * 64, "a" * 65, "a" * 500,
    "héllo", "ünïcode" * 12, "日本語テキスト",
    [], {}, [1, [2, [3, [4]]]], {"a": {"b": {"c": [None, True, 2.5]}}},
    {"taskId": "q.1.0.3.0", "fragment": base64.b64encode(
        b"PLAN" * 100).decode(),
     "sources": [{"planNodeId": "0", "splits": [
         {"sequenceId": i, "split": {"connectorId": "tpch"}}
         for i in range(5)], "noMoreSplits": True}],
     "outputIds": {"type": "PARTITIONED", "buffers": {"0": 0},
                   "noMoreBufferIds": True},
     "session": {"user": "test", "catalog": "tpch",
                 "systemProperties": {}}},
]


@pytest.mark.parametrize("shared", [True, False])
def test_round_trips(shared):
    for case in CASES:
        raw = _smile_equal(case, shared_names=shared)
        assert smile.decode(raw) == case, case


def test_shared_names_shrink_repetitive_payloads():
    doc = [{"columnName": "c", "typeSignature": "bigint"}] * 64
    shared = _smile_equal(doc, shared_names=True)
    plain = _smile_equal(doc, shared_names=False)
    assert smile.decode(shared) == doc == smile.decode(plain)
    assert len(shared) < len(plain) / 1.5


def test_shared_name_table_overflow_resets():
    doc = {f"k{i:04d}": i for i in range(1500)}
    assert smile.decode(_smile_equal(doc, shared_names=True)) == doc


def test_json_compatibility_matrix():
    j = json.loads(json.dumps(CASES[-1]))
    assert smile.decode(_smile_equal(j)) == j


def test_pack7_matches_jackson_alignment():
    from presto_tpu_torch.worker.smile import _pack7, _packed7_len, _unpack7
    assert _pack7(b"\x81") == bytes([0x40, 0x01])
    assert _unpack7(bytes([0x40, 0x01])) == b"\x81"
    for n in range(25):
        raw = bytes((i * 37 + 11) & 0xFF for i in range(n))
        assert len(_pack7(raw)) == _packed7_len(n)
        assert _unpack7(_pack7(raw))[:n] == raw
        assert _pack7(raw) == jsmile._pack7(raw)
    v = 2 ** 70 - 3
    enc = _smile_equal(v)
    assert enc[4] == 0x26
    assert enc[5] == 0x80 | 9
    assert len(enc) == 6 + 11
    assert smile.decode(enc) == v


def test_long_shared_value_refs_decode():
    body = bytearray(b":)\n\x02\xf8")
    vals = [f"s{i:02d}" for i in range(40)]
    for v in vals:
        body.append(0x40 + len(v) - 1)
        body.extend(v.encode())
    body.extend([0x2C | (33 >> 8), 33 & 0xFF])
    body.append(0xF9)
    got = smile.decode(bytes(body))
    assert got == vals + [vals[33]] == jsmile.decode(bytes(body))


# -- Thrift TaskStatus ----------------------------------------------------

def _thrift_equal(d):
    raw = thrift.encode_struct(thrift.TASK_STATUS, d)
    assert raw == jthrift.encode_struct(jthrift.TASK_STATUS, d), d
    return raw


def test_golden_minimal_status():
    raw = _thrift_equal({"version": 7, "state": "RUNNING"})
    assert raw == (b"\x0a\x00\x03" + struct.pack(">q", 7)
                   + b"\x08\x00\x04" + struct.pack(">i", 1) + b"\x00")


def test_golden_string_field():
    raw = _thrift_equal({"selfUri": "http://x"})
    assert raw == (b"\x0b\x00\x05" + struct.pack(">i", 8) + b"http://x"
                   + b"\x00")


FULL_STATUS = {
    "taskInstanceIdLeastSignificantBits": 1,
    "taskInstanceIdMostSignificantBits": 2,
    "version": 42, "state": "FAILED", "selfUri": "http://w:8080/t",
    "completedDriverGroups": [{"grouped": True, "groupId": 3}],
    "failures": [{"type": "X", "message": "boom", "stack": ["a", "b"],
                  "errorCode": {"code": 1, "name": "GENERIC",
                                "type": "INTERNAL_ERROR",
                                "retriable": False},
                  "cause": {"type": "Y", "message": "inner"}}],
    "queuedPartitionedDrivers": 4, "runningPartitionedDrivers": 5,
    "outputBufferUtilization": 0.25, "outputBufferOverutilized": True,
    "physicalWrittenDataSizeInBytes": 10, "memoryReservationInBytes": 11,
    "systemMemoryReservationInBytes": 12, "fullGcCount": 0,
    "fullGcTimeInMillis": 0, "peakNodeTotalMemoryReservationInBytes": 13,
    "totalCpuTimeInNanos": 14, "taskAgeInMillis": 15,
    "queuedPartitionedSplitsWeight": 16,
    "runningPartitionedSplitsWeight": 17}


def test_round_trip_full_status():
    raw = _thrift_equal(FULL_STATUS)
    out, end = thrift.decode_struct(thrift.TASK_STATUS, memoryview(raw))
    assert end == len(raw)
    assert out == jthrift.decode_struct(jthrift.TASK_STATUS,
                                        memoryview(raw))[0]
    assert out["failures"][0]["cause"]["message"] == "inner"
    assert out["completedDriverGroups"] == [{"grouped": True, "groupId": 3}]
    for k, v in FULL_STATUS.items():
        if k not in ("failures", "completedDriverGroups"):
            assert out[k] == v, k


def test_unknown_fields_are_skipped():
    known = _thrift_equal({"version": 9})
    unknown = (b"\x0b\x00\x63" + struct.pack(">i", 3) + b"xyz")
    raw = known[:-1] + unknown + b"\x00"
    out, _ = thrift.decode_struct(thrift.TASK_STATUS, memoryview(raw))
    assert out == {"version": 9}


def test_json_bridge_maps_self_uri():
    d = {"version": 1, "state": "RUNNING", "self": "http://w/t",
         "failures": ["boom"], "memoryReservationInBytes": 5}
    raw = thrift.task_status_to_thrift(d)
    assert raw == jthrift.task_status_to_thrift(d)
    back = thrift.task_status_from_thrift(raw)
    assert back["self"] == "http://w/t"
    assert back["failures"][0]["message"] == "boom"
    assert back["memoryReservationInBytes"] == 5


# -- the reference-shaped DTOs ----------------------------------------------

@needs_fixtures
def test_task_status_round_trips_reference_fixture():
    with open(os.path.join(FIXTURES, "TaskInfo.json")) as f:
        ref = json.load(f)
    out = PP.TaskStatus.from_json(ref["taskStatus"]).to_json()
    for k, v in ref["taskStatus"].items():
        assert out[k] == v, (k, out.get(k), v)
    assert set(out) == set(ref["taskStatus"])


def _update(pp):
    return pp.TaskUpdateRequest(
        session=pp.SessionRepresentation(
            queryId="q1", user="alice", catalog="tpch", schema="sf0.01",
            systemProperties={"query_max_memory": "1GB"}),
        extraCredentials={"token": "t"},
        fragment=base64.b64encode(b"{}").decode(),
        sources=[pp.TaskSource("scan.0", [
            pp.ScheduledSplit(7, "scan.0",
                              {"connectorId": "tpch",
                               "connectorSplit": {"table": "lineitem",
                                                  "sf": 0.01,
                                                  "start": 0, "end": 10}})])],
        outputIds=pp.OutputBuffers("PARTITIONED", 3, True,
                                   {"0": 0, "1": 1}))


def test_update_request_round_trip():
    d = _update(PP).to_json()
    assert json.dumps(d, sort_keys=True) == json.dumps(
        _update(JPP).to_json(), sort_keys=True)
    back = PP.TaskUpdateRequest.from_json(d)
    assert back.to_json() == d
    assert back.session.systemProperties == {"query_max_memory": "1GB"}
    assert back.sources[0].splits[0].sequenceId == 7


def test_broadcast_buffer_count_from_ids():
    from presto_tpu.worker.protocol import from_reference_update as jfrom
    from presto_tpu_torch.worker.protocol import from_reference_update
    body = {
        "session": PP.SessionRepresentation(queryId="q", user="u").to_json(),
        "extraCredentials": {},
        "fragment": base64.b64encode(b"{}").decode(),
        "sources": [],
        "outputIds": PP.OutputBuffers(
            "BROADCAST", 0, True, {"0": 0, "1": 0, "2": 0}).to_json(),
    }
    upd = from_reference_update("q.0.0.0.0", body)
    assert upd.output_buffers.n_buffers == 3
    assert upd.output_buffers.type == "BROADCAST"
    assert upd.to_dict() == jfrom("q.0.0.0.0", body).to_dict()


def test_task_status_dict_equals_the_reference():
    """TaskStatus.to_dict (the JSON every status poll carries) equals the
    reference's field for field, a failure's error code included."""
    from presto_tpu.worker.protocol import TaskStatus as JStatus
    from presto_tpu_torch.worker.protocol import TaskStatus
    args = ("q.1.0.0.0", "FAILED", 3, "http://w/v1/task/q.1.0.0.0",
            ["boom"], 123, 2)
    mine = TaskStatus(*args, error_type="USER_ERROR").to_dict()
    assert mine == JStatus(*args, error_type="USER_ERROR").to_dict()
    back = TaskStatus.from_dict(mine)
    assert (back.failures, back.error_type) == (["boom"], "USER_ERROR")


# -- live port worker over the three transports ---------------------------

def _nation_count_body(task_id, cat, P, Planner):
    out = Planner(default_schema="sf0.01", default_catalog="tpch") \
        .plan("SELECT count(*) AS n FROM nation")
    frag = P.PlanFragment(
        "0", out, P.SOURCE_DISTRIBUTION,
        P.PartitioningScheme(P.SINGLE_DISTRIBUTION, [],
                             list(out.output_variables)),
        [n.id for n in P.walk_plan(out) if isinstance(n, P.TableScanNode)])
    return {
        "taskId": task_id,
        "fragment": base64.b64encode(
            json.dumps(frag.to_dict()).encode()).decode(),
        "sources": [{"planNodeId": sid,
                     "splits": [s.to_dict() for s in
                                cat.make_splits("nation", 0.01, 2)],
                     "noMoreSplits": True}
                    for sid in frag.partitioned_sources],
        "outputBuffers": {"type": "PARTITIONED", "nBuffers": 1,
                          "partitionKeys": []},
    }


@pytest.fixture(scope="module")
def worker():
    from presto_tpu_torch.worker.server import WorkerServer
    w = WorkerServer(device="cpu")
    yield w
    w.close()


def _modules():
    from presto_tpu_torch.connectors import catalog as cat
    from presto_tpu_torch.spi import plan as P
    from presto_tpu_torch.sql.planner import Planner
    return cat, P, Planner


def _poll(url, accept, decode, timeout_s=60):
    deadline = time.time() + timeout_s
    while True:
        r = urllib.request.urlopen(urllib.request.Request(
            url, headers={"Accept": accept}), timeout=30)
        st = decode(r.read())
        if st["state"] in ("FINISHED", "FAILED", "CANCELED") \
                or time.time() > deadline:
            return st
        time.sleep(0.05)


def test_worker_speaks_smile_end_to_end(worker):
    from presto_tpu_torch.common.block import block_to_values
    from presto_tpu_torch.common.serde import deserialize_page
    from presto_tpu_torch.common.types import BIGINT
    body = _nation_count_body("smq.0.0.0.0", *_modules())
    req = urllib.request.Request(
        f"{worker.uri}/v1/task/smq.0.0.0.0", data=smile.encode(body),
        method="POST", headers={"Content-Type": smile.CONTENT_TYPE,
                                "Accept": smile.CONTENT_TYPE})
    resp = urllib.request.urlopen(req, timeout=30)
    assert resp.headers.get("Content-Type") == smile.CONTENT_TYPE
    assert smile.decode(resp.read())["state"] in (
        "PLANNED", "RUNNING", "FINISHED")
    st = _poll(f"{worker.uri}/v1/task/smq.0.0.0.0/status",
               smile.CONTENT_TYPE, smile.decode)
    assert st["state"] == "FINISHED", st
    info = smile.decode(urllib.request.urlopen(urllib.request.Request(
        f"{worker.uri}/v1/task/smq.0.0.0.0",
        headers={"Accept": smile.CONTENT_TYPE}), timeout=30).read())
    assert info["stats"]["outputPositions"] == 1
    data = urllib.request.urlopen(
        f"{worker.uri}/v1/task/smq.0.0.0.0/results/0/0", timeout=30).read()
    page, _ = deserialize_page(data)
    assert block_to_values(BIGINT, page.blocks[0]) == [25]


def test_task_status_negotiates_three_transports(worker):
    body = _nation_count_body("thr.0.0.0.0", *_modules())
    req = urllib.request.Request(
        f"{worker.uri}/v1/task/thr.0.0.0.0",
        data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json",
                 "Accept": thrift.CONTENT_TYPE})
    resp = urllib.request.urlopen(req, timeout=30)
    assert resp.headers.get("Content-Type") == thrift.CONTENT_TYPE
    status_url = f"{worker.uri}/v1/task/thr.0.0.0.0/status"
    st = _poll(status_url, thrift.CONTENT_TYPE,
               thrift.task_status_from_thrift)
    assert st["state"] == "FINISHED"
    as_json = json.loads(urllib.request.urlopen(urllib.request.Request(
        status_url, headers={"Accept": "application/json"}),
        timeout=30).read())
    raw_smile = urllib.request.urlopen(urllib.request.Request(
        status_url, headers={"Accept": smile.CONTENT_TYPE}),
        timeout=30).read()
    as_smile = smile.decode(raw_smile)
    assert as_json["state"] == as_smile["state"] == st["state"]
    assert as_json["version"] == as_smile["version"] == st["version"]
    assert as_json["self"] == as_smile["self"] == st["self"]
    assert as_json["memoryReservationInBytes"] \
        == st["memoryReservationInBytes"]
    # the served bytes are the reference encoders' bytes of that status
    assert raw_smile == jsmile.encode(as_json)
    raw_thrift = urllib.request.urlopen(urllib.request.Request(
        status_url, headers={"Accept": thrift.CONTENT_TYPE}),
        timeout=30).read()
    assert raw_thrift == jthrift.task_status_to_thrift(as_json)


def test_worker_accepts_reference_envelope_with_repo_fragment(worker):
    """A reference-shaped TaskUpdateRequest envelope carrying a repo-IR
    fragment of the port's own distributed plan; the pages pulled back
    hold the JAX package's count."""
    from presto_tpu_torch.common.block import block_to_values
    from presto_tpu_torch.common.serde import deserialize_page
    from presto_tpu_torch.common.types import BIGINT
    from presto_tpu_torch.sql.fragmenter import (FragmenterConfig,
                                                 plan_distributed)
    cat, P, Planner = _modules()
    out = Planner(default_schema="sf0.01", default_catalog="tpch") \
        .plan("SELECT count(*) AS n FROM nation")
    sub = plan_distributed(out, FragmenterConfig())
    frag = sub.children[0].fragment if sub.children else sub.fragment
    sources = []
    for sc in [n for n in P.walk_plan(frag.root)
               if isinstance(n, P.TableScanNode)]:
        splits = cat.make_splits(sc.table.table_name, 0.01, 1,
                                 sc.table.connector_id)
        sources.append(PP.TaskSource(sc.id, [
            PP.ScheduledSplit(i, sc.id, {"connectorId": sp.connector,
                                         "connectorSplit": sp.to_dict()})
            for i, sp in enumerate(splits)]).to_json())
    body = {
        "session": PP.SessionRepresentation(
            queryId="q_interop", user="test").to_json(),
        "extraCredentials": {},
        "fragment": base64.b64encode(
            json.dumps(frag.to_dict()).encode()).decode(),
        "sources": sources,
        "outputIds": PP.OutputBuffers(
            "PARTITIONED", 0, True, {"0": 0}).to_json(),
    }
    req = urllib.request.Request(
        f"{worker.uri}/v1/task/q_interop.0.0.0.0",
        data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    st = json.load(urllib.request.urlopen(req, timeout=30))
    assert st["state"] in ("PLANNED", "RUNNING", "FINISHED")
    assert "taskInstanceIdLeastSignificantBits" in st
    rows, token = [], 0
    deadline = time.time() + 60
    while time.time() < deadline:
        r = urllib.request.urlopen(
            f"{worker.uri}/v1/task/q_interop.0.0.0.0/results/0/{token}",
            timeout=30)
        data = r.read()
        complete = r.headers.get("X-Presto-Buffer-Complete") == "true"
        nxt = r.headers.get("X-Presto-Page-End-Sequence-Id")
        pos = 0
        while pos < len(data):
            page, pos = deserialize_page(data, pos)
            rows += block_to_values(BIGINT, page.blocks[0])
        if complete:
            break
        token = int(nxt) if nxt else token + 1
        time.sleep(0.05)
    # the leaf fragment's PARTIAL count of nation's rows
    assert sum(rows) == 25
