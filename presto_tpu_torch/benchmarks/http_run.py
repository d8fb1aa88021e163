"""The HTTP task plane and the coordinator on a device.

    python -m presto_tpu_torch.benchmarks.http_run --sf 10 [--device cuda]

Boots an in-process cluster: two WorkerServer(device=...) workers that
announce to one WorkerServer(coordinator=True, device=...).  Statements
go through the coordinator's /v1/statement, which runs them over the
announced workers with worker/coordinator.py's HttpQueryRunner (2 tasks
per source / hash stage, broadcast threshold 600,000 rows): each task is
a POST /v1/task on a worker, compiled there by the port's PlanCompiler on
the worker's device, and its output pages travel over the results
protocol.  Runs (every failed check raises):
  * Q1-Q22 at sf0.01 against the JAX package's golden rows
    (benchmarks/tpch_sf001_rows.json): every query of
    distributed_run.RECORDED must equal them; Q21, whose rows the
    reference's distributed runners do not hold with broadcast joins, is
    run beside them and its equality printed;
  * Q1 and Q6 at the scale factor, each equal to LocalQueryRunner's rows
    on the same device; the direct scan kernel (#1) must launch in their
    source tasks on the card (the launch delta around the two runs);
  * one join at the scale factor over a partitioned exchange
    (JOIN_SQL: filtered orders joined with filtered customers by
    custkey, broadcast_threshold=0, so both sides are hash-partitioned
    over HTTP; under 1 M rows at SF10): its rows equal to
    LocalQueryRunner's, the pages, bytes and rows the exchange moved;
  * a failed task retried: Q6 at the scale factor under session
    retry_policy=task, the workers' fault_injector failing the first task
    that starts; the rows equal the clean run's and at least one task
    was retried;
  * the graceful drain: PUT /v1/info/state SHUTTING_DOWN on one worker
    from its first task of a running Q6 (so the query is in flight); the
    query finishes with no failure and equal rows, and the drained
    worker closes itself once its output is consumed;
  * per query the client's wall and the coordinator's (QueryInfo
    elapsedTimeMillis), the task count and the exchange's bytes; each
    part's wall and kernel launches (the counts' deltas around it); one
    torch.profiler capture of Q6 through the coordinator (the device's
    busy time and idle share of the wall, as distributed_run's trace);
  * telemetry: the coordinator exports through a CollectorSink
    (telemetry/export.py) and keeps a history store.  One warm Q6 and one
    warm Q1 at the scale factor, each with a trace token, must stitch one
    trace: every fragment span parented to `query`, every task span to a
    fragment, every operator span to a task, both the coordinator and
    the worker resource roles, nothing dropped.  Each span's wall is
    printed, and the query span's wall outside every task span (task
    POSTs, status polls and result pulls: the protocol's share);
  * history-based sizing: one grouped statement twice under session
    adaptive_history_sizing=true; the repeat is sized from the first
    run's history record (history_sized_queries rises by one) and its
    rows equal the first run's.
chip_smoke.py computes `local_rows` and then runs `run` as its HTTP
phase, so the launch counts it reads around `run` are the cluster's
alone.
"""
from __future__ import annotations

import argparse
import json
import threading
import time
import urllib.request
from typing import Dict, List, Optional

import torch

from .distributed_run import GOLDEN_PATH, RECORDED, RTOL
from .rows import assert_rows_close, golden_result
from .tpch_queries import ALL, ORDERED, queries_for_sf

WORKERS = 2
ANNOUNCE_TIMEOUT_S = 30.0
# the drained worker's own exit: its 2 s grace, its tasks, the consumers
DRAIN_TIMEOUT_S = 90.0
JOIN_SQL = ("select c_mktsegment, count(*) as n, sum(o_totalprice) as total "
            "from orders, customer where o_custkey = c_custkey "
            "and o_orderdate < date '1992-04-01' and c_acctbal > 8000 "
            "group by c_mktsegment order by c_mktsegment")
# the session every retried / drained statement carries: durable spooled
# output, so a failed task retries alone and a drained worker's output
# outlives its tasks
TASK_RETRY = {"retry_policy": "task"}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)  # lint: allow-host-sync


def _launches() -> Dict[str, int]:
    from ..exec.kernels import scan_kernel as sk
    return {**sk.LAUNCHES,
            **{f"probe_{k}": v for k, v in sk.JOIN_LAUNCHES.items()}}


def _exchange() -> Dict[str, float]:
    from ..worker.exchange import EXCHANGE_METRICS
    return EXCHANGE_METRICS.snapshot()


def _get(url: str) -> dict:
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


def start_cluster(device, workers: int = WORKERS, sink=None):
    """A coordinator and `workers` workers, every one on `device`; returns
    (coordinator, [worker...]) once every worker has announced.  With a
    telemetry `sink` the coordinator exports into it, and its workers'
    tasks reach it through the process exporter."""
    from ..worker.server import WorkerServer
    coord = WorkerServer(coordinator=True, device=device,
                         telemetry_sink=sink,
                         telemetry_flush_interval_s=0.02)
    ws = [WorkerServer(discovery_uri=coord.uri, announce_interval_s=0.1,
                       device=device) for _ in range(workers)]
    deadline = time.time() + ANNOUNCE_TIMEOUT_S
    while len(coord.worker_uris()) < workers and time.time() < deadline:
        time.sleep(0.05)
    assert sorted(coord.worker_uris()) == sorted(w.uri for w in ws), \
        "workers failed to announce"
    return coord, ws


def close_cluster(coord, workers) -> None:
    for w in workers:
        w.close()
    coord.close()


def statement(coord, schema: str, sql: str,
              session: Optional[dict] = None, device=None,
              trace_token: str = "") -> dict:
    """One statement through the coordinator: the client's result, its
    wall and the coordinator's (QueryInfo elapsedTimeMillis), and the
    execution's stages (task count, rows and bytes each stage's tasks
    produced)."""
    from ..client import StatementClient
    client = StatementClient(coord.uri, schema=schema,
                             session=session or {}, timeout_s=600.0,
                             trace_token=trace_token)
    if device is not None:
        _sync(device)
    t0 = time.perf_counter()
    res = client.execute(sql)
    wall = time.perf_counter() - t0
    info = _get(f"{coord.uri}/v1/query/{res.query_id}")
    stages = [{"fragment": st["fragmentId"],
               "partitioning": st["partitioning"], "tasks": st["nTasks"],
               "output_rows": sum(t.get("stats", {}).get(
                   "outputPositions", 0) for t in st["tasks"]),
               "output_bytes": sum(t.get("stats", {}).get(
                   "outputDataSizeInBytes", 0) for t in st["tasks"])}
              for st in info.get("stages") or []]
    return {"result": res, "client_ms": wall * 1e3,
            "coordinator_ms": info["queryStats"]["elapsedTimeMillis"],
            "stages": stages, "tasks": sum(s["tasks"] for s in stages)}


def _brief(rec: dict) -> dict:
    return {k: v for k, v in rec.items() if k != "result"}


def check_golden(coord, card: str = "") -> dict:
    """Q1-Q22 at sf0.01 through the coordinator against the golden rows."""
    with open(GOLDEN_PATH) as f:
        doc = json.load(f)
    ordered = set(doc["ordered"])
    out = {}
    for q in sorted(ALL):
        ent = doc["queries"][str(q)]
        rec = statement(coord, doc["schema"], ALL[q])
        res = rec["result"]
        assert res.column_names == ent["columns"], q
        if q in RECORDED:
            assert_rows_close(res, golden_result(ent), ordered=q in ordered,
                              rtol=RTOL)
        else:
            try:
                assert_rows_close(res, golden_result(ent),
                                  ordered=q in ordered, rtol=RTOL)
                rec["equal_to_golden"] = True
            except AssertionError:
                rec["equal_to_golden"] = False
        out[f"q{q}"] = _brief(rec)
    walls = {q: round(r["client_ms"], 3) for q, r in out.items()}
    print(f"  sf0.01 through the coordinator: Q"
          f"{','.join(map(str, RECORDED))} == the JAX package's golden "
          f"rows; Q21 equal to them: {out['q21']['equal_to_golden']}; "
          f"client walls ms {walls} {card}", flush=True)
    return out


def run_scale(coord, sf: float, device, local: dict,
              card: str = "") -> dict:
    """Q1 and Q6 at the scale factor through the coordinator, each equal
    to LocalQueryRunner's rows (`run` checks #1's launches)."""
    schema = f"sf{sf:g}"
    qs = queries_for_sf(sf)
    out = {}
    for q in (1, 6):
        x0 = _exchange()
        cold = statement(coord, schema, qs[q], device=device)
        warm = statement(coord, schema, qs[q], device=device)
        x1 = _exchange()
        for rec in (cold, warm):
            assert_rows_close(rec["result"], local[q], ordered=q in ORDERED,
                              rtol=RTOL)
        out[f"q{q}"] = {
            "cold_client_ms": cold["client_ms"],
            "cold_coordinator_ms": cold["coordinator_ms"],
            **_brief(warm),
            "exchange_pages": x1["pages"] - x0["pages"],
            "exchange_bytes": x1["bytes"] - x0["bytes"]}
    for q in (1, 6):
        r = out[f"q{q}"]
        print(f"  {schema} Q{q} through the coordinator: == local; cold "
              f"{r['cold_client_ms']:.3f} ms (coordinator "
              f"{r['cold_coordinator_ms']} ms), warm {r['client_ms']:.3f} "
              f"ms (coordinator {r['coordinator_ms']} ms), {r['tasks']} "
              f"tasks, exchange {r['exchange_pages']} pages / "
              f"{r['exchange_bytes']} B over both runs {card}", flush=True)
    return out


def run_join(workers, sf: float, device, local_rows, card: str = "") -> dict:
    """JOIN_SQL over a partitioned exchange (broadcast_threshold=0) on the
    cluster's workers, equal to LocalQueryRunner's rows."""
    from ..spi import plan as P
    from ..worker.coordinator import HttpQueryRunner
    schema = f"sf{sf:g}"
    runner = HttpQueryRunner([w.uri for w in workers], schema,
                             n_tasks=WORKERS, broadcast_threshold=0,
                             device=device)
    runner.execute(JOIN_SQL)
    x0 = _exchange()
    _sync(device)
    t0 = time.perf_counter()
    res = runner.execute(JOIN_SQL)
    wall = time.perf_counter() - t0
    x1 = _exchange()
    assert_rows_close(res, local_rows, ordered=True, rtol=RTOL)
    snap = runner.last_execution.query_info_snapshot()
    parts = [st["partitioning"] for st in snap["stages"]]
    # the rows each stage's tasks handed to their consumers: every stage
    # but the root (stage path "0", pulled by the coordinator) feeds an
    # exchange between workers
    moved = sum(int(t.get("stats", {}).get("outputPositions", 0))
                for st in snap["stages"]
                if not st["stageId"].endswith(".0") for t in st["tasks"])
    rec = {"wall_ms": wall * 1e3, "rows": len(res.rows),
           "stages": len(parts), "partitionings": parts,
           "tasks": sum(st["nTasks"] for st in snap["stages"]),
           "exchange_rows": moved,
           "exchange_pages": x1["pages"] - x0["pages"],
           "exchange_bytes": x1["bytes"] - x0["bytes"],
           "exchange_uncompressed_bytes": (x1["uncompressed_bytes"]
                                           - x0["uncompressed_bytes"])}
    assert P.FIXED_HASH_DISTRIBUTION in parts, parts
    print(f"  {schema} join over a partitioned exchange: == local "
          f"({rec['rows']} rows); {rec['wall_ms']:.3f} ms, {rec['stages']} "
          f"stages {parts}, {rec['tasks']} tasks; the exchange moved "
          f"{moved} rows in {rec['exchange_pages']} pages, "
          f"{rec['exchange_bytes']} B over HTTP {card}", flush=True)
    return rec


def run_retry(coord, workers, sf: float, device, local_rows,
              card: str = "") -> dict:
    """Q6 under retry_policy=task with the first task that starts failed
    by the workers' fault injector."""
    from ..common.errors import InjectedTaskFailure
    schema = f"sf{sf:g}"
    sql = queries_for_sf(sf)[6]
    clean = statement(coord, schema, sql, session=TASK_RETRY, device=device)
    failed: List[str] = []
    lock = threading.Lock()

    def fail_first(task_id):
        with lock:
            if failed:
                return
            failed.append(task_id)
        raise InjectedTaskFailure(f"injected: the first task {task_id}")

    retried0 = sum(w.task_manager.counts()["retried"] for w in workers)
    for w in workers:
        w.task_manager.fault_injector = fail_first
    try:
        rec = statement(coord, schema, sql, session=TASK_RETRY,
                        device=device)
    finally:
        for w in workers:
            w.task_manager.fault_injector = None
    retried = sum(w.task_manager.counts()["retried"]
                  for w in workers) - retried0
    assert len(failed) == 1, failed
    assert retried >= 1, retried
    assert rec["result"].rows == clean["result"].rows
    assert_rows_close(rec["result"], local_rows, ordered=False, rtol=RTOL)
    out = {"failed_task": failed[0], "tasks_retried": retried,
           "clean_client_ms": clean["client_ms"], **_brief(rec)}
    print(f"  {schema} Q6 under retry_policy=task with task {failed[0]} "
          f"failed: == the clean run; {retried} task(s) retried; "
          f"{rec['client_ms']:.3f} ms against {clean['client_ms']:.3f} ms "
          f"clean {card}", flush=True)
    return out


def run_drain(coord, workers, sf: float, device, local_rows,
              card: str = "") -> dict:
    """PUT /v1/info/state SHUTTING_DOWN on the last worker from its first
    task of a running Q6: the query finishes with no failure, and the
    worker closes itself once its output is consumed."""
    schema = f"sf{sf:g}"
    sql = queries_for_sf(sf)[6]
    target = workers[-1]
    fired = threading.Event()

    def put_drain():
        req = urllib.request.Request(
            target.uri + "/v1/info/state", data=b'"SHUTTING_DOWN"',
            method="PUT", headers={"Content-Type": "application/json"})
        urllib.request.urlopen(req, timeout=30).close()

    def drain_on_first_task(task_id):
        if not fired.is_set():
            fired.set()
            threading.Thread(target=put_drain, daemon=True).start()

    failed0 = target.task_manager.counts()["failed"]
    target.task_manager.fault_injector = drain_on_first_task
    t0 = time.perf_counter()
    try:
        rec = statement(coord, schema, sql, session=TASK_RETRY,
                        device=device)
    finally:
        target.task_manager.fault_injector = None
    assert fired.is_set(), "no task of the query started on the worker"
    assert_rows_close(rec["result"], local_rows, ordered=False, rtol=RTOL)
    failed = target.task_manager.counts()["failed"] - failed0
    assert failed == 0, failed
    deadline = time.time() + DRAIN_TIMEOUT_S
    while time.time() < deadline and not target._closed:
        time.sleep(0.1)
    assert target._closed, "the drained worker never closed"
    closed_s = time.perf_counter() - t0
    state = coord.dispatch.get(rec["result"].query_id).state
    assert state == "FINISHED", state
    out = {"query_failures": 0, "task_failures_on_drained": failed,
           "closed_after_s": closed_s, **_brief(rec)}
    print(f"  {schema} Q6 with {target.uri} drained mid-query: finished, "
          f"== local, 0 query failures; {rec['client_ms']:.3f} ms; the "
          f"worker closed {closed_s:.3f} s after the query began {card}",
          flush=True)
    return out


def trace_q6(coord, sf: float, device, card: str = "") -> dict:
    """One warm Q6 through the coordinator under torch.profiler: the
    wall, the device's busy time (kernel, copy and memset events of every
    thread) and its idle share of the wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    schema = f"sf{sf:g}"
    sql = queries_for_sf(sf)[6]
    statement(coord, schema, sql, device=device)
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        rec = statement(coord, schema, sql, device=device)
        _sync(device)
    dev = [(e.self_device_time_total, e.count, e.key)
           for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(t for t, _c, _k in dev) / 1e3
    wall = rec["client_ms"]
    out = {"wall_ms": wall, "busy_ms": busy, "idle_share": 1 - busy / wall,
           "device_events": sum(c for _t, c, _k in dev),
           "top": sorted(dev, reverse=True)[:4]}
    print(f"  {schema} Q6 through the coordinator under torch.profiler: "
          f"wall {wall:.3f} ms, device busy {busy:.3f} ms, idle "
          f"{out['idle_share']:.4f}, {out['device_events']} device events "
          f"{card}", flush=True)
    return out


def _covered_ms(intervals) -> float:
    """The length of the union of (start, end) intervals, in ms."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total * 1e3


def trace_spans(coord, sink, sf: float, device, want: dict,
                card: str = "") -> dict:
    """One warm Q6 and one warm Q1 through the coordinator, each with a
    trace token: the exported spans must stitch one trace (the
    reference's test_end_to_end_distributed_trace); each span's wall and
    the query span's wall outside every task span are printed."""
    from ..telemetry import trace_id_for
    schema = f"sf{sf:g}"
    out = {}
    for q in (6, 1):
        token = f"smoke-q{q}-{time.time_ns()}"
        rec = statement(coord, schema, queries_for_sf(sf)[q],
                        device=device, trace_token=token)
        assert_rows_close(rec["result"], want[q], ordered=q in ORDERED,
                          rtol=RTOL)
        assert coord.telemetry.flush(timeout_s=30.0)
        tid = trace_id_for(token)
        spans = [s for s in sink.spans() if s["traceId"] == tid]
        by_id = {s["spanId"]: s for s in spans}
        kinds = {k: [s for s in spans if s["name"].split(" ")[0] == k]
                 for k in ("query", "fragment", "task", "operator")}
        (query,) = kinds["query"]
        assert kinds["fragment"] and kinds["task"] and kinds["operator"],             sorted(s["name"] for s in spans)
        parents = {"fragment": "query", "task": "fragment",
                   "operator": "task"}
        for kind, parent in parents.items():
            for s in kinds[kind]:
                p = by_id.get(s["parentSpanId"])
                assert p is not None and p["name"].startswith(parent),                     (s["name"], s["parentSpanId"])
        roles = set()
        for p in sink.payloads:
            for rs in p.get("resourceSpans", []):
                names = {sp["traceId"] for ss in rs["scopeSpans"]
                         for sp in ss["spans"]}
                if tid not in names:
                    continue
                for a in rs["resource"]["attributes"]:
                    if a["key"] == "presto.role":
                        roles.add(a["value"]["stringValue"])
        assert {"coordinator", "worker"} <= roles, roles

        def wall_ms(s):
            return (int(s["endTimeUnixNano"])
                    - int(s["startTimeUnixNano"])) / 1e6

        def interval(s):
            return (int(s["startTimeUnixNano"]) / 1e9,
                    int(s["endTimeUnixNano"]) / 1e9)
        q0, q1 = interval(query)
        in_tasks = _covered_ms(
            (max(a, q0), min(b, q1)) for a, b in map(interval, kinds["task"])
            if min(b, q1) > max(a, q0))
        r = {"client_ms": rec["client_ms"],
             "coordinator_ms": rec["coordinator_ms"],
             "query_ms": wall_ms(query),
             "fragments_ms": {s["name"]: wall_ms(s)
                              for s in kinds["fragment"]},
             "tasks_ms": {s["name"]: wall_ms(s) for s in kinds["task"]},
             "operators": len(kinds["operator"]),
             "task_union_ms": in_tasks,
             "outside_tasks_ms": wall_ms(query) - in_tasks,
             "roles": sorted(roles)}
        out[f"q{q}"] = r
        print(f"  {schema} Q{q} traced through the coordinator: one trace, "
              f"{len(spans)} spans ({len(kinds['fragment'])} fragments, "
              f"{len(kinds['task'])} tasks, {r['operators']} operators), "
              f"roles {r['roles']}; client {r['client_ms']:.3f} ms, "
              f"coordinator {r['coordinator_ms']:.3f} ms, query span "
              f"{r['query_ms']:.3f} ms, fragments "
              + ", ".join(f"{k} {v:.3f}" for k, v in
                          sorted(r["fragments_ms"].items()))
              + " ms, tasks "
              + ", ".join(f"{k.split(' ')[1]} {v:.3f}" for k, v in
                          sorted(r["tasks_ms"].items()))
              + f" ms; the tasks cover {in_tasks:.3f} ms of the query "
              f"span, {r['outside_tasks_ms']:.3f} ms outside every task "
              f"{card}", flush=True)
    c = coord.telemetry.counters()
    assert c["dropped"] == 0 and c["dropped_after_retry"] == 0, c
    out["exporter"] = c
    return out


HISTORY_SQL = ("select l_returnflag, l_linestatus, count(*) as n, "
               "sum(l_quantity) as q from lineitem "
               "where l_shipdate <= date '1998-09-01' "
               "group by l_returnflag, l_linestatus")


def run_history(coord, sf: float, device, card: str = "") -> dict:
    """One grouped statement twice under adaptive_history_sizing=true:
    the repeat is sized from the first run's record."""
    from ..exec.adaptive import ADAPTIVE_METRICS
    schema = f"sf{sf:g}"
    session = {"adaptive_history_sizing": "true"}
    sized0 = ADAPTIVE_METRICS.snapshot()["history_sized_queries"]
    first = statement(coord, schema, HISTORY_SQL, session, device)
    sized1 = ADAPTIVE_METRICS.snapshot()["history_sized_queries"]
    again = statement(coord, schema, HISTORY_SQL, session, device)
    sized2 = ADAPTIVE_METRICS.snapshot()["history_sized_queries"]
    assert_rows_close(again["result"], first["result"], ordered=False,
                      rtol=RTOL)
    assert sized1 == sized0 and sized2 == sized1 + 1, \
        (sized0, sized1, sized2)
    rec = {"first_ms": first["client_ms"], "repeat_ms": again["client_ms"],
           "history_sized_queries": sized2 - sized0,
           "history_entries": len(coord.history)}
    print(f"  {schema} grouped statement twice under adaptive history "
          f"sizing: history_sized_queries +{sized1 - sized0} on the first "
          f"run, +{sized2 - sized1} on the repeat; client "
          f"{rec['first_ms']:.3f} ms then {rec['repeat_ms']:.3f} ms; rows "
          f"equal; {rec['history_entries']} history entries {card}",
          flush=True)
    return rec


def local_rows(sf: float, device, local: Optional[dict] = None) -> dict:
    """LocalQueryRunner's rows of Q1, Q6 (unless `local` holds them) and
    JOIN_SQL at the scale factor on the device: what `run` holds the
    cluster's rows to."""
    from ..exec.runner import LocalQueryRunner
    runner = LocalQueryRunner(f"sf{sf:g}", device=device)
    qs = queries_for_sf(sf)
    want = dict(local or {})
    for q in (1, 6):
        if q not in want:
            want[q] = runner.execute(qs[q])
    want["join"] = runner.execute(JOIN_SQL)
    return want


def run(sf: float, device, want: dict, card: str = "") -> dict:
    """Every part of the module's docstring over one cluster; returns the
    records, with each part's wall and kernel launches (the join probes
    carried by #1 / #4 as `probe_*`).  `want`: local_rows(sf, device)."""
    from ..telemetry import CollectorSink
    walls, launches = {}, {}
    sink = CollectorSink()
    coord, workers = start_cluster(device, sink=sink)
    parts = (
        ("golden", lambda: check_golden(coord, card)),
        ("scale", lambda: run_scale(coord, sf, device, want, card)),
        ("trace_q6", lambda: trace_q6(coord, sf, device, card)),
        ("spans", lambda: trace_spans(coord, sink, sf, device, want,
                                      card)),
        ("history", lambda: run_history(coord, sf, device, card)),
        ("join", lambda: run_join(workers, sf, device, want["join"], card)),
        ("retry", lambda: run_retry(coord, workers, sf, device, want[6],
                                    card)),
        ("drain", lambda: run_drain(coord, workers, sf, device, want[6],
                                    card)))
    out: Dict[str, dict] = {}
    try:
        for name, part in parts:
            before = _launches()
            t0 = time.perf_counter()
            out[name] = part()
            walls[f"{name}_s"] = time.perf_counter() - t0
            launches[name] = {k: v - before[k]
                              for k, v in _launches().items()
                              if v != before[k]}
    finally:
        close_cluster(coord, workers)
    print(f"  launches by part {launches} {card}", flush=True)
    if device.type == "cuda":
        # Q1 and Q6 at the scale factor, 2 runs x 2 source tasks each
        # (the plain versions on the CPU meter no launch)
        assert launches["scale"].get("scan_direct", 0) >= 2 * WORKERS, \
            launches
    out["walls"] = walls
    out["launches"] = launches
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sf", default="10")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    from ..exec.runner import resolve_device
    device = resolve_device(args.device)
    if device.type == "cuda":
        from ..exec.kernels import build
        build.build_all()
    sf = float(args.sf)
    recs = run(sf, device, local_rows(sf, device))
    print(json.dumps(recs, default=str))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
