"""The device exchange over a mesh of positions on one device.

    python -m presto_tpu_torch.benchmarks.mesh_run --sf 10 [--device cuda]
        [--positions 4] [--chunk-rows 65536]

Two DistributedQueryRunners over one mesh, make_mesh(devices=[device] *
positions), with one task per position: one with exchange_fabric "ici"
(every eligible hashed edge is the device exchange of
parallel/exchange.py: the producers' output stays on the device and moves
to its consumer's position in chunks), one with "http" (the same stages,
the hashed edges through host pages).  The exchange's chunk is
CHUNK_ROWS rows (exchange.ici-chunk-rows; 0 asks the tuner): the size
the tuner settles at, parallel/fabric.py IciChunkTuner.MAX_ROWS, since
its consumers wait on no exchange here (overlap above HIGH), and the
one at which each consumer's chunk over 4 positions is the page path's
pack of EXCHANGE_PACK_ROWS rows.  Runs (every failed check raises):
  * Q1, Q3, Q5, Q18, the GROUPBY of tests/test_ici_exchange.py and W1 at
    the scale factor through both runners: the ici rows equal the http
    rows (integers exactly, floats within RTOL); every query's hashed
    edges engaged the device exchange (the ici exchanges counted in
    FABRIC_METRICS) with no fallback to pages;
  * per query the two walls (one run each after a warm-up of Q1 under
    both, host clock around execute, the device synchronized), the
    exchanged bytes and chunks and the drain / wait walls the consumers
    measured; the launches of the direct (#1), hash (#4) and window (#6)
    kernels in each runner's runs;
  * one torch.profiler capture of Q3 through each runner: the device's
    busy time and its idle share of the wall.
chip_smoke.py runs `run` as its mesh phase, with the launch counts set
to 0 just before it.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict

import torch

from ..parallel.fabric import IciChunkTuner
from .distributed_run import RTOL
from .rows import assert_rows_close
from .tpch_queries import ORDERED, queries_for_sf
from .window_queries import W1

POSITIONS = 4
# the GROUPBY of tests/test_ici_exchange.py
GROUPBY = ("SELECT o.custkey, count(*) AS c, sum(o.totalprice) AS s "
           "FROM orders o GROUP BY o.custkey")
QUERIES = ("q1", "q3", "q5", "q18", "groupby", "w1")
KERNELS = ("scan_direct", "scan_hash", "window_scan")
CHUNK_ROWS = IciChunkTuner.MAX_ROWS


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)  # lint: allow-host-sync


def _launches() -> Dict[str, int]:
    from ..exec.kernels import scan_kernel as sk
    return {k: sk.LAUNCHES[k] for k in KERNELS}


def _stat(res, key: str) -> float:
    return float((res.runtime_stats or {}).get(key, {}).get("sum", 0))


def sqls(sf: float) -> Dict[str, tuple]:
    """name -> (SQL, ordered)."""
    qs = queries_for_sf(sf)
    out = {f"q{q}": (qs[q], q in ORDERED) for q in (1, 3, 5, 18)}
    out["groupby"] = (GROUPBY, False)
    out["w1"] = (W1, True)
    return out


def runners(sf: float, device, positions: int = POSITIONS,
            chunk_rows: int = 0):
    """(ici runner, http runner) over one mesh of `positions` positions
    on `device`."""
    from ..exec.pipeline import tuned_config
    from ..exec.runner import DistributedQueryRunner
    from ..parallel.mesh import make_mesh
    mesh = make_mesh(devices=[device] * positions)
    schema = f"sf{sf:g}"
    return tuple(DistributedQueryRunner(
        schema, n_tasks=positions, mesh=mesh, device=device,
        config=tuned_config(exchange_fabric=fabric,
                            ici_chunk_rows=chunk_rows))
        for fabric in ("ici", "http"))


def _timed(runner, sql, device):
    _sync(device)
    t0 = time.perf_counter()
    res = runner.execute(sql)
    _sync(device)
    return res, time.perf_counter() - t0


def _assert_equal(got, exp, ordered: bool) -> None:
    """assert_rows_close; an unordered result whose first column is
    unique (GROUPBY's custkeys) is put in that column's order first,
    which is cheaper than sorting its million rows by every value."""
    if not ordered and len({r[0] for r in exp.rows}) == len(exp.rows):
        got.rows.sort(key=lambda r: r[0])
        exp.rows.sort(key=lambda r: r[0])
        ordered = True
    assert_rows_close(got, exp, ordered=ordered, rtol=RTOL)


def trace(runner, sql, device, trace_dir: str = "build/profiles") -> dict:
    """One run under torch.profiler: the wall, the device's busy time
    (the kernel, copy and memset events of every thread) and its idle
    share.  Only the device's activity is recorded, and it is read from
    the profiler's own trace file (written under `trace_dir`, removed
    after): building the profiler's Python events of a multi-second
    query took longer than the query (about 0.3 ms per device event on
    an H100)."""
    from torch.profiler import ProfilerActivity, profile
    acts = ([ProfilerActivity.CUDA] if device.type == "cuda"
            else [ProfilerActivity.CPU])
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        _res, wall = _timed(runner, sql, device)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"mesh-{os.getpid()}-{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    dev = [e for e in events
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    busy = sum(e.get("dur", 0) for e in dev) / 1e3
    return {"wall_ms": wall * 1e3, "busy_ms": busy,
            "profiler_s": time.perf_counter() - t0 - wall,
            "idle_share": 1 - busy / (wall * 1e3),
            "d2h_ms": sum(e.get("dur", 0) for e in dev
                          if "DtoH" in e.get("name", "")) / 1e3,
            "h2d_ms": sum(e.get("dur", 0) for e in dev
                          if "HtoD" in e.get("name", "")) / 1e3,
            "device_events": len(dev)}


def run(sf: float, device, positions: int = POSITIONS,
        chunk_rows: int = CHUNK_ROWS, queries=QUERIES,
        card: str = "") -> dict:
    """Every part of the module's docstring; returns the records."""
    from ..parallel.fabric import FABRIC_METRICS
    ici, http = runners(sf, device, positions, chunk_rows)
    schema = f"sf{sf:g}"
    # the first execution of each runner pays one-time set-up (the first
    # calls of the exchange's torch ops): one warm-up Q1 under each
    warm_sql = sqls(sf)["q1"][0]
    t0 = time.perf_counter()
    for runner in (ici, http):
        _timed(runner, warm_sql, device)
    walls = {"warm_up": time.perf_counter() - t0}
    out: Dict[str, dict] = {"queries": {}, "walls": walls}
    launches = {"ici": dict.fromkeys(KERNELS, 0),
                "http": dict.fromkeys(KERNELS, 0)}
    for name in queries:
        t0 = time.perf_counter()
        sql, ordered = sqls(sf)[name]
        rec = {}
        for fabric, runner in (("ici", ici), ("http", http)):
            before = _launches()
            f0 = FABRIC_METRICS.snapshot()["ici"]
            res, wall = _timed(runner, sql, device)
            f1 = FABRIC_METRICS.snapshot()["ici"]
            for k, v in _launches().items():
                launches[fabric][k] += v - before[k]
            rec[fabric] = {"res": res, "wall_s": wall,
                           "ici_exchanges": f1["exchanges"]
                           - f0["exchanges"],
                           "ici_fallbacks": f1["fallbacks"]
                           - f0["fallbacks"],
                           "ici_bytes": _stat(res, "exchangeFabricIciBytes"),
                           "ici_chunks": _stat(res,
                                               "exchangeFabricIciChunks"),
                           "http_bytes": _stat(res,
                                               "exchangeFabricHttpBytes"),
                           "drain_ms": _stat(
                               res, "exchangeFabricIciDrainWallNanos") / 1e6,
                           "wait_ms": _stat(
                               res, "exchangeFabricIciWaitWallNanos") / 1e6,
                           "rows": len(res.rows)}
        _assert_equal(rec["ici"]["res"], rec["http"]["res"], ordered)
        i, h = rec["ici"], rec["http"]
        # the reference's test_ici_path_engaged, as a count
        assert i["ici_exchanges"] >= 1 and i["ici_bytes"] > 0, (name, i)
        assert i["ici_fallbacks"] == 0, (name, i)
        assert h["ici_exchanges"] == 0 and h["http_bytes"] > 0, (name, h)
        for r in (i, h):
            del r["res"]
        out["queries"][name] = rec
        print(f"  {schema} {name} over {positions} positions: ici "
              f"{i['wall_s'] * 1e3:.3f} ms ({i['ici_exchanges']} "
              f"exchanges, {int(i['ici_bytes'])} B in "
              f"{int(i['ici_chunks'])} chunks, drain {i['drain_ms']:.3f} "
              f"ms, wait {i['wait_ms']:.3f} ms, fallbacks "
              f"{i['ici_fallbacks']}) against http "
              f"{h['wall_s'] * 1e3:.3f} ms ({int(h['http_bytes'])} B of "
              f"pages); {i['rows']} rows equal {card}", flush=True)
        walls[name] = time.perf_counter() - t0
    fab = FABRIC_METRICS.snapshot()["ici"]
    out["fabric_ici"] = fab
    out["launches"] = launches
    print(f"  ici fabric totals: {fab['exchanges']} exchanges, "
          f"{fab['chunks']} chunks, {fab['bytes_moved']} B, host bytes "
          f"{fab['host_bytes']}, exchange wall "
          f"{fab['exchange_wall_s']:.3f} s, overlap fraction "
          f"{fab['overlap_fraction']:.4f}, fallbacks {fab['fallbacks']} "
          f"{card}", flush=True)
    print(f"  launches by fabric {launches} {card}", flush=True)
    assert fab["host_bytes"] == 0 and fab["fallbacks"] == 0, fab
    if device.type == "cuda":
        # Q1's source stages run #1, W1's hash stage #6, through ici
        assert launches["ici"]["scan_direct"] > 0, launches
        assert launches["ici"]["window_scan"] > 0, launches
    if "q3" in queries:
        out["trace_q3"] = {}
        for fabric, runner in (("ici", ici), ("http", http)):
            t0 = time.perf_counter()
            t = out["trace_q3"][fabric] = trace(runner, sqls(sf)["q3"][0],
                                                device)
            walls[f"trace_{fabric}"] = time.perf_counter() - t0
            print(f"  {schema} Q3 over {positions} positions through "
                  f"{fabric} under torch.profiler: wall {t['wall_ms']:.3f} "
                  f"ms, device busy {t['busy_ms']:.3f} ms, idle "
                  f"{t['idle_share']:.4f}, DtoH {t['d2h_ms']:.3f} ms, HtoD "
                  f"{t['h2d_ms']:.3f} ms, {t['device_events']} device "
                  f"events; the profiler's own {t['profiler_s']:.3f} s "
                  f"{card}", flush=True)
    print(f"  part walls (s, each query's two runs and their check) "
          f"{ {k: round(v, 3) for k, v in walls.items()} } {card}",
          flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sf", default="10")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--positions", type=int, default=POSITIONS)
    ap.add_argument("--chunk-rows", type=int, default=CHUNK_ROWS,
                    help="exchange.ici-chunk-rows (0: the tuner)")
    ap.add_argument("--queries", default=",".join(QUERIES))
    args = ap.parse_args()
    from ..exec.runner import resolve_device
    device = resolve_device(args.device)
    if device.type == "cuda":
        from ..exec.kernels import build
        build.build_all()
    recs = run(float(args.sf), device, args.positions, args.chunk_rows,
               tuple(q for q in args.queries.split(",") if q))
    print(json.dumps(recs, default=str))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
