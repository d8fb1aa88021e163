"""TPC-H through the distributed runner: stages of tasks on one device.

    python -m presto_tpu_torch.benchmarks.distributed_run --sf 10
        [--queries 1,3,18] [--tasks 2] [--device cuda] [--no-golden]

Runs, through DistributedQueryRunner (exec/scheduler.py, every task on
the one device):
  * Q1-Q22 at sf0.01 (2 tasks, broadcast joins) against the JAX
    package's golden rows, every query the reference's distributed
    runner answers (RECORDED: all but Q21, where its rows differ from the
    golden ones with broadcast joins), and Q21 through partitioned joins
    (3 tasks, broadcast_threshold=0);
  * at the scale factor, each query of RECORDED (2 tasks, the default
    broadcast threshold of 600,000 rows) cold and once warm: its rows
    equal to the
    single-task LocalQueryRunner rows (exact; doubles at rtol 1e-9), the
    local warm wall beside its walls, the stage count, each stage's task
    and stage walls, the exchange's host bytes and split wall
    (exchangeFabricHttpBytes / ...ExchangeWallNanos), the dynamic filters
    collected, the adaptive flips and swaps, the kernel launches of the
    warm run (deltas of the LAUNCHES dicts) and its peak device memory;
    the direct scan kernel (#1) must launch in Q1's and Q6's source
    stages.  Q21 runs only when asked for (--queries 21): whether its
    rows equal the local ones is recorded, not held;
  * Q3 and Q18 partitioned (3 tasks, broadcast_threshold=0), equal to the
    local rows;
  * W1 distributed: the window kernel (#6) launches in the hash stage
    over the exchange's input; rows equal to the local W1;
  * batch mode (BatchQueryRunner, 2 tasks, 2 retries) on Q1 and Q3: a
    fault injector fails task 0 of the first source stage on attempt 0;
    the injector sees attempt 1 of that task exactly once and the rows
    equal the local ones;
  * lifespan sharding: the reference test's Q18 shape with 4 forced
    lifespans over 2 tasks (orders broadcast, SHARD_BROADCAST) runs
    shards (0, 2) and (1, 2), two lifespans each, rows equal to the
    unforced local run;
  * one torch.profiler capture of distributed Q3: the device's busy time
    and idle share of the wall, and the device-to-host and host-to-device
    copy ms of its exchanges.
chip_smoke.py runs `run_all` as its distributed phase (after the TPC-H
phase, whose local rows and walls it passes in).  Any failed check
raises.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, Optional

import torch

from .rows import assert_rows_close, golden_result
from .scale_run import Q18_SHAPE
from .tpch_queries import ALL, ORDERED, queries_for_sf
from .window_queries import W1

GOLDEN_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tpch_sf001_rows.json")
RTOL = 1e-9
TASKS = 2
# the TPC-H queries the reference's DistributedQueryRunner("sf0.01",
# n_tasks=2) answers with the golden rows: all but Q21 (ROADMAP
# section 3)
RECORDED = tuple(q for q in sorted(ALL) if q != 21)
# the chip script's recorded subset at the scale factor (its time
# limit): Q1 and Q6, whose source stages launch the direct kernel, the
# queries whose hash edges carry small or aggregated inputs, and Q13
# (orders repartitioned by custkey through host pages)
SMOKE_QUERIES = (1, 2, 6, 11, 13, 15, 16, 22)
PARTITIONED = (3, 18)
PARTITIONED_TASKS = 3
BATCH_QUERIES = (1, 3)
SHARD_LIFESPANS = 4
# the sharded run's broadcast threshold: over SF10's 15 M orders, so the
# Q18 shape's orders join is broadcast and its PARTIAL aggregation stays
# in the lineitem source stage, where lifespans shard (a partitioned
# join moves the aggregation to a hash stage, which does not)
SHARD_BROADCAST = 1 << 25
# the RuntimeStats of one distributed run that the records keep
STATS = ("exchangeFabricHttpBytes", "exchangeFabricHttpExchangeWallNanos",
         "dynamicFiltersCollected", "adaptiveExchangeFlips",
         "adaptiveSideSwaps")


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)  # lint: allow-host-sync


def _wall(runner, sql, device):
    _sync(device)
    t0 = time.perf_counter()
    res = runner.execute(sql)
    _sync(device)
    return res, time.perf_counter() - t0


def _launches() -> Dict[str, int]:
    from ..exec.kernels import scan_kernel as sk
    out = dict(sk.LAUNCHES)
    out.update({"join_" + k: v for k, v in sk.JOIN_LAUNCHES.items()})
    return out


def _delta(before: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before[k] for k, v in _launches().items()
            if v != before[k]}


def _peak_reset(device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _peak(device) -> int:
    return (int(torch.cuda.max_memory_allocated(device))
            if device.type == "cuda" else 0)


def _stat(res, key: str) -> float:
    return float((res.runtime_stats or {}).get(key, {}).get("sum", 0))


def stages(runner) -> list:
    """The last execution's stages: fragment, partitioning, task count,
    task walls and stage wall (seconds)."""
    return [{"fragment": s.fragment.fragment_id,
             "partitioning": s.fragment.partitioning,
             "tasks": s.n_tasks, "task_walls": s.task_walls,
             "stage_wall": s.stage_wall}
            for s in runner.last_scheduler.stages()]


def record(res, runner) -> dict:
    """The distributed run's numbers every record keeps."""
    return {"rows": len(res.rows), "stages": stages(runner),
            **{k: _stat(res, k) for k in STATS}}


def check_golden(device, card: str = "") -> int:
    """TPC-H at sf0.01 through the distributed runner against the golden
    rows: RECORDED with broadcast joins, Q21 partitioned."""
    from ..exec.runner import DistributedQueryRunner
    with open(GOLDEN_PATH) as f:
        doc = json.load(f)
    bcast = DistributedQueryRunner(doc["schema"], n_tasks=TASKS,
                                   device=device)
    part = DistributedQueryRunner(doc["schema"], n_tasks=PARTITIONED_TASKS,
                                  broadcast_threshold=0, device=device)
    ordered = set(doc["ordered"])
    for q in sorted(ALL):
        ent = doc["queries"][str(q)]
        res = (bcast if q in RECORDED else part).execute(ALL[q])
        assert list(res.column_names) == ent["columns"], q
        assert_rows_close(res, golden_result(ent), ordered=q in ordered,
                          rtol=RTOL)
    print(f"  sf0.01 distributed: Q{','.join(map(str, RECORDED))} "
          f"({TASKS} tasks) and Q21 (partitioned, {PARTITIONED_TASKS} "
          f"tasks) == the JAX package's golden rows {card}", flush=True)
    return len(ALL)


def local_results(sf: float, device, queries) -> dict:
    """Each query's rows and warm wall through LocalQueryRunner (one cold
    and one warm run), for a call that has not run the TPC-H phase."""
    from ..exec.runner import LocalQueryRunner
    runner = LocalQueryRunner(f"sf{sf:g}", device=device)
    qs = queries_for_sf(sf)
    out = {"results": {}}
    for q in queries:
        _wall(runner, qs[q], device)
        res, wall = _wall(runner, qs[q], device)
        out["results"][q] = res
        out[f"q{q}"] = {"warm_ms": wall * 1e3}
    return out


def run_tpch(sf: float, device, local: dict, queries, tasks: int = TASKS,
             card: str = "") -> dict:
    """Each query cold and once warm through one DistributedQueryRunner,
    held to the local rows (every query on RECORDED; Q21's equality is
    recorded)."""
    from ..exec.runner import DistributedQueryRunner
    schema = f"sf{sf:g}"
    runner = DistributedQueryRunner(schema, n_tasks=tasks, device=device)
    qs = queries_for_sf(sf)
    out = {}
    for q in queries:
        want = local["results"][q]
        first, cold = _wall(runner, qs[q], device)
        before = _launches()
        _peak_reset(device)
        res, warm = _wall(runner, qs[q], device)
        peak = _peak(device)
        launched = _delta(before)
        rec = out[f"q{q}"] = {
            "cold_s": cold, "warm_ms": warm * 1e3,
            "local_warm_ms": local.get(f"q{q}", {}).get("warm_ms"),
            "launched": launched, "peak_bytes": peak,
            **record(res, runner)}
        if q in RECORDED:
            assert_rows_close(first, want, ordered=q in ORDERED, rtol=RTOL)
            assert_rows_close(res, want, ordered=q in ORDERED, rtol=RTOL)
        else:
            try:
                assert_rows_close(res, want, ordered=q in ORDERED,
                                  rtol=RTOL)
                rec["equal_to_local"] = True
            except AssertionError:
                rec["equal_to_local"] = False
        if q in (1, 6):
            # kernel #1 in each source task's PARTIAL aggregation (the
            # plain versions on the CPU count programs, not launches)
            assert _stat(res, "kernelScanPrograms") >= tasks, q
            if device.type == "cuda":
                assert launched.get("scan_direct", 0) >= tasks, \
                    (q, launched)
        local_ms = rec["local_warm_ms"]
        print(f"  {schema} Q{q} distributed ({tasks} tasks): "
              f"{rec['rows']} rows"
              + (" == local" if q in RECORDED
                 else f", equal to local: {rec['equal_to_local']} (not on "
                      f"the reference's list)")
              + f"; cold {cold:.3f} s, warm {warm * 1e3:.3f} ms, local "
              f"warm {'%.3f' % local_ms if local_ms is not None else '-'} "
              f"ms; {len(rec['stages'])} stages, task walls "
              f"{[s['task_walls'] for s in rec['stages']]}, stage walls "
              f"{[s['stage_wall'] for s in rec['stages']]}; http "
              f"{rec['exchangeFabricHttpBytes']:.0f} B in "
              f"{rec['exchangeFabricHttpExchangeWallNanos'] / 1e6:.3f} ms; "
              f"dynamic filters {rec['dynamicFiltersCollected']:.0f}, flips "
              f"{rec['adaptiveExchangeFlips']:.0f}, swaps "
              f"{rec['adaptiveSideSwaps']:.0f}; launched {launched}; peak "
              f"{peak} B {card}", flush=True)
    return out


def run_partitioned(sf: float, device, local: dict, card: str = "") -> dict:
    """Q3 and Q18 with hash-partitioned joins over PARTITIONED_TASKS."""
    from ..exec.runner import DistributedQueryRunner
    schema = f"sf{sf:g}"
    runner = DistributedQueryRunner(schema, n_tasks=PARTITIONED_TASKS,
                                    broadcast_threshold=0, device=device)
    qs = queries_for_sf(sf)
    out = {}
    for q in PARTITIONED:
        res, wall = _wall(runner, qs[q], device)
        assert_rows_close(res, local["results"][q], ordered=q in ORDERED,
                          rtol=RTOL)
        rec = out[f"q{q}"] = {"wall_s": wall, **record(res, runner)}
        print(f"  {schema} Q{q} partitioned ({PARTITIONED_TASKS} tasks, "
              f"broadcast_threshold=0): == local; {wall:.3f} s, "
              f"{len(rec['stages'])} stages, http "
              f"{rec['exchangeFabricHttpBytes']:.0f} B, flips "
              f"{rec['adaptiveExchangeFlips']:.0f}, swaps "
              f"{rec['adaptiveSideSwaps']:.0f} {card}", flush=True)
    return out


def run_window(sf: float, device, card: str = "") -> dict:
    """W1 through the distributed runner: the window kernel launches in
    the hash stage that reads the exchange."""
    from ..exec.runner import DistributedQueryRunner, LocalQueryRunner
    from ..spi import plan as P
    schema = f"sf{sf:g}"
    want, local_wall = _wall(LocalQueryRunner(schema, device=device), W1,
                             device)
    runner = DistributedQueryRunner(schema, n_tasks=TASKS, device=device)
    before = _launches()
    res, wall = _wall(runner, W1, device)
    launched = _delta(before)
    assert_rows_close(res, want, ordered=True, rtol=RTOL)
    window_stages = [
        s for s in runner.last_scheduler.stages()
        if any(isinstance(n, P.WindowNode) for n in P.walk_plan(s.fragment.root))]
    assert [s.fragment.partitioning for s in window_stages] == \
        [P.FIXED_HASH_DISTRIBUTION], window_stages
    assert any(isinstance(n, P.RemoteSourceNode)
               for n in P.walk_plan(window_stages[0].fragment.root))
    if device.type == "cuda":
        assert launched.get("window_scan", 0) >= TASKS, launched
    assert not [k for k in (res.runtime_stats or {})
                if k.startswith("kernelDeclinedWindow")], res.runtime_stats
    rec = {"wall_s": wall, "local_wall_s": local_wall,
           "launched": launched, **record(res, runner)}
    print(f"  {schema} W1 distributed ({TASKS} tasks): == local; "
          f"{wall:.3f} s against {local_wall:.3f} s local; the window in "
          f"hash stage {window_stages[0].fragment.fragment_id} over the "
          f"exchange; launched {launched} {card}", flush=True)
    return rec


def run_batch(sf: float, device, local: dict, card: str = "",
              queries=BATCH_QUERIES) -> dict:
    """Batch mode with one injected task failure per query."""
    from ..common.errors import InjectedTaskFailure
    from ..exec.runner import BatchQueryRunner
    from ..spi import plan as P
    schema = f"sf{sf:g}"
    qs = queries_for_sf(sf)
    out = {}
    for q in queries:
        calls = []
        target = {}

        def inject(fragment_id, task_index, attempt):
            calls.append((fragment_id, task_index, attempt))
            if fragment_id in source and "fid" not in target:
                target["fid"] = fragment_id
            if fragment_id == target.get("fid") and task_index == 0 \
                    and attempt == 0:
                raise InjectedTaskFailure(
                    f"injected loss of task {fragment_id}.0")

        runner = BatchQueryRunner(schema, n_tasks=TASKS, task_retries=2,
                                  fault_injector=inject, device=device)
        source = {f.fragment_id for f in
                  runner.plan_subplan(qs[q])[0].all_fragments()
                  if f.partitioning == P.SOURCE_DISTRIBUTION}
        res, wall = _wall(runner, qs[q], device)
        assert_rows_close(res, local["results"][q], ordered=q in ORDERED,
                          rtol=RTOL)
        fid = target["fid"]
        assert calls.count((fid, 0, 1)) == 1, calls
        assert calls.count((fid, 0, 0)) == 1, calls
        out[f"q{q}"] = {"wall_s": wall, "failed_task": f"{fid}.0",
                        "attempts": len(calls), **record(res, runner)}
        print(f"  {schema} Q{q} batch mode ({TASKS} tasks, 2 retries): task "
              f"{fid}.0 failed on attempt 0, attempt 1 ran once; == local; "
              f"{wall:.3f} s {card}", flush=True)
    return out


def run_sharded(sf: float, device, card: str = "") -> dict:
    """The Q18 shape with SHARD_LIFESPANS forced lifespans over TASKS
    tasks: each task runs its shard of the bucket layout."""
    from ..exec.pipeline import tuned_config
    from ..exec.runner import DistributedQueryRunner, LocalQueryRunner
    schema = f"sf{sf:g}"
    want, local_wall = _wall(LocalQueryRunner(schema, device=device),
                             Q18_SHAPE, device)
    runner = DistributedQueryRunner(
        schema, n_tasks=TASKS, broadcast_threshold=SHARD_BROADCAST,
        device=device,
        config=tuned_config(grouped_lifespans=SHARD_LIFESPANS))
    res, wall = _wall(runner, Q18_SHAPE, device)
    assert_rows_close(res, want, ordered=True, rtol=RTOL)
    shards = [s.task_shards for s in runner.last_scheduler.stages()
              if s.task_shards[0] is not None]
    assert shards == [[(i, TASKS) for i in range(TASKS)]], shards
    ran = {i: _stat(res, f"groupedShard{i}of{TASKS}Lifespans")
           for i in range(TASKS)}
    assert ran == {i: SHARD_LIFESPANS // TASKS for i in range(TASKS)}, ran
    rec = {"wall_s": wall, "local_wall_s": local_wall, "shards": shards[0],
           "lifespans_per_shard": ran, **record(res, runner)}
    print(f"  {schema} Q18 shape, {SHARD_LIFESPANS} lifespans over {TASKS} "
          f"tasks: shards {shards[0]} ran {ran} lifespans; == local "
          f"(unforced); {wall:.3f} s against {local_wall:.3f} s local "
          f"{card}", flush=True)
    return rec


def trace_q3(sf: float, device, card: str = "") -> dict:
    """One warm run of distributed Q3 under torch.profiler: the wall, the
    device's busy time (its kernel, copy and memset events) and idle
    share, and the device-to-host / host-to-device copy ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from ..exec.runner import DistributedQueryRunner
    schema = f"sf{sf:g}"
    sql = queries_for_sf(sf)[3]
    runner = DistributedQueryRunner(schema, n_tasks=TASKS, device=device)
    _wall(runner, sql, device)
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        _res, wall = _wall(runner, sql, device)
    dev = [(e.self_device_time_total, e.count, e.key)
           for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(t for t, _c, _k in dev) / 1e3
    d2h = sum(t for t, _c, k in dev if "DtoH" in k) / 1e3
    h2d = sum(t for t, _c, k in dev if "HtoD" in k) / 1e3
    rec = {"wall_ms": wall * 1e3, "busy_ms": busy,
           "idle_share": 1 - busy / (wall * 1e3), "d2h_ms": d2h,
           "h2d_ms": h2d, "device_events": sum(c for _t, c, _k in dev),
           "top": sorted(dev, reverse=True)[:6]}
    print(f"  {schema} Q3 distributed under torch.profiler: wall "
          f"{rec['wall_ms']:.3f} ms, device busy {busy:.3f} ms, idle "
          f"{rec['idle_share']:.4f}, DtoH {d2h:.3f} ms, HtoD {h2d:.3f} ms, "
          f"{rec['device_events']} device events {card}", flush=True)
    return rec


def run_all(sf: float, device, local: Optional[dict] = None,
            queries=None, tasks: int = TASKS, golden: bool = True,
            card: str = "", partitioned: bool = True,
            batch_queries=BATCH_QUERIES, trace: bool = True) -> dict:
    """Every part of the module's docstring; returns the records.
    chip_smoke.py leaves out the partitioned runs and the trace (its mesh
    phase runs Q3 and Q18 over hashed page exchanges and traces Q3 there)
    and runs batch mode on Q1 alone: the script's time limit."""
    queries = sorted(queries or RECORDED)
    if local is None:
        need = sorted(set(queries) | set(PARTITIONED) | set(BATCH_QUERIES))
        local = local_results(sf, device, need)
    out: Dict[str, dict] = {}
    if golden:
        out["golden"] = {"queries": check_golden(device, card)}
    out["tpch"] = run_tpch(sf, device, local, queries, tasks, card)
    if partitioned:
        out["partitioned"] = run_partitioned(sf, device, local, card)
    out["window"] = run_window(sf, device, card)
    out["batch"] = run_batch(sf, device, local, card, batch_queries)
    out["sharded"] = run_sharded(sf, device, card)
    if trace:
        out["trace_q3"] = trace_q3(sf, device, card)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sf", default="10")
    ap.add_argument("--queries", default="",
                    help="comma-separated TPC-H query numbers (RECORDED)")
    ap.add_argument("--tasks", type=int, default=TASKS)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--no-golden", action="store_true")
    args = ap.parse_args()
    from ..exec.runner import resolve_device
    device = resolve_device(args.device)
    if device.type == "cuda":
        # nvcc the hash and window kernels first, so no query's cold wall
        # holds their build (chip_smoke.py builds them before its phases)
        from ..exec.kernels import build
        build.build_all()
    queries = [int(q) for q in args.queries.split(",") if q]
    recs = run_all(float(args.sf), device, queries=queries or None,
                   tasks=args.tasks, golden=not args.no_golden)
    print(json.dumps({k: v for k, v in recs.items() if k != "trace_q3"},
                     default=str))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
