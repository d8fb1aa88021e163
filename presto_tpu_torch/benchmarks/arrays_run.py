"""ARRAY columns, UNNEST and EXPLAIN ANALYZE on a device.

    python -m presto_tpu_torch.benchmarks.arrays_run --sf 10
        [--runs 3] [--device cuda] [--profile-dir build/profiles]

Runs, through the port's runners (every failure raises):
  * U1, U2, U4 (benchmarks/array_queries.py) at the scale factor: the cold
    wall, the median of `runs` warm walls, the scan and window kernels'
    launches, and the rows equal to their array-free twins' run in the
    same process; U4 prints the kernelDeclined{reason} it meters;
  * U3, the window over unnested rows: the window kernel launches, the
    rows equal the same query under scan_kernel="xla" and its twin's;
  * U1 through DistributedQueryRunner with 2 tasks, equal to the local
    rows, and X1, whose ARRAY column crosses the gather exchange (a
    RemoteSource's output), equal to the local rows;
  * EXPLAIN ANALYZE of Q6 and Q1 under "auto" (the direct kernel
    launches) and "xla": last_operator_stats rows equal node for node,
    the scan node's rows beside lineitem's row count, the footer's
    "CUDA scan kernels: 1" and the Disabled decline;
  * EXPLAIN ANALYZE of Q18 (the torch chain) at the scale factor, both
    runners' first hash table sized by q18_slots so that no collision
    retry runs: per-node rows of the fused path equal to
    analyze_unfused=True's, the per-node host walls printed.  Then Q18 at
    Q18_RETRY_SF from the default table, where the unfused streaming
    aggregation retries: the fused rows equal the retry-free ones, and
    each unfused node's rows are those rows times 1 or times the passes
    (the retried aggregation's input, re-read and counted on every pass;
    ROADMAP section 3);
  * EXPLAIN ANALYZE of W1: "CUDA window kernels: 1";
  * distributed EXPLAIN ANALYZE of Q1 with 2 tasks: every fragment
    carries rows and walls;
  * EXPLAIN ANALYZE of Q6 with profile=True: the footer names a directory
    holding the torch.profiler trace.
Each ANALYZE wall is printed beside the plain query's warm wall.
chip_smoke.py runs `run` as its arrays phase.
"""
from __future__ import annotations

import argparse
import os
import re
import time
from typing import Dict

import numpy as np

from . import array_queries as AQ
from .rows import assert_rows_close
from .tpch_queries import Q1, Q6, Q18
from .tpch_run import _sync, _wall, modes
from .window_queries import W1

RTOL = 1e-12
# where Q18's unfused streaming aggregation retries from the default table
# (its first table is 2^20 slots, the estimate's clamp) and still ends:
# at SF10 its 15 M orderkeys run out of retries
Q18_RETRY_SF = 1


def q18_slots(sf: float) -> int:
    """A first hash table for Q18's aggregations that no retry follows:
    the power of two at or above 4 slots per orderkey."""
    from ..connectors import catalog
    return 1 << (4 * catalog.table_row_count("orders", sf) - 1).bit_length()


def _launches() -> Dict[str, int]:
    from ..exec.kernels import scan_kernel as sk
    return {k: sk.LAUNCHES[k] for k in sk.SCAN_KERNELS + ("window_scan",)}


def _delta(before: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before[k] for k, v in _launches().items()
            if v != before[k]}


def _check_rows(got, want, ordered: bool) -> None:
    """got's rows equal want's: compared as whole lists first (U1's 1 M
    rows in C, not a Python comparison per value), else value by value
    within RTOL."""
    try:
        if (got.rows == want.rows if ordered
                else sorted(got.rows) == sorted(want.rows)):
            return
    except TypeError:           # NULLs beside values do not sort
        pass
    assert_rows_close(got, want, ordered=ordered, rtol=RTOL)


def _timed(runner, sql, runs, device):
    """(first result, cold s, median warm ms, launches of the cold run)."""
    before = _launches()
    first, cold = _wall(runner, sql, device)
    launched = _delta(before)
    walls = []
    for _ in range(runs):
        res, w = _wall(runner, sql, device)
        walls.append(w)
        _check_rows(res, first, ordered=True)
    return first, cold, float(np.median(walls)) * 1e3, launched


def run_arrays(sf: float, runs: int, device, card: str = "") -> dict:
    from ..exec.pipeline import tuned_config
    from ..exec.runner import DistributedQueryRunner, LocalQueryRunner
    schema = f"sf{sf:g}"
    auto = LocalQueryRunner(schema, device=device)
    out: Dict[str, dict] = {}
    local: Dict[str, object] = {}
    for name in ("U1", "U2", "U4", "U3"):
        sql = AQ.QUERIES[name]
        res, cold, warm, launched = _timed(auto, sql, runs, device)
        local[name] = res
        _sync(device)
        t0 = time.perf_counter()
        twin_rows = AQ.run_twin(auto, name)
        _sync(device)
        twin_cold = time.perf_counter() - t0
        AQ.check_twin(name, res.rows, twin_rows)
        rec = out[name] = {"rows": len(res.rows), "cold_s": cold,
                           "warm_ms": warm, "twin_s": twin_cold,
                           "launched": launched, **modes(res)}
        if name == "U4":
            assert rec["declined"].get("PlanShape"), rec
        if name == "U3":
            # the plain versions (CPU tensors) count no launch
            assert device.type != "cuda" \
                or launched.get("window_scan", 0) >= 1, launched
            xla = LocalQueryRunner(schema, device=device,
                                   config=tuned_config(scan_kernel="xla"))
            xres, xwall = _wall(xla, sql, device)
            assert xres.rows == res.rows
            rec["xla_ms"] = xwall * 1e3
        print(f"  {schema} {name}: {rec['rows']} rows, cold {cold:.3f} s, "
              f"warm median {warm:.3f} ms ({runs} runs), == twin (twin "
              f"cold {twin_cold:.3f} s), launched {launched}, chain "
              f"{rec['chain']}, streaming {rec['streaming']}, declined "
              f"{rec['declined']}"
              + (f", xla {rec['xla_ms']:.3f} ms == auto"
                 if "xla_ms" in rec else "") + f" {card}", flush=True)
    dist = DistributedQueryRunner(schema, n_tasks=2, device=device)
    res, wall = _wall(dist, AQ.QUERIES["U1"], device)
    _check_rows(res, local["U1"], ordered=False)
    out["U1_distributed"] = {"wall_s": wall, "rows": len(res.rows)}
    subplan, _n, _t = dist.plan_subplan(AQ.QUERIES["X1"])
    crossing = AQ.exchanged_arrays(subplan)
    assert crossing, "X1's array column does not cross an exchange"
    res, wall = _wall(dist, AQ.QUERIES["X1"], device)
    _check_rows(res, auto.execute(AQ.QUERIES["X1"]), ordered=False)
    out["X1_distributed"] = {"wall_s": wall, "rows": len(res.rows),
                             "exchanged": crossing}
    print(f"  {schema} U1 with 2 tasks: {out['U1_distributed']['rows']} "
          f"rows == local, {out['U1_distributed']['wall_s']:.3f} s; X1: "
          f"{len(res.rows)} rows == local, {wall:.3f} s, ARRAY columns "
          f"read from an exchange {crossing} {card}", flush=True)
    return out


def _analyze(runner, sql, device):
    """(plan text, per-node stats, wall s) of one EXPLAIN ANALYZE."""
    res, wall = _wall(runner, "EXPLAIN ANALYZE " + sql, device)
    return res.rows[0][0], runner.last_operator_stats, wall


def _node_rows(stats) -> Dict[str, int]:
    return {nid: s["rows"] for nid, s in stats.items()}


def run_analyze(sf: float, runs: int, device, card: str = "",
                profile_dir: str = "build/profiles",
                unfused_q18: bool = True) -> dict:
    from ..connectors import catalog
    from ..exec.pipeline import tuned_config
    from ..exec.runner import DistributedQueryRunner, LocalQueryRunner
    schema = f"sf{sf:g}"
    auto = LocalQueryRunner(schema, device=device)
    xla = LocalQueryRunner(schema, device=device,
                           config=tuned_config(scan_kernel="xla"))
    out: Dict[str, dict] = {}
    n_lineitem = catalog.table_row_count("lineitem", sf)
    for name, sql in (("q6", Q6), ("q1", Q1)):
        _first, _cold, plain_ms, _l = _timed(auto, sql, runs, device)
        before = _launches()
        text, stats, wall = _analyze(auto, sql, device)
        launched = _delta(before)
        xtext, xstats, xwall = _analyze(xla, sql, device)
        assert device.type != "cuda" \
            or launched.get("scan_direct", 0) >= 1, launched
        assert "CUDA scan kernels: 1" in text, text
        assert "Disabled" in xtext and "CUDA scan kernels" not in xtext
        assert _node_rows(stats) == _node_rows(xstats), (stats, xstats)
        scan = [s["rows"] for nid, s in stats.items()
                if nid.startswith("scan")]
        out[name] = {"analyze_ms": wall * 1e3, "xla_analyze_ms": xwall * 1e3,
                     "plain_warm_ms": plain_ms, "launched": launched,
                     "scan_rows": scan, "lineitem_rows": n_lineitem,
                     "nodes": _node_rows(stats)}
        print(f"  {schema} EXPLAIN ANALYZE {name}: auto {wall * 1e3:.3f} ms "
              f"(kernel launches {launched}), xla {xwall * 1e3:.3f} ms, "
              f"plain warm {plain_ms:.3f} ms; per-node rows auto == xla "
              f"{out[name]['nodes']}; scan rows {scan} of lineitem's "
              f"{n_lineitem} {card}", flush=True)

    # both runners from a table that no collision retry follows: a retry
    # re-reads the aggregation's input, and the unfused path counts every
    # pass (checked below)
    slots = q18_slots(sf)
    fused = LocalQueryRunner(schema, device=device,
                             config=tuned_config(agg_slots=slots))
    unfused = LocalQueryRunner(schema, device=device, config=tuned_config(
        agg_slots=slots, analyze_unfused=True))
    _f, _c, plain_ms, _l = _timed(fused, Q18, 1, device)
    text, stats, wall = _analyze(fused, Q18, device)
    assert "[fused]" in text
    out["q18"] = {"agg_slots": slots, "analyze_ms": wall * 1e3,
                  "plain_warm_ms": plain_ms,
                  "walls_ms": {n: round(s["wall_s"] * 1e3, 3)
                               for n, s in stats.items()}}
    unfused_note = "not run (the unfused rows are held at Q18_RETRY_SF)"
    if unfused_q18:
        utext, ustats, uwall = _analyze(unfused, Q18, device)
        assert "AnalyzeUnfused" in utext
        shared = set(stats) & set(ustats)
        assert shared
        differ = {n: (stats[n]["rows"], ustats[n]["rows"]) for n in shared
                  if stats[n]["rows"] != ustats[n]["rows"]}
        assert not differ, (differ, text, utext)
        out["q18"].update(
            unfused_analyze_ms=uwall * 1e3,
            unfused_walls_ms={n: round(s["wall_s"] * 1e3, 3)
                              for n, s in ustats.items()})
        unfused_note = (f"{uwall * 1e3:.3f} ms, {len(shared)} shared "
                        f"nodes' rows equal; host walls (ms) unfused "
                        f"{out['q18']['unfused_walls_ms']}")
    print(f"  {schema} EXPLAIN ANALYZE q18 (agg_slots {slots}): fused "
          f"{wall * 1e3:.3f} ms, plain warm {plain_ms:.3f} ms, host walls "
          f"(ms) fused {out['q18']['walls_ms']}; unfused {unfused_note} "
          f"{card}", flush=True)
    out["q18_retry"] = _q18_retry(device, card)

    _f, _c, plain_ms, _l = _timed(auto, W1, runs, device)
    before = _launches()
    text, _stats, wall = _analyze(auto, W1, device)
    launched = _delta(before)
    assert "CUDA window kernels: 1" in text, text
    out["w1"] = {"analyze_ms": wall * 1e3, "plain_warm_ms": plain_ms,
                 "launched": launched}
    print(f"  {schema} EXPLAIN ANALYZE w1: {wall * 1e3:.3f} ms, plain warm "
          f"{plain_ms:.3f} ms, launched {launched} {card}", flush=True)

    dist = DistributedQueryRunner(schema, n_tasks=2, device=device)
    _r, dplain = _wall(dist, Q1, device)
    text, _stats, wall = _analyze(dist, Q1, device)
    fragments = re.split(r"(?m)^Fragment ", text)[1:]
    assert len(fragments) >= 2
    for frag in fragments:
        assert "rows:" in frag and "wall:" in frag, frag
    out["q1_distributed"] = {"analyze_ms": wall * 1e3,
                             "plain_ms": dplain * 1e3,
                             "fragments": len(fragments)}
    print(f"  {schema} distributed EXPLAIN ANALYZE q1 (2 tasks): "
          f"{wall * 1e3:.3f} ms over {len(fragments)} fragments, each with "
          f"rows and walls; plain {dplain * 1e3:.3f} ms {card}", flush=True)

    from ..telemetry.profiler import TRACE_FILE
    prof = LocalQueryRunner(schema, device=device, config=tuned_config(
        profile=True, profile_dir=os.path.abspath(profile_dir)))
    text, _stats, wall = _analyze(prof, Q6, device)
    line = next(ln for ln in text.splitlines()
                if ln.startswith("Device profile: "))
    trace = os.path.join(line[len("Device profile: "):], TRACE_FILE)
    size = os.path.getsize(trace)
    assert size > 0, trace
    out["q6_profile"] = {"analyze_ms": wall * 1e3, "trace": trace,
                         "trace_bytes": size}
    print(f"  {schema} EXPLAIN ANALYZE q6 with profile=true: "
          f"{wall * 1e3:.3f} ms, trace {trace} ({size} B) {card}",
          flush=True)
    return out


def _q18_retry(device, card: str) -> dict:
    """Q18 under ANALYZE at Q18_RETRY_SF from the default table, against
    the retry-free table's rows: the fused rows equal them (the fused
    pass keeps its last pass's counters), and every unfused node's rows
    are them times 1 or times one count of passes, at least 2 (the
    retried aggregation's input, counted on every pass)."""
    from ..exec.pipeline import tuned_config
    from ..exec.runner import LocalQueryRunner
    schema = f"sf{Q18_RETRY_SF:g}"
    want = _node_rows(_analyze(LocalQueryRunner(
        schema, device=device, config=tuned_config(
            agg_slots=q18_slots(Q18_RETRY_SF))), Q18, device)[1])
    _t, stats, wall = _analyze(LocalQueryRunner(schema, device=device),
                               Q18, device)
    assert _node_rows(stats) == want, (stats, want)
    _t, ustats, uwall = _analyze(LocalQueryRunner(
        schema, device=device, config=tuned_config(analyze_unfused=True)),
        Q18, device)
    ratios = {}
    for n in set(want) & set(ustats):
        got, base = ustats[n]["rows"], want[n]
        if base == 0:
            assert got == 0, (n, got)
            continue
        k, rest = divmod(got, base)
        assert rest == 0, (n, got, base)
        ratios[n] = k
    passes = set(ratios.values()) - {1}
    assert len(passes) == 1 and min(passes) >= 2, ratios
    rec = {"analyze_ms": wall * 1e3, "unfused_analyze_ms": uwall * 1e3,
           "passes": passes.pop(),
           "counted_per_pass": sorted(n for n, k in ratios.items()
                                      if k > 1)}
    print(f"  {schema} EXPLAIN ANALYZE q18 from the default table: fused "
          f"{wall * 1e3:.3f} ms, rows == the retry-free table's; unfused "
          f"{uwall * 1e3:.3f} ms, {rec['passes']} passes counted at "
          f"{rec['counted_per_pass']}, every other node equal {card}",
          flush=True)
    return rec


def run(sf: float, runs: int, device, card: str = "",
        profile_dir: str = "build/profiles",
        unfused_q18: bool = True) -> dict:
    t0 = time.perf_counter()
    arrays = run_arrays(sf, runs, device, card)
    t1 = time.perf_counter()
    analyze = run_analyze(sf, runs, device, card, profile_dir, unfused_q18)
    return {"arrays": arrays, "analyze": analyze,
            "walls": {"arrays_s": t1 - t0,
                      "analyze_s": time.perf_counter() - t1}}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sf", default="10")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--profile-dir", default="build/profiles")
    args = ap.parse_args()
    from ..exec.runner import resolve_device
    rec = run(float(args.sf), args.runs, resolve_device(args.device),
              profile_dir=args.profile_dir)
    print(f"  phase walls: {rec['walls']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
