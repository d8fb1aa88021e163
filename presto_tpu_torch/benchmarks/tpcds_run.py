"""TPC-DS through the port on a device (the tpcds connector's fact tables
generated on the device: presto_tpu_torch/connectors/device_gen.py).

    python -m presto_tpu_torch.benchmarks.tpcds_run --sf 10 --sf100 100
        [--inventory-sf 1] [--runs 3] [--device cuda]
        [--phases golden,bank,q95,core,dist,fly]

Runs, through LocalQueryRunner unless said otherwise:
  * (golden) the bank of benchmarks/tpcds_queries.py (`bank()`: the 21
    conformance queries under their config, the shape queries, Q95 in
    both windows, the three Q95 cores) at sf0.01, each held to the JAX
    package's rows in benchmarks/tpcds_sf001_rows.json (written by
    tests/torch_tpcds_golden.py; ordered queries in order, floats within
    rtol 1e-9);
  * (bank) the 21 queries, the shape queries and two store_sales
    aggregations (by ss_store_sk, by ss_store_sk and ss_quantity) at the
    scale factor: the cold wall, the median of `runs` warm walls (rows
    equal to the cold run's), the aggregation modes, the scan kernels
    each launched (LAUNCHES / JOIN_LAUNCHES deltas) and its
    kernelDeclined{reason} counters, then one run under
    scan_kernel="xla", equal to the auto rows row for row.  The queries
    whose fact table the host generates on every run (HOST_HEAVY: not
    device-generated in either package) run cold only, and under xla
    only where the auto run launched a kernel (else both modes
    take the same path); of those, q37 and q82 (inventory, 235 M rows at
    SF10) run at `inventory_sf` (SF1 by default) and say so.  At least
    one query must launch a scan kernel;
  * (q95) BASELINE config 5, TPC-DS Q95 at `sf100` in a fresh runner:
    the official text (the 1999-02-01 .. 1999-04-02 window) cold and
    warm with the peak device memory (torch.cuda.max_memory_allocated),
    then the widened-window form, non-empty, equal to the same query
    under scan_kernel="xla".  Unbudgeted first; a CUDA out-of-memory
    error reruns it under `memory_budget_bytes` (the spill path), and the
    record says which ran and why;
  * (core) Q95's join core at `sf100` with grouped_lifespans=0 (auto),
    whose ws_order_number co-bucket layout must engage lifespans, equal
    to grouped_lifespans=1;
  * (dist) TPC-DS Q3 through DistributedQueryRunner at the scale factor,
    3 tasks and partitioned joins (broadcast_threshold=0), equal to the
    local rows;
  * (fly) the store_sales queries of the bank with storage_enabled=False
    (every column generated per chunk), equal to the resident rows.
chip_smoke.py runs `run` as its TPC-DS phase.  Any mismatch raises.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import time
from typing import Dict

import numpy as np
import torch

from .rows import assert_rows_close, golden_result
from .tpch_run import _launches, _sync, _wall, modes
from . import tpcds_queries as T

GOLDEN_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tpcds_sf001_rows.json")
RTOL = 1e-9
# store_sales aggregations that reach the scan kernels (one key, two
# keys), added to the bank at the scale factor
STORE_AGGS = {
    "ss_by_store": "select ss_store_sk, count(*), sum(ss_net_paid) "
                   "from store_sales group by ss_store_sk",
    "ss_by_store_qty": "select ss_store_sk, ss_quantity, "
                       "sum(ss_ext_sales_price), count(*) "
                       "from store_sales group by ss_store_sk, ss_quantity",
}
# the bank's queries over a host-generated fact table: catalog_sales
# (14.4 M rows at SF10) and inventory (235 M at SF10, 23.5 M at SF1)
HOST_HEAVY = ("q16_shape_exists", "q26", "q37", "q82", "q99")
# the inventory queries, run at `inventory_sf`
INVENTORY = ("q37", "q82")
# the store_sales queries the on-the-fly check repeats
FLY = ("q03", "q42_full", "q96", "ss_by_store", "ss_by_store_qty")
# the budget a Q95 run that does not fit the card reruns under
Q95_BUDGET = 16 << 30
PHASES = ("golden", "bank", "q95", "core", "dist", "fly")


def _runner(schema, device, config=None, **kw):
    from ..exec.pipeline import ExecutionConfig, tuned_config
    from ..exec.runner import LocalQueryRunner
    cfg = (ExecutionConfig(**T.BANK_CONFIG, **kw) if config == "bank"
           else tuned_config(**kw))
    return LocalQueryRunner(schema, catalog="tpcds", device=device,
                            config=cfg)


def _peak_reset(device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _peak(device) -> int:
    return (int(torch.cuda.max_memory_allocated(device))
            if device.type == "cuda" else 0)


def _collect(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def check_golden(device, card: str = "", path: str = GOLDEN_PATH) -> int:
    """The bank at sf0.01 against the golden file; returns the query
    count."""
    with open(path) as f:
        doc = json.load(f)
    ordered = set(doc["ordered"])
    runners = {c: _runner(doc["schema"], device, c)
               for c in ("bank", "default")}
    bank = T.bank()
    for name in sorted(bank):
        sql, config, _o = bank[name]
        ent = doc["queries"][name]
        res = runners[config].execute(sql)
        assert list(res.column_names) == ent["columns"], (name,
                                                          ent["columns"])
        assert_rows_close(res, golden_result(ent), ordered=name in ordered,
                          rtol=RTOL)
    print(f"  sf0.01: the TPC-DS bank ({len(bank)} queries) == the JAX "
          f"package's golden rows ({os.path.basename(path)}) {card}",
          flush=True)
    return len(bank)


def bank_queries() -> Dict[str, tuple]:
    """name -> (sql, ordered) of the bank at the scale factor."""
    out = {n: (sql, False) for n, sql in T.QUERIES.items()}
    out.update({n: (sql, n in T.ORDERED) for n, sql in T.SHAPES.items()})
    out.update({n: (sql, False) for n, sql in STORE_AGGS.items()})
    return out


def run_bank(sf: float, runs: int, device, card: str = "",
             inventory_sf: float = 1.0) -> dict:
    schemas = {n: f"sf{inventory_sf:g}" if n in INVENTORY else f"sf{sf:g}"
               for n in bank_queries()}
    runners = {}

    def runner(schema, mode):
        if (schema, mode) not in runners:
            runners[(schema, mode)] = _runner(schema, device,
                                              scan_kernel=mode)
        return runners[(schema, mode)]
    out: Dict[str, dict] = {"results": {}}
    queries = bank_queries()
    for name in sorted(queries):
        sql, ordered = queries[name]
        schema = schemas[name]
        auto, xla = runner(schema, "auto"), runner(schema, "xla")
        before = _launches()
        first, cold = _wall(auto, sql, device)
        launched = {k: v - before[k] for k, v in _launches().items()
                    if v != before[k]}
        heavy = name in HOST_HEAVY
        walls = []
        for _ in range(0 if heavy else runs):
            res, w = _wall(auto, sql, device)
            walls.append(w)
            assert_rows_close(res, first, ordered=ordered, rtol=RTOL)
        xla_ms = None
        if launched or not heavy:
            xres, xwall = _wall(xla, sql, device)
            assert_rows_close(first, xres, ordered=ordered, rtol=RTOL)
            xla_ms = xwall * 1e3
        out["results"][name] = first
        rec = out[name] = {
            "schema": schema, "rows": len(first.rows), "cold_s": cold,
            "warm_ms": float(np.median(walls)) * 1e3 if walls else None,
            "xla_ms": xla_ms, "launched": launched, **modes(first)}
        xla_note = ("not run (auto launched no kernel: the same path)"
                    if xla_ms is None else f"{xla_ms:.3f} ms == auto")
        warm_note = ("not run" if not walls else
                     f"median {rec['warm_ms']:.3f} ms ({len(walls)} runs)")
        print(f"  {schema} {name}: {rec['rows']} rows, cold {cold:.3f} s, "
              f"warm {warm_note}, "
              f"xla {xla_note}, kernel programs "
              f"{rec['kernel_programs']}, chain {rec['chain']}, streaming "
              f"{rec['streaming']}, launched {launched}, declined "
              f"{rec['declined']}"
              + (" (its fact table is host-generated)" if heavy else "")
              + f" {card}", flush=True)
    scan = {k: sum(r["launched"].get(k, 0) for n, r in out.items()
                   if n != "results")
            for k in ("scan_direct", "scan_span", "scan_hash")}
    out["launches"] = scan
    print(f"  bank scan-kernel launches on TPC-DS tables {scan} {card}")
    if device.type == "cuda":
        # the plain versions (the CPU) count no launch
        assert sum(scan.values()) > 0, scan
    return out


def _runs(runner, sql: str, warm: int, device, how: str):
    """A fresh runner's cold and warm runs of `sql` with the peak."""
    _sync(device)
    _peak_reset(device)
    first, cold = _wall(runner, sql, device)
    walls = []
    for _ in range(warm):
        res, w = _wall(runner, sql, device)
        walls.append(w)
        assert_rows_close(res, first, ordered=True, rtol=RTOL)
    return {"how": how, "rows": first.rows, "cold_s": cold,
            "warm_s": float(np.median(walls)) if walls else None,
            "peak_bytes": _peak(device), **modes(first)}, first


def _q95_run(sf: float, device, sql: str, warm: int, card: str):
    """`sql` unbudgeted in a fresh runner, or under Q95_BUDGET after a
    CUDA out-of-memory error."""
    schema = f"sf{sf:g}"
    _collect(device)
    try:
        return _runs(_runner(schema, device), sql, warm, device,
                     "unbudgeted")
    except torch.cuda.OutOfMemoryError as e:
        how = (f"budgeted at {Q95_BUDGET} B: the unbudgeted run ran out "
               f"of device memory ({str(e).splitlines()[0]})")
    print(f"  {schema} Q95: {how} {card}", flush=True)
    _collect(device)
    return _runs(_runner(schema, device, memory_budget_bytes=Q95_BUDGET),
                 sql, warm, device, how)


def run_q95(sf100: float, device, card: str = "") -> dict:
    schema = f"sf{sf100:g}"
    out = {}
    rec, _res = _q95_run(sf100, device, T.Q95_OFFICIAL, 1, card)
    assert len(rec["rows"]) == 1, rec["rows"]
    out["official"] = rec
    print(f"  {schema} Q95 (official, {rec['how']}): {rec['rows']}, cold "
          f"{rec['cold_s']:.3f} s, warm {rec['warm_s']:.3f} s, peak device "
          f"memory {rec['peak_bytes']} B, chain {rec['chain']}, streaming "
          f"{rec['streaming']}, declined {rec['declined']}, fusion "
          f"declined {rec['fusion_declined']} {card}", flush=True)
    rec, res = _q95_run(sf100, device, T.Q95_WIDE, 0, card)
    assert res.rows[0][0] > 0, res.rows
    _collect(device)
    xla = _runner(schema, device, scan_kernel="xla",
                  **({} if rec["how"] == "unbudgeted"
                     else {"memory_budget_bytes": Q95_BUDGET}))
    xres, xwall = _wall(xla, T.Q95_WIDE, device)
    assert_rows_close(res, xres, ordered=True, rtol=RTOL)
    del xla
    rec["xla_s"] = xwall
    out["wide"] = rec
    print(f"  {schema} Q95 (widened window, {rec['how']}): {rec['rows']}, "
          f"cold {rec['cold_s']:.3f} s, peak device memory "
          f"{rec['peak_bytes']} B, == xla ({xwall:.3f} s) {card}",
          flush=True)
    _collect(device)
    return out


def run_core(sf100: float, device, card: str = "") -> dict:
    """Q95's join core with auto lifespans against the whole-table run."""
    from .scale_run import lifespans
    schema = f"sf{sf100:g}"
    out = {}
    results = {}
    for k in (0, 1):
        _collect(device)
        runner = _runner(schema, device, grouped_lifespans=k)
        _sync(device)
        _peak_reset(device)
        res, wall = _wall(runner, T.Q95_JOIN_CORE, device)
        del runner
        results[k] = res
        gr = lifespans(res)
        out[f"lifespans_{k}"] = {"wall_s": wall, "rows": len(res.rows),
                                 "peak_bytes": _peak(device), "grouped": gr}
        print(f"  {schema} Q95 join core, grouped_lifespans={k}: "
              f"{len(res.rows)} rows, {wall:.3f} s, peak device memory "
              f"{_peak(device)} B, lifespans engaged {gr['engaged']} "
              f"({gr['lifespans']}) {card}", flush=True)
    # auto engages above AUTO_SPAN_THRESHOLD order numbers (at SF100:
    # 24 M over 2**24)
    from ..connectors import tpcds
    from ..exec.grouped import AUTO_SPAN_THRESHOLD
    keys = -(-tpcds.table_row_count("web_sales", sf100)
             // tpcds.LINES_PER_ORDER)
    if keys > AUTO_SPAN_THRESHOLD:
        assert out["lifespans_0"]["grouped"]["engaged"], out
        assert out["lifespans_0"]["grouped"]["lifespans"] > 1, out
    assert not out["lifespans_1"]["grouped"]["engaged"], out
    assert_rows_close(results[0], results[1], ordered=True, rtol=RTOL)
    _collect(device)
    return out


def run_distributed(sf: float, device, card: str = "") -> dict:
    from ..exec.runner import DistributedQueryRunner
    schema = f"sf{sf:g}"
    local, _w = _wall(_runner(schema, device), T.DISTRIBUTED_Q3, device)
    runner = DistributedQueryRunner(schema, n_tasks=3, broadcast_threshold=0,
                                    catalog="tpcds", device=device)
    res, wall = _wall(runner, T.DISTRIBUTED_Q3, device)
    assert_rows_close(res, local, ordered=False, rtol=RTOL)
    stages = len(runner.last_scheduler.stages())
    print(f"  {schema} TPC-DS Q3 distributed (3 tasks, broadcast_threshold="
          f"0): {len(res.rows)} rows == local, {wall:.3f} s, {stages} "
          f"stages {card}", flush=True)
    return {"wall_s": wall, "rows": len(res.rows), "stages": stages}


def run_onthefly(sf: float, device, resident: dict, card: str = "") -> dict:
    schema = f"sf{sf:g}"
    fly = _runner(schema, device, storage_enabled=False)
    queries = bank_queries()
    out = {}
    for name in FLY:
        sql, ordered = queries[name]
        got, wall = _wall(fly, sql, device)
        want = resident.get(name)
        if want is None:
            want, _w = _wall(_runner(schema, device), sql, device)
        assert_rows_close(got, want, ordered=ordered, rtol=RTOL)
        rec = out[name] = {"wall_s": wall, **modes(got)}
        print(f"  {schema} {name} on the fly: {wall:.3f} s == resident "
              f"rows, chain {rec['chain']}, declined {rec['declined']} "
              f"{card}", flush=True)
    return out


def run(sf: float, sf100: float, runs: int, device, card: str = "",
        phases=PHASES, inventory_sf: float = 1.0) -> dict:
    """Every part of the module's docstring; returns the records."""
    out: Dict[str, dict] = {}
    t = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out[name] = fn()
        t[name] = time.perf_counter() - t0
        print(f"  [tpcds] {name}: {t[name]:.3f} s", flush=True)
    if "golden" in phases:
        timed("golden", lambda: {"queries": check_golden(device, card)})
    if "bank" in phases:
        timed("bank", lambda: run_bank(sf, runs, device, card,
                                       inventory_sf))
    resident = out.get("bank", {}).get("results", {})
    if "fly" in phases:
        timed("fly", lambda: run_onthefly(sf, device, resident, card))
    if "dist" in phases:
        timed("dist", lambda: run_distributed(sf, device, card=card))
    _collect(device)
    if "q95" in phases:
        timed("q95", lambda: run_q95(sf100, device, card))
    if "core" in phases:
        timed("core", lambda: run_core(sf100, device, card))
    out["walls"] = t
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sf", default="10")
    ap.add_argument("--sf100", default="100")
    ap.add_argument("--inventory-sf", default="1")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--phases", default=",".join(PHASES))
    args = ap.parse_args()
    from ..exec.runner import resolve_device
    device = resolve_device(args.device)
    if device.type == "cuda":
        from ..exec.kernels import build
        build.build_all()
    run(float(args.sf), float(args.sf100), args.runs, device,
        phases=tuple(args.phases.split(",")),
        inventory_sf=float(args.inventory_sf))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
