"""All 22 TPC-H queries through the port on a device.

    python -m presto_tpu_torch.benchmarks.tpch_run --sf 10 [--runs 3]
        [--device cuda]

Runs, through LocalQueryRunner:
  * Q1-Q22 at sf0.01, each held to the JAX package's rows in the golden
    file benchmarks/tpch_sf001_rows.json (written by
    tests/torch_tpch_golden.py; ordered queries in order, floats within
    rtol 1e-9);
  * Q1-Q22 at the scale factor: the cold wall (a fresh runner's first
    run: plan, build sides, the host generation of late-materialized
    string columns), the median of `runs` warm walls (their rows equal
    the cold run's), the cold run's aggregation modes
    (torchChain{mode} / kernelScanPrograms / the streaming aggregation),
    the scan kernels it launched (LAUNCHES and JOIN_LAUNCHES around it)
    and every kernelDeclined{reason}; then one run
    under scan_kernel="xla" (the torch chain), held to the auto rows row
    for row (ordered queries in order, floats within rtol 1e-9), which
    puts the kernel paths against the torch chain.
chip_smoke.py runs `run` as its TPC-H phase.  Any mismatch raises.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict

import numpy as np
import torch

from .rows import assert_rows_close, golden_result
from .tpch_queries import ALL, ORDERED, queries_for_sf

GOLDEN_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tpch_sf001_rows.json")
MODES = ("Direct", "StaticSpan", "RuntimeSpan", "SortAgg", "Hash")
# rtol of the floats between the packages and between auto and xla
RTOL = 1e-9


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()  # lint: allow-host-sync


def _wall(runner, sql, device):
    _sync(device)
    t0 = time.perf_counter()
    res = runner.execute(sql)
    _sync(device)
    return res, time.perf_counter() - t0


def _launches() -> Dict[str, int]:
    from ..exec.kernels import scan_kernel as sk
    out = {k: sk.LAUNCHES[k] for k in sk.SCAN_KERNELS}
    out.update({"join_" + k: v for k, v in sk.JOIN_LAUNCHES.items()})
    return out


def modes(res) -> dict:
    """The aggregation modes and declines a result's RuntimeStats show."""
    rs = res.runtime_stats or {}

    def n(k):
        return int(rs.get(k, {}).get("sum", 0))
    return {"kernel_programs": n("kernelScanPrograms"),
            "chain": [m for m in MODES if n("torchChain" + m)],
            "streaming": n("torchStreamingAggregation"),
            "declined": {k[len("kernelDeclined"):]: n(k) for k in sorted(rs)
                         if k.startswith("kernelDeclined")},
            "fusion_declined": sorted(k[len("fusionDeclined"):]
                                      for k in rs
                                      if k.startswith("fusionDeclined"))}


def check_golden(device, card: str = "", path: str = GOLDEN_PATH) -> int:
    """Q1-Q22 at sf0.01 against the golden file; returns the query
    count."""
    from ..exec.runner import LocalQueryRunner
    with open(path) as f:
        doc = json.load(f)
    runner = LocalQueryRunner(doc["schema"], device=device)
    ordered = set(doc["ordered"])
    for q in sorted(ALL):
        ent = doc["queries"][str(q)]
        res = runner.execute(ALL[q])
        assert list(res.column_names) == ent["columns"], (q, ent["columns"])
        assert_rows_close(res, golden_result(ent), ordered=q in ordered,
                          rtol=RTOL)
    print(f"  sf0.01: Q1-Q22 == the JAX package's golden rows "
          f"({os.path.basename(path)}) {card}")
    return len(ALL)


def run(sf: float, runs: int, device, card: str = "") -> dict:
    """Every part of the module's docstring; returns the records."""
    from ..exec.pipeline import tuned_config
    from ..exec.runner import LocalQueryRunner
    out: Dict[str, dict] = {"golden": {"queries": check_golden(device,
                                                               card)}}
    schema = f"sf{sf:g}"
    auto = LocalQueryRunner(schema, device=device)
    xla = LocalQueryRunner(schema, device=device,
                           config=tuned_config(scan_kernel="xla"))
    queries = queries_for_sf(sf)
    # each query's warm rows, for callers that hold other runs to them
    out["results"] = {}
    for q in sorted(queries):
        sql = queries[q]
        before = _launches()
        first, cold = _wall(auto, sql, device)
        launched = {k: v - before[k] for k, v in _launches().items()
                    if v != before[k]}
        walls = []
        for _ in range(runs):
            res, w = _wall(auto, sql, device)
            walls.append(w)
        assert_rows_close(res, first, ordered=q in ORDERED, rtol=RTOL)
        xres, xwall = _wall(xla, sql, device)
        assert_rows_close(res, xres, ordered=q in ORDERED, rtol=RTOL)
        out["results"][q] = res
        rec = out[f"q{q}"] = {
            "rows": len(res.rows), "cold_s": cold,
            "warm_ms": float(np.median(walls)) * 1e3,
            "xla_ms": xwall * 1e3, "launched": launched, **modes(first)}
        print(f"  {schema} Q{q}: {rec['rows']} rows, cold {cold:.3f} s, "
              f"warm median {rec['warm_ms']:.3f} ms ({runs} runs), xla "
              f"{rec['xla_ms']:.3f} ms == auto, kernel programs "
              f"{rec['kernel_programs']}, chain {rec['chain']}, streaming "
              f"{rec['streaming']}, launched {launched}, declined "
              f"{rec['declined']} {card}", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sf", default="10")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    run(float(args.sf), args.runs, torch.device(args.device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
