"""The scalar function set on a device (presto_tpu_torch/exec/lowering.py,
the opcodes the torch interpreter runs alone).

    python -m presto_tpu_torch.benchmarks.functions_run --sf 10
        [--runs 3] [--device cuda]

Runs, through LocalQueryRunner:
  * every query of benchmarks/function_queries.py `ALL` at sf0.01 on the
    device and on the CPU in the same process (8K-row batches, as the CPU
    tests run them), the device's rows equal to the CPU's (integers,
    decimals and strings exactly, floats within rtol 1e-12);
  * `AT_SCALE` (one kernel-eligible lineitem aggregation per family) at
    the scale factor: the cold wall, the median of `runs` warm walls, the
    kernelDeclined{reason} counters (PlanShape: the scan kernels decline
    the new opcodes) and one run under scan_kernel="xla", equal to the
    auto rows.
chip_smoke.py runs `run` as its functions phase.  Any mismatch raises.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict

import numpy as np
import torch

from .function_queries import ALL, AT_SCALE
from .rows import assert_rows_close
from .tpch_run import _wall, modes

RTOL = 1e-12


def check_sf001(device, card: str = "") -> int:
    from ..exec.pipeline import ExecutionConfig
    from ..exec.runner import LocalQueryRunner
    cfg = ExecutionConfig(batch_rows=1 << 13)
    dev = LocalQueryRunner("sf0.01", device=device, config=cfg)
    cpu = LocalQueryRunner("sf0.01", device="cpu", config=cfg)
    t0 = time.perf_counter()
    for sql in ALL:
        assert_rows_close(dev.execute(sql), cpu.execute(sql), ordered=False,
                          rtol=RTOL)
    print(f"  sf0.01: {len(ALL)} function queries on {device} == their "
          f"rows on the CPU ({time.perf_counter() - t0:.3f} s) {card}",
          flush=True)
    return len(ALL)


def run_at_scale(sf: float, runs: int, device, card: str = "") -> dict:
    from ..exec.pipeline import tuned_config
    from ..exec.runner import LocalQueryRunner
    schema = f"sf{sf:g}"
    auto = LocalQueryRunner(schema, device=device)
    xla = LocalQueryRunner(schema, device=device,
                           config=tuned_config(scan_kernel="xla"))
    out: Dict[str, dict] = {}
    for fam, sql in AT_SCALE.items():
        first, cold = _wall(auto, sql, device)
        walls = []
        for _ in range(runs):
            res, w = _wall(auto, sql, device)
            walls.append(w)
            assert_rows_close(res, first, ordered=False, rtol=RTOL)
        xres, xwall = _wall(xla, sql, device)
        assert_rows_close(first, xres, ordered=False, rtol=RTOL)
        rec = out[fam] = {"rows": len(first.rows), "cold_s": cold,
                          "warm_ms": float(np.median(walls)) * 1e3,
                          "xla_ms": xwall * 1e3, **modes(first)}
        assert rec["declined"].get("PlanShape"), rec
        print(f"  {schema} {fam}: {rec['rows']} rows, cold {cold:.3f} s, "
              f"warm median {rec['warm_ms']:.3f} ms ({runs} runs), xla "
              f"{rec['xla_ms']:.3f} ms == auto, chain {rec['chain']}, "
              f"streaming {rec['streaming']}, declined {rec['declined']} "
              f"{card}", flush=True)
    return out


def run(sf: float, runs: int, device, card: str = "") -> dict:
    return {"sf001": {"queries": check_sf001(device, card)},
            "at_scale": run_at_scale(sf, runs, device, card)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sf", default="10")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    from ..exec.runner import resolve_device
    run(float(args.sf), args.runs, resolve_device(args.device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
