"""Run the TPC-H suite one query per subprocess with a wall-clock timeout
(the port's copy of presto_tpu/benchmarks/suite_runner.py, the
benchto-style black-box runner: a hung query must not sink the suite).

    python -m presto_tpu_torch.benchmarks.suite_runner [--sf 0.1]
        [--runs 2] [--timeout 300] [--device cuda|cpu]
        [--json results.json]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="presto-tpu-torch-suite-runner")
    ap.add_argument("--sf", default="0.1")
    ap.add_argument("--runs", default="2")
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    out = []
    for q in range(1, 23):
        try:
            p = subprocess.run(
                [sys.executable, "-m", "presto_tpu_torch.benchmarks.driver",
                 "--sf", args.sf, "--runs", args.runs,
                 "--queries", str(q), "--device", args.device],
                capture_output=True, text=True, timeout=args.timeout)
            lines = p.stdout.strip().splitlines()
            rec = (json.loads(lines[0]) if lines
                   else {"query": f"q{q:02d}", "sf": float(args.sf),
                         "error": (p.stderr or "no output")[-200:]})
        except subprocess.TimeoutExpired:
            rec = {"query": f"q{q:02d}", "sf": float(args.sf),
                   "error": f"timeout >{args.timeout:g}s"}
        out.append(rec)
        print(json.dumps(rec), flush=True)
        if args.json:
            with open(args.json, "w") as f:
                json.dump({"results": out}, f, indent=1)
    ok = [r for r in out if "best_s" in r]
    print(json.dumps({"suite": "tpch", "sf": float(args.sf),
                      "queries_ok": len(ok),
                      "queries_failed": len(out) - len(ok),
                      "total_best_s": round(sum(r["best_s"]
                                                for r in ok), 3)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
