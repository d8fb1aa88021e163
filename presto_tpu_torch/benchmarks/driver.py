"""TPC-H macro-benchmark driver (the port's copy of
presto_tpu/benchmarks/driver.py, the presto-benchmark-driver /
benchto-suite analog: per-query wall-clock with prewarm runs over the
full q1-q22 suite).

    python -m presto_tpu_torch.benchmarks.driver [--sf 1] [--runs 3]
        [--queries 1,6,3] [--distributed N] [--device cuda|cpu]
        [--json out.json]

Runs on the card unless `--device cpu` asks for the CPU.  Prints one
JSON object per query: {"query", "sf", "device", "best_s", "runs_s",
"rows"} and a trailing suite summary; mirrors the benchto harness shape
(6 runs / 2 prewarm in the reference's tpch.yaml -- defaults here are
smaller because the first run's kernel builds and host string passes
dominate it).  It is a user's driver, not the port's benchmark.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="presto-tpu-torch-bench-driver")
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--prewarm", type=int, default=1)
    ap.add_argument("--queries", default=None,
                    help="comma-separated query numbers (default: all 22)")
    ap.add_argument("--distributed", type=int, default=0, metavar="N",
                    help="run through the in-process distributed scheduler "
                         "with N tasks per stage")
    ap.add_argument("--batch-rows", type=int, default=1 << 20)
    ap.add_argument("--grouped-lifespans", type=int, default=0,
                    help="0=auto, 1=off, N>=2 force N bucket lifespans")
    ap.add_argument("--grouped-prefetch-depth", type=int, default=1,
                    help="lifespans staged ahead of the one computing "
                         "(0 = strictly serial bucket loop)")
    ap.add_argument("--grouped-stats", action="store_true",
                    help="attach per-query grouped bucket gen/compute/run "
                         "walls from runtime stats to each record")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the device queries run on")
    ap.add_argument("--json", default=None, help="write results file")
    args = ap.parse_args(argv)

    from .tpch_queries import queries_for_sf
    from ..exec.pipeline import ExecutionConfig
    from ..exec.runner import DistributedQueryRunner, LocalQueryRunner

    suite = queries_for_sf(args.sf)
    nums = (sorted(int(x) for x in args.queries.split(","))
            if args.queries else sorted(suite))
    cfg = ExecutionConfig(batch_rows=args.batch_rows,
                          join_out_capacity=1 << 21,
                          grouped_lifespans=args.grouped_lifespans,
                          grouped_prefetch_depth=args.grouped_prefetch_depth)
    schema = f"sf{args.sf:g}"
    if args.distributed:
        runner = DistributedQueryRunner(schema, config=cfg,
                                        n_tasks=args.distributed,
                                        device=args.device)
    else:
        runner = LocalQueryRunner(schema, config=cfg, device=args.device)

    results = []
    for qnum in nums:
        try:
            sql = suite[qnum]
            for _ in range(args.prewarm):
                runner.execute(sql)
            runs = []
            rows = 0
            for _ in range(args.runs):
                t0 = time.perf_counter()
                r = runner.execute(sql)
                runs.append(round(time.perf_counter() - t0, 4))
                rows = len(r.rows)
            rec = {"query": f"q{qnum:02d}", "sf": args.sf,
                   "device": args.device, "best_s": min(runs),
                   "runs_s": runs, "rows": rows}
            if args.grouped_stats:
                stats = getattr(r, "runtime_stats", None) or {}
                rec["grouped_stats"] = {
                    k: v for k, v in stats.items()
                    if k.startswith("grouped")}
        except Exception as e:   # noqa: BLE001 — record and continue
            rec = {"query": f"q{qnum:02d}", "sf": args.sf,
                   "error": f"{type(e).__name__}: {e}"}
        results.append(rec)
        print(json.dumps(rec), flush=True)
        if args.json:   # incremental: a killed run keeps prior results
            with open(args.json, "w") as f:
                json.dump({"results": results}, f, indent=1)

    ok = [r for r in results if "best_s" in r]
    summary = {"suite": "tpch", "sf": args.sf, "device": args.device,
               "queries_ok": len(ok), "queries_failed":
               len(results) - len(ok),
               "total_best_s": round(sum(r["best_s"] for r in ok), 3)}
    print(json.dumps(summary), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"results": results, "summary": summary}, f,
                      indent=1)
    return 0 if len(ok) == len(results) else 1


if __name__ == "__main__":
    sys.exit(main())
