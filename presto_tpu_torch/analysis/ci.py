"""One-shot static-analysis gate: `python -m presto_tpu_torch.analysis.ci`
(the port's copy of presto_tpu/analysis/ci.py).

The CI entry point that runs every static pass this package owns over a
clean tree and the TPC-H planning corpus, then emits one JSON report:

  1. host-sync lint (analysis/lint.py) over the engine sources;
  2. the class-granular thread-safety pass (analysis/concurrency.py,
     LOCK001-LOCK004) over the same tree — including the globally
     combined lock-order graph;
  3. the PlanChecker sweep: every TPC-H suite query is planned,
     optimized, and fragmented with validation diagnostics collected at
     all three wired stages (post-plan / post-optimize / post-fragment),
     the same recipe the conformance tests run per query.

Exit 0 means the tree is clean (no lint finding, no concurrency finding,
no plan diagnostic); anything else exits 1 with the findings both
printed and embedded in the JSON report.  `--json <path>` writes the
report to a file (default: stdout only), `--max-plans N` bounds the
TPC-H sweep for quick pre-commit runs (the bound is recorded in the
report — a capped sweep is not a clean-tree claim for the skipped
queries).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time
from typing import Dict, List

_ENGINE_ROOT = pathlib.Path(__file__).resolve().parent.parent


def _count_py_files(paths: List[str]) -> int:
    n = 0
    for p in paths:
        path = pathlib.Path(p)
        n += sum(1 for _ in path.rglob("*.py")) if path.is_dir() else 1
    return n


def _finding_dicts(findings) -> List[dict]:
    return [{"path": f.path, "line": f.line, "code": f.code,
             "message": f.message} for f in findings]


def _count_codes(counts: Dict[str, int], codes) -> None:
    for code in codes:
        counts[code] = counts.get(code, 0) + 1


def run_plan_sweep(max_plans: int = 0) -> dict:
    """Plan+optimize+fragment every TPC-H suite query, collecting
    validation diagnostics at the three wired stages (the PlanChecker
    conformance recipe) instead of raising on the first."""
    import dataclasses

    from ..benchmarks.tpch_queries import ALL as TPCH_QUERIES
    from ..spi import plan as P
    from ..sql import parser as A
    from ..sql.fragmenter import plan_distributed
    from ..sql.optimizer import optimize
    from ..sql.planner import Planner
    from . import check_plan, check_subplan

    qids = sorted(TPCH_QUERIES)
    skipped = 0
    if max_plans > 0 and len(qids) > max_plans:
        skipped = len(qids) - max_plans
        qids = qids[:max_plans]
    diagnostics: List[dict] = []
    errors: List[dict] = []
    for qid in qids:
        try:
            planner = Planner("sf0.01", "tpch")
            node, names, out_vars = planner.plan_query_any(
                A.parse_sql(TPCH_QUERIES[qid]))
            out = P.OutputNode(planner.new_id("output"), node, names,
                               out_vars)
            for diag in check_plan(out, "post-plan"):
                diagnostics.append(
                    {"query": qid, **dataclasses.asdict(diag)})
            out = optimize(out)
            for diag in check_plan(out, "post-optimize"):
                diagnostics.append(
                    {"query": qid, **dataclasses.asdict(diag)})
            sub = plan_distributed(out)
            for diag in check_subplan(sub, "post-fragment"):
                diagnostics.append(
                    {"query": qid, **dataclasses.asdict(diag)})
        except Exception as e:  # noqa: BLE001 — a crash IS a CI failure
            errors.append({"query": qid,
                           "error": f"{type(e).__name__}: {e}"})
    return {"queries": len(qids), "skipped": skipped,
            "diagnostics": diagnostics, "errors": errors}


def run(paths: List[str], max_plans: int = 0) -> dict:
    from .concurrency import check_paths as concurrency_paths
    from .lint import lint_paths

    t0 = time.perf_counter()
    report: dict = {"paths": [str(p) for p in paths],
                    "files_scanned": _count_py_files(paths)}
    counts: Dict[str, int] = {}

    lint_findings = lint_paths(paths)
    _count_codes(counts, (f.code for f in lint_findings))
    report["lint"] = {"findings": _finding_dicts(lint_findings)}

    conc_findings = concurrency_paths(paths)
    _count_codes(counts, (f.code for f in conc_findings))
    report["concurrency"] = {"findings": _finding_dicts(conc_findings)}

    sweep = run_plan_sweep(max_plans)
    _count_codes(counts, (d.get("code", "PLAN_ERROR")
                          for d in sweep["diagnostics"]))
    for _ in sweep["errors"]:
        counts["PLAN_CRASH"] = counts.get("PLAN_CRASH", 0) + 1
    report["plan_sweep"] = sweep

    report["counts_by_code"] = dict(sorted(counts.items()))
    report["total_findings"] = sum(counts.values())
    report["wall_seconds"] = round(time.perf_counter() - t0, 3)
    report["clean"] = report["total_findings"] == 0
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m presto_tpu_torch.analysis.ci",
        description="run lint + concurrency + the TPC-H PlanChecker "
                    "sweep; exit 0 only on a clean tree")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files/dirs to scan (default: the "
                         "presto_tpu_torch package)")
    ap.add_argument("--json", dest="json_path", default="",
                    help="also write the JSON report to this path")
    ap.add_argument("--max-plans", type=int, default=0,
                    help="bound the TPC-H sweep to N queries (0 = all)")
    args = ap.parse_args(argv)
    paths = args.paths or [str(_ENGINE_ROOT)]

    report = run(paths, max_plans=args.max_plans)

    for section in ("lint", "concurrency"):
        for f in report[section]["findings"]:
            print(f"{f['path']}:{f['line']}: {f['code']} {f['message']}")
    for d in report["plan_sweep"]["diagnostics"]:
        print(f"plan[{d['query']}]: {d}")
    for e in report["plan_sweep"]["errors"]:
        print(f"plan[{e['query']}] crashed: {e['error']}")

    out = json.dumps(report, indent=2, default=str)
    if args.json_path:
        pathlib.Path(args.json_path).write_text(out + "\n")
    print(out)
    return 0 if report["clean"] else 1


if __name__ == "__main__":
    sys.exit(main())
