"""The numpy oracle, the verifier and the SQLite differential on a
device.

    python -m presto_tpu_torch.benchmarks.verify_run [--device cuda]

Runs at sf0.01 (every failed check raises):
  * verifier.verify with the port's numpy oracle as the control
    (LocalQueryRunner.execute_reference, host numpy) and the runner on
    the device as the test, over TPC-H Q1-Q22: 22 MATCH;
  * the SQLite differential (benchmarks/sqlite_queries.py, the queries
    of tests/test_sqlite_differential.py) over the same data exported
    into an in-memory sqlite3 database: every query's rows equal to
    sqlite's value for value (num_eq), and verifier.verify with sqlite as
    the control over every query, both sides normalized to one
    representation: all MATCH.
chip_smoke.py runs `run` as its oracle phase.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict

from . import sqlite_queries as SQ
from .tpch_queries import queries_for_sf

SF = 0.01


def run(device, card: str = "") -> Dict[str, object]:
    """Every part of the module's docstring; returns the records."""
    from .. import verifier as V
    from ..connectors.sqlite_backend import SqliteRunner
    from ..exec.pipeline import ExecutionConfig
    from ..exec.runner import LocalQueryRunner
    rec: Dict[str, object] = {"walls": {}}
    walls = rec["walls"]
    runner = LocalQueryRunner(f"sf{SF:g}", device=device)
    tpch = queries_for_sf(SF)
    t0 = time.perf_counter()
    res = V.verify(runner.execute_reference, runner.execute,
                   [tpch[q] for q in sorted(tpch)])
    walls["oracle_tpch"] = time.perf_counter() - t0
    bad = [(q, r.status, r.detail) for q, r in zip(sorted(tpch), res)
           if r.status != V.MATCH]
    assert not bad, bad
    rec["oracle_tpch"] = {"queries": len(res), "match": len(res)}
    print(f"  verifier, numpy oracle vs {device}: TPC-H Q1-Q22 at "
          f"sf{SF:g}: {len(res)} MATCH in {walls['oracle_tpch']:.3f} s "
          f"{card}")

    t0 = time.perf_counter()
    lite = SqliteRunner(SQ.SF)
    walls["sqlite_export"] = time.perf_counter() - t0
    engine = LocalQueryRunner(f"sf{SQ.SF:g}", device=device,
                              config=ExecutionConfig(
                                  batch_rows=1 << 14,
                                  join_out_capacity=1 << 16))
    names = sorted(SQ.QUERIES)
    eng = {n: SQ.render(SQ.QUERIES[n], "engine") for n in names}
    lit = {eng[n]: SQ.render(SQ.QUERIES[n], "sqlite") for n in names}
    types = {eng[n]: [v.type for v in engine.plan(eng[n]).outputs]
             for n in names}
    t0 = time.perf_counter()
    for n in names:
        got = engine.execute(eng[n])
        exp = lite.execute(lit[eng[n]])
        grows = sorted(([SQ.date_to_days(v) for v in r] for r in got.rows),
                       key=repr)
        erows = sorted(exp.rows, key=repr)
        assert len(grows) == len(erows), (n, len(grows), len(erows))
        for gr, er in zip(grows, erows):
            assert all(SQ.num_eq(a, b) for a, b in zip(gr, er)), (n, gr, er)
    walls["sqlite_rows"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = V.verify(lambda s: SQ.normalize(lite.execute(lit[s]), types[s]),
                   lambda s: SQ.normalize(engine.execute(s), types[s]),
                   [eng[n] for n in names])
    walls["sqlite_verify"] = time.perf_counter() - t0
    bad = [(n, r.status, r.detail) for n, r in zip(names, res)
           if r.status != V.MATCH]
    assert not bad, bad
    rec["sqlite"] = {"queries": len(names), "match": len(res)}
    print(f"  verifier, sqlite vs {device}: {len(names)} queries of the "
          f"SQLite differential at sf{SQ.SF:g}: rows equal and "
          f"{len(res)} MATCH (export {walls['sqlite_export']:.3f} s, rows "
          f"{walls['sqlite_rows']:.3f} s, verify "
          f"{walls['sqlite_verify']:.3f} s) {card}")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="verify_run")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from ..exec.runner import resolve_device
    run(resolve_device(args.device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
