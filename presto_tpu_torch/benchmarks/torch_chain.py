"""The torch fused chain and the streaming aggregation at a TPC-H scale.

    python -m presto_tpu_torch.benchmarks.torch_chain --sf 10 [--runs 5]
        [--device cuda]

Runs, through LocalQueryRunner on the device:
  * TPC-H Q12, Q14 and Q19 (a kernel's metered JoinShape decline, then
    the torch fused chain): one warm-up and `runs` timed walls each, the
    mode the chain took (its torchChain{mode} counters), its chunks and
    the decline reason;
  * one query per aggregate form: moments and corr (the sort
    aggregation), approx_distinct (the streaming hashed table),
    approx_percentile (the sort aggregation), count(distinct o_custkey)
    by o_orderpriority (an aggregation over an aggregation) and a masked
    aggregate (a hand-built plan through PlanCompiler);
  * the kernel queries Q1, Q6, S1, H1, H2 and J1-J3 under
    scan_kernel="xla", held against their rows through the kernels
    (integers exact, floats rtol 1e-12);
  * one torch.profiler trace of Q14: the device's busy time, its idle
    share of the traced wall and its device events per chain step;
  * Q14's wall with the chain's steps of pipeline.CHAIN_STEP_ROWS rows
    against steps of one scan chunk (the reference's granularity), in
    turns (steps, chunks, chunks, steps);
and checks every answer against numpy over the decoded resident columns.
chip_smoke.py runs `run` as its torch-chain phase.  Any failed check
raises.
"""
from __future__ import annotations

import argparse
import math
import time
from typing import Dict, List

import numpy as np
import torch

from .grouped_queries import H1, H2, S1
from .join_queries import J1, J2, J3
from .rows import assert_rows_close
from .tpch_queries import Q1, Q6, Q12, Q14, Q19

CHAIN_QUERIES = {"q12": Q12, "q14": Q14, "q19": Q19}
FORMS = {
    "moments_corr": ("select l_returnflag, stddev(l_quantity), "
                     "corr(l_quantity, l_extendedprice) from lineitem "
                     "group by l_returnflag"),
    "approx_distinct": ("select l_shipmode, approx_distinct(l_suppkey) "
                        "from lineitem group by l_shipmode"),
    "approx_percentile": ("select l_returnflag, "
                          "approx_percentile(l_extendedprice, 0.5) "
                          "from lineitem group by l_returnflag"),
    "count_distinct": ("select o_orderpriority, count(distinct o_custkey) "
                       "from orders group by o_orderpriority"),
}
KERNEL_QUERIES = {"q1": Q1, "q6": Q6, "s1": S1, "h1": H1, "h2": H2,
                  "j1": J1, "j2": J2, "j3": J3}
MODES = ("Direct", "StaticSpan", "RuntimeSpan", "SortAgg", "Hash")
# 3 x approx_distinct's standard error (1.04 / sqrt(2048))
HLL_BOUND = 3 * 1.04 / math.sqrt(2048)


def chain_info(res) -> dict:
    rs = res.runtime_stats or {}

    def n(k):
        return int(rs.get(k, {}).get("sum", 0))
    return {"modes": [m for m in MODES if n("torchChain" + m)],
            "passes": sum(n("torchChain" + m) for m in MODES),
            "chunks": n("torchChainChunks"),
            "steps": n("torchChainSteps"),
            "streaming": n("torchStreamingAggregation"),
            "declined": sorted(k[len("kernelDeclined"):] for k in rs
                               if k.startswith("kernelDeclined")),
            "fusion_declined": sorted(k[len("fusionDeclined"):] for k in rs
                                      if k.startswith("fusionDeclined"))}


def _scan_launches() -> dict:
    from ..exec.kernels import scan_kernel as sk
    return {k: sk.LAUNCHES[k] for k in sk.SCAN_KERNELS}


def no_scan_kernel(name, res, launches0) -> None:
    """`res` (and every run since `launches0`, a _scan_launches()) went
    through no scan kernel: no kernelScanPrograms, no launch counted."""
    rs = res.runtime_stats or {}
    assert "kernelScanPrograms" not in rs, (name, rs)
    assert _scan_launches() == launches0, (name, launches0)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()  # lint: allow-host-sync


def timed(runner, sql, runs, device, warm=True):
    """(the last result, the median wall of `runs` runs), after a warm-up
    run that builds the plan and its tables unless `warm` is False."""
    res = runner.execute(sql) if warm else None
    walls = []
    for _ in range(runs):
        _sync(device)
        t0 = time.perf_counter()
        res = runner.execute(sql)
        walls.append(time.perf_counter() - t0)
    return res, float(np.median(walls))


class Columns:
    """Decoded resident columns on the host (int64; dictionary codes for
    varchar columns), generated into the store if absent."""

    def __init__(self, runner, sf: float):
        from ..connectors import catalog
        from ..storage import get_store
        cfg = runner.config
        self.cfg, self.sf, self.catalog = cfg, sf, catalog
        self.store = get_store(cfg.storage_budget_bytes,
                               cfg.storage_max_column_bytes, runner.device)
        self.cache: Dict[tuple, np.ndarray] = {}

    def __call__(self, table: str, col: str) -> np.ndarray:
        key = (table, col)
        if key not in self.cache:
            cat = self.catalog
            n = cat.table_row_count(table, self.sf, "tpch")
            as_i32 = (col.endswith("date") or cat.column_type(
                table, col, "tpch").storage == "INT_ARRAY")
            ent = self.store.get_or_build(
                "tpch", table, col, self.sf, n, self.cfg.batch_rows, as_i32,
                zone_rows=self.cfg.storage_zone_rows,
                encodings=self.cfg.storage_encodings)
            assert ent is not None, f"{table}.{col} not resident"
            host = ent.column.decode_full()[:n].cpu()  # lint: allow-host-sync
            self.cache[key] = host.numpy().astype(np.int64)
        return self.cache[key]

    @staticmethod
    def code(table: str, col: str, value: str) -> int:
        from ..connectors import device_gen
        return device_gen.dictionary("tpch", table, col).index(value)

    @staticmethod
    def codes(table: str, col: str, pred) -> np.ndarray:
        from ..connectors import device_gen
        d = device_gen.dictionary("tpch", table, col)
        return np.asarray([i for i, s in enumerate(d) if pred(s)],
                          dtype=np.int64)


def _day(s: str) -> int:
    return int(np.datetime64(s, "D").astype(np.int64))


def _lookup(keys: np.ndarray, values: np.ndarray, probe: np.ndarray):
    """values[i] where keys[i] == probe (keys unique), and the hit mask."""
    order = np.argsort(keys)
    ks = keys[order]
    pos = np.clip(np.searchsorted(ks, probe), 0, len(ks) - 1)
    hit = ks[pos] == probe
    return values[order][pos], hit


def check_q12(rows, C: Columns) -> None:
    L = lambda c: C("lineitem", c)       # noqa: E731
    mode, commit, receipt, ship = (L(c) for c in (
        "shipmode", "commitdate", "receiptdate", "shipdate"))
    sel = (np.isin(mode, C.codes("lineitem", "shipmode",
                                 lambda s: s in ("MAIL", "SHIP")))
           & (commit < receipt) & (ship < commit)
           & (receipt >= _day("1994-01-01")) & (receipt < _day("1995-01-01")))
    prio, hit = _lookup(C("orders", "orderkey"), C("orders", "orderpriority"),
                        L("orderkey")[sel])
    assert hit.all()
    high = np.isin(prio, C.codes("orders", "orderpriority",
                                 lambda s: s in ("1-URGENT", "2-HIGH")))
    want = []
    for m in ("MAIL", "SHIP"):
        g = mode[sel] == C.code("lineitem", "shipmode", m)
        want.append([m, int((g & high).sum()), int((g & ~high).sum())])
    assert rows == want, (rows, want)


def check_q14(rows, C: Columns) -> None:
    L = lambda c: C("lineitem", c)       # noqa: E731
    ship = L("shipdate")
    sel = (ship >= _day("1995-09-01")) & (ship < _day("1995-10-01"))
    ptype, hit = _lookup(C("part", "partkey"), C("part", "type"),
                         L("partkey")[sel])
    assert hit.all()
    rev = L("extendedprice")[sel] * (100 - L("discount")[sel])
    promo = np.isin(ptype, C.codes("part", "type",
                                   lambda s: s.startswith("PROMO")))
    want = 100.0 * int(rev[promo].sum()) / int(rev.sum())
    (got,), = rows
    assert abs(float(got) - want) <= 1e-6, (got, want)


def check_q19(rows, C: Columns) -> None:
    L = lambda c: C("lineitem", c)       # noqa: E731
    P = lambda c: C("part", c)           # noqa: E731
    pk = P("partkey")
    brand, cont, size = (_lookup(pk, P(c), L("partkey"))[0]
                         for c in ("brand", "container", "size"))
    qty = L("quantity")
    base = (np.isin(L("shipmode"), C.codes(
        "lineitem", "shipmode", lambda s: s in ("AIR", "AIR REG")))
        & (L("shipinstruct") == C.code("lineitem", "shipinstruct",
                                       "DELIVER IN PERSON")))
    sel = np.zeros(len(qty), dtype=bool)
    for b, conts, q0, smax in (
            ("Brand#12", ("SM CASE", "SM BOX", "SM PACK", "SM PKG"), 1, 5),
            ("Brand#23", ("MED BAG", "MED BOX", "MED PKG", "MED PACK"), 10,
             10),
            ("Brand#34", ("LG CASE", "LG BOX", "LG PACK", "LG PKG"), 20,
             15)):
        sel |= (base & (brand == C.code("part", "brand", b))
                & np.isin(cont, C.codes("part", "container",
                                        lambda s, c=conts: s in c))
                & (qty >= q0 * 100) & (qty <= (q0 + 10) * 100)
                & (size >= 1) & (size <= smax))
    want = int((L("extendedprice")[sel] * (100 - L("discount")[sel])).sum())
    (got,), = rows
    assert int(got.scaleb(4)) == want, (got, want)


def check_forms(results, C: Columns) -> None:
    L = lambda c: C("lineitem", c)       # noqa: E731
    flag = L("returnflag")
    qty, price = L("quantity") / 100.0, L("extendedprice")
    for f, sd, corr in results["moments_corr"].rows:
        g = flag == C.code("lineitem", "returnflag", f)
        assert abs(sd - qty[g].std(ddof=1)) <= 1e-9 * sd, (f, sd)
        want = np.corrcoef(qty[g], price[g] / 100.0)[0, 1]
        assert abs(corr - want) <= 1e-9, (f, corr, want)
    mode, supp = L("shipmode"), L("suppkey")
    for m, est in results["approx_distinct"].rows:
        exact = len(np.unique(supp[mode == C.code("lineitem", "shipmode",
                                                  m)]))
        assert abs(est - exact) <= HLL_BOUND * exact, (m, est, exact)
    for f, p50 in results["approx_percentile"].rows:
        v = np.sort(price[flag == C.code("lineitem", "returnflag", f)])
        want = v[int(math.floor(0.5 * (len(v) - 1) + 0.5))]
        assert int(p50.scaleb(2)) == int(want), (f, p50, want)
    prio, cust = C("orders", "orderpriority"), C("orders", "custkey")
    for p, n in results["count_distinct"].rows:
        g = prio == C.code("orders", "orderpriority", p)
        assert n == len(np.unique(cust[g])), (p, n)
    tot = C("orders", "totalprice")
    for p, n_all, n_big, s_big in results["masked"].rows:
        g = prio == C.code("orders", "orderpriority", p)
        big = g & (tot > 15000000)
        assert (n_all, n_big, int(s_big.scaleb(2))) == (
            int(g.sum()), int(big.sum()), int(tot[big].sum())), p


def masked_plan(runner):
    """count(*), count(*) MASK m and sum(o_totalprice) MASK m by
    o_orderpriority, m = o_totalprice > 150000: the masks become IF inputs
    (_rewrite_agg_masks) over the fused chain."""
    from ..common.types import BIGINT, BOOLEAN, DOUBLE
    from ..spi import plan as P
    from ..spi.expr import (CallExpression, ConstantExpression,
                            VariableReferenceExpression, call)
    root = runner.plan("select o_orderpriority, o_totalprice from orders")
    src = root.source
    prio, price = src.output_variables
    m = VariableReferenceExpression("m", BOOLEAN)
    proj = P.ProjectNode("masked_p", src, {
        prio: prio, price: price,
        m: call("gt", BOOLEAN, call("cast", DOUBLE, price),
                ConstantExpression(150000.0, DOUBLE))})
    out = {n: VariableReferenceExpression(n, t) for n, t in (
        ("n_all", BIGINT), ("n_big", BIGINT), ("s_big", price.type))}
    return P.AggregationNode("masked_agg", proj, {
        out["n_all"]: P.Aggregation(CallExpression("count", BIGINT, [])),
        out["n_big"]: P.Aggregation(CallExpression("count", BIGINT, []),
                                    False, m),
        out["s_big"]: P.Aggregation(
            CallExpression("sum", price.type, [price]), False, m)},
        [prio], P.SINGLE)


def run_plan(runner, root):
    from ..exec.runner import pages_to_result
    comp = runner._new_compiler()
    src = comp.compile(root)
    res = pages_to_result(list(comp.run_to_pages(root)), src.names,
                          src.types)
    res.runtime_stats = {}
    return res


def trace(runner, sql, device) -> dict:
    """One run under torch.profiler: the traced wall, the device's busy
    time (its own kernel, copy and memset events) and idle share, and the
    device events per chunk of the torch chain."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    _sync(device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        res = runner.execute(sql)
        _sync(device)
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = [(e.self_device_time_total, e.count, e.key)
           for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(t for t, _c, _k in dev)
    events = sum(c for _t, c, _k in dev)
    info = chain_info(res)
    return {"wall_ms": wall_us / 1e3, "busy_ms": busy_us / 1e3,
            "idle_share": 1 - busy_us / wall_us, "device_events": events,
            "steps": info["steps"], "chunks": info["chunks"],
            "events_per_step": events / max(1, info["steps"]),
            "top": sorted(dev, reverse=True)[:8]}


def step_turns(runner, sql, runs, device) -> dict:
    """`sql`'s median wall with the chain's steps of CHAIN_STEP_ROWS rows
    and with steps of one scan chunk, in turns: steps, chunks, chunks,
    steps."""
    from ..exec import pipeline
    default = pipeline.CHAIN_STEP_ROWS
    out: Dict[str, List[float]] = {"steps": [], "chunks": []}
    try:
        for label in ("steps", "chunks", "chunks", "steps"):
            pipeline.CHAIN_STEP_ROWS = (default if label == "steps"
                                        else runner.config.batch_rows)
            _res, med = timed(runner, sql, runs, device)
            out[label].append(med * 1e3)
    finally:
        pipeline.CHAIN_STEP_ROWS = default
    return out


def run(runner, sf: float, runs: int, device, kernel_results=None,
        card: str = "") -> dict:
    """Every part of the module's docstring; returns the records.
    kernel_results: the kernel queries' QueryResults through the kernels
    (run here when absent)."""
    from ..exec.pipeline import tuned_config
    from ..exec.runner import LocalQueryRunner
    C = Columns(runner, sf)
    out: Dict[str, dict] = {}
    for name, sql in CHAIN_QUERIES.items():
        launches0 = _scan_launches()
        res, med = timed(runner, sql, runs, device)
        no_scan_kernel(name, res, launches0)
        info = chain_info(res)
        assert info["declined"] == ["JoinShape"], (name, info)
        assert info["modes"] and not info["streaming"], (name, info)
        {"q12": check_q12, "q14": check_q14, "q19": check_q19}[name](
            res.rows, C)
        out[name] = {"wall_ms": med * 1e3, "rows": res.rows, **info}
        print(f"  {name}: median wall {med * 1e3:.3f} ms over {runs} runs, "
              f"mode {info['modes']}, {info['passes']} pass(es) of "
              f"{info['chunks']} chunks in {info['steps']} steps, declined "
              f"{info['declined']}, rows {res.rows} == numpy {card}")
    forms = {}
    for name, sql in FORMS.items():
        # the first run meters the fusion decision (made once per compiled
        # plan) and warms the plan; the second is timed
        info = chain_info(runner.execute(sql))
        res, med = timed(runner, sql, 1, device, warm=False)
        forms[name] = res
        out[name] = {**chain_info(res), "wall_ms": med * 1e3,
                     "fusion_declined": info["fusion_declined"]}
    res = run_plan(runner, masked_plan(runner))
    forms["masked"] = res
    out["masked"] = {"rows": len(res.rows)}
    check_forms(forms, C)
    assert out["moments_corr"]["modes"] == ["SortAgg"], out["moments_corr"]
    assert out["approx_percentile"]["modes"] == ["SortAgg"]
    assert out["approx_distinct"]["fusion_declined"] == ["HllAgg"]
    assert out["approx_distinct"]["streaming"] == 1
    assert out["count_distinct"]["fusion_declined"] == ["PlanShape"]
    for name in FORMS:
        o = out[name]
        print(f"  {name}: wall {o['wall_ms']:.3f} ms, mode {o['modes']}, "
              f"streaming {o['streaming']}, declined {o['declined']}, "
              f"fusion declined {o['fusion_declined']} == numpy {card}")
    print(f"  masked: {out['masked']['rows']} groups == numpy")
    xla = LocalQueryRunner(runner.schema,
                           config=tuned_config(scan_kernel="xla"),
                           device=device)
    for name, sql in KERNEL_QUERIES.items():
        exp = (kernel_results or {}).get(name)
        if exp is None:
            exp = runner.execute(sql)
        launches0 = _scan_launches()
        got, med = timed(xla, sql, 1, device)
        no_scan_kernel("xla_" + name, got, launches0)
        info = chain_info(got)
        assert info["declined"] == ["Disabled"], (name, info)
        assert_rows_close(got, exp, ordered=False)
        out["xla_" + name] = {"wall_ms": med * 1e3, **info}
        print(f"  {name} under scan_kernel=xla: wall {med * 1e3:.3f} ms, "
              f"mode {info['modes']}, {info['chunks']} chunks in "
              f"{info['steps']} steps, rows == the kernel's {card}")
    tr = out["trace_q14"] = trace(runner, Q14, device)
    print(f"  q14 traced wall {tr['wall_ms']:.3f} ms, device busy "
          f"{tr['busy_ms']:.3f} ms, idle share {tr['idle_share']:.3f}, "
          f"{tr['device_events']} device events, "
          f"{tr['events_per_step']:.1f} per step ({tr['steps']} steps of "
          f"{tr['chunks']} chunks) {card}")
    for t, c, k in tr["top"]:
        print(f"    {t / 1e3:9.3f} ms  x{c:<5d} {k[:90]}")
    turns = out["steps_q14"] = step_turns(runner, Q14, runs, device)
    print(f"  q14 median walls in turns (ms): steps of "
          f"{runner.config.batch_rows} rows {turns['chunks']}, of "
          f"CHAIN_STEP_ROWS {turns['steps']} {card}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sf", default="10")
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    from ..exec.runner import LocalQueryRunner
    device = torch.device(args.device)
    runner = LocalQueryRunner(f"sf{args.sf}", device=device)
    run(runner, float(args.sf), args.runs, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
