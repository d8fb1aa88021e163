"""TPC-H beyond the resident store and under a memory budget, on a device.

    python -m presto_tpu_torch.benchmarks.scale_run [--phase all]
        [--sf100 100] [--sf 10] [--device cuda]
    python -m presto_tpu_torch.benchmarks.scale_run --trace-peak 12

Four phases, each through LocalQueryRunner (chip_smoke.py runs all
four):

  * `sf100`: SF100 TPC-H, unbudgeted, with the store's defaults (6 GiB,
    1 GiB per column): every lineitem column and every orders column but
    o_orderdate are over the per-column cap (a column that is neither a
    date nor INT_ARRAY is sized at 8 bytes a row), so they are generated
    on the fly per chunk.  Q1, Q3, Q5, Q6, Q11, Q12, Q14, Q18 and Q19
    (the queries with no whole-column host string pass), one fresh
    runner per query (the structural build cache is unbounded under an
    unlimited pool): the cold
    wall, the median warm wall, the modes, declines and kernel launches,
    the grouped lifespans (whether they engaged, groupedRunWallNanos > 0;
    how many; the gen and compute walls), and the device's peak memory
    (torch.cuda.max_memory_allocated over the query's runs), which must
    stay within PEAK_SHARE of the card; then the store's resident and
    rejected columns.  Under auto, Q3 and Q18 (grouped by an orderkey,
    whose 150 M-key span passes grouped.AUTO_SPAN_THRESHOLD) must engage
    lifespans and the others must not (LIFESPAN_QUERIES); Q3 once more
    with grouped_lifespans=1 (the whole-table path) must give the same
    rows.  Q1, Q6 and Q18 are held to plain chunked torch computations
    over device_gen.column's values (plain_q1 / plain_q6 / plain_q18,
    sharing no code with the chain): sums and counts exact, each average
    within half a unit of its scale of sum / count; Q18's orders, prices,
    dates, customers and quantity sums exact in the same top-100 order.
    Q11 must launch a scan kernel, or its decline is printed.
  * `lifespans`: at --sf, Q3, Q18 and the reference test's Q18 shape
    with grouped_lifespans=4 (and once more with
    grouped_prefetch_depth=0) equal to their unforced rows; Q1 and the
    reference test's o_orderstatus query with task_concurrency=4 and
    fuse_pipelines=False equal to their single-driver rows, with each
    split driver's wall.
  * `onthefly`: Q1, Q6, Q14 and Q18 at --sf with storage_enabled=False,
    equal to the resident runner's rows of the same call; the scan
    kernels meter kernelDeclinedColumnsNotResident.
  * `budgeted`: Q1, Q3, Q5, Q9, Q13, Q18 and Q21 at --sf under
    memory_budget_bytes (query.max-memory-per-node, BUDGET = 48 MiB;
    the reference's ExecutionConfig defaults otherwise: 1M-row batches),
    equal to the
    unbudgeted rows of the same call, with their spill bytes, spill and
    unspill walls and overlap fraction; spillBytes > 0 for Q3 (the grace
    join) and Q18; Q18 once more with a small spill_budget_bytes and a
    spill_path under build/ (the disk tier round trip: spillDiskBytes and
    unspillBytes > 0, the same rows) (run_budgeted); W1 under a budget
    its window kernel reservation fits and one that declines
    WindowInputSize, both equal to the unbudgeted rows
    (run_window_budgets); Q18 under FAULT_BUDGET, which records whether
    the reference behaviour of ROADMAP section 3 (a budgeted aggregation's
    table grows unreserved and runs out of retries), which the port
    mirrors, still raises (q18_fault_outcome).

`--trace-peak Q` runs only query Q at --sf100 once with the CUDA
allocator's history on, and prints what is live at its peak by the
port's source line (trace_peak).

Any mismatch raises.
"""
from __future__ import annotations

import argparse
import gc
import os
import shutil
import time
from decimal import Decimal
from typing import Dict

import numpy as np
import torch

from .rows import assert_rows_close
from .tpch_queries import ORDERED, queries_for_sf
from .tpch_run import _launches, _sync, _wall, modes

SF100_QUERIES = (1, 3, 5, 6, 11, 12, 14, 18, 19)
# the SF100 queries whose aggregation is grouped by an orderkey: under
# auto their lifespans engage at SF100, and no other query's do
LIFESPAN_QUERIES = (3, 18)
# the reference tests' shapes (tests/test_grouped.py,
# tests/test_local_exchange.py) for the forced-lifespan and driver checks
Q18_SHAPE = """
select l_orderkey, o_orderdate, o_totalprice, sum(l_quantity) q
from lineitem join orders on l_orderkey = o_orderkey
group by l_orderkey, o_orderdate, o_totalprice
having sum(l_quantity) > 150
order by o_totalprice desc, o_orderdate limit 20
"""
ORDERSTATUS = ("select o_orderstatus, count(*), sum(o_totalprice) "
               "from orders group by o_orderstatus")
FORCED_LIFESPANS = 4
DRIVERS = 4
ONTHEFLY_QUERIES = (1, 6, 14, 18)
BUDGETED_QUERIES = (1, 3, 5, 9, 13, 18, 21)
# query.max-memory-per-node for the budgeted phase: at SF10 under Q3's
# join build (358 MB reserved at 512 MiB, no spill) and under the 52 MiB
# table (2^20 slots) of Q18's 15 M-group l_orderkey aggregation, so Q3
# spills through the grace join and Q18 through the partitioned
# aggregation (at 96 MiB that table fits its first reservation, and its
# in-place retries end at "collision retries exhausted": FAULT_BUDGET)
BUDGET = 48 << 20
# between Q18's first aggregation table at SF10 (2^20 slots of 52 B, 52
# MiB) and its doubled one: the budget where the reference behaviour the
# port mirrors shows (q18_fault_outcome)
FAULT_BUDGET = 96 << 20
# the disk tier's host budget for the second Q18 run
DISK_TIER_HOST_BYTES = 64 << 20
# W1's budgets: one its window launch fits in, one it does not
WINDOW_FITS = 16 << 30
WINDOW_DECLINES = 64 << 20
# the share of the card's memory an SF100 query may peak at
PEAK_SHARE = 0.9
RTOL = 1e-9
PLAIN_CHUNK = 1 << 24


def _stat(res, key: str) -> float:
    return float((res.runtime_stats or {}).get(key, {}).get("sum", 0))


def lifespans(res) -> dict:
    """Whether grouped lifespans engaged (groupedRunWallNanos > 0), how
    many buckets were aggregated, and the gen / compute / run walls."""
    rs = res.runtime_stats or {}
    return {"engaged": _stat(res, "groupedRunWallNanos") > 0,
            "lifespans": int(rs.get("groupedBucketComputeWallNanos",
                                    {}).get("count", 0)),
            "gen_s": _stat(res, "groupedBucketGenWallNanos") / 1e9,
            "compute_s": _stat(res, "groupedBucketComputeWallNanos") / 1e9,
            "run_s": _stat(res, "groupedRunWallNanos") / 1e9}


# -- plain chunked computations over device_gen.column ---------------------

def _chunks(sf: float, device, chunk: int = PLAIN_CHUNK):
    from ..connectors import catalog
    n = catalog.table_row_count("lineitem", sf, "tpch")
    for lo in range(0, n, chunk):
        yield torch.arange(lo, min(n, lo + chunk), dtype=torch.int64,
                           device=device)


def _col(name: str, sf: float, idx):
    from ..connectors import device_gen
    return device_gen.column("tpch", "lineitem", name, sf, idx) \
        .to(torch.int64)


def _day(iso: str) -> int:
    return int(np.datetime64(iso, "D").astype(np.int64))


def plain_q6(sf: float, device) -> int:
    """Q6's unscaled revenue (scale 4)."""
    lo, hi = _day("1994-01-01"), _day("1995-01-01")
    total = torch.zeros((), dtype=torch.int64, device=device)
    for idx in _chunks(sf, device):
        ship = _col("shipdate", sf, idx)
        disc = _col("discount", sf, idx)
        qty = _col("quantity", sf, idx)
        sel = (ship >= lo) & (ship < hi) & (disc >= 5) & (disc <= 7) \
            & (qty < 2400)
        price = _col("extendedprice", sf, idx)
        total += torch.where(sel, price * disc, 0).sum()
    return int(total)  # lint: allow-host-sync


def plain_q1(sf: float, device) -> Dict[tuple, list]:
    """Q1 per (returnflag, linestatus): [sum_qty (scale 2), sum_base_price
    (2), sum_disc_price (4), sum_charge (6), sum of discounts (2), count],
    unscaled integers."""
    from ..connectors import device_gen
    cutoff = _day("1998-09-02")
    acc = torch.zeros((6, 6), dtype=torch.int64, device=device)
    for idx in _chunks(sf, device):
        live = _col("shipdate", sf, idx) <= cutoff
        g = _col("returnflag", sf, idx) * 2 + _col("linestatus", sf, idx)
        g = torch.where(live, g, 6)
        qty = _col("quantity", sf, idx)
        price = _col("extendedprice", sf, idx)
        disc = _col("discount", sf, idx)
        tax = _col("tax", sf, idx)
        disc_price = price * (100 - disc)
        parts = (qty, price, disc_price, disc_price * (100 + tax), disc,
                 torch.ones_like(qty))
        for j, v in enumerate(parts):
            acc[:, j] += torch.zeros(7, dtype=torch.int64, device=device) \
                .index_add_(0, g, v)[:6]
    flags = device_gen.dictionary("tpch", "lineitem", "returnflag")
    stats = device_gen.dictionary("tpch", "lineitem", "linestatus")
    out = {}
    for code, row in enumerate(acc.tolist()):  # lint: allow-host-sync
        if row[5]:
            out[(flags[code // 2], stats[code % 2])] = row
    return out


def plain_q18(sf: float, device, limit: int = 100) -> list:
    """Q18's rows without the customer name: (o_orderkey, o_custkey,
    o_orderdate day, o_totalprice unscaled, sum(l_quantity) unscaled) of
    the orders whose lines' quantities sum past 300, by o_totalprice
    descending and o_orderdate: the quantities summed per orderkey into
    an int64 array of one slot per order (orderkeys are dense)."""
    from ..connectors import catalog, device_gen
    n_orders = catalog.table_row_count("orders", sf, "tpch")
    qty = torch.zeros(n_orders + 1, dtype=torch.int64, device=device)
    for idx in _chunks(sf, device):
        qty.index_add_(0, _col("orderkey", sf, idx), _col("quantity", sf,
                                                          idx))
    okeys = torch.nonzero(qty > 300 * 100).flatten()
    rows = okeys - 1

    def ocol(name):
        return device_gen.column("tpch", "orders", name, sf, rows) \
            .to(torch.int64)
    price, day, cust = ocol("totalprice"), ocol("orderdate"), ocol("custkey")
    host = [a.tolist() for a in (  # lint: allow-host-sync
        okeys, cust, day, price, qty[okeys])]
    out = sorted(zip(*host),
                 key=lambda r: (-r[3], r[2]))
    return out[:limit]


def check_q18(res, want: list) -> None:
    assert len(res.rows) == len(want), (len(res.rows), len(want))
    epoch = np.datetime64("1970-01-01", "D")
    for r, w in zip(res.rows, want):
        day = int((np.datetime64(str(r[3]), "D") - epoch)
                  .astype(np.int64))
        got = (r[2], r[1], day, int(r[4].scaleb(2)), int(r[5].scaleb(2)))
        assert got == w and r[4].scaleb(2) == got[3] \
            and r[5].scaleb(2) == got[4], (r, w)


def check_q1(res, want: Dict[tuple, list]) -> None:
    got = {(r[0], r[1]): r for r in res.rows}
    assert set(got) == set(want), (sorted(got), sorted(want))
    for key, w in want.items():
        r = got[key]
        sums = [r[2].scaleb(2), r[3].scaleb(2), r[4].scaleb(4),
                r[5].scaleb(6)]
        assert [int(x) for x in sums] == w[:4] and all(
            x == int(x) for x in sums), (key, r, w)
        assert r[9] == w[5], (key, r, w)
        for avg, total, scale in ((r[6], w[0], 2), (r[7], w[1], 2),
                                  (r[8], w[4], 2)):
            # the average is rounded to its own scale
            exact = Decimal(total).scaleb(-scale) / Decimal(w[5])
            half = Decimal(5).scaleb(avg.as_tuple().exponent - 1)
            assert abs(avg - exact) <= half, (key, avg, exact)


# -- the phases ------------------------------------------------------------

def _peak_reset(device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _peak(device) -> int:
    return (int(torch.cuda.max_memory_allocated(device))
            if device.type == "cuda" else 0)


def check_headroom(q: int, peak: int, device) -> None:
    """A query's peak must leave the card PEAK_SHARE's margin: nearer the
    card's size, whether a run fails with a CUDA OOM depends on what the
    process still holds from earlier work (phase order, the store)."""
    if device.type != "cuda":
        return
    total = torch.cuda.get_device_properties(device).total_memory
    assert peak <= PEAK_SHARE * total, (
        f"Q{q} peaks at {peak} B, past {PEAK_SHARE:.0%} of the card's "
        f"{total} B")


def run_sf100(sf: float, device, card: str = "", warm: int = 2,
              queries=SF100_QUERIES, whole_q3: bool = True,
              warm_queries=None) -> dict:
    from ..connectors import catalog, device_gen
    from ..exec.grouped import AUTO_SPAN_THRESHOLD
    from ..exec.pipeline import tuned_config
    from ..exec.runner import LocalQueryRunner
    from ..storage import get_store
    from ..storage.store import STORAGE_METRICS
    schema = f"sf{sf:g}"
    qs = queries_for_sf(sf)
    out: Dict[str, dict] = {}
    results = {}
    for q in queries:
        # the previous query's runner holds its builds in reference
        # cycles (compiled sources and their closures): collect them, so
        # each query's peak is its own
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        runner = LocalQueryRunner(schema, device=device)
        _sync(device)
        _peak_reset(device)
        before = _launches()
        first, cold = _wall(runner, qs[q], device)
        launched = {k: v - before[k] for k, v in _launches().items()
                    if v != before[k]}
        walls = []
        for _ in range(warm if warm_queries is None or q in warm_queries
                       else 0):
            res, w = _wall(runner, qs[q], device)
            walls.append(w)
            assert_rows_close(res, first, ordered=q in ORDERED, rtol=RTOL)
        results[q] = first
        check_headroom(q, _peak(device), device)
        rec = out[f"q{q}"] = {
            "rows": len(first.rows), "cold_s": cold,
            "warm_ms": float(np.median(walls)) * 1e3 if walls else None,
            "peak_bytes": _peak(device), "launched": launched,
            "grouped": lifespans(first), **modes(first)}
        warm_txt = ("no warm run" if not walls else
                    f"warm median {rec['warm_ms']:.3f} ms ({len(walls)} "
                    f"runs)")
        gr = rec["grouped"]
        print(f"  {schema} Q{q}: {rec['rows']} rows, cold {cold:.3f} s, "
              f"{warm_txt}, peak "
              f"device memory {rec['peak_bytes']} B, kernel programs "
              f"{rec['kernel_programs']}, chain {rec['chain']}, streaming "
              f"{rec['streaming']}, launched {launched}, declined "
              f"{rec['declined']}, lifespans engaged {gr['engaged']} "
              f"({gr['lifespans']} on the cold run, gen {gr['gen_s']:.3f} "
              f"s, compute {gr['compute_s']:.3f} s, run {gr['run_s']:.3f} "
              f"s) {card}", flush=True)
        if catalog.table_row_count("orders", sf, "tpch") \
                > AUTO_SPAN_THRESHOLD:
            assert gr["engaged"] == (q in LIFESPAN_QUERIES), (q, gr)
        del runner
        if q == 3 and whole_q3:
            # the whole-table path (no lifespans) for the same rows
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
            whole = LocalQueryRunner(schema, device=device,
                                     config=tuned_config(grouped_lifespans=1))
            _sync(device)
            _peak_reset(device)
            got, wall = _wall(whole, qs[q], device)
            assert_rows_close(got, first, ordered=True, rtol=RTOL)
            assert not lifespans(got)["engaged"]
            check_headroom(q, _peak(device), device)
            out["whole_q3"] = {"cold_s": wall, "peak_bytes": _peak(device)}
            print(f"  {schema} Q3 with grouped_lifespans=1: cold "
                  f"{wall:.3f} s, peak device memory {_peak(device)} B, "
                  f"rows == the lifespans' rows {card}", flush=True)
            del whole
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    probe = LocalQueryRunner(schema, device=device)
    cfg = probe.config
    store = get_store(cfg.storage_budget_bytes, cfg.storage_max_column_bytes,
                      probe.device)
    resident = sorted(f"{k[1]}.{k[2]}" for k in store.entries)
    # the store's per-column rule (storage/store.py get_or_build): a
    # column whose padded plain bytes pass the cap is never built
    rejected = []
    for table in ("lineitem", "orders", "customer", "part", "partsupp",
                  "supplier"):
        n = catalog.table_row_count(table, sf, "tpch")
        for c, _t in catalog.schema(table, "tpch"):
            if not device_gen.supported("tpch", table, c) \
                    or (table, c) in catalog.OPEN_DOMAIN:
                continue
            as_i32 = (c.endswith("date") or catalog.column_type(
                table, c, "tpch").storage == "INT_ARRAY")
            if (n + cfg.batch_rows) * (4 if as_i32 else 8) \
                    > cfg.storage_max_column_bytes:
                rejected.append(f"{table}.{c}")
    out["store"] = {"resident": resident, "rejected": rejected,
                    "resident_bytes": store.pool.reserved,
                    "build_rejected": STORAGE_METRICS.snapshot()[
                        "build_rejected"]}
    print(f"  store at {schema}: {store.pool.reserved} B resident in "
          f"{len(resident)} columns {resident}; over the per-column cap "
          f"{cfg.storage_max_column_bytes} B, generated on the fly: "
          f"{rejected} {card}")
    if 1 in results:
        t0 = time.perf_counter()
        check_q1(results[1], plain_q1(sf, device))
        print(f"  {schema} Q1 == plain chunked torch over device_gen "
              f"({time.perf_counter() - t0:.3f} s)")
    if 6 in results:
        t0 = time.perf_counter()
        want = plain_q6(sf, device)
        got = results[6].rows[0][0].scaleb(4)
        assert got == int(got) and int(got) == want, (got, want)
        print(f"  {schema} Q6 unscaled revenue {want} == plain chunked "
              f"torch ({time.perf_counter() - t0:.3f} s)")
    if 18 in results:
        t0 = time.perf_counter()
        check_q18(results[18], plain_q18(sf, device))
        print(f"  {schema} Q18's {len(results[18].rows)} rows == plain "
              f"chunked torch over device_gen "
              f"({time.perf_counter() - t0:.3f} s)")
    if 11 in results:
        q11 = out["q11"]
        if q11["kernel_programs"]:
            print(f"  {schema} Q11 launched {q11['launched']}")
        else:
            print(f"  {schema} Q11 launched no scan kernel: declined "
                  f"{q11['declined']}, fusion declined "
                  f"{q11['fusion_declined']}")
    return out


def _with_node_stats(runner, sql):
    """The query through a compiler of the runner's config whose
    per-node operator stats are on (TaskContext.stats): its result and
    the scans' driver walls.  Those stats also turn on EXPLAIN ANALYZE's
    per-node instrumentation (PlanCompiler._instrument), so the driver
    walls are walls under ANALYZE."""
    from ..exec.pipeline import PlanCompiler, TaskContext
    from ..exec.runner import pages_to_result
    from ..spi import plan as P
    from ..sql import parser as A
    from ..sql.planner import Planner
    output = Planner(default_schema=runner.schema, default_catalog="tpch") \
        .plan_query_to_output(A.parse_sql(sql))
    comp = PlanCompiler(TaskContext(config=runner.config,
                                    device=runner.device, stats={}))
    res = pages_to_result(comp.run_to_pages(output), output.column_names,
                          [v.type for v in output.outputs])
    walls = [comp.ctx.stats[n.id]["driver_walls"]
             for n in P.walk_plan(output)
             if isinstance(n, P.TableScanNode)
             and "driver_walls" in comp.ctx.stats.get(n.id, {})]
    return res, walls


def run_lifespans(sf: float, device, card: str = "") -> dict:
    """Forced lifespans and scan drivers at `sf`: rows against the
    unforced and single-driver rows of the same call."""
    from ..exec.pipeline import tuned_config
    from ..exec.runner import LocalQueryRunner
    schema = f"sf{sf:g}"
    qs = queries_for_sf(sf)
    out = {}
    free = LocalQueryRunner(schema, device=device)
    forced = {d: LocalQueryRunner(schema, device=device, config=tuned_config(
        grouped_lifespans=FORCED_LIFESPANS, grouped_prefetch_depth=d))
        for d in (1, 0)}
    for name, sql in (("q3", qs[3]), ("q18", qs[18]),
                      ("q18_shape", Q18_SHAPE)):
        want, wall = _wall(free, sql, device)
        assert not lifespans(want)["engaged"], name
        rec = out[name] = {"unforced_s": wall}
        for d, r in forced.items():
            got, wall = _wall(r, sql, device)
            assert_rows_close(got, want, ordered=True, rtol=RTOL)
            gr = lifespans(got)
            assert gr["engaged"] and gr["lifespans"] >= FORCED_LIFESPANS, gr
            rec[f"depth{d}"] = {"wall_s": wall, **gr}
        d1, d0 = rec["depth1"], rec["depth0"]
        print(f"  {schema} {name} with grouped_lifespans="
              f"{FORCED_LIFESPANS}: == unforced rows; wall unforced "
              f"{rec['unforced_s']:.3f} s, prefetch depth 1 "
              f"{d1['wall_s']:.3f} s ({d1['lifespans']} lifespans, gen "
              f"{d1['gen_s']:.3f} s, compute {d1['compute_s']:.3f} s, run "
              f"{d1['run_s']:.3f} s), depth 0 {d0['wall_s']:.3f} s (run "
              f"{d0['run_s']:.3f} s) {card}", flush=True)
    serial = LocalQueryRunner(schema, device=device,
                              config=tuned_config(fuse_pipelines=False))
    drivers = LocalQueryRunner(schema, device=device, config=tuned_config(
        fuse_pipelines=False, task_concurrency=DRIVERS))
    for name, sql in (("q1", qs[1]), ("orderstatus", ORDERSTATUS)):
        want, w_serial = _wall(serial, sql, device)
        got, w_drv = _wall(drivers, sql, device)
        assert_rows_close(got, want, ordered=False, rtol=RTOL)
        res, walls = _with_node_stats(drivers, sql)
        assert_rows_close(res, want, ordered=False, rtol=RTOL)
        assert walls and all(len(w) > 1 for w in walls), walls
        out[f"drivers_{name}"] = {"serial_s": w_serial, "drivers_s": w_drv,
                                  "driver_walls": walls}
        print(f"  {schema} {name} with task_concurrency={DRIVERS}, "
              f"fuse_pipelines=False: == single-driver rows; wall "
              f"{w_drv:.3f} s against {w_serial:.3f} s single; driver "
              f"walls (s, under ANALYZE) per scan {walls} {card}",
              flush=True)
    return out


def run_onthefly(sf: float, device, card: str = "",
                 queries=ONTHEFLY_QUERIES, resident_rows=None) -> dict:
    """`resident_rows` ({query: QueryResult}) are resident rows of the
    same call (tpch_run's); a query without them runs resident here."""
    from ..exec.pipeline import tuned_config
    from ..exec.runner import LocalQueryRunner
    schema = f"sf{sf:g}"
    qs = queries_for_sf(sf)
    res_runner = LocalQueryRunner(schema, device=device)
    fly = LocalQueryRunner(schema, device=device,
                           config=tuned_config(storage_enabled=False))
    out = {}
    for q in queries:
        want = (resident_rows or {}).get(q)
        if want is None:
            want, _w = _wall(res_runner, qs[q], device)
        got, wall = _wall(fly, qs[q], device)
        assert_rows_close(got, want, ordered=q in ORDERED, rtol=RTOL)
        rec = out[f"q{q}"] = {"wall_s": wall, **modes(got)}
        assert rec["declined"].get("ColumnsNotResident"), rec
        print(f"  {schema} Q{q} on the fly: {wall:.3f} s == resident rows, "
              f"chain {rec['chain']}, streaming {rec['streaming']}, "
              f"declined {rec['declined']} {card}", flush=True)
    return out


def _spill_record(res, wall: float) -> dict:
    return {"wall_s": wall,
            "spill_bytes": _stat(res, "spillBytes"),
            "spill_disk_bytes": _stat(res, "spillDiskBytes"),
            "unspill_bytes": _stat(res, "unspillBytes"),
            "spill_stage_s": _stat(res, "spillStageWallNanos") / 1e9,
            "spill_wait_s": _stat(res, "spillWaitWallNanos") / 1e9,
            "unspill_s": _stat(res, "unspillWallNanos") / 1e9,
            "overlap": (1.0 - _stat(res, "spillWaitWallNanos")
                        / _stat(res, "spillStageWallNanos")
                        if _stat(res, "spillStageWallNanos") else None),
            "peak_reserved": res.peak_memory_bytes}


def run_budgeted(sf: float, device, card: str = "",
                 queries=BUDGETED_QUERIES, budget: int = BUDGET,
                 spill_dir: str = "build/spill",
                 disk_host_bytes: int = DISK_TIER_HOST_BYTES,
                 free_rows=None) -> dict:
    """`queries` under `budget`, and Q18 through the disk tier when it is
    one of them.  `free_rows` ({query: QueryResult}) are unbudgeted rows
    of the same call (tpch_run's); a query without them runs unbudgeted
    here."""
    from ..exec.pipeline import ExecutionConfig
    from ..exec.runner import LocalQueryRunner

    schema = f"sf{sf:g}"
    qs = queries_for_sf(sf)
    free = LocalQueryRunner(schema, device=device)
    # every budgeted runner keeps the reference's ExecutionConfig defaults
    # (1M-row batches, 2M-row join output): a budgeted query streams its
    # operators batch by batch, and a 64K-row batch pays the same host
    # dispatch as a 1M-row one
    tight = LocalQueryRunner(schema, device=device, config=ExecutionConfig(
        memory_budget_bytes=budget))
    print(f"  memory_budget_bytes {budget} (query.max-memory-per-node) "
          f"{card}")
    out = {}
    free_rows = dict(free_rows or {})
    for q in queries:
        if q not in free_rows:
            free_rows[q] = _wall(free, qs[q], device)[0]
    for q in queries:
        want = free_rows[q]
        _peak_reset(device)
        got, wall = _wall(tight, qs[q], device)
        assert_rows_close(got, want, ordered=q in ORDERED, rtol=RTOL)
        rec = out[f"q{q}"] = {"peak_bytes": _peak(device),
                              **_spill_record(got, wall), **modes(got)}
        if q in (3, 18):
            assert rec["spill_bytes"] > 0, (q, rec)
        print(f"  {schema} Q{q} budgeted: {wall:.3f} s == unbudgeted "
              f"rows, spilled "
              f"{rec['spill_bytes']:.0f} B, stage {rec['spill_stage_s']:.3f}"
              f" s, wait {rec['spill_wait_s']:.3f} s, overlap "
              f"{rec['overlap']}, peak reserved {rec['peak_reserved']} B, "
              f"peak device {rec['peak_bytes']} B, streaming "
              f"{rec['streaming']}, declined {rec['declined']} {card}",
              flush=True)
    if 18 in queries:
        # the disk tier: host staging past a small budget overflows to
        # LZ4 files under spill_dir
        shutil.rmtree(spill_dir, ignore_errors=True)
        disk = LocalQueryRunner(schema, device=device, config=ExecutionConfig(
            memory_budget_bytes=budget,
            spill_budget_bytes=disk_host_bytes,
            spill_path=spill_dir))
        want = free_rows[18]
        got, wall = _wall(disk, qs[18], device)
        assert_rows_close(got, want, ordered=True, rtol=RTOL)
        rec = out["q18_disk"] = _spill_record(got, wall)
        assert rec["spill_disk_bytes"] > 0 and rec["unspill_bytes"] > 0, rec
        left = os.listdir(spill_dir) if os.path.isdir(spill_dir) else []
        print(f"  {schema} Q18 disk tier (host budget "
              f"{disk_host_bytes} B, spill_path {spill_dir}): "
              f"{wall:.3f} s == unbudgeted rows, disk "
              f"{rec['spill_disk_bytes']:.0f} B written, "
              f"{rec['unspill_bytes']:.0f} B read back in "
              f"{rec['unspill_s']:.3f} s, {len(left)} files left {card}",
              flush=True)
    return out


def run_window_budgets(sf: float, device, card: str = "",
                       budgets=(WINDOW_FITS, WINDOW_DECLINES)) -> dict:
    """W1 under a budget its window kernel reservation fits and one that
    declines WindowInputSize, each equal to the unbudgeted rows."""
    from ..exec.pipeline import ExecutionConfig
    from ..exec.runner import LocalQueryRunner
    from .window_queries import W1

    schema = f"sf{sf:g}"
    out = {}
    want, _w = _wall(LocalQueryRunner(schema, device=device), W1, device)
    for name, b, path in (("w1_fits", budgets[0], "kernelWindowPrograms"),
                          ("w1_declines", budgets[1],
                           "kernelDeclinedWindowInputSize")):
        r = LocalQueryRunner(schema, device=device,
                             config=ExecutionConfig(memory_budget_bytes=b))
        got, wall = _wall(r, W1, device)
        assert_rows_close(got, want, ordered=True, rtol=RTOL)
        assert _stat(got, path) == 1, (name, got.runtime_stats)
        out[name] = {"wall_s": wall, "budget": b, "path": path}
        print(f"  {schema} W1 under {b} B: {path}, {wall:.3f} s == "
              f"unbudgeted rows {card}", flush=True)
    return out


def q18_fault_outcome(schema: str, sql: str, want, device,
                      card: str = "", budget: int = FAULT_BUDGET) -> dict:
    """Q18 under a budget between its aggregation's first table and the
    doubled one (ROADMAP section 3, a reference behaviour the port
    mirrors): the first
    reservation fits, and the in-place collision retries grow the table
    past the budget without reserving it, as the reference's run_retrying
    does, until they end at "collision retries exhausted".  Either that
    error (the reference's behaviour) or the unbudgeted rows (repaired) is
    recorded; any other outcome raises."""
    from ..exec.pipeline import ExecutionConfig
    from ..exec.runner import LocalQueryRunner
    r = LocalQueryRunner(schema, device=device,
                         config=ExecutionConfig(memory_budget_bytes=budget))
    t0 = time.perf_counter()
    try:
        got, wall = _wall(r, sql, device)
    except RuntimeError as e:
        if "collision retries exhausted" not in str(e):
            raise
        wall = time.perf_counter() - t0
        outcome = f"raised {e!r} (the reference's behaviour)"
    else:
        assert_rows_close(got, want, ordered=True, rtol=RTOL)
        outcome = "== unbudgeted rows (no retry ran out)"
    print(f"  {schema} Q18 under {budget} B: {outcome}, {wall:.3f} s "
          f"{card}", flush=True)
    return {"budget": budget, "outcome": outcome, "wall_s": wall}


def trace_peak(sf: float, q: int, device, top: int = 12) -> dict:
    """One cold run of query `q` at `sf` with the CUDA caching allocator's
    history on (Python frames): the allocations live at the run's peak,
    summed by the innermost line of presto_tpu_torch that made each, and
    each such line's caller in the port."""
    from ..exec.runner import LocalQueryRunner
    mem = torch.cuda.memory
    gc.collect()
    torch.cuda.empty_cache()
    runner = LocalQueryRunner(f"sf{sf:g}", device=device)
    _sync(device)
    torch.cuda.reset_peak_memory_stats(device)
    base = int(torch.cuda.memory_allocated(device))
    mem._record_memory_history(enabled="all", context="alloc",
                               stacks="python")
    try:
        _wall(runner, queries_for_sf(sf)[q], device)
        snap = mem._snapshot()
    finally:
        mem._record_memory_history(enabled=None)
    events = snap["device_traces"][device.index or 0]

    def site(frames):
        mine = [f for f in frames if "presto_tpu_torch" in f["filename"]
                and "benchmarks" not in f["filename"]]
        return " <- ".join(
            f"{f['filename'].split('presto_tpu_torch/')[-1]}:{f['line']} "
            f"{f['name']}" for f in mine[:2]) or "outside the port"

    live, cur, peak, at = {}, 0, 0, -1
    for i, ev in enumerate(events):
        if ev["action"] == "alloc":
            live[ev["addr"]] = ev["size"]
            cur += ev["size"]
            if cur > peak:
                peak, at = cur, i
        elif ev["action"] == "free_completed":
            cur -= live.pop(ev["addr"], 0)
    held: Dict[int, dict] = {}
    for ev in events[:at + 1]:
        if ev["action"] == "alloc":
            held[ev["addr"]] = ev
        elif ev["action"] == "free_completed":
            held.pop(ev["addr"], None)
    by_site: Dict[str, list] = {}
    for ev in held.values():
        ent = by_site.setdefault(site(ev["frames"]), [0, 0])
        ent[0] += ev["size"]
        ent[1] += 1
    ranked = sorted(by_site.items(), key=lambda kv: -kv[1][0])[:top]
    rec = {"query": q, "sf": sf, "before_bytes": base,
           "peak_bytes": int(torch.cuda.max_memory_allocated(device)),
           "peak_in_trace_bytes": peak, "events": len(events),
           "sites": [{"site": k, "bytes": v[0], "allocations": v[1]}
                     for k, v in ranked]}
    print(f"  sf{sf:g} Q{q}: peak {rec['peak_bytes']} B "
          f"({base} B held before the run; {peak} B allocated during it "
          f"at its peak, {len(events)} allocator events); live at the "
          f"peak by site:")
    for ent in rec["sites"]:
        print(f"    {ent['bytes']:>14} B in {ent['allocations']:>5} "
              f"allocations: {ent['site']}")
    return rec


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase", default="all",
                    choices=("all", "sf100", "lifespans", "onthefly",
                             "budgeted"))
    ap.add_argument("--sf100", default="100")
    ap.add_argument("--sf", default="10")
    ap.add_argument("--warm", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--queries", default="",
                    help="comma-separated SF100 queries")
    ap.add_argument("--budget", type=int, default=BUDGET)
    ap.add_argument("--disk-host-bytes", type=int,
                    default=DISK_TIER_HOST_BYTES)
    ap.add_argument("--window-budgets", default=f"{WINDOW_FITS},"
                    f"{WINDOW_DECLINES}")
    ap.add_argument("--trace-peak", type=int, default=0, metavar="Q",
                    help="only trace query Q's peak device memory at "
                    "--sf100 (CUDA)")
    args = ap.parse_args()
    device = torch.device(args.device)
    if args.trace_peak:
        trace_peak(float(args.sf100), args.trace_peak, device)
        return 0
    qs = (tuple(int(q) for q in args.queries.split(","))
          if args.queries else SF100_QUERIES)
    if args.phase in ("all", "sf100"):
        run_sf100(float(args.sf100), device, warm=args.warm, queries=qs)
    if args.phase in ("all", "lifespans"):
        run_lifespans(float(args.sf), device)
    if args.phase in ("all", "onthefly"):
        run_onthefly(float(args.sf), device)
    if args.phase in ("all", "budgeted"):
        from ..exec.runner import LocalQueryRunner
        sf = float(args.sf)
        run_budgeted(sf, device, budget=args.budget,
                     disk_host_bytes=args.disk_host_bytes)
        run_window_budgets(sf, device, budgets=tuple(
            int(b) for b in args.window_budgets.split(",")))
        schema, sql = f"sf{sf:g}", queries_for_sf(sf)[18]
        want, _w = _wall(LocalQueryRunner(schema, device=device), sql,
                         device)
        q18_fault_outcome(schema, sql, want, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
