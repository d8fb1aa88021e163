"""The hive connector on a device: a Parquet / ORC warehouse written and
read through the port's entry points, REAL columns, and the window kernel
over a REAL key.

    python -m presto_tpu_torch.benchmarks.hive_run --sf 1 [--device cuda]

Runs (every failed check raises):
  * an etc directory whose catalog/hive.properties mounts a Parquet
    warehouse in a temporary directory (hive.warehouse.dir); through
    LocalQueryRunner: CREATE TABLE AS of lineitem's Q1 / Q6 columns
    (LINEITEM_COLUMNS, every row) and of orders' W1 columns; then the
    same catalog re-mounted with hive.storage-format=ORC for a second
    copy of orders as ORC parts;
  * one external Parquet file written with pyarrow and no presto_type
    metadata: lineitem's quantity, extendedprice and discount as float32
    (from the Parquet copy's scaled integers), which the connector maps
    to REAL;
  * Q1 and Q6 over the hive lineitem, W1 over both hive orders: rows
    equal to the same queries over the tpch catalog, run cold and warm
    once each there (decimals and integers exactly, doubles within rtol
    1e-12); the cold (first) and warm walls of each against the tpch
    catalog's; the hive scans are host columns, which no scan kernel
    launches over (a host scan has no device-generated leaf for a fused
    chain), and on a card the cold and the warm W1 over each hive copy
    launch the window kernel #6 (counted around those two runs alone);
  * REAL_SQL (a filter on the REAL columns, a REAL projection and
    sums): rows equal on the device and on the CPU port (min / max /
    counts exactly, the sums within rtol 1e-12: another summation
    order), and equal to numpy over the float32 values (the same
    tolerances; REAL arithmetic is typed DOUBLE by the planner, so numpy
    computes it in float64 of the float32 values);
  * REAL_WINDOW (rank() partitioned by a REAL column and ordered by
    another, row_number() ordered by a REAL column): on a card #6
    launches with float32 keys, and every launch's outputs equal
    `window_scan_plain` over the same sorted run on every row.
chip_smoke.py runs `run` as its hive phase.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from .rows import assert_rows_close
from .tpch_queries import Q1, Q6
from .tpch_run import _wall, modes
from .window_queries import W1

LINEITEM_COLUMNS = ("l_returnflag", "l_linestatus", "l_quantity",
                    "l_extendedprice", "l_discount", "l_tax", "l_shipdate")
ORDERS_COLUMNS = ("o_orderkey", "o_custkey", "o_totalprice", "o_orderdate")
REAL_COLUMNS = ("l_quantity", "l_extendedprice", "l_discount")
REAL_SQL = """
select count(*) as n, sum(l_extendedprice * l_discount) as revenue,
       sum(l_quantity) as qty, min(l_extendedprice) as lo,
       max(l_extendedprice) as hi, min(l_quantity * 2) as q2
from lineitem_real
where l_discount between 0.05 and 0.07 and l_quantity < 24
"""
REAL_WINDOW = """
select l_discount, l_quantity, rk, rn from (
  select l_discount, l_quantity,
         rank() over (partition by l_discount
                      order by l_quantity) as rk,
         row_number() over (order by l_extendedprice, l_quantity,
                            l_discount) as rn
  from lineitem_real) t
where rk <= 2 and rn <= 5000000
order by l_discount, l_quantity, rn
limit 200
"""
RTOL = 1e-12


def _etc(root: str, warehouse: str, storage_format: str) -> str:
    etc = os.path.join(root, f"etc-{storage_format.lower()}")
    os.makedirs(os.path.join(etc, "catalog"), exist_ok=True)
    with open(os.path.join(etc, "catalog", "hive.properties"), "w") as f:
        f.write(f"connector.name=hive\nhive.warehouse.dir={warehouse}\n"
                f"hive.storage-format={storage_format}\n")
    return etc


def ctas_sql(table: str, source: str, columns) -> str:
    return f"create table {table} as select {', '.join(columns)} " \
           f"from {source}"


def write_real_file(warehouse: str, table: str = "lineitem_h",
                    out: str = "lineitem_real") -> Dict[str, np.ndarray]:
    """REAL_COLUMNS as float32 in one external Parquet file (no
    presto_type metadata), from the Parquet copy's scaled integers;
    returns the float32 arrays."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    from ..connectors import catalog
    src = catalog.module("hive")._tables[table]
    arrays = {}
    for c in REAL_COLUMNS:
        values, nulls = src._read_full_column(c)
        assert nulls is None, c
        scale = 10.0 ** src.column_type(c).scale
        arrays[c] = (values / scale).astype(np.float32)
    os.makedirs(os.path.join(warehouse, out))
    pq.write_table(pa.table({c: pa.array(v) for c, v in arrays.items()}),
                   os.path.join(warehouse, out, "part-0.parquet"))
    catalog.module("hive").refresh()
    return arrays


def numpy_real(arrays: Dict[str, np.ndarray]) -> List:
    """REAL_SQL's row from numpy over the float32 values (comparisons and
    products in float64 of the float32 values, as the planner types
    them; min / max / the REAL projection in float32)."""
    q, e, d = (arrays[c] for c in REAL_COLUMNS)
    keep = (d.astype(np.float64) >= 0.05) & (d.astype(np.float64) <= 0.07) \
        & (q.astype(np.float64) < 24)
    e64 = e[keep].astype(np.float64)
    return [int(keep.sum()), float(np.sum(e64 * d[keep].astype(np.float64))),
            float(np.sum(q[keep].astype(np.float64))),
            float(e[keep].min()), float(e[keep].max()),
            float(np.min(q[keep].astype(np.float64) * 2))]


class _WindowCalls:
    """Records the window kernel wrapper's calls while active."""

    def __init__(self):
        from ..exec.kernels import window as wk
        self.wk, self.real, self.calls = wk, wk.window_scan, []

    def __enter__(self):
        def record(*a, **kw):
            self.calls.append(a)
            return self.real(*a, **kw)
        self.wk.window_scan = record
        return self

    def __exit__(self, *exc):
        self.wk.window_scan = self.real


def check_window_calls(calls) -> List[dict]:
    """Every recorded call's kernel outputs against window_scan_plain on
    the same sorted run, value for value and null for null."""
    from ..exec.kernels import window as wk
    out = []
    for a in calls:
        mask, arrays, parts, orderings, specs = a
        got, plain = wk.window_scan(*a), wk.window_scan_plain(*a)
        for spec, (kv, kn), (pv, pn) in zip(specs, got, plain):
            assert torch.equal(kv, pv), f"{spec.output} differs from plain"
            assert (kn is None) == (pn is None) and (
                kn is None or torch.equal(kn, pn)), spec.output
        out.append({"rows": int(mask.numel()),
                    "keys": {nm: str(v.dtype).replace("torch.", "")
                             for nm, (v, _n) in arrays.items()},
                    "partition": list(parts),
                    "order": [o for o, _ in orderings],
                    "specs": [s.name for s in specs]})
    return out


def run(sf: float, device, card: str = "") -> dict:
    """Every part of the module's docstring; returns the records."""
    from ..connectors import catalog
    from ..exec.kernels import scan_kernel as sk
    from ..exec.runner import LocalQueryRunner
    from ..worker.properties import register_catalogs_from_etc
    writable = [c for c in catalog._CONNECTORS
                if hasattr(catalog.module(c), "begin_write")]
    assert not writable, f"a writable catalog is mounted already: {writable}"
    root = tempfile.mkdtemp(prefix="hive_run_")
    warehouse = os.path.join(root, "warehouse")
    schema = f"sf{sf:g}"
    rec: Dict[str, object] = {"walls": {}}
    walls = rec["walls"]
    t_phase = time.perf_counter()
    try:
        assert register_catalogs_from_etc(
            _etc(root, warehouse, "PARQUET")) == {"hive": "hive"}
        runner = LocalQueryRunner(schema, device=device)
        for table, source, columns in (
                ("lineitem_h", "lineitem", LINEITEM_COLUMNS),
                ("orders_h", "orders", ORDERS_COLUMNS)):
            res, walls[f"ctas_{table}"] = _wall(
                runner, ctas_sql(table, source, columns), device)
            rec[f"rows_{table}"] = res.rows[0][0]
        # the same catalog mounted again with ORC parts
        assert register_catalogs_from_etc(
            _etc(root, warehouse, "ORC")) == {"hive": "hive"}
        res, walls["ctas_orders_orc"] = _wall(
            runner, ctas_sql("orders_orc", "orders", ORDERS_COLUMNS), device)
        rec["rows_orders_orc"] = res.rows[0][0]
        tdir = os.path.join(warehouse, "orders_orc")
        assert all(f.endswith(".orc") for f in os.listdir(tdir)), tdir
        t0 = time.perf_counter()
        arrays = write_real_file(warehouse)
        walls["write_real_file"] = time.perf_counter() - t0
        assert str(catalog.column_type("lineitem_real", "l_quantity",
                                       "hive")) == "real"
        n_li = runner.execute("select count(*) from lineitem").rows[0][0]
        assert rec["rows_lineitem_h"] == n_li, (rec, n_li)

        # Q1, Q6 over hive lineitem; W1 over both hive orders: rows equal
        # to the tpch catalog's (one cold and one warm run of each query
        # there, shared by both hive copies of orders), cold and warm
        # walls against its
        refs, before_w = {}, sk.LAUNCHES["window_scan"]
        for name, sql in (("q1", Q1), ("q6", Q6), ("w1", W1)):
            cold_t, walls[f"{name}_tpch_cold"] = _wall(runner, sql, device)
            refs[name], walls[f"{name}_tpch_warm"] = _wall(runner, sql,
                                                           device)
            assert_rows_close(cold_t, refs[name], ordered=True, rtol=RTOL)
        rec["tpch_window_launches"] = sk.LAUNCHES["window_scan"] - before_w
        rec["hive_window_launches"] = {}
        cases = (("q1", "q1", Q1, "lineitem", "lineitem_h"),
                 ("q6", "q6", Q6, "lineitem", "lineitem_h"),
                 ("w1", "w1", W1, "orders", "orders_h"),
                 ("w1_orc", "w1", W1, "orders", "orders_orc"))
        for name, ref, sql, src, table in cases:
            hive_sql = sql.replace(f"from {src}", f"from {table}")
            assert hive_sql != sql, name
            scans = {k: sk.LAUNCHES[k] for k in sk.SCAN_KERNELS}
            before_w = sk.LAUNCHES["window_scan"]
            cold_h, walls[f"{name}_hive_cold"] = _wall(runner, hive_sql,
                                                       device)
            warm_h, walls[f"{name}_hive_warm"] = _wall(runner, hive_sql,
                                                       device)
            # host columns: no scan kernel ever sees them (the scan has
            # no device-generated leaf to fuse; chain_eligible's
            # ColumnsNotResident gate stands behind that)
            assert scans == {k: sk.LAUNCHES[k] for k in sk.SCAN_KERNELS}, \
                (name, scans)
            if ref == "w1":
                n = sk.LAUNCHES["window_scan"] - before_w
                rec["hive_window_launches"][name] = n
                if device.type == "cuda":
                    # the cold and the warm run over this copy launch #6
                    assert n >= 2, (name, n)
            for got in (cold_h, warm_h):
                assert_rows_close(got, refs[ref], ordered=True, rtol=RTOL)
            m = modes(warm_h)
            rec[name] = {"rows": len(warm_h.rows), "declined": m["declined"],
                         "chain": m["chain"], "streaming": m["streaming"]}

        # REAL: the device, the CPU port and numpy agree
        real, walls["real_cold"] = _wall(runner, REAL_SQL, device)
        real_warm, walls["real_warm"] = _wall(runner, REAL_SQL, device)
        cpu = LocalQueryRunner(schema, device="cpu").execute(REAL_SQL)
        want = numpy_real(arrays)
        for got in (real_warm, cpu):
            assert_rows_close(real, got, ordered=True, rtol=RTOL)
        assert real.rows[0][0] == want[0] and real.rows[0][3:5] == \
            want[3:5], (real.rows, want)
        for j in (1, 2, 5):
            assert abs(real.rows[0][j] - want[j]) <= RTOL * abs(want[j]), \
                (j, real.rows, want)
        rec["real"] = {"row": real.rows[0], "numpy": want}

        # #6 over REAL keys, every launch equal to its plain version
        before_w = sk.LAUNCHES["window_scan"]
        with _WindowCalls() as wc:
            res, walls["real_window"] = _wall(runner, REAL_WINDOW, device)
        rec["real_window_launches"] = sk.LAUNCHES["window_scan"] - before_w
        # the phase's launches, before the comparison's own
        rec["launches"] = dict(sk.LAUNCHES)
        rec["join_launches"] = sum(sk.JOIN_LAUNCHES.values())
        rec["real_window_calls"] = check_window_calls(wc.calls)
        rec["real_window_rows"] = len(res.rows)
        assert res.rows and all(r[2] <= 2 for r in res.rows), res.rows[:5]
        if device.type == "cuda":
            assert rec["real_window_launches"] >= 2 and any(
                "float32" in c["keys"].values()
                for c in rec["real_window_calls"]), rec
    finally:
        catalog.unregister_connector("hive")
        shutil.rmtree(root, ignore_errors=True)
    walls["phase"] = time.perf_counter() - t_phase
    print(f"  hive at {schema}: CTAS lineitem {rec['rows_lineitem_h']} rows "
          f"{walls['ctas_lineitem_h']:.3f} s, orders {rec['rows_orders_h']} "
          f"rows {walls['ctas_orders_h']:.3f} s (Parquet), "
          f"{walls['ctas_orders_orc']:.3f} s (ORC) {card}")
    for name, ref in (("q1", "q1"), ("q6", "q6"), ("w1", "w1"),
                      ("w1_orc", "w1")):
        print(f"  {name}: hive cold {walls[name + '_hive_cold']:.3f} s, warm "
              f"{walls[name + '_hive_warm'] * 1e3:.3f} ms; tpch cold "
              f"{walls[ref + '_tpch_cold']:.3f} s, warm "
              f"{walls[ref + '_tpch_warm'] * 1e3:.3f} ms; rows equal; "
              f"no scan kernel; streaming {rec[name]['streaming']}, "
              f"declined {rec[name]['declined']}")
    print(f"  REAL: {rec['real']['row']} (numpy {rec['real']['numpy']}), "
          f"cold {walls['real_cold']:.3f} s, warm "
          f"{walls['real_warm'] * 1e3:.3f} ms; device == CPU port")
    print(f"  REAL window: {rec['real_window_rows']} rows in "
          f"{walls['real_window']:.3f} s, window_scan launches "
          f"{rec['real_window_launches']} (W1 over hive "
          f"{rec['hive_window_launches']}, over tpch "
          f"{rec['tpch_window_launches']}), each equal to plain: "
          f"{rec['real_window_calls']}")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="hive_run")
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from ..exec.runner import resolve_device
    device = resolve_device(args.device)
    rec = run(args.sf, device)
    print(json.dumps({"walls": rec["walls"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
