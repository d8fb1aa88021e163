"""The serving plane and writes on a device.

    python -m presto_tpu_torch.benchmarks.serving_run --sf 10
        [--device cuda]

Runs, through the port's entry points (every failed check raises):
  * prepared statements: PREPARE of the Q6 and grouped templates of
    tests/test_serving_batch.py, then 5 EXECUTEs of each under "auto":
    the first of each replans, the other 4 take the fast path, each
    launches the direct kernel #1, and each result equals the same SQL
    with its literals inline under "auto" and under "xla".  The warm
    medians of the fast path against the inline SQL, with the parse,
    plan and optimize walls the fast path skips;
  * batched drains under scan_kernel="xla": execute_prepared_batch over 3
    and over 16 bindings of each template, every lane equal to its solo
    run exactly, the batch counters (batches, padded lanes, the launch
    nanos) and the 16-lane drain's wall against the 16 solo walls; under
    "auto" the batch declines and each lane's solo run launches #1;
  * through the server: WorkerServer(coordinator=True) on the device
    with scan.kernel-dma=double, a plan-cache sidecar and a kernel cache
    in a temporary directory: one EXECUTE of the Q6 template under auto
    (#1, carrying the stage ring #2), then 16 concurrent StatementClient
    EXECUTEs under session scan_kernel=xla: at least one batched drain,
    no fallback, rows equal to the solo runs;
  * a warm restart in a subprocess (`--restart-child DIR`): a server
    over the same sidecar and kernel cache replays before it listens;
    its first EXECUTE of the Q6 template under auto makes no plan-cache
    miss and no replan, every generated kernel of that process loads from
    the cache (build.COMPILE_MS all 0.0: no NVRTC compile), and its rows
    equal the first server's.  A subprocess, because the loaded-module
    table build._MODULES lives as long as the process;
  * writes over the memory connector: CREATE TABLE AS of the reference
    test's orders shape restricted to orderkey <= 250,000 (250 K rows at
    SF10 and above), read back (count and sum equal to the generated
    table's), joined against orders, INSERT doubling it, DROP through the
    server; after the DDL the runners' plan caches, the fast paths, the
    fragment cache and the sidecar are empty, and a scan of the dropped
    table raises.
chip_smoke.py runs `run` as its serving phase.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, List

import numpy as np

from .tpch_run import _sync, _wall

Q6_TEMPLATE = ("select sum(l_extendedprice * l_discount) as revenue "
               "from lineitem where l_shipdate >= ? and l_shipdate < ? "
               "and l_discount between ? and ? and l_quantity < ?")
GROUPED_TEMPLATE = ("select l_returnflag, count(*) as c, "
                    "sum(l_quantity) as q, min(l_extendedprice) as lo, "
                    "max(l_extendedprice) as hi from lineitem "
                    "where l_quantity < ? group by l_returnflag")
# the generated orderkeys are dense (1..N), so this is 250,000 rows at
# SF10: the memory connector holds host Python values, and a larger
# table costs host seconds and shows nothing new
CTAS_WHERE = "orderkey <= 250000"
CTAS = ("create table mem_orders as select orderkey, totalprice, "
        "orderpriority, orderdate from orders where " + CTAS_WHERE)
# the micro-batcher's window for the server part (the reference test's)
BATCH_WINDOW_MS = 150.0
MAX_BATCH = 16
RESTART_TIMEOUT_S = 600


def q6_values(i: int) -> List[str]:
    """The i-th binding of the Q6 template (USING literals)."""
    y = 1993 + i % 5
    lo = (1 + i % 6) / 100
    return [f"date '{y}-01-01'", f"date '{y + 1}-01-01'", f"{lo:.2f}",
            f"{lo + 0.02:.2f}", str(10 + i)]


def grouped_values(i: int) -> List[str]:
    return [str(5 + 3 * i)]


TEMPLATES = {"q6": (Q6_TEMPLATE, q6_values),
             "grouped": (GROUPED_TEMPLATE, grouped_values)}


def execute_sql(name: str, i: int) -> str:
    template, values = TEMPLATES[name]
    return f"execute {name} using " + ", ".join(values(i))


def inline_sql(name: str, i: int) -> str:
    """The template with the i-th binding's literals written inline."""
    template, values = TEMPLATES[name]
    parts = template.split("?")
    vals = values(i)
    return "".join(p + v for p, v in zip(parts, vals)) + parts[-1]


def _direct_launches() -> int:
    from ..exec.kernels import scan_kernel as sk
    return sk.LAUNCHES["scan_direct"]


def _walls_ns(res) -> Dict[str, float]:
    rs = res.runtime_stats or {}
    return {k: rs.get(k + "WallNanos", {}).get("sum", 0) for k in
            ("queryParse", "queryPlan", "queryOptimize", "queryExecute")}


def run_prepared(schema: str, device, card: str = "") -> dict:
    """5 EXECUTEs of each template under auto: fast path, launches, rows
    equal to the inline SQL under auto and xla, walls."""
    from ..exec.pipeline import tuned_config
    from ..exec.runner import LocalQueryRunner
    from ..serving import SERVING_METRICS
    auto = LocalQueryRunner(schema, device=device)
    xla = LocalQueryRunner(schema, device=device,
                           config=tuned_config(scan_kernel="xla"))
    out: Dict[str, dict] = {}
    sv0 = SERVING_METRICS.snapshot()
    launches = 0
    for name, (template, _values) in TEMPLATES.items():
        res = auto.execute(f"prepare {name} from {template}")
        assert res.added_prepare == (name, template)
        ex_walls, ex_stats, rows = [], [], []
        for i in range(5):
            before = _direct_launches()
            res, wall = _wall(auto, execute_sql(name, i), device)
            launches += _direct_launches() - before
            ex_walls.append(wall)
            ex_stats.append(_walls_ns(res))
            rows.append(res.rows)
        in_walls, in_stats = [], []
        for i in range(5):
            res, wall = _wall(auto, inline_sql(name, i), device)
            assert res.rows == rows[i], (name, i, res.rows, rows[i])
            assert xla.execute(inline_sql(name, i)).rows == rows[i]
            in_walls.append(wall)
            in_stats.append(_walls_ns(res))
        rec = out[name] = {
            "fast_ms": float(np.median(ex_walls[1:])) * 1e3,
            "first_ms": ex_walls[0] * 1e3,
            "inline_ms": float(np.median(in_walls[1:])) * 1e3,
            "fast_walls_us": {k: float(np.median(
                [s[k] for s in ex_stats[1:]])) / 1e3 for k in ex_stats[0]},
            "inline_walls_us": {k: float(np.median(
                [s[k] for s in in_stats[1:]])) / 1e3 for k in in_stats[0]},
            "rows": len(rows[0])}
        print(f"  {schema} prepared {name}: first EXECUTE (replan) "
              f"{rec['first_ms']:.3f} ms, fast path median "
              f"{rec['fast_ms']:.3f} ms against inline SQL "
              f"{rec['inline_ms']:.3f} ms (4 warm runs each); walls (us) "
              f"fast {rec['fast_walls_us']}, inline "
              f"{rec['inline_walls_us']}; rows == inline == xla {card}",
              flush=True)
    sv = SERVING_METRICS.snapshot()
    fast = sv["preparedFastPath"] - sv0["preparedFastPath"]
    replans = sv["preparedReplans"] - sv0["preparedReplans"]
    assert fast == 8 and replans == 2, (fast, replans)
    # the plain versions (CPU tensors) count no launch
    assert device.type != "cuda" or launches == 10, launches
    out["counters"] = {"fast_path": fast, "replans": replans,
                       "direct_launches": launches}
    print(f"  {schema} prepared: fast path {fast}, replans {replans}, "
          f"#1 launches {launches} {card}", flush=True)
    return out


def run_batched(schema: str, device, card: str = "") -> dict:
    """execute_prepared_batch over 3 and 16 lanes under xla (each lane
    equal to its solo run), and its decline under auto."""
    from ..exec.pipeline import tuned_config
    from ..exec.runner import LocalQueryRunner
    from ..serving import SERVING_METRICS
    xla = LocalQueryRunner(schema, device=device,
                           config=tuned_config(scan_kernel="xla"))
    auto = LocalQueryRunner(schema, device=device)
    out: Dict[str, dict] = {}
    for name, (template, _values) in TEMPLATES.items():
        xla.execute(f"prepare {name} from {template}")
        binds = [execute_sql(name, i) for i in range(16)]
        xla.execute(binds[0])       # the replan that records the fast path
        solo, solo_walls = [], []
        for s in binds:
            res, wall = _wall(xla, s, device)
            solo.append(res.rows)
            solo_walls.append(wall)
        rec = out[name] = {"solo16_ms": sum(solo_walls) * 1e3}
        for n in (3, 16):
            sv0 = SERVING_METRICS.snapshot()
            _sync(device)
            t0 = time.perf_counter()
            lanes = xla.execute_prepared_batch(binds[:n])
            _sync(device)
            wall = time.perf_counter() - t0
            assert lanes is not None and all(r is not None for r in lanes)
            for i, r in enumerate(lanes):
                assert r.rows == solo[i], (name, n, i, r.rows, solo[i])
            sv = SERVING_METRICS.snapshot()
            width = 1 << (n - 1).bit_length()
            assert sv["servingBatches"] - sv0["servingBatches"] == 1
            assert sv["servingBatchQueries"] - sv0["servingBatchQueries"] \
                == n
            assert (sv["servingBatchPaddedLanes"]
                    - sv0["servingBatchPaddedLanes"]) == width - n
            rec[f"batch{n}"] = {
                "wall_ms": wall * 1e3, "lanes": n, "padded": width - n,
                "launch_ms": lanes[0].runtime_stats[
                    "servingBatchLaunchNanos"]["sum"] / 1e6,
                "demux_ms": (sv["servingBatchDemuxNanos"]
                             - sv0["servingBatchDemuxNanos"]) / 1e6}
        # under auto the solo runs launch #1: the batch declines
        auto.execute(f"prepare {name} from {template}")
        auto.execute(binds[0])
        assert auto.execute_prepared_batch(binds[:3]) is None
        before = _direct_launches()
        for i in range(3):
            assert auto.execute(binds[i]).rows == solo[i]
        rec["auto_solo_launches"] = _direct_launches() - before
        assert device.type != "cuda" or rec["auto_solo_launches"] == 3
        print(f"  {schema} batched {name} (xla): 3 lanes "
              f"{rec['batch3']['wall_ms']:.3f} ms (padded "
              f"{rec['batch3']['padded']}, launch "
              f"{rec['batch3']['launch_ms']:.3f} ms), 16 lanes "
              f"{rec['batch16']['wall_ms']:.3f} ms (launch "
              f"{rec['batch16']['launch_ms']:.3f} ms, demux "
              f"{rec['batch16']['demux_ms']:.3f} ms) against 16 solo xla "
              f"runs {rec['solo16_ms']:.3f} ms; every lane == its solo run; "
              f"auto declines, its 3 solo runs launched #1 "
              f"{rec['auto_solo_launches']} times {card}", flush=True)
    return out


def _server(tmp: str, device):
    from ..exec.pipeline import tuned_config
    from ..worker.server import WorkerServer
    return WorkerServer(
        coordinator=True, device=device,
        config=tuned_config(scan_kernel_dma="double"),
        plan_cache_path=os.path.join(tmp, "plans.jsonl"),
        compilation_cache_dir=os.path.join(tmp, "kernels"),
        batch_window_ms=BATCH_WINDOW_MS, max_batch_size=MAX_BATCH)


def run_server(srv, schema: str, device, card: str = "") -> dict:
    """One auto EXECUTE (#1 with the ring), then 16 concurrent xla
    EXECUTEs through the micro-batcher."""
    from ..client import StatementClient
    from ..exec.kernels import scan_kernel as sk
    from ..serving import SERVING_METRICS
    c = StatementClient(srv.uri, schema=schema)
    c.execute(f"prepare q6 from {Q6_TEMPLATE}")
    before, staged = _direct_launches(), sk.STAGED_LAUNCHES["scan_direct"]
    t0 = time.perf_counter()
    auto_rows = c.execute(execute_sql("q6", 0)).rows
    auto_ms = (time.perf_counter() - t0) * 1e3
    launched = _direct_launches() - before
    staged = sk.STAGED_LAUNCHES["scan_direct"] - staged
    assert device.type != "cuda" or (launched == 1 and staged == 1), \
        (launched, staged)
    session = {"scan_kernel": "xla"}
    cx = StatementClient(srv.uri, schema=schema, session=session)
    cx.prepared = dict(c.prepared)
    binds = [execute_sql("q6", i) for i in range(16)]
    cx.execute(binds[0])        # the xla runner's plan-cache entry
    sv0 = SERVING_METRICS.snapshot()
    got: List = [None] * 16
    errors: List = []

    def go(i):
        try:
            cc = StatementClient(srv.uri, schema=schema, session=session)
            cc.prepared = dict(c.prepared)
            got[i] = cc.execute(binds[i]).rows
        except Exception as e:  # noqa: BLE001 -- reported below
            errors.append(e)
    threads = [threading.Thread(target=go, args=(i,)) for i in range(16)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall16 = time.perf_counter() - t0
    assert not errors, errors
    sv = SERVING_METRICS.snapshot()
    d = {k: sv[k] - sv0[k] for k in ("servingBatches", "servingBatchQueries",
                                     "servingBatchFallbacks",
                                     "servingBatchLaunchesSaved")}
    assert d["servingBatches"] >= 1, d
    assert d["servingBatchFallbacks"] == 0, d
    solo_ms = []
    for i, s in enumerate(binds):
        t0 = time.perf_counter()
        assert cx.execute(s).rows == got[i], i
        solo_ms.append((time.perf_counter() - t0) * 1e3)
    assert got[0] == auto_rows
    rec = {"auto_ms": auto_ms, "auto_launches": launched,
           "auto_staged": staged, "concurrent16_ms": wall16 * 1e3,
           "solo16_ms": sum(solo_ms), "rows": auto_rows, **d,
           "sidecar": srv._sidecar.info()}
    print(f"  {schema} server: auto EXECUTE {auto_ms:.3f} ms (#1 launches "
          f"{launched}, staged {staged}); 16 concurrent xla EXECUTEs "
          f"{rec['concurrent16_ms']:.3f} ms in {d['servingBatches']} "
          f"batched drains of {d['servingBatchQueries']} lanes, fallbacks "
          f"{d['servingBatchFallbacks']}; the 16 solo "
          f"{rec['solo16_ms']:.3f} ms, rows equal; sidecar "
          f"{rec['sidecar']['entries']} entries {card}", flush=True)
    return rec


def restart_child(tmp: str, sf: float) -> int:
    """The warm restart, in its own process: a server over `tmp`'s
    sidecar and kernel cache, then one EXECUTE of the Q6 template under
    auto.  Prints one JSON line."""
    from ..client import StatementClient
    from ..exec.kernels import build
    from ..exec.runner import resolve_device
    from ..serving import SERVING_METRICS
    device = resolve_device("cuda")
    t0 = time.perf_counter()
    srv = _server(tmp, device)
    boot_s = time.perf_counter() - t0
    try:
        SERVING_METRICS.reset()
        c = StatementClient(srv.uri, schema=f"sf{sf:g}")
        c.prepared["q6"] = Q6_TEMPLATE
        before = _direct_launches()
        t0 = time.perf_counter()
        rows = c.execute(execute_sql("q6", 0)).rows
        first_ms = (time.perf_counter() - t0) * 1e3
        sv = SERVING_METRICS.snapshot()
        print(json.dumps({
            "rows": json.dumps(rows, default=str), "boot_s": boot_s,
            "first_ms": first_ms, "launches": _direct_launches() - before,
            "gen_dir": str(build.GEN_DIR),
            "compile_ms": dict(build.COMPILE_MS),
            **{k: sv[k] for k in ("planCacheMisses", "planCacheHits",
                                  "preparedReplans", "preparedFastPath")}}),
            flush=True)
    finally:
        srv.close()
    return 0


def run_restart(tmp: str, sf: float, want_rows, card: str = "") -> dict:
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "presto_tpu_torch.benchmarks.serving_run",
         "--restart-child", tmp, "--sf", f"{sf:g}"],
        cwd=root, capture_output=True, text=True,
        timeout=RESTART_TIMEOUT_S)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"the restarted server failed "
                           f"(rc {proc.returncode}):\n{proc.stdout[-4000:]}"
                           f"\n{proc.stderr[-4000:]}")
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rec["planCacheMisses"] == 0, rec
    assert rec["preparedReplans"] == 0, rec
    assert rec["preparedFastPath"] == 1, rec
    assert rec["rows"] == json.dumps(want_rows, default=str), rec
    assert rec["gen_dir"] == os.path.join(tmp, "kernels"), rec
    assert rec["compile_ms"], "no generated kernel was loaded"
    assert all(v == 0.0 for v in rec["compile_ms"].values()), rec
    assert rec["launches"] == 1, rec
    rec["process_s"] = wall
    print(f"  sf{sf:g} warm restart (subprocess, {wall:.3f} s): boot with "
          f"replay {rec['boot_s']:.3f} s, first EXECUTE "
          f"{rec['first_ms']:.3f} ms, plan-cache misses "
          f"{rec['planCacheMisses']}, replans {rec['preparedReplans']}, "
          f"{len(rec['compile_ms'])} generated kernels loaded from the "
          f"cache with 0 NVRTC compiles, rows == the first server's {card}",
          flush=True)
    return rec


def run_writes(srv, schema: str, device, card: str = "") -> dict:
    """CTAS / read back / join / INSERT / DROP over the memory connector;
    the serving state is empty after the DDL."""
    from ..client import StatementClient
    from ..connectors import catalog
    from ..connectors.memory import MemoryConnector
    from ..exec.runner import LocalQueryRunner
    from ..serving import FRAGMENT_JIT_CACHE, PREPARED_REGISTRY
    catalog.register_connector("memory", MemoryConnector())
    try:
        runner = LocalQueryRunner(schema, device=device)
        res, ctas = _wall(runner, CTAS, device)
        n = res.rows[0][0]
        got, read = _wall(runner, "select count(*), sum(totalprice) from "
                          "mem_orders", device)
        want = runner.execute("select count(*), sum(totalprice) from "
                              "orders where " + CTAS_WHERE).rows
        assert got.rows == want and want[0][0] == n, (got.rows, want)
        j, join = _wall(runner, "select count(*) from mem_orders m join "
                        "orders o on m.orderkey = o.orderkey", device)
        assert j.rows == [[n]], j.rows
        runner.execute("prepare mq from select count(*) from mem_orders "
                       "where totalprice < ?")
        runner.execute("execute mq using 100000")
        assert PREPARED_REGISTRY.info()["fastPaths"] >= 1
        assert runner.plan_cache.info()["entries"] >= 1
        ins, insert = _wall(runner, CTAS.replace(
            "create table mem_orders as", "insert into mem_orders"), device)
        assert ins.rows == [[n]], ins.rows
        assert runner.plan_cache.info()["entries"] == 0
        assert PREPARED_REGISTRY.info()["fastPaths"] == 0
        assert FRAGMENT_JIT_CACHE.info()["entries"] == 0
        assert runner.execute("select count(*) from mem_orders").rows \
            == [[2 * n]]
        # the DROP through the server: its runners and sidecar go too
        assert srv._sidecar.info()["entries"] >= 1
        cm = StatementClient(srv.uri, catalog="memory", schema=schema)
        cm.execute("drop table mem_orders")
        assert srv._sidecar.info()["entries"] == 0
        assert not os.path.exists(srv._sidecar.path)
        assert srv._runner_cache == {}
        assert FRAGMENT_JIT_CACHE.info()["entries"] == 0
        assert PREPARED_REGISTRY.info()["fastPaths"] == 0
        try:
            runner.execute("select count(*) from mem_orders")
        except Exception as e:  # noqa: BLE001 -- the expected failure
            dropped = f"{type(e).__name__}: {e}"
        else:
            raise AssertionError("the dropped table still scans")
    finally:
        catalog.unregister_connector("memory")
    rec = {"rows": n, "ctas_ms": ctas * 1e3, "read_ms": read * 1e3,
           "join_ms": join * 1e3, "insert_ms": insert * 1e3,
           "dropped": dropped}
    print(f"  {schema} writes: CTAS of {n} orders rows {rec['ctas_ms']:.3f} "
          f"ms, read back {rec['read_ms']:.3f} ms (count, sum == orders), "
          f"join with orders {rec['join_ms']:.3f} ms, INSERT "
          f"{rec['insert_ms']:.3f} ms (count doubled); after the DDL plan "
          f"caches, fast paths, fragments and sidecar empty; the dropped "
          f"table raises {dropped!r} {card}", flush=True)
    return rec


def run(sf: float, device, card: str = "") -> dict:
    """The whole phase; returns its records and walls."""
    from ..exec.kernels import build
    from ..serving import PREPARED_REGISTRY
    schema = f"sf{sf:g}"
    PREPARED_REGISTRY.clear()
    gen_dir = build.GEN_DIR     # the server moves it into `tmp`
    walls: Dict[str, float] = {}
    t = time.perf_counter()
    prepared = run_prepared(schema, device, card)
    walls["prepared_s"] = time.perf_counter() - t
    t = time.perf_counter()
    batched = run_batched(schema, device, card)
    walls["batched_s"] = time.perf_counter() - t
    tmp = tempfile.mkdtemp(prefix="serving-")
    try:
        t = time.perf_counter()
        srv = _server(tmp, device)
        try:
            server = run_server(srv, schema, device, card)
            walls["server_s"] = time.perf_counter() - t
            t = time.perf_counter()
            restart = run_restart(tmp, sf, server["rows"], card)
            walls["restart_s"] = time.perf_counter() - t
            t = time.perf_counter()
            writes = run_writes(srv, schema, device, card)
            walls["writes_s"] = time.perf_counter() - t
        finally:
            srv.close()
    finally:
        build.set_gen_dir(gen_dir)
        shutil.rmtree(tmp, ignore_errors=True)
    return {"prepared": prepared, "batched": batched, "server": server,
            "restart": restart, "writes": writes, "walls": walls}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sf", default="10")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--restart-child", default=None,
                    help="run as the restarted server over this directory")
    args = ap.parse_args()
    if args.restart_child:
        return restart_child(args.restart_child, float(args.sf))
    from ..exec.runner import resolve_device
    rec = run(float(args.sf), resolve_device(args.device))
    print(f"  phase walls: {rec['walls']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
