"""Where the hash kernel's time goes on the card: its scan launch against
its reduce launch.

    python3 -m presto_tpu_torch.benchmarks.hash_split [--sf 10] [--launches 10]

Runs H1, H2, J1, HASH_F, COLLIDE and H1 under one key at a time (H1_QTY,
H1_DISC) through LocalQueryRunner on the card
at the scale factor, keeps each query's last scan_hash call (COLLIDE's is
the collision loop's last table), launches it `launches` times under
torch.profiler and prints, per query, the device ms per launch of
scan_grouped_kernel and of scan_grouped_reduce, the slot count, and
whether the table stayed in shared memory (where the package meters it:
grouped.ONCHIP_LAUNCHES).  A launch on chip is timed again with its plan
sent down the device-memory path (ScanPlan.onchip_slots = 0, the same
CTAs): the two paths' comparison on one card.  The first line is the card's name
and power limit.  chip_smoke.py reads `split_ms` for its grouped cases.
"""
import argparse
import dataclasses
import subprocess
import sys

# H1 / H2 / J1 are grouped_queries' and join_queries'; these two are the
# hash kernel's float / min-max query and the collision query (4950
# groups: a table started at AGG_SLOTS must collide)
HASH_F = (
    "select l_quantity, l_linenumber, min(l_extendedprice) as mn, "
    "max(cast(l_tax as double)) as mx, avg(cast(l_discount as double)) as a, "
    "min(l_orderkey) as mo from lineitem where l_shipdate > date '1995-06-17' "
    "group by 1, 2")
COLLIDE = (
    "select l_quantity, l_discount, l_tax, count(*) as n, "
    "sum(l_extendedprice) as s, sum(cast(l_extendedprice as double)) as sf "
    "from lineitem group by 1, 2, 3")
# H1's filter and aggregates under one of its two keys: 50 and 11 groups
# where H1 has 550 (how the on-chip path's cost follows the group count)
H1_QTY = (
    "select l_quantity, sum(l_extendedprice * l_discount) as revenue, "
    "count(*) as n from lineitem where l_shipdate >= date '1994-01-01' "
    "and l_shipdate < date '1995-01-01' group by 1")
H1_DISC = H1_QTY.replace("l_quantity", "l_discount", 1)
KERNEL_NAMES = ("scan_grouped_kernel", "scan_grouped_reduce")


def split_ms(launch, n: int, names=KERNEL_NAMES) -> dict:
    """Device ms per launch of the scan kernel and the reduce (`names`:
    the hash kernel's by default), from torch.profiler over `n` calls of
    `launch` (after one warm-up)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    launch()
    torch.cuda.synchronize()  # lint: allow-host-sync
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            launch()
        torch.cuda.synchronize()  # lint: allow-host-sync
    out = {k: 0.0 for k in names}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        for k in names:
            if k in e.key:
                out[k] += e.self_device_time_total / 1e3 / n
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sf", default="10")
    ap.add_argument("--launches", type=int, default=10)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("hash_split: CUDA is not available", file=sys.stderr)
        return 2
    from presto_tpu_torch.benchmarks.grouped_queries import H1, H2
    from presto_tpu_torch.benchmarks.join_queries import J1
    from presto_tpu_torch.exec.kernels import grouped as gk
    from presto_tpu_torch.exec.runner import LocalQueryRunner
    from presto_tpu_torch.sql.stats import StatsCalculator
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(f"card: {smi.stdout.strip().splitlines()[0]}")
    real = gk.scan_hash
    calls = []

    def recording(*a, **kw):
        calls.append((a, kw))
        return real(*a, **kw)
    gk.scan_hash = recording
    runner = LocalQueryRunner(f"sf{args.sf}", device=torch.device("cuda", 0))
    onchip = getattr(gk, "ONCHIP_LAUNCHES", None)
    for qname, sql in (("h1", H1), ("h2", H2), ("j1", J1),
                       ("hash_f", HASH_F), ("collide", COLLIDE),
                       ("h1_qty", H1_QTY), ("h1_disc", H1_DISC)):
        rows = StatsCalculator.rows
        if qname == "collide":      # start the table below the groups
            StatsCalculator.rows = lambda self, node: 1.0
        try:
            runner.execute(sql)
        finally:
            StatsCalculator.rows = rows
        a, kw = calls[-1]
        before = dict(onchip) if onchip is not None else None
        ms = split_ms(lambda: real(*a, **kw), args.launches)
        path = ("not metered" if onchip is None else
                "on chip" if onchip["scan_hash"] > before["scan_hash"]
                else "device memory")
        print(f"{qname}: slots {a[5]}, {path}, scan_grouped_kernel "
              f"{ms['scan_grouped_kernel']:.4f} ms, scan_grouped_reduce "
              f"{ms['scan_grouped_reduce']:.4f} ms per launch "
              f"({args.launches} launches)", flush=True)
        if path == "on chip":
            off = (dataclasses.replace(a[0], onchip_slots=0),) + a[1:]
            ms = split_ms(lambda: real(*off, **kw), args.launches)
            print(f"{qname}: the same launch ({a[0].threads} threads a CTA) "
                  f"on the device-memory path: scan_grouped_kernel "
                  f"{ms['scan_grouped_kernel']:.4f} ms, scan_grouped_reduce "
                  f"{ms['scan_grouped_reduce']:.4f} ms", flush=True)
    gk.scan_hash = real
    return 0


if __name__ == "__main__":
    sys.exit(main())
