"""The scan and window kernels' times on the card, for comparing two
checkouts of the port on one card.

    python3 -m presto_tpu_torch.benchmarks.kernel_times [--sf 10]
        [--launches 20] [--queries q6,q1,...] [--variants]
        [--parent DIR]

Runs Q6, Q1, J2, J2_NOPROBE (direct kernel), S1, S2, SPAN_F, J3 (span),
H1, H2, J1 (hash) and W1-W3 (window kernel) through LocalQueryRunner on
the card, keeps each query's last kernel call and launches it `launches`
times after one warm-up.
Per query it prints the wrapper's call ms (CUDA events around the calls:
launch overhead and host gaps included) and, from torch.profiler over the
same calls, the device ms per call of the kernels (each kernel by name:
the split between a scan and its reduce, or between the window kernel's
launches) and of the copies and memsets.  The first line is the card's
name and power limit.  It uses only the wrappers' calls, so the same file
run from two checkouts compares their kernels within one call: --parent
DIR copies this file and the query modules (SQL text only) into the
checkout at DIR, runs it there and here in turns -- parent, change,
change, parent, one process each -- and prints every query's device ms
per turn.  J2 minus J2_NOPROBE (the same scan without the semi probe) is
the probe's share of J2.

--variants (a tree with the generated direct kernel) also times Q6 and Q1
with the kernel's partials folded per pass (codegen.REG_PARTIALS = 0) and
with one CTA per work item instead of the persistent grid: where the
redesign's time went.
"""
import argparse
import math
import re
import subprocess
import sys

QUERIES = ("q6", "q1", "j2", "j2_noprobe", "s1", "s2", "span_f", "j3", "h1",
           "h2", "j1", "w1", "w2", "w3")
# the files --parent copies into the parent checkout
_COPIED = ("kernel_times.py", "grouped_queries.py", "join_queries.py")


def events_ms(fn, n: int) -> float:
    """Wall ms per call on the stream (CUDA events), after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


def device_ms(fn, n: int) -> dict:
    """{device event name: ms per call} from torch.profiler over n calls
    of `fn` (after a warm-up); "kernels" sums the port's kernels (each
    kernel's mean launch times its whole launches per call),
    "copies" the memcpy and memset events and PyTorch's fills of the
    wrapper's outputs, "launches" counts the port's kernels per call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {"kernels": 0.0, "copies": 0.0, "launches": 0.0}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = e.self_device_time_total / 1e3 / n
        # copies, memsets and PyTorch's own fills of the wrapper's outputs
        if re.search(r"[Mm]emcpy|[Mm]emset|at::native|at::", e.key):
            out["copies"] += ms
            continue
        # a kernel's launches per call, whole: the profiler can miss some
        # of a run's events, so its time is its mean launch times that
        per_call = math.ceil(e.count / n - 1e-9)
        ms = e.self_device_time_total / 1e3 / e.count * per_call
        out["kernels"] += ms
        out["launches"] += per_call
        out[kernel_name(e.key)] = out.get(kernel_name(e.key), 0.0) + ms
    return out


def kernel_name(key: str) -> str:
    """A profiler kernel key without its return type and arguments."""
    key = re.sub(r"^void ", "", key)
    return re.split(r"[(<]", key, 1)[0]


def record_calls(wrappers):
    """Replace each wrapper with one that records its calls; returns
    (calls, real wrappers, restore)."""
    real = {k: getattr(m, a) for k, (m, a) in wrappers.items()}
    calls = {k: [] for k in wrappers}

    def recorder(name):
        def recording(*a, **kw):
            calls[name].append((a, kw))
            return real[name](*a, **kw)
        return recording
    for k, (m, a) in wrappers.items():
        setattr(m, a, recorder(k))

    def restore():
        for k, (m, a) in wrappers.items():
            setattr(m, a, real[k])
    return calls, real, restore


def line(qname, kernel, call_ms, dev) -> str:
    split = ", ".join(f"{k} {v:.4f}" for k, v in sorted(dev.items())
                      if k not in ("kernels", "copies", "launches"))
    return (f"{qname} ({kernel}): call_ms {call_ms:.4f} device_ms "
            f"{dev['kernels']:.4f} copies_and_fills_ms {dev['copies']:.4f} "
            f"kernel launches per call {dev['launches']:.1f} [{split}]")


def in_turns(parent: str, argv) -> int:
    """Run this file at `parent` and here in turns (parent, change,
    change, parent), each in its own process with PYTHONPATH at its
    checkout; then print each query's device ms per turn."""
    import os
    import shutil
    here = os.path.dirname(os.path.abspath(__file__))
    repo = os.path.dirname(os.path.dirname(here))
    dst = os.path.join(parent, "presto_tpu_torch", "benchmarks")
    for name in _COPIED:
        shutil.copy(os.path.join(here, name), os.path.join(dst, name))
    table = {}
    for turn, root in enumerate((parent, repo, repo, parent)):
        who = "parent" if root == parent else "change"
        print(f"== turn {turn + 1}: {who} ({root})", flush=True)
        out = subprocess.run(
            [sys.executable, "-m", "presto_tpu_torch.benchmarks.kernel_times",
             *argv], cwd=root, env=dict(os.environ, PYTHONPATH=root),
            capture_output=True, text=True)
        print(out.stdout, end="", flush=True)
        if out.returncode != 0:
            print(out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        for m in re.finditer(r"^(\w+) \(\w+\): call_ms \S+ device_ms (\S+)",
                             out.stdout, re.M):
            table.setdefault(m.group(1), []).append(
                f"{who} {float(m.group(2)):.4f}")
    print("device ms per turn (parent, change, change, parent):")
    for q, cells in table.items():
        print(f"  {q}: {' | '.join(cells)}")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sf", default="10")
    ap.add_argument("--launches", type=int, default=20)
    ap.add_argument("--queries", default=",".join(QUERIES))
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--parent", default=None,
                    help="a parent checkout to time in turns with this one")
    args = ap.parse_args()
    if args.parent:
        argv = [a for a in sys.argv[1:] if not a.startswith("--parent")
                and a != args.parent]
        return in_turns(args.parent, argv)
    import torch
    if not torch.cuda.is_available():
        print("kernel_times: CUDA is not available", file=sys.stderr)
        return 2
    from presto_tpu_torch.benchmarks import window_queries as WQ
    from presto_tpu_torch.benchmarks.grouped_queries import (H1, H2, S1, S2,
                                                             SPAN_F)
    from presto_tpu_torch.benchmarks.join_queries import J1, J2, J2_NOPROBE, J3
    from presto_tpu_torch.benchmarks.tpch_queries import Q1, Q6
    from presto_tpu_torch.exec.kernels import grouped as gk
    from presto_tpu_torch.exec.kernels import scan_kernel as sk
    from presto_tpu_torch.exec.kernels import window as wk
    from presto_tpu_torch.exec.runner import LocalQueryRunner
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(f"card: {smi.stdout.strip().splitlines()[0]}", flush=True)
    calls, real, restore = record_calls({
        "scan_direct": (sk, "scan_direct"), "scan_span": (gk, "scan_span"),
        "scan_hash": (gk, "scan_hash"), "window_scan": (wk, "window_scan")})
    runner = LocalQueryRunner(f"sf{args.sf}", device=torch.device("cuda", 0))
    table = {"q6": (Q6, "scan_direct"), "q1": (Q1, "scan_direct"),
             "j2": (J2, "scan_direct"),
             "j2_noprobe": (J2_NOPROBE, "scan_direct"),
             "s1": (S1, "scan_span"), "s2": (S2, "scan_span"),
             "span_f": (SPAN_F, "scan_span"), "j3": (J3, "scan_span"),
             "h1": (H1, "scan_hash"), "h2": (H2, "scan_hash"),
             "j1": (J1, "scan_hash"), "w1": (WQ.W1, "window_scan"),
             "w2": (WQ.W2, "window_scan"), "w3": (WQ.W3, "window_scan")}
    kept = {}
    for qname in args.queries.split(","):
        sql, kernel = table[qname]
        runner.execute(sql)
        a, kw = calls[kernel][-1]
        launch = real[kernel]
        kept[qname] = (kernel, a, kw)
        if kernel == "window_scan":
            calls[kernel].clear()        # a call holds the sorted run
        call_ms = events_ms(lambda: launch(*a, **kw), args.launches)
        dev = device_ms(lambda: launch(*a, **kw), args.launches)
        print(line(qname, kernel, call_ms, dev), flush=True)
    if args.variants:
        from presto_tpu_torch.exec.kernels import codegen
        for qname in ("q6", "q1"):
            if qname not in kept:
                continue
            kernel, a, kw = kept[qname]
            plan = a[0]
            for name, patch in (("fold per pass", "regs"),
                                ("one CTA per work item", "ctas")):
                saved = (codegen.REG_PARTIALS, sk.direct_ctas)
                if patch == "regs":
                    codegen.REG_PARTIALS = 0
                else:
                    sk.direct_ctas = lambda kern, n_items, device: n_items
                plan.dev.clear()
                try:
                    call_ms = events_ms(lambda: real[kernel](*a, **kw),
                                        args.launches)
                    dev = device_ms(lambda: real[kernel](*a, **kw),
                                    args.launches)
                finally:
                    codegen.REG_PARTIALS, sk.direct_ctas = saved
                    plan.dev.clear()
                print(line(f"{qname} [{name}]", kernel, call_ms, dev),
                      flush=True)
    restore()
    return 0


if __name__ == "__main__":
    sys.exit(main())
