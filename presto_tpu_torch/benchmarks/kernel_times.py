"""The scan and window kernels' times on the card, for comparing two
checkouts of the port on one card.

    python3 -m presto_tpu_torch.benchmarks.kernel_times [--sf 10]
        [--launches 20] [--queries q6,q1,...] [--dma single,double]
        [--variants] [--walls N] [--parent DIR]

Runs Q6, Q1, J2, J2_NOPROBE, the float query (direct kernel), S1, S2,
SPAN_F, SPAN_F_CTA, J3 (span), H1, H2, J1, HASH_DATE_PARTS (hash) and
W1-W3 (window kernel) through LocalQueryRunner on the card, keeps each
query's last kernel call and launches it `launches` times after one
warm-up, in each scan_kernel_dma mode of --dma (the window kernel has no
stage ring: single only; a double line is named "<query>/double").
Under "double" a tree with the stage ring's plan (ScanPlan.staging)
also prints each query's staging: the staged arrays, the ring's stages
and passes per stage, bytes per stage, the staged MB and the ring's
bound at 3.35 TB/s.
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

--walls N also prints each query's median of N warm walls around
LocalQueryRunner.execute (host clock, the card synchronized before each
run): the end-to-end wall whose host part the kernels' times leave out;
with --parent, per turn beside the device ms.

--variants (a tree with the generated direct kernel) also times Q6 and Q1
with the kernel's partials folded per pass (codegen.REG_PARTIALS = 0) and
with one CTA per work item instead of the persistent grid: where the
redesign's time went.  With "double" among the modes (a tree with
ScanPlan.staging) it also times each scan query's double launch under
the stage ring's other choices (RING_VARIANTS: one pass per stage, two
stages of one pass, long stages for a probe plan too, every array read
staged), each held bit for bit to the single launch first: the measured
ground of the plan's rule.
"""
import argparse
import math
import re
import statistics
import subprocess
import sys
import time
from typing import Optional

QUERIES = ("q6", "q1", "j2", "j2_noprobe", "float", "s1", "s2", "span_f",
           "span_f_cta", "j3", "h1", "h2", "j1", "hash_date_parts", "w1",
           "w2", "w3")
# the files --parent copies into the parent checkout
_COPIED = ("kernel_times.py", "grouped_queries.py", "join_queries.py",
           "expr_queries.py")
# a float64 sum over a selective filter (the direct kernel's float path)
FLOAT_QUERY = ("select sum(cast(l_extendedprice as double)) as s "
               "from lineitem where l_discount > 0.05")
HBM_BYTES_PER_S = 3.35e12


def events_ms(fn, n: int) -> float:
    """Wall ms per call on the stream (CUDA events), after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()  # lint: allow-host-sync
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    torch.cuda.synchronize()  # lint: allow-host-sync
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
    torch.cuda.synchronize()  # lint: allow-host-sync
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()  # lint: allow-host-sync
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


def _all_read(reads, shape):
    """Every per-row array the kernels read (the rule's alternative)."""
    return tuple(c for c in sorted(reads)
                 if shape[c][0] in ("plain", "dict"))


# the stage ring's other choices --variants times: scan_kernel knobs
RING_VARIANTS = (("one pass per stage", {"MAX_PASSES": 1}),
                 ("two stages of one pass", {"MAX_STAGES": 2,
                                             "MAX_PASSES": 1}),
                 ("long stages for a probe plan", {"PROBE_L1_BYTES": 1 << 40}),
                 ("every array read staged", {"staged_columns": _all_read}))


def ring_variant(knobs: dict, plan, fn, a, kw, launches: int):
    """(device ms, "S..P.. n.." of the staging, bit-identical to single) of
    the double launch under scan_kernel's `knobs`; (None, error, False)
    when that ring does not fit."""
    import torch
    from presto_tpu_torch.exec.kernels import scan_kernel as sk
    saved = {k: getattr(sk, k) for k in knobs}
    for k, v in knobs.items():
        setattr(sk, k, v)
    plan.dev.clear()
    kwd = dict(kw, dma="double")
    try:
        one, two = fn(*a, **kw), fn(*a, **kwd)
        torch.cuda.synchronize()  # lint: allow-host-sync
        slots = a[5] if len(a) > 5 else plan.G
        st = plan.staging(a[1], slots)
        same = _same_outputs(one, two)
        ms = device_ms(lambda: fn(*a, **kwd), launches)["kernels"]
        return ms, f"S{st.stages}P{st.passes} n{len(st.staged)}", same
    except NotImplementedError as e:
        return None, str(e)[:60], False
    finally:
        for k, v in saved.items():
            setattr(sk, k, v)
        plan.dev.clear()


def _same_outputs(one, two) -> bool:
    """Two launches' outputs equal bit for bit (a hash table group by
    group: its slots follow the claims' order)."""
    import torch
    from presto_tpu_torch.exec.operators import EMPTY_SLOT
    if hasattr(one, "keyhash"):
        def groups(t):
            occ = t.keyhash != EMPTY_SLOT
            order = torch.argsort(t.keyhash[occ])
            return (t.keyhash[occ][order], t.acc_i[:, occ][:, order],
                    t.acc_f[:, occ][:, order].view(torch.int64), t.counts)
        return all(torch.equal(x, y)
                   for x, y in zip(groups(one), groups(two)))
    return all(torch.equal(x.view(torch.int64), y.view(torch.int64))
               for x, y in zip(one, two))


def staging_line(qname, kernel, a) -> Optional[str]:
    """The stage ring's plan of a scan kernel call (None where the tree has
    no ScanPlan.staging, or for the window kernel)."""
    from presto_tpu_torch.exec.kernels import scan_kernel as sk
    plan, columns = a[0], a[1]
    if kernel == "window_scan" or not hasattr(plan, "staging"):
        return None
    slots = a[5] if kernel == "scan_hash" else plan.G
    st = plan.staging(columns, slots)
    staged = st.staged_bytes(sum(hi - lo for _b, lo, hi in a[2]))
    return (f"{qname} staging: arrays "
            f"{[plan.names[c] for c in st.staged]} S {st.stages} "
            f"P {st.passes} stage_bytes {st.stage_bytes} staged_mb "
            f"{staged / 1e6:.3f} "
            f"ring_bound_ms {staged / HBM_BYTES_PER_S * 1e3:.4f}")


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
    table, walls = {}, {}
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
        for m in re.finditer(r"^([\w/]+) \(\w+\): call_ms \S+ device_ms "
                             r"(\S+)", out.stdout, re.M):
            table.setdefault(m.group(1), []).append(
                f"{who} {float(m.group(2)):.4f}")
        for m in re.finditer(r"^(\w+) wall: median_ms (\S+)", out.stdout,
                             re.M):
            walls.setdefault(m.group(1), []).append(
                f"{who} {float(m.group(2)):.4f}")
    print("device ms per turn (parent, change, change, parent):")
    for q, cells in table.items():
        print(f"  {q}: {' | '.join(cells)}")
    if walls:
        print("median wall ms per turn (parent, change, change, parent):")
        for q, cells in walls.items():
            print(f"  {q}: {' | '.join(cells)}")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sf", default="10")
    ap.add_argument("--launches", type=int, default=20)
    ap.add_argument("--queries", default=",".join(QUERIES))
    ap.add_argument("--dma", default="single",
                    help="scan_kernel_dma modes to time, comma-separated")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--walls", type=int, default=0,
                    help="warm query walls to take the median of")
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
    from presto_tpu_torch.benchmarks.expr_queries import QUERIES as XQ
    from presto_tpu_torch.benchmarks.grouped_queries import (
        H1, H2, S1, S2, SPAN_F, SPAN_F_CTA)
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
    table = {"q6": Q6, "q1": Q1, "j2": J2, "j2_noprobe": J2_NOPROBE,
             "float": FLOAT_QUERY, "s1": S1, "s2": S2, "span_f": SPAN_F,
             "span_f_cta": SPAN_F_CTA, "j3": J3, "h1": H1, "h2": H2,
             "j1": J1, "hash_date_parts": XQ["hash_date_parts"],
             "w1": WQ.W1, "w2": WQ.W2, "w3": WQ.W3}
    modes = args.dma.split(",")
    kept = {}
    for qname in args.queries.split(","):
        n0 = {k: len(v) for k, v in calls.items()}
        runner.execute(table[qname])
        kernel, = [k for k in calls if len(calls[k]) > n0[k]][-1:]
        a, kw = calls[kernel][-1]
        launch = real[kernel]
        kept[qname] = (kernel, a, kw)
        if args.walls:
            n1, walls = len(calls[kernel]), []
            for _ in range(args.walls):
                torch.cuda.synchronize()  # lint: allow-host-sync
                t0 = time.perf_counter()
                runner.execute(table[qname])
                walls.append((time.perf_counter() - t0) * 1e3)
            del calls[kernel][n1:]
            print(f"{qname} wall: median_ms {statistics.median(walls):.4f} "
                  f"of {args.walls}", flush=True)
        if kernel == "window_scan":
            calls[kernel].clear()        # a call holds the sorted run
        for mode in modes if kernel != "window_scan" else ("single",):
            kwm = kw if mode == "single" else dict(kw, dma=mode)
            call_ms = events_ms(lambda: launch(*a, **kwm), args.launches)
            dev = device_ms(lambda: launch(*a, **kwm), args.launches)
            label = qname if mode == "single" else f"{qname}/{mode}"
            print(line(label, kernel, call_ms, dev), flush=True)
            if mode == "double" and staging_line(qname, kernel, a):
                print(staging_line(qname, kernel, a), flush=True)
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
        has_staging = hasattr(sk.ScanPlan, "staging")
        for qname, (kernel, a, kw) in kept.items():
            if "double" not in modes or kernel == "window_scan" \
                    or not has_staging:
                continue
            for name, knobs in RING_VARIANTS:
                ms, desc, same = ring_variant(knobs, a[0], real[kernel], a,
                                              kw, args.launches)
                print(f"{qname}/double [{name}] ({kernel}): device_ms "
                      + (f"{ms:.4f} {desc}, bit-identical to single "
                         f"{same}" if ms is not None else f"- ({desc})"),
                      flush=True)
    restore()
    return 0


if __name__ == "__main__":
    sys.exit(main())
