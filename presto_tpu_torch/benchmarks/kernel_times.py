"""The scan kernels' times on the main and join paths, for comparing two
checkouts of the port on one card.

    python3 -m presto_tpu_torch.benchmarks.kernel_times [--sf 10] [--launches 20]

Runs Q6, Q1 (direct), S1 (span), H1, H2 and J1 (hash) through
LocalQueryRunner on the card, keeps each query's last kernel call and
times it with CUDA events over `launches` launches after one warm-up,
then prints one line per query and, first, the card's name and power
limit.  It uses only the wrappers' calls, so the same file run from two
checkouts (PYTHONPATH at each, in turns: parent, change, change, parent)
compares their kernels within one call.
"""
import argparse
import subprocess
import sys


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sf", default="10")
    ap.add_argument("--launches", type=int, default=20)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("kernel_times: CUDA is not available", file=sys.stderr)
        return 2
    from presto_tpu_torch.benchmarks.grouped_queries import H1, H2, S1
    from presto_tpu_torch.benchmarks.join_queries import J1
    from presto_tpu_torch.benchmarks.tpch_queries import Q1, Q6
    from presto_tpu_torch.exec.kernels import grouped as gk
    from presto_tpu_torch.exec.kernels import scan_kernel as sk
    from presto_tpu_torch.exec.runner import LocalQueryRunner
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(f"card: {smi.stdout.strip().splitlines()[0]}")
    wrappers = {"scan_direct": sk, "scan_span": gk, "scan_hash": gk}
    real = {k: getattr(m, k) for k, m in wrappers.items()}
    calls = {k: [] for k in wrappers}

    def recorder(name):
        def recording(*a, **kw):
            calls[name].append((a, kw))
            return real[name](*a, **kw)
        return recording
    for k, m in wrappers.items():
        setattr(m, k, recorder(k))
    runner = LocalQueryRunner(f"sf{args.sf}", device=torch.device("cuda", 0))
    for qname, sql, kernel in (("q6", Q6, "scan_direct"),
                               ("q1", Q1, "scan_direct"),
                               ("s1", S1, "scan_span"),
                               ("h1", H1, "scan_hash"),
                               ("h2", H2, "scan_hash"),
                               ("j1", J1, "scan_hash")):
        runner.execute(sql)
        a, kw = calls[kernel][-1]
        launch = real[kernel]
        launch(*a, **kw)
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(args.launches):
            launch(*a, **kw)
        t1.record()
        torch.cuda.synchronize()
        print(f"{qname} ({kernel}): kernel_ms "
              f"{t0.elapsed_time(t1) / args.launches:.4f}", flush=True)
    for k, m in wrappers.items():
        setattr(m, k, real[k])
    return 0


if __name__ == "__main__":
    sys.exit(main())
