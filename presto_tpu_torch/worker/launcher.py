"""External-worker launcher: the integration point a Java coordinator's
test harness uses to spawn this worker per node.

The port of presto_tpu/worker/launcher.py.  The worker's device is
explicit: `launch_worker(..., device=...)` and the exec form's
`--device` (both "cuda" by default; a worker asked for the card where
CUDA is absent exits at start-up) reach the spawned worker's `--device`.

The reference wires native workers into a Java DistributedQueryRunner via
setExternalWorkerLauncher — a BiFunction<workerIndex, discoveryUri,
Process> that writes an etc/ directory (config.properties with the
discovery URI and an ephemeral port, node.properties, catalog mounts) and
execs the worker binary on it (DistributedQueryRunner.java:190-215,
PrestoNativeQueryRunnerUtils.java:434-520).  This module is that launcher
for the port's worker, in two forms:

- `launch_worker(worker_index, discovery_uri, ..., device="cuda")` -- the
  Python callable (spawns `python -m presto_tpu_torch.worker --etc-dir
  <tmpdir> --device <device>`).
- `python -m presto_tpu_torch.worker.launcher <workerIndex>
  <discoveryUri> [--device cuda|cpu]` -- the exec form for the Java side:
  the BiFunction body reduces to `new ProcessBuilder(python, "-m",
  "presto_tpu_torch.worker.launcher", String.valueOf(workerIndex),
  discoveryUri.toString()).start()`.

The spawned worker announces itself to the coordinator's discovery
service and serves the /v1/task protocol with reference-shaped
PlanFragment JSON (worker/plan_translation.py), so the Java scheduler
drives it like any native worker.
"""
from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import uuid
from typing import Dict, Optional


def write_etc_dir(worker_index: int, discovery_uri: str,
                  base_dir: Optional[str] = None,
                  extra_config: Optional[Dict[str, str]] = None,
                  catalogs: Optional[Dict[str, str]] = None) -> str:
    """Write the reference launcher's etc/ layout
    (PrestoNativeQueryRunnerUtils.java:453-520) and return its path."""
    root = base_dir or os.path.join(tempfile.gettempdir(),
                                    "presto_tpu_torch_workers")
    os.makedirs(root, exist_ok=True)
    etc = tempfile.mkdtemp(prefix=f"worker{worker_index}-", dir=root)
    config = {
        "discovery.uri": discovery_uri,
        "presto.version": "testversion",
        "http-server.http.port": "0",
        **(extra_config or {}),
    }
    with open(os.path.join(etc, "config.properties"), "w") as f:
        for k, v in config.items():
            f.write(f"{k}={v}\n")
    with open(os.path.join(etc, "node.properties"), "w") as f:
        f.write(f"node.id={uuid.uuid4()}\n"
                "node.internal-address=127.0.0.1\n"
                "node.environment=testing\n"
                "node.location=test-location\n")
    catalog_dir = os.path.join(etc, "catalog")
    os.makedirs(catalog_dir)
    if catalogs is None:
        catalogs = {"tpchstandard": "connector.name=tpch\n"}
    for name, body in catalogs.items():
        with open(os.path.join(catalog_dir, f"{name}.properties"), "w") as f:
            f.write(body)
    return etc


def launch_worker(worker_index: int, discovery_uri: str,
                  base_dir: Optional[str] = None,
                  extra_config: Optional[Dict[str, str]] = None,
                  catalogs: Optional[Dict[str, str]] = None,
                  stdout=None, device: str = "cuda") -> subprocess.Popen:
    """Spawn one external worker process on `device` announcing to
    `discovery_uri`; returns the Process (caller owns its lifetime, like
    the reference's externalWorkersBuilder)."""
    etc = write_etc_dir(worker_index, discovery_uri, base_dir,
                        extra_config, catalogs)
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [repo_root] + [p for p in
                       os.environ.get("PYTHONPATH", "").split(os.pathsep)
                       if p]))
    out = stdout if stdout is not None else open(
        os.path.join(etc, "worker.out"), "w")
    try:
        return subprocess.Popen(
            [sys.executable, "-m", "presto_tpu_torch.worker", "--etc-dir",
             etc, "--device", device],
            stdout=out, stderr=subprocess.STDOUT, env=env)
    finally:
        if stdout is None:
            out.close()   # the child holds its own duplicate


def main(argv=None) -> int:
    import argparse
    parser = argparse.ArgumentParser(
        prog="python -m presto_tpu_torch.worker.launcher")
    parser.add_argument("worker_index", type=int)
    parser.add_argument("discovery_uri")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    etc = write_etc_dir(args.worker_index, args.discovery_uri)
    # exec form: become the worker so the caller's Process handle IS the
    # worker (kill/waitFor work as the Java harness expects)
    os.execv(sys.executable,
             [sys.executable, "-m", "presto_tpu_torch.worker", "--etc-dir",
              etc, "--device", args.device])
    return 0  # unreachable


if __name__ == "__main__":
    sys.exit(main())
