"""Build and load the port's hand-written CUDA kernels.

Each source under csrc/ compiles with nvcc into a shared library with a
plain C interface (sm_90a, -O3), loaded with ctypes.  Libraries land in
build/presto_tpu_torch/ at the repository root (listed in .gitignore),
named by a hash of the source, the shared headers (csrc/*.cuh) and the
flags, so an edited source or header rebuilds and an unchanged one is
loaded as built.  Nothing here runs at import time: the first launch of
a kernel builds it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "presto_tpu_torch"
# -fmad=false: no multiply-add contraction, so float64 expression results
# round exactly like the torch evaluator's separate multiply and add
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
SOURCES = ("scan_direct", "scan_grouped", "window_scan")

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return path


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source; returns (process, tmp, out, log) or None
    when the library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = out.with_suffix(".log")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    fh = open(log, "w")
    proc = subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT)
    return proc, tmp, out, log, fh


def build_all(names=SOURCES) -> List[Path]:
    """Build every source, one nvcc each, all started together.  Raises
    with the compiler's output when a build fails."""
    jobs = [(n, _start(n)) for n in names]
    failed = []
    # wait for every nvcc before raising, so none outlives the call
    for name, job in jobs:
        if job is None:
            continue
        proc, tmp, out, log, fh = job
        rc = proc.wait()
        fh.close()
        if rc != 0:
            failed.append(f"nvcc failed for {name}.cu:\n" + log.read_text())
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return [library_path(n) for n in names]


def build_log(name: str) -> str:
    """The compiler's output (ptxas register/shared-memory report) for the
    current build of `name`, or '' when it was not built here."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `name`, building it on first use."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            build_all((name,))
            lib = _LOADED[name] = ctypes.CDLL(str(library_path(name)))
        return lib
