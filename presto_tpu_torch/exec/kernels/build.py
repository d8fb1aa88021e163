"""Build and load the port's hand-written CUDA kernels.

Each source under csrc/ compiles with nvcc into a shared library with a
plain C interface (sm_90a, -O3), loaded with ctypes (a source of PARTS
compiles once per part, in parallel, and its objects link into one
library).  Libraries land in
build/presto_tpu_torch/ at the repository root (listed in .gitignore),
named by a hash of the source, the shared headers (csrc/*.cuh) and the
flags, so an edited source or header rebuilds and an unchanged one is
loaded as built.

Generated kernels (the direct and span scan kernels, one per chain
shape: codegen.py) compile at first use with NVRTC, the CUDA toolkit's
runtime compiler (libnvrtc, bound with ctypes), for sm_90a, and load
through the driver API (libcuda: cuModuleLoadData, cuLaunchKernel).  Each
cubin and its source are cached under build/presto_tpu_torch/gen/, named
by a hash of the source, the shared headers and the options
(serving/persist.py enable_compilation_cache moves that directory:
set_gen_dir).  A failed compile or load raises with the compiler's log.
Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "presto_tpu_torch"
# -fmad=false: no multiply-add contraction, so float64 expression results
# round exactly like the torch evaluator's separate multiply and add
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
SOURCES = ("scan_grouped", "window_scan")
# sources compiled once per part (-DSG_PART=k), all parts in parallel,
# then linked into the one library: scan_grouped.cu's eight kernel
# instances take most of the build, two in each of parts 1-4
PARTS = {"scan_grouped": 5}
GEN_DIR = BUILD_DIR / "gen"
# NVRTC's options for a generated kernel (the nvcc flags' counterparts)
NVRTC_OPTIONS = ("--gpu-architecture=sm_90a", "-std=c++17", "--fmad=false",
                 f"-I{CSRC}")

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# one build_all at a time: a caller that arrives during another's waits
# for it, then finds its libraries built
_BUILD_LOCK = threading.Lock()


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
    h.update(str(PARTS.get(name)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source, or for each of its PARTS; returns
    (processes, part objects, tmp, out, log, log file) or None when the
    library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = out.with_suffix(".log")
    src = str(CSRC / f"{name}.cu")
    if name in PARTS:
        objs = [out.with_suffix(f".{os.getpid()}.{k}.o")
                for k in range(PARTS[name])]
        flags = [f for f in NVCC_FLAGS if f != "-shared"]
        cmds = [[nvcc(), *flags, f"-DSG_PART={k}", "-c", "-o", str(o), src]
                for k, o in enumerate(objs)]
    else:
        objs = []
        cmds = [[nvcc(), *NVCC_FLAGS, "-o", str(tmp), src]]
    fh = open(log, "w")
    procs = [subprocess.Popen(c, stdout=fh, stderr=subprocess.STDOUT)
             for c in cmds]
    return procs, objs, tmp, out, log, fh


def build_all(names=SOURCES) -> List[Path]:
    """Build every source, one nvcc each, all started together (safe to
    run on a thread beside other work).  Raises with the compiler's
    output when a build fails."""
    with _BUILD_LOCK:
        jobs = [(n, _start(n)) for n in names]
        failed = []
        # wait for every nvcc before raising, so none outlives the call
        for name, job in jobs:
            if job is None:
                continue
            procs, objs, tmp, out, log, fh = job
            rc = next((r for r in [p.wait() for p in procs] if r), 0)
            if objs and rc == 0:
                rc = subprocess.run(
                    [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                     *map(str, objs)], stdout=fh,
                    stderr=subprocess.STDOUT).returncode
            fh.close()
            for o in objs:
                o.unlink(missing_ok=True)
            if rc != 0:
                failed.append(f"nvcc failed for {name}.cu:\n"
                              + log.read_text())
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


# ---------------------------------------------------------------------------
# generated kernels: NVRTC + the driver API
# ---------------------------------------------------------------------------

CUDA_HOME = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
# the driver API's attribute and limit numbers (cuda.h)
_CU_FUNC_ATTRIBUTE_NUM_REGS = 4
_CU_FUNC_ATTRIBUTE_LOCAL_SIZE_BYTES = 3
_CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES = 8
_CU_DEVICE_ATTRIBUTE_MULTIPROCESSOR_COUNT = 16

_libs: Dict[str, ctypes.CDLL] = {}
_MODULES: Dict[Tuple[str, int], "GenModule"] = {}
# compile ms per generated source hash (first use in this process: an
# NVRTC compile, or 0.0 when the cubin came from the cache directory)
COMPILE_MS: Dict[str, float] = {}
# (cache directory, source hash) of every cubin known to be on disk there
_ON_DISK: set = set()


def set_gen_dir(path) -> None:
    """Read and write generated cubins under `path` from now on (the
    serving plane's compilation cache).  A module already loaded in this
    process is written there at its next use."""
    global GEN_DIR
    with _LOCK:
        GEN_DIR = Path(path)


def _write_cubin(key: str, cubin: bytes) -> None:
    """The cubin under GEN_DIR, written atomically (caller holds _LOCK)."""
    GEN_DIR.mkdir(parents=True, exist_ok=True)
    cubin_path = GEN_DIR / f"{key}.cubin"
    tmp = cubin_path.with_suffix(f".{os.getpid()}.tmp")
    tmp.write_bytes(cubin)
    os.replace(tmp, cubin_path)
    _ON_DISK.add((GEN_DIR, key))


def _nvrtc() -> ctypes.CDLL:
    """libnvrtc of the CUDA toolkit (CUDA_HOME, default /usr/local/cuda)."""
    lib = _libs.get("nvrtc")
    if lib is None:
        found = sorted((CUDA_HOME / "lib64").glob("libnvrtc.so*"))
        if not found:
            raise RuntimeError(f"libnvrtc not found under {CUDA_HOME}/lib64: "
                               f"the generated kernels compile only where "
                               f"the CUDA toolkit is installed")
        lib = _libs["nvrtc"] = ctypes.CDLL(str(found[0]))
        lib.nvrtcGetErrorString.restype = ctypes.c_char_p
    return lib


def _cuda() -> ctypes.CDLL:
    lib = _libs.get("cuda")
    if lib is None:
        lib = _libs["cuda"] = ctypes.CDLL("libcuda.so.1")
    return lib


def _check_cu(rc: int, what: str) -> None:
    if rc != 0:
        msg = ctypes.c_char_p()
        _cuda().cuGetErrorString(rc, ctypes.byref(msg))
        raise RuntimeError(f"{what} failed: CUDA driver error {rc} "
                           f"({(msg.value or b'').decode()})")


_GEN_KEYS: Dict[str, str] = {}


def gen_key(source: str) -> str:
    """The cache key of a generated source: its hash with the shared
    headers' and the options' (kept per source for the process, so a
    launch does not reread the headers)."""
    key = _GEN_KEYS.get(source)
    if key is None:
        key = _GEN_KEYS[source] = _hash_source(source)
    return key


def _hash_source(source: str) -> str:
    h = hashlib.sha256(source.encode())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVRTC_OPTIONS[:-1]).encode())
    return h.hexdigest()[:20]


def compile_cubin(source: str, name: str = "gen.cu") -> bytes:
    """NVRTC: the sm_90a cubin of `source`; raises with the log."""
    nv = _nvrtc()
    prog = ctypes.c_void_p()

    def check(rc, what):
        if rc != 0:
            raise RuntimeError(f"{what}: {nv.nvrtcGetErrorString(rc).decode()}")
    check(nv.nvrtcCreateProgram(ctypes.byref(prog), source.encode(),
                                name.encode(), 0, None, None),
          "nvrtcCreateProgram")
    try:
        opts = [o.encode() for o in NVRTC_OPTIONS]
        arr = (ctypes.c_char_p * len(opts))(*opts)
        rc = nv.nvrtcCompileProgram(prog, len(opts), arr)
        size = ctypes.c_size_t()
        nv.nvrtcGetProgramLogSize(prog, ctypes.byref(size))
        log = ctypes.create_string_buffer(size.value + 1)
        nv.nvrtcGetProgramLog(prog, log)
        if rc != 0:
            raise RuntimeError(f"NVRTC failed for {name} "
                               f"({nv.nvrtcGetErrorString(rc).decode()}):\n"
                               f"{log.value.decode(errors='replace')}")
        check(nv.nvrtcGetCUBINSize(prog, ctypes.byref(size)),
              "nvrtcGetCUBINSize")
        cubin = ctypes.create_string_buffer(size.value)
        check(nv.nvrtcGetCUBIN(prog, cubin), "nvrtcGetCUBIN")
        return cubin.raw
    finally:
        nv.nvrtcDestroyProgram(ctypes.byref(prog))


def _ensure_context(device_index: int) -> None:
    """Make the device's primary context (the one PyTorch uses) current on
    this thread."""
    cu = _cuda()
    ctx = ctypes.c_void_p()
    _check_cu(cu.cuCtxGetCurrent(ctypes.byref(ctx)), "cuCtxGetCurrent")
    if ctx.value:
        return
    dev = ctypes.c_int()
    _check_cu(cu.cuDeviceGet(ctypes.byref(dev), device_index), "cuDeviceGet")
    _check_cu(cu.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), dev),
              "cuDevicePrimaryCtxRetain")
    _check_cu(cu.cuCtxSetCurrent(ctx), "cuCtxSetCurrent")


class GenModule:
    """A loaded generated module: its kernels by name, each launched with
    one by-value argument (an int64 word array)."""

    def __init__(self, key: str, cubin: bytes, device_index: int):
        self.key = key
        self.device_index = device_index
        self.cubin = cubin
        cu = _cuda()
        _ensure_context(device_index)
        self._image = ctypes.create_string_buffer(cubin, len(cubin))
        self.handle = ctypes.c_void_p()
        _check_cu(cu.cuModuleLoadData(ctypes.byref(self.handle), self._image),
                  f"cuModuleLoadData ({key})")
        self._fns: Dict[str, ctypes.c_void_p] = {}
        self._smem: Dict[str, int] = {}

    def function(self, name: str) -> ctypes.c_void_p:
        fn = self._fns.get(name)
        if fn is None:
            fn = ctypes.c_void_p()
            _check_cu(_cuda().cuModuleGetFunction(
                ctypes.byref(fn), self.handle, name.encode()),
                f"cuModuleGetFunction {name}")
            self._fns[name] = fn
        return fn

    def attributes(self, name: str) -> Dict[str, int]:
        """Registers per thread and local (spill) bytes of a kernel."""
        fn, out = self.function(name), {}
        for k, a in (("registers", _CU_FUNC_ATTRIBUTE_NUM_REGS),
                     ("local_bytes", _CU_FUNC_ATTRIBUTE_LOCAL_SIZE_BYTES)):
            v = ctypes.c_int()
            _check_cu(_cuda().cuFuncGetAttribute(ctypes.byref(v), a, fn),
                      "cuFuncGetAttribute")
            out[k] = v.value
        return out

    def launch(self, name: str, grid, threads, smem: int,
               stream: int, words) -> None:
        """Launch kernel `name` on `stream` with its argument array `words`
        (a ctypes int64 array); `grid` and `threads` are a count or an
        (x, y) pair.  Raises on a refused launch."""
        cu = _cuda()
        _ensure_context(self.device_index)
        fn = self.function(name)
        if smem > 48 * 1024 and self._smem.get(name, 0) < smem:
            _check_cu(cu.cuFuncSetAttribute(
                fn, _CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES, smem),
                f"cuFuncSetAttribute {name}")
            self._smem[name] = smem
        gx, gy = grid if isinstance(grid, tuple) else (grid, 1)
        tx, ty = threads if isinstance(threads, tuple) else (threads, 1)
        params = (ctypes.c_void_p * 1)(ctypes.addressof(words))
        _check_cu(cu.cuLaunchKernel(fn, gx, gy, 1, tx, ty, 1, smem,
                                    ctypes.c_void_p(stream), params, None),
                  f"cuLaunchKernel {name}")


def load_generated(source: str, device_index: int) -> GenModule:
    """The loaded module of a generated source, compiled with NVRTC on
    first use (or read from the cache directory) and loaded once per
    device."""
    key = gen_key(source)
    with _LOCK:
        mod = _MODULES.get((key, device_index))
        if mod is not None:
            if (GEN_DIR, key) not in _ON_DISK:
                # loaded before the cache directory moved: persist it
                if not (GEN_DIR / f"{key}.cubin").exists():
                    _write_cubin(key, mod.cubin)
                _ON_DISK.add((GEN_DIR, key))
            return mod
        cubin_path = GEN_DIR / f"{key}.cubin"
        if cubin_path.exists():
            cubin = cubin_path.read_bytes()
            COMPILE_MS.setdefault(key, 0.0)
            _ON_DISK.add((GEN_DIR, key))
        else:
            GEN_DIR.mkdir(parents=True, exist_ok=True)
            (GEN_DIR / f"{key}.cu").write_text(source)
            t0 = time.perf_counter()  # lint: allow-wall-clock
            cubin = compile_cubin(source, f"{key}.cu")
            ms = (time.perf_counter() - t0) * 1e3  # lint: allow-wall-clock
            COMPILE_MS[key] = ms
            _write_cubin(key, cubin)
        mod = _MODULES[(key, device_index)] = GenModule(key, cubin,
                                                        device_index)
        return mod


def multiprocessors(device_index: int) -> int:
    """The device's SM count (driver API)."""
    cu = _cuda()
    _ensure_context(device_index)
    v, dev = ctypes.c_int(), ctypes.c_int()
    _check_cu(cu.cuDeviceGet(ctypes.byref(dev), device_index), "cuDeviceGet")
    _check_cu(cu.cuDeviceGetAttribute(
        ctypes.byref(v), _CU_DEVICE_ATTRIBUTE_MULTIPROCESSOR_COUNT, dev),
        "cuDeviceGetAttribute")
    return v.value
