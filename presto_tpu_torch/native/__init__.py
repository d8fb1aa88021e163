"""Native (C++) host-side kernels, loaded via ctypes: the port's copy of
presto_tpu/native.

`kernels.cpp` is built with g++ at first use into
build/presto_tpu_torch/native/ (beside the CUDA builds of
exec/kernels/build.py, never into the package directory), under a name
that carries the source's hash, so an edited source rebuilds.  The
whole-column string hoists of exec/pipeline.py (`_column_substr_codes`,
`_column_like_mask`) call `substr_dict_encode` / `like_match`; each
returns None where the library is missing or a string is not ASCII, and
the caller then runs its Python loop, the plain version the tests hold
the library to.  `load(require=True)` raises with the compiler's output
where the build fails.  CALLS counts the calls that ran natively.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "kernels.cpp"
BUILD_DIR = (Path(__file__).resolve().parents[2] / "build"
             / "presto_tpu_torch" / "native")

# calls served by the library, per entry point (bumped under _calls_lock:
# scan drivers hoist on threads)
CALLS = {"like_match": 0, "substr_dict_encode": 0}
_calls_lock = threading.Lock()

_lib = None
_lib_lock = threading.Lock()
_build_error: Optional[str] = None


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libkernels-{digest}.so"


def _build(path: Path) -> Optional[str]:
    """Compile kernels.cpp to `path` (atomic replace; safe under
    concurrent builders).  Returns None, or the error text."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", tmp,
             str(_SRC)], check=True, capture_output=True, timeout=120)
        os.replace(tmp, path)
        return None
    except subprocess.CalledProcessError as e:
        err = e.stderr.decode(errors="replace") or str(e)
    except (subprocess.SubprocessError, OSError) as e:
        err = str(e)
    try:
        os.unlink(tmp)
    except OSError:
        pass
    return err


def load(require: bool = False):
    """The loaded library, or None when it cannot be built (the callers
    then run Python).  `require=True` raises RuntimeError instead."""
    global _lib, _build_error
    if _lib is None and _build_error is None:
        with _lib_lock:
            if _lib is None and _build_error is None:
                path = library_path()
                if not path.exists():
                    _build_error = _build(path)
                if _build_error is None:
                    try:
                        _lib = _bind(ctypes.CDLL(str(path)))
                    except OSError as e:
                        _build_error = str(e)
    if _lib is None and require:
        raise RuntimeError(f"native kernels did not build: {_build_error}")
    return _lib


def _bind(lib):
    lib.ptn_like.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8)]
    lib.ptn_like.restype = None
    lib.ptn_substr_dict_encode.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64,
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32)]
    lib.ptn_substr_dict_encode.restype = ctypes.c_int64
    lib.ptn_hash_combine.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_uint64)]
    lib.ptn_hash_combine.restype = None
    return lib


def pack_strings(strings: List[str]
                 ) -> Optional[Tuple[bytes, np.ndarray]]:
    """list[str] -> (utf-8 buffer, int64 offsets[n+1]), or None when any
    string is non-ASCII (byte-wise kernels would miscount characters)."""
    n = len(strings)
    offsets = np.zeros(n + 1, dtype=np.int64)
    lens = np.fromiter((len(s) for s in strings), dtype=np.int64, count=n)
    np.cumsum(lens, out=offsets[1:])
    data = "".join(strings).encode("utf-8")
    if len(data) != int(offsets[-1]):
        return None  # non-ASCII: char count != byte count
    return data, offsets


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def like_match(strings: List[str], pattern: str,
               escape: Optional[str] = None) -> Optional[np.ndarray]:
    """Vectorized SQL LIKE over a string list; None -> caller falls back to
    the Python matcher (no native lib, or non-ASCII input)."""
    lib = load()
    if lib is None:
        return None
    packed = pack_strings(strings)
    if packed is None:
        return None
    try:
        pat = pattern.encode("ascii")
    except UnicodeEncodeError:
        return None
    data, offsets = packed
    out = np.zeros(len(strings), dtype=np.uint8)
    esc = ord(escape) if escape else -1
    lib.ptn_like(data, _i64p(offsets), len(strings), pat, len(pat), esc,
                 out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    with _calls_lock:
        CALLS["like_match"] += 1
    return out.astype(bool)


def substr_dict_encode(strings: List[str], start: int, length: Optional[int],
                       dictionary: Tuple[str, ...]) -> Optional[np.ndarray]:
    """codes[i] = index of substr(strings[i], start, length) in the sorted
    dictionary.  None -> fall back to Python.  Raises KeyError when a value
    is missing from the dictionary (callers build exhaustive dictionaries)."""
    lib = load()
    if lib is None:
        return None
    packed = pack_strings(strings)
    dpacked = pack_strings(list(dictionary))
    if packed is None or dpacked is None:
        return None
    data, offsets = packed
    ddata, doffsets = dpacked
    out = np.zeros(len(strings), dtype=np.int32)
    missing = lib.ptn_substr_dict_encode(
        data, _i64p(offsets), len(strings), start,
        -1 if length is None else length,
        ddata, _i64p(doffsets), len(dictionary),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if missing:
        raise KeyError(f"{missing} values missing from dictionary")
    with _calls_lock:
        CALLS["substr_dict_encode"] += 1
    return out
