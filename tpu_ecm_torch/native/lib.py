"""ctypes loader/builder for the native host components.

Copy of tpu_ecm/native/lib.py (the port imports nothing of tpu_ecm) that
builds elsewhere: g++ -O2 compiles sieve.cpp and planner.cpp at first use
into build/tpu_ecm_torch/ beside the package (a directory .gitignore
lists), never next to the sources.  The file name carries a hash of the
sources and flags, so an edited source is rebuilt, and the library is
written under a temporary name and renamed, so processes that build at
once never load a half-written file.  Every caller has a pure-Python
fallback, so a missing toolchain degrades gracefully (primes/sieve.py,
curve/prac.py, stage2/plan.py); `available()` says which one runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_PKG = os.path.dirname(_DIR)
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "tpu_ecm_torch")
_SOURCES = [os.path.join(_DIR, f) for f in ("sieve.cpp", "planner.cpp")]
_FLAGS = ["-O2", "-march=native", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in _SOURCES:
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"libtpuecm_native_{h.hexdigest()[:16]}.so")


def _build() -> Optional[str]:
    try:
        out = library_path()
        if os.path.exists(out):
            return out
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        subprocess.run(["g++", *_FLAGS, "-o", tmp, *_SOURCES], check=True,
                       capture_output=True)
        os.replace(tmp, out)
        return out
    except Exception:
        return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        lib.tpuecm_primes_range.restype = ctypes.c_uint64
        lib.tpuecm_primes_range.argtypes = [
            ctypes.c_uint64, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64]
        lib.tpuecm_stage1_tape.restype = ctypes.c_uint64
        lib.tpuecm_stage1_tape.argtypes = [
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64,
            ctypes.c_uint64, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_uint64]
        lib.tpuecm_pair.restype = ctypes.c_uint64
        lib.tpuecm_pair.argtypes = [
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64,
            ctypes.c_uint64, ctypes.c_uint64,
            ctypes.c_uint32, ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint32)]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _u64ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def primes_range(lo: int, hi: int) -> np.ndarray:
    lib = _load()
    assert lib is not None
    import math
    width = max(hi - lo, 16)
    est = int(width / max(math.log(max(hi, 3)) - 1.2, 1.0)) + 64
    while True:
        out = np.empty(est, dtype=np.uint64)
        n = lib.tpuecm_primes_range(lo, hi, _u64ptr(out), est)
        if n <= est:
            return out[:n].copy()
        est = n + 16


def stage1_tape(primes: np.ndarray, b1: int, include_two: bool) -> np.ndarray:
    lib = _load()
    assert lib is not None
    primes = np.ascontiguousarray(primes, dtype=np.uint64)
    est = 64 + int(4.5 * b1)  # generous: ~2.1 entries/bit * 1.44*b1 bits
    while True:
        out = np.empty((est, 5), dtype=np.int32)
        n = lib.tpuecm_stage1_tape(
            _u64ptr(primes), len(primes), b1, int(include_two),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), est)
        if n <= est:
            return out[:n].copy()
        est = int(n) + 16


def pair(primes: np.ndarray, b1: int, b2: int, D: int, U: int
         ) -> Tuple[np.ndarray, np.ndarray, int]:
    lib = _load()
    assert lib is not None
    primes = np.ascontiguousarray(primes, dtype=np.uint64)
    est = len(primes) + 4 * (b2 - b1) // (4 * D * U) + 64
    while True:
        out_v = np.empty(est, dtype=np.uint32)
        out_u = np.empty(est, dtype=np.uint32)
        amin = ctypes.c_uint32(0)
        n = lib.tpuecm_pair(
            _u64ptr(primes), len(primes), b1, b2, D, U,
            out_v.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            out_u.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            est, ctypes.byref(amin))
        if n <= est:
            return out_v[:n].copy(), out_u[:n].copy(), int(amin.value)
        est = int(n) + 16
