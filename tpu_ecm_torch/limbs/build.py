"""Build and load the CUDA kernels of tpu_ecm_torch/csrc.

nvcc compiles every csrc/*.cu for sm_90a into one shared library with a
plain C interface, at first use, into build/tpu_ecm_torch/ beside the
package (a directory .gitignore lists).  The file name carries a hash of the
sources and flags, so an edited kernel is rebuilt and a stale library is
never loaded.  The library is loaded with ctypes; every entry point takes
device pointers and the CUDA stream as void*, returns cudaGetLastError()
as an int, and launches without synchronising.

Importing this module builds nothing, so it imports on a machine without
nvcc, where the CPU tests run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "tpu_ecm_torch")
HEADERS = ("arith.cuh",)
SOURCES = ("tape.cu", "chain.cu", "batch_inverse.cu", "replay.cu")

# Largest digit count the kernels take: the digit engine's int32 column
# bound ends at nw = 210 (params._radix_or_host_only, ~2080 bits).
NW_MAX = 224
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
         f"-DTPUECM_NW_MAX={NW_MAX}")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# argument lists of the extern "C" entry points (pointers and stream as
# void*, so ctypes never truncates them to 32 bits)
SIGNATURES = {
    "tpuecm_tape": [_P, _L, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "tpuecm_chain": [_P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P],
    "tpuecm_prefix": [_P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P],
    "tpuecm_apply_inverse": [_P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I,
                             _I, _P],
    "tpuecm_replay": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib = None


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def source_key() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in HEADERS + SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def library_path() -> str:
    return os.path.join(BUILD_DIR, f"libtpuecm_kernels_{source_key()}.so")


def build() -> str:
    """Compile the kernels unless this source hash is built; returns the
    library path.  nvcc's output (with -Xptxas -v: registers, stack frame
    and spills of every kernel) is kept beside it as a .log file."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ([nvcc_path(), *FLAGS, "-I", CSRC, "-o", tmp]
           + [os.path.join(CSRC, s) for s in SOURCES])
    res = subprocess.run(cmd, capture_output=True, text=True)
    with open(out[:-3] + ".log", "w") as f:
        f.write(" ".join(cmd) + "\n" + res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{res.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib
