"""Build and load the dt-engine CUDA kernels (``csrc/*.cu``).

At first use, ``nvcc`` compiles the package's CUDA sources (one process per
source, all started together) and links them into a shared library with a
plain C interface, under ``build/parallel_gps_torch/`` at the root of the
checkout, and ``ctypes`` loads it.  The library's file name
carries a hash of the sources and flags, so an edited source is rebuilt and
an unchanged one is reused.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "parallel_gps_torch"
# -Xptxas -v: the build log lists each kernel's registers and spills.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Threads per block of every dt kernel (csrc/dt_launch.cuh: kThreads).
THREADS = 128

_LIB = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the dt-engine kernels need the CUDA toolkit")
    return path


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    cu, cuh = _sources()
    h = hashlib.sha256()
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libpgt_dt_{h.hexdigest()[:16]}.so"


def _run(cmd) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    return proc.stdout + proc.stderr


def build() -> tuple[Path, str]:
    """Compile the sources if their library is missing; returns the library
    path and the compiler's output (empty when nothing was built)."""
    so = library_path()
    if so.exists():
        return so, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, f.stem + ".o") for f in cu]
        cmds = [[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", o, str(f)] for f, o in zip(cu, objs)]
        with ThreadPoolExecutor(len(cmds)) as pool:
            logs = list(pool.map(_run, cmds))
        out = os.path.join(tmp, so.name)
        logs.append(_run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", out, *objs]))
        os.replace(out, so)
    return so, "".join(logs)


def load():
    """The loaded kernel library, built on first use."""
    global _LIB
    if _LIB is not None:
        return _LIB
    so, _ = build()
    lib = ctypes.CDLL(str(so))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    sigs = {
        "pgt_dt_filter_scan": [i, i, i, p, p, p, p, ll, i, p],
        "pgt_dt_filter_apply": [i, i, i, p, p, p, p, p, p, p, ll, i, p],
        "pgt_dt_smoother_scan": [i, i, i, p, p, p, p, p, ll, i, p],
        "pgt_dt_smoother_apply": [i, i, i, p, p, p, p, p, p, p, ll, i, p],
        "pgt_dt_fisher": [i, i, i, p, p, p, p, p, p, p, p, p, p, ll, i, p],
        "pgt_dt_fisher_n_sums": [i],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.pgt_error_string.argtypes = [ctypes.c_int]
    lib.pgt_error_string.restype = ctypes.c_char_p
    lib.pgt_threads_per_block.argtypes = []
    lib.pgt_threads_per_block.restype = ctypes.c_int
    if lib.pgt_threads_per_block() != THREADS:
        raise RuntimeError("csrc/dt_launch.cuh and kalman/_cuda.py disagree on threads per block")
    _LIB = lib
    return lib


def error_string(rc: int) -> str:
    return f"{rc}: {load().pgt_error_string(rc).decode()}"
