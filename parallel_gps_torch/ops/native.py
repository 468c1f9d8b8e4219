"""The native balancing routine on the host (counterpart:
parallel_gps_tpu/ops/native.py).

``native/balance.c`` (the Parlett–Reinsch scale of the reference's numba
routine, pssgp/kernels/math_utils.py:10-29) is compiled with the system C
compiler at first use into ``build/parallel_gps_torch/native/`` (the file
name hashes the source and the flags) and called through ctypes.  The
compile writes a temporary name and renames it into place, so processes
that race to build it each load a whole library.  Without a compiler, or if
the compile fails, a numpy loop with the same semantics runs instead.  No
device is involved either way: the scale is a host constant.

The flags turn off floating-point contraction, so that the C routine sums
each row and column in the order of the vectorised loop of ops/balance.py,
one rounding a multiply and an add, and gives its bits at d ≤ 8 (numpy
sums eight lanes at a time from eight terms on).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parent.parent.parent
SOURCE = _ROOT / "native" / "balance.c"
BUILD_DIR = _ROOT / "build" / "parallel_gps_torch" / "native"
CFLAGS = ["-O2", "-fPIC", "-shared", "-ffp-contract=off"]

_LIB: list = []  # [ctypes.CDLL or None] once loading was tried


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes() + " ".join(CFLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libpgtbalance_{h}.so"


def _compile(so: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        subprocess.run(["cc", *CFLAGS, "-o", tmp, str(SOURCE)], check=True, capture_output=True, timeout=60)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load():
    """The compiled routine, built at first use, or ``None`` where it cannot
    be built or loaded (the numpy loop then runs)."""
    if _LIB:
        return _LIB[0]
    lib = None
    try:
        so = library_path()
        if not so.exists():
            _compile(so)
        lib = ctypes.CDLL(str(so))
        dbl = ctypes.POINTER(ctypes.c_double)
        lib.pgps_balance_scale.argtypes = [dbl, ctypes.c_int, ctypes.c_int, dbl]
        lib.pgps_balance_scale.restype = None
    except (OSError, subprocess.SubprocessError):
        lib = None
    _LIB.append(lib)
    return lib


def _np_balance_scale(F: np.ndarray, iters: int) -> np.ndarray:
    """The numpy loop with the C routine's semantics (native.py:63-77 of the
    JAX package)."""
    F = F.copy()
    n = F.shape[0]
    d = np.ones(n)
    for _ in range(iters):
        for i in range(n):
            c = np.sqrt(max(np.sum(F[:, i] ** 2) - F[i, i] ** 2, 0.0))
            r = np.sqrt(max(np.sum(F[i, :] ** 2) - F[i, i] ** 2, 0.0))
            if c > 0.0 and r > 0.0:
                f = np.sqrt(r / c)
                d[i] *= f
                F[:, i] *= f
                F[i, :] /= f
    return d


def balance_scale_host(F: np.ndarray, iters: int) -> np.ndarray:
    """Balancing scale vector (n,) of one (n, n) matrix, float64, on the
    host."""
    F = np.ascontiguousarray(F, dtype=np.float64)
    if F.ndim != 2 or F.shape[0] != F.shape[1]:
        raise ValueError(f"balance_scale_host takes one square matrix, got shape {F.shape}")
    lib = load()
    if lib is None:
        return _np_balance_scale(F, iters)
    n = F.shape[0]
    scratch = F.copy()
    out = np.empty(n, dtype=np.float64)
    dbl = ctypes.POINTER(ctypes.c_double)
    lib.pgps_balance_scale(scratch.ctypes.data_as(dbl), n, int(iters), out.ctypes.data_as(dbl))
    return out
