"""Build and load the package's CUDA kernels (``csrc/*.cu``).

At first use, ``nvcc`` compiles the package's CUDA sources (one process per
translation unit, all started together; ``dt_scan.cu``, ``dt_fisher.cu`` and
``strip_scan.cu`` are one unit per state dimension, ``batched_scan.cu`` and
``plane_scan.cu`` one per state dimension and scalar type, ``VARIANTS``) and links them into a shared
library with a plain C interface, under ``build/parallel_gps_torch/`` at the
root of the checkout, and ``ctypes`` loads it.  The library's file name
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

# Threads per block of the two-pass scan kernels and the Fisher tail
# (csrc/dt_launch.cuh: kThreads).
THREADS = 128

# State dimensions the kernels are built for: every unit of the strip,
# batched and plane kernels (kalman/strip.py, kalman/batched.py,
# kalman/plane.py) and of the dt kernels' spectral family; the dt units of
# d ≤ 3 hold the exponential polynomial too (kalman/dt.py: MAX_KERNEL_D).
STRIP_DIMS = tuple(range(1, 9))
_BY_D = [(f"_d{d}", [f"-DPGT_D={d}"]) for d in STRIP_DIMS]
_BY_D_AND_TYPE = [
    (f"_d{d}_f{bits}", [f"-DPGT_D={d}", f"-DPGT_F64={int(bits == 64)}"]) for d in STRIP_DIMS for bits in (32, 64)
]
# Sources compiled more than once: {file name: [(object suffix, extra flags)]}.
VARIANTS = {
    "dt_scan.cu": _BY_D,
    "dt_fisher.cu": _BY_D,
    "strip_scan.cu": _BY_D,
    "batched_scan.cu": _BY_D_AND_TYPE,
    "plane_scan.cu": _BY_D_AND_TYPE,
}

_LIB = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
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
    h.update(repr(VARIANTS).encode())
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
        units = [(f, suffix, flags) for f in cu for suffix, flags in VARIANTS.get(f.name, [("", [])])]
        objs = [os.path.join(tmp, f.stem + suffix + ".o") for f, suffix, _ in units]
        cmds = [
            [nvcc, *NVCC_FLAGS, *flags, "-I", str(CSRC), "-c", "-o", o, str(f)]
            for (f, _, flags), o in zip(units, objs)
        ]
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
        # csrc/probes.cu (parallel_gps_torch/probes/)
        "pgt_probe_copy_chunk": [i, p, p, i, ll, i, p],
        "pgt_probe_copy_coalesced": [i, p, p, ll, p],
        "pgt_probe_copy_blocked": [i, p, p, ll, ll, p],
        "pgt_probe_read": [i, i, p, p, p, p, i, ll, i, p],
        "pgt_probe_tile_noop": [i, p, ll, p],
        "pgt_probe_tile_stream": [i, p, p, i, ll, i, p],
        "pgt_probe_tile_outwrite": [i, p, p, p, ll, i, p],
        "pgt_probe_tile_carry": [i, p, p, p, ll, i, p],
    }
    for d in STRIP_DIMS:
        # csrc/dt_scan.cu, csrc/dt_fisher.cu (kalman/dt.py): (is64, family, ...)
        sigs[f"pgt_dt_filter_scan_d{d}"] = [i, i, i, p, p, p, p, ll, i, p]
        sigs[f"pgt_dt_filter_apply_d{d}"] = [i, i, i, p, p, p, p, p, p, p, ll, i, p]
        sigs[f"pgt_dt_smoother_scan_d{d}"] = [i, i, i, p, p, p, p, p, ll, i, p]
        sigs[f"pgt_dt_smoother_apply_d{d}"] = [i, i, i, p, p, p, p, p, p, p, ll, i, p]
        sigs[f"pgt_dt_apply_threads_d{d}"] = [i, i, i]
        sigs[f"pgt_dt_apply_smem_d{d}"] = [i, i, i]
        sigs[f"pgt_dt_fisher_d{d}"] = [i, i, i, p, p, ll, p, ll, p, p, p, p, p, p, p, ll, i, i, p]
        sigs[f"pgt_dt_fisher_n_sums_d{d}"] = [i]
        sigs[f"pgt_strip_filter_scan_d{d}"] = [i, p, p, p, p, p, ll, i, p]
        sigs[f"pgt_strip_filter_apply_d{d}"] = [i, p, p, p, p, p, p, p, p, ll, i, p]
        sigs[f"pgt_strip_smoother_scan_d{d}"] = [i, p, p, p, p, p, ll, i, p]
        sigs[f"pgt_strip_smoother_apply_d{d}"] = [i, p, p, p, p, p, p, p, ll, i, p]
        for field in ("threads", "rows", "smem", "blocks_per_sm"):
            sigs[f"pgt_strip_apply_{field}_d{d}"] = [i, i]
        for field in _SCAN_FIELDS + ("blocks_per_sm",):
            sigs[f"pgt_strip_scan_{field}_d{d}"] = [i, i]
            sigs[f"pgt_dt_scan_{field}_d{d}"] = [i, i, i]
        for bits in (32, 64):
            sigs[f"pgt_batched_filter_d{d}_f{bits}"] = [p, p, ll, ll, p, ll, ll, p, ll, p, p, p, ll, i, p, p, p, ll, p]
            sigs[f"pgt_batched_smoother_d{d}_f{bits}"] = [
                i, p, p, ll, ll, p, ll, ll, p, ll, ll, p, ll, ll, p, p, p, p, ll, i, p, p, ll, p
            ]
            sigs[f"pgt_batched_tile_d{d}_f{bits}"] = [i, i]
            # csrc/plane_scan.cu (kalman/plane.py)
            sigs[f"pgt_plane_scan_d{d}_f{bits}"] = [i, i, i, p, p, ll, p, p, p, p, ll, p]
            sigs[f"pgt_plane_scan_threads_d{d}_f{bits}"] = []
            sigs[f"pgt_plane_scan_steps_d{d}_f{bits}"] = []
    for bits in (32, 64):
        sigs[f"pgt_plane_transpose_f{bits}"] = [p, p, ll, ll, p]
        sigs[f"pgt_plane_transpose_run_f{bits}"] = [ll, ll]
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
    from parallel_gps_torch.kalman import batched, dt, strip

    mirrors = [
        ("csrc/strip_scan.cu", "kalman/strip.py", "pass 2", strip_apply_stages(lib), strip.apply_stage),
        ("csrc/strip_scan.cu", "kalman/strip.py", "pass 1", strip_scan_stages(lib), strip.scan_stage),
        ("csrc/dt_scan.cu", "kalman/dt.py", "pass 1", dt_scan_stages(lib), dt.scan_stage),
        ("csrc/batched_scan.cu", "kalman/batched.py", "tile", batched_tiles(lib), batched.tile_shape),
    ]
    for source, mirror, what, stages, expected in mirrors:
        for unit, got in stages.items():
            if got != expected(*unit):
                raise RuntimeError(
                    f"{source} and {mirror} disagree on the {what} stage of unit {unit}: "
                    f"(threads, [steps, ]rows, bytes[, buffers]) {got} against {expected(*unit)}"
                )
    _LIB = lib
    return lib


_STAGE_FIELDS = ("threads", "rows", "smem")
_SCAN_FIELDS = _STAGE_FIELDS + ("buffers",)


def strip_apply_stages(lib) -> dict:
    """{(d, dtype, kind): (threads a block, rows a warp stages, dynamic shared
    memory a block in bytes)} of the strip pass-2 kernels, as the library
    ``lib`` was built."""
    import torch

    return {
        (d, dtype, kind): tuple(
            getattr(lib, f"pgt_strip_apply_{field}_d{d}")(int(dtype == torch.float64), int(kind == "smoother"))
            for field in _STAGE_FIELDS
        )
        for d in STRIP_DIMS
        for dtype in (torch.float32, torch.float64)
        for kind in ("filter", "smoother")
    }


def strip_scan_stages(lib) -> dict:
    """{(d, dtype, kind): (threads, rows a buffer, bytes, buffers)} of the
    strip filter's and smoother's pass-1 kernels, as the library ``lib`` was
    built."""
    import torch

    return {
        (d, dtype, kind): tuple(
            getattr(lib, f"pgt_strip_scan_{field}_d{d}")(int(dtype == torch.float64), int(kind == "smoother"))
            for field in _SCAN_FIELDS
        )
        for d in STRIP_DIMS
        for dtype in (torch.float32, torch.float64)
        for kind in ("filter", "smoother")
    }


def batched_tiles(lib, fields: int = 4) -> dict:
    """{(d, dtype, kind): (threads a block, steps a thread, rows a warp
    stages, dynamic shared memory a block in bytes[, blocks an SM holds])}
    of the batched kernels, as the library ``lib`` was built (the fifth
    field, the occupancy calculator's, with ``fields`` = 5)."""
    import torch

    return {
        (d, dtype, kind): tuple(
            getattr(lib, f"pgt_batched_tile_d{d}_f{64 if dtype == torch.float64 else 32}")(int(kind == "smoother"), f)
            for f in range(fields)
        )
        for d in STRIP_DIMS
        for dtype in (torch.float32, torch.float64)
        for kind in ("filter", "smoother")
    }


def dt_scan_stages(lib) -> dict:
    """{(family, d, dtype, kind): (threads, rows a buffer, bytes, buffers)}
    of the dt filter's and smoother's pass-1 kernels of each transition
    family at each d it is built for, as the library ``lib`` was built."""
    import torch

    from parallel_gps_torch.kalman import dt

    return {
        (family, d, dtype, kind): tuple(
            getattr(lib, f"pgt_dt_scan_{field}_d{d}")(
                int(dtype == torch.float64), dt.FAMILY_IDS[family], int(kind == "smoother")
            )
            for field in _SCAN_FIELDS
        )
        for family, top in dt.MAX_KERNEL_D.items()
        for d in range(1, top + 1)
        for dtype in (torch.float32, torch.float64)
        for kind in ("filter", "smoother")
    }


def launch(name: str, fn, *args) -> None:
    """Call the library entry ``fn`` on PyTorch's current stream of the device
    given last: tensors pass as their data pointers, other arguments as they
    are; the stream goes last.  Raises when the launch is refused."""
    import torch

    with torch.cuda.device(args[-1]):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        ptrs = [ctypes.c_void_p(a.data_ptr()) if isinstance(a, torch.Tensor) else a for a in args[:-1]]
        rc = fn(*ptrs, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed: {error_string(rc)}")


def error_string(rc: int) -> str:
    return f"{rc}: {load().pgt_error_string(rc).decode()}"
