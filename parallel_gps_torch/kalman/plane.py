"""Single-pass plane scan and plane transpose: the kernels of the time-first
fused Kalman path, ``pkf / pks / pkfs`` on an ``LGSSM`` with
``engine="strip"`` (counterpart: the plane-scan section of
parallel_gps_tpu/kalman/pallas_scan.py, ``pallas_plane_scan`` and
``plane_transpose``, reached from ``timelast.pkf_pallas`` / ``pks_pallas``).

Elements are packed as (n, T) component rows in the JAX package's order —
filtering [A | b | C | J | η] (n = 3d²+2d), smoothing [E | g | L]
(n = 2d²+d) — by ``strip._pack``.  ``plane_scan`` is their inclusive
associative scan along T in one launch: a few steps a CUDA thread, a
Kogge–Stone scan of each tile's thread totals in shared memory and a
decoupled look-back across tiles, 32 predecessors at a time by a warp
(``csrc/plane_scan.cu``).  ``plane_transpose`` is the (r, c) →
(c, r) copy that every layout move of the path goes through.

Each wrapper dispatches on the device of its tensor:

  - CUDA, float32 or float64 (the scan: d ≤ 8): the hand-written kernel;
    anything else on CUDA raises;
  - CPU: the plain PyTorch version (``*_plain``).

``LAUNCHES`` counts kernel launches by kernel name.
"""
from __future__ import annotations

import torch
from torch import Tensor

from parallel_gps_torch.kalman.strip import _pack, _unpack_filt, _unpack_smooth, filt_rows, smooth_rows
from parallel_gps_torch.kalman.timelast import (
    filtering_identity_tl,
    filtering_operator_tl,
    kogge_stone_scan_tl,
    smoothing_identity_tl,
    smoothing_operator_tl,
)

LAUNCHES = {"plane_scan": 0, "plane_transpose": 0}
# The last scan launch's tiles, the predecessors its look-backs folded
# together (the decoupled look-back's work grows with their ratio) and the
# steps a tile holds.
LOOK_BACK = {"tiles": 0, "folded": 0, "steps": 0}

MAX_KERNEL_D = 8
KINDS = ("filter", "smoother")
# Polls of a predecessor's flag before the scan gives up and reports an
# overrun (each poll sleeps up to 256 ns): seconds, against the microseconds
# a predecessor takes.  Read at every launch.
MAX_POLLS = 1 << 22
OVERRUN = 1  # csrc/plane_scan.cu: kSpinOverrun


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def rows(d: int, kind: str) -> int:
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    return filt_rows(d) if kind == "filter" else smooth_rows(d)


# --------------------------------------------------------------------------
# Plain versions
# --------------------------------------------------------------------------


def plane_scan_plain(planes: Tensor, d: int, kind: str, reverse: bool = False) -> Tensor:
    """Inclusive scan of packed (n, T) element rows by the plain time-last
    Kogge–Stone engine, repacked."""
    if kind == "filter":
        elems, op, ident = _unpack_filt(planes, d), filtering_operator_tl, filtering_identity_tl
    else:
        elems, op, ident = _unpack_smooth(planes, d), smoothing_operator_tl, smoothing_identity_tl
    scanned = kogge_stone_scan_tl(op, elems, ident(d, planes.dtype, planes.device), reverse)
    return _pack(scanned, planes.shape[-1])


def plane_transpose_plain(x: Tensor) -> Tensor:
    """(r, c) → (c, r), contiguous.  The plain version of a transpose is the
    library call itself."""
    return x.t().contiguous()


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise ValueError(f"plane CUDA kernels: {what}")


def _check(x: Tensor, what: str) -> None:
    _require(x.device.type == "cuda", f"{what} must be on a CUDA device, got {x.device}")
    _require(x.dtype in (torch.float32, torch.float64), f"{what} must be float32 or float64, got {x.dtype}")
    _require(x.dim() == 2 and x.shape[0] >= 1 and x.shape[1] >= 1, f"{what} must be 2-D and non-empty, got {tuple(x.shape)}")
    _require(x.is_contiguous(), f"{what} must be contiguous")


def _bits(x: Tensor) -> int:
    return 64 if x.dtype == torch.float64 else 32


def plane_scan(planes: Tensor, d: int, kind: str, reverse: bool = False) -> Tensor:
    """Inclusive scan of packed (n, T) element rows along T (from the end,
    with ``reverse``), ``kind`` "filter" or "smoother"; one launch.  A spin
    of the look-back that outlasts ``MAX_POLLS`` polls raises."""
    n = rows(d, kind)
    if planes.device.type == "cpu":
        return plane_scan_plain(planes, d, kind, reverse)
    from parallel_gps_torch.kalman import _cuda

    _check(planes, "planes")
    _require(1 <= d <= MAX_KERNEL_D, f"state dimension {d} > {MAX_KERNEL_D}")
    _require(planes.shape[0] == n, f"{kind} planes of d = {d} have {n} rows, got {planes.shape[0]}")
    max_polls = MAX_POLLS
    _require(max_polls >= 0, f"MAX_POLLS must be >= 0, got {max_polls}")
    dev, dtype, T = planes.device, planes.dtype, planes.shape[1]
    lib, tag = _cuda.load(), f"d{d}_f{_bits(planes)}"
    threads, steps = scan_tiling(d, dtype)
    tile = threads * steps
    n_tiles = -(-T // tile)
    status = torch.zeros(3, dtype=torch.int32, device=dev)  # ticket, overrun, predecessors folded
    flags = torch.zeros(n_tiles, dtype=torch.int32, device=dev)
    # A tile's values are written before its flag is raised, and read after.
    agg = torch.empty((n_tiles, n), dtype=dtype, device=dev)
    incl = torch.empty((n_tiles, n), dtype=dtype, device=dev)
    out = torch.empty_like(planes)
    _cuda.launch(
        "plane_scan", getattr(lib, f"pgt_plane_scan_{tag}"), int(kind == "smoother"), int(reverse), planes, out, T,
        status, flags, agg, incl, max_polls, dev,
    )
    LAUNCHES["plane_scan"] += 1
    _, overrun, folded = status.tolist()
    LOOK_BACK.update(tiles=n_tiles, folded=folded, steps=tile)
    if overrun == OVERRUN:
        raise RuntimeError(f"plane_scan: a look-back spin outlasted {max_polls} polls ({kind}, d = {d}, T = {T})")
    return out


def scan_tiling(d: int, dtype) -> tuple:
    """(threads a block, steps a thread) of the scan kernel at state
    dimension d and ``dtype``: a tile is threads × steps steps
    (csrc/plane_scan.cu: PlaneSteps)."""
    from parallel_gps_torch.kalman import _cuda

    lib, tag = _cuda.load(), f"d{d}_f{64 if dtype == torch.float64 else 32}"
    return tuple(getattr(lib, f"pgt_plane_scan_{what}_{tag}")() for what in ("threads", "steps"))


def transpose_run(rows: int, cols: int, dtype) -> int:
    """Long-side steps a block of the transpose kernel moves for a (rows,
    cols) input: the narrow path's L where a side is at most 64 wide, 0 for
    the both-sides-wide tiles."""
    from parallel_gps_torch.kalman import _cuda

    return getattr(_cuda.load(), f"pgt_plane_transpose_run_f{64 if dtype == torch.float64 else 32}")(rows, cols)


def plane_transpose(x: Tensor) -> Tensor:
    """(r, c) → (c, r), contiguous; one launch."""
    if x.device.type == "cpu":
        return plane_transpose_plain(x)
    from parallel_gps_torch.kalman import _cuda

    _check(x, "x")
    out = torch.empty((x.shape[1], x.shape[0]), dtype=x.dtype, device=x.device)
    fn = getattr(_cuda.load(), f"pgt_plane_transpose_f{_bits(x)}")
    _cuda.launch("plane_transpose", fn, x, out, x.shape[0], x.shape[1], x.device)
    LAUNCHES["plane_transpose"] += 1
    return out
