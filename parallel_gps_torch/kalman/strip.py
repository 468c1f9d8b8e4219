"""Plane-streaming ("strip") filter and smoother on an explicit time-last
model (counterpart: the strip engine of
parallel_gps_tpu/kalman/pallas_scan.py, ``strip_filter`` / ``strip_smoother``).

The per-step transitions and noises are given as (d, d, T) planes — a
state-space model the caller built, or a kernel with no closed-form
transition family (``SDEKernel.transition_coeffs()`` is ``None``), d ≤ 8.

The filter and the smoother are each a two-pass chunked scan over chunks of
``CHUNK`` consecutive steps: pass 1 folds each chunk to its total, an
exclusive prefix over the (n, n_chunks) totals runs in plain PyTorch on the
totals' device (``exclusive_chunk_prefixes``), and pass 2 re-folds each chunk
seeded with its prefix and writes the moments (the filter's pass 2 also
streams the log-likelihood).  Each pass is a wrapper that dispatches on the
device of its tensors:

  - CUDA, d ≤ 8, float32 or float64: the hand-written kernel of
    ``csrc/strip_scan.cu`` (one thread per chunk; the passes stage their rows
    through shared memory a warp at a time, each unit by its budget,
    ``apply_stage`` and ``scan_stage``, the filter's pass 1 at the units of
    ``FILTER_SCAN_STAGED``); anything else on CUDA raises;
  - CPU: the plain PyTorch version of the same pass (``*_plain``).

The dt-engine (``kalman/dt.py``) runs the same algorithm with F and Q rebuilt
from dt; the chunk helpers here serve both.

``LAUNCHES`` counts kernel launches by kernel name.
"""
from __future__ import annotations

import torch
from torch import Tensor

from parallel_gps_torch.kalman.timelast import (
    FilteringElementTL,
    SmoothingElementTL,
    _filtering_elements_from_planes,
    _loglik_from_planes,
    _map,
    _smoothing_elements_from_planes,
    exclusive_shift,
    filtering_identity_tl,
    filtering_operator_tl,
    kogge_stone_scan_tl,
    smoothing_identity_tl,
    smoothing_operator_tl,
)

LAUNCHES = {"strip_filter_scan": 0, "strip_filter_apply": 0, "strip_smoother_scan": 0, "strip_smoother_apply": 0}

# Steps folded sequentially by one CUDA thread (both engines).
CHUNK = 64
MAX_KERNEL_D = 8

# The pass-2 kernels' shared-memory budget (csrc/strip_scan.cu: ApplyStage),
# mirrored here and checked against the library when it loads
# (kalman/_cuda.py).  A warp stages 32 / itemsize steps of its 32 chunks, a
# chunk's steps of a row in a slot of one more value.  The filter stages its
# F, Q and y rows (2d² + 1, b and C written in place); the smoother either
# its b, C, F and Q rows (3d² + d) or the moments alone (d + d² rows, g and L
# written in place, F and Q loaded strided).  A block is 4, 2 or 1 warps,
# whichever leaves an SM the most warps by shared memory (the larger block on
# a tie), the filter's per-thread block sum included, within SMEM_LIMIT.
SMEM_LIMIT = 232_448  # shared memory a block may opt in to on an H100, bytes
SMEM_PER_SM = 233_472  # an H100 SM's shared memory, bytes
SMEM_RESERVED = 1_024  # the CUDA runtime's share of it for each block
# The state dimensions whose smoother pass 2 stages its F, Q planes, by scalar
# type, where that measured faster on an H100 (PERF.md §6); the rest stage
# their moments alone.
SMOOTHER_PLANES = {torch.float32: frozenset(range(1, 7)), torch.float64: frozenset({1, 3, 4, 5, 6})}
# The same choice for the smoother's pass 1 (csrc/strip_scan.cu: StripScan,
# kScanPlanesF32 / kScanPlanesF64), by its own measurement (PERF.md §6); and
# its units that stage two buffers, the next round's copy in flight while one
# is folded (kScanTwoF32 / kScanTwoF64).
SCAN_PLANES = {torch.float32: frozenset(range(1, 8)), torch.float64: frozenset(range(1, 7))}
SCAN_TWO_BUFFERS = {torch.float32: frozenset({1, 2}), torch.float64: frozenset({1, 2, 4, 7})}
# The filter pass 1's units that stage their F, Q and y rows, and those of
# them that stage two buffers (csrc/strip_scan.cu: StripFilterScan,
# kFilterScanStagedF32, kFilterScanTwoF32, …), where each measured faster on
# an H100 (PERF.md §6); the rest read their rows directly, each thread its
# own chunk's (no buffer).
FILTER_SCAN_STAGED = {torch.float32: frozenset(range(1, 8)), torch.float64: frozenset(range(2, 7))}
FILTER_SCAN_TWO_BUFFERS = {torch.float32: frozenset({1, 2, 3}), torch.float64: frozenset({2, 3})}


def filt_rows(d: int) -> int:
    """Components of a filtering element: A (d²), b (d), C (d²), J (d²), η (d)."""
    return 3 * d * d + 2 * d


def smooth_rows(d: int) -> int:
    """Components of a smoothing element: E (d²), g (d), L (d²)."""
    return 2 * d * d + d


def n_chunks(T: int) -> int:
    return -(-T // CHUNK)


def apply_stage(d: int, dtype, kind: str) -> tuple[int, int, int]:
    """(threads a block, rows a warp stages, dynamic shared memory a block in
    bytes) of the ``kind`` ("filter" or "smoother") pass-2 kernel at state
    dimension ``d`` and scalar type ``dtype``."""
    if kind == "filter":
        rows = 2 * d * d + 1
    elif d in SMOOTHER_PLANES[dtype]:
        rows = 3 * d * d + d
    else:
        rows = d + d * d
    size = torch.finfo(dtype).bits // 8
    return warp_stage_budget(rows, dtype, per_thread=size if kind == "filter" else 0)


def scan_stage(d: int, dtype, kind: str) -> tuple[int, int, int, int]:
    """(threads a block, rows a warp stages in a buffer, dynamic shared memory
    a block in bytes, buffers) of the ``kind`` ("filter" or "smoother")
    pass-1 kernel at state dimension ``d`` and scalar type ``dtype``.  The
    filter stages its F, Q and y rows (2d² + 1) where ``FILTER_SCAN_STAGED``
    says, in two buffers where ``FILTER_SCAN_TWO_BUFFERS`` says, and
    elsewhere none (0 buffers: each thread reads its own chunk's); the
    smoother its b, C, F and Q rows (3d² + d) where ``SCAN_PLANES`` says,
    else its moments alone (d + d², F and Q loaded strided), in two buffers
    where ``SCAN_TWO_BUFFERS`` says."""
    if kind == "filter":
        rows = 2 * d * d + 1
        buffers = 0 if d not in FILTER_SCAN_STAGED[dtype] else 2 if d in FILTER_SCAN_TWO_BUFFERS[dtype] else 1
    else:
        rows = 3 * d * d + d if d in SCAN_PLANES[dtype] else d + d * d
        buffers = 2 if d in SCAN_TWO_BUFFERS[dtype] else 1
    return warp_stage_budget(rows, dtype, buffers=buffers) + (buffers,)


def warp_stage_budget(rows: int, dtype, per_thread: int = 0, table: int = 0, buffers: int = 1) -> tuple[int, int, int]:
    """(threads a block, ``rows``, dynamic shared memory a block) of a kernel
    whose warps each stage ``buffers`` × ``rows`` rows of 32 slots of
    32 / itemsize + 1 values, after ``table`` bytes a block (a scalar table),
    with ``per_thread`` more bytes a thread counted against the limit (the
    filter's block sum): 4, 2 or 1 warps a block, whichever leaves an SM the
    most warps, the largest on a tie (csrc/dt_launch.cuh: BlockWarps)."""
    size = torch.finfo(dtype).bits // 8
    region = buffers * rows * 32 * (32 // size + 1) * size
    per_warp = region + 32 * per_thread
    fits = [w for w in (4, 2, 1) if w * per_warp + table <= SMEM_LIMIT]
    warps = max(fits, key=lambda w: resident_warps(w, per_warp, table))  # the first, the largest, on a tie
    return 32 * warps, rows, table + warps * region


def resident_warps(warps: int, bytes_per_warp: int, bytes_per_block: int = 0) -> int:
    """Warps an SM holds, by shared memory, in blocks of ``warps`` warps of
    ``bytes_per_warp`` each and ``bytes_per_block`` more."""
    return warps * (SMEM_PER_SM // (warps * bytes_per_warp + bytes_per_block + SMEM_RESERVED))


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# --------------------------------------------------------------------------
# Chunk helpers (shared with kalman/dt.py)
# --------------------------------------------------------------------------


def _unpack_filt(X: Tensor, d: int) -> FilteringElementTL:
    d2 = d * d
    m = X.shape[-1]
    return FilteringElementTL(
        X[:d2].reshape(d, d, m), X[d2 : d2 + d], X[d2 + d : 2 * d2 + d].reshape(d, d, m),
        X[2 * d2 + d : 3 * d2 + d].reshape(d, d, m), X[3 * d2 + d :],
    )


def _unpack_smooth(X: Tensor, d: int) -> SmoothingElementTL:
    d2 = d * d
    m = X.shape[-1]
    return SmoothingElementTL(X[:d2].reshape(d, d, m), X[d2 : d2 + d], X[d2 + d :].reshape(d, d, m))


def _pack(elem, m: int) -> Tensor:
    """Element leaves with trailing axis m → packed (n, m) component rows."""
    return torch.cat([x.reshape(-1, m) for x in elem]).contiguous()


def _chunk_scan(elems, identity, operator, reverse: bool):
    """Inclusive scan inside each CHUNK-step chunk: leaves (..., T) →
    (..., n_chunks, CHUNK), the ragged last chunk padded at its end with
    identity elements (exact no-ops in either direction)."""
    T = elems[0].shape[-1]
    nc = n_chunks(T)
    pad = nc * CHUNK - T

    def blocked(x, ident):
        if pad:
            fill = ident.reshape(ident.shape + (1,)).to(x.dtype).expand(x.shape[:-1] + (pad,))
            x = torch.cat([x, fill], -1)
        return x.reshape(x.shape[:-1] + (nc, CHUNK))

    return kogge_stone_scan_tl(operator, _map(blocked, elems, identity), identity, reverse)


def _seed_chunks(operator, prefix, local, T: int):
    """Fold each chunk's exclusive prefix into its scanned steps; → (..., T)."""
    out = operator(_map(lambda p, x: p[..., None].expand_as(x), prefix, local), local)
    return _map(lambda x: x.reshape(x.shape[:-2] + (-1,))[..., :T], out)


def exclusive_chunk_prefixes(totals: Tensor, d: int, reverse: bool) -> Tensor:
    """Exclusive prefixes (suffixes, for ``reverse``) of the packed
    (n, n_chunks) chunk totals, by the plain Kogge–Stone scan on the
    totals' device (counterpart: pallas_scan.py::_strip_exclusive_prefixes)."""
    if reverse:
        elems, op, ident = _unpack_smooth(totals, d), smoothing_operator_tl, smoothing_identity_tl
    else:
        elems, op, ident = _unpack_filt(totals, d), filtering_operator_tl, filtering_identity_tl
    identity = ident(d, totals.dtype, totals.device)
    scanned = kogge_stone_scan_tl(op, elems, identity, reverse)
    return _pack(_map(lambda x, i: exclusive_shift(x, i, reverse), scanned, identity), totals.shape[-1])


# --------------------------------------------------------------------------
# Plain versions of the four passes
# --------------------------------------------------------------------------


def strip_filter_scan_plain(Fs_tl, Qs_tl, P0, H, R, y) -> Tensor:
    """Filter chunk totals, packed (3d²+2d, n_chunks)."""
    e = _filtering_elements_from_planes(P0, Fs_tl, Qs_tl, H, R.reshape(1, 1), y)
    ident = filtering_identity_tl(P0.shape[0], P0.dtype, P0.device)
    local = _chunk_scan(e, ident, filtering_operator_tl, reverse=False)
    return _pack(_map(lambda x: x[..., -1], local), n_chunks(Fs_tl.shape[-1]))


def strip_filter_apply_plain(Fs_tl, Qs_tl, P0, H, R, y, prefix):
    """Filtered (b (d, T), C (d, d, T), ell) from the chunks' exclusive prefixes."""
    d, T = P0.shape[0], Fs_tl.shape[-1]
    R = R.reshape(1, 1)
    e = _filtering_elements_from_planes(P0, Fs_tl, Qs_tl, H, R, y)
    ident = filtering_identity_tl(d, P0.dtype, P0.device)
    local = _chunk_scan(e, ident, filtering_operator_tl, reverse=False)
    out = _seed_chunks(filtering_operator_tl, _unpack_filt(prefix, d), local, T)
    return out.b, out.C, _loglik_from_planes(P0, Fs_tl, Qs_tl, H, R, out.b, out.C, y)


def strip_smoother_scan_plain(Fs_tl, Qs_tl, b_tl, C_tl) -> Tensor:
    """Smoother chunk (suffix) totals, packed (2d²+d, n_chunks)."""
    e = _smoothing_elements_from_planes(Fs_tl, Qs_tl, b_tl, C_tl)
    ident = smoothing_identity_tl(Fs_tl.shape[0], Fs_tl.dtype, Fs_tl.device)
    local = _chunk_scan(e, ident, smoothing_operator_tl, reverse=True)
    return _pack(_map(lambda x: x[..., 0], local), n_chunks(Fs_tl.shape[-1]))


def strip_smoother_apply_plain(Fs_tl, Qs_tl, b_tl, C_tl, prefix):
    """Smoothed (g (d, T), L (d, d, T)) from the chunks' exclusive suffixes."""
    d, T = Fs_tl.shape[0], Fs_tl.shape[-1]
    e = _smoothing_elements_from_planes(Fs_tl, Qs_tl, b_tl, C_tl)
    ident = smoothing_identity_tl(d, Fs_tl.dtype, Fs_tl.device)
    local = _chunk_scan(e, ident, smoothing_operator_tl, reverse=True)
    out = _seed_chunks(smoothing_operator_tl, _unpack_smooth(prefix, d), local, T)
    return out.g, out.L


def strip_filter_plain(Fs_tl, Qs_tl, P0, H, R, observations):
    """Plain filter by the same chunked two-pass algorithm: (b_tl, C_tl, ell)."""
    y = observations.reshape(-1)
    totals = strip_filter_scan_plain(Fs_tl, Qs_tl, P0, H, R, y)
    prefix = exclusive_chunk_prefixes(totals, P0.shape[0], reverse=False)
    return strip_filter_apply_plain(Fs_tl, Qs_tl, P0, H, R, y, prefix)


def strip_smoother_plain(Fs_tl, Qs_tl, b_tl, C_tl):
    """Plain smoother by the same chunked two-pass algorithm: (g_tl, L_tl)."""
    totals = strip_smoother_scan_plain(Fs_tl, Qs_tl, b_tl, C_tl)
    prefix = exclusive_chunk_prefixes(totals, Fs_tl.shape[0], reverse=True)
    return strip_smoother_apply_plain(Fs_tl, Qs_tl, b_tl, C_tl, prefix)


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise ValueError(f"strip-engine CUDA kernels: {what}")


def _check(Fs_tl: Tensor, tensors: dict):
    """Validate the inputs of a kernel launch; returns (d, T).  ``tensors``:
    {name: (tensor, shape)}, a shape's entries being numbers or the names of
    ``sizes`` below."""
    dev, dtype = Fs_tl.device, Fs_tl.dtype
    _require(dev.type == "cuda", f"tensors must be on a CUDA device, got {dev}")
    _require(dtype in (torch.float32, torch.float64), f"dtype must be float32 or float64, got {dtype}")
    _require(Fs_tl.dim() == 3 and Fs_tl.shape[0] == Fs_tl.shape[1] and Fs_tl.shape[2] >= 1,
             f"Fs must be (d, d, T) with T >= 1, got {tuple(Fs_tl.shape)}")
    d, T = Fs_tl.shape[0], Fs_tl.shape[2]
    _require(1 <= d <= MAX_KERNEL_D, f"state dimension {d} > {MAX_KERNEL_D}")
    sizes = {"d": d, "T": T, "filt": filt_rows(d), "smooth": smooth_rows(d), "chunks": n_chunks(T)}
    for name, (x, shape) in {"Fs": (Fs_tl, (d, d, T)), **tensors}.items():
        shape = tuple(sizes.get(s, s) for s in shape)
        _require(x.device == dev, f"{name} is on {x.device}, expected {dev}")
        _require(x.dtype == dtype, f"{name} has dtype {x.dtype}, expected {dtype}")
        _require(tuple(x.shape) == shape, f"{name} must have shape {shape}, got {tuple(x.shape)}")
        _require(x.is_contiguous(), f"{name} must be contiguous")
    return d, T


def _launch(name: str, d: int, *args) -> None:
    from parallel_gps_torch.kalman import _cuda

    _cuda.launch(name, getattr(_cuda.load(), f"pgt_{name}_d{d}"), *args)
    LAUNCHES[name] += 1


def _filter_scalars(P0, H, R) -> Tensor:
    """[P0 (d²) | h (d) | r], the filter kernels' scalar table."""
    return torch.cat([P0.reshape(-1), H.reshape(-1), R.reshape(-1)]).contiguous()


_SHAPES = {
    "Qs": ("d", "d", "T"), "P0": ("d", "d"), "H": (1, "d"), "R": (1, 1), "y": ("T",), "b_tl": ("d", "T"),
    "C_tl": ("d", "d", "T"), "filter_prefix": ("filt", "chunks"), "smoother_prefix": ("smooth", "chunks"),
}


def _named(**tensors) -> dict:
    return {name: (x, _SHAPES[name]) for name, x in tensors.items()}


def strip_filter_scan(Fs_tl, Qs_tl, P0, H, R, y) -> Tensor:
    """Filter pass 1: packed chunk totals (3d²+2d, n_chunks).  ``y``: (T,)
    observations, NaN = missing."""
    if Fs_tl.device.type == "cpu":
        return strip_filter_scan_plain(Fs_tl, Qs_tl, P0, H, R, y)
    d, T = _check(Fs_tl, _named(Qs=Qs_tl, P0=P0, H=H, R=R, y=y))
    totals = torch.empty((filt_rows(d), n_chunks(T)), dtype=Fs_tl.dtype, device=Fs_tl.device)
    _launch(
        "strip_filter_scan", d, int(Fs_tl.dtype == torch.float64), _filter_scalars(P0, H, R), Fs_tl, Qs_tl, y,
        totals, T, CHUNK, Fs_tl.device,
    )
    return totals


def strip_filter_apply(Fs_tl, Qs_tl, P0, H, R, y, prefix):
    """Filter pass 2: (b (d, T), C (d, d, T), ell) from the chunk prefixes."""
    if Fs_tl.device.type == "cpu":
        return strip_filter_apply_plain(Fs_tl, Qs_tl, P0, H, R, y, prefix)
    d, T = _check(Fs_tl, _named(Qs=Qs_tl, P0=P0, H=H, R=R, y=y, filter_prefix=prefix))
    dev, dtype = Fs_tl.device, Fs_tl.dtype
    b = torch.empty((d, T), dtype=dtype, device=dev)
    C = torch.empty((d, d, T), dtype=dtype, device=dev)
    threads = apply_stage(d, dtype, "filter")[0]  # the library's, checked when it loads
    parts = torch.empty((-(-n_chunks(T) // threads),), dtype=dtype, device=dev)
    _launch(
        "strip_filter_apply", d, int(dtype == torch.float64), _filter_scalars(P0, H, R), prefix, Fs_tl, Qs_tl, y,
        b, C, parts, T, CHUNK, dev,
    )
    # Per-block partials, each summed in a fixed order by the kernel; the
    # final sum is one deterministic reduction (no atomics).
    return b, C, parts.sum()


def strip_smoother_scan(Fs_tl, Qs_tl, b_tl, C_tl) -> Tensor:
    """Smoother pass 1: packed chunk suffix totals (2d²+d, n_chunks)."""
    if Fs_tl.device.type == "cpu":
        return strip_smoother_scan_plain(Fs_tl, Qs_tl, b_tl, C_tl)
    d, T = _check(Fs_tl, _named(Qs=Qs_tl, b_tl=b_tl, C_tl=C_tl))
    totals = torch.empty((smooth_rows(d), n_chunks(T)), dtype=Fs_tl.dtype, device=Fs_tl.device)
    _launch(
        "strip_smoother_scan", d, int(Fs_tl.dtype == torch.float64), Fs_tl, Qs_tl, b_tl, C_tl, totals, T, CHUNK,
        Fs_tl.device,
    )
    return totals


def strip_smoother_apply(Fs_tl, Qs_tl, b_tl, C_tl, prefix):
    """Smoother pass 2: (g (d, T), L (d, d, T)) from the chunk suffixes."""
    if Fs_tl.device.type == "cpu":
        return strip_smoother_apply_plain(Fs_tl, Qs_tl, b_tl, C_tl, prefix)
    d, T = _check(Fs_tl, _named(Qs=Qs_tl, b_tl=b_tl, C_tl=C_tl, smoother_prefix=prefix))
    g = torch.empty((d, T), dtype=Fs_tl.dtype, device=Fs_tl.device)
    L = torch.empty((d, d, T), dtype=Fs_tl.dtype, device=Fs_tl.device)
    _launch(
        "strip_smoother_apply", d, int(Fs_tl.dtype == torch.float64), prefix, Fs_tl, Qs_tl, b_tl, C_tl, g, L, T,
        CHUNK, Fs_tl.device,
    )
    return g, L


# --------------------------------------------------------------------------
# Filter and smoother
# --------------------------------------------------------------------------


def strip_filter(Fs_tl: Tensor, Qs_tl: Tensor, P0: Tensor, H: Tensor, R: Tensor, observations: Tensor):
    """Strip-engine filter on time-last planes; returns (b_tl (d, T),
    C_tl (d, d, T), ell).  ``observations``: T values, NaN = missing."""
    # The kernels take contiguous planes; a caller's may be views.
    Fs_tl, Qs_tl = Fs_tl.contiguous(), Qs_tl.contiguous()
    y = observations.reshape(-1).contiguous()
    R = R.reshape(1, 1)
    totals = strip_filter_scan(Fs_tl, Qs_tl, P0, H, R, y)
    prefix = exclusive_chunk_prefixes(totals, P0.shape[0], reverse=False)
    return strip_filter_apply(Fs_tl, Qs_tl, P0, H, R, y, prefix)


def strip_smoother(Fs_tl: Tensor, Qs_tl: Tensor, b_tl: Tensor, C_tl: Tensor):
    """Strip-engine smoother over filtered moments; returns (g_tl, L_tl)."""
    Fs_tl, Qs_tl, b_tl, C_tl = (x.contiguous() for x in (Fs_tl, Qs_tl, b_tl, C_tl))
    totals = strip_smoother_scan(Fs_tl, Qs_tl, b_tl, C_tl)
    prefix = exclusive_chunk_prefixes(totals, Fs_tl.shape[0], reverse=True)
    return strip_smoother_apply(Fs_tl, Qs_tl, b_tl, C_tl, prefix)
