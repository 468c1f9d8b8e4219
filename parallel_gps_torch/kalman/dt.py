"""Fused-discretization ("dt-engine") filter and smoother
(counterpart: parallel_gps_tpu/kalman/pallas_dt.py).

For kernels whose transitions have an elementwise closed form
(``SDEKernel.transition_coeffs``: the Matérn kernels' exponential polynomial,
``EXPPOLY``, RBF's spectral closed form, ``SPECTRAL``, and the composite
family of Periodic, Sum and Product, ``COMPOSITE``), the per-step
transition and noise planes never exist: each step rebuilds, from its dt and
the coefficients,

    Am1 = expm(dt·F) − I,   F = I + Am1,
    Q   = −(M + Mᵀ + M·Am1ᵀ),  M = Am1·P∞,

the cancellation-free discretization of ops/disc.py.  The JAX ``build``
closure becomes a family id plus the flat ``coeffs`` tensor
(kernels/matern.py, kernels/rbf.py, kernels/composite.py); the spectral
family's block table is derived from d (``rbf.spectral_blocks``), the
composite family's plan travels with its family id, and each is handed to
the kernels with the coefficients (``kernel_coeffs``).

``lml_dt`` is differentiable: its backward is the smoother followed by the
fused Fisher tail ``dt_fisher``, one scan-free pass from the filtered and
smoothed moments to the cotangents of (coeffs, P0, H, R, dts, y).

The filter and the smoother are each a two-pass chunked scan over chunks of
``CHUNK`` consecutive steps: pass 1 folds each chunk to its total, an
exclusive prefix over the (n, n_chunks) totals runs as one plane scan
(``strip.exclusive_chunk_prefixes``), and pass 2 re-folds each chunk seeded
with its prefix and writes the moments (the filter's pass 2 also streams the
log-likelihood); the chunk helpers and the plain passes on planes are
``kalman/strip.py``'s.
Each pass, and the Fisher tail, is a wrapper that dispatches on the device
of its tensors:

  - CUDA, float32 or float64, d ≤ ``MAX_KERNEL_D[family]`` (3 for the
    exponential polynomial, 8 for the spectral and composite families, a
    composite within the kernels' limits, ``composite.Plan.fits``): the
    hand-written
    kernel of ``csrc/dt_scan.cu`` (one thread per chunk; the pass-2 kernels
    and the smoother's pass 1 stage the moments a warp at a time, the
    filter's pass 1 its y and dt rows at the units of
    ``FILTER_SCAN_STAGED``, both pass 1s in blocks of ``scan_stage``) or
    ``csrc/dt_fisher.cu``
    (one thread per step), one translation unit per d; anything else on CUDA
    raises;
  - CPU: the plain PyTorch version of the same function (``*_plain``).

On the CPU, ``strip_filter_dt``/``strip_smoother_dt`` run the plain
time-last engine directly (``strip_filter_dt_plain``,
``strip_smoother_dt_plain``: build_planes_tl + pkf_from_tl/pks_from_tl).

With a batch axis — ``coeffs`` (B, n), ``P0`` (B, d, d), ``H`` (B, 1, d),
``R`` (B, 1, 1), ``dts`` and the observations (T,) when all series share them
or (B, T) — the entry points take the single-pass batched engine
(kalman/batched.py) instead: the (d, d, B, T) planes are built once by
``build_planes_tl`` and one launch filters (or smooths) all B series, with no
prefix step on the host; ``lml_dt`` then returns (B,) and its backward is the
batched smoother and one launch of the Fisher tail for all series.  This is
what ``jax.vmap`` of the single-series entry points does in the JAX package
(pallas_dt.py:426-460, :769-800), for every family: the spectral and
composite coefficients (B, n) build their planes as the exponential
polynomial's do, and the Fisher tail reads each series' row of the scalar
table.

``LAUNCHES`` counts kernel launches by kernel name (the spectral family's
kernels are ``<wrapper>_spectral``, the composite family's
``<wrapper>_composite``).
"""
from __future__ import annotations

import torch
from torch import Tensor
from torch.autograd.function import once_differentiable

from parallel_gps_torch.kalman.batched import batched_strip_filter, batched_strip_smoother, series_observations
from parallel_gps_torch.kalman.strip import (
    CHUNK,
    exclusive_chunk_prefixes,
    filt_rows,
    n_chunks,
    smooth_rows,
    strip_filter_apply_plain,
    strip_filter_scan_plain,
    strip_smoother_apply_plain,
    strip_smoother_scan_plain,
    warp_stage_budget,
)
from parallel_gps_torch.kalman.timelast import fisher_grads_from_smoothed, pkf_from_tl, pks_from_tl
from parallel_gps_torch.kernels import composite
from parallel_gps_torch.kernels.composite import COMPOSITE
from parallel_gps_torch.kernels.matern import EXPPOLY, build_transitions_m1
from parallel_gps_torch.kernels.rbf import SPECTRAL, spectral_blocks
from parallel_gps_torch.ops.linalg import symmetrize
from parallel_gps_torch.types import LGSSMTL

_KERNELS = ("dt_filter_scan", "dt_filter_apply", "dt_smoother_scan", "dt_smoother_apply", "dt_fisher")
# By kernel: the exponential polynomial's under the wrapper's name, the
# spectral and composite families' with "_spectral" and "_composite" (csrc:
# dt_filter_scan_spectral_kernel, dt_filter_scan_composite_kernel, ...).
LAUNCHES = dict.fromkeys(_KERNELS + tuple(f"{k}_{f}" for f in (SPECTRAL, COMPOSITE) for k in _KERNELS), 0)

# The state dimensions the kernels are built for, by family: the Matérn
# range for the exponential polynomial, RBF's spectral orders, and the
# composites up to the same d = 8.
MAX_KERNEL_D = {EXPPOLY: 3, SPECTRAL: 8, COMPOSITE: 8}
# The family ids the kernels take (csrc/dt_launch.cuh: kExppoly, kSpectral,
# kComposite).
FAMILY_IDS = {EXPPOLY: 0, SPECTRAL: 1, COMPOSITE: 2}
# The smoother pass 1's units that stage two buffers, the next round's copy in
# flight while one is folded, by family and scalar type, where that measured
# faster on an H100 (csrc/dt_scan.cu: kDtScanTwoF32, …; PERF.md §6); the rest
# stage one.
SCAN_TWO_BUFFERS = {
    (EXPPOLY, torch.float32): frozenset({1, 3}), (EXPPOLY, torch.float64): frozenset(),
    (SPECTRAL, torch.float32): frozenset({1, 4}), (SPECTRAL, torch.float64): frozenset(),
    (COMPOSITE, torch.float32): frozenset(), (COMPOSITE, torch.float64): frozenset(),
}
# The filter pass 1's units that stage their y and dt rows a warp at a time,
# and those of them that stage two buffers, by family and scalar type, where
# each measured faster on an H100 (csrc/dt_scan.cu: kDtFilterScanStagedF32,
# kDtFilterScanTwoF32, …; PERF.md §6); the rest read y and dt directly, each
# thread its own chunk's (no buffer).
FILTER_SCAN_STAGED = {
    (EXPPOLY, torch.float32): frozenset({1}), (EXPPOLY, torch.float64): frozenset(),
    (SPECTRAL, torch.float32): frozenset({7}), (SPECTRAL, torch.float64): frozenset(),
    (COMPOSITE, torch.float32): frozenset(), (COMPOSITE, torch.float64): frozenset(),
}
FILTER_SCAN_TWO_BUFFERS = {
    (EXPPOLY, torch.float32): frozenset(), (EXPPOLY, torch.float64): frozenset(),
    (SPECTRAL, torch.float32): frozenset(), (SPECTRAL, torch.float64): frozenset(),
    (COMPOSITE, torch.float32): frozenset(), (COMPOSITE, torch.float64): frozenset(),
}
# Most blocks of the Fisher-tail kernel's grid-stride loops, over all series:
# one row of partial sums per block.
FISHER_MAX_BLOCKS = 2048


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def scan_stage(family: str, d: int, dtype, kind: str) -> tuple[int, int, int, int]:
    """(threads a block, rows a warp stages in a buffer, dynamic shared memory
    a block in bytes, buffers) of the ``kind`` ("filter" or "smoother")
    pass-1 kernel of ``family`` at state dimension ``d`` and scalar type
    ``dtype`` (csrc/dt_scan.cu: DtFilterScan, SpectralFilterScan, DtScan,
    SpectralScan).  The filter's warps stage y and dt, 2 rows, at the units
    of ``FILTER_SCAN_STAGED``, in two buffers where
    ``FILTER_SCAN_TWO_BUFFERS`` says, and elsewhere none (0 buffers: each
    thread reads its own chunk's); the smoother's stage their moments,
    d + d² rows, in two buffers where ``SCAN_TWO_BUFFERS`` says.  The
    spectral and composite families' scalar table comes first, the filter's
    [P0 (d²) | h (d) | r | coefficients and table] or the smoother's [P0 |
    coefficients and table], in bytes rounded up to 16."""
    table = 0
    if family in (SPECTRAL, COMPOSITE):
        blocks = (d + 1) // 2
        coeffs = 1 + 2 * blocks * d * d + 2 * blocks if family == SPECTRAL else composite.table_size(d)
        values = d * d + coeffs + (d + 1 if kind == "filter" else 0)
        table = -(-values * (torch.finfo(dtype).bits // 8) // 16) * 16
    if kind == "filter":
        rows = 2
        staged, two = d in FILTER_SCAN_STAGED[family, dtype], d in FILTER_SCAN_TWO_BUFFERS[family, dtype]
        buffers = 0 if not staged else 2 if two else 1
    else:
        rows, buffers = d + d * d, 2 if d in SCAN_TWO_BUFFERS[family, dtype] else 1
    return warp_stage_budget(rows, dtype, table=table, buffers=buffers) + (buffers,)


# --------------------------------------------------------------------------
# Plain building blocks
# --------------------------------------------------------------------------


def _spectral_positions(d: int) -> list:
    """The position of each spectral coefficient of the model's layout in the
    kernels' (csrc/dt_elements.cuh: Spectral), where every block has a G and
    an S matrix, [1/ℓ | G_1 | S_1 | …]: a real root's S is absent from the
    model's layout."""
    pos = [0]
    for k, (_, beta) in enumerate(spectral_blocks(d)):
        base = 1 + 2 * k * d * d
        pos += range(base, base + d * d)
        if beta != 0.0:
            pos += range(base + d * d, base + 2 * d * d)
    return pos


def kernel_coeffs(family: str, coeffs: Tensor, d: int) -> Tensor:
    """The coefficients as the kernels read them: the exponential
    polynomial's as they are; the spectral family's in the kernels' layout (a
    real root's S zero) followed by the block table [a_1, β_1, …]; the
    composite family's padded and followed by its plan
    (``composite.kernel_layout``).  A leading batch axis is kept."""
    if family == COMPOSITE:
        return composite.kernel_layout(family, coeffs)
    if family != SPECTRAL:
        return coeffs
    blocks = spectral_blocks(d)
    padded = coeffs.new_zeros(coeffs.shape[:-1] + (1 + 2 * len(blocks) * d * d,))
    padded[..., _spectral_positions(d)] = coeffs
    table = torch.tensor([v for block in blocks for v in block], dtype=coeffs.dtype, device=coeffs.device)
    return torch.cat([padded, table.expand(coeffs.shape[:-1] + table.shape)], -1)


def _dts_from_ts(ts: Tensor, t0=0.0) -> Tensor:
    ts = ts.reshape(-1)
    return torch.diff(ts, prepend=torch.full((1,), float(t0), dtype=ts.dtype, device=ts.device))


def build_planes_tl(family: str, coeffs: Tensor, P0: Tensor, dts: Tensor):
    """Time-last (Fs, Qs, P0) planes rebuilt from the transition
    coefficients — the same algebra as ops/disc.py::discretize_tl.  With
    ``coeffs`` (B, n) and ``P0`` (B, d, d) the planes are (d, d, B, T) and
    ``dts`` is (T,), shared, or (B, T)."""
    d = P0.shape[-1]
    Am1 = build_transitions_m1(family, coeffs, dts, d)
    P0s = symmetrize(P0)
    P0p = P0s.permute(1, 2, 0) if P0s.dim() == 3 else P0s  # (d, d, *batch)
    eye = torch.eye(d, dtype=Am1.dtype, device=Am1.device)
    Fs = Am1 + eye.reshape((d, d) + (1,) * (Am1.dim() - 2)).expand(Am1.shape)
    # AP = Am1·P0 and APAt = AP·Am1ᵀ a term of the inner index at a time:
    # two planes in flight, not a (d, d, d, …, T) product (8.6 GB at d = 8,
    # B = 64, T = 65,536 in float32).
    AP = sum(Am1[:, j, None] * P0p[None, j, :, ..., None] for j in range(d))
    APAt = sum(AP[:, j, None] * Am1[None, :, j] for j in range(d))
    Q = -(AP + AP.transpose(0, 1) + APAt)
    Qs = 0.5 * (Q + Q.transpose(0, 1))
    return Fs, Qs, P0s


# --------------------------------------------------------------------------
# Plain versions of the four passes and of the Fisher tail
# --------------------------------------------------------------------------


def dt_filter_scan_plain(family, coeffs, P0, H, R, dts, y) -> Tensor:
    """Filter chunk totals, packed (3d²+2d, n_chunks)."""
    Fs, Qs, P0s = build_planes_tl(family, coeffs, P0, dts)
    return strip_filter_scan_plain(Fs, Qs, P0s, H, R, y)


def dt_filter_apply_plain(family, coeffs, P0, H, R, dts, y, prefix):
    """Filtered (b (d, T), C (d, d, T), ell) from the chunks' exclusive prefixes."""
    Fs, Qs, P0s = build_planes_tl(family, coeffs, P0, dts)
    return strip_filter_apply_plain(Fs, Qs, P0s, H, R, y, prefix)


def dt_smoother_scan_plain(family, coeffs, P0, dts, b_tl, C_tl) -> Tensor:
    """Smoother chunk (suffix) totals, packed (2d²+d, n_chunks)."""
    Fs, Qs, _ = build_planes_tl(family, coeffs, P0, dts)
    return strip_smoother_scan_plain(Fs, Qs, b_tl, C_tl)


def dt_smoother_apply_plain(family, coeffs, P0, dts, b_tl, C_tl, prefix):
    """Smoothed (g (d, T), L (d, d, T)) from the chunks' exclusive suffixes."""
    Fs, Qs, _ = build_planes_tl(family, coeffs, P0, dts)
    return strip_smoother_apply_plain(Fs, Qs, b_tl, C_tl, prefix)


def dt_fisher_plain(family, coeffs, P0, H, R, dts, y, b_tl, C_tl, g_tl, L_tl):
    """Plain Fisher tail (counterpart: pallas_dt.py:1061-1071): the planes
    rebuilt under autograd, the elementwise tail on them, and autograd back
    from the plane cotangents to (coeffs, P0, dts).  Returns what
    ``dt_fisher`` returns, with a batch axis too."""
    batch = tuple(coeffs.shape[:-1])
    if batch:
        dts = dts.expand(batch + dts.shape[-1:]).contiguous()  # per-series ∂ℓ/∂dt also where dts is shared
    with torch.enable_grad():
        co, p0, dt_ = (x.detach().requires_grad_() for x in (coeffs, P0, dts))
        planes = build_planes_tl(family, co, p0, dt_)
    Fs, Qs, P0s = (x.detach() for x in planes)
    one = torch.ones(batch, dtype=P0.dtype, device=P0.device)
    ct, d_y = fisher_grads_from_smoothed(LGSSMTL(P0s, Fs, Qs, H, R), y, b_tl, C_tl, g_tl, L_tl, one)
    d_co, d_p0, d_dt = torch.autograd.grad(planes, (co, p0, dt_), (ct.Fs, ct.Qs, ct.P0))
    return d_co, d_p0, ct.H, ct.R, d_dt, d_y


def strip_filter_dt_plain(family, coeffs, P0, H, R, dts, observations):
    """Plain filter: (b_tl (d, T), C_tl (d, d, T), ell)."""
    Fs, Qs, P0s = build_planes_tl(family, coeffs, P0, dts)
    return pkf_from_tl(LGSSMTL(P0s, Fs, Qs, H, R.reshape(1, 1)), observations, True)


def strip_smoother_dt_plain(family, coeffs, P0, dts, b_tl, C_tl):
    """Plain smoother: (g_tl (d, T), L_tl (d, d, T))."""
    Fs, Qs, P0s = build_planes_tl(family, coeffs, P0, dts)
    return pks_from_tl(LGSSMTL(P0s, Fs, Qs, None, None), b_tl, C_tl)


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise ValueError(f"dt-engine CUDA kernels: {what}")


def fits(family, d: int) -> bool:
    """Whether the kernels take ``family`` at state dimension ``d``: d within
    ``MAX_KERNEL_D``, and a composite's plan within the kernels' fixed limits
    (``composite.Plan.fits``)."""
    return d <= MAX_KERNEL_D.get(family, 0) and (family != COMPOSITE or family.plan.fits())


def _check_family(family, d: int, n: int) -> int:
    """Validate the family, the state dimension and the coefficients' length
    ``n``; returns the exponential polynomial's degree (0 for the spectral
    family, whose layout has 1 + d³ values, and for the composite family)."""
    _require(family in MAX_KERNEL_D, f"unsupported transition family {family!r}")
    top = MAX_KERNEL_D[family]
    _require(1 <= d <= top, f"state dimension {d} outside 1..{top} (the {family} family's kernels are built for d <= {top})")
    if family == COMPOSITE:
        plan = family.plan
        _require(
            plan.fits(),
            f"a composite of {len(plan.weights)} weights and {len(plan.monomials)} monomials of up to "
            f"{max(map(len, plan.monomials), default=0)} factors exceeds the kernels' limits ({composite.MAX_WEIGHTS}, "
            f"{composite.MAX_MONOMIALS}, {composite.MAX_FACTORS})",
        )
        _require(plan.d == d and n == plan.n_coeffs, f"coeffs of length {n} do not fit the d={d} composite plan")
        return 0
    if family == SPECTRAL:
        _require(n == 1 + d**3, f"coeffs of length {n} do not fit the d={d} spectral layout (1 + d³ = {1 + d**3})")
        return 0
    degree = (n - 1) // (d * d)
    _require(n == 1 + degree * d * d and degree <= d - 1, f"coeffs of length {n} do not fit the d={d} exppoly layout")
    return degree


def _check(family, coeffs, P0, dts, tensors):
    """Validate the inputs of a kernel launch; returns (d, T, degree)."""
    d = P0.shape[0]
    dev = dts.device
    _require(dev.type == "cuda", f"tensors must be on a CUDA device, got {dev}")
    _require(P0.dtype in (torch.float32, torch.float64), f"dtype must be float32 or float64, got {P0.dtype}")
    degree = _check_family(family, d, coeffs.numel())
    _require(dts.dim() == 1 and dts.shape[0] >= 1, f"dts must be (T,) with T >= 1, got {tuple(dts.shape)}")
    T = dts.shape[0]
    tensors = {"coeffs": (coeffs, (coeffs.numel(),)), "P0": (P0, (d, d)), "dts": (dts, (T,)), **tensors}
    _check_tensors(dev, P0.dtype, tensors)
    return d, T, degree


def _check_tensors(dev, dtype, tensors: dict) -> None:
    """Every ``{name: (tensor, shape)}`` on ``dev``, of ``dtype``, of its shape
    and contiguous."""
    for name, (x, shape) in tensors.items():
        _require(x.device == dev, f"{name} is on {x.device}, expected {dev}")
        _require(x.dtype == dtype, f"{name} has dtype {x.dtype}, expected {dtype}")
        _require(tuple(x.shape) == shape, f"{name} must have shape {shape}, got {tuple(x.shape)}")
        _require(x.is_contiguous(), f"{name} must be contiguous")


def _check_fisher(family, coeffs, P0, H, R, dts, y, moments: dict):
    """Validate the inputs of a (batched) Fisher-tail launch: ``coeffs``
    (B, n), ``P0`` (B, d, d), ``dts`` and ``y`` (T,) or (B, T), moments with
    the batch axis before time.  Returns (d, B, T, degree)."""
    d, dev, dtype = P0.shape[-1], dts.device, P0.dtype
    _require(dev.type == "cuda", f"tensors must be on a CUDA device, got {dev}")
    _require(dtype in (torch.float32, torch.float64), f"dtype must be float32 or float64, got {dtype}")
    _require(coeffs.dim() == 2 and coeffs.shape[0] >= 1, f"coeffs must be (B, n), got {tuple(coeffs.shape)}")
    B, n = coeffs.shape
    degree = _check_family(family, d, n)
    _require(dts.dim() in (1, 2) and dts.shape[-1] >= 1, f"dts must be (T,) or (B, T) with T >= 1, got {tuple(dts.shape)}")
    T = dts.shape[-1]
    tensors = {
        "coeffs": (coeffs, (B, n)), "P0": (P0, (B, d, d)), "H": (H, (B, 1, d)), "R": (R, (B, 1, 1)),
        "dts": (dts, (T,) if dts.dim() == 1 else (B, T)), "y": (y, (T,) if y.dim() == 1 else (B, T)),
        **{name: (x, (d,) * k + (B, T)) for name, (x, k) in moments.items()},
    }
    _check_tensors(dev, dtype, tensors)
    return d, B, T, degree


def _launch(name: str, lib, d: int, family, is64: int, *args) -> None:
    """Launch ``name`` of the unit of state dimension ``d``: its entry point
    takes (is64, family id, *args)."""
    from parallel_gps_torch.kalman import _cuda

    _cuda.launch(name, getattr(lib, f"pgt_{name}_d{d}"), is64, FAMILY_IDS[family], *args)
    LAUNCHES[name if family == EXPPOLY else f"{name}_{family}"] += 1


def _filter_scalars(family, P0, H, R, coeffs) -> Tensor:
    """[P0 (d²) | h (d) | r | coeffs], the filter kernels' scalar table, the
    coefficients as the kernels read them."""
    kc = kernel_coeffs(family, coeffs, P0.shape[-1])
    return torch.cat([P0.reshape(-1), H.reshape(-1), R.reshape(-1), kc.reshape(-1)]).contiguous()


def _smoother_scalars(family, P0, coeffs) -> Tensor:
    """[P0 (d²) | coeffs], the smoother kernels' scalar table."""
    return torch.cat([P0.reshape(-1), kernel_coeffs(family, coeffs, P0.shape[-1]).reshape(-1)]).contiguous()


def dt_filter_scan(family, coeffs, P0, H, R, dts, y) -> Tensor:
    """Filter pass 1: packed chunk totals (3d²+2d, n_chunks).  ``y``: (T,)
    observations, NaN = missing."""
    if dts.device.type == "cpu":
        return dt_filter_scan_plain(family, coeffs, P0, H, R, dts, y)
    from parallel_gps_torch.kalman import _cuda

    d, T, degree = _check(family, coeffs, P0, dts, {"y": (y, (dts.shape[0],)), "H": (H, (1, P0.shape[0])), "R": (R, (1, 1))})
    lib = _cuda.load()
    totals = torch.empty((filt_rows(d), n_chunks(T)), dtype=P0.dtype, device=dts.device)
    _launch(
        "dt_filter_scan", lib, d, family, int(P0.dtype == torch.float64), degree,
        _filter_scalars(family, P0, H, R, coeffs), dts, y, totals, T, CHUNK, dts.device,
    )
    return totals


def dt_filter_apply(family, coeffs, P0, H, R, dts, y, prefix):
    """Filter pass 2: (b (d, T), C (d, d, T), ell) from the chunk prefixes."""
    if dts.device.type == "cpu":
        return dt_filter_apply_plain(family, coeffs, P0, H, R, dts, y, prefix)
    from parallel_gps_torch.kalman import _cuda

    d, T = P0.shape[0], dts.shape[0]
    d, T, degree = _check(
        family, coeffs, P0, dts,
        {"y": (y, (T,)), "H": (H, (1, d)), "R": (R, (1, 1)), "prefix": (prefix, (filt_rows(d), n_chunks(T)))},
    )
    lib = _cuda.load()
    dev, dtype = dts.device, P0.dtype
    is64 = int(dtype == torch.float64)
    b = torch.empty((d, T), dtype=dtype, device=dev)
    C = torch.empty((d, d, T), dtype=dtype, device=dev)
    threads = getattr(lib, f"pgt_dt_apply_threads_d{d}")(is64, FAMILY_IDS[family], 0)
    parts = torch.empty((-(-n_chunks(T) // threads),), dtype=dtype, device=dev)
    _launch(
        "dt_filter_apply", lib, d, family, is64, degree,
        _filter_scalars(family, P0, H, R, coeffs), prefix, dts, y, b, C, parts, T, CHUNK, dev,
    )
    # Per-block partials, each summed in a fixed order by the kernel; the
    # final sum is one deterministic reduction (no atomics).
    return b, C, parts.sum()


def dt_smoother_scan(family, coeffs, P0, dts, b_tl, C_tl) -> Tensor:
    """Smoother pass 1: packed chunk suffix totals (2d²+d, n_chunks)."""
    if dts.device.type == "cpu":
        return dt_smoother_scan_plain(family, coeffs, P0, dts, b_tl, C_tl)
    from parallel_gps_torch.kalman import _cuda

    d, T = P0.shape[0], dts.shape[0]
    d, T, degree = _check(family, coeffs, P0, dts, {"b_tl": (b_tl, (d, T)), "C_tl": (C_tl, (d, d, T))})
    lib = _cuda.load()
    totals = torch.empty((smooth_rows(d), n_chunks(T)), dtype=P0.dtype, device=dts.device)
    _launch(
        "dt_smoother_scan", lib, d, family, int(P0.dtype == torch.float64), degree,
        _smoother_scalars(family, P0, coeffs), dts, b_tl, C_tl, totals, T, CHUNK, dts.device,
    )
    return totals


def dt_smoother_apply(family, coeffs, P0, dts, b_tl, C_tl, prefix):
    """Smoother pass 2: (g (d, T), L (d, d, T)) from the chunk suffixes."""
    if dts.device.type == "cpu":
        return dt_smoother_apply_plain(family, coeffs, P0, dts, b_tl, C_tl, prefix)
    from parallel_gps_torch.kalman import _cuda

    d, T = P0.shape[0], dts.shape[0]
    d, T, degree = _check(
        family, coeffs, P0, dts,
        {"b_tl": (b_tl, (d, T)), "C_tl": (C_tl, (d, d, T)), "prefix": (prefix, (smooth_rows(d), n_chunks(T)))},
    )
    lib = _cuda.load()
    g = torch.empty((d, T), dtype=P0.dtype, device=dts.device)
    L = torch.empty((d, d, T), dtype=P0.dtype, device=dts.device)
    _launch(
        "dt_smoother_apply", lib, d, family, int(P0.dtype == torch.float64), degree,
        _smoother_scalars(family, P0, coeffs), prefix, dts, b_tl, C_tl, g, L, T, CHUNK, dts.device,
    )
    return g, L


def dt_fisher(family, coeffs, P0, H, R, dts, y, b_tl, C_tl, g_tl, L_tl):
    """Fused Fisher tail: the cotangents of one LML evaluation from the
    filtered (b, C) and smoothed (g, L) moments, unscaled by the output
    cotangent.  Returns (d_coeffs, d_P0 (d, d), d_H (1, d), d_R (1, 1),
    d_dts (T,), d_y (T,)); ``d_P0`` is the cotangent of a symmetric P0,
    distributed symmetrically.

    With a batch axis (``coeffs`` (B, n), module docstring) one launch serves
    all B series and every output gains a leading B — ``d_dts`` and ``d_y``
    are (B, T), per series, also where ``dts`` or ``y`` is shared."""
    if dts.device.type == "cpu":
        return dt_fisher_plain(family, coeffs, P0, H, R, dts, y, b_tl, C_tl, g_tl, L_tl)
    if coeffs.dim() == 1:
        # The single-series call is the B = 1 case of the same launch.
        outs = _dt_fisher_launch(
            family, coeffs[None], P0[None], H[None], R[None], dts, y,
            b_tl[:, None], C_tl[:, :, None], g_tl[:, None], L_tl[:, :, None],
        )
        return tuple(x[0] for x in outs)
    return _dt_fisher_launch(family, coeffs, P0, H, R, dts, y, b_tl, C_tl, g_tl, L_tl)


def _dt_fisher_launch(family, coeffs, P0, H, R, dts, y, b_bt, C_bt, g_bt, L_bt):
    from parallel_gps_torch.kalman import _cuda

    d, B, T, degree = _check_fisher(
        family, coeffs, P0, H, R, dts, y, {"b_tl": (b_bt, 1), "C_tl": (C_bt, 2), "g_tl": (g_bt, 1), "L_tl": (L_bt, 2)}
    )
    lib = _cuda.load()
    dev, dtype = dts.device, P0.dtype
    n_sums = getattr(lib, f"pgt_dt_fisher_n_sums_d{d}")(FAMILY_IDS[family])
    # Blocks a series: the B series share the grid's budget, so that a thread
    # still sums several steps in registers before its block reduces.
    n_blocks = min(-(-T // _cuda.THREADS), max(1, FISHER_MAX_BLOCKS // B))
    d_dts = torch.empty((B, T), dtype=dtype, device=dev)
    d_y = torch.empty((B, T), dtype=dtype, device=dev)
    sums = torch.empty((B, n_blocks, n_sums), dtype=dtype, device=dev)
    # Per-series scalar table, rows [P0 (d²) | h (d) | r | coeffs].
    kc = kernel_coeffs(family, coeffs, d)
    scal = torch.cat([P0.reshape(B, -1), H.reshape(B, -1), R.reshape(B, -1), kc], 1).contiguous()
    _launch(
        "dt_fisher", lib, d, family, int(dtype == torch.float64), degree, scal,
        dts, T if dts.dim() == 2 else 0, y, T if y.dim() == 2 else 0, b_bt, C_bt, g_bt, L_bt, d_dts, d_y, sums,
        T, B, n_blocks, dev,
    )
    # One row of sums per series and block, each reduced in a fixed order by
    # the kernel; the final sum over the blocks is one deterministic
    # reduction (no atomics), of the same shape at B = 1 as a single series'.
    # Row layout: [d_coeffs | d_P0 | d_H | d_R], d_coeffs padded to the degree
    # d−1 (exponential polynomial) or in the kernels' layout (spectral,
    # composite).
    total = sums.transpose(0, 1).reshape(n_blocks, B * n_sums).sum(0).reshape(B, n_sums)
    d2 = d * d
    off = n_sums - d2 - d - 1
    d_P0 = total[:, off : off + d2].reshape(B, d, d)
    if family == SPECTRAL:
        d_co = total[:, _spectral_positions(d)]
    elif family == COMPOSITE:
        d_co = total[:, composite.kernel_positions(family)]
    else:
        d_co = total[:, : coeffs.shape[1]]
    return (
        d_co, symmetrize(d_P0), total[:, off + d2 : off + d2 + d].reshape(B, 1, d),
        total[:, -1].reshape(B, 1, 1), d_dts, d_y,
    )


# --------------------------------------------------------------------------
# Filter and smoother
# --------------------------------------------------------------------------


def strip_filter_dt(family: str, coeffs: Tensor, P0: Tensor, H: Tensor, R: Tensor, dts: Tensor, observations: Tensor):
    """dt-engine filter; returns (b_tl (d, T), C_tl (d, d, T), ell).
    ``dts``: the (T,) gaps between observation times (t0-prepended diff).
    With a batch axis (module docstring): (b (d, B, T), C (d, d, B, T),
    ell (B,)) from one launch of the batched filter."""
    if coeffs.dim() == 2:
        return _batched_filter_dt(family, coeffs, P0, H, R, dts, observations)[0]
    if dts.device.type == "cpu":
        return strip_filter_dt_plain(family, coeffs, P0, H, R, dts, observations)
    y = observations.reshape(-1).contiguous()
    R = R.reshape(1, 1)
    totals = dt_filter_scan(family, coeffs, P0, H, R, dts, y)
    prefix = exclusive_chunk_prefixes(totals, P0.shape[0], reverse=False)
    return dt_filter_apply(family, coeffs, P0, H, R, dts, y, prefix)


def strip_smoother_dt(family: str, coeffs: Tensor, P0: Tensor, dts: Tensor, b_tl: Tensor, C_tl: Tensor):
    """dt-engine smoother over filtered moments; returns (g_tl, L_tl) — with
    a batch axis (g (d, B, T), L (d, d, B, T)) from one launch of the batched
    smoother."""
    if coeffs.dim() == 2:
        Fs, Qs, _ = build_planes_tl(family, coeffs, P0, dts)
        return batched_strip_smoother(Fs, Qs, b_tl, C_tl, None, project=False)
    if dts.device.type == "cpu":
        return strip_smoother_dt_plain(family, coeffs, P0, dts, b_tl, C_tl)
    # The kernels take contiguous planes; the plain filter returns views.
    b_tl, C_tl = b_tl.contiguous(), C_tl.contiguous()
    totals = dt_smoother_scan(family, coeffs, P0, dts, b_tl, C_tl)
    prefix = exclusive_chunk_prefixes(totals, P0.shape[0], reverse=True)
    return dt_smoother_apply(family, coeffs, P0, dts, b_tl, C_tl, prefix)


def _batched_filter_dt(family, coeffs, P0, H, R, dts, observations):
    """The batched filter on planes built once from the coefficients; returns
    ((b, C, ell), (Fs, Qs)), the planes for a smoother that follows."""
    Fs, Qs, P0s = build_planes_tl(family, coeffs, P0, dts)
    ys = series_observations(observations, Fs.shape[2:])
    return batched_strip_filter(Fs, Qs, P0s, H, R.reshape(-1, 1, 1), ys), (Fs, Qs)


# --------------------------------------------------------------------------
# High-level entry points
# --------------------------------------------------------------------------


class _LmlDt(torch.autograd.Function):
    """LML via the dt-engine with Fisher-identity gradients (counterpart:
    pallas_dt.py:_lml_dt_core).  Forward: the filter.  Backward: the
    smoother and the fused Fisher tail; the (d, d, T) planes exist in
    neither.  The stationarity contract the Fisher tail requires
    (Q_k = P0 − F_k P0 F_kᵀ, kalman/timelast.py) holds by construction."""

    @staticmethod
    def forward(ctx, family, coeffs, P0, H, R, dts, observations):
        y = observations.contiguous()
        b_tl, C_tl, ell = strip_filter_dt(family, coeffs, P0, H, R, dts, y)
        ctx.family = family
        ctx.save_for_backward(coeffs, P0, H, R, dts, y, b_tl, C_tl)
        return ell

    @staticmethod
    @once_differentiable
    def backward(ctx, gbar):
        coeffs, P0, H, R, dts, y, b_tl, C_tl = ctx.saved_tensors
        b_tl, C_tl = b_tl.contiguous(), C_tl.contiguous()
        g_tl, L_tl = strip_smoother_dt(ctx.family, coeffs, P0, dts, b_tl, C_tl)
        grads = dt_fisher(ctx.family, coeffs, P0, H, R, dts, y, b_tl, C_tl, g_tl.contiguous(), L_tl.contiguous())
        g = gbar.to(P0.dtype)
        return (None, *(g * x if needed else None for x, needed in zip(grads, ctx.needs_input_grad[1:])))


class _LmlDtBatched(torch.autograd.Function):
    """``_LmlDt`` for B series (or chains) at once: the forward is one launch
    of the batched filter on planes built from the coefficients, the backward
    one launch of the batched smoother on the same planes and one of the
    Fisher tail, each series scaled by its own output cotangent.  The planes
    are kept from the forward for the backward, not rebuilt: 2·d²·B·T values
    held in between (302 MB at d = 3, B = 64, T = 65,536 in float32)."""

    @staticmethod
    def forward(ctx, family, coeffs, P0, H, R, dts, observations):
        (b_bt, C_bt, ell), (Fs, Qs) = _batched_filter_dt(family, coeffs, P0, H, R, dts, observations)
        ctx.family = family
        ctx.save_for_backward(coeffs, P0, H, R, dts, observations, b_bt, C_bt, Fs, Qs)
        return ell

    @staticmethod
    @once_differentiable
    def backward(ctx, gbar):
        coeffs, P0, H, R, dts, y, b_bt, C_bt, Fs, Qs = ctx.saved_tensors
        b_bt, C_bt = b_bt.contiguous(), C_bt.contiguous()
        g_bt, L_bt = batched_strip_smoother(Fs, Qs, b_bt, C_bt, None, project=False)
        grads = dt_fisher(
            ctx.family, coeffs.contiguous(), P0.contiguous(), H.contiguous(), R.contiguous(), dts.contiguous(),
            y.contiguous(), b_bt, C_bt, g_bt.contiguous(), L_bt.contiguous(),
        )
        g = gbar.to(P0.dtype)
        out = [None]
        for x, like, needed in zip(grads, (coeffs, P0, H, R, dts, y), ctx.needs_input_grad[1:]):
            if not needed:
                out.append(None)
                continue
            x = g.reshape((-1,) + (1,) * (x.dim() - 1)) * x
            # An input that all series share receives the sum of their cotangents.
            out.append(x.sum(0).reshape(like.shape) if like.numel() != x.numel() else x.reshape(like.shape))
        return tuple(out)


def _model_inputs(kernel, ts, transition=None):
    """``transition``: the kernel's ``transition_coeffs()`` where the caller
    has computed them already."""
    family, coeffs = transition or kernel.transition_coeffs()
    sde = kernel.get_sde()
    dts = _dts_from_ts(ts).to(sde.P0.dtype)
    return family, coeffs, sde, dts


def series_inputs(coeffs: Tensor, sde, R: Tensor):
    """(coeffs, P0, H, R, batched): for hyperparameters with a leading batch
    axis — any of the kernel's or the noise — every leaf expanded to that
    axis, (B, n), (B, d, d), (B, 1, d), (B, 1, 1); else the single-series
    leaves with R as (1, 1)."""
    d = sde.P0.shape[-1]
    R = R.reshape(-1)
    batch = torch.broadcast_shapes(coeffs.shape[:-1], sde.P0.shape[:-2], sde.H.shape[:-2], R.shape if R.numel() > 1 else ())
    if not batch:
        return coeffs, sde.P0, sde.H, R.reshape(1, 1), False
    if len(batch) != 1:
        raise ValueError(f"hyperparameters may carry one leading batch axis, got batch shape {tuple(batch)}")
    (B,) = batch
    return (
        coeffs.expand(B, coeffs.shape[-1]), sde.P0.expand(B, d, d), sde.H.expand(B, 1, d),
        R.reshape(-1, 1, 1).expand(B, 1, 1), True,
    )


def lml_dt(kernel, ts: Tensor, R: Tensor, observations: Tensor, transition=None) -> Tensor:
    """Log marginal likelihood via the dt-engine, differentiable in the
    kernel's hyperparameters, R and the observations.  Hyperparameters (or an
    ``R``) with a leading batch axis of B give (B,): B chains over the shared
    ``ts`` and observations ((T,), or (B, T) for B series)."""
    family, coeffs, sde, dts = _model_inputs(kernel, ts, transition)
    coeffs, P0, H, R, batched = series_inputs(coeffs, sde, R)
    if batched:
        return _LmlDtBatched.apply(family, coeffs, P0, H, R, dts, observations)
    return _LmlDt.apply(family, coeffs, P0, H, R, dts, observations.reshape(-1))


def pkf_dt(kernel, ts: Tensor, R: Tensor, observations: Tensor):
    """Filter from (kernel, times) directly; returns (b_tl, C_tl, ell)."""
    family, coeffs, sde, dts = _model_inputs(kernel, ts)
    coeffs, P0, H, R, batched = series_inputs(coeffs, sde, R)
    return strip_filter_dt(family, coeffs, P0, H, R, dts, observations if batched else observations.reshape(-1))


def pkfs_dt(kernel, ts: Tensor, R: Tensor, observations: Tensor, transition=None):
    """Filter + smoother; returns smoothed (g_tl (d, T), L_tl (d, d, T)), or
    (g (d, B, T), L (d, d, B, T)) for batched hyperparameters (``lml_dt``)."""
    family, coeffs, sde, dts = _model_inputs(kernel, ts, transition)
    coeffs, P0, H, R, batched = series_inputs(coeffs, sde, R)
    if batched:
        (b_bt, C_bt, _), (Fs, Qs) = _batched_filter_dt(family, coeffs, P0, H, R, dts, observations)
        return batched_strip_smoother(Fs, Qs, b_bt.contiguous(), C_bt.contiguous(), None, project=False)
    b_tl, C_tl, _ = strip_filter_dt(family, coeffs, P0, H, R, dts, observations.reshape(-1))
    return strip_smoother_dt(family, coeffs, P0, dts, b_tl, C_tl)
