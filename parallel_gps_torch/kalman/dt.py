"""Fused-discretization ("dt-engine") filter and smoother
(counterpart: parallel_gps_tpu/kalman/pallas_dt.py).

For kernels whose transitions have an elementwise closed form (the Matérn
family, ``SDEKernel.transition_coeffs``), the per-step transition and noise
planes never exist: each step rebuilds, from its dt and the coefficients,

    Am1 = expm(dt·F) − I,   F = I + Am1,
    Q   = −(M + Mᵀ + M·Am1ᵀ),  M = Am1·P∞,

the cancellation-free discretization of ops/disc.py.  The JAX ``build``
closure becomes a family id plus the flat ``coeffs`` tensor
(kernels/matern.py).

``lml_dt`` is differentiable: its backward is the smoother followed by the
fused Fisher tail ``dt_fisher``, one scan-free pass from the filtered and
smoothed moments to the cotangents of (coeffs, P0, H, R, dts, y).

The filter and the smoother are each a two-pass chunked scan over chunks of
``CHUNK`` consecutive steps: pass 1 folds each chunk to its total, an
exclusive prefix over the (n, n_chunks) totals runs in plain PyTorch on the
totals' device, and pass 2 re-folds each chunk seeded with its prefix and
writes the moments (the filter's pass 2 also streams the log-likelihood); the
chunk helpers and the plain passes on planes are ``kalman/strip.py``'s.
Each pass, and the Fisher tail, is a wrapper that dispatches on the device
of its tensors:

  - CUDA, d ≤ 3, float32 or float64: the hand-written kernel of
    ``csrc/dt_scan.cu`` (one thread per chunk) or ``csrc/dt_fisher.cu`` (one
    thread per step); anything else on CUDA raises;
  - CPU: the plain PyTorch version of the same function (``*_plain``).

On the CPU, ``strip_filter_dt``/``strip_smoother_dt`` run the plain
time-last engine directly (``strip_filter_dt_plain``,
``strip_smoother_dt_plain``: build_planes_tl + pkf_from_tl/pks_from_tl).

``LAUNCHES`` counts kernel launches by kernel name.
"""
from __future__ import annotations

import torch
from torch import Tensor
from torch.autograd.function import once_differentiable

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
)
from parallel_gps_torch.kalman.timelast import fisher_grads_from_smoothed, pkf_from_tl, pks_from_tl
from parallel_gps_torch.kernels.matern import EXPPOLY, build_transitions_m1
from parallel_gps_torch.ops.linalg import symmetrize
from parallel_gps_torch.types import LGSSMTL

LAUNCHES = {"dt_filter_scan": 0, "dt_filter_apply": 0, "dt_smoother_scan": 0, "dt_smoother_apply": 0, "dt_fisher": 0}

MAX_KERNEL_D = 3
# Most blocks of the Fisher-tail kernel's grid-stride loop: one row of
# partial sums per block.
FISHER_MAX_BLOCKS = 2048


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# --------------------------------------------------------------------------
# Plain building blocks
# --------------------------------------------------------------------------


def _dts_from_ts(ts: Tensor, t0=0.0) -> Tensor:
    ts = ts.reshape(-1)
    return torch.diff(ts, prepend=torch.full((1,), float(t0), dtype=ts.dtype, device=ts.device))


def build_planes_tl(family: str, coeffs: Tensor, P0: Tensor, dts: Tensor):
    """Time-last (Fs, Qs, P0) planes rebuilt from the transition
    coefficients — the same algebra as ops/disc.py::discretize_tl."""
    d = P0.shape[0]
    Am1 = build_transitions_m1(family, coeffs, dts, d)
    P0s = symmetrize(P0)
    T = dts.shape[0]
    Fs = Am1 + torch.eye(d, dtype=Am1.dtype, device=Am1.device)[:, :, None].expand(d, d, T)
    AP = (Am1[:, :, None, :] * P0s[None, :, :, None]).sum(1)
    APAt = (AP[:, :, None, :] * Am1[None].transpose(1, 2)).sum(1)
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
    ``dt_fisher`` returns."""
    with torch.enable_grad():
        co, p0, dt_ = (x.detach().requires_grad_() for x in (coeffs, P0, dts))
        planes = build_planes_tl(family, co, p0, dt_)
    Fs, Qs, P0s = (x.detach() for x in planes)
    one = torch.ones((), dtype=P0.dtype, device=P0.device)
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


def _check(family, coeffs, P0, dts, tensors):
    """Validate the inputs of a kernel launch; returns (d, T, degree)."""
    d = P0.shape[0]
    dev = dts.device
    _require(dev.type == "cuda", f"tensors must be on a CUDA device, got {dev}")
    _require(family == EXPPOLY, f"unsupported transition family {family!r}")
    _require(P0.dtype in (torch.float32, torch.float64), f"dtype must be float32 or float64, got {P0.dtype}")
    _require(1 <= d <= MAX_KERNEL_D, f"state dimension {d} > {MAX_KERNEL_D} (the dt kernels are built for d <= 3)")
    _require(dts.dim() == 1 and dts.shape[0] >= 1, f"dts must be (T,) with T >= 1, got {tuple(dts.shape)}")
    T = dts.shape[0]
    n = coeffs.numel()
    degree = (n - 1) // (d * d)
    _require(n == 1 + degree * d * d and degree <= d - 1, f"coeffs of length {n} do not fit the d={d} exppoly layout")
    tensors = {"coeffs": (coeffs, (n,)), "P0": (P0, (d, d)), "dts": (dts, (T,)), **tensors}
    for name, (x, shape) in tensors.items():
        _require(x.device == dev, f"{name} is on {x.device}, expected {dev}")
        _require(x.dtype == P0.dtype, f"{name} has dtype {x.dtype}, expected {P0.dtype}")
        _require(tuple(x.shape) == shape, f"{name} must have shape {shape}, got {tuple(x.shape)}")
        _require(x.is_contiguous(), f"{name} must be contiguous")
    return d, T, degree


def _launch(name: str, fn, *args) -> None:
    from parallel_gps_torch.kalman import _cuda

    _cuda.launch(name, fn, *args)
    LAUNCHES[name] += 1


def _filter_scalars(P0, H, R, coeffs) -> Tensor:
    """[P0 (d²) | h (d) | r | coeffs], the filter kernels' scalar table."""
    return torch.cat([P0.reshape(-1), H.reshape(-1), R.reshape(-1), coeffs.reshape(-1)]).contiguous()


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
        "dt_filter_scan", lib.pgt_dt_filter_scan, int(P0.dtype == torch.float64), d, degree,
        _filter_scalars(P0, H, R, coeffs), dts, y, totals, T, CHUNK, dts.device,
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
    b = torch.empty((d, T), dtype=dtype, device=dev)
    C = torch.empty((d, d, T), dtype=dtype, device=dev)
    parts = torch.empty((-(-n_chunks(T) // _cuda.THREADS),), dtype=dtype, device=dev)
    _launch(
        "dt_filter_apply", lib.pgt_dt_filter_apply, int(dtype == torch.float64), d, degree,
        _filter_scalars(P0, H, R, coeffs), prefix, dts, y, b, C, parts, T, CHUNK, dev,
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
    scal = torch.cat([P0.reshape(-1), coeffs.reshape(-1)]).contiguous()
    _launch(
        "dt_smoother_scan", lib.pgt_dt_smoother_scan, int(P0.dtype == torch.float64), d, degree,
        scal, dts, b_tl, C_tl, totals, T, CHUNK, dts.device,
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
    scal = torch.cat([P0.reshape(-1), coeffs.reshape(-1)]).contiguous()
    _launch(
        "dt_smoother_apply", lib.pgt_dt_smoother_apply, int(P0.dtype == torch.float64), d, degree,
        scal, prefix, dts, b_tl, C_tl, g, L, T, CHUNK, dts.device,
    )
    return g, L


def dt_fisher(family, coeffs, P0, H, R, dts, y, b_tl, C_tl, g_tl, L_tl):
    """Fused Fisher tail: the cotangents of one LML evaluation from the
    filtered (b, C) and smoothed (g, L) moments, unscaled by the output
    cotangent.  Returns (d_coeffs, d_P0 (d, d), d_H (1, d), d_R (1, 1),
    d_dts (T,), d_y (T,)); ``d_P0`` is the cotangent of a symmetric P0,
    distributed symmetrically."""
    if dts.device.type == "cpu":
        return dt_fisher_plain(family, coeffs, P0, H, R, dts, y, b_tl, C_tl, g_tl, L_tl)
    from parallel_gps_torch.kalman import _cuda

    d, T = P0.shape[0], dts.shape[0]
    d, T, degree = _check(
        family, coeffs, P0, dts,
        {
            "y": (y, (T,)), "H": (H, (1, d)), "R": (R, (1, 1)),
            "b_tl": (b_tl, (d, T)), "C_tl": (C_tl, (d, d, T)), "g_tl": (g_tl, (d, T)), "L_tl": (L_tl, (d, d, T)),
        },
    )
    lib = _cuda.load()
    dev, dtype = dts.device, P0.dtype
    n_sums = lib.pgt_dt_fisher_n_sums(d)
    n_blocks = min(-(-T // _cuda.THREADS), FISHER_MAX_BLOCKS)
    d_dts = torch.empty((T,), dtype=dtype, device=dev)
    d_y = torch.empty((T,), dtype=dtype, device=dev)
    sums = torch.empty((n_blocks, n_sums), dtype=dtype, device=dev)
    _launch(
        "dt_fisher", lib.pgt_dt_fisher, int(dtype == torch.float64), d, degree,
        _filter_scalars(P0, H, R, coeffs), dts, y, b_tl, C_tl, g_tl, L_tl, d_dts, d_y, sums, T, n_blocks, dev,
    )
    # One row of sums per block, each reduced in a fixed order by the
    # kernel; the final sum is one deterministic reduction (no atomics).
    # Row layout: [d_coeffs, padded to the degree d−1 | d_P0 | d_H | d_R].
    total = sums.sum(0)
    d2 = d * d
    off = n_sums - d2 - d - 1
    d_P0 = total[off : off + d2].reshape(d, d)
    return (
        total[: coeffs.numel()], symmetrize(d_P0), total[off + d2 : off + d2 + d].reshape(1, d),
        total[-1].reshape(1, 1), d_dts, d_y,
    )


# --------------------------------------------------------------------------
# Filter and smoother
# --------------------------------------------------------------------------


def strip_filter_dt(family: str, coeffs: Tensor, P0: Tensor, H: Tensor, R: Tensor, dts: Tensor, observations: Tensor):
    """dt-engine filter; returns (b_tl (d, T), C_tl (d, d, T), ell).
    ``dts``: the (T,) gaps between observation times (t0-prepended diff)."""
    if dts.device.type == "cpu":
        return strip_filter_dt_plain(family, coeffs, P0, H, R, dts, observations)
    y = observations.reshape(-1).contiguous()
    R = R.reshape(1, 1)
    totals = dt_filter_scan(family, coeffs, P0, H, R, dts, y)
    prefix = exclusive_chunk_prefixes(totals, P0.shape[0], reverse=False)
    return dt_filter_apply(family, coeffs, P0, H, R, dts, y, prefix)


def strip_smoother_dt(family: str, coeffs: Tensor, P0: Tensor, dts: Tensor, b_tl: Tensor, C_tl: Tensor):
    """dt-engine smoother over filtered moments; returns (g_tl, L_tl)."""
    if dts.device.type == "cpu":
        return strip_smoother_dt_plain(family, coeffs, P0, dts, b_tl, C_tl)
    # The kernels take contiguous planes; the plain filter returns views.
    b_tl, C_tl = b_tl.contiguous(), C_tl.contiguous()
    totals = dt_smoother_scan(family, coeffs, P0, dts, b_tl, C_tl)
    prefix = exclusive_chunk_prefixes(totals, P0.shape[0], reverse=True)
    return dt_smoother_apply(family, coeffs, P0, dts, b_tl, C_tl, prefix)


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


def _model_inputs(kernel, ts, transition=None):
    """``transition``: the kernel's ``transition_coeffs()`` where the caller
    has computed them already."""
    family, coeffs = transition or kernel.transition_coeffs()
    sde = kernel.get_sde()
    dts = _dts_from_ts(ts).to(sde.P0.dtype)
    return family, coeffs, sde, dts


def lml_dt(kernel, ts: Tensor, R: Tensor, observations: Tensor, transition=None) -> Tensor:
    """Log marginal likelihood via the dt-engine, differentiable in the
    kernel's hyperparameters, R and the observations."""
    family, coeffs, sde, dts = _model_inputs(kernel, ts, transition)
    return _LmlDt.apply(family, coeffs, sde.P0, sde.H, R.reshape(1, 1), dts, observations.reshape(-1))


def pkf_dt(kernel, ts: Tensor, R: Tensor, observations: Tensor):
    """Filter from (kernel, times) directly; returns (b_tl, C_tl, ell)."""
    family, coeffs, sde, dts = _model_inputs(kernel, ts)
    return strip_filter_dt(family, coeffs, sde.P0, sde.H, R.reshape(1, 1), dts, observations.reshape(-1))


def pkfs_dt(kernel, ts: Tensor, R: Tensor, observations: Tensor, transition=None):
    """Filter + smoother; returns smoothed (g_tl (d, T), L_tl (d, d, T))."""
    family, coeffs, sde, dts = _model_inputs(kernel, ts, transition)
    b_tl, C_tl, _ = strip_filter_dt(family, coeffs, sde.P0, sde.H, R.reshape(1, 1), dts, observations.reshape(-1))
    return strip_smoother_dt(family, coeffs, sde.P0, dts, b_tl, C_tl)
