"""Single-pass batched filter and smoother: B independent series, or B MCMC
chains over one series, through one launch each (counterpart: the batched
engine of parallel_gps_tpu/kalman/pallas_scan.py, ``batched_strip_filter`` /
``batched_strip_smoother``, which ``jax.vmap`` of the single-series entry
points dispatches to).

Layouts are the JAX package's: planes ``Fs_bt``, ``Qs_bt``, ``C_bt``
(d, d, B, T), moments ``b_bt`` (d, B, T), ``P0_b`` (B, d, d), ``H_b``
(B, 1, d), ``R_b`` (B, 1, 1), observations ``ys_b`` (B, T) with NaN = missing.
An operand that all series share — one model and B observation vectors, or
one observation vector for B chains — is passed as an ``expand``-ed view
(batch stride 0) and is never copied B times.

Unlike the two-pass strip and dt engines there is no prefix step between two
passes: one thread block owns a series, walks its time axis in tiles and
carries the running element across them (``csrc/batched_scan.cu``).  Each
wrapper dispatches on the device of its tensors:

  - CUDA, d ≤ 8, float32 or float64: the hand-written kernel; anything else
    on CUDA raises;
  - CPU: the plain PyTorch version (``*_plain``), the time-last Kogge–Stone
    engine with the batch axis riding along.

``LAUNCHES`` counts kernel launches by kernel name.
"""
from __future__ import annotations

import torch
from torch import Tensor

from parallel_gps_torch.kalman.timelast import pkf_from_tl, pks_from_tl
from parallel_gps_torch.types import LGSSMTL

LAUNCHES = {"batched_filter": 0, "batched_smoother": 0}

# Steps folded sequentially by one CUDA thread within a tile.
BATCHED_CHUNK = 8
MAX_KERNEL_D = 8


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def series_observations(observations: Tensor, shape) -> Tensor:
    """Observations as (B, T): given per series, or one (T,) vector that all
    B series share, expanded without a copy."""
    B, T = shape
    if observations.numel() == B * T:
        return observations.reshape(B, T)
    return observations.reshape(1, T).expand(B, T)


# --------------------------------------------------------------------------
# Plain versions
# --------------------------------------------------------------------------


def batched_strip_filter_plain(Fs_bt, Qs_bt, P0_b, H_b, R_b, ys_b):
    """Plain batched filter: (b (d, B, T), C (d, d, B, T), ell (B,))."""
    return pkf_from_tl(LGSSMTL(P0_b, Fs_bt, Qs_bt, H_b, R_b), ys_b, True)


def batched_strip_smoother_plain(Fs_bt, Qs_bt, b_bt, C_bt, H_b, project: bool = True):
    """Plain batched smoother: (g (d, B, T), L (d, d, B, T)) and, with
    ``project``, the H-projections mean = h·g and var = hᵀLh, each (B, T)."""
    g, L = pks_from_tl(LGSSMTL(None, Fs_bt, Qs_bt, None, None), b_bt, C_bt)
    if not project:
        return g, L
    h = H_b[:, 0, :].transpose(0, 1)[..., None]  # (d, B, 1)
    return g, L, (h * g).sum(0), (h[:, None] * h[None] * L).sum((0, 1))


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise ValueError(f"batched CUDA kernels: {what}")


def _strided(x: Tensor, lead: int):
    """(x, plane stride, batch stride) of an operand with ``lead`` matrix axes
    before its (B, T) axes.  The kernels address element (q, series, t) at
    q·plane + series·batch + t; a view that does not fit (time not
    contiguous, or matrix axes that do not flatten) is copied."""
    st = x.stride()
    fits = (x.shape[-1] == 1 or st[-1] == 1) and (lead < 2 or st[0] == x.shape[1] * st[1]) and min(st) >= 0
    if not fits:
        x = x.contiguous()
        st = x.stride()
    return x, (st[lead - 1] if lead else 0), st[lead]


def _check(Fs_bt: Tensor, tensors: dict):
    """Validate the inputs of a launch; returns (d, B, T).  ``tensors``:
    {name: (tensor, shape)}."""
    dev, dtype = Fs_bt.device, Fs_bt.dtype
    _require(dev.type == "cuda", f"tensors must be on a CUDA device, got {dev}")
    _require(dtype in (torch.float32, torch.float64), f"dtype must be float32 or float64, got {dtype}")
    _require(
        Fs_bt.dim() == 4 and Fs_bt.shape[0] == Fs_bt.shape[1] and Fs_bt.shape[2] >= 1 and Fs_bt.shape[3] >= 1,
        f"Fs must be (d, d, B, T) with B, T >= 1, got {tuple(Fs_bt.shape)}",
    )
    d, _, B, T = Fs_bt.shape
    _require(1 <= d <= MAX_KERNEL_D, f"state dimension {d} > {MAX_KERNEL_D}")
    sizes = {"d": d, "B": B, "T": T}
    for name, (x, shape) in tensors.items():
        shape = tuple(sizes.get(s, s) for s in shape)
        _require(x.device == dev, f"{name} is on {x.device}, expected {dev}")
        _require(x.dtype == dtype, f"{name} has dtype {x.dtype}, expected {dtype}")
        _require(tuple(x.shape) == shape, f"{name} must have shape {shape}, got {tuple(x.shape)}")
    return d, B, T


def _launch(name: str, d: int, dtype, *args) -> None:
    from parallel_gps_torch.kalman import _cuda

    bits = 64 if dtype == torch.float64 else 32
    _cuda.launch(name, getattr(_cuda.load(), f"pgt_{name}_d{d}_f{bits}"), *args)
    LAUNCHES[name] += 1


_PLANE = ("d", "d", "B", "T")


def batched_strip_filter(Fs_bt, Qs_bt, P0_b, H_b, R_b, ys_b):
    """Batched filter in one launch; returns (b (d, B, T), C (d, d, B, T),
    ell (B,)), each series' log-likelihood summed in a fixed order."""
    if Fs_bt.device.type == "cpu":
        return batched_strip_filter_plain(Fs_bt, Qs_bt, P0_b, H_b, R_b, ys_b)
    d, B, T = _check(
        Fs_bt,
        {"Qs": (Qs_bt, _PLANE), "P0": (P0_b, ("B", "d", "d")), "H": (H_b, ("B", 1, "d")), "R": (R_b, ("B", 1, 1)),
         "ys": (ys_b, ("B", "T"))},
    )
    dev, dtype = Fs_bt.device, Fs_bt.dtype
    Fs_bt, f_ps, f_bs = _strided(Fs_bt, 2)
    Qs_bt, q_ps, q_bs = _strided(Qs_bt, 2)
    ys_b, _, y_bs = _strided(ys_b, 0)
    # Per-series scalar table, rows [P0 (d²) | h (d) | r].
    scal = torch.cat([P0_b.reshape(B, -1), H_b.reshape(B, -1), R_b.reshape(B, -1)], 1).contiguous()
    b = torch.empty((d, B, T), dtype=dtype, device=dev)
    C = torch.empty((d, d, B, T), dtype=dtype, device=dev)
    ell = torch.empty((B,), dtype=dtype, device=dev)
    _launch(
        "batched_filter", d, dtype, scal, Fs_bt, f_ps, f_bs, Qs_bt, q_ps, q_bs, ys_b, y_bs,
        b, C, ell, T, B, BATCHED_CHUNK, dev,
    )
    return b, C, ell


def batched_strip_smoother(Fs_bt, Qs_bt, b_bt, C_bt, H_b, project: bool = True):
    """Batched smoother in one launch over filtered moments; returns
    (g (d, B, T), L (d, d, B, T), mean (B, T), var (B, T)) — the last two the
    fused H-projections — or (g, L) alone with ``project=False`` (``H_b`` is
    then not read and may be ``None``)."""
    if Fs_bt.device.type == "cpu":
        return batched_strip_smoother_plain(Fs_bt, Qs_bt, b_bt, C_bt, H_b, project)
    named = {"Qs": (Qs_bt, _PLANE), "b": (b_bt, ("d", "B", "T")), "C": (C_bt, _PLANE)}
    if project:
        named["H"] = (H_b, ("B", 1, "d"))
    d, B, T = _check(Fs_bt, named)
    dev, dtype = Fs_bt.device, Fs_bt.dtype
    Fs_bt, f_ps, f_bs = _strided(Fs_bt, 2)
    Qs_bt, q_ps, q_bs = _strided(Qs_bt, 2)
    b_bt, b_ps, b_bs = _strided(b_bt, 1)
    C_bt, c_ps, c_bs = _strided(C_bt, 2)
    g = torch.empty((d, B, T), dtype=dtype, device=dev)
    L = torch.empty((d, d, B, T), dtype=dtype, device=dev)
    if project:
        h = H_b.reshape(B, d).contiguous()
        mean = torch.empty((B, T), dtype=dtype, device=dev)
        var = torch.empty((B, T), dtype=dtype, device=dev)
    else:
        h = mean = var = None
    _launch(
        "batched_smoother", d, dtype, int(project), h, Fs_bt, f_ps, f_bs, Qs_bt, q_ps, q_bs,
        b_bt, b_ps, b_bs, C_bt, c_ps, c_bs, g, L, mean, var, T, B, BATCHED_CHUNK, dev,
    )
    return (g, L, mean, var) if project else (g, L)
