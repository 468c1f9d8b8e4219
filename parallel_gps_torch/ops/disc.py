"""Continuous → discrete compilation, time-last and time-first
(counterpart: parallel_gps_tpu/ops/disc.py).

With P0 the stationary covariance P∞ and Am1 = expm(dt·F) − I, the discrete
process noise is

    Q = P∞ − A P∞ Aᵀ = −(Am1·P∞ + (Am1·P∞)ᵀ + Am1·P∞·Am1ᵀ),

every term O(dt) with full relative precision at tiny dt.
"""
from __future__ import annotations

import torch
from torch import Tensor

from parallel_gps_torch.ops.expm import expm_pade13
from parallel_gps_torch.ops.linalg import symmetrize
from parallel_gps_torch.types import LGSSM, LGSSMTL, ContinuousDiscreteModel


def _dts(ts: Tensor, t0=0.0) -> Tensor:
    """Time deltas with t0 prepended."""
    ts = ts.reshape(-1)
    prev = torch.cat([torch.full((1,), float(t0), dtype=ts.dtype, device=ts.device), ts[:-1]])
    return ts - prev


def discretize_tl(
    sde: ContinuousDiscreteModel, ts: Tensor, R: Tensor, t0=0.0, transitions_m1_tl=None
) -> LGSSMTL:
    """(d, d, T) transition/noise stacks from the SDE and the time stamps.
    ``transitions_m1_tl``: callable ``dts -> (d, d, T)`` giving
    ``expm(dt_k F) − I`` time-last.

    A batch of C models (hyperparameters of shape (C,): an SDE with (C, d, d)
    leaves, (d, d, C, T) transitions, or an ``R`` of shape (C, 1, 1)) gives
    the batched layout of kalman/timelast.py: planes (d, d, C, T), ``P0``
    (C, d, d), ``H`` (C, 1, d) and ``R`` (C, 1, 1), every leaf expanded to
    the batch."""
    dts = _dts(ts, t0)
    Am1 = transitions_m1_tl(dts)
    d = sde.F.shape[-1]
    T = dts.shape[0]
    P0 = symmetrize(sde.P0)
    R = torch.as_tensor(R)
    batch = torch.broadcast_shapes(Am1.shape[2:-1], P0.shape[:-2], sde.H.shape[:-2], R.shape[:-2])
    if len(batch) > 1:
        raise ValueError(f"a model may carry one leading batch axis, got batch shape {tuple(batch)}")
    if batch:
        Am1 = (Am1[:, :, None] if Am1.dim() == 3 else Am1).expand((d, d) + batch + (T,))
        P0 = P0.expand(batch + (d, d))
    P0p = P0.movedim((-2, -1), (0, 1))  # (d, d, *batch)
    eye_tl = torch.eye(d, dtype=Am1.dtype, device=Am1.device).reshape((d, d) + (1,) * (Am1.dim() - 2)).expand(Am1.shape)
    Fs = Am1 + eye_tl
    AP = (Am1[:, :, None] * P0p[None, ..., None]).sum(1)
    APAt = (AP[:, :, None] * Am1[None].transpose(1, 2)).sum(1)
    Q = -(AP + AP.transpose(0, 1) + APAt)
    Qs = 0.5 * (Q + Q.transpose(0, 1))
    if not batch:
        return LGSSMTL(P0, Fs, Qs, sde.H, R.reshape(1, 1))
    return LGSSMTL(P0, Fs, Qs, sde.H.expand(batch + (1, d)), R.reshape(-1, 1, 1).expand(batch + (1, 1)))


def discretize(sde: ContinuousDiscreteModel, ts: Tensor, R: Tensor, t0=0.0, transitions_m1=None) -> LGSSM:
    """The same discretization in the reference layout: (T, d, d) stacks.
    ``transitions_m1``: callable ``dts -> (T, d, d)`` giving
    ``expm(dt_k F) − I``.  A batch of C models (an SDE with (C, d, d)
    leaves, transitions (C, T, d, d), an ``R`` of shape (C, 1, 1)) gives
    stacks (C, T, d, d), ``P0`` (C, d, d), ``H`` (C, 1, d) and ``R``
    (C, 1, 1), the leading layout of kalman/sqrt.py."""
    dts = _dts(ts, t0)
    Am1 = transitions_m1(dts)
    d = sde.F.shape[-1]
    P0 = symmetrize(sde.P0)
    Fs = Am1 + torch.eye(d, dtype=Am1.dtype, device=Am1.device)
    AP = Am1 @ P0[..., None, :, :]
    Qs = symmetrize(-(AP + AP.transpose(-1, -2) + AP @ Am1.transpose(-1, -2)))
    R = torch.as_tensor(R)
    batch = torch.broadcast_shapes(Am1.shape[:-3], P0.shape[:-2], sde.H.shape[:-2], R.shape[:-2])
    if not batch:
        return LGSSM(P0, Fs, Qs, sde.H, R.reshape(1, 1))
    return LGSSM(
        P0.expand(batch + (d, d)), Fs.expand(batch + Fs.shape[-3:]), Qs.expand(batch + Qs.shape[-3:]),
        sde.H.expand(batch + sde.H.shape[-2:]), R.reshape(-1, 1, 1).expand(batch + (1, 1)),
    )


def discretize_mfd(sde: ContinuousDiscreteModel, ts: Tensor, R: Tensor, t0=0.0) -> LGSSM:
    """Matrix-fraction discretization (counterpart: disc.py:110-126 of the
    JAX package): one Padé exponential of the 2d×2d block matrix
    [[F, L Q Lᵀ], [0, −Fᵀ]] a step, valid for any P0 (not only the
    stationary one); the oracle ``discretize`` is held against."""
    n = sde.F.shape[0]
    dts = _dts(ts, t0)
    LQL = sde.L @ sde.Q @ sde.L.T
    Phi = torch.cat([torch.cat([sde.F, LQL], 1), torch.cat([torch.zeros_like(sde.F), -sde.F.T], 1)], 0)
    M = expm_pade13(dts[:, None, None] * Phi[None])
    Fs = M[:, :n, :n]  # block-triangular: equals expm(dt F)
    Qs = M[:, :n, n:] @ Fs.transpose(-1, -2)
    return LGSSM(sde.P0, Fs, symmetrize(Qs), sde.H, torch.as_tensor(R).reshape(1, 1))
