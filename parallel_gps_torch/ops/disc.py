"""Continuous → discrete compilation, time-last and time-first
(counterpart: parallel_gps_tpu/ops/disc.py:34-106).

With P0 the stationary covariance P∞ and Am1 = expm(dt·F) − I, the discrete
process noise is

    Q = P∞ − A P∞ Aᵀ = −(Am1·P∞ + (Am1·P∞)ᵀ + Am1·P∞·Am1ᵀ),

every term O(dt) with full relative precision at tiny dt.
"""
from __future__ import annotations

import torch
from torch import Tensor

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
    ``expm(dt_k F) − I`` time-last."""
    dts = _dts(ts, t0)
    Am1 = transitions_m1_tl(dts)
    d = sde.F.shape[0]
    T = dts.shape[0]
    P0 = symmetrize(sde.P0)
    eye_tl = torch.eye(d, dtype=Am1.dtype, device=Am1.device)[:, :, None].expand(d, d, T)
    Fs = Am1 + eye_tl
    AP = (Am1[:, :, None, :] * P0[None, :, :, None]).sum(1)
    APAt = (AP[:, :, None, :] * Am1[None, :, :, :].transpose(1, 2)).sum(1)
    Q = -(AP + AP.transpose(0, 1) + APAt)
    Qs = 0.5 * (Q + Q.transpose(0, 1))
    return LGSSMTL(P0, Fs, Qs, sde.H, torch.as_tensor(R).reshape(1, 1))


def discretize(sde: ContinuousDiscreteModel, ts: Tensor, R: Tensor, t0=0.0, transitions_m1=None) -> LGSSM:
    """The same discretization in the reference layout: (T, d, d) stacks.
    ``transitions_m1``: callable ``dts -> (T, d, d)`` giving
    ``expm(dt_k F) − I``."""
    dts = _dts(ts, t0)
    Am1 = transitions_m1(dts)
    d = sde.F.shape[0]
    P0 = symmetrize(sde.P0)
    Fs = Am1 + torch.eye(d, dtype=Am1.dtype, device=Am1.device)
    AP = Am1 @ P0
    Qs = symmetrize(-(AP + AP.transpose(-1, -2) + AP @ Am1.transpose(-1, -2)))
    return LGSSM(P0, Fs, Qs, sde.H, torch.as_tensor(R).reshape(1, 1))
