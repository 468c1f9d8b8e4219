"""Sequential Kalman filter / RTS smoother: the O(T)-span oracle engine
(counterpart: parallel_gps_tpu/kalman/sequential.py).

Zero initial mean, per-step symmetrisation, NaN observations skip the update
step, and the log marginal likelihood accumulates per-step innovation
log-densities.  General m-row observations (H (m, d), R (m, m), ys (T, m)):
a step with any NaN component counts as missing.

This is a Python loop over time on small tensors — about a dozen small
operations per step, whatever the device — so it is the reference the
parallel engines are tested against at T of hundreds to ~10⁵, and not
something to run at millions of steps (PERF.md gives its measured time per
step).  It has no kernel, as the JAX package's has none.
"""
from __future__ import annotations

import torch
from torch import Tensor

from parallel_gps_torch.ops.linalg import cho_solve_psd, mvn_logpdf, symmetrize
from parallel_gps_torch.types import LGSSM


def _clean(lgssm: LGSSM, observations: Tensor):
    ys = observations.reshape(lgssm.Fs.shape[0], lgssm.H.shape[0])
    mask = ~torch.isnan(ys).any(-1)
    return torch.where(mask[:, None], ys, torch.zeros_like(ys)), mask


def kf(lgssm: LGSSM, observations: Tensor, return_loglikelihood: bool = False, return_predicted: bool = False):
    """Kalman filter; returns (fms (T, d), fPs (T, d, d)), then ``ell`` and
    the predicted (mps, Pps) when asked for."""
    P0, Fs, Qs, H, R = lgssm
    ys, mask = _clean(lgssm, observations)
    observed = mask.tolist()
    m = torch.zeros(P0.shape[0], dtype=P0.dtype, device=P0.device)
    P = P0
    ell = torch.zeros((), dtype=P0.dtype, device=P0.device)
    fms, fPs, mps, Pps = [], [], [], []
    for k in range(Fs.shape[0]):
        F = Fs[k]
        mp = F @ m
        Pp = symmetrize(F @ P @ F.T + Qs[k])
        m, P = mp, Pp
        if observed[k]:
            S = H @ Pp @ H.T + R
            yp = H @ mp
            ell = ell + mvn_logpdf(ys[k], yp, S)
            Kt = cho_solve_psd(S, H @ Pp)  # (m, d)
            m = mp + Kt.T @ (ys[k] - yp)
            P = symmetrize(Pp - Kt.T @ S @ Kt)
        fms.append(m)
        fPs.append(P)
        mps.append(mp)
        Pps.append(Pp)
    out = (torch.stack(fms), torch.stack(fPs))
    if return_loglikelihood:
        out = out + (ell,)
    if return_predicted:
        out = out + (torch.stack(mps), torch.stack(Pps))
    return out


def ks(lgssm: LGSSM, ms: Tensor, Ps: Tensor, mps: Tensor, Pps: Tensor):
    """RTS smoother over filtered (ms, Ps) and predicted (mps, Pps) moments."""
    Fs = lgssm.Fs
    sm, sP = ms[-1], Ps[-1]
    sms, sPs = [sm], [sP]
    for k in range(Fs.shape[0] - 2, -1, -1):
        Ct = cho_solve_psd(Pps[k + 1], Fs[k + 1] @ Ps[k])  # (d, d)
        sm = ms[k] + Ct.T @ (sm - mps[k + 1])
        sP = symmetrize(Ps[k] + Ct.T @ (sP - Pps[k + 1]) @ Ct)
        sms.append(sm)
        sPs.append(sP)
    return torch.stack(sms[::-1]), torch.stack(sPs[::-1])


def kfs(lgssm: LGSSM, observations: Tensor):
    """Filter + smoother."""
    fms, fPs, mps, Pps = kf(lgssm, observations, return_predicted=True)
    return ks(lgssm, fms, fPs, mps, Pps)
