"""State-space balancing (counterpart: parallel_gps_tpu/ops/balance.py).

Parlett–Reinsch diagonal similarity scaling.  The scale vector is a constant
with respect to gradients (the JAX package wraps it in ``stop_gradient``,
the reference computes it in a host callback), so it is computed here from a
detached float64 copy of F on the host, with the iteration of
balance.py:46-61, and returned as a plain tensor.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import Tensor

from parallel_gps_torch import config


def balance_scale(F: Tensor, n_iter: int) -> Tensor:
    """Scale vector d so that D⁻¹ F D has balanced off-diagonal row/column
    norms; a degenerate (zero-norm) row or column leaves its scale at 1.
    Returned in F's dtype and device, without autograd history."""
    A = F.detach().to("cpu", torch.float64).numpy().copy()
    dim = A.shape[0]
    d = np.ones(dim)
    for _ in range(int(n_iter)):
        for i in range(dim):
            col = np.delete(A[:, i], i)
            row = np.delete(A[i, :], i)
            c = math.sqrt(float(col @ col))
            r = math.sqrt(float(row @ row))
            if c > 0.0 and r > 0.0:
                f = math.sqrt(r / c)
                d[i] *= f
                # A[i, i] is multiplied then divided by f: unchanged.
                A[:, i] *= f
                A[i, :] /= f
    return torch.as_tensor(d, dtype=F.dtype, device=F.device)


def balance_ss(F: Tensor, L: Tensor, H: Tensor, q: Tensor, n_iter: int | None = None):
    """Balance an LTI state-space model: rescale F by the similarity D, fold
    the scale into L and H, then normalise max|L| and max|H| to 1, pushing
    the magnitudes into the spectral density q.  All scale factors are
    constants with respect to gradients."""
    if n_iter is None:
        n_iter = config.NUMBER_OF_BALANCING_STEPS
    d = balance_scale(F, n_iter)
    F = F * d[None, :] / d[:, None]
    L = L / d[:, None]
    H = H * d[None, :]

    tmp3 = L.detach().abs().max()
    L = L / tmp3
    q = (tmp3**2) * q

    tmp4 = H.detach().abs().max()
    H = H / tmp4
    q = (tmp4**2) * q
    return F, L, H, q
