"""State-space balancing (counterpart: parallel_gps_tpu/ops/balance.py).

Parlett–Reinsch diagonal similarity scaling.  The scale vector is a constant
with respect to gradients (the JAX package wraps it in ``stop_gradient``,
the reference computes it in a host callback), so it is computed here from a
detached float64 copy of F on the host, with the iteration of
balance.py:46-61, and returned as a plain tensor.  A batch of matrices
(…, d, d) — one per chain of a sampler — makes one copy to the host, runs the
iteration on all of them at once in numpy, and makes one copy back.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import Tensor

from parallel_gps_torch import config


def balance_scale(F: Tensor, n_iter: int) -> Tensor:
    """Scale vector d so that D⁻¹ F D has balanced off-diagonal row/column
    norms; a degenerate (zero-norm) row or column leaves its scale at 1.
    ``F``: (…, d, d); returns (…, d) in F's dtype and device, without
    autograd history."""
    A = F.detach().to("cpu", torch.float64).numpy().copy()
    dim = A.shape[-1]
    d = np.ones(A.shape[:-1])
    # A sampler may propose hyperparameters that overflow: the scale is then
    # inf or NaN like everything computed from them, without a warning.
    with np.errstate(all="ignore"):
        for _ in range(int(n_iter)):
            for i in range(dim):
                col = np.delete(A[..., :, i], i, axis=-1)
                row = np.delete(A[..., i, :], i, axis=-1)
                c = np.sqrt((col * col).sum(-1))
                r = np.sqrt((row * row).sum(-1))
                ok = (c > 0.0) & (r > 0.0)
                f = np.sqrt(np.where(ok, r, 1.0) / np.where(ok, c, 1.0))[..., None]
                d[..., i] *= f[..., 0]
                # A[i, i] is multiplied then divided by f: unchanged.
                A[..., :, i] *= f
                A[..., i, :] /= f
    return torch.as_tensor(d, dtype=F.dtype, device=F.device)


def balance_ss(F: Tensor, L: Tensor, H: Tensor, q: Tensor, n_iter: int | None = None):
    """Balance an LTI state-space model: rescale F by the similarity D, fold
    the scale into L and H, then normalise max|L| and max|H| to 1, pushing
    the magnitudes into the spectral density q.  All scale factors are
    constants with respect to gradients.  ``F`` (…, d, d) and ``q`` (…, 1, 1)
    may carry batch axes; L and H come back with them."""
    if n_iter is None:
        n_iter = config.NUMBER_OF_BALANCING_STEPS
    d = balance_scale(F, n_iter)
    F = F * d[..., None, :] / d[..., :, None]
    L = L / d[..., :, None]
    H = H * d[..., None, :]

    tmp3 = L.detach().abs().amax((-2, -1), keepdim=True)
    L = L / tmp3
    q = (tmp3**2) * q

    tmp4 = H.detach().abs().amax((-2, -1), keepdim=True)
    H = H / tmp4
    q = (tmp4**2) * q
    return F, L, H, q
