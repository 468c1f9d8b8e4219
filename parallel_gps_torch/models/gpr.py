"""Dense Gaussian-process regression: the correctness oracle (counterpart:
parallel_gps_tpu/models/gpr.py).

A dense GP with zero mean function sharing the kernel modules of the
state-space model, so LML values, gradients and predictions are directly
comparable.  O(N³): for tests at N of hundreds.
"""
from __future__ import annotations

import math

import torch
from torch import Tensor

from parallel_gps_torch.kernels.base import SDEKernel


class GPR:
    def __init__(self, ts: Tensor, ys: Tensor, kernel: SDEKernel, noise_variance: Tensor):
        """``ts``, ``ys``: N inputs and observations (no NaN);
        ``noise_variance``: the constrained value."""
        self.ts = ts.reshape(-1, 1)
        self.ys = ys.reshape(-1, 1)
        self.kernel = kernel
        self.noise_variance = noise_variance

    def _factor(self):
        X = self.ts
        K = self.kernel.dense(X, X) + self.noise_variance * torch.eye(X.shape[0], dtype=X.dtype, device=X.device)
        chol = torch.linalg.cholesky(K)
        return chol, torch.cholesky_solve(self.ys, chol)

    def log_marginal_likelihood(self) -> Tensor:
        chol, alpha = self._factor()
        quad = (self.ys * alpha).sum()
        logdet = 2.0 * torch.log(torch.diagonal(chol)).sum()
        return -0.5 * (quad + logdet + self.ts.shape[0] * math.log(2.0 * math.pi))

    def predict_f(self, Xnew: Tensor):
        """Posterior mean and marginal variance at ``Xnew``, each (M, 1)."""
        Xnew = Xnew.reshape(-1, 1)
        chol, alpha = self._factor()
        Ks = self.kernel.dense(self.ts, Xnew)  # (N, M)
        mean = Ks.T @ alpha
        v = torch.cholesky_solve(Ks, chol)
        var = torch.diagonal(self.kernel.dense(Xnew, Xnew) - Ks.T @ v)[:, None]
        return mean, var
