"""Dense Gaussian-process regression: the correctness oracle (counterpart:
parallel_gps_tpu/models/gpr.py).

A dense GP with zero mean function sharing the kernel modules of the
state-space model, so LML values, gradients and predictions are directly
comparable.  O(N³): for tests at N of hundreds, and for the experiments'
``gp`` model (``DenseGP``, the same as a module that the optimisers and
samplers take).
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import Tensor, nn

from parallel_gps_torch import config
from parallel_gps_torch.kernels.base import SDEKernel
from parallel_gps_torch.models.params import inv_softplus, softplus


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
        # The diagonal of k(X*, X*) − Ksᵀ K⁻¹ Ks alone, not the (M, M)
        # matrices: every kernel here is stationary, k(x, x) = k(0).
        kss = self.kernel.dense(Xnew[:1], Xnew[:1]).reshape(())
        var = (kss - (Ks * v).sum(0))[:, None]
        return mean, var


class DenseGP(nn.Module):
    """``GPR`` as an ``nn.Module`` with the interface of ``StateSpaceGP``
    that the optimisers and samplers use (``named_parameters``, ``forward``
    = the LML, ``training_loss``, ``predict_f``): data buffers, a kernel
    module and a softplus-unconstrained noise variance.  It is the
    experiments' ``gp`` model, as the JAX package's ``GPR`` pytree is
    there.  Scalar hyperparameters only."""

    def __init__(self, ts: Tensor, ys: Tensor, kernel: SDEKernel, raw_noise_variance: Tensor):
        super().__init__()
        self.register_buffer("ts", ts.reshape(-1))
        self.register_buffer("ys", ys.reshape(-1))
        self.kernel = kernel
        self.raw_noise_variance = nn.Parameter(raw_noise_variance)

    @classmethod
    def create(cls, data, kernel: SDEKernel, noise_variance: float = 1.0, dtype=None, device=None) -> "DenseGP":
        """``data`` = (ts, ys) as arrays or tensors; ``device=None`` is the
        card (``config.resolve_device``)."""
        dtype = dtype or config.default_float()
        device = config.resolve_device(device)
        ts, ys = (torch.as_tensor(np.asarray(x)).to(dtype=dtype, device=device) for x in data)
        nv = inv_softplus(torch.as_tensor(np.asarray(noise_variance, dtype=np.float64)))
        return cls(ts, ys, kernel.to(dtype=dtype, device=device), nv.to(dtype=dtype, device=device))

    @property
    def noise_variance(self) -> Tensor:
        return softplus(self.raw_noise_variance)

    def _gpr(self) -> GPR:
        if any(p.dim() for p in self.parameters()):
            raise NotImplementedError("the dense GP takes scalar hyperparameters: chains of it are not ported")
        return GPR(self.ts, self.ys, self.kernel, self.noise_variance)

    def log_marginal_likelihood(self) -> Tensor:
        return self._gpr().log_marginal_likelihood()

    forward = log_marginal_likelihood

    def training_loss(self) -> Tensor:
        return -self.log_marginal_likelihood()

    @torch.no_grad()
    def predict_f(self, Xnew, full_cov: bool = False):
        """Posterior mean and marginal variance at ``Xnew`` (arrays or
        tensors), each (M, 1)."""
        del full_cov
        X = torch.as_tensor(np.asarray(Xnew) if not isinstance(Xnew, Tensor) else Xnew)
        return self._gpr().predict_f(X.to(dtype=self.ts.dtype, device=self.ts.device))
