"""(Quasi-)periodic kernel as an order-N harmonic-oscillator SDE
(counterpart: parallel_gps_tpu/kernels/periodic.py).

The Solin–Särkkä expansion of the periodic squared-exponential kernel: the
state stacks N + 1 deterministic oscillators at frequencies j·ω₀ (Q = 0);
the stationary covariance carries the Bessel-series weights q²_j.  As the
reference, the GPflow convention σ² exp(−0.5 sin²(πτ/p)/ℓ²) is converted to
the canonical σ² exp(−2 sin²(ω₀τ/2)/ℓ'²) by a factor-2 lengthscale shim,
ℓ' = 2ℓ, so that the dense and state-space forms agree.

Transitions: F is a direct sum of plane-rotation generators j·ω₀·[[0, −1],
[1, 0]], so expm(dt·F) − I is the direct sum of [[cos θ − 1, −sin θ], [sin θ,
cos θ − 1]], θ_j = j·ω₀·dt, the diagonal as the half-angle −2 sin²(θ/2),
cancellation-free at tiny dt.  ``transition_coeffs()`` gives them as the
composite family (kernels/composite.py), a composite of one leaf.
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
from torch import Tensor, nn

from parallel_gps_torch import config
from parallel_gps_torch.kernels.base import SDEKernel
from parallel_gps_torch.kernels.composite import rotation_expansion
from parallel_gps_torch.models.params import inv_softplus, softplus
from parallel_gps_torch.types import ContinuousDiscreteModel


@lru_cache(maxsize=None)
def _offline_coeffs(N: int):
    """Parameter-independent coefficients b, K, 1/K! (periodic.py:29-42),
    numpy float64."""
    r = np.arange(0, N + 1)
    J, K = np.meshgrid(r, r)
    div_facto_K = 1.0 / np.vectorize(math.factorial)(K)
    b = (
        2.0 * np.vectorize(math.comb)(K, (np.floor((K - J) / 2) * (J <= K)).astype(int)) / (1.0 + (J == 0))
        * (J <= K) * (np.mod(K - J, 2) == 0)
    )
    return b.astype(np.float64), K.astype(np.float64), div_facto_K.astype(np.float64)


class Periodic(SDEKernel):
    """Periodic kernel with a squared-exponential base (GPflow convention):
    softplus-unconstrained variance, lengthscale and period; the static
    ``order`` N gives d = 2(N + 1)."""

    def __init__(self, variance=1.0, lengthscales=1.0, period=1.0, order: int = 6, *, dtype=None, device=None):
        super().__init__()
        dtype = dtype or config.default_float()
        device = config.resolve_device(device)

        def raw(v):
            return nn.Parameter(inv_softplus(torch.as_tensor(v, dtype=torch.float64)).to(dtype=dtype, device=device))

        self.raw_variance = raw(variance)
        self.raw_lengthscales = raw(lengthscales)
        self.raw_period = raw(period)
        self.order = int(order)

    @property
    def variance(self) -> Tensor:
        return softplus(self.raw_variance)

    @property
    def lengthscales(self) -> Tensor:
        return softplus(self.raw_lengthscales)

    @property
    def period(self) -> Tensor:
        return softplus(self.raw_period)

    @property
    def state_dim(self) -> int:
        return 2 * (self.order + 1)

    def _w0(self) -> Tensor:
        return 2.0 * math.pi / self.period

    def get_sde(self) -> ContinuousDiscreteModel:
        N, dim = self.order, self.state_dim
        var = self.variance
        dtype, device = var.dtype, var.device
        ell = 2.0 * self.lengthscales  # the GPflow-convention shim
        b, K, div_facto_K = (torch.as_tensor(x, dtype=dtype, device=device) for x in _offline_coeffs(N))
        rot = torch.tensor([[0.0, -1.0], [1.0, 0.0]], dtype=dtype, device=device)
        F = torch.kron(torch.diag(torch.arange(N + 1, dtype=dtype, device=device)), self._w0() * rot)
        q2 = (b * ell ** (-2.0 * K) * div_facto_K * torch.exp(-(ell**-2.0)) * 2.0 ** (-K) * var).sum(0)
        Pinf = torch.kron(torch.diag(q2), torch.eye(2, dtype=dtype, device=device))
        H = torch.kron(torch.ones((1, N + 1), dtype=dtype, device=device), torch.tensor([[1.0, 0.0]], dtype=dtype, device=device))
        L = torch.eye(dim, dtype=dtype, device=device)
        return ContinuousDiscreteModel(Pinf, F, L, H, torch.zeros((dim, dim), dtype=dtype, device=device))

    def transitions_m1_tl(self, dts: Tensor) -> Tensor:
        """The rotation planes (d, d, T), each entry a (T,) plane."""
        N, dim = self.order, self.state_dim
        j = torch.arange(N + 1, dtype=dts.dtype, device=dts.device)
        theta = (self._w0().to(dts.dtype) * j)[:, None] * dts.reshape(1, -1)  # (N+1, T)
        cm1 = -2.0 * torch.sin(0.5 * theta) ** 2
        s = torch.sin(theta)
        ev = torch.arange(N + 1, device=dts.device) * 2
        out = torch.zeros((dim, dim, dts.numel()), dtype=dts.dtype, device=dts.device)
        out[ev, ev] = cm1
        out[ev, ev + 1] = -s
        out[ev + 1, ev] = s
        out[ev + 1, ev + 1] = cm1
        return out

    def transition_coeffs(self):
        """The composite family of one rotation leaf: one rate, ω₀, for each
        harmonic's two weights (the JAX build's single coefficient)."""
        w0 = self._w0().reshape(())
        family, coeffs = rotation_expansion(self.order, w0).encode()
        return family, coeffs.to(w0)  # order 0: no weights, no coefficients

    def dense(self, X: Tensor, X2: Tensor) -> Tensor:
        tau = X.reshape(-1, 1) - X2.reshape(1, -1)
        s = torch.sin(math.pi * tau / self.period) / self.lengthscales
        return self.variance * torch.exp(-0.5 * s**2)
