"""Matérn half-integer kernels as LTI SDEs
(counterpart: parallel_gps_tpu/kernels/matern.py).

For smoothness ν = d − 1/2, λ = √(2d−1)/ℓ, F is the companion matrix with
ones on the superdiagonal and last row −binom(d,k) λ^{d−k}; L = e_d,
H = e_1ᵀ and q = (2λ)^{2d−1} σ² ((d−1)!)² / (2d−2)!.  Matern12 and Matern32
use closed-form stationary covariances; Matern52 balances and solves the
Lyapunov equation.

Transitions are the exponential-polynomial family (matern.py:69-103):

    expm(dt·F) − I = expm1(−λ dt)·I + e^{−λ dt} Σ_{p=1..deg} dt^p/p! · N_p

with N = F + λI nilpotent (balance-scaled for Matern52) and N_p = Nᵖ.  Its
coefficients are laid out flat as ``[λ | N₁ (d²) | … | N_deg (d²)]``, degree
d − 1; the CUDA kernels read the same layout (csrc/dt_elements.cuh).

Hyperparameters may carry leading batch axes (B chains of a sampler, B
models over one data set): every function here then returns its matrices
with the same leading axes — ``F`` (…, d, d), ``P0`` (…, d, d), ``coeffs``
(…, n) — from tensor operations over the whole batch, and a scalar
hyperparameter gives what it always gave.
"""
from __future__ import annotations

import math

import torch
from torch import Tensor

from parallel_gps_torch import config
from parallel_gps_torch.kernels.base import VarianceLengthscaleKernel, scaled_dist
from parallel_gps_torch.kernels.rbf import SPECTRAL, spectral_transitions_m1
from parallel_gps_torch.ops.balance import balance_scale, balance_ss
from parallel_gps_torch.ops.lyapunov import solve_lyap_vec
from parallel_gps_torch.types import ContinuousDiscreteModel

EXPPOLY = "exppoly"


def exppoly_transitions_m1(coeffs: Tensor, dts: Tensor, d: int) -> Tensor:
    """(d, d, T) ``expm(dt·F) − I`` of the exponential-polynomial family;
    (d, d, B, T) for ``coeffs`` (B, n), with ``dts`` (T,) or (B, T)."""
    batch = tuple(coeffs.shape[:-1])
    degree = (coeffs.shape[-1] - 1) // (d * d)
    lam = coeffs[..., 0:1]  # (*batch, 1): broadcasts against the time axis
    eye = torch.eye(d, dtype=dts.dtype, device=dts.device).reshape((d, d) + (1,) * (len(batch) + 1))
    Am1 = eye * torch.expm1(-lam * dts)
    if degree:
        term = torch.exp(-lam * dts) * dts
        for p in range(1, degree + 1):
            off = 1 + (p - 1) * d * d
            Np = coeffs[..., off : off + d * d].reshape(batch + (d, d)).movedim((-2, -1), (0, 1))[..., None]
            Am1 = Am1 + term * Np
            if p < degree:
                term = term * dts * (1.0 / (p + 1))
    return Am1


def build_transitions_m1(family: str, coeffs: Tensor, dts: Tensor, d: int) -> Tensor:
    """Dispatch on the transition family id: the exponential polynomial
    (here), RBF's spectral closed form (kernels/rbf.py) or the composite
    family of Periodic, Sum and Product (kernels/composite.py)."""
    from parallel_gps_torch.kernels.composite import COMPOSITE, composite_transitions_m1

    if family == EXPPOLY:
        return exppoly_transitions_m1(coeffs, dts, d)
    if family == SPECTRAL:
        return spectral_transitions_m1(coeffs, dts, d)
    if family == COMPOSITE:
        return composite_transitions_m1(family, coeffs, dts, d)
    raise ValueError(f"unknown transition family {family!r}")


def matern_sde(variance: Tensor, lengthscales: Tensor, d: int):
    """(F, L, H, Q) of the order-d Matérn SDE (see module docstring): F
    (…, d, d) and Q (…, 1, 1) over the hyperparameters' batch axes, L (d, 1)
    and H (1, d) shared."""
    variance, lengthscales = torch.broadcast_tensors(variance, lengthscales)
    dtype, device, batch = variance.dtype, variance.device, tuple(variance.shape)
    lam = math.sqrt(2 * d - 1) / lengthscales
    last = torch.stack([-math.comb(d, k) * lam ** (d - k) for k in range(d)], -1)
    shift = torch.diag(torch.ones(d - 1, dtype=dtype, device=device), 1)
    F = torch.cat([shift[: d - 1].expand(batch + (d - 1, d)), (shift[d - 1] + last)[..., None, :]], dim=-2)
    L = torch.zeros((d, 1), dtype=dtype, device=device)
    L[d - 1, 0] = 1.0
    H = torch.zeros((1, d), dtype=dtype, device=device)
    H[0, 0] = 1.0
    q = (2.0 * lam) ** (2 * d - 1) * variance * math.factorial(d - 1) ** 2 / math.factorial(2 * d - 2)
    return F, L, H, q.reshape(batch + (1, 1))


class Matern12(VarianceLengthscaleKernel):
    order = 1

    def get_sde(self) -> ContinuousDiscreteModel:
        F, L, H, Q = matern_sde(self.variance, self.lengthscales, 1)
        variance = torch.broadcast_tensors(self.variance, self.lengthscales)[0]
        return ContinuousDiscreteModel(variance.reshape(variance.shape + (1, 1)), F, L, H, Q)

    def transition_coeffs(self):
        lam = 1.0 / torch.broadcast_tensors(self.lengthscales, self.variance)[0]
        return EXPPOLY, lam.reshape(lam.shape + (1,))

    def dense(self, X: Tensor, X2: Tensor) -> Tensor:
        r = scaled_dist(X, X2, self.lengthscales)
        return self.variance * torch.exp(-r)


class Matern32(VarianceLengthscaleKernel):
    order = 2

    def get_sde(self) -> ContinuousDiscreteModel:
        F, L, H, Q = matern_sde(self.variance, self.lengthscales, 2)
        var, ell = torch.broadcast_tensors(self.variance, self.lengthscales)
        lam = math.sqrt(3) / ell
        Pinf = torch.diag_embed(torch.stack([var, lam**2 * var], -1))
        return ContinuousDiscreteModel(Pinf, F, L, H, Q)

    def transition_coeffs(self):
        lam = math.sqrt(3) / torch.broadcast_tensors(self.lengthscales, self.variance)[0]
        one = torch.ones_like(lam)
        N = torch.stack([torch.stack([lam, one], -1), torch.stack([-lam * lam, -lam], -1)], -2)
        return EXPPOLY, torch.cat([lam[..., None], N.reshape(lam.shape + (4,))], -1)

    def dense(self, X: Tensor, X2: Tensor) -> Tensor:
        r = math.sqrt(3) * scaled_dist(X, X2, self.lengthscales)
        return self.variance * (1.0 + r) * torch.exp(-r)


class Matern52(VarianceLengthscaleKernel):
    order = 3

    def __init__(self, variance=1.0, lengthscales=1.0, *, balancing_iter: int = -1, dtype=None, device=None):
        super().__init__(variance, lengthscales, dtype=dtype, device=device)
        self.balancing_iter = balancing_iter

    def _n_iter(self) -> int:
        return self.balancing_iter if self.balancing_iter >= 0 else config.NUMBER_OF_BALANCING_STEPS

    def get_sde(self) -> ContinuousDiscreteModel:
        F, L, H, Q = matern_sde(self.variance, self.lengthscales, 3)
        Fb, Lb, Hb, Qb = balance_ss(F, L, H, Q, self._n_iter())
        Pinf = solve_lyap_vec(Fb, Lb, Qb)
        return ContinuousDiscreteModel(Pinf, Fb, Lb, Hb, Qb)

    def transition_coeffs(self):
        F, _, _, _ = matern_sde(self.variance, self.lengthscales, 3)
        batch = tuple(F.shape[:-2])
        lam = (math.sqrt(5) / self.lengthscales).expand(batch)
        N = F + lam[..., None, None] * torch.eye(3, dtype=F.dtype, device=F.device)
        # Written out, not ``N @ N``: a batched product may round differently
        # from a single one, and a chain must not depend on its neighbours.
        N2 = (N[..., :, :, None] * N[..., None, :, :]).sum(-2)
        dvec = balance_scale(F, self._n_iter())
        scale = dvec[..., None, :] / dvec[..., :, None]  # [i, j] = d_j / d_i
        return EXPPOLY, torch.cat(
            [lam[..., None], (N * scale).reshape(batch + (9,)), (N2 * scale).reshape(batch + (9,))], -1
        )

    def dense(self, X: Tensor, X2: Tensor) -> Tensor:
        r = math.sqrt(5) * scaled_dist(X, X2, self.lengthscales)
        return self.variance * (1.0 + r + r**2 / 3.0) * torch.exp(-r)
