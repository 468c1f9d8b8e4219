"""Kernel → SDE compiler: the SDEKernel contract
(counterpart: parallel_gps_tpu/kernels/base.py; Sum and Product are not
ported yet).

A kernel is an ``nn.Module`` whose positive hyperparameters are stored
unconstrained (softplus).  It provides

  - ``get_sde()``: the LTI SDE of the stationary covariance;
  - ``transition_coeffs()``: ``(family, coeffs)``, the closed form of
    ``expm(dt·F) − I`` as a family id and a flat coefficient tensor — what
    the dt-engine kernels rebuild the transitions from, per step, in
    registers — or ``None`` for a kernel without one, whose models take the
    plane-streaming strip engine (kalman/strip.py);
  - ``transitions_m1_tl(dts)`` and ``get_ssm_tl(ts, R)``: the time-last
    transitions and discretised model; ``transitions_m1`` and ``get_ssm``
    the same in the reference (time-first) layout;
  - ``dense(X, X2)``: the dense covariance matrix, for the dense-GP oracle;
  - ``state_dim``.
"""
from __future__ import annotations

import torch
from torch import Tensor, nn

from parallel_gps_torch import config
from parallel_gps_torch.models.params import inv_softplus, softplus
from parallel_gps_torch.ops.disc import discretize, discretize_tl
from parallel_gps_torch.types import LGSSM, LGSSMTL, ContinuousDiscreteModel


def scaled_dist(X: Tensor, X2: Tensor, lengthscales: Tensor) -> Tensor:
    """|x − x'| / ℓ between two sets of 1-D inputs, (N, M)."""
    return (X.reshape(-1, 1) - X2.reshape(1, -1)).abs() / lengthscales


class SDEKernel(nn.Module):
    def get_sde(self) -> ContinuousDiscreteModel:
        raise NotImplementedError

    @property
    def state_dim(self) -> int:
        raise NotImplementedError

    def transition_coeffs(self) -> tuple[str, Tensor] | None:
        """``(family, coeffs)`` for the dt-engine, or ``None`` (default) for
        a kernel with no closed-form transition family in the port."""
        return None

    def dense(self, X: Tensor, X2: Tensor) -> Tensor:
        raise NotImplementedError

    def transitions_m1_tl(self, dts: Tensor) -> Tensor:
        """Time-last ``expm(dt_k · F) − I`` as (d, d, T)."""
        from parallel_gps_torch.kernels.matern import build_transitions_m1

        transition = self.transition_coeffs()
        if transition is None:
            raise NotImplementedError(f"{type(self).__name__} has no transition coefficients: override transitions_m1_tl")
        family, coeffs = transition
        return build_transitions_m1(family, coeffs.to(dts.dtype), dts, self.state_dim)

    def transitions_m1(self, dts: Tensor) -> Tensor:
        """``expm(dt_k · F) − I`` as (T, d, d)."""
        return self.transitions_m1_tl(dts).movedim(-1, 0)

    def get_ssm(self, ts: Tensor, R: Tensor, t0=0.0) -> LGSSM:
        """Discretised model in the reference (time-first) layout."""
        sde = self.get_sde()
        dtype = sde.F.dtype
        return discretize(sde, ts.to(dtype), R, t0, transitions_m1=lambda dts: self.transitions_m1(dts.to(dtype)))

    def get_ssm_tl(self, ts: Tensor, R: Tensor, t0=0.0) -> LGSSMTL:
        sde = self.get_sde()
        dtype = sde.F.dtype
        return discretize_tl(
            sde, ts.to(dtype), R, t0,
            transitions_m1_tl=lambda dts: self.transitions_m1_tl(dts.to(dtype)),
        )


class VarianceLengthscaleKernel(SDEKernel):
    """Shared storage of the stationary kernels: softplus-unconstrained
    variance and lengthscale; the state dimension is ``order``.  Either may
    have shape (C,) — C chains of a sampler, or C models — and the Matérn
    kernels then build every matrix over that leading axis."""

    order: int

    def __init__(self, variance=1.0, lengthscales=1.0, *, dtype=None, device=None):
        super().__init__()
        dtype = dtype or config.default_float()
        device = config.resolve_device(device)

        def raw(v):
            u = inv_softplus(torch.as_tensor(v, dtype=torch.float64))
            return nn.Parameter(u.to(dtype=dtype, device=device))

        self.raw_variance = raw(variance)
        self.raw_lengthscales = raw(lengthscales)

    @property
    def variance(self) -> Tensor:
        return softplus(self.raw_variance)

    @property
    def lengthscales(self) -> Tensor:
        return softplus(self.raw_lengthscales)

    @property
    def state_dim(self) -> int:
        return self.order
