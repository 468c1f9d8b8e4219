"""Kernel → SDE compiler: the SDEKernel contract
(counterpart: parallel_gps_tpu/kernels/base.py; Sum and Product are not
ported yet).

A kernel is an ``nn.Module`` whose positive hyperparameters are stored
unconstrained (softplus).  It provides

  - ``get_sde()``: the LTI SDE of the stationary covariance;
  - ``transition_coeffs()``: ``(family, coeffs)``, the closed form of
    ``expm(dt·F) − I`` as a family id and a flat coefficient tensor — what
    the dt-engine kernels rebuild the transitions from, per step, in
    registers;
  - ``transitions_m1_tl(dts)`` and ``get_ssm_tl(ts, R)``: the time-last
    transitions and discretised model, for the plain path and the tests;
  - ``state_dim``.
"""
from __future__ import annotations

from torch import Tensor, nn

from parallel_gps_torch.ops.disc import discretize_tl
from parallel_gps_torch.types import LGSSMTL, ContinuousDiscreteModel


class SDEKernel(nn.Module):
    def get_sde(self) -> ContinuousDiscreteModel:
        raise NotImplementedError

    @property
    def state_dim(self) -> int:
        raise NotImplementedError

    def transition_coeffs(self) -> tuple[str, Tensor]:
        raise NotImplementedError

    def transitions_m1_tl(self, dts: Tensor) -> Tensor:
        """Time-last ``expm(dt_k · F) − I`` as (d, d, T)."""
        from parallel_gps_torch.kernels.matern import build_transitions_m1

        family, coeffs = self.transition_coeffs()
        return build_transitions_m1(family, coeffs.to(dts.dtype), dts, self.state_dim)

    def get_ssm_tl(self, ts: Tensor, R: Tensor, t0=0.0) -> LGSSMTL:
        sde = self.get_sde()
        dtype = sde.F.dtype
        return discretize_tl(
            sde, ts.to(dtype), R, t0,
            transitions_m1_tl=lambda dts: self.transitions_m1_tl(dts.to(dtype)),
        )
