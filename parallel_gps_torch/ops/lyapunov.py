"""Vectorized continuous Lyapunov solver
(counterpart: parallel_gps_tpu/ops/lyapunov.py).

Solves F P + P Fᵀ + L Q Lᵀ = 0 for the stationary covariance P∞: with
row-major vec, (I ⊗ F + F ⊗ I) vec(P) = −vec(L Q Lᵀ), a d² × d² dense solve
(9 × 9 for Matern52).  F, L and Q may carry leading batch axes: one batched
solve.
"""
from __future__ import annotations

import torch
from torch import Tensor

from parallel_gps_torch.ops.linalg import symmetrize


def solve_lyap_vec(F: Tensor, L: Tensor, Q: Tensor) -> Tensor:
    dim = F.shape[-1]
    eye = torch.eye(dim, dtype=F.dtype, device=F.device)
    # torch.kron multiplies out every axis: batch axes meet the size-1 axes it
    # pads ``eye`` with and pass through.
    K = torch.kron(eye, F) + torch.kron(F, eye)
    LQL = L @ Q @ L.transpose(-1, -2)
    rhs = LQL.reshape(LQL.shape[:-2] + (dim * dim, 1))
    if K.dim() == 2:
        # One system: a singular one raises ``torch.linalg.LinAlgError``.
        Pinf = torch.linalg.solve(K, rhs)
    else:
        # A batch of chains: hyperparameters a sampler proposed out of range
        # (inf, NaN) give a non-finite covariance for their chain alone — a
        # NaN energy, which a sampler counts as a rejection — instead of an
        # error that would end every chain.
        Pinf = torch.linalg.solve_ex(K, rhs).result
    return -symmetrize(Pinf.reshape(Pinf.shape[:-2] + (dim, dim)))
