"""Vectorized continuous Lyapunov solver
(counterpart: parallel_gps_tpu/ops/lyapunov.py).

Solves F P + P Fᵀ + L Q Lᵀ = 0 for the stationary covariance P∞: with
row-major vec, (I ⊗ F + F ⊗ I) vec(P) = −vec(L Q Lᵀ), a d² × d² dense solve
(9 × 9 for Matern52).
"""
from __future__ import annotations

import torch
from torch import Tensor

from parallel_gps_torch.ops.linalg import symmetrize


def solve_lyap_vec(F: Tensor, L: Tensor, Q: Tensor) -> Tensor:
    dim = F.shape[0]
    eye = torch.eye(dim, dtype=F.dtype, device=F.device)
    K = torch.kron(eye, F) + torch.kron(F, eye)
    rhs = (L @ Q @ L.T).reshape(-1, 1)
    Pinf = torch.linalg.solve(K, rhs).reshape(dim, dim)
    return -symmetrize(Pinf)
