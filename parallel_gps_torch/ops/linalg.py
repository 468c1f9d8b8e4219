"""Small-matrix helpers (counterpart: parallel_gps_tpu/ops/linalg.py)."""
from __future__ import annotations

import math

import torch
from torch import Tensor


def symmetrize(P: Tensor) -> Tensor:
    """0.5 (P + Pᵀ) over the trailing two axes."""
    return 0.5 * (P + P.transpose(-1, -2))


def inv_small(M: Tensor) -> Tensor:
    """Inverse over the trailing two axes: closed-form adjugate for d ≤ 3,
    ``torch.linalg.inv`` above."""
    d = M.shape[-1]
    if d == 1:
        return 1.0 / M
    if d == 2:
        a, b, c, e = M[..., 0, 0], M[..., 0, 1], M[..., 1, 0], M[..., 1, 1]
        adj = torch.stack([torch.stack([e, -b], -1), torch.stack([-c, a], -1)], -2)
        return adj / (a * e - b * c)[..., None, None]
    if d == 3:
        a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
        e, f, g = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
        h, i, j = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
        A00, A01, A02 = f * j - g * i, c * i - b * j, b * g - c * f
        A10, A11, A12 = g * h - e * j, a * j - c * h, c * e - a * g
        A20, A21, A22 = e * i - f * h, b * h - a * i, a * f - b * e
        det = a * A00 + b * A10 + c * A20
        adj = torch.stack(
            [torch.stack([A00, A01, A02], -1), torch.stack([A10, A11, A12], -1), torch.stack([A20, A21, A22], -1)], -2
        )
        return adj / det[..., None, None]
    return torch.linalg.inv(M)


def solve_small(M: Tensor, B: Tensor) -> Tensor:
    """``inv(M) @ B``, closed form for d ≤ 3."""
    if M.shape[-1] <= 3:
        return inv_small(M) @ B
    return torch.linalg.solve(M, B)


def solve_right(M: Tensor, A: Tensor) -> Tensor:
    """``A @ inv(M)`` by a transposed solve, batched over leading axes (the
    reference's ``tf.linalg.solve(M, Aᵀ, adjoint=True)ᵀ``)."""
    return torch.linalg.solve(M.transpose(-1, -2), A.transpose(-1, -2)).transpose(-1, -2)


def cho_solve_psd(S: Tensor, B: Tensor) -> Tensor:
    """Solve ``S X = B`` for symmetric positive-definite S via Cholesky."""
    if S.shape[-1] == 1:  # scalar innovation: the usual one-row observation
        return B / S
    return torch.cholesky_solve(B, torch.linalg.cholesky(S))


def mvn_logpdf(y: Tensor, mean: Tensor, cov: Tensor) -> Tensor:
    """Log-density of N(mean, cov) at y; y, mean (..., k), cov (..., k, k)."""
    k = y.shape[-1]
    if k == 1:
        var = cov[..., 0, 0]
        diff = y[..., 0] - mean[..., 0]
        return -0.5 * (diff * diff / var + torch.log(var) + math.log(2.0 * math.pi))
    chol = torch.linalg.cholesky(cov)
    z = torch.linalg.solve_triangular(chol, (y - mean)[..., None], upper=False)[..., 0]
    logdet = 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
    return -0.5 * ((z * z).sum(-1) + logdet + k * math.log(2.0 * math.pi))
