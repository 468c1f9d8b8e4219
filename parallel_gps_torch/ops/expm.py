"""Batched matrix exponential by one fixed program
(counterpart: parallel_gps_tpu/ops/expm.py).

The discretisation needs ``expm(dt_k · F)`` for T small matrices.  A kernel
without a closed form (RBF above order 8, a composite of one) takes this
path:

  - Padé-13 (Higham 2005): six batched matmuls and one (d, d) solve;
  - each matrix scaled by 2^{-k} with k chosen elementwise from its norm,
    then ``MAX_SQUARINGS`` squarings, each kept or dropped by ``where``: no
    control flow depends on the data, so any mix of step sizes runs the
    same program.

The minus-identity form ``expm(A) − I`` is computed without cancellation
(``expm1_pade13``).  The solve is normalised by 1/b0: unnormalised, the
entries of V − U are O(b0) ≈ 6.5e16 and a small-d adjugate (b0³) overflows
float32.  The time-last form (``expm1_dt_tl``) runs the same batched
matmuls on a time-first view and moves the axes at the end: the JAX
package's broadcast-multiply-reduce over (d, d, T) planes is a TPU layout
choice that materialises a d³·T temporary a product.

Everything is differentiable (plain arithmetic and one linear solve).
"""
from __future__ import annotations

import torch
from torch import Tensor

from parallel_gps_torch.ops.linalg import solve_small

# Padé-13 coefficients (Higham, "The scaling and squaring method for the
# matrix exponential revisited", 2005).
_B13 = (
    64764752532480000.0,
    32382376266240000.0,
    7771770303897600.0,
    1187353796428800.0,
    129060195264000.0,
    10559470521600.0,
    670442572800.0,
    33522128640.0,
    1323241920.0,
    40840800.0,
    960960.0,
    16380.0,
    182.0,
    1.0,
)
_THETA13 = 5.371920351148152  # ||A|| below which Padé-13 is accurate
MAX_SQUARINGS = 16  # covers ||A|| up to θ13·2^16 ≈ 3.5e5


def expm1_pade13(A: Tensor, max_squarings: int = MAX_SQUARINGS) -> Tensor:
    """``expm(A) − I`` over the trailing (d, d) axes, batched over the
    leading ones, without cancellation.

    The approximant is E = (V − U)⁻¹(V + U), so E − I = (V − U)⁻¹·2U, where
    U = A·(polynomial) is O(‖A‖): no large-minus-large subtraction even at
    ‖A‖ ~ 1e−6.  The squarings keep the form: E² − I = (E − I)² + 2(E − I).
    """
    d = A.shape[-1]
    eye = torch.eye(d, dtype=A.dtype, device=A.device)

    # Per-matrix scaling: k = max(0, ceil(log2(‖A‖ / θ13))), capped, with
    # the norm of the JAX package (the largest absolute row sum).
    norm = A.abs().sum(-1).amax(-1)
    k = torch.ceil(torch.log2(torch.clamp(norm / _THETA13, min=1.0))).clamp(0, max_squarings)
    A = A * torch.exp2(-k)[..., None, None]

    b = _B13
    A2 = A @ A
    A4 = A2 @ A2
    A6 = A2 @ A4
    W1 = b[13] * A6 + b[11] * A4 + b[9] * A2
    W2 = b[7] * A6 + b[5] * A4 + b[3] * A2 + b[1] * eye
    U = A @ (A6 @ W1 + W2)
    Z1 = b[12] * A6 + b[10] * A4 + b[8] * A2
    V = A6 @ Z1 + b[6] * A6 + b[4] * A4 + b[2] * A2 + b[0] * eye

    inv_b0 = 1.0 / b[0]
    Em1 = solve_small((V - U) * inv_b0, (2.0 * inv_b0) * U)
    for j in range(max_squarings):
        Em1 = torch.where((j < k)[..., None, None], Em1 @ Em1 + 2.0 * Em1, Em1)
    return Em1


def expm_pade13(A: Tensor, max_squarings: int = MAX_SQUARINGS) -> Tensor:
    """``expm`` over the trailing (d, d) axes, batched over the leading ones."""
    return expm1_pade13(A, max_squarings) + torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)


def _scaled(F: Tensor, dts: Tensor) -> Tensor:
    """dt_k · F as (…, T, d, d) for F (…, d, d) and dts (T,)."""
    return dts.reshape(-1, 1, 1).to(F.dtype) * F[..., None, :, :]


def expm_dt_batched(F: Tensor, dts: Tensor, max_squarings: int = MAX_SQUARINGS) -> Tensor:
    """``expm(dt_k · F)``, (…, T, d, d), for step sizes (T,) and F (…, d, d)."""
    return expm_pade13(_scaled(F, dts), max_squarings)


def expm1_dt_batched(F: Tensor, dts: Tensor, max_squarings: int = MAX_SQUARINGS) -> Tensor:
    """``expm(dt_k · F) − I``, (…, T, d, d), cancellation-free."""
    return expm1_pade13(_scaled(F, dts), max_squarings)


def expm1_dt_tl(F: Tensor, dts: Tensor, max_squarings: int = MAX_SQUARINGS) -> Tensor:
    """``expm(dt_k · F) − I`` time-last: (d, d, T) for F (d, d), and
    (d, d, C, T) for a batch of C chains' F (C, d, d), as ``discretize_tl``
    takes them.  Computed time-first by batched matmuls, then the axes are
    moved (a view)."""
    return expm1_dt_batched(F, dts, max_squarings).movedim((-2, -1), (0, 1))
