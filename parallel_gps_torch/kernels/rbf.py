"""RBF / squared-exponential kernel via an order-k Taylor SDE approximation
(counterpart: parallel_gps_tpu/kernels/rbf.py).

The SE spectral density has no finite-dimensional SDE: its inverse is
Taylor-expanded to order k, the stable (left-half-plane) roots of the
resulting polynomial are found once in float64 numpy (they do not depend on
the hyperparameters), and a controllable companion form is built.  The
lengthscale and variance scale it under autograd.

Transitions, order ≤ 8: the spectral closed form of the unit-lengthscale
companion F(1) (``_rbf_spectral``), evaluated elementwise in u = dt/ℓ and
mapped to ``get_sde``'s balanced basis by the diagonal similarity κ
(``_kappa``).  ``transition_coeffs()`` gives it as the ``SPECTRAL`` family
(rbf.py:235-290 of the JAX package): the coefficients
``[1/ℓ | per block: κ·G (d²) and, for a conjugate pair, κ·S (d²)]`` and,
carried with the family and derived from d alone, the block table
(``spectral_blocks``).  RBF models with ``parallel=True`` take the dt engine
(kalman/dt.py), as the reference does.  Above order 8 the transitions are
the Padé exponential of F (ops/expm.py) and the models take the plain
time-last engine (d > 8), as the JAX package's XLA route does.

Hyperparameters of shape (C,) (C chains of a sampler) give every matrix and
the coefficients a leading C axis, as the Matérn kernels do; each chain's
balancing and κ are its own (``balance_scale`` over the batch).
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
from torch import Tensor

from parallel_gps_torch import config
from parallel_gps_torch.kernels.base import VarianceLengthscaleKernel, scaled_dist
from parallel_gps_torch.ops.balance import balance_scale, balance_ss
from parallel_gps_torch.ops.lyapunov import solve_lyap_vec
from parallel_gps_torch.types import ContinuousDiscreteModel

# Spectral closed forms are used up to this order; beyond it the companion's
# eigenvector conditioning degrades and the transitions need a Padé
# exponential.
SPECTRAL_MAX_ORDER = 8
# The transition family of the spectral closed form (kalman/dt.py).
SPECTRAL = "spectral"


@lru_cache(maxsize=None)
def _unscaled_rbf_sde(order: int):
    """(F, L, H, q) of the unit-lengthscale, unit-variance SE kernel's SDE:
    numpy float64, independent of the hyperparameters."""
    B = math.sqrt(2.0 * math.pi)
    A = np.zeros((2 * order + 1,), dtype=np.float64)
    i = 0
    for k in range(order, -1, -1):
        A[i] = 0.5**k / math.factorial(k)
        i += 2

    q = B / np.polyval(A, 0)

    # Substitute s = iω: divide coefficient j (degree 2·order − j) by i^degree.
    LA = np.real(A / (1j ** np.arange(A.size - 1, -1, -1)))
    AR = np.roots(LA)

    GB = 1.0
    GA = np.poly(AR[np.real(AR) < 0])
    GA = GA / GA[-1]
    GB = GB / GA[0]
    GA = GA / GA[0]

    n = GA.size - 1
    F = np.zeros((n, n), dtype=np.float64)
    F[-1, :] = -GA[:0:-1]
    F[:-1, 1:] = np.eye(n - 1)
    L = np.zeros((n, 1), dtype=np.float64)
    L[-1, 0] = 1.0
    H = np.zeros((1, n), dtype=np.float64)
    H[0, 0] = GB
    return F, L, H, float(q)


@lru_cache(maxsize=None)
def _rbf_spectral(order: int):
    """Spectral decomposition of the unit-lengthscale companion F(1): real
    and conjugate-pair eigenvalue blocks with their real projector matrices,
    so that

        expm(u·F(1)) − I = Σ_real  expm1(α_k u)·G_k
                         + Σ_pairs [ (e^{α_k u} cos(β_k u) − 1)·G_k
                                     + e^{α_k u} sin(β_k u)·S_k ]

    with G_k = 2·Re(v_k w_kᵀ), S_k = −2·Im(v_k w_kᵀ) for a pair α_k ± iβ_k
    (G_k = Re(v_k w_kᵀ) for a real root), v_k / w_k right / left eigenvectors.
    Σ_k G_k = I, so every term is O(u) at small u when the diagonal factor is
    computed as expm1(αu)·cos(βu) − 2 sin²(βu/2): cancellation-free.  Returns
    a tuple of (alpha, beta, G, S), S ``None`` for real roots; numpy float64."""
    F1, _, _, _ = _unscaled_rbf_sde(order)
    w, V = np.linalg.eig(F1)
    Winv = np.linalg.inv(V)
    blocks = []
    used = np.zeros(w.size, dtype=bool)
    for k in range(w.size):
        if used[k]:
            continue
        lam = w[k]
        P = np.outer(V[:, k], Winv[k, :])
        if abs(lam.imag) < 1e-10 * max(1.0, abs(lam.real)):
            blocks.append((float(lam.real), 0.0, np.real(P), None))
            used[k] = True
        else:
            if lam.imag < 0:
                lam = np.conj(lam)
                P = np.conj(P)
            blocks.append((float(lam.real), float(lam.imag), 2.0 * P.real, -2.0 * P.imag))
            used[k] = True
            conj_idx = np.where(~used & (np.abs(w - np.conj(lam)) < 1e-8 * abs(lam)))[0]
            if conj_idx.size:
                used[conj_idx[0]] = True
    # The projectors must resolve the identity to float64 roundoff.
    resid = np.abs(sum(b[2] for b in blocks) - np.eye(F1.shape[0])).max()
    if resid > 1e-6:
        raise ValueError(f"RBF order {order} spectral resolution residual {resid:.2e}")
    return tuple(blocks)


def spectral_blocks(d: int) -> tuple:
    """The block table of the order-d spectral family: one (a, β) per
    eigenvalue block of F(1), a = −α > 0, β = 0 for a real root (a G
    coefficient matrix only) and β > 0 for a conjugate pair (G and S), in the
    order of the coefficients.  It depends on d alone."""
    return tuple((-alpha, beta) for alpha, beta, _, _ in _rbf_spectral(d))


def spectral_transitions_m1(coeffs: Tensor, dts: Tensor, d: int) -> Tensor:
    """(d, d, T) ``expm(dt·F) − I`` of the spectral family from its
    coefficients (what the JAX ``build`` closure of rbf.py:267-288 computes):
    with u = dt·c[0], a real block adds expm1(−a·u)·κG and a conjugate pair
    (expm1(−a·u)·cos(βu) − 2 sin²(βu/2))·κG + e^{−a·u} sin(βu)·κS.
    Differentiable in ``coeffs`` and ``dts``; (d, d, B, T) for ``coeffs``
    (B, n), with ``dts`` (T,) or (B, T)."""
    batch = tuple(coeffs.shape[:-1])
    u = dts * coeffs[..., 0:1] if batch else dts.reshape(-1) * coeffs[0]
    out = torch.zeros((d, d) + tuple(u.shape), dtype=dts.dtype, device=dts.device)

    def matrix(off):
        return coeffs[..., off : off + d * d].reshape(batch + (d, d)).movedim((-2, -1), (0, 1))[..., None]

    off = 1
    for a, beta in spectral_blocks(d):
        G = matrix(off)
        off += d * d
        if beta == 0.0:
            out = out + torch.expm1(-a * u) * G
            continue
        S = matrix(off)
        off += d * d
        bu = beta * u
        em1 = torch.expm1(-a * u) * torch.cos(bu) - 2.0 * torch.sin(0.5 * bu) ** 2
        out = out + em1 * G + torch.exp(-a * u) * torch.sin(bu) * S
    return out


class RBF(VarianceLengthscaleKernel):
    def __init__(self, variance=1.0, lengthscales=1.0, order: int = 3, balancing_iter: int = -1, *, dtype=None, device=None):
        super().__init__(variance, lengthscales, dtype=dtype, device=device)
        self.order = int(order)
        self.balancing_iter = balancing_iter

    def _n_iter(self) -> int:
        return self.balancing_iter if self.balancing_iter >= 0 else config.NUMBER_OF_BALANCING_STEPS

    def _const(self, x) -> Tensor:
        ell = self.lengthscales
        return torch.as_tensor(x, dtype=ell.dtype, device=ell.device)

    def _ell(self) -> Tensor:
        """The lengthscale over the hyperparameters' batch shape."""
        return torch.broadcast_tensors(self.lengthscales, self.variance)[0]

    def _scaled_F(self) -> Tensor:
        """The lengthscale-scaled companion F(ℓ): the last row of F(1)
        divided by ℓ^{d−j}; (…, d, d) over the hyperparameters' batch axes."""
        F = self._const(_unscaled_rbf_sde(self.order)[0])
        dim = F.shape[0]
        ell = self._ell()
        ell_vec = ell[..., None] ** self._const(np.arange(dim, 0, -1.0))
        return torch.cat([F[: dim - 1].expand(ell.shape + (dim - 1, dim)), (F[dim - 1] / ell_vec)[..., None, :]], -2)

    def get_sde(self) -> ContinuousDiscreteModel:
        _, L_, H_, q_ = _unscaled_rbf_sde(self.order)
        F = self._scaled_F()
        ell = self._ell()
        batch = tuple(ell.shape)
        H = self._const(H_) / (ell**self.order)[..., None, None]
        Q = (self.variance * ell * q_).reshape(batch + (1, 1))
        Fb, Lb, Hb, Qb = balance_ss(F, self._const(L_), H, Q, self._n_iter())
        Pinf = solve_lyap_vec(Fb, Lb, Qb)
        return ContinuousDiscreteModel(Pinf, Fb, Lb, Hb, Qb.reshape(batch + (1, 1)))

    def _kappa(self) -> Tensor:
        """Entry scale κ[i, j] = ℓ^{j−i}·db_j / db_i mapping the
        unit-companion basis to ``get_sde``'s balanced basis:
        Am1_balanced[i, j] = κ[i, j]·(expm(u·F(1)) − I)[i, j], u = dt/ℓ, where
        F(ℓ) = D F(1) D⁻¹ / ℓ with D = diag(ℓ⁻ⁱ) and db is ``get_sde``'s
        balancing scale, a constant under autograd (ops/balance.py), computed
        for each chain of a batch on its own."""
        ell_pow = self._ell()[..., None] ** self._const(np.arange(self.order, dtype=np.float64))
        scale = ell_pow * balance_scale(self._scaled_F(), self._n_iter())
        return scale[..., None, :] / scale[..., :, None]

    def transition_coeffs(self):
        """``(SPECTRAL, coeffs)``: the spectral closed form with κ folded into
        each block's projector matrices, laid out
        ``[1/ℓ | per block: κ·G (d²) and, for a conjugate pair, κ·S (d²)]``
        (1 + d³ values, (B, 1 + d³) for B chains); the block table is
        ``spectral_blocks(d)``.  ``None`` above ``SPECTRAL_MAX_ORDER``: the
        transitions are then the Padé exponential of ``get_sde().F``
        (``SDEKernel.transitions_m1_tl``) and the models take the plain
        time-last engine, as the JAX package routes them (rbf.py:193-199)."""
        if self.order > SPECTRAL_MAX_ORDER:
            return None
        kap = self._kappa()
        batch = tuple(kap.shape[:-2])
        parts = [(1.0 / self._ell()).reshape(batch + (1,))]
        for _, _, G, S in _rbf_spectral(self.order):
            parts += [(kap * self._const(M)).reshape(batch + (-1,)) for M in (G, S) if M is not None]
        return SPECTRAL, torch.cat(parts, -1)

    def dense(self, X: Tensor, X2: Tensor) -> Tensor:
        r = scaled_dist(X, X2, self.lengthscales)
        return self.variance * torch.exp(-0.5 * r**2)
