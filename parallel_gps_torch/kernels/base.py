"""Kernel → SDE compiler: the SDEKernel contract and the Sum and Product
combinators (counterpart: parallel_gps_tpu/kernels/base.py).

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

``+`` and ``*`` build ``Sum`` and ``Product`` kernels: a block-diagonal and
a Kronecker state space, balanced by a diagonal similarity.  Children whose
hyperparameters have shape (C,) (C chains of a sampler) give the composite's
matrices, planes and coefficients a leading (planes: third) C axis, each
chain balanced by its own similarity.  Their
transitions fold their children's closed forms; their
``transition_coeffs()`` is the composite family (kernels/composite.py), or
``None`` where a child has none.
"""
from __future__ import annotations

from functools import reduce

import torch
from torch import Tensor, nn

from parallel_gps_torch import config
from parallel_gps_torch.models.params import inv_softplus, softplus
from parallel_gps_torch.ops.balance import balance_scale, balance_ss
from parallel_gps_torch.ops.disc import discretize, discretize_tl
from parallel_gps_torch.ops.expm import expm1_dt_tl
from parallel_gps_torch.ops.lyapunov import solve_lyap_vec
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
        """Time-last ``expm(dt_k · F) − I`` as (d, d, T), or (d, d, C, T) for
        C chains: the closed form of ``transition_coeffs()``, or for a kernel
        without one the Padé exponential of ``get_sde().F``
        (ops/expm.py)."""
        from parallel_gps_torch.kernels.matern import build_transitions_m1

        transition = self.transition_coeffs()
        if transition is None:
            return expm1_dt_tl(self.get_sde().F, dts)
        family, coeffs = transition
        return build_transitions_m1(family, coeffs.to(dts.dtype), dts, self.state_dim)

    def transitions_m1(self, dts: Tensor) -> Tensor:
        """``expm(dt_k · F) − I`` as (T, d, d), or (C, T, d, d) for C chains:
        a time-first view of ``transitions_m1_tl`` (the Padé path computes
        time-first and returns a time-last view, so nothing moves)."""
        return self.transitions_m1_tl(dts).movedim((0, 1), (-2, -1))

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

    def __add__(self, other: "SDEKernel") -> "Sum":
        return Sum(self, other)

    def __mul__(self, other: "SDEKernel") -> "Product":
        return Product(self, other)


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


def _block_diag(mats) -> Tensor:
    """Block-diagonal stack of possibly non-square matrices over their
    trailing two axes, with any leading batch axes broadcast."""
    batch = torch.broadcast_shapes(*(m.shape[:-2] for m in mats))
    if not batch:
        return torch.block_diag(*mats)
    out = mats[0].new_zeros(batch + (sum(m.shape[-2] for m in mats), sum(m.shape[-1] for m in mats)))
    r = c = 0
    for m in mats:
        out[..., r : r + m.shape[-2], c : c + m.shape[-1]] = m
        r, c = r + m.shape[-2], c + m.shape[-1]
    return out


def kron(a: Tensor, b: Tensor) -> Tensor:
    """The Kronecker product of the trailing two axes, with any leading batch
    axes broadcast (``torch.kron`` multiplies out every axis)."""
    if a.dim() == 2 and b.dim() == 2:
        return torch.kron(a, b)
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    out = a[..., :, None, :, None] * b[..., None, :, None, :]
    return out.reshape(batch + (a.shape[-2] * b.shape[-2], a.shape[-1] * b.shape[-1]))


def _kron_F(F1: Tensor, F2: Tensor) -> Tensor:
    """F = F1 ⊗ I + I ⊗ F2 (base.py:287-292)."""
    I1 = torch.eye(F1.shape[-1], dtype=F1.dtype, device=F1.device)
    I2 = torch.eye(F2.shape[-1], dtype=F2.dtype, device=F2.device)
    return kron(F1, I2) + kron(I1, F2)


def _similarity_tl(dvec: Tensor, like: Tensor) -> Tensor:
    """The balancing similarity d_j / d_i as a time-last factor of ``like``'s
    (d, d, …, T) planes: (d, d, 1) or, for B chains' scales (B, d),
    (d, d, B, 1)."""
    dvec = dvec.to(like.dtype)
    return (dvec[..., None, :] / dvec[..., :, None]).movedim((-2, -1), (0, 1))[..., None]


def _common_planes(planes: list) -> list:
    """The children's (dk, dk, …, T) planes over one shared set of trailing
    axes: a child without the batch axis of another is viewed with it."""
    common = torch.broadcast_shapes(*(p.shape[2:] for p in planes))
    out = []
    for p in planes:
        p = p.reshape(p.shape[:2] + (1,) * (len(common) + 2 - p.dim()) + p.shape[2:])
        out.append(p.expand(p.shape[:2] + common))
    return out


class _Composite(SDEKernel):
    """Children in an ``nn.ModuleList``; ``balancing_iter`` < 0 takes
    ``config.NUMBER_OF_BALANCING_STEPS``."""

    def __init__(self, *kernels: SDEKernel, balancing_iter: int = -1):
        super().__init__()
        self.kernels = nn.ModuleList(kernels)
        self.balancing_iter = balancing_iter

    def _n_iter(self) -> int:
        return self.balancing_iter if self.balancing_iter >= 0 else config.NUMBER_OF_BALANCING_STEPS

    def _balanced(self, F, L, H, Q) -> ContinuousDiscreteModel:
        Fb, Lb, Hb, Qb = balance_ss(F, L, H, Q, self._n_iter())
        return ContinuousDiscreteModel(solve_lyap_vec(Fb, Lb, Qb), Fb, Lb, Hb, Qb)

    def transition_coeffs(self):
        """The composite family (kernels/composite.py): the children's closed
        forms folded and conjugated by this kernel's balancing similarity,
        which carries no gradient; ``None`` where a child has no closed
        form."""
        from parallel_gps_torch.kernels import composite

        parts = []
        for k in self.kernels:
            transition = k.transition_coeffs()
            if transition is None:
                return None
            parts.append(composite.expansion(*transition, k.state_dim))
        dvec = balance_scale(self._unbalanced_F(), self._n_iter())
        return self._fold(parts).scaled(dvec).encode()

    def __repr__(self):
        return f"{type(self).__name__}({', '.join(map(repr, self.kernels))})"


class Sum(_Composite):
    """Sum of SDE kernels: concatenated (block-diagonal) state space
    (base.py:156-281)."""

    @property
    def state_dim(self) -> int:
        return sum(k.state_dim for k in self.kernels)

    def _unbalanced_F(self) -> Tensor:
        return _block_diag([k.get_sde().F for k in self.kernels])

    def get_sde(self) -> ContinuousDiscreteModel:
        sdes = [k.get_sde() for k in self.kernels]
        F = _block_diag([s.F for s in sdes])
        L = _block_diag([s.L for s in sdes])
        batch = torch.broadcast_shapes(*(s.H.shape[:-2] for s in sdes))
        H = torch.cat([s.H.expand(batch + s.H.shape[-2:]) for s in sdes], -1)
        Q = _block_diag([s.Q for s in sdes])
        return self._balanced(F, L, H, Q)

    def dense(self, X: Tensor, X2: Tensor) -> Tensor:
        return reduce(torch.add, [k.dense(X, X2) for k in self.kernels])

    def transitions_m1_tl(self, dts: Tensor) -> Tensor:
        """The children's (dk, dk, T) closed forms on the block diagonal,
        conjugated by the balancing similarity (a block-diagonal F
        exponentiates blockwise; subtracting I commutes with both)."""
        children = _common_planes([k.transitions_m1_tl(dts) for k in self.kernels])
        d = self.state_dim
        out = children[0].new_zeros((d, d) + children[0].shape[2:])
        r = 0
        for m1 in children:
            dk = m1.shape[0]
            out[r : r + dk, r : r + dk] = m1
            r += dk
        return out * _similarity_tl(balance_scale(self._unbalanced_F(), self._n_iter()), out)

    def _fold(self, parts):
        from parallel_gps_torch.kernels.composite import sum_expansion

        return sum_expansion(parts)


class Product(_Composite):
    """Product of SDE kernels by Kronecker algebra, folded pairwise, so that
    products of any arity work (base.py:287-474)."""

    @property
    def state_dim(self) -> int:
        out = 1
        for k in self.kernels:
            out *= k.state_dim
        return out

    def _unbalanced_F(self) -> Tensor:
        return reduce(_kron_F, [k.get_sde().F for k in self.kernels])

    def get_sde(self) -> ContinuousDiscreteModel:
        def fold(s1: ContinuousDiscreteModel, s2: ContinuousDiscreteModel) -> ContinuousDiscreteModel:
            F = _kron_F(s1.F, s2.F)
            gamma1 = s1.L @ s1.Q @ s1.L.transpose(-1, -2)
            gamma2 = s2.L @ s2.Q @ s2.L.transpose(-1, -2)
            Q = kron(gamma1, s2.P0) + kron(s1.P0, gamma2)
            L = torch.eye(F.shape[-1], dtype=F.dtype, device=F.device)
            return ContinuousDiscreteModel(kron(s1.P0, s2.P0), F, L, kron(s1.H, s2.H), Q)

        s = reduce(fold, [k.get_sde() for k in self.kernels])
        return self._balanced(s.F, s.L, s.H, s.Q)

    def dense(self, X: Tensor, X2: Tensor) -> Tensor:
        return reduce(torch.mul, [k.dense(X, X2) for k in self.kernels])

    def transitions_m1_tl(self, dts: Tensor) -> Tensor:
        """The Kronecker fold of the children's closed forms,
        A − I = Am1_a ⊗ Am1_b + Am1_a ⊗ I + I ⊗ Am1_b (the terms of
        F_a ⊗ I + I ⊗ F_b commute), T last; conjugated by the balancing
        similarity."""

        def kron_tl(a, b):
            da, db = a.shape[0], b.shape[0]
            out = a[:, None, :, None] * b[None, :, None, :]
            return out.reshape((da * db, da * db) + out.shape[4:])

        def fold(am1, bm1):
            ia = torch.eye(am1.shape[0], dtype=am1.dtype, device=am1.device)[:, :, None].expand(am1.shape)
            ib = torch.eye(bm1.shape[0], dtype=bm1.dtype, device=bm1.device)[:, :, None].expand(bm1.shape)
            return kron_tl(am1, bm1) + kron_tl(am1, ib) + kron_tl(ia, bm1)

        out = reduce(fold, _common_planes([k.transitions_m1_tl(dts) for k in self.kernels]))
        return out * _similarity_tl(balance_scale(self._unbalanced_F(), self._n_iter()), out)

    def _fold(self, parts):
        from parallel_gps_torch.kernels.composite import product_expansion

        return reduce(product_expansion, parts)
