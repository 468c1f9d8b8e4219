"""The dt engine's composite transition family: Periodic, Sum and Product
(counterpart: the ``transition_coeffs`` builds of
parallel_gps_tpu/kernels/periodic.py:140 and kernels/base.py:242, :420).

Every closed form of the port is a sum of per-step scalar weights times
coefficient matrices: the exponential polynomial's
``expm1(−λdt)·I + Σ_p τ_p N_p`` (τ_p = e^{−λdt} dt^p/p!), RBF's spectral
``Σ_k em1_k G_k + es_k S_k`` and Periodic's rotation planes
``Σ_j (cos θ_j − 1)·R⁰_j + sin θ_j·R¹_j``.  A Sum places its children's
matrices on the block diagonal; a Product's Kronecker fold
``A − I = Am1_a ⊗ Am1_b + Am1_a ⊗ I + I ⊗ Am1_b`` multiplies the children's
weights and takes the Kronecker products of their matrices.  So a composite
of any depth is

    Am1(dt) = Σ_μ W_μ(dt)·K_μ,   W_μ = Π_{m ∈ μ} w_m(ρ_m, dt),

a *monomial* μ being a product of at most ``MAX_FACTORS`` leaf weights w_m,
each a closed-form function of one rate ρ_m (λ, the spectral 1/ℓ, or
Periodic's ω₀) and of dt, and K_μ a d×d matrix into which the composite's
balancing similarity d_j/d_i is folded (a constant under autograd, as the
reference's ``stop_gradient``).  The weights' kinds and constants and the
monomials' factors are the static ``Plan``; the rates and the matrices are
the coefficients, ``[ρ (n_w) | K_0 (d²) | … | K_{M−1} (d²)]``, differentiable
in the hyperparameters.  A matrix entry that is structurally zero (Periodic's
j = 0 block, a Sum's off-diagonal blocks, the zeros of a Kronecker product)
is zero in K_μ and off in the monomial's pattern: the kernels skip it, as
``pallas_dt.zmul`` / ``zsum`` skip a ``None`` entry.

The family value is ``CompositeFamily(plan)``, a ``str`` equal to
``COMPOSITE`` (every table keyed by family name takes it) that carries its
plan.  The CUDA kernels read the coefficients padded to fixed limits, then
the plan as numbers (``kernel_layout``; csrc/dt_elements.cuh: Composite).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import Tensor

COMPOSITE = "composite"
# The kernels' fixed limits (csrc/dt_elements.cuh: Composite): weights,
# monomials, factors a monomial, and the 16-bit words of a pattern (d² ≤ 64).
MAX_WEIGHTS = 16
MAX_MONOMIALS = 32
MAX_FACTORS = 3
MASK_WORDS = 4
# The weights' kinds, as the kernels read them.
EXPM1, TAU, COSM1, SIN, SPEC_EM1, SPEC_ES = range(6)


@dataclass(frozen=True)
class Plan:
    """The static part of a composite: ``weights`` (kind, p, q) — TAU's
    power p, a rotation's harmonic p, a spectral block's (a, β) = (p, q) —
    ``monomials`` (the weight ids of each) and ``patterns`` (each monomial's
    structurally nonzero entries, row-major d²)."""

    d: int
    weights: tuple
    monomials: tuple
    patterns: tuple

    def fits(self) -> bool:
        """Whether the CUDA kernels' limits hold it."""
        return (
            len(self.weights) <= MAX_WEIGHTS and len(self.monomials) <= MAX_MONOMIALS
            and all(len(m) <= MAX_FACTORS for m in self.monomials) and self.d * self.d <= 16 * MASK_WORDS
        )

    @property
    def n_coeffs(self) -> int:
        return len(self.weights) + len(self.monomials) * self.d * self.d


class CompositeFamily(str):
    """The composite family id (equal to ``COMPOSITE``) with its plan."""

    plan: Plan

    def __new__(cls, plan: Plan):
        family = super().__new__(cls, COMPOSITE)
        family.plan = plan
        return family


@dataclass
class Expansion:
    """A closed form as weights and monomials: ``rates`` (one scalar tensor a
    weight), ``matrices`` (K_μ, (d, d)) and ``patterns`` (bool (d, d))."""

    d: int
    weights: list
    rates: list
    monomials: list
    matrices: list
    patterns: list

    def encode(self) -> tuple[CompositeFamily, Tensor]:
        """``(CompositeFamily(plan), coeffs)``."""
        plan = Plan(
            self.d, tuple(self.weights), tuple(self.monomials),
            tuple(tuple(bool(v) for v in P.reshape(-1).tolist()) for P in self.patterns),
        )
        rates = [torch.stack(self.rates).reshape(-1)] if self.rates else []
        coeffs = torch.cat(rates + [K.reshape(-1) for K in self.matrices] or [torch.zeros(0)])
        return CompositeFamily(plan), coeffs

    def scaled(self, dvec: Tensor) -> "Expansion":
        """Conjugated by the diagonal similarity ``dvec`` (detached): entry
        [i, j] times d_j / d_i."""
        scale = dvec.detach()[None, :] / dvec.detach()[:, None]
        return Expansion(self.d, self.weights, self.rates, self.monomials, [K * scale for K in self.matrices], self.patterns)


def _leaf(d, weights, rates, matrices, patterns) -> Expansion:
    return Expansion(d, list(weights), list(rates), [(m,) for m in range(len(weights))], list(matrices), list(patterns))


def expansion(family, coeffs: Tensor, d: int) -> Expansion:
    """The expansion of a ``transition_coeffs()`` result of any family."""
    from parallel_gps_torch.kernels.matern import EXPPOLY
    from parallel_gps_torch.kernels.rbf import SPECTRAL, spectral_blocks

    if coeffs.dim() != 1:
        raise NotImplementedError("a composite of kernels whose hyperparameters carry a batch axis is ROADMAP.md B7")
    dtype, device = coeffs.dtype, coeffs.device
    full = torch.ones((d, d), dtype=torch.bool, device=device)
    if family == EXPPOLY:
        degree = (coeffs.shape[0] - 1) // (d * d)
        eye = torch.eye(d, dtype=dtype, device=device)
        Ns = [coeffs[1 + p * d * d : 1 + (p + 1) * d * d].reshape(d, d) for p in range(degree)]
        weights = [(EXPM1, 0.0, 0.0)] + [(TAU, float(p), 0.0) for p in range(1, degree + 1)]
        return _leaf(d, weights, [coeffs[0]] * (1 + degree), [eye] + Ns, [eye.bool()] + [full] * degree)
    if family == SPECTRAL:
        weights, matrices, off = [], [], 1
        for a, beta in spectral_blocks(d):
            kinds = (SPEC_EM1,) if beta == 0.0 else (SPEC_EM1, SPEC_ES)
            for kind in kinds:
                weights.append((kind, float(a), float(beta)))
                matrices.append(coeffs[off : off + d * d].reshape(d, d))
                off += d * d
        return _leaf(d, weights, [coeffs[0]] * len(weights), matrices, [full] * len(weights))
    if family != COMPOSITE:
        raise ValueError(f"unknown transition family {family!r}")
    plan = family.plan
    n_w = len(plan.weights)
    return Expansion(
        d, list(plan.weights), list(coeffs[:n_w]), list(plan.monomials),
        [coeffs[n_w + i * d * d : n_w + (i + 1) * d * d].reshape(d, d) for i in range(len(plan.monomials))],
        [torch.tensor(p, device=device).reshape(d, d) for p in plan.patterns],
    )


def rotation_expansion(order: int, w0: Tensor) -> Expansion:
    """Periodic's rotation planes (periodic.py:140-165): harmonic j = 1..N
    adds (cos θ_j − 1) on its block's diagonal and sin θ_j, −sin θ_j below
    and above it, θ_j = j·ω₀·dt; the j = 0 block is exactly zero and has no
    weight."""
    d = 2 * (order + 1)
    weights, matrices = [], []
    for j in range(1, order + 1):
        e = 2 * j
        diag = torch.zeros((d, d), dtype=w0.dtype, device=w0.device)
        diag[e, e] = diag[e + 1, e + 1] = 1.0
        rot = torch.zeros_like(diag)
        rot[e + 1, e], rot[e, e + 1] = 1.0, -1.0
        weights += [(COSM1, float(j), 0.0), (SIN, float(j), 0.0)]
        matrices += [diag, rot]
    return _leaf(d, weights, [w0] * len(weights), matrices, [K != 0 for K in matrices])


def _merge(parts: list, d: int, place) -> Expansion:
    """The children's weights side by side; ``place(i, K)`` puts child i's
    matrix (or pattern) into the composite's d×d."""
    out = Expansion(d, [], [], [], [], [])
    for i, e in enumerate(parts):
        base = len(out.weights)
        out.weights += e.weights
        out.rates += e.rates
        out.monomials += [tuple(base + m for m in mono) for mono in e.monomials]
        out.matrices += [place(i, K) for K in e.matrices]
        out.patterns += [place(i, P) for P in e.patterns]
    return out


def sum_expansion(parts: list) -> Expansion:
    """A Sum's block diagonal (base.py:266-281), before its similarity."""
    dims = [e.d for e in parts]
    d = sum(dims)
    starts = [sum(dims[:i]) for i in range(len(dims))]

    def place(i, K):
        out = K.new_zeros((d, d))
        r = starts[i]
        out[r : r + dims[i], r : r + dims[i]] = K
        return out

    return _merge(parts, d, place)


def product_expansion(a: Expansion, b: Expansion) -> Expansion:
    """The Kronecker fold of two children (base.py:451-464): the monomials
    of a and b with each other (Am1_a ⊗ Am1_b), a's with I (Am1_a ⊗ I) and
    b's (I ⊗ Am1_b)."""
    d = a.d * b.d
    out = _merge([a, b], d, lambda i, K: _kron(K, _eye_like(K, b.d)) if i == 0 else _kron(_eye_like(K, a.d), K))
    na = len(a.weights)
    for ma, Ka, Pa in zip(a.monomials, a.matrices, a.patterns):
        for mb, Kb, Pb in zip(b.monomials, b.matrices, b.patterns):
            out.monomials.append(tuple(ma) + tuple(na + m for m in mb))
            out.matrices.append(_kron(Ka, Kb))
            out.patterns.append(_kron(Pa, Pb))
    return out


def _eye_like(K: Tensor, n: int) -> Tensor:
    return torch.eye(n, dtype=K.dtype, device=K.device)


def _kron(a: Tensor, b: Tensor) -> Tensor:
    """``torch.kron``, also of two patterns (bool)."""
    if a.dtype == torch.bool:
        return torch.kron(a.int(), b.int()).bool()
    return torch.kron(a, b)


def weights(plan: Plan, rates: Tensor, dts: Tensor) -> list:
    """The plan's weights at each step, a (T,) tensor each (the kernels'
    csrc/dt_elements.cuh: composite_weight), differentiable in the rates
    and dts."""
    out = []
    for (kind, p, q), rho in zip(plan.weights, rates):
        if kind == EXPM1:
            out.append(torch.expm1(-rho * dts))
        elif kind == TAU:
            tau = torch.exp(-rho * dts)
            for k in range(1, int(p) + 1):
                tau = tau * dts * (1.0 / k)
            out.append(tau)
        elif kind in (COSM1, SIN):
            theta = (p * rho) * dts
            out.append(-2.0 * torch.sin(0.5 * theta) ** 2 if kind == COSM1 else torch.sin(theta))
        else:
            u = dts * rho
            bu = q * u
            if kind == SPEC_EM1:
                out.append(torch.expm1(-p * u) * torch.cos(bu) - 2.0 * torch.sin(0.5 * bu) ** 2)
            else:
                out.append(torch.exp(-p * u) * torch.sin(bu))
    return out


def composite_transitions_m1(family: CompositeFamily, coeffs: Tensor, dts: Tensor, d: int) -> Tensor:
    """(d, d, T) ``expm(dt·F) − I`` of the composite family, Σ_μ W_μ·K_μ in
    the plan's order; differentiable in ``coeffs`` and ``dts``."""
    plan = family.plan
    if coeffs.dim() != 1:
        raise NotImplementedError("the composite transitions of a batch of kernels are ROADMAP.md B7")
    if plan.d != d or coeffs.shape[0] != plan.n_coeffs:
        raise ValueError(f"composite coefficients of length {coeffs.shape[0]} do not fit the d={d} plan")
    dts = dts.reshape(-1)
    n_w = len(plan.weights)
    w = weights(plan, coeffs[:n_w], dts)
    out = torch.zeros((d, d, dts.shape[0]), dtype=dts.dtype, device=dts.device)
    for i, mono in enumerate(plan.monomials):
        W = w[mono[0]]
        for m in mono[1:]:
            W = W * w[m]
        K = coeffs[n_w + i * d * d : n_w + (i + 1) * d * d].reshape(d, d, 1)
        out = out + K * W
    return out


def kernel_layout(family: CompositeFamily, coeffs: Tensor) -> Tensor:
    """The coefficients as the CUDA kernels read them: the rates padded to
    MAX_WEIGHTS, the matrices to MAX_MONOMIALS, then the plan — each weight's
    (kind, p, q), each monomial's factors (−1 for none) and its pattern as
    MASK_WORDS words of 16 bits — and (n_w, n_mono).  A leading batch axis
    is kept."""
    plan = family.plan
    d2, n_w, n_mono = plan.d * plan.d, len(plan.weights), len(plan.monomials)
    batch = tuple(coeffs.shape[:-1])
    rates = coeffs.new_zeros(batch + (MAX_WEIGHTS,))
    rates[..., :n_w] = coeffs[..., :n_w]
    mats = coeffs.new_zeros(batch + (MAX_MONOMIALS * d2,))
    mats[..., : n_mono * d2] = coeffs[..., n_w:]
    spec = [0.0] * (3 * MAX_WEIGHTS)
    for i, w in enumerate(plan.weights):
        spec[3 * i : 3 * i + 3] = w
    mono = [-1.0] * ((MAX_FACTORS + MASK_WORDS) * MAX_MONOMIALS)
    for i, (factors, pattern) in enumerate(zip(plan.monomials, plan.patterns)):
        row = (MAX_FACTORS + MASK_WORDS) * i
        mono[row : row + len(factors)] = factors
        for k in range(MASK_WORDS):
            mono[row + MAX_FACTORS + k] = float(sum(1 << b for b in range(16) if 16 * k + b < d2 and pattern[16 * k + b]))
    table = torch.tensor(spec + mono + [n_w, n_mono], dtype=coeffs.dtype, device=coeffs.device)
    return torch.cat([rates, mats, table.expand(batch + table.shape)], -1)


def kernel_positions(family: CompositeFamily) -> list:
    """Where each coefficient sits in ``kernel_layout``'s padded part."""
    plan = family.plan
    d2, n_w = plan.d * plan.d, len(plan.weights)
    return list(range(n_w)) + list(range(MAX_WEIGHTS, MAX_WEIGHTS + len(plan.monomials) * d2))


def table_size(d: int) -> int:
    """Values of ``kernel_layout`` at state dimension d."""
    return MAX_WEIGHTS + MAX_MONOMIALS * d * d + 3 * MAX_WEIGHTS + (MAX_FACTORS + MASK_WORDS) * MAX_MONOMIALS + 2

