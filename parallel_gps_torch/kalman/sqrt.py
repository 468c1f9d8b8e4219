"""Square-root (Cholesky-factor) parallel Kalman engine: filter, smoother
and LML with Fisher-identity gradients (counterpart:
parallel_gps_tpu/kalman/sqrt.py).

The standard filtering combine subtracts covariance products, which is
where d ≳ 12 float32 runs lose definiteness.  Here the elements carry
triangular factors,

    (A, b, U, Z, eta)   with   C = U Uᵀ,   J = Z Zᵀ,

and the combine rebuilds everything from Cholesky factors of Gram matrices
that are ≥ I by construction,

    Ψ = I + Yᵀ Y,   Φ = I + Y Yᵀ,   Y = Z2ᵀ U1,

and from QR triangularisations (``tria``) whose results are factors of PSD
matrices by construction (Yaghoobi, Corenflos, Hassan and Särkkä, "Parallel
square-root solutions for Bayesian smoothers", arXiv 2207.00426, in this
repo's element convention; the derivation is the JAX module's docstring).
Process-noise factors come from Gauss–Legendre quadrature of the
discretisation's Gramian where the kernel has one noise input
(``gramian_disc_factors``), else from an eigh square root of the assembled
matrices (``psd_sqrt``).

Layout: time first, with any leading batch axes — ``Fs`` (…, T, d, d),
``P0`` (…, d, d), ``H`` (…, m, d), ``R`` (…, m, m), moments (…, T, d) and
factors (…, T, d, d) — so that hyperparameters of shape (C,) run all chains
in one scan (the JAX package's ``jax.vmap`` of the stable LML).  The scans
are ``ops/scan.py::blocked_associative_scan`` over the T axis.

Every function here runs its matmuls, QRs and solves at full float32
precision (``full_precision``): products rounded to TF32's 10-bit mantissa
are fatal to triangular factors, as bf16 products were on the TPU
(sqrt.py:326, 490, 687 of the JAX package).  ``tria`` factors float32
inputs in float64 (its docstring says why).

The engine has no hand-written kernel: its operations are the counterparts
of the JAX module's ``jnp.linalg`` calls (``torch.linalg.qr``,
``cholesky``, ``solve_triangular``, ``eigh``) and ``@``.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch
from torch import Tensor

from parallel_gps_torch.ops.linalg import mvn_logpdf, solve_small
from parallel_gps_torch.ops.scan import blocked_associative_scan
from parallel_gps_torch.types import LGSSM


class SqrtFilteringElement(NamedTuple):
    A: Tensor  # (..., d, d)
    b: Tensor  # (..., d)
    U: Tensor  # (..., d, d)  C = U Uᵀ
    Z: Tensor  # (..., d, d)  J = Z Zᵀ
    eta: Tensor  # (..., d)


class SqrtSmoothingElement(NamedTuple):
    E: Tensor  # (..., d, d)
    g: Tensor  # (..., d)
    N: Tensor  # (..., d, d)  L = N Nᵀ


@contextlib.contextmanager
def full_precision():
    """float32 matmuls at full precision (no TF32) inside, whatever the
    caller has set through ``torch.set_float32_matmul_precision`` or
    ``torch.backends.cuda.matmul.allow_tf32``; the caller's setting is
    restored on exit."""
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved)


def tria(M: Tensor) -> Tensor:
    """Lower-triangular L with L Lᵀ = M Mᵀ for M (..., d, k), k ≥ d, by a QR
    of Mᵀ (the square-root filtering primitive).  A float32 M is factored in
    float64 and L rounded back: the H100's batched float32 QR (cuBLAS's
    geqrfBatched, which ``torch.linalg.qr`` takes for a batch of small
    matrices) lost about two digits on these inputs — the d = 12 f32 LML
    at T = 4,096 was 3.6e-4 from f64 truth with it, 6.2e-7 with the QR in
    float64, and 4.2e-6 for the same float32 inputs on the CPU's LAPACK
    (PERF.md §5)."""
    wide = torch.float64 if M.dtype == torch.float32 else M.dtype
    R = torch.linalg.qr(M.transpose(-1, -2).to(wide), mode="r").R
    return R.transpose(-1, -2).to(M.dtype)


def _bcat(a: Tensor, b: Tensor) -> Tensor:
    """Concatenate along the last axis with the other axes broadcast (the
    blocked scan combines (B, 1, …) prefixes with (B, n, …) elements)."""
    shape = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    return torch.cat([a.expand(shape + a.shape[-1:]), b.expand(shape + b.shape[-1:])], -1)


def psd_sqrt(M: Tensor) -> Tensor:
    """Symmetric square root of a PSD matrix by eigh with the eigenvalues
    clamped at zero: never NaN for singular or roundoff-indefinite inputs
    (Q at tiny steps, undamped Periodic components).  Accurate only to
    ‖M‖·eps absolutely; ``gramian_disc_factors`` builds the noise factors
    entrywise where the kernel allows."""
    w, V = torch.linalg.eigh(0.5 * (M + M.transpose(-1, -2)))
    return (V * torch.sqrt(torch.clamp(w, min=0.0))[..., None, :]) @ V.transpose(-1, -2)


def _mv(M: Tensor, v: Tensor) -> Tensor:
    return (M @ v[..., None])[..., 0]


def _chol_solve(L: Tensor, B: Tensor) -> Tensor:
    """(L Lᵀ)⁻¹ B for lower-triangular L, batched."""
    y = torch.linalg.solve_triangular(L, B, upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)


def _tri_solve_t(L: Tensor, B: Tensor) -> Tensor:
    """B L⁻ᵀ for lower-triangular L, batched: (L⁻¹ Bᵀ)ᵀ."""
    return torch.linalg.solve_triangular(L, B.transpose(-1, -2), upper=False).transpose(-1, -2)


def _eye(d: int, like: Tensor) -> Tensor:
    return torch.eye(d, dtype=like.dtype, device=like.device)


def _observations(observations: Tensor, T: int, m: int):
    """(y (…, T, m) with NaN → 0, mask (…, T)): observations given as (T,),
    (T, m) or (…, T, m); a step with any NaN component is missing."""
    if observations.numel() == T * m:
        ys = observations.reshape(T, m)
    elif observations.shape[-2:] == (T, m):
        ys = observations
    else:
        ys = observations.reshape(observations.shape[:-1] + (T, m))
    mask = ~torch.isnan(ys).any(-1)
    return torch.where(mask[..., None], torch.nan_to_num(ys), torch.zeros_like(ys)), mask


def _first(x: Tensor, first: Tensor, axis: int) -> Tensor:
    """``x`` with its first entry along ``axis`` (the T axis, counted from
    the end) replaced by ``first``, the two broadcast against each other."""
    rest = x.narrow(axis, 1, x.shape[axis] - 1)
    first = first.unsqueeze(axis)
    one = list(rest.shape)
    one[axis] = 1
    shape = list(torch.broadcast_shapes(first.shape, tuple(one)))
    first = first.expand(shape)
    shape[axis] = rest.shape[axis]
    return torch.cat([first, rest.expand(shape)], axis)


def _scan(operator, elems, identity, reverse: bool = False):
    """``blocked_associative_scan`` over the T axis of elements laid out
    (…, T, d, d) / (…, T, d): T moved first for the scan, then back."""
    axes = [x.dim() - i.dim() - 1 for x, i in zip(elems, identity)]
    front = type(elems)(*(x.movedim(a, 0) for x, a in zip(elems, axes)))
    out = blocked_associative_scan(operator, front, identity, reverse=reverse)
    return type(elems)(*(x.movedim(0, a) for x, a in zip(out, axes)))


def gramian_disc_factors(kernel, dts: Tensor, nodes: int = 8) -> Tensor:
    """Square-root discretisation: per-step factors G_k (…, T, d, nodes) with
    G_k G_kᵀ = Q_k = ∫₀^{dt_k} e^{Fs} L q Lᵀ e^{Fᵀs} ds, by Gauss–Legendre
    quadrature of the Gramian's columns,

        G_k[:, i] = √(w_i · dt_k/2 · q) · e^{F s_i} L,   s_i = dt_k (x_i + 1)/2,

    each column to the dtype's relative accuracy from the kernel's
    ``transitions_m1`` (closed form or Padé): U Uᵀ reproduces Q entrywise,
    where an eigh of the assembled Q is accurate only to ‖Q‖·eps (fatal to
    companion-form Q, whose entries span dt¹..dt^{2d−1}).  Requires an L of
    shape (d, 1) and a scalar q: raises ``ValueError`` otherwise.  The nodes
    are host constants, built once a call."""
    sde = kernel.get_sde()
    if sde.L.shape[-1] != 1:
        raise ValueError(f"gramian_disc_factors needs a rank-1 L (d, 1), got {tuple(sde.L.shape)}")
    dtype = sde.F.dtype
    dts = dts.reshape(-1).to(dtype)
    x, w = np.polynomial.legendre.leggauss(nodes)
    Lq = sde.L[..., :, 0] * torch.sqrt(sde.Q[..., 0, 0])[..., None]  # (..., d)
    cols = []
    for i in range(nodes):
        Am1 = kernel.transitions_m1(dts * (0.5 * (x[i] + 1.0)))  # (..., T, d, d)
        col = _mv(Am1, Lq[..., None, :]) + Lq[..., None, :]
        cols.append(col * torch.sqrt(0.5 * w[i] * dts)[:, None])
    return torch.stack(cols, -1)


# ---------------------------------------------------------------------------
# Square-root filter
# ---------------------------------------------------------------------------


def sqrt_filtering_identity(d: int, dtype, device=None) -> SqrtFilteringElement:
    z = torch.zeros((d, d), dtype=dtype, device=device)
    v = torch.zeros((d,), dtype=dtype, device=device)
    return SqrtFilteringElement(torch.eye(d, dtype=dtype, device=device), v, z, z, v)


def sqrt_filtering_operator(elem1: SqrtFilteringElement, elem2: SqrtFilteringElement) -> SqrtFilteringElement:
    """Associative combine in square-root form (module docstring):
    A = A2 (A1 − U1 Ψ⁻¹ Yᵀ Z2ᵀ A1), U = tria([A2 U1 S⁻ᵀ, U2]),
    Z = tria([A1ᵀ Z2 T⁻ᵀ, Z1]), with S = chol(Ψ), T = chol(Φ)."""
    A1, b1, U1, Z1, eta1 = elem1
    A2, b2, U2, Z2, eta2 = elem2
    I = _eye(A1.shape[-1], A1)

    Z2t = Z2.transpose(-1, -2)
    Y = Z2t @ U1
    Yt = Y.transpose(-1, -2)
    S = torch.linalg.cholesky(I + Yt @ Y)  # chol(Ψ), eigenvalues ≥ 1
    Tc = torch.linalg.cholesky(I + Y @ Yt)  # chol(Φ)

    w = _mv(U1.transpose(-1, -2), eta2)
    v = _mv(Z2t, b1)
    r = w - _mv(Yt, v)

    Xa = Z2t @ A1
    A = A2 @ (A1 - U1 @ _chol_solve(S, Yt @ Xa))
    b = _mv(A2, b1 + _mv(U1, _chol_solve(S, r[..., None])[..., 0])) + b2
    U = tria(_bcat(_tri_solve_t(S, A2 @ U1), U2))
    Z = tria(_bcat(torch.linalg.solve_triangular(Tc, Xa, upper=False).transpose(-1, -2), Z1))
    corr = _mv(Z2, _chol_solve(Tc, _mv(Y, r)[..., None])[..., 0])
    eta = _mv(A1.transpose(-1, -2), eta2 - _mv(Z2, v) - corr) + eta1
    return SqrtFilteringElement(A, b, U, Z, eta)


def make_sqrt_filtering_elements(
    lgssm: LGSSM, observations: Tensor, sqQ: Tensor | None = None, sqP0: Tensor | None = None
) -> SqrtFilteringElement:
    """Square-root per-step elements with Joseph-form factors,
    U = tria([(I − KᵀH)√Q, Kᵀ√R]); a missing step keeps (F, 0, √Q, 0, 0).
    ``sqQ``: optional (…, T, d, k) process-noise factors (the quadrature
    factors of ``gramian_disc_factors``), ``sqP0`` likewise for P0; by
    default eigh factors of the assembled matrices."""
    P0, Fs, Qs, H, R = lgssm
    d = P0.shape[-1]
    m = H.shape[-2]
    T = Fs.shape[-3]
    I = _eye(d, P0)
    y, mask = _observations(observations, T, m)

    sqQ = psd_sqrt(Qs) if sqQ is None else sqQ
    sqQ_sq = sqQ if sqQ.shape[-1] == d else tria(sqQ)
    sqR = psd_sqrt(R)
    Ht, Rt, sqRt = H[..., None, :, :], R[..., None, :, :], sqR[..., None, :, :]

    HQ = Ht @ Qs
    S = HQ @ Ht.transpose(-1, -2) + Rt
    Kt = solve_small(S, HQ).transpose(-1, -2)  # (…, T, d, m)
    HF = Ht @ Fs
    IKH = I - Kt @ Ht
    A_ok = IKH @ Fs
    b_ok = _mv(Kt, y)
    U_ok = tria(_bcat(IKH @ sqQ, Kt @ sqRt))
    # J = (HF)ᵀ S⁻¹ (HF): Z's columns (HF)ᵀ chol(S)⁻ᵀ, zero-padded to d.
    Zcols = _tri_solve_t(torch.linalg.cholesky(S), HF.transpose(-1, -2))
    Z_ok = torch.cat([Zcols, Zcols.new_zeros(Zcols.shape[:-1] + (d - m,))], -1)
    eta_ok = _mv(HF.transpose(-1, -2), solve_small(S, y[..., None])[..., 0])

    m3, m2 = mask[..., None, None], mask[..., None]
    A = torch.where(m3, A_ok, Fs)
    b = torch.where(m2, b_ok, torch.zeros_like(b_ok))
    U = torch.where(m3, U_ok, sqQ_sq)
    Z = torch.where(m3, Z_ok, torch.zeros_like(Z_ok))
    eta = torch.where(m2, eta_ok, torch.zeros_like(eta_ok))

    # First element: the update of (m0 = 0, P0) (reference parallel.py:13-43).
    sqP0 = psd_sqrt(P0) if sqP0 is None else sqP0
    sqP0_sq = sqP0 if sqP0.shape[-1] == d else tria(sqP0)
    y0, ok0 = y[..., 0, :], mask[..., 0]
    S1 = H @ P0 @ H.transpose(-1, -2) + R
    K1t = solve_small(S1, H @ P0).transpose(-1, -2)  # (…, d, m)
    b0_ok = _mv(K1t, y0)
    U0_ok = tria(_bcat((I - K1t @ H) @ sqP0, K1t @ sqR))
    F0, Q0 = Fs[..., 0, :, :], Qs[..., 0, :, :]
    S0 = H @ Q0 @ H.transpose(-1, -2) + R
    HF0t = (H @ F0).transpose(-1, -2)
    Z0cols = _tri_solve_t(torch.linalg.cholesky(S0), HF0t)
    Z0_ok = torch.cat([Z0cols, Z0cols.new_zeros(Z0cols.shape[:-1] + (d - m,))], -1)
    eta0_ok = _mv(HF0t, solve_small(S0, y0[..., None])[..., 0])

    o3, o2 = ok0[..., None, None], ok0[..., None]
    A0 = torch.zeros_like(F0)
    b0 = torch.where(o2, b0_ok, torch.zeros_like(b0_ok))
    U0 = torch.where(o3, U0_ok, sqP0_sq)
    Z0 = torch.where(o3, Z0_ok, torch.zeros_like(Z0_ok))
    eta0 = torch.where(o2, eta0_ok, torch.zeros_like(eta0_ok))
    return SqrtFilteringElement(
        _first(A, A0, -3), _first(b, b0, -2), _first(U, U0, -3), _first(Z, Z0, -3), _first(eta, eta0, -2)
    )


def sqrt_pkf(
    lgssm: LGSSM,
    observations: Tensor,
    return_loglikelihood: bool = False,
    sqQ: Tensor | None = None,
    sqP0: Tensor | None = None,
):
    """Square-root parallel Kalman filter: (filtered means (…, T, d), lower
    factors (…, T, d, d) with P = U Uᵀ[, ell (…)]).  Covariances stay PSD by
    construction at any conditioning.  The log-likelihood is post hoc: the
    innovation variance H Pp Hᵀ = ‖H F U_prev‖² + ‖H √Q‖² + R ≥ R."""
    with full_precision():
        P0, Fs, Qs, H, R = lgssm
        d = P0.shape[-1]
        elems = make_sqrt_filtering_elements(lgssm, observations, sqQ, sqP0)
        final = _scan(sqrt_filtering_operator, elems, sqrt_filtering_identity(d, P0.dtype, P0.device))
        fms, fUs = final.b, final.U
        if not return_loglikelihood:
            return fms, fUs

        y, mask = _observations(observations, Fs.shape[-3], H.shape[-2])
        sqP0 = psd_sqrt(P0) if sqP0 is None else tria(sqP0)
        sqQ = psd_sqrt(Qs) if sqQ is None else sqQ
        prev_ms = _first(fms.roll(1, -2), torch.zeros_like(fms[..., 0, :]), -2)
        prev_Us = _first(fUs.roll(1, -3), sqP0, -3)
        Ht = H[..., None, :, :]
        HFU = Ht @ Fs @ prev_Us
        HsQ = Ht @ sqQ
        obs_means = _mv(Ht, _mv(Fs, prev_ms))
        obs_covs = HFU @ HFU.transpose(-1, -2) + HsQ @ HsQ.transpose(-1, -2) + R[..., None, :, :]
        logprobs = mvn_logpdf(y, obs_means, obs_covs)
        ell = torch.where(mask, logprobs, torch.zeros_like(logprobs)).sum(-1)
        return fms, fUs, ell


def kernel_sq_factors(kernel, ts: Tensor, lgssm: LGSSM, nodes: int | None, t0=0.0):
    """(sqQ, sqP0) for a kernel: the quadrature Gramian factors where its SDE
    has one noise input (L of shape (d, 1): every companion-form kernel),
    ``None`` otherwise (a Sum or Product carries a block or full-rank L:
    the elements then take eigh factors of the assembled Q); and the eigh
    factor of P0.  The rank is tested here, explicitly: an error inside
    ``gramian_disc_factors`` is raised, not taken for a rank test (the JAX
    version catches any ``ValueError`` there, sqrt.py:533-536)."""
    nodes = max(8, kernel.state_dim + 2) if nodes is None else nodes
    sqQ = None
    if kernel.get_sde().L.shape[-1] == 1:
        ts = ts.reshape(-1)
        prev = torch.cat([torch.full((1,), float(t0), dtype=ts.dtype, device=ts.device), ts[:-1]])
        sqQ = gramian_disc_factors(kernel, ts - prev, nodes)
    return sqQ, psd_sqrt(lgssm.P0)


def _kernel_model(kernel, ts: Tensor, R, t0):
    """(time-first model, ts (T,)) of a kernel; ``R`` (1, 1), or (C, 1, 1)
    for C chains."""
    ts = ts.reshape(-1)
    R = torch.as_tensor(R, dtype=ts.dtype, device=ts.device)
    R = R.reshape(1, 1) if R.numel() == 1 and R.dim() <= 2 else R.reshape(-1, 1, 1)
    return kernel.get_ssm(ts, R, t0), ts


def sqrt_pkf_kernel(kernel, ts: Tensor, R, observations: Tensor, return_loglikelihood: bool = False, nodes=None, t0=0.0):
    """Square-root filter straight from a kernel: the model discretised as
    usual (for the gains and solves), the noise factors from the quadrature
    Gramian (``kernel_sq_factors``)."""
    with full_precision():
        lgssm, ts = _kernel_model(kernel, ts, R, t0)
        sqQ, sqP0 = kernel_sq_factors(kernel, ts, lgssm, nodes, t0)
        return sqrt_pkf(lgssm, observations, return_loglikelihood, sqQ=sqQ, sqP0=sqP0)


# ---------------------------------------------------------------------------
# Square-root smoother
# ---------------------------------------------------------------------------


def sqrt_smoothing_identity(d: int, dtype, device=None) -> SqrtSmoothingElement:
    z = torch.zeros((d, d), dtype=dtype, device=device)
    return SqrtSmoothingElement(torch.eye(d, dtype=dtype, device=device), torch.zeros((d,), dtype=dtype, device=device), z)


def sqrt_smoothing_operator(elem1: SqrtSmoothingElement, elem2: SqrtSmoothingElement) -> SqrtSmoothingElement:
    """The smoothing combine on factors: L = E2 L1 E2ᵀ + L2 is one QR,
    N = tria([E2 N1, N2])."""
    E1, g1, N1 = elem1
    E2, g2, N2 = elem2
    return SqrtSmoothingElement(E2 @ E1, _mv(E2, g1) + g2, tria(_bcat(E2 @ N1, N2)))


def _pad_factor(sqQ: Tensor, d: int) -> Tensor:
    """A noise factor with at least d columns (zero columns added)."""
    k = sqQ.shape[-1]
    return sqQ if k >= d else torch.cat([sqQ, sqQ.new_zeros(sqQ.shape[:-1] + (d - k,))], -1)


def make_sqrt_smoothing_elements(lgssm: LGSSM, fms: Tensor, fUs: Tensor, sqQ: Tensor | None = None) -> SqrtSmoothingElement:
    """Per-step smoothing elements from factored filtered results, by one
    block triangularisation a step:

        Ψ = tria([[F U, G], [U, 0]]) = [[Ψ11, 0], [Ψ21, Ψ22]],

    Ψ Ψᵀ = [[F P Fᵀ + Q, F P], [P Fᵀ, P]]: Ψ11 factors the predicted
    covariance, the gain is E = Ψ21 Ψ11⁻¹ (a triangular solve) and Ψ22
    factors L = P − E Pp Eᵀ."""
    _, Fs, Qs, *_ = lgssm
    d = Fs.shape[-1]
    sqQ = _pad_factor(psd_sqrt(Qs) if sqQ is None else sqQ, d)
    F, G = Fs[..., 1:, :, :], sqQ[..., 1:, :, :]
    m, U = fms[..., :-1, :], fUs[..., :-1, :, :]
    top = _bcat(F @ U, G)
    bot = _bcat(U, U.new_zeros(U.shape[-3:-1] + (sqQ.shape[-1],)))
    shape = torch.broadcast_shapes(top.shape[:-2], bot.shape[:-2])
    Psi = tria(torch.cat([top.expand(shape + top.shape[-2:]), bot.expand(shape + bot.shape[-2:])], -2))
    P11, P21 = Psi[..., :d, :d], Psi[..., d:, :d]
    N = Psi[..., d:, d : 2 * d]
    # E Ψ11 = Ψ21  ⇔  Ψ11ᵀ Eᵀ = Ψ21ᵀ (an upper-triangular solve).
    E = torch.linalg.solve_triangular(P11.transpose(-1, -2), P21.transpose(-1, -2), upper=True).transpose(-1, -2)
    g = m - _mv(E @ F, m)
    last = lambda x, y: torch.cat([x, y.expand(x.shape[:-3] + (1,) + y.shape[-2:])], -3)  # noqa: E731
    return SqrtSmoothingElement(
        last(E, torch.zeros_like(E[..., :1, :, :])),
        torch.cat([g, fms[..., -1:, :].expand(g.shape[:-2] + (1, d))], -2),
        last(N, fUs[..., -1:, :, :]),
    )


def sqrt_pks(lgssm: LGSSM, fms: Tensor, fUs: Tensor, sqQ: Tensor | None = None):
    """Square-root parallel RTS smoother: (smoothed means (…, T, d), smoothed
    covariance factors (…, T, d, d) with P = N Nᵀ, PSD at any
    conditioning)."""
    with full_precision():
        d = fms.shape[-1]
        elems = make_sqrt_smoothing_elements(lgssm, fms, fUs, sqQ)
        final = _scan(sqrt_smoothing_operator, elems, sqrt_smoothing_identity(d, fms.dtype, fms.device), reverse=True)
        return final.g, final.N


def sqrt_pkfs(
    lgssm: LGSSM,
    observations: Tensor,
    return_loglikelihood: bool = False,
    sqQ: Tensor | None = None,
    sqP0: Tensor | None = None,
):
    """Square-root parallel filter and smoother: smoothed means and
    covariance factors[, LML]."""
    out = sqrt_pkf(lgssm, observations, return_loglikelihood, sqQ, sqP0)
    gms, gNs = sqrt_pks(lgssm, out[0], out[1], sqQ)
    return (gms, gNs, out[2]) if return_loglikelihood else (gms, gNs)


def sqrt_pkfs_kernel(kernel, ts: Tensor, R, observations: Tensor, return_loglikelihood: bool = False, nodes=None, t0=0.0):
    """Square-root filter and smoother straight from a kernel (as
    ``sqrt_pkf_kernel``): the model's ``stable=True`` prediction path."""
    with full_precision():
        lgssm, ts = _kernel_model(kernel, ts, R, t0)
        sqQ, sqP0 = kernel_sq_factors(kernel, ts, lgssm, nodes, t0)
        return sqrt_pkfs(lgssm, observations, return_loglikelihood, sqQ=sqQ, sqP0=sqP0)


# ---------------------------------------------------------------------------
# Fisher-identity LML on the square-root engine
# ---------------------------------------------------------------------------
#
# Autodiff through the scan is a dead end: a QR's VJP divides by R's
# diagonal, and the information factors Z have rank m by construction, so
# every gradient would be NaN.  The gradient uses Fisher's identity, as the
# plane engines do (kalman/timelast.py::fisher_grads_from_smoothed): the
# backward is one square-root smoother pass and per-step formulas whose
# every inversion is a pair of triangular solves against the predicted
# covariance's factor Ψ11 (cond Ψ11 = √cond Pp).  ``sqQ`` and ``sqP0`` get
# no gradient: they factor Qs and P0, whose cotangents carry all of
# dℓ/dθ.


def _smoothed_differences(Psi11: Tensor, gNs: Tensor):
    """(Pp⁻¹ D, Pp⁻¹ D Pp⁻¹) with D = P̂ − Pp = N̂N̂ᵀ − Ψ11Ψ11ᵀ formed first
    and then solved against the factor on both sides, as the plane
    backward does (the JAX version forms W Wᵀ − Pp⁻¹ with W = Pp⁻¹N̂, which
    subtracts two products of Pp⁻¹'s size, sqrt.py:631-632)."""
    D = gNs @ gNs.transpose(-1, -2) - Psi11 @ Psi11.transpose(-1, -2)
    PiD = _chol_solve(Psi11, D)
    return PiD, _chol_solve(Psi11, PiD.transpose(-1, -2)).transpose(-1, -2)


def _sqrt_fisher_bwd(lgssm: LGSSM, observations: Tensor, fms, fUs, sqQ, sqP0, gbar):
    """The LML's cotangents: (LGSSM cotangent, ∂ℓ/∂y), each of its input's
    shape, scaled by ``gbar`` (…)."""
    P0, Fs, Qs, H, R = lgssm
    d = P0.shape[-1]
    T = Fs.shape[-3]
    h, r = H[..., 0, :], R[..., 0, 0]

    gms, gNs = sqrt_pks(lgssm, fms, fUs, sqQ)
    y, mask = _observations(observations, T, 1)
    y = y[..., 0]
    maskf = mask.to(P0.dtype)

    sqQ_ = _pad_factor(psd_sqrt(Qs) if sqQ is None else sqQ, d)
    sqP0_ = psd_sqrt(P0) if sqP0 is None else sqP0
    sqP0_ = sqP0_ if sqP0_.shape[-1] == d else tria(sqP0_)

    # Predicted-covariance factors Ψ11_k = tria([F_k U_{k−1}, G_k]) (U₋₁ =
    # √P0), V_k = F_k U_{k−1}: Pp_k = V Vᵀ + G Gᵀ = Ψ11 Ψ11ᵀ.
    U_prev = _first(fUs.roll(1, -3), sqP0_, -3)
    m_prev = _first(fms.roll(1, -2), torch.zeros_like(fms[..., 0, :]), -2)
    V = Fs @ U_prev
    Psi11 = tria(_bcat(V, sqQ_))

    delta = gms - _mv(Fs, m_prev)  # m̂_k − mp_k
    rk = _chol_solve(Psi11, delta[..., None])[..., 0]  # Pp⁻¹ δ
    PiD, PiDPi = _smoothed_differences(Psi11, gNs)

    # RTS gains E_{k−1} = P_{k−1} F_kᵀ Pp_k⁻¹ = U_prev (Pp⁻¹ V)ᵀ and the
    # pre-initial smoothed mean m̂₋₁ = E₋₁ m̂₀ (mp₀ = 0).
    E_prev = U_prev @ _chol_solve(Psi11, V).transpose(-1, -2)
    mham1 = _mv(E_prev[..., 0, :, :], gms[..., 0, :])
    mh_prev = _first(gms.roll(1, -2), mham1, -2)

    dQ = 0.5 * (PiDPi + rk[..., :, None] * rk[..., None, :])
    dF = rk[..., :, None] * mh_prev[..., None, :] + PiD @ E_prev.transpose(-1, -2)
    F0 = Fs[..., 0, :, :]
    dP0 = F0.transpose(-1, -2) @ dQ[..., 0, :, :] @ F0

    # Observation terms (m = 1; cf. timelast.fisher_grads_from_smoothed).
    resid = y - (gms * h[..., None, :]).sum(-1)
    hN = (gNs.transpose(-1, -2) @ h[..., None, :, None])[..., 0]  # N̂ᵀ h
    HPhat = _mv(gNs, hN)  # P̂ h
    rc = r[..., None]
    dH = ((maskf[..., None] * (resid[..., None] * gms - HPhat)).sum(-2) / rc)[..., None, :]
    Nk = resid * resid + (hN * hN).sum(-1)
    dR = (0.5 * maskf * (Nk / (rc * rc) - 1.0 / rc)).sum(-1)[..., None, None]
    dy = torch.where(mask, -resid / rc, torch.zeros_like(resid))

    g = gbar.to(P0.dtype)
    g2, g3 = g[..., None, None], g[..., None, None, None]
    # Leaves a batch shares (broadcast to it) take the sum of its cotangents.
    ct = LGSSM(
        (g2 * dP0).sum_to_size(P0.shape), (g3 * dF).sum_to_size(Fs.shape), (g3 * dQ).sum_to_size(Qs.shape),
        (g2 * dH).sum_to_size(H.shape), (g2 * dR).sum_to_size(R.shape),
    )
    dy = g[..., None] * dy
    if dy.numel() != observations.numel():
        dy = dy.sum(tuple(range(dy.dim() - 1)))  # series that share their observations: the cotangents add up
    return ct, dy.reshape(observations.shape)


class _SqrtLml(torch.autograd.Function):
    @staticmethod
    def forward(ctx, P0, Fs, Qs, H, R, observations, sqQ, sqP0):
        lgssm = LGSSM(P0, Fs, Qs, H, R)
        fms, fUs, ell = sqrt_pkf(lgssm, observations, True, sqQ, sqP0)
        ctx.factors = (sqQ, sqP0)
        ctx.save_for_backward(P0, Fs, Qs, H, R, observations, fms, fUs)
        return ell

    @staticmethod
    def backward(ctx, gbar):
        P0, Fs, Qs, H, R, observations, fms, fUs = ctx.saved_tensors
        sqQ, sqP0 = ctx.factors
        with full_precision():
            ct, dy = _sqrt_fisher_bwd(LGSSM(P0, Fs, Qs, H, R), observations, fms, fUs, sqQ, sqP0, gbar)
        return (*ct, dy, None, None)


def sqrt_lml(lgssm: LGSSM, observations: Tensor, sqQ: Tensor | None = None, sqP0: Tensor | None = None) -> Tensor:
    """LML through the square-root filter, (…) over the batch axes, with
    Fisher-identity gradients in ``lgssm`` and ``observations`` (section
    comment); ``sqQ`` and ``sqP0`` take none."""
    return _SqrtLml.apply(*lgssm, observations, sqQ, sqP0)


def sqrt_lml_kernel(kernel, ts: Tensor, R, observations: Tensor, nodes=None, t0=0.0) -> Tensor:
    """Differentiable stable LML straight from a kernel: gradients reach the
    hyperparameters through the discretisation's own autograd, while the
    factors are computed without autograd (their cotangents are zero by
    construction, section comment)."""
    with full_precision():
        lgssm, ts = _kernel_model(kernel, ts, R, t0)
        with torch.no_grad():
            sqQ, sqP0 = kernel_sq_factors(kernel, ts, lgssm, nodes, t0)
        return sqrt_lml(lgssm, observations, sqQ, sqP0)
