"""Time-last parallel Kalman engine in plain PyTorch
(counterpart: parallel_gps_tpu/kalman/timelast.py, non-Pallas branches).

Scan elements keep every component time-last — A as (d, d, T), b as (d, T)
— so each small-matrix operation of the combine is an elementwise
multiply-add over the time axis: d×d products are unrolled
broadcast-multiply-reduce, and inverses use closed-form adjugates (d ≤ 3)
or a Schur-complement recursion onto them (d > 3).
The scan is Kogge–Stone over the last axis, two-level for T ≥ 8192.

Every function here also takes a model with a batch axis — B independent
series, or B chains over one series — in the JAX package's batched layout:
planes (d, d, B, T), moments (d, B, T), ``P0`` (B, d, d), ``H`` (B, 1, d),
``R`` (B, 1, 1) and observations (B, T), or (T,) when all series share them.
The algebra is elementwise over whatever axes trail the matrix axes, so the
batch rides along; the log-likelihood is then (B,).

This is the plain version the dt-engine kernels are held against
(kalman/dt.py), and what those entry points run on the CPU.

``lml_tl`` is the LML with Fisher-identity gradients: the backward is one
smoother pass plus the elementwise tail ``fisher_grads_from_smoothed``,
instead of a replay of the scan tree.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import Tensor

from parallel_gps_torch.types import LGSSMTL


class FilteringElementTL(NamedTuple):
    A: Tensor  # (d, d, T)
    b: Tensor  # (d, T)
    C: Tensor  # (d, d, T)
    J: Tensor  # (d, d, T)
    eta: Tensor  # (d, T)


class SmoothingElementTL(NamedTuple):
    E: Tensor  # (d, d, T)
    g: Tensor  # (d, T)
    L: Tensor  # (d, d, T)


# --------------------------------------------------------------------------
# Time-last small-matrix algebra: elementwise over the trailing axes.
# --------------------------------------------------------------------------


def _mm(a: Tensor, b: Tensor) -> Tensor:
    """(d,d,...) @ (d,d,...): out[i,j] = Σ_k a[i,k]·b[k,j]."""
    return (a[:, :, None] * b[None, :, :]).sum(1)


def _mv(a: Tensor, v: Tensor) -> Tensor:
    """(d,d,...) @ (d,...) → (d,...)."""
    return (a * v[None]).sum(1)


def _mt(a: Tensor) -> Tensor:
    return a.transpose(0, 1)


def _sym(a: Tensor) -> Tensor:
    return 0.5 * (a + _mt(a))


def _inv(M: Tensor) -> Tensor:
    """Inverse over (d, d, ...) planes, elementwise in every trailing axis:
    closed-form adjugate for d ≤ 3, and for d > 3 the Schur-complement block
    recursion M = [[A, B], [C, D]], S = D − C A⁻¹ B onto those base cases
    (split k = (d+1)/2, as the CUDA kernels' ``inv``).  The engine inverts
    SPD predicted covariances and I + C·J with C, J PSD, whose leading
    blocks are well conditioned."""
    d = M.shape[0]
    if d > 3:
        k = (d + 1) // 2
        A, B = M[:k, :k], M[:k, k:]
        C, D = M[k:, :k], M[k:, k:]
        Ainv = _inv(A)
        CAinv = _mm(C, Ainv)
        AinvB = _mm(Ainv, B)
        Sinv = _inv(D - _mm(CAinv, B))
        AS = _mm(AinvB, Sinv)
        top = torch.cat([Ainv + _mm(AS, CAinv), -AS], 1)
        bot = torch.cat([-_mm(Sinv, CAinv), Sinv], 1)
        return torch.cat([top, bot], 0)
    if d == 1:
        return 1.0 / M
    if d == 2:
        a, b = M[0, 0], M[0, 1]
        c, e = M[1, 0], M[1, 1]
        det = a * e - b * c
        return torch.stack([torch.stack([e, -b]), torch.stack([-c, a])]) / det
    a, b, c = M[0, 0], M[0, 1], M[0, 2]
    e, f, g = M[1, 0], M[1, 1], M[1, 2]
    h, i, j = M[2, 0], M[2, 1], M[2, 2]
    A00 = f * j - g * i
    A01 = c * i - b * j
    A02 = b * g - c * f
    A10 = g * h - e * j
    A11 = a * j - c * h
    A12 = c * e - a * g
    A20 = e * i - f * h
    A21 = b * h - a * i
    A22 = a * f - b * e
    det = a * A00 + b * A10 + c * A20
    adj = torch.stack([torch.stack([A00, A01, A02]), torch.stack([A10, A11, A12]), torch.stack([A20, A21, A22])])
    return adj / det


def _eye_like(d: int, like: Tensor) -> Tensor:
    shape = (d, d) + (1,) * (like.dim() - 2)
    return torch.eye(d, dtype=like.dtype, device=like.device).reshape(shape).expand_as(like)


# --------------------------------------------------------------------------
# Elements and operators
# --------------------------------------------------------------------------


def _clean_observations(observations: Tensor, shape):
    """(y with NaN → 0, mask).  ``shape``: the planes' trailing axes, (T,) or
    (B, T); observations shared by a batch stay (T,) and broadcast."""
    shape = tuple(shape)
    ys = observations.reshape(shape if observations.numel() == math.prod(shape) else shape[-1:])
    mask = ~torch.isnan(ys)
    y = torch.where(mask, ys, torch.zeros_like(ys))
    return y, mask


def _series_leaves(P0: Tensor, H: Tensor, R: Tensor, batched: bool):
    """(P0 (d, d, *batch), h (d, *batch), r (*batch)): the per-series leaves
    with the batch axis moved behind the matrix axes, like the planes'."""
    if not batched:
        return P0, H[0], R[0, 0]
    return P0.permute(1, 2, 0), H[:, 0, :].transpose(0, 1), R[:, 0, 0]


def _filtering_elements_from_planes(
    P0: Tensor, A_std: Tensor, Q: Tensor, H: Tensor, R: Tensor, observations: Tensor
) -> FilteringElementTL:
    """Filtering elements (A, b, C, J, η) from time-last (d, d, T) planes;
    NaN observations give the masked element (A=F, C=Q, b=η=J=0) and t=0
    updates against (m0 = 0, P0)."""
    batched = A_std.dim() == 4
    P0, h, r = _series_leaves(P0, H, R, batched)
    y, mask = _clean_observations(observations, A_std.shape[2:])
    hc = h[..., None]  # (d, *batch, 1)
    rc = r[..., None] if batched else r

    HQ = (hc[:, None] * Q).sum(0)  # (d, *batch, T)
    S = (hc * HQ).sum(0) + rc
    Sinv = 1.0 / S
    K = HQ * Sinv[None]
    HF = (hc[:, None] * A_std).sum(0)

    A_ok = A_std - K[:, None] * HF[None]
    b_ok = K * y[None]
    C_ok = Q - K[:, None] * HQ[None]
    eta_ok = HF * (Sinv * y)[None]
    J_ok = HF[:, None] * HF[None] * Sinv[None, None]

    m2 = mask[None]
    m3 = mask[None, None]
    zero = torch.zeros((), dtype=P0.dtype, device=P0.device)
    A = torch.where(m3, A_ok, A_std)
    b = torch.where(m2, b_ok, zero)
    C = torch.where(m3, C_ok, Q)
    eta = torch.where(m2, eta_ok, zero)
    J = torch.where(m3, J_ok, zero)

    # First element: filter step against (m0 = 0, P0).
    P0h = _mv(P0, h)
    S1 = (h * P0h).sum(0) + r
    K1 = P0h / S1
    ok0, y0, S0 = mask[..., 0], y[..., 0], S[..., 0]
    b0 = torch.where(ok0, K1 * y0, zero)
    C0 = torch.where(ok0, P0 - K1[:, None] * P0h[None], P0)
    HF0 = HF[..., 0]
    eta0 = torch.where(ok0, HF0 * (y0 / S0), zero)
    J0 = torch.where(ok0, HF0[:, None] * HF0[None] / S0, zero)

    A = A.clone()
    A[..., 0] = 0.0
    b = b.clone()
    b[..., 0] = b0
    C = C.clone()
    C[..., 0] = C0
    J = J.clone()
    J[..., 0] = J0
    eta = eta.clone()
    eta[..., 0] = eta0
    return FilteringElementTL(A, b, C, J, eta)


def filtering_operator_tl(e1: FilteringElementTL, e2: FilteringElementTL, sym=_sym) -> FilteringElementTL:
    """Associative filtering combine, elementwise over the trailing axes.
    ``sym`` makes C and J symmetric: the two triangles averaged, or another
    form (``plane.chained_plain_scan`` models the kernels' forms)."""
    A1, b1, C1, J1, eta1 = e1
    A2, b2, C2, J2, eta2 = e2
    eye = _eye_like(A1.shape[0], A1)
    V = _inv(eye + _mm(C1, J2))
    U = _mm(A2, V)
    A = _mm(U, A1)
    b = _mv(U, b1 + _mv(C1, eta2)) + b2
    C = _mm(_mm(U, C1), _mt(A2)) + C2
    # Symmetric C1, J2 ⇒ I + J2 C1 = (I + C1 J2)ᵀ: reuse Vᵀ.
    W = _mm(_mt(A1), _mt(V))
    eta = _mv(W, eta2 - _mv(J2, b1)) + eta1
    J = _mm(_mm(W, J2), A1) + J1
    return FilteringElementTL(A, b, sym(C), sym(J), eta)


def filtering_identity_tl(d: int, dtype, device=None) -> FilteringElementTL:
    z = lambda *s: torch.zeros(s, dtype=dtype, device=device)  # noqa: E731
    return FilteringElementTL(torch.eye(d, dtype=dtype, device=device), z(d), z(d, d), z(d, d), z(d))


def _smoothing_elements_from_planes(A_all: Tensor, Q_all: Tensor, m_all: Tensor, P_all: Tensor) -> SmoothingElementTL:
    """Smoothing elements (E, g, L) from (d, d, T) transition/noise planes
    and the filtered moments; the last step is (E=0, g=m_T, L=P_T)."""
    A = A_all[..., 1:]
    Q = Q_all[..., 1:]
    m = m_all[..., :-1]
    P = P_all[..., :-1]
    Pp = _mm(_mm(A, P), _mt(A)) + Q
    FP = _mm(A, P)
    E = _mt(_mm(_inv(_sym(Pp)), FP))
    g = m - _mv(_mm(E, A), m)
    L = _sym(P - _mm(_mm(E, Pp), _mt(E)))
    return SmoothingElementTL(
        E=torch.cat([E, torch.zeros_like(A_all[..., :1])], -1),
        g=torch.cat([g, m_all[..., -1:]], -1),
        L=torch.cat([L, P_all[..., -1:]], -1),
    )


def smoothing_operator_tl(e1: SmoothingElementTL, e2: SmoothingElementTL) -> SmoothingElementTL:
    E1, g1, L1 = e1
    E2, g2, L2 = e2
    return SmoothingElementTL(E=_mm(E2, E1), g=_mv(E2, g1) + g2, L=_mm(_mm(E2, L1), _mt(E2)) + L2)


def smoothing_identity_tl(d: int, dtype, device=None) -> SmoothingElementTL:
    z = lambda *s: torch.zeros(s, dtype=dtype, device=device)  # noqa: E731
    return SmoothingElementTL(torch.eye(d, dtype=dtype, device=device), z(d), z(d, d))


# --------------------------------------------------------------------------
# Kogge–Stone scan over the last axis
# --------------------------------------------------------------------------

_BLOCKED_SCAN_MIN_T = 8192


def _map(fn, *trees):
    return type(trees[0])(*(fn(*leaves) for leaves in zip(*trees)))


def _bcast_ident(ident: Tensor, x: Tensor) -> Tensor:
    return ident.reshape(ident.shape + (1,) * (x.dim() - ident.dim())).to(x.dtype).expand_as(x)


def kogge_stone_scan_tl(operator, elems, identity, reverse: bool = False):
    """Inclusive associative scan over the LAST axis of every leaf.

    Small T: Kogge–Stone, ceil(log2 T) rounds of roll + identity mask +
    combine.  T ≥ 8192: two-level — Kogge–Stone inside blocks of ~√T, a
    recursive scan of the block totals, and one fold of each block's
    exclusive prefix.  ``identity`` leaves have no T axis.  ``reverse``
    accumulates from the right with the later partial on the LEFT of the
    operator."""
    T = elems[0].shape[-1]
    if T >= _BLOCKED_SCAN_MIN_T:
        return _blocked_scan_tl(operator, elems, identity, reverse)
    return _kogge_stone_flat_tl(operator, elems, identity, reverse)


def _blocked_scan_tl(operator, elems, identity, reverse: bool):
    T = elems[0].shape[-1]
    Lb = 1 << max(1, math.ceil(math.log2(math.sqrt(T))))
    B = -(-T // Lb)
    Tp = B * Lb

    def pad(x, ident):
        if Tp == T:
            return x
        fill = _bcast_ident(ident, x[..., :1]).expand(x.shape[:-1] + (Tp - T,))
        # Forward scans pad at the end, reverse scans at the front.
        return torch.cat([fill, x], -1) if reverse else torch.cat([x, fill], -1)

    blocked = _map(lambda x, i: pad(x, i).reshape(x.shape[:-1] + (B, Lb)), elems, identity)
    local = _kogge_stone_flat_tl(operator, blocked, identity, reverse)
    pick = 0 if reverse else -1
    totals = _map(lambda x: x[..., pick], local)  # (..., B)
    scanned = kogge_stone_scan_tl(operator, totals, identity, reverse)
    prefix = _map(lambda x, i: exclusive_shift(x, i, reverse), scanned, identity)
    combined = operator(_map(lambda p, x: p[..., None].expand_as(x), prefix, local), local)
    out = _map(lambda x: x.reshape(x.shape[:-2] + (Tp,)), combined)
    if Tp != T:
        out = _map(lambda x: x[..., Tp - T :] if reverse else x[..., :T], out)
    return out


def exclusive_shift(x: Tensor, ident: Tensor, reverse: bool) -> Tensor:
    """Inclusive → exclusive scan along the last axis: shift by one step,
    the identity entering at the start (the end, for reverse)."""
    edge = _bcast_ident(ident, x[..., :1])
    if reverse:
        return torch.cat([x[..., 1:], edge], -1)
    return torch.cat([edge, x[..., :-1]], -1)


def _kogge_stone_flat_tl(operator, elems, identity, reverse: bool = False):
    T = elems[0].shape[-1]
    n_rounds = max(1, math.ceil(math.log2(T))) if T > 1 else 0
    idx = torch.arange(T, device=elems[0].device)
    shift = 1
    for _ in range(n_rounds):
        mask = idx < T - shift if reverse else idx >= shift

        def mk(x, ident):
            rolled = torch.roll(x, -shift if reverse else shift, dims=-1)
            return torch.where(mask, rolled, _bcast_ident(ident, x))

        elems = operator(_map(mk, elems, identity), elems)
        shift *= 2
    return elems


# --------------------------------------------------------------------------
# Entry points
# --------------------------------------------------------------------------


def _loglik_from_planes(P0, A, Q, H, R, b_tl, C_tl, observations) -> Tensor:
    """Σ_t log p(y_t | y_<t) from the filtered moments (masked steps add 0);
    one value per series."""
    batched = A.dim() == 4
    P0, h, r = _series_leaves(P0, H, R, batched)
    y, mask = _clean_observations(observations, A.shape[2:])
    hc = h[..., None]
    m_prev = torch.cat([torch.zeros_like(b_tl[..., :1]), b_tl[..., :-1]], -1)
    P_prev = torch.cat([P0[..., None], C_tl[..., :-1]], -1)
    mp = _mv(A, m_prev)
    Pp = _mm(_mm(A, P_prev), _mt(A)) + Q
    mean = (hc * mp).sum(0)
    var = (hc * _mv(Pp, hc.expand(mp.shape))).sum(0) + (r[..., None] if batched else r)
    diff = y - mean
    logprobs = -0.5 * (diff * diff / var + torch.log(var) + math.log(2.0 * math.pi))
    return torch.where(mask, logprobs, torch.zeros_like(logprobs)).sum(-1)


def pkf_from_tl(lgssm_tl, observations: Tensor, return_loglikelihood: bool = False, strip: bool = False):
    """Parallel Kalman filter on a time-last LGSSMTL; returns (b_tl, C_tl)
    or (b_tl, C_tl, ell).  ``strip=True`` takes the strip engine
    (kalman/strip.py: CUDA kernels on the card, d ≤ 8, forward only);
    otherwise the plain Kogge–Stone scan, differentiable, any d.  A model
    with a batch axis (module docstring) takes the single-pass batched
    kernel (kalman/batched.py) for ``strip=True``."""
    P0, Fs_tl, Qs_tl, H, R = lgssm_tl
    if strip:
        if Fs_tl.dim() == 4:
            from parallel_gps_torch.kalman.batched import batched_strip_filter, series_observations

            out = batched_strip_filter(Fs_tl, Qs_tl, P0, H, R, series_observations(observations, Fs_tl.shape[2:]))
        else:
            from parallel_gps_torch.kalman.strip import strip_filter

            out = strip_filter(Fs_tl, Qs_tl, P0, H, R, observations)
        return out if return_loglikelihood else out[:2]
    e = _filtering_elements_from_planes(P0, Fs_tl, Qs_tl, H, R, observations)
    final = kogge_stone_scan_tl(
        filtering_operator_tl, e, filtering_identity_tl(Fs_tl.shape[0], P0.dtype, P0.device)
    )
    b_tl, C_tl = final.b, final.C
    if not return_loglikelihood:
        return b_tl, C_tl
    return b_tl, C_tl, _loglik_from_planes(P0, Fs_tl, Qs_tl, H, R, b_tl, C_tl, observations)


def pks_from_tl(lgssm_tl, b_tl: Tensor, C_tl: Tensor, strip: bool = False):
    """Parallel RTS smoother on time-last moments; returns (g_tl, L_tl).
    ``strip`` as in ``pkf_from_tl``."""
    P0, Fs_tl, Qs_tl, _, _ = lgssm_tl
    if strip:
        if Fs_tl.dim() == 4:
            from parallel_gps_torch.kalman.batched import batched_strip_smoother

            return batched_strip_smoother(Fs_tl, Qs_tl, b_tl, C_tl, None, project=False)
        from parallel_gps_torch.kalman.strip import strip_smoother

        return strip_smoother(Fs_tl, Qs_tl, b_tl, C_tl)
    e = _smoothing_elements_from_planes(Fs_tl, Qs_tl, b_tl, C_tl)
    final = kogge_stone_scan_tl(
        smoothing_operator_tl, e, smoothing_identity_tl(Fs_tl.shape[0], Fs_tl.dtype, Fs_tl.device), reverse=True
    )
    return final.g, final.L


def pkfs_from_tl(lgssm_tl, observations: Tensor, strip: bool = False, time_first_out: bool = True):
    """Filter + smoother on an LGSSMTL; the filtered moments stay time-last
    between the two scans.  Returns (sms (T, d), sPs (T, d, d)) when
    ``time_first_out`` (the reference layout), else the time-last
    (g_tl (d, T), L_tl (d, d, T))."""
    b_tl, C_tl = pkf_from_tl(lgssm_tl, observations, strip=strip)
    g_tl, L_tl = pks_from_tl(lgssm_tl, b_tl, C_tl, strip=strip)
    if not time_first_out:
        return g_tl, L_tl
    return g_tl.movedim(-1, 0), L_tl.movedim(-1, 0)


# --------------------------------------------------------------------------
# Time-first models through the plane scan (counterpart: pkf_pallas,
# pks_pallas, pkfs_pallas and the time-first element helpers of the JAX
# package's timelast.py).  The elements and the log-likelihood are plain
# PyTorch; each scan is one launch of ``plane.plane_scan`` and every layout
# move between (T, ...) and (..., T) one of ``plane.plane_transpose``: Fs and
# Qs in (unless they already lie time-last in memory), the moments out, and
# pks's filtered moments in.
# --------------------------------------------------------------------------


def _to_time_last(x: Tensor) -> Tensor:
    """(T, ...) → (..., T), contiguous.  A time-first view of time-last
    memory (what ``SDEKernel.get_ssm`` returns) needs no move and is taken as
    it is; other strides are made contiguous time-first first."""
    from parallel_gps_torch.kalman.plane import plane_transpose

    T = x.shape[0]
    tl = x.movedim(0, -1)
    if tl.is_contiguous():
        return tl
    return plane_transpose(x.reshape(T, -1).contiguous()).reshape(x.shape[1:] + (T,))


def _to_time_first(x: Tensor) -> Tensor:
    """(..., T) → (T, ...)."""
    from parallel_gps_torch.kalman.plane import plane_transpose

    T = x.shape[-1]
    return plane_transpose(x.reshape(-1, T).contiguous()).reshape((T,) + x.shape[:-1])


def time_last_planes(lgssm) -> tuple[Tensor, Tensor]:
    """(Fs, Qs) of a time-first LGSSM as (d, d, T) planes."""
    return _to_time_last(lgssm.Fs), _to_time_last(lgssm.Qs)


def make_filtering_elements_tl(lgssm, observations: Tensor, planes) -> FilteringElementTL:
    """Time-last filtering elements of a time-first LGSSM whose
    ``time_last_planes`` are ``planes``."""
    return _filtering_elements_from_planes(lgssm.P0, *planes, lgssm.H, lgssm.R, observations)


def _loglik_tl(lgssm, b_tl: Tensor, C_tl: Tensor, observations: Tensor, planes) -> Tensor:
    """Σ_t log p(y_t | y_<t) of a time-first LGSSM (``planes`` as in
    ``make_filtering_elements_tl``) from time-last filtered moments."""
    return _loglik_from_planes(lgssm.P0, *planes, lgssm.H, lgssm.R, b_tl, C_tl, observations)


def make_smoothing_elements_tl(lgssm, ms: Tensor, Ps: Tensor) -> SmoothingElementTL:
    """Time-last smoothing elements of a time-first LGSSM from time-first
    filtered moments ``ms`` (T, d), ``Ps`` (T, d, d)."""
    return _smoothing_elements_from_planes(*time_last_planes(lgssm), _to_time_last(ms), _to_time_last(Ps))


def _plane_scan_moments(elems, kind: str):
    """Pack the elements, scan them in one launch and return the moment rows
    of the result: (b (d, T), C (d, d, T)) or (g, L)."""
    from parallel_gps_torch.kalman.plane import plane_scan
    from parallel_gps_torch.kalman.strip import _pack

    d, T = elems[1].shape
    out = plane_scan(_pack(elems, T), d, kind, reverse=kind == "smoother")
    d2 = d * d
    return out[d2 : d2 + d], out[d2 + d : 2 * d2 + d].reshape(d, d, T)


def pkf_plane(lgssm, observations: Tensor, return_loglikelihood: bool = False):
    """Filter of a time-first LGSSM through the plane scan; returns
    (fms (T, d), fPs (T, d, d)) or with ``ell``."""
    planes = time_last_planes(lgssm)
    b_tl, C_tl = _plane_scan_moments(make_filtering_elements_tl(lgssm, observations, planes), "filter")
    moments = (_to_time_first(b_tl), _to_time_first(C_tl))
    if not return_loglikelihood:
        return moments
    return moments + (_loglik_tl(lgssm, b_tl, C_tl, observations, planes),)


def pks_plane(lgssm, ms: Tensor, Ps: Tensor):
    """Smoother of a time-first LGSSM over filtered moments through the plane
    scan; returns (sms (T, d), sPs (T, d, d))."""
    g_tl, L_tl = _plane_scan_moments(make_smoothing_elements_tl(lgssm, ms, Ps), "smoother")
    return _to_time_first(g_tl), _to_time_first(L_tl)


def pkfs_plane(lgssm, observations: Tensor):
    """Filter + smoother of a time-first LGSSM through the plane scan, the
    filtered moments time-last between the two scans; returns (sms, sPs)."""
    planes = time_last_planes(lgssm)
    b_tl, C_tl = _plane_scan_moments(make_filtering_elements_tl(lgssm, observations, planes), "filter")
    g_tl, L_tl = _plane_scan_moments(_smoothing_elements_from_planes(*planes, b_tl, C_tl), "smoother")
    return _to_time_first(g_tl), _to_time_first(L_tl)


# --------------------------------------------------------------------------
# LML with Fisher-identity gradients
#
# ∇θ log p(y) = E_{x|y}[∇θ log p(x, y)]: the gradient of the LML w.r.t.
# every leaf of the model is a closed-form function of the smoothed moments,
# so the backward costs one smoother pass.
#
# CONTRACT: the forward value is the filter's likelihood for any input, but
# the gradient is exact only for stationarity-consistent models — those with
# Q_k = P0 − F_k P0 F_kᵀ, which ops/disc.py::discretize_tl and
# kalman/dt.py::build_planes_tl guarantee by construction.  Off that manifold
# the first-step term differs (the engines update step 0 against P0 directly
# rather than F_0 P0 F_0ᵀ + Q_0).  Hyperparameter gradients are exact,
# because discretization maps parameter perturbations onto the manifold's
# tangent.
# --------------------------------------------------------------------------


def _smoother_gains_tl(Fs_tl: Tensor, Qs_tl: Tensor, b_tl: Tensor, C_tl: Tensor) -> Tensor:
    """RTS gains E_k = (Pp_{k+1}⁻¹ F_{k+1} P_k)ᵀ for k = 0..T−2, (d, d, T−1):
    Cov(x_{k+1}, x_k | y) = P̂_{k+1} E_kᵀ."""
    A = Fs_tl[..., 1:]
    Q = Qs_tl[..., 1:]
    P = C_tl[..., :-1]
    Pp = _sym(_mm(_mm(A, P), _mt(A)) + Q)
    return _mt(_mm(_inv(Pp), _mm(A, P)))


def fisher_grads_from_smoothed(lgssm_tl: LGSSMTL, observations: Tensor, b_tl, C_tl, mhat, Phat, gbar):
    """Fisher-identity LML cotangents from filtered (b, C) and smoothed
    (m̂, P̂) time-last moments: the elementwise tail of the backward (every
    formula is elementwise over T apart from one-step shifts).  Returns
    (LGSSMTL cotangent, ∂ℓ/∂y), both scaled by ``gbar``.  With a batch axis
    (module docstring) ``gbar`` is (B,), the cotangent's leaves have the
    model's shapes, and ∂ℓ/∂y is (B, T): per series, also where the series
    share their observations."""
    batched = lgssm_tl.Fs.dim() == 4
    _, Fs, Qs, H, R = lgssm_tl
    P0, h, r = _series_leaves(lgssm_tl.P0, H, R, batched)
    y, mask = _clean_observations(observations, Fs.shape[2:])
    maskf = mask.to(P0.dtype)
    hc = h[..., None]
    rc = r[..., None] if batched else r

    # RTS gains E_{k−1} (pair (k−1, k), aligned with transition k;
    # pre-initial gain E₋₁ from P0).
    E = _smoother_gains_tl(Fs, Qs, b_tl, C_tl)
    F0 = Fs[..., 0]
    Q0 = Qs[..., 0]
    FP0 = _mm(F0, P0)
    Pp0 = _mm(FP0, _mt(F0)) + Q0
    Em1 = _mt(_mm(_inv(_sym(Pp0)), FP0))  # P0 F0ᵀ Pp0⁻¹
    E_prev = torch.cat([Em1[..., None], E], -1)
    mham1 = _mv(Em1, mhat[..., 0])  # m̂₋₁ (mp₀ = 0)
    mh_prev = torch.cat([mham1[..., None], mhat[..., :-1]], -1)

    # Predicted moments mp_k = F_k m_{k−1}, Pp_k = F_k P_{k−1} F_kᵀ + Q_k.
    m_prev = torch.cat([torch.zeros_like(b_tl[..., :1]), b_tl[..., :-1]], -1)
    P_prev = torch.cat([P0[..., None], C_tl[..., :-1]], -1)
    mp = _mv(Fs, m_prev)
    Pp = _sym(_mm(_mm(Fs, P_prev), _mt(Fs)) + Qs)

    # Cancellation-free Fisher gradients.  The naive forms
    # ∇Q = ½(Q⁻¹MQ⁻¹ − Q⁻¹), ∇F = Q⁻¹(U − FS') are catastrophically
    # ill-conditioned at small dt (Q = O(dt·…) nearly singular while the
    # gradient is O(1)); do not revert to them.  Substituting the RTS
    # identities
    #   I − F_k E_{k−1} = Q_k Pp_k⁻¹,  ŵ_k = Q_k Pp_k⁻¹ δ_k,
    #   Cov(w_k, x_{k−1}|y) = Q_k Pp_k⁻¹ D_k E_{k−1}ᵀ,
    #   Cov(w_k|y) − Q_k = Q_k Pp_k⁻¹ D_k Pp_k⁻¹ Q_k,
    # with δ_k = m̂_k − mp_k and D_k = P̂_k − Pp_k, every Q⁻¹ cancels:
    #   ∇Q_k = ½ (Pp⁻¹ D Pp⁻¹ + r rᵀ),   r_k = Pp_k⁻¹ δ_k
    #   ∇F_k = r_k m̂_{k−1}ᵀ + Pp⁻¹ D E_{k−1}ᵀ
    #   ∇P0  = F₀ᵀ (∇Q)₀ F₀
    # — only the well-conditioned predicted covariance is ever inverted.
    Ppinv = _inv(Pp)
    delta = mhat - mp
    Dk = Phat - Pp
    rk = _mv(Ppinv, delta)
    PiD = _mm(Ppinv, Dk)
    dQ = 0.5 * (_mm(PiD, Ppinv) + rk[:, None] * rk[None])
    dF = rk[:, None] * mh_prev[None] + _mm(PiD, _mt(E_prev))
    dP0 = _mm(_mm(_mt(F0), dQ[..., 0]), F0)

    # Observation terms (observed steps only); R is (1, 1).
    Hm = (hc * mhat).sum(0)
    resid = y - Hm
    HPhat = (hc[:, None] * Phat).sum(0)  # (d, *batch, T): (H P̂)_j
    # ∇H = R⁻¹ Σ [(y − Hm̂) m̂ᵀ − H P̂]
    dH = (maskf[None] * (resid[None] * mhat - HPhat)).sum(-1) / r
    # ∇R = ½ Σ [R⁻¹ N R⁻¹ − R⁻¹],  N = resid² + H P̂ Hᵀ
    HPH = (hc * HPhat).sum(0)
    Nk = resid * resid + HPH
    dR = (0.5 * maskf * (Nk / (rc * rc) - 1.0 / rc)).sum(-1)
    # ∇y_k = −R⁻¹ (y_k − H m̂_k) at observed steps
    dy = torch.where(mask, -resid / rc, torch.zeros_like(resid))

    g = gbar.to(P0.dtype)
    if batched:
        gt = g[:, None]
        ct = LGSSMTL(
            g[:, None, None] * dP0.permute(2, 0, 1), gt * dF, gt * dQ, (g * dH).transpose(0, 1)[:, None, :],
            (g * dR)[:, None, None],
        )
        return ct, gt * dy
    return LGSSMTL(g * dP0, g * dF, g * dQ, g * dH[None, :], g * dR.reshape(1, 1)), g * dy.reshape(observations.shape)


class _LmlTL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, strip, P0, Fs, Qs, H, R, observations):
        b_tl, C_tl, ell = pkf_from_tl(LGSSMTL(P0, Fs, Qs, H, R), observations, True, strip=strip)
        ctx.strip = strip
        ctx.save_for_backward(P0, Fs, Qs, H, R, observations, b_tl, C_tl)
        return ell

    @staticmethod
    def backward(ctx, gbar):
        P0, Fs, Qs, H, R, observations, b_tl, C_tl = ctx.saved_tensors
        ssm = LGSSMTL(P0, Fs, Qs, H, R)
        mhat, Phat = pks_from_tl(ssm, b_tl, C_tl, strip=ctx.strip)
        ct, dy = fisher_grads_from_smoothed(ssm, observations, b_tl, C_tl, mhat, Phat, gbar)
        if dy.numel() != observations.numel():
            dy = dy.sum(0)  # series that share their observations: the cotangents add up
        return (None, *ct, dy.reshape(observations.shape))


def lml_tl(lgssm_tl: LGSSMTL, observations: Tensor, strip: bool = False) -> Tensor:
    """Log marginal likelihood of an LGSSMTL with Fisher-identity gradients
    (see the section comment).  ``strip`` selects the strip engine for the
    forward filter and the backward's smoother (kalman/strip.py); the
    elementwise Fisher tail is plain PyTorch either way."""
    return _LmlTL.apply(strip, *lgssm_tl, observations)
