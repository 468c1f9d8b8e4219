"""Parallel Kalman filter / smoother via associative scan
(counterpart: parallel_gps_tpu/kalman/parallel.py).

The filtering and smoothing element algebra of Särkkä & García-Fernández,
"Temporal Parallelization of Bayesian Smoothers" (arXiv 1905.13002), in the
reference layout (time first) and as the reference writes it — two solves per
filtering combine, general m-row observations — on the blocked associative
scan of ``ops/scan.py``.  It is the literal oracle; the fast engines are the
time-last one (kalman/timelast.py), the strip kernels (kalman/strip.py) and,
for a time-first model, the plane scan (kalman/plane.py), which ``pkf`` /
``pks`` / ``pkfs`` dispatch to.

Element types:
  filtering: (A, b, C, J, eta);  smoothing: (E, g, L).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from parallel_gps_torch.kalman.strip import MAX_KERNEL_D
from parallel_gps_torch.ops.linalg import mvn_logpdf, solve_small, symmetrize
from parallel_gps_torch.ops.scan import blocked_associative_scan
from parallel_gps_torch.types import LGSSM, LGSSMTL

ENGINES = ("auto", "timelast", "strip", "generic")


class FilteringElement(NamedTuple):
    A: Tensor  # (..., d, d)
    b: Tensor  # (..., d)
    C: Tensor  # (..., d, d)
    J: Tensor  # (..., d, d)
    eta: Tensor  # (..., d)


class SmoothingElement(NamedTuple):
    E: Tensor  # (..., d, d)
    g: Tensor  # (..., d)
    L: Tensor  # (..., d, d)


def _mv(M: Tensor, v: Tensor) -> Tensor:
    return (M @ v[..., None])[..., 0]


def _t(M: Tensor) -> Tensor:
    return M.transpose(-1, -2)


def filtering_identity(d: int, dtype, device=None) -> FilteringElement:
    """Identity of ``filtering_operator``: (A=I, b=0, C=0, J=0, eta=0)."""
    z = lambda *s: torch.zeros(s, dtype=dtype, device=device)  # noqa: E731
    return FilteringElement(torch.eye(d, dtype=dtype, device=device), z(d), z(d, d), z(d, d), z(d))


def smoothing_identity(d: int, dtype, device=None) -> SmoothingElement:
    """Identity of ``smoothing_operator``: (E=I, g=0, L=0)."""
    z = lambda *s: torch.zeros(s, dtype=dtype, device=device)  # noqa: E731
    return SmoothingElement(torch.eye(d, dtype=dtype, device=device), z(d), z(d, d))


def _clean(observations: Tensor, T: int, m: int):
    ys = observations.reshape(T, m)
    mask = ~torch.isnan(ys).any(-1)  # (T,)
    return torch.where(mask[:, None], ys, torch.zeros_like(ys)), mask


def make_filtering_elements(lgssm: LGSSM, observations: Tensor) -> FilteringElement:
    """Per-step filtering elements, all steps at once; a NaN step is the pure
    prediction element and t = 0 updates against (m0 = 0, P0)."""
    P0, Fs, Qs, H, R = lgssm
    T = Fs.shape[0]
    y, mask = _clean(observations, T, H.shape[0])

    HQ = H @ Qs  # (T, m, d)
    S = HQ @ H.T + R  # (T, m, m) innovation covariance
    Kt = solve_small(S, HQ)  # (T, m, d) == S⁻¹ H Q
    HF = H @ Fs  # (T, m, d)

    A_ok = Fs - _t(Kt) @ HF  # (I − Kᵀ H) F
    b_ok = _mv(_t(Kt), y)
    C_ok = Qs - _t(Kt) @ HQ
    eta_ok = _mv(_t(HF), solve_small(S, y[..., None])[..., 0])
    J_ok = _t(HF) @ solve_small(S, HF)

    m3, m2 = mask[:, None, None], mask[:, None]
    zero = torch.zeros((), dtype=P0.dtype, device=P0.device)
    A = torch.where(m3, A_ok, Fs)
    b = torch.where(m2, b_ok, zero)
    C = torch.where(m3, C_ok, Qs)
    eta = torch.where(m2, eta_ok, zero)
    J = torch.where(m3, J_ok, zero)

    # First element: filter step against (m0 = 0, P0).
    S1 = H @ P0 @ H.T + R
    K1t = solve_small(S1, H @ P0)  # (m, d)
    ok0 = mask[0]
    b0 = torch.where(ok0, K1t.T @ y[0], zero)
    C0 = torch.where(ok0, P0 - K1t.T @ S1 @ K1t, P0)

    A, b, C = A.clone(), b.clone(), C.clone()
    A[0] = 0.0
    b[0] = b0
    C[0] = C0
    return FilteringElement(A, b, C, J, eta)


def filtering_operator(elem1: FilteringElement, elem2: FilteringElement) -> FilteringElement:
    """Associative combine of filtering elements (Lemma 8 of arXiv
    1905.13002), batched over leading axes: the reference's two solves."""
    A1, b1, C1, J1, eta1 = elem1
    A2, b2, C2, J2, eta2 = elem2
    eye = torch.eye(A1.shape[-1], dtype=A1.dtype, device=A1.device)

    # U = A2 (I + C1 J2)⁻¹, via the transposed solve.
    U = _t(solve_small(_t(eye + C1 @ J2), _t(A2)))
    A = U @ A1
    b = _mv(U, b1 + _mv(C1, eta2)) + b2
    C = U @ C1 @ _t(A2) + C2

    # V = (I + J2 C1)⁻ᵀ A1, i.e. Vᵀ = A1ᵀ (I + J2 C1)⁻¹.
    V = solve_small(_t(eye + J2 @ C1), A1)
    eta = _mv(_t(V), eta2 - _mv(J2, b1)) + eta1
    J = _t(V) @ J2 @ A1 + J1
    return FilteringElement(A, b, symmetrize(C), symmetrize(J), eta)


def make_smoothing_elements(lgssm: LGSSM, ms: Tensor, Ps: Tensor) -> SmoothingElement:
    """Per-step smoothing elements from filtered moments; the last step is
    (E = 0, g = m_T, L = P_T)."""
    _, Fs, Qs, _, _ = lgssm
    F, Q = Fs[1:], Qs[1:]
    m, P = ms[:-1], Ps[:-1]
    Pp = F @ P @ _t(F) + Q
    FP = F @ P
    E = _t(solve_small(symmetrize(Pp), FP))  # (Pp⁻¹ F P)ᵀ
    g = m - _mv(E @ F, m)
    L = symmetrize(P - E @ Pp @ _t(E))
    return SmoothingElement(
        E=torch.cat([E, torch.zeros_like(Ps[-1:])], 0), g=torch.cat([g, ms[-1:]], 0), L=torch.cat([L, Ps[-1:]], 0)
    )


def smoothing_operator(elem1: SmoothingElement, elem2: SmoothingElement) -> SmoothingElement:
    """Associative combine of smoothing elements; elem1 is the later one."""
    E1, g1, L1 = elem1
    E2, g2, L2 = elem2
    return SmoothingElement(E=E2 @ E1, g=_mv(E2, g1) + g2, L=E2 @ L1 @ _t(E2) + L2)


# --------------------------------------------------------------------------
# Dispatch
# --------------------------------------------------------------------------


def _check_engine(engine: str) -> None:
    if engine == "pallas":
        raise ValueError('engine="pallas" names the JAX package\'s kernels; the port\'s fused engine is engine="strip"')
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}: one of {ENGINES}")


def _tl_strip(lgssm: LGSSMTL, engine: str) -> bool:
    """Resolve ``engine`` for an LGSSMTL input; a request the time-last path
    cannot honour raises instead of silently taking another engine."""
    _check_engine(engine)
    d = lgssm.P0.shape[0]
    if engine == "generic":
        raise ValueError(
            "engine='generic' (the reference-literal oracle) operates on the LGSSM (time-first) layout only;"
            " convert explicitly, e.g. LGSSM(P0, Fs.movedim(-1, 0), Qs.movedim(-1, 0), H, R)"
        )
    if lgssm.H.shape[0] > 1:
        raise ValueError(f"an LGSSMTL takes scalar observations only (H has {lgssm.H.shape[0]} rows); use an LGSSM")
    if engine == "strip" and d > MAX_KERNEL_D:
        raise ValueError(
            f"engine='strip' (fused strip kernels) supports d <= {MAX_KERNEL_D}, got d={d};"
            " use engine='auto' (plain time-last, any d)"
        )
    return engine == "strip"


def _time_first_engine(lgssm: LGSSM, engine: str) -> str:
    """The engine a time-first model goes through: "plane" (the plane scan),
    "timelast" or "generic"; a request no engine can honour raises."""
    _check_engine(engine)
    if lgssm.H.shape[0] > 1:
        # m > 1 observation rows: only the generic engine carries the (m, m)
        # solves; the time-last, strip and plane engines are scalar-observation.
        if engine in ("timelast", "strip"):
            raise ValueError(
                f"engine={engine!r} supports scalar observations only (H has {lgssm.H.shape[0]} rows);"
                " use engine='generic'"
            )
        return "generic"
    d = lgssm.P0.shape[0]
    if engine == "strip":
        if d > MAX_KERNEL_D:
            raise ValueError(
                f"engine='strip' (the fused plane scan) supports d <= {MAX_KERNEL_D}, got d={d};"
                " use engine='auto' (any d)"
            )
        return "plane"
    if engine == "auto":
        # Closed-form inverses cover d ≤ 3; larger states take the generic layout.
        return "timelast" if d <= 3 else "generic"
    return engine


def _as_tl(lgssm: LGSSM) -> LGSSMTL:
    return LGSSMTL(lgssm.P0, lgssm.Fs.movedim(0, -1), lgssm.Qs.movedim(0, -1), lgssm.H, lgssm.R)


def pkf(lgssm, observations: Tensor, return_loglikelihood: bool = False, max_parallel: int = 0, engine: str = "auto"):
    """Parallel Kalman filter; returns (fms (T, d), fPs (T, d, d)) or with
    ``ell``.  Accepts an ``LGSSM`` (time first, the reference layout) or an
    ``LGSSMTL`` (time last).  ``engine``: "auto" (an LGSSMTL: the plain
    time-last engine; an LGSSM: time-last for d ≤ 3, else generic),
    "timelast", "strip" (d ≤ 8, on a CUDA model the hand-written kernels,
    on the CPU their plain versions: an LGSSMTL goes through the two-pass
    strip kernels, an LGSSM through the single-pass plane scan,
    ``timelast.pkf_plane``) or "generic".  ``max_parallel`` is accepted for
    reference-API compatibility and ignored."""
    del max_parallel
    from parallel_gps_torch.kalman.timelast import pkf_from_tl, pkf_plane

    if isinstance(lgssm, LGSSMTL):
        out = pkf_from_tl(lgssm, observations, return_loglikelihood, strip=_tl_strip(lgssm, engine))
    else:
        route = _time_first_engine(lgssm, engine)
        if route == "plane":
            return pkf_plane(lgssm, observations, return_loglikelihood)
        if route == "generic":
            return _pkf_generic(lgssm, observations, return_loglikelihood)
        out = pkf_from_tl(_as_tl(lgssm), observations, return_loglikelihood)
    return (out[0].movedim(-1, 0), out[1].movedim(-1, 0)) + tuple(out[2:])


def _pkf_generic(lgssm: LGSSM, observations: Tensor, return_loglikelihood: bool):
    P0, Fs, Qs, H, R = lgssm
    d = P0.shape[0]
    elems = make_filtering_elements(lgssm, observations)
    final = blocked_associative_scan(filtering_operator, elems, filtering_identity(d, P0.dtype, P0.device))
    fms, fPs = final.b, final.C
    if not return_loglikelihood:
        return fms, fPs

    # Post-hoc vectorised log-likelihood from the previous filtered moments.
    y, mask = _clean(observations, Fs.shape[0], H.shape[0])
    prev_ms = torch.cat([torch.zeros((1, d), dtype=P0.dtype, device=P0.device), fms[:-1]], 0)
    prev_Ps = torch.cat([P0[None], fPs[:-1]], 0)
    mps = _mv(Fs, prev_ms)
    Pps = Fs @ prev_Ps @ _t(Fs) + Qs
    logprobs = mvn_logpdf(y, _mv(H, mps), H @ Pps @ H.T + R)
    return fms, fPs, torch.where(mask, logprobs, torch.zeros_like(logprobs)).sum()


def pks(lgssm, ms: Tensor, Ps: Tensor, max_parallel: int = 0, engine: str = "auto"):
    """Parallel RTS smoother over filtered moments ``ms`` (T, d), ``Ps``
    (T, d, d), for either layout of the model; returns (sms, sPs) time
    first.  ``engine`` as in ``pkf``."""
    del max_parallel
    from parallel_gps_torch.kalman.timelast import pks_from_tl, pks_plane

    if isinstance(lgssm, LGSSMTL):
        strip = _tl_strip(lgssm, engine)
    elif (route := _time_first_engine(lgssm, engine)) == "plane":
        return pks_plane(lgssm, ms, Ps)
    elif route == "timelast":
        lgssm, strip = _as_tl(lgssm), False
    else:
        elems = make_smoothing_elements(lgssm, ms, Ps)
        ident = smoothing_identity(lgssm.P0.shape[0], lgssm.P0.dtype, lgssm.P0.device)
        final = blocked_associative_scan(smoothing_operator, elems, ident, reverse=True)
        return final.g, final.L
    g_tl, L_tl = pks_from_tl(lgssm, ms.movedim(0, -1), Ps.movedim(0, -1), strip=strip)
    return g_tl.movedim(-1, 0), L_tl.movedim(-1, 0)


def pkfs(lgssm, observations: Tensor, max_parallel: int = 0, engine: str = "auto"):
    """Parallel filter + smoother; returns smoothed (sms (T, d), sPs
    (T, d, d)).  On an LGSSMTL, and on an LGSSM with ``engine="strip"``, the
    filtered moments stay time-last between the two scans."""
    from parallel_gps_torch.kalman.timelast import pkfs_from_tl, pkfs_plane

    if isinstance(lgssm, LGSSMTL):
        return pkfs_from_tl(lgssm, observations, strip=_tl_strip(lgssm, engine))
    if _time_first_engine(lgssm, engine) == "plane":
        return pkfs_plane(lgssm, observations)
    fms, fPs = pkf(lgssm, observations, False, engine=engine)
    return pks(lgssm, fms, fPs, engine=engine)
