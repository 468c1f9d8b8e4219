"""PyTorch port vs the JAX package: the time-first fused Kalman path —
``pkf / pks / pkfs`` on an LGSSM with ``engine="strip"`` (kalman/plane.py,
``timelast.pkf_plane`` / ``pks_plane`` / ``pkfs_plane``) — through the plain
plane scan and plane transpose, which the CUDA kernels are held against on
the card, against the JAX plane kernels in interpret mode and the JAX
time-last engine; f64 on the CPU."""
import contextlib
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from parallel_gps_torch import kernels as tk
from parallel_gps_torch import lgssm_from_numpy
from parallel_gps_torch.kalman import kf, pkf, pkfs, pks, plane
from parallel_gps_torch.kalman import timelast as ttl
from parallel_gps_torch.kalman.strip import _pack
from parallel_gps_tpu.kalman.pallas_scan import plane_transpose as jax_plane_transpose
from parallel_gps_tpu.kalman.timelast import FilteringElementTL, SmoothingElementTL, pkf_pallas, pkf_tl, pks_pallas, pks_tl
from parallel_gps_tpu.kalman.timelast import filtering_identity_tl as jax_filtering_identity_tl
from parallel_gps_tpu.kalman.timelast import filtering_operator_tl as jax_filtering_operator_tl
from parallel_gps_tpu.kalman.timelast import kogge_stone_scan_tl as jax_kogge_stone_scan_tl
from parallel_gps_tpu.kalman.timelast import smoothing_identity_tl as jax_smoothing_identity_tl
from parallel_gps_tpu.kalman.timelast import smoothing_operator_tl as jax_smoothing_operator_tl
from parallel_gps_tpu.types import LGSSM as JaxLGSSM

torch.set_num_threads(1)

# tests/test_pallas_scan.py:40-55: filter, log-likelihood, smoother.
FILTER_TOL = dict(rtol=1e-9, atol=1e-10)
LML_RTOL = 1e-10
SMOOTHER_TOL = dict(rtol=1e-8, atol=1e-9)


@contextlib.contextmanager
def _no_compile_cache():
    """Interpret-mode programs segfault in the persistent compilation cache
    (see test_model_interpret.py); disable it around them, and only there:
    the jitted references keep the cache."""
    from jax._src import compilation_cache as _cc

    jax.config.update("jax_enable_compilation_cache", False)
    _cc.reset_cache()
    try:
        yield
    finally:
        jax.config.update("jax_enable_compilation_cache", True)
        _cc.reset_cache()


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _problem(kernel, T, n_nan, seed):
    """A time-first LGSSM of ``kernel`` (a port kernel; its SDE is held
    against the JAX package's in test_torch_sde.py / test_torch_rbf_sde.py) with
    observations (``n_nan`` NaN), as the same numpy arrays in a JAX LGSSM
    and, through ``lgssm_from_numpy``, the port's."""
    rng = np.random.RandomState(seed)
    t = np.sort(rng.rand(T))
    y = np.sin(12.0 * t) + 0.3 * rng.randn(T)
    y[rng.choice(T, n_nan, replace=False)] = np.nan
    with torch.no_grad():
        arrays = [x.numpy() for x in kernel.get_ssm(torch.tensor(t), torch.tensor([[0.1]], dtype=torch.float64))]
    tssm = lgssm_from_numpy(*arrays, time_last=False, dtype=torch.float64, device="cpu")
    return JaxLGSSM(*(jnp.asarray(x) for x in arrays)), jnp.asarray(y).reshape(-1, 1), tssm, torch.tensor(y)


def _kernel(name, *args, **kwargs):
    return getattr(tk, name)(*args, dtype=torch.float64, device="cpu", **kwargs)


def _run_port(tssm, ty):
    """pkf (with the LML), pks on its moments and pkfs, engine="strip"; pkfs
    keeps the filtered moments time-last, pks takes them time-first, and the
    two give the same bits."""
    with torch.no_grad():
        fms, fPs, ell = pkf(tssm, ty, True, engine="strip")
        sms, sPs = pks(tssm, fms, fPs, engine="strip")
        sms2, sPs2 = pkfs(tssm, ty, engine="strip")
    assert torch.equal(sms2, sms) and torch.equal(sPs2, sPs)
    assert set(plane.LAUNCHES.values()) == {0}  # the CPU runs the plain versions
    return fms, fPs, ell, sms, sPs


def _assert_matches(port, ref):
    fms, fPs, ell, sms, sPs = port
    fms_r, fPs_r, ell_r, sms_r, sPs_r = ref
    npt.assert_allclose(_np(fms), _np(fms_r), **FILTER_TOL)
    npt.assert_allclose(_np(fPs), _np(fPs_r), **FILTER_TOL)
    npt.assert_allclose(float(ell), float(ell_r), rtol=LML_RTOL)
    npt.assert_allclose(_np(sms), _np(sms_r), **SMOOTHER_TOL)
    npt.assert_allclose(_np(sPs), _np(sPs_r), **SMOOTHER_TOL)


def test_plane_path_matches_jax_plane_scan_in_interpret_mode():
    """The one interpret-mode case of the family: Matern32 (d = 2), T = 70
    with 7 NaNs at block 32 — three grid steps, the last one ragged — through
    the JAX ``pkf_pallas`` / ``pks_pallas`` (``_carry_scan_kernel``)."""
    ssm, ys, tssm, ty = _problem(_kernel("Matern32", 1.0, 0.5), 70, 7, 4)
    with _no_compile_cache():
        # Under jit: one program each instead of an op-by-op interpretation.
        fms_j, fPs_j, ell_j = jax.jit(partial(pkf_pallas, return_loglikelihood=True, block=32, interpret=True))(ssm, ys)
        sms_j, sPs_j = jax.jit(partial(pks_pallas, block=32, interpret=True))(ssm, fms_j, fPs_j)
    _assert_matches(_run_port(tssm, ty), (fms_j, fPs_j, ell_j, sms_j, sPs_j))


@jax.jit
def _jax_pkfs_tl(ssm, ys):
    fms, fPs, ell = pkf_tl(ssm, ys, True)
    return (fms, fPs, ell) + tuple(pks_tl(ssm, fms, fPs))


@pytest.mark.parametrize(
    "make,T",
    [(lambda: _kernel("Matern52", 0.8, 0.4), 301), (lambda: _kernel("RBF", 1.0, 0.3, order=4, balancing_iter=5), 37)],
    ids=["m52_T301", "rbf4_T37"],
)
def test_plane_path_matches_jax_time_last_engine(make, T):
    """Against the jitted JAX time-last engine, which computes what the
    interpret-mode kernels compute (test_pallas_scan.py holds them to it);
    d = 4 takes the Schur-recursed inverse."""
    ssm, ys, tssm, ty = _problem(make(), T, T // 9, 5)
    _assert_matches(_run_port(tssm, ty), _jax_pkfs_tl(ssm, ys))


def _jax_unpack(X, d, kind):
    """Packed (n, T) rows → the JAX package's time-last element, in the row
    order of ``strip._pack``."""
    T, d2 = X.shape[-1], d * d
    if kind == "filter":
        sizes, shapes, cls = (d2, d, d2, d2, d), ((d, d), (d,), (d, d), (d, d), (d,)), FilteringElementTL
    else:
        sizes, shapes, cls = (d2, d, d2), ((d, d), (d,), (d, d)), SmoothingElementTL
    cuts = np.cumsum(sizes)[:-1].tolist()
    return cls(*(x.reshape(*shape, T) for x, shape in zip(jnp.split(X, cuts), shapes)))


@partial(jax.jit, static_argnums=2)
def _jax_plane_scans(filt, smooth, d):
    """JAX ``kogge_stone_scan_tl`` over packed filtering and smoothing rows,
    forward and reverse, repacked: {(kind, reverse): (n, T)}."""
    T, out = filt.shape[-1], {}
    for kind, X, op, ident in (
        ("filter", filt, jax_filtering_operator_tl, jax_filtering_identity_tl),
        ("smoother", smooth, jax_smoothing_operator_tl, jax_smoothing_identity_tl),
    ):
        for reverse in (False, True):
            scanned = jax_kogge_stone_scan_tl(op, _jax_unpack(X, d, kind), ident(d, X.dtype), reverse)
            out[(kind, reverse)] = jnp.concatenate([x.reshape(-1, T) for x in scanned])
    return out


@pytest.mark.parametrize("T", [1, 2], ids=lambda T: f"T{T}")
def test_plane_scan_plain_at_the_edges(T):
    """``plane_scan_plain``, forward and reverse, of either kind, against the
    JAX package's time-last Kogge–Stone scan of the same packed rows (a scan
    of one element is the element; two take one combine, the earlier element
    on the left); and the plane path against the jitted JAX time-last engine
    there.  Longer series: the cases above (T = 37, 70, 301)."""
    ssm, ys, tssm, ty = _problem(_kernel("Matern52", 0.9, 0.45), T, T // 3, 3)
    ref = _jax_pkfs_tl(ssm, ys)
    with torch.no_grad():
        fms, fPs = (torch.tensor(np.asarray(x)) for x in ref[:2])
        planes = ttl.time_last_planes(tssm)
        elems = {
            "filter": _pack(ttl.make_filtering_elements_tl(tssm, ty, planes), T),
            "smoother": _pack(ttl.make_smoothing_elements_tl(tssm, fms, fPs), T),
        }
        scans = _jax_plane_scans(*(jnp.asarray(_np(x)) for x in elems.values()), 3)
        for (kind, reverse), want in scans.items():
            out = plane.plane_scan_plain(elems[kind], 3, kind, reverse)
            npt.assert_allclose(_np(out), np.asarray(want), **(FILTER_TOL if kind == "filter" else SMOOTHER_TOL))
            if T == 1:
                assert torch.equal(out, elems[kind])
        port = _run_port(tssm, ty)
    _assert_matches(port, ref)


@pytest.mark.parametrize("shape", [(13, 70), (1, 70)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_plane_transpose_plain_equals_the_jax_kernel(shape):
    """Bit for bit the JAX ``plane_transpose`` in interpret mode (block 32:
    three grid steps, a ragged last one)."""
    x = np.random.RandomState(shape[0]).randn(*shape)
    with _no_compile_cache():
        ref = jax_plane_transpose(jnp.asarray(x), block=32, interpret=True)
    got = plane.plane_transpose_plain(torch.tensor(x))
    assert got.is_contiguous() and np.array_equal(_np(got), np.asarray(ref))


def test_time_first_strip_refuses_what_the_plane_scan_cannot_do():
    """m = 2 observation rows and d = 9 raise on a time-first model with
    engine="strip"; a tensor on another device than the CPU goes to the
    kernel wrappers, which refuse it instead of falling back, and no launch
    is counted."""
    def model(d, m, T, rng):
        eye = np.eye(d)
        F, Q = np.broadcast_to(0.9 * eye, (T, d, d)), np.broadcast_to(0.1 * eye, (T, d, d))
        return lgssm_from_numpy(eye, F, Q, rng.randn(m, d), 0.2 * np.eye(m), time_last=False, dtype=torch.float64, device="cpu")

    rng = np.random.RandomState(0)
    m2, ys2 = model(3, 2, 12, rng), torch.tensor(rng.randn(12, 2))
    for call in (pkf, lambda ssm, ys, engine: pks(ssm, *kf(ssm, ys), engine=engine), pkfs):
        with pytest.raises(ValueError, match="scalar observations only"):
            call(m2, ys2, engine="strip")
    big, ys9 = model(9, 1, 4, rng), torch.zeros(4, dtype=torch.float64)
    for call in (pkf, pkfs):
        with pytest.raises(ValueError, match="d <= 8"):
            call(big, ys9, engine="strip")

    _, _, tssm, ty = _problem(_kernel("Matern32", 1.0, 0.5), 20, 2, 1)
    plane.reset_launch_counts()
    meta = type(tssm)(*(x.to("meta") for x in tssm))
    with pytest.raises(ValueError, match="CUDA device"):
        plane.plane_scan(torch.zeros(plane.rows(2, "filter"), 20, device="meta"), 2, "filter")
    with pytest.raises(ValueError, match="CUDA device"):
        plane.plane_scan(torch.zeros(plane.rows(2, "smoother"), 20, device="meta"), 2, "smoother", reverse=True)
    with pytest.raises(ValueError, match="CUDA device"):
        plane.plane_transpose(torch.zeros(4, 20, device="meta"))
    with pytest.raises(ValueError, match="CUDA device"):
        pkfs(meta, ty.to("meta"), engine="strip")
    assert set(plane.LAUNCHES) == {"plane_scan", "plane_transpose"}
    assert set(plane.LAUNCHES.values()) == {0}
