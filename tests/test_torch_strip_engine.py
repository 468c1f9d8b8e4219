"""PyTorch port vs the JAX package: the plane-streaming strip engine
(kalman/strip.py) — its plain passes, which the CUDA kernels are held against
on the card, against the JAX strip kernels in interpret mode and the JAX
time-last engine — and ``lml_tl(strip=True)``; f64 on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import parallel_gps_tpu.kernels as jk
from parallel_gps_torch import kernels as tk
from parallel_gps_torch import lgssm_from_numpy
from parallel_gps_torch.kalman import strip as tstrip
from parallel_gps_torch.kalman import timelast as ttl
from parallel_gps_tpu.kalman.pallas_scan import strip_filter, strip_smoother
from parallel_gps_tpu.kalman.timelast import lml_tl, pkf_from_tl, pks_from_tl
from _torch_common import _no_compile_cache, _np

torch.set_num_threads(1)


def _model(jkern, T, seed):
    """A JAX LGSSMTL with observations (~11% NaN) and the port's copy of it."""
    rng = np.random.RandomState(seed)
    t = np.sort(rng.rand(T))
    y = np.sin(12.0 * t) + 0.3 * rng.randn(T)
    y[rng.choice(T, T // 9, replace=False)] = np.nan
    ssm = jkern.get_ssm_tl(jnp.asarray(t).reshape(-1, 1), jnp.asarray(0.1).reshape(1, 1))
    tssm = lgssm_from_numpy(*(np.asarray(x) for x in ssm), time_last=True, dtype=torch.float64, device="cpu")
    return ssm, jnp.asarray(y).reshape(-1, 1), tssm, torch.tensor(y)


def _run_port(tssm, ty):
    """The port's strip filter and smoother, and the four plain passes one by
    one with the prefix between them."""
    P0, Fs, Qs, H, R = tssm
    d, T = P0.shape[0], Fs.shape[-1]
    with torch.no_grad():
        b, C, ell = tstrip.strip_filter(Fs, Qs, P0, H, R, ty)
        g, L = tstrip.strip_smoother(Fs, Qs, b, C)
        tot = tstrip.strip_filter_scan_plain(Fs, Qs, P0, H, R, ty)
        assert tot.shape == (tstrip.filt_rows(d), tstrip.n_chunks(T))
        b2, C2, ell2 = tstrip.strip_filter_apply_plain(Fs, Qs, P0, H, R, ty, tstrip.exclusive_chunk_prefixes(tot, d, False))
        tot = tstrip.strip_smoother_scan_plain(Fs, Qs, b, C)
        assert tot.shape == (tstrip.smooth_rows(d), tstrip.n_chunks(T))
        g2, L2 = tstrip.strip_smoother_apply_plain(Fs, Qs, b, C, tstrip.exclusive_chunk_prefixes(tot, d, True))
    for a, ref in ((b2, b), (C2, C), (g2, g), (L2, L)):
        assert torch.equal(a, ref)  # the wrappers on the CPU ARE the plain passes
    assert float(ell2) == float(ell)
    return b, C, ell, g, L


@jax.jit
def _jax_pkfs(ssm, ys):
    b, C, ell = pkf_from_tl(ssm, ys, True)
    return (b, C, ell) + tuple(pks_from_tl(ssm, b, C))


@pytest.mark.parametrize(
    "jkern,T,block,tols",
    # Kernels and tolerances of tests/test_pallas_scan.py (:88-90, :106-107
    # for d ≤ 3; :131-138 for d = 4).  One case runs the JAX strip kernels in
    # interpret mode: Matern32 at block 8, so that T = 97 spans two grid steps
    # of 8 strips × 8 lanes with a ragged tail; the others (block None) hold
    # the port against the jitted JAX time-last engine, which
    # test_pallas_scan.py holds those kernels against.
    [
        (jk.Matern32(1.0, 0.5), 97, 8, (1e-9, 1e-10, 1e-10, 1e-8, 1e-9)),
        (jk.Matern52(0.8, 0.4), 301, None, (1e-9, 1e-10, 1e-10, 1e-8, 1e-9)),
        (jk.RBF(variance=1.0, lengthscales=0.3, order=4, balancing_iter=5), 37, None, (1e-8, 1e-9, 1e-9, 1e-7, 1e-8)),
    ],
    ids=["m32_T97", "m52_T301", "rbf4_T37"],
)
def test_strip_engine_matches_jax_strip_kernels_in_interpret_mode(jkern, T, block, tols):
    """Port's strip filter / smoother (plain passes) vs the JAX strip kernels
    themselves, run as the JAX tests run them on the CPU (interpret mode), or
    vs the JAX time-last engine those kernels are held against."""
    rf, af, rell, rs, as_ = tols
    ssm, ys, tssm, ty = _model(jkern, T, 7)
    if block is None:
        b_s, C_s, ell_s, g_s, L_s = _jax_pkfs(ssm, ys)
    else:
        with _no_compile_cache():
            b_s, C_s, ell_s = strip_filter(ssm.Fs, ssm.Qs, ssm.P0, ssm.H, ssm.R, ys, block=block, interpret=True)
            g_s, L_s = strip_smoother(ssm.Fs, ssm.Qs, b_s, C_s, block=block, interpret=True)
    b, C, ell, g, L = _run_port(tssm, ty)
    npt.assert_allclose(_np(b), _np(b_s), rtol=rf, atol=af)
    npt.assert_allclose(_np(C), _np(C_s), rtol=rf, atol=af)
    npt.assert_allclose(float(ell), float(ell_s), rtol=rell)
    npt.assert_allclose(_np(g), _np(g_s), rtol=rs, atol=as_)
    npt.assert_allclose(_np(L), _np(L_s), rtol=rs, atol=as_)


@pytest.mark.parametrize("order,T", [(6, 150), (8, 70)], ids=["rbf6_T150", "rbf8_T70"])
def test_strip_engine_matches_jax_time_last_engine_at_high_order(order, T):
    """d = 6 and 8 (interpret mode is too slow there): against the JAX
    time-last engine, the reference the JAX strip kernels are held against;
    tolerances of test_pallas_scan.py:131-138."""
    ssm, ys, tssm, ty = _model(jk.RBF(variance=1.0, lengthscales=0.3, order=order, balancing_iter=5), T, 5)
    b_x, C_x, ell_x, g_x, L_x = _jax_pkfs(ssm, ys)
    b, C, ell, g, L = _run_port(tssm, ty)
    npt.assert_allclose(_np(b), _np(b_x), rtol=1e-8, atol=1e-9)
    npt.assert_allclose(_np(C), _np(C_x), rtol=1e-8, atol=1e-9)
    npt.assert_allclose(float(ell), float(ell_x), rtol=1e-9)
    npt.assert_allclose(_np(g), _np(g_x), rtol=1e-7, atol=1e-8)
    npt.assert_allclose(_np(L), _np(L_x), rtol=1e-7, atol=1e-8)


@pytest.mark.parametrize("T", [1, 64, 65], ids=lambda T: f"T{T}")
def test_strip_engine_equals_the_plain_time_last_engine_at_chunk_edges(T):
    """One step, exactly one chunk, and a ragged second chunk of one step."""
    _, _, tssm, ty = _model(jk.Matern52(0.9, 0.45), T, 3)
    b, C, ell, g, L = _run_port(tssm, ty)
    with torch.no_grad():
        b0, C0, ell0 = ttl.pkf_from_tl(tssm, ty, True)
        g0, L0 = ttl.pks_from_tl(tssm, b0, C0)
    for a, ref in ((b, b0), (C, C0), (g, g0), (L, L0)):
        npt.assert_allclose(_np(a), _np(ref), rtol=1e-10, atol=1e-12)
    npt.assert_allclose(float(ell), float(ell0), rtol=1e-12)


def test_lml_tl_strip_value_and_gradient():
    """``lml_tl(strip=True)`` (strip filter forward; strip smoother and the
    Fisher tail backward): the value and the cotangents of every leaf of the
    model against the JAX ``lml_tl``, and the hyperparameter gradient against
    autograd through the plain filter's scan; rtol 1e-7."""
    jkern = jk.RBF(variance=1.1, lengthscales=0.35, order=4, balancing_iter=5)
    ssm, ys, tssm, ty = _model(jkern, 90, 11)
    val_j, grads_j = jax.jit(jax.value_and_grad(lambda s, y: lml_tl(s, y, False), argnums=(0, 1)))(ssm, jnp.nan_to_num(ys))
    leaves = [x.clone().requires_grad_() for x in tssm]
    tyc = torch.nan_to_num(ty).requires_grad_()
    val = ttl.lml_tl(type(tssm)(*leaves), tyc, strip=True)
    val.backward()
    npt.assert_allclose(float(val.detach()), float(val_j), rtol=1e-9)
    for x, ref in zip(leaves + [tyc], list(grads_j[0]) + [grads_j[1].reshape(-1)]):
        npt.assert_allclose(_np(x.grad), _np(ref), rtol=1e-7, atol=1e-9 * float(np.abs(_np(ref)).max()))

    rng = np.random.RandomState(2)
    t = np.sort(rng.rand(60))
    y = np.sin(9.0 * t) + 0.2 * rng.randn(60)
    y[::7] = np.nan
    R = torch.tensor([[0.1]], dtype=torch.float64)
    grads = []
    for through_scan in (False, True):
        k = tk.RBF(1.1, 0.35, order=4, balancing_iter=5, dtype=torch.float64, device="cpu")
        model = k.get_ssm_tl(torch.tensor(t), R)
        ell = ttl.pkf_from_tl(model, torch.tensor(y), True)[2] if through_scan else ttl.lml_tl(model, torch.tensor(y), strip=True)
        ell.backward()
        grads.append([k.raw_variance.grad.item(), k.raw_lengthscales.grad.item(), float(ell.detach())])
    npt.assert_allclose(grads[0], grads[1], rtol=1e-7)


def test_non_cpu_tensors_never_fall_back_to_the_plain_version():
    """A tensor on a device other than the CPU goes to the kernel wrapper,
    which refuses what it cannot launch instead of falling back; no launch
    is counted on the CPU."""
    _, _, tssm, ty = _model(jk.Matern32(1.0, 0.5), 50, 1)
    _run_port(tssm, ty)
    assert set(tstrip.LAUNCHES) == {"strip_filter_scan", "strip_filter_apply", "strip_smoother_scan", "strip_smoother_apply"}
    assert set(tstrip.LAUNCHES.values()) == {0}
    P0, Fs, Qs, H, R = (x.to("meta") for x in tssm)
    b, C = torch.zeros(2, 50, device="meta"), torch.zeros(2, 2, 50, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        tstrip.strip_filter(Fs, Qs, P0, H, R, ty.to("meta"))
    with pytest.raises(ValueError, match="CUDA device"):
        tstrip.strip_smoother(Fs, Qs, b, C)
    with pytest.raises(ValueError, match="CUDA device"):
        tstrip.strip_filter_apply(Fs, Qs, P0, H, R, ty.to("meta"), torch.zeros(16, 1, device="meta"))
    with pytest.raises(ValueError, match="CUDA device"):
        tstrip.strip_smoother_apply(Fs, Qs, b, C, torch.zeros(10, 1, device="meta"))
    with pytest.raises(ValueError, match="CUDA device"):
        ttl.lml_tl(type(tssm)(P0, Fs, Qs, H, R), ty.to("meta"), strip=True)
    assert set(tstrip.LAUNCHES.values()) == {0}
