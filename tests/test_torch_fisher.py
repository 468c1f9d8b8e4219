"""PyTorch port vs the JAX package: the LML's Fisher-identity gradients —
the elementwise tail (kalman/timelast.py), the plain version of the
Fisher-tail kernel (kalman/dt.py::dt_fisher_plain) and ``lml_dt``'s
backward — f64 on the CPU, same numpy inputs through both packages."""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import parallel_gps_tpu.kernels as jk
from parallel_gps_torch import kernels as tk
from parallel_gps_torch.kalman import dt as tdt
from parallel_gps_torch.kalman import timelast as ttl
from parallel_gps_torch.types import LGSSMTL
from parallel_gps_tpu.kalman import pallas_dt as jdt
from parallel_gps_tpu.kalman import timelast as jtl
from parallel_gps_tpu.types import LGSSMTL as JaxLGSSMTL

torch.set_num_threads(1)

KERNELS = [("Matern12", 1.2, 0.6), ("Matern32", 1.1, 0.45), ("Matern52", 0.9, 0.5)]
IDS = ["m12", "m32", "m52"]
NOISE = 0.1


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


def _data(T, seed, nan=True):
    rng = np.random.RandomState(seed)
    t = np.sort(rng.rand(T))
    y = np.sin(12.0 * t) + 0.3 * rng.randn(T)
    if nan:
        y[rng.choice(T, T // 9, replace=False)] = np.nan
    return t, y


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return torch.tensor(np.asarray(x))


def _torch_kernel(name, v, ell):
    return getattr(tk, name)(v, ell, dtype=torch.float64, device="cpu")


def _raw(tkern):
    """The port kernel's unconstrained (variance, lengthscale) as numpy."""
    return np.array([tkern.raw_variance.item(), tkern.raw_lengthscales.item()])


def _moments(name, v, ell, t, y):
    """Inputs of the Fisher tail as numpy, for both packages: the dt-engine's
    (coeffs, P0, H, R, dts, y) of a kernel, its planes (Fs, Qs, P0s), and the
    filtered (b, C) and smoothed (g, L) moments of the series."""
    with torch.no_grad():
        k = _torch_kernel(name, v, ell)
        fam, co = k.transition_coeffs()
        sde = k.get_sde()
        dts = tdt._dts_from_ts(torch.tensor(t))
        R = torch.tensor([[NOISE]], dtype=torch.float64)
        planes = tdt.build_planes_tl(fam, co, sde.P0, dts)
        b, C, _ = tdt.strip_filter_dt(fam, co, sde.P0, sde.H, R, dts, torch.tensor(y))
        g, L = tdt.strip_smoother_dt(fam, co, sde.P0, dts, b, C)
    engine = tuple(_np(x) for x in (co, sde.P0, sde.H, R, dts, torch.tensor(y)))
    return engine, tuple(map(_np, planes)), tuple(_np(x.contiguous()) for x in (b, C, g, L))


def test_fisher_grads_from_smoothed_matches_jax():
    """The same planes and moments through both packages' elementwise tail:
    all five plane cotangents and d_y, rtol 1e-9 (atol 1e-12 for entries
    that are zero up to rounding)."""
    t, y = _data(150, 11)
    (_, _, H, R, _, _), (Fs, Qs, P0s), mom = _moments("Matern32", 1.1, 0.45, t, y)
    ssm = (P0s, Fs, Qs, H, R)
    ys = y.reshape(-1, 1)
    ct_j, dy_j = jax.jit(jtl.fisher_grads_from_smoothed)(
        JaxLGSSMTL(*map(jnp.asarray, ssm)), jnp.asarray(ys), *map(jnp.asarray, mom), jnp.asarray(0.7)
    )
    ct_t, dy_t = ttl.fisher_grads_from_smoothed(
        LGSSMTL(*map(_t, ssm)), _t(ys), *map(_t, mom), torch.tensor(0.7, dtype=torch.float64)
    )
    for field in LGSSMTL._fields:
        npt.assert_allclose(_np(getattr(ct_t, field)), _np(getattr(ct_j, field)), rtol=1e-9, atol=1e-12, err_msg=field)
    assert dy_t.shape == (150, 1)
    npt.assert_allclose(_np(dy_t), _np(dy_j), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("name,v,ell", KERNELS, ids=IDS)
def test_lml_tl_gradient_matches_autograd_of_the_filter(name, v, ell):
    """``lml_tl`` (Fisher VJP) vs torch autograd through the scan of
    ``pkf_from_tl(...)[2]``: same forward value, and gradients w.r.t. the
    unconstrained hyperparameters, the noise and the observations to rtol
    1e-7 / atol 1e-10 (the tolerance of the JAX package's gradient tests)."""
    t, y = _data(97, 4)
    ts, ys = torch.tensor(t), torch.tensor(y, requires_grad=True)
    results = []
    for fn in (ttl.lml_tl, lambda ssm, o: ttl.pkf_from_tl(ssm, o, True)[2]):
        k = _torch_kernel(name, v, ell)
        R = torch.tensor([[NOISE]], dtype=torch.float64, requires_grad=True)
        ell_ = fn(k.get_ssm_tl(ts, R), ys)
        grads = torch.autograd.grad(ell_, [k.raw_variance, k.raw_lengthscales, R, ys])
        results.append((float(ell_.detach()), grads))
    (v_f, g_f), (v_a, g_a) = results
    npt.assert_allclose(v_f, v_a, rtol=1e-12)
    for a, ref in zip(g_f, g_a):
        npt.assert_allclose(_np(a), _np(ref), rtol=1e-7, atol=1e-10)


def _dt_fisher_on(engine, mom):
    co, P0, H, R, dts, y = map(_t, engine)
    return tdt.dt_fisher("exppoly", co, P0, H, R, dts, y, *map(_t, mom))


FISHER_OUTPUTS = ("d_coeffs", "d_P0", "d_H", "d_R", "d_dts", "d_y")


def test_dt_fisher_plain_matches_jax_kernel_in_interpret_mode():
    """``dt_fisher_plain`` vs the JAX ``_dt_fisher`` kernel itself, interpret
    mode, block=32, on the same moments, at T = 257 (two grid steps of 8
    strips × 32 lanes, a ragged tail): all six outputs, rtol 1e-8 / atol
    1e-10.  Matern12 only: the d = 2 and 3 kernels cost 20-100 s each in
    interpret mode on the CPU; the next test holds those state dimensions
    against the JAX package's plane tail, which the JAX kernel replaced."""
    t, y = _data(257, 7)
    engine, _, mom = _moments("Matern12", 1.2, 0.6, t, y)
    _, build = jk.Matern12(1.2, 0.6).transition_coeffs()
    co, P0, H, R, dts, ys = map(jnp.asarray, engine)
    with _no_compile_cache():
        out_j = jdt._dt_fisher(build, co, P0, H, R, dts, ys.reshape(-1, 1), *map(jnp.asarray, mom), 32, True)
    for n, a, ref in zip(FISHER_OUTPUTS, _dt_fisher_on(engine, mom), out_j):
        npt.assert_allclose(_np(a), _np(ref).reshape(a.shape), rtol=1e-8, atol=1e-10, err_msg=n)


@pytest.mark.parametrize("name,v,ell", KERNELS[1:], ids=IDS[1:])
def test_dt_fisher_plain_matches_jax_plane_tail(name, v, ell):
    """``dt_fisher_plain`` vs the JAX package's own plain tail
    (pallas_dt.py:1061-1071: build_planes_tl under jax.vjp and
    fisher_grads_from_smoothed) on the same moments, with d_P0 symmetrised
    as the JAX backward does (:1290); rtol 1e-8 / atol 1e-10."""
    t, y = _data(131, 3)
    engine, _, mom = _moments(name, v, ell, t, y)
    _, build = getattr(jk, name)(v, ell).transition_coeffs()

    @jax.jit
    def plane_tail(co, P0, H, R, dts, ys, b, C, g, L):
        (Fs, Qs, P0s), vjp_fn = jax.vjp(lambda c, p, d_: jdt.build_planes_tl(build, c, p, d_), co, P0, dts)
        ct, dy = jtl.fisher_grads_from_smoothed(JaxLGSSMTL(P0s, Fs, Qs, H, R), ys, b, C, g, L, jnp.ones(()))
        d_co, d_p0, d_dt = vjp_fn((ct.Fs, ct.Qs, ct.P0))
        return d_co, 0.5 * (d_p0 + d_p0.T), ct.H, ct.R, d_dt, dy

    out_j = plane_tail(*map(jnp.asarray, engine), *map(jnp.asarray, mom))
    out_t = _dt_fisher_on(engine, mom)
    for n, a, ref in zip(FISHER_OUTPUTS, out_t, out_j):
        npt.assert_allclose(_np(a), _np(ref).reshape(a.shape), rtol=1e-8, atol=1e-10, err_msg=n)
    npt.assert_array_equal(_np(out_t[1]), _np(out_t[1]).T)


def _jax_lml_and_grads(name, u, t, y):
    """value_and_grad of the JAX ``lml_tl`` through ``get_ssm_tl`` w.r.t.
    u = (unconstrained variance, unconstrained lengthscale, noise)."""
    ts, ys = jnp.asarray(t).reshape(-1, 1), jnp.asarray(y).reshape(-1, 1)

    def via_xla(p):
        kern = getattr(jk, name)(variance=jax.nn.softplus(p[0]), lengthscales=jax.nn.softplus(p[1]))
        return jtl.lml_tl(kern.get_ssm_tl(ts, p[2].reshape(1, 1)), ys, False)

    return jax.jit(jax.value_and_grad(via_xla))(jnp.asarray(u))


@pytest.mark.parametrize("name,v,ell", KERNELS, ids=IDS)
def test_lml_dt_value_and_grads_match_jax(name, v, ell):
    """``lml_dt`` and its backward (plain smoother + ``dt_fisher_plain`` on
    the CPU) vs ``jax.value_and_grad`` of the JAX ``lml_tl`` through
    ``get_ssm_tl``, T = 173: value rtol 1e-10, gradients w.r.t. (variance,
    lengthscale, noise) rtol 1e-7 / atol 1e-10 (test_pallas_dt.py:206-207).
    Both sides differentiate w.r.t. the softplus-unconstrained variance and
    lengthscale, which is what the port stores."""
    t, y = _data(173, 5)
    k = _torch_kernel(name, v, ell)
    R = torch.tensor([[NOISE]], dtype=torch.float64, requires_grad=True)
    ell_t = tdt.lml_dt(k, torch.tensor(t), R, torch.tensor(y))
    ell_t.backward()
    v_j, g_j = _jax_lml_and_grads(name, np.append(_raw(k), NOISE), t, y)
    npt.assert_allclose(float(ell_t.detach()), float(v_j), rtol=1e-10)
    g_t = np.array([k.raw_variance.grad.item(), k.raw_lengthscales.grad.item(), R.grad.item()])
    npt.assert_allclose(g_t, np.asarray(g_j), rtol=1e-7, atol=1e-10)


def test_lml_dt_grad_wrt_observations_matches_jax():
    """∂ℓ/∂y vs the JAX ``lml_tl``, rtol 1e-8 / atol 1e-12
    (test_pallas_dt.py:222); missing observations get exactly 0."""
    t, y = _data(157, 9)
    ssm = jk.Matern32(1.0, 0.5).get_ssm_tl(jnp.asarray(t).reshape(-1, 1), jnp.asarray(NOISE).reshape(1, 1))
    g_j = jax.jit(jax.grad(lambda o: jtl.lml_tl(ssm, o, False)))(jnp.asarray(y).reshape(-1, 1))
    obs = torch.tensor(y, requires_grad=True)
    R = torch.tensor([[NOISE]], dtype=torch.float64)
    tdt.lml_dt(_torch_kernel("Matern32", 1.0, 0.5), torch.tensor(t), R, obs).backward()
    npt.assert_allclose(_np(obs.grad), np.asarray(g_j)[:, 0], rtol=1e-8, atol=1e-12)
    assert (obs.grad[torch.isnan(obs.detach())] == 0).all()


def test_backward_scales_by_the_output_cotangent():
    t, y = _data(60, 2)
    grads = []
    for scale in (1.0, -2.5):
        k = _torch_kernel("Matern52", 0.9, 0.5)
        R = torch.tensor([[NOISE]], dtype=torch.float64)
        (scale * tdt.lml_dt(k, torch.tensor(t), R, torch.tensor(y))).backward()
        grads.append(np.array([k.raw_variance.grad.item(), k.raw_lengthscales.grad.item()]))
    npt.assert_allclose(grads[1], -2.5 * grads[0], rtol=1e-13)


@pytest.mark.parametrize("name,v,ell", KERNELS, ids=IDS)
def test_all_nan_series_gives_zero_gradient(name, v, ell):
    t = np.sort(np.random.RandomState(3).rand(40))
    k = _torch_kernel(name, v, ell)
    R = torch.tensor([[NOISE]], dtype=torch.float64, requires_grad=True)
    obs = torch.full((40,), float("nan"), dtype=torch.float64, requires_grad=True)
    ell_t = tdt.lml_dt(k, torch.tensor(t), R, obs)
    ell_t.backward()
    assert float(ell_t.detach()) == 0.0
    for g in (k.raw_variance.grad, k.raw_lengthscales.grad, R.grad):
        npt.assert_allclose(_np(g), 0.0, atol=1e-12)
    assert (obs.grad == 0).all()


@pytest.mark.parametrize("name,v,ell", KERNELS[1:], ids=IDS[1:])
def test_single_step_gradient_matches_jax(name, v, ell):
    """T = 1: no previous step, no smoother gain; rtol 1e-7 / atol 1e-10."""
    t, y = np.array([0.37]), np.array([0.8])
    k = _torch_kernel(name, v, ell)
    R = torch.tensor([[NOISE]], dtype=torch.float64, requires_grad=True)
    ell_t = tdt.lml_dt(k, torch.tensor(t), R, torch.tensor(y))
    ell_t.backward()
    v_j, g_j = _jax_lml_and_grads(name, np.append(_raw(k), NOISE), t, y)
    npt.assert_allclose(float(ell_t.detach()), float(v_j), rtol=1e-12)
    g_t = np.array([k.raw_variance.grad.item(), k.raw_lengthscales.grad.item(), R.grad.item()])
    npt.assert_allclose(g_t, np.asarray(g_j), rtol=1e-7, atol=1e-10)
