"""PyTorch port vs the JAX package: the LML's Fisher-identity tail — the
elementwise tail (kalman/timelast.py) and the plain version of the
Fisher-tail kernel (kalman/dt.py::dt_fisher_plain) — and ``lml_tl``'s
gradient; f64 on the CPU, same numpy inputs through both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import parallel_gps_tpu.kernels as jk
from parallel_gps_torch.kalman import dt as tdt
from parallel_gps_torch.kalman import timelast as ttl
from parallel_gps_torch.types import LGSSMTL
from parallel_gps_tpu.kalman import pallas_dt as jdt
from parallel_gps_tpu.kalman import timelast as jtl
from parallel_gps_tpu.types import LGSSMTL as JaxLGSSMTL
from _torch_common import _no_compile_cache, _np
from _torch_fisher import IDS, KERNELS, NOISE, _data, _torch_kernel

torch.set_num_threads(1)


def _t(x):
    return torch.tensor(np.asarray(x))


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
