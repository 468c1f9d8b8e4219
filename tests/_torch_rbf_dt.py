"""Helpers that the test_torch_rbf_dt_*.py files share: an RBF kernel of each
package with the same values, data, the port's dt-engine inputs, and the two
checks each test_torch_rbf_dt_order<k>.py file runs at its order (one JAX
reference program an order and a check, compiled in the file that runs it)."""
import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import torch

import parallel_gps_tpu.kernels as jk
from parallel_gps_torch import kernels as tk
from parallel_gps_torch.kalman import dt as tdt
from parallel_gps_tpu.kalman import timelast as jtl
from _torch_common import _np

NOISE = 0.1


def _kernels(order, variance=1.1, lengthscale=0.35):
    jkern = jk.RBF(variance=variance, lengthscales=lengthscale, order=order, balancing_iter=5)
    tkern = tk.RBF(variance, lengthscale, order=order, balancing_iter=5, dtype=torch.float64, device="cpu")
    return jkern, tkern


def _data(T, seed):
    rng = np.random.RandomState(seed)
    t = np.sort(rng.rand(T))
    y = np.sin(12.0 * t) + 0.3 * rng.randn(T)
    y[rng.choice(T, T // 9, replace=False)] = np.nan
    return t, y


def _jax_model(jkern, t, y):
    ssm = jkern.get_ssm_tl(jnp.asarray(t).reshape(-1, 1), jnp.asarray(NOISE).reshape(1, 1))
    return ssm, jnp.asarray(y).reshape(-1, 1)


def _torch_inputs(tkern, t, y):
    """(family, coeffs, P0, H, R, dts, y) of the port's dt engine, no autograd."""
    with torch.no_grad():
        family, coeffs = tkern.transition_coeffs()
        sde = tkern.get_sde()
    dts = tdt._dts_from_ts(torch.tensor(t))
    R = torch.tensor([[NOISE]], dtype=torch.float64)
    return family, coeffs, sde.P0, sde.H, R, dts, torch.tensor(y)


@jax.jit
def _jax_pkfs(ssm, ys):
    b, C, ell = jtl.pkf_from_tl(ssm, ys, True)
    return (b, C, ell) + tuple(jtl.pks_from_tl(ssm, b, C))


def check_four_passes_and_pkfs_dt(order):
    """The four plain passes composed through the chunk prefixes — filter
    scan and apply, smoother scan and apply, T = 203: three full chunks and
    a ragged one — and ``pkfs_dt`` from the kernel, against JAX
    ``pkf_from_tl`` / ``pks_from_tl`` on the JAX kernel's planes: filter
    1e-9 / 1e-10, LML rtol 1e-9, smoother 1e-8 / 1e-9."""
    jkern, tkern = _kernels(order)
    t, y = _data(203, order)
    b_x, C_x, ell_x, g_x, L_x = _jax_pkfs(*_jax_model(jkern, t, y))
    fam, co, P0, H, R, dts, ty = _torch_inputs(tkern, t, y)
    with torch.no_grad():
        tot = tdt.dt_filter_scan_plain(fam, co, P0, H, R, dts, ty)
        pre = tdt.exclusive_chunk_prefixes(tot, order, reverse=False)
        b, C, ell = tdt.dt_filter_apply_plain(fam, co, P0, H, R, dts, ty, pre)
        b, C = b.contiguous(), C.contiguous()
        tot_s = tdt.dt_smoother_scan_plain(fam, co, P0, dts, b, C)
        pre_s = tdt.exclusive_chunk_prefixes(tot_s, order, reverse=True)
        g, L = tdt.dt_smoother_apply_plain(fam, co, P0, dts, b, C, pre_s)
        g_k, L_k = tdt.pkfs_dt(tkern, torch.tensor(t), R, ty)
    npt.assert_allclose(_np(b), _np(b_x), rtol=1e-9, atol=1e-10)
    npt.assert_allclose(_np(C), _np(C_x), rtol=1e-9, atol=1e-10)
    npt.assert_allclose(float(ell), float(ell_x), rtol=1e-9)
    for a, ref in ((g, g_x), (L, L_x), (g_k, g_x), (L_k, L_x)):
        npt.assert_allclose(_np(a), _np(ref), rtol=1e-8, atol=1e-9)


def _jax_value_and_grads(order, t, y, v, ell):
    """LML and its gradient w.r.t. the constrained (variance, lengthscale,
    noise variance), autodiff through the JAX kernel's ``get_ssm_tl``."""
    ts, ys = jnp.asarray(t).reshape(-1, 1), jnp.asarray(y).reshape(-1, 1)

    def lml(p):
        kern = jk.RBF(variance=p[0], lengthscales=p[1], order=order, balancing_iter=5)
        return jtl.lml_tl(kern.get_ssm_tl(ts, p[2].reshape(1, 1)), ys, False)

    return jax.jit(jax.value_and_grad(lml))(jnp.asarray([v, ell, NOISE]))


def check_lml_dt_value_and_grads(order):
    """``lml_dt`` (the dt engine with the spectral family's coefficients;
    its backward the plain smoother and ``dt_fisher_plain``) and its
    gradients w.r.t. the variance, the lengthscale and the noise variance,
    against JAX autodiff: LML rtol 1e-9, gradients rtol 1e-7, T = 150."""
    v, ell = 1.1, 0.35
    _, tkern = _kernels(order, v, ell)
    t, y = _data(150, 10 + order)
    val_x, grads_x = _jax_value_and_grads(order, t, y, v, ell)
    R = torch.tensor([[NOISE]], dtype=torch.float64, requires_grad=True)
    val = tdt.lml_dt(tkern, torch.tensor(t), R, torch.tensor(y))
    val.backward()
    raws = (tkern.raw_variance, tkern.raw_lengthscales)
    grads = [float(p.grad / torch.sigmoid(p.detach())) for p in raws] + [float(R.grad)]
    npt.assert_allclose(float(val.detach()), float(val_x), rtol=1e-9)
    npt.assert_allclose(grads, np.asarray(grads_x), rtol=1e-7)
