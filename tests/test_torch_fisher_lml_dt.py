"""PyTorch port vs the JAX package: ``lml_dt``'s value and its
Fisher-identity backward (plain smoother and ``dt_fisher_plain`` on the CPU)
against the JAX package's gradients; f64 on the CPU, same numpy inputs
through both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import parallel_gps_tpu.kernels as jk
from parallel_gps_torch.kalman import dt as tdt
from parallel_gps_tpu.kalman import timelast as jtl
from _torch_common import _np, jit_o0, port_model
from _torch_fisher import IDS, KERNELS, NOISE, _data, _torch_kernel

torch.set_num_threads(1)


def _raw(tkern):
    """The port kernel's unconstrained (variance, lengthscale) as numpy."""
    return np.array([tkern.raw_variance.item(), tkern.raw_lengthscales.item()])


def _jax_lml_and_grads(name, u, t, y):
    """value_and_grad of the JAX ``lml_tl`` through ``get_ssm_tl`` w.r.t.
    u = (unconstrained variance, unconstrained lengthscale, noise)."""
    ts, ys = jnp.asarray(t).reshape(-1, 1), jnp.asarray(y).reshape(-1, 1)

    def via_xla(p):
        kern = getattr(jk, name)(variance=jax.nn.softplus(p[0]), lengthscales=jax.nn.softplus(p[1]))
        return jtl.lml_tl(kern.get_ssm_tl(ts, p[2].reshape(1, 1)), ys, False)

    return jit_o0(jax.value_and_grad(via_xla))(jnp.asarray(u))


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
    ssm = port_model(_torch_kernel("Matern32", 1.0, 0.5), t, NOISE)[0]
    g_j = jit_o0(jax.grad(lambda o: jtl.lml_tl(ssm, o, False)))(jnp.asarray(y).reshape(-1, 1))
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
