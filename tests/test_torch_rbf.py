"""PyTorch port vs the JAX package: the RBF kernel's SDE, its spectral
closed-form transitions, the discretised model and the dense covariance; f64
on the CPU."""
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import parallel_gps_tpu.kernels as jk
from parallel_gps_torch.kernels import RBF

torch.set_num_threads(1)

ORDERS = [3, 4, 6, 8]


def _pair(order, variance=1.3, lengthscale=0.37, balancing_iter=5):
    jkern = jk.RBF(variance=variance, lengthscales=lengthscale, order=order, balancing_iter=balancing_iter)
    tkern = RBF(variance, lengthscale, order=order, balancing_iter=balancing_iter, dtype=torch.float64, device="cpu")
    return jkern, tkern


def _close(a, ref, rtol=1e-9):
    """rtol against each entry, with an absolute floor of rtol times the
    tensor's largest entry (the matrices span many orders of magnitude)."""
    ref = np.asarray(ref)
    npt.assert_allclose(a.detach().numpy(), ref, rtol=rtol, atol=rtol * np.abs(ref).max())


def test_rbf_sde_coefficients():
    """The pinned order-3 numbers of tests/test_kernels.py:18-50."""
    Pinf, F, L, H, Q = RBF(1.0, 0.1, order=3, balancing_iter=5, dtype=torch.float64, device="cpu").get_sde()
    F_expected = np.array(
        [
            [0, 14.520676967550859, 0],
            [0, 0, 32.857489440296360],
            [-14.5210953665873, -29.4746060478111, -50.3678777987092],
        ]
    )
    Pinf_expected = np.array(
        [
            [1.04502531824891, 0.0, -0.301281550265743],
            [0.0, 0.681741999944955, 0.0],
            [-0.301281550265743, 0.0, 0.611552410634913],
        ]
    )
    npt.assert_array_almost_equal(F.detach().numpy(), F_expected, decimal=8)
    npt.assert_array_almost_equal(L.detach().numpy(), np.array([[0.0], [0.0], [1.0]]), decimal=8)
    npt.assert_array_almost_equal(H.detach().numpy(), np.array([[1.0, 0.0, 0.0]]), decimal=8)
    npt.assert_array_almost_equal(float(Q.detach()), 52.8553179255264, decimal=8)
    npt.assert_array_almost_equal(Pinf.detach().numpy(), Pinf_expected, decimal=8)


@pytest.mark.parametrize("order", ORDERS)
def test_get_sde_matches_jax(order):
    jkern, tkern = _pair(order)
    assert tkern.state_dim == order and tkern.transition_coeffs() is None
    for a, ref in zip(tkern.get_sde(), jkern.get_sde()):
        _close(a, ref)


@pytest.mark.parametrize("order", ORDERS)
def test_transitions_and_discretised_models_match_jax(order):
    """``transitions_m1_tl`` / ``transitions_m1`` (tiny and large gaps) and
    both layouts of the discretised model."""
    jkern, tkern = _pair(order)
    rng = np.random.RandomState(order)
    dts = np.concatenate([[0.0, 1e-9, 1e-5], rng.rand(40) * 0.2, [1.5]])
    _close(tkern.transitions_m1_tl(torch.tensor(dts)), jkern.transitions_m1_tl(jnp.asarray(dts)))
    _close(tkern.transitions_m1(torch.tensor(dts)), jkern.transitions_m1(jnp.asarray(dts)))
    t = np.sort(rng.rand(50))
    R = torch.tensor([[0.1]], dtype=torch.float64)
    jts, jR = jnp.asarray(t).reshape(-1, 1), jnp.asarray(0.1).reshape(1, 1)
    for a, ref in zip(tkern.get_ssm_tl(torch.tensor(t), R), jkern.get_ssm_tl(jts, jR)):
        _close(a, ref)
    for a, ref in zip(tkern.get_ssm(torch.tensor(t), R), jkern.get_ssm(jts, jR)):
        _close(a, ref)


def test_dense_matches_jax():
    jkern, tkern = _pair(6)
    rng = np.random.RandomState(0)
    X, X2 = rng.rand(7), rng.rand(5)
    npt.assert_allclose(tkern.dense(torch.tensor(X), torch.tensor(X2)).detach().numpy(), np.asarray(jkern.dense(X[:, None], X2[:, None])), rtol=1e-12)


def test_balancing_scale_is_constant_under_autograd():
    """The gradient of a transition entry w.r.t. the lengthscale equals a
    central difference taken with the balancing scale held fixed (as
    ``jax.lax.stop_gradient`` makes it in the JAX kernel)."""
    from parallel_gps_torch.kernels import rbf as trbf

    _, tkern = _pair(4)
    dts = torch.tensor([0.03, 0.2], dtype=torch.float64)
    out = tkern.transitions_m1_tl(dts)
    weights = torch.tensor(np.random.RandomState(1).randn(*out.shape))
    (grad,) = torch.autograd.grad((out * weights).sum(), tkern.raw_lengthscales)

    frozen = trbf.balance_scale(tkern._scaled_F(), tkern._n_iter())
    eps, vals = 1e-6, []
    for sign in (1.0, -1.0):
        k = RBF(1.3, 0.37, order=4, balancing_iter=5, dtype=torch.float64, device="cpu")
        with torch.no_grad():
            k.raw_lengthscales += sign * eps
        orig = trbf.balance_scale
        trbf.balance_scale = lambda F, n: frozen
        try:
            vals.append(float((k.transitions_m1_tl(dts) * weights).sum().detach()))
        finally:
            trbf.balance_scale = orig
    npt.assert_allclose(float(grad), (vals[0] - vals[1]) / (2 * eps), rtol=1e-6)


def test_order_above_the_spectral_range_raises():
    with pytest.raises(NotImplementedError, match="A9"):
        RBF(1.0, 0.5, order=12, dtype=torch.float64, device="cpu")
