"""PyTorch port vs the JAX package: the RBF kernel's SDE, its dense covariance
and its balancing under autograd; f64 on the CPU."""
import numpy as np
import numpy.testing as npt
import pytest
import torch

from parallel_gps_torch.kernels import RBF
from _torch_common import jit_o0
from _torch_rbf import ORDERS, _close, _pair

torch.set_num_threads(1)


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
    assert tkern.state_dim == order and tkern.transition_coeffs()[0] == "spectral"
    for a, ref in zip(tkern.get_sde(), jit_o0(lambda k: k.get_sde())(jkern)):
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
    """Above the spectral range (order 8) the kernel builds, takes no
    transition family (its transitions are the Padé exponential,
    test_torch_expm.py) and its SDE is the JAX one's."""
    jkern, tkern = _pair(12)
    assert tkern.transition_coeffs() is None
    want = jit_o0(jkern.get_sde)()
    for got, ref in zip(tkern.get_sde(), want):
        _close(got, ref, rtol=1e-9)
