"""PyTorch port vs the JAX package: RBF above order 8 (no closed form: the
Padé transitions) on the plain time-last engine — an RBF(order=12) model's
LML, gradient and predict_f, a Sum with an RBF(order=10) child, and chains;
f64 on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import torch

import parallel_gps_tpu.kernels as jk
from parallel_gps_tpu.kernels.base import Sum as JSum
from parallel_gps_torch import StateSpaceGP
from parallel_gps_torch.kernels import RBF, Matern32
from parallel_gps_torch.kernels.base import Sum
from parallel_gps_tpu.models import StateSpaceGP as JaxStateSpaceGP
from _torch_common import jit_o0
from _torch_model import _data

torch.set_num_threads(1)
F64 = dict(dtype=torch.float64, device="cpu")
NAMES = ("kernel.raw_variance", "kernel.raw_lengthscales", "raw_noise_variance")


def _constrained_grads(model):
    """dℓ/d(variance, lengthscale, noise) of a port model's LML (its
    parameters are softplus⁻¹ of those: dℓ/du = dℓ/dx · sigmoid(u))."""
    model.zero_grad()
    lml = model.log_marginal_likelihood()
    lml.backward()
    params = dict(model.named_parameters())
    return float(lml.detach()), np.array([float(params[n].grad / torch.sigmoid(params[n].detach())) for n in NAMES])


def test_rbf12_model_matches_jax():
    """LML 1e-10, gradient 1e-7, predict_f 1e-8 against the JAX model on
    its sequential engine (the same Padé discretisation; its scan compiles
    in a fraction of the time-last engine's time).  The port's model takes
    the plain time-last engine (no closed form, d > 8), as the JAX parallel
    model does.  Two balancing sweeps: the traced loop is most of the
    reference's compile."""
    t, y = _data(160, 0)
    xq = np.random.RandomState(1).rand(25)
    p0 = np.array([1.1, 0.3, 0.1])

    def jax_model(p):
        return JaxStateSpaceGP.create((t, y), jk.RBF(p[0], p[1], order=12, balancing_iter=2), p[2], parallel=False)

    @jit_o0
    def ref(p, X):
        lml, grad = jax.value_and_grad(lambda q: jax_model(q).log_marginal_likelihood())(p)
        return lml, grad, jax_model(p)._predict_f_impl(X)

    jl, jg, (jm, jv) = ref(jnp.asarray(p0), jnp.asarray(xq).reshape(-1, 1))
    m = StateSpaceGP.from_numpy(t, y, "RBF", *p0, order=12, balancing_iter=2, **F64)
    assert m.engine() == ("timelast", None)
    lml, grad = _constrained_grads(m)
    npt.assert_allclose(lml, float(jl), rtol=1e-10)
    npt.assert_allclose(grad, np.asarray(jg), rtol=1e-7)
    mean, var = m.predict_f(xq)
    npt.assert_allclose(mean.numpy(), np.asarray(jm), rtol=1e-8, atol=1e-8 * np.abs(jm).max())
    npt.assert_allclose(var.numpy(), np.asarray(jv), rtol=1e-8, atol=1e-8 * np.abs(jv).max())


def test_sum_with_an_rbf10_child():
    """Matern32 + RBF(order=10), d = 12: the Sum's transitions fold the
    Matérn closed form and the RBF child's Padé exponential; the model's LML
    (the plain time-last engine) equals the JAX Sum's model's (its
    sequential engine).  One balancing sweep each: the traced loop is most
    of the reference's compile."""
    t, y = _data(120, 2)
    kern = Sum(Matern32(0.7, 0.5, **F64), RBF(1.2, 0.25, order=10, balancing_iter=1, **F64), balancing_iter=1)
    assert kern.transition_coeffs() is None and kern.state_dim == 12
    jkern = JSum(kernels=(jk.Matern32(0.7, 0.5), jk.RBF(1.2, 0.25, order=10, balancing_iter=1)), balancing_iter=1)
    jl = jit_o0(lambda: JaxStateSpaceGP.create((t, y), jkern, 0.2, parallel=False).log_marginal_likelihood())()
    m = StateSpaceGP.create((t, y), kern, 0.2, **F64)
    assert m.engine() == ("timelast", None)
    npt.assert_allclose(float(m.log_marginal_likelihood().detach()), float(jl), rtol=1e-10)


def test_rbf12_chains():
    """Hyperparameters of shape (C,) = 3 (one Padé exponential of the three
    chains' F): each chain's LML, gradient and predict_f equal its own
    model's."""
    t, y = _data(120, 3)
    xq = np.random.RandomState(4).rand(15)
    var, ell, noise = np.array([1.1, 0.9, 1.3]), np.array([0.3, 0.25, 0.4]), np.array([0.1, 0.15, 0.2])
    chains = StateSpaceGP.from_numpy(t, y, "RBF", var, ell, noise, order=12, balancing_iter=5, **F64)
    lml = chains.log_marginal_likelihood()
    assert tuple(lml.shape) == (3,)
    lml.sum().backward()
    mean, v = chains.predict_f(xq)
    params = dict(chains.named_parameters())
    for c in range(3):
        one = StateSpaceGP.from_numpy(t, y, "RBF", var[c], ell[c], noise[c], order=12, balancing_iter=5, **F64)
        l1, g1 = _constrained_grads(one)
        npt.assert_allclose(float(lml[c]), l1, rtol=1e-10)
        gc = np.array([float(params[n].grad[c] / torch.sigmoid(params[n][c].detach())) for n in NAMES])
        npt.assert_allclose(gc, g1, rtol=1e-8)
        m1, v1 = one.predict_f(xq)
        npt.assert_allclose(mean[c].numpy(), m1.numpy(), rtol=1e-9, atol=1e-11)
        npt.assert_allclose(v[c].numpy(), v1.numpy(), rtol=1e-9, atol=1e-11)
