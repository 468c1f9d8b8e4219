"""PyTorch port vs the JAX package: ``StateSpaceGP(stable=True)`` on the
square-root engine — against the standard engine (the mirror of
tests/test_sqrt.py:221-268), against the JAX stable model, chains, the
refusals, and the two reference defects fixed rather than copied; f64 on
the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import parallel_gps_tpu.kernels as jk
from parallel_gps_torch import StateSpaceGP
from parallel_gps_torch.kalman import sqrt as S
from parallel_gps_torch.kernels import RBF, Matern12, Matern32, Matern52
from parallel_gps_torch.toymodels import obs_noise, sinu
from parallel_gps_tpu.kalman import sqrt as J
from parallel_gps_tpu.models import StateSpaceGP as JaxStateSpaceGP
from parallel_gps_tpu.types import LGSSM as JLGSSM, ContinuousDiscreteModel as JSDE
from _torch_common import jit_o0

torch.set_num_threads(1)
F64 = dict(dtype=torch.float64, device="cpu")


def _data():
    """Matern52 data of tests/test_sqrt.py:227-233: T = 181, 20 NaNs, 33
    unsorted queries."""
    rng = np.random.RandomState(5)
    t = np.sort(rng.rand(181))
    y = obs_noise(sinu(t), 0.1, 5)
    y[rng.choice(181, 20, replace=False)] = np.nan
    return t, y, rng.rand(33)


def _grads(model):
    model.zero_grad()
    loss = model.training_loss()
    loss.backward()
    return float(loss), np.array([float(p.grad) for p in model.parameters()])


def test_stable_model_matches_standard():
    """LML and predict_f equal the standard parallel model's (the dt engine)
    in f64; the query variances are ≥ 0; the LML's gradient (the square-root
    Fisher tail) equals the standard one's."""
    t, y, xq = _data()
    std = StateSpaceGP.from_numpy(t, y, "Matern52", 0.9, 0.4, 0.1, **F64)
    stb = StateSpaceGP.from_numpy(t, y, "Matern52", 0.9, 0.4, 0.1, stable=True, **F64)
    assert std.engine()[0] == "dt" and stb.engine()[0] == "sqrt"
    npt.assert_allclose(float(stb.log_marginal_likelihood().detach()), float(std.log_marginal_likelihood().detach()), rtol=1e-9)
    m1, v1 = std.predict_f(xq)
    m2, v2 = stb.predict_f(xq)
    assert tuple(m2.shape) == tuple(v2.shape) == (33, 1)
    npt.assert_allclose(m2.numpy(), m1.numpy(), atol=1e-8 * float(m1.abs().max()))
    npt.assert_allclose(v2.numpy(), v1.numpy(), atol=1e-8 * float(v1.abs().max()))
    assert float(v2.min()) >= 0.0
    (l1, g1), (l2, g2) = _grads(std), _grads(stb)
    npt.assert_allclose(l2, l1, rtol=1e-9)
    assert np.isfinite(g2).all()
    npt.assert_allclose(g2, g1, rtol=1e-6)


def test_stable_lml_and_gradient_match_jax():
    """The stable LML and its gradient in the constrained values against the
    JAX stable model's (1e-9 and 1e-7)."""
    t, y, _ = _data()
    p0 = np.array([0.9, 0.4, 0.1])

    def loss(p):
        m = JaxStateSpaceGP.create((t, y), jk.Matern32(p[0], p[1]), p[2], stable=True)
        return m.log_marginal_likelihood()

    jl, jg = jit_o0(jax.value_and_grad(loss))(jnp.asarray(p0))
    m = StateSpaceGP.from_numpy(t, y, "Matern32", *p0, stable=True, **F64)
    lml = m.log_marginal_likelihood()
    lml.backward()
    # The port's parameters are softplus⁻¹ of the values: dℓ/du = dℓ/dx · sigmoid(u).
    params = dict(m.named_parameters())
    names = ("kernel.raw_variance", "kernel.raw_lengthscales", "raw_noise_variance")
    got = np.array([float(params[n].grad / torch.sigmoid(params[n].detach())) for n in names])
    npt.assert_allclose(float(lml), float(jl), rtol=1e-9)
    npt.assert_allclose(got, np.asarray(jg), rtol=1e-7)


def test_stable_chains():
    """Hyperparameters of shape (C,) = 3: the LML (C,), its gradient and
    predict_f (C, M, 1) equal each chain's own stable model."""
    t, y, xq = _data()
    var, ell, noise = np.array([0.9, 1.1, 0.7]), np.array([0.4, 0.3, 0.5]), np.array([0.1, 0.2, 0.15])
    chains = StateSpaceGP.from_numpy(t, y, "Matern52", var, ell, noise, stable=True, **F64)
    lml = chains.log_marginal_likelihood()
    assert tuple(lml.shape) == (3,)
    (-lml.sum()).backward()
    mean, v = chains.predict_f(xq)
    assert tuple(mean.shape) == tuple(v.shape) == (3, 33, 1)
    for c in range(3):
        one = StateSpaceGP.from_numpy(t, y, "Matern52", var[c], ell[c], noise[c], stable=True, **F64)
        l1, g1 = _grads(one)
        npt.assert_allclose(-float(lml[c]), l1, rtol=1e-12)
        npt.assert_allclose([float(p.grad[c]) for p in chains.parameters()], g1, rtol=1e-10)
        m1, v1 = one.predict_f(xq)
        npt.assert_allclose(mean[c].numpy(), m1.numpy(), rtol=1e-10, atol=1e-12)
        npt.assert_allclose(v[c].numpy(), v1.numpy(), rtol=1e-10, atol=1e-12)


def test_stable_value_errors():
    t, y, _ = _data()
    k = Matern52(1.0, 0.5, **F64)
    with pytest.raises(ValueError, match="parallel"):
        StateSpaceGP.create((t, y), k, 0.1, parallel=False, stable=True, **F64)
    with pytest.raises(ValueError, match="mesh"):
        StateSpaceGP.create((t, y), k, 0.1, mesh=object(), stable=True, **F64)


class _RaisingJaxKernel:
    """A JAX-side kernel whose transitions raise a ``ValueError`` that has
    nothing to do with the dispersion's rank."""

    def __init__(self, sde):
        self.sde, self.state_dim = sde, sde.F.shape[0]

    def get_sde(self):
        return self.sde

    def transitions_m1(self, dts):
        raise ValueError("a fault inside the quadrature")


def test_rank_test_is_explicit(monkeypatch):
    """C3, the first defect: the quadrature factors are taken where L has one
    column, tested explicitly.  A Sum (L of two columns) takes the eigh
    factors and still matches the standard engine; an error raised inside
    ``gramian_disc_factors`` surfaces, where the JAX version's
    ``except ValueError`` falls back to eigh silently."""
    t, y, _ = _data()
    kern = Matern32(0.9, 0.4, **F64) + Matern12(0.5, 0.3, **F64)
    with torch.no_grad():
        lgssm, ts = S._kernel_model(kern, torch.tensor(t), 0.1, 0.0)
        sqQ, sqP0 = S.kernel_sq_factors(kern, ts, lgssm, None)
    assert kern.get_sde().L.shape[-1] == 2 and sqQ is None
    std = StateSpaceGP.create((t, y), kern, 0.1, **F64)
    stb = StateSpaceGP.create((t, y), kern, 0.1, stable=True, **F64)
    npt.assert_allclose(float(stb.log_marginal_likelihood()), float(std.log_marginal_likelihood()), rtol=1e-9)

    m32 = Matern32(0.9, 0.4, **F64)
    with torch.no_grad():
        lgssm, ts = S._kernel_model(m32, torch.tensor(t), 0.1, 0.0)

    def fault(dts):
        raise ValueError("a fault inside the quadrature")

    monkeypatch.setattr(m32, "transitions_m1", fault)
    with pytest.raises(ValueError, match="fault inside"):
        S.kernel_sq_factors(m32, ts, lgssm, None)
    jsde = JSDE(*(jnp.asarray(x.detach().numpy()) for x in m32.get_sde()))
    jl = JLGSSM(*(jnp.asarray(x.numpy()) for x in lgssm))
    jsqQ, _ = J.kernel_sq_factors(_RaisingJaxKernel(jsde), jnp.asarray(t).reshape(-1, 1), jl, None, 0.0)
    assert jsqQ is None  # the JAX form swallows the fault


def test_differences_are_formed_before_the_solves():
    """C3, the second defect: the Fisher tail forms D = N̂N̂ᵀ − Ψ11Ψ11ᵀ first
    and then solves against the factor on both sides.  Where the smoothed
    factor is the predicted one (no information added) D is exactly zero and
    so are Pp⁻¹D and Pp⁻¹DPp⁻¹; the JAX form W Wᵀ − Pp⁻¹ (W = Pp⁻¹N̂)
    subtracts two products of Pp⁻¹'s size and leaves their rounding, here on
    RBF(order=12)'s ill-conditioned predicted covariances."""
    kern = RBF(1.0, 0.25, order=12, balancing_iter=5, **F64)
    t = np.sort(np.random.RandomState(1).rand(40))
    y = np.sin(12.0 * t)
    with torch.no_grad():
        lgssm, ts = S._kernel_model(kern, torch.tensor(t), 0.1, 0.0)
        sqQ, sqP0 = S.kernel_sq_factors(kern, ts, lgssm, None)
        fms, fUs = S.sqrt_pkf(lgssm, torch.tensor(y), False, sqQ, sqP0)
        U_prev = torch.cat([sqP0[None], fUs[:-1]])
        Psi11 = S.tria(torch.cat([lgssm.Fs @ U_prev, sqQ], -1))
        PiD, PiDPi = S._smoothed_differences(Psi11, Psi11.clone())
        assert torch.count_nonzero(PiD) == 0 and torch.count_nonzero(PiDPi) == 0
        W = S._chol_solve(Psi11, Psi11)
        eye = torch.eye(12, dtype=torch.float64).expand(40, 12, 12)
        jax_form = W @ W.transpose(-1, -2) - S._chol_solve(Psi11, eye)
    assert float(jax_form.abs().max()) > 0.0
