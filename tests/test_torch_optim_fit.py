"""PyTorch port vs the JAX package: the training path — model-level
value_and_grad, ``fit_adam`` / ``fit_lbfgs`` (``inference.optim``) and
frozen leaves — f64 on the CPU, same numpy data through both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import parallel_gps_tpu.kernels as jk
from parallel_gps_torch.inference import fit_adam, fit_lbfgs
from parallel_gps_tpu.inference import fit_adam as jax_fit_adam
from parallel_gps_tpu.models import StateSpaceGP as JaxStateSpaceGP
from parallel_gps_tpu.toymodels import obs_noise, sinu
from _torch_optim import _data, _model, _raw
from _torch_common import jit_o0

torch.set_num_threads(1)


def _grad(m):
    return np.array([m.kernel.raw_variance.grad.item(), m.kernel.raw_lengthscales.grad.item(), m.raw_noise_variance.grad.item()])


def _state(m):
    return {k: v.clone() for k, v in m.state_dict().items()}


def _assert_state_is(m, before):
    """Parameters and buffers bit-equal to an earlier ``_state`` (NaN
    observations compare equal)."""
    for key, value in m.state_dict().items():
        assert torch.allclose(value, before[key], rtol=0.0, atol=0.0, equal_nan=True), key


@pytest.mark.parametrize(
    "name,v,ell", [("Matern12", 1.2, 0.6), ("Matern32", 1.0, 0.5), ("Matern52", 0.9, 0.45)], ids=["m12", "m32", "m52"]
)
def test_model_value_and_grad_match_jax(name, v, ell):
    """``training_loss()`` and its gradient w.r.t. the unconstrained
    (variance, lengthscale, noise) vs ``jax.value_and_grad`` of the JAX
    model's loss: value rtol 1e-10, gradients rtol 1e-7 / atol 1e-10
    (test_model_interpret.py:112-113)."""
    t, y = _data(173, 7)
    tm = _model(name, t, y, v, ell, 0.12)
    loss = tm.training_loss()
    loss.backward()

    @jit_o0
    @jax.value_and_grad
    def jax_loss(u):
        p = jax.nn.softplus(u)
        return JaxStateSpaceGP.create((t, y), getattr(jk, name)(p[0], p[1]), noise_variance=p[2]).training_loss()

    v_j, g_j = jax_loss(jnp.asarray(_raw(tm)))
    npt.assert_allclose(float(loss.detach()), float(v_j), rtol=1e-10)
    npt.assert_allclose(_grad(tm), np.asarray(g_j), rtol=1e-7, atol=1e-10)
    assert float(tm.maximum_log_likelihood_objective().detach()) == -float(loss.detach())


@pytest.fixture(scope="module")
def adam_pair():
    """Ten Adam steps on the same Matern32 model in both packages."""
    t, y = _data(120, 1)
    jm = JaxStateSpaceGP.create((t, y), jk.Matern32(1.5, 0.8), noise_variance=0.4)
    tm = _model("Matern32", t, y, 1.5, 0.8, 0.4)
    before = _state(tm)
    return tm, before, fit_adam(tm, n_iters=10, learning_rate=0.05), jax_fit_adam(jm, n_iters=10, learning_rate=0.05)


def test_fit_adam_history_matches_jax(adam_pair):
    """Loss before each of 10 updates, rtol 1e-6."""
    _, _, (_, hist_t), (_, hist_j) = adam_pair
    assert hist_t.shape == (10,) and not hist_t.requires_grad
    npt.assert_allclose(hist_t.numpy(), np.asarray(hist_j), rtol=1e-6)


def test_fit_adam_fitted_values_match_jax(adam_pair):
    """Constrained hyperparameters after 10 updates, rtol 1e-6."""
    _, _, (fit_t, _), (fit_j, _) = adam_pair
    got = fit_t.to_numpy()
    want = {"variance": fit_j.kernel.variance, "lengthscales": fit_j.kernel.lengthscales, "noise_variance": fit_j.noise_variance}
    assert set(got) == set(want)
    for key, value in want.items():
        npt.assert_allclose(got[key], np.asarray(value), rtol=1e-6, err_msg=key)


def test_fit_adam_leaves_the_callers_model_unchanged(adam_pair):
    tm, before, (fit_t, _), _ = adam_pair
    assert fit_t is not tm
    _assert_state_is(tm, before)
    assert all(p.grad is None for p in tm.parameters()) and all(p.grad is None for p in fit_t.parameters())
    assert not np.allclose(_raw(fit_t), _raw(tm))


@pytest.fixture(scope="module")
def canonical():
    """The canonical drive: noisy sinusoid, T = 300, Matern32(2, 1), noise
    0.5, Adam at learning rate 0.05."""
    t = np.sort(np.random.RandomState(0).rand(300))
    y = obs_noise(sinu(t), 0.1, 1)
    model = _model("Matern32", t, y, 2.0, 1.0, 0.5)
    fitted, history = fit_adam(model, n_iters=120, learning_rate=0.05)
    return model, fitted, history


def test_canonical_drive_rmse(canonical):
    """RMSE of the fitted posterior mean against the noise-free signal
    (1 + √0.1)·sinu(q) below 0.05, and the loss fell."""
    _, fitted, history = canonical
    q = np.linspace(0.02, 0.98, 50)
    mean, var = fitted.predict_f(q)
    rmse = float(np.sqrt(np.mean((mean.numpy()[:, 0] - (1 + np.sqrt(0.1)) * sinu(q)) ** 2)))
    assert rmse < 0.05, rmse
    assert (var.numpy() > 0).all()
    assert float(history[-1]) < float(history[0])


def test_fit_lbfgs_raises_the_lml_to_adams_long_run_value(canonical):
    """Every L-BFGS step lowers the loss (strong-Wolfe line search), and 25
    steps reach at least the LML that 120 Adam steps reached."""
    model, adam_fitted, _ = canonical
    before = _state(model)
    fitted, history = fit_lbfgs(model, n_iters=25)
    assert history.shape == (25,)
    assert (history[1:] <= history[:-1] + 1e-9).all()
    with torch.no_grad():
        lml0, lml_adam, lml = (float(m.log_marginal_likelihood()) for m in (model, adam_fitted, fitted))
    npt.assert_allclose(float(history[0]), -lml0, rtol=1e-12)
    assert lml > lml0 and lml >= lml_adam
    _assert_state_is(model, before)


@pytest.mark.parametrize("fit", [fit_adam, fit_lbfgs], ids=["adam", "lbfgs"])
def test_trainable_freezes_the_named_leaf_bit_exactly(fit):
    t, y = _data(80, 2)
    tm = _model("Matern52", t, y, 0.9, 0.45, 0.3)
    seen = []

    def trainable(name):
        seen.append(name)
        return name != "kernel.lengthscales"

    fitted, history = fit(tm, n_iters=3, trainable=trainable)
    assert sorted(set(seen)) == ["kernel.lengthscales", "kernel.variance", "noise_variance"]
    assert torch.equal(fitted.kernel.raw_lengthscales, tm.kernel.raw_lengthscales)
    assert not torch.equal(fitted.kernel.raw_variance, tm.kernel.raw_variance)
    assert not torch.equal(fitted.raw_noise_variance, tm.raw_noise_variance)
    assert float(history[-1]) < float(history[0])
