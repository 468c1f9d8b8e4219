"""PyTorch port vs the JAX package: ``RBF`` models on the dt and the
sequential engines (LML, gradients, predict_f), the same kernel's planes on
the strip engine through the Kalman API, their edge cases and their
``to_numpy`` fields; f64 on the CPU."""
import numpy as np
import numpy.testing as npt
import pytest
import torch

from parallel_gps_torch import StateSpaceGP
from parallel_gps_torch.kalman.timelast import lml_tl, pkfs_from_tl
from parallel_gps_torch.models.ssgp import merge_sorted
from _torch_model import _data, _pair

torch.set_num_threads(1)


def _jax_value_and_grads(jm):
    """LML of a JAX model and its gradient w.r.t. the constrained
    (variance, lengthscale, noise variance)."""
    import jax

    def lml(v, ell, noise):
        return jm.replace(kernel=jm.kernel.replace(variance=v, lengthscales=ell), noise_variance=noise).log_marginal_likelihood()

    return jax.value_and_grad(lml, argnums=(0, 1, 2))(jm.kernel.variance, jm.kernel.lengthscales, jm.noise_variance)


def _value_and_constrained_grads(tm):
    """The same for the port's model: the gradients w.r.t. the raw
    parameters divided by the softplus derivative."""
    tm.zero_grad(set_to_none=True)
    ell = tm.log_marginal_likelihood()
    ell.backward()
    raws = (tm.kernel.raw_variance, tm.kernel.raw_lengthscales, tm.raw_noise_variance)
    return float(ell.detach()), [float(p.grad / torch.sigmoid(p.detach())) for p in raws]


def _strip_value_and_constrained_grads(tm):
    """``_value_and_constrained_grads`` through the strip engine on the
    model's planes (``lml_tl(..., strip=True)``: strip filter forward, strip
    smoother + Fisher tail backward)."""
    tm.zero_grad(set_to_none=True)
    ell = lml_tl(tm.kernel.get_ssm_tl(tm.ts, tm.noise_variance.reshape(1, 1)), tm.ys, strip=True)
    ell.backward()
    raws = (tm.kernel.raw_variance, tm.kernel.raw_lengthscales, tm.raw_noise_variance)
    return float(ell.detach()), [float(p.grad / torch.sigmoid(p.detach())) for p in raws]


@torch.no_grad()
def _strip_predict(tm, Xnew):
    """``predict_f`` with the merged series smoothed by the strip engine
    (``pkfs_from_tl(..., strip=True)``)."""
    X = torch.tensor(Xnew)
    order = torch.argsort(X)
    nan = torch.full((X.shape[0],), float("nan"), dtype=tm.ys.dtype)
    all_ts, (all_ys,), q_idx = merge_sorted(tm.ts, X[order], (tm.ys,), (nan,))
    ssm = tm.kernel.get_ssm_tl(all_ts, tm.noise_variance.reshape(1, 1))
    g, L = pkfs_from_tl(ssm, all_ys, strip=True, time_first_out=False)
    h = ssm.H[0]
    inv = torch.argsort(order)
    return (h @ g[:, q_idx])[inv], torch.einsum("i,ijm,j->m", h, L[:, :, q_idx], h)[inv]


@pytest.mark.parametrize("parallel", [True, False], ids=["strip", "sequential"])
def test_rbf6_model_matches_jax(parallel):
    """``RBF(order=6)``: with ``parallel=True`` the model's dt engine (the
    spectral transition family: dt filter forward, dt smoother + Fisher tail
    backward, as the reference routes it) and the same kernel's planes on the
    strip engine through the Kalman API; with ``parallel=False`` the
    sequential engine — LML, its three gradients and ``predict_f`` against
    the JAX ``StateSpaceGP`` with the same ``parallel``, rtol 1e-7."""
    t, y = _data(120, 6)
    jm, tm = _pair("RBF", t, y, 1.1, 0.3, 0.1, parallel=parallel, order=6, balancing_iter=5)
    assert tm.engine()[0] == ("dt" if parallel else "sequential")
    val_j, grads_j = _jax_value_and_grads(jm)
    Xnew = np.random.RandomState(5).rand(13) * 1.2 - 0.1
    mean_j, var_j = jm.predict_f(Xnew)
    routes = [(_value_and_constrained_grads, lambda: tm.predict_f(Xnew))]
    if parallel:
        routes.append((_strip_value_and_constrained_grads, lambda: _strip_predict(tm, Xnew)))
    for value_and_grads, predict in routes:
        val, grads = value_and_grads(tm)
        npt.assert_allclose(val, float(val_j), rtol=1e-9)
        npt.assert_allclose(grads, [float(g) for g in grads_j], rtol=1e-7)
        mean_t, var_t = predict()
        npt.assert_allclose(mean_t.reshape(-1).numpy(), np.asarray(mean_j).reshape(-1), rtol=1e-7, atol=1e-9)
        npt.assert_allclose(var_t.reshape(-1).numpy(), np.asarray(var_j).reshape(-1), rtol=1e-7, atol=1e-9)


@pytest.mark.parametrize("parallel", [True, False], ids=["strip", "sequential"])
def test_rbf_edge_cases(parallel):
    """All-NaN data: the LML is exactly 0 and predictions are the prior;
    T = 1: LML and prediction against the closed-form GP posterior of one
    observation."""
    opts = dict(dtype=torch.float64, device="cpu", parallel=parallel, order=4, balancing_iter=5)
    t = np.sort(np.random.RandomState(3).rand(30))
    tm = StateSpaceGP.from_numpy(t, np.full(30, np.nan), "RBF", 1.3, 0.5, 0.2, **opts)
    with torch.no_grad():
        assert float(tm.log_marginal_likelihood()) == 0.0
    mean, var = tm.predict_f(np.array([0.3, 1.7]))
    with torch.no_grad():
        sde = tm.kernel.get_sde()
        k0 = float(sde.H @ sde.P0 @ sde.H.T)  # the SDE's own k(0)
    npt.assert_allclose(mean.numpy(), 0.0, atol=1e-12)
    npt.assert_allclose(var.numpy(), k0, rtol=1e-9)

    v, noise, t0, y0 = 0.9, 0.1, 0.37, 0.8
    one = StateSpaceGP.from_numpy(np.array([t0]), np.array([y0]), "RBF", v, 0.4, noise, **opts)
    with torch.no_grad():
        sde = one.kernel.get_sde()
        k0 = float(sde.H @ sde.P0 @ sde.H.T)
        ell = float(one.log_marginal_likelihood())
    npt.assert_allclose(ell, -0.5 * (y0**2 / (k0 + noise) + np.log(k0 + noise) + np.log(2 * np.pi)), rtol=1e-12)
    mean, var = one.predict_f(np.array([t0]))
    npt.assert_allclose(float(mean), k0 * y0 / (k0 + noise), rtol=1e-9)
    npt.assert_allclose(float(var), k0 - k0 * k0 / (k0 + noise), rtol=1e-9)


def test_to_numpy_carries_the_rbf_fields():
    t, y = _data(10, 0)
    tm = StateSpaceGP.from_numpy(t, y, "RBF", 0.7, 1.9, 0.25, dtype=torch.float64, device="cpu", order=6, balancing_iter=7)
    got = tm.to_numpy()
    assert (got["order"], got["balancing_iter"]) == (6, 7)
    again = StateSpaceGP.from_numpy(t, y, "RBF", dtype=torch.float64, device="cpu", **got)
    npt.assert_allclose([again.to_numpy()[k] for k in ("variance", "lengthscales", "noise_variance")], [0.7, 1.9, 0.25], rtol=1e-14)
    assert again.kernel.order == 6 and again.kernel.balancing_iter == 7
