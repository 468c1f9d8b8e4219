"""PyTorch port vs the JAX package: StateSpaceGP (LML and predict_f) built
from the same numpy data through ``StateSpaceGP.from_numpy``, f64 on the
CPU, where the port runs the plain versions of its kernels."""
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import parallel_gps_tpu.kernels as jk
from parallel_gps_torch import StateSpaceGP
from parallel_gps_torch.kernels import RBF, Matern32
from parallel_gps_torch.models import GPR, merge_sorted
from parallel_gps_tpu.models import StateSpaceGP as JaxStateSpaceGP
from parallel_gps_tpu.models import merge_sorted as jax_merge_sorted

torch.set_num_threads(1)


def _data(T, seed, nan_frac=0.1):
    rng = np.random.RandomState(seed)
    t = np.sort(rng.rand(T))
    y = np.sin(12.0 * t) + 0.3 * rng.randn(T)
    y[rng.rand(T) < nan_frac] = np.nan
    return t, y


def _pair(name, t, y, variance, lengthscale, noise, parallel=True, **kernel_options):
    """A JAX model and the port's model holding the same constrained values."""
    jkern = getattr(jk, name)(variance, lengthscale, **kernel_options)
    jm = JaxStateSpaceGP.create((t, y), jkern, noise_variance=noise, parallel=parallel)
    tm = StateSpaceGP.from_numpy(
        np.asarray(jm.ts)[:, 0], np.asarray(jm.ys)[:, 0], kernel=name,
        variance=np.asarray(jm.kernel.variance), lengthscales=np.asarray(jm.kernel.lengthscales),
        noise_variance=np.asarray(jm.noise_variance), dtype=torch.float64, device="cpu", parallel=parallel,
        **kernel_options,
    )
    return jm, tm


@pytest.mark.parametrize(
    "name,v,ell", [("Matern12", 1.2, 0.6), ("Matern32", 1.0, 0.5), ("Matern52", 0.9, 0.4)],
    ids=["m12", "m32", "m52"],
)
def test_lml_matches_jax(name, v, ell):
    t, y = _data(301, 0)
    jm, tm = _pair(name, t, y, v, ell, 0.1)
    with torch.no_grad():
        ell_t = float(tm.log_marginal_likelihood())
    npt.assert_allclose(ell_t, float(jm.log_marginal_likelihood()), rtol=1e-9)  # test_model_interpret.py:77


def test_predict_matches_jax():
    t, y = _data(257, 3)
    jm, tm = _pair("Matern52", t, y, 0.9, 0.4, 0.1)
    Xnew = np.random.RandomState(5).rand(23) * 1.2 - 0.1  # unsorted, some outside [0, 1)
    mean_j, var_j = jm.predict_f(Xnew)
    mean_t, var_t = tm.predict_f(Xnew)
    assert mean_t.shape == (23, 1) and var_t.shape == (23, 1)
    # test_model_interpret.py:93-94
    npt.assert_allclose(mean_t.numpy(), np.asarray(mean_j), rtol=1e-7, atol=1e-9)
    npt.assert_allclose(var_t.numpy(), np.asarray(var_j), rtol=1e-7, atol=1e-9)


def test_unsorted_queries_match_sorted_ones():
    t, y = _data(200, 1)
    tm = StateSpaceGP.from_numpy(t, y, "Matern52", 0.8, 0.4, 0.1, dtype=torch.float64, device="cpu")
    X = np.random.RandomState(2).rand(17) * 1.5 - 0.25
    order = np.argsort(X)
    m_u, v_u = tm.predict_f(X)
    m_s, v_s = tm.predict_f(X[order])
    npt.assert_allclose(m_u.numpy()[order], m_s.numpy(), rtol=1e-12, atol=1e-14)
    npt.assert_allclose(v_u.numpy()[order], v_s.numpy(), rtol=1e-12, atol=1e-14)


def test_all_nan_lml_is_exactly_zero_and_predicts_the_prior():
    t = np.sort(np.random.RandomState(3).rand(50))
    y = np.full(50, np.nan)
    jm, tm = _pair("Matern32", t, y, 1.3, 0.5, 0.2)
    with torch.no_grad():
        assert float(tm.log_marginal_likelihood()) == 0.0
    assert float(jm.log_marginal_likelihood()) == 0.0
    mean, var = tm.predict_f(np.array([0.3, 1.7]))
    npt.assert_allclose(mean.numpy(), 0.0, atol=1e-12)
    npt.assert_allclose(var.numpy(), 1.3, rtol=1e-10)


def test_single_observation():
    """T = 1: LML vs JAX; predict_f vs the closed-form GP posterior of one
    Matern52 observation."""
    v, ell, noise, t0, y0 = 0.9, 0.4, 0.1, 0.37, 0.8
    jm, tm = _pair("Matern52", np.array([t0]), np.array([y0]), v, ell, noise)
    with torch.no_grad():
        npt.assert_allclose(float(tm.log_marginal_likelihood()), float(jm.log_marginal_likelihood()), rtol=1e-12)
    X = np.array([0.5, 0.1, 0.37, 1.4])
    mean_t, var_t = tm.predict_f(X)

    def k(r):
        s = np.sqrt(5.0) * np.abs(r) / ell
        return v * (1.0 + s + s * s / 3.0) * np.exp(-s)

    kx = k(X - t0)
    npt.assert_allclose(mean_t.numpy()[:, 0], kx * y0 / (v + noise), rtol=1e-9, atol=1e-12)
    npt.assert_allclose(var_t.numpy()[:, 0], v - kx * kx / (v + noise), rtol=1e-9, atol=1e-12)


def test_empty_queries():
    t, y = _data(20, 4)
    tm = StateSpaceGP.from_numpy(t, y, "Matern12", 1.0, 0.3, 0.1, dtype=torch.float64, device="cpu")
    mean, var = tm.predict_f(np.zeros(0))
    assert mean.shape == (0, 1) and var.shape == (0, 1)


def test_merge_sorted_matches_jax_with_ties():
    a = np.array([0.1, 0.2, 0.2, 0.5, 0.9])
    b = np.array([0.0, 0.2, 0.2, 0.7, 1.0])
    pa, pb = np.arange(5.0), -np.arange(1.0, 6.0)
    merged_j, (pay_j,), is_b = jax_merge_sorted(jnp.asarray(a), jnp.asarray(b), (jnp.asarray(pa),), (jnp.asarray(pb),))
    merged_t, (pay_t,), b_pos = merge_sorted(torch.tensor(a), torch.tensor(b), (torch.tensor(pa),), (torch.tensor(pb),))
    npt.assert_array_equal(merged_t.numpy(), np.asarray(merged_j))
    npt.assert_array_equal(pay_t.numpy(), np.asarray(pay_j))
    npt.assert_array_equal(b_pos.numpy(), np.nonzero(np.asarray(is_b))[0])


def test_unported_options_raise():
    t, y = _data(10, 0)
    k = Matern32(1.0, 0.5, dtype=torch.float64, device="cpu")
    for kwargs, item in (({"mesh": object()}, "A13"), ({"stable": True}, "A10")):
        with pytest.raises(NotImplementedError, match=item):
            StateSpaceGP.create((t, y), k, 0.1, dtype=torch.float64, device="cpu", **kwargs)


@pytest.mark.parametrize("build", ["from_numpy", "create", "kernel", "rbf"])
def test_default_device_is_the_card_and_raises_without_one(build):
    """``device=None`` means the card at every entry point that creates
    tensors; where there is none (as here) it raises and names
    ``device="cpu"`` instead of carrying on on the CPU."""
    from parallel_gps_torch import config

    assert config.default_device() == torch.device("cuda")
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    t, y = _data(10, 0)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        if build == "from_numpy":
            StateSpaceGP.from_numpy(t, y, "Matern32", 1.0, 0.5, 0.1, dtype=torch.float64)
        elif build == "create":
            StateSpaceGP.create((t, y), Matern32(1.0, 0.5, dtype=torch.float64, device="cpu"), 0.1, dtype=torch.float64)
        elif build == "kernel":
            Matern32(1.0, 0.5, dtype=torch.float64)
        else:
            RBF(1.0, 0.5, order=4, dtype=torch.float64)


def test_to_numpy_inverts_from_numpy():
    t, y = _data(10, 0)
    tm = StateSpaceGP.from_numpy(t, y, "Matern52", 0.7, 1.9, 0.25, dtype=torch.float64, device="cpu")
    got = tm.to_numpy()
    assert {k: v.shape for k, v in got.items()} == {"variance": (), "lengthscales": (), "noise_variance": ()}
    npt.assert_allclose([got["variance"], got["lengthscales"], got["noise_variance"]], [0.7, 1.9, 0.25], rtol=1e-14)


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


@pytest.mark.parametrize("parallel", [True, False], ids=["strip", "sequential"])
def test_rbf6_model_matches_jax(parallel):
    """``RBF(order=6)``: the strip engine (no transition coefficients, d ≤ 8:
    strip filter forward, strip smoother + Fisher tail backward) and the
    sequential engine — LML, its three gradients and ``predict_f`` against the
    JAX ``StateSpaceGP`` with the same ``parallel``, rtol 1e-7."""
    t, y = _data(120, 6)
    jm, tm = _pair("RBF", t, y, 1.1, 0.3, 0.1, parallel=parallel, order=6, balancing_iter=5)
    assert tm.engine()[0] == ("strip" if parallel else "sequential")
    val_j, grads_j = _jax_value_and_grads(jm)
    val, grads = _value_and_constrained_grads(tm)
    npt.assert_allclose(val, float(val_j), rtol=1e-9)
    npt.assert_allclose(grads, [float(g) for g in grads_j], rtol=1e-7)
    Xnew = np.random.RandomState(5).rand(13) * 1.2 - 0.1
    mean_j, var_j = jm.predict_f(Xnew)
    mean_t, var_t = tm.predict_f(Xnew)
    npt.assert_allclose(mean_t.numpy(), np.asarray(mean_j), rtol=1e-7, atol=1e-9)
    npt.assert_allclose(var_t.numpy(), np.asarray(var_j), rtol=1e-7, atol=1e-9)


def test_sequential_model_matches_the_parallel_one():
    """``parallel=False`` (kf / kfs) against JAX's and against the port's
    dt-engine model: LML to 1e-10 relative, predictions to the smoother's
    tolerance."""
    t, y = _data(150, 8)
    jm, seq = _pair("Matern52", t, y, 0.9, 0.4, 0.1, parallel=False)
    _, par = _pair("Matern52", t, y, 0.9, 0.4, 0.1)
    assert seq.engine()[0] == "sequential" and par.engine()[0] == "dt"
    with torch.no_grad():
        ell_s, ell_p = float(seq.log_marginal_likelihood()), float(par.log_marginal_likelihood())
    npt.assert_allclose(ell_s, float(jm.log_marginal_likelihood()), rtol=1e-10)
    assert abs(ell_s - ell_p) < 1e-10 * abs(ell_p)
    X = np.random.RandomState(1).rand(9)
    for a, b in zip(seq.predict_f(X), par.predict_f(X)):
        npt.assert_allclose(a.numpy(), b.numpy(), rtol=1e-8, atol=1e-9)


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


GPR_COVS = [
    # (kernel, options, value tolerance, gradient tolerance): tests/test_gp_vs_kfs.py:37-40.
    # RBF at the port's highest order: its order-8 SDE approximates the SE
    # kernel far less closely than that file's order 15 (the LML is 4% from
    # the dense one), so only the value and the posterior are held, loosely;
    # the port's RBF model is held against the JAX one at rtol 1e-7 above.
    ("Matern12", {}, 1e-6, 1e-2),
    ("Matern32", {}, 1e-6, 1e-2),
    ("Matern52", {}, 1e-6, 1e-2),
    ("RBF", {"order": 8, "balancing_iter": 10}, 5e-2, None),
]


@pytest.mark.parametrize("name,options,val_tol,grad_tol", GPR_COVS, ids=[c[0] for c in GPR_COVS])
def test_dense_gpr_oracle_against_kfs(name, options, val_tol, grad_tol):
    """The dense GP (models/gpr.py) against the state-space model, sequential
    and parallel, on the data protocol of tests/test_gp_vs_kfs.py (T = 200
    sorted uniform times, noisy sinusoid, K = 50 queries): LML, its gradients
    w.r.t. the unconstrained hyperparameters, and the posterior."""
    from parallel_gps_torch.toymodels import obs_noise, sinu

    rng = np.random.RandomState(31415926)
    t = np.sort(rng.rand(200))
    y = obs_noise(sinu(t), 0.1, 42)
    query = np.sort(rng.rand(50))
    models = [
        StateSpaceGP.from_numpy(t, y, name, 1.0, 0.5, 0.1, dtype=torch.float64, device="cpu", parallel=p, **options)
        for p in (True, False)
    ]
    ref = models[0]
    ref.zero_grad(set_to_none=True)
    gp = GPR(ref.ts, ref.ys, ref.kernel, ref.noise_variance)
    gp_val = gp.log_marginal_likelihood()
    gp_val.backward()
    gp_grads = [float(p.grad) for p in ref.parameters()]
    with torch.no_grad():
        mean_gp, var_gp = GPR(ref.ts, ref.ys, ref.kernel, ref.noise_variance).predict_f(torch.tensor(query))
    for tm in models:
        tm.zero_grad(set_to_none=True)
        val = tm.log_marginal_likelihood()
        val.backward()
        npt.assert_allclose(float(val.detach()), float(gp_val.detach()), atol=val_tol, rtol=val_tol)
        if grad_tol is not None:
            npt.assert_allclose([float(p.grad) for p in tm.parameters()], gp_grads, atol=grad_tol, rtol=grad_tol)
        mean, var = tm.predict_f(query)
        npt.assert_allclose(mean.numpy(), mean_gp.numpy(), atol=val_tol, rtol=val_tol)
        npt.assert_allclose(var.numpy(), var_gp.numpy(), atol=val_tol, rtol=val_tol)


def test_to_numpy_carries_the_rbf_fields():
    t, y = _data(10, 0)
    tm = StateSpaceGP.from_numpy(t, y, "RBF", 0.7, 1.9, 0.25, dtype=torch.float64, device="cpu", order=6, balancing_iter=7)
    got = tm.to_numpy()
    assert (got["order"], got["balancing_iter"]) == (6, 7)
    again = StateSpaceGP.from_numpy(t, y, "RBF", dtype=torch.float64, device="cpu", **got)
    npt.assert_allclose([again.to_numpy()[k] for k in ("variance", "lengthscales", "noise_variance")], [0.7, 1.9, 0.25], rtol=1e-14)
    assert again.kernel.order == 6 and again.kernel.balancing_iter == 7
