"""PyTorch port vs the JAX package: Matérn ``StateSpaceGP`` models (LML and
predict_f) built from the same numpy data through ``StateSpaceGP.from_numpy``,
query order and edge cases, and the sequential engine; f64 on the CPU, where
the port runs the plain versions of its kernels."""
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from parallel_gps_torch import StateSpaceGP
from parallel_gps_torch.models import merge_sorted
from parallel_gps_tpu.models import merge_sorted as jax_merge_sorted
from _torch_model import _data, _pair

torch.set_num_threads(1)


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
