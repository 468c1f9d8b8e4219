"""Helpers that test_torch_kalman_api.py, test_torch_kalman_engines.py
share."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parallel_gps_tpu.kernels as jk
from parallel_gps_torch import lgssm_from_numpy


FILTER_TOL = dict(rtol=1e-9, atol=1e-10)
SMOOTHER_TOL = dict(rtol=1e-8, atol=1e-9)


def _port(ssm, time_last):
    return lgssm_from_numpy(*(np.asarray(x) for x in ssm), time_last=time_last, dtype=torch.float64, device="cpu")


def _problem(jkern, T, seed):
    """JAX models in both layouts with observations (~11% NaN), and the
    port's copies."""
    rng = np.random.RandomState(seed)
    t = np.sort(rng.rand(T))
    y = np.sin(12.0 * t) + 0.3 * rng.randn(T)
    y[rng.choice(T, T // 9, replace=False)] = np.nan
    ts, R = jnp.asarray(t).reshape(-1, 1), jnp.asarray(0.1).reshape(1, 1)
    tf, tl = jkern.get_ssm(ts, R), jkern.get_ssm_tl(ts, R)
    return tf, tl, jnp.asarray(y).reshape(-1, 1), _port(tf, False), _port(tl, True), torch.tensor(y)


@pytest.fixture(scope="module")
def m52():
    return _problem(jk.Matern52(0.8, 0.4), 150, 3)


@pytest.fixture(scope="module")
def rbf4():
    return _problem(jk.RBF(variance=1.0, lengthscales=0.3, order=4, balancing_iter=5), 90, 5)
