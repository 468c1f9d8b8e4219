"""Helpers that test_torch_kalman_api.py, test_torch_kalman_engines.py
share."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_gps_torch import kernels as tk
from parallel_gps_torch import lgssm_from_numpy
from _torch_common import port_model


FILTER_TOL = dict(rtol=1e-9, atol=1e-10)
SMOOTHER_TOL = dict(rtol=1e-8, atol=1e-9)


def _port(ssm, time_last):
    return lgssm_from_numpy(*(np.asarray(x) for x in ssm), time_last=time_last, dtype=torch.float64, device="cpu")


def _problem(tkern, T, seed):
    """A model in both layouts with observations (~11% NaN), as the JAX
    package's types holding the port kernel's arrays (``port_model``), and
    the port's copies of those made by ``lgssm_from_numpy``."""
    rng = np.random.RandomState(seed)
    t = np.sort(rng.rand(T))
    y = np.sin(12.0 * t) + 0.3 * rng.randn(T)
    y[rng.choice(T, T // 9, replace=False)] = np.nan
    tf, tl = (port_model(tkern, t, 0.1, time_last)[0] for time_last in (False, True))
    return tf, tl, jnp.asarray(y).reshape(-1, 1), _port(tf, False), _port(tl, True), torch.tensor(y)


@pytest.fixture(scope="module")
def m52():
    return _problem(tk.Matern52(0.8, 0.4, dtype=torch.float64, device="cpu"), 150, 3)


@pytest.fixture(scope="module")
def rbf4():
    return _problem(tk.RBF(1.0, 0.3, order=4, balancing_iter=5, dtype=torch.float64, device="cpu"), 90, 5)
