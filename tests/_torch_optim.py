"""Helpers that test_torch_optim_fit.py, test_torch_optim_priors.py share."""
import numpy as np
import torch

from parallel_gps_torch import StateSpaceGP


def _data(T, seed):
    rng = np.random.RandomState(seed)
    t = np.sort(rng.rand(T))
    y = np.sin(12.0 * t) + 0.3 * rng.randn(T)
    y[rng.rand(T) < 0.1] = np.nan
    return t, y


def _model(name, t, y, v, ell, noise):
    return StateSpaceGP.from_numpy(t, y, name, v, ell, noise, dtype=torch.float64, device="cpu")


def _raw(m):
    """Unconstrained (variance, lengthscale, noise) of a port model."""
    return np.array([m.kernel.raw_variance.item(), m.kernel.raw_lengthscales.item(), m.raw_noise_variance.item()])
