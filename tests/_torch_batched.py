"""Helpers that test_torch_batched_build.py, test_torch_batched_fisher.py,
test_torch_batched_kernels.py, test_torch_batched_posterior.py share."""
import numpy as np
import torch


MATERN = [("Matern12", 1), ("Matern32", 2), ("Matern52", 3)]


def _t(x):
    return torch.tensor(np.asarray(x))


def _series(n, T, seed, nan_frac=0.15):
    """Shared sorted times and n observation vectors with NaNs."""
    rng = np.random.RandomState(seed)
    t = np.sort(rng.rand(T)) * 4.0
    ys = np.sin(7 * t)[None] + 0.1 * rng.randn(n, T)
    ys[rng.rand(n, T) < nan_frac] = np.nan
    return t, ys


C_CHAINS = 5
VAR = 0.5 + 0.2 * np.arange(C_CHAINS)
ELL = 0.3 + 0.05 * np.arange(C_CHAINS)
NOISE = 0.1 + 0.02 * np.arange(C_CHAINS)


def _data(T, seed):
    rng = np.random.RandomState(seed)
    t = np.sort(rng.rand(T))
    y = np.sin(12.0 * t) + 0.3 * rng.randn(T)
    y[rng.rand(T) < 0.1] = np.nan
    return t, y


PRIORS = {
    "kernel.lengthscales": (lambda x: -3.0 * x, "constrained"),
    "kernel.variance": lambda u: -0.25 * u * u,
    "noise_variance": lambda u: -0.5 * (u + 1.0) ** 2,
}
