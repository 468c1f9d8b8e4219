"""Sunspot experiment shared pieces (counterpart:
parallel_gps_tpu/experiments/sunspot/common.py): SILSO monthly data,
Matern32(σ² = 5500, ℓ = 5) with Normal priors matching the parameter
scales."""
from __future__ import annotations

import numpy as np

from parallel_gps_torch.datasets import load_sunspots
from parallel_gps_torch.experiments import common as C

MATERN_VARIANCE = 5500.0
MATERN_LENGTHSCALES = 5.0


def get_data(n_training: int, data_dir: str | None = None):
    return load_sunspots(n_training, data_dir)


def get_covariance_function():
    return C.get_covariance_function("Matern32", variance=MATERN_VARIANCE, lengthscales=MATERN_LENGTHSCALES)


def normal_logpdf(mu: float, sigma: float):
    def logpdf(x):
        return -0.5 * ((x - mu) / sigma) ** 2 - np.log(sigma) - 0.5 * np.log(2 * np.pi)

    return logpdf


def get_priors(noise_variance: float) -> dict:
    """Normal priors centred at the initial values with matching scale, on
    the constrained values (gpflow's default, which the reference keeps)."""
    return {
        "kernel.variance": (normal_logpdf(MATERN_VARIANCE, MATERN_VARIANCE), "constrained"),
        "kernel.lengthscales": (normal_logpdf(MATERN_LENGTHSCALES, MATERN_LENGTHSCALES), "constrained"),
        "noise_variance": (normal_logpdf(noise_variance, noise_variance), "constrained"),
    }
