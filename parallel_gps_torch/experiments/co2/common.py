"""CO2 experiment shared pieces (counterpart:
parallel_gps_tpu/experiments/co2/common.py): the merged NOAA weekly and
monthly Mauna Loa data and the quasi-periodic covariance

    Periodic(σ² = 5 fixed, ℓ, period = 1 fixed, order = qp)
        × Matern32(σ² = 0.1, ℓ = 50)      [periodic damping]
    + Matern32(σ² = 1, ℓ = 100)           [long-term trend]

(d = 18 at the CLI's ``--qp-order 3``: the plain time-last engine), with
Normal priors on the trainable hyperparameters and the observation noise
fixed.
"""
from __future__ import annotations

import numpy as np

from parallel_gps_torch.datasets import load_co2
from parallel_gps_torch.experiments import common as C


def get_data(n_training: int | None, data_dir: str | None = None):
    return load_co2(n_training, data_dir)


def get_covariance_function(qp_order: int = 3):
    from parallel_gps_torch import config, kernels

    opts = dict(dtype=config.default_float(), device=C.default_device())
    periodic = kernels.Periodic(5.0, 1.0, 1.0, order=qp_order, **opts)
    damping = kernels.Matern32(0.1, 50.0, **opts)
    trend = kernels.Matern32(1.0, 100.0, **opts)
    return periodic * damping + trend


def normal_logpdf(mu: float, sigma: float):
    def logpdf(x):
        return -0.5 * ((x - mu) / sigma) ** 2 - np.log(sigma) - 0.5 * np.log(2 * np.pi)

    return logpdf


def get_priors() -> dict:
    """The priors of reference co2/mcmc.py:42-62 on the constrained values
    (gpflow's default, which the reference keeps), by the port's dotted
    names: the kernel is Sum(Product(Periodic, damping), trend)."""
    return {
        "kernel.kernels.0.kernels.0.lengthscales": (normal_logpdf(5.0, 1.0), "constrained"),
        "kernel.kernels.0.kernels.1.variance": (normal_logpdf(0.1, 1e-3), "constrained"),
        "kernel.kernels.0.kernels.1.lengthscales": (normal_logpdf(50.0, 10.0), "constrained"),
        "kernel.kernels.1.variance": (normal_logpdf(1.0, 0.1), "constrained"),
        "kernel.kernels.1.lengthscales": (normal_logpdf(100.0, 50.0), "constrained"),
    }


def trainable(path: str) -> bool:
    """The noise, the periodic variance and the period are fixed (reference
    co2/mcmc.py:35-39, 46-57); ``path`` is a dotted name of the port's
    model."""
    if path.endswith("noise_variance"):
        return False
    if "kernels.0.kernels.0" in path and path.endswith(("variance", "period")):
        return False
    return True
