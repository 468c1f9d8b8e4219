"""Helpers that test_torch_model_gpr.py, test_torch_model_matern.py,
test_torch_model_options.py, test_torch_model_rbf.py share."""
import numpy as np
import torch

import parallel_gps_tpu.kernels as jk
from parallel_gps_torch import StateSpaceGP
from parallel_gps_tpu.models import StateSpaceGP as JaxStateSpaceGP


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
