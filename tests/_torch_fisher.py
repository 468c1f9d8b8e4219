"""Helpers that test_torch_fisher_lml_dt.py, test_torch_fisher_tail.py
share."""
import numpy as np
import torch

from parallel_gps_torch import kernels as tk


KERNELS = [("Matern12", 1.2, 0.6), ("Matern32", 1.1, 0.45), ("Matern52", 0.9, 0.5)]
IDS = ["m12", "m32", "m52"]
NOISE = 0.1


def _data(T, seed, nan=True):
    rng = np.random.RandomState(seed)
    t = np.sort(rng.rand(T))
    y = np.sin(12.0 * t) + 0.3 * rng.randn(T)
    if nan:
        y[rng.choice(T, T // 9, replace=False)] = np.nan
    return t, y


def _torch_kernel(name, v, ell):
    return getattr(tk, name)(v, ell, dtype=torch.float64, device="cpu")
