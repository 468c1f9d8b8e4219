"""Helpers that test_torch_sde.py, test_torch_sde_discretization.py share."""
import torch

import parallel_gps_tpu.kernels as jk
from parallel_gps_torch import kernels as tk


KERNELS = [
    ("Matern12", 1.3, 0.7),
    ("Matern32", 1.1, 0.5),
    ("Matern52", 0.8, 0.4),
]
IDS = [k for k, _, _ in KERNELS]


def _pair(name, v, ell):
    return getattr(jk, name)(v, ell), getattr(tk, name)(v, ell, dtype=torch.float64, device="cpu")
