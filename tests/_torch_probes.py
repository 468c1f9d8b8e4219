"""Helpers that test_torch_probes_cli.py, test_torch_probes_grid.py,
test_torch_probes_kernels.py share."""
import numpy as np
import torch


T = 4099  # a multiple of no tile or chunk


def _rows(n, T_, seed):
    return np.random.RandomState(seed).rand(n, T_)


def _t(x):
    return torch.tensor(x, dtype=torch.float64)
