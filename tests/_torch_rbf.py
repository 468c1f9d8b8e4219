"""Helpers that test_torch_rbf_sde.py, test_torch_rbf_transitions.py share."""
import numpy as np
import numpy.testing as npt
import torch

import parallel_gps_tpu.kernels as jk
from parallel_gps_torch.kernels import RBF


ORDERS = [3, 4, 6, 8]


def _pair(order, variance=1.3, lengthscale=0.37, balancing_iter=5):
    jkern = jk.RBF(variance=variance, lengthscales=lengthscale, order=order, balancing_iter=balancing_iter)
    tkern = RBF(variance, lengthscale, order=order, balancing_iter=balancing_iter, dtype=torch.float64, device="cpu")
    return jkern, tkern


def _close(a, ref, rtol=1e-9):
    """rtol against each entry, with an absolute floor of rtol times the
    tensor's largest entry (the matrices span many orders of magnitude)."""
    ref = np.asarray(ref)
    npt.assert_allclose(a.detach().numpy(), ref, rtol=rtol, atol=rtol * np.abs(ref).max())
