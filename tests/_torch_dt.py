"""Helpers that test_torch_dt_dispatch.py, test_torch_dt_passes.py share."""
import numpy as np
import torch

from parallel_gps_torch.kalman import dt as tdt


def _data(T, seed):
    rng = np.random.RandomState(seed)
    t = np.sort(rng.rand(T))
    y = np.sin(12.0 * t) + 0.3 * rng.randn(T)
    y[rng.choice(T, T // 9, replace=False)] = np.nan
    return t, y


def _torch_inputs(tkern, t, y):
    with torch.no_grad():
        family, coeffs = tkern.transition_coeffs()
        sde = tkern.get_sde()
    dts = tdt._dts_from_ts(torch.tensor(t))
    R = torch.tensor([[0.1]], dtype=torch.float64)
    return family, coeffs, sde.P0, sde.H, R, dts, torch.tensor(y)
