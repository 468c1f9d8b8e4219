"""PyTorch port: the any-d time-last inverse that the strip engine's combine
takes (kalman/timelast.py::_inv) against numpy; f64 on the CPU."""
import numpy as np
import numpy.testing as npt
import pytest
import torch

from parallel_gps_torch.kalman import timelast as ttl

torch.set_num_threads(1)


@pytest.mark.parametrize("d", range(1, 9), ids=lambda d: f"d{d}")
def test_schur_inverse_matches_numpy(d):
    """The any-d time-last inverse (closed forms for d ≤ 3, Schur recursion
    above) on the I + PSD·PSD family the combine inverts, over a trailing
    axis (counterpart of test_list_schur_inverse_matches_numpy)."""
    rng = np.random.RandomState(d)
    A = rng.randn(5, d, d)
    M = np.eye(d) + 0.3 * A @ A.transpose(0, 2, 1)
    got = ttl._inv(torch.tensor(M).permute(1, 2, 0)).permute(2, 0, 1)
    npt.assert_allclose(got.numpy(), np.linalg.inv(M), rtol=1e-9, atol=1e-11)
