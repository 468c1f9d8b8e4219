"""Core container types (counterpart: parallel_gps_tpu/types.py).

NamedTuples of tensors.  ``LGSSM`` is the reference layout (time first);
``LGSSMTL`` keeps the time axis last, which is what the parallel engines and
the CUDA kernels read.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import Tensor

from parallel_gps_torch import config


class LGSSM(NamedTuple):
    """Discrete linear-Gaussian state-space model over T steps, time first.

    The initial mean is implicitly zero.  The sequential and the generic
    parallel engines accept m observation rows (``H (m, d)``, ``R (m, m)``,
    observations ``(T, m)``); the time-last and strip engines take m = 1.
    A step with any NaN component counts as missing.

    Attributes:
      P0: (d, d) initial state covariance.
      Fs: (T, d, d) per-step transition matrices.
      Qs: (T, d, d) per-step process-noise covariances.
      H:  (m, d) shared observation matrix.
      R:  (m, m) observation-noise covariance.
    """

    P0: Tensor
    Fs: Tensor
    Qs: Tensor
    H: Tensor
    R: Tensor


class LGSSMTL(NamedTuple):
    """Time-last discrete linear-Gaussian state-space model over T steps.

    The initial mean is implicitly zero.

    Attributes:
      P0: (d, d) initial state covariance.
      Fs: (d, d, T) per-step transition matrices.
      Qs: (d, d, T) per-step process-noise covariances.
      H:  (1, d) shared observation row.
      R:  (1, 1) observation-noise covariance.
    """

    P0: Tensor
    Fs: Tensor
    Qs: Tensor
    H: Tensor
    R: Tensor


class ContinuousDiscreteModel(NamedTuple):
    """LTI SDE ``dx = F x dt + L dW`` with spectral density Q and readout H.

    Attributes:
      P0: (d, d) stationary covariance, solving ``F P + P Fᵀ + L Q Lᵀ = 0``.
      F:  (d, d) drift matrix.
      L:  (d, m) diffusion selection matrix.
      H:  (1, d) observation row.
      Q:  (m, m) white-noise spectral density.
    """

    P0: Tensor
    F: Tensor
    L: Tensor
    H: Tensor
    Q: Tensor


def lgssm_from_numpy(P0, Fs, Qs, H, R, time_last: bool, dtype=None, device=None):
    """An ``LGSSMTL`` (``time_last``; Fs, Qs given as (d, d, T)) or an
    ``LGSSM`` (Fs, Qs given as (T, d, d)) from numpy arrays: the fields of a
    model built elsewhere, so that both compute the same thing.
    ``device=None`` is the card (``config.resolve_device``)."""
    dtype = dtype or config.default_float()
    device = config.resolve_device(device)
    leaves = [torch.tensor(np.asarray(x)).to(dtype=dtype, device=device) for x in (P0, Fs, Qs, H, R)]
    d = leaves[0].shape[0]
    T = leaves[1].shape[-1 if time_last else 0]
    want = (d, d, T) if time_last else (T, d, d)
    for name, x in (("Fs", leaves[1]), ("Qs", leaves[2])):
        if tuple(x.shape) != want:
            raise ValueError(f"{name} must have shape {want} for time_last={time_last}, got {tuple(x.shape)}")
    return (LGSSMTL if time_last else LGSSM)(*leaves)
