"""Core container types (counterpart: parallel_gps_tpu/types.py).

NamedTuples of tensors.  The port carries only the time-last layout: the
time axis is the last axis of every per-step tensor.
"""
from __future__ import annotations

from typing import NamedTuple

from torch import Tensor


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
