"""Synthetic test-function generators (counterpart:
parallel_gps_tpu/toymodels.py).  Plain numpy on the host: they produce
experiment data, not computed-on-device quantities."""
from __future__ import annotations

from typing import Optional

import numpy as np


def sinu(t: np.ndarray) -> np.ndarray:
    """sin(πt) + sin(2πt) + cos(3πt)."""
    return np.sin(np.pi * t) + np.sin(2 * np.pi * t) + np.cos(3 * np.pi * t)


def comp_sinu(t: np.ndarray) -> np.ndarray:
    """Composite sinusoid, hard for stationary GPs."""
    return np.sin(7 * np.pi * np.cos(2 * np.pi * t**2)) ** 2 / (np.cos(5 * np.pi * t) + 2)


def rect(t: np.ndarray) -> np.ndarray:
    """Magnitude-varying rectangle wave."""
    tau = (t - np.min(t)) / (np.max(t) - np.min(t))
    p = np.linspace(1 / 6, 5 / 6, 5)
    y = np.zeros(t.shape)
    y[(tau >= p[0]) & (tau < p[1])] = 1.0
    y[(tau >= p[2]) & (tau < p[3])] = 0.6
    y[tau >= p[4]] = 0.4
    return y


def obs_noise(x: np.ndarray, r: float, seed: Optional[int] = None) -> np.ndarray:
    """Observation noise as the reference experiments draw it: the noise is
    sampled as ``normal(loc=x, scale=sqrt(r))``, scaled by ``sqrt(r)`` and
    added to x — so y ≈ (1 + sqrt(r))·x + r·eps — which keeps datasets
    comparable with the JAX package's."""
    rng = np.random.RandomState(seed)
    return x + np.sqrt(r) * rng.normal(x, np.sqrt(r), x.shape[0]).astype(x.dtype)
