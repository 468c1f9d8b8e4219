"""Positivity transforms (counterpart: parallel_gps_tpu/models/params.py:32-39).

Positive hyperparameters are stored unconstrained and mapped through
softplus, as the JAX package does for training and sampling.
"""
from __future__ import annotations

import torch
from torch import Tensor


def softplus(x: Tensor) -> Tensor:
    """log(1 + eˣ), exact at every x (``torch.nn.functional.softplus``
    switches to the identity above a threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def inv_softplus(y: Tensor) -> Tensor:
    """Stable inverse: y + log(1 − e⁻ʸ) = y + log(−expm1(−y))."""
    y = torch.as_tensor(y)
    return y + torch.log(-torch.expm1(-y))
