"""Small-matrix helpers (counterpart: parallel_gps_tpu/ops/linalg.py)."""
from __future__ import annotations

from torch import Tensor


def symmetrize(P: Tensor) -> Tensor:
    """0.5 (P + Pᵀ) over the trailing two axes."""
    return 0.5 * (P + P.transpose(-1, -2))
