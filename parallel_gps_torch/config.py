"""Global configuration (counterpart: parallel_gps_tpu/config.py).

The JAX package's Pallas switches have no counterpart here: the dt-engine
entry points dispatch on the device of the tensors they are given
(``kalman/dt.py``).
"""
from __future__ import annotations

import torch

# Number of diagonal-similarity balancing iterations used when compiling
# kernels to SDE form (reference: pssgp/config.py:6).
NUMBER_OF_BALANCING_STEPS: int = 10


def default_float() -> torch.dtype:
    """Default floating dtype: PyTorch's default dtype (float32 unless the
    caller has set ``torch.set_default_dtype(torch.float64)``)."""
    return torch.get_default_dtype()
