"""Global configuration (counterpart: parallel_gps_tpu/config.py).

The JAX package's Pallas switches have no counterpart here: the dt-engine
entry points dispatch on the device of the tensors they are given
(``kalman/dt.py``).

The port runs on the card: an entry point that creates tensors and is given
``device=None`` puts them on ``default_device()``, and raises when there is
no card instead of carrying on on the CPU.  The CPU is for the tests and
must be asked for (``device="cpu"``).
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


def default_device() -> torch.device:
    """The device of every entry point that is given ``device=None``."""
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """``device`` itself, or ``default_device()`` for ``None``; raises when
    the default is needed and no CUDA device is available."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            'no CUDA device is available and none other was named: pass device="cpu" to run on the CPU'
        )
    return default_device()
