"""parallel-gps-torch: the PyTorch / CUDA port of parallel-gps-tpu.

State-space Gaussian-process regression for stationary kernels: the kernel is
compiled to a linear-Gaussian state-space model and solved by a parallel
(associative-scan) Kalman filter and smoother, and trained on the LML's
Fisher-identity gradients (``inference``).  On a CUDA device the scan passes
of the dt-engine and of the plane-streaming strip engine, and the Fisher tail
of the dt-engine's backward, run as hand-written CUDA kernels
(``kalman/dt.py``, ``kalman/strip.py``, ``csrc/``); on the CPU the same
functions run their plain PyTorch versions.  ``kalman.pkf`` / ``pks`` /
``pkfs`` filter and smooth an explicit state-space model (``LGSSM``,
``LGSSMTL``).  Entry points build on the card unless the caller passes
``device="cpu"``.

The JAX package ``parallel_gps_tpu`` is the reference this package is tested
against; module names follow it where that helps find the counterpart.
"""
# ``models`` first: it loads ``models.params`` before the kernels that use it.
from parallel_gps_torch import models  # isort: skip
from parallel_gps_torch import config, inference, kalman, kernels, ops
from parallel_gps_torch.models import StateSpaceGP
from parallel_gps_torch.types import LGSSM, LGSSMTL, ContinuousDiscreteModel, lgssm_from_numpy

__version__ = "0.1.0"

__all__ = [
    "config",
    "inference",
    "kalman",
    "kernels",
    "models",
    "ops",
    "StateSpaceGP",
    "LGSSM",
    "LGSSMTL",
    "ContinuousDiscreteModel",
    "lgssm_from_numpy",
]
