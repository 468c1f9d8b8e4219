"""Small metric and plot helpers (counterpart: parallel_gps_tpu/misc_utils.py).

matplotlib is imported inside the function that draws, so that a machine
without it (the card's) runs everything else.
"""
from __future__ import annotations

import numpy as np


def _np(x) -> np.ndarray:
    """A tensor (any device) or an array-like as a flat numpy array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x).reshape(-1)


def rmse(y_pred, y_true) -> float:
    """Root-mean-square error."""
    y_pred, y_true = _np(y_pred), _np(y_true)
    return float(np.sqrt(np.mean((y_pred - y_true) ** 2)))


def error_shade(ax, t, mean, var, color="C0", alpha=0.25, label=None):
    """Shade the 95% credible interval mean ± 1.96·std on a matplotlib axis."""
    import matplotlib  # noqa: F401  (the axis is matplotlib's; fail here, not in fill_between, without it)

    t, mean = _np(t), _np(mean)
    std = np.sqrt(_np(var))
    lo, hi = mean - 1.96 * std, mean + 1.96 * std
    ax.fill_between(t, lo, hi, color=color, alpha=alpha, label=label)
    return ax
