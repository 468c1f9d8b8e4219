"""Toy-model data protocol (counterpart:
parallel_gps_tpu/experiments/toy_models/common.py): a [0, 4] uniform grid,
one of three synthetic functions, Gaussian noise.  Plain numpy."""
from __future__ import annotations

import enum

import numpy as np

from parallel_gps_torch.toymodels import comp_sinu, obs_noise, rect, sinu


class DataEnum(enum.Enum):
    SINE = "SINE"
    COMPOSITE_SINE = "COMPOSITE_SINE"
    RECT = "RECT"

    @classmethod
    def _missing_(cls, value):
        # Launch scripts pass lowercase names (--data-model sine).
        if isinstance(value, str):
            upper = value.upper()
            for member in cls:
                if member.value == upper:
                    return member
        return None


_FUNCS = {DataEnum.SINE: sinu, DataEnum.COMPOSITE_SINE: comp_sinu, DataEnum.RECT: rect}


def get_data(seed: int, n_training: int, n_pred: int, data_model: str = "SINE", noise_variance: float = 0.5, dtype=np.float64):
    """Returns (t, ft, t_pred, ft_pred, y) column vectors."""
    t = np.linspace(0, 4, n_training, dtype=dtype)
    t_pred = np.linspace(0, 4, n_pred, dtype=dtype)
    fun = _FUNCS[DataEnum(data_model)]
    ft, ft_pred = fun(t), fun(t_pred)
    y = obs_noise(ft, noise_variance, seed)
    return t.reshape(-1, 1), ft.reshape(-1, 1), t_pred.reshape(-1, 1), ft_pred.reshape(-1, 1), y.reshape(-1, 1)
