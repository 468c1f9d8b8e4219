from parallel_gps_torch.kalman import dt, timelast
from parallel_gps_torch.kalman.dt import (
    LAUNCHES,
    dt_fisher,
    dt_fisher_plain,
    lml_dt,
    pkf_dt,
    pkfs_dt,
    strip_filter_dt,
    strip_filter_dt_plain,
    strip_smoother_dt,
    strip_smoother_dt_plain,
)

__all__ = [
    "dt",
    "timelast",
    "LAUNCHES",
    "dt_fisher",
    "dt_fisher_plain",
    "lml_dt",
    "pkf_dt",
    "pkfs_dt",
    "strip_filter_dt",
    "strip_filter_dt_plain",
    "strip_smoother_dt",
    "strip_smoother_dt_plain",
]
