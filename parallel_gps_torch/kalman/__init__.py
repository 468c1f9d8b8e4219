from parallel_gps_torch.kalman import batched, dt, parallel, sequential, strip, timelast
from parallel_gps_torch.kalman.batched import (
    batched_strip_filter,
    batched_strip_filter_plain,
    batched_strip_smoother,
    batched_strip_smoother_plain,
)
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
from parallel_gps_torch.kalman.parallel import pkf, pkfs, pks
from parallel_gps_torch.kalman.sequential import kf, kfs, ks
from parallel_gps_torch.kalman.strip import strip_filter, strip_filter_plain, strip_smoother, strip_smoother_plain
from parallel_gps_torch.kalman.timelast import lml_tl, pkf_from_tl, pkfs_from_tl, pks_from_tl

__all__ = [
    "batched",
    "batched_strip_filter",
    "batched_strip_filter_plain",
    "batched_strip_smoother",
    "batched_strip_smoother_plain",
    "dt",
    "parallel",
    "sequential",
    "strip",
    "timelast",
    "LAUNCHES",
    "dt_fisher",
    "dt_fisher_plain",
    "kf",
    "kfs",
    "ks",
    "lml_dt",
    "lml_tl",
    "pkf",
    "pkf_dt",
    "pkf_from_tl",
    "pkfs",
    "pkfs_dt",
    "pkfs_from_tl",
    "pks",
    "pks_from_tl",
    "strip_filter",
    "strip_filter_dt",
    "strip_filter_dt_plain",
    "strip_filter_plain",
    "strip_smoother",
    "strip_smoother_dt",
    "strip_smoother_dt_plain",
    "strip_smoother_plain",
]
