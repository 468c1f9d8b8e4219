"""Dataset loaders for the experiments (sunspots, Mauna Loa CO2)
(counterpart: parallel_gps_tpu/datasets.py, of which this is a copy: plain
numpy, no torch).

Both datasets are public: SILSO monthly sunspot numbers (CSV with
``id,date,sunspots`` columns) and the NOAA GML Mauna Loa CO2 records
(``co2_weekly_mlo.txt``, ``co2_mm_mlo.txt``).  Loaders parse the standard
published formats (reference behavior: pssgp/experiments/sunspot/common.py:29-33,
pssgp/experiments/co2/common.py:31-51) with plain numpy — no pandas.

File discovery: explicit ``data_dir`` argument, else ``$PGPS_DATA_DIR``,
else ``./data`` relative to the CWD, else the repo-root ``data/`` next to
this package (the shipped copies).
"""
from __future__ import annotations

import os

import numpy as np

_SEARCH_ENV = "PGPS_DATA_DIR"


def _find(filename: str, data_dir: str | None) -> str:
    candidates = []
    if data_dir:
        candidates.append(os.path.join(data_dir, filename))
    env = os.environ.get(_SEARCH_ENV)
    if env:  # colon-separated list of directories
        candidates += [os.path.join(d, filename) for d in env.split(":") if d]
    candidates.append(os.path.join("data", filename))
    repo_data = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data")
    candidates.append(os.path.join(repo_data, filename))
    for c in candidates:
        if os.path.exists(c):
            return c
    raise FileNotFoundError(
        f"{filename} not found (searched {candidates}); pass data_dir= or "
        f"set ${_SEARCH_ENV}. Sunspots: SILSO monthly CSV; CO2: NOAA GML "
        "co2_weekly_mlo.txt / co2_mm_mlo.txt."
    )


def load_sunspots(
    n_training: int | None = None,
    data_dir: str | None = None,
    dtype=np.float64,
):
    """Monthly sunspot numbers; time in fractional years since the first
    observation.  Returns (t, y) column vectors of the last ``n_training``
    rows (all rows if None)."""
    path = _find("sunspots.csv", data_dir)
    dates, values = [], []
    with open(path) as fh:
        header = fh.readline().strip().split(",")
        date_col = header.index("date")
        val_col = header.index("sunspots")
        for line in fh:
            parts = line.strip().split(",")
            if len(parts) <= max(date_col, val_col):
                continue
            dates.append(np.datetime64(parts[date_col]))
            values.append(float(parts[val_col]))
    dates = np.asarray(dates)
    # fractional years: seconds since first observation / seconds per mean year
    t = (dates - dates[0]).astype("timedelta64[s]").astype("float64") / (
        365.2425 * 86400.0
    )
    y = np.asarray(values, dtype)
    t = t.astype(dtype)
    if n_training is not None:
        t, y = t[-n_training:], y[-n_training:]
    return t.reshape(-1, 1), y.reshape(-1, 1)


def load_co2(
    n_training: int | None = None,
    data_dir: str | None = None,
    dtype=np.float64,
):
    """Merged weekly+monthly Mauna Loa CO2 (decimal year, ppm), invalid
    (negative-sentinel) rows dropped, sorted by time.  Returns the last
    ``n_training`` (t, y) column vectors."""
    weekly_path = _find("co2_weekly_mlo.txt", data_dir)
    monthly_path = _find("co2_mm_mlo.txt", data_dir)
    weekly = np.loadtxt(weekly_path)[:, 3:5]
    monthly = np.loadtxt(monthly_path)[:, 2:4]
    data = np.concatenate([weekly, monthly], axis=0).astype(dtype)
    data = data[~np.any(data < 0, axis=1)]
    data = data[np.argsort(data[:, 0], kind="stable")]
    if n_training is not None:
        data = data[-n_training:]
    return data[:, 0:1], data[:, 1:2]
