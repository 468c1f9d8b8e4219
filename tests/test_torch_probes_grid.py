"""The port's tile-cost probe (parallel_gps_torch/probes/grid.py, kernels in
csrc/probes.cu) on the CPU: each plain version against a numpy restatement of
the Pallas body it replaces in scripts/bench_grid_isolation.py (the bodies
are closures inside the script's ``main()`` and cannot be imported).  f64,
T of a few thousand."""
import math

import numpy as np
import numpy.testing as npt
import pytest
import torch

from parallel_gps_torch.probes import grid
from _torch_probes import T, _rows, _t

torch.set_num_threads(1)


@pytest.mark.parametrize("kernel", ["noop", "stream3", "stream22", "outwrite12", "carry33"])
@pytest.mark.parametrize("tile", [256, 1024])
def test_tile_plain_versions_are_the_grid_kernels(kernel, tile):
    """bench_grid_isolation.py: k_noop (:102) writes ones; k_stream (:105)
    sums the tile's rows (there only its first 128 lanes; here every value);
    k_outwrite (:123) writes row 0 to 12 rows; k_carry (:109) adds k to carry
    value k at every grid step, so it ends at k · n_tiles — here each tile
    also writes its sum plus carry value 32.  Sums to rtol 1e-12."""
    n = math.ceil(T / tile)
    x = _rows(22, T, 5)
    sums = lambda rows: np.array([rows[:, i : i + tile].sum() for i in range(0, T, tile)])  # noqa: E731
    if kernel == "noop":
        out = grid.tile_noop(torch.zeros(n, dtype=torch.float64))
        npt.assert_array_equal(out.numpy(), np.ones(n))
    elif kernel.startswith("stream"):
        r = int(kernel[len("stream"):])
        npt.assert_allclose(grid.tile_stream(_t(x[:r]), tile).numpy(), sums(x[:r]), rtol=1e-12)
    elif kernel == "outwrite12":
        rows12, parts = grid.tile_outwrite(_t(x[:3]), tile)
        npt.assert_array_equal(rows12.numpy(), np.repeat(x[:1], 12, axis=0))
        npt.assert_allclose(parts.numpy(), sums(x[:3]), rtol=1e-12)
    else:
        carry = np.zeros(33)
        outs = []
        for b in range(n):
            carry = carry + np.arange(33)
            outs.append(x[0, b * tile : (b + 1) * tile].sum() + carry[32])
        out, c = grid.tile_carry(_t(x[0]), tile)
        npt.assert_array_equal(c.numpy(), carry)
        npt.assert_array_equal(c.numpy(), np.arange(33) * n)
        npt.assert_allclose(out.numpy(), outs, rtol=1e-12)
