"""How the chained chunk prefix makes C and J symmetric
(``plane.chained_plain_scan``, ``plane.SYM_FORMS``).

Between the two passes of the dt and strip engines the chunk totals are
scanned by one chained ``plane_scan`` launch: Kogge–Stone inside tiles of 32
totals at d = 8 float32, then each tile combined with the inclusive total of
the tile before it.  Its filter combine (csrc/tile_scan.cuh: FilterOps) once
mirrored the upper triangle of C and J, as the reference's sequential fold
does; in the chained association, on the float32 totals of the quasi-periodic
model (Periodic(order=1) × Matern32, d = 8) at the spacing of a 1M-step
series, that form loses every digit, where averaging the two triangles (the
plain operator's form, and the kernel's now) keeps the plain Kogge–Stone
scan's accuracy.  These tests hold, on the CPU:

  - the plain model of the chained association against the plain scan in
    float64, in both forms, at tiles of 1 (the sequential fold), 4 and 32;
  - on the QP model's float32 filter totals of 1,024 chunks (the plain
    pass 1, data made from a seed with numpy as chip_smoke.py makes the 1M
    series, its first 65,536 steps), against the float64 scan of the same
    totals: the mirrored form misses the port's float32 rule (within 10× of
    the plain float32 scan's distance, or 1e-5), the averaged form meets it.

No JAX: the reference's fold has no chained counterpart.  The totals of the
QP model take most of the file's time (~8 s on one thread).
"""
import numpy as np
import pytest
import torch

from parallel_gps_torch import StateSpaceGP
from parallel_gps_torch import kernels as tk
from parallel_gps_torch.kalman import dt as tdt
from parallel_gps_torch.kalman import plane as tplane
from parallel_gps_torch.kalman import strip as tstrip

torch.set_num_threads(1)

NOISE = 0.1
F32_FACTOR, F32_FLOOR = 10.0, 1e-5
N_SERIES = 1_000_000  # the spacing: the first steps of a series of this length
N_CHUNKS = 1_024
TILE = 32  # plane.scan_tiling(8, float32): 32 threads, one step each
QP_SPEC = ("Product", [
    ("Periodic", {"variance": 1.0, "lengthscales": 1.0, "period": 1.0, "order": 1}),
    ("Matern32", {"variance": 1.0, "lengthscales": 1.0}),
])


def _series(T: int, n: int, seed: int):
    """The first n steps of chip_smoke.make_data(T, seed): sorted times in
    [0, 1), y = sin(12 t) + noise, ~10% NaN."""
    rng = np.random.RandomState(seed)
    t = np.sort(rng.rand(T))
    y = np.sin(12.0 * t) + np.sqrt(NOISE) * rng.randn(T)
    y[rng.rand(T) < 0.1] = np.nan
    return t[:n], y[:n]


def _moment_err(scan, truth, d):
    """Largest error of b and C over the chunks, relative to each
    component's largest value (chip_smoke.qp_prefix_precision)."""
    rows = slice(d * d, 2 * d * d + d)
    scale = truth[rows].abs().amax(1, keepdim=True).clamp_min(1e-300)
    return float(((scan[rows].double() - truth[rows]).abs() / scale).max())


@pytest.fixture(scope="module")
def qp_scans():
    """{form or "plain": error against the float64 scan} of the QP model's
    float32 filter chunk totals."""
    t, y = _series(N_SERIES, N_CHUNKS * tstrip.CHUNK, seed=9)
    model = StateSpaceGP.from_numpy(t, y, QP_SPEC, noise_variance=NOISE, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        fam, co, sde, dts = tdt._model_inputs(model.kernel, model.ts)
        R = model.noise_variance.reshape(1, 1)
        tot = tdt.dt_filter_scan_plain(fam, co, sde.P0, sde.H, R, dts, model.ys)
        d = sde.P0.shape[0]
        truth = tplane.plane_scan_plain(tot.double(), d, "filter")
        errs = {"plain": _moment_err(tplane.plane_scan_plain(tot, d, "filter"), truth, d)}
        for form in tplane.SYM_FORMS:
            errs[form] = _moment_err(tplane.chained_plain_scan(tot, d, TILE, form), truth, d)
    assert d == 8 and tot.shape[1] == N_CHUNKS and tot.dtype == torch.float32
    return errs


@pytest.mark.parametrize("form", sorted(tplane.SYM_FORMS))
@pytest.mark.parametrize("tile", [1, 4, 32])
def test_chained_plain_scan_is_the_scan_in_float64(tile, form):
    """Matern52 filter totals of 40 chunks and a ragged one, float64: any
    tile, either form, is the plain scan to rounding; a tile of one is the
    sequential fold."""
    rng = np.random.RandomState(3)
    T = 40 * tstrip.CHUNK + 5
    t = np.sort(rng.rand(T))
    y = np.sin(12.0 * t) + 0.3 * rng.randn(T)
    with torch.no_grad():
        ssm = tk.Matern52(0.8, 0.4, dtype=torch.float64, device="cpu").get_ssm_tl(
            torch.tensor(t), torch.tensor([[NOISE]], dtype=torch.float64)
        )
        tot = tstrip.strip_filter_scan_plain(ssm.Fs, ssm.Qs, ssm.P0, ssm.H, ssm.R, torch.tensor(y))
        got = tplane.chained_plain_scan(tot, 3, tile, form)
        want = tplane.plane_scan_plain(tot, 3, "filter")
        if tile == 1:
            fold, op = [tot[:, :1]], tplane.functools.partial(tplane.filtering_operator_tl, sym=tplane.SYM_FORMS[form])
            for k in range(1, tot.shape[1]):
                fold.append(tstrip._pack(op(tstrip._unpack_filt(fold[-1], 3), tstrip._unpack_filt(tot[:, k : k + 1], 3)), 1))
            assert torch.equal(got, torch.cat(fold, 1))
    torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-12)


def test_mirror_upper_mirrors_the_upper_triangle():
    x = torch.arange(2 * 3 * 3, dtype=torch.float64).reshape(3, 3, 2).permute(0, 1, 2)
    m = tplane.mirror_upper(x)
    for i in range(3):
        for j in range(3):
            assert torch.equal(m[i, j], x[min(i, j), max(i, j)])


def test_mirrored_chained_prefix_misses_the_float32_rule(qp_scans):
    assert qp_scans["mirrored"] > F32_FACTOR * max(qp_scans["plain"], F32_FLOOR), qp_scans


def test_averaged_chained_prefix_meets_the_float32_rule(qp_scans):
    assert qp_scans["averaged"] <= F32_FACTOR * max(qp_scans["plain"], F32_FLOOR), qp_scans
