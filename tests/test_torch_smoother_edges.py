"""PyTorch port vs the JAX package at the edges of the staged smoother apply
and of the plane scan's tiles.

On the card, ``dt_smoother_apply`` stages its loads and stores a warp at a
time: 8 (float32) or 4 (float64) steps of the warp's 32 chunks of ``CHUNK``
steps, 128 chunks a block, walked from the chunks' ends; ``plane_scan``
takes tiles of threads × steps a thread (128 × 4 at d = 3 float32).
``chip_smoke.py`` holds those kernels against their plain versions at the
lengths where the tiling has ragged edges; these tests hold the plain
versions they are held against, on the CPU, f64:

  - the plain chunked smoother passes (suffix totals, exclusive chunk
    suffixes, the seeded reverse re-fold) against the jitted JAX time-last
    smoother at one step, a chunk less one, one chunk, a chunk and a step,
    and a block of chunks and a step (T = 8,193), on Matern12/32/52 models;
  - the same passes against the plain smoother at a warp's and a block's
    chunks and past them;
  - the time-first plane path (``pkf`` / ``pkfs(LGSSM, engine="strip")``)
    one step past a tile of 512 against the JAX time-last engine.

Inputs are made from a seed with numpy; each model is built by the port and
handed to JAX as numpy arrays.  The JAX smoother is one compiled program a
kernel: each series is smoothed at the end of an 8,193-step series whose
first steps are padding, as a smoother's value at a step depends only on
that step's filtered moments and the steps after it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from parallel_gps_torch import kernels as tk
from parallel_gps_torch.kalman import dt as tdt
from parallel_gps_torch.kalman.parallel import pkf, pkfs
from parallel_gps_torch.types import LGSSM
from parallel_gps_tpu.kalman.timelast import pkf_from_tl, pks_from_tl
from parallel_gps_tpu.types import LGSSMTL as JaxLGSSMTL

torch.set_num_threads(1)

WARP_CHUNKS = 32 * tdt.CHUNK  # steps of one warp's chunks
BLOCK_CHUNKS = 128 * tdt.CHUNK  # steps of one block's chunks
SMOOTHER_T = (1, tdt.CHUNK - 1, tdt.CHUNK, tdt.CHUNK + 1, BLOCK_CHUNKS + 1)
PADDED_T = BLOCK_CHUNKS + 1  # the JAX smoother's length
PLANE_TILE = 128 * 4  # the plane scan's tile at d = 3 float32 on the card
KERNELS = [(tk.Matern12, (1.2, 0.6)), (tk.Matern32, (1.0, 0.5)), (tk.Matern52, (0.8, 0.4))]
# test_pallas_dt.py:86-87, the JAX dt smoother's tolerances.
SMOOTHER_TOL = dict(rtol=1e-8, atol=1e-9)


def _data(T, seed):
    rng = np.random.RandomState(seed)
    t = np.sort(rng.rand(T))
    y = np.sin(12.0 * t) + 0.3 * rng.randn(T)
    y[rng.choice(T, T // 9, replace=False)] = np.nan
    return t, y


def _R():
    return torch.tensor([[0.1]], dtype=torch.float64)


def _filtered(kern, t, y):
    """The model's (family, coeffs, P0, dts) and the plain filter's (b, C)."""
    with torch.no_grad():
        family, coeffs = kern.transition_coeffs()
        sde = kern.get_sde()
        dts = tdt._dts_from_ts(torch.tensor(t))
        b, C, _ = tdt.strip_filter_dt_plain(family, coeffs, sde.P0, sde.H, _R(), dts, torch.tensor(y))
    return (family, coeffs, sde.P0, dts), b, C


def _chunked_smoother(family, coeffs, P0, dts, b, C):
    """The plain versions of the smoother's kernel passes, composed as the
    kernels are on the card."""
    with torch.no_grad():
        tot = tdt.dt_smoother_scan_plain(family, coeffs, P0, dts, b, C)
        assert tot.shape == (tdt.smooth_rows(P0.shape[0]), tdt.n_chunks(dts.shape[0]))
        pre = tdt.exclusive_chunk_prefixes(tot, P0.shape[0], reverse=True)
        return tdt.dt_smoother_apply_plain(family, coeffs, P0, dts, b, C, pre)


@jax.jit
def _jax_smoother(ssm, b, C):
    return pks_from_tl(ssm, b, C)


def _jax_smoothed(kern, t, b, C):
    """The JAX time-last smoother of the port's planes and filtered moments,
    after leading steps of padding (copies of the first step) up to
    PADDED_T."""
    with torch.no_grad():
        planes = kern.get_ssm_tl(torch.tensor(t), _R())
    pad = PADDED_T - len(t)
    lead = lambda x: np.concatenate([np.repeat(x[..., :1], pad, -1), x], -1)  # noqa: E731
    ssm = JaxLGSSMTL(planes.P0.numpy(), *(lead(x.numpy()) for x in (planes.Fs, planes.Qs)), planes.H.numpy(), planes.R.numpy())
    g, L = _jax_smoother(ssm, lead(b.numpy()), lead(C.numpy()))
    return np.asarray(g)[..., pad:], np.asarray(L)[..., pad:]


@pytest.mark.parametrize("kcls,params", KERNELS, ids=["m12", "m32", "m52"])
def test_chunked_smoother_matches_jax_time_last_smoother(kcls, params):
    """At T = 1, 63, 64, 65 and 8,193, to test_pallas_dt.py's smoother
    tolerances (1e-8 / 1e-9)."""
    for T in SMOOTHER_T:
        kern = kcls(*params, dtype=torch.float64, device="cpu")
        t, y = _data(T, 20 + T)
        inputs, b, C = _filtered(kern, t, y)
        g, L = _chunked_smoother(*inputs, b, C)
        g_x, L_x = _jax_smoothed(kern, t, b, C)
        npt.assert_allclose(g.numpy(), g_x, **SMOOTHER_TOL, err_msg=f"T={T}")
        npt.assert_allclose(L.numpy(), L_x, **SMOOTHER_TOL, err_msg=f"T={T}")


@pytest.mark.parametrize(
    "T", [WARP_CHUNKS - 1, WARP_CHUNKS, WARP_CHUNKS + 5, BLOCK_CHUNKS - 1, BLOCK_CHUNKS, BLOCK_CHUNKS + 5],
    ids=lambda T: f"T{T}",
)
def test_chunked_smoother_passes_compose_to_the_plain_smoother(T):
    """Suffix totals, exclusive suffixes and the seeded reverse re-fold give
    the plain smoother's moments where the staged apply's warps and blocks
    end, to the tolerances of test_torch_dt_passes.py's shorter cases."""
    kern = tk.Matern52(0.8, 0.4, dtype=torch.float64, device="cpu")
    inputs, b, C = _filtered(kern, *_data(T, 13))
    g, L = _chunked_smoother(*inputs, b, C)
    with torch.no_grad():
        g0, L0 = tdt.strip_smoother_dt_plain(*inputs, b, C)
    npt.assert_allclose(g.numpy(), g0.numpy(), rtol=1e-10, atol=1e-12)
    npt.assert_allclose(L.numpy(), L0.numpy(), rtol=1e-10, atol=1e-12)


@jax.jit
def _jax_filter(ssm, ys):
    return pkf_from_tl(ssm, ys, True)[:2]


def test_plane_path_past_one_tile_matches_jax_time_last_engine():
    """``pkf`` and ``pkfs`` on a time-first Matern52 model with
    engine="strip" (the plane path: plain elements, one plane scan a pass)
    at T = 513, one step past a tile, against the JAX time-last engine on
    the same model: its filter, and its smoother on those filtered moments
    (the smoother compiled once, at the end of a padded series), to the
    filter (1e-9 / 1e-10) and smoother tolerances."""
    T = PLANE_TILE + 1
    t, y = _data(T, 14)
    kern = tk.Matern52(0.8, 0.4, dtype=torch.float64, device="cpu")
    with torch.no_grad():
        views = kern.get_ssm(torch.tensor(t), _R())
        ssm = LGSSM(views.P0, views.Fs.contiguous(), views.Qs.contiguous(), views.H, views.R)
        fms, fPs = pkf(ssm, torch.tensor(y), engine="strip")
        sms, sPs = pkfs(ssm, torch.tensor(y), engine="strip")
    planes = JaxLGSSMTL(*(np.asarray(x) for x in (ssm.P0, ssm.Fs.permute(1, 2, 0), ssm.Qs.permute(1, 2, 0), ssm.H, ssm.R)))
    b_x, C_x = (np.asarray(x) for x in _jax_filter(planes, jnp.asarray(y).reshape(-1, 1)))
    npt.assert_allclose(fms.numpy(), b_x.T, rtol=1e-9, atol=1e-10)
    npt.assert_allclose(fPs.numpy(), np.moveaxis(C_x, -1, 0), rtol=1e-9, atol=1e-10)
    g_x, L_x = _jax_smoothed(kern, t, torch.tensor(b_x), torch.tensor(C_x))
    npt.assert_allclose(sms.numpy(), g_x.T, **SMOOTHER_TOL)
    npt.assert_allclose(sPs.numpy(), np.moveaxis(L_x, -1, 0), **SMOOTHER_TOL)
