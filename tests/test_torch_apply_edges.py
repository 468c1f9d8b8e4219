"""PyTorch port vs the JAX package at the edges of the staged filter apply.

On the card, ``dt_filter_apply`` stages its stores a warp at a time: 8
(float32) or 4 (float64) steps of the warp's 32 chunks of ``CHUNK`` steps,
128 chunks a block.  ``chip_smoke.py`` holds that kernel against the plain
filter at the lengths where the staging has ragged edges; these tests hold
the plain versions it is held against, on the CPU, f64:

  - the plain chunked passes (chunk totals, exclusive chunk prefixes, the
    seeded re-fold) compose to the plain filter at one warp of chunks
    (T = 2,048) and one chunk past it (T = 2,053: a short last round), one
    step short of a block of chunks (T = 8,191), at one block (T = 8,192) and
    one 5-step chunk past it (T = 8,197);
  - the port's filter at T = 8,197 matches the JAX package's time-last
    engine, the reference its dt kernels are held against in
    test_pallas_dt.py, to that file's tolerances.

Inputs are made from a seed with numpy and handed to both packages; the JAX
engine's model is the port's time-last planes as numpy arrays (the JAX
package builds the same model eagerly in ~6 s on the CPU, over this file's
budget).
"""
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from parallel_gps_torch import kernels as tk
from parallel_gps_torch.kalman import dt as tdt
from parallel_gps_tpu.kalman.timelast import pkf_from_tl
from parallel_gps_tpu.types import LGSSMTL as JaxLGSSMTL
from _torch_common import jit_o0

torch.set_num_threads(1)

WARP_CHUNKS = 32 * tdt.CHUNK  # steps of one warp's chunks
BLOCK_CHUNKS = 128 * tdt.CHUNK  # steps of one block's chunks


def _data(T, seed):
    rng = np.random.RandomState(seed)
    t = np.sort(rng.rand(T))
    y = np.sin(12.0 * t) + 0.3 * rng.randn(T)
    y[rng.choice(T, T // 9, replace=False)] = np.nan
    return t, y


def _kernel():
    return tk.Matern52(0.8, 0.4, dtype=torch.float64, device="cpu")


def _R():
    return torch.tensor([[0.1]], dtype=torch.float64)


def _inputs(t, y):
    """(family, coeffs, P0, H, R, dts, y) of Matern52(0.8, 0.4), noise 0.1,
    f64 on the CPU."""
    kern = _kernel()
    with torch.no_grad():
        family, coeffs = kern.transition_coeffs()
        sde = kern.get_sde()
    return family, coeffs, sde.P0, sde.H, _R(), tdt._dts_from_ts(torch.tensor(t)), torch.tensor(y)


def _chunked_filter(fam, co, P0, H, R, dts, y):
    """The plain versions of the filter's kernel passes, composed as the
    kernels are on the card."""
    tot = tdt.dt_filter_scan(fam, co, P0, H, R, dts, y)
    assert tot.shape == (tdt.filt_rows(3), tdt.n_chunks(dts.shape[0]))
    pre = tdt.exclusive_chunk_prefixes(tot, 3, reverse=False)
    return tdt.dt_filter_apply(fam, co, P0, H, R, dts, y, pre)


@pytest.mark.parametrize(
    "T", [WARP_CHUNKS, WARP_CHUNKS + 5, BLOCK_CHUNKS - 1, BLOCK_CHUNKS, BLOCK_CHUNKS + 5], ids=lambda T: f"T{T}"
)
def test_chunked_filter_passes_compose_to_the_plain_filter(T):
    """Chunk totals, exclusive prefixes and the seeded re-fold give the plain
    filter's moments and log-likelihood where the staged apply's warps and
    blocks end, to the tolerances of test_torch_dt_passes.py's shorter
    cases."""
    args = _inputs(*_data(T, 11))
    with torch.no_grad():
        b0, C0, ell0 = tdt.strip_filter_dt_plain(*args)
        b, C, ell = _chunked_filter(*args)
    npt.assert_allclose(b.numpy(), b0.numpy(), rtol=1e-10, atol=1e-12)
    npt.assert_allclose(C.numpy(), C0.numpy(), rtol=1e-10, atol=1e-12)
    npt.assert_allclose(float(ell), float(ell0), rtol=1e-12)


@jit_o0
def _jax_filter(ssm, ys):
    return pkf_from_tl(ssm, ys, True)


def test_filter_past_one_block_matches_jax_time_last_engine():
    """The port's filter, plain and as its chunked passes, against the JAX
    time-last engine at T = 8,197 (one block of chunks and a 5-step chunk),
    to test_pallas_dt.py's tolerances (filter 1e-9 / 1e-10, LML 1e-10)."""
    T = BLOCK_CHUNKS + 5
    t, y = _data(T, 12)
    with torch.no_grad():
        planes = _kernel().get_ssm_tl(torch.tensor(t), _R())
    ssm = JaxLGSSMTL(*(jnp.asarray(x.numpy()) for x in planes))
    b_x, C_x, ell_x = _jax_filter(ssm, jnp.asarray(y).reshape(-1, 1))
    args = _inputs(t, y)
    with torch.no_grad():
        port = tdt.strip_filter_dt(*args)
        chunked = _chunked_filter(*args)
    for b, C, ell in (port, chunked):
        npt.assert_allclose(b.numpy(), np.asarray(b_x), rtol=1e-9, atol=1e-10)
        npt.assert_allclose(C.numpy(), np.asarray(C_x), rtol=1e-9, atol=1e-10)
        npt.assert_allclose(float(ell), float(ell_x), rtol=1e-10)
