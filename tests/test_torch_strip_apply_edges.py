"""PyTorch port vs the JAX package at the edges of the staged strip applies,
and the strip applies' shared-memory budget.

On the card, ``strip_filter_apply`` and ``strip_smoother_apply`` stage their
rows a warp at a time: 8 (float32) or 4 (float64) steps of the warp's 32
chunks of ``CHUNK`` steps, in blocks of 32, 64 or 128 chunks, fixed for each
unit (state dimension, scalar type) by its shared-memory budget
(``strip.apply_stage``, the mirror of ``csrc/strip_scan.cu``'s ApplyStage).
``chip_smoke.py`` holds those kernels against their plain versions at every
d = 1..8 at the lengths where the staging has ragged edges; these tests hold
the plain versions they are held against, on the CPU, f64:

  - the plain chunked passes (chunk totals, exclusive chunk prefixes, the
    seeded re-fold) compose to the port's plain time-last filter and
    smoother (one Kogge–Stone scan over the whole series) at the edge
    lengths of the d = 3 and d = 6 units;
  - the port at d = 6 against the jitted JAX time-last engine;
  - the budget: every unit's stage fits a block's opt-in limit, its block
    leaves an SM the most warps, and the planes are staged only where they
    fit.

Inputs are made from a seed with numpy; each model is built by the port and
handed to JAX as numpy arrays.
"""
import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from parallel_gps_torch import kernels as tk
from parallel_gps_torch.kalman import strip as tstrip
from parallel_gps_torch.kalman import timelast as ttl
from parallel_gps_tpu.kalman.timelast import pkf_from_tl, pks_from_tl
from parallel_gps_tpu.types import LGSSMTL as JaxLGSSMTL

torch.set_num_threads(1)

KINDS = ("filter", "smoother")
DTYPES = (torch.float32, torch.float64)
# test_pallas_scan.py's tolerances (:88-90, :106-107 at d ≤ 3; :131-138
# above): filter rtol, atol, LML rtol, smoother rtol, atol.
TOLS = {3: (1e-9, 1e-10, 1e-10, 1e-8, 1e-9), 6: (1e-8, 1e-9, 1e-9, 1e-7, 1e-8)}


def _edge_lengths(d):
    """chip_smoke.strip_edge_lengths for both f64 units of dimension d: one
    step; a chunk less one, a chunk, a chunk and a step; a warp's chunks, a
    step and a chunk past them; a step short of the unit's block of chunks,
    the block and a 5-step chunk past it."""
    chunk, warp = tstrip.CHUNK, 32 * tstrip.CHUNK
    lengths = {1, chunk - 1, chunk, chunk + 1, warp, warp + 1, warp + chunk}
    for kind in KINDS:
        block = tstrip.apply_stage(d, torch.float64, kind)[0] * chunk
        lengths |= {block - 1, block, block + 5}
    return sorted(lengths)


def _data(T, seed):
    rng = np.random.RandomState(seed)
    t = np.sort(rng.rand(T))
    y = np.sin(12.0 * t) + 0.3 * rng.randn(T)
    y[rng.choice(T, T // 9, replace=False)] = np.nan
    return t, y


def _model(d, T, seed):
    """(LGSSMTL, y) f64 on the CPU: Matern52(0.8, 0.4) at d = 3, the
    RBF(1.0, 0.05, order=6) of chip_smoke.py's strip checks at d = 6; noise
    0.1."""
    t, y = _data(T, seed)
    kern = (
        tk.Matern52(0.8, 0.4, dtype=torch.float64, device="cpu")
        if d == 3
        else tk.RBF(1.0, 0.05, order=6, dtype=torch.float64, device="cpu")
    )
    with torch.no_grad():
        ssm = kern.get_ssm_tl(torch.tensor(t), torch.tensor([[0.1]], dtype=torch.float64))
    return ssm, torch.tensor(y)


def _chunked_filter(ssm, y):
    """The plain versions of the filter's kernel passes, composed as the
    kernels are on the card."""
    P0, Fs, Qs, H, R = ssm
    tot = tstrip.strip_filter_scan_plain(Fs, Qs, P0, H, R, y)
    assert tot.shape == (tstrip.filt_rows(P0.shape[0]), tstrip.n_chunks(y.shape[0]))
    pre = tstrip.exclusive_chunk_prefixes(tot, P0.shape[0], reverse=False)
    return tstrip.strip_filter_apply_plain(Fs, Qs, P0, H, R, y, pre)


def _chunked_smoother(ssm, b, C):
    P0, Fs, Qs, _, _ = ssm
    tot = tstrip.strip_smoother_scan_plain(Fs, Qs, b, C)
    assert tot.shape == (tstrip.smooth_rows(P0.shape[0]), tstrip.n_chunks(b.shape[-1]))
    pre = tstrip.exclusive_chunk_prefixes(tot, P0.shape[0], reverse=True)
    return tstrip.strip_smoother_apply_plain(Fs, Qs, b, C, pre)


@pytest.mark.parametrize("d", [3, 6], ids=lambda d: f"d{d}")
def test_chunked_strip_filter_passes_compose_to_the_plain_filter(d):
    """Chunk totals, exclusive prefixes and the seeded re-fold give the
    unchunked plain filter's moments and log-likelihood at every edge length
    of the d-dimensional units."""
    rf, af, rell, _, _ = TOLS[d]
    for T in _edge_lengths(d):
        ssm, y = _model(d, T, 20 + T)
        with torch.no_grad():
            b0, C0, ell0 = ttl.pkf_from_tl(ssm, y, True)
            b, C, ell = _chunked_filter(ssm, y)
        npt.assert_allclose(b.numpy(), b0.numpy(), rtol=rf, atol=af, err_msg=f"T={T}")
        npt.assert_allclose(C.numpy(), C0.numpy(), rtol=rf, atol=af, err_msg=f"T={T}")
        npt.assert_allclose(float(ell), float(ell0), rtol=rell, err_msg=f"T={T}")


@pytest.mark.parametrize("d", [3, 6], ids=lambda d: f"d{d}")
def test_chunked_strip_smoother_passes_compose_to_the_plain_smoother(d):
    """Suffix totals, exclusive suffixes and the seeded reverse re-fold give
    the unchunked plain smoother's moments at every edge length of the
    d-dimensional units, on the plain filter's moments."""
    _, _, _, rs, as_ = TOLS[d]
    for T in _edge_lengths(d):
        ssm, y = _model(d, T, 40 + T)
        with torch.no_grad():
            b, C = ttl.pkf_from_tl(ssm, y)
            g0, L0 = ttl.pks_from_tl(ssm, b, C)
            g, L = _chunked_smoother(ssm, b, C)
        npt.assert_allclose(g.numpy(), g0.numpy(), rtol=rs, atol=as_, err_msg=f"T={T}")
        npt.assert_allclose(L.numpy(), L0.numpy(), rtol=rs, atol=as_, err_msg=f"T={T}")


@jax.jit
def _jax_pkfs(ssm, ys):
    b, C, ell = pkf_from_tl(ssm, ys, True)
    return (b, C, ell) + tuple(pks_from_tl(ssm, b, C))


def test_chunked_strip_passes_match_jax_time_last_engine_at_d6():
    """The port's chunked strip passes at d = 6 against the jitted JAX
    time-last engine at a chunk and a step (T = 65: a one-step last chunk,
    whose smoother step reads the next chunk's F and Q, and whose filter
    prefix is a whole chunk's total), to test_pallas_scan.py's d > 3
    tolerances.  (The JAX program's compile time grows with T: 2.4 s here,
    5.1 s at T = 4,101 on one CPU core.)"""
    rf, af, rell, rs, as_ = TOLS[6]
    T = tstrip.CHUNK + 1
    ssm, y = _model(6, T, 60)
    jssm = JaxLGSSMTL(*(jnp.asarray(x.numpy()) for x in ssm))
    b_x, C_x, ell_x, g_x, L_x = _jax_pkfs(jssm, jnp.asarray(y.numpy()).reshape(-1, 1))
    with torch.no_grad():
        b, C, ell = _chunked_filter(ssm, y)
        g, L = _chunked_smoother(ssm, b, C)
    npt.assert_allclose(b.numpy(), np.asarray(b_x), rtol=rf, atol=af)
    npt.assert_allclose(C.numpy(), np.asarray(C_x), rtol=rf, atol=af)
    npt.assert_allclose(float(ell), float(ell_x), rtol=rell)
    npt.assert_allclose(g.numpy(), np.asarray(g_x), rtol=rs, atol=as_)
    npt.assert_allclose(L.numpy(), np.asarray(L_x), rtol=rs, atol=as_)


def _units():
    return [(d, dtype, kind) for d in range(1, tstrip.MAX_KERNEL_D + 1) for dtype in DTYPES for kind in KINDS]


def _per_warp(d, dtype, kind, rows):
    """Bytes a warp: rows × 32 slots of kR + 1 values, and the filter's
    block_sum value a thread."""
    size = torch.finfo(dtype).bits // 8
    return rows * 32 * (32 // size + 1) * size + (0 if kind == "smoother" else 32 * size)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_every_strip_apply_unit_fits_the_opt_in_limit(dtype):
    """Rows staged × bytes a warp × warps a block (with the filter's block
    sum) ≤ 232,448 for every unit; rows are the moments (d + d²) or the
    planes in place (filter 2d² + 1, smoother 3d² + d): the filter always,
    the smoother where SMOOTHER_PLANES says."""
    for d in range(1, tstrip.MAX_KERNEL_D + 1):
        for kind in KINDS:
            threads, rows, smem = tstrip.apply_stage(d, dtype, kind)
            planes = (3 * d * d + d) if kind == "smoother" else (2 * d * d + 1)
            staged = kind == "filter" or d in tstrip.SMOOTHER_PLANES[dtype]
            assert rows == (planes if staged else d + d * d), (d, kind)
            assert threads in (32, 64, 128), (d, kind, threads)
            warps = threads // 32
            assert smem == warps * (_per_warp(d, dtype, kind, rows) - (0 if kind == "smoother" else 32 * (torch.finfo(dtype).bits // 8)))
            assert warps * _per_warp(d, dtype, kind, rows) <= 232_448, (d, dtype, kind)


def test_strip_apply_blocks_leave_an_sm_the_most_warps():
    """Each unit's block (4, 2 or 1 warps) holds, by shared memory, at least
    as many warps an SM as any other that fits (228 KB an SM, 1 KB of it
    reserved a block), the larger block on a tie."""
    for d, dtype, kind in _units():
        threads, rows, _ = tstrip.apply_stage(d, dtype, kind)
        per_warp = _per_warp(d, dtype, kind, rows)

        def resident(w):
            return w * (233_472 // (w * per_warp + 1_024))

        fitting = [w for w in (4, 2, 1) if w * per_warp <= 232_448]
        best = max(resident(w) for w in fitting)
        assert resident(threads // 32) == best, (d, dtype, kind, threads)
        assert threads // 32 == max(w for w in fitting if resident(w) == best), (d, dtype, kind)


def test_strip_apply_planes_are_staged_only_where_they_fit():
    """A unit stages its planes only where one warp's planes fit a block;
    the f64 d = 8 smoother's do not (3d² + d = 200 rows, 256,000 bytes) and
    it stages its moments."""
    for d, dtype, kind in _units():
        planes = (3 * d * d + d) if kind == "smoother" else (2 * d * d + 1)
        fits = _per_warp(d, dtype, kind, planes) <= 232_448
        if kind == "filter" or d in tstrip.SMOOTHER_PLANES[dtype]:
            assert fits, (d, dtype, kind)
    assert _per_warp(8, torch.float64, "smoother", 200) == 256_000
    assert tstrip.apply_stage(8, torch.float64, "smoother")[1] == 8 + 64
