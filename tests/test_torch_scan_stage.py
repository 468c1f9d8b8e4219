"""The smoother's pass-1 stage: its shared-memory budget, and the plain
passes the staged scans are held against, at the scans' edge lengths.

On the card, ``strip_smoother_scan`` and ``dt_smoother_scan`` (both transition
families) stage their rows a warp at a time: 8 (float32) or 4 (float64)
steps of the warp's 32 chunks of ``CHUNK`` steps, in blocks of 32, 64 or 128
chunks, fixed for each unit by its shared-memory budget (``strip.scan_stage``
and ``dt.scan_stage``, the mirrors of the ScanStage budgets of
``csrc/strip_scan.cu`` and ``csrc/dt_scan.cu``, checked against the library
when it loads).  ``chip_smoke.py`` holds those kernels against their plain
versions at every unit at the lengths where the staging has ragged edges;
these tests hold, on the CPU:

  - the budget: every unit's stage fits a block's opt-in limit, with the
    spectral family's scalar table (as the wrapper builds it) ahead of it;
    its block leaves an SM the most warps; and it stages its planes, or two
    buffers, only where one warp's stage fits;
  - the plain chunk totals, exclusive suffixes and seeded reverse re-fold,
    composed, against the jitted JAX time-last smoother at the edge lengths
    of the d = 3 and d = 6 units, f64.

Inputs are made from a seed with numpy; each model is built by the port and
handed to JAX as numpy arrays.  The JAX smoother runs once, on the longest
series: a suffix of a series has the same smoothed moments as the whole
series over those steps (the smoother runs backward from the last step), so
each edge length is the last T steps of it.
"""
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from parallel_gps_torch import kernels as tk
from parallel_gps_torch.kalman import dt as tdt
from parallel_gps_torch.kalman import strip as tstrip
from parallel_gps_torch.kalman import timelast as ttl
from parallel_gps_torch.kernels.composite import COMPOSITE
from parallel_gps_torch.kernels.rbf import SPECTRAL
from parallel_gps_tpu.kalman.timelast import pks_from_tl
from parallel_gps_tpu.types import LGSSMTL as JaxLGSSMTL
from _torch_common import jit_o0

torch.set_num_threads(1)

DTYPES = (torch.float32, torch.float64)
SMEM_LIMIT, SMEM_PER_SM, SMEM_RESERVED = 232_448, 233_472, 1_024
# test_pallas_scan.py's smoother tolerances (:106-107 at d ≤ 3; :131-138
# above): rtol, atol.
TOLS = {3: (1e-8, 1e-9), 6: (1e-7, 1e-8)}


def _units():
    """(name, stage function of dtype) of every smoother pass-1 unit."""
    units = [(("strip", d), lambda dtype, d=d: tstrip.scan_stage(d, dtype, "smoother")) for d in range(1, tstrip.MAX_KERNEL_D + 1)]
    for family, top in tdt.MAX_KERNEL_D.items():
        units += [((family, d), lambda dtype, d=d, f=family: tdt.scan_stage(f, d, dtype, "smoother")) for d in range(1, top + 1)]
    return units


def _size(dtype):
    return torch.finfo(dtype).bits // 8


def _region(rows, dtype, buffers=1):
    """Bytes of one warp's stage: buffers × rows × 32 slots of kR + 1
    values."""
    return buffers * rows * 32 * (32 // _size(dtype) + 1) * _size(dtype)


def _two_buffers(kind, d, dtype):
    """Whether the unit stages two buffers, by the mirrors' sets."""
    if kind == "strip":
        return d in tstrip.SCAN_TWO_BUFFERS[dtype]
    return d in tdt.SCAN_TWO_BUFFERS[kind, dtype]


def _table_bytes(family, d, dtype):
    """The spectral or composite smoother scan's scalar table as the wrapper
    builds it, [P0 | coefficients in the kernels' layout | block table or
    plan] (the composite's of a Sum of d Matern12 kernels: its layout
    depends on d alone), in bytes rounded up to 16; none for the
    exponential polynomial."""
    if family not in (SPECTRAL, COMPOSITE):
        return 0
    kern = (
        tk.RBF(1.0, 0.3, order=d, dtype=torch.float64, device="cpu")
        if family == SPECTRAL
        else tk.Sum(*(tk.Matern12(1.0, 0.3 + 0.1 * i, dtype=torch.float64, device="cpu") for i in range(d)))
    )
    with torch.no_grad():
        fam, coeffs = kern.transition_coeffs()
        values = tdt._smoother_scalars(fam, kern.get_sde().P0, coeffs).numel()
    return -(-values * _size(dtype) // 16) * 16


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_every_scan_unit_fits_the_opt_in_limit(dtype):
    """Rows staged × buffers × bytes a warp × warps a block, after the scalar
    table, ≤ 232,448 for every unit; a strip unit stages its planes
    (3d² + d rows) where SCAN_PLANES says and its moments (d + d²) elsewhere,
    a dt unit its moments, in two buffers where SCAN_TWO_BUFFERS says."""
    for (kind, d), stage in _units():
        threads, rows, smem, buffers = stage(dtype)
        planes = kind == "strip" and d in tstrip.SCAN_PLANES[dtype]
        assert rows == (3 * d * d + d if planes else d + d * d), (kind, d)
        assert buffers == (2 if _two_buffers(kind, d, dtype) else 1), (kind, d)
        assert threads in (32, 64, 128), (kind, d, threads)
        table = 0 if kind == "strip" else _table_bytes(kind, d, dtype)
        assert smem == table + threads // 32 * _region(rows, dtype, buffers), (kind, d)
        assert smem <= SMEM_LIMIT, (kind, d, smem)


def test_scan_blocks_leave_an_sm_the_most_warps():
    """Each unit's block (4, 2 or 1 warps) holds, by shared memory, at least
    as many warps an SM as any other that fits (228 KB an SM, 1 KB of it
    reserved a block, the table once a block), the larger block on a tie."""
    for (kind, d), stage in _units():
        for dtype in DTYPES:
            threads, rows, smem, buffers = stage(dtype)
            per_warp = _region(rows, dtype, buffers)
            table = smem - threads // 32 * per_warp

            def resident(w):
                return w * (SMEM_PER_SM // (w * per_warp + table + SMEM_RESERVED))

            fitting = [w for w in (4, 2, 1) if w * per_warp + table <= SMEM_LIMIT]
            best = max(resident(w) for w in fitting)
            assert resident(threads // 32) == best, (kind, d, dtype, threads)
            assert threads // 32 == max(w for w in fitting if resident(w) == best), (kind, d, dtype)


def test_scan_planes_and_buffers_are_staged_only_where_they_fit():
    """A strip unit stages its planes, and any unit two buffers, only where
    one warp's stage fits a block; the f64 d = 8 strip unit's planes do not
    (200 rows, 256,000 bytes), and it stages its moments."""
    for (kind, d), stage in _units():
        for dtype in DTYPES:
            _, rows, smem, buffers = stage(dtype)
            table = 0 if kind == "strip" else _table_bytes(kind, d, dtype)
            assert table + _region(rows, dtype, buffers) <= SMEM_LIMIT, (kind, d, dtype)
    assert _region(200, torch.float64) == 256_000
    assert tstrip.scan_stage(8, torch.float64, "smoother")[1] == 8 + 64


def _edge_lengths(d):
    """chip_smoke.scan_edge_lengths for every unit of dimension d, float32
    and float64: one step; a chunk less one, a chunk, a chunk and a step, a
    chunk and a round (8 or 4 steps); a warp's chunks, a step and a chunk
    past them; a step short of the unit's block of chunks, the block and a
    5-step chunk past it."""
    chunk, warp = tstrip.CHUNK, 32 * tstrip.CHUNK
    lengths = {1, chunk - 1, chunk, chunk + 1, warp, warp + 1, warp + chunk}
    for (kind, dd), stage in _units():
        if dd != d:
            continue
        for dtype in DTYPES:
            block = stage(dtype)[0] * chunk
            lengths |= {chunk + 32 // _size(dtype), block - 1, block, block + 5}
    return sorted(lengths)


@jit_o0
def _jax_pks(ssm, b, C):
    return pks_from_tl(ssm, b, C)


@pytest.mark.parametrize("d", [3, 6], ids=lambda d: f"d{d}")
def test_chunked_smoother_passes_match_jax_at_scan_edges(d):
    """Suffix totals (strip_smoother_scan_plain), exclusive suffixes and the
    seeded reverse re-fold give the jitted JAX time-last smoother's moments
    at every edge length of the d-dimensional pass-1 units, on the port's
    plain filtered moments: Matern52(0.8, 0.4) at d = 3, RBF(1.0, 0.05,
    order=6) at d = 6, noise 0.1, ~1/9 of the observations missing."""
    rs, as_ = TOLS[d]
    lengths = _edge_lengths(d)
    T = lengths[-1]
    rng = np.random.RandomState(70 + d)
    t = np.sort(rng.rand(T))
    y = np.sin(12.0 * t) + 0.3 * rng.randn(T)
    y[rng.choice(T, T // 9, replace=False)] = np.nan
    kern = (
        tk.Matern52(0.8, 0.4, dtype=torch.float64, device="cpu")
        if d == 3
        else tk.RBF(1.0, 0.05, order=6, dtype=torch.float64, device="cpu")
    )
    with torch.no_grad():
        ssm = kern.get_ssm_tl(torch.tensor(t), torch.tensor([[0.1]], dtype=torch.float64))
        b, C = ttl.pkf_from_tl(ssm, torch.tensor(y))
    jssm = JaxLGSSMTL(*(jnp.asarray(x.numpy()) for x in ssm))
    g_x, L_x = (np.asarray(x) for x in _jax_pks(jssm, jnp.asarray(b.numpy()), jnp.asarray(C.numpy())))
    for n in lengths:
        Fs, Qs, bn, Cn = (x[..., T - n :].contiguous() for x in (ssm.Fs, ssm.Qs, b, C))
        with torch.no_grad():
            tot = tstrip.strip_smoother_scan_plain(Fs, Qs, bn, Cn)
            assert tot.shape == (tstrip.smooth_rows(d), tstrip.n_chunks(n))
            pre = tstrip.exclusive_chunk_prefixes(tot, d, reverse=True)
            g, L = tstrip.strip_smoother_apply_plain(Fs, Qs, bn, Cn, pre)
        npt.assert_allclose(g.numpy(), g_x[:, T - n :], rtol=rs, atol=as_, err_msg=f"T={n}")
        npt.assert_allclose(L.numpy(), L_x[..., T - n :], rtol=rs, atol=as_, err_msg=f"T={n}")

