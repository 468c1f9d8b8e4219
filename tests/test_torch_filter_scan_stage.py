"""The filter's pass-1 stage: its shared-memory budget, the per-unit choices
of the CUDA sources against their Python mirrors, and the plain passes the
staged scans are held against, at the scans' edge lengths.

On the card, ``strip_filter_scan`` stages its F, Q and y rows a warp at a
time (2d² + 1 rows) at the units of ``strip.FILTER_SCAN_STAGED``, and
``dt_filter_scan`` (both transition families) its y and dt rows (2 rows) at
the units of ``dt.FILTER_SCAN_STAGED``, the rest reading them directly, each
thread its own chunk's: 8 (float32) or 4 (float64) steps of the warp's 32
chunks of ``CHUNK`` steps, in one buffer or two, in blocks of 32, 64 or 128
chunks, fixed for each unit when it is compiled (``strip.scan_stage`` and
``dt.scan_stage`` with kind "filter", the mirrors of the ScanStage budgets
of ``csrc/strip_scan.cu`` and ``csrc/dt_scan.cu``, checked against the
library when it loads).  ``chip_smoke.py`` holds those kernels against
their plain versions at every unit at the lengths where the staging has
ragged edges; these tests hold, on the CPU:

  - the budget: every unit's stage fits a block's opt-in limit, with the
    spectral family's filter scalar table (as the wrapper builds it) ahead
    of it; its block leaves an SM the most warps; and it stages two buffers
    only where they fit;
  - the Python mirrors' unit sets against the ``constexpr`` masks of the
    CUDA sources, read from the sources;
  - the plain chunk totals, exclusive prefixes and seeded re-fold, composed,
    against the jitted JAX time-last filter at the edge lengths of the
    d = 3 and d = 6 units, f64.

Inputs are made from a seed with numpy; each model is built by the port and
handed to JAX as numpy arrays.  The JAX filter runs once, on the longest
series: a filter's moments over the first T steps do not depend on later
steps, so each edge length is the first T steps of it.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from parallel_gps_torch import kernels as tk
from parallel_gps_torch.kalman import dt as tdt
from parallel_gps_torch.kalman import strip as tstrip
from parallel_gps_torch.kernels.composite import COMPOSITE
from parallel_gps_torch.kernels.matern import EXPPOLY
from parallel_gps_torch.kernels.rbf import SPECTRAL
from parallel_gps_tpu.kalman.timelast import pkf_from_tl
from parallel_gps_tpu.types import LGSSMTL as JaxLGSSMTL
from _torch_common import jit_o0

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parent.parent / "parallel_gps_torch" / "csrc"
DTYPES = (torch.float32, torch.float64)
SMEM_LIMIT, SMEM_PER_SM, SMEM_RESERVED = 232_448, 233_472, 1_024
# test_pallas_scan.py's filter tolerances (:88-89 at d ≤ 3; :131-132
# above): rtol, atol.
TOLS = {3: (1e-9, 1e-10), 6: (1e-8, 1e-9)}


def _units():
    """(unit, d, stage function of dtype) of every filter pass-1 unit."""
    units = [("strip", d, lambda dtype, d=d: tstrip.scan_stage(d, dtype, "filter")) for d in range(1, tstrip.MAX_KERNEL_D + 1)]
    for family, top in tdt.MAX_KERNEL_D.items():
        units += [(family, d, lambda dtype, d=d, f=family: tdt.scan_stage(f, d, dtype, "filter")) for d in range(1, top + 1)]
    return units


def _size(dtype):
    return torch.finfo(dtype).bits // 8


def _region(rows, dtype, buffers=1):
    """Bytes of one warp's stage: buffers × rows × 32 slots of kR + 1
    values."""
    return buffers * rows * 32 * (32 // _size(dtype) + 1) * _size(dtype)


def _buffers(unit, d, dtype):
    """The unit's buffers by the mirrors' sets: 0 for a unit that reads its
    rows directly."""
    staged, two = (
        (tstrip.FILTER_SCAN_STAGED[dtype], tstrip.FILTER_SCAN_TWO_BUFFERS[dtype])
        if unit == "strip"
        else (tdt.FILTER_SCAN_STAGED[unit, dtype], tdt.FILTER_SCAN_TWO_BUFFERS[unit, dtype])
    )
    return 0 if d not in staged else 2 if d in two else 1


def _table_bytes(unit, d, dtype):
    """The spectral or composite filter scan's scalar table as the wrapper
    builds it, [P0 | h | r | coefficients in the kernels' layout | block
    table or plan] (the composite's of a Sum of d Matern12 kernels: its
    layout depends on d alone), in bytes rounded up to 16; none for the
    other units."""
    if unit not in (SPECTRAL, COMPOSITE):
        return 0
    kern = (
        tk.RBF(1.0, 0.3, order=d, dtype=torch.float64, device="cpu")
        if unit == SPECTRAL
        else tk.Sum(*(tk.Matern12(1.0, 0.3 + 0.1 * i, dtype=torch.float64, device="cpu") for i in range(d)))
    )
    with torch.no_grad():
        fam, coeffs = kern.transition_coeffs()
        sde = kern.get_sde()
        values = tdt._filter_scalars(fam, sde.P0, sde.H, torch.ones(1, 1, dtype=torch.float64), coeffs).numel()
    return -(-values * _size(dtype) // 16) * 16


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_every_filter_scan_unit_fits_the_opt_in_limit(dtype):
    """Rows staged × buffers × bytes a warp × warps a block, after the scalar
    table, ≤ 232,448 for every unit: a strip unit stages its F, Q and y rows
    (2d² + 1), a dt unit its y and dt (2), in the buffers the mirrors' sets
    give (none where a unit reads directly: then its block is 4 warps and
    its shared memory the table alone)."""
    for unit, d, stage in _units():
        threads, rows, smem, buffers = stage(dtype)
        assert rows == (2 * d * d + 1 if unit == "strip" else 2), (unit, d)
        assert buffers == _buffers(unit, d, dtype), (unit, d)
        assert threads in (32, 64, 128), (unit, d, threads)
        table = _table_bytes(unit, d, dtype)
        assert smem == table + threads // 32 * _region(rows, dtype, buffers), (unit, d)
        assert smem <= SMEM_LIMIT, (unit, d, smem)
        if buffers == 0:
            assert (threads, smem) == (128, table), (unit, d)


def test_filter_scan_blocks_leave_an_sm_the_most_warps():
    """Each unit's block (4, 2 or 1 warps) holds, by shared memory, at least
    as many warps an SM as any other that fits (228 KB an SM, 1 KB of it
    reserved a block, the table once a block), the larger block on a tie."""
    for unit, d, stage in _units():
        for dtype in DTYPES:
            threads, rows, smem, buffers = stage(dtype)
            per_warp = _region(rows, dtype, buffers)
            table = smem - threads // 32 * per_warp

            def resident(w):
                return w * (SMEM_PER_SM // (w * per_warp + table + SMEM_RESERVED))

            fitting = [w for w in (4, 2, 1) if w * per_warp + table <= SMEM_LIMIT]
            best = max(resident(w) for w in fitting)
            assert resident(threads // 32) == best, (unit, d, dtype, threads)
            assert threads // 32 == max(w for w in fitting if resident(w) == best), (unit, d, dtype)


def test_filter_scan_buffers_are_staged_only_where_they_fit():
    """A unit stages two buffers only where one warp's two fit a block; the
    strip units' two buffers do not at f32 d = 8 and f64 d = 7, 8
    (2d² + 1 rows)."""
    for unit, d, stage in _units():
        for dtype in DTYPES:
            _, rows, _, buffers = stage(dtype)
            assert _table_bytes(unit, d, dtype) + _region(rows, dtype, buffers) <= SMEM_LIMIT, (unit, d, dtype)
    too_wide = {(8, torch.float32), (7, torch.float64), (8, torch.float64)}
    for d in range(1, tstrip.MAX_KERNEL_D + 1):
        for dtype in DTYPES:
            assert (_region(2 * d * d + 1, dtype, 2) > SMEM_LIMIT) == ((d, dtype) in too_wide), (d, dtype)


def _masks(source):
    """{name: value} of the ``constexpr unsigned`` masks of a CUDA source."""
    text = (CSRC / source).read_text()
    return {name: int(value, 16) for name, value in re.findall(r"constexpr unsigned (k\w+) = 0x([0-9A-Fa-f]+)u;", text)}


def _dims(mask, top):
    """The state dimensions d ≤ top whose bit d − 1 the mask sets; no bit
    above top may be set."""
    assert mask < 1 << top, (hex(mask), top)
    return frozenset(d for d in range(1, top + 1) if (mask >> (d - 1)) & 1)


@pytest.mark.parametrize("source", ["strip_scan.cu", "dt_scan.cu"])
def test_mirror_sets_match_the_constexpr_masks(source):
    """Every per-unit choice of the source (bit d − 1 of its F32 / F64 mask)
    is the unit set of its Python mirror, filter and smoother passes both:
    strip.FILTER_SCAN_STAGED, FILTER_SCAN_TWO_BUFFERS, SCAN_PLANES,
    SCAN_TWO_BUFFERS and SMOOTHER_PLANES; dt.FILTER_SCAN_STAGED,
    FILTER_SCAN_TWO_BUFFERS and
    SCAN_TWO_BUFFERS of each family (kDt…, kSpectral…, kComposite…)."""
    masks = _masks(source)
    if source == "strip_scan.cu":
        top = tstrip.MAX_KERNEL_D
        mirrors = {
            "kFilterScanStaged": tstrip.FILTER_SCAN_STAGED, "kFilterScanTwo": tstrip.FILTER_SCAN_TWO_BUFFERS,
            "kScanPlanes": tstrip.SCAN_PLANES,
            "kScanTwo": tstrip.SCAN_TWO_BUFFERS, "kSmootherPlanes": tstrip.SMOOTHER_PLANES,
        }
        expected = {f"{stem}F{bits}": (sets[dtype], top) for stem, sets in mirrors.items() for bits, dtype in ((32, torch.float32), (64, torch.float64))}
    else:
        expected = {}
        for prefix, family in (("kDt", EXPPOLY), ("kSpectral", SPECTRAL), ("kComposite", COMPOSITE)):
            for stem, sets in (("FilterScanStaged", tdt.FILTER_SCAN_STAGED), ("FilterScanTwo", tdt.FILTER_SCAN_TWO_BUFFERS),
                               ("ScanTwo", tdt.SCAN_TWO_BUFFERS)):
                for bits, dtype in ((32, torch.float32), (64, torch.float64)):
                    expected[f"{prefix}{stem}F{bits}"] = (sets[family, dtype], tdt.MAX_KERNEL_D[family])
    assert set(masks) == set(expected), sorted(set(masks) ^ set(expected))
    for name, (units, top) in expected.items():
        assert _dims(masks[name], top) == units, (name, hex(masks[name]), sorted(units))


def _edge_lengths(d):
    """chip_smoke.scan_edge_lengths for every filter unit of dimension d,
    float32 and float64: one step; a chunk less one, a chunk, a chunk and a
    step, a chunk and a round (8 or 4 steps); a warp's chunks, a step and a
    chunk past them; a step short of the unit's block of chunks, the block
    and a 5-step chunk past it."""
    chunk, warp = tstrip.CHUNK, 32 * tstrip.CHUNK
    lengths = {1, chunk - 1, chunk, chunk + 1, warp, warp + 1, warp + chunk}
    for _, dd, stage in _units():
        if dd != d:
            continue
        for dtype in DTYPES:
            block = stage(dtype)[0] * chunk
            lengths |= {chunk + 32 // _size(dtype), block - 1, block, block + 5}
    return sorted(lengths)


def _jax_pkf(ssm, y):
    """The jitted JAX time-last filter, (b, C), compiled at XLA's lowest
    backend optimisation level (``jit_o0``): at T = 8,197 the default
    level's compile takes 4–5 s, this one's about half, and the run stays
    well under 1 s."""
    return jit_o0(pkf_from_tl)(ssm, y)


@pytest.mark.parametrize("d", [3, 6], ids=lambda d: f"d{d}")
def test_chunked_filter_passes_match_jax_at_scan_edges(d):
    """Chunk totals (strip_filter_scan_plain), exclusive prefixes and the
    seeded re-fold (strip_filter_apply_plain) give the jitted JAX time-last
    filter's moments at every edge length of the d-dimensional pass-1 units:
    Matern52(0.8, 0.4) at d = 3, RBF(1.0, 0.05, order=6) at d = 6, noise
    0.1, ~1/9 of the observations missing."""
    rtol, atol = TOLS[d]
    lengths = _edge_lengths(d)
    T = lengths[-1]
    rng = np.random.RandomState(80 + d)
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
    jssm = JaxLGSSMTL(*(jnp.asarray(x.numpy()) for x in ssm))
    b_x, C_x = (np.asarray(x) for x in _jax_pkf(jssm, jnp.asarray(y)))
    yt = torch.tensor(y)
    for n in lengths:
        Fs, Qs = (x[..., :n].contiguous() for x in (ssm.Fs, ssm.Qs))
        with torch.no_grad():
            tot = tstrip.strip_filter_scan_plain(Fs, Qs, ssm.P0, ssm.H, ssm.R, yt[:n])
            assert tot.shape == (tstrip.filt_rows(d), tstrip.n_chunks(n))
            pre = tstrip.exclusive_chunk_prefixes(tot, d, reverse=False)
            b, C, _ = tstrip.strip_filter_apply_plain(Fs, Qs, ssm.P0, ssm.H, ssm.R, yt[:n], pre)
        npt.assert_allclose(b.numpy(), b_x[:, :n], rtol=rtol, atol=atol, err_msg=f"T={n}")
        npt.assert_allclose(C.numpy(), C_x[..., :n], rtol=rtol, atol=atol, err_msg=f"T={n}")
