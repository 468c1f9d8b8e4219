"""The batched kernels' tiles: their launch geometry and the association in
which they fold a series, held against the JAX package.

On the card, ``batched_strip_filter`` and ``batched_strip_smoother`` run one
thread block a (series, tile): a tile is ``threads × chunk`` steps
(``batched.tile_shape``, the mirror of ``BatchedTile`` in
``csrc/batched_scan.cu``, checked against the library when it loads), a
block takes ticket k — tile k / B of series k % B, counted from the series'
end for the smoother — and waits only for the inclusive total of the tile
before it in its series.  ``chip_smoke.py`` holds the kernels against their
plain versions at the tiles' edge lengths; these tests hold, on the CPU:

  - the Python mirror against the source: the per-unit ``constexpr`` masks
    and chunks read from ``batched_scan.cu``, every unit's tile and shared
    memory (within a block's 232,448-byte opt-in, its block leaving an SM the
    most warps), the ticket map (read from the source) a bijection onto
    (series, tile) whose awaited tiles hold earlier tickets, and the
    scratch a launch allocates;
  - a plain composition in the kernels' association — each thread's fold of
    its chunk, the Kogge–Stone scan of a tile's thread totals, the chained
    carry between tiles, each thread's re-fold seeded with combine(carry,
    its exclusive prefix), the filter's log-likelihood as per-tile partials
    (a thread's steps in order, the block's threads in a fixed tree) summed
    in tile order — against the jitted JAX time-last filter and smoother
    under ``jax.vmap``, f64, B = 3, at the d = 3 units' edge lengths.

Inputs are made from a seed with numpy; each model is built by the port and
handed to JAX as numpy arrays.  JAX runs once a pass, on the longest
series: a filter's moments over the first T steps do not depend on later
steps (each edge length is a prefix), and a smoother's over the last T
steps, given the filtered moments, do not depend on earlier ones (each edge
length is a suffix).
"""
import math
import re
from pathlib import Path

import jax
import numpy as np
import numpy.testing as npt
import pytest
import torch

from parallel_gps_torch import kernels as tk
from parallel_gps_torch.kalman import batched as tb
from parallel_gps_torch.kalman import timelast as ttl
from parallel_gps_tpu.kalman.timelast import pkf_from_tl, pks_from_tl
from parallel_gps_tpu.types import LGSSMTL as JaxLGSSMTL
from _torch_common import jit_o0

torch.set_num_threads(1)

SOURCE = (Path(__file__).resolve().parent.parent / "parallel_gps_torch" / "csrc" / "batched_scan.cu").read_text()
DTYPES = (torch.float32, torch.float64)
SMEM_LIMIT, SMEM_PER_SM, SMEM_RESERVED = 232_448, 233_472, 1_024
# test_pallas_scan.py's tolerances at d ≤ 3 (:88-89 the filter, the
# smoother's one decade looser as in chip_smoke.batched_tolerances): rtol,
# atol; the log-likelihood relative.
FILTER_TOL, SMOOTHER_TOL, ELL_RTOL = (1e-9, 1e-10), (1e-8, 1e-9), 1e-10
D, B = 3, 3


def _mask(name):
    return int(re.search(rf"constexpr unsigned {name} = (0x[0-9a-f]+)u;", SOURCE).group(1), 16)


def test_source_choices_match_the_mirror():
    """The staged and the walking units (bit d − 1 of each kBatched*Staged
    and kBatched*Walk mask) and the steps a thread of a unit that reads
    directly or walks (kBatchedDirectChunk, kBatchedWalkChunk) read from the
    source equal ``batched.STAGED``, ``WALK``, ``DIRECT_CHUNK`` and
    ``WALK_CHUNK``; no unit is both staged and walking."""
    for kind in tb.KINDS:
        for dtype, tag in zip(DTYPES, ("F32", "F64")):
            for what, mirror in (("Staged", tb.STAGED), ("Walk", tb.WALK)):
                mask = _mask(f"kBatched{kind.capitalize()}{what}{tag}")
                assert {d for d in range(1, 9) if mask >> (d - 1) & 1} == set(mirror[kind][dtype]), (kind, what, tag)
            assert not tb.STAGED[kind][dtype] & tb.WALK[kind][dtype]
    for name, value in (("kBatchedDirectChunk", tb.DIRECT_CHUNK), ("kBatchedWalkChunk", tb.WALK_CHUNK)):
        assert int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1)) == value


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_every_unit_fits_a_block_and_fills_an_sm(dtype):
    """Each chained unit's shared memory, recomputed from its parts — per
    warp its staged rows (32 slots of 32 / itemsize + 1 values) and one
    element a thread; per block one element, the filter's scalars and four
    ints — equals the mirror's, fits the opt-in limit, and its block (4, 2
    or 1 warps) leaves an SM the most warps, the larger block on a tie; a
    walking unit's is its NT + 1 elements."""
    size = torch.finfo(dtype).bits // 8
    for kind in tb.KINDS:
        for d in range(1, 9):
            threads, chunk, rows, smem = tb.tile_shape(d, dtype, kind)
            elem = 3 * d * d + 2 * d if kind == "filter" else 2 * d * d + d
            if d in tb.WALK[kind][dtype]:  # one block a series: NT + 1 elements
                assert (chunk, rows) == (tb.WALK_CHUNK, 0)
                assert threads == (128 if d <= 3 else 64 if d <= 5 else 32)
                assert smem == size * elem * (threads + 1) <= SMEM_LIMIT
                continue
            staged = d in tb.STAGED[kind][dtype]
            assert rows == ((2 * d * d + 1 if kind == "filter" else 3 * d * d + d) if staged else 0)
            # A staged chunk is one 32-byte sector of a row.
            assert chunk == (32 // size if staged else tb.DIRECT_CHUNK)
            per_warp = size * (rows * 32 * (32 // size + 1) + 32 * elem)
            per_block = size * (elem + (d * d + d + 1 if kind == "filter" else 0)) + 16
            assert smem == threads // 32 * per_warp + per_block, (kind, d)
            assert threads in (32, 64, 128) and smem <= SMEM_LIMIT, (kind, d, threads, smem)

            def resident(w):
                return w * (SMEM_PER_SM // (w * per_warp + per_block + SMEM_RESERVED))

            fitting = [w for w in (4, 2, 1) if w * per_warp + per_block <= SMEM_LIMIT]
            best = max(resident(w) for w in fitting)
            assert threads // 32 == max(w for w in fitting if resident(w) == best), (kind, d)


def _ticket_tile(ticket, n_series, n_tiles, reverse):
    """The kernels' ticket map (take_ticket in batched_scan.cu)."""
    series = ticket % n_series
    return series, (n_tiles - 1 - ticket // n_series if reverse else ticket // n_series)


def test_ticket_map_is_a_bijection_whose_waits_hold_earlier_tickets():
    """The map as the source writes it; at B = 1, 3, 133 and 1, 2, 5 tiles a
    series, tickets 0 .. B·n_tiles − 1 cover every (series, tile) once, the
    first B tickets span every series, and the tile each waits on (the one
    before in its series, in scan order: the next one for the smoother) holds
    an earlier ticket — a block that already runs."""
    assert "series = ticket % B;" in SOURCE
    assert "tile = reverse ? n_tiles - 1 - ticket / B : ticket / B;" in SOURCE
    for n_series in (1, 3, 133):
        for n_tiles in (1, 2, 5):
            for reverse in (False, True):
                where = {_ticket_tile(k, n_series, n_tiles, reverse): k for k in range(n_series * n_tiles)}
                assert set(where) == {(s, j) for s in range(n_series) for j in range(n_tiles)}
                assert {where_s for where_s, _ in list(where)[:n_series]} == set(range(n_series))
                for (s, j), k in where.items():
                    prev = j + 1 if reverse else j - 1
                    if 0 <= prev < n_tiles:
                        assert where[(s, prev)] < k, (n_series, n_tiles, reverse, s, j)


def test_scratch_of_a_launch():
    """What a launch allocates: the status words zeroed — ticket, overrun, a
    flag a tile and, for the filter, an arrival counter a series — and an
    inclusive element a tile, at the tiles the mirror gives."""
    for kind in tb.KINDS:
        for dtype in DTYPES:
            for d, n_series, T in ((1, 1, 1), (3, 4, 5000), (8, 133, 777)):
                status, incl, tiles = tb._scratch(d, dtype, kind, n_series, T, "cpu")
                threads, chunk, _, _ = tb.tile_shape(d, dtype, kind)
                assert tiles == n_series * -(-T // (threads * chunk)) == n_series * tb.n_tiles(d, dtype, kind, T)
                assert status.dtype == torch.int32 and not status.any()
                assert status.numel() == 2 + tiles + (n_series if kind == "filter" else 0)
                elem = 3 * d * d + 2 * d if kind == "filter" else 2 * d * d + d
                assert tuple(incl.shape) == (tiles, elem) and incl.dtype == dtype


# --------------------------------------------------------------------------
# The kernels' association, composed from the plain time-last algebra
# --------------------------------------------------------------------------


def _tiled(x, tile, threads, chunk, fill):
    """(..., B, T) → (..., B, n_tiles, threads, chunk), the steps past T
    ``fill``."""
    T = x.shape[-1]
    pad = -T % tile
    x = torch.cat([x, fill.expand(*x.shape[:-1], pad)], -1) if pad else x
    return x.reshape(*x.shape[:-1], -1, threads, chunk)


def _steps(T, tile, threads, chunk):
    """Steps of each thread's chunk: (n_tiles, threads)."""
    first = torch.arange(-(-T // tile) * tile).reshape(-1, threads, chunk)[..., 0]
    return (T - first).clamp(0, chunk)


def _pick(mask, a, b):
    return type(a)(*(torch.where(mask, x, y) for x, y in zip(a, b)))


def _at(e, *idx):
    return type(e)(*(x[(Ellipsis,) + idx] for x in e))


def _tile_scans(elems, op, identity, T, threads, chunk, reverse):
    """Each thread's fold of its chunk (from its last step with
    ``reverse``), the inclusive Kogge–Stone scan of a tile's thread totals in
    block_scan's association, each tile's aggregate, the tiles' chained
    inclusive totals in scan order, and each thread's seed, combine(carry,
    exclusive prefix): (per-step elements (..., B, n_tiles, threads, chunk),
    seeds (..., B, n_tiles, threads), seeded (n_tiles, threads), steps of
    each chunk (n_tiles, threads))."""
    tile = threads * chunk
    n_tiles = -(-T // tile)
    E = type(elems)(*(_tiled(x, tile, threads, chunk, i[..., None, None]) for x, i in zip(elems, identity)))
    steps = _steps(T, tile, threads, chunk)
    n_valid = (steps > 0).sum(-1)  # chunks of each tile
    mine = None
    for u in (range(chunk - 1, -1, -1) if reverse else range(chunk)):
        e = _at(E, u)
        if mine is None:
            mine = e
        elif reverse:  # from the chunk's last step, every earlier one combined in
            mine = _pick(u == steps - 1, e, _pick(u < steps - 1, op(mine, e), mine))
        else:
            mine = _pick(u < steps, op(mine, e), mine)
    incl, idx, s = mine, torch.arange(threads), 1
    while s < threads:
        partner = type(incl)(*(torch.roll(x, -s if reverse else s, -1) for x in incl))
        incl = _pick((idx + s < n_valid[:, None]) if reverse else (idx >= s), op(partner, incl), incl)
        s <<= 1
    # A tile's aggregate: its first thread's inclusive total backwards, its
    # last valid thread's forwards; the chain over the tiles in scan order.
    last = (n_valid - 1).clamp(min=0)
    agg = _at(incl, 0) if reverse else type(incl)(*(x[..., torch.arange(n_tiles), last] for x in incl))
    chained = [None] * n_tiles
    for j in (range(n_tiles - 1, -1, -1) if reverse else range(n_tiles)):
        prev = j + 1 if reverse else j - 1
        chained[j] = _at(agg, j) if not 0 <= prev < n_tiles else op(chained[prev], _at(agg, j))
    first = n_tiles - 1 if reverse else 0
    carried = [type(elems)(*identity) if j == first else chained[j + 1] if reverse else chained[j - 1]
               for j in range(n_tiles)]
    carry = type(elems)(*(
        torch.stack([torch.broadcast_to(c[k], chained[0][k].shape) for c in carried], -1)[..., None].expand_as(incl[k])
        for k in range(len(incl))
    ))
    before = type(incl)(*(torch.roll(x, -1 if reverse else 1, -1) for x in incl))
    has_before = (idx + 1 < n_valid[:, None]) if reverse else ((idx >= 1) & (idx < n_valid[:, None]))
    has_carry = (torch.arange(n_tiles) != first)[:, None]
    seeds = _pick(has_carry & has_before, op(carry, before), _pick(has_before, before, carry))
    return E, seeds, has_carry | has_before, steps


def _filter_tiles(Fs, Qs, P0, H, R, ys, threads, chunk):
    """The batched filter in the kernel's association: (b, C, ell)."""
    d, _, nb, T = Fs.shape
    elems = ttl._filtering_elements_from_planes(P0, Fs, Qs, H, R, ys)
    ident = ttl.filtering_identity_tl(d, Fs.dtype)
    E, seeds, seeded, steps = _tile_scans(elems, ttl.filtering_operator_tl, ident, T, threads, chunk, False)
    tile = threads * chunk
    Fr, Qr = (_tiled(x, tile, threads, chunk, torch.zeros(1, dtype=x.dtype)) for x in (Fs, Qs))
    y = _tiled(ys, tile, threads, chunk, torch.full((1,), float("nan"), dtype=ys.dtype))
    P0s, h, r = ttl._series_leaves(P0, H, R, True)
    h = h[:, :, None, None]
    r = r[:, None, None]
    acc, bs, Cs, ll = seeds, [], [], torch.zeros(nb, *steps.shape, dtype=Fs.dtype)
    for u in range(chunk):
        live = u < steps
        first = torch.zeros_like(live)
        if u == 0:
            first[0, 0] = True  # global step 0: its loglik against (0, P0)
        m_prev = torch.where(first, 0.0, acc.b)
        P_prev = torch.where(first, P0s[:, :, :, None, None], acc.C)
        F, Q, yu = Fr[..., u], Qr[..., u], y[..., u]
        mean = (h * ttl._mv(F, m_prev)).sum(0)
        var = (h * ttl._mv(ttl._mm(ttl._mm(F, P_prev), ttl._mt(F)) + Q, h.expand_as(m_prev))).sum(0) + r
        term = -0.5 * ((yu - mean) ** 2 / var + torch.log(var) + math.log(2 * math.pi))
        ll = ll + torch.where(live & ~torch.isnan(yu), term, torch.zeros_like(term))
        e = _at(E, u)
        acc = _pick(live, _pick(seeded | (u > 0), ttl.filtering_operator_tl(acc, e), e), acc)
        bs.append(acc.b)
        Cs.append(acc.C)
    b = torch.stack(bs, -1).reshape(d, nb, -1)[..., :T]
    C = torch.stack(Cs, -1).reshape(d, d, nb, -1)[..., :T]
    # A tile's share: its threads' sums in block_sum's tree; the series' in
    # tile order.
    part = ll
    s = threads // 2
    while s:
        part = torch.cat([part[..., :s] + part[..., s: 2 * s], part[..., s:]], -1)
        s //= 2
    ell = torch.zeros(nb, dtype=Fs.dtype)
    for j in range(steps.shape[0]):
        ell = ell + part[:, j, 0]
    return b, C, ell


def _smoother_tiles(Fs, Qs, b, C, threads, chunk):
    """The batched smoother in the kernel's association: (g, L)."""
    d, _, nb, T = Fs.shape
    elems = ttl._smoothing_elements_from_planes(Fs, Qs, b, C)
    ident = ttl.smoothing_identity_tl(d, Fs.dtype)
    E, seeds, seeded, steps = _tile_scans(elems, ttl.smoothing_operator_tl, ident, T, threads, chunk, True)
    acc, gs, Ls = seeds, [None] * chunk, [None] * chunk
    for u in range(chunk - 1, -1, -1):
        live = u < steps
        e = _at(E, u)
        acc = _pick(live, _pick(seeded | (u < steps - 1), ttl.smoothing_operator_tl(acc, e), e), acc)
        gs[u], Ls[u] = acc.g, acc.L
    return torch.stack(gs, -1).reshape(d, nb, -1)[..., :T], torch.stack(Ls, -1).reshape(d, d, nb, -1)[..., :T]


def _edge_lengths(kind):
    threads, chunk, _, _ = tb.tile_shape(D, torch.float64, kind)
    tile = threads * chunk
    return threads, chunk, (1, tile - 1, tile, tile + 1, 3 * tile + 5)


@pytest.fixture(scope="module")
def series():
    """B = 3 Matern52 models of their own hyperparameters over shared sorted
    times, each its own observations (~10% NaN) and noise, at the longest
    edge length of either pass: the port's planes and JAX's filtered
    moments, log-likelihoods and smoothed moments of the whole series."""
    T = max(max(_edge_lengths(kind)[2]) for kind in tb.KINDS)
    rng = np.random.RandomState(14)
    t = np.sort(rng.rand(T)) * 3.0
    ys = np.sin(5.0 * t)[None] + 0.3 * rng.randn(B, T)
    ys[rng.rand(B, T) < 0.1] = np.nan
    ssms = []
    with torch.no_grad():
        for s in range(B):
            kern = tk.Matern52(0.7 + 0.3 * s, 0.3 + 0.1 * s, dtype=torch.float64, device="cpu")
            ssms.append(kern.get_ssm_tl(torch.tensor(t), torch.tensor([[0.08 + 0.03 * s]], dtype=torch.float64)))
    P0, H, R = (torch.stack([getattr(m, n) for m in ssms]) for n in ("P0", "H", "R"))
    Fs, Qs = (torch.stack([getattr(m, n) for m in ssms], 2) for n in ("Fs", "Qs"))
    y = torch.tensor(ys)

    def jax_filter(P0_, Fs_, Qs_, H_, R_, y_):
        return pkf_from_tl(JaxLGSSMTL(P0_, Fs_, Qs_, H_, R_), y_, True)

    def jax_smoother(P0_, Fs_, Qs_, b_, C_):
        return pks_from_tl(JaxLGSSMTL(P0_, Fs_, Qs_, None, None), b_, C_)

    npy = [x.numpy() for x in (P0, Fs, Qs, H, R, y)]
    jb, jC, jell = jit_o0(jax.vmap(jax_filter, in_axes=(0, 2, 2, 0, 0, 0), out_axes=(1, 2, 0)))(*npy)
    jg, jL = jit_o0(jax.vmap(jax_smoother, in_axes=(0, 2, 2, 1, 2), out_axes=(1, 2)))(npy[0], npy[1], npy[2], jb, jC)
    return dict(P0=P0, H=H, R=R, Fs=Fs, Qs=Qs, y=y, b=np.asarray(jb), C=np.asarray(jC), ell=np.asarray(jell),
                g=np.asarray(jg), L=np.asarray(jL))


def test_filter_tiles_match_jax(series):
    """At each edge length of the d = 3 f64 filter unit's tile (T = 1, a step
    short of a tile, a tile, a step past it, three tiles and a 5-step end),
    the tiled composition's moments equal JAX's over the same prefix; its
    log-likelihoods equal the port's plain filter's at every length and JAX's
    at the longest."""
    threads, chunk, lengths = _edge_lengths("filter")
    s = series
    for T in lengths:
        with torch.no_grad():
            b, C, ell = _filter_tiles(s["Fs"][..., :T], s["Qs"][..., :T], s["P0"], s["H"], s["R"], s["y"][:, :T], threads, chunk)
            _, _, ell_p = tb.batched_strip_filter_plain(s["Fs"][..., :T], s["Qs"][..., :T], s["P0"], s["H"], s["R"], s["y"][:, :T])
        npt.assert_allclose(b.numpy(), s["b"][..., :T], *FILTER_TOL, err_msg=f"b, T = {T}")
        npt.assert_allclose(C.numpy(), s["C"][..., :T], *FILTER_TOL, err_msg=f"C, T = {T}")
        npt.assert_allclose(ell.numpy(), ell_p.numpy(), rtol=ELL_RTOL, err_msg=f"ell, T = {T}")
        if T == s["y"].shape[1]:
            npt.assert_allclose(ell.numpy(), s["ell"], rtol=ELL_RTOL)


def test_smoother_tiles_match_jax(series):
    """At each edge length of the d = 3 f64 smoother unit's tile, the tiled
    composition, run backwards over the last T steps of JAX's filtered
    moments, equals JAX's smoothed moments over those steps."""
    threads, chunk, lengths = _edge_lengths("smoother")
    s = series
    N = s["y"].shape[1]
    for T in lengths:
        with torch.no_grad():
            g, L = _smoother_tiles(
                s["Fs"][..., N - T:], s["Qs"][..., N - T:], torch.tensor(s["b"][..., N - T:]),
                torch.tensor(s["C"][..., N - T:]), threads, chunk,
            )
        npt.assert_allclose(g.numpy(), s["g"][..., N - T:], *SMOOTHER_TOL, err_msg=f"g, T = {T}")
        npt.assert_allclose(L.numpy(), s["L"][..., N - T:], *SMOOTHER_TOL, err_msg=f"L, T = {T}")
