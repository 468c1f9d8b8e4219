"""The exclusive prefix of the chunk totals between the two passes of the
strip and dt engines (``strip.exclusive_chunk_prefixes``; counterpart
``pallas_scan.py::_strip_exclusive_prefixes``).

It is one inclusive ``plane.plane_scan`` over the packed (n, n_chunks) totals
— the hand-written kernel on the card, its plain Kogge–Stone version on the
CPU — followed by a one-column shift that puts the identity first (last, for
the smoother's suffixes).  ``exclusive_chunk_prefixes_plain`` is the plain
Kogge–Stone scan of the unpacked elements, kept as the yardstick and as the
all-plain engines' prefix.  These tests hold, on the CPU, in float64:

  - the prefix against the jitted JAX ``_strip_exclusive_prefixes`` on the
    Matern52 filter and smoother totals of a ragged series of 4 chunks, and
    on each run of the first (last, for the smoother) k of them;
  - the prefix against the plain version, bit for bit, at 1, 2, 3 and 8,193
    chunks (past the plain scan's blocked threshold) at d = 1, 3, 6 and 8;
  - one chunk giving the identity column without a scan;
  - the strip engine's filter and smoother, which take the prefix, against
    the all-plain engines, bit for bit.

The totals come from the port's plain pass 1 on models built by the port,
with inputs made from a seed with numpy and ~1/10 of the observations
missing.  The JAX reference is compiled once a kind, at XLA's lowest backend
optimisation level: it unrolls a combine a chunk, and its compile, not the
run, sets the file's time (about 0.6 s a filter combine at d = 3).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_gps_torch import kernels as tk
from parallel_gps_torch.kalman import plane as tplane
from parallel_gps_torch.kalman import strip as tstrip
from parallel_gps_torch.kalman.timelast import filtering_identity_tl, smoothing_identity_tl
from parallel_gps_tpu.kalman.pallas_scan import _filt_combine_rows, _smooth_combine_rows, _strip_exclusive_prefixes
from _torch_common import jit_o0

torch.set_num_threads(1)

NOISE = 0.1
KINDS = ("filter", "smoother")
M52_CHUNKS = 4
# Chunk counts of the bit-for-bit test: the edges of the shift and one past
# timelast._BLOCKED_SCAN_MIN_T, where the plain scan turns two-level.
N_CHUNKS = (1, 2, 3, 8_193)


def _kernel(d: int):
    """Matern12 / Matern52 at d = 1 / 3, RBF(order=d) above."""
    opts = dict(dtype=torch.float64, device="cpu")
    if d == 1:
        return tk.Matern12(1.2, 0.6, **opts)
    if d == 3:
        return tk.Matern52(0.8, 0.4, **opts)
    return tk.RBF(1.0, 0.05, order=d, **opts)


def _totals(d: int, T: int, seed: int):
    """{kind: packed chunk totals} of the plain pass 1 of each engine on a
    series of T steps, ~1/10 of them unobserved."""
    rng = np.random.RandomState(seed)
    t = np.sort(rng.rand(T))
    y = np.sin(12.0 * t) + 0.3 * rng.randn(T)
    y[rng.choice(T, T // 10, replace=False)] = np.nan
    with torch.no_grad():
        ssm = _kernel(d).get_ssm_tl(torch.tensor(t), torch.tensor([[NOISE]], dtype=torch.float64))
        yt = torch.tensor(y)
        b, C, _ = tstrip.strip_filter_plain(ssm.Fs, ssm.Qs, ssm.P0, ssm.H, ssm.R, yt)
        return ssm, yt, {
            "filter": tstrip.strip_filter_scan_plain(ssm.Fs, ssm.Qs, ssm.P0, ssm.H, ssm.R, yt),
            "smoother": tstrip.strip_smoother_scan_plain(ssm.Fs, ssm.Qs, b, C),
        }


@pytest.fixture(scope="module")
def m52_totals():
    """Matern52 (d = 3) totals of a ragged series of M52_CHUNKS chunks."""
    return _totals(3, (M52_CHUNKS - 1) * tstrip.CHUNK + 23, seed=31)


def _jax_prefixes(totals: np.ndarray, d: int, kind: str) -> np.ndarray:
    """The jitted JAX exclusive prefixes of (n, S) totals, compiled at XLA's
    lowest backend optimisation level (``jit_o0``; the S − 1 combines are
    unrolled)."""
    combine = _filt_combine_rows if kind == "filter" else _smooth_combine_rows
    ident_rows = tuple(k * d + k for k in range(d))

    def ref(x):
        return _strip_exclusive_prefixes(x, d, combine, ident_rows, reverse=kind == "smoother")

    return np.asarray(jit_o0(ref)(jnp.asarray(totals)))


@pytest.mark.parametrize("kind", KINDS)
def test_prefix_matches_jax(m52_totals, kind):
    """Every column to 1e-12 of its component's magnitude, on all the chunks
    and on each run of the first (filter) or last (smoother) k of them: an
    exclusive prefix over the first k totals is the first k columns of the
    prefix over all of them, a suffix likewise the last k."""
    _, _, totals = m52_totals
    tot = totals[kind]
    assert tot.shape == (tstrip.filt_rows(3) if kind == "filter" else tstrip.smooth_rows(3), M52_CHUNKS)
    ref = _jax_prefixes(tot.numpy(), 3, kind)
    scale = np.maximum(np.abs(ref).max(axis=1, keepdims=True), 1e-300)
    reverse = kind == "smoother"
    for k in range(1, M52_CHUNKS + 1):
        part = tot[:, -k:] if reverse else tot[:, :k]
        want = ref[:, -k:] if reverse else ref[:, :k]
        with torch.no_grad():
            got = tstrip.exclusive_chunk_prefixes(part.contiguous(), 3, reverse).numpy()
        assert got.shape == want.shape
        err = np.abs(got - want) / scale
        assert err.max() <= 1e-12, f"{kind} k={k}: {err.max():.3e} relative"


@pytest.mark.parametrize("d", [1, 3, 6, 8], ids=lambda d: f"d{d}")
def test_prefix_matches_plain_bitwise(d):
    """The plane-scan prefix and the plain Kogge–Stone one are the same
    arithmetic on the CPU: equal bits at every chunk count, both kinds.
    The long rows repeat the series' own totals."""
    _, _, totals = _totals(d, 9 * tstrip.CHUNK + 13, seed=40 + d)
    for kind, tot in totals.items():
        reverse = kind == "smoother"
        for n in N_CHUNKS:
            x = tot[:, torch.arange(n) % tot.shape[1]].contiguous()
            with torch.no_grad():
                got = tstrip.exclusive_chunk_prefixes(x, d, reverse)
                want = tstrip.exclusive_chunk_prefixes_plain(x, d, reverse)
            assert got.shape == want.shape == x.shape
            assert torch.equal(got, want), f"{kind} d={d} n_chunks={n}"


def test_single_chunk_is_identity_without_scan(monkeypatch):
    """One chunk: the identity element's column, and no plane scan."""
    def no_scan(*args, **kwargs):
        raise AssertionError("plane_scan called for one chunk")

    monkeypatch.setattr(tplane, "plane_scan", no_scan)
    for d in (1, 3, 8):
        for kind, ident in (("filter", filtering_identity_tl), ("smoother", smoothing_identity_tl)):
            n = tplane.rows(d, kind)
            tot = torch.randn(n, 1, dtype=torch.float64)
            got = tstrip.exclusive_chunk_prefixes(tot, d, kind == "smoother")
            want = tstrip._pack([x[..., None] for x in ident(d, torch.float64)], 1)
            assert got.shape == (n, 1) and got.dtype == torch.float64
            assert torch.equal(got, want), f"{kind} d={d}"


def test_strip_engine_with_prefix_matches_plain_engine(m52_totals):
    """strip_filter and strip_smoother (passes and prefix by their wrappers)
    give the all-plain engines' bits on the CPU."""
    ssm, yt, _ = m52_totals
    with torch.no_grad():
        b, C, ell = tstrip.strip_filter(ssm.Fs, ssm.Qs, ssm.P0, ssm.H, ssm.R, yt)
        b_p, C_p, ell_p = tstrip.strip_filter_plain(ssm.Fs, ssm.Qs, ssm.P0, ssm.H, ssm.R, yt)
        g, L = tstrip.strip_smoother(ssm.Fs, ssm.Qs, b, C)
        g_p, L_p = tstrip.strip_smoother_plain(ssm.Fs, ssm.Qs, b_p, C_p)
    for name, a, b_ in (("b", b, b_p), ("C", C, C_p), ("ell", ell, ell_p), ("g", g, g_p), ("L", L, L_p)):
        assert torch.equal(a, b_), name
