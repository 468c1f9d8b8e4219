"""PyTorch port vs the JAX package: the dt-engine filter and smoother
(parallel_gps_torch.kalman.dt, plain versions on the CPU) against
parallel_gps_tpu's dt kernels in interpret mode and its time-last engine,
and the four chunked passes composed; f64, same numpy inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import parallel_gps_tpu.kernels as jk
from parallel_gps_torch import kernels as tk
from parallel_gps_torch.kalman import dt as tdt
from parallel_gps_torch.kalman import timelast as ttl
from parallel_gps_tpu.kalman.pallas_dt import _dts_from_ts, strip_filter_dt, strip_smoother_dt
from parallel_gps_tpu.kalman.timelast import pkf_from_tl, pks_from_tl
from _torch_common import _no_compile_cache, _np
from _torch_dt import _data, _torch_inputs

torch.set_num_threads(1)


@jax.jit
def _jax_pkfs(ssm, ys):
    b, C, ell = pkf_from_tl(ssm, ys, True)
    return (b, C, ell) + tuple(pks_from_tl(ssm, b, C))


def _jax_model(jkern, t, y):
    ssm = jkern.get_ssm_tl(jnp.asarray(t).reshape(-1, 1), jnp.asarray(0.1).reshape(1, 1))
    return ssm, jnp.asarray(y).reshape(-1, 1)


@pytest.mark.parametrize(
    "name,v,ell,T",
    # The T values of test_pallas_dt.py:57-58; Matern12 is the
    # interpret-mode test below.
    [("Matern32", 1.0, 0.5, 517), ("Matern52", 0.8, 0.4, 279)],
    ids=["m32_T517", "m52_T279"],
)
def test_filter_and_smoother_match_jax_time_last_engine(name, v, ell, T):
    """Port's dt filter/smoother vs the JAX time-last engine
    (pkf_from_tl/pks_from_tl), the reference the JAX dt kernels are held
    against in test_pallas_dt.py, to that file's tolerances."""
    t, y = _data(T, 7)
    ssm, ys = _jax_model(getattr(jk, name)(v, ell), t, y)
    b_x, C_x, ell_x, g_x, L_x = _jax_pkfs(ssm, ys)
    fam, co, P0, H, R, dts, ty = _torch_inputs(getattr(tk, name)(v, ell, dtype=torch.float64, device="cpu"), t, y)
    with torch.no_grad():
        b, C, ell_t = tdt.strip_filter_dt(fam, co, P0, H, R, dts, ty)
        g, L = tdt.strip_smoother_dt(fam, co, P0, dts, b, C)
    # test_pallas_dt.py:71-73 (filter) and 86-87 (smoother).
    npt.assert_allclose(_np(b), _np(b_x), rtol=1e-9, atol=1e-10)
    npt.assert_allclose(_np(C), _np(C_x), rtol=1e-9, atol=1e-10)
    npt.assert_allclose(float(ell_t), float(ell_x), rtol=1e-10)
    npt.assert_allclose(_np(g), _np(g_x), rtol=1e-8, atol=1e-9)
    npt.assert_allclose(_np(L), _np(L_x), rtol=1e-8, atol=1e-9)


def test_filter_and_smoother_match_jax_dt_kernels_in_interpret_mode():
    """Port vs the JAX dt kernels themselves (strip_filter_dt and
    strip_smoother_dt, interpret mode, block=32) and the time-last engine,
    Matern12 at T=257: two grid steps of 8 strips × 32 lanes with a ragged
    tail (test_pallas_dt.py:56 runs T=301).  The
    d = 2 and 3 kernels cost 20-100 s each in interpret mode on the CPU;
    test_pallas_dt.py holds them against the time-last engine that the test
    above holds the port against."""
    t, y = _data(257, 7)
    jkern = jk.Matern12(1.2, 0.6)
    ssm, ys = _jax_model(jkern, t, y)
    coeffs, build = jkern.transition_coeffs()
    dts = _dts_from_ts(jnp.asarray(t)).astype(ssm.P0.dtype)
    with _no_compile_cache():
        b_s, C_s, ell_s = strip_filter_dt(build, coeffs, ssm.P0, ssm.H, ssm.R, dts, ys, block=32, interpret=True)
        g_s, L_s = strip_smoother_dt(build, coeffs, ssm.P0, dts, b_s, C_s, block=32, interpret=True)
    fam, co, P0, H, R, tdts, ty = _torch_inputs(tk.Matern12(1.2, 0.6, dtype=torch.float64, device="cpu"), t, y)
    with torch.no_grad():
        b, C, ell_t = tdt.strip_filter_dt(fam, co, P0, H, R, tdts, ty)
        g, L = tdt.strip_smoother_dt(fam, co, P0, tdts, torch.tensor(np.asarray(b_s)), torch.tensor(np.asarray(C_s)))
    b_x, C_x, ell_x, g_x, L_x = _jax_pkfs(ssm, ys)
    for ref_b, ref_C, ref_ell in ((b_s, C_s, ell_s), (b_x, C_x, ell_x)):
        npt.assert_allclose(_np(b), _np(ref_b), rtol=1e-9, atol=1e-10)
        npt.assert_allclose(_np(C), _np(ref_C), rtol=1e-9, atol=1e-10)
        npt.assert_allclose(float(ell_t), float(ref_ell), rtol=1e-10)
    npt.assert_allclose(_np(g), _np(g_s), rtol=1e-8, atol=1e-9)
    npt.assert_allclose(_np(L), _np(L_s), rtol=1e-8, atol=1e-9)


@pytest.mark.parametrize("T", [1, 64, 65, 300], ids=lambda T: f"T{T}")
def test_chunked_passes_compose_to_the_plain_engine(T):
    """The plain versions of the four kernel passes (chunk totals, exclusive
    chunk prefixes, seeded re-scan), which the kernels are held against on
    the card, give the plain filter and smoother at any chunk remainder."""
    t, y = _data(T, 3)
    fam, co, P0, H, R, dts, ty = _torch_inputs(tk.Matern52(0.9, 0.45, dtype=torch.float64, device="cpu"), t, y)
    with torch.no_grad():
        b0, C0, ell0 = tdt.strip_filter_dt_plain(fam, co, P0, H, R, dts, ty)
        g0, L0 = tdt.strip_smoother_dt_plain(fam, co, P0, dts, b0, C0)
        tot = tdt.dt_filter_scan(fam, co, P0, H, R, dts, ty)
        assert tot.shape == (tdt.filt_rows(3), tdt.n_chunks(T))
        pre = tdt.exclusive_chunk_prefixes(tot, 3, reverse=False)
        b, C, ell = tdt.dt_filter_apply(fam, co, P0, H, R, dts, ty, pre)
        tot = tdt.dt_smoother_scan(fam, co, P0, dts, b0, C0)
        assert tot.shape == (tdt.smooth_rows(3), tdt.n_chunks(T))
        pre = tdt.exclusive_chunk_prefixes(tot, 3, reverse=True)
        g, L = tdt.dt_smoother_apply(fam, co, P0, dts, b0, C0, pre)
    for a, ref in ((b, b0), (C, C0), (g, g0), (L, L0)):
        npt.assert_allclose(_np(a), _np(ref), rtol=1e-10, atol=1e-12)
    npt.assert_allclose(float(ell), float(ell0), rtol=1e-12)


def test_blocked_scan_matches_flat_scan():
    """Two-level Kogge–Stone (T ≥ 8192) == flat Kogge–Stone."""
    t, y = _data(8200, 5)
    fam, co, P0, H, R, dts, ty = _torch_inputs(tk.Matern12(1.0, 0.3, dtype=torch.float64, device="cpu"), t, y)
    with torch.no_grad():
        Fs, Qs, P0s = tdt.build_planes_tl(fam, co, P0, dts)
        e = ttl._filtering_elements_from_planes(P0s, Fs, Qs, H, R, ty)
        ident = ttl.filtering_identity_tl(1, torch.float64)
        blocked = ttl.kogge_stone_scan_tl(ttl.filtering_operator_tl, e, ident)
        flat = ttl._kogge_stone_flat_tl(ttl.filtering_operator_tl, e, ident)
    npt.assert_allclose(_np(blocked.b), _np(flat.b), rtol=1e-10, atol=1e-12)
    npt.assert_allclose(_np(blocked.C), _np(flat.C), rtol=1e-10, atol=1e-12)
