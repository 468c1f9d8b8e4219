"""PyTorch port vs the JAX package: the dt-engine filter and smoother
(parallel_gps_torch.kalman.dt, plain versions on the CPU) against
parallel_gps_tpu's dt kernels in interpret mode and its time-last engine,
f64, same numpy inputs; and the CPU dispatch contract of the kernel
wrappers."""
import contextlib
import json
import subprocess
import sys
import textwrap

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
from parallel_gps_tpu.kalman.pallas_dt import (
    _dts_from_ts,
    strip_filter_dt,
    strip_smoother_dt,
)
from parallel_gps_tpu.kalman.timelast import pkf_from_tl, pks_from_tl

torch.set_num_threads(1)


@contextlib.contextmanager
def _no_compile_cache():
    """Interpret-mode programs segfault in the persistent compilation cache
    (see test_model_interpret.py); disable it around them, and only there:
    the jitted references keep the cache."""
    from jax._src import compilation_cache as _cc

    jax.config.update("jax_enable_compilation_cache", False)
    _cc.reset_cache()
    try:
        yield
    finally:
        jax.config.update("jax_enable_compilation_cache", True)
        _cc.reset_cache()


def _data(T, seed):
    rng = np.random.RandomState(seed)
    t = np.sort(rng.rand(T))
    y = np.sin(12.0 * t) + 0.3 * rng.randn(T)
    y[rng.choice(T, T // 9, replace=False)] = np.nan
    return t, y


def _torch_inputs(tkern, t, y):
    with torch.no_grad():
        family, coeffs = tkern.transition_coeffs()
        sde = tkern.get_sde()
    dts = tdt._dts_from_ts(torch.tensor(t))
    R = torch.tensor([[0.1]], dtype=torch.float64)
    return family, coeffs, sde.P0, sde.H, R, dts, torch.tensor(y)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


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


@pytest.fixture(scope="module")
def fresh_process_facts():
    """Import the port and each of its modules (the probe programs too) in a
    fresh interpreter, run the model once on the CPU at T = 70 (LML, a
    gradient, predict_f, a step of each optimiser and a batched LML with its
    gradient), and report which modules were loaded and which kernels
    launched."""
    code = textwrap.dedent(
        """
        import json, sys
        import parallel_gps_torch as pgt
        import parallel_gps_torch.inference.optim, parallel_gps_torch.models.params
        import parallel_gps_torch.kalman.dt, parallel_gps_torch.kalman.timelast
        import parallel_gps_torch.kalman.batched, parallel_gps_torch.inference.mcmc
        import parallel_gps_torch.experiments.common
        import parallel_gps_torch.probes.dma, parallel_gps_torch.probes.attrib, parallel_gps_torch.probes.grid
        import numpy as np
        import torch
        from parallel_gps_torch.kalman import batched, dt
        rng = np.random.RandomState(0)
        t = np.sort(rng.rand(70)); y = np.sin(t); y[::7] = np.nan
        m = pgt.StateSpaceGP.from_numpy(t, y, "Matern52", 0.8, 0.4, 0.1, dtype=torch.float64, device="cpu")
        m.log_marginal_likelihood().backward(); m.predict_f(rng.rand(5))
        pgt.inference.fit_adam(m, n_iters=1); pgt.inference.fit_lbfgs(m, n_iters=1)
        chains = pgt.StateSpaceGP.from_numpy(t, y, "Matern52", np.full(3, 0.8), np.full(3, 0.4), np.full(3, 0.1),
                                             dtype=torch.float64, device="cpu")
        chains.log_marginal_likelihood().sum().backward()
        foreign = ("jax", "jaxlib", "flax", "optax", "parallel_gps_tpu")
        print(json.dumps({
            "jax_modules": sorted(m for m in sys.modules if m.split(".")[0] in foreign),
            "launches": {**dt.LAUNCHES, **batched.LAUNCHES},
            "cuda_loader_imported": "parallel_gps_torch.kalman._cuda" in sys.modules,
        }))
        """
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_port_imports_no_jax(fresh_process_facts):
    """Importing and running the port (serving and training) leaves jax,
    flax, optax and the JAX package unloaded."""
    assert fresh_process_facts["jax_modules"] == []


def test_cpu_dispatch_launches_no_kernel_and_loads_no_build_step(fresh_process_facts):
    """On the CPU every wrapper takes its plain version: no launch counter
    moves and the CUDA loader (kalman/_cuda.py) is never imported."""
    assert set(fresh_process_facts["launches"].values()) == {0}
    assert not fresh_process_facts["cuda_loader_imported"]


def test_non_cpu_tensors_never_fall_back_to_the_plain_version():
    """A tensor on a device other than the CPU goes to the kernel wrapper,
    which refuses what it cannot launch instead of falling back."""
    fam, co, P0, H, R, dts, ty = _torch_inputs(tk.Matern32(1.0, 0.5, dtype=torch.float64, device="cpu"), *_data(50, 1))
    meta = [x.to("meta") for x in (co, P0, H, R, dts, ty)]
    with pytest.raises(ValueError, match="CUDA device"):
        tdt.strip_filter_dt(fam, *meta)
    b, C = torch.zeros(2, 50, device="meta"), torch.zeros(2, 2, 50, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        tdt.dt_smoother_scan(fam, meta[0], meta[1], meta[4], b, C)
    with pytest.raises(ValueError, match="CUDA device"):
        tdt.dt_fisher(fam, *meta, b, C, b, C)
    assert set(tdt.LAUNCHES) == {"dt_filter_scan", "dt_filter_apply", "dt_smoother_scan", "dt_smoother_apply", "dt_fisher"}
    assert set(tdt.LAUNCHES.values()) == {0}


def test_lml_dt_gradient_is_the_fisher_backward():
    """``lml_dt`` is differentiable: its backward (smoother + Fisher tail)
    gives the gradient that autograd through the plain filter's scan gives,
    rtol 1e-7 / atol 1e-10 (tests/test_torch_fisher.py holds it against the
    JAX package)."""
    t, y = _data(40, 2)
    R = torch.tensor([[0.1]], dtype=torch.float64)
    grads = []
    for through_scan in (False, True):
        k = tk.Matern32(1.0, 0.5, dtype=torch.float64, device="cpu")
        if through_scan:
            ell = ttl.pkf_from_tl(k.get_ssm_tl(torch.tensor(t), R), torch.tensor(y), True)[2]
        else:
            ell = tdt.lml_dt(k, torch.tensor(t), R, torch.tensor(y))
        assert ell.requires_grad
        ell.backward()
        grads.append([k.raw_variance.grad.item(), k.raw_lengthscales.grad.item()])
    npt.assert_allclose(grads[0], grads[1], rtol=1e-7, atol=1e-10)
