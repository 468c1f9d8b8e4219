"""PyTorch port vs the JAX package: the batched path — B series (or chains)
at once.  The plain versions of the single-pass batched filter and smoother
(kalman/batched.py) against the JAX package's batched kernels in interpret
mode; the batched ``lml_dt`` and log posterior against ``jax.vmap`` of the JAX
model's; the batch axis of the Fisher tail and of the SDE build against loops
over single series.  f64 on the CPU, same numpy inputs through both packages.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import parallel_gps_tpu.kernels as jk
from parallel_gps_torch import StateSpaceGP
from parallel_gps_torch import kernels as tk
from parallel_gps_torch.inference import make_log_posterior
from parallel_gps_torch.kalman import batched as tb
from parallel_gps_torch.kalman import dt as tdt
from parallel_gps_torch.kalman import timelast as ttl
from parallel_gps_torch.models.params import log_prior, positions_from_tree, positions_to_tree
from parallel_gps_torch.ops.balance import balance_scale
from parallel_gps_torch.ops.lyapunov import solve_lyap_vec
from parallel_gps_torch.types import LGSSMTL
from parallel_gps_tpu.inference.optim import make_log_posterior as jax_make_log_posterior
from parallel_gps_tpu.kalman.pallas_scan import batched_strip_filter as jax_batched_filter
from parallel_gps_tpu.kalman.pallas_scan import batched_strip_smoother as jax_batched_smoother
from parallel_gps_tpu.models import StateSpaceGP as JaxStateSpaceGP

torch.set_num_threads(1)

B, T, BLOCK = 9, 17, 16  # as tests/test_batched_pallas.py: more than 8 series; two time blocks, the second ragged
MATERN = [("Matern12", 1), ("Matern32", 2), ("Matern52", 3)]


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


def _t(x):
    return torch.tensor(np.asarray(x))


def _series(n, T, seed, nan_frac=0.15):
    """Shared sorted times and n observation vectors with NaNs."""
    rng = np.random.RandomState(seed)
    t = np.sort(rng.rand(T)) * 4.0
    ys = np.sin(7 * t)[None] + 0.1 * rng.randn(n, T)
    ys[rng.rand(n, T) < nan_frac] = np.nan
    return t, ys


def _torch_planes(make, n, t):
    """Stacked planes and leaves of n port models with their own
    hyperparameters: (P0 (n,d,d), H (n,1,d), R (n,1,1), Fs, Qs (d,d,n,T))."""
    ssms = []
    with torch.no_grad():
        for i in range(n):
            R = torch.tensor([[0.1 + 0.02 * i]], dtype=torch.float64)
            ssms.append(make(0.5 + 0.3 * i, 0.2 + 0.1 * i).get_ssm_tl(_t(t), R))
    stack = lambda leaf, axis: torch.stack([getattr(s, leaf) for s in ssms], axis)  # noqa: E731
    return stack("P0", 0), stack("H", 0), stack("R", 0), stack("Fs", 2), stack("Qs", 2)


def _kernel_maker(d):
    if d <= 3:
        cls = {1: tk.Matern12, 2: tk.Matern32, 3: tk.Matern52}[d]
        return lambda v, ell: cls(v, ell, dtype=torch.float64, device="cpu")
    return lambda v, ell: tk.RBF(v, ell, order=d, dtype=torch.float64, device="cpu")


@pytest.fixture(scope="module")
def jax_batch():
    """One evaluation of the JAX batched kernels in interpret mode, as
    tests/test_batched_pallas.py runs them, shared by the assertions below."""
    t, ys = _series(B, T, 0)
    ssms = []
    for i in range(B):
        k = jk.Matern32(variance=0.5 + i * 0.3, lengthscales=0.2 + 0.1 * i)
        ssms.append(k.get_ssm_tl(jnp.asarray(t).reshape(-1, 1), jnp.asarray(0.1 + 0.02 * i).reshape(1, 1)))
    Fs, Qs = (jnp.stack([getattr(s, n) for s in ssms], axis=2) for n in ("Fs", "Qs"))
    P0, H, R = (jnp.stack([getattr(s, n) for s in ssms]) for n in ("P0", "H", "R"))
    with _no_compile_cache():
        b, C, ell = jax_batched_filter(Fs, Qs, P0, H, R, jnp.asarray(ys), block=BLOCK, interpret=True)
        g, L, mean, var = jax_batched_smoother(Fs, Qs, b, C, H, block=BLOCK, interpret=True)
    inputs = tuple(_t(x) for x in (Fs, Qs, P0, H, R, ys))
    return inputs, tuple(np.asarray(x) for x in (b, C, ell, g, L, mean, var))


def test_plain_batched_filter_matches_the_jax_batched_kernel(jax_batch):
    (Fs, Qs, P0, H, R, ys), (b_j, C_j, ell_j, *_) = jax_batch
    b, C, ell = tb.batched_strip_filter(Fs, Qs, P0, H, R, ys)  # the CPU takes the plain version
    assert b.shape == (2, B, T) and C.shape == (2, 2, B, T) and ell.shape == (B,)
    # tests/test_batched_pallas.py:73-75
    npt.assert_allclose(b.numpy(), b_j, rtol=1e-9, atol=1e-11)
    npt.assert_allclose(C.numpy(), C_j, rtol=1e-9, atol=1e-11)
    npt.assert_allclose(ell.numpy(), ell_j, rtol=1e-10)


@pytest.mark.parametrize("project", [True, False], ids=["project", "moments"])
def test_plain_batched_smoother_matches_the_jax_batched_kernel(jax_batch, project):
    (Fs, Qs, _, H, _, _), (b_j, C_j, _, g_j, L_j, mean_j, var_j) = jax_batch
    out = tb.batched_strip_smoother(Fs, Qs, _t(b_j), _t(C_j), H if project else None, project=project)
    assert len(out) == (4 if project else 2)
    # tests/test_batched_pallas.py:76-86
    npt.assert_allclose(out[0].numpy(), g_j, rtol=1e-8, atol=1e-10)
    npt.assert_allclose(out[1].numpy(), L_j, rtol=1e-8, atol=1e-10)
    if project:
        npt.assert_allclose(out[2].numpy(), mean_j, rtol=1e-8)
        npt.assert_allclose(out[3].numpy(), var_j, rtol=1e-8)


@pytest.mark.parametrize("d", [1, 2, 3, 6])
def test_plain_batched_engine_matches_single_series(d):
    """Series i of the batched result against the single-series time-last
    engine on series i, at an odd T with NaNs (d = 6: RBF planes)."""
    n, T_odd = 5, 37
    t, ys = _series(n, T_odd, 10 + d)
    P0, H, R, Fs, Qs = _torch_planes(_kernel_maker(d), n, t)
    ys = _t(ys)
    b, C, ell = tb.batched_strip_filter_plain(Fs, Qs, P0, H, R, ys)
    g, L, mean, var = tb.batched_strip_smoother_plain(Fs, Qs, b, C, H)
    rf, af, rs, as_ = (1e-9, 1e-11, 1e-8, 1e-10) if d <= 3 else (1e-8, 1e-10, 1e-7, 1e-9)
    for i in range(n):
        ssm = LGSSMTL(P0[i], Fs[:, :, i], Qs[:, :, i], H[i], R[i])
        b_i, C_i, ell_i = ttl.pkf_from_tl(ssm, ys[i], True)
        g_i, L_i = ttl.pks_from_tl(ssm, b_i, C_i)
        npt.assert_allclose(b[:, i].numpy(), b_i.numpy(), rtol=rf, atol=af)
        npt.assert_allclose(C[:, :, i].numpy(), C_i.numpy(), rtol=rf, atol=af)
        npt.assert_allclose(float(ell[i]), float(ell_i), rtol=1e-10)
        npt.assert_allclose(g[:, i].numpy(), g_i.numpy(), rtol=rs, atol=as_)
        npt.assert_allclose(L[:, :, i].numpy(), L_i.numpy(), rtol=rs, atol=as_)
        h = H[i, 0]
        npt.assert_allclose(mean[i].numpy(), (h @ g_i).numpy(), rtol=rs, atol=as_)
        npt.assert_allclose(var[i].numpy(), torch.einsum("a,abt,b->t", h, L_i, h).numpy(), rtol=rs, atol=as_)


def test_shared_operands_equal_expanded_ones():
    """One model and n observation vectors (planes with batch stride 0), and
    one observation vector for n models: the bits of the expanded operands."""
    n, T_odd = 4, 33
    t, ys = _series(n, T_odd, 3)
    P0, H, R, Fs, Qs = _torch_planes(_kernel_maker(2), 1, t)
    shared = (Fs.expand(2, 2, n, T_odd), Qs.expand(2, 2, n, T_odd), P0.expand(n, 2, 2), H.expand(n, 1, 2), R.expand(n, 1, 1))
    assert shared[0].stride(2) == 0
    out_s = tb.batched_strip_filter(*shared, _t(ys))
    out_e = tb.batched_strip_filter(*(x.contiguous() for x in shared), _t(ys))
    for a, b_ in zip(out_s, out_e):
        assert torch.equal(a, b_)
    sm_s = tb.batched_strip_smoother(shared[0], shared[1], out_s[0], out_s[1], shared[3])
    sm_e = tb.batched_strip_smoother(shared[0].contiguous(), shared[1].contiguous(), out_e[0], out_e[1], shared[3].contiguous())
    for a, b_ in zip(sm_s, sm_e):
        assert torch.equal(a, b_)
    # One (T,) observation vector shared by n models.
    P0, H, R, Fs, Qs = _torch_planes(_kernel_maker(3), n, t)
    y_shared = tb.series_observations(_t(ys[0]), (n, T_odd))
    assert y_shared.shape == (n, T_odd) and y_shared.stride(0) == 0
    for a, b_ in zip(tb.batched_strip_filter(Fs, Qs, P0, H, R, y_shared), tb.batched_strip_filter(Fs, Qs, P0, H, R, y_shared.contiguous())):
        assert torch.equal(a, b_)


def test_kernel_operand_layouts():
    """What the wrappers hand the kernels: (tensor, plane stride, batch
    stride) — an expanded view as it is with batch stride 0, a view the
    kernels cannot address as a contiguous copy."""
    planes = torch.arange(2 * 2 * 7, dtype=torch.float64).reshape(2, 2, 1, 7)
    x, ps, bs = tb._strided(planes.expand(2, 2, 5, 7), 2)
    assert (ps, bs) == (7, 0) and x.data_ptr() == planes.data_ptr()
    x, ps, bs = tb._strided(torch.zeros(2, 2, 5, 7, dtype=torch.float64), 2)
    assert (ps, bs) == (35, 7)
    time_first = torch.zeros(7, 5, 2, 2, dtype=torch.float64).permute(2, 3, 1, 0)
    x, ps, bs = tb._strided(time_first, 2)
    assert x.is_contiguous() and (ps, bs) == (35, 7)
    y, _, bs = tb._strided(torch.zeros(7, dtype=torch.float64).reshape(1, 7).expand(5, 7), 0)
    assert bs == 0
    m, ps, bs = tb._strided(torch.zeros(3, 5, 7, dtype=torch.float64), 1)
    assert (ps, bs) == (35, 7)


def test_cuda_wrappers_refuse_other_devices_and_count_nothing_on_the_cpu():
    """A tensor off the CPU goes to the kernel wrapper, which refuses what it
    cannot launch instead of taking the plain version."""
    planes = torch.zeros(2, 2, 3, 9, device="meta", dtype=torch.float64)
    mom = torch.zeros(2, 3, 9, device="meta", dtype=torch.float64)
    leaves = [torch.zeros(s, device="meta", dtype=torch.float64) for s in ((3, 2, 2), (3, 1, 2), (3, 1, 1), (3, 9))]
    with pytest.raises(ValueError, match="CUDA device"):
        tb.batched_strip_filter(planes, planes, *leaves)
    with pytest.raises(ValueError, match="CUDA device"):
        tb.batched_strip_smoother(planes, planes, mom, planes, leaves[1])
    co = torch.zeros(3, 5, device="meta", dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA device"):
        tdt.dt_fisher("exppoly", co, *leaves[:3], torch.zeros(9, device="meta", dtype=torch.float64), leaves[3], mom, planes, mom, planes)
    assert tb.LAUNCHES == {"batched_filter": 0, "batched_smoother": 0}
    assert tdt.LAUNCHES["dt_fisher"] == 0


# --------------------------------------------------------------------------
# Batched SDE build, Fisher tail, LML and log posterior
# --------------------------------------------------------------------------

C_CHAINS = 5
VAR = 0.5 + 0.2 * np.arange(C_CHAINS)
ELL = 0.3 + 0.05 * np.arange(C_CHAINS)
NOISE = 0.1 + 0.02 * np.arange(C_CHAINS)


def _data(T, seed):
    rng = np.random.RandomState(seed)
    t = np.sort(rng.rand(T))
    y = np.sin(12.0 * t) + 0.3 * rng.randn(T)
    y[rng.rand(T) < 0.1] = np.nan
    return t, y


@pytest.mark.parametrize("name,d", MATERN, ids=["m12", "m32", "m52"])
def test_batched_sde_build_equals_a_loop_of_scalar_builds(name, d):
    """``get_sde``, ``transition_coeffs`` and ``balance_scale`` on
    hyperparameters of shape (C,): bit-equal to C scalar builds."""
    kb = getattr(tk, name)(VAR, ELL, dtype=torch.float64, device="cpu")
    with torch.no_grad():
        sde_b = kb.get_sde()
        fam_b, co_b = kb.transition_coeffs()
        assert sde_b.P0.shape == (C_CHAINS, d, d) and sde_b.F.shape == (C_CHAINS, d, d) and co_b.shape[0] == C_CHAINS
        for c in range(C_CHAINS):
            ks = getattr(tk, name)(VAR[c], ELL[c], dtype=torch.float64, device="cpu")
            sde = ks.get_sde()
            fam, co = ks.transition_coeffs()
            assert fam == fam_b and torch.equal(co, co_b[c])
            for leaf_b, leaf in zip(sde_b, sde):
                assert torch.equal(leaf_b[c] if leaf_b.dim() == leaf.dim() + 1 else leaf_b, leaf)
            assert torch.equal(balance_scale(sde_b.F, 7)[c], balance_scale(sde.F, 7))


def test_scalar_and_batched_hyperparameters_broadcast():
    """A kernel with one batched and one scalar hyperparameter builds the
    batch (a sampler with some leaves pinned)."""
    k = tk.Matern52(VAR, 0.4, dtype=torch.float64, device="cpu")
    ref = tk.Matern52(VAR, np.full(C_CHAINS, 0.4), dtype=torch.float64, device="cpu")
    with torch.no_grad():
        assert torch.equal(k.get_sde().P0, ref.get_sde().P0)
        assert torch.equal(k.transition_coeffs()[1], ref.transition_coeffs()[1])


def test_singular_lyapunov_system_raises_alone_and_is_non_finite_in_a_batch():
    """One singular system is an error, as before the batch axis; in a batch
    it makes its own chain non-finite and leaves the others their values."""
    F = _t([[0.0, 1.0], [-3.0, -2.0]])
    L, Q = _t([[0.0], [1.0]]), _t([[2.0]])
    good = solve_lyap_vec(F, L, Q)
    npt.assert_allclose((F @ good + good @ F.T + L @ Q @ L.T).numpy(), 0.0, atol=1e-14)
    singular = torch.zeros_like(F)
    with pytest.raises(torch.linalg.LinAlgError):
        solve_lyap_vec(singular, L, Q)
    both = solve_lyap_vec(torch.stack([F, singular, F]), L, Q)
    assert torch.equal(both[0], good) and torch.equal(both[2], good)
    assert not bool(torch.isfinite(both[1]).all())


@pytest.mark.parametrize("name,d", MATERN, ids=["m12", "m32", "m52"])
@pytest.mark.parametrize("shared_y", [True, False], ids=["chains", "series"])
def test_batched_fisher_plain_matches_single_series(name, d, shared_y):
    """``dt_fisher_plain`` with a batch axis — shared dts, shared or
    per-series y — against the single-series call per series."""
    T_ = 61
    t, ys = _series(C_CHAINS, T_, 5)
    y_b = _t(ys[0]) if shared_y else _t(ys)
    k = getattr(tk, name)(VAR, ELL, dtype=torch.float64, device="cpu")
    with torch.no_grad():
        fam, co = k.transition_coeffs()
        co, P0, H, R, batched = tdt.series_inputs(co, k.get_sde(), _t(NOISE))
        assert batched
        dts = tdt._dts_from_ts(_t(t))
        b, C, _ = tdt.strip_filter_dt(fam, co, P0, H, R, dts, y_b)
        g, L = tdt.strip_smoother_dt(fam, co, P0, dts, b, C)
        assert b.shape == (d, C_CHAINS, T_) and L.shape == (d, d, C_CHAINS, T_)
        out_b = tdt.dt_fisher(fam, co, P0, H, R, dts, y_b, b, C, g, L)  # the CPU takes the plain version
        for c in range(C_CHAINS):
            y_c = y_b if shared_y else y_b[c]
            out = tdt.dt_fisher_plain(fam, co[c], P0[c], H[c], R[c], dts, y_c, b[:, c], C[:, :, c], g[:, c], L[:, :, c])
            for a, ref in zip(out_b, out):
                assert a[c].shape == ref.shape
                npt.assert_allclose(a[c].numpy(), ref.numpy(), rtol=1e-10, atol=1e-12)


def _jax_model(name, t, y, c):
    kern = getattr(jk, name)(VAR[c], ELL[c])
    return JaxStateSpaceGP.create((t, y), kern, noise_variance=NOISE[c])


PRIORS = {
    "kernel.lengthscales": (lambda x: -3.0 * x, "constrained"),
    "kernel.variance": lambda u: -0.25 * u * u,
    "noise_variance": lambda u: -0.5 * (u + 1.0) ** 2,
}


@pytest.mark.parametrize("name,d", MATERN, ids=["m12", "m32", "m52"])
def test_batched_log_posterior_value_and_gradient_match_jax_vmap(name, d):
    """The model on hyperparameters of shape (C,) — ``functional_call`` with
    every leaf (C,) — against ``jax.vmap(jax.value_and_grad(log_post))`` of
    the JAX model: value rtol 1e-9, gradient rtol 1e-7."""
    t, y = _data(203, 7)
    log_post_j, u0_j = jax_make_log_posterior(_jax_model(name, t, y, 0), PRIORS)
    stacked = jax.tree.map(
        lambda *xs: jnp.stack(xs), *[jax_make_log_posterior(_jax_model(name, t, y, c), None)[1] for c in range(C_CHAINS)]
    )
    val_j, grad_j = jax.jit(jax.vmap(jax.value_and_grad(log_post_j)))(stacked)

    tm = StateSpaceGP.from_numpy(t, y, name, 1.0, 1.0, 1.0, dtype=torch.float64, device="cpu")
    log_post, u0 = make_log_posterior(tm, PRIORS)
    u = {k: v.requires_grad_() for k, v in positions_from_tree(stacked, tm).items()}
    assert set(u) == set(u0) and all(v.shape == (C_CHAINS,) for v in u.values())
    val = log_post(u)
    assert val.shape == (C_CHAINS,)
    npt.assert_allclose(val.detach().numpy(), np.asarray(val_j), rtol=1e-9)
    grads = torch.autograd.grad(val.sum(), list(u.values()))
    got = positions_to_tree(dict(zip(u, grads)))
    npt.assert_allclose(got["kernel"]["variance"], np.asarray(grad_j["kernel"].variance), rtol=1e-7, atol=1e-10)
    npt.assert_allclose(got["kernel"]["lengthscales"], np.asarray(grad_j["kernel"].lengthscales), rtol=1e-7, atol=1e-10)
    npt.assert_allclose(got["noise_variance"], np.asarray(grad_j["noise_variance"]), rtol=1e-7, atol=1e-10)


@pytest.mark.parametrize("name,d", MATERN, ids=["m12", "m32", "m52"])
def test_batched_model_matches_single_models(name, d):
    """A model built from (C,) hyperparameters: LML (C,) and gradients equal
    to those of C scalar models (rtol 1e-9 / 1e-7); scaling chain c's output
    cotangent scales chain c's gradient only."""
    t, y = _data(150, 8)
    mb = StateSpaceGP.from_numpy(t, y, name, VAR, ELL, NOISE, dtype=torch.float64, device="cpu")
    assert mb.engine()[0] == "dt"
    back = mb.to_numpy()
    npt.assert_allclose(back["variance"], VAR, rtol=1e-12)
    npt.assert_allclose(back["noise_variance"], NOISE, rtol=1e-12)
    weights = torch.tensor([1.0, 2.0, 0.0, -1.0, 0.5], dtype=torch.float64)
    lml = mb.log_marginal_likelihood()
    (lml * weights).sum().backward()
    for c in range(C_CHAINS):
        ms = StateSpaceGP.from_numpy(t, y, name, VAR[c], ELL[c], NOISE[c], dtype=torch.float64, device="cpu")
        ref = ms.log_marginal_likelihood()
        ref.backward()
        npt.assert_allclose(float(lml[c].detach()), float(ref.detach()), rtol=1e-9)
        for pb, ps in zip(mb.parameters(), ms.parameters()):
            npt.assert_allclose(float(pb.grad[c]), float(weights[c]) * float(ps.grad), rtol=1e-7, atol=1e-10)


def test_batched_pkfs_dt_and_lml_gradient_in_the_observations():
    """``pkfs_dt`` on batched hyperparameters returns (d, B, T) moments, each
    series the single model's; the LML's gradient in shared observations is
    the sum over the chains."""
    t, y = _data(90, 9)
    kb = tk.Matern32(VAR, ELL, dtype=torch.float64, device="cpu")
    yt = _t(y).requires_grad_()
    with torch.no_grad():
        g, L = tdt.pkfs_dt(kb, _t(t), _t(NOISE), yt)
    assert g.shape == (2, C_CHAINS, 90) and L.shape == (2, 2, C_CHAINS, 90)
    lml = tdt.lml_dt(kb, _t(t), _t(NOISE), yt)
    (dy,) = torch.autograd.grad(lml.sum(), yt)
    total = torch.zeros_like(dy)
    for c in range(C_CHAINS):
        ks = tk.Matern32(VAR[c], ELL[c], dtype=torch.float64, device="cpu")
        R = torch.tensor([[NOISE[c]]], dtype=torch.float64)
        with torch.no_grad():
            g_c, L_c = tdt.pkfs_dt(ks, _t(t), R, _t(y))
        npt.assert_allclose(g[:, c].numpy(), g_c.numpy(), rtol=1e-8, atol=1e-10)
        npt.assert_allclose(L[:, :, c].numpy(), L_c.numpy(), rtol=1e-8, atol=1e-10)
        y_c = _t(y).requires_grad_()
        total += torch.autograd.grad(tdt.lml_dt(ks, _t(t), R, y_c), y_c)[0]
    npt.assert_allclose(dy.numpy(), total.numpy(), rtol=1e-8, atol=1e-12)


def test_batched_lml_tl_on_one_model_and_many_observation_vectors():
    """``lml_tl(strip=True)`` on planes with a batch axis — one Matern32 model
    shared by n observation vectors through stride-0 planes — against n single
    calls: values, and gradients in the observations and in P0."""
    n, T_ = 6, 77
    t, ys = _series(n, T_, 11)
    with torch.no_grad():
        ssm = tk.Matern32(1.0, 0.5, dtype=torch.float64, device="cpu").get_ssm_tl(_t(t), torch.tensor([[0.1]], dtype=torch.float64))
    P0 = ssm.P0.expand(n, 2, 2).clone().requires_grad_()
    ys_b = _t(ys).requires_grad_()
    shared = LGSSMTL(P0, ssm.Fs[:, :, None].expand(2, 2, n, T_), ssm.Qs[:, :, None].expand(2, 2, n, T_), ssm.H.expand(n, 1, 2), ssm.R.expand(n, 1, 1))
    lml = ttl.lml_tl(shared, ys_b, strip=True)
    assert lml.shape == (n,)
    d_y, d_P0 = torch.autograd.grad(lml.sum(), (ys_b, P0))
    for i in range(n):
        y_i, P0_i = _t(ys[i]).requires_grad_(), ssm.P0.clone().requires_grad_()
        ref = ttl.lml_tl(LGSSMTL(P0_i, ssm.Fs, ssm.Qs, ssm.H, ssm.R), y_i, strip=True)
        r_y, r_P0 = torch.autograd.grad(ref, (y_i, P0_i))
        npt.assert_allclose(float(lml[i].detach()), float(ref.detach()), rtol=1e-10)
        npt.assert_allclose(d_y[i].numpy(), r_y.numpy(), rtol=1e-8, atol=1e-12)
        npt.assert_allclose(d_P0[i].numpy(), r_P0.numpy(), rtol=1e-8, atol=1e-12)


def test_log_prior_is_summed_per_chain():
    t, y = _data(10, 0)
    mb = StateSpaceGP.from_numpy(t, y, "Matern32", VAR, ELL, NOISE, dtype=torch.float64, device="cpu")
    per_chain = log_prior(mb, PRIORS, batch_ndim=1)
    assert per_chain.shape == (C_CHAINS,)
    for c in range(C_CHAINS):
        ms = StateSpaceGP.from_numpy(t, y, "Matern32", VAR[c], ELL[c], NOISE[c], dtype=torch.float64, device="cpu")
        npt.assert_allclose(float(per_chain[c].detach()), float(log_prior(ms, PRIORS).detach()), rtol=1e-12)
    npt.assert_allclose(float(log_prior(mb, PRIORS).detach()), float(per_chain.sum().detach()), rtol=1e-12)  # the default sums over every axis


def test_position_trees_round_trip():
    t, y = _data(10, 0)
    tm = StateSpaceGP.from_numpy(t, y, "Matern52", 1.0, 1.0, 1.0, dtype=torch.float64, device="cpu")
    tree = {"kernel": {"variance": np.arange(3.0), "lengthscales": np.arange(3.0) + 5}, "noise_variance": -np.arange(3.0)}
    pos = positions_from_tree(tree, tm)
    assert set(pos) == {"kernel.raw_variance", "kernel.raw_lengthscales", "raw_noise_variance"}
    assert list(pos) == [n for n, _ in tm.named_parameters()]
    back = positions_to_tree(pos)
    npt.assert_array_equal(back["kernel"]["lengthscales"], tree["kernel"]["lengthscales"])
    npt.assert_array_equal(back["noise_variance"], tree["noise_variance"])


def test_what_the_batched_path_does_not_cover_raises():
    t, y = _data(20, 0)
    rbf = StateSpaceGP.from_numpy(t, y, "RBF", VAR, ELL, NOISE, dtype=torch.float64, device="cpu", order=4)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        rbf.log_marginal_likelihood()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        rbf.kernel.get_sde()
    mb = StateSpaceGP.from_numpy(t, y, "Matern32", VAR, ELL, NOISE, dtype=torch.float64, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mb.predict_f(np.array([0.5]))
    seq = StateSpaceGP.from_numpy(t, y, "Matern32", VAR, ELL, NOISE, dtype=torch.float64, device="cpu", parallel=False)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        seq.log_marginal_likelihood()
