"""PyTorch port vs the JAX package on the quasi-periodic model
(Periodic(order=1) × Matern32, d = 8, the composite family at the dt
kernels' largest state): the plain versions of the five dt kernels and the
model's LML, gradient and predict_f; the sum_m32_m12 model's LML and
gradient; and the d = 14 Periodic(order=6) and d = 18 CO2 composites on the
plain time-last engine.  f64 on the CPU.  JAX references compiled at XLA's
lowest backend level (``jit_o0``), one length each; the engine-level ones
run on the port's model handed across (``port_model``)."""
import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import parallel_gps_tpu.kernels as jk
from parallel_gps_torch import StateSpaceGP
from parallel_gps_torch.kalman import dt as tdt
from parallel_gps_torch.kalman import strip as tstrip
from parallel_gps_torch.kalman import timelast as ttl
from parallel_gps_torch.kernels.composite import COMPOSITE
from parallel_gps_torch.types import LGSSMTL
from parallel_gps_tpu.kalman import sequential as jseq
from parallel_gps_tpu.kalman import timelast as jtl
from parallel_gps_tpu.models import StateSpaceGP as JaxStateSpaceGP
from _torch_common import _np, jit_o0, port_model
from _torch_composite import CPU64, data, jax_spec, port_kernel, qp

torch.set_num_threads(1)

NOISE = 0.1
T = 300


def _unbalanced(jkern):
    """The JAX kernel with its Sum's or Product's balancing off: a
    similarity of the state that carries no gradient (stop_gradient) leaves
    the LML and its gradient unchanged, and the balancing, traced and
    unrolled into the reference's program, is two thirds of its compile
    (the balanced build is held in test_torch_composite_build.py)."""
    return type(jkern)(kernels=jkern.kernels, balancing_iter=0)


@pytest.fixture(scope="module")
def qp_models():
    """The JAX QP model on the sequential engine, unbalanced, and the
    port's from the QP kernel's numpy values (the spec of its kernel
    tree)."""
    t, y = data(T, 17)
    jm = JaxStateSpaceGP.create((t, y), _unbalanced(qp()), noise_variance=NOISE, parallel=False)
    tm = StateSpaceGP.from_numpy(t, y, jax_spec(qp()), noise_variance=np.array(jm.noise_variance), **CPU64)
    return jm, tm


def _constrained_grads(tm):
    """LML and its gradient w.r.t. the constrained hyperparameters, in the
    model's parameter order (the raw gradients over the softplus
    derivative)."""
    tm.zero_grad(set_to_none=True)
    ell = tm.log_marginal_likelihood()
    ell.backward()
    return float(ell.detach()), {n: float(p.grad / torch.sigmoid(p.detach())) for n, p in tm.named_parameters()}


def _jax_grads(jm):
    """The same for a JAX model: the gradient of its LML w.r.t. its kernel's
    leaves and its noise variance, by the port's parameter names."""
    v, (gk, gn) = jit_o0(
        jax.value_and_grad(lambda k, n: jm.replace(kernel=k, noise_variance=n).log_marginal_likelihood(), argnums=(0, 1))
    )(jm.kernel, jm.noise_variance)
    out = {"raw_noise_variance": float(gn)}

    def walk(k, prefix):
        if type(k).__name__ in ("Sum", "Product"):
            for i, c in enumerate(k.kernels):
                walk(c, f"{prefix}kernels.{i}.")
            return
        for f in ("variance", "lengthscales", "period"):
            if hasattr(k, f):
                out[f"{prefix}raw_{f}"] = float(getattr(k, f))

    walk(gk, "kernel.")
    return float(v), out


def test_qp_model_lml_and_gradient_match_jax(qp_models):
    """The model's LML (1e-10) and its gradient w.r.t. all six constrained
    hyperparameters (rtol 1e-7, atol 1e-10: test_pallas_dt.py:169-170)
    against the JAX model's, the port (balanced) on the dt engine's plain
    versions."""
    jm, tm = qp_models
    engine, (family, _) = tm.engine()
    assert engine == "dt" and family == COMPOSITE and tm.kernel.state_dim == 8
    v_t, g_t = _constrained_grads(tm)
    v_j, g_j = _jax_grads(jm)
    npt.assert_allclose(v_t, v_j, rtol=1e-10)
    assert set(g_t) == set(g_j)
    for n in g_t:
        npt.assert_allclose(g_t[n], g_j[n], rtol=1e-7, atol=1e-10, err_msg=n)


def test_qp_predict_f_matches_jax(qp_models):
    """predict_f at unsorted queries, some outside the data, against the
    JAX sequential smoother on the port's model of the merged times (the
    model's build is held by the LML test): 1e-8."""
    _, tm = qp_models
    Xnew = np.random.RandomState(5).rand(23) * 1.2 - 0.1
    mean_t, var_t = tm.predict_f(Xnew)
    times = np.concatenate([_np(tm.ts), Xnew])
    order = np.argsort(times, kind="stable")
    ys = np.concatenate([_np(tm.ys), np.full(23, np.nan)])[order]
    jssm, _ = port_model(tm.kernel, times[order], NOISE, time_last=False)
    ms, Ps = jit_o0(jseq.kfs)(jssm, jnp.asarray(ys).reshape(-1, 1))
    h = _np(jssm.H)[0]
    where = np.argsort(order)[_np(tm.ts).shape[0] :]
    npt.assert_allclose(_np(mean_t)[:, 0], _np(ms)[where] @ h, rtol=1e-8, atol=1e-8)
    npt.assert_allclose(_np(var_t)[:, 0], np.einsum("i,tij,j->t", h, _np(Ps)[where], h), rtol=1e-8, atol=1e-8)


def test_qp_plain_passes_and_fisher_tail_match_jax(qp_models):
    """The dt kernels' plain versions on the QP model — filter scan and
    apply on the plain prefixes, smoother scan and apply, and the Fisher
    tail — against the JAX time-last engine and its Fisher tail on the same
    model: filter 1e-8 / 1e-9 and LML rtol 1e-9, smoother 1e-8 / 1e-9,
    Fisher cotangents rtol 1e-8 / atol 1e-10 (d_coeffs through the planes'
    chain rule)."""
    _, tm = qp_models
    jssm, ssm = port_model(tm.kernel, _np(tm.ts), NOISE)
    ys = jnp.asarray(_np(tm.ys)).reshape(-1, 1)

    @jit_o0
    def reference(s, y):
        b, C, ell = jtl.pkf_from_tl(s, y, True)
        g, L = jtl.pks_from_tl(s, b, C)
        ct, dy = jtl.fisher_grads_from_smoothed(s, y, b, C, g, L, jnp.ones(()))
        return b, C, ell, g, L, ct, dy

    b_j, C_j, ell_j, g_j, L_j, ct_j, dy_j = reference(jssm, ys)
    with torch.no_grad():
        fam, co = tm.kernel.transition_coeffs()
        P0, H, R, dts, y = ssm.P0, ssm.H, torch.tensor([[NOISE]], dtype=torch.float64), tdt._dts_from_ts(tm.ts), tm.ys
        pre = tstrip.exclusive_chunk_prefixes(tdt.dt_filter_scan_plain(fam, co, P0, H, R, dts, y), 8, reverse=False)
        b, C, ell = tdt.dt_filter_apply_plain(fam, co, P0, H, R, dts, y, pre)
        pre_s = tstrip.exclusive_chunk_prefixes(tdt.dt_smoother_scan_plain(fam, co, P0, dts, b, C), 8, reverse=True)
        g, L = tdt.dt_smoother_apply_plain(fam, co, P0, dts, b, C, pre_s)
    assert pre.shape == (tstrip.filt_rows(8), tstrip.n_chunks(T))
    npt.assert_allclose(_np(b), _np(b_j), rtol=1e-8, atol=1e-9)
    npt.assert_allclose(_np(C), _np(C_j), rtol=1e-8, atol=1e-9)
    npt.assert_allclose(float(ell), float(ell_j), rtol=1e-9)
    npt.assert_allclose(_np(g), _np(g_j), rtol=1e-8, atol=1e-9)
    npt.assert_allclose(_np(L), _np(L_j), rtol=1e-8, atol=1e-9)
    mom = [x.contiguous() for x in (b, C, g, L)]
    d_co, d_P0, d_H, d_R, d_dts, d_y = tdt.dt_fisher_plain(fam, co, P0, H, R, dts, y, *mom)
    cts = (torch.tensor(_np(ct_j.Fs)), torch.tensor(_np(ct_j.Qs)), torch.tensor(_np(ct_j.P0)))
    with torch.enable_grad():
        c_, d_ = co.detach().requires_grad_(), dts.detach().requires_grad_()
        planes = tdt.build_planes_tl(fam, c_, P0, d_)
        ref_co, ref_dts = torch.autograd.grad(planes[:2], (c_, d_), cts[:2])
    npt.assert_allclose(_np(d_co), _np(ref_co), rtol=1e-8, atol=1e-10)
    npt.assert_allclose(_np(d_dts), _np(ref_dts), rtol=1e-8, atol=1e-10)
    npt.assert_allclose(_np(d_H), _np(ct_j.H), rtol=1e-8, atol=1e-10)
    npt.assert_allclose(_np(d_R), _np(ct_j.R), rtol=1e-8, atol=1e-10)
    npt.assert_allclose(_np(d_y), _np(dy_j).reshape(-1), rtol=1e-8, atol=1e-10)
    # d_P0: the planes' P0 cotangent plus the build's, symmetrised.
    with torch.enable_grad():
        p_ = P0.detach().requires_grad_()
        (ref_p0,) = torch.autograd.grad(tdt.build_planes_tl(fam, co, p_, dts)[1:], p_, cts[1:])
    npt.assert_allclose(_np(d_P0), _np(0.5 * (ref_p0 + ref_p0.T)), rtol=1e-8, atol=1e-10)


def test_sum_model_lml_and_gradient_match_jax():
    """The sum_m32_m12 model (test_pallas_dt.py:92, d = 3) on the dt engine:
    LML 1e-10 and gradient rtol 1e-7 / atol 1e-10 against the JAX model
    (unbalanced, as the QP's)."""
    t, y = data(T, 18)
    jkern = jk.Matern32(1.1, 0.5) + jk.Matern12(0.8, 0.3)
    jm = JaxStateSpaceGP.create((t, y), _unbalanced(jkern), noise_variance=NOISE, parallel=False)
    tm = StateSpaceGP.from_numpy(t, y, jax_spec(jkern), noise_variance=np.array(jm.noise_variance), **CPU64)
    assert tm.engine()[0] == "dt"
    v_t, g_t = _constrained_grads(tm)
    v_j, g_j = _jax_grads(jm)
    npt.assert_allclose(v_t, v_j, rtol=1e-10)
    for n in g_t:
        npt.assert_allclose(g_t[n], g_j[n], rtol=1e-7, atol=1e-10, err_msg=n)


LARGE = [
    ("periodic6_d14", jk.Periodic(1.0, 1.0, period=0.5, order=6)),
    ("co2_d18", jk.Periodic(1.0, 0.5, 1.0, order=3) * jk.Matern32(1.0, 0.5) + jk.Matern32(0.5, 2.0)),
]


@pytest.mark.parametrize("name,jkern", LARGE, ids=[n for n, _ in LARGE])
def test_large_composites_take_the_time_last_engine(name, jkern):
    """Above d = 8 a composite takes the plain time-last engine (as the JAX
    package's XLA route does): the model's LML against the JAX sequential
    filter on the same model (1e-10); the d = 14 Periodic's stationary
    covariance against the JAX package's get_sde (1e-11; the d = 18
    composite's transitions are test_torch_composite_build.py's, its
    Sum-of-Product SDE build the d = 10 co2_shape's there)."""
    t, y = data(200, 19)
    tkern = port_kernel(jkern)
    tm = StateSpaceGP.create((t, y), tkern, NOISE, **CPU64)
    assert tm.engine() == ("timelast", None) and tkern.state_dim in (14, 18)
    with torch.no_grad():
        if tkern.state_dim == 14:
            npt.assert_allclose(_np(tkern.get_sde().P0), _np(jkern.get_sde().P0), rtol=1e-11, atol=1e-13)
        ell = float(tm.log_marginal_likelihood())
    jssm, _ = port_model(tkern, t, NOISE, time_last=False)
    ell_j = float(jit_o0(lambda s, o: jseq.kf(s, o, return_loglikelihood=True)[2])(jssm, jnp.asarray(y).reshape(-1, 1)))
    npt.assert_allclose(ell, ell_j, rtol=1e-10)
