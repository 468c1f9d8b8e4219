"""PyTorch port vs the JAX package: composite models (the quasi-periodic
Periodic(order=1) × Matern32, d = 8, and a Sum Matern32 + Periodic ×
Matern12, d = 6, on the dt engine's composite family) on hyperparameters of
shape (C,) against ``jax.vmap(jax.value_and_grad(log_post))`` of the JAX
model and against C scalar models; the plan that the kernels skip by, one
for every chain; a d > 8 composite on the plain time-last engine and one
beyond the plan's limits on the strip engine, each against C scalar models.
f64 on the CPU; JAX references compiled at XLA's lowest backend level
(``jit_o0``)."""
import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import parallel_gps_tpu.kernels as jk
from parallel_gps_torch import StateSpaceGP
from parallel_gps_torch.inference import make_log_posterior
from parallel_gps_torch.kalman import dt as tdt
from parallel_gps_torch.kernels import composite
from parallel_gps_torch.kernels.composite import COMPOSITE
from parallel_gps_torch.models.params import positions_from_tree
from parallel_gps_tpu.inference.optim import make_log_posterior as jax_make_log_posterior
from parallel_gps_tpu.models import StateSpaceGP as JaxStateSpaceGP
from _torch_common import jit_o0
from _torch_composite import CPU64, data, jax_spec

torch.set_num_threads(1)

C = 3
NOISE = np.array([0.1, 0.15, 0.08])
PRIORS = {"lengthscales": (lambda x: -2.0 * x, "constrained"), "variance": lambda u: -0.25 * u * u}


def qp(c):
    """Chain c's quasi-periodic kernel (experiments/common.py:103-112 at
    --qp-order 1), its hyperparameters spread around the CLI's."""
    s = 1.0 + 0.15 * c
    return jk.Periodic(variance=s, lengthscales=1.1 * s, period=0.9 * s, order=1) * jk.Matern32(variance=1.0 / s, lengthscales=0.8 * s)


def sum_kernel(c):
    """Chain c's Sum: Matern32 + Periodic(order=1) × Matern12, d = 6."""
    s = 1.0 + 0.1 * c
    return jk.Matern32(1.1 * s, 0.5 * s) + jk.Periodic(s, 1.0, period=0.5 * s, order=1) * jk.Matern12(1.0, 0.7 / s)


def _unbalanced(k):
    """The JAX kernel with its composites' balancing off: a similarity of
    the state that carries no gradient leaves the LML and its gradient as
    they are, and tracing it is two thirds of the reference's compile."""
    if type(k).__name__ in ("Sum", "Product"):
        return type(k)(kernels=tuple(_unbalanced(c) for c in k.kernels), balancing_iter=0)
    return k


def stacked_spec(make):
    """The port's kernel spec whose leaves hold the C chains' values."""
    specs = [jax_spec(make(c)) for c in range(C)]

    def stack(nodes):
        name, body, *rest = nodes[0]
        if name in ("Sum", "Product"):
            return (name, [stack([n[1][i] for n in nodes]) for i in range(len(body))], *rest)
        return (name, {k: np.stack([n[1][k] for n in nodes]) if k in ("variance", "lengthscales", "period") else v for k, v in body.items()})

    return stack(specs)


@pytest.mark.parametrize("make", [qp, sum_kernel], ids=["qp_d8", "sum_d6"])
def test_batched_composite_log_posterior_value_and_gradient_match_jax_vmap(make):
    """The model on (C,) hyperparameters against ``jax.vmap`` of the JAX
    model's log posterior and its gradient (the JAX sequential engine on the
    unbalanced kernel): value rtol 1e-9, gradient rtol 1e-7."""
    t, y = data(183, 3)
    models = [
        JaxStateSpaceGP.create((t, y), _unbalanced(make(c)), noise_variance=NOISE[c], parallel=False) for c in range(C)
    ]
    log_post_j, _ = jax_make_log_posterior(models[0], PRIORS)
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *[jax_make_log_posterior(m, None)[1] for m in models])
    val_j, grad_j = jit_o0(jax.vmap(jax.value_and_grad(log_post_j)))(stacked)

    tm = StateSpaceGP.from_numpy(t, y, jax_spec(make(0)), noise_variance=0.1, **CPU64)
    log_post, _ = make_log_posterior(tm, PRIORS)
    u = {k: v.requires_grad_() for k, v in positions_from_tree(stacked, tm).items()}
    val = log_post(u)
    engine, (family, coeffs) = tm.engine()  # the engine of the scalar model the positions replace
    assert engine == "dt" and family == COMPOSITE
    npt.assert_allclose(val.detach().numpy(), np.asarray(val_j), rtol=1e-9)
    grads = torch.autograd.grad(val.sum(), list(u.values()))
    flat_j = dict(zip(
        [".".join(str(getattr(e, "name", getattr(e, "key", getattr(e, "idx", "")))) for e in path)
         for path, _ in jax.tree_util.tree_flatten_with_path(grad_j)[0]],
        jax.tree_util.tree_leaves(grad_j),
    ))
    for name, g in zip(u, grads):
        dotted = name.replace("raw_", "")
        npt.assert_allclose(g.numpy(), np.asarray(flat_j[dotted]), rtol=1e-7, atol=1e-10, err_msg=name)


@pytest.mark.parametrize("make", [qp, sum_kernel], ids=["qp_d8", "sum_d6"])
def test_batched_composite_matches_scalar_models(make):
    """A model whose every leaf is (C,): the composite family's coefficients
    (C, n), LML (C,), gradients (each chain's output cotangent its own) and
    predict_f (C, M, 1) equal to C scalar models' (rtol 1e-9 / 1e-7 /
    1e-9)."""
    t, y = data(160, 8)
    X = np.array([0.37, -0.2, 1.4, 0.05, 0.66])
    mb = StateSpaceGP.from_numpy(t, y, stacked_spec(make), noise_variance=NOISE, **CPU64)
    engine, (family, coeffs) = mb.engine()
    assert engine == "dt" and family == COMPOSITE and coeffs.shape == (C, family.plan.n_coeffs)
    weights = torch.tensor([1.0, -0.5, 2.0], dtype=torch.float64)
    lml = mb.log_marginal_likelihood()
    (lml * weights).sum().backward()
    mean, var = mb.predict_f(X)
    assert mean.shape == var.shape == (C, X.size, 1)
    for c in range(C):
        ms = StateSpaceGP.from_numpy(t, y, jax_spec(make(c)), noise_variance=NOISE[c], **CPU64)
        assert ms.engine()[1][0].plan == family.plan
        ref = ms.log_marginal_likelihood()
        ref.backward()
        npt.assert_allclose(float(lml[c].detach()), float(ref.detach()), rtol=1e-9)
        for (n, pb), ps in zip(mb.named_parameters(), ms.parameters()):
            npt.assert_allclose(float(pb.grad[c]), float(weights[c]) * float(ps.grad), rtol=1e-7, atol=1e-10, err_msg=n)
        m_c, v_c = ms.predict_f(X)
        npt.assert_allclose(mean[c].numpy(), m_c.numpy(), rtol=1e-9, atol=1e-12)
        npt.assert_allclose(var[c].numpy(), v_c.numpy(), rtol=1e-9, atol=1e-12)


def test_plan_is_one_for_every_chain_and_holds_each_chains_nonzeros():
    """The plan comes from the kernel's structure: a batch of QP models has
    the scalar model's plan, every chain's nonzero coefficient entries lie
    in its patterns, and the kernels' table of it is the same row for every
    chain.  With one chain's entry of a K_μ set to an exact zero and
    another's not, the batched transitions and LML are each chain's own."""
    t, y = data(90, 4)
    mb = StateSpaceGP.from_numpy(t, y, stacked_spec(qp), noise_variance=NOISE, **CPU64)
    ms = StateSpaceGP.from_numpy(t, y, jax_spec(qp(0)), noise_variance=0.1, **CPU64)
    with torch.no_grad():
        family, coeffs = mb.kernel.transition_coeffs()
        plan = family.plan
        assert plan == ms.kernel.transition_coeffs()[0].plan
        n_w, d2 = len(plan.weights), plan.d * plan.d
        mats = coeffs[:, n_w:].reshape(C, len(plan.monomials), d2)
        patterns = torch.tensor(plan.patterns)
        assert not bool((mats != 0)[:, ~patterns].any())
        table = composite.kernel_layout(family, coeffs)[:, composite.MAX_WEIGHTS + composite.MAX_MONOMIALS * d2 :]
        assert bool((table == table[:1]).all())
        # An entry the pattern holds, zero in chain 0 and not in chain 1.
        mono, entry = next((i, int(p.nonzero()[0])) for i, p in enumerate(patterns) if bool(p.any()))
        edited = coeffs.clone()
        edited[0, n_w + mono * d2 + entry] = 0.0
        assert float(edited[1, n_w + mono * d2 + entry]) != 0.0
        dts = tdt._dts_from_ts(mb.ts)
        planes = composite.composite_transitions_m1(family, edited, dts, plan.d)
        _, P0, H, R, _ = tdt.series_inputs(edited, mb.kernel.get_sde(), mb.noise_variance)
        ell = tdt.lml_dt(mb.kernel, mb.ts, mb.noise_variance, mb.ys, (family, edited))
        for c in range(C):
            one = composite.composite_transitions_m1(family, edited[c], dts, plan.d)
            npt.assert_array_equal(planes[:, :, c].numpy(), one.numpy())
            ell_c = tdt._LmlDt.apply(family, edited[c], P0[c], H[c], R[c], dts, mb.ys)
            npt.assert_allclose(float(ell[c]), float(ell_c), rtol=1e-12)


@pytest.mark.parametrize("case", ["periodic6_d14", "m12x4_strip"])
def test_batched_composite_off_the_dt_engine_matches_scalar_models(case):
    """Periodic(order=6), d = 14, takes the plain time-last engine with the
    batch axis; a product of four Matern12 (monomials of four factors, beyond
    the plan's limits) the strip engine's batched kernels (their plain
    versions here).  LML, gradients and predict_f against C scalar models."""
    t, y = data(140, 6)
    X = np.array([0.5, -0.1, 1.2, 0.25])

    def kern(c):
        s = 1.0 + 0.2 * c
        if case == "periodic6_d14":
            return jk.Periodic(s, 0.9 * s, period=0.7, order=6)
        return jk.Matern12(s, 0.5 * s) * jk.Matern12(1.0, 0.4) * jk.Matern12(1.0, 0.6 * s) * jk.Matern12(1.0, 0.9)

    mb = StateSpaceGP.from_numpy(t, y, stacked_spec(kern), noise_variance=NOISE, **CPU64)
    want = "timelast" if case == "periodic6_d14" else "strip"
    assert mb.engine() == (want, None)
    lml = mb.log_marginal_likelihood()
    lml.sum().backward()
    mean, var = mb.predict_f(X)
    for c in range(C):
        ms = StateSpaceGP.from_numpy(t, y, jax_spec(kern(c)), noise_variance=NOISE[c], **CPU64)
        ref = ms.log_marginal_likelihood()
        ref.backward()
        npt.assert_allclose(float(lml[c].detach()), float(ref.detach()), rtol=1e-9)
        for (n, pb), ps in zip(mb.named_parameters(), ms.parameters()):
            npt.assert_allclose(float(pb.grad[c]), float(ps.grad), rtol=1e-7, atol=1e-10, err_msg=n)
        m_c, v_c = ms.predict_f(X)
        npt.assert_allclose(mean[c].numpy(), m_c.numpy(), rtol=1e-9, atol=1e-12)
        npt.assert_allclose(var[c].numpy(), v_c.numpy(), rtol=1e-9, atol=1e-12)
