"""PyTorch port vs the JAX package: an RBF model on hyperparameters of shape
(C,) — C chains over one series on the dt engine's spectral family — against
``jax.vmap(jax.value_and_grad(log_post))`` of the JAX model, against C
scalar models, and with one chain's hyperparameters overflowing.  f64 on the
CPU; JAX references compiled at XLA's lowest backend level (``jit_o0``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch
from torch.func import functional_call

import parallel_gps_tpu.kernels as jk
from parallel_gps_torch import StateSpaceGP
from parallel_gps_torch.inference import make_log_posterior
from parallel_gps_torch.kernels.rbf import SPECTRAL
from parallel_gps_torch.models.params import positions_from_tree, positions_to_tree
from parallel_gps_tpu.inference.optim import make_log_posterior as jax_make_log_posterior
from parallel_gps_tpu.models import StateSpaceGP as JaxStateSpaceGP
from _torch_batched import PRIORS, _data
from _torch_common import jit_o0

torch.set_num_threads(1)

C = 3
VAR = np.array([0.7, 1.0, 1.3])
ELL = np.array([0.25, 0.3, 0.35])
NOISE = np.array([0.1, 0.15, 0.08])
CPU64 = dict(dtype=torch.float64, device="cpu")


def _stacked_jax_positions(t, y, order):
    """The JAX log posterior of chain 0's model and the C chains' stacked
    unconstrained hyperparameter trees.  The JAX models run the sequential
    engine on the unbalanced kernel: the balancing is a similarity of the
    state that carries no gradient, so it leaves the LML and its gradient
    as they are, and tracing it, and the parallel engine, was three quarters
    of the reference's compile."""
    models = [
        JaxStateSpaceGP.create(
            (t, y), jk.RBF(VAR[c], ELL[c], order=order, balancing_iter=0), noise_variance=NOISE[c], parallel=False
        )
        for c in range(C)
    ]
    log_post, _ = jax_make_log_posterior(models[0], PRIORS)
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *[jax_make_log_posterior(m, None)[1] for m in models])
    return log_post, stacked


@pytest.mark.parametrize("order", [3, 4])
def test_batched_rbf_log_posterior_value_and_gradient_match_jax_vmap(order):
    """The model on (C,) hyperparameters against ``jax.vmap`` of the JAX
    model's log posterior and its gradient: value rtol 1e-9, gradient rtol
    1e-7.  It takes the dt engine's spectral family."""
    t, y = _data(197, 11 + order)
    log_post_j, stacked = _stacked_jax_positions(t, y, order)
    val_j, grad_j = jit_o0(jax.vmap(jax.value_and_grad(log_post_j)))(stacked)

    tm = StateSpaceGP.from_numpy(t, y, "RBF", VAR, ELL, NOISE, order=order, **CPU64)
    engine, (family, coeffs) = tm.engine()
    assert (engine, family) == ("dt", SPECTRAL) and coeffs.shape == (C, 1 + order**3)
    log_post, _ = make_log_posterior(tm, PRIORS)
    u = {k: v.requires_grad_() for k, v in positions_from_tree(stacked, tm).items()}
    val = log_post(u)
    assert val.shape == (C,)
    npt.assert_allclose(val.detach().numpy(), np.asarray(val_j), rtol=1e-9)
    got = positions_to_tree(dict(zip(u, torch.autograd.grad(val.sum(), list(u.values())))))
    npt.assert_allclose(got["kernel"]["variance"], np.asarray(grad_j["kernel"].variance), rtol=1e-7, atol=1e-10)
    npt.assert_allclose(got["kernel"]["lengthscales"], np.asarray(grad_j["kernel"].lengthscales), rtol=1e-7, atol=1e-10)
    npt.assert_allclose(got["noise_variance"], np.asarray(grad_j["noise_variance"]), rtol=1e-7, atol=1e-10)


@pytest.mark.parametrize("order", [3, 4, 6])
def test_batched_rbf_matches_scalar_models(order):
    """LML (C,) and gradients equal to those of C scalar models (rtol 1e-9 /
    1e-7), each chain's gradient scaled by its own output cotangent; the SDE
    and the spectral coefficients chain by chain."""
    t, y = _data(150, 20 + order)
    mb = StateSpaceGP.from_numpy(t, y, "RBF", VAR, ELL, NOISE, order=order, **CPU64)
    weights = torch.tensor([1.0, -2.0, 0.5], dtype=torch.float64)
    lml = mb.log_marginal_likelihood()
    (lml * weights).sum().backward()
    with torch.no_grad():
        sde_b, (_, co_b) = mb.kernel.get_sde(), mb.kernel.transition_coeffs()
    for c in range(C):
        ms = StateSpaceGP.from_numpy(t, y, "RBF", VAR[c], ELL[c], NOISE[c], order=order, **CPU64)
        ref = ms.log_marginal_likelihood()
        ref.backward()
        npt.assert_allclose(float(lml[c].detach()), float(ref.detach()), rtol=1e-9)
        for pb, ps in zip(mb.parameters(), ms.parameters()):
            npt.assert_allclose(float(pb.grad[c]), float(weights[c]) * float(ps.grad), rtol=1e-7, atol=1e-10)
        with torch.no_grad():
            for xb, xs in zip(sde_b, ms.kernel.get_sde()):
                npt.assert_allclose(xb[c].numpy() if xb.dim() > xs.dim() else xb.numpy(), xs.numpy(), rtol=1e-12, atol=1e-14)
            npt.assert_allclose(co_b[c].numpy(), ms.kernel.transition_coeffs()[1].numpy(), rtol=1e-12, atol=1e-14)


def test_one_overflowing_chain_gives_nan_for_that_chain_alone():
    """A chain whose lengthscale overflows ℓ^d: its log posterior and
    gradient are NaN, with no error, and every other chain's are those of
    the batch without it, bit for bit (the κ balancing and the Lyapunov
    solve are per chain)."""
    t, y = _data(120, 5)
    mb = StateSpaceGP.from_numpy(t, y, "RBF", VAR, ELL, NOISE, order=4, **CPU64)

    def value_and_grad(u):
        u = {k: v.clone().requires_grad_() for k, v in u.items()}
        val = functional_call(mb, u)
        return val.detach(), torch.autograd.grad(val.sum(), list(u.values()))

    u0 = {k: v.detach().clone() for k, v in mb.named_parameters()}
    bad = {k: v.clone() for k, v in u0.items()}
    bad["kernel.raw_lengthscales"][1] = 1e80
    val0, grad0 = value_and_grad(u0)
    val, grad = value_and_grad(bad)
    assert bool(torch.isnan(val[1])) and all(bool(torch.isnan(g[1])) for g in grad)
    keep = [0, 2]
    assert torch.isfinite(val0).all() and torch.equal(val[keep], val0[keep])
    for g, g0 in zip(grad, grad0):
        assert torch.equal(g[keep], g0[keep])
