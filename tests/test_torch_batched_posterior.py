"""PyTorch port vs the JAX package: the batched log posterior and its
gradient against ``jax.vmap`` of the JAX model's, and a model on (C,)
hyperparameters against C scalar models.  f64 on the CPU, same numpy inputs
through both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import parallel_gps_tpu.kernels as jk
from parallel_gps_torch import StateSpaceGP
from parallel_gps_torch.inference import make_log_posterior
from parallel_gps_torch.models.params import positions_from_tree, positions_to_tree
from parallel_gps_tpu.inference.optim import make_log_posterior as jax_make_log_posterior
from parallel_gps_tpu.models import StateSpaceGP as JaxStateSpaceGP
from _torch_batched import C_CHAINS, ELL, MATERN, NOISE, PRIORS, VAR, _data
from _torch_common import jit_o0

torch.set_num_threads(1)


def _jax_model(name, t, y, c):
    kern = getattr(jk, name)(VAR[c], ELL[c])
    return JaxStateSpaceGP.create((t, y), kern, noise_variance=NOISE[c])


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
    val_j, grad_j = jit_o0(jax.vmap(jax.value_and_grad(log_post_j)))(stacked)

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
