"""PyTorch port vs the JAX package: ``predict_f`` of a model on
hyperparameters of shape (C,) — Matern52, RBF(order=4) and the
quasi-periodic model — against ``jax.vmap(lambda m: m.predict_f(X))`` over
the C stacked JAX models (their XLA route) and against C scalar models, at
unsorted queries inside and outside the data's range.  f64 on the CPU; JAX
references compiled at XLA's lowest backend level (``jit_o0``)."""
import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import parallel_gps_tpu.kernels as jk
from parallel_gps_torch import StateSpaceGP
from parallel_gps_tpu.models import StateSpaceGP as JaxStateSpaceGP
from _torch_common import jit_o0
from _torch_composite import CPU64, data, jax_spec

torch.set_num_threads(1)

C = 3
NOISE = np.array([0.1, 0.15, 0.08])
# Unsorted, with repeats, inside and outside [0, 1].
X = np.array([0.52, -0.3, 1.25, 0.07, 0.52, 0.999, 0.0, 0.31, 2.0, 0.74, -0.01, 0.18])


def matern52(c):
    return jk.Matern52(0.8 + 0.2 * c, 0.3 + 0.05 * c, balancing_iter=0)


def rbf4(c):
    return jk.RBF(0.8 + 0.2 * c, 0.25 + 0.05 * c, order=4, balancing_iter=0)


def qp(c):
    s = 1.0 + 0.15 * c
    k = jk.Periodic(variance=s, lengthscales=1.1 * s, period=0.9 * s, order=1) * jk.Matern32(variance=1.0 / s, lengthscales=0.8 * s)
    return type(k)(kernels=k.kernels, balancing_iter=0)


def _spec(k):
    """The port's spec of chain c's JAX kernel, with the port's own
    (balanced) build: the balancing is a similarity of the state, which
    leaves the projections as they are."""
    name, body, *_ = jax_spec(k)
    if name == "RBF":
        body = {**body, "balancing_iter": -1}
    return (name, body)


def _batched_spec(make):
    specs = [_spec(make(c)) for c in range(C)]

    def stack(nodes):
        name, body = nodes[0][:2]
        if name in ("Sum", "Product"):
            return (name, [stack([n[1][i] for n in nodes]) for i in range(len(body))])
        return (name, {k: np.stack([n[1][k] for n in nodes]) if k in ("variance", "lengthscales", "period") else v for k, v in body.items()})

    return stack(specs)


@pytest.mark.parametrize("make,engine", [(matern52, "dt"), (rbf4, "dt"), (qp, "dt")], ids=["m52", "rbf4", "qp_d8"])
def test_batched_predict_matches_jax_vmap_and_scalar_models(make, engine):
    """Mean and variance (C, M, 1) against the vmapped JAX predict_f (the JAX
    sequential engine on its kernels unbalanced) at rtol 1e-8, and
    against C scalar models of the port at rtol 1e-9."""
    t, y = data(150, 12)
    jms = [JaxStateSpaceGP.create((t, y), make(c), noise_variance=NOISE[c], parallel=False) for c in range(C)]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *jms)
    mean_j, var_j = jit_o0(jax.vmap(lambda m: m.predict_f(jnp.asarray(X))))(stacked)

    mb = StateSpaceGP.from_numpy(t, y, _batched_spec(make), noise_variance=NOISE, **CPU64)
    assert mb.engine()[0] == engine
    mean, var = mb.predict_f(X)
    assert mean.shape == var.shape == (C, X.size, 1)
    npt.assert_allclose(mean.numpy(), np.asarray(mean_j), rtol=1e-8, atol=1e-12)
    npt.assert_allclose(var.numpy(), np.asarray(var_j), rtol=1e-8, atol=1e-12)
    for c in range(C):
        m_c, v_c = StateSpaceGP.from_numpy(t, y, _spec(make(c)), noise_variance=NOISE[c], **CPU64).predict_f(X)
        npt.assert_allclose(mean[c].numpy(), m_c.numpy(), rtol=1e-9, atol=1e-12)
        npt.assert_allclose(var[c].numpy(), v_c.numpy(), rtol=1e-9, atol=1e-12)


def test_batched_predict_edges():
    """No queries gives (C, 0, 1); noise alone batched (a scalar kernel)
    predicts each chain with its own noise; a batch on the sequential engine
    raises and names ROADMAP A14."""
    t, y = data(60, 2)
    mb = StateSpaceGP.from_numpy(t, y, "Matern32", 1.0, 0.4, NOISE, **CPU64)
    mean, var = mb.predict_f(np.zeros(0))
    assert mean.shape == var.shape == (C, 0, 1)
    mean, var = mb.predict_f(X)
    for c in range(C):
        m_c, v_c = StateSpaceGP.from_numpy(t, y, "Matern32", 1.0, 0.4, NOISE[c], **CPU64).predict_f(X)
        npt.assert_allclose(mean[c].numpy(), m_c.numpy(), rtol=1e-10, atol=1e-13)
        npt.assert_allclose(var[c].numpy(), v_c.numpy(), rtol=1e-10, atol=1e-13)
    seq = StateSpaceGP.from_numpy(t, y, "Matern32", 1.0, 0.4, NOISE, parallel=False, **CPU64)
    with pytest.raises(NotImplementedError, match="A14"):
        seq.predict_f(X)
