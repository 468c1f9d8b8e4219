"""PyTorch port vs the JAX package: the RBF kernel's spectral closed-form
transitions and the discretised model in both layouts; f64 on the CPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_rbf import ORDERS, _close, _pair

torch.set_num_threads(1)


@pytest.mark.parametrize("order", ORDERS)
def test_transitions_and_discretised_models_match_jax(order):
    """``transitions_m1_tl`` / ``transitions_m1`` (tiny and large gaps) and
    both layouts of the discretised model."""
    jkern, tkern = _pair(order)
    rng = np.random.RandomState(order)
    dts = np.concatenate([[0.0, 1e-9, 1e-5], rng.rand(40) * 0.2, [1.5]])
    _close(tkern.transitions_m1_tl(torch.tensor(dts)), jkern.transitions_m1_tl(jnp.asarray(dts)))
    _close(tkern.transitions_m1(torch.tensor(dts)), jkern.transitions_m1(jnp.asarray(dts)))
    t = np.sort(rng.rand(50))
    R = torch.tensor([[0.1]], dtype=torch.float64)
    jts, jR = jnp.asarray(t).reshape(-1, 1), jnp.asarray(0.1).reshape(1, 1)
    for a, ref in zip(tkern.get_ssm_tl(torch.tensor(t), R), jkern.get_ssm_tl(jts, jR)):
        _close(a, ref)
    for a, ref in zip(tkern.get_ssm(torch.tensor(t), R), jkern.get_ssm(jts, jR)):
        _close(a, ref)
