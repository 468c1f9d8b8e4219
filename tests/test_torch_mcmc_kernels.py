"""PyTorch port vs the JAX package: the MCMC kernels (inference/mcmc.py).  The
port is batch-first — C chains in step — where the JAX package vmaps one
chain; the two draw different random numbers from the same seed, so the
parity tests hand both the same momentum and noise, made by JAX's generator
and carried over as numpy.  Seeds, rejection and per-chain step sizes too.
f64 on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from parallel_gps_torch.experiments.common import MCMCEnum
from parallel_gps_torch.inference import mcmc as tm
from parallel_gps_torch.inference import (
    find_reasonable_step_size,
    hmc_kernel,
    make_kernel,
    mala_kernel,
    nuts_kernel,
    sample_chain,
    sample_chains,
)
from parallel_gps_tpu.inference import mcmc as jm
from _torch_mcmc import _gaussian, _generator

torch.set_num_threads(1)


COV = np.array([[1.0, 0.6, 0.2], [0.6, 2.0, -0.3], [0.2, -0.3, 0.7]])
PREC = np.linalg.inv(COV)
C, P = 4, 3


def _jax_gaussian(prec):
    prec_j = jnp.asarray(prec)
    return lambda x: -0.5 * x @ prec_j @ x


def _states(q0):
    """The same starting state in both packages."""
    lp_j = _jax_gaussian(PREC)
    state_t = tm._init_state(tm._as_target(_gaussian(PREC)), torch.tensor(q0))
    states_j = [jm._init_state(lp_j, jnp.asarray(q0[c])) for c in range(C)]
    for c in range(C):
        npt.assert_allclose(float(state_t.log_prob[c]), float(states_j[c].log_prob), rtol=1e-12)
        npt.assert_allclose(state_t.grad[c].numpy(), np.asarray(states_j[c].grad), rtol=1e-12)
    return state_t, states_j


def test_leapfrog_trajectory_matches_jax():
    rng = np.random.RandomState(0)
    q0, p0 = rng.randn(C, P), rng.randn(C, P)
    state_t, states_j = _states(q0)
    new_t, p_t = tm._leapfrog(tm._as_target(_gaussian(PREC)), state_t, torch.tensor(p0), 0.3, 7)
    for c in range(C):
        new_j, p_j = jm._leapfrog(_jax_gaussian(PREC), states_j[c], jnp.asarray(p0[c]), 0.3, 7)
        npt.assert_allclose(new_t.position[c].numpy(), np.asarray(new_j.position), rtol=1e-12)
        npt.assert_allclose(p_t[c].numpy(), np.asarray(p_j), rtol=1e-12)
        npt.assert_allclose(float(new_t.log_prob[c]), float(new_j.log_prob), rtol=1e-12)
        npt.assert_allclose(new_t.grad[c].numpy(), np.asarray(new_j.grad), rtol=1e-12)


@pytest.mark.parametrize("algo", ["hmc", "mala"])
def test_log_acceptance_and_metropolis_step_match_jax(algo):
    """One step of the JAX kernel per chain, its momentum (or noise) and its
    uniform read off its key; the port's proposal on the same numbers gives the
    same acceptance probability (rtol 1e-12) and, decided by the same uniform,
    the same next state."""
    rng = np.random.RandomState(1)
    q0 = rng.randn(C, P)
    state_t, states_j = _states(q0)
    lp_j = _jax_gaussian(PREC)
    step_j = jm.hmc_kernel(lp_j, 0.45, 6) if algo == "hmc" else jm.mala_kernel(lp_j, 0.6)
    keys = [jax.random.PRNGKey(10 + c) for c in range(C)]
    noise, unif = [], []
    for key in keys:
        k1, k2 = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(k1, (P,), jnp.float64)))
        unif.append(float(jax.random.uniform(k2, dtype=jnp.float64)))
    target = tm._as_target(_gaussian(PREC))
    if algo == "hmc":
        new_t, log_accept = tm._hmc_proposal(target, state_t, torch.tensor(np.stack(noise)), 0.45, 6)
    else:
        new_t, log_accept = tm._mala_proposal(target, state_t, torch.tensor(np.stack(noise)), 0.6)
    prob_t = tm._accept_prob(log_accept)
    seen = set()
    for c in range(C):
        out_j, prob_j = step_j(keys[c], states_j[c])
        npt.assert_allclose(float(prob_t[c]), float(prob_j), rtol=1e-12)
        accepted = np.log(unif[c]) < float(log_accept[c])
        seen.add(bool(accepted))
        want = new_t.position[c] if accepted else state_t.position[c]
        npt.assert_allclose(np.asarray(out_j.position), want.numpy(), rtol=1e-12)
    assert 0.0 < float(prob_t.min()) and float(prob_t.max()) <= 1.0 and seen


def test_nan_energy_counts_as_rejection():
    state = tm.ChainState(torch.zeros(2, 1, dtype=torch.float64), torch.zeros(2, dtype=torch.float64), torch.zeros(2, 1, dtype=torch.float64))
    new = tm.ChainState(torch.ones(2, 1, dtype=torch.float64), torch.ones(2, dtype=torch.float64), torch.ones(2, 1, dtype=torch.float64))
    log_accept = torch.tensor([float("nan"), 5.0], dtype=torch.float64)
    out, prob = tm._metropolis(_generator(0), state, new, log_accept)
    assert prob.tolist() == [0.0, 1.0]
    assert out.position[:, 0].tolist() == [0.0, 1.0]


@pytest.mark.parametrize("algo", ["hmc", "mala", "nuts"])
def test_same_seed_same_chain_and_one_chain_is_sample_chain(algo):
    log_prob_flat = _gaussian(PREC)
    kernel = make_kernel(algo, log_prob_flat, 0.35, num_leapfrog_steps=4, max_depth=4)
    init = torch.tensor(np.random.RandomState(2).randn(1, P))
    a, acc_a = sample_chains(kernel, init, log_prob_flat, _generator(3), 30, 5)
    b, acc_b = sample_chains(kernel, init, log_prob_flat, _generator(3), 30, 5)
    c, _ = sample_chains(kernel, init, log_prob_flat, _generator(4), 30, 5)
    assert torch.equal(a, b) and torch.equal(acc_a, acc_b) and not torch.equal(a, c)
    one, acc_one = sample_chain(kernel, init[0], log_prob_flat, _generator(3), 30, 5)
    assert one.shape == (30, P) and acc_one.shape == (30,)
    assert torch.equal(one, a[0]) and torch.equal(acc_one, acc_a[0])
    assert bool(torch.isfinite(a).all()) and float(acc_a.min()) >= 0.0 and float(acc_a.max()) <= 1.0


def test_make_kernel_names_and_step_sizes_per_chain():
    log_prob_flat = _gaussian(PREC)
    assert [m.value for m in MCMCEnum] == ["hmc", "mala", "nuts"]
    for name, factory in (("HMC", hmc_kernel), ("mala", mala_kernel), ("Nuts", nuts_kernel)):
        assert make_kernel(name, log_prob_flat, 0.1).step_fn is factory(log_prob_flat, 0.1).step_fn
    with pytest.raises(ValueError, match="unknown MCMC kernel"):
        make_kernel("gibbs", log_prob_flat, 0.1)
    # One step size per chain: chain c moves as a single chain with its own.
    q0 = torch.tensor(np.random.RandomState(3).randn(C, P))
    state = tm._init_state(tm._as_target(log_prob_flat), q0)
    p0 = torch.tensor(np.random.RandomState(4).randn(C, P))
    eps = torch.tensor([0.1, 0.2, 0.3, 0.4], dtype=torch.float64)
    new, _ = tm._hmc_proposal(tm._as_target(log_prob_flat), state, p0, eps, 3)
    for c in range(C):
        one = tm.ChainState(*(x[c : c + 1] for x in state))
        ref, _ = tm._hmc_proposal(tm._as_target(log_prob_flat), one, p0[c : c + 1], float(eps[c]), 3)
        npt.assert_allclose(new.position[c].numpy(), ref.position[0].numpy(), rtol=1e-14)


def test_find_reasonable_step_size_per_chain():
    """From 1.0 the step size is doubled or halved, per chain, until the
    one-leapfrog acceptance crosses 1/2: a narrow and a wide Gaussian end far
    apart, and the loop's mask tests are counted."""
    scales = torch.tensor([1e-2, 1.0, 1e2], dtype=torch.float64)

    def log_prob(x):
        return -0.5 * ((x / scales[:, None]) ** 2).sum(-1)

    q0 = scales[:, None] * torch.ones(3, 2, dtype=torch.float64)
    state = tm._init_state(tm._as_target(log_prob), q0)
    tm.MASK_TESTS["step_size"] = 0
    eps = find_reasonable_step_size(log_prob, state, _generator(0))
    assert eps.shape == (3,) and tm.MASK_TESTS["step_size"] >= 1
    assert float(eps[0]) < 0.1 < 0.5 <= float(eps[1]) <= 4.0 < float(eps[2])
    ratios = np.log2(eps.numpy())
    npt.assert_allclose(ratios, np.round(ratios), atol=1e-12)  # powers of two
