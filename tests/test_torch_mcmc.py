"""PyTorch port vs the JAX package: the MCMC kernels (inference/mcmc.py) and
``run_one_mcmc`` (experiments/common.py).  The port is batch-first — C chains
in step — where the JAX package vmaps one chain; the two draw different
random numbers from the same seed, so the parity tests hand both the same
momentum and noise, made by JAX's generator and carried over as numpy.  f64
on the CPU.
"""
import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from parallel_gps_torch import StateSpaceGP
from parallel_gps_torch.experiments.common import MCMCEnum, run_one_mcmc
from parallel_gps_torch.inference import mcmc as tm
from parallel_gps_torch.inference import (
    dual_averaging_warmup,
    find_reasonable_step_size,
    hmc_kernel,
    make_kernel,
    mala_kernel,
    nuts_kernel,
    sample_chain,
    sample_chains,
)
from parallel_gps_tpu.inference import mcmc as jm

torch.set_num_threads(1)

COV = np.array([[1.0, 0.6, 0.2], [0.6, 2.0, -0.3], [0.2, -0.3, 0.7]])
PREC = np.linalg.inv(COV)
C, P = 4, 3


def _gaussian(prec):
    """The batched target (C, P) → (C,), written elementwise so that a chain's
    value does not depend on how many chains are evaluated with it."""
    prec_t = torch.tensor(prec)

    def log_prob(x):
        return -0.5 * (x[:, :, None] * prec_t[None] * x[:, None, :]).sum((1, 2))

    return log_prob


def _jax_gaussian(prec):
    prec_j = jnp.asarray(prec)
    return lambda x: -0.5 * x @ prec_j @ x


def _generator(seed):
    return torch.Generator().manual_seed(seed)


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


def test_multi_chain_mcmc_recovers_gaussian():
    """sample_chains: 4 HMC chains in step on a correlated 2-D Gaussian recover
    its moments; the chains are distinct (tests/test_kalman.py, on the port)."""
    cov = np.array([[1.0, 0.6], [0.6, 2.0]])
    log_prob_flat = _gaussian(np.linalg.inv(cov))
    kernel = hmc_kernel(log_prob_flat, step_size=0.4, num_leapfrog_steps=8)
    init = {"x": torch.tensor(np.random.RandomState(0).randn(4, 2))}
    samples, accepted = sample_chains(kernel, init, lambda tree: log_prob_flat(tree["x"]), _generator(0), 1500, 300)
    xs = samples["x"].numpy()
    assert xs.shape == (4, 1500, 2) and accepted.shape == (4, 1500)
    assert float(accepted.mean()) > 0.6
    assert not np.allclose(xs[0], xs[1])
    pooled = xs.reshape(-1, 2)
    npt.assert_allclose(pooled.mean(axis=0), [0.0, 0.0], atol=0.15)
    npt.assert_allclose(np.cov(pooled.T), cov, atol=0.3)


def test_dual_averaging_nuts_recovers_gaussian():
    """Dual averaging adapts each chain's NUTS step size so that the
    trajectory-mean acceptance sits near the 0.8 target, and the adapted
    sampler recovers a correlated Gaussian's moments (tests/test_kalman.py, on
    the port, two chains from far off)."""
    cov = np.array([[1.0, 0.8], [0.8, 2.0]])
    log_prob_flat = _gaussian(np.linalg.inv(cov))
    log_prob = lambda tree: log_prob_flat(tree["x"])  # noqa: E731
    init = {"x": torch.tensor([[3.0, -3.0], [-3.0, 3.0]], dtype=torch.float64)}
    tm.MASK_TESTS["nuts"] = 0
    eps, warm = dual_averaging_warmup(
        lambda e: make_kernel("nuts", log_prob_flat, e), init, log_prob, _generator(1), num_warmup=300, target_accept=0.8
    )
    assert eps.shape == (2,) and warm["x"].shape == (2, 2)
    assert bool(((eps > 0.05) & (eps < 5.0)).all()), eps
    # Each NUTS step tests its masks at most max_depth + 2^max_depth − 1 times.
    assert 300 <= tm.MASK_TESTS["nuts"] <= 300 * (8 + 2**8 - 1)
    samples, accept = sample_chains(make_kernel("nuts", log_prob_flat, eps), warm, log_prob, _generator(2), 750, 50)
    assert 0.6 < float(accept.mean()) <= 1.0
    assert float(accept.min()) >= 0.0 and float(accept.max()) <= 1.0
    xs = samples["x"].numpy().reshape(-1, 2)
    npt.assert_allclose(xs.mean(axis=0), [0.0, 0.0], atol=0.25)
    npt.assert_allclose(np.cov(xs.T), cov, atol=0.45)


@pytest.mark.parametrize("chunk_size", [3, 4], ids=["divides", "does-not-divide"])
@pytest.mark.parametrize("algo", ["hmc", "nuts"])
def test_sample_chains_chunked_matches_monolithic(algo, chunk_size):
    """``chunk_size`` splits the chain axis inside the evaluation of the
    log-probability only: the same draws, bit for bit, also for a chain count
    it does not divide."""
    log_prob_flat = _gaussian(np.linalg.inv(np.array([[1.0, 0.4], [0.4, 1.5]])))
    calls = []

    def counting(x):
        calls.append(x.shape[0])
        return log_prob_flat(x)

    kernel = make_kernel(algo, counting, 0.3, num_leapfrog_steps=5, max_depth=4)
    init = {"x": torch.tensor(np.random.RandomState(1).randn(6, 2))}
    log_prob = lambda tree: counting(tree["x"])  # noqa: E731
    mono, acc_m = sample_chains(kernel, init, log_prob, _generator(7), 40, 10, chunk_size=None)
    assert set(calls) == {6}
    calls.clear()
    chunked, acc_c = sample_chains(kernel, init, log_prob, _generator(7), 40, 10, chunk_size=chunk_size)
    assert max(calls) == chunk_size and set(calls) == {chunk_size, 6 % chunk_size or chunk_size}
    assert torch.equal(mono["x"], chunked["x"]) and torch.equal(acc_m, acc_c)


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


def _toy_model(C_=None):
    rng = np.random.RandomState(0)
    t = np.sort(rng.rand(300))
    y = np.sin(12.0 * t) + 0.3 * rng.randn(300)
    full = (lambda v: np.full(C_, v)) if C_ else (lambda v: v)
    return StateSpaceGP.from_numpy(t, y, "Matern32", full(1.0), full(0.5), full(0.3), dtype=torch.float64, device="cpu")


PRIORS = {k: (lambda u: -0.5 * u * u) for k in ("kernel.variance", "kernel.lengthscales", "noise_variance")}


def test_run_one_mcmc_on_a_matern32_model_with_four_chains():
    """A short HMC run on a Matern32 model (T = 300), four chains in step
    through the batched path."""
    samples, rate, wall = run_one_mcmc(_toy_model(4), PRIORS, "hmc", n_samples=25, burnin=5, step_size=0.05, seed=1)
    assert set(samples) == {"kernel.raw_variance", "kernel.raw_lengthscales", "raw_noise_variance"}
    assert all(v.shape == (4, 25) and bool(torch.isfinite(v).all()) for v in samples.values())
    assert 0.2 < rate <= 1.0 and wall > 0.0
    assert not torch.equal(samples["raw_noise_variance"][0], samples["raw_noise_variance"][1])


def test_run_one_mcmc_single_chain_warmup_and_segments():
    """A scalar model runs one chain on the single-series engine; ``warmup``
    adapts the step size first; ``progress`` runs the chain in segments."""
    samples, rate, _ = run_one_mcmc(_toy_model(), PRIORS, "mala", n_samples=12, burnin=2, step_size=0.05, warmup=4, progress=3)
    assert all(v.shape == (12,) and bool(torch.isfinite(v).all()) for v in samples.values())
    assert 0.0 <= rate <= 1.0
    again, rate2, _ = run_one_mcmc(_toy_model(), PRIORS, "mala", n_samples=12, burnin=2, step_size=0.05, warmup=4, progress=3)
    assert rate2 == rate and all(torch.equal(samples[k], again[k]) for k in samples)


class _Failing(torch.nn.Module):
    """A model whose evaluation raises: once it has been called ``after`` times."""

    def __init__(self, error, after=1):
        super().__init__()
        self.raw_x = torch.nn.Parameter(torch.zeros((), dtype=torch.float64))
        self.error, self.after, self.calls = error, after, 0

    def forward(self):
        self.calls += 1
        if self.calls > self.after:
            raise self.error
        return -0.5 * self.raw_x**2


def test_run_one_mcmc_records_nans_for_numerical_failures_only():
    """The sweep convention: a numerical failure records NaNs and goes on; a
    kernel that does not build or launch (a RuntimeError of the loader, a
    ValueError of a wrapper) is raised."""
    samples, rate, _ = run_one_mcmc(_Failing(FloatingPointError("overflow")), None, "hmc", n_samples=5, burnin=0)
    assert samples["raw_x"].shape == (5,) and bool(torch.isnan(samples["raw_x"]).all()) and np.isnan(rate)
    samples, rate, _ = run_one_mcmc(_Failing(torch.linalg.LinAlgError("singular")), None, "mala", n_samples=3, burnin=0)
    assert bool(torch.isnan(samples["raw_x"]).all()) and np.isnan(rate)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        run_one_mcmc(_Failing(RuntimeError("nvcc failed (1)")), None, "hmc", n_samples=5, burnin=0)
    with pytest.raises(ValueError, match="CUDA kernels"):
        run_one_mcmc(_Failing(ValueError("batched CUDA kernels: dtype")), None, "nuts", n_samples=5, burnin=0)


def test_mcmc_drive_loads_no_jax_and_launches_nothing_on_the_cpu():
    """The documented CPU drive of ``run_one_mcmc``, at T = 100 and six
    steps, in a fresh interpreter:
    jax and the JAX package stay unloaded, no launch counter moves and the CUDA
    loader is never imported."""
    code = """
import json, sys
import numpy as np, torch
from parallel_gps_torch import StateSpaceGP
from parallel_gps_torch.experiments.common import run_one_mcmc
from parallel_gps_torch.kalman import batched, dt, strip
rng = np.random.RandomState(0)
t = np.sort(rng.rand(100)); y = np.sin(12 * t) + 0.3 * rng.randn(100)
prior = lambda u: -0.5 * u * u
priors = {"kernel.variance": prior, "kernel.lengthscales": prior, "noise_variance": prior}
m = StateSpaceGP.from_numpy(t, y, "Matern32", np.full(4, 1.0), np.full(4, 0.5), np.full(4, 0.3), dtype=torch.float64, device="cpu")
samples, rate, wall = run_one_mcmc(m, priors, "hmc", n_samples=5, burnin=1, step_size=0.05)
foreign = ("jax", "jaxlib", "flax", "optax", "parallel_gps_tpu")
print(json.dumps({
    "rate": rate,
    "jax_modules": sorted(k for k in sys.modules if k.split(".")[0] in foreign),
    "launches": {**batched.LAUNCHES, **dt.LAUNCHES, **strip.LAUNCHES},
    "cuda_loader_imported": "parallel_gps_torch.kalman._cuda" in sys.modules,
}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    facts = json.loads(out.stdout.strip().splitlines()[-1])
    assert facts["jax_modules"] == [] and not facts["cuda_loader_imported"]
    assert set(facts["launches"]) >= {"batched_filter", "batched_smoother", "dt_fisher"} and set(facts["launches"].values()) == {0}
    assert 0.2 < facts["rate"] <= 1.0
