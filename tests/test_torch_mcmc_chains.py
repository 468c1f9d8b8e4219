"""PyTorch port: chains in step (``sample_chains``, dual-averaging NUTS)
recovering Gaussians, chunking of the chain axis, and ``run_one_mcmc``
(experiments/common.py) on models.  f64 on the CPU.
"""
import json
import subprocess
import sys

import numpy as np
import numpy.testing as npt
import pytest
import torch

from parallel_gps_torch import StateSpaceGP
from parallel_gps_torch.experiments.common import run_one_mcmc
from parallel_gps_torch.inference import mcmc as tm
from parallel_gps_torch.inference import dual_averaging_warmup, hmc_kernel, make_kernel, sample_chains
from _torch_mcmc import _gaussian, _generator

torch.set_num_threads(1)


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
