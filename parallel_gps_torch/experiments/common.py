"""Shared experiment machinery (counterpart:
parallel_gps_tpu/experiments/common.py; so far ``run_one_mcmc`` and
``MCMCEnum`` only — the model and covariance factories and the command-line
parsers are not ported yet).
"""
from __future__ import annotations

import enum
import time

import torch

from parallel_gps_torch.inference.mcmc import dual_averaging_warmup, make_kernel, ravel_positions, sample_chains
from parallel_gps_torch.inference.optim import make_log_posterior


class MCMCEnum(enum.Enum):
    HMC = "hmc"
    MALA = "mala"
    NUTS = "nuts"


# What counts as a numerical failure of a chain (recorded as NaNs, the sweep
# goes on).  A kernel that does not build or launch raises a plain
# ``RuntimeError`` or ``ValueError`` and is never swallowed.
NUMERICAL_FAILURES = (ArithmeticError, torch.linalg.LinAlgError)


def run_one_mcmc(
    model,
    priors: dict | None,
    algo: str = "hmc",
    n_samples: int = 1000,
    burnin: int = 100,
    step_size: float = 0.01,
    num_leapfrog_steps: int = 10,
    seed: int = 0,
    trainable=None,
    progress: bool | int = False,
    warmup: int = 0,
):
    """Sample hyperparameter posteriors; returns (samples — a ``{parameter
    name: tensor}`` dict of unconstrained values, acceptance rate, wall
    seconds).  A model whose hyperparameters have shape (C,) runs C chains in
    step, one launch of the batched kernels per evaluation, and the samples
    are (C, n_samples); a scalar model runs one chain on the single-series
    engine and they are (n_samples,).  Numerical failures record NaNs and keep
    going — the sweep convention of the reference; a kernel that fails to
    build or launch raises.

    ``warmup`` > 0 runs that many dual-averaging adaptation steps first
    (inference.mcmc.dual_averaging_warmup), replaces ``step_size`` with the
    adapted value of each chain and starts the chains from the warmed
    positions.  The acceptance statistic reported is the (trajectory-mean)
    Metropolis acceptance probability.

    ``progress``: the run is split into segments (``progress`` as an int =
    segment count, True = 10) with a tqdm update between them where tqdm is
    installed; each segment resumes from the previous final state and draws
    on from the same generator, so the results are the unsegmented run's
    chain up to the burn-in's place in it."""
    log_post, u0 = make_log_posterior(model, priors, trainable=trainable)
    batched = any(x.dim() for x in u0.values())
    if batched:
        C = max(x.shape[0] for x in u0.values() if x.dim())
        positions = {k: v.expand(C) for k, v in u0.items()}
        log_post_tree = log_post
    else:
        # One chain: scalar leaves, evaluated by the single-series engine.
        positions = {k: v[None] for k, v in u0.items()}
        log_post_tree = lambda u: log_post({k: v[0] for k, v in u.items()})[None]  # noqa: E731
    flat0, unravel = ravel_positions(positions)
    log_post_flat = lambda x: log_post_tree(unravel(x))  # noqa: E731
    generator = torch.Generator(device=flat0.device).manual_seed(seed)
    options = {"num_leapfrog_steps": num_leapfrog_steps}
    t0 = time.time()
    if warmup > 0:
        step_size, positions = dual_averaging_warmup(
            lambda eps: make_kernel(algo, log_post_flat, eps, **options), positions, log_post_tree, generator,
            num_warmup=warmup,
        )
    kernel = make_kernel(algo, log_post_flat, step_size, **options)
    try:
        n_segments = 1 if not progress else (10 if progress is True else int(progress))
        seg = max(1, -(-n_samples // n_segments))
        sizes = [min(seg, n_samples - done) for done in range(0, n_samples, seg)] or [0]
        bar = None
        if progress:
            try:
                from tqdm import tqdm

                bar = tqdm(total=n_samples, desc=f"{algo} chain")
            except ImportError:
                pass
        pieces, accepts = [], []
        for i, n_i in enumerate(sizes):
            s_i, a_i = sample_chains(kernel, positions, log_post_tree, generator, n_i, burnin if i == 0 else 0)
            pieces.append(s_i)
            accepts.append(a_i)
            if n_i:
                positions = {k: v[:, -1] for k, v in s_i.items()}
            if bar is not None:
                bar.update(n_i)
        if bar is not None:
            bar.close()
        samples = {k: torch.cat([p[k] for p in pieces], 1) for k in pieces[0]}
        accept = torch.cat(accepts, 1)
        rate = float(accept.mean()) if accept.numel() else float("nan")  # the read-back ends the device's work
        if not batched:
            samples = {k: v[0] for k, v in samples.items()}
        return samples, rate, time.time() - t0
    except NUMERICAL_FAILURES as err:
        print(f"MCMC failed: {err!r}")
        lead = (flat0.shape[0], n_samples) if batched else (n_samples,)
        nan_samples = {k: torch.full(lead + tuple(v.shape[1:]), float("nan"), dtype=v.dtype, device=v.device) for k, v in positions.items()}
        return nan_samples, float("nan"), time.time() - t0
