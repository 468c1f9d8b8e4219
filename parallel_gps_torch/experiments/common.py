"""Shared experiment machinery: the model and covariance factories, the MCMC
runner, the command-line parser and results persistence (counterpart:
parallel_gps_tpu/experiments/common.py).

The port's differences: ``--platform`` names a torch device, ``cuda`` (the
default) or ``cpu``, and ``--dtype`` the default float; float64 runs on the
card like float32 — the H100 computes in f64 natively, so the JAX rule that
sends f64 to the CPU is not carried over.  The samplers are the port's
batch-first ones (``inference.mcmc``).
"""
from __future__ import annotations

import argparse
import enum
import os
import time

import numpy as np
import torch

from parallel_gps_torch import config
from parallel_gps_torch.inference.mcmc import dual_averaging_warmup, make_kernel, ravel_positions, sample_chains
from parallel_gps_torch.inference.optim import make_log_posterior
from parallel_gps_torch.models.params import as_arrays, constrain, tree_order, unconstrain

PLATFORMS = ("default", "cuda", "cpu")
# The device of the models, set by ``set_dtype`` from ``--platform``.
_DEVICE: list = [None]


def progress(iterable, desc: str | None = None, total: int | None = None):
    """A tqdm progress bar over an iterable, or the iterable itself where
    tqdm is not installed."""
    try:
        from tqdm import tqdm
    except ImportError:
        return iterable
    return tqdm(iterable, desc=desc, total=total)


class ModelEnum(enum.Enum):
    GP = "gp"  # the dense GP (models/gpr.py::DenseGP)
    SSGP = "ssgp"  # the sequential state-space engine
    PSSGP = "pssgp"  # the parallel engines


class CovarianceEnum(enum.Enum):
    Matern12 = "Matern12"
    Matern32 = "Matern32"
    Matern52 = "Matern52"
    RBF = "RBF"
    QP = "QP"


class MCMCEnum(enum.Enum):
    HMC = "hmc"
    MALA = "mala"
    NUTS = "nuts"


def platform_device(platform: str | None = None) -> torch.device:
    """The device ``--platform`` names: ``cpu``, or the card for ``cuda`` and
    ``default`` (``config.resolve_device``: it raises without one)."""
    if platform not in (None,) + PLATFORMS:
        raise ValueError(f"--platform must be one of {PLATFORMS}, got {platform!r}")
    return torch.device("cpu") if platform == "cpu" else config.resolve_device(None)


def set_dtype(dtype: str, platform: str | None = None) -> torch.device:
    """Set torch's default float to ``dtype`` ("float32" or "float64") and
    the models' device to ``--platform``'s; returns that device.  float64
    stays on the card."""
    torch.set_default_dtype({"float32": torch.float32, "float64": torch.float64}[dtype])
    _DEVICE[0] = platform_device(platform)
    return _DEVICE[0]


def default_device() -> torch.device:
    """The models' device: ``set_dtype``'s, else the card."""
    return _DEVICE[0] if _DEVICE[0] is not None else platform_device()


def get_covariance_function(
    kind: str,
    variance: float = 1.0,
    lengthscales: float = 1.0,
    rbf_order: int = 6,
    rbf_balance_iter: int = 10,
    qp_order: int = 3,
    period: float = 1.0,
):
    """The covariance factory (JAX common.py:77-113).  QP is the
    quasi-periodic composite Periodic(order=``qp_order``) × Matern32 of the
    CO2 and sunspot studies."""
    from parallel_gps_torch import kernels

    opts = dict(dtype=config.default_float(), device=default_device())
    kind = CovarianceEnum(kind)
    if kind in (CovarianceEnum.Matern12, CovarianceEnum.Matern32, CovarianceEnum.Matern52):
        return getattr(kernels, kind.value)(variance, lengthscales, **opts)
    if kind == CovarianceEnum.RBF:
        return kernels.RBF(variance, lengthscales, order=rbf_order, balancing_iter=rbf_balance_iter, **opts)
    if kind == CovarianceEnum.QP:
        periodic = kernels.Periodic(variance, lengthscales, period, order=qp_order, **opts)
        return periodic * kernels.Matern32(1.0, lengthscales, **opts)
    raise ValueError(f"unknown covariance {kind}")


def resolve_model_device(model: str, platform: str | None, dtype: str):
    """The device of one kind of model inside one process, the reference's
    study protocol (GP and PSSGP on the accelerator, SSGP on the host): the
    sequential engine, a Python loop over time, goes to the CPU, the dense
    GP and the parallel engines stay on the card.  ``None`` (the process's
    device) under ``--platform cpu``.  ``dtype`` is accepted as the JAX
    function takes it; float64 changes nothing here."""
    del dtype
    if platform == "cpu":
        return None
    return torch.device("cpu") if ModelEnum(model) == ModelEnum.SSGP else None


def model_device_from_args(args):
    """``--split-devices`` → the per-model device for ``get_model(device=…)``."""
    if not getattr(args, "split_devices", False):
        return None
    return resolve_model_device(args.model, args.platform, args.dtype)


def get_model(model: str, data, covariance, noise_variance: float, device=None, stable: bool = False):
    """The model factory (JAX common.py:143-185): ``gp`` the dense GP,
    ``ssgp`` the sequential engine, ``pssgp`` the parallel engines, on
    ``device`` (``None``: the process's, ``set_dtype``).  ``stable``
    (``--stable``) routes the parallel state-space model through the
    square-root engine (kalman/sqrt.py); the other models ignore it, as in
    the JAX package."""
    from parallel_gps_torch.models import DenseGP, StateSpaceGP

    device = device if device is not None else default_device()
    model = ModelEnum(model)
    if model == ModelEnum.GP:
        return DenseGP.create(data, covariance, noise_variance, device=device)
    parallel = model == ModelEnum.PSSGP
    return StateSpaceGP.create(data, covariance, noise_variance, parallel=parallel, device=device, stable=stable and parallel)


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


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--model", default="pssgp", choices=[m.value for m in ModelEnum])
    p.add_argument("--cov", default="Matern32", choices=[c.value for c in CovarianceEnum])
    p.add_argument("--dtype", default="float64", choices=["float32", "float64"])
    p.add_argument(
        "--platform",
        default="default",
        choices=PLATFORMS,
        help="torch device: cuda (the card; default) or cpu; float64 runs on the card too",
    )
    p.add_argument("--noise-variance", type=float, default=0.5)
    p.add_argument(
        "--stable",
        action="store_true",
        help="square-root (Cholesky-factor) engine for the state-space models: PSD covariances at any conditioning "
        "(the f32 answer to the reference's float64 stability switch); ~2-3x the flops",
    )
    p.add_argument("--rbf-order", type=int, default=6)
    p.add_argument("--rbf-balance-iter", type=int, default=10)
    p.add_argument("--qp-order", type=int, default=3)
    p.add_argument("--out-dir", default="results")
    p.add_argument("--progress", action="store_true", help="in-chain tqdm progress (segmented sampling)")
    p.add_argument(
        "--split-devices",
        action="store_true",
        help="reference-protocol per-model device split in one process: ssgp on the CPU, pssgp and gp on the card",
    )
    p.add_argument("--data-dir", default=None)
    return p


def block_until_ready(*tensors) -> None:
    """Wait for the card's work on the tensors (a wall time's end)."""
    for x in tensors:
        if isinstance(x, torch.Tensor) and x.device.type == "cuda":
            torch.cuda.synchronize(x.device)


def require_plots(args) -> None:
    """``--plot`` needs ``experiments/plots.py``, which is not ported."""
    if getattr(args, "plot", False):
        raise NotImplementedError("--plot: experiments/plots.py is not ported (ROADMAP A12b)")


def model_values(model) -> dict:
    """The model's hyperparameters as the JAX tree holds them: ``{dotted name:
    constrained value}``."""
    return constrain({name: p.detach() for name, p in model.named_parameters()})


def load_samples(npz_path: str, model) -> dict:
    """The unconstrained samples that the MCMC experiments saved (leaves
    ``sample_{j}`` in the JAX package's tree order, ``tree_order``) as the
    port's ``{parameter name: tensor}`` for a model with the same
    hyperparameters — a file written by either package."""
    hypers0 = tree_order(as_arrays(unconstrain(model_values(model)), device=model.ts.device))
    with np.load(npz_path) as data:
        saved = [data[f"sample_{j}"] for j in range(len(hypers0))]
    return as_arrays(dict(zip(hypers0, saved)), dtype=next(iter(hypers0.values())).dtype, device=model.ts.device)


def save_results(out_dir: str, name: str, **arrays) -> str:
    """``out_dir/name.npz`` of the arrays (tensors copied to the host)."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name + ".npz")
    np.savez(path, **{k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v) for k, v in arrays.items()})
    print(f"saved {path}")
    return path
