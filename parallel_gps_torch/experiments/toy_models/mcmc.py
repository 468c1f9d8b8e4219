"""Toy-model MCMC timing (counterpart:
parallel_gps_tpu/experiments/toy_models/mcmc.py): hyperparameter posteriors
via HMC/MALA/NUTS over a range of series lengths, Normal priors in
unconstrained space, wall time per size.

Usage::

    python -m parallel_gps_torch.experiments.toy_models.mcmc \
        --model pssgp --cov Matern32 --mcmc hmc --log2-sizes 7 10 14
"""
from __future__ import annotations

import numpy as np

from parallel_gps_torch.experiments import common as C
from parallel_gps_torch.experiments.toy_models.common import get_data
from parallel_gps_torch.models.params import leaf_key, tree_order


def normal_logpdf(mu: float, sigma: float):
    def logpdf(x):
        return -0.5 * ((x - mu) / sigma) ** 2 - np.log(sigma) - 0.5 * np.log(2 * np.pi)

    return logpdf


# Normal priors on the *unconstrained* parameters.
PRIORS = {
    "kernel.variance": normal_logpdf(1.0, 2.0),
    "kernel.lengthscales": normal_logpdf(0.0, 2.0),
    "noise_variance": normal_logpdf(0.0, 2.0),
}


def run(args) -> dict:
    C.set_dtype(args.dtype, args.platform)
    sizes = [2**p for p in args.log2_sizes]
    walls = np.full((len(sizes),), np.nan)
    accepts = np.full((len(sizes),), np.nan)
    all_samples = {}

    def cov_factory():
        return C.get_covariance_function(
            args.cov, variance=1.0, lengthscales=0.1, rbf_order=args.rbf_order,
            rbf_balance_iter=args.rbf_balance_iter, qp_order=args.qp_order,
        )

    for i, n in enumerate(sizes):
        t, _, _, _, y = get_data(0, n, n, args.data_model, args.noise_variance)
        model = C.get_model(
            args.model, (t, y), cov_factory(), args.noise_variance, device=C.model_device_from_args(args), stable=args.stable
        )
        samples, acc, wall = C.run_one_mcmc(
            model, PRIORS, algo=args.mcmc, n_samples=args.n_samples, burnin=args.burnin, step_size=args.step_size,
            warmup=args.warmup, seed=i, progress=args.progress,
        )
        walls[i], accepts[i] = wall, acc
        all_samples[f"n{n}"] = samples
        print(f"n={n}: accept={acc:.3f} wall={wall:.1f}s")

    name = f"mcmc_{args.model}_{args.cov}_{args.mcmc}_{args.dtype}"
    # The JAX module's array names: the size, then the sample tree's leaf path.
    flat = {f"{k}_{leaf_key(p)}": v for k, tree in all_samples.items() for p, v in tree_order(tree).items()}
    C.save_results(args.out_dir, name, sizes=np.asarray(sizes), walls=walls, accepts=accepts, **flat)
    return {"sizes": sizes, "walls": walls, "accepts": accepts}


def parser():
    """The command line of ``main``: ``run(parser().parse_args(argv))`` runs it
    from Python."""
    p = C.base_parser(__doc__)
    p.add_argument("--data-model", default="SINE")
    p.add_argument("--mcmc", default="hmc", choices=[m.value for m in C.MCMCEnum])
    p.add_argument("--log2-sizes", type=int, nargs="+", default=[7, 8, 10, 12, 14])
    p.add_argument("--n-samples", type=int, default=1000)
    p.add_argument("--burnin", type=int, default=100)
    p.add_argument("--step-size", type=float, default=0.01)
    p.add_argument("--warmup", type=int, default=0,
                   help="dual-averaging step-size adaptation iterations (0 = the reference's fixed-step protocol)")
    return p


def main():
    run(parser().parse_args())


if __name__ == "__main__":
    main()
