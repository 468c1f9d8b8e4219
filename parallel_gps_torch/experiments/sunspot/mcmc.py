"""Sunspot MCMC experiment (counterpart:
parallel_gps_tpu/experiments/sunspot/mcmc.py): HMC posteriors of the
Matern32 hyperparameters on n ∈ {3000, 300, 50} months.

Usage::

    python -m parallel_gps_torch.experiments.sunspot.mcmc --model pssgp \
        --data-dir /path/with/sunspots.csv
"""
from __future__ import annotations

import numpy as np

from parallel_gps_torch.experiments import common as C
from parallel_gps_torch.experiments.sunspot.common import get_covariance_function, get_data, get_priors
from parallel_gps_torch.models.params import tree_order


def run(args) -> dict:
    C.require_plots(args)
    C.set_dtype(args.dtype, args.platform)
    if getattr(args, "no_run", False):
        return {}

    walls, accepts = [], []
    for i, n in enumerate(args.sizes):
        t, y = get_data(n, args.data_dir)
        model = C.get_model(
            args.model, (t, y), get_covariance_function(), args.noise_variance,
            device=C.model_device_from_args(args), stable=args.stable,
        )
        samples, acc, wall = C.run_one_mcmc(
            model, get_priors(args.noise_variance), algo=args.mcmc, n_samples=args.n_samples, burnin=args.burnin,
            step_size=args.step_size, warmup=args.warmup, seed=i, progress=args.progress,
        )
        walls.append(wall)
        accepts.append(acc)
        print(f"n={n}: accept={acc:.3f} wall={wall:.1f}s")
        # The sample leaves in the JAX package's tree order, so that either
        # package's load_samples reads the file.
        C.save_results(
            args.out_dir, f"sunspot_mcmc_{args.model}_{args.mcmc}_n{n}",
            walls=np.asarray(walls), accepts=np.asarray(accepts),
            **{f"sample_{j}": leaf for j, leaf in enumerate(tree_order(samples).values())},
        )
    return {"walls": walls, "accepts": accepts}


def parser():
    """The command line of ``main``: ``run(parser().parse_args(argv))`` runs it
    from Python."""
    p = C.base_parser(__doc__)
    p.add_argument("--sizes", type=int, nargs="+", default=[3000, 300, 50])
    p.add_argument("--mcmc", default="hmc", choices=[m.value for m in C.MCMCEnum])
    p.add_argument("--n-samples", type=int, default=1000)
    p.add_argument("--burnin", type=int, default=100)
    p.add_argument("--step-size", type=float, default=1.0)
    p.add_argument("--warmup", type=int, default=0,
                   help="dual-averaging step-size adaptation iterations (0 = the reference's fixed-step protocol)")
    p.add_argument("--plot", action="store_true", help="posterior-predictive figure (not ported: ROADMAP A12b)")
    p.add_argument("--no-run", action="store_true", help="skip sampling (reload saved results)")
    p.set_defaults(noise_variance=300.0)
    return p


def main():
    run(parser().parse_args())


if __name__ == "__main__":
    main()
