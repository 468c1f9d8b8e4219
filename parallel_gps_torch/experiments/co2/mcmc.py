"""CO2 MCMC experiment (counterpart:
parallel_gps_tpu/experiments/co2/mcmc.py): HMC posteriors of the
quasi-periodic sum kernel on n = 3192 merged Mauna Loa observations,
float64, the noise fixed.

Usage::

    python -m parallel_gps_torch.experiments.co2.mcmc --model pssgp \
        --data-dir /path/with/co2_weekly_mlo.txt
"""
from __future__ import annotations

import numpy as np

from parallel_gps_torch.experiments import common as C
from parallel_gps_torch.experiments.co2.common import get_covariance_function, get_data, get_priors, trainable
from parallel_gps_torch.models.params import tree_order


def run(args) -> dict:
    C.require_plots(args)
    C.set_dtype(args.dtype, args.platform)
    if getattr(args, "no_run", False):
        return {}
    t, y = get_data(args.n_training, args.data_dir)
    # The model is zero-mean: centre the observations.
    y_mean = float(np.mean(y))
    model = C.get_model(
        args.model, (t, y - y_mean), get_covariance_function(args.qp_order), args.noise_variance,
        device=C.model_device_from_args(args), stable=args.stable,
    )
    samples, acc, wall = C.run_one_mcmc(
        model, get_priors(), algo=args.mcmc, n_samples=args.n_samples, burnin=args.burnin, step_size=args.step_size,
        warmup=args.warmup, trainable=trainable, progress=args.progress,
    )
    print(f"n={t.shape[0]}: accept={acc:.3f} wall={wall:.1f}s")
    # The sample leaves in the JAX package's tree order, so that either
    # package's load_samples reads the file.
    C.save_results(
        args.out_dir, f"co2_mcmc_{args.model}_{args.mcmc}",
        walls=np.asarray([wall]), accepts=np.asarray([acc]), y_mean=y_mean,
        **{f"sample_{j}": leaf for j, leaf in enumerate(tree_order(samples).values())},
    )
    return {"wall": wall, "accept": acc}


def parser():
    """The command line of ``main``: ``run(parser().parse_args(argv))`` runs it
    from Python."""
    p = C.base_parser(__doc__)
    p.add_argument("--n-training", type=int, default=3192)
    p.add_argument("--mcmc", default="hmc", choices=[m.value for m in C.MCMCEnum])
    p.add_argument("--n-samples", type=int, default=1000)
    p.add_argument("--burnin", type=int, default=100)
    p.add_argument("--step-size", type=float, default=0.01)
    p.add_argument("--warmup", type=int, default=0,
                   help="dual-averaging step-size adaptation iterations (0 = the reference's fixed-step protocol)")
    p.add_argument("--plot", action="store_true", help="posterior-predictive figure (not ported: ROADMAP A12b)")
    p.add_argument("--no-run", action="store_true", help="skip sampling (reload saved results)")
    p.set_defaults(noise_variance=0.05)
    return p


def main():
    run(parser().parse_args())


if __name__ == "__main__":
    main()
