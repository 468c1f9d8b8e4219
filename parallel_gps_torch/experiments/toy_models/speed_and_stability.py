"""Speed & stability sweep (counterpart:
parallel_gps_tpu/experiments/toy_models/speed_and_stability.py): wall time
and RMSE of posterior prediction over a mesh of (n_train = n_pred) sizes ×
seeds.  A numerical failure records NaN and the sweep goes on (the
"stability" axis); a kernel that fails to build or launch raises.

Usage::

    python -m parallel_gps_torch.experiments.toy_models.speed_and_stability \
        --model pssgp --cov Matern32 --log2-sizes 12 13 14 15 --n-seeds 21
"""
from __future__ import annotations

import time

import numpy as np

from parallel_gps_torch.experiments import common as C
from parallel_gps_torch.experiments.toy_models.common import get_data
from parallel_gps_torch.misc_utils import rmse


def run(args) -> dict:
    name = f"speed_stability_{args.model}_{args.cov}_{args.dtype}"
    C.require_plots(args)
    if getattr(args, "no_run", False):
        return {}

    C.set_dtype(args.dtype, args.platform)
    sizes = [2**p for p in args.log2_sizes]
    # --full-mesh sweeps the (n_train × n_pred) product grid; the default the
    # n_train = n_pred diagonal.
    full_mesh = getattr(args, "full_mesh", False)
    shape = (len(sizes), len(sizes), args.n_seeds) if full_mesh else (len(sizes), args.n_seeds)
    rmses = np.full(shape, np.nan)
    times = np.full(shape, np.nan)

    cells = [(i, j) for i in range(len(sizes)) for j in range(len(sizes))] if full_mesh else [(i, i) for i in range(len(sizes))]
    for i, j in cells:
        n_train, n_pred = sizes[i], sizes[j]
        idx = (i, j) if full_mesh else (i,)
        cov = C.get_covariance_function(
            args.cov, variance=1.0, lengthscales=0.1, rbf_order=args.rbf_order,
            rbf_balance_iter=args.rbf_balance_iter, qp_order=args.qp_order,
        )
        for seed in C.progress(range(args.n_seeds), desc=f"n={n_train}/m={n_pred}"):
            try:
                t, ft, t_pred, ft_pred, y = get_data(seed, n_train, n_pred, args.data_model, args.noise_variance)
                model = C.get_model(
                    args.model, (t, y), cov, args.noise_variance, device=C.model_device_from_args(args), stable=args.stable
                )
                tic = time.time()
                mean, var = model.predict_f(t_pred)
                C.block_until_ready(mean, var)
                toc = time.time()
                rmses[idx + (seed,)] = rmse(mean, ft_pred)
                times[idx + (seed,)] = toc - tic
            except C.NUMERICAL_FAILURES as err:
                print(f"n={n_train} m={n_pred} seed={seed} failed: {err!r}")
            print(f"n={n_train} m={n_pred} seed={seed}: rmse={rmses[idx + (seed,)]:.4f} time={times[idx + (seed,)]:.3f}s")

    C.save_results(args.out_dir, name, sizes=np.asarray(sizes), rmses=rmses, times=times)
    return {"sizes": sizes, "rmses": rmses, "times": times}


def parser():
    """The command line of ``main``: ``run(parser().parse_args(argv))`` runs it
    from Python."""
    p = C.base_parser(__doc__)
    p.add_argument("--data-model", default="SINE")
    p.add_argument("--log2-sizes", type=int, nargs="+", default=[12, 13, 14, 15])
    p.add_argument("--n-seeds", type=int, default=21)
    p.add_argument("--plot", action="store_true", help="regenerate the ridgeline figure (not ported: ROADMAP A12b)")
    p.add_argument("--no-run", action="store_true", help="skip the sweep (reload saved results)")
    p.add_argument(
        "--full-mesh",
        action="store_true",
        help="sweep the full (n_train x n_pred) product grid like the reference instead of the n_train = n_pred diagonal",
    )
    return p


def main():
    run(parser().parse_args())


if __name__ == "__main__":
    main()
