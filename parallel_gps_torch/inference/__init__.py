from parallel_gps_torch.inference.mcmc import (
    ChainState,
    dual_averaging_warmup,
    find_reasonable_step_size,
    hmc_kernel,
    make_kernel,
    mala_kernel,
    nuts_kernel,
    ravel_positions,
    sample_chain,
    sample_chains,
)
from parallel_gps_torch.inference.optim import fit_adam, fit_lbfgs, make_log_posterior, make_loss

__all__ = [
    "ChainState",
    "dual_averaging_warmup",
    "find_reasonable_step_size",
    "fit_adam",
    "fit_lbfgs",
    "hmc_kernel",
    "make_kernel",
    "make_log_posterior",
    "make_loss",
    "mala_kernel",
    "nuts_kernel",
    "ravel_positions",
    "sample_chain",
    "sample_chains",
]
