"""Helpers that test_torch_mcmc_chains.py, test_torch_mcmc_kernels.py share."""
import torch


def _gaussian(prec):
    """The batched target (C, P) → (C,), written elementwise so that a chain's
    value does not depend on how many chains are evaluated with it."""
    prec_t = torch.tensor(prec)

    def log_prob(x):
        return -0.5 * (x[:, :, None] * prec_t[None] * x[:, None, :]).sum((1, 2))

    return log_prob


def _generator(seed):
    return torch.Generator().manual_seed(seed)
