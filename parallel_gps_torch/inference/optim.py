"""Hyperparameter optimization: Adam and L-BFGS on the negative LML
(counterpart: the JAX package's ``inference.optim`` module).

Hyperparameters live in *unconstrained* space: they are the ``raw_*``
parameters of the model and its kernel (models/params.py), and the model
constrains them when it evaluates.  The optimizers are ``torch.optim``'s;
each LML and its gradient run on the model's device, through the dt-engine
kernels when that is a CUDA card.

The fitting functions work on a deep copy, so the caller's model is
unchanged, and return ``(fitted model, loss history)`` with the history a
tensor of length ``n_iters`` on the model's device holding the loss *before*
each update.
"""
from __future__ import annotations

import copy
from typing import Callable

import torch
from torch.func import functional_call

from parallel_gps_torch.models.params import log_prior, trainable_mask


_MAX_LINE_SEARCH = 25


def make_loss(model) -> tuple[Callable, dict]:
    """Return (loss_fn, init_unconstrained_params) for a model.

    ``loss_fn(u)`` = negative LML with ``u`` a ``{parameter name: tensor}``
    dict of unconstrained values; the data stays in the model.
    """
    u0 = {name: p.detach().clone() for name, p in model.named_parameters()}

    def loss(u):
        return -functional_call(model, u)

    return loss, u0


def make_log_posterior(model, priors: dict | None = None, trainable=None):
    """Unnormalized log posterior over unconstrained hyperparameters:
    LML + Σ prior.log_prob(unconstrained leaf), the MCMC target.

    ``trainable`` is an optional predicate on dotted leaf names; leaves it
    rejects are pinned to their initial values.

    Leaves of shape (C,) are C chains: the model returns their LMLs as (C,)
    and the priors are summed per chain, so ``log_post`` is then the batched
    target ``inference.mcmc`` samples from (``jax.vmap(log_post)`` in the JAX
    package).
    """
    loss, u0 = make_loss(model)
    mask = trainable_mask(u0, trainable) if trainable is not None else None

    def log_post(u):
        if mask is not None:
            u = {name: u[name] if mask[name] else u0[name] for name in u0}
        lp = -loss(u)
        if priors:
            # Every hyperparameter of the port's models is a scalar, so any
            # axis of a leaf is a chain axis.
            lp = lp + log_prior(u, priors, batch_ndim=max(x.dim() for x in u.values()))
        return lp

    return log_post, u0


def _with_priors(loss: Callable, params, priors: dict | None) -> Callable:
    """Negative log *posterior* loss: the MAP objective when priors are
    given."""
    if not priors:
        return loss
    return lambda: loss() - log_prior(params, priors)


def _start(model, trainable, priors):
    """A deep copy of the model, its trainable parameters and its loss."""
    fitted = copy.deepcopy(model)
    params = dict(fitted.named_parameters())
    if trainable is not None:
        mask = trainable_mask(params, trainable)
        free = [p for name, p in params.items() if mask[name]]
    else:
        free = list(params.values())
    return fitted, free, _with_priors(fitted.training_loss, params, priors)


def fit_adam(
    model,
    n_iters: int = 200,
    learning_rate: float = 1e-2,
    trainable: Callable[[str], bool] | None = None,
    priors: dict | None = None,
):
    """Adam on negative LML (or negative log posterior with ``priors``);
    returns (fitted model, loss history)."""
    fitted, free, loss_fn = _start(model, trainable, priors)
    opt = torch.optim.Adam(free, lr=learning_rate)
    history = []
    for _ in range(n_iters):
        fitted.zero_grad(set_to_none=True)
        loss = loss_fn()
        loss.backward()
        opt.step()
        history.append(loss.detach())
    fitted.zero_grad(set_to_none=True)
    return fitted, torch.stack(history) if history else free[0].new_zeros(0)


def fit_lbfgs(model, n_iters: int = 100, trainable=None, priors: dict | None = None):
    """L-BFGS (strong-Wolfe line search) on negative LML (or negative log
    posterior with ``priors`` — MAP).  Each of the ``n_iters`` steps is one
    L-BFGS iteration with its line search."""
    fitted, free, loss_fn = _start(model, trainable, priors)
    # One iteration per ``step``: the evaluation that opens it plus at most
    # _MAX_LINE_SEARCH of its line search (the curvature memory lives in the
    # optimizer's state across steps).
    opt = torch.optim.LBFGS(
        free, lr=1.0, max_iter=1, max_eval=1 + _MAX_LINE_SEARCH, line_search_fn="strong_wolfe"
    )

    def closure():
        fitted.zero_grad(set_to_none=True)
        loss = loss_fn()
        loss.backward()
        return loss

    history = []
    for _ in range(n_iters):
        # ``step`` returns the loss of its first evaluation: before the update.
        history.append(opt.step(closure).detach())
    fitted.zero_grad(set_to_none=True)
    return fitted, torch.stack(history) if history else free[0].new_zeros(0)
