"""Positivity transforms, trainability masks and priors (counterpart:
parallel_gps_tpu/models/params.py).

Positive hyperparameters are stored unconstrained and mapped through
softplus, as the JAX package does for training and sampling.  A module
stores the unconstrained value of a positive quantity ``x`` as the parameter
``raw_x``; masks and priors address a parameter by the dotted name of the
constrained quantity (``kernel.variance``, ``kernel.lengthscales``,
``noise_variance``), the leaf paths of the JAX package's hyperparameter
tree.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch import Tensor, nn

RAW_PREFIX = "raw_"


def softplus(x: Tensor) -> Tensor:
    """log(1 + eˣ), exact at every x (``torch.nn.functional.softplus``
    switches to the identity above a threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def inv_softplus(y: Tensor) -> Tensor:
    """Stable inverse: y + log(1 − e⁻ʸ) = y + log(−expm1(−y))."""
    y = torch.as_tensor(y)
    return y + torch.log(-torch.expm1(-y))


def _named(params) -> dict:
    """A module's ``named_parameters()`` or a ``{name: tensor}`` dict of them."""
    return dict(params.named_parameters()) if isinstance(params, nn.Module) else dict(params)


def _split(name: str) -> tuple[str, bool]:
    """Parameter name → (dotted name of the constrained quantity, whether
    the parameter is its softplus-unconstrained value)."""
    head, _, leaf = name.rpartition(".")
    positive = leaf.startswith(RAW_PREFIX)
    if positive:
        leaf = leaf[len(RAW_PREFIX) :]
    return (f"{head}.{leaf}" if head else leaf), positive


def trainable_mask(params, predicate: Callable[[str], bool]) -> dict:
    """{parameter name: bool}: the predicate receives the dotted name of the
    constrained quantity."""
    return {name: bool(predicate(_split(name)[0])) for name in _named(params)}


def log_prior(params, priors: dict) -> Tensor:
    """Sum of prior log-densities over the matching *unconstrained*
    parameters.

    ``priors`` maps a dotted-name *suffix* (e.g. ``"kernel.lengthscales"``)
    to either

      - a callable ``logpdf(u) -> tensor`` evaluated on the unconstrained
        value, or
      - a tuple ``(logpdf, "constrained")``: evaluated on the constrained
        value softplus(u), plus the log-Jacobian of the transform.

    The longest matching suffix wins, at most one prior per parameter."""
    total = 0.0
    for name, u in _named(params).items():
        dotted, positive = _split(name)
        matches = [s for s in priors if dotted == s or dotted.endswith("." + s)]
        if not matches:
            continue
        spec = priors[max(matches, key=len)]
        logpdf, on = spec if isinstance(spec, tuple) else (spec, "unconstrained")
        if on == "constrained" and positive:
            # + log|d softplus(u)/du| = log sigmoid(u) = −softplus(−u)
            total = total + logpdf(softplus(u)).sum() + (-softplus(-u)).sum()
        else:
            total = total + logpdf(u).sum()
    return total
