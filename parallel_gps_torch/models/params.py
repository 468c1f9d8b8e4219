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

import numpy as np
import torch
from torch import Tensor, nn

RAW_PREFIX = "raw_"
# The positive quantities, by the name of their leaf (params.py:34 of the JAX
# package): each is stored as softplus⁻¹ of its value under ``raw_<name>``.
POSITIVE_FIELD_NAMES = frozenset({"variance", "lengthscales", "period", "noise_variance"})


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


def log_prior(params, priors: dict, batch_ndim: int = 0) -> Tensor:
    """Sum of prior log-densities over the matching *unconstrained*
    parameters.

    ``batch_ndim`` leading axes of every parameter are chains of a sampler
    and are kept: the sum runs over a parameter's own axes only, so
    parameters of shape (C,) with ``batch_ndim=1`` give a (C,) result, one
    log-density per chain.

    ``priors`` maps a dotted-name *suffix* (e.g. ``"kernel.lengthscales"``)
    to either

      - a callable ``logpdf(u) -> tensor`` evaluated on the unconstrained
        value, or
      - a tuple ``(logpdf, "constrained")``: evaluated on the constrained
        value softplus(u), plus the log-Jacobian of the transform.

    The longest matching suffix wins, at most one prior per parameter."""
    def own_sum(x: Tensor) -> Tensor:
        return x.sum(tuple(range(batch_ndim, x.dim()))) if x.dim() > batch_ndim else x

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
            total = total + own_sum(logpdf(softplus(u))) + own_sum(-softplus(-u))
        else:
            total = total + own_sum(logpdf(u))
    return total


def positions_from_tree(tree, params, dtype=None, device=None) -> dict:
    """A position of the JAX package — its unconstrained hyperparameter tree,
    nested by the constrained quantity's name (``{"kernel": {"variance": u,
    "lengthscales": u}, "noise_variance": u}``, dicts or objects with such
    attributes, a composite's children a sequence under ``kernels``, leaves
    numpy arrays with or without a leading chain axis) —
    as the port's ``{parameter name: tensor}`` dict for ``params`` (a module
    or its named parameters)."""
    out = {}
    for name, p in _named(params).items():
        node = tree
        for key in _split(name)[0].split("."):
            if isinstance(node, dict):
                node = node[key]
            else:  # a kernel's fields, or the children of a Sum or a Product (a sequence)
                node = node[int(key)] if isinstance(node, (list, tuple)) else getattr(node, key)
        out[name] = torch.tensor(np.asarray(node), dtype=dtype or p.dtype, device=device or p.device)
    return out


def positions_to_tree(positions: dict) -> dict:
    """The inverse of ``positions_from_tree``: nested dicts of numpy arrays."""
    tree: dict = {}
    for name, x in positions.items():
        *heads, leaf = _split(name)[0].split(".")
        node = tree
        for head in heads:
            node = node.setdefault(head, {})
        node[leaf] = x.detach().cpu().numpy()
    return tree


def _leaf(dotted: str) -> str:
    return dotted.rpartition(".")[2]


def unconstrain(values: dict) -> dict:
    """``{dotted name of a quantity: value}`` — the JAX package's hyperparameter
    tree, flat (``kernel.variance``, ``noise_variance``) — as the port's
    ``{parameter name: unconstrained value}``: a positive quantity (its leaf
    in ``POSITIVE_FIELD_NAMES``) becomes softplus⁻¹ of its value under
    ``raw_<name>``; any other passes through (counterpart: ``unconstrain``,
    params.py:55)."""
    out = {}
    for dotted, x in values.items():
        head, _, leaf = dotted.rpartition(".")
        if leaf in POSITIVE_FIELD_NAMES:
            out[f"{head}.{RAW_PREFIX}{leaf}" if head else RAW_PREFIX + leaf] = inv_softplus(x)
        else:
            out[dotted] = x
    return out


def constrain(positions: dict) -> dict:
    """The inverse of ``unconstrain``: ``{parameter name: unconstrained
    value}`` as ``{dotted name of the quantity: value}``."""
    out = {}
    for name, u in positions.items():
        dotted, positive = _split(name)
        out[dotted] = softplus(u) if positive and _leaf(dotted) in POSITIVE_FIELD_NAMES else u
    return out


def as_arrays(tree, dtype=None, device=None):
    """Every leaf of a dict (nested or flat) as a tensor of ``dtype`` (the
    default float, ``config.default_float()``) on ``device`` (``None``: a
    tensor stays where it is, anything else goes to the card,
    ``config.resolve_device``) — counterpart: ``as_arrays``, params.py:70."""
    from parallel_gps_torch import config

    dtype = dtype or config.default_float()

    def leaf(x):
        if isinstance(x, Tensor):
            return x.to(dtype=dtype, device=device or x.device)
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=config.resolve_device(device))

    return {k: as_arrays(v, dtype, device) if isinstance(v, dict) else leaf(v) for k, v in tree.items()}


def tree_order(positions: dict) -> dict:
    """The positions in the order of the JAX package's hyperparameter tree,
    ``{"kernel": kernel, "noise_variance": u}`` flattened: its top-level keys
    sorted, then each kernel's fields and children in their own order, which
    is the port's ``named_parameters`` order within the kernel.  The
    experiments save their samples in this order (``sample_{j}``)."""
    return dict(sorted(positions.items(), key=lambda item: _split(item[0])[0].split(".")[0]))


def leaf_key(name: str) -> str:
    """A parameter's JAX leaf path joined by "_" (``kernel_variance``,
    ``kernel_kernels_0_period``, ``noise_variance``): the names the toy-model
    MCMC experiment saves its samples under."""
    return _split(name)[0].replace(".", "_")
