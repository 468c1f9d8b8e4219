"""Two-level (blocked) associative scan over the leading axis
(counterpart: parallel_gps_tpu/ops/scan.py).

PyTorch has no ``associative_scan``; the flat scan here is Kogge–Stone over
axis 0 (ceil(log2 T) rounds of shift + identity fill + combine), and the
blocked scan runs it inside blocks, over the block totals, and folds each
block's exclusive prefix back in.  Elements are NamedTuples of tensors with
the scan axis first; ``identity`` leaves have no scan axis.
"""
from __future__ import annotations

import math
from typing import Callable

import torch


def _map(fn, *trees):
    return type(trees[0])(*(fn(*leaves) for leaves in zip(*trees)))


def _pick_block(T: int, cap: int = 4096, floor: int = 128):
    """Power-of-two block length ≤ cap with ≥ 2 blocks; None → flat scan."""
    if T < 2 * floor:
        return None
    b = cap
    while b > T // 2:
        b //= 2
    return max(b, floor)


def _fill(ident, x, n: int, axis: int):
    """``n`` identity elements along ``axis``, shaped to concatenate with x."""
    shape = list(x.shape)
    shape[axis] = n
    return ident.to(x.dtype).expand(shape)


def associative_scan(operator: Callable, elems, identity, reverse: bool = False, axis: int = 0):
    """Inclusive Kogge–Stone scan along ``axis`` (leaves may carry leading
    block axes before it).  ``reverse`` accumulates from the end with the
    later partial on the LEFT of the operator, as
    ``jax.lax.associative_scan(reverse=True)`` does."""
    T = elems[0].shape[axis]
    shift = 1
    for _ in range(math.ceil(math.log2(T)) if T > 1 else 0):

        def shifted(x, ident):
            fill = _fill(ident, x, shift, axis)
            if reverse:
                return torch.cat([x.narrow(axis, shift, T - shift), fill], axis)
            return torch.cat([fill, x.narrow(axis, 0, T - shift)], axis)

        elems = operator(_map(shifted, elems, identity), elems)
        shift *= 2
    return elems


def blocked_associative_scan(operator: Callable, elems, identity, reverse: bool = False, block: int | None = None):
    """Two-level inclusive scan along axis 0: T is cut into (B, L) blocks
    (identity-padded at the end), each block is scanned, the B block totals
    are scanned, and each block's incoming prefix (suffix, for ``reverse``)
    is applied on the left of its local results."""
    T = elems[0].shape[0]
    if block is None:
        block = _pick_block(T)
    if block is None or T < 2 * block:
        return associative_scan(operator, elems, identity, reverse)
    B = -(-T // block)
    Tp = B * block
    if Tp != T:
        elems = _map(lambda x, i: torch.cat([x, _fill(i, x, Tp - T, 0)], 0), elems, identity)
    blocked = _map(lambda x: x.reshape((B, block) + x.shape[1:]), elems)
    inner = associative_scan(operator, blocked, identity, reverse, axis=1)

    totals = _map(lambda x: x[:, 0 if reverse else -1], inner)
    scanned = associative_scan(operator, totals, identity, reverse)

    def exclusive(x, ident):
        edge = _fill(ident, x, 1, 0)
        return torch.cat([x[1:], edge], 0) if reverse else torch.cat([edge, x[:-1]], 0)

    prefixes = _map(exclusive, scanned, identity)
    out = operator(_map(lambda x: x[:, None], prefixes), inner)
    return _map(lambda x: x.reshape((Tp,) + x.shape[2:])[:T], out)
