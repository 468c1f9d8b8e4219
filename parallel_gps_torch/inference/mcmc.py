"""MCMC kernels over unconstrained hyperparameters: HMC, MALA, NUTS
(counterpart: parallel_gps_tpu/inference/mcmc.py).

Batch-first, where the JAX package vmaps a single chain: a position is
``(C, P)`` for C chains, a log-probability function maps ``(C, P) → (C,)``,
and the gradient of all chains comes from one
``torch.autograd.grad(lp.sum(), q)`` — the chains are independent, so row c
of it is chain c's gradient.  A single chain is C = 1 (``sample_chain``).  For
a ``StateSpaceGP`` target the C chains are one launch of the batched kernels
per filter, smoother and Fisher tail (kalman/batched.py, kalman/dt.py).

Randomness is explicit: every kernel step takes a ``torch.Generator`` on the
chains' device and draws, for all C chains at once, from it alone.

Loops with data-dependent ends (the two ``lax.while_loop``s of NUTS and the
one of ``find_reasonable_step_size``) are Python loops over a per-chain
``active`` mask: every chain steps while any is active and a finished chain
is held by ``torch.where`` — what ``vmap`` of ``while_loop`` does.  Each test
of the mask is one host synchronisation; ``MASK_TESTS`` counts them (a NUTS
step makes at most ``max_depth + 2**max_depth − 1``).

NUTS is the multinomial variant (Betancourt 2017) with iterative tree
building: within-subtree U-turn checks use the aligned-block checkpoint
scheme (leaf i closes every block of size 2^k with (i+1) ≡ 0 mod 2^k; its
left endpoint was checkpointed when encountered), so detailed balance holds
without recursion.

``chunk_size`` bounds memory, nothing else: it splits the chain axis inside
the evaluation of the log-probability and its gradient, so the samplers still
draw for all C chains at once and a chunked run makes the same draws as a
monolithic one.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch
from torch import Tensor

# Host synchronisations made to test an ``active`` mask, by loop.
MASK_TESTS = {"nuts": 0, "step_size": 0}


class ChainState(NamedTuple):
    position: Tensor  # (C, P)
    log_prob: Tensor  # (C,)
    grad: Tensor  # (C, P)


class _Target:
    """A batched log-probability ``(C, P) → (C,)`` with its gradient."""

    def __init__(self, fn: Callable, chunk_size: int | None = None):
        self.fn = fn
        self.chunk_size = chunk_size

    def with_chunk_size(self, chunk_size: int | None) -> "_Target":
        return _Target(self.fn, chunk_size)

    def value_and_grad(self, q: Tensor):
        """(log-probabilities (C,), their gradients (C, P)), evaluated
        ``chunk_size`` chains at a time."""
        if self.chunk_size is None or q.shape[0] <= self.chunk_size:
            return self._value_and_grad(q)
        parts = [self._value_and_grad(qc) for qc in q.split(self.chunk_size)]
        return torch.cat([lp for lp, _ in parts]), torch.cat([g for _, g in parts])

    def _value_and_grad(self, q: Tensor):
        q = q.detach().requires_grad_()
        with torch.enable_grad():
            lp = self.fn(q)
            (g,) = torch.autograd.grad(lp.sum(), q, allow_unused=True)
        return lp.detach(), torch.zeros_like(q) if g is None else g


def _as_target(log_prob_fn) -> _Target:
    return log_prob_fn if isinstance(log_prob_fn, _Target) else _Target(log_prob_fn)


def _init_state(target: _Target, position_flat: Tensor) -> ChainState:
    lp, g = target.value_and_grad(position_flat)
    return ChainState(position_flat.detach(), lp, g)


def _per_chain(step_size, like: Tensor) -> Tensor:
    """The step size against (C, P) positions: a number, or (C,) — one per
    chain — as a column."""
    eps = torch.as_tensor(step_size, dtype=like.dtype, device=like.device)
    return eps[:, None] if eps.dim() == 1 else eps


def _where(mask: Tensor, new: Tensor, old: Tensor) -> Tensor:
    """``new`` for the chains of ``mask`` (C,), ``old`` for the others."""
    return torch.where(mask.reshape(mask.shape + (1,) * (new.dim() - 1)), new, old)


def _any(mask: Tensor, loop: str) -> bool:
    MASK_TESTS[loop] += 1
    return bool(mask.any())


def _leapfrog(target: _Target, state: ChainState, momentum: Tensor, step_size, n_steps: int):
    eps = _per_chain(step_size, state.position)
    q, p, g, lp = state.position, momentum, state.grad, state.log_prob
    for _ in range(n_steps):
        p = p + 0.5 * eps * g
        q = q + eps * p
        lp, g = target.value_and_grad(q)
        p = p + 0.5 * eps * g
    return ChainState(q, lp, g), p


def _accept_prob(log_accept: Tensor) -> Tensor:
    """Metropolis acceptance probability min(1, exp(log_accept)) — the
    per-step statistic whose mean the reference's protocol logs; NaN energies
    count 0."""
    a = torch.exp(torch.clamp(log_accept, max=0.0))
    return torch.where(torch.isnan(a), torch.zeros_like(a), a)


def _metropolis(generator, state: ChainState, new: ChainState, log_accept: Tensor):
    """Accept ``new`` per chain with probability min(1, e^log_accept)."""
    u = torch.rand(log_accept.shape, generator=generator, dtype=log_accept.dtype, device=log_accept.device)
    accept = torch.log(u) < log_accept  # False for a NaN energy
    out = ChainState(*(_where(accept, a, b) for a, b in zip(new, state)))
    return out, _accept_prob(log_accept)


def _randn_like(x: Tensor, generator) -> Tensor:
    return torch.randn(x.shape, generator=generator, dtype=x.dtype, device=x.device)


def _hmc_proposal(target: _Target, state: ChainState, p0: Tensor, step_size, num_leapfrog_steps: int):
    """The end of the trajectory from momentum ``p0`` and its log acceptance
    ratio, per chain."""
    new, p = _leapfrog(target, state, p0, step_size, num_leapfrog_steps)
    log_accept = new.log_prob - state.log_prob - 0.5 * (p**2).sum(-1) + 0.5 * (p0**2).sum(-1)
    return new, log_accept


def _hmc_step(target, generator, state, step_size, num_leapfrog_steps):
    p0 = _randn_like(state.position, generator)
    new, log_accept = _hmc_proposal(target, state, p0, step_size, num_leapfrog_steps)
    return _metropolis(generator, state, new, log_accept)


def _mala_proposal(target: _Target, state: ChainState, noise: Tensor, step_size):
    """The Langevin proposal q' = q + (ε²/2) ∇logπ(q) + ε ξ and its log
    acceptance ratio, per chain."""
    eps = _per_chain(step_size, state.position)
    eps2 = eps**2
    mean_fwd = state.position + 0.5 * eps2 * state.grad
    q_new = mean_fwd + eps * noise
    lp_new, g_new = target.value_and_grad(q_new)
    mean_bwd = q_new + 0.5 * eps2 * g_new
    log_q_fwd = (-0.5 * (q_new - mean_fwd) ** 2 / eps2).sum(-1)
    log_q_bwd = (-0.5 * (state.position - mean_bwd) ** 2 / eps2).sum(-1)
    log_accept = lp_new - state.log_prob + log_q_bwd - log_q_fwd
    return ChainState(q_new, lp_new, g_new), log_accept


def _mala_step(target, generator, state, step_size):
    noise = _randn_like(state.position, generator)
    new, log_accept = _mala_proposal(target, state, noise, step_size)
    return _metropolis(generator, state, new, log_accept)


# --------------------------------------------------------------------------
# NUTS (multinomial, iterative)
# --------------------------------------------------------------------------


def _is_turning(q_minus, p_minus, q_plus, p_plus) -> Tensor:
    dq = q_plus - q_minus
    return ((dq * p_minus).sum(-1) < 0.0) | ((dq * p_plus).sum(-1) < 0.0)


def _nuts_subtree(target, generator, q, p, g, depth: int, energy0, active, step_size, max_depth: int):
    """Add up to 2^depth leaves from (q, p, g) for the chains of ``active``,
    with aligned-block U-turn checks against per-level checkpoints.  A chain
    stops at its first turning or diverging leaf; the others go on.  Returns
    the far endpoint, the subtree's proposal and log-weight, and its turning,
    diverging and acceptance sums, each per chain."""
    C = q.shape[0]
    dtype, dev = q.dtype, q.device
    q_prop, g_prop = q, g
    lp_prop = torch.full((C,), -math.inf, dtype=dtype, device=dev)
    log_w = torch.full((C,), -math.inf, dtype=dtype, device=dev)
    turning = torch.zeros((C,), dtype=torch.bool, device=dev)
    diverging = torch.zeros((C,), dtype=torch.bool, device=dev)
    sum_alpha = torch.zeros((C,), dtype=dtype, device=dev)
    n_alpha = torch.zeros((C,), dtype=dtype, device=dev)
    ckpt_q = [torch.zeros_like(q) for _ in range(max_depth + 1)]  # left endpoints per level
    ckpt_p = [torch.zeros_like(q) for _ in range(max_depth + 1)]
    for i in range(1 << depth):
        live = active & ~turning & ~diverging
        if not _any(live, "nuts"):
            break
        u = torch.rand((C,), generator=generator, dtype=dtype, device=dev)
        new, p_new = _leapfrog(target, ChainState(q, None, g), p, step_size, 1)
        energy = -new.log_prob + 0.5 * (p_new**2).sum(-1)
        log_w_leaf = energy0 - energy
        diverging = diverging | (live & ((log_w_leaf < -1000.0) | torch.isnan(energy)))
        # Trajectory-mean Metropolis acceptance (Stan's accept_stat).
        sum_alpha = sum_alpha + torch.where(live, _accept_prob(log_w_leaf), torch.zeros_like(sum_alpha))
        n_alpha = n_alpha + live.to(dtype)
        # Reservoir (multinomial) proposal update.
        log_w_new = torch.logaddexp(log_w, log_w_leaf)
        take = live & (torch.log(u) < log_w_leaf - log_w_new)
        q_prop, g_prop = _where(take, new.position, q_prop), _where(take, new.grad, g_prop)
        lp_prop = torch.where(take, new.log_prob, lp_prop)
        log_w = torch.where(live, log_w_new, log_w)
        q, p, g = _where(live, new.position, q), _where(live, p_new, p), _where(live, new.grad, g)
        # Checkpoint: leaf i is the left endpoint of every aligned block of
        # size 2^k with i ≡ 0 (mod 2^k); it closes every block with
        # (i+1) ≡ 0 (mod 2^k), k ≥ 1, and is compared with that checkpoint.
        for k in range(1, max_depth + 1):
            if i % (1 << k) == 0:
                ckpt_q[k], ckpt_p[k] = _where(live, q, ckpt_q[k]), _where(live, p, ckpt_p[k])
        for k in range(1, max_depth + 1):
            if (i + 1) % (1 << k) == 0:
                turning = turning | (live & _is_turning(ckpt_q[k], ckpt_p[k], q, p))
    return q, p, g, q_prop, lp_prop, g_prop, log_w, turning, diverging, sum_alpha, n_alpha


def _nuts_step(target, generator, state, step_size, max_depth):
    q0, lp0, g0 = state
    C = q0.shape[0]
    dtype, dev = q0.dtype, q0.device
    p0 = _randn_like(q0, generator)
    energy0 = -lp0 + 0.5 * (p0**2).sum(-1)
    q_left, p_left, g_left = q0, -p0, g0  # momentum pointing backwards for the left expansion
    q_right, p_right, g_right = q0, p0, g0
    q_prop, lp_prop, g_prop = q0, lp0, g0
    log_weight = torch.zeros((C,), dtype=dtype, device=dev)  # energy0 − energy0
    turning = torch.zeros((C,), dtype=torch.bool, device=dev)
    diverging = torch.zeros((C,), dtype=torch.bool, device=dev)
    sum_alpha = torch.zeros((C,), dtype=dtype, device=dev)
    n_alpha = torch.zeros((C,), dtype=dtype, device=dev)
    # A chain still active at doubling ``depth`` has been active at every one
    # before, so its tree depth is the loop's.
    for depth in range(max_depth):
        active = ~turning & ~diverging
        if not _any(active, "nuts"):
            break
        go_right = torch.rand((C,), generator=generator, dtype=dtype, device=dev) < 0.5
        u_take = torch.rand((C,), generator=generator, dtype=dtype, device=dev)
        q_s, p_s, g_s = (_where(go_right, r, l) for r, l in ((q_right, q_left), (p_right, p_left), (g_right, g_left)))
        (q_e, p_e, g_e, sq_prop, slp_prop, sg_prop, s_log_w, s_turning, s_diverging, s_sum, s_n) = _nuts_subtree(
            target, generator, q_s, p_s, g_s, depth, energy0, active, step_size, max_depth
        )
        # New overall endpoint in the chosen direction.
        to_right, to_left = active & go_right, active & ~go_right
        q_right, p_right, g_right = _where(to_right, q_e, q_right), _where(to_right, p_e, p_right), _where(to_right, g_e, g_right)
        q_left, p_left, g_left = _where(to_left, q_e, q_left), _where(to_left, p_e, p_left), _where(to_left, g_e, g_left)
        bad = s_turning | s_diverging
        # Biased progressive sampling between the old tree and the new subtree.
        take_new = active & (torch.log(u_take) < s_log_w - log_weight) & ~bad
        q_prop, g_prop = _where(take_new, sq_prop, q_prop), _where(take_new, sg_prop, g_prop)
        lp_prop = torch.where(take_new, slp_prop, lp_prop)
        log_weight = torch.where(active & ~bad, torch.logaddexp(log_weight, s_log_w), log_weight)
        turning = torch.where(active, bad | _is_turning(q_left, -p_left, q_right, p_right), turning)
        diverging = diverging | (active & s_diverging)
        sum_alpha, n_alpha = sum_alpha + s_sum, n_alpha + s_n
    # Trajectory-mean Metropolis acceptance over all visited leaves — the
    # statistic dual averaging targets.
    accept_stat = sum_alpha / torch.clamp(n_alpha, min=1.0)
    return ChainState(q_prop, lp_prop, g_prop), accept_stat


# --------------------------------------------------------------------------
# Kernels
# --------------------------------------------------------------------------


class _Kernel:
    """A kernel step ``step(generator, state) → (state, acceptance statistic
    (C,))`` bound to its target and parameters."""

    def __init__(self, step_fn: Callable, target: _Target, **params):
        self.step_fn, self.target, self.params = step_fn, target, params

    def __call__(self, generator, state: ChainState):
        return self.step_fn(self.target, generator, state, **self.params)

    def with_chunk_size(self, chunk_size: int | None) -> "_Kernel":
        return _Kernel(self.step_fn, self.target.with_chunk_size(chunk_size), **self.params)


def hmc_kernel(log_prob_fn: Callable, step_size, num_leapfrog_steps: int = 10) -> _Kernel:
    """Hamiltonian Monte Carlo.  ``step_size``: a number or one per chain (C,)."""
    return _Kernel(_hmc_step, _as_target(log_prob_fn), step_size=step_size, num_leapfrog_steps=num_leapfrog_steps)


def mala_kernel(log_prob_fn: Callable, step_size) -> _Kernel:
    """Metropolis-adjusted Langevin."""
    return _Kernel(_mala_step, _as_target(log_prob_fn), step_size=step_size)


def nuts_kernel(log_prob_fn: Callable, step_size, max_depth: int = 8) -> _Kernel:
    """No-U-Turn sampler."""
    return _Kernel(_nuts_step, _as_target(log_prob_fn), step_size=step_size, max_depth=max_depth)


def make_kernel(name: str, log_prob_flat, step_size, **kwargs) -> _Kernel:
    """Factory mirroring the reference's MCMC enum."""
    name = name.upper()
    if name == "HMC":
        return hmc_kernel(log_prob_flat, step_size, kwargs.get("num_leapfrog_steps", 10))
    if name == "MALA":
        return mala_kernel(log_prob_flat, step_size)
    if name == "NUTS":
        return nuts_kernel(log_prob_flat, step_size, kwargs.get("max_depth", 8))
    raise ValueError(f"unknown MCMC kernel: {name}")


# --------------------------------------------------------------------------
# Positions as {name: tensor} dicts
# --------------------------------------------------------------------------


def ravel_positions(positions):
    """A position — a tensor (C, …) or a ``{name: tensor (C, …)}`` dict, e.g.
    of a model's parameters in ``named_parameters()`` order — as one (C, P)
    tensor, with the function that maps (…, C, P) back to the structure."""
    if isinstance(positions, Tensor):
        shape = tuple(positions.shape[1:])
        return positions.reshape(positions.shape[0], -1), lambda x: x.reshape(x.shape[:-1] + shape)
    names = list(positions)
    shapes = [tuple(positions[n].shape[1:]) for n in names]
    sizes = [math.prod(s) for s in shapes]
    C = positions[names[0]].shape[0]
    flat = torch.cat([positions[n].reshape(C, -1) for n in names], 1)

    def unravel(x: Tensor) -> dict:
        parts = x.split(sizes, -1)
        return {n: part.reshape(x.shape[:-1] + s) for n, part, s in zip(names, parts, shapes)}

    return flat, unravel


# --------------------------------------------------------------------------
# Running chains
# --------------------------------------------------------------------------


def sample_chains(
    kernel_step: Callable,
    initial_positions,
    log_prob_fn_tree: Callable,
    generator: torch.Generator,
    num_samples: int,
    num_burnin: int = 0,
    chunk_size: int | None = None,
):
    """Run C chains in step; returns (samples with leaves
    (C, num_samples, …), acceptance statistic (C, num_samples) — the
    (trajectory-mean) Metropolis acceptance probability of each step).

    ``initial_positions``: a tensor or ``{name: tensor}`` dict whose leaves
    carry a leading chain axis; ``log_prob_fn_tree`` takes that structure and
    returns (C,).  ``chunk_size`` (default: all chains at once) evaluates the
    log-probability ``chunk_size`` chains at a time, in this function and in
    a ``kernel_step`` made by this module's factories; the draws stay those
    of the monolithic run.
    """
    flat0, unravel = ravel_positions(initial_positions)
    target = _Target(lambda x: log_prob_fn_tree(unravel(x)), chunk_size)
    if chunk_size is not None and isinstance(kernel_step, _Kernel):
        kernel_step = kernel_step.with_chunk_size(chunk_size)
    state = _init_state(target, flat0)
    positions, accepted = [], []
    for i in range(num_samples + num_burnin):
        state, acc = kernel_step(generator, state)
        if i >= num_burnin:
            positions.append(state.position)
            accepted.append(acc)
    C, P = flat0.shape
    pos = torch.stack(positions, 1) if positions else flat0.new_zeros((C, 0, P))
    acc = torch.stack(accepted, 1) if accepted else flat0.new_zeros((C, 0))
    return unravel(pos), acc


def sample_chain(
    kernel_step: Callable,
    initial_position,
    log_prob_fn_tree: Callable,
    generator: torch.Generator,
    num_samples: int,
    num_burnin: int = 0,
):
    """One chain: ``sample_chains`` at C = 1.  ``initial_position`` has no
    chain axis and the results have none: samples (num_samples, …), acceptance
    (num_samples,).  The log-probability functions stay batch-first (they see
    a leading axis of 1)."""
    add = lambda x: x[None]  # noqa: E731
    lead = add(initial_position) if isinstance(initial_position, Tensor) else {k: add(v) for k, v in initial_position.items()}
    samples, acc = sample_chains(kernel_step, lead, log_prob_fn_tree, generator, num_samples, num_burnin)
    samples = samples[0] if isinstance(samples, Tensor) else {k: v[0] for k, v in samples.items()}
    return samples, acc[0]


# --------------------------------------------------------------------------
# Step-size adaptation (opt-in): Nesterov dual averaging (Hoffman & Gelman
# 2014, Algorithms 4–6), per chain.
# --------------------------------------------------------------------------


def find_reasonable_step_size(
    log_prob_flat: Callable, state: ChainState | Tensor, generator: torch.Generator, init: float = 1.0, max_iters: int = 60
) -> Tensor:
    """Algorithm 4 of Hoffman & Gelman, per chain: from ``init``, double
    (halve) the step size until the one-leapfrog acceptance probability
    crosses 1/2.  ``state``: the chains' state, or their flat positions
    (C, P), which are evaluated here.  Returns (C,); NaN energies count as
    acceptance 0."""
    target = _as_target(log_prob_flat)
    if isinstance(state, Tensor):
        state = _init_state(target, state)
    q = state.position
    p0 = _randn_like(q, generator)
    k0 = 0.5 * (p0**2).sum(-1)

    def log_alpha(eps):
        new, p = _leapfrog(target, state, p0, eps, 1)
        la = new.log_prob - state.log_prob - 0.5 * (p**2).sum(-1) + k0
        return torch.where(torch.isnan(la), torch.full_like(la, -math.inf), la)

    log2 = math.log(2.0)
    eps = torch.full((q.shape[0],), float(init), dtype=q.dtype, device=q.device)
    a = torch.where(log_alpha(eps) > -log2, 1.0, -1.0).to(q.dtype)
    done = torch.zeros_like(a, dtype=torch.bool)
    for _ in range(max_iters):
        done = done | ~(a * log_alpha(eps) > -a * log2)
        if not _any(~done, "step_size"):
            break
        eps = torch.where(done, eps, eps * torch.exp(a * log2))
    return eps


def dual_averaging_warmup(
    make_step: Callable,
    initial_positions,
    log_prob_fn_tree: Callable,
    generator: torch.Generator,
    num_warmup: int = 500,
    target_accept: float = 0.8,
    gamma: float = 0.05,
    t0: float = 10.0,
    kappa: float = 0.75,
    init_step_size: float | None = None,
    chunk_size: int | None = None,
):
    """Adapt each chain's step size over ``num_warmup`` iterations; returns
    (step sizes (C,), warmed positions in the structure given).

    ``make_step(eps)`` must build a kernel step (e.g.
    ``lambda e: make_kernel("nuts", lp_flat, e)``) whose second return is the
    acceptance statistic the adaptation targets — the kernels here all return
    the (trajectory-mean) Metropolis acceptance probability."""
    flat0, unravel = ravel_positions(initial_positions)
    target = _Target(lambda x: log_prob_fn_tree(unravel(x)), chunk_size)
    state = _init_state(target, flat0)
    dtype, dev = flat0.dtype, flat0.device
    if init_step_size is None:
        eps0 = find_reasonable_step_size(target, state, generator)
    else:
        eps0 = torch.full((flat0.shape[0],), float(init_step_size), dtype=dtype, device=dev)
    mu = torch.log(10.0 * eps0)
    log_eps = torch.log(eps0)
    log_eps_bar = log_eps.clone()
    h_bar = torch.zeros_like(eps0)
    for m in range(1, num_warmup + 1):
        step = make_step(torch.exp(log_eps))
        if chunk_size is not None and isinstance(step, _Kernel):
            step = step.with_chunk_size(chunk_size)
        state, alpha = step(generator, state)
        alpha = torch.clamp(alpha.to(dtype), 0.0, 1.0)
        h_bar = (1.0 - 1.0 / (m + t0)) * h_bar + (target_accept - alpha) / (m + t0)
        log_eps = mu - math.sqrt(m) / gamma * h_bar
        eta = m**-kappa
        log_eps_bar = eta * log_eps + (1.0 - eta) * log_eps_bar
    return torch.exp(log_eps_bar), unravel(state.position)
