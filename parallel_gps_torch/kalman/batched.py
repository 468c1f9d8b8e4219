"""Single-pass batched filter and smoother: B independent series, or B MCMC
chains over one series, through one launch each (counterpart: the batched
engine of parallel_gps_tpu/kalman/pallas_scan.py, ``batched_strip_filter`` /
``batched_strip_smoother``, which ``jax.vmap`` of the single-series entry
points dispatches to).

Layouts are the JAX package's: planes ``Fs_bt``, ``Qs_bt``, ``C_bt``
(d, d, B, T), moments ``b_bt`` (d, B, T), ``P0_b`` (B, d, d), ``H_b``
(B, 1, d), ``R_b`` (B, 1, 1), observations ``ys_b`` (B, T) with NaN = missing.
An operand that all series share — one model and B observation vectors, or
one observation vector for B chains — is passed as an ``expand``-ed view
(batch stride 0) and is never copied B times.

Unlike the two-pass strip and dt engines there is no prefix step between two
passes: every (series, tile) pair is a thread block, a tile of ``threads ×
chunk`` steps (``tile_shape``), and each tile takes the inclusive total of
the tile before it in its series from the block that computed it, in one
launch (``csrc/batched_scan.cu``: a chained scan, so two launches give the
same bits); at the units of ``WALK`` one block walks each series' tiles in
order instead (``csrc/batched_walk.cuh``).  Each wrapper dispatches on the
device of its tensors:

  - CUDA, d ≤ 8, float32 or float64: the hand-written kernel; anything else
    on CUDA raises;
  - CPU: the plain PyTorch version (``*_plain``), the time-last Kogge–Stone
    engine with the batch axis riding along.

A wait between two tiles that outlasts ``MAX_POLLS`` polls makes the
series' log-likelihood (the filter) or moments NaN and is raised without a
host synchronisation at each launch: a later launch's wrapper raises it once
the failed launch has finished, and ``check_overruns()`` waits for every
launch and raises it.

``LAUNCHES`` counts kernel launches by kernel name.
"""
from __future__ import annotations

from collections import deque

import torch
from torch import Tensor

from parallel_gps_torch.kalman.strip import filt_rows, smooth_rows, warp_stage_budget
from parallel_gps_torch.kalman.timelast import pkf_from_tl, pks_from_tl
from parallel_gps_torch.types import LGSSMTL

LAUNCHES = {"batched_filter": 0, "batched_smoother": 0}

MAX_KERNEL_D = 8
KINDS = ("filter", "smoother")
# The tiles of the kernels (csrc/batched_scan.cu: BatchedTile), mirrored here
# and checked against the library when it loads (kalman/_cuda.py).  The state
# dimensions whose warps stage their rows (the filter's F, Q and y, 2d² + 1;
# the smoother's b, C, F and Q, 3d² + d), by pass and scalar type, where that
# measured faster on an H100 (PERF.md §6, kBatched*Staged); the rest read
# them directly.  Steps a thread: one 32-byte sector of a row where the unit
# stages (8 float32, 4 float64), DIRECT_CHUNK where it reads directly.
DIRECT_CHUNK = 4
STAGED = {
    "filter": {torch.float32: frozenset({1, 3}), torch.float64: frozenset({1, 3, 4, 5, 6})},
    "smoother": {torch.float32: frozenset({1, 2, 3, 6}), torch.float64: frozenset(range(1, 8))},
}
# The units that keep one block walking each series' tiles in order, the
# kernels' first design (csrc/batched_walk.cuh), where the chained tiles
# measured slower (kBatched*Walk): 128, 64 or 32 threads a block at d ≤ 3,
# ≤ 5, above, WALK_CHUNK steps a thread.
WALK = {
    "filter": {torch.float32: frozenset(), torch.float64: frozenset({7, 8})},
    "smoother": {torch.float32: frozenset(), torch.float64: frozenset({8})},
}
WALK_CHUNK = 8
# Polls of the previous tile's flag before a tile gives up (each poll sleeps
# up to 256 ns): seconds, against the microseconds a tile takes.  Read at
# every launch.
MAX_POLLS = 1 << 22
OVERRUN = 1  # csrc/tile_scan.cuh: kSpinOverrun
# Launches whose overrun word has not been read yet: (kernel, what, host
# copy of the status, event after the copy).
_PENDING: deque = deque()


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def tile_shape(d: int, dtype, kind: str) -> tuple[int, int, int, int]:
    """(threads a block, steps a thread, rows a warp stages, dynamic shared
    memory a block in bytes) of the ``kind`` ("filter" or "smoother") kernel
    at state dimension ``d`` and scalar type ``dtype``: a tile is threads ×
    steps consecutive steps of one series.  A staged unit's warps keep their
    chunks' rows (a chunk is 32 / itemsize steps, in a slot of one more
    value); no rows where the unit reads them directly.  Each block also
    holds one element a thread (the block scan), one more (the prefix), the
    filter's scalars [P0 | h | r] and four ints; 4, 2 or 1 warps, whichever
    leaves an SM the most warps (``strip.warp_stage_budget``).  A unit of
    ``WALK`` has one block a series, which scans a tile at a time in NT + 1
    elements of shared memory."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    size = torch.finfo(dtype).bits // 8
    filt = kind == "filter"
    elem = filt_rows(d) if filt else smooth_rows(d)
    if d in WALK[kind][dtype]:  # a block walks a series: the tile it scans at a time
        threads = 128 if d <= 3 else 64 if d <= 5 else 32
        return threads, WALK_CHUNK, 0, size * elem * (threads + 1)
    scal = d * d + d + 1 if filt else 0
    staged = d in STAGED[kind][dtype]
    chunk = 32 // size if staged else DIRECT_CHUNK
    rows = (2 * d * d + 1 if filt else 3 * d * d + d) if staged else 0
    block = size * (elem + scal) + 16
    threads, _, smem = warp_stage_budget(rows, dtype, per_thread=size * elem, table=block, buffers=int(staged))
    return threads, chunk, rows, smem + threads * size * elem


def n_tiles(d: int, dtype, kind: str, T: int) -> int:
    threads, chunk, _, _ = tile_shape(d, dtype, kind)
    return -(-T // (threads * chunk))


def series_observations(observations: Tensor, shape) -> Tensor:
    """Observations as (B, T): given per series, or one (T,) vector that all
    B series share, expanded without a copy."""
    B, T = shape
    if observations.numel() == B * T:
        return observations.reshape(B, T)
    return observations.reshape(1, T).expand(B, T)


# --------------------------------------------------------------------------
# Plain versions
# --------------------------------------------------------------------------


def batched_strip_filter_plain(Fs_bt, Qs_bt, P0_b, H_b, R_b, ys_b):
    """Plain batched filter: (b (d, B, T), C (d, d, B, T), ell (B,))."""
    return pkf_from_tl(LGSSMTL(P0_b, Fs_bt, Qs_bt, H_b, R_b), ys_b, True)


def batched_strip_smoother_plain(Fs_bt, Qs_bt, b_bt, C_bt, H_b, project: bool = True):
    """Plain batched smoother: (g (d, B, T), L (d, d, B, T)) and, with
    ``project``, the H-projections mean = h·g and var = hᵀLh, each (B, T)."""
    g, L = pks_from_tl(LGSSMTL(None, Fs_bt, Qs_bt, None, None), b_bt, C_bt)
    if not project:
        return g, L
    h = H_b[:, 0, :].transpose(0, 1)[..., None]  # (d, B, 1)
    return g, L, (h * g).sum(0), (h[:, None] * h[None] * L).sum((0, 1))


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise ValueError(f"batched CUDA kernels: {what}")


def _strided(x: Tensor, lead: int):
    """(x, plane stride, batch stride) of an operand with ``lead`` matrix axes
    before its (B, T) axes.  The kernels address element (q, series, t) at
    q·plane + series·batch + t; a view that does not fit (time not
    contiguous, or matrix axes that do not flatten) is copied."""
    st = x.stride()
    fits = (x.shape[-1] == 1 or st[-1] == 1) and (lead < 2 or st[0] == x.shape[1] * st[1]) and min(st) >= 0
    if not fits:
        x = x.contiguous()
        st = x.stride()
    return x, (st[lead - 1] if lead else 0), st[lead]


def _check(Fs_bt: Tensor, tensors: dict):
    """Validate the inputs of a launch; returns (d, B, T).  ``tensors``:
    {name: (tensor, shape)}."""
    dev, dtype = Fs_bt.device, Fs_bt.dtype
    _require(dev.type == "cuda", f"tensors must be on a CUDA device, got {dev}")
    _require(dtype in (torch.float32, torch.float64), f"dtype must be float32 or float64, got {dtype}")
    _require(
        Fs_bt.dim() == 4 and Fs_bt.shape[0] == Fs_bt.shape[1] and Fs_bt.shape[2] >= 1 and Fs_bt.shape[3] >= 1,
        f"Fs must be (d, d, B, T) with B, T >= 1, got {tuple(Fs_bt.shape)}",
    )
    d, _, B, T = Fs_bt.shape
    _require(1 <= d <= MAX_KERNEL_D, f"state dimension {d} > {MAX_KERNEL_D}")
    sizes = {"d": d, "B": B, "T": T}
    for name, (x, shape) in tensors.items():
        shape = tuple(sizes.get(s, s) for s in shape)
        _require(x.device == dev, f"{name} is on {x.device}, expected {dev}")
        _require(x.dtype == dtype, f"{name} has dtype {x.dtype}, expected {dtype}")
        _require(tuple(x.shape) == shape, f"{name} must have shape {shape}, got {tuple(x.shape)}")
    return d, B, T


def _launch(name: str, d: int, dtype, *args) -> None:
    from parallel_gps_torch.kalman import _cuda

    bits = 64 if dtype == torch.float64 else 32
    _cuda.launch(name, getattr(_cuda.load(), f"pgt_{name}_d{d}_f{bits}"), *args)
    LAUNCHES[name] += 1


def _scratch(d: int, dtype, kind: str, B: int, T: int, dev):
    """(status, incl, tiles) of a launch: status zeroed — ticket, overrun,
    one flag a tile and, for the filter, one arrival counter a series — and
    one inclusive element a tile, written before its flag is raised."""
    tiles = B * n_tiles(d, dtype, kind, T)
    status = torch.zeros(2 + tiles + (B if kind == "filter" else 0), dtype=torch.int32, device=dev)
    incl = torch.empty((tiles, filt_rows(d) if kind == "filter" else smooth_rows(d)), dtype=dtype, device=dev)
    return status, incl, tiles


def _watch(name: str, what: str, status: Tensor) -> None:
    """Raise the overruns of earlier launches that have finished, and keep
    this launch's overrun word for a later call: copied to the host behind
    the launch, read once the copy has landed."""
    check_overruns(wait=False)
    host = torch.empty(2, dtype=torch.int32, pin_memory=True)
    with torch.cuda.device(status.device):
        host.copy_(status[:2], non_blocking=True)
        event = torch.cuda.Event()
        event.record()
    _PENDING.append((name, what, host, event))


def check_overruns(wait: bool = True) -> None:
    """Raise if a launch of either kernel had a wait outlast ``MAX_POLLS``
    polls (its series' outputs are NaN).  With ``wait`` (the default) every
    launch so far is waited for; else only those that have finished are
    read."""
    while _PENDING:
        name, what, host, event = _PENDING[0]
        if not wait and not event.query():
            return
        event.synchronize()
        _PENDING.popleft()
        if int(host[1]) == OVERRUN:
            _PENDING.clear()
            raise RuntimeError(f"{name}: a wait between two tiles outlasted {MAX_POLLS} polls ({what})")


_PLANE = ("d", "d", "B", "T")


def batched_strip_filter(Fs_bt, Qs_bt, P0_b, H_b, R_b, ys_b):
    """Batched filter in one launch; returns (b (d, B, T), C (d, d, B, T),
    ell (B,)), each series' log-likelihood summed in a fixed order."""
    if Fs_bt.device.type == "cpu":
        return batched_strip_filter_plain(Fs_bt, Qs_bt, P0_b, H_b, R_b, ys_b)
    d, B, T = _check(
        Fs_bt,
        {"Qs": (Qs_bt, _PLANE), "P0": (P0_b, ("B", "d", "d")), "H": (H_b, ("B", 1, "d")), "R": (R_b, ("B", 1, 1)),
         "ys": (ys_b, ("B", "T"))},
    )
    dev, dtype = Fs_bt.device, Fs_bt.dtype
    Fs_bt, f_ps, f_bs = _strided(Fs_bt, 2)
    Qs_bt, q_ps, q_bs = _strided(Qs_bt, 2)
    ys_b, _, y_bs = _strided(ys_b, 0)
    # Per-series scalar table, rows [P0 (d²) | h (d) | r].
    scal = torch.cat([P0_b.reshape(B, -1), H_b.reshape(B, -1), R_b.reshape(B, -1)], 1).contiguous()
    b = torch.empty((d, B, T), dtype=dtype, device=dev)
    C = torch.empty((d, d, B, T), dtype=dtype, device=dev)
    ell = torch.empty((B,), dtype=dtype, device=dev)
    status, incl, tiles = _scratch(d, dtype, "filter", B, T, dev)
    parts = torch.empty((tiles,), dtype=dtype, device=dev)  # each tile's share of its series' ell
    max_polls = MAX_POLLS
    _require(max_polls >= 0, f"MAX_POLLS must be >= 0, got {max_polls}")
    _launch(
        "batched_filter", d, dtype, scal, Fs_bt, f_ps, f_bs, Qs_bt, q_ps, q_bs, ys_b, y_bs,
        b, C, ell, T, B, status, incl, parts, max_polls, dev,
    )
    _watch("batched_filter", f"d = {d}, B = {B}, T = {T}", status)
    return b, C, ell


def batched_strip_smoother(Fs_bt, Qs_bt, b_bt, C_bt, H_b, project: bool = True):
    """Batched smoother in one launch over filtered moments; returns
    (g (d, B, T), L (d, d, B, T), mean (B, T), var (B, T)) — the last two the
    fused H-projections — or (g, L) alone with ``project=False`` (``H_b`` is
    then not read and may be ``None``)."""
    if Fs_bt.device.type == "cpu":
        return batched_strip_smoother_plain(Fs_bt, Qs_bt, b_bt, C_bt, H_b, project)
    named = {"Qs": (Qs_bt, _PLANE), "b": (b_bt, ("d", "B", "T")), "C": (C_bt, _PLANE)}
    if project:
        named["H"] = (H_b, ("B", 1, "d"))
    d, B, T = _check(Fs_bt, named)
    dev, dtype = Fs_bt.device, Fs_bt.dtype
    Fs_bt, f_ps, f_bs = _strided(Fs_bt, 2)
    Qs_bt, q_ps, q_bs = _strided(Qs_bt, 2)
    b_bt, b_ps, b_bs = _strided(b_bt, 1)
    C_bt, c_ps, c_bs = _strided(C_bt, 2)
    g = torch.empty((d, B, T), dtype=dtype, device=dev)
    L = torch.empty((d, d, B, T), dtype=dtype, device=dev)
    if project:
        h = H_b.reshape(B, d).contiguous()
        mean = torch.empty((B, T), dtype=dtype, device=dev)
        var = torch.empty((B, T), dtype=dtype, device=dev)
    else:
        h = mean = var = None
    status, incl, _ = _scratch(d, dtype, "smoother", B, T, dev)
    max_polls = MAX_POLLS
    _require(max_polls >= 0, f"MAX_POLLS must be >= 0, got {max_polls}")
    _launch(
        "batched_smoother", d, dtype, int(project), h, Fs_bt, f_ps, f_bs, Qs_bt, q_ps, q_bs,
        b_bt, b_ps, b_bs, C_bt, c_ps, c_bs, g, L, mean, var, T, B, status, incl, max_polls, dev,
    )
    _watch("batched_smoother", f"d = {d}, B = {B}, T = {T}", status)
    return (g, L, mean, var) if project else (g, L)
