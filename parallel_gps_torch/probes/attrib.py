"""Read-floor probe: where a strip-filter pass's time goes on the card
(counterpart of scripts/bench_r4_attrib.py).

At d = 3 (Matern52(0.8, 0.4), noise 0.1) on T steps it times

  - the read floor of a filter pass, a hand-written kernel of
    ``csrc/probes.cu`` that reads what the strip filter reads — F and Q as the
    port holds them, (d, d, T) from ``get_ssm_tl``, and y (T,), NaN = missing
    — once, in the strip kernels' chunk pattern (thread c reads steps
    [cK, cK + K), K = ``kalman/strip.py::CHUNK``) and coalesced; each block
    writes the sum of its 128·K steps' values (F, then Q, then y and 1 where
    y is observed), so both patterns compute one function;
  - beside it, through the port's own kernels and entry points: the strip
    filter's pass 1 (``strip_filter_scan``), pass 2 with its prefixes fixed
    (``strip_filter_apply``), ``strip_filter``, ``timelast.lml_tl(strip=True)``
    and ``timelast.pkfs_from_tl(strip=True)``;
  - the cost of one launch: an empty kernel (the tile probe's ``noop`` on one
    block) and one small PyTorch operation, each on the device (CUDA events
    around the call queued behind a held stream) and on the host (host clock
    over back-to-back calls).

    python -m parallel_gps_torch.probes.attrib            # on the card, T = 10M
    python -m parallel_gps_torch.probes.attrib --device cpu --T 4096
"""
from __future__ import annotations

import math

import torch
from torch import Tensor

from parallel_gps_torch.kalman import strip, timelast
from parallel_gps_torch.kernels import Matern52
from parallel_gps_torch.probes import common, grid
from parallel_gps_torch.types import LGSSMTL

NOISE = 0.1
# Back-to-back calls of the host-clock launch cost.
LAUNCHES_FOR_HOST_CLOCK = 2000


def _step_values(Fs: Tensor, Qs: Tensor, y: Tensor) -> Tensor:
    """A step's value in the kernels' order: F's values, then Q's, then y
    and 1 where y is observed."""
    T = y.shape[0]
    F, Q = Fs.reshape(-1, T), Qs.reshape(-1, T)
    s = F[0]
    for row in list(F[1:]) + list(Q):
        s = s + row
    observed = ~torch.isnan(y)
    s = s + torch.where(observed, y, torch.zeros_like(y))
    return s + observed.to(y.dtype)


def read_plain(Fs: Tensor, Qs: Tensor, y: Tensor, K: int = strip.CHUNK, coalesced: bool = False) -> Tensor:
    """The plain version of both read kernels, summing in the order of the
    one asked for: per block of 128·K steps, each thread's K steps in
    sequence (a chunk of K neighbours, or every 128th step when
    ``coalesced``), then the block's fixed tree."""
    threads = common.CHUNK_THREADS
    T = y.shape[0]
    n_blocks = math.ceil(T / (threads * K))
    v = common.padded(_step_values(Fs, Qs, y), n_blocks * threads * K)
    v = v.reshape(n_blocks, K, threads).transpose(1, 2) if coalesced else v.reshape(n_blocks, threads, K)
    acc = torch.zeros((n_blocks, threads), dtype=y.dtype, device=y.device)
    for i in range(K):
        acc = acc + v[..., i]
    return common.tree_sum(acc)


def read(Fs: Tensor, Qs: Tensor, y: Tensor, K: int = strip.CHUNK, coalesced: bool = False) -> Tensor:
    """Per-block sums of the strip filter's inputs, read in the chunk pattern
    or, with ``coalesced``, coalesced."""
    if y.device.type == "cpu":
        return read_plain(Fs, Qs, y, K, coalesced)
    common.require(Fs.dim() == 3 and Fs.shape == Qs.shape and Fs.shape[2] == y.shape[0] and y.dim() == 1 and K >= 1,
                   f"Fs and Qs must be (d, d, T) and y (T,), got {tuple(Fs.shape)}, {tuple(Qs.shape)}, {tuple(y.shape)}")
    dev, dtype = common.check_operands(Fs=Fs, Qs=Qs, y=y)
    T = y.shape[0]
    parts = torch.empty((math.ceil(T / (common.CHUNK_THREADS * K)),), dtype=dtype, device=dev)
    common.launch(
        "read", int(dtype == torch.float64), int(coalesced), Fs, Qs, y, parts, Fs.shape[0] * Fs.shape[1], T, K, dev,
        counted_as="read_coalesced" if coalesced else "read_chunk",
    )
    return parts


def make_model(T: int, dtype: torch.dtype, dev: torch.device, seed: int):
    """(Fs, Qs, P0, H, R) of Matern52(0.8, 0.4) on T sorted times in [0, 1),
    and y = sin(12 t) + noise with ~10% NaN, made on the device."""
    g = torch.Generator(device=dev).manual_seed(seed)
    t = torch.rand(T, generator=g, dtype=dtype, device=dev).sort().values
    y = torch.sin(12.0 * t) + math.sqrt(NOISE) * torch.randn(T, generator=g, dtype=dtype, device=dev)
    y[torch.rand(T, generator=g, dtype=dtype, device=dev) < 0.1] = float("nan")
    with torch.no_grad():
        R = torch.full((1, 1), NOISE, dtype=dtype, device=dev)
        ssm = Matern52(0.8, 0.4, dtype=dtype, device=dev).get_ssm_tl(t, R)
    return LGSSMTL(*(x.detach().contiguous() for x in ssm)), y


def main(argv=None) -> list[dict]:
    args = common.parser("attrib", __doc__.splitlines()[0], 10_000_000).parse_args(argv)
    dev = common.device_of(args)
    dtype = getattr(torch, args.dtype)
    recs = common.Records("attrib", dev, dtype)
    T, reps, K = args.T, args.reps, strip.CHUNK
    ssm, y = make_model(T, dtype, dev, common.SEED)
    d = ssm.P0.shape[0]
    item = y.element_size()
    n_obs = int((~torch.isnan(y)).sum())
    inputs = (2 * d * d + 1) * T * item
    recs.emit(bench="setup", T=T, d=d, observed=n_obs, input_bytes=inputs)

    with torch.no_grad():
        for name, coalesced in (("read_chunk", False), ("read_coalesced", True)):
            out = read(ssm.Fs, ssm.Qs, y, K, coalesced)
            err = common.max_abs_err(out, read_plain(ssm.Fs, ssm.Qs, y, K, coalesced))
            n_bytes = inputs + out.numel() * item
            ms = common.cuda_ms(lambda c=coalesced: read(ssm.Fs, ssm.Qs, y, K, c), dev, reps)
            recs.emit(
                bench=name, T=T, K=K, bytes=n_bytes, ms=ms,
                plain_ms=common.cuda_ms(lambda c=coalesced: read_plain(ssm.Fs, ssm.Qs, y, K, c), dev, reps),
                library_ms=None, bound_ms=common.bound_ms(n_bytes), **common.rates(n_bytes, ms), max_abs_err=err,
            )

        # The strip filter's passes and the entry points above them.
        args5 = (ssm.Fs, ssm.Qs, ssm.P0, ssm.H, ssm.R, y)
        totals = strip.strip_filter_scan(*args5)
        prefix = strip.exclusive_chunk_prefixes(totals, d, reverse=False)
        rows = strip.filt_rows(d) * strip.n_chunks(T) * item
        moments = (d + d * d) * T * item
        passes = {
            "strip_filter_scan": (lambda: strip.strip_filter_scan(*args5), inputs + rows),
            "strip_filter_apply": (lambda: strip.strip_filter_apply(*args5, prefix), inputs + rows + moments),
            "strip_filter": (lambda: strip.strip_filter(*args5), None),
            "lml_tl_strip": (lambda: timelast.lml_tl(ssm, y, strip=True), None),
            "pkfs_from_tl_strip": (lambda: timelast.pkfs_from_tl(ssm, y, strip=True), None),
        }
        for name, (fn, n_bytes) in passes.items():
            ms = common.cuda_ms(fn, dev, reps)
            bound = common.bound_ms(n_bytes) if n_bytes else None
            recs.emit(bench=name, T=T, d=d, ms=ms, bytes=n_bytes, bound_ms=bound)

        # One launch: an empty kernel, and a PyTorch operation on 8 values —
        # on the device (queued behind the held stream) and on the host
        # (back-to-back calls).
        out = torch.empty((1,), dtype=dtype, device=dev)
        small = torch.zeros((8,), dtype=dtype, device=dev)
        launches = {"empty_kernel": lambda: grid.tile_noop(out), "torch_add": lambda: small.add_(1.0)}
        for name, fn in launches.items():
            ms = common.cuda_ms(fn, dev, 10 * reps)
            recs.emit(
                bench="launch", what=name, device_us=None if ms is None else 1e3 * ms,
                host_us=common.host_us(fn, dev, LAUNCHES_FOR_HOST_CLOCK), calls=LAUNCHES_FOR_HOST_CLOCK,
            )
    recs.write(args.out)
    return recs.items


if __name__ == "__main__":
    main()
