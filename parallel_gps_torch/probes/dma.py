"""Copy probe: what the two-pass kernels' access pattern costs on the card
(counterpart of scripts/bench_dma_probe.py).

Copies an (n, T) row-major buffer three ways, each a hand-written kernel of
``csrc/probes.cu``:

  - ``chunk``: the two-pass kernels' pattern (kalman/dt.py, kalman/strip.py):
    thread c copies steps [cK, cK + K) of every row, a step at a time, 128
    threads a block — K = 64 is ``kalman/strip.py::CHUNK``, and the sweep
    over K is an argument of this probe only;
  - ``coalesced``: neighbouring threads copy neighbouring 16-byte vectors;
  - ``blocked``: the JAX probe's second layout, (n_tiles, n, tile)
    contiguous, one block a tile;

beside ``dst.copy_(src)``, the one PyTorch call with the same function.
Rows: 27 (the JAX probe's, the d = 3 filter element) and 12 (what
``dt_filter_apply`` stores a step at d = 3: b and C).  Each record: ms, GB/s,
the share of the 3.35 TB/s peak, the bound, the plain version's time and the
largest difference from it.

    python -m parallel_gps_torch.probes.dma            # on the card, T = 10M
    python -m parallel_gps_torch.probes.dma --device cpu --T 4096
"""
from __future__ import annotations

import torch
from torch import Tensor

from parallel_gps_torch.kalman.strip import CHUNK
from parallel_gps_torch.probes import common

ROWS = (27, 12)
CHUNKS = (8, 16, 32, CHUNK)
TILES = (1024, 2048)


def copy_plain(src: Tensor) -> Tensor:
    """The plain version of every copy: the buffer itself, copied."""
    return src.clone()


def copy_chunk(src: Tensor, K: int = CHUNK) -> Tensor:
    """Copy of an (n, T) buffer in the chunk pattern, K steps a thread."""
    if src.device.type == "cpu":
        return copy_plain(src)
    common.require(src.dim() == 2 and K >= 1, f"src must be (n, T) and K >= 1, got {tuple(src.shape)}, K = {K}")
    dev, dtype = common.check_operands(src=src)
    dst = torch.empty_like(src)
    n, T = src.shape
    common.launch("copy_chunk", int(dtype == torch.float64), src, dst, n, T, K, dev)
    return dst


def _check_vectors(src: Tensor) -> tuple[torch.device, torch.dtype]:
    """The copies that load 16-byte vectors need a 16-byte aligned source
    (``torch.empty_like`` aligns the destination)."""
    dev, dtype = common.check_operands(src=src)
    common.require(src.data_ptr() % 16 == 0, "src must be 16-byte aligned")
    return dev, dtype


def copy_coalesced(src: Tensor) -> Tensor:
    """Copy of a contiguous buffer, neighbouring threads on neighbouring
    16-byte vectors."""
    if src.device.type == "cpu":
        return copy_plain(src)
    dev, dtype = _check_vectors(src)
    dst = torch.empty_like(src)
    common.launch("copy_coalesced", int(dtype == torch.float64), src, dst, src.numel(), dev)
    return dst


def copy_blocked(src: Tensor) -> Tensor:
    """Copy of an (n_tiles, n, tile) buffer, one block a contiguous tile."""
    if src.device.type == "cpu":
        return copy_plain(src)
    common.require(src.dim() == 3 and src.shape[1] * src.shape[2] % 4 == 0, f"src must be (n_tiles, n, tile) with n * tile a multiple of 4, got {tuple(src.shape)}")
    dev, dtype = _check_vectors(src)
    dst = torch.empty_like(src)
    common.launch("copy_blocked", int(dtype == torch.float64), src, dst, src.shape[0], src.shape[1] * src.shape[2], dev)
    return dst


def record(recs: common.Records, bench: str, fn, src: Tensor, dev, reps: int, **shape) -> dict:
    """Check one copy against its plain version and time it, the plain
    version and ``dst.copy_(src)`` on the same buffer."""
    err = common.max_abs_err(fn(src), copy_plain(src))
    n_bytes = 2 * src.numel() * src.element_size()
    ms = common.cuda_ms(lambda: fn(src), dev, reps)
    plain_ms = common.cuda_ms(lambda: copy_plain(src), dev, reps)
    dst = torch.empty_like(src)
    library_ms = common.cuda_ms(lambda: dst.copy_(src), dev, reps)
    del dst
    return recs.emit(
        bench=bench, **shape, bytes=n_bytes, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        bound_ms=common.bound_ms(n_bytes), **common.rates(n_bytes, ms), max_abs_err=err,
    )


def main(argv=None) -> list[dict]:
    args = common.parser("dma", __doc__.splitlines()[0], 10_000_000).parse_args(argv)
    dev = common.device_of(args)
    dtype = getattr(torch, args.dtype)
    recs = common.Records("dma", dev, dtype)
    T = args.T
    for i, n in enumerate(ROWS):
        src = common.rows(n, T, dtype, dev, common.SEED + i)
        for K in CHUNKS:
            record(recs, "copy_chunk", lambda x, K=K: copy_chunk(x, K), src, dev, args.reps, rows=n, T=T, K=K)
        record(recs, "copy_coalesced", copy_coalesced, src, dev, args.reps, rows=n, T=T)
        for tile in TILES:
            n_tiles = -(-T // tile)
            blocked = common.rows(n_tiles * n * tile, 1, dtype, dev, common.SEED + i).reshape(n_tiles, n, tile)
            record(recs, "copy_blocked", copy_blocked, blocked, dev, args.reps, rows=n, T=T, tile=tile, n_tiles=n_tiles)
            del blocked
        del src
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    recs.write(args.out)
    return recs.items


if __name__ == "__main__":
    main()
