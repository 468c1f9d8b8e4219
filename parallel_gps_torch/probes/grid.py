"""Tile-cost probe: what a block costs on the card against the length of the
tile it works on (counterpart of scripts/bench_grid_isolation.py).

Over T steps of float32 rows and tile ∈ {256, ..., 4096} steps a block,
hand-written kernels of ``csrc/probes.cu``:

  - ``noop``: each block writes one value (1);
  - ``stream3`` / ``stream22``: each block reads its tile of 3 or 22 rows
    coalesced and writes their sum;
  - ``outwrite12``: reads 3 rows, writes row 0 to 12 output rows and the
    tile's sum of the 3 rows;
  - ``carry33``: a carry across tiles.  Blocks run in no order on the card,
    so one block walks the tiles in order (as the batched kernels walk a
    series): it reads each tile, adds k to value k of a 33-value carry in
    shared memory behind a barrier, and writes the tile's sum plus carry
    value 32; the carry ends at k · n_tiles.

Each record: ms, µs per tile (ms ÷ tiles), the bound, the plain version's
time and, where one PyTorch call computes the same function, its time
(``out.fill_(1)``; ``x.view(r, n_tiles, tile).sum((0, 2))``); then, per
kernel, the slope of ms against the tile count.  The default T, 10,027,008,
is the JAX probe's lane count (8 strips of 1,253,376, aligned to every tile
of the sweep), so each tile divides it.

    python -m parallel_gps_torch.probes.grid            # on the card
    python -m parallel_gps_torch.probes.grid --device cpu --T 4096
"""
from __future__ import annotations

import math

import torch
from torch import Tensor

from parallel_gps_torch.probes import common

TILES = (256, 512, 1024, 2048, 4096)
CARRY = 33
OUT_ROWS = 12
T_DEFAULT = 8 * 1_253_376


def n_tiles(T: int, tile: int) -> int:
    return math.ceil(T / tile)


def _check_tile(x: Tensor, tile: int) -> tuple[torch.device, torch.dtype]:
    common.require(tile >= common.TILE_THREADS and tile % common.TILE_THREADS == 0,
                   f"tile must be a multiple of {common.TILE_THREADS}, got {tile}")
    return common.check_operands(x=x)


def _flag(dtype) -> int:
    return int(dtype == torch.float64)


# --------------------------------------------------------------------------
# Plain versions
# --------------------------------------------------------------------------


def stream_plain(x: Tensor, tile: int) -> Tensor:
    """Per-tile sums of the (r, T) rows in the kernels' order: thread j sums
    steps j, j + 256, ... of the tile, each step's rows in order, then the
    block's fixed tree."""
    r, T = x.shape
    threads, n = common.TILE_THREADS, n_tiles(T, tile)
    X = common.padded(x, n * tile).reshape(r, n, tile // threads, threads)
    acc = torch.zeros((n, threads), dtype=x.dtype, device=x.device)
    for i in range(tile // threads):
        for k in range(r):
            acc = acc + X[k, :, i]
    return common.tree_sum(acc)


def outwrite_plain(x: Tensor, tile: int) -> tuple[Tensor, Tensor]:
    """Row 0 of the (3, T) rows twelve times, and their per-tile sums."""
    return x[0].expand(OUT_ROWS, x.shape[1]).clone(), stream_plain(x, tile)


def carry_plain(x: Tensor, tile: int) -> tuple[Tensor, Tensor]:
    """Per tile b of the (T,) row: its sum plus 32·(b + 1); and the final
    carry, k · n_tiles for k < 33."""
    n = n_tiles(x.shape[0], tile)
    out = stream_plain(x[None], tile) + 32 * torch.arange(1, n + 1, dtype=x.dtype, device=x.device)
    return out, torch.arange(CARRY, dtype=x.dtype, device=x.device) * n


# --------------------------------------------------------------------------
# Kernel wrappers: the CUDA kernel for CUDA tensors, the plain version on the CPU
# --------------------------------------------------------------------------


def tile_noop(out: Tensor) -> Tensor:
    """One block a value of ``out``, each writing 1 into it."""
    if out.device.type == "cpu":
        return out.fill_(1)
    dev, dtype = common.check_operands(out=out)
    common.launch("tile_noop", _flag(dtype), out, out.numel(), dev)
    return out


def tile_stream(x: Tensor, tile: int) -> Tensor:
    """Per-tile sums of the (r, T) rows."""
    if x.device.type == "cpu":
        return stream_plain(x, tile)
    common.require(x.dim() == 2, f"x must be (r, T), got {tuple(x.shape)}")
    dev, dtype = _check_tile(x, tile)
    r, T = x.shape
    parts = torch.empty((n_tiles(T, tile),), dtype=dtype, device=dev)
    common.launch("tile_stream", _flag(dtype), x, parts, r, T, tile, dev)
    return parts


def tile_outwrite(x: Tensor, tile: int) -> tuple[Tensor, Tensor]:
    """Row 0 of the (3, T) rows written twelve times, and their per-tile sums."""
    if x.device.type == "cpu":
        return outwrite_plain(x, tile)
    common.require(x.dim() == 2 and x.shape[0] == 3, f"x must be (3, T), got {tuple(x.shape)}")
    dev, dtype = _check_tile(x, tile)
    T = x.shape[1]
    out12 = torch.empty((OUT_ROWS, T), dtype=dtype, device=dev)
    parts = torch.empty((n_tiles(T, tile),), dtype=dtype, device=dev)
    common.launch("tile_outwrite", _flag(dtype), x, out12, parts, T, tile, dev)
    return out12, parts


def tile_carry(x: Tensor, tile: int) -> tuple[Tensor, Tensor]:
    """One block walking the tiles of the (T,) row in order with a carry."""
    if x.device.type == "cpu":
        return carry_plain(x, tile)
    common.require(x.dim() == 1, f"x must be (T,), got {tuple(x.shape)}")
    dev, dtype = _check_tile(x, tile)
    T = x.shape[0]
    out = torch.empty((n_tiles(T, tile),), dtype=dtype, device=dev)
    carry = torch.empty((CARRY,), dtype=dtype, device=dev)
    common.launch("tile_carry", _flag(dtype), x, out, carry, T, tile, dev)
    return out, carry


# --------------------------------------------------------------------------
# The sweep
# --------------------------------------------------------------------------


def _library_sum(x: Tensor, tile: int):
    """``x.view(r, n_tiles, tile).sum((0, 2))`` where the tile divides T."""
    r, T = x.shape
    if T % tile:
        return None
    return lambda: x.view(r, T // tile, tile).sum((0, 2))


def _flat(out) -> Tensor:
    return torch.cat([o.reshape(-1) for o in out]) if isinstance(out, tuple) else out


def main(argv=None) -> list[dict]:
    args = common.parser("grid", __doc__.splitlines()[0], T_DEFAULT).parse_args(argv)
    dev = common.device_of(args)
    dtype = getattr(torch, args.dtype)
    recs = common.Records("grid", dev, dtype)
    T, item = args.T, torch.empty((), dtype=dtype).element_size()
    x3 = common.rows(3, T, dtype, dev, common.SEED)
    x22 = common.rows(22, T, dtype, dev, common.SEED + 1)
    fits: dict[str, list] = {}
    for tile in TILES:
        n = n_tiles(T, tile)
        ones = torch.empty((n,), dtype=dtype, device=dev)
        benches = {
            # name: (kernel, plain version, one PyTorch call or None, bytes moved)
            "noop": (lambda: tile_noop(ones), lambda: torch.ones_like(ones), lambda: ones.fill_(1), n),
            "stream3": (lambda: tile_stream(x3, tile), lambda: stream_plain(x3, tile), _library_sum(x3, tile), 3 * T + n),
            "stream22": (lambda: tile_stream(x22, tile), lambda: stream_plain(x22, tile), _library_sum(x22, tile), 22 * T + n),
            "outwrite12": (lambda: tile_outwrite(x3, tile), lambda: outwrite_plain(x3, tile), None, (3 + OUT_ROWS) * T + n),
            "carry33": (lambda: tile_carry(x3[0], tile), lambda: carry_plain(x3[0], tile), None, T + n + CARRY),
        }
        for name, (kern, plain, library, values) in benches.items():
            err = common.max_abs_err(_flat(kern()), _flat(plain()))
            ms = common.cuda_ms(kern, dev, args.reps)
            n_bytes = values * item
            recs.emit(
                bench=name, tile=tile, n_tiles=n, T=T, bytes=n_bytes, ms=ms,
                us_per_tile=None if ms is None else 1e3 * ms / n,
                plain_ms=common.cuda_ms(plain, dev, max(1, args.reps // 3)),
                library_ms=common.cuda_ms(library, dev, args.reps) if library else None,
                bound_ms=common.bound_ms(n_bytes), **common.rates(n_bytes, ms), max_abs_err=err,
            )
            fits.setdefault(name, []).append((n, ms))
    # µs per tile as the slope of ms against the tile count (least squares).
    for name, pts in fits.items():
        slope = intercept = None
        if len(pts) > 1 and all(ms is not None for _, ms in pts):
            xm = sum(n for n, _ in pts) / len(pts)
            ym = sum(ms for _, ms in pts) / len(pts)
            slope_ms = sum((n - xm) * (ms - ym) for n, ms in pts) / sum((n - xm) ** 2 for n, _ in pts)
            slope, intercept = 1e3 * slope_ms, ym - slope_ms * xm
        recs.emit(bench="slope", of=name, us_per_tile=slope, intercept_ms=intercept, tiles=[n for n, _ in pts])
    recs.write(args.out)
    return recs.items


if __name__ == "__main__":
    main()
