"""What the three probe programs share: the launch counts of the probe
kernels (``csrc/probes.cu``), the plain fixed-order sums their plain versions
take, the command line, the timing and the JSON records.

Counterpart of the ``emit`` and ``med`` of the JAX package's probe scripts
(``scripts/bench_dma_probe.py``, ``bench_r4_attrib.py``,
``bench_grid_isolation.py``), on the port's terms: a record is one JSON line on
stdout, and all of a run's records go to ``--out`` (by default
``build/probes/<probe>.json`` at the root of the checkout); times are
medians of CUDA-event timings after a warm-up, on the card; every record
carries the card's name and power limit as ``nvidia-smi`` prints them.  With
``--device cpu`` the probes run their plain versions at a small size and
time nothing (``"ms": null``): a CPU run says whether the plumbing works, not
how fast the card is.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from pathlib import Path

import torch
from torch import Tensor

# Launches of each probe kernel, counted by its wrapper where it launches.
LAUNCHES = dict.fromkeys(
    (
        "copy_chunk", "copy_coalesced", "copy_blocked", "read_chunk", "read_coalesced",
        "tile_noop", "tile_stream", "tile_outwrite", "tile_carry",
    ),
    0,
)

# Threads per block of the chunk-pattern probes (the two-pass kernels'
# block) and of the coalesced copies and tile probes (csrc/probes.cu:
# kChunkThreads, kTileThreads; tests/test_torch_probes_kernels.py reads them
# there).
CHUNK_THREADS = 128
TILE_THREADS = 256

# Device memory of one H100 SXM (NVIDIA's data sheet): a probe's bound is
# the bytes it must move over this rate.
PEAK_BYTES_PER_S = 3.35e12

OUT_DIR = Path(__file__).resolve().parents[2] / "build" / "probes"

# Seed of every probe's data.
SEED = 0


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def require(ok: bool, what: str) -> None:
    if not ok:
        raise ValueError(f"probe CUDA kernels: {what}")


def check_operands(**tensors: Tensor) -> tuple[torch.device, torch.dtype]:
    """The device and dtype shared by the given tensors, which must be
    contiguous float32 or float64 on one CUDA device."""
    first = next(iter(tensors.values()))
    dev, dtype = first.device, first.dtype
    require(dev.type == "cuda", f"tensors must be on a CUDA device, got {dev}")
    require(dtype in (torch.float32, torch.float64), f"dtype must be float32 or float64, got {dtype}")
    for name, x in tensors.items():
        require(x.device == dev and x.dtype == dtype, f"{name} is {x.dtype} on {x.device}, expected {dtype} on {dev}")
        require(x.is_contiguous(), f"{name} must be contiguous")
    return dev, dtype


def launch(entry: str, *args, counted_as: str | None = None) -> None:
    """Launch a probe kernel through entry ``pgt_probe_<entry>`` and count
    it as ``counted_as`` (default: ``entry``); the last argument is the
    device, whose current stream it runs on."""
    from parallel_gps_torch.kalman import _cuda

    name = counted_as or entry
    _cuda.launch(name, getattr(_cuda.load(), f"pgt_probe_{entry}"), *args)
    LAUNCHES[name] += 1


def tree_sum(acc: Tensor) -> Tensor:
    """Sum over the last axis (a power of two, one value per CUDA thread) in
    the kernels' fixed tree: value j += value j + s for s = n/2, n/4, ..., 1."""
    n = acc.shape[-1]
    while n > 1:
        n //= 2
        acc = acc[..., :n] + acc[..., n : 2 * n]
    return acc[..., 0]


def padded(x: Tensor, length: int) -> Tensor:
    """x (..., T) with zeros appended along the last axis up to ``length``
    (a kernel skips steps past T; adding 0 leaves a sum's bits as they are)."""
    pad = length - x.shape[-1]
    if pad == 0:
        return x
    return torch.cat([x, x.new_zeros(x.shape[:-1] + (pad,))], -1)


def bound_ms(n_bytes: int) -> float:
    """The least time the card could take to move ``n_bytes``."""
    return 1e3 * n_bytes / PEAK_BYTES_PER_S


def rates(n_bytes: int, ms: float | None) -> dict:
    """GB/s and the share of the memory peak, or None where not measured."""
    if ms is None:
        return {"gbps": None, "peak_share": None}
    return {"gbps": n_bytes / ms / 1e6, "peak_share": bound_ms(n_bytes) / ms}


def max_abs_err(a: Tensor, b: Tensor) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def parser(name: str, description: str, default_T: int) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=f"python -m parallel_gps_torch.probes.{name}", description=description)
    p.add_argument("--device", default="cuda", help="cuda (the default; raises without a card) or cpu (plain versions, no times)")
    p.add_argument("--T", type=int, default=default_T, help=f"time steps (default {default_T:,})")
    p.add_argument("--dtype", choices=("float32", "float64"), default="float32")
    p.add_argument("--reps", type=int, default=10, help="timed calls after the warm-up; the median is kept")
    p.add_argument("--out", type=Path, default=OUT_DIR / f"{name}.json", help="where the run's records go (JSON list)")
    return p


def device_of(args) -> torch.device:
    """The run's device: the card unless ``--device cpu``; raises when the
    card is asked for and there is none."""
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: the probes measure the card (pass --device cpu to run their plain versions)")
    return dev


def card_name(dev: torch.device) -> str | None:
    """The card's name and power limit as nvidia-smi prints them, or None on
    the CPU."""
    if dev.type != "cuda":
        return None
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return smi.stdout.strip().splitlines()[dev.index or 0]


class Records:
    """A run's records: each is printed as one JSON line and kept for the
    ``--out`` file; every record carries the probe, device and card."""

    def __init__(self, probe: str, dev: torch.device, dtype: torch.dtype):
        self.base = {"probe": probe, "device": dev.type, "card": card_name(dev), "dtype": str(dtype).split(".")[-1]}
        self.items: list[dict] = []

    def emit(self, **kw) -> dict:
        rec = {**self.base, **kw}
        self.items.append(rec)
        print(json.dumps(rec), flush=True)
        return rec

    def write(self, path: Path) -> None:
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.items, indent=1))


# Cycles the stream is held for before each timed call (about half a
# millisecond on an H100), so that a short call is queued before its start
# event fires and the events time the device, not the host's enqueue.
HOLD_CYCLES = 1_000_000


def cuda_ms(fn, dev: torch.device, reps: int) -> float | None:
    """Median milliseconds of ``reps`` calls of ``fn``, each between CUDA
    events recorded behind a held stream (``HOLD_CYCLES``), after one warm-up
    call; None (not measured) off the card.  A call whose host work outlasts
    the hold is timed with its host gaps, as its caller would see it."""
    if dev.type != "cuda":
        return None
    fn()
    torch.cuda.synchronize(dev)
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HOLD_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_us(fn, dev: torch.device, calls: int) -> float | None:
    """Microseconds of host time per call over ``calls`` back-to-back calls
    of ``fn``, ended by one synchronise (after a warm-up of as many); None
    off the card."""
    if dev.type != "cuda":
        return None
    for _ in range(calls):
        fn()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize(dev)
    return 1e6 * (time.perf_counter() - t0) / calls


def rows(n: int, T: int, dtype: torch.dtype, dev: torch.device, seed: int) -> Tensor:
    """An (n, T) buffer of uniform values in [0, 1), made on its device from
    a seeded generator."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.rand((n, T), generator=g, dtype=dtype, device=dev)
