#!/usr/bin/env python3
"""Smoke test of the PyTorch port (parallel_gps_torch) on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each failing the run (non-zero exit, no result line) on error:

  1. device: the card's name and power limit (nvidia-smi); a CUDA device is
     required;
  2. build: compile every CUDA kernel from parallel_gps_torch/csrc; each
     strip pass-2 unit's stage and each filter and smoother pass-1 unit's
     (strip and dt) held against kalman/strip.py's and kalman/dt.py's
     mirrors;
  3. kernels vs plain: for Matern12/32/52 at T = 65,537 with ~10% missing
     observations, the CUDA filter, smoother and Fisher tail of the dt-engine
     against their plain PyTorch versions, float64 to the JAX interpret-test
     tolerances, float32 against float64 truth; the filter and the smoother
     again at the lengths where their staged pass 2 has ragged warps, rounds
     and blocks (APPLY_EDGE_T); then the four
     plane-streaming strip kernels the same way at d = 1, 2, 3 (Matérn
     planes) and d = 4, 6, 8 (RBF planes), and at d = 3 the strip engine
     against the dt-engine on the same data; both strip pass-2 kernels at
     every d = 1..8, float64 and float32, at the lengths where their staging
     has ragged edges (strip_edge_lengths); then every spectral dt unit (RBF's
     transition family, d = 1..8, float64 and float32: filter, smoother and
     Fisher tail) against its plain version at T = 65,537, and its staged
     pass 2 at its ragged lengths; every composite dt unit (Periodic, Sum
     and Product, d = 2..8, COMPOSITE_CASES) the same way, two launches bit
     for bit (check_composite_kernels); the filter's and the smoother's pass 1
     alone, every strip and dt unit, float64 and float32, at the lengths
     where their stages have ragged edges (check_scan_edges); and the
     exponential polynomial's dt
     units bit for bit against the tree before the spectral family
     (PARENT_DT_DIGESTS, dt_outputs);
  4. the serving path at full size: StateSpaceGP(Matern52(0.8, 0.4), noise
     0.1), N = 10,000,000 float32 observations — one LML and three
     predict_f requests of 1,000 unsorted queries — with the launch counts
     that path requires (a plane scan for the chunk prefix between the two
     passes of each filter and smoother) and no plain prefix; the same in
     float64; and at N = 262,144 float64 the model against its plain
     versions;
  5. the training path on the same data: one LML + backward on that model,
     then five Adam steps and two L-BFGS steps from other hyperparameters,
     with the launch counts of a training step and no plain prefix;
     the float32 gradient beside the float64 one and the plain float32 one;
     and at N = 262,144 float64 the gradient through the kernels against
     the plain path on the card and the same model on the CPU;
  6. times (CUDA events, medians): each kernel against its plain version
     and its bound at N = 10M float32, the LML, one predict_f request and
     one training step;
  7. profile (torch.profiler): device time by kernel and the device's idle
     share for one LML, one predict_f request and one training step; then
     the chunk prefix (strip.exclusive_chunk_prefixes: plane_scan over the
     packed totals and a one-column shift) against its plain Kogge–Stone
     version on the dt kernels' totals at the main path's shapes (Matern52
     N = 10M: 156,250 chunks at d = 3; RBF(order=6) N = 1M: 15,625 at
     d = 6), float64 and float32, both kinds, and at every d = 1..8 at 1 and
     2 chunks and the plane scan's tile edges (phase_prefix), with its time
     beside the plain prefix's and its bound;
  8. the RBF(order=6) model at N = 1,000,000 on the dt engine (the spectral
     kernels) the same way (phases 4–7), with every spectral unit d = 1..8
     timed at that length, and the model's LML, predict_f and training step
     on the dt route beside the same entry points on the strip route (the
     Kalman API on the model's planes) at orders 4..8; then the
     quasi-periodic model (QP_SPEC: Periodic(order=1) × Matern32, d = 8) at
     N = 1,000,000 on the dt engine (the composite kernels): LML, predict_f
     and a training step with their launch counts, against float64 truth
     by the 10× rule beside the plain float32 path, and at T = 65,537
     float64 against the plain path and the CPU (phase_qp_slice); each
     composite kernel against its plain version and its bound, every
     composite unit d = 2..8 timed at that length (phase_qp_times), and a
     profile of the three entry points; then the strip path:
     the RBF(order=6) model's planes through the Kalman API and
     pkfs(engine="strip") on an explicit model at N = 10M;
  9. the batched path: the two single-pass batched kernels and the Fisher
     tail with a batch axis against their plain versions (B = 5 and 64 series
     of T = 65,537, d = 1, 2, 3, 6 and 8; stride-0 shared operands; B = 1 bit
     for bit the single-series Fisher tail); both kernels, the smoother with
     and without its projection, at every d = 1..8, float64 and float32, at
     the lengths where their tiles have ragged edges, with B = 3, 1 and 133,
     two launches bit for bit (check_batched_edges); a wait between tiles
     that may not poll raising (check_batched_overrun); then Matern52 with 64 chains over
     T = 65,536 float32 observations — one batched log posterior and gradient
     with exactly the launches that takes and no plain prefix, HMC, MALA, NUTS
     and the dual-averaging warm-up through the normal entry points, each
     chain against the single-series engine — with times, the same LMLs as a
     loop of single-series calls, and a profile;
 10. the probe programs (parallel_gps_torch/probes, kernels in
     csrc/probes.cu): each probe kernel against its plain version at
     T = 65,537 in float32 and float64, bit for bit; then the three command
     lines at full size — the copy in the two-pass kernels' chunk pattern,
     coalesced and blocked; the read floor of a strip-filter pass beside the
     passes and the cost of one launch; the cost of a block against its tile
     length — with the probe kernels' launches counted, one JSON line a
     measurement;
 11. the time-first fused path, pkf / pks / pkfs on an LGSSM with
     engine="strip" (kalman/plane.py, kernels in csrc/plane_scan.cu): the
     plane scan against its plain version at T = 65,537 (filter and smoother
     rows of d = 1, 2, 3 Matérn and d = 4, 6, 8 RBF models, float64 to the
     JAX interpret-test tolerances, float32 against float64 truth); at every
     state dimension d = 1..8, both
     kinds, both directions, float64 and float32, at the lengths where its
     tiles have ragged edges — T = 1, and one tile, where the look-back does
     nothing and block_scan (the port of _local_scan_kernel) works alone —
     and where a look-back can reach past a window of 32 predecessors
     (plane_edge_lengths); and its look-back's bounded spin raising; the
     plane transpose bit for bit against
     x.t().contiguous() at every width and length where its blocks change
     shape, aligned or not (TRANSPOSE_WIDTHS); then the path on configuration (i)'s data at
     N = 10M float32 with the launch counts it requires and no plain
     version, against pkfs(LGSSMTL, "strip") and float64 truth, and at
     N = 262,144 float64 against engine="timelast"; times of both kernels
     (the transpose in its three moves of the path, on the device behind a
     held stream) against bound, plain version and x.t().contiguous(), and of pkfs
     beside pkfs(LGSSMTL, "strip") and pkfs_dt.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.

``entry_timers(label)`` times the entry points alone — the chunk prefix, the
Matern52 LML, predict_f, training step and time-last pkfs, the RBF(order=6)
LML, predict_f and training step, and the quasi-periodic model's — as
events, wall, device time and the device's idle share.  ``ab_timers(label)`` runs those and this script's
other timers alone: the dt applies, plane_scan, the time-first pkfs, the
strip applies at every unit, the filter's and the smoother's
pass-1 kernels at every unit (``scan_timers(label)``, which also runs alone,
``scan_timers(label, passes=("filter",))`` the filter's alone) and the
batched kernels on the batched path and at every unit, with the batched
value and gradient and an HMC step (``batched_timers(label)``, which also
runs alone), so that two trees can be compared in one call (each with this
file copied to its root):

    python3 -c "import chip_smoke as c; c.ab_timers('parent')"

``strip_apply_outputs(out_dir)`` saves both strip pass-2 kernels' moments and
both pass-1 kernels' totals at every unit, ``spectral_outputs(out_dir)`` the
spectral dt units' the same way, and ``compare_strip_apply_outputs(dir_a,
dir_b)`` compares two trees' bit for bit.
"""
from __future__ import annotations

import hashlib
import inspect
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from parallel_gps_torch import StateSpaceGP  # noqa: E402
from parallel_gps_torch.inference import (  # noqa: E402
    dual_averaging_warmup,
    find_reasonable_step_size,
    fit_adam,
    fit_lbfgs,
    make_kernel,
    make_log_posterior,
    mcmc,
    ravel_positions,
    sample_chains,
)
from parallel_gps_torch.kalman import _cuda  # noqa: E402
from parallel_gps_torch.kalman import batched, dt, plane, strip, timelast  # noqa: E402
from parallel_gps_torch.kalman.parallel import pkf, pkfs, pks  # noqa: E402
from parallel_gps_torch.models.ssgp import merge_sorted  # noqa: E402
from parallel_gps_torch.kernels import RBF, Matern12, Matern32, Matern52, Periodic  # noqa: E402
from parallel_gps_torch.kernels.composite import COMPOSITE  # noqa: E402
from parallel_gps_torch.kernels.matern import EXPPOLY  # noqa: E402
from parallel_gps_torch.kernels.rbf import SPECTRAL  # noqa: E402
from parallel_gps_torch.probes import attrib as probe_attrib  # noqa: E402
from parallel_gps_torch.probes import common as probe_common  # noqa: E402
from parallel_gps_torch.probes import dma as probe_dma  # noqa: E402
from parallel_gps_torch.probes import grid as probe_grid  # noqa: E402
from parallel_gps_torch.types import LGSSM, LGSSMTL  # noqa: E402

N_FULL = 10_000_000
N_STRIP = 1_000_000  # the strip path's model: RBF(order=6), d = 6
N_CHECK = 262_144
T_KERNEL = 65_537  # a multiple of no chunk size
NOISE = 0.1
SEED = 0
DEV = "cuda"

SOURCES = {
    "dt_filter_scan": "parallel_gps_torch/csrc/dt_scan.cu",
    "dt_filter_apply": "parallel_gps_torch/csrc/dt_scan.cu",
    "dt_smoother_scan": "parallel_gps_torch/csrc/dt_scan.cu",
    "dt_smoother_apply": "parallel_gps_torch/csrc/dt_scan.cu",
    "dt_fisher": "parallel_gps_torch/csrc/dt_fisher.cu",
    "dt_filter_scan_spectral": "parallel_gps_torch/csrc/dt_scan.cu",
    "dt_filter_apply_spectral": "parallel_gps_torch/csrc/dt_scan.cu",
    "dt_smoother_scan_spectral": "parallel_gps_torch/csrc/dt_scan.cu",
    "dt_smoother_apply_spectral": "parallel_gps_torch/csrc/dt_scan.cu",
    "dt_fisher_spectral": "parallel_gps_torch/csrc/dt_fisher.cu",
    "dt_filter_scan_composite": "parallel_gps_torch/csrc/dt_scan.cu",
    "dt_filter_apply_composite": "parallel_gps_torch/csrc/dt_scan.cu",
    "dt_smoother_scan_composite": "parallel_gps_torch/csrc/dt_scan.cu",
    "dt_smoother_apply_composite": "parallel_gps_torch/csrc/dt_scan.cu",
    "dt_fisher_composite": "parallel_gps_torch/csrc/dt_fisher.cu",
    "strip_filter_scan": "parallel_gps_torch/csrc/strip_scan.cu",
    "strip_filter_apply": "parallel_gps_torch/csrc/strip_scan.cu",
    "strip_smoother_scan": "parallel_gps_torch/csrc/strip_scan.cu",
    "strip_smoother_apply": "parallel_gps_torch/csrc/strip_scan.cu",
    "batched_filter": "parallel_gps_torch/csrc/batched_scan.cu",
    "batched_smoother": "parallel_gps_torch/csrc/batched_scan.cu",
    **{f"probe_{name}": "parallel_gps_torch/csrc/probes.cu" for name in probe_common.LAUNCHES},
    "plane_scan": "parallel_gps_torch/csrc/plane_scan.cu",
    "plane_transpose": "parallel_gps_torch/csrc/plane_scan.cu",
}
# The dt kernels of the exponential polynomial (the Matérn kernels), of the
# spectral family (RBF) and of the composite family (Periodic, Sum,
# Product): one wrapper each, a kernel a family.
DT_KERNELS = tuple(k for k in SOURCES if k.startswith("dt_") and not k.endswith(("_spectral", "_composite")))
SPECTRAL_KERNELS = tuple(f"{k}_spectral" for k in DT_KERNELS)
COMPOSITE_KERNELS = tuple(f"{k}_composite" for k in DT_KERNELS)
# Every dt kernel of another family than the path's: none launched.
NOT_SPECTRAL = dict.fromkeys(DT_KERNELS + COMPOSITE_KERNELS, 0)
STRIP_KERNELS = tuple(k for k in SOURCES if k.startswith("strip_"))
PLANE_KERNELS = ("plane_scan", "plane_transpose")
REPLACES = {
    "dt_filter_scan": "parallel_gps_tpu/kalman/pallas_dt.py:179",
    "dt_filter_apply": "parallel_gps_tpu/kalman/pallas_dt.py:208",
    "dt_smoother_scan": "parallel_gps_tpu/kalman/pallas_dt.py:553",
    "dt_smoother_apply": "parallel_gps_tpu/kalman/pallas_dt.py:589",
    "dt_fisher": "parallel_gps_tpu/kalman/pallas_dt.py:839",
    # The same five TPU kernels with RBF's spectral build closure
    # (parallel_gps_tpu/kernels/rbf.py:267) traced into them.
    "dt_filter_scan_spectral": "parallel_gps_tpu/kalman/pallas_dt.py:179",
    "dt_filter_apply_spectral": "parallel_gps_tpu/kalman/pallas_dt.py:208",
    "dt_smoother_scan_spectral": "parallel_gps_tpu/kalman/pallas_dt.py:553",
    "dt_smoother_apply_spectral": "parallel_gps_tpu/kalman/pallas_dt.py:589",
    "dt_fisher_spectral": "parallel_gps_tpu/kalman/pallas_dt.py:839",
    # The same five with a composite's build traced into them: Periodic's
    # rotation planes (parallel_gps_tpu/kernels/periodic.py:140), a Sum's
    # block diagonal (kernels/base.py:242) or a Product's Kronecker fold
    # (kernels/base.py:420).
    "dt_filter_scan_composite": "parallel_gps_tpu/kalman/pallas_dt.py:179",
    "dt_filter_apply_composite": "parallel_gps_tpu/kalman/pallas_dt.py:208",
    "dt_smoother_scan_composite": "parallel_gps_tpu/kalman/pallas_dt.py:553",
    "dt_smoother_apply_composite": "parallel_gps_tpu/kalman/pallas_dt.py:589",
    "dt_fisher_composite": "parallel_gps_tpu/kalman/pallas_dt.py:839",
    "strip_filter_scan": "parallel_gps_tpu/kalman/pallas_scan.py:766",
    "strip_filter_apply": "parallel_gps_tpu/kalman/pallas_scan.py:798",
    "strip_smoother_scan": "parallel_gps_tpu/kalman/pallas_scan.py:1795",
    "strip_smoother_apply": "parallel_gps_tpu/kalman/pallas_scan.py:1840",
    "batched_filter": "parallel_gps_tpu/kalman/pallas_scan.py:1271",
    "batched_smoother": "parallel_gps_tpu/kalman/pallas_scan.py:1385",
    # The probe programs' Pallas kernels: the copy's body (:56) behind its
    # strided (:69) and blocked (:93) calls; read_kernel; the kernels passed
    # to run (:76).
    "probe_copy_chunk": "scripts/bench_dma_probe.py:69",
    "probe_copy_coalesced": "scripts/bench_dma_probe.py:56",
    "probe_copy_blocked": "scripts/bench_dma_probe.py:93",
    "probe_read_chunk": "scripts/bench_r4_attrib.py:98",
    "probe_read_coalesced": "scripts/bench_r4_attrib.py:98",
    "probe_tile_noop": "scripts/bench_grid_isolation.py:102",
    "probe_tile_stream": "scripts/bench_grid_isolation.py:105",
    "probe_tile_carry": "scripts/bench_grid_isolation.py:109",
    "probe_tile_outwrite": "scripts/bench_grid_isolation.py:123",
    # _carry_scan_kernel; its in-block body _local_scan_kernel (:410, no
    # pallas_call) is the scan's block_scan (PLANE_BODY, on its record).
    "plane_scan": "parallel_gps_tpu/kalman/pallas_scan.py:428",
    "plane_transpose": "parallel_gps_tpu/kalman/pallas_scan.py:531",
}
PLANE_BODY = "parallel_gps_tpu/kalman/pallas_scan.py:410"
# Launches the serving path makes: the filter passes for the LML, and all
# four passes for each predict_f request; and between the two passes of a
# filter or a smoother, one plane scan for the chunk prefix
# (strip.exclusive_chunk_prefixes).
N_REQUESTS = 3
EXPECTED_LAUNCHES = {
    "dt_filter_scan": 1 + N_REQUESTS,
    "dt_filter_apply": 1 + N_REQUESTS,
    "dt_smoother_scan": N_REQUESTS,
    "dt_smoother_apply": N_REQUESTS,
    "dt_fisher": 0,
    **dict.fromkeys(SPECTRAL_KERNELS + COMPOSITE_KERNELS, 0),
    "plane_scan": 1 + 2 * N_REQUESTS,
}
LML_LAUNCHES = {
    **dict.fromkeys(DT_KERNELS + SPECTRAL_KERNELS + COMPOSITE_KERNELS, 0), "dt_filter_scan": 1, "dt_filter_apply": 1, "plane_scan": 1,
}
# One training step (LML + backward) launches each of the five kernels once,
# and a plane scan for each of its two prefixes.
STEP_LAUNCHES = {**dict.fromkeys(DT_KERNELS, 1), **dict.fromkeys(SPECTRAL_KERNELS + COMPOSITE_KERNELS, 0), "plane_scan": 2}
# The RBF model on the dt engine (its spectral family): an LML is the filter;
# a predict_f request the filter and the smoother; a training step all five.
RBF_MODEL = dict(kernel="RBF", variance=0.8, lengthscales=0.05, noise_variance=NOISE, order=6)
RBF_LML_LAUNCHES = {
    **NOT_SPECTRAL, **dict.fromkeys(SPECTRAL_KERNELS, 0), "dt_filter_scan_spectral": 1, "dt_filter_apply_spectral": 1, "plane_scan": 1,
}
RBF_PREDICT_LAUNCHES = {**NOT_SPECTRAL, **dict.fromkeys(SPECTRAL_KERNELS, 1), "dt_fisher_spectral": 0, "plane_scan": 2}
RBF_STEP_LAUNCHES = {**NOT_SPECTRAL, **dict.fromkeys(SPECTRAL_KERNELS, 1), "plane_scan": 2}
# The quasi-periodic model on the dt engine (the composite family): the
# covariance of experiments/common.py:104-112 (--cov QP) at --qp-order 1,
# Periodic(1, 1, period=1, order=1) × Matern32(1, 1), d = 4 × 2 = 8 — the
# largest state the dt kernels take — at N = 1M.  Its LML is the filter, a
# predict_f request the filter and the smoother, a training step all five.
N_QP = 1_000_000
QP_SPEC = ("Product", [
    ("Periodic", {"variance": 1.0, "lengthscales": 1.0, "period": 1.0, "order": 1}),
    ("Matern32", {"variance": 1.0, "lengthscales": 1.0}),
])
NOT_COMPOSITE = dict.fromkeys(DT_KERNELS + SPECTRAL_KERNELS, 0)
QP_LML_LAUNCHES = {
    **NOT_COMPOSITE, **dict.fromkeys(COMPOSITE_KERNELS, 0), "dt_filter_scan_composite": 1, "dt_filter_apply_composite": 1,
    "plane_scan": 1,
}
QP_PREDICT_LAUNCHES = {**NOT_COMPOSITE, **dict.fromkeys(COMPOSITE_KERNELS, 1), "dt_fisher_composite": 0, "plane_scan": 2}
QP_STEP_LAUNCHES = {**NOT_COMPOSITE, **dict.fromkeys(COMPOSITE_KERNELS, 1), "plane_scan": 2}
# The strip path on the same model's planes, through the Kalman API: an LML
# is the strip filter; a predict_f request and a training step (strip filter
# forward, strip smoother backward) are all four.
STRIP_LML_LAUNCHES = {"strip_filter_scan": 1, "strip_filter_apply": 1, "strip_smoother_scan": 0, "strip_smoother_apply": 0, "plane_scan": 1}
STRIP_ALL_LAUNCHES = {**dict.fromkeys(STRIP_KERNELS, 1), "plane_scan": 2}
STRIP_PASSES = dict.fromkeys(STRIP_KERNELS, 1)  # strip.LAUNCHES after a filter and a smoother
N_ADAM = 5
N_LBFGS = 2
# The optimisers start away from the serving model's hyperparameters (0.8,
# 0.4, noise 0.1), which generated the data's noise: there the loss of 10M
# points is within one float32 step of its minimum and cannot be seen to fall.
TRAIN_START = (1.0, 0.3, 0.2)

# Peaks of one H100 SXM (NVIDIA's data sheet): device memory 3.35 TB/s,
# float32 outside the tensor cores 67 TFLOP/s, float64 34 TFLOP/s.  A
# kernel's bound is the larger of its bytes over the first and its
# operations over the peak of its scalar type.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_F64_FLOPS = 34e12  # float64 outside the tensor cores

# float32 checks: the kernel's float32 result must be as close to float64
# truth as the plain float32 engine's, within F32_FACTOR (the two fold the
# same elements in different orders, so their rounding differs but not its
# scale), or within F32_FLOOR relative to the quantity's magnitude.
F32_FACTOR = 10.0
F32_FLOOR = 1e-5


def f32_sum_floor(T: int) -> float:
    """The floor for a quantity that is a sum over T float32 terms (the
    Fisher tail's d_coeffs, d_P0, d_H, d_R, and the gradients made of them):
    in any summation order the terms' own rounding leaves noise of about
    √T·ε times their magnitude, and the terms largely cancel, so relative to
    the sum the floor is F32_FACTOR·√T·ε (ε = 2⁻²⁴)."""
    return F32_FACTOR * (T**0.5) * 2.0**-24


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def allclose(a, b, rtol, atol) -> bool:
    a, b = a.double(), b.to(a.device).double()
    return bool(((a - b).abs() <= atol + rtol * b.abs()).all())


def max_abs(a, b) -> float:
    return float((a.double() - b.to(a.device).double()).abs().max())


def rel_err(a, truth) -> float:
    """max |a − truth| / max |truth|."""
    return max_abs(a, truth) / max(float(truth.double().abs().max()), 1e-300)


def make_data(T: int, seed: int):
    """Sorted times in [0, 1), y = sin(12 t) + noise, ~10% NaN."""
    rng = np.random.RandomState(seed)
    t = np.sort(rng.rand(T))
    y = np.sin(12.0 * t) + np.sqrt(NOISE) * rng.randn(T)
    y[rng.rand(T) < 0.1] = np.nan
    return t, y


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of ``reps`` calls, each between CUDA events, after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def engine_inputs(kernel_cls, params, t, y, dtype):
    """(family, coeffs, P0, H, R, dts, y) on the card, no autograd."""
    return kernel_inputs(kernel_cls(*params, dtype=dtype, device=DEV), t, y, dtype)


def kernel_inputs(k, t, y, dtype):
    """``engine_inputs`` of the kernel ``k``."""
    with torch.no_grad():
        family, coeffs = k.transition_coeffs()
        sde = k.get_sde()
        dts = dt._dts_from_ts(torch.as_tensor(t, dtype=dtype, device=DEV))
        yt = torch.as_tensor(y, dtype=dtype, device=DEV)
        R = torch.full((1, 1), NOISE, dtype=dtype, device=DEV)
    return family, coeffs.detach(), sde.P0.detach(), sde.H.detach(), R, dts, yt


def hyper_params(model):
    """The unconstrained hyperparameters: (variance, lengthscale, noise) of a
    Matérn or RBF model; a composite's kernel parameters in their named
    order, then the noise."""
    k = model.kernel
    if isinstance(k, (Matern12, Matern32, Matern52, RBF)):
        return [k.raw_variance, k.raw_lengthscales, model.raw_noise_variance]
    return [p for _, p in k.named_parameters()] + [model.raw_noise_variance]


def value_and_grad(model):
    """One training step without the update: the loss (−LML) and its
    gradient w.r.t. the unconstrained (variance, lengthscale, noise)."""
    model.zero_grad(set_to_none=True)
    loss = model.training_loss()
    loss.backward()
    return loss.detach(), torch.stack([p.grad.reshape(()) for p in hyper_params(model)])


def plain_value_and_grad(model):
    """The same step through the plain versions only, on the model's device:
    plain filter, plain smoother and ``dt_fisher_plain``, chained to the
    hyperparameters as ``lml_dt``'s backward chains the kernels' outputs."""
    fam, co, sde, dts = dt._model_inputs(model.kernel, model.ts)
    leaves = [co, sde.P0, sde.H, model.noise_variance.reshape(1, 1)]
    with torch.no_grad():
        co_, P0_, H_, R_ = (x.detach() for x in leaves)
        b, C, ell = dt.strip_filter_dt_plain(fam, co_, P0_, H_, R_, dts, model.ys)
        g, L = dt.strip_smoother_dt_plain(fam, co_, P0_, dts, b, C)
        cts = dt.dt_fisher_plain(fam, co_, P0_, H_, R_, dts, model.ys, *(x.contiguous() for x in (b, C, g, L)))
    live = [(x, -c) for x, c in zip(leaves, cts) if x.requires_grad]
    grads = torch.autograd.grad([x for x, _ in live], hyper_params(model), [c for _, c in live])
    return -ell, torch.stack([g.reshape(()) for g in grads])


def strip_inputs(kernel, t, y, dtype):
    """(Fs, Qs, P0, H, R, y) of the kernel's time-last model on the card, no
    autograd: what the strip kernels read."""
    with torch.no_grad():
        R = torch.full((1, 1), NOISE, dtype=dtype, device=DEV)
        ssm = kernel.get_ssm_tl(torch.as_tensor(t, dtype=dtype, device=DEV), R)
        yt = torch.as_tensor(y, dtype=dtype, device=DEV)
    return ssm.Fs.contiguous(), ssm.Qs.contiguous(), ssm.P0, ssm.H, ssm.R, yt


def plain_strip_value_and_grad(model):
    """A training step of a strip-engine model through the plain versions
    only, on the model's device: plain strip filter, plain strip smoother and
    the Fisher tail, chained to the hyperparameters through the plane build
    as ``lml_tl``'s backward chains the kernels' outputs."""
    ssm = model.kernel.get_ssm_tl(model.ts, model.noise_variance.reshape(1, 1))
    with torch.no_grad():
        det = LGSSMTL(*(x.detach() for x in ssm))
        b, C, ell = strip.strip_filter_plain(det.Fs, det.Qs, det.P0, det.H, det.R, model.ys)
        g, L = strip.strip_smoother_plain(det.Fs, det.Qs, b, C)
        one = torch.ones((), dtype=b.dtype, device=b.device)
        cts, _ = timelast.fisher_grads_from_smoothed(det, model.ys, b, C, g, L, one)
    live = [(x, -c) for x, c in zip(ssm, cts) if x.requires_grad]
    grads = torch.autograd.grad([x for x, _ in live], hyper_params(model), [c for _, c in live])
    return -ell, torch.stack([g.reshape(()) for g in grads])


def _mm(d):
    return d * d * (2 * d - 1)


def _mv(d):
    return d * (2 * d - 1)


def _symout(d):
    return d * d * (d + 1)


def _mm_rect(p, q, r):
    return p * r * (2 * q - 1)


def _inv_flops(d: int) -> int:
    """Operations of dt_elements.cuh::inv: the closed forms for d ≤ 3, the
    Schur-complement recursion (split k = (d+1)/2) above."""
    if d <= 3:
        return {1: 1, 2: 8, 3: 42}[d]
    k = (d + 1) // 2
    m = d - k
    products = (
        _mm_rect(m, k, k) + _mm_rect(k, k, m) + _mm_rect(m, k, m) + _mm_rect(k, m, m) + _mm_rect(k, m, k) + _mm_rect(m, m, k)
    )
    return _inv_flops(k) + _inv_flops(m) + products + m * m + k * k


# Operations of one composite weight of each kind and of its two derivatives
# (csrc/dt_elements.cuh: composite_weight), by kind (kernels/composite.py:
# EXPM1, TAU, COSM1, SIN, SPEC_EM1, SPEC_ES); TAU adds 3 a power.
COMPOSITE_WEIGHT_OPS = {0: (3, 4), 1: (2, 4), 2: (8, 4), 3: (4, 3), 4: (14, 4), 5: (8, 4)}


def composite_ops(plan) -> tuple:
    """(build, chain rule) operations a step of a composite plan: each
    weight's, then per monomial one multiply a factor past the first and a
    multiply-add an entry of its pattern; the chain rule adds each weight's
    derivatives, each monomial's ⟨dA, K⟩ over its pattern and its factors'
    cotangents, and the tile's W·dA sums over every entry of each monomial."""
    weights = sum(COMPOSITE_WEIGHT_OPS[k][0] + (3 * int(p) if k == 1 else 0) for k, p, _ in plan.weights)
    nnz = sum(sum(pat) for pat in plan.patterns)
    build = weights + sum(len(m) - 1 for m in plan.monomials) + 2 * nnz
    chain = (
        sum(COMPOSITE_WEIGHT_OPS[k][1] for k, _, _ in plan.weights) + 2 * nnz
        + sum(len(m) * len(m) for m in plan.monomials) + 3 * len(plan.weights) + 2 * len(plan.monomials) * plan.d * plan.d
    )
    return build, chain


def flops_per_step(d: int, degree: int, family: str = EXPPOLY, plan=None) -> dict:
    """Floating-point operations of one time step of each kernel, counted
    from csrc/dt_elements.cuh (a multiply, an add, a divide and a
    transcendental one each); ``*_obs`` parts run at observed steps only.
    The strip kernels load F and Q where the dt kernels rebuild them, from
    the exponential polynomial of ``degree``, (``family`` SPECTRAL) RBF's
    spectral family: (d+1)/2 blocks, each 5 transcendentals, 8 scalar
    operations and 2·d² multiply-adds a step, or (COMPOSITE) a composite
    ``plan``'s weights and monomials (composite_ops)."""
    tri = d * (d + 1) // 2
    inv = _inv_flops(d)
    blocks = (d + 1) // 2
    fq_from_am1 = d + _mm(d) + tri * (2 * d + 2)
    if family == SPECTRAL:
        build_fq = 1 + blocks * (13 + 4 * d * d) + fq_from_am1
    elif family == COMPOSITE:
        build_fq = composite_ops(plan)[0] + fq_from_am1
    else:
        build_fq = 4 + degree * (2 * d * d + 2) + fq_from_am1
    build_filtering = 2 * _mv(d) + 2 * d + 2 + d * (3 + 6 * d)
    filt_combine = 5 * _mm(d) + 2 * _symout(d) + inv + 4 * _mv(d) + 5 * d
    loglik_obs = 2 * _mv(d) + _mv(d) + 6 * d + 10
    build_smoothing = 4 * _mm(d) + _symout(d) + inv + _mv(d) + d + tri * 2 * d
    smooth_combine = 2 * _mm(d) + _mv(d) + d + _symout(d)
    am1_vjp = tri * (2 + 4 * d) + 2 * _mm(d) + d * d
    if family == SPECTRAL:
        # Per block: sincos and exp, 10 scalar operations, two d² dot
        # products; then the coefficients' cotangents w·dA (2 blocks·d²
        # multiply-adds) and the sums of d c[0], d_P0, d_H and d_R.
        fq_vjp = am1_vjp + 2 + blocks * (13 + 4 * d * d) + 4 * blocks * d * d + d * d + d + 2
    elif family == COMPOSITE:
        fq_vjp = am1_vjp + composite_ops(plan)[1] + d * d + d + 2
    else:
        fq_vjp = am1_vjp + d + 6 + degree * (4 * d * d + 5)
    fisher = (
        build_fq + 5 * _mm(d) + _symout(d) + inv + 3 * _mv(d) + d + 4 * d * d + d * d * (2 * d + 1)
        + fq_vjp + (1 + d * d) + d * d
    )
    fisher_obs = 2 * _mv(d) + 5 * d + 10
    filt = build_filtering + filt_combine
    smooth = build_smoothing + smooth_combine
    return {
        "dt_filter_scan": (build_fq + filt, 0), "dt_filter_apply": (build_fq + filt, loglik_obs),
        "dt_smoother_scan": (build_fq + smooth, 0), "dt_smoother_apply": (build_fq + smooth, 0),
        "dt_fisher": (fisher, fisher_obs),
        **{f"{k}_{fam}": v for fam in (SPECTRAL, COMPOSITE) for k, v in (
            ("dt_filter_scan", (build_fq + filt, 0)), ("dt_filter_apply", (build_fq + filt, loglik_obs)),
            ("dt_smoother_scan", (build_fq + smooth, 0)), ("dt_smoother_apply", (build_fq + smooth, 0)),
            ("dt_fisher", (fisher, fisher_obs)),
        )},
        "strip_filter_scan": (filt, 0), "strip_filter_apply": (filt, loglik_obs),
        "strip_smoother_scan": (smooth, 0), "strip_smoother_apply": (smooth, 0),
        # One element and one combine a step: what the function needs, not the
        # re-fold and the scan rounds this design spends on it.
        "batched_filter": (filt, loglik_obs), "batched_smoother": (smooth, 0),
        # The plane scan: one combine a step over given elements; the
        # transpose computes nothing.
        "plane_scan_filter": (filt_combine, 0), "plane_scan_smoother": (smooth_combine, 0), "plane_transpose": (0, 0),
    }


def kernel_bound(
    name: str, d: int, degree: int, T: int, n_obs: int, itemsize: int, B: int = 1, y_series: int | None = None,
    rows: int | None = None, plan=None,
):
    """(bound in ms, "bytes" or "operations"): the least time the card could
    take — each input read once and each output written once at the memory
    peak, against this run's operations at the float32 peak.  ``degree`` is
    read by the dt kernels only; ``itemsize`` 8 counts the operations at the
    float64 peak.  ``B`` series: ``n_obs`` counts all series'
    observed steps; ``y_series`` is the number of observation vectors the
    call reads (B by default, 1 where the chains share one with a batch
    stride of 0); the batched Fisher tail reads one shared dt.  The plane
    scan ("plane_scan_filter" / "_smoother") reads and writes its packed
    rows; "plane_transpose" moves ``rows`` rows of T values (d² for Fs, Qs
    and the covariances, d for the means).  A composite kernel
    ("…_composite") counts the operations of its ``plan``."""
    peak_flops = PEAK_F64_FLOPS if itemsize == 8 else PEAK_F32_FLOPS
    if name.startswith("plane_"):
        check(name != "plane_transpose" or bool(rows), "kernel_bound: a transpose needs its row count")
        values = {
            "plane_scan_filter": 2 * dt.filt_rows(d) * T,
            "plane_scan_smoother": 2 * dt.smooth_rows(d) * T,
            "plane_transpose": 2 * (rows or 0) * T,
        }[name]
        every, _ = flops_per_step(d, degree)[name]
        bytes_ms = 1e3 * values * itemsize / PEAK_BYTES_PER_S
        ops_ms = 1e3 * every * T / peak_flops
        return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")
    if B > 1 or name in BATCHED_KERNELS:
        steps = B * T
        y_values = (B if y_series is None else y_series) * T
        values = {
            "batched_filter": (3 * d * d + d) * steps + y_values,
            "batched_smoother": (4 * d * d + 2 * d) * steps,  # without the projection's two planes
            "dt_fisher": T + y_values + 2 * (d + d * d) * steps + 2 * steps,
        }[name]
        every, observed = flops_per_step(d, degree)[name]
        bytes_ms = 1e3 * values * itemsize / PEAK_BYTES_PER_S
        ops_ms = 1e3 * (every * steps + observed * n_obs) / peak_flops
        return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")
    nc = dt.n_chunks(T)
    mom = (d + d * d) * T
    planes = 2 * d * d * T
    family = next((f for f in (SPECTRAL, COMPOSITE) if name.endswith(f"_{f}")), EXPPOLY)
    name = name.removesuffix(f"_{family}")
    values = {
        "dt_filter_scan": 2 * T + dt.filt_rows(d) * nc,
        "dt_filter_apply": 2 * T + dt.filt_rows(d) * nc + mom,
        "dt_smoother_scan": T + mom + dt.smooth_rows(d) * nc,
        "dt_smoother_apply": T + mom + dt.smooth_rows(d) * nc + mom,
        "dt_fisher": 2 * T + 2 * mom + 2 * T,
        "strip_filter_scan": planes + T + dt.filt_rows(d) * nc,
        "strip_filter_apply": planes + T + dt.filt_rows(d) * nc + mom,
        "strip_smoother_scan": planes + mom + dt.smooth_rows(d) * nc,
        "strip_smoother_apply": planes + mom + dt.smooth_rows(d) * nc + mom,
    }[name]
    every, observed = flops_per_step(d, degree, family, plan)[name]
    bytes_ms = 1e3 * values * itemsize / PEAK_BYTES_PER_S
    ops_ms = 1e3 * (every * T + observed * n_obs) / peak_flops
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


# --------------------------------------------------------------------------
# Phases
# --------------------------------------------------------------------------


def phase_device() -> str:
    check(torch.cuda.is_available(), "no CUDA device: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    return card


def ptxas_lines(log: str) -> list:
    """One line per kernel of a build log: registers, stack and spills as
    ptxas reports them."""
    lines, entry, frame = [], None, {}
    for line in log.splitlines():
        found = re.search(r"Compiling entry function '_ZN(?:3pgt|9pgt_probe)\d+(\w+?)_kernelI([fd])(?:Li(\d)E|Lb([01])E)?", line)
        if found:
            entry = f"{found.group(1)} {'f64' if found.group(2) == 'd' else 'f32'}" + (f" D={found.group(3)}" if found.group(3) else "")
            entry += {"0": " chunk", "1": " coalesced"}.get(found.group(4), "")
            ops = re.search(r"NS_\d+(Filter|Smoother)Ops", line)  # the plane scan's two kinds
            entry += f" {ops.group(1).lower()}" if ops else ""
        elif "spill stores" in line:
            frame = {what: n for n, what in re.findall(r"(\d+) bytes (stack frame|spill stores|spill loads)", line)}
        elif "registers" in line and entry:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            smem = re.search(r"(\d+) bytes smem", line)
            lines.append(
                f"ptxas: {entry}: {regs} registers, {smem.group(1) if smem else 0} B static smem, "
                f"{frame.get('stack frame', '?')} B stack, "
                f"{frame.get('spill stores', '?')} B spill stores, {frame.get('spill loads', '?')} B spill loads"
            )
            entry = None
    return lines


def phase_build() -> None:
    t0 = time.perf_counter()
    so, log = _cuda.build()
    _cuda.load()
    print(f"build: {so.name} in {time.perf_counter() - t0:.1f} s")
    for line in ptxas_lines(log):
        print(f"  {line}")
    # The dynamic shared memory of the kernels that stage through it: the dt
    # pass-2 units of each family (threads and bytes a block).
    lib = _cuda.load()
    for family, top in dt.MAX_KERNEL_D.items():
        for smoother, name in enumerate(("dt_filter_apply", "dt_smoother_apply")):
            staged = {}
            for bits in (32, 64):
                for d in range(1, top + 1):
                    args = (int(bits == 64), dt.FAMILY_IDS[family], smoother)
                    threads, smem = (getattr(lib, f"pgt_dt_apply_{f}_d{d}")(*args) for f in ("threads", "smem"))
                    check(0 < smem <= strip.SMEM_LIMIT, f"{name} {family} d={d} f{bits}: {smem} B a block")
                    staged[f"f{bits} D={d}"] = f"{threads}x{smem} B"
            print(f"  threads x dynamic smem a block: {name} {family} {staged}")
    phase_strip_stages(lib)
    phase_scan_stages(lib)
    for dtype in (torch.float32, torch.float64):
        tiling = {d: plane.scan_tiling(d, dtype) for d in range(1, plane.MAX_KERNEL_D + 1)}
        print(f"  plane_scan {dtype}, by D: threads x steps a thread " + ", ".join(
            f"D={d} {nt}x{st}" for d, (nt, st) in tiling.items()))
    for dtype in (torch.float32, torch.float64):
        size = torch.finfo(dtype).bits // 8
        runs = {w: plane.transpose_run(N_FULL, w, dtype) for w in (1, 3, 9, 16, 36, 64)}
        # The tile: w rows of L values, padded by one 16-byte vector a row.
        print(f"  dynamic smem a block: plane_transpose {dtype}, width w (run L): " + ", ".join(
            f"w={w} (L={L}) {w * (L + 16 // size) * size} B" for w, L in runs.items()))


def phase_strip_stages(lib) -> None:
    """Each strip pass-2 unit's stage as the library reports it (and as
    _cuda.load() has held it against kalman/strip.py's mirror) — threads a
    block, rows a warp stages (moments only, d + d², or the planes too),
    dynamic shared memory a block, and the warps an SM holds (the occupancy
    calculator) — held against the opt-in limit; with the warps an SM at
    N = N_STRIP."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    path_warps = -(-strip.n_chunks(N_STRIP) // 32)
    for (d, dtype, kind), (threads, rows, smem) in _cuda.strip_apply_stages(lib).items():
        blocks = getattr(lib, f"pgt_strip_apply_blocks_per_sm_d{d}")(int(dtype == torch.float64), int(kind == "smoother"))
        static = 0 if kind == "smoother" else threads * (torch.finfo(dtype).bits // 8)  # block_sum's values
        check(smem + static <= strip.SMEM_LIMIT, f"strip {kind} apply d={d} {dtype}: {smem} + {static} B a block")
        check(blocks > 0, f"strip {kind} apply d={d} {dtype}: occupancy calculator returned {blocks}")
        resident = blocks * threads // 32
        print(
            f"  strip_{kind}_apply d={d} {dtype}: stages {'planes' if rows != d + d * d else 'moments'} ({rows} rows a warp), "
            f"{threads} threads and {smem} B dynamic smem a block, {resident} warps an SM; at N={N_STRIP} "
            f"{min(resident, -(-path_warps // sms))} warps an SM ({path_warps} warps on {sms} SMs)"
        )


PASS_KINDS = ("filter", "smoother")


def scan_name(unit: str, kind: str) -> str:
    """The launch counter of the ``kind`` pass-1 kernel of a unit ("strip",
    or a dt family)."""
    if unit == "strip":
        return f"strip_{kind}_scan"
    return f"dt_{kind}_scan{'' if unit == EXPPOLY else '_spectral'}"


def scan_rows(name: str, d: int, rows: int, buffers: int) -> str:
    """What a pass-1 unit's warps stage."""
    if buffers == 0:
        return "nothing (each thread reads its own chunk's rows directly)"
    if "filter" in name:
        what = "F, Q and y" if name.startswith("strip") else "y and dt"
    else:
        what = "planes" if rows != d + d * d else "moments"
    return f"{what} ({rows} rows a warp) in {buffers} buffer(s)"


def phase_scan_stages(lib) -> None:
    """Each pass-1 unit's stage, the filter's and the smoother's, as the
    library reports it (and as _cuda.load() has held it against
    kalman/strip.py's and kalman/dt.py's mirrors) — threads a block, rows a
    warp stages, buffers, dynamic shared memory a block, and the warps an SM
    holds (the occupancy calculator) — held against the opt-in limit."""
    units = [(scan_name("strip", kind), (d, dtype), lib_stage, f"pgt_strip_scan_blocks_per_sm_d{d}",
              (int(dtype == torch.float64), int(kind == "smoother")))
             for (d, dtype, kind), lib_stage in _cuda.strip_scan_stages(lib).items()]
    units += [(scan_name(family, kind), (d, dtype), lib_stage, f"pgt_dt_scan_blocks_per_sm_d{d}",
               (int(dtype == torch.float64), dt.FAMILY_IDS[family], int(kind == "smoother")))
              for (family, d, dtype, kind), lib_stage in _cuda.dt_scan_stages(lib).items()]
    for name, (d, dtype), (threads, rows, smem, buffers), entry, args in units:
        blocks = getattr(lib, entry)(*args)
        what = f"{name} d={d} {dtype}"
        check(0 <= smem <= strip.SMEM_LIMIT and (smem > 0 or buffers == 0), f"{what}: {smem} B a block")
        check(blocks > 0, f"{what}: occupancy calculator returned {blocks}")
        print(
            f"  {what}: stages {scan_rows(name, d, rows, buffers)}, {threads} threads and {smem} B dynamic smem a "
            f"block, {blocks * threads // 32} warps an SM"
        )


FISHER_OUTPUTS = ("d_coeffs", "d_P0", "d_H", "d_R", "d_dts", "d_y")


def phase_kernels() -> None:
    """Filter, smoother and Fisher tail of the dt-engine through the kernels
    against their plain versions, then the strip kernels."""
    cases = [(Matern12, (1.2, 0.6)), (Matern32, (1.0, 0.5)), (Matern52, (0.8, 0.4))]
    t, y = make_data(T_KERNEL, SEED + 1)
    for kcls, params in cases:
        name = kcls.__name__
        with torch.no_grad():
            # float64: the tolerances of the JAX interpret tests
            # (test_pallas_dt.py:71-73, 86-87).
            fam, co, P0, H, R, dts, yt = engine_inputs(kcls, params, t, y, torch.float64)
            b_k, C_k, ell_k = dt.strip_filter_dt(fam, co, P0, H, R, dts, yt)
            b_p, C_p, ell_p = dt.strip_filter_dt_plain(fam, co, P0, H, R, dts, yt)
            g_k, L_k = dt.strip_smoother_dt(fam, co, P0, dts, b_p, C_p)
            g_p, L_p = dt.strip_smoother_dt_plain(fam, co, P0, dts, b_p, C_p)
            torch.cuda.synchronize()
            print(
                f"{name} f64 T={T_KERNEL}: |b| {max_abs(b_k, b_p):.3e} |C| {max_abs(C_k, C_p):.3e} "
                f"ell {float(ell_k):.12f} vs {float(ell_p):.12f} |g| {max_abs(g_k, g_p):.3e} |L| {max_abs(L_k, L_p):.3e}"
            )
            check(allclose(b_k, b_p, 1e-9, 1e-10) and allclose(C_k, C_p, 1e-9, 1e-10), f"{name} f64 filter moments")
            check(abs(float(ell_k - ell_p)) <= 1e-9 * abs(float(ell_p)), f"{name} f64 LML")
            check(allclose(g_k, g_p, 1e-8, 1e-9) and allclose(L_k, L_p, 1e-8, 1e-9), f"{name} f64 smoother moments")
            # The Fisher tail on the same (b, C, g, L), all six outputs, to
            # the tolerances of the JAX gradient tests (test_pallas_dt.py:207).
            mom = [x.contiguous() for x in (b_p, C_p, g_p, L_p)]
            f_k = dt.dt_fisher(fam, co, P0, H, R, dts, yt, *mom)
            f_p = dt.dt_fisher_plain(fam, co, P0, H, R, dts, yt, *mom)
            torch.cuda.synchronize()
            print(f"{name} f64 T={T_KERNEL} fisher: " + " ".join(f"|{n}| {max_abs(a, b):.3e}" for n, a, b in zip(FISHER_OUTPUTS, f_k, f_p)))
            for n, a, b in zip(FISHER_OUTPUTS, f_k, f_p):
                check(a.shape == b.shape and allclose(a, b, 1e-7, 1e-10), f"{name} f64 fisher {n}")

            # float32 against float64 truth, beside the plain float32 engine.
            g_t, L_t = g_p, L_p
            fam, co, P0, H, R, dts, yt = engine_inputs(kcls, params, t, y, torch.float32)
            b_k, C_k, ell_k32 = dt.strip_filter_dt(fam, co, P0, H, R, dts, yt)
            g_k, L_k = dt.strip_smoother_dt(fam, co, P0, dts, b_k, C_k)
            b_q, C_q, ell_q32 = dt.strip_filter_dt_plain(fam, co, P0, H, R, dts, yt)
            g_q, L_q = dt.strip_smoother_dt_plain(fam, co, P0, dts, b_q, C_q)
            # The Fisher tail in float32: kernel and plain on the same
            # inputs, the truth from float64 copies of those inputs.
            in32 = [co, P0, H, R, dts, yt] + [x.contiguous() for x in (b_q, C_q, g_q, L_q)]
            f_k = dt.dt_fisher(fam, *in32)
            f_q = dt.dt_fisher_plain(fam, *in32)
            f_t = dt.dt_fisher_plain(fam, *(x.double() for x in in32))
            torch.cuda.synchronize()
        errs = {
            "b": (rel_err(b_k, b_p), rel_err(b_q, b_p)),
            "C": (rel_err(C_k, C_p), rel_err(C_q, C_p)),
            "ell": (abs(float(ell_k32) - float(ell_p)) / abs(float(ell_p)), abs(float(ell_q32) - float(ell_p)) / abs(float(ell_p))),
            "g": (rel_err(g_k, g_t), rel_err(g_q, g_t)),
            "L": (rel_err(L_k, L_t), rel_err(L_q, L_t)),
            **{n: (rel_err(a, c), rel_err(b, c)) for n, a, b, c in zip(FISHER_OUTPUTS, f_k, f_q, f_t)},
        }
        print(f"{name} f32 vs f64 truth (kernel / plain f32): " + " ".join(f"{k} {a:.2e}/{b:.2e}" for k, (a, b) in errs.items()))
        for k, (a, b) in errs.items():
            floor = f32_sum_floor(T_KERNEL) if k in FISHER_OUTPUTS[:4] else F32_FLOOR
            check(a <= max(F32_FACTOR * b, floor), f"{name} f32 {k}: kernel {a:.3e} vs plain {b:.3e}")
    check_apply_edges(cases)
    check_strip_kernels(t, y)
    check_strip_apply_edges()


# The spectral dt units' cases: RBF(1.0, 0.05, order=d), the strip checks'
# RBF kernels (STRIP_CASES), at every d = 1..8.
SPECTRAL_DIMS = tuple(range(1, dt.MAX_KERNEL_D[SPECTRAL] + 1))


def spectral_kernel(d: int, dtype):
    return RBF(1.0, 0.05, order=d, dtype=dtype, device=DEV)


def fisher_close(a, b) -> bool:
    """The float64 Fisher tail against its plain version: rtol 1e-7 (the JAX
    gradient tests', test_pallas_dt.py:207) and an absolute tolerance of
    1e-9 of the output's largest value (at least 1e-10): an output that is a
    sum over T steps carries the summation order's rounding at that scale."""
    return a.shape == b.shape and allclose(a, b, 1e-7, max(1e-10, 1e-9 * float(b.double().abs().max())))


def check_spectral_kernels() -> None:
    """Every spectral dt unit, d = 1..8, float64 and float32: the filter
    (scan and apply), the smoother (scan and apply, on the plain filter's
    moments) and the Fisher tail through the kernels, each launched once,
    against their plain versions at T = T_KERNEL with ~10% missing
    observations.  float64 to the JAX interpret tests' tolerances
    (strip_tolerances: the dt Matérn checks' at d ≤ 3, test_pallas_scan.py's
    RBF cases above; fisher_close); float32 against float64 truth by the 10×
    rule, as the Matérn units."""
    t, y = make_data(T_KERNEL, SEED + 1)
    one_each = {**NOT_SPECTRAL, **dict.fromkeys(SPECTRAL_KERNELS, 1)}
    for d in SPECTRAL_DIMS:
        rf, af, rs, as_ = strip_tolerances(d)
        name = f"RBF d={d} spectral"
        with torch.no_grad():
            fam, co, P0, H, R, dts, yt = kernel_inputs(spectral_kernel(d, torch.float64), t, y, torch.float64)
            dt.reset_launch_counts()
            b_k, C_k, ell_k = dt.strip_filter_dt(fam, co, P0, H, R, dts, yt)
            b_p, C_p, ell_p = dt.strip_filter_dt_plain(fam, co, P0, H, R, dts, yt)
            g_k, L_k = dt.strip_smoother_dt(fam, co, P0, dts, b_p, C_p)
            g_p, L_p = dt.strip_smoother_dt_plain(fam, co, P0, dts, b_p, C_p)
            mom = [x.contiguous() for x in (b_p, C_p, g_p, L_p)]
            f_k = dt.dt_fisher(fam, co, P0, H, R, dts, yt, *mom)
            f_p = dt.dt_fisher_plain(fam, co, P0, H, R, dts, yt, *mom)
            torch.cuda.synchronize()
        check(dt.LAUNCHES == one_each, f"{name}: launches {dt.LAUNCHES}")
        with torch.no_grad():
            again = dt.dt_fisher(fam, co, P0, H, R, dts, yt, *mom)
        check(all(bits(a) == bits(b) for a, b in zip(f_k, again)), f"{name}: two Fisher launches differ")
        print(
            f"{name} f64 T={T_KERNEL}: |b| {max_abs(b_k, b_p):.3e} |C| {max_abs(C_k, C_p):.3e} "
            f"ell {float(ell_k):.12f} vs {float(ell_p):.12f} |g| {max_abs(g_k, g_p):.3e} |L| {max_abs(L_k, L_p):.3e}; fisher "
            + " ".join(f"|{n}| {max_abs(a, b):.3e} (of {float(b.abs().max()):.3e})" for n, a, b in zip(FISHER_OUTPUTS, f_k, f_p))
        )
        check(allclose(b_k, b_p, rf, af) and allclose(C_k, C_p, rf, af), f"{name} f64 filter moments")
        check(abs(float(ell_k - ell_p)) <= 1e-9 * abs(float(ell_p)), f"{name} f64 LML")
        check(allclose(g_k, g_p, rs, as_) and allclose(L_k, L_p, rs, as_), f"{name} f64 smoother moments")
        for n, a, b in zip(FISHER_OUTPUTS, f_k, f_p):
            check(fisher_close(a, b), f"{name} f64 fisher {n}")

        # float32 against float64 truth, beside the plain float32 engine.
        with torch.no_grad():
            fam, co, P0, H, R, dts, yt = kernel_inputs(spectral_kernel(d, torch.float32), t, y, torch.float32)
            b_k, C_k, ell_k32 = dt.strip_filter_dt(fam, co, P0, H, R, dts, yt)
            b_q, C_q, ell_q32 = dt.strip_filter_dt_plain(fam, co, P0, H, R, dts, yt)
            g_k, L_k = dt.strip_smoother_dt(fam, co, P0, dts, b_q, C_q)
            g_q, L_q = dt.strip_smoother_dt_plain(fam, co, P0, dts, b_q, C_q)
            g_t, L_t = dt.strip_smoother_dt_plain(fam, co.double(), P0.double(), dts.double(), b_q.double(), C_q.double())
            in32 = [co, P0, H, R, dts, yt] + [x.contiguous() for x in (b_q, C_q, g_q, L_q)]
            f_k = dt.dt_fisher(fam, *in32)
            f_q = dt.dt_fisher_plain(fam, *in32)
            f_t = dt.dt_fisher_plain(fam, *(x.double() for x in in32))
            torch.cuda.synchronize()
        errs = {
            "b": (rel_err(b_k, b_p), rel_err(b_q, b_p)),
            "C": (rel_err(C_k, C_p), rel_err(C_q, C_p)),
            "ell": (abs(float(ell_k32) - float(ell_p)) / abs(float(ell_p)), abs(float(ell_q32) - float(ell_p)) / abs(float(ell_p))),
            "g": (rel_err(g_k, g_t), rel_err(g_q, g_t)),
            "L": (rel_err(L_k, L_t), rel_err(L_q, L_t)),
            **{n: (rel_err(a, c), rel_err(b, c)) for n, a, b, c in zip(FISHER_OUTPUTS, f_k, f_q, f_t)},
        }
        print(f"{name} f32 vs f64 truth (kernel / plain f32): " + " ".join(f"{k} {a:.2e}/{b:.2e}" for k, (a, b) in errs.items()))
        for k, (a, b) in errs.items():
            floor = f32_sum_floor(T_KERNEL) if k in FISHER_OUTPUTS[:4] else F32_FLOOR
            check(a <= max(F32_FACTOR * b, floor), f"{name} f32 {k}: kernel {a:.3e} vs plain {b:.3e}")
    check_spectral_apply_edges()


# Series lengths of the Fisher units' checks at their edges: one step, past
# the first round of the lane-split body (16, 32, ..., 256 steps a block),
# several rounds a block with a ragged last one.
FISHER_EDGE_T = (1, 17, 33, 257, 5_003)


def check_fisher_edges() -> None:
    """Every dt_fisher unit — the exponential polynomial d = 1..3, the
    spectral family d = 1..8, the composite family d = 2..8 and the bare
    Periodic — float64 at the lengths FISHER_EDGE_T (the exponential
    polynomial, whose body is not lane-split, at the largest) and float32
    at the largest, and the batched units d = 1..3 with B = 3 at the
    largest: each against dt_fisher_plain on the plain passes' moments
    (float64 by fisher_close, float32 against float64 truth by the 10× rule
    or f32_sum_floor), two launches bit for bit."""
    units = fisher_units() + [(COMPOSITE, 6, BARE_PERIODIC)]
    n_checked = 0
    for family, d, make in units:
        for T in FISHER_EDGE_T if family != EXPPOLY else FISHER_EDGE_T[-1:]:
            t, y = make_data(T, SEED + 50 + T % 7)
            outs = {torch.float32: float("nan")}
            for dtype in (torch.float64, torch.float32) if T == FISHER_EDGE_T[-1] else (torch.float64,):
                fam, co, P0, H, R, dts, yt = kernel_inputs(make(dtype), t, y, dtype)
                with torch.no_grad():
                    b, C, _ = dt.strip_filter_dt_plain(fam, co, P0, H, R, dts, yt)
                    g, L = dt.strip_smoother_dt_plain(fam, co, P0, dts, b, C)
                    args = (fam, co, P0, H, R, dts, yt, *(x.contiguous() for x in (b, C, g, L)))
                    f_k, again = dt.dt_fisher(*args), dt.dt_fisher(*args)
                    f_p = dt.dt_fisher_plain(*args)
                    f_t = dt.dt_fisher_plain(*(x.double() if isinstance(x, torch.Tensor) else x for x in args))
                    torch.cuda.synchronize()
                what = f"dt_fisher {family} d={d} T={T} {dtype}"
                check(all(bits(a) == bits(b_) for a, b_ in zip(f_k, again)), f"{what}: two launches differ")
                if dtype == torch.float64:
                    for n, a, b_ in zip(FISHER_OUTPUTS, f_k, f_p):
                        check(fisher_close(a, b_), f"{what} {n}: |kernel - plain| {max_abs(a, b_):.3e}")
                else:
                    errs = [(n, rel_err(a, c), rel_err(b_, c)) for n, a, b_, c in zip(FISHER_OUTPUTS, f_k, f_p, f_t)]
                    print(f"{what} vs f64 truth (kernel / plain f32): " + " ".join(f"{n} {a:.2e}/{b_:.2e}" for n, a, b_ in errs))
                    for n, a, b_ in errs:
                        floor = f32_sum_floor(T) if n in FISHER_OUTPUTS[:4] else F32_FLOOR
                        check(a <= max(F32_FACTOR * b_, floor), f"{what} {n}: kernel {a:.3e} vs plain {b_:.3e} from f64")
                outs[dtype] = max(max_abs(a, b_) / max(float(b_.abs().max()), 1e-300) for a, b_ in zip(f_k, f_p))
                n_checked += 1
            if T == FISHER_EDGE_T[-1]:
                print(f"dt_fisher {family} d={d} T={T}: |kernel - plain| / max, f64 {outs[torch.float64]:.2e}, "
                      f"f32 {outs[torch.float32]:.2e}; two launches bit for bit")
    for d in FISHER_EXP:
        for dtype in (torch.float64, torch.float32):
            args = batched_fisher_inputs(d, dtype, B=3, T=FISHER_EDGE_T[-1])
            with torch.no_grad():
                f_k, again, f_p = dt.dt_fisher(*args), dt.dt_fisher(*args), dt.dt_fisher_plain(*args)
                torch.cuda.synchronize()
            what = f"dt_fisher batched d={d} B=3 T={FISHER_EDGE_T[-1]} {dtype}"
            check(all(bits(a) == bits(b_) for a, b_ in zip(f_k, again)), f"{what}: two launches differ")
            if dtype == torch.float64:
                for n, a, b_ in zip(FISHER_OUTPUTS, f_k, f_p):
                    check(fisher_close(a, b_), f"{what} {n}: |kernel - plain| {max_abs(a, b_):.3e}")
            n_checked += 1
    print(f"dt_fisher units at their edges: {n_checked} cases against dt_fisher_plain, two launches bit for bit")


def check_spectral_apply_edges() -> None:
    """Each spectral unit's staged pass 2, filter and smoother, d = 1..8,
    float64 and float32, at the lengths where its stage has ragged edges
    (strip_edge_lengths of the unit's block, pgt_dt_apply_threads_d<d>):
    float64 to strip_tolerances, float32 by the 10× rule.  The smoothers run
    on the plain filter's moments."""
    lib = _cuda.load()
    n = 0
    for dtype in (torch.float64, torch.float32):
        is64 = int(dtype == torch.float64)
        for d in SPECTRAL_DIMS:
            rf, af, rs, as_ = strip_tolerances(d)
            threads = {getattr(lib, f"pgt_dt_apply_threads_d{d}")(is64, dt.FAMILY_IDS[SPECTRAL], k) for k in (0, 1)}
            lengths = sorted(set().union(*(strip_edge_lengths(w) for w in threads)))
            for T in lengths:
                t, y = make_data(T, SEED + 7)
                what = f"spectral d={d} {dtype} T={T} (blocks of {sorted(threads)} threads)"
                with torch.no_grad():
                    fam, co, P0, H, R, dts, yt = kernel_inputs(spectral_kernel(d, dtype), t, y, dtype)
                    b_k, C_k, ell_k = dt.strip_filter_dt(fam, co, P0, H, R, dts, yt)
                    b_p, C_p, ell_p = dt.strip_filter_dt_plain(fam, co, P0, H, R, dts, yt)
                    g_k, L_k = dt.strip_smoother_dt(fam, co, P0, dts, b_p, C_p)
                    g_p, L_p = dt.strip_smoother_dt_plain(fam, co, P0, dts, b_p, C_p)
                    if dtype == torch.float32:
                        args64 = [x.double() for x in (co, P0, H, R, dts, yt)]
                        b_t, C_t, ell_t = dt.strip_filter_dt_plain(fam, *args64)
                        g_t, L_t = dt.strip_smoother_dt_plain(fam, args64[0], args64[1], args64[4], b_p.double(), C_p.double())
                    torch.cuda.synchronize()
                n += 1
                if dtype == torch.float64:
                    check(allclose(b_k, b_p, rf, af) and allclose(C_k, C_p, rf, af), f"{what}: filter moments")
                    check(abs(float(ell_k - ell_p)) <= 1e-9 * max(abs(float(ell_p)), 1e-300), f"{what}: LML")
                    check(allclose(g_k, g_p, rs, as_) and allclose(L_k, L_p, rs, as_), f"{what}: smoother moments")
                    continue
                scale = max(abs(float(ell_t)), 1e-300)
                errs = {
                    "b": (rel_err(b_k, b_t), rel_err(b_p, b_t)), "C": (rel_err(C_k, C_t), rel_err(C_p, C_t)),
                    "ell": (abs(float(ell_k) - float(ell_t)) / scale, abs(float(ell_p) - float(ell_t)) / scale),
                    "g": (rel_err(g_k, g_t), rel_err(g_p, g_t)), "L": (rel_err(L_k, L_t), rel_err(L_p, L_t)),
                }
                for k, (a, b_) in errs.items():
                    check(a <= max(F32_FACTOR * b_, F32_FLOOR), f"{what} {k}: kernel {a:.3e} vs plain {b_:.3e}")
    print(f"spectral dt pass-2 units at their stage's ragged lengths: {n} cases, d = 1..8, f64 and f32, all within tolerance")


# The composite dt units' cases, one a state dimension d = 2..8: Sums,
# Products, a Periodic × Matern12, a Sum of a Product (the CO2 shape) and the
# QP model's Periodic × Matern32; and a bare Periodic (BARE_PERIODIC, d = 6:
# undamped, Q = 0), held as the others but not timed.
COMPOSITE_CASES = {
    2: lambda dtype: Matern12(1.0, 0.5, dtype=dtype, device=DEV) + Matern12(0.8, 0.3, dtype=dtype, device=DEV),
    3: lambda dtype: Matern32(1.1, 0.5, dtype=dtype, device=DEV) + Matern12(0.8, 0.3, dtype=dtype, device=DEV),
    4: lambda dtype: Matern32(1.2, 0.6, dtype=dtype, device=DEV) * Matern32(0.9, 0.4, dtype=dtype, device=DEV),
    5: lambda dtype: Matern52(0.8, 0.4, dtype=dtype, device=DEV) + Matern32(1.0, 0.5, dtype=dtype, device=DEV),
    6: lambda dtype: Periodic(1.3, 0.8, period=0.7, order=2, dtype=dtype, device=DEV) * Matern12(1.0, 2.0, dtype=dtype, device=DEV),
    7: lambda dtype: Periodic(1.0, 1.0, period=0.5, order=1, dtype=dtype, device=DEV) * Matern12(1.0, 0.7, dtype=dtype, device=DEV)
    + Matern52(0.8, 0.4, dtype=dtype, device=DEV),
    8: lambda dtype: Periodic(1.0, 1.0, period=1.0, order=1, dtype=dtype, device=DEV) * Matern32(1.0, 1.0, dtype=dtype, device=DEV),
}
BARE_PERIODIC = lambda dtype: Periodic(1.3, 0.8, period=0.7, order=2, dtype=dtype, device=DEV)  # noqa: E731


def bits(x) -> bytes:
    return x.detach().cpu().contiguous().numpy().tobytes()


def check_composite_kernels() -> None:
    """Every composite dt unit, d = 2..8 (COMPOSITE_CASES), float64 and
    float32: the filter (scan and apply), the smoother (scan and apply, on
    the plain filter's moments) and the Fisher tail through the kernels,
    each launched once, against their plain versions at T = T_KERNEL with
    ~10% missing observations — float64 to the spectral units' tolerances
    (strip_tolerances, fisher_close), float32 against float64 truth by the
    10× rule — and a second launch of each bit for bit the first, the bare
    Periodic (BARE_PERIODIC) too; then the staged pass 2 at its ragged
    lengths (check_composite_apply_edges)."""
    t, y = make_data(T_KERNEL, SEED + 1)
    one_each = {**NOT_COMPOSITE, **dict.fromkeys(COMPOSITE_KERNELS, 1)}
    for d, make in [*COMPOSITE_CASES.items(), (6, BARE_PERIODIC)]:
        rf, af, rs, as_ = strip_tolerances(d)
        k64 = make(torch.float64)
        name = f"{k64!r} d={d} composite"
        check(k64.state_dim == d and k64.transition_coeffs()[0] == COMPOSITE, f"{name}: not a d={d} composite")
        with torch.no_grad():
            fam, co, P0, H, R, dts, yt = kernel_inputs(k64, t, y, torch.float64)
            dt.reset_launch_counts()
            b_k, C_k, ell_k = dt.strip_filter_dt(fam, co, P0, H, R, dts, yt)
            b_p, C_p, ell_p = dt.strip_filter_dt_plain(fam, co, P0, H, R, dts, yt)
            g_k, L_k = dt.strip_smoother_dt(fam, co, P0, dts, b_p, C_p)
            g_p, L_p = dt.strip_smoother_dt_plain(fam, co, P0, dts, b_p, C_p)
            mom = [x.contiguous() for x in (b_p, C_p, g_p, L_p)]
            f_k = dt.dt_fisher(fam, co, P0, H, R, dts, yt, *mom)
            f_p = dt.dt_fisher_plain(fam, co, P0, H, R, dts, yt, *mom)
            torch.cuda.synchronize()
            launches = dict(dt.LAUNCHES)
            again = (dt.strip_filter_dt(fam, co, P0, H, R, dts, yt), dt.strip_smoother_dt(fam, co, P0, dts, b_p, C_p),
                     dt.dt_fisher(fam, co, P0, H, R, dts, yt, *mom))
        check(launches == one_each, f"{name}: launches {launches}")
        first = (b_k, C_k, ell_k, g_k, L_k, *f_k)
        check(all(bits(a) == bits(b) for a, b in zip(first, [x for part in again for x in part])), f"{name}: two launches differ")
        print(
            f"{name} f64 T={T_KERNEL}: |b| {max_abs(b_k, b_p):.3e} |C| {max_abs(C_k, C_p):.3e} "
            f"ell {float(ell_k):.12f} vs {float(ell_p):.12f} |g| {max_abs(g_k, g_p):.3e} |L| {max_abs(L_k, L_p):.3e}; fisher "
            + " ".join(f"|{n}| {max_abs(a, b):.3e} (of {float(b.abs().max()):.3e})" for n, a, b in zip(FISHER_OUTPUTS, f_k, f_p))
            + "; two launches bit for bit"
        )
        check(allclose(b_k, b_p, rf, af) and allclose(C_k, C_p, rf, af), f"{name} f64 filter moments")
        check(abs(float(ell_k - ell_p)) <= 1e-9 * abs(float(ell_p)), f"{name} f64 LML")
        check(allclose(g_k, g_p, rs, as_) and allclose(L_k, L_p, rs, as_), f"{name} f64 smoother moments")
        for n, a, b in zip(FISHER_OUTPUTS, f_k, f_p):
            check(fisher_close(a, b), f"{name} f64 fisher {n}")

        with torch.no_grad():
            fam, co, P0, H, R, dts, yt = kernel_inputs(make(torch.float32), t, y, torch.float32)
            b_k, C_k, ell_k32 = dt.strip_filter_dt(fam, co, P0, H, R, dts, yt)
            b_q, C_q, ell_q32 = dt.strip_filter_dt_plain(fam, co, P0, H, R, dts, yt)
            g_k, L_k = dt.strip_smoother_dt(fam, co, P0, dts, b_q, C_q)
            g_q, L_q = dt.strip_smoother_dt_plain(fam, co, P0, dts, b_q, C_q)
            g_t, L_t = dt.strip_smoother_dt_plain(fam, co.double(), P0.double(), dts.double(), b_q.double(), C_q.double())
            in32 = [co, P0, H, R, dts, yt] + [x.contiguous() for x in (b_q, C_q, g_q, L_q)]
            f_k = dt.dt_fisher(fam, *in32)
            f_q = dt.dt_fisher_plain(fam, *in32)
            f_t = dt.dt_fisher_plain(fam, *(x.double() for x in in32))
            torch.cuda.synchronize()
        errs = {
            "b": (rel_err(b_k, b_p), rel_err(b_q, b_p)),
            "C": (rel_err(C_k, C_p), rel_err(C_q, C_p)),
            "ell": (abs(float(ell_k32) - float(ell_p)) / abs(float(ell_p)), abs(float(ell_q32) - float(ell_p)) / abs(float(ell_p))),
            "g": (rel_err(g_k, g_t), rel_err(g_q, g_t)),
            "L": (rel_err(L_k, L_t), rel_err(L_q, L_t)),
            **{n: (rel_err(a, c), rel_err(b, c)) for n, a, b, c in zip(FISHER_OUTPUTS, f_k, f_q, f_t)},
        }
        print(f"{name} f32 vs f64 truth (kernel / plain f32): " + " ".join(f"{k} {a:.2e}/{b:.2e}" for k, (a, b) in errs.items()))
        for k, (a, b) in errs.items():
            floor = f32_sum_floor(T_KERNEL) if k in FISHER_OUTPUTS[:4] else F32_FLOOR
            check(a <= max(F32_FACTOR * b, floor), f"{name} f32 {k}: kernel {a:.3e} vs plain {b:.3e}")
    check_composite_apply_edges()


def check_composite_apply_edges() -> None:
    """Each composite unit's staged pass 2, filter and smoother, d = 2..8,
    float64 and float32, at the lengths where its stage has ragged edges
    (strip_edge_lengths of the unit's block, pgt_dt_apply_threads_d<d>), as
    check_spectral_apply_edges holds the spectral units."""
    lib = _cuda.load()
    n = 0
    for dtype in (torch.float64, torch.float32):
        is64 = int(dtype == torch.float64)
        for d, make in COMPOSITE_CASES.items():
            rf, af, rs, as_ = strip_tolerances(d)
            threads = {getattr(lib, f"pgt_dt_apply_threads_d{d}")(is64, dt.FAMILY_IDS[COMPOSITE], k) for k in (0, 1)}
            lengths = sorted(set().union(*(strip_edge_lengths(w) for w in threads)))
            kern = make(dtype)
            for T in lengths:
                t, y = make_data(T, SEED + 7)
                what = f"composite d={d} {dtype} T={T} (blocks of {sorted(threads)} threads)"
                with torch.no_grad():
                    fam, co, P0, H, R, dts, yt = kernel_inputs(kern, t, y, dtype)
                    b_k, C_k, ell_k = dt.strip_filter_dt(fam, co, P0, H, R, dts, yt)
                    b_p, C_p, ell_p = dt.strip_filter_dt_plain(fam, co, P0, H, R, dts, yt)
                    g_k, L_k = dt.strip_smoother_dt(fam, co, P0, dts, b_p, C_p)
                    g_p, L_p = dt.strip_smoother_dt_plain(fam, co, P0, dts, b_p, C_p)
                    if dtype == torch.float32:
                        args64 = [x.double() for x in (co, P0, H, R, dts, yt)]
                        b_t, C_t, ell_t = dt.strip_filter_dt_plain(fam, *args64)
                        g_t, L_t = dt.strip_smoother_dt_plain(fam, args64[0], args64[1], args64[4], b_p.double(), C_p.double())
                    torch.cuda.synchronize()
                n += 1
                if dtype == torch.float64:
                    check(allclose(b_k, b_p, rf, af) and allclose(C_k, C_p, rf, af), f"{what}: filter moments")
                    check(abs(float(ell_k - ell_p)) <= 1e-9 * max(abs(float(ell_p)), 1e-300), f"{what}: LML")
                    check(allclose(g_k, g_p, rs, as_) and allclose(L_k, L_p, rs, as_), f"{what}: smoother moments")
                    continue
                scale = max(abs(float(ell_t)), 1e-300)
                errs = {
                    "b": (rel_err(b_k, b_t), rel_err(b_p, b_t)), "C": (rel_err(C_k, C_t), rel_err(C_p, C_t)),
                    "ell": (abs(float(ell_k) - float(ell_t)) / scale, abs(float(ell_p) - float(ell_t)) / scale),
                    "g": (rel_err(g_k, g_t), rel_err(g_p, g_t)), "L": (rel_err(L_k, L_t), rel_err(L_p, L_t)),
                }
                for k, (a, b_) in errs.items():
                    check(a <= max(F32_FACTOR * b_, F32_FLOOR), f"{what} {k}: kernel {a:.3e} vs plain {b_:.3e}")
    print(f"composite dt pass-2 units at their stage's ragged lengths: {n} cases, d = 2..8, f64 and f32, all within tolerance")


# The edges of the staged pass-2 kernels, dt_filter_apply and
# dt_smoother_apply (a warp stages 8 (f32) or 4 (f64) steps of its 32 chunks
# of 64 steps, a block is 128 chunks): a short last chunk; a warp's chunks
# and one past them with a short last round; a block's chunks and one chunk
# past them, 5 steps long.
APPLY_EDGE_T = (1, 63, 64, 65, 2_047, 2_048, 2_053, 8_191, 8_192, 8_197)


def check_apply_edges(cases) -> None:
    """The dt filter and smoother through the kernels (their pass 2 the
    staged applies) against the plain versions at APPLY_EDGE_T: float64 to
    the JAX interpret tests' tolerances (filter 1e-9 / 1e-10, smoother
    1e-8 / 1e-9), float32 against float64 truth by the 10× rule.  The
    smoothers run on the plain filter's moments, and the float32 smoothers'
    truth is the float64 plain smoother on the same float32 moments."""
    worst = {}
    for T in APPLY_EDGE_T:
        t, y = make_data(T, SEED + 7)
        for kcls, params in cases:
            what = f"{kcls.__name__} T={T}"
            with torch.no_grad():
                fam, co64, P064, H, R, dts64, yt = engine_inputs(kcls, params, t, y, torch.float64)
                b_k, C_k, ell_k = dt.strip_filter_dt(fam, co64, P064, H, R, dts64, yt)
                b_p, C_p, ell_p = dt.strip_filter_dt_plain(fam, co64, P064, H, R, dts64, yt)
                g_k, L_k = dt.strip_smoother_dt(fam, co64, P064, dts64, b_p, C_p)
                g_p, L_p = dt.strip_smoother_dt_plain(fam, co64, P064, dts64, b_p, C_p)
                fam, co, P0, H, R, dts, yt = engine_inputs(kcls, params, t, y, torch.float32)
                b_k32, C_k32, ell_k32 = dt.strip_filter_dt(fam, co, P0, H, R, dts, yt)
                b_q32, C_q32, ell_q32 = dt.strip_filter_dt_plain(fam, co, P0, H, R, dts, yt)
                g_k32, L_k32 = dt.strip_smoother_dt(fam, co, P0, dts, b_q32, C_q32)
                g_q32, L_q32 = dt.strip_smoother_dt_plain(fam, co, P0, dts, b_q32, C_q32)
                g_t, L_t = dt.strip_smoother_dt_plain(fam, co64, P064, dts64, b_q32.double(), C_q32.double())
            torch.cuda.synchronize()
            check(allclose(b_k, b_p, 1e-9, 1e-10) and allclose(C_k, C_p, 1e-9, 1e-10), f"{what} f64 filter moments")
            check(abs(float(ell_k - ell_p)) <= 1e-9 * abs(float(ell_p)), f"{what} f64 LML {float(ell_k)} vs {float(ell_p)}")
            check(allclose(g_k, g_p, 1e-8, 1e-9) and allclose(L_k, L_p, 1e-8, 1e-9), f"{what} f64 smoother moments")
            scale = max(abs(float(ell_p)), 1e-300)
            errs = {
                "b": (rel_err(b_k32, b_p), rel_err(b_q32, b_p)),
                "C": (rel_err(C_k32, C_p), rel_err(C_q32, C_p)),
                "ell": (abs(float(ell_k32) - float(ell_p)) / scale, abs(float(ell_q32) - float(ell_p)) / scale),
                "g": (rel_err(g_k32, g_t), rel_err(g_q32, g_t)),
                "L": (rel_err(L_k32, L_t), rel_err(L_q32, L_t)),
            }
            for k, (a, b_) in errs.items():
                check(a <= max(F32_FACTOR * b_, F32_FLOOR), f"{what} f32 {k}: kernel {a:.3e} vs plain {b_:.3e}")
            worst[what] = (
                max(max_abs(b_k, b_p), max_abs(C_k, C_p)), max(max_abs(g_k, g_p), max_abs(L_k, L_p)),
                max(a / max(b_, F32_FLOOR / F32_FACTOR) for a, b_ in errs.values()),
            )
    for i, part in ((0, "filter"), (1, "smoother")):
        top = max(worst, key=lambda k: worst[k][i])
        print(f"dt {part} at T in {APPLY_EDGE_T}, Matern12/32/52: f64 |moments| max {worst[top][i]:.3e} ({top})")
    print(f"  f32 kernel error over plain f32 error at most {max(v[2] for v in worst.values()):.2f} (limit {F32_FACTOR:.0f})")


# The strip kernels' cases: Matérn planes at d ≤ 3, RBF planes above.  The
# float64 tolerances are the JAX interpret tests' (test_pallas_scan.py:88-90,
# 106-107 at d ≤ 3; 131-138 above): (filter rtol, atol, smoother rtol, atol).
# RBF lengthscale 0.05: at 0.3 and this spacing (dt/ℓ ≈ 5e-5) the d = 8
# model is so ill-conditioned that two float64 summation orders of the same
# algorithm land 3e-9 apart in the filtered means, above those tolerances.
STRIP_CASES = [
    ("Matern12 d=1", lambda dtype: Matern12(1.2, 0.6, dtype=dtype, device=DEV)),
    ("Matern32 d=2", lambda dtype: Matern32(1.0, 0.5, dtype=dtype, device=DEV)),
    ("Matern52 d=3", lambda dtype: Matern52(0.8, 0.4, dtype=dtype, device=DEV)),
    ("RBF d=4", lambda dtype: RBF(1.0, 0.05, order=4, dtype=dtype, device=DEV)),
    ("RBF d=6", lambda dtype: RBF(1.0, 0.05, order=6, dtype=dtype, device=DEV)),
    ("RBF d=8", lambda dtype: RBF(1.0, 0.05, order=8, dtype=dtype, device=DEV)),
]


def strip_tolerances(d: int):
    return (1e-9, 1e-10, 1e-8, 1e-9) if d <= 3 else (1e-8, 1e-9, 1e-7, 1e-8)


def check_strip_kernels(t, y) -> None:
    """The four strip kernels (through ``strip_filter`` / ``strip_smoother``,
    which launch each once) against their plain versions."""
    for name, make in STRIP_CASES:
        with torch.no_grad():
            Fs, Qs, P0, H, R, yt = strip_inputs(make(torch.float64), t, y, torch.float64)
            d = P0.shape[0]
            rf, af, rs, as_ = strip_tolerances(d)
            strip.reset_launch_counts()
            b_k, C_k, ell_k = strip.strip_filter(Fs, Qs, P0, H, R, yt)
            b_p, C_p, ell_p = strip.strip_filter_plain(Fs, Qs, P0, H, R, yt)
            g_k, L_k = strip.strip_smoother(Fs, Qs, b_p, C_p)
            g_p, L_p = strip.strip_smoother_plain(Fs, Qs, b_p, C_p)
            torch.cuda.synchronize()
            check(strip.LAUNCHES == STRIP_PASSES, f"{name}: launches {strip.LAUNCHES}")
            print(
                f"strip {name} f64 T={T_KERNEL}: |b| {max_abs(b_k, b_p):.3e} |C| {max_abs(C_k, C_p):.3e} "
                f"ell {float(ell_k):.12f} vs {float(ell_p):.12f} |g| {max_abs(g_k, g_p):.3e} |L| {max_abs(L_k, L_p):.3e}"
            )
            check(allclose(b_k, b_p, rf, af) and allclose(C_k, C_p, rf, af), f"strip {name} f64 filter moments")
            check(abs(float(ell_k - ell_p)) <= rf * abs(float(ell_p)), f"strip {name} f64 LML")
            check(allclose(g_k, g_p, rs, as_) and allclose(L_k, L_p, rs, as_), f"strip {name} f64 smoother moments")
            if d == 3:
                # Two independent routes to the same moments: planes from
                # PyTorch against F and Q rebuilt from dt in registers.
                fam, co, P0d, Hd, Rd, dts, yd = engine_inputs(Matern52, (0.8, 0.4), t, y, torch.float64)
                b_d, C_d, ell_d = dt.strip_filter_dt(fam, co, P0d, Hd, Rd, dts, yd)
                g_d, L_d = dt.strip_smoother_dt(fam, co, P0d, dts, b_d, C_d)
                g_s, L_s = strip.strip_smoother(Fs, Qs, b_k, C_k)
                torch.cuda.synchronize()
                print(
                    f"strip vs dt engine, Matern52 f64: |b| {max_abs(b_k, b_d):.3e} |C| {max_abs(C_k, C_d):.3e} "
                    f"ell {float(ell_k):.12f} vs {float(ell_d):.12f} |g| {max_abs(g_s, g_d):.3e} |L| {max_abs(L_s, L_d):.3e}"
                )
                check(allclose(b_k, b_d, rf, af) and allclose(C_k, C_d, rf, af), "strip vs dt filter moments")
                check(abs(float(ell_k - ell_d)) <= rf * abs(float(ell_d)), "strip vs dt LML")
                check(allclose(g_s, g_d, rs, as_) and allclose(L_s, L_d, rs, as_), "strip vs dt smoother moments")

            # float32 against float64 truth, beside the plain float32 engine.
            Fs, Qs, P0, H, R, yt = strip_inputs(make(torch.float32), t, y, torch.float32)
            b_k, C_k, ell_k32 = strip.strip_filter(Fs, Qs, P0, H, R, yt)
            g_k, L_k = strip.strip_smoother(Fs, Qs, b_k, C_k)
            b_q, C_q, ell_q32 = strip.strip_filter_plain(Fs, Qs, P0, H, R, yt)
            g_q, L_q = strip.strip_smoother_plain(Fs, Qs, b_q, C_q)
            torch.cuda.synchronize()
        errs = {
            "b": (rel_err(b_k, b_p), rel_err(b_q, b_p)),
            "C": (rel_err(C_k, C_p), rel_err(C_q, C_p)),
            "ell": (abs(float(ell_k32) - float(ell_p)) / abs(float(ell_p)), abs(float(ell_q32) - float(ell_p)) / abs(float(ell_p))),
            "g": (rel_err(g_k, g_p), rel_err(g_q, g_p)),
            "L": (rel_err(L_k, L_p), rel_err(L_q, L_p)),
        }
        print(f"strip {name} f32 vs f64 truth (kernel / plain f32): " + " ".join(f"{k} {a:.2e}/{b:.2e}" for k, (a, b) in errs.items()))
        for k, (a, b) in errs.items():
            check(a <= max(F32_FACTOR * b, F32_FLOOR), f"strip {name} f32 {k}: kernel {a:.3e} vs plain {b:.3e}")


def strip_edge_lengths(threads: int) -> tuple:
    """The lengths where a strip pass-2 kernel's stage has ragged edges (a
    warp stages 8 (f32) or 4 (f64) steps of its 32 chunks of 64, a block is
    ``threads`` chunks): one step; a chunk less one, a chunk and a step past
    it; a warp's chunks, a step and a chunk past them; a step short of the
    unit's block of chunks, the block and a 5-step chunk past it."""
    chunk, warp, block = strip.CHUNK, 32 * strip.CHUNK, threads * strip.CHUNK
    return tuple(sorted({1, chunk - 1, chunk, chunk + 1, warp, warp + 1, warp + chunk, block - 1, block, block + 5}))


def strip_edge_kernel(d: int, dtype):
    """Matérn planes at d ≤ 3, RBF(order=d) above (as STRIP_CASES)."""
    if d <= 3:
        kcls, params = {1: (Matern12, (1.2, 0.6)), 2: (Matern32, (1.0, 0.5)), 3: (Matern52, (0.8, 0.4))}[d]
        return kcls(*params, dtype=dtype, device=DEV)
    return RBF(1.0, 0.05, order=d, dtype=dtype, device=DEV)


def check_strip_apply_edges() -> None:
    """Both strip pass-2 kernels (through ``strip_filter`` / ``strip_smoother``)
    against their plain versions at every d = 1..8, float64 and float32, at
    each unit's strip_edge_lengths (the unit's threads a block as the library
    reports them): float64 to strip_tolerances, float32 against float64 truth
    by the 10× rule.  The smoothers run on the plain filter's moments; the
    float32 smoothers' truth is the float64 plain smoother on the same
    float32 moments and the float64 planes.  One line a (d, scalar type) with
    the worst error of each length."""
    lib = _cuda.load()
    for d in range(1, strip.MAX_KERNEL_D + 1):
        for dtype in (torch.float64, torch.float32):
            is64 = int(dtype == torch.float64)
            threads = {
                kind: getattr(lib, f"pgt_strip_apply_threads_d{d}")(is64, int(kind == "smoother"))
                for kind in ("filter", "smoother")
            }
            lengths = sorted(set(strip_edge_lengths(threads["filter"]) + strip_edge_lengths(threads["smoother"])))
            worst = {}
            for T in lengths:
                t, y = make_data(T, SEED + 8)
                what = f"strip apply edges d={d} T={T}"
                with torch.no_grad():
                    Fs, Qs, P0, H, R, yt = strip_inputs(strip_edge_kernel(d, torch.float64), t, y, torch.float64)
                    b_p, C_p, ell_p = strip.strip_filter_plain(Fs, Qs, P0, H, R, yt)
                    g_p, L_p = strip.strip_smoother_plain(Fs, Qs, b_p, C_p)
                    if dtype == torch.float64:
                        strip.reset_launch_counts()
                        b_k, C_k, ell_k = strip.strip_filter(Fs, Qs, P0, H, R, yt)
                        g_k, L_k = strip.strip_smoother(Fs, Qs, b_p, C_p)
                        torch.cuda.synchronize()
                        check(strip.LAUNCHES == STRIP_PASSES, f"{what}: launches {strip.LAUNCHES}")
                        rf, af, rs, as_ = strip_tolerances(d)
                        check(allclose(b_k, b_p, rf, af) and allclose(C_k, C_p, rf, af), f"{what} f64 filter moments")
                        check(abs(float(ell_k - ell_p)) <= rf * abs(float(ell_p)), f"{what} f64 LML {float(ell_k)} vs {float(ell_p)}")
                        check(allclose(g_k, g_p, rs, as_) and allclose(L_k, L_p, rs, as_), f"{what} f64 smoother moments")
                        worst[T] = max(max_abs(b_k, b_p), max_abs(C_k, C_p), max_abs(g_k, g_p), max_abs(L_k, L_p))
                        continue
                    Fs32, Qs32, P032, H32, R32, y32 = strip_inputs(strip_edge_kernel(d, dtype), t, y, dtype)
                    b_k, C_k, ell_k = strip.strip_filter(Fs32, Qs32, P032, H32, R32, y32)
                    b_q, C_q, ell_q = strip.strip_filter_plain(Fs32, Qs32, P032, H32, R32, y32)
                    g_k, L_k = strip.strip_smoother(Fs32, Qs32, b_q, C_q)
                    g_q, L_q = strip.strip_smoother_plain(Fs32, Qs32, b_q, C_q)
                    g_t, L_t = strip.strip_smoother_plain(Fs, Qs, b_q.double(), C_q.double())
                    torch.cuda.synchronize()
                scale = max(abs(float(ell_p)), 1e-300)
                errs = {
                    "b": (rel_err(b_k, b_p), rel_err(b_q, b_p)),
                    "C": (rel_err(C_k, C_p), rel_err(C_q, C_p)),
                    "ell": (abs(float(ell_k) - float(ell_p)) / scale, abs(float(ell_q) - float(ell_p)) / scale),
                    "g": (rel_err(g_k, g_t), rel_err(g_q, g_t)),
                    "L": (rel_err(L_k, L_t), rel_err(L_q, L_t)),
                }
                for k, (a, b_) in errs.items():
                    check(a <= max(F32_FACTOR * b_, F32_FLOOR), f"{what} f32 {k}: kernel {a:.3e} vs plain {b_:.3e}")
                worst[T] = max(a / max(b_, F32_FLOOR / F32_FACTOR) for a, b_ in errs.values())
            unit = f"filter {threads['filter']} / smoother {threads['smoother']} threads a block"
            if dtype == torch.float64:
                print(f"strip apply edges d={d} f64 ({unit}), worst |kernel - plain| by T: " + ", ".join(f"{T}: {e:.2e}" for T, e in worst.items()))
            else:
                print(f"strip apply edges d={d} f32 ({unit}), worst kernel error over plain f32 error by T (limit {F32_FACTOR:.0f}): "
                      + ", ".join(f"{T}: {e:.2f}" for T, e in worst.items()))


def scan_edge_lengths(threads: int, dtype) -> tuple:
    """The lengths where a pass-1 unit's stage has ragged edges: its block's
    strip_edge_lengths, and a round's worth of steps past a chunk (a round
    is 8 float32 or 4 float64 steps)."""
    return tuple(sorted(set(strip_edge_lengths(threads)) | {strip.CHUNK + 32 // (torch.finfo(dtype).bits // 8)}))


def check_scan_edges() -> None:
    """The filter's and the smoother's pass-1 kernels alone, each launched
    once a case — every strip unit and every spectral dt unit, d = 1..8, and
    the exponential polynomial's d = 1..3, float64 and float32 — their chunk
    totals against strip_filter_scan_plain / dt_filter_scan_plain and
    strip_smoother_scan_plain / dt_smoother_scan_plain at the lengths where
    the unit's stage of either pass or scalar type has ragged edges
    (scan_edge_lengths); the smoother on the plain float64 filter's moments.
    float64 to strip_tolerances' filter and smoother pairs (the JAX
    interpret tests'); float32 against float64 truth by the 10× rule: the
    filter on its inputs rounded to float32, against the float64 plain scan
    of the same rounded inputs; the smoother on the moments rounded to
    float32, against the float64 plain scan of the same rounded moments.
    One line a unit and pass with the worst error of each length."""
    lib = _cuda.load()
    stages = {("strip", *unit): stage for unit, stage in _cuda.strip_scan_stages(lib).items()}
    stages.update(_cuda.dt_scan_stages(lib))
    units = [("strip", d) for d in range(1, strip.MAX_KERNEL_D + 1)]
    units += [(family, d) for family in (SPECTRAL, EXPPOLY) for d in range(1, dt.MAX_KERNEL_D[family] + 1)]
    n = 0
    for unit, d in units:
        rf, af, rs, as_ = strip_tolerances(d)
        tols = {"filter": (rf, af), "smoother": (rs, as_)}
        threads = {(dtype, kind): stages[unit, d, dtype, kind][0] for dtype in (torch.float64, torch.float32) for kind in PASS_KINDS}
        lengths = sorted(set().union(*(scan_edge_lengths(w, dtype) for (dtype, _), w in threads.items())))
        names = {kind: scan_name(unit, kind) for kind in PASS_KINDS}
        worst = {kind: {} for kind in PASS_KINDS}
        for T in lengths:
            t, y = make_data(T, SEED + 9)
            with torch.no_grad():
                if unit == "strip":
                    Fs, Qs, P0, H, R, yt = strip_inputs(strip_edge_kernel(d, torch.float64), t, y, torch.float64)
                    b, C, _ = strip.strip_filter_plain(Fs, Qs, P0, H, R, yt)
                    models = {"filter": (Fs, Qs, P0, H, R), "smoother": (Fs, Qs)}
                    scans = {"filter": (strip.strip_filter_scan, strip.strip_filter_scan_plain),
                             "smoother": (strip.strip_smoother_scan, strip.strip_smoother_scan_plain)}
                    counts = strip.LAUNCHES
                else:
                    kern = spectral_kernel(d, torch.float64) if unit == SPECTRAL else strip_edge_kernel(d, torch.float64)
                    fam, co, P0, H, R, dts, yt = kernel_inputs(kern, t, y, torch.float64)
                    b, C, _ = dt.strip_filter_dt_plain(fam, co, P0, H, R, dts, yt)
                    models = {"filter": (co, P0, H, R, dts), "smoother": (co, P0, dts)}
                    scans = {kind: tuple(lambda *a, f=f, fam=fam: f(fam, *a) for f in fns) for kind, fns in (
                        ("filter", (dt.dt_filter_scan, dt.dt_filter_scan_plain)),
                        ("smoother", (dt.dt_smoother_scan, dt.dt_smoother_scan_plain)))}
                    counts = dt.LAUNCHES
                b, C = b.contiguous(), C.contiguous()
                data = {"filter": (yt,), "smoother": (b, C)}
                strip.reset_launch_counts()
                dt.reset_launch_counts()
                got = {}
                for kind in PASS_KINDS:
                    (kernel_scan, plain_scan), model = scans[kind], models[kind]
                    model32, data32 = (tuple(x.float().contiguous() for x in xs) for xs in (model, data[kind]))
                    tot_k, tot_k32 = kernel_scan(*model, *data[kind]), kernel_scan(*model32, *data32)
                    tot_p, tot_q32 = plain_scan(*model, *data[kind]), plain_scan(*model32, *data32)
                    # float64 truth of the float32 run: the filter's inputs, or
                    # the smoother's moments, as rounded to float32.
                    truth_model = tuple(x.double() for x in model32) if kind == "filter" else model
                    tot_t = plain_scan(*truth_model, *(x.double() for x in data32))
                    got[kind] = (tot_k, tot_k32, tot_p, tot_q32, tot_t)
                launched = {kind: counts[names[kind]] for kind in PASS_KINDS}
                torch.cuda.synchronize()
            for kind, (tot_k, tot_k32, tot_p, tot_q32, tot_t) in got.items():
                what = f"{names[kind]} d={d} T={T}"
                rows = strip.filt_rows(d) if kind == "filter" else strip.smooth_rows(d)
                check(launched[kind] == 2, f"{what}: {launched[kind]} launches, expected 2")
                check(tot_k.shape == tot_p.shape == (rows, strip.n_chunks(T)), f"{what}: totals {tuple(tot_k.shape)}")
                check(allclose(tot_k, tot_p, *tols[kind]), f"{what} f64 totals: |kernel - plain| {max_abs(tot_k, tot_p):.3e}")
                a, b_ = rel_err(tot_k32, tot_t), rel_err(tot_q32, tot_t)
                check(a <= max(F32_FACTOR * b_, F32_FLOOR), f"{what} f32 totals: kernel {a:.3e} vs plain {b_:.3e}")
                worst[kind][T] = (max_abs(tot_k, tot_p), a / max(b_, F32_FLOOR / F32_FACTOR))
                n += 2
        for kind in PASS_KINDS:
            print(
                f"{names[kind]} d={d} edges (blocks of {threads[torch.float64, kind]} / {threads[torch.float32, kind]} "
                f"threads, f64 / f32), T: f64 |kernel - plain|, f32 kernel error over plain f32 error: "
                + ", ".join(f"{T}: {e:.1e} {r:.2f}" for T, (e, r) in worst[kind].items())
            )
    print(f"filter and smoother pass-1 units at their stages' ragged lengths: {n} cases, all within tolerance")


# --------------------------------------------------------------------------
# The batched path: B series (or chains) through one launch per pass
# --------------------------------------------------------------------------

B_SMALL, B_FULL = 5, 64
T_BATCHED = 65_536  # the batched slice's series length
BATCHED_KERNELS = ("batched_filter", "batched_smoother")


def batched_tolerances(d: int):
    """float64 tolerances of the batched kernels against their plain
    versions: those of the JAX interpret tests (test_batched_pallas.py:73-86)
    and, above d = 3, ``strip_tolerances``: (filter rtol, atol, smoother rtol,
    atol)."""
    return (1e-9, 1e-11, 1e-8, 1e-10) if d <= 3 else strip_tolerances(d)


def series_data(B: int, T: int, seed: int):
    """Shared sorted times and B observation vectors, ~10% NaN each."""
    rng = np.random.RandomState(seed)
    t = np.sort(rng.rand(T))
    ys = np.sin(12.0 * t)[None] + np.sqrt(NOISE) * rng.randn(B, T)
    ys[rng.rand(B, T) < 0.1] = np.nan
    return t, ys


def series_hypers(B: int):
    """Per-series (variance, lengthscale, noise variance), spread around the
    serving model's."""
    j = np.arange(B) / max(B - 1, 1)
    return 0.6 + 0.5 * j, 0.3 + 0.2 * j, NOISE * (0.7 + 0.8 * j)


def batched_matern_inputs(kcls, B: int, t, dtype):
    """(family, coeffs (B, n), P0 (B, d, d), H (B, 1, d), R (B, 1, 1), dts,
    Fs, Qs) of B models with their own hyperparameters, built on the card by
    the batched SDE build and the batched plane build."""
    var, ell, noise = series_hypers(B)
    with torch.no_grad():
        k = kcls(var, ell, dtype=dtype, device=DEV)
        fam, co = k.transition_coeffs()
        co, P0, H, R, _ = dt.series_inputs(co, k.get_sde(), torch.as_tensor(noise, dtype=dtype, device=DEV))
        dts = dt._dts_from_ts(torch.as_tensor(t, dtype=dtype, device=DEV))
        Fs, Qs, P0s = dt.build_planes_tl(fam, co, P0, dts)
    return fam, co.contiguous(), P0s.contiguous(), H.contiguous(), R.contiguous(), dts, Fs, Qs


def batched_rbf_inputs(B: int, t, dtype, order: int = 6):
    """The same for RBF(order) models, whose planes are built one model at a
    time (the RBF build takes scalar hyperparameters) and stacked.
    Lengthscales from 0.05 down: above it the d = 8 model is too
    ill-conditioned for either float32 version (``STRIP_CASES``)."""
    var, _, noise = series_hypers(B)
    ts = torch.as_tensor(t, dtype=dtype, device=DEV)
    with torch.no_grad():
        ssms = [
            RBF(var[b], 0.05 - 0.005 * b, order=order, dtype=dtype, device=DEV).get_ssm_tl(
                ts, torch.full((1, 1), noise[b], dtype=dtype, device=DEV)
            )
            for b in range(B)
        ]
    stack = lambda leaf, axis: torch.stack([getattr(m, leaf) for m in ssms], axis)  # noqa: E731
    return stack("P0", 0), stack("H", 0), stack("R", 0), stack("Fs", 2), stack("Qs", 2)


def check_batched_case(name: str, planes64, planes32, ys) -> None:
    """One case of the batched kernels against their plain versions: float64
    to ``batched_tolerances``, float32 against the float64 truth; a few
    series against the single-series strip engine; one launch per call."""
    P0, H, R, Fs, Qs = planes64
    d, B = P0.shape[-1], P0.shape[0]
    rf, af, rs, as_ = batched_tolerances(d)
    with torch.no_grad():
        y64 = torch.as_tensor(ys, dtype=torch.float64, device=DEV)
        batched.reset_launch_counts()
        b_k, C_k, ell_k = batched.batched_strip_filter(Fs, Qs, P0, H, R, y64)
        b_p, C_p, ell_p = batched.batched_strip_filter_plain(Fs, Qs, P0, H, R, y64)
        g_k, L_k, mean_k, var_k = batched.batched_strip_smoother(Fs, Qs, b_p.contiguous(), C_p.contiguous(), H)
        g_p, L_p, mean_p, var_p = batched.batched_strip_smoother_plain(Fs, Qs, b_p, C_p, H)
        g_n, L_n = batched.batched_strip_smoother(Fs, Qs, b_p.contiguous(), C_p.contiguous(), None, project=False)
        torch.cuda.synchronize()
        check(batched.LAUNCHES == {"batched_filter": 1, "batched_smoother": 2}, f"{name}: launches {batched.LAUNCHES}")
        ell_rel = float(((ell_k - ell_p).abs() / ell_p.abs()).max())
        print(
            f"batched {name} f64 B={B} T={ys.shape[1]}: |b| {max_abs(b_k, b_p):.3e} |C| {max_abs(C_k, C_p):.3e} ell rel {ell_rel:.3e} "
            f"|g| {max_abs(g_k, g_p):.3e} |L| {max_abs(L_k, L_p):.3e} |mean| {max_abs(mean_k, mean_p):.3e} |var| {max_abs(var_k, var_p):.3e}"
        )
        check(ell_k.shape == (B,) and bool(torch.isfinite(ell_k).all()), f"batched {name} f64 ell shape or values")
        check(allclose(b_k, b_p, rf, af) and allclose(C_k, C_p, rf, af), f"batched {name} f64 filter moments")
        check(ell_rel <= 1e-10, f"batched {name} f64 per-series LML")
        check(allclose(g_k, g_p, rs, as_) and allclose(L_k, L_p, rs, as_), f"batched {name} f64 smoother moments")
        check(allclose(mean_k, mean_p, rs, as_) and allclose(var_k, var_p, rs, as_), f"batched {name} f64 projections")
        check(torch.equal(g_n, g_k) and torch.equal(L_n, L_k), f"batched {name}: project=False changes the moments")
        # Series of the batch against the single-series two-pass strip engine.
        for s in sorted({0, B // 2, B - 1}):
            b_s, C_s, ell_s = strip.strip_filter(Fs[:, :, s], Qs[:, :, s], P0[s], H[s], R[s], y64[s])
            g_s, L_s = strip.strip_smoother(Fs[:, :, s], Qs[:, :, s], b_s, C_s)
            g_b, L_b = g_k[:, s], L_k[:, :, s]
            check(allclose(b_k[:, s], b_s, rf, af) and allclose(C_k[:, :, s], C_s, rf, af), f"batched {name} series {s} vs strip_filter")
            check(abs(float(ell_k[s] - ell_s)) <= 1e-10 * abs(float(ell_s)), f"batched {name} series {s} LML vs strip_filter")
            check(allclose(g_b, g_s, rs, as_) and allclose(L_b, L_s, rs, as_), f"batched {name} series {s} vs strip_smoother")
        del b_k, C_k, g_k, L_k, g_n, L_n, mean_k, var_k, mean_p, var_p
        torch.cuda.empty_cache()

        # float32 against float64 truth, beside the plain float32 engine.
        P0f, Hf, Rf, Fsf, Qsf = planes32
        y32 = y64.float()
        b_k, C_k, ell_k = batched.batched_strip_filter(Fsf, Qsf, P0f, Hf, Rf, y32)
        g_k, L_k = batched.batched_strip_smoother(Fsf, Qsf, b_k, C_k, None, project=False)
        b_q, C_q, ell_q = batched.batched_strip_filter_plain(Fsf, Qsf, P0f, Hf, Rf, y32)
        g_q, L_q = batched.batched_strip_smoother_plain(Fsf, Qsf, b_q, C_q, None, project=False)
        torch.cuda.synchronize()
    rel_ell = lambda e: float(((e.double() - ell_p).abs() / ell_p.abs()).max())  # noqa: E731
    errs = {
        "b": (rel_err(b_k, b_p), rel_err(b_q, b_p)), "C": (rel_err(C_k, C_p), rel_err(C_q, C_p)),
        "ell": (rel_ell(ell_k), rel_ell(ell_q)), "g": (rel_err(g_k, g_p), rel_err(g_q, g_p)),
        "L": (rel_err(L_k, L_p), rel_err(L_q, L_p)),
    }
    print(f"batched {name} f32 vs f64 truth (kernel / plain f32): " + " ".join(f"{k} {a:.2e}/{b:.2e}" for k, (a, b) in errs.items()))
    for k, (a, b) in errs.items():
        check(a <= max(F32_FACTOR * b, F32_FLOOR), f"batched {name} f32 {k}: kernel {a:.3e} vs plain {b:.3e}")


def batched_tile_steps(d: int, dtype, kind: str) -> int:
    threads, steps, _, _ = batched.tile_shape(d, dtype, kind)
    return threads * steps


def batched_edge_lengths(d: int, dtype) -> tuple:
    """The lengths where the batched kernels' tiles have ragged edges, for
    each of the unit's two tiles (the filter's and the smoother's): one step;
    a step short of a tile, a tile and a step past it; three tiles and a
    5-step end."""
    lengths = {1}
    for kind in batched.KINDS:
        tile = batched_tile_steps(d, dtype, kind)
        lengths |= {tile - 1, tile, tile + 1, 3 * tile + 5}
    return tuple(sorted(lengths))


def check_batched_edges() -> None:
    """Both batched kernels against their plain versions at every d = 1..8,
    float64 and float32, at each unit's batched_edge_lengths with B = 3, and
    with B = 1 and B = 133 (more series than SMs) at three filter tiles and
    a 5-step end: the planes a view of longer ones (their own plane and batch
    strides), the smoother with and without its projection on the plain
    filter's moments, each kernel launched twice and the two launches' bits
    equal.  float64 to batched_tolerances; float32 against float64 truth by
    the 10× rule (the float32 smoothers' truth: the float64 plain smoother on
    the same float32 moments).  One line a (d, scalar type), the worst error
    of each case."""
    B_MAX, N_MODELS = 133, 3
    for d in range(1, batched.MAX_KERNEL_D + 1):
        for dtype in (torch.float64, torch.float32):
            lengths = batched_edge_lengths(d, dtype)
            long_T = 3 * batched_tile_steps(d, dtype, "filter") + 5
            cases = [(3, T) for T in lengths] + [(1, long_T), (B_MAX, long_T)]
            T_max = max(T for _, T in cases)
            t, ys = series_data(B_MAX, T_max, SEED + 40 + d)
            with torch.no_grad():
                # N_MODELS models of their own hyperparameters, series s the
                # model s % N_MODELS's; every series its own observations and
                # noise.
                planes = {}
                for dt_ in {torch.float64, dtype}:
                    ts = torch.as_tensor(t, dtype=dt_, device=DEV)
                    ssms = []
                    for j in range(N_MODELS):
                        if d <= 3:
                            kcls = {1: Matern12, 2: Matern32, 3: Matern52}[d]
                            kern = kcls(0.8 + 0.2 * j, 0.3 + 0.1 * j, dtype=dt_, device=DEV)
                        else:
                            kern = RBF(1.0 + 0.2 * j, 0.05 - 0.005 * j, order=d, dtype=dt_, device=DEV)
                        ssms.append(kern.get_ssm_tl(ts, torch.ones(1, 1, dtype=dt_, device=DEV)))
                    pick = torch.arange(B_MAX, device=DEV) % N_MODELS
                    Fs = torch.stack([m.Fs for m in ssms], 2)[:, :, pick]
                    Qs = torch.stack([m.Qs for m in ssms], 2)[:, :, pick]
                    P0 = torch.stack([m.P0 for m in ssms])[pick]
                    H = torch.stack([m.H for m in ssms])[pick]
                    R = torch.as_tensor(NOISE * (0.7 + 0.6 * np.arange(B_MAX) / B_MAX), dtype=dt_, device=DEV).reshape(B_MAX, 1, 1)
                    planes[dt_] = (Fs, Qs, P0, H, R, torch.as_tensor(ys, dtype=dt_, device=DEV))
            worst = {}
            for B, T in cases:
                what = f"batched edges d={d} {str(dtype)[6:]} B={B} T={T}"

                def cut(x, B=B, T=T):
                    return x[:, :, :B, :T] if x.dim() == 4 else x[:B, :T] if x.dim() == 2 else x[:B]

                with torch.no_grad():
                    Fs, Qs, P0, H, R, y = (cut(x) for x in planes[torch.float64])
                    b_p, C_p, ell_p = batched.batched_strip_filter_plain(Fs, Qs, P0, H, R, y)
                    g_p, L_p, mean_p, var_p = batched.batched_strip_smoother_plain(Fs, Qs, b_p, C_p, H)
                    Fk, Qk, P0k, Hk, Rk, yk = (cut(x) for x in planes[dtype])
                    batched.reset_launch_counts()
                    out_f = [batched.batched_strip_filter(Fk, Qk, P0k, Hk, Rk, yk) for _ in range(2)]
                    bq, Cq = (b_p, C_p) if dtype == torch.float64 else batched.batched_strip_filter_plain(Fk, Qk, P0k, Hk, Rk, yk)[:2]
                    out_s = [batched.batched_strip_smoother(Fk, Qk, bq.contiguous(), Cq.contiguous(), Hk) for _ in range(2)]
                    out_n = batched.batched_strip_smoother(Fk, Qk, bq.contiguous(), Cq.contiguous(), None, project=False)
                    torch.cuda.synchronize()
                    batched.check_overruns()
                    check(batched.LAUNCHES == {"batched_filter": 2, "batched_smoother": 3}, f"{what}: launches {batched.LAUNCHES}")
                    check(all(torch.equal(a, b_) for a, b_ in zip(out_f[0] + out_s[0], out_f[1] + out_s[1])), f"{what}: two launches differ")
                    check(torch.equal(out_n[0], out_s[0][0]) and torch.equal(out_n[1], out_s[0][1]), f"{what}: project=False changes the moments")
                    b_k, C_k, ell_k = out_f[0]
                    g_k, L_k, mean_k, var_k = out_s[0]
                    # Relative to max(|ell|, 1): a series whose steps are all
                    # missing has ell = 0 exactly.
                    ell_scale = ell_p.abs().clamp_min(1.0)
                    ell_rel = float(((ell_k.double() - ell_p).abs() / ell_scale).max())
                    if dtype == torch.float64:
                        rf, af, rs, as_ = batched_tolerances(d)
                        check(allclose(b_k, b_p, rf, af) and allclose(C_k, C_p, rf, af), f"{what} filter moments")
                        check(ell_rel <= 1e-10, f"{what} per-series LML {ell_rel:.3e}")
                        check(allclose(g_k, g_p, rs, as_) and allclose(L_k, L_p, rs, as_), f"{what} smoother moments")
                        check(allclose(mean_k, mean_p, rs, as_) and allclose(var_k, var_p, rs, as_), f"{what} projections")
                        worst[(B, T)] = max(max_abs(b_k, b_p), max_abs(C_k, C_p), max_abs(g_k, g_p), max_abs(L_k, L_p))
                        continue
                    b_q, C_q, ell_q = batched.batched_strip_filter_plain(Fk, Qk, P0k, Hk, Rk, yk)
                    g_q, L_q, mean_q, var_q = batched.batched_strip_smoother_plain(Fk, Qk, b_q, C_q, Hk)
                    g_t, L_t, mean_t, var_t = batched.batched_strip_smoother_plain(Fs, Qs, b_q.double(), C_q.double(), H)
                    ell_q_rel = float(((ell_q.double() - ell_p).abs() / ell_scale).max())
                errs = {
                    "b": (rel_err(b_k, b_p), rel_err(b_q, b_p)), "C": (rel_err(C_k, C_p), rel_err(C_q, C_p)),
                    "ell": (ell_rel, ell_q_rel), "g": (rel_err(g_k, g_t), rel_err(g_q, g_t)),
                    "L": (rel_err(L_k, L_t), rel_err(L_q, L_t)), "mean": (rel_err(mean_k, mean_t), rel_err(mean_q, mean_t)),
                    "var": (rel_err(var_k, var_t), rel_err(var_q, var_t)),
                }
                for k, (a, b_) in errs.items():
                    check(a <= max(F32_FACTOR * b_, F32_FLOOR), f"{what} f32 {k}: kernel {a:.3e} vs plain {b_:.3e}")
                worst[(B, T)] = max(a / max(b_, F32_FLOOR / F32_FACTOR) for a, b_ in errs.values())
            del planes
            torch.cuda.empty_cache()
            tiles = {kind: batched.tile_shape(d, dtype, kind) for kind in batched.KINDS}
            unit = f"tiles (threads, steps, rows, bytes) filter {tiles['filter']} / smoother {tiles['smoother']}"
            if dtype == torch.float64:
                print(f"batched edges d={d} f64 ({unit}), worst |kernel - plain| by (B, T): " + ", ".join(f"{k}: {e:.2e}" for k, e in worst.items()))
            else:
                print(f"batched edges d={d} f32 ({unit}), worst kernel error over plain f32 error by (B, T) (limit {F32_FACTOR:.0f}): "
                      + ", ".join(f"{k}: {e:.2f}" for k, e in worst.items()))


def check_batched_overrun() -> None:
    """A wait between two tiles that may not poll (MAX_POLLS = 0): the
    series' log-likelihoods are NaN past their first tile, the first tile's
    moments finite, and check_overruns raises; with the limit back, the same
    call is finite and raises nothing."""
    d, B, T = 2, 4, 3 * batched_tile_steps(2, torch.float32, "filter") + 5
    t, ys = series_data(B, T, SEED + 50)
    with torch.no_grad():
        ssm = Matern32(1.0, 0.5, dtype=torch.float32, device=DEV).get_ssm_tl(
            torch.as_tensor(t, dtype=torch.float32, device=DEV), torch.full((1, 1), NOISE, device=DEV)
        )
        args = (
            ssm.Fs[:, :, None].expand(d, d, B, T), ssm.Qs[:, :, None].expand(d, d, B, T), ssm.P0.expand(B, d, d),
            ssm.H.expand(B, 1, d), ssm.R.expand(B, 1, 1), torch.as_tensor(ys, dtype=torch.float32, device=DEV),
        )
        saved = batched.MAX_POLLS
        batched.MAX_POLLS = 0
        try:
            b, C, ell = batched.batched_strip_filter(*args)
            torch.cuda.synchronize()
        finally:
            batched.MAX_POLLS = saved
        raised = False
        try:
            batched.check_overruns()
        except RuntimeError as err:
            raised = True
            print(f"batched overrun with MAX_POLLS = 0 raised: {err}")
        tile = batched_tile_steps(d, torch.float32, "filter")
        check(raised, "an overrun of the batched filter did not raise")
        check(bool(torch.isnan(ell).all()) and bool(torch.isfinite(b[..., :tile]).all()) and bool(torch.isnan(b[..., tile:]).all()),
              "an overrun did not leave its series NaN past the first tile")
        b, C, ell = batched.batched_strip_filter(*args)
        batched.check_overruns()
        check(bool(torch.isfinite(ell).all()), "the batched filter after an overrun")


def phase_batched_kernels() -> None:
    """The two single-pass batched kernels and the batched Fisher tail
    against their plain versions."""
    cases = [(Matern12, "Matern12 d=1"), (Matern32, "Matern32 d=2"), (Matern52, "Matern52 d=3")]
    for B in (B_SMALL, B_FULL):
        t, ys = series_data(B, T_KERNEL, SEED + 10 + B)
        for kcls, name in cases:
            planes = []
            for dtype in (torch.float64, torch.float32):
                fam, co, P0, H, R, dts, Fs, Qs = batched_matern_inputs(kcls, B, t, dtype)
                planes.append((P0, H, R, Fs, Qs))
            check_batched_case(name, planes[0], planes[1], ys)
            del planes
            torch.cuda.empty_cache()
    # d = 8 in float64 is the one case whose block needs more than 48 KB of
    # shared memory (the opt-in of its launcher).
    t, ys = series_data(B_SMALL, T_KERNEL, SEED + 20)
    for order in (6, 8):
        check_batched_case(
            f"RBF d={order}", batched_rbf_inputs(B_SMALL, t, torch.float64, order),
            batched_rbf_inputs(B_SMALL, t, torch.float32, order), ys,
        )
        torch.cuda.empty_cache()

    # One model shared by 64 observation vectors (batch stride 0) against the
    # same model copied 64 times: the same bits.
    t, ys = series_data(B_FULL, T_KERNEL, SEED + 21)
    with torch.no_grad():
        k = Matern32(1.0, 0.5, dtype=torch.float32, device=DEV)
        ssm = k.get_ssm_tl(torch.as_tensor(t, dtype=torch.float32, device=DEV), torch.full((1, 1), NOISE, device=DEV))
        y32 = torch.as_tensor(ys, dtype=torch.float32, device=DEV)
        d, T = 2, T_KERNEL
        shared = (ssm.Fs[:, :, None].expand(d, d, B_FULL, T), ssm.Qs[:, :, None].expand(d, d, B_FULL, T))
        leaves = (ssm.P0.expand(B_FULL, d, d), ssm.H.expand(B_FULL, 1, d), ssm.R.expand(B_FULL, 1, 1))
        check(shared[0].stride(2) == 0, "the shared planes are not a stride-0 view")
        out_s = batched.batched_strip_filter(*shared, *leaves, y32)
        out_e = batched.batched_strip_filter(*(x.contiguous() for x in shared), *leaves, y32)
        sm_s = batched.batched_strip_smoother(*shared, out_s[0], out_s[1], leaves[1])
        sm_e = batched.batched_strip_smoother(*(x.contiguous() for x in shared), out_s[0], out_s[1], leaves[1])
        torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(out_s + sm_s, out_e + sm_e)), "shared (stride-0) planes differ from expanded ones")
    check(bool(torch.isfinite(out_s[2]).all()), "shared-model LMLs not finite")
    print(f"batched shared model, {B_FULL} observation vectors T={T}: stride-0 planes give the expanded planes' bits")
    del shared, out_s, out_e, sm_s, sm_e
    torch.cuda.empty_cache()

    # The Fisher tail with a batch axis against its plain version (shared dts,
    # per-series y), and at B = 1 against the single-series call, bit for bit.
    t, ys = series_data(B_SMALL, T_KERNEL, SEED + 22)
    for kcls, name in cases:
        with torch.no_grad():
            fam, co, P0, H, R, dts, Fs, Qs = batched_matern_inputs(kcls, B_SMALL, t, torch.float64)
            y64 = torch.as_tensor(ys, dtype=torch.float64, device=DEV)
            b, C, _ = batched.batched_strip_filter(Fs, Qs, P0, H, R, y64)
            g, L = batched.batched_strip_smoother(Fs, Qs, b, C, None, project=False)
            f_k = dt.dt_fisher(fam, co, P0, H, R, dts, y64, b, C, g, L)
            f_p = dt.dt_fisher_plain(fam, co, P0, H, R, dts, y64, b, C, g, L)
            one = [x[:1].contiguous() for x in (co, P0, H, R)] + [dts, y64[:1].contiguous()] + [
                x[:, :1].contiguous() for x in (b,)
            ] + [C[:, :, :1].contiguous(), g[:, :1].contiguous(), L[:, :, :1].contiguous()]
            f_1 = dt.dt_fisher(fam, *one)
            f_s = dt.dt_fisher(
                fam, co[0], P0[0], H[0], R[0], dts, y64[0], *(x[..., 0, :].contiguous() for x in (b, C, g, L))
            )
            torch.cuda.synchronize()
        print(f"batched {name} f64 B={B_SMALL} fisher: " + " ".join(f"|{n}| {max_abs(a, b_):.3e}" for n, a, b_ in zip(FISHER_OUTPUTS, f_k, f_p)))
        for n, a, b_, a1, s1 in zip(FISHER_OUTPUTS, f_k, f_p, f_1, f_s):
            check(a.shape == b_.shape and allclose(a, b_, 1e-7, 1e-10), f"batched {name} f64 fisher {n}")
            check(torch.equal(a1[0], s1), f"batched {name} fisher {n}: B = 1 differs from the single-series call")
    check_batched_edges()
    check_batched_overrun()


C_CHAINS = 64
T_CHAIN_CHECK = 16_384
N_HMC, N_MALA, N_NUTS, N_WARMUP = 4, 4, 2, 10
CHAIN_PRIORS = {k: (lambda u: -0.5 * u * u) for k in ("kernel.variance", "kernel.lengthscales", "noise_variance")}
TWO_PASS_KERNELS = tuple(k for k in DT_KERNELS + STRIP_KERNELS if k.endswith(("_scan", "_apply")))
# One batched log posterior with its gradient: one launch each of the
# batched filter, the batched smoother and the Fisher tail, and nothing else.
BATCHED_STEP_LAUNCHES = {
    "batched_filter": 1, "batched_smoother": 1, "dt_fisher": 1,
    **dict.fromkeys(TWO_PASS_KERNELS + SPECTRAL_KERNELS + COMPOSITE_KERNELS + PLANE_KERNELS, 0),
}
PREFIX_CALLS = [0]


def count_prefix_calls() -> None:
    """Count every call of the plain exclusive prefix between two passes
    (``exclusive_chunk_prefixes_plain``, which the all-plain strip engines
    call by its module's name; the card's entry points must make none)."""
    plain = strip.exclusive_chunk_prefixes_plain

    def counting(*args, **kwargs):
        PREFIX_CALLS[0] += 1
        return plain(*args, **kwargs)

    strip.exclusive_chunk_prefixes_plain = counting


def all_launches() -> dict:
    return {**dt.LAUNCHES, **strip.LAUNCHES, **batched.LAUNCHES, **plane.LAUNCHES}


def dt_launches() -> dict:
    """The dt kernels' launches and the plane scans of their chunk prefixes."""
    return {**dt.LAUNCHES, "plane_scan": plane.LAUNCHES["plane_scan"]}


def strip_launches() -> dict:
    """The strip kernels' launches and the plane scans of their chunk prefixes."""
    return {**strip.LAUNCHES, "plane_scan": plane.LAUNCHES["plane_scan"]}


def reset_all_launches() -> None:
    dt.reset_launch_counts()
    strip.reset_launch_counts()
    batched.reset_launch_counts()
    plane.reset_launch_counts()
    PREFIX_CALLS[0] = 0


def chain_hypers(C: int, seed: int):
    """C chains' (variance, lengthscale, noise variance), jittered around the
    serving model's (0.8, 0.4, 0.1) from a seeded generator."""
    jitter = torch.exp(0.1 * torch.randn((3, C), generator=torch.Generator().manual_seed(seed), dtype=torch.float64)).numpy()
    return 0.8 * jitter[0], 0.4 * jitter[1], NOISE * jitter[2]


def chain_model(t, y, hypers, dtype):
    return StateSpaceGP.from_numpy(t, y, "Matern52", *hypers, dtype=dtype, device=DEV)


def chains_value_and_grad(model):
    """One log posterior and its gradient: values (C,), gradients (C, 3) in
    (variance, lengthscale, noise) order; a scalar and (3,) for a scalar
    model."""
    log_post, u0 = make_log_posterior(model, CHAIN_PRIORS)
    u = {k: v.clone().requires_grad_() for k, v in u0.items()}
    lp = log_post(u)
    names = ["kernel.raw_variance", "kernel.raw_lengthscales", "raw_noise_variance"]
    grads = torch.autograd.grad(lp.sum(), [u[n] for n in names])
    return lp.detach(), torch.stack(grads, -1)


def phase_batched_slice():
    """The batched slice at full width: Matern52, 64 chains over one series of
    T = 65,536 in float32 — one batched log posterior and its gradient with
    the launches that takes, then HMC, MALA, NUTS and the dual-averaging
    warm-up through the normal entry points.  Returns the model and the
    launch counts of the path."""
    t, y = make_data(T_BATCHED, SEED + 30)
    hypers = chain_hypers(C_CHAINS, SEED + 31)
    model = chain_model(t, y, hypers, torch.float32)
    check(model.engine()[0] == "dt", f"the chains' model runs the {model.engine()[0]} engine")
    torch.cuda.synchronize()
    reset_all_launches()
    lp, grad = chains_value_and_grad(model)
    torch.cuda.synchronize()
    step_counts = all_launches()
    print(
        f"batched slice f32 Matern52 C={C_CHAINS} T={T_BATCHED}: log posterior min {float(lp.min()):.4f} max {float(lp.max()):.4f}; "
        f"launches of one value and gradient {step_counts}, plain prefixes {PREFIX_CALLS[0]}"
    )
    check(lp.shape == (C_CHAINS,) and grad.shape == (C_CHAINS, 3), "batched log posterior shapes")
    check(bool(torch.isfinite(lp).all()) and bool(torch.isfinite(grad).all()), "batched log posterior or gradient not finite")
    check(step_counts == BATCHED_STEP_LAUNCHES, f"one batched value and gradient launched {step_counts}")
    check(PREFIX_CALLS[0] == 0, f"the batched path ran {PREFIX_CALLS[0]} plain prefixes")
    lp2, grad2 = chains_value_and_grad(model)
    check(torch.equal(lp, lp2) and torch.equal(grad, grad2), "two batched evaluations differ")

    # The samplers, through the entry points a user calls.
    log_post, u0 = make_log_posterior(model, CHAIN_PRIORS)
    flat0, unravel = ravel_positions(u0)
    log_post_flat = lambda x: log_post(unravel(x))  # noqa: E731

    def run(seed):
        gen = torch.Generator(device=DEV).manual_seed(seed)
        found = find_reasonable_step_size(log_post_flat, flat0, gen)
        out = {"found": found}
        out["hmc_found"] = sample_chains(make_kernel("hmc", log_post_flat, found, num_leapfrog_steps=10), u0, log_post, gen, N_HMC)
        # The other samplers run at half that step size: the heuristic holds
        # one leapfrog step to an acceptance of 1/2, a looser criterion than a
        # ten-step trajectory's.
        eps = 0.5 * found
        out["eps"] = eps
        out["hmc"] = sample_chains(make_kernel("hmc", log_post_flat, eps, num_leapfrog_steps=10), u0, log_post, gen, N_HMC)
        out["mala"] = sample_chains(make_kernel("mala", log_post_flat, eps), u0, log_post, gen, N_MALA)
        mcmc.MASK_TESTS["nuts"] = 0
        out["nuts"] = sample_chains(make_kernel("nuts", log_post_flat, eps, max_depth=3), u0, log_post, gen, N_NUTS)
        out["nuts_mask_tests"] = mcmc.MASK_TESTS["nuts"]
        out["warmup"] = dual_averaging_warmup(
            lambda e: make_kernel("hmc", log_post_flat, e, num_leapfrog_steps=10), u0, log_post, gen,
            num_warmup=N_WARMUP, init_step_size=float(eps.median()),
        )
        return out

    first = run(SEED + 32)
    torch.cuda.synchronize()
    counts = all_launches()
    second = run(SEED + 32)
    torch.cuda.synchronize()
    for algo in ("hmc_found", "hmc", "mala", "nuts"):
        samples, accept = first[algo]
        last = {k: v[:, -1] for k, v in samples.items()}
        with torch.no_grad():
            lp_last = log_post(last)
        check(all(bool(torch.isfinite(v).all()) for v in samples.values()), f"{algo} samples not finite")
        check(bool(torch.isfinite(lp_last).all()), f"{algo}: log posterior of the last draws not finite")
        check(float(accept.min()) >= 0.0 and float(accept.max()) <= 1.0, f"{algo} acceptance statistic outside [0, 1]")
        check(all(torch.equal(samples[k], second[algo][0][k]) for k in samples) and torch.equal(accept, second[algo][1]),
              f"{algo}: a second run from the same seed differs")
        print(f"  {algo}: {accept.shape[1]} steps of {C_CHAINS} chains, mean acceptance {float(accept.mean()):.3f}")
    for algo, what in (("hmc_found", "the step size find_reasonable_step_size found"), ("hmc", "half that step size")):
        hmc_rate = float(first[algo][1].mean())
        check(0.2 < hmc_rate <= 1.0, f"HMC mean acceptance {hmc_rate} at {what}")
    eps_w, warm = first["warmup"]
    check(eps_w.shape == (C_CHAINS,) and bool(torch.isfinite(eps_w).all()) and bool((eps_w > 0).all()), "warm-up step sizes")
    check(torch.equal(eps_w, second["warmup"][0]) and torch.equal(first["eps"], second["eps"]), "warm-up differs between two runs")
    with torch.no_grad():
        check(bool(torch.isfinite(log_post(warm)).all()), "log posterior of the warmed positions not finite")
    print(
        f"  step size by find_reasonable_step_size: median {float(first['found'].median()):.4g} (hmc_found runs at it, the others at half); after {N_WARMUP} dual-averaging "
        f"steps median {float(eps_w.median()):.4g}; NUTS (max_depth=3) tested its masks {first['nuts_mask_tests'] / N_NUTS:.1f} times a step"
    )
    print(f"  launches of the batched path (one run of the samplers included) {counts}, plain prefixes {PREFIX_CALLS[0]}")
    check(
        not any(counts[k] for k in TWO_PASS_KERNELS + SPECTRAL_KERNELS + COMPOSITE_KERNELS + PLANE_KERNELS) and PREFIX_CALLS[0] == 0,
        f"the samplers left the batched path: {counts}",
    )
    check(counts["batched_filter"] >= counts["batched_smoother"] == counts["dt_fisher"] > N_HMC * 10, f"sampler launches {counts}")
    del first, second
    torch.cuda.empty_cache()

    # Each chain against the single-series engine on a model with that chain's
    # hyperparameters: float64 at a smaller T, then float32 at full length by
    # the gradient rule of the training path.
    tc, yc = make_data(T_CHAIN_CHECK, SEED + 33)
    lp64, grad64 = chains_value_and_grad(chain_model(tc, yc, hypers, torch.float64))
    worst_v = worst_g = 0.0
    for c in range(C_CHAINS):
        one = chain_model(tc, yc, tuple(h[c] for h in hypers), torch.float64)
        lp_c, grad_c = chains_value_and_grad(one)
        worst_v = max(worst_v, abs(float(lp64[c] - lp_c)) / abs(float(lp_c)))
        worst_g = max(worst_g, rel_err(grad64[c], grad_c))
        check(abs(float(lp64[c] - lp_c)) <= 1e-9 * abs(float(lp_c)), f"chain {c}: batched f64 log posterior vs single series")
        check(allclose(grad64[c], grad_c, 1e-7, 1e-10), f"chain {c}: batched f64 gradient vs single series")
    print(f"batched check f64 C={C_CHAINS} T={T_CHAIN_CHECK}: chains vs single-series lml_dt, value rel {worst_v:.2e}, gradient rel {worst_g:.2e}")
    lp_t, grad_t = chains_value_and_grad(chain_model(t, y, hypers, torch.float64))
    rels = []
    for c in (0, C_CHAINS // 2, C_CHAINS - 1):
        _, grad_c = chains_value_and_grad(chain_model(t, y, tuple(h[c] for h in hypers), torch.float32))
        rel_k, rel_s = rel_err(grad[c], grad_t[c]), rel_err(grad_c, grad_t[c])
        rels.append((rel_k, rel_s))
        check(rel_k <= max(F32_FACTOR * rel_s, f32_sum_floor(T_BATCHED)), f"chain {c} f32 gradient: batched {rel_k:.3e} vs single series {rel_s:.3e} from f64")
    print(
        f"batched f32 vs f64 C={C_CHAINS} T={T_BATCHED}: log posterior rel {float(((lp.double() - lp_t).abs() / lp_t.abs()).max()):.3e}; gradient "
        f"(batched / single-series f32) " + " ".join(f"{a:.2e}/{b:.2e}" for a, b in rels)
    )

    # bench.py's batched workload: one Matern32 model, 64 observation vectors,
    # lml_tl on planes with a batch axis, against 64 single calls.
    tb_, ys = series_data(C_CHAINS, T_CHAIN_CHECK, SEED + 34)
    with torch.no_grad():
        ssm = Matern32(1.0, 0.5, dtype=torch.float64, device=DEV).get_ssm_tl(
            torch.as_tensor(tb_, dtype=torch.float64, device=DEV), torch.full((1, 1), NOISE, dtype=torch.float64, device=DEV)
        )
        n, T_ = C_CHAINS, T_CHAIN_CHECK
        shared = LGSSMTL(
            ssm.P0.expand(n, 2, 2), ssm.Fs[:, :, None].expand(2, 2, n, T_), ssm.Qs[:, :, None].expand(2, 2, n, T_),
            ssm.H.expand(n, 1, 2), ssm.R.expand(n, 1, 1),
        )
        y_b = torch.as_tensor(ys, dtype=torch.float64, device=DEV)
        before = dict(batched.LAUNCHES)
        lml_b = timelast.lml_tl(shared, y_b, strip=True)
        check(batched.LAUNCHES["batched_filter"] == before["batched_filter"] + 1, "lml_tl on batched planes did not launch the batched filter")
        lml_1 = torch.stack([timelast.lml_tl(ssm, y_b[i], strip=True) for i in range(n)])
    rel = float(((lml_b - lml_1).abs() / lml_1.abs()).max())
    print(f"batched lml_tl(strip=True) f64, one Matern32 model and {n} observation vectors T={T_}: vs {n} single calls rel {rel:.2e}")
    check(lml_b.shape == (n,) and rel <= 1e-10, "batched lml_tl vs single calls")
    return model, counts


def hmc_step_s(model, n_steps: int = 3) -> float:
    """Seconds of one HMC step of 10 leapfrog steps over the model's chains
    (host clock, after one step)."""
    log_post, u0 = make_log_posterior(model, CHAIN_PRIORS)
    _, unravel = ravel_positions(u0)
    kernel = make_kernel("hmc", lambda x: log_post(unravel(x)), 0.005, num_leapfrog_steps=10)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 35)
    sample_chains(kernel, u0, log_post, gen, 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sample_chains(kernel, u0, log_post, gen, n_steps)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n_steps


def phase_batched_times(card: str, model, counts) -> list:
    """The two batched kernels and the batched Fisher tail against bound and
    plain version at d = 3, B = 64, T = 65,536 in float32; the batched entry
    points; the same LMLs as a loop of single-series calls; an HMC step; a
    profile of one batched value and gradient."""
    records = []
    t = model.ts
    R = model.noise_variance.detach()
    with torch.no_grad():
        fam, co = model.kernel.transition_coeffs()
        co, P0, H, R, _ = dt.series_inputs(co, model.kernel.get_sde(), R)
        co, P0, H, R = (x.contiguous() for x in (co, P0, H, R))
        dts = dt._dts_from_ts(t)
        Fs, Qs, P0s = dt.build_planes_tl(fam, co, P0, dts)
        ys = batched.series_observations(model.ys, (C_CHAINS, T_BATCHED))
        d, degree = P0.shape[-1], (co.shape[1] - 1) // (P0.shape[-1] ** 2)
        n_obs = C_CHAINS * int((~torch.isnan(model.ys)).sum())
        b, C, _ = batched.batched_strip_filter(Fs, Qs, P0s, H, R, ys)
        g, L = batched.batched_strip_smoother(Fs, Qs, b, C, None, project=False)
        smoother = lambda F_, Q_, b_, C_: batched.batched_strip_smoother(F_, Q_, b_, C_, None, project=False)  # noqa: E731
        smoother_plain = lambda F_, Q_, b_, C_: batched.batched_strip_smoother_plain(F_, Q_, b_, C_, None, project=False)  # noqa: E731
        passes = {
            "batched_filter": (batched.batched_strip_filter, batched.batched_strip_filter_plain, (Fs, Qs, P0s, H, R, ys)),
            "batched_smoother": (smoother, smoother_plain, (Fs, Qs, b, C)),
            "dt_fisher": (dt.dt_fisher, dt.dt_fisher_plain, (fam, co, P0, H, R, dts, model.ys, b, C, g, L)),
        }
        what = f"d={d} B={C_CHAINS} T={T_BATCHED}"
        for name, (kern, plain, args) in passes.items():
            as64 = tuple(a.double() if isinstance(a, torch.Tensor) else a for a in args)
            out_k, out_p, out_t = list(kern(*args)), list(plain(*args)), list(plain(*as64))
            torch.cuda.synchronize()
            err = max(max_abs(a, b_) for a, b_ in zip(out_k, out_p))
            rks = [rel_err(a, c) for a, c in zip(out_k, out_t)]
            rps = [rel_err(a, c) for a, c in zip(out_p, out_t)]
            del out_k, out_p, out_t, as64
            torch.cuda.empty_cache()
            ms = cuda_ms(lambda: kern(*args), reps=10)
            plain_ms = cuda_ms(lambda: plain(*args), reps=3)
            torch.cuda.empty_cache()
            # The chains share one observation vector: ``ys`` is a stride-0 view.
            bound_ms, bound_by = kernel_bound(name, d, degree, T_BATCHED, n_obs, 4, B=C_CHAINS, y_series=1 if ys.stride(0) == 0 else C_CHAINS)
            print(
                f"{name} {what} f32 [{card}]: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms "
                f"({bound_by}); |kernel - plain| {err:.3e}; vs f64 truth kernel {max(rks):.2e} plain {max(rps):.2e}"
            )
            floors = [f32_sum_floor(T_BATCHED)] * 4 + [F32_FLOOR] * 2 if name == "dt_fisher" else [F32_FLOOR] * len(rks)
            for a, b_, floor in zip(rks, rps, floors):
                check(a <= max(F32_FACTOR * b_, floor), f"{name} {what}: f32 kernel {rks} vs plain {rps}")
            measured = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
            if name == "dt_fisher":
                records.append({"at": f"{what} f32", "launches": counts[name], **measured})
            else:
                # No single PyTorch call computes either function.
                records.append({
                    "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
                    "launches": counts[name], "at": f"{what} f32", **measured,
                })
        planes_ms = cuda_ms(lambda: dt.build_planes_tl(fam, co, P0, dts), reps=5)
        sde_ms = cuda_ms(lambda: (model.kernel.transition_coeffs(), model.kernel.get_sde()), reps=5)
        del passes, args, Fs, Qs, b, C, g, L
        torch.cuda.empty_cache()

        torch.cuda.reset_peak_memory_stats()
        lml_ms = cuda_ms(model.log_marginal_likelihood, reps=5)
        lml_peak = torch.cuda.max_memory_allocated() / 2**30
        # The same 64 LMLs as a loop of single-series calls: two passes and a
        # plain prefix each.
        hypers = [v.detach().cpu().numpy() for v in (model.kernel.variance, model.kernel.lengthscales, model.noise_variance)]
        t_np, y_np = t.cpu().numpy(), model.ys.cpu().numpy()
        singles = [chain_model(t_np, y_np, tuple(h[c] for h in hypers), torch.float32) for c in range(C_CHAINS)]
        loop_ms = cuda_ms(lambda: [m.log_marginal_likelihood() for m in singles], reps=2)
        lml_b = model.log_marginal_likelihood()
        lml_s = torch.stack([m.log_marginal_likelihood() for m in singles])
        loop_rel = float(((lml_b - lml_s).abs() / lml_s.abs()).max())
        del singles
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(lambda: chains_value_and_grad(model), reps=5)
    step_peak = torch.cuda.max_memory_allocated() / 2**30
    n_steps = 3
    hmc_s = hmc_step_s(model, n_steps)
    print(f"batched SDE build (transition_coeffs + get_sde) Matern52 C={C_CHAINS} [{card}]: {sde_ms:.3f} ms; plane build (build_planes_tl) {what} f32: {planes_ms:.3f} ms")
    print(f"batched LML C={C_CHAINS} T={T_BATCHED} f32 [{card}]: {lml_ms:.3f} ms (peak {lml_peak:.2f} GiB); the same {C_CHAINS} LMLs as a loop of single-series lml_dt calls: {loop_ms:.3f} ms (values agree to {loop_rel:.2e})")
    print(f"batched log posterior + gradient C={C_CHAINS} T={T_BATCHED} f32 [{card}]: {step_ms:.3f} ms (peak {step_peak:.2f} GiB)")
    print(f"HMC step (10 leapfrog steps, {C_CHAINS} chains, T={T_BATCHED}) f32 [{card}]: {hmc_s:.4f} s a step (host clock, {n_steps} steps, one initial evaluation included)")
    profile_calls(card, f"Matern52 C={C_CHAINS} T={T_BATCHED}", {"batched log posterior + gradient": lambda: chains_value_and_grad(model)})
    return records


def phase_slice():
    """The serving path at full size; returns the f32 model, its numpy data,
    the queries and the launch counts of the path."""
    t_full, y_full = t, y = make_data(N_FULL, SEED)
    rng = np.random.RandomState(SEED + 2)
    queries = [rng.rand(1000) * 1.4 - 0.2 for _ in range(N_REQUESTS)]  # unsorted, some outside [0, 1)
    results = {}
    for dtype in (torch.float32, torch.float64):
        model = StateSpaceGP.from_numpy(t, y, "Matern52", 0.8, 0.4, NOISE, dtype=dtype, device=DEV)
        torch.cuda.synchronize()
        reset_all_launches()
        with torch.no_grad():
            ell = model.log_marginal_likelihood()
            after_lml = dt_launches()
            preds = [model.predict_f(q) for q in queries]
        torch.cuda.synchronize()
        counts = dt_launches()
        tag = str(dtype).replace("torch.", "")
        print(
            f"slice {tag} N={N_FULL}: LML {float(ell):.6f}, launches after LML {after_lml}, after requests {counts}, "
            f"plain prefixes {PREFIX_CALLS[0]}"
        )
        check(PREFIX_CALLS[0] == 0, f"{tag} serving path ran {PREFIX_CALLS[0]} plain prefixes")
        check(bool(torch.isfinite(ell)), f"{tag} LML not finite")
        with torch.no_grad():
            again = model.log_marginal_likelihood()
        check(bool(again == ell), f"{tag} LML differs between two runs ({float(ell)!r} vs {float(again)!r})")
        for mean, var in preds:
            check(mean.shape == (1000, 1) and var.shape == (1000, 1), f"{tag} predict_f shapes")
            check(bool(torch.isfinite(mean).all()), f"{tag} predict_f means not finite")
            check(bool((var > 0).all()), f"{tag} predict_f variances not positive")
        check(after_lml == LML_LAUNCHES, f"{tag} LML launches {after_lml}, expected {LML_LAUNCHES}")
        check(counts == EXPECTED_LAUNCHES, f"{tag} serving-path launches {counts}, expected {EXPECTED_LAUNCHES}")
        results[dtype] = (model, ell, preds, counts)
    (m32, ell32, p32, counts32), (m64, ell64, p64, _) = results[torch.float32], results[torch.float64]
    lml_rel = abs(float(ell32) - float(ell64)) / abs(float(ell64))
    mean_err = max(max_abs(a[0], b[0]) for a, b in zip(p32, p64))
    var_rel = max(rel_err(a[1], b[1]) for a, b in zip(p32, p64))
    print(f"slice f32 vs f64: LML rel {lml_rel:.3e}, mean max abs {mean_err:.3e}, var max rel {var_rel:.3e}")
    del m64, p64, results
    torch.cuda.empty_cache()

    # Reference on a smaller input: the model's kernel path against its plain
    # versions (LML) and against the same model on the CPU (predict_f).
    t, y = make_data(N_CHECK, SEED + 3)
    model = StateSpaceGP.from_numpy(t, y, "Matern52", 0.8, 0.4, NOISE, dtype=torch.float64, device=DEV)
    cpu_model = StateSpaceGP.from_numpy(t, y, "Matern52", 0.8, 0.4, NOISE, dtype=torch.float64, device="cpu")
    with torch.no_grad():
        ell_k = model.log_marginal_likelihood()
        fam, co, sde, dts = dt._model_inputs(model.kernel, model.ts)
        ell_p = dt.strip_filter_dt_plain(fam, co, sde.P0, sde.H, model.noise_variance.reshape(1, 1), dts, model.ys)[2]
        ell_c = cpu_model.log_marginal_likelihood()
        mean_k, var_k = model.predict_f(queries[0])
        mean_c, var_c = cpu_model.predict_f(queries[0])
    lrel = abs(float(ell_k - ell_p)) / abs(float(ell_p))
    print(
        f"check f64 N={N_CHECK}: LML kernel {float(ell_k):.10f} plain {float(ell_p):.10f} cpu {float(ell_c):.10f} "
        f"(rel {lrel:.2e}); predict_f vs cpu: mean {max_abs(mean_k, mean_c):.2e} var {max_abs(var_k, var_c):.2e}"
    )
    check(lrel <= 1e-9, "f64 LML, kernels vs plain")
    check(abs(float(ell_k) - float(ell_c)) <= 1e-9 * abs(float(ell_c)), "f64 LML, card vs CPU")
    check(allclose(mean_k.cpu(), mean_c, 1e-7, 1e-9) and allclose(var_k.cpu(), var_c, 1e-7, 1e-9), "f64 predict_f, card vs CPU")
    return m32, (t_full, y_full), queries, counts32


def rbf_model(t, y, dtype, device=None, order=None):
    opts = {**RBF_MODEL, **({"order": order} if order else {})}
    return StateSpaceGP.from_numpy(t, y, dtype=dtype, device=device or DEV, **opts)


# The strip route of a model's entry points, through the Kalman API on the
# model's planes (kernel.get_ssm_tl): the LML and its gradient by lml_tl
# (strip filter forward, strip smoother and the plain Fisher tail backward),
# prediction by pkfs_from_tl on the merged series, as predict_f merges it.
def strip_lml(model):
    return timelast.lml_tl(model.kernel.get_ssm_tl(model.ts, model.noise_variance.reshape(1, 1)), model.ys, strip=True)


def strip_value_and_grad(model):
    """``value_and_grad`` with the LML on the strip route."""
    model.zero_grad(set_to_none=True)
    loss = -strip_lml(model)
    loss.backward()
    return loss.detach(), torch.stack([p.grad.reshape(()) for p in hyper_params(model)])


@torch.no_grad()
def strip_predict(model, Xnew):
    """``model.predict_f(Xnew)`` with the merged series smoothed on the strip
    route."""
    X = torch.as_tensor(np.asarray(Xnew), dtype=model.ts.dtype, device=model.ts.device)
    order = torch.argsort(X)
    nan = torch.full((X.shape[0],), float("nan"), dtype=model.ys.dtype, device=model.ys.device)
    all_ts, (all_ys,), q_idx = merge_sorted(model.ts, X[order], (model.ys,), (nan,))
    ssm = model.kernel.get_ssm_tl(all_ts, model.noise_variance.reshape(1, 1))
    g, L = timelast.pkfs_from_tl(ssm, all_ys, strip=True, time_first_out=False)
    h, back = ssm.H[0], torch.argsort(order)
    return (h @ g[:, q_idx])[back][:, None], torch.einsum("i,ijm,j->m", h, L[:, :, q_idx], h)[back][:, None]


# The two routes of the RBF(order=6) model's entry points: (LML, predict_f,
# value and gradient, the same step through the plain versions only, the
# counts of the route's kernels and its prefixes' plane scans, and the
# launches of an LML, a predict_f request and a training step).
RBF_ROUTES = {
    "dt": (
        lambda m: m.log_marginal_likelihood(), lambda m, q: m.predict_f(q), value_and_grad, plain_value_and_grad,
        dt_launches, (RBF_LML_LAUNCHES, RBF_PREDICT_LAUNCHES, RBF_STEP_LAUNCHES),
    ),
    "strip": (
        strip_lml, strip_predict, strip_value_and_grad, plain_strip_value_and_grad,
        strip_launches, (STRIP_LML_LAUNCHES, STRIP_ALL_LAUNCHES, STRIP_ALL_LAUNCHES),
    ),
}


def drive_rbf_route(route: str):
    """The RBF(order=6) model at N = N_STRIP float32 on one route
    (RBF_ROUTES): one LML, one predict_f request of 1,000 unsorted queries
    and one training step, each with the launches it requires and none of
    another engine's; the same in float64 beside it; and at N = N_CHECK
    float64 the kernels against the plain path on the card and the same
    model on the CPU.  Returns the float32 model, its queries and the
    route's launch counts."""
    lml, predict, step, plain_step, counter, (want_lml, want_predict, want_step) = RBF_ROUTES[route]
    t, y = make_data(N_STRIP, SEED + 4)
    queries = np.random.RandomState(SEED + 5).rand(1000) * 1.4 - 0.2  # unsorted, some outside [0, 1)
    model = rbf_model(t, y, torch.float32)
    torch.cuda.synchronize()
    counts, plain_prefixes = [], []
    reset_all_launches()
    with torch.no_grad():
        ell = lml(model)
        counts.append(counter())
        plain_prefixes.append(PREFIX_CALLS[0])
        reset_all_launches()
        mean, var = predict(model, queries)
        counts.append(counter())
        plain_prefixes.append(PREFIX_CALLS[0])
    reset_all_launches()
    loss, grad = step(model)
    counts.append(counter())
    plain_prefixes.append(PREFIX_CALLS[0])
    others = {k: v for k, v in all_launches().items() if k not in counts[-1]}
    torch.cuda.synchronize()
    tag = f"rbf {route} route"
    print(
        f"{tag} f32 RBF(order=6) N={N_STRIP} (the model on the {model.engine()[0]} engine): LML {float(ell):.6f}; query "
        f"variance min {float(var.min()):.3e} max {float(var.max()):.3e}; gradient (variance, lengthscale, noise) {grad.tolist()}"
    )
    print(f"  launches: LML {counts[0]}, predict_f {counts[1]}, training step {counts[2]}; plain prefixes {plain_prefixes}")
    for got, want, call in zip(counts, (want_lml, want_predict, want_step), ("LML", "predict_f", "training-step")):
        check(got == want, f"{tag} {call} launches {got}, expected {want}")
    check(not any(others.values()), f"{tag} launched another engine's kernel: {others}")
    check(not any(plain_prefixes), f"{tag}: the LML, predict_f and training step ran {plain_prefixes} plain prefixes")
    check(bool(torch.isfinite(ell)) and bool(loss == -ell), f"{tag} f32 LML not finite, or the loss is not its negative")
    check(mean.shape == (1000, 1) and var.shape == (1000, 1) and bool(torch.isfinite(mean).all()), f"{tag} predict_f means")
    check(bool((var > 0).all()), f"{tag} predict_f variances not positive")
    check(bool(torch.isfinite(grad).all()), f"{tag} f32 gradient not finite")
    model.zero_grad(set_to_none=True)

    m64 = rbf_model(t, y, torch.float64)
    with torch.no_grad():
        ell64 = lml(m64)
        mean64, var64 = predict(m64, queries)
    _, grad64 = step(m64)
    print(
        f"{tag} f32 vs f64 N={N_STRIP}: LML rel {abs(float(ell) - float(ell64)) / abs(float(ell64)):.3e}, mean max abs "
        f"{max_abs(mean, mean64):.3e}, var max rel {rel_err(var, var64):.3e}, var min f64 {float(var64.min()):.3e}; "
        f"f64 gradient {grad64.tolist()}, f32 gradient per component "
        f"{((grad.double() - grad64).abs() / grad64.abs()).tolist()}"
    )
    del m64, mean64, var64
    torch.cuda.empty_cache()

    tc, yc = make_data(N_CHECK, SEED + 6)
    m_k, m_c = rbf_model(tc, yc, torch.float64), rbf_model(tc, yc, torch.float64, device="cpu")
    (loss_k, grad_k), (loss_p, grad_p), (loss_c, grad_c) = step(m_k), plain_step(m_k), step(m_c)
    with torch.no_grad():
        mean_k, var_k = predict(m_k, queries)
        mean_c, var_c = predict(m_c, queries)
    print(
        f"{tag} check f64 N={N_CHECK}: loss kernels {float(loss_k):.10f} plain {float(loss_p):.10f} cpu {float(loss_c):.10f}; "
        f"gradient kernels {grad_k.tolist()} plain {grad_p.tolist()} cpu {grad_c.tolist()}; "
        f"predict_f vs cpu: mean {max_abs(mean_k, mean_c):.2e} var {max_abs(var_k, var_c):.2e}"
    )
    check(abs(float(loss_k - loss_p)) <= 1e-9 * abs(float(loss_p)), f"{tag} f64 LML, kernels vs plain")
    check(abs(float(loss_k) - float(loss_c)) <= 1e-9 * abs(float(loss_c)), f"{tag} f64 LML, card vs CPU")
    check(allclose(grad_k, grad_p, 1e-7, 1e-10), f"{tag} f64 gradient, kernels vs plain")
    check(allclose(grad_k, grad_c, 1e-7, 1e-10), f"{tag} f64 gradient, card vs CPU")
    check(allclose(mean_k.cpu(), mean_c, 1e-7, 1e-9) and allclose(var_k.cpu(), var_c, 1e-7, 1e-9), f"{tag} f64 predict_f, card vs CPU")
    del m_k, m_c
    torch.cuda.empty_cache()
    return model, queries, {k: sum(c[k] for c in counts) for k in counts[0]}


def phase_rbf_slice():
    """The RBF(order=6) model on the dt engine (its spectral family): the
    model's entry points (drive_rbf_route)."""
    model, queries, counts = drive_rbf_route("dt")
    check(model.engine()[0] == "dt", f"the RBF model runs the {model.engine()[0]} engine")
    return model, queries, counts


def phase_strip_slice():
    """The strip path at full width: the RBF(order=6) model's planes through
    the Kalman API (the model itself runs the dt engine, phase_rbf_slice),
    and the Kalman API on an explicit model.  Returns the f32 model, its
    queries, the planes of the explicit model and the launch counts of the
    path."""
    # (a) the RBF(order=6) model's planes: its entry points on the strip route.
    model, queries, counts = drive_rbf_route("strip")

    # (b) the Kalman API on an explicit model: the caller's planes.
    t, y = make_data(N_FULL, SEED)
    kernel = Matern52(0.8, 0.4, dtype=torch.float32, device=DEV)
    planes = strip_inputs(kernel, t, y, torch.float32)
    Fs, Qs, P0, H, R, yt = planes
    ts = torch.as_tensor(t, dtype=torch.float32, device=DEV)
    plane_bytes = Fs.numel() * Fs.element_size() + Qs.numel() * Qs.element_size()
    reset_all_launches()
    with torch.no_grad():
        sms, sPs = pkfs(LGSSMTL(P0, Fs, Qs, H, R), yt, engine="strip")
        api_counts = strip_launches()
        check(PREFIX_CALLS[0] == 0, f"pkfs(engine='strip') ran {PREFIX_CALLS[0]} plain prefixes")
        g_dt, L_dt = dt.pkfs_dt(kernel, ts, R, yt)
        k64 = Matern52(0.8, 0.4, dtype=torch.float64, device=DEV)
        g_t, L_t = dt.pkfs_dt(k64, ts.double(), R.double(), yt.double())
    torch.cuda.synchronize()
    check(api_counts == STRIP_ALL_LAUNCHES, f"pkfs(engine='strip') launches {api_counts}")
    check(sms.shape == (N_FULL, 3) and sPs.shape == (N_FULL, 3, 3), "pkfs output shapes (time first)")
    check(bool(torch.isfinite(sms).all()) and bool(torch.isfinite(sPs).all()), "pkfs(engine='strip') moments not finite")
    g_s, L_s = sms.movedim(0, -1), sPs.movedim(0, -1)
    errs = {"g": (rel_err(g_s, g_t), rel_err(g_dt, g_t)), "L": (rel_err(L_s, L_t), rel_err(L_dt, L_t))}
    print(
        f"kalman API f32 N={N_FULL}: pkfs(Matern52.get_ssm_tl, engine='strip') on {plane_bytes / 1e6:.0f} MB of planes; "
        f"vs pkfs_dt: |g| {max_abs(g_s, g_dt):.3e} |L| {max_abs(L_s, L_dt):.3e}; vs f64 truth (strip / dt): "
        + " ".join(f"{k} {a:.2e}/{b:.2e}" for k, (a, b) in errs.items())
    )
    for k, (a, b) in errs.items():
        check(a <= max(F32_FACTOR * b, F32_FLOOR), f"pkfs strip f32 {k}: strip {a:.3e} vs dt {b:.3e} from f64")
    counts = {k: counts[k] + api_counts[k] for k in counts}
    del sms, sPs, g_s, L_s, g_dt, L_dt, g_t, L_t
    torch.cuda.empty_cache()

    # The same call in f64 at a smaller size against the plain time-last engine.
    tc, yc = make_data(N_CHECK, SEED + 3)
    Fs64, Qs64, P064, H64, R64, y64 = strip_inputs(k64, tc, yc, torch.float64)
    with torch.no_grad():
        ssm64 = LGSSMTL(P064, Fs64, Qs64, H64, R64)
        sms, sPs = pkfs(ssm64, y64, engine="strip")
        ref_m, ref_P = pkfs(ssm64, y64, engine="timelast")
    print(f"kalman API check f64 N={N_CHECK}: strip vs plain time-last |sms| {max_abs(sms, ref_m):.3e} |sPs| {max_abs(sPs, ref_P):.3e}")
    check(allclose(sms, ref_m, 1e-8, 1e-9) and allclose(sPs, ref_P, 1e-8, 1e-9), "pkfs f64, strip vs plain time-last")
    return model, queries, planes, counts


def phase_training(model, data) -> dict:
    """The training path at full size: one step on the serving phase's f32
    model, and the optimisers on the same data from ``TRAIN_START``; returns
    the launch counts of the path."""
    check(all(p.grad is None for p in model.parameters()), "the serving path left gradients behind")
    start = StateSpaceGP.from_numpy(*data, "Matern52", *TRAIN_START, dtype=torch.float32, device=DEV)
    before = [p.detach().clone() for p in start.parameters()]
    torch.cuda.synchronize()
    reset_all_launches()
    loss, grad = value_and_grad(model)
    step_counts = dt_launches()
    fitted, history = fit_adam(start, n_iters=N_ADAM)
    adam_counts = dt_launches()
    lbfgs_fitted, lbfgs_history = fit_lbfgs(start, n_iters=N_LBFGS)
    torch.cuda.synchronize()
    counts = dt_launches()
    print(f"training f32 N={N_FULL}: loss {float(loss):.6f}, gradient (variance, lengthscale, noise) {grad.tolist()}")
    print(
        f"  launches of one step {step_counts}, after {N_ADAM} Adam steps {adam_counts}, after {N_LBFGS} L-BFGS steps {counts}, "
        f"plain prefixes {PREFIX_CALLS[0]}"
    )
    check(PREFIX_CALLS[0] == 0, f"the training path ran {PREFIX_CALLS[0]} plain prefixes")
    check(bool(torch.isfinite(loss)) and bool(torch.isfinite(grad).all()), "f32 loss or gradient not finite")
    check(step_counts == STEP_LAUNCHES, f"one training step launched {step_counts}, expected {STEP_LAUNCHES}")
    want = {k: (1 + N_ADAM) * v for k, v in STEP_LAUNCHES.items()}
    check(adam_counts == want, f"launches after Adam {adam_counts}, expected {want}")
    # Every L-BFGS evaluation is one training step too: the five counts stay
    # equal, two prefixes each, and each of its steps makes at least one.
    check(
        len({counts[k] for k in DT_KERNELS}) == 1 and not any(counts[k] for k in SPECTRAL_KERNELS + COMPOSITE_KERNELS)
        and counts["dt_fisher"] >= 1 + N_ADAM + N_LBFGS and counts["plane_scan"] == 2 * counts["dt_fisher"],
        f"launches after L-BFGS {counts}",
    )
    with torch.no_grad():
        after_adam = fitted.training_loss()
        after_lbfgs = lbfgs_fitted.training_loss()
    print(f"  Adam history {history.tolist()} -> {float(after_adam):.6f}; fitted {fitted.to_numpy()}")
    print(f"  L-BFGS history {lbfgs_history.tolist()} -> {float(after_lbfgs):.6f}; fitted {lbfgs_fitted.to_numpy()}")
    check(history.shape == (N_ADAM,) and history.device.type == "cuda", "Adam history shape or device")
    check(bool(torch.isfinite(history).all()) and bool(torch.isfinite(after_adam)), "Adam history not finite")
    with torch.no_grad():
        check(bool(history[0] == start.training_loss()), "the Adam history does not start at the model's loss")
    check(bool(after_adam < history[0]), f"Adam did not lower the loss: {float(history[0])} -> {float(after_adam)}")
    check(bool(torch.isfinite(lbfgs_history).all()) and bool(after_lbfgs <= lbfgs_history[0]), "L-BFGS raised the loss")
    check(all(torch.equal(p, q) for p, q in zip(start.parameters(), before)), "fitting changed the caller's model")
    del fitted, lbfgs_fitted, start
    loss2, grad2 = value_and_grad(model)
    check(bool(loss2 == loss) and bool((grad2 == grad).all()), f"two identical steps differ: {grad.tolist()} vs {grad2.tolist()}")
    model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()

    # The f32 gradient's distance from the f64 one at this size, beside the
    # plain f32 path's (both are expected to be far: the engines lose digits
    # over 10M steps in f32, whichever way the passes are computed).
    m64 = StateSpaceGP.from_numpy(*data, "Matern52", 0.8, 0.4, NOISE, dtype=torch.float64, device=DEV)
    loss64, grad64 = value_and_grad(m64)
    del m64
    torch.cuda.empty_cache()
    loss_p, grad_p = plain_value_and_grad(model)
    torch.cuda.empty_cache()
    rel_k, rel_p = rel_err(grad, grad64), rel_err(grad_p, grad64)
    print(
        f"training f32 vs f64 N={N_FULL}: f64 gradient {grad64.tolist()}; relative distance of the f32 gradient "
        f"through the kernels {rel_k:.3e} (per component {((grad.double() - grad64).abs() / grad64.abs()).tolist()}), "
        f"through the plain path {rel_p:.3e}; loss rel {abs(float(loss) - float(loss64)) / abs(float(loss64)):.3e}"
    )
    check(rel_k <= max(F32_FACTOR * rel_p, f32_sum_floor(N_FULL)), f"f32 gradient: kernels {rel_k:.3e} vs plain {rel_p:.3e} from f64")

    # Reference on a smaller input, f64: the kernels against the plain path
    # on the card and against the same model on the CPU.
    t, y = make_data(N_CHECK, SEED + 3)
    model = StateSpaceGP.from_numpy(t, y, "Matern52", 0.8, 0.4, NOISE, dtype=torch.float64, device=DEV)
    cpu_model = StateSpaceGP.from_numpy(t, y, "Matern52", 0.8, 0.4, NOISE, dtype=torch.float64, device="cpu")
    (loss_k, grad_k), (loss_p, grad_p), (loss_c, grad_c) = value_and_grad(model), plain_value_and_grad(model), value_and_grad(cpu_model)
    print(
        f"check f64 N={N_CHECK}: gradient kernels {grad_k.tolist()} plain {grad_p.tolist()} cpu {grad_c.tolist()}"
    )
    check(allclose(grad_k, grad_p, 1e-7, 1e-10), "f64 gradient, kernels vs plain")
    check(allclose(grad_k, grad_c, 1e-7, 1e-10), "f64 gradient, card vs CPU")
    check(abs(float(loss_k) - float(loss_c)) <= 1e-9 * abs(float(loss_c)), "f64 loss, card vs CPU")
    return counts


def phase_times(card: str, model, queries, counts) -> list:
    """Kernel vs plain vs bound at N = 10M float32, and the entry points."""
    records = []
    fam, co, sde, dts = dt._model_inputs(model.kernel, model.ts)
    with torch.no_grad():
        co, P0, H = co.detach(), sde.P0.detach(), sde.H.detach()
        R = model.noise_variance.detach().reshape(1, 1)
        y = model.ys
        d = P0.shape[0]

        def f64(*xs):
            return [x.double() for x in xs]

        # Inputs shared by each kernel and its plain version; float64 copies
        # of the same inputs give the truth for the float32 tolerance.
        passes = {}
        tot_f = dt.dt_filter_scan(fam, co, P0, H, R, dts, y)
        pre_f = dt.exclusive_chunk_prefixes(tot_f, d, reverse=False)
        b, C, _ = dt.dt_filter_apply(fam, co, P0, H, R, dts, y, pre_f)
        tot_s = dt.dt_smoother_scan(fam, co, P0, dts, b, C)
        pre_s = dt.exclusive_chunk_prefixes(tot_s, d, reverse=True)
        passes["dt_filter_scan"] = (dt.dt_filter_scan, dt.dt_filter_scan_plain, (fam, co, P0, H, R, dts, y))
        passes["dt_filter_apply"] = (dt.dt_filter_apply, dt.dt_filter_apply_plain, (fam, co, P0, H, R, dts, y, pre_f))
        passes["dt_smoother_scan"] = (dt.dt_smoother_scan, dt.dt_smoother_scan_plain, (fam, co, P0, dts, b, C))
        passes["dt_smoother_apply"] = (dt.dt_smoother_apply, dt.dt_smoother_apply_plain, (fam, co, P0, dts, b, C, pre_s))
        g, L = dt.dt_smoother_apply(fam, co, P0, dts, b, C, pre_s)
        passes["dt_fisher"] = (dt.dt_fisher, dt.dt_fisher_plain, (fam, co, P0, H, R, dts, y, b, C, g, L))
        T, degree = dts.shape[0], (co.numel() - 1) // (d * d)
        n_obs = int((~torch.isnan(y)).sum())

        for name, (kern, plain, args) in passes.items():
            as64 = tuple(a.double() if isinstance(a, torch.Tensor) else a for a in args)
            out_k = kern(*args)
            out_p = plain(*args)
            out_t = plain(*as64)
            torch.cuda.synchronize()
            out_k, out_p, out_t = ([o] if isinstance(o, torch.Tensor) else list(o) for o in (out_k, out_p, out_t))
            err = max(max_abs(a, b) for a, b in zip(out_k, out_p))
            rks = [rel_err(a, c) for a, c in zip(out_k, out_t)]
            rps = [rel_err(a, c) for a, c in zip(out_p, out_t)]
            rk, rp = max(rks), max(rps)
            del out_k, out_p, out_t, as64
            torch.cuda.empty_cache()
            ms = cuda_ms(lambda: kern(*args), reps=10)
            plain_ms = cuda_ms(lambda: plain(*args), reps=3)
            torch.cuda.empty_cache()
            bound_ms, bound_by = kernel_bound(name, d, degree, T, n_obs, y.element_size())
            print(
                f"{name} N={N_FULL} f32 [{card}]: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms "
                f"({bound_by}); |kernel - plain| {err:.3e}; vs f64 truth kernel {rk:.2e} plain {rp:.2e}"
            )
            floors = [f32_sum_floor(T)] * 4 + [F32_FLOOR] * 2 if name == "dt_fisher" else [F32_FLOOR] * len(rks)
            for a, b, floor in zip(rks, rps, floors):
                check(a <= max(F32_FACTOR * b, floor), f"{name}: f32 kernel {rks} vs plain {rps}")
            # No single PyTorch call computes any of these functions.
            records.append({
                "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
                "launches": counts[name], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            })
        # The exclusive prefix between the passes (a plane scan and a shift),
        # beside the plain Kogge–Stone prefix on the card; phase_prefix checks
        # and records it.
        pf_ms = cuda_ms(lambda: dt.exclusive_chunk_prefixes(tot_f, d, reverse=False), reps=5)
        ps_ms = cuda_ms(lambda: dt.exclusive_chunk_prefixes(tot_s, d, reverse=True), reps=5)
        pf_plain = cuda_ms(lambda: strip.exclusive_chunk_prefixes_plain(tot_f, d, reverse=False), reps=5)
        ps_plain = cuda_ms(lambda: strip.exclusive_chunk_prefixes_plain(tot_s, d, reverse=True), reps=5)
        print(
            f"chunk prefixes N={N_FULL} f32 [{card}]: filter {pf_ms:.3f} ms, smoother {ps_ms:.3f} ms (plane scan and shift); "
            f"plain filter {pf_plain:.3f} ms, smoother {ps_plain:.3f} ms"
        )
        del passes, args, tot_f, pre_f, b, C, tot_s, pre_s, g, L
        torch.cuda.empty_cache()

        torch.cuda.reset_peak_memory_stats()
        lml_ms = cuda_ms(model.log_marginal_likelihood, reps=5)
        lml_peak = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        pred_ms = cuda_ms(lambda: model.predict_f(queries[0]), reps=5)
        pred_peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(lambda: value_and_grad(model), reps=5)
    step_peak = torch.cuda.max_memory_allocated() / 2**30
    model.zero_grad(set_to_none=True)
    print(f"LML N={N_FULL} f32 [{card}]: {lml_ms:.3f} ms (peak {lml_peak:.2f} GiB)")
    print(f"predict_f 1000 queries N={N_FULL} f32 [{card}]: {pred_ms:.3f} ms (peak {pred_peak:.2f} GiB)")
    print(f"training step (LML + backward) N={N_FULL} f32 [{card}]: {step_ms:.3f} ms (peak {step_peak:.2f} GiB)")
    return records


# The chunk prefix between the two passes (strip.exclusive_chunk_prefixes: an
# inclusive plane_scan over the packed totals, then a one-column shift).  The
# JAX package computes it as XLA ops (_strip_exclusive_prefixes), not a
# Pallas kernel: its record names that function beside the scan's kernel.
PREFIX_REPLACES = "parallel_gps_tpu/kalman/pallas_scan.py:907"


def check_prefix_case(what: str, d: int, kind: str, x64, x32) -> tuple:
    """The card prefix against ``exclusive_chunk_prefixes_plain`` on ``kind``
    chunk totals (either of ``x64``, ``x32`` may be None): float64 moment
    rows to the strip kernels' tolerances and every row to ROW_RTOL64 of its
    magnitude; float32 moment rows against float64 truth (the plain prefix of
    the same totals in float64) by the 10× rule.  Returns (float64 max
    |moments| difference, largest float32 kernel-over-plain error ratio)."""
    reverse = kind == "smoother"
    worst64 = worst32 = 0.0
    if x64 is not None:
        rf, af, rs, as_ = strip_tolerances(d)
        rtol, atol = (rf, af) if kind == "filter" else (rs, as_)
        with torch.no_grad():
            k, p = strip.exclusive_chunk_prefixes(x64, d, reverse), strip.exclusive_chunk_prefixes_plain(x64, d, reverse)
        torch.cuda.synchronize()
        check(k.shape == x64.shape and bool(torch.isfinite(k).all()), f"prefix {what} f64: shape {tuple(k.shape)} or not finite")
        pairs = list(zip(moment_rows(k, d), moment_rows(p, d)))
        worst64 = max(max_abs(a, b_) for a, b_ in pairs)
        check(all(allclose(a, b_, rtol, atol) for a, b_ in pairs), f"prefix {what} f64 moments")
        check(row_err(k, p) <= ROW_RTOL64, f"prefix {what} f64 rows")
    if x32 is not None:
        with torch.no_grad():
            k = strip.exclusive_chunk_prefixes(x32, d, reverse)
            p = strip.exclusive_chunk_prefixes_plain(x32, d, reverse)
            t = strip.exclusive_chunk_prefixes_plain(x32.double(), d, reverse)
        torch.cuda.synchronize()
        check(k.shape == x32.shape and bool(torch.isfinite(k).all()), f"prefix {what} f32: shape {tuple(k.shape)} or not finite")
        for a, b_, c in zip(moment_rows(k, d), moment_rows(p, d), moment_rows(t, d)):
            ka, pa = rel_err(a, c), rel_err(b_, c)
            worst32 = max(worst32, ka / max(pa, F32_FLOOR / F32_FACTOR))
            check(ka <= max(F32_FACTOR * pa, F32_FLOOR), f"prefix {what} f32: kernel {ka:.3e} vs plain {pa:.3e} from f64")
    return worst64, worst32


def strip_totals(kernel, t, y, dtype) -> dict:
    """{kind: chunk totals} of the strip kernels' pass 1 on the kernel's
    planes (the smoother's on the strip filter's moments)."""
    Fs, Qs, P0, H, R, yt = strip_inputs(kernel, t, y, dtype)
    with torch.no_grad():
        b, C, _ = strip.strip_filter(Fs, Qs, P0, H, R, yt)
        return {"filter": strip.strip_filter_scan(Fs, Qs, P0, H, R, yt), "smoother": strip.strip_smoother_scan(Fs, Qs, b, C)}


def dt_totals(model) -> dict:
    """{kind: chunk totals} of the dt kernels' pass 1 on a model's data, as
    its entry points give them."""
    with torch.no_grad():
        fam, co, sde, dts = dt._model_inputs(model.kernel, model.ts)
        co, P0, H = co.detach(), sde.P0.detach(), sde.H.detach()
        R = model.noise_variance.detach().reshape(1, 1)
        b, C, _ = dt.strip_filter_dt(fam, co, P0, H, R, dts, model.ys)
        return {"filter": dt.dt_filter_scan(fam, co, P0, H, R, dts, model.ys), "smoother": dt.dt_smoother_scan(fam, co, P0, dts, b, C)}


def phase_prefix(card: str, launches: int) -> dict:
    """The chunk prefix on the card against its plain version: at the main
    path's shapes — the Matern52 N = 10M model's totals (156,250 chunks,
    d = 3) and the RBF(order=6) N = 1M model's (15,625, d = 6), float32 and
    float64, both kinds — and at every d = 1..8, float32 and float64, at 1
    and 2 chunks and where the plane scan's tiles have edges
    (plane_edge_lengths), on the strip kernels' totals of the
    PLANE_EDGE_CASES models; then its time at the path's shapes against the
    plain prefix and its bound.  ``launches``: the plane scans of the dt
    path's prefixes.  Returns the kernels-line record."""
    shapes = {}
    for name, d, T, seed in (("Matern52", 3, N_FULL, SEED), ("RBF(order=6)", 6, N_STRIP, SEED + 4)):
        t, y = make_data(T, seed)

        def model(dtype):
            if d == 3:
                return StateSpaceGP.from_numpy(t, y, "Matern52", 0.8, 0.4, NOISE, dtype=dtype, device=DEV)
            return rbf_model(t, y, dtype)

        totals = {dtype: dt_totals(model(dtype)) for dtype in (torch.float64, torch.float32)}
        for kind in plane.KINDS:
            x64, x32 = totals[torch.float64][kind], totals[torch.float32][kind]
            worst64, worst32 = check_prefix_case(f"{name} N={T} {kind}", d, kind, x64, x32)
            print(
                f"prefix {name} N={T} {kind}: {x32.shape[1]} chunks, d={d}: f64 |moments| {worst64:.3e}, "
                f"f32 kernel error over plain f32 error {worst32:.2f} (limit {F32_FACTOR:.0f})"
            )
            shapes[(name, kind)] = (d, x32, worst64)
        del totals, x64
        torch.cuda.empty_cache()

    # Every unit at its tile edges: the strip kernels' totals of a series of
    # 64 steps a chunk, cut to each count of chunks.
    for name, make in PLANE_EDGE_CASES:
        d, n, worst64, worst32 = int(name.split("d=")[1]), 0, 0.0, 0.0
        for dtype in (torch.float64, torch.float32):
            threads, steps = plane.scan_tiling(d, dtype)
            counts = (1, 2) + plane_edge_lengths(threads * steps)[1:]
            t, y = make_data(strip.CHUNK * counts[-1], SEED + 60 + d)
            totals = strip_totals(make(dtype), t, y, dtype)
            for kind in plane.KINDS:
                for m in counts:
                    x = totals[kind][:, -m:] if kind == "smoother" else totals[kind][:, :m]
                    pair = (x.contiguous(), None) if dtype == torch.float64 else (None, x.contiguous())
                    w64, w32 = check_prefix_case(f"{name} {kind} {m} chunks", d, kind, *pair)
                    worst64, worst32, n = max(worst64, w64), max(worst32, w32), n + 1
            del totals
            torch.cuda.empty_cache()
        print(
            f"prefix edges {name}: {n} prefixes at 1, 2 and the tile edges' chunk counts, both kinds, f64 and f32; "
            f"f64 |moments| max {worst64:.3e}, f32 kernel error over plain f32 error at most {worst32:.2f}"
        )
    # The chain's wait is bounded too: with no polls allowed the second tile
    # overruns, and the status read after the launch raises.
    d, x = 3, shapes[("Matern52", "filter")][1]
    max_polls, plane.MAX_POLLS = plane.MAX_POLLS, 0
    try:
        strip.exclusive_chunk_prefixes(x, d, False)
        plane.check_overruns()
    except RuntimeError as err:
        print(f"prefix with MAX_POLLS = 0 raised, as it must: {err}")
    else:
        raise AssertionError("the chunk prefix with MAX_POLLS = 0 did not raise")
    finally:
        plane.MAX_POLLS = max_polls

    # Times at the path's shapes: events around the whole prefix (its host
    # work and the scan's status read included), the device time of one
    # call, the plain prefix, and the bound of reading the totals once and
    # writing the prefixes once.
    out = {}
    for (name, kind), (d, x, worst64) in shapes.items():
        reverse = kind == "smoother"
        with torch.no_grad():
            k, p = strip.exclusive_chunk_prefixes(x, d, reverse), strip.exclusive_chunk_prefixes_plain(x, d, reverse)
            plane.check_overruns()
            look_back = dict(plane.LOOK_BACK)
            again = strip.exclusive_chunk_prefixes(x, d, reverse)
            torch.cuda.synchronize()
            err = max_abs(k, p)
            # The chained scan folds one predecessor a tile, so two calls give
            # the same bits.
            check(torch.equal(k, again), f"prefix {name} {kind}: two calls differ")
            check(look_back["folded"] == look_back["tiles"] - 1, f"prefix {name} {kind}: look-back {look_back}")
            del k, p, again
            ms = cuda_ms(lambda: strip.exclusive_chunk_prefixes(x, d, reverse), reps=10)
            plain_ms = cuda_ms(lambda: strip.exclusive_chunk_prefixes_plain(x, d, reverse), reps=3)
            _, by_name, n_kernels = profile_call(lambda: strip.exclusive_chunk_prefixes(x, d, reverse))
            # For comparison, the same inclusive scan joined by the decoupled
            # look-back (the time-first path's): faster, but its fold, and so
            # its bits, follow the blocks' timing.
            lb_ms = cuda_ms(lambda: plane.plane_scan(x, d, kind, reverse), reps=10)
            _, lb_by_name, _ = profile_call(lambda: plane.plane_scan(x, d, kind, reverse))
            runs = [plane.plane_scan(x, d, kind, reverse) for _ in range(5)]
            lb_same = all(torch.equal(runs[0], r) for r in runs[1:])
            del runs
        plane.check_overruns()
        bound_ms, bound_by = kernel_bound(f"plane_scan_{kind}", d, 0, x.shape[1], 0, x.element_size())
        print(
            f"prefix {name} {kind} {x.shape[1]} chunks d={d} f32 [{card}]: {ms:.4f} ms (events), device "
            f"{sum(by_name.values()):.4f} ms in {n_kernels} kernels {by_name}, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}); |card - plain| {err:.3e}; look-back {look_back}; the scan by the decoupled look-back instead: "
            f"{lb_ms:.4f} ms (events), device {sum(lb_by_name.values()):.4f} ms, five calls bit for bit: {lb_same}"
        )
        out[(name, kind)] = {
            "at": f"{name} {kind} totals, {x.shape[1]} chunks, d={d} f32", "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "device_ms": sum(by_name.values()) if by_name else None, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "f64_max_abs_err": worst64, "look_back_ms": lb_ms,
            "look_back_device_ms": sum(lb_by_name.values()) if lb_by_name else None, "look_back_deterministic": lb_same,
        }
    del shapes
    torch.cuda.empty_cache()
    main_rec = out.pop(("Matern52", "filter"))
    # No single PyTorch call computes this scan.
    return {
        "name": "plane_scan_chunk_prefix", "route": "cuda", "source": SOURCES["plane_scan"], "replaces": REPLACES["plane_scan"],
        "prefix_replaces": PREFIX_REPLACES, "launches": launches, **main_rec, "other_shapes": list(out.values()),
    }


def time_strip_kernels(card: str, what: str, planes) -> dict:
    """Each strip kernel against its plain version and its bound on the given
    (Fs, Qs, P0, H, R, y) planes; {kernel: measurements}."""
    Fs, Qs, P0, H, R, y = planes
    d, T = P0.shape[0], y.shape[0]
    n_obs = int((~torch.isnan(y)).sum())
    out = {}
    with torch.no_grad():
        tot_f = strip.strip_filter_scan(Fs, Qs, P0, H, R, y)
        pre_f = strip.exclusive_chunk_prefixes(tot_f, d, reverse=False)
        b, C, _ = strip.strip_filter_apply(Fs, Qs, P0, H, R, y, pre_f)
        tot_s = strip.strip_smoother_scan(Fs, Qs, b, C)
        pre_s = strip.exclusive_chunk_prefixes(tot_s, d, reverse=True)
        passes = {
            "strip_filter_scan": (strip.strip_filter_scan, strip.strip_filter_scan_plain, (Fs, Qs, P0, H, R, y)),
            "strip_filter_apply": (strip.strip_filter_apply, strip.strip_filter_apply_plain, (Fs, Qs, P0, H, R, y, pre_f)),
            "strip_smoother_scan": (strip.strip_smoother_scan, strip.strip_smoother_scan_plain, (Fs, Qs, b, C)),
            "strip_smoother_apply": (strip.strip_smoother_apply, strip.strip_smoother_apply_plain, (Fs, Qs, b, C, pre_s)),
        }
        for name, (kern, plain, args) in passes.items():
            out_k, out_p = kern(*args), plain(*args)
            out_t = plain(*(a.double() for a in args))
            torch.cuda.synchronize()
            out_k, out_p, out_t = ([o] if isinstance(o, torch.Tensor) else list(o) for o in (out_k, out_p, out_t))
            err = max(max_abs(a, b_) for a, b_ in zip(out_k, out_p))
            rks = [rel_err(a, c) for a, c in zip(out_k, out_t)]
            rps = [rel_err(a, c) for a, c in zip(out_p, out_t)]
            del out_k, out_p, out_t
            torch.cuda.empty_cache()
            ms = cuda_ms(lambda: kern(*args), reps=10)
            plain_ms = cuda_ms(lambda: plain(*args), reps=3)
            torch.cuda.empty_cache()
            bound_ms, bound_by = kernel_bound(name, d, 0, T, n_obs, y.element_size())
            print(
                f"{name} {what} f32 [{card}]: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms "
                f"({bound_by}); |kernel - plain| {err:.3e}; vs f64 truth kernel {max(rks):.2e} plain {max(rps):.2e}"
            )
            for a, b_ in zip(rks, rps):
                check(a <= max(F32_FACTOR * b_, F32_FLOOR), f"{name} {what}: f32 kernel {rks} vs plain {rps}")
            out[name] = {
                "at": f"{what} f32", "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None,
            }
        pf_ms = cuda_ms(lambda: strip.exclusive_chunk_prefixes(tot_f, d, reverse=False), reps=5)
        ps_ms = cuda_ms(lambda: strip.exclusive_chunk_prefixes(tot_s, d, reverse=True), reps=5)
        print(f"chunk prefixes {what} f32 [{card}]: filter {pf_ms:.3f} ms, smoother {ps_ms:.3f} ms ({tot_f.shape[1]} totals)")
    return out


def phase_strip_times(card: str, model, planes, counts) -> list:
    """The strip kernels at the two shapes the strip path gives them — the
    RBF(order=6) model's planes (d = 6, N = 1M) and the explicit Matern52
    model's (d = 3, N = 10M) — and pkfs on the explicit model (the RBF
    model's entry points on the strip route are timed by phase_rbf_routes)."""
    at_d3 = time_strip_kernels(card, f"d=3 N={N_FULL}", planes)
    del planes
    torch.cuda.empty_cache()
    R = model.noise_variance.detach().reshape(1, 1)
    with torch.no_grad():
        ssm = model.kernel.get_ssm_tl(model.ts, R)
        rbf_planes = (ssm.Fs.contiguous(), ssm.Qs.contiguous(), ssm.P0, ssm.H, ssm.R, model.ys)
    del ssm
    plane_mb = 2 * rbf_planes[0].numel() * rbf_planes[0].element_size() / 1e6
    at_d6 = time_strip_kernels(card, f"d=6 N={N_STRIP}", rbf_planes)
    # No single PyTorch call computes any of these functions.
    records = [
        {"name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name], "launches": counts[name],
         **at_d6[name], "other_shapes": [at_d3[name]]}
        for name in STRIP_KERNELS
    ]

    kernel = Matern52(0.8, 0.4, dtype=torch.float32, device=DEV)
    with torch.no_grad():
        t_full, y_full = (torch.as_tensor(x, dtype=torch.float32, device=DEV) for x in make_data(N_FULL, SEED))
        ssm = kernel.get_ssm_tl(t_full, R)
        torch.cuda.reset_peak_memory_stats()
        api_ms = cuda_ms(lambda: pkfs(ssm, y_full, engine="strip"), reps=5)
        api_peak = torch.cuda.max_memory_allocated() / 2**30
        api_dt_ms = cuda_ms(lambda: dt.pkfs_dt(kernel, t_full, R, y_full), reps=5)
        build_ms = cuda_ms(lambda: kernel.get_ssm_tl(t_full, R), reps=3)
        del ssm
        torch.cuda.empty_cache()
        planes_ms = cuda_ms(lambda: model.kernel.get_ssm_tl(model.ts, R), reps=3)
    print(
        f"pkfs(engine='strip') Matern52 N={N_FULL} f32 [{card}]: {api_ms:.3f} ms on given planes (peak {api_peak:.2f} GiB, "
        f"planes included); building the planes (get_ssm_tl) {build_ms:.3f} ms; pkfs_dt on the same data {api_dt_ms:.3f} ms"
    )
    print(f"RBF(order=6) planes N={N_STRIP} f32: {plane_mb:.0f} MB (F and Q); get_ssm_tl {planes_ms:.3f} ms")
    return records


def spectral_passes(model, suffix="_spectral"):
    """{kernel: (wrapper, plain version, arguments)} of the five dt kernels
    of the model's table family (``suffix`` "_spectral" or "_composite") on
    ``model``'s inputs, no autograd: each pass on the outputs of the kernels
    before it."""
    fam, co, sde, dts = dt._model_inputs(model.kernel, model.ts)
    co, P0, H = co.detach(), sde.P0.detach(), sde.H.detach()
    R = model.noise_variance.detach().reshape(1, 1)
    y, d = model.ys, P0.shape[0]
    tot_f = dt.dt_filter_scan(fam, co, P0, H, R, dts, y)
    pre_f = dt.exclusive_chunk_prefixes(tot_f, d, reverse=False)
    b, C, _ = dt.dt_filter_apply(fam, co, P0, H, R, dts, y, pre_f)
    pre_s = dt.exclusive_chunk_prefixes(dt.dt_smoother_scan(fam, co, P0, dts, b, C), d, reverse=True)
    g, L = dt.dt_smoother_apply(fam, co, P0, dts, b, C, pre_s)
    return {
        f"dt_filter_scan{suffix}": (dt.dt_filter_scan, dt.dt_filter_scan_plain, (fam, co, P0, H, R, dts, y)),
        f"dt_filter_apply{suffix}": (dt.dt_filter_apply, dt.dt_filter_apply_plain, (fam, co, P0, H, R, dts, y, pre_f)),
        f"dt_smoother_scan{suffix}": (dt.dt_smoother_scan, dt.dt_smoother_scan_plain, (fam, co, P0, dts, b, C)),
        f"dt_smoother_apply{suffix}": (dt.dt_smoother_apply, dt.dt_smoother_apply_plain, (fam, co, P0, dts, b, C, pre_s)),
        f"dt_fisher{suffix}": (dt.dt_fisher, dt.dt_fisher_plain, (fam, co, P0, H, R, dts, y, b, C, g, L)),
    }


ENTRY_ORDERS = tuple(range(4, dt.MAX_KERNEL_D[SPECTRAL] + 1))  # the RBF orders of the dt-versus-strip table


def phase_rbf_times(card: str, model, queries, counts) -> list:
    """The spectral dt kernels on the RBF(order=6) model at N = N_STRIP
    float32 — each against its plain version, float64 truth and its bound —
    and every unit, d = 1..8, on RBF(order=d) models of the same data
    (events, beside its bound); then the model's three entry points on the dt
    route beside the same entry points on the strip route (the Kalman API on
    the model's planes), events and the profiler's device time, at every
    order in ENTRY_ORDERS.  Returns the spectral kernels' records."""
    records = []
    T = model.ts.shape[0]
    n_obs = int((~torch.isnan(model.ys)).sum())
    with torch.no_grad():
        passes = spectral_passes(model)
        for name, (kern, plain, args) in passes.items():
            as64 = tuple(a.double() if isinstance(a, torch.Tensor) else a for a in args)
            out_k, out_p, out_t = kern(*args), plain(*args), plain(*as64)
            torch.cuda.synchronize()
            out_k, out_p, out_t = ([o] if isinstance(o, torch.Tensor) else list(o) for o in (out_k, out_p, out_t))
            err = max(max_abs(a, b) for a, b in zip(out_k, out_p))
            rks = [rel_err(a, c) for a, c in zip(out_k, out_t)]
            rps = [rel_err(a, c) for a, c in zip(out_p, out_t)]
            del out_k, out_p, out_t, as64
            torch.cuda.empty_cache()
            ms = cuda_ms(lambda: kern(*args), reps=10)
            plain_ms = cuda_ms(lambda: plain(*args), reps=3)
            torch.cuda.empty_cache()
            bound_ms, bound_by = kernel_bound(name, 6, 0, T, n_obs, 4)
            print(
                f"{name} RBF(order=6) N={T} f32 [{card}]: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms "
                f"({bound_by}); |kernel - plain| {err:.3e}; vs f64 truth kernel {max(rks):.2e} plain {max(rps):.2e}"
            )
            floors = [f32_sum_floor(T)] * 4 + [F32_FLOOR] * 2 if name == "dt_fisher_spectral" else [F32_FLOOR] * len(rks)
            for a, b, floor in zip(rks, rps, floors):
                check(a <= max(F32_FACTOR * b, floor), f"{name}: f32 kernel {rks} vs plain {rps}")
            # No single PyTorch call computes any of these functions.
            records.append({
                "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
                "launches": counts[name], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None, "at": f"RBF(order=6) N={T} f32",
                "units": [],
            })
        del passes
        torch.cuda.empty_cache()
        # Every unit at this length: its kernels on RBF(order=d) of the same data.
        t_np, y_np = model.ts.double().cpu().numpy(), model.ys.double().cpu().numpy()
        for d in SPECTRAL_DIMS:
            passes = spectral_passes(rbf_model(t_np, y_np, torch.float32, order=d))
            line = []
            for rec in records:
                kern, _, args = passes[rec["name"]]
                ms = cuda_ms(lambda: kern(*args), reps=5)
                bound_ms, bound_by = kernel_bound(rec["name"], d, 0, T, n_obs, 4)
                rec["units"].append({"d": d, "ms": ms, "bound_ms": bound_ms, "bound_by": bound_by})
                line.append(f"{rec['name'].removesuffix('_spectral')} {ms:.3f} (bound {bound_ms:.3f})")
            print(f"spectral units d={d} N={T} f32 [{card}], ms: " + ", ".join(line))
            del passes
            torch.cuda.empty_cache()
    phase_rbf_routes(card, t_np, y_np, queries)
    return records


def phase_rbf_routes(card: str, t, y, queries) -> None:
    """The RBF(order=k) model's LML, one predict_f request and one training
    step on the dt route (the model's entry points) and on the strip route
    (strip_lml, strip_predict, strip_value_and_grad), k in ENTRY_ORDERS,
    float32: events (cuda_ms, median of 5) and the device time of one
    profiled call (profile_call)."""
    for order in ENTRY_ORDERS:
        m = rbf_model(t, y, torch.float32, order=order)
        routes = {
            "dt": {"LML": m.log_marginal_likelihood, "predict_f": lambda: m.predict_f(queries), "training step": lambda: value_and_grad(m)},
            "strip": {"LML": lambda: strip_lml(m), "predict_f": lambda: strip_predict(m, queries), "training step": lambda: strip_value_and_grad(m)},
        }
        for route, calls in routes.items():
            for call, fn in calls.items():
                grad = call == "training step"
                with torch.set_grad_enabled(grad):
                    ms = cuda_ms(fn, reps=5)
                    _, by_name, _ = profile_call(fn)
                device = sum(by_name.values()) if by_name else float("nan")
                ours = {k: round(v, 3) for k, v in by_name.items() if k != "torch kernels and copies"}
                print(
                    f"RBF(order={order}) N={len(t)} f32 {route} route {call} [{card}]: {ms:.3f} ms events, device {device:.3f} ms "
                    f"(torch {by_name.get('torch kernels and copies', float('nan')):.3f}; {ours})"
                )
        m.zero_grad(set_to_none=True)
        del m, routes
        torch.cuda.empty_cache()


def qp_model(t, y, dtype, device=None):
    return StateSpaceGP.from_numpy(t, y, QP_SPEC, noise_variance=NOISE, dtype=dtype, device=device or DEV)


@torch.no_grad()
def plain_predict(model, Xnew):
    """``model.predict_f(Xnew)`` of a dt-engine model with the merged series
    filtered and smoothed by the plain versions only, on the model's
    device."""
    X = torch.as_tensor(np.asarray(Xnew), dtype=model.ts.dtype, device=model.ts.device)
    order = torch.argsort(X)
    nan = torch.full((X.shape[0],), float("nan"), dtype=model.ys.dtype, device=model.ys.device)
    all_ts, (all_ys,), q_idx = merge_sorted(model.ts, X[order], (model.ys,), (nan,))
    fam, co, sde, dts = dt._model_inputs(model.kernel, all_ts)
    R = model.noise_variance.reshape(1, 1)
    b, C, _ = dt.strip_filter_dt_plain(fam, co, sde.P0, sde.H, R, dts, all_ys)
    g, L = dt.strip_smoother_dt_plain(fam, co, sde.P0, dts, b, C)
    h, back = sde.H[0], torch.argsort(order)
    return (h @ g[:, q_idx])[back][:, None], torch.einsum("i,ijm,j->m", h, L[:, :, q_idx], h)[back][:, None]


def phase_qp_slice():
    """The quasi-periodic model (QP_SPEC) at N = N_QP float32 on the dt
    engine, the composite family: one LML, one predict_f request of 1,000
    unsorted queries and one training step, each with the launches it
    requires and none of another family's or engine's, no plain prefix, two
    identical steps bit for bit; each result against float64 truth (the
    same model in float64 on the kernels) by the 10× rule beside the plain
    float32 path; and at N = T_KERNEL float64 the kernels against the plain
    path on the card and the same model on the CPU.  Returns the float32
    model, its queries and the path's launch counts."""
    t, y = make_data(N_QP, SEED + 9)
    queries = np.random.RandomState(SEED + 10).rand(1000) * 1.4 - 0.2  # unsorted, some outside [0, 1)
    model = qp_model(t, y, torch.float32)
    check(model.engine()[0] == "dt" and model.engine()[1][0] == COMPOSITE, f"the QP model runs the {model.engine()[0]} engine")
    torch.cuda.synchronize()
    counts, plain_prefixes = [], []
    reset_all_launches()
    with torch.no_grad():
        ell = model.log_marginal_likelihood()
        counts.append(dt_launches())
        plain_prefixes.append(PREFIX_CALLS[0])
        reset_all_launches()
        mean, var = model.predict_f(queries)
        counts.append(dt_launches())
        plain_prefixes.append(PREFIX_CALLS[0])
    reset_all_launches()
    loss, grad = value_and_grad(model)
    counts.append(dt_launches())
    plain_prefixes.append(PREFIX_CALLS[0])
    others = {k: v for k, v in all_launches().items() if k not in counts[-1]}
    loss2, grad2 = value_and_grad(model)
    torch.cuda.synchronize()
    tag = f"QP {QP_SPEC[1][0][0]}(order=1) x Matern32 d=8 N={N_QP}"
    print(
        f"{tag} f32: LML {float(ell):.6f}; query variance min {float(var.min()):.3e} max {float(var.max()):.3e}; "
        f"gradient (Periodic variance, lengthscale, period, Matern32 variance, lengthscale, noise) {grad.tolist()}"
    )
    print(f"  launches: LML {counts[0]}, predict_f {counts[1]}, training step {counts[2]}; plain prefixes {plain_prefixes}")
    for got, want, call in zip(counts, (QP_LML_LAUNCHES, QP_PREDICT_LAUNCHES, QP_STEP_LAUNCHES), ("LML", "predict_f", "training-step")):
        check(got == want, f"{tag} {call} launches {got}, expected {want}")
    check(not any(others.values()), f"{tag} launched another engine's kernel: {others}")
    check(not any(plain_prefixes), f"{tag}: the LML, predict_f and training step ran {plain_prefixes} plain prefixes")
    check(bool(torch.isfinite(ell)) and bool(loss == -ell), f"{tag} f32 LML not finite, or the loss is not its negative")
    check(mean.shape == (1000, 1) and var.shape == (1000, 1), f"{tag} predict_f shapes")
    check(bool(torch.isfinite(mean).all()) and bool(torch.isfinite(var).all()), f"{tag} predict_f not finite")
    check(bool(torch.isfinite(grad).all()), f"{tag} f32 gradient not finite")
    check(bool(loss2 == loss) and bool((grad2 == grad).all()), f"{tag}: two identical steps differ")

    # Float64 truth on the kernels, the plain float32 path beside the kernels.
    m64 = qp_model(t, y, torch.float64)
    with torch.no_grad():
        ell64 = m64.log_marginal_likelihood()
        mean64, var64 = m64.predict_f(queries)
    _, grad64 = value_and_grad(m64)
    del m64
    torch.cuda.empty_cache()
    loss_p, grad_p = plain_value_and_grad(model)
    mean_p, var_p = plain_predict(model, queries)
    model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()
    ell64 = float(ell64)
    errs = {
        "LML": (abs(float(ell) - ell64) / abs(ell64), abs(-float(loss_p) - ell64) / abs(ell64), F32_FLOOR),
        "mean": (rel_err(mean, mean64), rel_err(mean_p, mean64), F32_FLOOR),
        "var": (rel_err(var, var64), rel_err(var_p, var64), F32_FLOOR),
        "gradient": (rel_err(grad, grad64), rel_err(grad_p, grad64), f32_sum_floor(N_QP)),
    }
    print(
        f"{tag} f32 vs f64 truth (kernels / plain f32): " + ", ".join(f"{k} {a:.3e} / {b:.3e}" for k, (a, b, _) in errs.items())
        + f"; f64 LML {ell64:.6f}, f64 gradient {grad64.tolist()}; query variance min: kernels f32 {float(var.min()):.3e}, "
        f"plain f32 {float(var_p.min()):.3e}, f64 {float(var64.min()):.3e}"
    )
    # In float32 the posterior variance of 1M points under this smooth kernel
    # is below the rounding of P − E·Pp·Eᵀ: both float32 paths may return
    # small negative variances, which the 10× rule bounds; float64's are
    # positive.
    check(bool((var64 > 0).all()), f"{tag} f64 predict_f variances not positive")
    for k, (a, b, floor) in errs.items():
        check(a <= max(F32_FACTOR * b, floor), f"{tag} f32 {k}: kernels {a:.3e} vs plain {b:.3e} from f64")

    tc, yc = make_data(T_KERNEL, SEED + 11)
    m_k, m_c = qp_model(tc, yc, torch.float64), qp_model(tc, yc, torch.float64, device="cpu")
    (loss_k, grad_k), (loss_p, grad_p), (loss_c, grad_c) = value_and_grad(m_k), plain_value_and_grad(m_k), value_and_grad(m_c)
    with torch.no_grad():
        mean_k, var_k = m_k.predict_f(queries)
        mean_c, var_c = m_c.predict_f(queries)
    print(
        f"{tag} check f64 N={T_KERNEL}: loss kernels {float(loss_k):.10f} plain {float(loss_p):.10f} cpu {float(loss_c):.10f}; "
        f"gradient kernels {grad_k.tolist()} plain {grad_p.tolist()} cpu {grad_c.tolist()}; "
        f"predict_f vs cpu: mean {max_abs(mean_k, mean_c):.2e} var {max_abs(var_k, var_c):.2e}"
    )
    check(abs(float(loss_k - loss_p)) <= 1e-9 * abs(float(loss_p)), f"{tag} f64 LML, kernels vs plain")
    check(abs(float(loss_k) - float(loss_c)) <= 1e-9 * abs(float(loss_c)), f"{tag} f64 LML, card vs CPU")
    check(allclose(grad_k, grad_p, 1e-7, 1e-10), f"{tag} f64 gradient, kernels vs plain")
    check(allclose(grad_k, grad_c, 1e-7, 1e-10), f"{tag} f64 gradient, card vs CPU")
    check(allclose(mean_k.cpu(), mean_c, 1e-7, 1e-9) and allclose(var_k.cpu(), var_c, 1e-7, 1e-9), f"{tag} f64 predict_f, card vs CPU")
    del m_k, m_c
    torch.cuda.empty_cache()
    return model, queries, {k: sum(c[k] for c in counts) for k in counts[0]}


def qp_prefix_precision(card: str) -> None:
    """The chained chunk prefix of the composite family in float32, on the
    QP model's chunk totals at N = N_QP, filter and smoother: the inclusive
    plane scan of the float32 totals (the chained kernel), the plain
    Kogge–Stone scan of them and the float64 kernel scan of them rounded to
    float32, each against the float64 scan of the same totals; for the
    filter also the plain models of the kernel's association
    (plane.chained_plain_scan, the kernel's tile) with C and J mirrored from
    the upper triangle (the kernel's combine before the repair: it lost
    every digit here) and averaged (the kernel's now), and the sequential
    fold, the reference's association (a tile of one, mirrored).  The
    largest error of the moment components (the filter's b, C; the
    smoother's g, L) over the chunks, relative to each component's largest
    value.  Both float32 kernel prefixes are held within 10× of the plain
    float32 scan's distance: the composite family's route, as every other
    family's (strip.exclusive_chunk_prefixes)."""
    t, y = make_data(N_QP, SEED + 9)
    m = qp_model(t, y, torch.float32)
    d = 8
    with torch.no_grad():
        fam, co, sde, dts = dt._model_inputs(m.kernel, m.ts)
        co, P0, H, R = co.detach(), sde.P0.detach(), sde.H.detach(), m.noise_variance.detach().reshape(1, 1)
        tot_f = dt.dt_filter_scan(fam, co, P0, H, R, dts, m.ys)
        b, C, _ = dt.dt_filter_apply(fam, co, P0, H, R, dts, m.ys, dt.exclusive_chunk_prefixes(tot_f, d, reverse=False))
        tot_s = dt.dt_smoother_scan(fam, co, P0, dts, b, C)
        del b, C
        for kind, tot, rows in (("filter", tot_f, slice(d * d, 2 * d * d + d)), ("smoother", tot_s, slice(d * d, 2 * d * d + d))):
            # A filter prefix that holds chunk 0 has A = J = η = 0 exactly;
            # a smoother suffix's E is a product of gains: b, C and g, L carry it.
            rev = kind == "smoother"
            truth = plane.plane_scan_plain(tot.double(), d, kind, rev)
            scans = {
                "kernel f32": plane.plane_scan(tot, d, kind, rev, chained=True),
                "plain f32": plane.plane_scan_plain(tot, d, kind, rev),
                "kernel f64 of the f32 totals": plane.plane_scan(tot.double(), d, kind, rev, chained=True).float(),
            }
            if kind == "filter":
                threads, steps = plane.scan_tiling(d, torch.float32)
                for form in ("mirrored", "averaged"):
                    scans[f"chained plain f32, {form}"] = plane.chained_plain_scan(tot, d, threads * steps, form)
                scans["sequential fold f32, mirrored"] = plane.chained_plain_scan(tot.cpu(), d, 1, "mirrored")
            scale = truth[rows].abs().amax(1, keepdim=True).clamp_min(1e-300)
            errs = {k: float(((v[rows].to(truth).double() - truth[rows]).abs() / scale).max()) for k, v in scans.items()}
            print(f"QP chunk prefix {kind} N={N_QP} ({tot.shape[1]} chunks) [{card}], moments vs the f64 scan of the same f32 "
                  "totals: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
            check(errs["kernel f32"] <= F32_FACTOR * max(errs["plain f32"], F32_FLOOR), f"QP chunk prefix {kind}: {errs}")
            del truth, scans
    del m, tot_f, tot_s
    torch.cuda.empty_cache()


def phase_qp_times(card: str, model, queries, counts) -> list:
    """The composite dt kernels on the QP model at N = N_QP float32 — each
    against its plain version, float64 truth and its bound (this run's plan
    and observed steps), as events and as device time in a profile — and
    every composite unit d = 2..8 (COMPOSITE_CASES) on the same data,
    float32 and float64 (what the float64 units' spills cost); then
    the model's three entry points (events, profile).  Returns the
    composite kernels' records."""
    records = []
    T = model.ts.shape[0]
    n_obs = int((~torch.isnan(model.ys)).sum())
    plan = model.kernel.transition_coeffs()[0].plan
    with torch.no_grad():
        passes = spectral_passes(model, "_composite")
        for name, (kern, plain, args) in passes.items():
            as64 = tuple(a.double() if isinstance(a, torch.Tensor) else a for a in args)
            out_k, out_p, out_t = kern(*args), plain(*args), plain(*as64)
            torch.cuda.synchronize()
            out_k, out_p, out_t = ([o] if isinstance(o, torch.Tensor) else list(o) for o in (out_k, out_p, out_t))
            err = max(max_abs(a, b) for a, b in zip(out_k, out_p))
            rks = [rel_err(a, c) for a, c in zip(out_k, out_t)]
            rps = [rel_err(a, c) for a, c in zip(out_p, out_t)]
            del out_k, out_p, out_t, as64
            torch.cuda.empty_cache()
            ms = cuda_ms(lambda: kern(*args), reps=10)
            _, by_name, _ = profile_call(lambda: kern(*args))
            device_ms = by_name.get(name, None)
            plain_ms = cuda_ms(lambda: plain(*args), reps=3)
            torch.cuda.empty_cache()
            bound_ms, bound_by = kernel_bound(name, 8, 0, T, n_obs, 4, plan=plan)
            print(
                f"{name} QP d=8 N={T} f32 [{card}]: kernel {ms:.3f} ms (device {device_ms}), plain {plain_ms:.3f} ms, "
                f"bound {bound_ms:.4f} ms ({bound_by}); |kernel - plain| {err:.3e}; vs f64 truth kernel {max(rks):.2e} plain {max(rps):.2e}"
            )
            floors = [f32_sum_floor(T)] * 4 + [F32_FLOOR] * 2 if name == "dt_fisher_composite" else [F32_FLOOR] * len(rks)
            for a, b, floor in zip(rks, rps, floors):
                check(a <= max(F32_FACTOR * b, floor), f"{name}: f32 kernel {rks} vs plain {rps}")
            # No single PyTorch call computes any of these functions.
            records.append({
                "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
                "launches": counts[name], "max_abs_err": err, "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None, "at": f"QP d=8 N={T} f32", "units": [],
            })
        del passes
        torch.cuda.empty_cache()
        t_np, y_np = model.ts.double().cpu().numpy(), model.ys.double().cpu().numpy()
        for d, make in COMPOSITE_CASES.items():
            for dtype in (torch.float32, torch.float64):
                kern_d = make(dtype)
                m = StateSpaceGP.create((t_np, y_np), kern_d, NOISE, dtype=dtype, device=DEV)
                passes = spectral_passes(m, "_composite")
                plan_d = kern_d.transition_coeffs()[0].plan
                size = torch.finfo(dtype).bits // 8
                line = []
                for rec in records:
                    kern, _, args = passes[rec["name"]]
                    ms = cuda_ms(lambda: kern(*args), reps=5 if dtype == torch.float32 else 3)
                    bound_ms, bound_by = kernel_bound(rec["name"], d, 0, T, n_obs, size, plan=plan_d)
                    if dtype == torch.float32:
                        rec["units"].append({"d": d, "case": repr(kern_d), "ms": ms, "bound_ms": bound_ms, "bound_by": bound_by})
                    else:
                        rec["units"][-1].update(ms_f64=ms, bound_ms_f64=bound_ms)
                    line.append(f"{rec['name'].removesuffix('_composite')} {ms:.3f} (bound {bound_ms:.4f})")
                print(f"composite units d={d} {kern_d!r} N={T} {dtype} [{card}], ms: " + ", ".join(line))
                del passes, m
                torch.cuda.empty_cache()
        lml_ms = cuda_ms(model.log_marginal_likelihood, reps=5)
        pred_ms = cuda_ms(lambda: model.predict_f(queries), reps=5)
    step_ms = cuda_ms(lambda: value_and_grad(model), reps=5)
    model.zero_grad(set_to_none=True)
    print(f"QP d=8 N={T} f32 [{card}]: LML {lml_ms:.3f} ms, predict_f 1000 queries {pred_ms:.3f} ms, training step {step_ms:.3f} ms (events)")
    return records


def phase_sequential_time(card: str) -> None:
    """The sequential oracle's time per step on the card (a Python loop over
    time; kalman/sequential.py), at a length it is meant for."""
    from parallel_gps_torch.kalman.sequential import kfs

    T = 4096
    t, y = make_data(T, SEED + 7)
    with torch.no_grad():
        for make in (lambda: Matern52(0.8, 0.4, dtype=torch.float32, device=DEV), lambda: RBF(0.8, 0.05, order=6, dtype=torch.float32, device=DEV)):
            k = make()
            ssm = k.get_ssm(torch.as_tensor(t, dtype=torch.float32, device=DEV), torch.full((1, 1), NOISE, device=DEV))
            yt = torch.as_tensor(y, dtype=torch.float32, device=DEV)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sms, _ = kfs(ssm, yt)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            check(bool(torch.isfinite(sms).all()), "sequential kfs moments not finite")
            print(f"sequential kfs d={k.state_dim} T={T} f32 [{card}]: {1e3 * wall:.1f} ms, {1e6 * wall / T:.1f} us per step (filter + smoother)")


def phase_profile(card: str, what: str, model, queries) -> None:
    """Device time by kernel and the device's idle share for one call of each
    entry point of ``model`` (torch.profiler; the wall is the host-clock
    median of five unprofiled calls, each ended by a synchronise)."""

    def lml():
        with torch.no_grad():
            model.log_marginal_likelihood()

    profile_calls(card, what, {"LML": lml, "predict_f": lambda: model.predict_f(queries), "training step": lambda: value_and_grad(model)})
    model.zero_grad(set_to_none=True)


def profile_call(fn):
    """(wall ms, {kernel: device ms}, kernels) of one call: the wall is the
    host-clock median of five unprofiled calls after one, each ended by a
    synchronise; the device times come from torch.profiler over one more
    call, this package's kernels by name and the rest together.  An empty
    dict: the profiler recorded no device events."""
    from torch.profiler import ProfilerActivity, profile

    walls = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name, n_kernels = {}, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ours = re.search(r"pgt::(\w+?)_kernel", e.name)
            key = ours.group(1) if ours else "torch kernels and copies"
            by_name[key] = by_name.get(key, 0.0) + e.time_range.elapsed_us() / 1e3
            n_kernels += 1
    return float(np.median(walls[1:])), by_name, n_kernels


def profile_calls(card: str, what: str, calls: dict) -> None:
    """``phase_profile`` for the given {name: call}."""
    for call, fn in calls.items():
        wall, by_name, n_kernels = profile_call(fn)
        if not by_name:
            print(f"profile {call} {what}: the profiler recorded no device events; device time not measured")
            continue
        busy = sum(by_name.values())
        parts = ", ".join(f"{k} {v:.3f}" for k, v in sorted(by_name.items(), key=lambda kv: -kv[1]))
        print(
            f"profile {call} {what} f32 [{card}]: wall {wall:.3f} ms, device {busy:.3f} ms in {n_kernels} kernels "
            f"({parts}), idle share {max(0.0, 1.0 - busy / wall):.3f}"
        )


def phase_probe_kernels() -> None:
    """Each probe kernel against its plain version at T = 65,537, float32 and
    float64: the plain versions sum in the kernels' order, so every result
    must be the plain version's bits."""
    for dtype in (torch.float32, torch.float64):
        tag = f"T={T_KERNEL} {str(dtype).split('.')[-1]}"
        src = probe_common.rows(12, T_KERNEL, dtype, torch.device(DEV), SEED + 40)
        outs = {f"copy_chunk K={K}": (probe_dma.copy_chunk(src, K), src) for K in probe_dma.CHUNKS}
        outs["copy_coalesced"] = (probe_dma.copy_coalesced(src), src)
        n_tiles = T_KERNEL // 1024
        blocked = src[:, : n_tiles * 1024].reshape(12, n_tiles, 1024).transpose(0, 1).contiguous()
        outs["copy_blocked tile=1024"] = (probe_dma.copy_blocked(blocked), blocked)
        ssm, y = probe_attrib.make_model(T_KERNEL, dtype, torch.device(DEV), SEED + 41)
        for name, coalesced in (("read_chunk", False), ("read_coalesced", True)):
            outs[name] = (probe_attrib.read(ssm.Fs, ssm.Qs, y, coalesced=coalesced), probe_attrib.read_plain(ssm.Fs, ssm.Qs, y, coalesced=coalesced))
        x3 = probe_common.rows(22, T_KERNEL, dtype, torch.device(DEV), SEED + 42)
        for tile in probe_grid.TILES:
            n = probe_grid.n_tiles(T_KERNEL, tile)
            outs[f"tile_noop tile={tile}"] = (probe_grid.tile_noop(torch.zeros(n, dtype=dtype, device=DEV)), torch.ones(n, dtype=dtype, device=DEV))
            for r in (3, 22):
                xr = x3[:r].contiguous()
                outs[f"tile_stream rows={r} tile={tile}"] = (probe_grid.tile_stream(xr, tile), probe_grid.stream_plain(xr, tile))
            xr = x3[:3].contiguous()
            for part, a, b_ in zip(("rows", "sums"), probe_grid.tile_outwrite(xr, tile), probe_grid.outwrite_plain(xr, tile)):
                outs[f"tile_outwrite {part} tile={tile}"] = (a, b_)
            for part, a, b_ in zip(("sums", "carry"), probe_grid.tile_carry(x3[0], tile), probe_grid.carry_plain(x3[0], tile)):
                outs[f"tile_carry {part} tile={tile}"] = (a, b_)
        torch.cuda.synchronize()
        worst = max((max_abs(a, b_), what) for what, (a, b_) in outs.items())
        print(f"probe kernels vs plain {tag}: {len(outs)} results, largest |kernel - plain| {worst[0]:.3e} ({worst[1]})")
        for what, (a, b_) in outs.items():
            check(a.shape == b_.shape and torch.equal(a, b_), f"probe {what} {tag}: kernel differs from its plain version")


def phase_probes(card: str) -> list:
    """The probe programs at full size through their command lines, with the
    probe kernels' launches counted from zero; one kernel record each."""
    probe_common.reset_launch_counts()
    runs = {
        "dma": probe_dma.main([]),
        "attrib": probe_attrib.main([]),
        "grid": probe_grid.main([]),
    }
    counts = dict(probe_common.LAUNCHES)
    print(f"launches: probes {counts}")
    for name, n in counts.items():
        check(n > 0, f"probe kernel {name} was never launched by the probe programs")
    for name, recs in runs.items():
        check(all(r["card"] == card for r in recs), f"probe {name}: records name another card")
        check(all(r.get("max_abs_err", 0.0) == 0.0 for r in recs), f"probe {name}: a kernel differs from its plain version")
    dma_recs, attrib_recs, grid_recs = runs["dma"], runs["attrib"], runs["grid"]

    def pick(recs, **want):
        return [r for r in recs if all(r.get(k) == v for k, v in want.items())]

    # {kernel: (the record on the kernels line, the other shapes it ran at)}
    chosen = {
        "copy_chunk": (pick(dma_recs, bench="copy_chunk", rows=12, K=strip.CHUNK), pick(dma_recs, bench="copy_chunk")),
        "copy_coalesced": (pick(dma_recs, bench="copy_coalesced", rows=12), pick(dma_recs, bench="copy_coalesced")),
        "copy_blocked": (pick(dma_recs, bench="copy_blocked", rows=12, tile=1024), pick(dma_recs, bench="copy_blocked")),
        "read_chunk": (pick(attrib_recs, bench="read_chunk"), []),
        "read_coalesced": (pick(attrib_recs, bench="read_coalesced"), []),
        "tile_noop": (pick(grid_recs, bench="noop", tile=1024), pick(grid_recs, bench="noop")),
        "tile_stream": (pick(grid_recs, bench="stream22", tile=1024), pick(grid_recs, bench="stream22") + pick(grid_recs, bench="stream3")),
        "tile_outwrite": (pick(grid_recs, bench="outwrite12", tile=1024), pick(grid_recs, bench="outwrite12")),
        "tile_carry": (pick(grid_recs, bench="carry33", tile=1024), pick(grid_recs, bench="carry33")),
    }
    shape_keys = ("bench", "rows", "K", "tile", "ms", "bound_ms", "library_ms")
    records = []
    for name, (main_rec, others) in chosen.items():
        check(len(main_rec) == 1, f"probe {name}: no single record at the chosen shape")
        r = main_rec[0]
        records.append({
            "name": f"probe_{name}", "route": "cuda", "source": SOURCES[f"probe_{name}"], "replaces": REPLACES[f"probe_{name}"],
            "launches": counts[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": "bytes", "library_ms": r["library_ms"],
            "at": " ".join(f"{k}={r[k]}" for k in ("bench", "rows", "K", "tile", "T") if k in r) + f" {r['dtype']}",
            "other_shapes": [{k: o[k] for k in shape_keys if k in o} for o in others if o is not r],
        })
        print(
            f"probe {name} {records[-1]['at']} [{card}]: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
            f"bound {r['bound_ms']:.3f} ms, library {r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 3)} ms"
        )
    return records


# --------------------------------------------------------------------------
# The time-first fused path: pkf / pks / pkfs on an LGSSM, engine="strip"
# --------------------------------------------------------------------------

# Launches of the path: one scan a pass, one transpose a layout move.
PKF_LAUNCHES = {"plane_scan": 1, "plane_transpose": 4}  # Fs, Qs in; b, C out
PKS_LAUNCHES = {"plane_scan": 1, "plane_transpose": 6}  # Fs, Qs, ms, Ps in; g, L out
PKFS_LAUNCHES = {"plane_scan": 2, "plane_transpose": 4}  # Fs, Qs in; g, L out (b, C stay time-last)
PLAIN_CALLS = {"plane_scan_plain": 0, "plane_transpose_plain": 0}
# A sanity bound for the element rows that are not moments (A, J, η; E): the
# kernel and the plain scan fold in different orders, so each row is held to
# its own magnitude.
ROW_RTOL64 = 1e-6


def count_plain_plane_calls() -> None:
    """Count every call of the two plain versions (the wrappers look them up
    by their module's name)."""
    for name in PLAIN_CALLS:
        plain = getattr(plane, name)

        def counting(*args, _plain=plain, _name=name, **kwargs):
            PLAIN_CALLS[_name] += 1
            return _plain(*args, **kwargs)

        setattr(plane, name, counting)


def plane_rows(make, t, y, dtype):
    """Packed filtering rows of the kernel's model, smoothing rows from the
    plain filter's moments, and the state dimension, on the card."""
    Fs, Qs, P0, H, R, yt = strip_inputs(make(dtype), t, y, dtype)
    T = Fs.shape[-1]
    with torch.no_grad():
        filt = strip._pack(timelast._filtering_elements_from_planes(P0, Fs, Qs, H, R, yt), T)
        b, C = timelast.pkf_from_tl(LGSSMTL(P0, Fs, Qs, H, R), yt)
        smooth = strip._pack(timelast._smoothing_elements_from_planes(Fs, Qs, b, C), T)
    return filt, smooth, P0.shape[0]


def moment_rows(x, d: int):
    """The moment rows of packed rows: (b, C) of a filter, (g, L) of a
    smoother."""
    d2 = d * d
    return x[d2 : d2 + d], x[d2 + d : 2 * d2 + d]


def row_err(a, b_) -> float:
    """max over rows of max |a − b| / max |b| in the row."""
    a, b_ = a.double(), b_.double()
    return float(((a - b_).abs().amax(1) / b_.abs().amax(1).clamp_min(1e-300)).max())


def check_plane_case(what: str, d: int, rows64: dict, rows32: dict | None) -> None:
    """The plane scan against its plain version: float64 moments to the
    tolerances of the strip kernels, every row to ROW_RTOL64 of its
    magnitude; float32 moments against float64 truth by the 10× rule."""
    rf, af, rs, as_ = strip_tolerances(d)
    for (kind, reverse), x in rows64.items():
        rtol, atol = (rf, af) if kind == "filter" else (rs, as_)
        with torch.no_grad():
            k, p = plane.plane_scan(x, d, kind, reverse), plane.plane_scan_plain(x, d, kind, reverse)
        torch.cuda.synchronize()
        errs = [max_abs(a, b_) for a, b_ in zip(moment_rows(k, d), moment_rows(p, d))]
        print(f"plane_scan {what} {kind}{' reverse' if reverse else ''} f64: |moments| {max(errs):.3e}, rows {row_err(k, p):.2e}")
        check(all(allclose(a, b_, rtol, atol) for a, b_ in zip(moment_rows(k, d), moment_rows(p, d))), f"plane_scan {what} {kind} f64 moments")
        check(row_err(k, p) <= ROW_RTOL64 and bool(torch.isfinite(k).all()), f"plane_scan {what} {kind} f64 rows")
        if rows32 is None or (kind, reverse) not in rows32:
            continue
        x32 = rows32[(kind, reverse)]
        with torch.no_grad():
            k32, p32 = plane.plane_scan(x32, d, kind, reverse), plane.plane_scan_plain(x32, d, kind, reverse)
        torch.cuda.synchronize()
        errs = [(rel_err(a, c), rel_err(b_, c)) for a, b_, c in zip(moment_rows(k32, d), moment_rows(p32, d), moment_rows(p, d))]
        print(f"plane_scan {what} {kind} f32 vs f64 truth (kernel / plain f32): " + " ".join(f"{a:.2e}/{b_:.2e}" for a, b_ in errs))
        for a, b_ in errs:
            check(a <= max(F32_FACTOR * b_, F32_FLOOR), f"plane_scan {what} {kind} f32: kernel {a:.3e} vs plain {b_:.3e}")


def phase_plane_kernels() -> None:
    """Both plane kernels against their plain versions on the card."""
    t, y = make_data(T_KERNEL, SEED + 50)
    for name, make in STRIP_CASES:
        filt64, smooth64, d = plane_rows(make, t, y, torch.float64)
        filt32, smooth32, _ = plane_rows(make, t, y, torch.float32)
        rows32 = {("filter", False): filt32, ("smoother", True): smooth32}
        rows64 = {("filter", False): filt64, ("smoother", True): smooth64}
        if d == 3:  # the directions the path does not take
            rows64.update({("filter", True): filt64, ("smoother", False): smooth64})
        check_plane_case(f"{name} T={T_KERNEL}", d, rows64, rows32)
        del filt64, smooth64, filt32, smooth32
    check_plane_edges()
    # The look-back's spin is bounded: with no polls allowed every tile after
    # the first overruns, and the status read after the launch raises
    # instead of the kernel hanging; in a unit of each look-back (d = 3
    # filter rows: the warp's; d = 6: one thread's).
    for name, make in (STRIP_CASES[2], STRIP_CASES[4]):
        filt, _, d = plane_rows(make, t, y, torch.float32)
        max_polls, plane.MAX_POLLS = plane.MAX_POLLS, 0
        try:
            plane.plane_scan(filt, d, "filter")
            plane.check_overruns()
        except RuntimeError as err:
            print(f"plane_scan {name} with MAX_POLLS = 0 raised, as it must: {err}")
        else:
            raise AssertionError(f"plane_scan {name} with MAX_POLLS = 0 did not raise")
        finally:
            plane.MAX_POLLS = max_polls
        del filt
    check_transpose_edges()


# The plane scan at every state dimension: STRIP_CASES and the two RBF
# orders between them.
PLANE_EDGE_CASES = sorted(
    STRIP_CASES + [
        ("RBF d=5", lambda dtype: RBF(1.0, 0.05, order=5, dtype=dtype, device=DEV)),
        ("RBF d=7", lambda dtype: RBF(1.0, 0.05, order=7, dtype=dtype, device=DEV)),
    ],
    key=lambda case: int(case[0].split("d=")[1]),
)


def plane_edge_lengths(tile: int) -> tuple:
    """Where a scan of tiles of ``tile`` steps has its edges: one step, a tile
    less one, one tile, one step more, and 33 tiles and a step, where a
    tile's look-back reaches past a window of 32 predecessors unless it finds
    an inclusive total first."""
    return (1, tile - 1, tile, tile + 1, 33 * tile + 1)


def check_plane_edges() -> None:
    """plane_scan against plane_scan_plain at every d = 1..8, both kinds and
    both directions, at plane_edge_lengths of the kernel's tile at that d
    and dtype: float64 moments to the strip kernels' tolerances and every
    row to ROW_RTOL64 of its magnitude, float32 moments against float64
    truth by the 10× rule."""
    t, y = make_data(33 * 4 * 128 + 1, SEED + 52)
    directions = [(kind, reverse) for kind in plane.KINDS for reverse in (False, True)]
    for name, make in PLANE_EDGE_CASES:
        worst64, worst32, n, tiles = 0.0, 0.0, 0, {}
        for dtype in (torch.float64, torch.float32):
            threads, steps = plane.scan_tiling(int(name.split("d=")[1]), dtype)
            tiles[dtype] = threads * steps
            longest = plane_edge_lengths(tiles[dtype])[-1]
            filt64, smooth64, d = plane_rows(make, t[:longest], y[:longest], torch.float64)
            filt32, smooth32, _ = plane_rows(make, t[:longest], y[:longest], torch.float32)
            rf, af, rs, as_ = strip_tolerances(d)
            for T in plane_edge_lengths(tiles[dtype]):
                for kind, reverse in directions:
                    x64 = (filt64 if kind == "filter" else smooth64)[:, :T].contiguous()
                    what = f"plane_scan {name} {kind}{' reverse' if reverse else ''} T={T}"
                    with torch.no_grad():
                        p64 = plane.plane_scan_plain(x64, d, kind, reverse)
                        if dtype == torch.float64:
                            k = plane.plane_scan(x64, d, kind, reverse)
                        else:
                            x32 = (filt32 if kind == "filter" else smooth32)[:, :T].contiguous()
                            k, p32 = plane.plane_scan(x32, d, kind, reverse), plane.plane_scan_plain(x32, d, kind, reverse)
                    torch.cuda.synchronize()
                    n += 1
                    check(bool(torch.isfinite(k).all()), f"{what} {dtype}: not finite")
                    if dtype == torch.float64:
                        rtol, atol = (rf, af) if kind == "filter" else (rs, as_)
                        pairs = list(zip(moment_rows(k, d), moment_rows(p64, d)))
                        worst64 = max([worst64] + [max_abs(a, b_) for a, b_ in pairs])
                        check(all(allclose(a, b_, rtol, atol) for a, b_ in pairs), f"{what} f64 moments")
                        check(row_err(k, p64) <= ROW_RTOL64, f"{what} f64 rows")
                    else:
                        for a, b_, c in zip(moment_rows(k, d), moment_rows(p32, d), moment_rows(p64, d)):
                            ka, pa = rel_err(a, c), rel_err(b_, c)
                            worst32 = max(worst32, ka / max(pa, F32_FLOOR / F32_FACTOR))
                            check(ka <= max(F32_FACTOR * pa, F32_FLOOR), f"{what} f32: kernel {ka:.3e} vs plain {pa:.3e}")
            del filt64, smooth64, filt32, smooth32
        print(
            f"plane_scan edges {name}: {n} scans (tiles of {tiles[torch.float32]} steps f32, {tiles[torch.float64]} f64; "
            f"both kinds and directions); f64 |moments| max {worst64:.3e}, "
            f"f32 kernel error over plain f32 error at most {worst32:.2f} (limit {F32_FACTOR:.0f})"
        )


# Widths of the transpose's checks: every d and d² of the plane path up to
# d = 8 that shapes its narrow path differently, and 65, the wide tiles.
TRANSPOSE_WIDTHS = (1, 2, 3, 4, 9, 16, 33, 36, 49, 64, 65)


def check_transpose_edges() -> None:
    """plane_transpose bit for bit against x.t().contiguous(), both
    directions, float32 and float64: each width of TRANSPOSE_WIDTHS at T = 1,
    L − 1, L, L + 1 (L the block's run at that width; the tile edge on the
    wide path) and T_KERNEL, and an input whose storage starts one value
    past an aligned address (the path without 16-byte accesses)."""
    gen = torch.Generator(device=DEV).manual_seed(SEED + 51)
    n = 0
    for dtype in (torch.float32, torch.float64):
        for w in TRANSPOSE_WIDTHS:
            L = plane.transpose_run(w, T_KERNEL, dtype) or 32
            for T in (1, L - 1, L, L + 1, T_KERNEL):
                for offset in (0, 1) if T in (L, T_KERNEL) else (0,):
                    buf = torch.randn(w * T + offset, dtype=dtype, device=DEV, generator=gen)
                    x = buf[offset:].view(w, T)
                    xt = plane.plane_transpose(x)
                    back = plane.plane_transpose(xt)
                    torch.cuda.synchronize()
                    what = f"plane_transpose w={w} T={T} {dtype} storage offset {offset}"
                    check(x.is_contiguous() and x.storage_offset() == offset, f"{what}: input not as meant")
                    check(torch.equal(xt, x.t().contiguous()) and torch.equal(back, x), what)
                    n += 2
    print(
        f"plane_transpose f32 and f64, w in {TRANSPOSE_WIDTHS}, T in (1, L-1, L, L+1, {T_KERNEL}), both directions, "
        f"aligned and one value off at T = L and {T_KERNEL}: {n} launches equal to x.t().contiguous()"
    )


def phase_plane_slice():
    """The time-first path at full width on configuration (i)'s data, with
    the launch counts it requires and no plain version; returns the launch
    counts and what the times phase needs."""
    t, y = make_data(N_FULL, SEED)
    kernel = Matern52(0.8, 0.4, dtype=torch.float32, device=DEV)
    with torch.no_grad():
        R = torch.full((1, 1), NOISE, dtype=torch.float32, device=DEV)
        ts, yt = (torch.as_tensor(x, dtype=torch.float32, device=DEV) for x in (t, y))
        views = kernel.get_ssm(ts, R)
        # A caller's own time-first arrays (numpy's, or a JAX model's carried
        # across) are contiguous (T, d, d); get_ssm returns time-first views
        # of time-last memory, driven below.
        ssm = LGSSM(views.P0, views.Fs.contiguous(), views.Qs.contiguous(), views.H, views.R)
    torch.cuda.synchronize()
    count_plain_plane_calls()
    counts = {}
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    plane.reset_launch_counts()
    with torch.no_grad():
        fms, fPs, ell = pkf(ssm, yt, True, engine="strip")
        counts["pkf"] = dict(plane.LAUNCHES)
        plane.reset_launch_counts()
        sms_a, sPs_a = pks(ssm, fms, fPs, engine="strip")
        counts["pks"] = dict(plane.LAUNCHES)
        plane.reset_launch_counts()
        sms, sPs = pkfs(ssm, yt, engine="strip")
        counts["pkfs"] = dict(plane.LAUNCHES)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    others = {k: v for k, v in all_launches().items() if k not in PLANE_KERNELS}
    print(f"plane slice f32 Matern52 N={N_FULL}: LML {float(ell):.6f}; launches {counts}; other kernels {others}; plain calls {PLAIN_CALLS}; peak {peak:.2f} GiB")
    check(counts == {"pkf": PKF_LAUNCHES, "pks": PKS_LAUNCHES, "pkfs": PKFS_LAUNCHES}, f"plane path launches {counts}")
    check(not any(others.values()) and PREFIX_CALLS[0] == 0, f"the plane path launched another engine's kernel: {others}")
    check(not any(PLAIN_CALLS.values()), f"the plane path called a plain version: {PLAIN_CALLS}")
    check(fms.shape == (N_FULL, 3) and fPs.shape == (N_FULL, 3, 3) and sms.shape == (N_FULL, 3) and sPs.shape == (N_FULL, 3, 3), "plane path shapes (time first)")
    check(all(bool(torch.isfinite(x).all()) for x in (fms, fPs, sms, sPs, sms_a, sPs_a)) and bool(torch.isfinite(ell)), "plane path moments not finite")
    print(f"  pks on pkf's moments vs pkfs: |sms| {max_abs(sms_a, sms):.3e} |sPs| {max_abs(sPs_a, sPs):.3e}")
    del sms_a, sPs_a
    # get_ssm's Fs lies time-last in memory and moves without a launch; its
    # Qs is contiguous time first and is transposed.
    time_last = [x.movedim(0, -1).is_contiguous() for x in (views.Fs, views.Qs)]
    want = {"plane_scan": 2, "plane_transpose": PKFS_LAUNCHES["plane_transpose"] - sum(time_last)}
    plane.reset_launch_counts()
    with torch.no_grad():
        sms_v, sPs_v = pkfs(views, yt, engine="strip")
    torch.cuda.synchronize()
    counts_v = dict(plane.LAUNCHES)
    print(
        f"  pkfs on get_ssm's views (Fs, Qs time-last in memory: {time_last}): launches {counts_v}; "
        f"vs the contiguous model |sms| {max_abs(sms_v, sms):.3e} |sPs| {max_abs(sPs_v, sPs):.3e}"
    )
    check(any(time_last) and counts_v == want and not any(PLAIN_CALLS.values()), f"pkfs on views launched {counts_v}, expected {want}")
    check(bool(torch.isfinite(sms_v).all()) and bool(torch.isfinite(sPs_v).all()), "pkfs on views: moments not finite")
    del sms_v, sPs_v, views

    # Against pkfs(LGSSMTL, "strip") on the same model and float64 truth.
    with torch.no_grad():
        ssm_tl = kernel.get_ssm_tl(ts, R)
        b_s, C_s, ell_s = strip.strip_filter(ssm_tl.Fs, ssm_tl.Qs, ssm_tl.P0, ssm_tl.H, ssm_tl.R, yt)
        g_s, L_s = strip.strip_smoother(ssm_tl.Fs, ssm_tl.Qs, b_s, C_s)
        del ssm_tl
        fam, co, P0d, Hd, Rd, dts, yd = engine_inputs(Matern52, (0.8, 0.4), t, y, torch.float64)
        b_t, C_t, ell_t = dt.strip_filter_dt(fam, co, P0d, Hd, Rd, dts, yd)
        g_t, L_t = dt.strip_smoother_dt(fam, co, P0d, dts, b_t, C_t)
        del dts, yd
    torch.cuda.synchronize()
    errs = {
        "fms": (rel_err(fms.t(), b_t), rel_err(b_s, b_t)),
        "fPs": (rel_err(fPs.movedim(0, -1), C_t), rel_err(C_s, C_t)),
        "ell": (abs(float(ell) - float(ell_t)) / abs(float(ell_t)), abs(float(ell_s) - float(ell_t)) / abs(float(ell_t))),
        "sms": (rel_err(sms.t(), g_t), rel_err(g_s, g_t)),
        "sPs": (rel_err(sPs.movedim(0, -1), L_t), rel_err(L_s, L_t)),
    }
    print(f"plane slice f32 vs f64 truth (plane / strip LGSSMTL): " + " ".join(f"{k} {a:.2e}/{b_:.2e}" for k, (a, b_) in errs.items()))
    for k, (a, b_) in errs.items():
        check(a <= max(F32_FACTOR * b_, F32_FLOOR), f"plane path f32 {k}: {a:.3e} vs strip {b_:.3e} from f64")
    del fms, fPs, sms, sPs, b_s, C_s, g_s, L_s, b_t, C_t, g_t, L_t
    torch.cuda.empty_cache()

    # float64 at N_CHECK against the plain time-last engine on the card.
    tc, yc = make_data(N_CHECK, SEED + 3)
    with torch.no_grad():
        k64 = Matern52(0.8, 0.4, dtype=torch.float64, device=DEV)
        ssm64 = k64.get_ssm(torch.as_tensor(tc, device=DEV), torch.full((1, 1), NOISE, dtype=torch.float64, device=DEV))
        y64 = torch.as_tensor(yc, device=DEV)
        f_p, f_r = pkf(ssm64, y64, True, engine="strip"), pkf(ssm64, y64, True, engine="timelast")
        s_p, s_r = pkfs(ssm64, y64, engine="strip"), pkfs(ssm64, y64, engine="timelast")
        s_q = pks(ssm64, f_p[0], f_p[1], engine="strip")
    torch.cuda.synchronize()
    print(
        f"plane check f64 N={N_CHECK} vs timelast: |fms| {max_abs(f_p[0], f_r[0]):.3e} |fPs| {max_abs(f_p[1], f_r[1]):.3e} "
        f"ell {float(f_p[2]):.10f} vs {float(f_r[2]):.10f}; |sms| {max_abs(s_p[0], s_r[0]):.3e} |sPs| {max_abs(s_p[1], s_r[1]):.3e}"
    )
    check(all(allclose(a, b_, 1e-9, 1e-10) for a, b_ in zip(f_p[:2], f_r[:2])), "plane pkf f64 vs timelast")
    check(abs(float(f_p[2] - f_r[2])) <= 1e-10 * abs(float(f_r[2])), "plane pkf f64 LML vs timelast")
    check(all(allclose(a, b_, 1e-8, 1e-9) for a, b_ in zip(s_p + s_q, s_r + s_r)), "plane pkfs / pks f64 vs timelast")
    return {k: sum(c[k] for c in counts.values()) for k in PLANE_KERNELS}, (kernel, ts, R, yt, ssm)


def phase_plane_times(card: str, counts: dict, inputs) -> list:
    """Both plane kernels at the path's shapes (N = 10M, d = 3, float32)
    against bound, plain version and x.t().contiguous() — the transpose in
    its three moves, Fs in, covariances out and means out; pkfs end to end
    beside pkfs(LGSSMTL, "strip") and pkfs_dt; a profile of pkfs."""
    kernel, ts, R, yt, ssm = inputs
    T, d = N_FULL, 3
    with torch.no_grad():
        planes = timelast.time_last_planes(ssm)
        filt = strip._pack(timelast.make_filtering_elements_tl(ssm, yt, planes), T)
        b, C = moment_rows(plane.plane_scan(filt, d, "filter"), d)
        smooth = strip._pack(timelast._smoothing_elements_from_planes(*planes, b, C.reshape(d, d, T)), T)
        means = b.clone()  # (3, T): the filtered means, moved out as (T, 3) by pkf
        del b, C
    out = {}
    for kind, x in (("filter", filt), ("smoother", smooth)):
        reverse = kind == "smoother"
        with torch.no_grad():
            k, p = plane.plane_scan(x, d, kind, reverse), plane.plane_scan_plain(x, d, kind, reverse)
            plane.check_overruns()
            err, look_back = max_abs(k, p), dict(plane.LOOK_BACK)
            truth = [m.clone() for m in moment_rows(plane.plane_scan_plain(x.double(), d, kind, reverse), d)]
            errs = [(rel_err(a, c), rel_err(b_, c)) for a, b_, c in zip(moment_rows(k, d), moment_rows(p, d), truth)]
            del k, p, truth
            torch.cuda.empty_cache()
        print(f"plane_scan {kind} d=3 N={T} f32 vs f64 truth (kernel / plain f32): " + " ".join(f"{a:.2e}/{b_:.2e}" for a, b_ in errs))
        for a, b_ in errs:
            check(a <= max(F32_FACTOR * b_, F32_FLOOR), f"plane_scan {kind} d=3 N={T} f32: kernel {a:.3e} vs plain {b_:.3e} from f64")
        with torch.no_grad():
            ms = cuda_ms(lambda: plane.plane_scan(x, d, kind, reverse), reps=10)
            plain_ms = cuda_ms(lambda: plane.plane_scan_plain(x, d, kind, reverse), reps=3)
        torch.cuda.empty_cache()
        bound_ms, bound_by = kernel_bound(f"plane_scan_{kind}", d, 0, T, 0, x.element_size())
        folds = look_back["folded"] / max(look_back["tiles"], 1)
        print(
            f"plane_scan {kind} d=3 N={T} f32 [{card}]: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms "
            f"({bound_by}); |kernel - plain| {err:.3e}; look-back {look_back['folded']} predecessors folded over "
            f"{look_back['tiles']} tiles of {look_back['steps']} steps ({folds:.2f} a tile)"
        )
        out[kind] = {
            "at": f"{kind} rows d=3 N={T} f32", "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "look_back_folds_per_tile": folds, "tile_steps": look_back["steps"],
        }
    del filt, smooth
    torch.cuda.empty_cache()
    tr = {}
    moves = (
        ("(T, 9) -> (9, T), Fs in", ssm.Fs.reshape(T, d * d)),
        ("(9, T) -> (T, 9), C out", planes[0].reshape(d * d, T)),
        ("(3, T) -> (T, 3), means out", means),
    )
    for what, x in moves:
        check(x.is_contiguous(), f"plane_transpose {what}: input not contiguous")
        with torch.no_grad():
            k, p = plane.plane_transpose(x), plane.plane_transpose_plain(x)
            torch.cuda.synchronize()
            check(torch.equal(k, p), f"plane_transpose {what} N={T}: not equal to x.t().contiguous()")
            err = max_abs(k, p)
            del k, p
            # Device time: each call queued behind a held stream, so that the
            # wrapper's host work (tens of µs against a 0.1 ms kernel) is not
            # timed; then events around the lone call, the host's share in.
            held = {
                name: probe_common.cuda_ms(fn, x.device, reps=20)
                for name, fn in (
                    ("ms", lambda: plane.plane_transpose(x)),
                    ("plain_ms", lambda: plane.plane_transpose_plain(x)),
                    ("library_ms", lambda: x.t().contiguous()),
                )
            }
            lone = {"kernel": cuda_ms(lambda: plane.plane_transpose(x), reps=10), "library": cuda_ms(lambda: x.t().contiguous(), reps=10)}
        bound_ms, bound_by = kernel_bound("plane_transpose", d, 0, T, 0, x.element_size(), rows=min(x.shape))
        print(
            f"plane_transpose {what} N={T} f32 [{card}]: kernel {held['ms']:.4f} ms, plain {held['plain_ms']:.4f} ms, "
            f"x.t().contiguous() {held['library_ms']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); events around a lone "
            f"call: kernel {lone['kernel']:.4f} ms, x.t().contiguous() {lone['library']:.4f} ms"
        )
        tr[what] = {
            "at": f"{what} N={T} f32", "max_abs_err": err, **held, "bound_ms": bound_ms, "bound_by": bound_by,
            "lone_call_ms": lone,
        }
    del planes, moves, means
    torch.cuda.empty_cache()

    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        plane_ms = cuda_ms(lambda: pkfs(ssm, yt, engine="strip"), reps=5)
        plane_peak = torch.cuda.max_memory_allocated() / 2**30
        pkf_ms = cuda_ms(lambda: pkf(ssm, yt, True, engine="strip"), reps=5)
        views = kernel.get_ssm(ts, R)
        views_ms = cuda_ms(lambda: pkfs(views, yt, engine="strip"), reps=5)
        del views
        ssm_tl = kernel.get_ssm_tl(ts, R)
        strip_ms = cuda_ms(lambda: pkfs(ssm_tl, yt, engine="strip"), reps=5)
        dt_ms = cuda_ms(lambda: dt.pkfs_dt(kernel, ts, R, yt), reps=5)
        del ssm_tl
    print(
        f"pkfs(LGSSM, engine='strip') Matern52 N={T} f32 [{card}]: {plane_ms:.3f} ms (peak {plane_peak:.2f} GiB); pkf with the LML "
        f"{pkf_ms:.3f} ms; pkfs on get_ssm's views (Fs, Qs time-last in memory) {views_ms:.3f} ms; in the same call "
        f"pkfs(LGSSMTL, engine='strip') {strip_ms:.3f} ms, pkfs_dt {dt_ms:.3f} ms"
    )
    with torch.no_grad():
        profile_calls(card, f"Matern52 N={T}", {"pkfs(LGSSM, strip)": lambda: pkfs(ssm, yt, engine="strip")})
    torch.cuda.empty_cache()
    fwd = tr["(T, 9) -> (9, T), Fs in"]
    return [
        {"name": "plane_scan", "route": "cuda", "source": SOURCES["plane_scan"], "replaces": REPLACES["plane_scan"],
         "body_replaces": PLANE_BODY, "launches": counts["plane_scan"], **out["filter"], "other_shapes": [out["smoother"]]},
        {"name": "plane_transpose", "route": "cuda", "source": SOURCES["plane_transpose"], "replaces": REPLACES["plane_transpose"],
         "launches": counts["plane_transpose"], **fwd, "other_shapes": [v for v in tr.values() if v is not fwd]},
    ]


def entry_timers(label: str, report=None) -> None:
    """The entry points alone, for comparing two trees in one call (the
    module docstring): at N = 10M, Matern52, float32, the chunk prefix of the
    dt filter's and smoother's totals (``dt.exclusive_chunk_prefixes``,
    whichever way the tree computes it), the LML, one predict_f request, one
    training step and the time-last pkfs(LGSSMTL, "strip"); the RBF(order=6)
    N = 1M LML, predict_f and training step on the engine the model takes;
    the quasi-periodic model's (QP_SPEC, N = 1M) where the tree has the
    composite family.  Each as events (cuda_ms, median of 9) and as wall, device time by kernel
    and the device's idle share (``report``, ab_report's by default: the
    median of three profiled calls)."""
    report = report or ab_report(label)
    t, y = make_data(N_FULL, SEED)
    query = np.random.RandomState(SEED + 2).rand(1000) * 1.4 - 0.2
    model = StateSpaceGP.from_numpy(t, y, "Matern52", 0.8, 0.4, NOISE, dtype=torch.float32, device=DEV)
    with torch.no_grad():
        fam, co, sde, dts = dt._model_inputs(model.kernel, model.ts)
        co, P0, H = co.detach(), sde.P0.detach(), sde.H.detach()
        R = model.noise_variance.detach().reshape(1, 1)
        b, C, _ = dt.strip_filter_dt(fam, co, P0, H, R, dts, model.ys)
        totals = {
            "filter": dt.dt_filter_scan(fam, co, P0, H, R, dts, model.ys),
            "smoother": dt.dt_smoother_scan(fam, co, P0, dts, b, C),
        }
        del b, C
        for kind, x in totals.items():
            def prefix(x=x, kind=kind):
                return dt.exclusive_chunk_prefixes(x, 3, reverse=kind == "smoother")

            report(f"chunk prefix {kind} {x.shape[1]} chunks", cuda_ms(prefix, reps=9), prefix, profiles=3)
        del totals

        def lml():
            return model.log_marginal_likelihood()

        report("LML", cuda_ms(lml, reps=9), lml, profiles=3)
        report("predict_f", cuda_ms(lambda: model.predict_f(query), reps=9), lambda: model.predict_f(query), profiles=3)
    report("training step", cuda_ms(lambda: value_and_grad(model), reps=9), lambda: value_and_grad(model), profiles=3)
    del model
    torch.cuda.empty_cache()

    kernel = Matern52(0.8, 0.4, dtype=torch.float32, device=DEV)
    with torch.no_grad():
        ts, yt = (torch.as_tensor(x, dtype=torch.float32, device=DEV) for x in (t, y))
        ssm_tl = kernel.get_ssm_tl(ts, torch.full((1, 1), NOISE, dtype=torch.float32, device=DEV))

        def api_tl():
            return pkfs(ssm_tl, yt, engine="strip")

        report("pkfs(LGSSMTL, strip)", cuda_ms(api_tl, reps=9), api_tl, profiles=3)
        del ssm_tl
        torch.cuda.empty_cache()

    # The RBF(order=6) model at N = N_STRIP: its entry points on the engine it
    # takes in this tree (strip before the spectral family, dt after).
    t_s, y_s = make_data(N_STRIP, SEED + 4)
    rbf = rbf_model(t_s, y_s, torch.float32)
    queries = np.random.RandomState(SEED + 5).rand(1000) * 1.4 - 0.2
    what = f"RBF(order=6) N={N_STRIP} on its {rbf.engine()[0]} engine"
    with torch.no_grad():
        report(f"LML {what}", cuda_ms(rbf.log_marginal_likelihood, reps=9), rbf.log_marginal_likelihood, profiles=3)
        report(f"predict_f {what}", cuda_ms(lambda: rbf.predict_f(queries), reps=9), lambda: rbf.predict_f(queries), profiles=3)
    report(f"training step {what}", cuda_ms(lambda: value_and_grad(rbf), reps=9), lambda: value_and_grad(rbf), profiles=3)
    del rbf
    torch.cuda.empty_cache()

    # The quasi-periodic model at N = N_QP, in a tree that has the composite
    # family.
    if hasattr(dt, "COMPOSITE"):
        t_q, y_q = make_data(N_QP, SEED + 9)
        qp = qp_model(t_q, y_q, torch.float32)
        what = f"QP d=8 N={N_QP} on its {qp.engine()[0]} engine"
        with torch.no_grad():
            report(f"LML {what}", cuda_ms(qp.log_marginal_likelihood, reps=9), qp.log_marginal_likelihood, profiles=3)
            report(f"predict_f {what}", cuda_ms(lambda: qp.predict_f(queries), reps=9), lambda: qp.predict_f(queries), profiles=3)
        report(f"training step {what}", cuda_ms(lambda: value_and_grad(qp), reps=9), lambda: value_and_grad(qp), profiles=3)
        del qp
        torch.cuda.empty_cache()


def status_read_timers(reps: int = 30) -> None:
    """What reading the plane scan's status word costs an LML (Matern52
    N = 10M and RBF(order=6) N = 1M, float32), in one process, the variants
    in turns: the wrapper's read, copied behind an event and checked by a
    later call (``plane._watch``); a read by a host synchronisation
    (``status.tolist()``, the wrapper's before); no read at all.  Median of
    ``reps`` calls each: CUDA events around the call, and the host clock
    around the call and a synchronise."""
    card = phase_device()
    watch = plane._watch
    variants = {
        "event": watch,
        "sync": lambda what, status, n_tiles, tile: status.tolist(),
        "none": lambda what, status, n_tiles, tile: None,
    }
    t, y = make_data(N_FULL, SEED)
    t_s, y_s = make_data(N_STRIP, SEED + 4)
    models = {
        f"LML Matern52 N={N_FULL}": StateSpaceGP.from_numpy(t, y, "Matern52", 0.8, 0.4, NOISE, dtype=torch.float32, device=DEV),
        f"LML RBF(order=6) N={N_STRIP}": rbf_model(t_s, y_s, torch.float32),
    }
    try:
        for what, model in models.items():
            times = {v: ([], []) for v in variants}
            with torch.no_grad():
                for v, fn in variants.items():  # one warm-up call each
                    plane._watch = fn
                    model.log_marginal_likelihood()
                for _ in range(reps):
                    for v, fn in variants.items():
                        plane._watch = fn
                        torch.cuda.synchronize()
                        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                        t0 = time.perf_counter()
                        start.record()
                        model.log_marginal_likelihood()
                        end.record()
                        torch.cuda.synchronize()
                        times[v][1].append(1e3 * (time.perf_counter() - t0))
                        times[v][0].append(start.elapsed_time(end))
            plane.check_overruns()
            print(
                f"status read [{card}] {what}, median of {reps} in turns: "
                + ", ".join(f"{v} events {np.median(e):.3f} ms wall {np.median(w):.3f} ms" for v, (e, w) in times.items())
            )
    finally:
        plane._watch = watch


def ab_timers(label: str) -> None:
    """This script's timers alone, for comparing two trees in one call (the
    module docstring): the entry points (entry_timers); at N = 10M,
    Matern52, float32 — dt_smoother_apply and dt_filter_apply on the serving
    path's inputs and plane_scan on the time-first path's filter and
    smoother rows, each as events around ten lone calls of its wrapper
    (cuda_ms) and as device time in a profile of one call; the time-first
    pkfs, as events (cuda_ms, median of 9) and as device time in a profile
    (profile_call).  plane_scan also on the same rows in float64, and on RBF
    filter and smoother rows of d = 4..8 at N = 1M float32.  The two strip
    pass-2 kernels on the Matern52 planes (d = 3, N = 10M float32) and at
    every d = 1..8 at N = 1M, float32 and float64; then the filter's and the
    smoother's pass-1 kernels (scan_timers) and the batched kernels
    (batched_timers).  One line a measurement, tagged with ``label``, the
    card and the tree's look-back tiling and strip stages where it reports
    them."""
    report = ab_report(label)
    entry_timers(label, report)
    t, y = make_data(N_FULL, SEED)
    model = StateSpaceGP.from_numpy(t, y, "Matern52", 0.8, 0.4, NOISE, dtype=torch.float32, device=DEV)
    with torch.no_grad():
        fam, co, sde, dts = dt._model_inputs(model.kernel, model.ts)
        co, P0, H = co.detach(), sde.P0.detach(), sde.H.detach()
        R = model.noise_variance.detach().reshape(1, 1)
        b, C, _ = dt.strip_filter_dt(fam, co, P0, H, R, dts, model.ys)
        pre_s = dt.exclusive_chunk_prefixes(dt.dt_smoother_scan(fam, co, P0, dts, b, C), 3, reverse=True)

        def apply():
            return dt.dt_smoother_apply(fam, co, P0, dts, b, C, pre_s)

        report("dt_smoother_apply", cuda_ms(apply, reps=10), apply)
        pre_f = dt.exclusive_chunk_prefixes(dt.dt_filter_scan(fam, co, P0, H, R, dts, model.ys), 3, reverse=False)

        def filter_apply():
            return dt.dt_filter_apply(fam, co, P0, H, R, dts, model.ys, pre_f)

        report("dt_filter_apply", cuda_ms(filter_apply, reps=10), filter_apply)
        del b, C, pre_s, pre_f
    del model
    torch.cuda.empty_cache()

    kernel = Matern52(0.8, 0.4, dtype=torch.float32, device=DEV)
    with torch.no_grad():
        ts, yt = (torch.as_tensor(x, dtype=torch.float32, device=DEV) for x in (t, y))
        views = kernel.get_ssm(ts, torch.full((1, 1), NOISE, dtype=torch.float32, device=DEV))
        ssm = LGSSM(views.P0, views.Fs.contiguous(), views.Qs.contiguous(), views.H, views.R)
        del views
        planes = timelast.time_last_planes(ssm)
        filt = strip._pack(timelast.make_filtering_elements_tl(ssm, yt, planes), N_FULL)
        b, C = moment_rows(plane.plane_scan(filt, 3, "filter"), 3)
        smooth = strip._pack(timelast._smoothing_elements_from_planes(*planes, b, C.reshape(3, 3, N_FULL)), N_FULL)
        del planes, b, C

        def scans(what, d, rows):
            for kind, x in zip(plane.KINDS, rows):
                def scan(x=x, kind=kind):
                    return plane.plane_scan(x, d, kind, kind == "smoother")

                ms = cuda_ms(scan, reps=10)
                getattr(plane, "check_overruns", lambda: None)()  # a tree that reads the status later
                print(f"ab {label} plane_scan {kind}{what}: look-back {plane.LOOK_BACK}")
                report(f"plane_scan {kind}{what}", ms, scan)

        scans("", 3, (filt, smooth))
        scans(f" d=3 N={N_FULL} f64", 3, (filt.double(), smooth.double()))
        del filt, smooth
        torch.cuda.empty_cache()
        # Wider states, where a tile holds fewer steps a thread (d = 4, 5: 2,
        # d ≥ 6: 1): RBF planes as in phase 11, at the strip path's length
        # (the RBF(order=6) model's data).
        t_s, y_s = make_data(N_STRIP, SEED + 4)
        for order in range(4, plane.MAX_KERNEL_D + 1):
            make = lambda dtype, order=order: RBF(1.0, 0.05, order=order, dtype=dtype, device=DEV)
            filt_r, smooth_r, d = plane_rows(make, t_s, y_s, torch.float32)
            scans(f" d={d} N={N_STRIP} f32", d, (filt_r, smooth_r))
            del filt_r, smooth_r
            torch.cuda.empty_cache()

        def api():
            return pkfs(ssm, yt, engine="strip")

        report("pkfs(LGSSM, strip)", cuda_ms(api, reps=9), api)
        del ssm
        torch.cuda.empty_cache()
        # The strip pass-2 kernels: d = 3 on that model's planes (the
        # pkfs(LGSSMTL, "strip") path's), and every unit, d = 1..8 in float32
        # and float64, at the strip path's length (strip_edge_kernel's planes).
        strip_apply_timers(report, label, "Matern52", strip_inputs(kernel, t, y, torch.float32))
        for dtype in (torch.float32, torch.float64):
            for d in range(1, strip.MAX_KERNEL_D + 1):
                strip_apply_timers(report, label, "", strip_inputs(strip_edge_kernel(d, dtype), t_s, y_s, dtype))
                torch.cuda.empty_cache()
    scan_timers(label, report)
    batched_timers(label, report)


def ab_report(label: str):
    """The card's name, the tree's library built and loaded (with every
    kernel's ptxas line where it was built now), and a
    ``report(what, events_ms, fn, profiles=1)`` that prints one A/B line: the
    events' time, and of ``profiles`` profiled calls of ``fn`` (profile_call)
    the median wall, each kernel's median device time (a profile that
    recorded no device events is left out), their sum and the device's idle
    share (1 − device / wall)."""
    card = phase_device()
    so, log = _cuda.build()
    _cuda.load()
    print(f"ab {label}: library {so.name}")
    for line in ptxas_lines(log):
        print(f"ab {label} {line}")

    def report(what, events_ms, fn, profiles=1):
        calls = [profile_call(fn) for _ in range(profiles)]
        runs = [by_name for _, by_name, _ in calls if by_name] or [{}]
        device = {k: round(float(np.median([r.get(k, 0.0) for r in runs])), 4) for k in runs[0]}
        wall, busy = float(np.median([c[0] for c in calls])), sum(device.values())
        kernels = int(np.median([c[2] for c in calls]))
        idle = f"idle share {max(0.0, 1.0 - busy / wall):.3f}" if device else "device time not measured"
        print(
            f"ab {label} [{card}] {what}: events {events_ms:.3f} ms, wall {wall:.3f} ms, device {busy:.3f} ms in {kernels} "
            f"kernels, {idle} {device}"
        )

    return report


def scan_timers(label: str, report=None, passes=PASS_KINDS) -> None:
    """The pass-1 kernels alone, for comparing two trees (or two variants of
    a per-unit choice) in one call, each as events around ten lone calls of
    its wrapper and device time, the median of five profiled calls
    (``report``, ab_report's by default), for each pass of ``passes``.  The
    filter's: dt_filter_scan on Matern12, Matern32 and Matern52 (d = 1, 2,
    3) at N = 10M float32 and N = 1M float64, dt_filter_scan_spectral at
    every d = 1..8 (RBF(1.0, 0.05, order=d)) at N = 1M, float32 and float64,
    strip_filter_scan on the Matern52 planes (d = 3, N = 10M float32) and at
    every d = 1..8 at N = 1M, float32 and float64 (strip_edge_kernel's
    planes).  The smoother's, on the filtered moments: dt_smoother_scan at
    d = 1, 2, 3 (N = 10M float32), dt_smoother_scan_spectral at every d
    (N = 1M float32), strip_smoother_scan as the filter's.  Each line names
    the tree's stage where it reports one, and the kernel's bound."""
    report = report or ab_report(label)

    def stage(kind, *unit):
        fn = dt.scan_stage if len(unit) == 3 else strip.scan_stage
        if "kind" in inspect.signature(fn).parameters:
            return fn(*unit, kind)
        return fn(*unit) if kind == "smoother" else "unstaged, 128 threads"  # a tree that stages the smoother's alone

    t, y = make_data(N_FULL, SEED)
    t_s, y_s = make_data(N_STRIP, SEED + 4)
    matern = [(kcls, params) for kcls, params in ((Matern12, (1.2, 0.6)), (Matern32, (1.0, 0.5)), (Matern52, (0.8, 0.4)))]
    with torch.no_grad():
        for kind in passes:
            cases = [(kcls(*params, dtype=torch.float32, device=DEV), t, y, torch.float32) for kcls, params in matern]
            cases += [(spectral_kernel(d, torch.float32), t_s, y_s, torch.float32) for d in SPECTRAL_DIMS]
            if kind == "filter":
                cases += [(kcls(*params, dtype=torch.float64, device=DEV), t_s, y_s, torch.float64) for kcls, params in matern]
                cases += [(spectral_kernel(d, torch.float64), t_s, y_s, torch.float64) for d in SPECTRAL_DIMS]
            for kern, tk, yk, dtype in cases:
                fam, co, P0, H, R, dts, yt = kernel_inputs(kern, tk, yk, dtype)
                d = P0.shape[0]
                if kind == "filter":
                    def scan():
                        return dt.dt_filter_scan(fam, co, P0, H, R, dts, yt)
                else:
                    b, C, _ = dt.strip_filter_dt(fam, co, P0, H, R, dts, yt)

                    def scan():
                        return dt.dt_smoother_scan(fam, co, P0, dts, b, C)

                name = scan_name(fam, kind)
                what = f"{name} d={d} N={yk.shape[0]} {dtype}"
                degree = 0 if fam == SPECTRAL else (co.numel() - 1) // (d * d)
                bound = kernel_bound(name, d, degree, yk.shape[0], 0, yt.element_size())
                print(f"ab {label} {what}: stage (threads, rows, bytes, buffers) {stage(kind, fam, d, dtype)}, bound {bound[0]:.4f} ms ({bound[1]})")
                report(what, cuda_ms(scan, reps=10), scan, profiles=5)
                del scan
                torch.cuda.empty_cache()
            cases = [(Matern52(0.8, 0.4, dtype=torch.float32, device=DEV), t, y, torch.float32)]
            cases += [(strip_edge_kernel(d, dtype), t_s, y_s, dtype) for dtype in (torch.float32, torch.float64) for d in range(1, strip.MAX_KERNEL_D + 1)]
            for kern, tk, yk, dtype in cases:
                Fs, Qs, P0, H, R, yt = strip_inputs(kern, tk, yk, dtype)
                d = P0.shape[0]
                if kind == "filter":
                    def scan():
                        return strip.strip_filter_scan(Fs, Qs, P0, H, R, yt)
                else:
                    b, C, _ = strip.strip_filter(Fs, Qs, P0, H, R, yt)

                    def scan():
                        return strip.strip_smoother_scan(Fs, Qs, b, C)

                name = scan_name("strip", kind)
                what = f"{name} d={d} N={yt.shape[0]} {Fs.dtype}"
                bound = kernel_bound(name, d, 0, yt.shape[0], 0, Fs.element_size())
                print(f"ab {label} {what}: stage (threads, rows, bytes, buffers) {stage(kind, d, Fs.dtype)}, bound {bound[0]:.4f} ms ({bound[1]})")
                report(what, cuda_ms(scan, reps=10), scan, profiles=5)
                del Fs, Qs, scan
                torch.cuda.empty_cache()


T_UNIT = 16_384  # the batched units' sweep: 64 series of this length


def batched_tile(d: int, dtype, kind: str) -> str:
    """The tree's tile of a batched unit, as its lines name it."""
    if hasattr(batched, "tile_shape"):
        threads, steps, rows, smem = batched.tile_shape(d, dtype, kind)
        if d in batched.WALK[kind][dtype]:
            return f"one block a series, tiles {threads} threads x {steps} steps, read directly, {smem} B"
        stage = f"{rows} rows staged" if rows else "read directly"
        return f"tile {threads} threads x {steps} steps, {stage}, {smem} B"
    threads = 128 if d <= 3 else 64 if d <= 5 else 32
    return f"one block a series, tiles {threads} threads x 8 steps, read directly"


def batched_timers(label: str, report=None, dims=tuple(range(1, 9)), dtypes=(torch.float32, torch.float64)) -> None:
    """The batched kernels, for comparing two trees (or two tilings) in one
    call: both kernels on the batched path's inputs (Matern52, 64 chains ×
    T = 65,536, float32: the chains' planes, one shared observation vector,
    the smoother without its projection as the gradient runs it), each as
    events around ten lone calls of its wrapper and device time, the median
    of five profiled calls (``report``, ab_report's by default); the batched
    log posterior and gradient, events (median of 9) and one profile (device
    time by kernel, idle share); one HMC step of 10 leapfrog steps; then
    every unit of ``dims`` and ``dtypes`` on RBF (d ≥ 4) or Matérn planes of
    64 series × T_UNIT steps.  Where the tree checks its overruns without a
    host synchronisation a launch, the value and gradient also with one
    (the status read at every launch), in turns.  Each line names the
    tree's tile."""
    report = report or ab_report(label)
    card = phase_device()
    t, y = make_data(T_BATCHED, SEED + 30)
    model = chain_model(t, y, chain_hypers(C_CHAINS, SEED + 31), torch.float32)
    with torch.no_grad():
        fam, co = model.kernel.transition_coeffs()
        co, P0, H, R, _ = dt.series_inputs(co, model.kernel.get_sde(), model.noise_variance.detach())
        Fs, Qs, P0s = dt.build_planes_tl(fam, co, P0, dt._dts_from_ts(model.ts))
        ys = batched.series_observations(model.ys, (C_CHAINS, T_BATCHED))
        b, C, _ = batched.batched_strip_filter(Fs, Qs, P0s, H, R, ys)
        what = f"d=3 B={C_CHAINS} T={T_BATCHED} torch.float32, the path's inputs"

        def filt():
            return batched.batched_strip_filter(Fs, Qs, P0s, H, R, ys)

        def smooth():
            return batched.batched_strip_smoother(Fs, Qs, b, C, None, project=False)

        n_obs = C_CHAINS * int((~torch.isnan(model.ys)).sum())
        for name, fn in (("batched_filter", filt), ("batched_smoother", smooth)):
            bound = kernel_bound(name, 3, 2, T_BATCHED, n_obs, 4, B=C_CHAINS, y_series=1)
            print(f"ab {label} {name} {what}: {batched_tile(3, torch.float32, name[8:])}, bound {bound[0]:.4f} ms ({bound[1]})")
            report(f"{name} {what}", cuda_ms(fn, reps=10), fn, profiles=5)
        del Fs, Qs, b, C
        torch.cuda.empty_cache()
    step = f"batched log posterior + gradient C={C_CHAINS} T={T_BATCHED}"
    report(step, cuda_ms(lambda: chains_value_and_grad(model), reps=9), lambda: chains_value_and_grad(model))
    profile_calls(card, f"{label} Matern52 C={C_CHAINS} T={T_BATCHED}", {"batched log posterior + gradient": lambda: chains_value_and_grad(model)})
    print(f"ab {label} [{card}] HMC step (10 leapfrog steps, {C_CHAINS} chains, T={T_BATCHED}) f32: {hmc_step_s(model):.4f} s")
    if hasattr(batched, "_watch"):
        # What a host synchronisation at every launch (the overrun word read
        # at once) would cost the value and gradient: in turns, without and
        # with.
        watch = batched._watch

        def read_now(name, what_, status):
            watch(name, what_, status)
            batched.check_overruns()

        times = {"without": [], "with": []}
        for turn in ("without", "with", "with", "without"):
            batched._watch = watch if turn == "without" else read_now
            try:
                times[turn].append(cuda_ms(lambda: chains_value_and_grad(model), reps=9))
            finally:
                batched._watch = watch
        print(f"ab {label} [{card}] {step}: events without / with a synchronisation a launch "
              + f"{times['without']} / {times['with']} ms")
    del model
    torch.cuda.empty_cache()

    # Every unit, on 64 series of T_UNIT steps: one model's planes copied to
    # every series, each series its own observations.
    lib = _cuda.load()
    occupancy = _cuda.batched_tiles(lib, fields=5) if hasattr(_cuda, "batched_tiles") else {}
    t_u, ys_u = series_data(C_CHAINS, T_UNIT, SEED + 36)
    for dtype in dtypes:
        for d in dims:
            with torch.no_grad():
                Fs1, Qs1, P01, H1, R1, _ = strip_inputs(strip_edge_kernel(d, dtype), t_u, ys_u[0], dtype)
                B = C_CHAINS
                Fs, Qs = (x[:, :, None].expand(d, d, B, T_UNIT).contiguous() for x in (Fs1, Qs1))
                P0, H, R = P01.expand(B, d, d), H1.expand(B, 1, d), R1.expand(B, 1, 1)
                yb = torch.as_tensor(ys_u, dtype=dtype, device=DEV)
                b, C, _ = batched.batched_strip_filter(Fs, Qs, P0, H, R, yb)
                del Fs1, Qs1
                calls = {
                    "filter": lambda: batched.batched_strip_filter(Fs, Qs, P0, H, R, yb),
                    "smoother": lambda: batched.batched_strip_smoother(Fs, Qs, b, C, None, project=False),
                }
                for kind, fn in calls.items():
                    name = f"batched_{kind}"
                    n_obs = int((~torch.isnan(yb)).sum())
                    bound = kernel_bound(name, d, max(d - 1, 0), T_UNIT, n_obs, yb.element_size(), B=B)
                    blocks = occupancy.get((d, dtype, kind), (None,) * 5)[4]
                    unit = f"{name} d={d} B={B} T={T_UNIT} {dtype}"
                    print(f"ab {label} {unit}: {batched_tile(d, dtype, kind)}, blocks an SM {blocks}, bound {bound[0]:.4f} ms ({bound[1]})")
                    report(unit, cuda_ms(fn, reps=10), fn, profiles=5)
                del Fs, Qs, b, C, calls
            torch.cuda.empty_cache()


N_FISHER = 1_000_000  # the Fisher units' sweep: one series of this length
FISHER_EXP = {1: Matern12, 2: Matern32, 3: Matern52}


def fisher_units():
    """(family, d, make(dtype)) of every dt_fisher unit: the exponential
    polynomial d = 1..3 (Matérn), the spectral family d = 1..8 (RBF), the
    composite family d = 2..8 (COMPOSITE_CASES)."""
    units = [(EXPPOLY, d, lambda dtype, k=k: k(0.8, 0.4, dtype=dtype, device=DEV)) for d, k in FISHER_EXP.items()]
    units += [(SPECTRAL, d, lambda dtype, d=d: spectral_kernel(d, dtype)) for d in SPECTRAL_DIMS]
    return units + [(COMPOSITE, d, make) for d, make in COMPOSITE_CASES.items()]


def fisher_inputs(k, t, y, dtype):
    """dt_fisher's arguments for the kernel ``k`` on (t, y), the moments
    from the kernels, no autograd."""
    fam, co, P0, H, R, dts, yt = kernel_inputs(k, t, y, dtype)
    with torch.no_grad():
        b, C, _ = dt.strip_filter_dt(fam, co, P0, H, R, dts, yt)
        b, C = b.contiguous(), C.contiguous()
        g, L = dt.strip_smoother_dt(fam, co, P0, dts, b, C)
    return fam, co, P0, H, R, dts, yt, b, C, g.contiguous(), L.contiguous()


def batched_fisher_inputs(d: int, dtype, B: int = C_CHAINS, T: int = T_BATCHED):
    """dt_fisher's arguments on the batched path: Matérn(d) chains with
    C_CHAINS jittered hyperparameters over one series of T_BATCHED steps,
    the moments from the batched kernels."""
    t, y = make_data(T, SEED + 30)
    name = FISHER_EXP[d].__name__
    model = StateSpaceGP.from_numpy(t, y, name, *chain_hypers(B, SEED + 31), dtype=dtype, device=DEV)
    with torch.no_grad():
        fam, co, sde, dts = dt._model_inputs(model.kernel, model.ts)
        co, P0, H, R, _ = dt.series_inputs(co.detach(), sde, model.noise_variance.detach())
        P0, H = P0.detach(), H.detach()
        (b, C, _), (Fs, Qs) = dt._batched_filter_dt(fam, co, P0, H, R, dts, model.ys)
        b, C = b.contiguous(), C.contiguous()
        g, L = batched.batched_strip_smoother(Fs, Qs, b, C, None, project=False)
    return fam, co.contiguous(), P0.contiguous(), H.contiguous(), R.contiguous(), dts, model.ys, b, C, g.contiguous(), L.contiguous()


def fisher_timers(label: str, report=None, dtypes=(torch.float32, torch.float64)) -> None:
    """Every dt_fisher unit, for comparing two trees in one call: events
    around five lone calls of dt.dt_fisher and its device time, the median
    of three profiled calls (``report``, ab_report's by default, which also
    prints the tree's ptxas lines), beside its bound from this run's
    inputs: the exponential polynomial (d = 1..3), spectral (d = 1..8) and
    composite (d = 2..8) units at N = N_FISHER, the batched units (d = 1..3,
    C_CHAINS × T_BATCHED), float32 and float64; then the rows of PERF.md's
    table at the path's shapes (Matern52 N = N_FULL, RBF(order=6) and the QP
    model at N = 1M, float32).  Each unit's two launches bit for bit."""
    report = report or ab_report(label)
    t, y = make_data(N_FISHER, SEED + 5)

    def time_unit(what, args, bound):
        out = dt.dt_fisher(*args)
        again = dt.dt_fisher(*args)
        torch.cuda.synchronize()
        check(all(bits(a) == bits(b) for a, b in zip(out, again)), f"{what}: two launches differ")
        del out, again
        print(f"ab {label} fisher {what}: bound {bound[0]:.4f} ms ({bound[1]})")
        report(f"fisher {what}", cuda_ms(lambda: dt.dt_fisher(*args), reps=5), lambda: dt.dt_fisher(*args), profiles=3)

    for dtype in dtypes:
        size = torch.finfo(dtype).bits // 8
        for family, d, make in fisher_units():
            k = make(dtype)
            args = fisher_inputs(k, t, y, dtype)
            plan = k.transition_coeffs()[0].plan if family == COMPOSITE else None
            n_obs = int((~torch.isnan(args[6])).sum())
            name = "dt_fisher" if family == EXPPOLY else f"dt_fisher_{family}"
            bound = kernel_bound(name, d, max(d - 1, 0), N_FISHER, n_obs, size, plan=plan)
            time_unit(f"{family} d={d} {k!r} N={N_FISHER} {dtype}", args, bound)
            del args
            torch.cuda.empty_cache()
        for d in FISHER_EXP:
            args = batched_fisher_inputs(d, dtype)
            n_obs = C_CHAINS * int((~torch.isnan(args[6])).sum())
            bound = kernel_bound("dt_fisher", d, d - 1, T_BATCHED, n_obs, size, B=C_CHAINS, y_series=1)
            time_unit(f"batched d={d} B={C_CHAINS} T={T_BATCHED} {dtype}", args, bound)
            del args
            torch.cuda.empty_cache()
    for what, family, k, T, seed in (
        ("Matern52", EXPPOLY, Matern52(0.8, 0.4, dtype=torch.float32, device=DEV), N_FULL, SEED),
        ("RBF(order=6)", SPECTRAL, RBF(0.8, 0.05, order=6, dtype=torch.float32, device=DEV), N_STRIP, SEED + 4),
        ("QP", COMPOSITE, qp_model(*make_data(2, 0), torch.float32).kernel, N_QP, SEED + 9),
    ):
        t_p, y_p = make_data(T, seed)
        args = fisher_inputs(k, t_p, y_p, torch.float32)
        d = args[2].shape[0]
        plan = k.transition_coeffs()[0].plan if family == COMPOSITE else None
        name = "dt_fisher" if family == EXPPOLY else f"dt_fisher_{family}"
        bound = kernel_bound(name, d, d - 1, T, int((~torch.isnan(args[6])).sum()), 4, plan=plan)
        time_unit(f"path {what} d={d} N={T} f32", args, bound)
        del args
        torch.cuda.empty_cache()


def prefix_timers(label: str, report=None) -> None:
    """The plane_scan units and the batched kernels whose filter combine the
    averaged symmetrisation changes, for comparing two trees in one call:
    every plane_scan unit, d = 1..8, float32 and float64, filter and
    smoother — chained over the chunk totals of N_STRIP steps (the chunk
    prefix), and with the look-back over the N_STRIP-step time-first rows
    (the plane path) — as events and device time (``report``), each chained
    scan's output digest (its bits do not depend on timing); and each
    batched unit's outputs' digest (batched_filter and batched_smoother,
    d = 1..8, both scalar types, 64 series × T_UNIT).  The units' times are
    batched_timers'."""
    report = report or ab_report(label)
    t_s, y_s = make_data(N_STRIP, SEED + 4)
    t_c, y_c = make_data(N_CHECK, SEED + 4)
    digests = {}
    for dtype in (torch.float32, torch.float64):
        for d in range(1, plane.MAX_KERNEL_D + 1):
            make = lambda dtype_, d=d: strip_edge_kernel(d, dtype_)  # noqa: E731
            with torch.no_grad():
                Fs, Qs, P0, H, R, yt = strip_inputs(make(dtype), t_s, y_s, dtype)
                tot_f = strip.strip_filter_scan(Fs, Qs, P0, H, R, yt)
                # The smoother's totals from the plain prefix's moments: the
                # same in both trees.
                pre_f = strip.exclusive_chunk_prefixes_plain(tot_f, d, reverse=False)
                b, C, _ = strip.strip_filter_apply(Fs, Qs, P0, H, R, yt, pre_f)
                tot_s = strip.strip_smoother_scan(Fs, Qs, b, C)
                del Fs, Qs, b, C
                for kind, tot in (("filter", tot_f), ("smoother", tot_s)):
                    def scan(tot=tot, kind=kind):
                        return plane.plane_scan(tot, d, kind, kind == "smoother", chained=True)

                    unit = f"plane_scan chained {kind} d={d} {tot.shape[1]} chunks {dtype}"
                    digests[unit] = hashlib.sha256(bits(scan())).hexdigest()[:16]
                    report(unit, cuda_ms(scan, reps=10), scan)
                del tot_f, tot_s
                rows = plane_rows(make, t_c, y_c, dtype)
                for kind, x in zip(plane.KINDS, rows[:2]):
                    def scan(x=x, kind=kind):
                        return plane.plane_scan(x, d, kind, kind == "smoother")

                    report(f"plane_scan {kind} d={d} N={N_CHECK} {dtype}", cuda_ms(scan, reps=10), scan)
                del rows
            torch.cuda.empty_cache()
    t_u, ys_u = series_data(C_CHAINS, T_UNIT, SEED + 36)
    for dtype in (torch.float32, torch.float64):
        for d in range(1, 9):
            with torch.no_grad():
                Fs1, Qs1, P01, H1, R1, _ = strip_inputs(strip_edge_kernel(d, dtype), t_u, ys_u[0], dtype)
                B = C_CHAINS
                Fs, Qs = (x[:, :, None].expand(d, d, B, T_UNIT).contiguous() for x in (Fs1, Qs1))
                P0, H, R = P01.expand(B, d, d), H1.expand(B, 1, d), R1.expand(B, 1, 1)
                yb = torch.as_tensor(ys_u, dtype=dtype, device=DEV)
                f_out = batched.batched_strip_filter(Fs, Qs, P0, H, R, yb)
                # The smoother on the plain filter's moments: the same in both trees.
                m_p = batched.batched_strip_filter_plain(Fs, Qs, P0, H, R, yb)
                s_out = batched.batched_strip_smoother(Fs, Qs, m_p[0].contiguous(), m_p[1].contiguous(), None, project=False)
                for kind, out in (("filter", f_out), ("smoother", s_out)):
                    digests[f"batched_{kind} d={d} {dtype}"] = hashlib.sha256(b"".join(bits(x) for x in out)).hexdigest()[:16]
                del Fs, Qs, f_out, s_out, m_p
            torch.cuda.empty_cache()
    print(f"ab {label} digests {json.dumps(digests)}")


def strip_apply_timers(report, label: str, what: str, planes) -> None:
    """Both strip pass-2 kernels on the given (Fs, Qs, P0, H, R, y) planes,
    through ``report`` (events around ten lone calls, device time in a
    profile), each with the tree's stage where it reports one."""
    Fs, Qs, P0, H, R, y = planes
    d, T = P0.shape[0], y.shape[0]
    with torch.no_grad():
        pre_f = strip.exclusive_chunk_prefixes(strip.strip_filter_scan(Fs, Qs, P0, H, R, y), d, reverse=False)
        b, C, _ = strip.strip_filter_apply(Fs, Qs, P0, H, R, y, pre_f)
        pre_s = strip.exclusive_chunk_prefixes(strip.strip_smoother_scan(Fs, Qs, b, C), d, reverse=True)
        calls = {
            "filter": lambda: strip.strip_filter_apply(Fs, Qs, P0, H, R, y, pre_f),
            "smoother": lambda: strip.strip_smoother_apply(Fs, Qs, b, C, pre_s),
        }
        for kind, fn in calls.items():
            # The parent's tree has no per-unit stage.
            stage = strip.apply_stage(d, Fs.dtype, kind) if hasattr(strip, "apply_stage") else "unstaged, 128 threads"
            ms = cuda_ms(fn, reps=10)
            print(f"ab {label} strip_{kind}_apply d={d} N={T} {Fs.dtype} {what}".rstrip() + f": stage (threads, rows, bytes) {stage}")
            report(f"strip_{kind}_apply d={d} N={T} {Fs.dtype} {what}".rstrip(), ms, fn)


# The exponential polynomial's dt units' output digests (dt_outputs) on the
# tree before the spectral family was added (commit 0d1c238), run on an
# NVIDIA H100 80GB HBM3 at 700 W: phase_dt_digests holds this tree's against
# them, bit for bit.
PARENT_DT_DIGESTS = {
    "Matern12 float64": "4746bad9037fc06b", "Matern12 float32": "bbeb8585cf83cfc7",
    "Matern32 float64": "7bba88a1548c3ed2", "Matern32 float32": "706d37a588641768",
    "Matern52 float64": "f628ceea7d6ab848", "Matern52 float32": "06e2c7a3be7b16b3",
    "inputs": "89ccdce5e6791b7f",
}


def dt_outputs(T: int = 100_003) -> dict:
    """The exponential polynomial's five dt kernels (the Matérn units, d = 1,
    2, 3, float32 and float64) on inputs made on the CPU from the seed and
    rounded to multiples of 2⁻²⁰, so that no library's last bit reaches them;
    each pass is fed the kernels' own outputs — the filter apply the filter
    scan's totals as its prefixes, the smoothers the filter apply's moments,
    the smoother apply the smoother scan's totals, the Fisher tail all four
    moments — so that nothing else computes on the card.  Returns {unit:
    sha256 of its outputs' bytes} and the inputs' digest under "inputs".
    Uses only entry points that the tree before the spectral family has."""
    t, y = make_data(T, SEED + 8)
    out, h_in = {}, hashlib.sha256()

    def q(x):
        return torch.round(x * 2.0**20) / 2.0**20

    for kcls, params in ((Matern12, (1.2, 0.6)), (Matern32, (1.0, 0.5)), (Matern52, (0.8, 0.4))):
        with torch.no_grad():
            k = kcls(*params, dtype=torch.float64, device="cpu")
            fam, co = k.transition_coeffs()
            sde = k.get_sde()
            R = torch.full((1, 1), NOISE, dtype=torch.float64)
            base = [q(co), q(sde.P0), q(sde.H), R, q(dt._dts_from_ts(torch.tensor(t))), q(torch.tensor(y))]
            for dtype in (torch.float64, torch.float32):
                co_, P0, H, R_, dts, yt = (x.to(dtype).contiguous() for x in base)
                for x in (co_, P0, H, R_, dts, yt):
                    h_in.update(x.numpy().tobytes())
                co_, P0, H, R_, dts, yt = (x.to(DEV) for x in (co_, P0, H, R_, dts, yt))
                tot = dt.dt_filter_scan(fam, co_, P0, H, R_, dts, yt)
                b, C, ell = dt.dt_filter_apply(fam, co_, P0, H, R_, dts, yt, tot)
                tot_s = dt.dt_smoother_scan(fam, co_, P0, dts, b, C)
                g, L = dt.dt_smoother_apply(fam, co_, P0, dts, b, C, tot_s)
                fisher = dt.dt_fisher(fam, co_, P0, H, R_, dts, yt, b, C, g, L)
                h = hashlib.sha256()
                for x in (tot, b, C, ell, tot_s, g, L, *fisher):
                    h.update(x.detach().cpu().contiguous().numpy().tobytes())
                out[f"{kcls.__name__} {str(dtype).replace('torch.', '')}"] = h.hexdigest()[:16]
    out["inputs"] = h_in.hexdigest()[:16]
    return out


def phase_dt_digests() -> None:
    """The exponential polynomial's dt units bit for bit against the tree
    before the spectral family (PARENT_DT_DIGESTS, dt_outputs)."""
    got = dt_outputs()
    print(f"dt units' output digests (exponential polynomial): {got}")
    if PARENT_DT_DIGESTS is None:
        print("  no parent digests recorded: not compared")
        return
    if got["inputs"] != PARENT_DT_DIGESTS["inputs"]:
        print(f"  the inputs differ from the recorded run's ({got['inputs']} vs {PARENT_DT_DIGESTS['inputs']}): not compared")
        return
    for unit, digest in PARENT_DT_DIGESTS.items():
        check(got[unit] == digest, f"dt unit {unit}: outputs differ from the parent's ({got[unit]} vs {digest})")
    print(f"  the {len(PARENT_DT_DIGESTS) - 1} exponential-polynomial units' outputs are bit for bit the parent's")


def strip_apply_outputs(out_dir: str, T: int = 100_003) -> None:
    """The moments of both strip pass-2 kernels and both pass-1 kernels'
    totals at every d = 1..8, float32 and float64, on planes made from the
    seed at T steps (by default a ragged chunk, warp and block), saved in
    ``out_dir`` one file a unit, for compare_strip_apply_outputs.  The
    smoother runs on the filter's moments, so its inputs agree between two
    trees where the filter's outputs do."""
    phase_device()
    _cuda.build()
    os.makedirs(out_dir, exist_ok=True)
    t, y = make_data(T, SEED + 4)
    for dtype in (torch.float32, torch.float64):
        for d in range(1, strip.MAX_KERNEL_D + 1):
            Fs, Qs, P0, H, R, yt = strip_inputs(strip_edge_kernel(d, dtype), t, y, dtype)
            with torch.no_grad():
                tot_f = strip.strip_filter_scan(Fs, Qs, P0, H, R, yt)
                b, C, _ = strip.strip_filter_apply(Fs, Qs, P0, H, R, yt, strip.exclusive_chunk_prefixes(tot_f, d, reverse=False))
                tot_s = strip.strip_smoother_scan(Fs, Qs, b, C)
                g, L = strip.strip_smoother_apply(Fs, Qs, b, C, strip.exclusive_chunk_prefixes(tot_s, d, reverse=True))
            outputs = {"tot_f": tot_f, "b": b, "C": C, "tot_s": tot_s, "g": g, "L": L}
            torch.save({k: v.cpu() for k, v in outputs.items()}, os.path.join(out_dir, f"d{d}_{dtype}.pt"))
    print(f"strip apply outputs: T={T}, {len(os.listdir(out_dir))} units in {out_dir}")


def spectral_outputs(out_dir: str, T: int = 100_003) -> None:
    """strip_apply_outputs' counterpart for the spectral dt units, d = 1..8,
    float32 and float64: RBF(1.0, 0.05, order=d) on data made from the seed,
    each pass fed the kernels' own outputs (the filter apply the prefixes of
    the filter scan's totals, the smoother the filter's moments, the smoother
    apply the suffixes of the smoother scan's totals); the filter scan's
    totals, the filter's moments, the smoother scan's totals and the smoothed
    moments saved in ``out_dir``,
    one file a unit (``spectral_d<d>_<dtype>.pt``)."""
    phase_device()
    _cuda.build()
    os.makedirs(out_dir, exist_ok=True)
    t, y = make_data(T, SEED + 4)
    for dtype in (torch.float32, torch.float64):
        for d in SPECTRAL_DIMS:
            fam, co, P0, H, R, dts, yt = kernel_inputs(spectral_kernel(d, dtype), t, y, dtype)
            with torch.no_grad():
                tot_f = dt.dt_filter_scan(fam, co, P0, H, R, dts, yt)
                b, C, _ = dt.dt_filter_apply(fam, co, P0, H, R, dts, yt, dt.exclusive_chunk_prefixes(tot_f, d, reverse=False))
                tot_s = dt.dt_smoother_scan(fam, co, P0, dts, b, C)
                g, L = dt.dt_smoother_apply(fam, co, P0, dts, b, C, dt.exclusive_chunk_prefixes(tot_s, d, reverse=True))
            outputs = {"tot_f": tot_f, "b": b, "C": C, "tot_s": tot_s, "g": g, "L": L}
            torch.save({k: v.cpu() for k, v in outputs.items()}, os.path.join(out_dir, f"spectral_d{d}_{dtype}.pt"))
    print(f"spectral outputs: T={T}, {len(os.listdir(out_dir))} files in {out_dir}")


def compare_strip_apply_outputs(dir_a: str, dir_b: str) -> bool:
    """Each unit's outputs from two strip_apply_outputs (or spectral_outputs)
    runs, compared bit for bit (the values' bit patterns); where they differ,
    the largest difference and the share of values that differ.  True where
    every unit agrees."""
    same = True
    for name in sorted(os.listdir(dir_a)):
        a, b = (torch.load(os.path.join(x, name)) for x in (dir_a, dir_b))
        for k in a:
            bits = torch.int64 if a[k].dtype == torch.float64 else torch.int32
            differ = a[k].view(bits) != b[k].view(bits)
            if differ.any():
                same = False
                print(f"outputs {name} {k}: differ, {float(differ.double().mean()):.3e} of the values, "
                      f"max abs {max_abs(a[k], b[k]):.3e}")
            else:
                print(f"outputs {name} {k}: bit for bit")
    print(f"outputs of {dir_a} and {dir_b}: {'every unit bit for bit' if same else 'not bit for bit'}")
    return same


def main() -> int:
    card = phase_device()
    phase_build()
    count_prefix_calls()
    phase_kernels()
    check_spectral_kernels()
    check_composite_kernels()
    check_fisher_edges()
    check_scan_edges()
    phase_dt_digests()
    phase_batched_kernels()
    model, data, queries, serving = phase_slice()
    training = phase_training(model, data)
    print(f"launches: serving path {serving}, training path {training}")
    for name in DT_KERNELS:
        check(serving[name] + training[name] > 0 and training[name] > 0, f"{name} was never launched on the training path")
    counts = {name: serving[name] + training[name] for name in DT_KERNELS + ("plane_scan",)}
    check(serving["plane_scan"] > 0 and training["plane_scan"] > 0, "the dt path ran its chunk prefixes without a plane scan")
    records = phase_times(card, model, queries, counts)
    phase_profile(card, f"Matern52 N={N_FULL}", model, queries[0])
    del model, data
    torch.cuda.empty_cache()
    records.append(phase_prefix(card, counts["plane_scan"]))
    rbf, rbf_queries, rbf_counts = phase_rbf_slice()
    print(f"launches: RBF dt path {rbf_counts}")
    for name in SPECTRAL_KERNELS:
        check(rbf_counts[name] > 0, f"{name} was never launched on the RBF dt path")
    records += phase_rbf_times(card, rbf, rbf_queries, rbf_counts)
    phase_profile(card, f"RBF(order=6) N={N_STRIP}", rbf, rbf_queries)
    del rbf
    torch.cuda.empty_cache()
    qp_prefix_precision(card)
    qp, qp_queries, qp_counts = phase_qp_slice()
    print(f"launches: QP dt path {qp_counts}")
    for name in COMPOSITE_KERNELS:
        check(qp_counts[name] > 0, f"{name} was never launched on the QP dt path")
    records += phase_qp_times(card, qp, qp_queries, qp_counts)
    phase_profile(card, f"QP d=8 N={N_QP}", qp, qp_queries)
    del qp
    torch.cuda.empty_cache()
    rbf, _, planes, strip_counts = phase_strip_slice()
    print(f"launches: strip path {strip_counts}")
    for name in STRIP_KERNELS:
        check(strip_counts[name] > 0, f"{name} was never launched on the strip path")
    records += phase_strip_times(card, rbf, planes, strip_counts)
    del planes, rbf
    torch.cuda.empty_cache()
    phase_sequential_time(card)
    chains, batched_counts = phase_batched_slice()
    for name in BATCHED_KERNELS + ("dt_fisher",):
        check(batched_counts[name] > 0, f"{name} was never launched on the batched path")
    for record in phase_batched_times(card, chains, batched_counts):
        if "name" in record:
            records.append(record)
        else:  # the Fisher tail with a batch axis: a field of its row
            next(r for r in records if r["name"] == "dt_fisher")["batched"] = record
    del chains
    torch.cuda.empty_cache()
    phase_probe_kernels()
    records += phase_probes(card)
    phase_plane_kernels()
    plane_counts, plane_inputs = phase_plane_slice()
    print(f"launches: plane path {plane_counts}")
    for name in PLANE_KERNELS:
        check(plane_counts[name] > 0, f"{name} was never launched on the time-first path")
    records += phase_plane_times(card, plane_counts, plane_inputs)
    del plane_inputs
    plane.check_overruns()
    print(f"card: {card}")
    print(json.dumps({"kernels": records}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
