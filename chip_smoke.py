#!/usr/bin/env python3
"""Smoke test of the PyTorch port (parallel_gps_torch) on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each failing the run (non-zero exit, no result line) on error:

  1. device: the card's name and power limit (nvidia-smi); a CUDA device is
     required;
  2. build: compile every CUDA kernel from parallel_gps_torch/csrc;
  3. kernels vs plain: for Matern12/32/52 at T = 65,537 with ~10% missing
     observations, the CUDA filter, smoother and Fisher tail of the dt-engine
     against their plain PyTorch versions, float64 to the JAX interpret-test
     tolerances, float32 against float64 truth; then the four
     plane-streaming strip kernels the same way at d = 1, 2, 3 (Matérn
     planes) and d = 4, 6, 8 (RBF planes), and at d = 3 the strip engine
     against the dt-engine on the same data;
  4. the serving path at full size: StateSpaceGP(Matern52(0.8, 0.4), noise
     0.1), N = 10,000,000 float32 observations — one LML and three
     predict_f requests of 1,000 unsorted queries — with the launch counts
     that path requires; the same in float64; and at N = 262,144 float64 the
     model against its plain versions;
  5. the training path on the same data: one LML + backward on that model,
     then five Adam steps and two L-BFGS steps from other hyperparameters,
     with the launch counts of a training step;
     the float32 gradient beside the float64 one and the plain float32 one;
     and at N = 262,144 float64 the gradient through the kernels against
     the plain path on the card and the same model on the CPU;
  6. times (CUDA events, medians): each kernel against its plain version
     and its bound at N = 10M float32, the LML, one predict_f request and
     one training step;
  7. profile (torch.profiler): device time by kernel and the device's idle
     share for one LML, one predict_f request and one training step.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

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
from parallel_gps_torch.inference import fit_adam, fit_lbfgs  # noqa: E402
from parallel_gps_torch.kalman import _cuda  # noqa: E402
from parallel_gps_torch.kalman import dt, strip, timelast  # noqa: E402
from parallel_gps_torch.kalman.parallel import pkfs  # noqa: E402
from parallel_gps_torch.kernels import RBF, Matern12, Matern32, Matern52  # noqa: E402
from parallel_gps_torch.types import LGSSMTL  # noqa: E402

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
    "strip_filter_scan": "parallel_gps_torch/csrc/strip_scan.cu",
    "strip_filter_apply": "parallel_gps_torch/csrc/strip_scan.cu",
    "strip_smoother_scan": "parallel_gps_torch/csrc/strip_scan.cu",
    "strip_smoother_apply": "parallel_gps_torch/csrc/strip_scan.cu",
}
DT_KERNELS = tuple(k for k in SOURCES if k.startswith("dt_"))
STRIP_KERNELS = tuple(k for k in SOURCES if k.startswith("strip_"))
REPLACES = {
    "dt_filter_scan": "parallel_gps_tpu/kalman/pallas_dt.py:179",
    "dt_filter_apply": "parallel_gps_tpu/kalman/pallas_dt.py:208",
    "dt_smoother_scan": "parallel_gps_tpu/kalman/pallas_dt.py:553",
    "dt_smoother_apply": "parallel_gps_tpu/kalman/pallas_dt.py:589",
    "dt_fisher": "parallel_gps_tpu/kalman/pallas_dt.py:839",
    "strip_filter_scan": "parallel_gps_tpu/kalman/pallas_scan.py:766",
    "strip_filter_apply": "parallel_gps_tpu/kalman/pallas_scan.py:798",
    "strip_smoother_scan": "parallel_gps_tpu/kalman/pallas_scan.py:1795",
    "strip_smoother_apply": "parallel_gps_tpu/kalman/pallas_scan.py:1840",
}
# Launches the serving path makes: the filter passes for the LML, and all
# four passes for each predict_f request.
N_REQUESTS = 3
EXPECTED_LAUNCHES = {
    "dt_filter_scan": 1 + N_REQUESTS,
    "dt_filter_apply": 1 + N_REQUESTS,
    "dt_smoother_scan": N_REQUESTS,
    "dt_smoother_apply": N_REQUESTS,
    "dt_fisher": 0,
}
LML_LAUNCHES = {"dt_filter_scan": 1, "dt_filter_apply": 1, "dt_smoother_scan": 0, "dt_smoother_apply": 0, "dt_fisher": 0}
# One training step (LML + backward) launches each of the five kernels once.
STEP_LAUNCHES = dict.fromkeys(EXPECTED_LAUNCHES, 1)
# The strip path's model: an LML is the strip filter; a predict_f request and
# a training step (strip filter forward, strip smoother backward) are all four.
RBF_MODEL = dict(kernel="RBF", variance=0.8, lengthscales=0.05, noise_variance=NOISE, order=6)
STRIP_LML_LAUNCHES = {"strip_filter_scan": 1, "strip_filter_apply": 1, "strip_smoother_scan": 0, "strip_smoother_apply": 0}
STRIP_ALL_LAUNCHES = dict.fromkeys(STRIP_KERNELS, 1)
N_ADAM = 5
N_LBFGS = 2
# The optimisers start away from the serving model's hyperparameters (0.8,
# 0.4, noise 0.1), which generated the data's noise: there the loss of 10M
# points is within one float32 step of its minimum and cannot be seen to fall.
TRAIN_START = (1.0, 0.3, 0.2)

# Peaks of one H100 SXM (NVIDIA's data sheet): device memory 3.35 TB/s,
# float32 outside the tensor cores 67 TFLOP/s.  A kernel's bound is the
# larger of its bytes over the first and its operations over the second.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

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
    with torch.no_grad():
        k = kernel_cls(*params, dtype=dtype, device=DEV)
        family, coeffs = k.transition_coeffs()
        sde = k.get_sde()
        dts = dt._dts_from_ts(torch.as_tensor(t, dtype=dtype, device=DEV))
        yt = torch.as_tensor(y, dtype=dtype, device=DEV)
        R = torch.full((1, 1), NOISE, dtype=dtype, device=DEV)
    return family, coeffs.detach(), sde.P0.detach(), sde.H.detach(), R, dts, yt


def hyper_params(model):
    return [model.kernel.raw_variance, model.kernel.raw_lengthscales, model.raw_noise_variance]


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


def flops_per_step(d: int, degree: int) -> dict:
    """Floating-point operations of one time step of each kernel, counted
    from csrc/dt_elements.cuh (a multiply, an add, a divide and a
    transcendental one each); ``*_obs`` parts run at observed steps only.
    The strip kernels load F and Q where the dt kernels rebuild them."""
    tri = d * (d + 1) // 2
    inv = _inv_flops(d)
    build_fq = 4 + degree * (2 * d * d + 2) + d + _mm(d) + tri * (2 * d + 2)
    build_filtering = 2 * _mv(d) + 2 * d + 2 + d * (3 + 6 * d)
    filt_combine = 5 * _mm(d) + 2 * _symout(d) + inv + 4 * _mv(d) + 5 * d
    loglik_obs = 2 * _mv(d) + _mv(d) + 6 * d + 10
    build_smoothing = 4 * _mm(d) + _symout(d) + inv + _mv(d) + d + tri * 2 * d
    smooth_combine = 2 * _mm(d) + _mv(d) + d + _symout(d)
    fq_vjp = tri * (2 + 4 * d) + 2 * _mm(d) + d * d + d + 6 + degree * (4 * d * d + 5)
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
        "strip_filter_scan": (filt, 0), "strip_filter_apply": (filt, loglik_obs),
        "strip_smoother_scan": (smooth, 0), "strip_smoother_apply": (smooth, 0),
    }


def kernel_bound(name: str, d: int, degree: int, T: int, n_obs: int, itemsize: int):
    """(bound in ms, "bytes" or "operations"): the least time the card could
    take — each input read once and each output written once at the memory
    peak, against this run's operations at the float32 peak.  ``degree`` is
    read by the dt kernels only."""
    nc = dt.n_chunks(T)
    mom = (d + d * d) * T
    planes = 2 * d * d * T
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
    every, observed = flops_per_step(d, degree)[name]
    bytes_ms = 1e3 * values * itemsize / PEAK_BYTES_PER_S
    ops_ms = 1e3 * (every * T + observed * n_obs) / PEAK_F32_FLOPS
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


def phase_build() -> None:
    t0 = time.perf_counter()
    so, log = _cuda.build()
    _cuda.load()
    print(f"build: {so.name} in {time.perf_counter() - t0:.1f} s")
    # One line per kernel: registers, stack and spills as ptxas reports them.
    entry, frame = None, {}
    for line in log.splitlines():
        found = re.search(r"Compiling entry function '_ZN3pgt\d+(\w+?)_kernelI([fd])Li(\d)E", line)
        if found:
            entry = f"{found.group(1)} {'f64' if found.group(2) == 'd' else 'f32'} D={found.group(3)}"
        elif "spill stores" in line:
            frame = {what: n for n, what in re.findall(r"(\d+) bytes (stack frame|spill stores|spill loads)", line)}
        elif "registers" in line and entry:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            print(
                f"  ptxas: {entry}: {regs} registers, {frame.get('stack frame', '?')} B stack, "
                f"{frame.get('spill stores', '?')} B spill stores, {frame.get('spill loads', '?')} B spill loads"
            )
            entry = None


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
    check_strip_kernels(t, y)


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
            check(strip.LAUNCHES == STRIP_ALL_LAUNCHES, f"{name}: launches {strip.LAUNCHES}")
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
        dt.reset_launch_counts()
        with torch.no_grad():
            ell = model.log_marginal_likelihood()
            after_lml = dict(dt.LAUNCHES)
            preds = [model.predict_f(q) for q in queries]
        torch.cuda.synchronize()
        counts = dict(dt.LAUNCHES)
        tag = str(dtype).replace("torch.", "")
        print(f"slice {tag} N={N_FULL}: LML {float(ell):.6f}, launches after LML {after_lml}, after requests {counts}")
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


def rbf_model(t, y, dtype, device=None):
    return StateSpaceGP.from_numpy(t, y, dtype=dtype, device=device or DEV, **RBF_MODEL)


def phase_strip_slice():
    """The strip path at full width: the RBF(order=6) model, and the Kalman
    API on an explicit model.  Returns the f32 model, its queries, the planes
    of the explicit model and the launch counts of the path."""
    # (a) the model whose kernel has no transition coefficients.
    t, y = make_data(N_STRIP, SEED + 4)
    queries = np.random.RandomState(SEED + 5).rand(1000) * 1.4 - 0.2  # unsorted, some outside [0, 1)
    model = rbf_model(t, y, torch.float32)
    check(model.engine()[0] == "strip", f"the RBF model runs the {model.engine()[0]} engine")
    torch.cuda.synchronize()
    strip.reset_launch_counts()
    dt.reset_launch_counts()
    with torch.no_grad():
        ell = model.log_marginal_likelihood()
        after_lml = dict(strip.LAUNCHES)
        strip.reset_launch_counts()
        mean, var = model.predict_f(queries)
        after_predict = dict(strip.LAUNCHES)
    strip.reset_launch_counts()
    loss, grad = value_and_grad(model)
    after_step = dict(strip.LAUNCHES)
    torch.cuda.synchronize()
    print(
        f"strip slice f32 RBF(order=6) N={N_STRIP}: LML {float(ell):.6f}; query variance min {float(var.min()):.3e} "
        f"max {float(var.max()):.3e}; gradient (variance, lengthscale, noise) {grad.tolist()}"
    )
    print(f"  launches: LML {after_lml}, predict_f {after_predict}, training step {after_step}; dt kernels {dt.LAUNCHES}")
    check(after_lml == STRIP_LML_LAUNCHES, f"strip LML launches {after_lml}")
    check(after_predict == STRIP_ALL_LAUNCHES, f"strip predict_f launches {after_predict}")
    check(after_step == STRIP_ALL_LAUNCHES, f"strip training-step launches {after_step}")
    check(not any(dt.LAUNCHES.values()), f"the strip path launched a dt kernel: {dt.LAUNCHES}")
    check(bool(torch.isfinite(ell)) and bool(loss == -ell), "strip f32 LML not finite, or the loss is not its negative")
    check(mean.shape == (1000, 1) and var.shape == (1000, 1) and bool(torch.isfinite(mean).all()), "strip predict_f means")
    check(bool((var > 0).all()), "strip predict_f variances not positive")
    check(bool(torch.isfinite(grad).all()), "strip f32 gradient not finite")
    counts = {k: after_lml[k] + after_predict[k] + after_step[k] for k in STRIP_KERNELS}
    model.zero_grad(set_to_none=True)

    # float32 beside float64 at this size.
    m64 = rbf_model(t, y, torch.float64)
    with torch.no_grad():
        ell64 = m64.log_marginal_likelihood()
        mean64, var64 = m64.predict_f(queries)
    _, grad64 = value_and_grad(m64)
    print(
        f"strip slice f32 vs f64 N={N_STRIP}: LML rel {abs(float(ell) - float(ell64)) / abs(float(ell64)):.3e}, mean max abs "
        f"{max_abs(mean, mean64):.3e}, var max rel {rel_err(var, var64):.3e}, var min f64 {float(var64.min()):.3e}; "
        f"f64 gradient {grad64.tolist()}, f32 gradient per component "
        f"{((grad.double() - grad64).abs() / grad64.abs()).tolist()}"
    )
    del m64, mean64, var64
    torch.cuda.empty_cache()

    # Reference on a smaller input, f64: the kernels against the plain path on
    # the card and against the same model on the CPU.
    tc, yc = make_data(N_CHECK, SEED + 6)
    m_k, m_c = rbf_model(tc, yc, torch.float64), rbf_model(tc, yc, torch.float64, device="cpu")
    (loss_k, grad_k), (loss_p, grad_p), (loss_c, grad_c) = value_and_grad(m_k), plain_strip_value_and_grad(m_k), value_and_grad(m_c)
    with torch.no_grad():
        mean_k, var_k = m_k.predict_f(queries)
        mean_c, var_c = m_c.predict_f(queries)
    print(
        f"strip check f64 N={N_CHECK}: loss kernels {float(loss_k):.10f} plain {float(loss_p):.10f} cpu {float(loss_c):.10f}; "
        f"gradient kernels {grad_k.tolist()} plain {grad_p.tolist()} cpu {grad_c.tolist()}; "
        f"predict_f vs cpu: mean {max_abs(mean_k, mean_c):.2e} var {max_abs(var_k, var_c):.2e}"
    )
    check(abs(float(loss_k - loss_p)) <= 1e-9 * abs(float(loss_p)), "strip f64 LML, kernels vs plain")
    check(abs(float(loss_k) - float(loss_c)) <= 1e-9 * abs(float(loss_c)), "strip f64 LML, card vs CPU")
    check(allclose(grad_k, grad_p, 1e-7, 1e-10), "strip f64 gradient, kernels vs plain")
    check(allclose(grad_k, grad_c, 1e-7, 1e-10), "strip f64 gradient, card vs CPU")
    check(allclose(mean_k.cpu(), mean_c, 1e-7, 1e-9) and allclose(var_k.cpu(), var_c, 1e-7, 1e-9), "strip f64 predict_f, card vs CPU")
    del m_k, m_c
    torch.cuda.empty_cache()

    # (b) the Kalman API on an explicit model: the caller's planes.
    t, y = make_data(N_FULL, SEED)
    kernel = Matern52(0.8, 0.4, dtype=torch.float32, device=DEV)
    planes = strip_inputs(kernel, t, y, torch.float32)
    Fs, Qs, P0, H, R, yt = planes
    ts = torch.as_tensor(t, dtype=torch.float32, device=DEV)
    plane_bytes = Fs.numel() * Fs.element_size() + Qs.numel() * Qs.element_size()
    strip.reset_launch_counts()
    with torch.no_grad():
        sms, sPs = pkfs(LGSSMTL(P0, Fs, Qs, H, R), yt, engine="strip")
        api_counts = dict(strip.LAUNCHES)
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
    counts = {k: counts[k] + api_counts[k] for k in STRIP_KERNELS}
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
    dt.reset_launch_counts()
    loss, grad = value_and_grad(model)
    step_counts = dict(dt.LAUNCHES)
    fitted, history = fit_adam(start, n_iters=N_ADAM)
    adam_counts = dict(dt.LAUNCHES)
    lbfgs_fitted, lbfgs_history = fit_lbfgs(start, n_iters=N_LBFGS)
    torch.cuda.synchronize()
    counts = dict(dt.LAUNCHES)
    print(f"training f32 N={N_FULL}: loss {float(loss):.6f}, gradient (variance, lengthscale, noise) {grad.tolist()}")
    print(f"  launches of one step {step_counts}, after {N_ADAM} Adam steps {adam_counts}, after {N_LBFGS} L-BFGS steps {counts}")
    check(bool(torch.isfinite(loss)) and bool(torch.isfinite(grad).all()), "f32 loss or gradient not finite")
    check(step_counts == STEP_LAUNCHES, f"one training step launched {step_counts}, expected {STEP_LAUNCHES}")
    want = {k: (1 + N_ADAM) * v for k, v in STEP_LAUNCHES.items()}
    check(adam_counts == want, f"launches after Adam {adam_counts}, expected {want}")
    # Every L-BFGS evaluation is one training step too: the five counts stay
    # equal, and each of its steps makes at least one.
    check(len(set(counts.values())) == 1 and counts["dt_fisher"] >= 1 + N_ADAM + N_LBFGS, f"launches after L-BFGS {counts}")
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
        # The plain exclusive prefix between the passes, on the card.
        pf_ms = cuda_ms(lambda: dt.exclusive_chunk_prefixes(tot_f, d, reverse=False), reps=5)
        ps_ms = cuda_ms(lambda: dt.exclusive_chunk_prefixes(tot_s, d, reverse=True), reps=5)
        print(f"chunk prefixes N={N_FULL} f32 [{card}]: filter {pf_ms:.3f} ms, smoother {ps_ms:.3f} ms")
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


def phase_strip_times(card: str, model, queries, planes, counts) -> list:
    """The strip kernels at the two shapes the strip path gives them — the
    RBF(order=6) model's planes (d = 6, N = 1M) and the explicit Matern52
    model's (d = 3, N = 10M) — and the entry points of that path."""
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
        torch.cuda.reset_peak_memory_stats()
        lml_ms = cuda_ms(model.log_marginal_likelihood, reps=5)
        lml_peak = torch.cuda.max_memory_allocated() / 2**30
        planes_ms = cuda_ms(lambda: model.kernel.get_ssm_tl(model.ts, R), reps=3)
        torch.cuda.reset_peak_memory_stats()
        pred_ms = cuda_ms(lambda: model.predict_f(queries), reps=5)
        pred_peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(lambda: value_and_grad(model), reps=5)
    step_peak = torch.cuda.max_memory_allocated() / 2**30
    model.zero_grad(set_to_none=True)
    print(
        f"pkfs(engine='strip') Matern52 N={N_FULL} f32 [{card}]: {api_ms:.3f} ms on given planes (peak {api_peak:.2f} GiB, "
        f"planes included); building the planes (get_ssm_tl) {build_ms:.3f} ms; pkfs_dt on the same data {api_dt_ms:.3f} ms"
    )
    print(f"RBF(order=6) planes N={N_STRIP} f32: {plane_mb:.0f} MB (F and Q); get_ssm_tl {planes_ms:.3f} ms")
    print(f"strip LML RBF(order=6) N={N_STRIP} f32 [{card}]: {lml_ms:.3f} ms (peak {lml_peak:.2f} GiB)")
    print(f"strip predict_f 1000 queries RBF(order=6) N={N_STRIP} f32 [{card}]: {pred_ms:.3f} ms (peak {pred_peak:.2f} GiB)")
    print(f"strip training step (LML + backward) RBF(order=6) N={N_STRIP} f32 [{card}]: {step_ms:.3f} ms (peak {step_peak:.2f} GiB)")
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
    from torch.profiler import ProfilerActivity, profile

    def lml():
        with torch.no_grad():
            model.log_marginal_likelihood()

    calls = {"LML": lml, "predict_f": lambda: model.predict_f(queries), "training step": lambda: value_and_grad(model)}
    for call, fn in calls.items():
        walls = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
        wall = float(np.median(walls[1:]))
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
        if not by_name:
            print(f"profile {call} {what}: the profiler recorded no device events; device time not measured")
            continue
        busy = sum(by_name.values())
        parts = ", ".join(f"{k} {v:.3f}" for k, v in sorted(by_name.items(), key=lambda kv: -kv[1]))
        print(
            f"profile {call} {what} f32 [{card}]: wall {wall:.3f} ms, device {busy:.3f} ms in {n_kernels} kernels "
            f"({parts}), idle share {max(0.0, 1.0 - busy / wall):.3f}"
        )
    model.zero_grad(set_to_none=True)


def main() -> int:
    card = phase_device()
    phase_build()
    phase_kernels()
    model, data, queries, serving = phase_slice()
    training = phase_training(model, data)
    print(f"launches: serving path {serving}, training path {training}")
    for name in DT_KERNELS:
        check(serving[name] + training[name] > 0 and training[name] > 0, f"{name} was never launched on the training path")
    counts = {name: serving[name] + training[name] for name in DT_KERNELS}
    records = phase_times(card, model, queries, counts)
    phase_profile(card, f"Matern52 N={N_FULL}", model, queries[0])
    del model, data
    torch.cuda.empty_cache()
    rbf, rbf_queries, planes, strip_counts = phase_strip_slice()
    print(f"launches: strip path {strip_counts}")
    for name in STRIP_KERNELS:
        check(strip_counts[name] > 0, f"{name} was never launched on the strip path")
    records += phase_strip_times(card, rbf, rbf_queries, planes, strip_counts)
    del planes
    phase_profile(card, f"RBF(order=6) N={N_STRIP}", rbf, rbf_queries)
    phase_sequential_time(card)
    print(f"card: {card}")
    print(json.dumps({"kernels": records}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
