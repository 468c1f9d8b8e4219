#!/usr/bin/env python3
"""Smoke test of the PyTorch port (parallel_gps_torch) on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each failing the run (non-zero exit, no result line) on error:

  1. device: the card's name and power limit (nvidia-smi); a CUDA device is
     required;
  2. build: compile the dt-engine kernels from parallel_gps_torch/csrc;
  3. kernels vs plain: for Matern12/32/52 at T = 65,537 with ~10% missing
     observations, the CUDA filter and smoother against their plain PyTorch
     versions, float64 to the JAX interpret-test tolerances, float32 against
     float64 truth;
  4. the serving path at full size: StateSpaceGP(Matern52(0.8, 0.4), noise
     0.1), N = 10,000,000 float32 observations — one LML and three
     predict_f requests of 1,000 unsorted queries — with the launch counts
     that path requires; the same in float64; and at N = 262,144 float64 the
     model against its plain versions;
  5. times (CUDA events, medians): each kernel against its plain version at
     N = 10M float32, the LML and one predict_f request.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from parallel_gps_torch import StateSpaceGP  # noqa: E402
from parallel_gps_torch.kalman import _cuda  # noqa: E402
from parallel_gps_torch.kalman import dt  # noqa: E402
from parallel_gps_torch.kernels import Matern12, Matern32, Matern52  # noqa: E402

N_FULL = 10_000_000
N_CHECK = 262_144
T_KERNEL = 65_537  # a multiple of no chunk size
NOISE = 0.1
SEED = 0
DEV = "cuda"

SOURCE = "parallel_gps_torch/csrc/dt_scan.cu"
REPLACES = {
    "dt_filter_scan": "parallel_gps_tpu/kalman/pallas_dt.py:179",
    "dt_filter_apply": "parallel_gps_tpu/kalman/pallas_dt.py:208",
    "dt_smoother_scan": "parallel_gps_tpu/kalman/pallas_dt.py:553",
    "dt_smoother_apply": "parallel_gps_tpu/kalman/pallas_dt.py:589",
}
# Launches the serving path makes: the filter passes for the LML, and all
# four passes for each predict_f request.
N_REQUESTS = 3
EXPECTED_LAUNCHES = {
    "dt_filter_scan": 1 + N_REQUESTS,
    "dt_filter_apply": 1 + N_REQUESTS,
    "dt_smoother_scan": N_REQUESTS,
    "dt_smoother_apply": N_REQUESTS,
}

# float32 checks: the kernel's float32 result must be as close to float64
# truth as the plain float32 engine's, within F32_FACTOR (the two fold the
# same elements in different orders, so their rounding differs but not its
# scale), or within F32_FLOOR relative to the quantity's magnitude.
F32_FACTOR = 10.0
F32_FLOOR = 1e-5


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
    for line in log.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print("  ptxas:", line.split("ptxas info    :")[-1].strip())


def phase_kernels() -> None:
    """Filter and smoother through the kernels against their plain versions."""
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

            # float32 against float64 truth, beside the plain float32 engine.
            g_t, L_t = g_p, L_p
            fam, co, P0, H, R, dts, yt = engine_inputs(kcls, params, t, y, torch.float32)
            b_k, C_k, ell_k32 = dt.strip_filter_dt(fam, co, P0, H, R, dts, yt)
            g_k, L_k = dt.strip_smoother_dt(fam, co, P0, dts, b_k, C_k)
            b_q, C_q, ell_q32 = dt.strip_filter_dt_plain(fam, co, P0, H, R, dts, yt)
            g_q, L_q = dt.strip_smoother_dt_plain(fam, co, P0, dts, b_q, C_q)
            torch.cuda.synchronize()
        errs = {
            "b": (rel_err(b_k, b_p), rel_err(b_q, b_p)),
            "C": (rel_err(C_k, C_p), rel_err(C_q, C_p)),
            "ell": (abs(float(ell_k32) - float(ell_p)) / abs(float(ell_p)), abs(float(ell_q32) - float(ell_p)) / abs(float(ell_p))),
            "g": (rel_err(g_k, g_t), rel_err(g_q, g_t)),
            "L": (rel_err(L_k, L_t), rel_err(L_q, L_t)),
        }
        print(f"{name} f32 vs f64 truth (kernel / plain f32): " + " ".join(f"{k} {a:.2e}/{b:.2e}" for k, (a, b) in errs.items()))
        for k, (a, b) in errs.items():
            check(a <= max(F32_FACTOR * b, F32_FLOOR), f"{name} f32 {k}: kernel {a:.3e} vs plain {b:.3e}")


def phase_slice():
    """The serving path at full size; returns the f32 model, the queries and
    the launch counts of the path."""
    t, y = make_data(N_FULL, SEED)
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
        lml_only = {"dt_filter_scan": 1, "dt_filter_apply": 1, "dt_smoother_scan": 0, "dt_smoother_apply": 0}
        check(after_lml == lml_only, f"{tag} LML launches {after_lml}, expected {lml_only}")
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
    return m32, queries, counts32


def phase_times(card: str, model, queries, counts) -> list:
    """Kernel vs plain at N = 10M float32, and the serving entry points."""
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

        for name, (kern, plain, args) in passes.items():
            as64 = tuple(a.double() if isinstance(a, torch.Tensor) else a for a in args)
            out_k = kern(*args)
            out_p = plain(*args)
            out_t = plain(*as64)
            torch.cuda.synchronize()
            out_k, out_p, out_t = ([o] if isinstance(o, torch.Tensor) else list(o) for o in (out_k, out_p, out_t))
            err = max(max_abs(a, b) for a, b in zip(out_k, out_p))
            rk = max(rel_err(a, c) for a, c in zip(out_k, out_t))
            rp = max(rel_err(a, c) for a, c in zip(out_p, out_t))
            del out_k, out_p, out_t, as64
            torch.cuda.empty_cache()
            ms = cuda_ms(lambda: kern(*args), reps=10)
            plain_ms = cuda_ms(lambda: plain(*args), reps=3)
            torch.cuda.empty_cache()
            print(
                f"{name} N={N_FULL} f32 [{card}]: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms; "
                f"|kernel - plain| {err:.3e}; vs f64 truth kernel {rk:.2e} plain {rp:.2e}"
            )
            check(rk <= max(F32_FACTOR * rp, F32_FLOOR), f"{name}: f32 kernel {rk:.3e} vs plain {rp:.3e}")
            records.append({
                "name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
                "launches": counts[name], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            })
        # The plain exclusive prefix between the passes, on the card.
        pf_ms = cuda_ms(lambda: dt.exclusive_chunk_prefixes(tot_f, d, reverse=False), reps=5)
        ps_ms = cuda_ms(lambda: dt.exclusive_chunk_prefixes(tot_s, d, reverse=True), reps=5)
        print(f"chunk prefixes N={N_FULL} f32 [{card}]: filter {pf_ms:.3f} ms, smoother {ps_ms:.3f} ms")
        del passes, tot_f, pre_f, b, C, tot_s, pre_s
        torch.cuda.empty_cache()

        torch.cuda.reset_peak_memory_stats()
        lml_ms = cuda_ms(model.log_marginal_likelihood, reps=5)
        lml_peak = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        pred_ms = cuda_ms(lambda: model.predict_f(queries[0]), reps=5)
        pred_peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"LML N={N_FULL} f32 [{card}]: {lml_ms:.3f} ms (peak {lml_peak:.2f} GiB)")
    print(f"predict_f 1000 queries N={N_FULL} f32 [{card}]: {pred_ms:.3f} ms (peak {pred_peak:.2f} GiB)")
    return records


def main() -> int:
    card = phase_device()
    phase_build()
    phase_kernels()
    model, queries, counts = phase_slice()
    records = phase_times(card, model, queries, counts)
    print(json.dumps({"kernels": records}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
