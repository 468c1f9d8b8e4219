// The four scan passes of the dt-engine, hand-written for Hopper (sm_90a).
//
// Each thread owns a contiguous chunk of K time steps.  For every step it
// rebuilds the transition F and the noise Q from dt and the kernel's
// transition coefficients (dt_elements.cuh: build_fq) and forms the scan
// element in registers; nothing per step but dt, y and the moments is read or
// written.  A pass-1 kernel folds each chunk to its total; the exclusive
// prefix over the (n, n_chunks) totals runs between the passes (plain PyTorch
// on the device, kalman/dt.py); a pass-2 kernel re-folds each chunk seeded
// with its prefix and writes the moments.
//
// Layouts are time-last, as at the port's public functions: dt, y (T,);
// b, g (D, T); C, L (D, D, T); totals and prefixes (n, n_chunks).
// Scalars (dt_launch.cuh): filter [P0 (D²) | h (D) | r | coeffs], smoother
// [P0 | coeffs].
//
// What bounds these kernels on an H100, and what the design does about it:
// the work per step is a dependent chain of small dense algebra (a filtering
// combine at D=3 is ~400 flops with a 3x3 inverse), so each thread is
// latency-bound on its own chain, and the card is kept busy by many
// independent chunks in flight; the elements stay in registers and the F/Q
// planes never exist in memory.  Memory access is the other bound: a thread
// walks its own chunk, so a warp's loads and stores are strided by K and are
// not coalesced (staging tiles through shared memory is left for later
// work).  Each kernel below notes which of the two bounds it.
#include <cuda_runtime.h>

#include "dt_launch.cuh"

namespace pgt {

// Filtering element of step t; also returns its F, Q and cleaned observation.
template <typename S, int D>
__device__ __forceinline__ void filter_step(const FilterScalars<S, D>& p, const S* dt, const S* y, long long t,
                                            S* F, S* Q, S& yc, bool& observed, Filt<S, D>& e) {
  const S yv = y[t];
  observed = !(yv != yv);  // NaN marks a missing observation
  yc = observed ? yv : S(0);
  build_fq<S, D>(p.c, p.degree, p.P0, dt[t], F, Q);
  build_filtering<S, D>(F, Q, yc, observed ? S(1) : S(0), p.h, p.r, p.P0, t == 0, e);
}

// Smoothing element of step t: F, Q at dt[t+1] and the filtered (m, P) at t;
// the global-last step is (E = 0, g = m, L = P).
template <typename S, int D>
__device__ __forceinline__ void smoother_step(const SmootherScalars<S, D>& p, const S* dt, const S* b, const S* C,
                                              long long t, long long T, Smooth<S, D>& e) {
  S m[D], P[D * D];
#pragma unroll
  for (int a = 0; a < D; ++a) m[a] = b[a * T + t];
#pragma unroll
  for (int q = 0; q < D * D; ++q) P[q] = C[q * T + t];
  if (t == T - 1) {
    build_smoothing_last<S, D>(m, P, e);
  } else {
    S Fn[D * D], Qn[D * D];
    build_fq<S, D>(p.c, p.degree, p.P0, dt[t + 1], Fn, Qn);
    build_smoothing<S, D>(Fn, Qn, m, P, e);
  }
}

// ---------------------------------------------------------------------------
// Filter pass 1.  Replaces parallel_gps_tpu/kalman/pallas_dt.py
// _dt_filter_scan_kernel (:179, pallas_call :341): per-chunk totals.
// Bound: the combine chain (it reads 8 bytes a step and writes one total
// per chunk); measured 0.40 ms at T = 10M f32, D = 3.
// ---------------------------------------------------------------------------
template <typename S, int D>
__global__ void __launch_bounds__(kThreads)
    dt_filter_scan_kernel(const S* __restrict__ scal, int degree, const S* __restrict__ dt, const S* __restrict__ y,
                          S* __restrict__ totals, long long T, int K, long long n_chunks) {
  const long long c = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (c >= n_chunks) return;
  FilterScalars<S, D> p;
  p.load(scal, degree);
  const long long t0 = c * K;
  const long long t1 = (t0 + K < T) ? t0 + K : T;
  S F[D * D], Q[D * D], yc;
  bool observed;
  Filt<S, D> acc, e;
  filter_step<S, D>(p, dt, y, t0, F, Q, yc, observed, acc);
  for (long long t = t0 + 1; t < t1; ++t) {
    filter_step<S, D>(p, dt, y, t, F, Q, yc, observed, e);
    acc = filt_combine<S, D>(acc, e);
  }
  store_filt<S, D>(totals, n_chunks, c, acc);
}

// ---------------------------------------------------------------------------
// Filter pass 2.  Replaces pallas_dt.py _dt_filter_apply_kernel (:208,
// pallas_call :369): seeded re-fold, filtered moments, and the streamed
// log p(y_t | y_<t) (pallas_dt.py:270-281) from the previous moments — the
// prefix-included element before step t, or (0, P0) at global t = 0.
// Per-thread sums are reduced per block in a fixed order (no atomics).
// Bound: the strided stores of b and C (12 values a step at D = 3), not the
// algebra it shares with pass 1; measured 9.1 ms at T = 10M f32.
// ---------------------------------------------------------------------------
template <typename S, int D>
__global__ void __launch_bounds__(kThreads)
    dt_filter_apply_kernel(const S* __restrict__ scal, int degree, const S* __restrict__ prefix,
                           const S* __restrict__ dt, const S* __restrict__ y, S* __restrict__ b_out,
                           S* __restrict__ C_out, S* __restrict__ ell_parts, long long T, int K, long long n_chunks) {
  __shared__ S red[kThreads];
  const long long c = (long long)blockIdx.x * kThreads + threadIdx.x;
  S ll = S(0);
  if (c < n_chunks) {
    FilterScalars<S, D> p;
    p.load(scal, degree);
    const S log2pi = S(1.8378770664093454835606594728112);  // log(2π)
    const long long t0 = c * K;
    const long long t1 = (t0 + K < T) ? t0 + K : T;
    Filt<S, D> acc, e;
    load_filt<S, D>(prefix, n_chunks, c, acc);
    for (long long t = t0; t < t1; ++t) {
      S F[D * D], Q[D * D], yc;
      bool observed;
      filter_step<S, D>(p, dt, y, t, F, Q, yc, observed, e);
      if (observed) {
        S mprev[D], Pprev[D * D];
#pragma unroll
        for (int a = 0; a < D; ++a) mprev[a] = (t == 0) ? S(0) : acc.b[a];
#pragma unroll
        for (int q = 0; q < D * D; ++q) Pprev[q] = (t == 0) ? p.P0[q] : acc.C[q];
        S hF[D], hQ[D], PhF[D];
#pragma unroll
        for (int j = 0; j < D; ++j) {
          S sf = p.h[0] * F[j], sq = p.h[0] * Q[j];
#pragma unroll
          for (int k = 1; k < D; ++k) {
            sf += p.h[k] * F[k * D + j];
            sq += p.h[k] * Q[k * D + j];
          }
          hF[j] = sf;
          hQ[j] = sq;
        }
        mv<S, D>(Pprev, hF, PhF);
        S mean = hF[0] * mprev[0], v1 = hF[0] * PhF[0], v2 = hQ[0] * p.h[0];
#pragma unroll
        for (int j = 1; j < D; ++j) {
          mean += hF[j] * mprev[j];
          v1 += hF[j] * PhF[j];
          v2 += hQ[j] * p.h[j];
        }
        const S var = v1 + v2 + p.r;
        const S diff = yc - mean;
        ll += S(-0.5) * (diff * diff / var + dlog(var) + log2pi);
      }
      acc = filt_combine<S, D>(acc, e);
#pragma unroll
      for (int a = 0; a < D; ++a) b_out[a * T + t] = acc.b[a];
#pragma unroll
      for (int q = 0; q < D * D; ++q) C_out[q * T + t] = acc.C[q];
    }
  }
  red[threadIdx.x] = ll;
  __syncthreads();
#pragma unroll
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) ell_parts[blockIdx.x] = red[0];
}

// ---------------------------------------------------------------------------
// Smoother pass 1.  Replaces pallas_dt.py _dt_smoother_scan_kernel (:553,
// pallas_call :685): reverse fold of each chunk to its suffix total.  The
// next step's dt is read directly (t+1 < T), in place of the TPU kernel's
// cross-strip boundary-dt column.
// Bound: the strided loads of b and C (12 values a step at D = 3); measured
// 4.0 ms at T = 10M f32.
// ---------------------------------------------------------------------------
template <typename S, int D>
__global__ void __launch_bounds__(kThreads)
    dt_smoother_scan_kernel(const S* __restrict__ scal, int degree, const S* __restrict__ dt,
                            const S* __restrict__ b, const S* __restrict__ C, S* __restrict__ totals, long long T,
                            int K, long long n_chunks) {
  const long long c = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (c >= n_chunks) return;
  SmootherScalars<S, D> p;
  p.load(scal, degree);
  const long long t0 = c * K;
  const long long t1 = (t0 + K < T) ? t0 + K : T;
  Smooth<S, D> acc, e;
  smoother_step<S, D>(p, dt, b, C, t1 - 1, T, acc);
  for (long long t = t1 - 2; t >= t0; --t) {
    smoother_step<S, D>(p, dt, b, C, t, T, e);
    acc = smooth_combine<S, D>(acc, e);
  }
  store_smooth<S, D>(totals, n_chunks, c, acc);
}

// ---------------------------------------------------------------------------
// Smoother pass 2.  Replaces pallas_dt.py _dt_smoother_apply_kernel (:589,
// pallas_call :724): reverse re-fold seeded with the chunk's exclusive
// suffix; writes the smoothed g and L.
// Bound: strided loads of b, C and stores of g, L (24 values a step at
// D = 3); measured 12.2 ms at T = 10M f32.
// ---------------------------------------------------------------------------
template <typename S, int D>
__global__ void __launch_bounds__(kThreads)
    dt_smoother_apply_kernel(const S* __restrict__ scal, int degree, const S* __restrict__ prefix,
                             const S* __restrict__ dt, const S* __restrict__ b, const S* __restrict__ C,
                             S* __restrict__ g_out, S* __restrict__ L_out, long long T, int K, long long n_chunks) {
  const long long c = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (c >= n_chunks) return;
  SmootherScalars<S, D> p;
  p.load(scal, degree);
  const long long t0 = c * K;
  const long long t1 = (t0 + K < T) ? t0 + K : T;
  Smooth<S, D> acc, e;
  load_smooth<S, D>(prefix, n_chunks, c, acc);
  for (long long t = t1 - 1; t >= t0; --t) {
    smoother_step<S, D>(p, dt, b, C, t, T, e);
    acc = smooth_combine<S, D>(acc, e);
#pragma unroll
    for (int a = 0; a < D; ++a) g_out[a * T + t] = acc.g[a];
#pragma unroll
    for (int q = 0; q < D * D; ++q) L_out[q * T + t] = acc.L[q];
  }
}

}  // namespace pgt

// C interface, bound with ctypes (kalman/_cuda.py).  Each entry launches one
// kernel on the given stream, does not synchronise, and returns
// cudaGetLastError() (0 on success) or kBadArgs.
extern "C" {

int pgt_threads_per_block(void) { return pgt::kThreads; }

const char* pgt_error_string(int rc) {
  if (rc == pgt::kBadArgs) return "unsupported arguments (d, degree, T or chunk)";
  return cudaGetErrorString((cudaError_t)rc);
}

int pgt_dt_filter_scan(int is64, int d, int degree, const void* scal, const void* dt, const void* y, void* totals,
                       long long T, int K, void* stream) {
  if (pgt::bad_shape(d, degree, T, K)) return pgt::kBadArgs;
  const long long n_chunks = (T + K - 1) / K;
  cudaStream_t st = (cudaStream_t)stream;
#define PGT_LAUNCH(S, DD)                                                                          \
  pgt::dt_filter_scan_kernel<S, DD><<<pgt::n_blocks(n_chunks), pgt::kThreads, 0, st>>>(            \
      (const S*)scal, degree, (const S*)dt, (const S*)y, (S*)totals, T, K, n_chunks)
  PGT_DISPATCH(is64, d, PGT_LAUNCH);
#undef PGT_LAUNCH
  return (int)cudaGetLastError();
}

int pgt_dt_filter_apply(int is64, int d, int degree, const void* scal, const void* prefix, const void* dt,
                        const void* y, void* b, void* C, void* ell_parts, long long T, int K, void* stream) {
  if (pgt::bad_shape(d, degree, T, K)) return pgt::kBadArgs;
  const long long n_chunks = (T + K - 1) / K;
  cudaStream_t st = (cudaStream_t)stream;
#define PGT_LAUNCH(S, DD)                                                                          \
  pgt::dt_filter_apply_kernel<S, DD><<<pgt::n_blocks(n_chunks), pgt::kThreads, 0, st>>>(           \
      (const S*)scal, degree, (const S*)prefix, (const S*)dt, (const S*)y, (S*)b, (S*)C, (S*)ell_parts, T, K, \
      n_chunks)
  PGT_DISPATCH(is64, d, PGT_LAUNCH);
#undef PGT_LAUNCH
  return (int)cudaGetLastError();
}

int pgt_dt_smoother_scan(int is64, int d, int degree, const void* scal, const void* dt, const void* b, const void* C,
                         void* totals, long long T, int K, void* stream) {
  if (pgt::bad_shape(d, degree, T, K)) return pgt::kBadArgs;
  const long long n_chunks = (T + K - 1) / K;
  cudaStream_t st = (cudaStream_t)stream;
#define PGT_LAUNCH(S, DD)                                                                          \
  pgt::dt_smoother_scan_kernel<S, DD><<<pgt::n_blocks(n_chunks), pgt::kThreads, 0, st>>>(          \
      (const S*)scal, degree, (const S*)dt, (const S*)b, (const S*)C, (S*)totals, T, K, n_chunks)
  PGT_DISPATCH(is64, d, PGT_LAUNCH);
#undef PGT_LAUNCH
  return (int)cudaGetLastError();
}

int pgt_dt_smoother_apply(int is64, int d, int degree, const void* scal, const void* prefix, const void* dt,
                          const void* b, const void* C, void* g, void* L, long long T, int K, void* stream) {
  if (pgt::bad_shape(d, degree, T, K)) return pgt::kBadArgs;
  const long long n_chunks = (T + K - 1) / K;
  cudaStream_t st = (cudaStream_t)stream;
#define PGT_LAUNCH(S, DD)                                                                          \
  pgt::dt_smoother_apply_kernel<S, DD><<<pgt::n_blocks(n_chunks), pgt::kThreads, 0, st>>>(         \
      (const S*)scal, degree, (const S*)prefix, (const S*)dt, (const S*)b, (const S*)C, (S*)g, (S*)L, T, K, \
      n_chunks)
  PGT_DISPATCH(is64, d, PGT_LAUNCH);
#undef PGT_LAUNCH
  return (int)cudaGetLastError();
}

}  // extern "C"
