// The four scan passes of the plane-streaming ("strip") engine, hand-written
// for Hopper (sm_90a): the filter and smoother of an explicit linear-Gaussian
// state-space model whose per-step transitions F and noises Q are given as
// time-last (D, D, T) planes.  They serve every model the dt-engine does not:
// a state-space model the caller built, and kernels without a closed-form
// transition family (state dimension up to 8).
//
// The algorithm is the dt-engine's (dt_scan.cu) and the pass bodies are shared
// with it (scan_passes.cuh): each thread folds a contiguous chunk of K steps in
// registers, a pass-1 kernel writes one total per chunk, the exclusive prefix
// over the (n, n_chunks) totals runs between the passes (plain PyTorch on the
// device, kalman/strip.py), and a pass-2 kernel re-folds each chunk seeded
// with its prefix and writes the moments.  The one difference is the source of
// a step's F and Q: 2·D² loads from the planes at step t (the smoother: at
// t+1, read directly) in place of the rebuild from dt.  The TPU kernels'
// 8-strip layout, front padding for the reverse scan, cross-strip boundary
// columns and separate mask plane have no counterpart: missing observations
// are the NaNs of y.
//
// Layouts: Fs, Qs, C, L (D, D, T); y (T,); b, g (D, T); totals and prefixes
// (n, n_chunks).  Filter scalars: [P0 (D²) | h (D) | r].
//
// What bounds these kernels on an H100: as in dt_scan.cu a thread's chain of
// D×D algebra, and strided (uncoalesced) plane accesses K steps apart — here
// 2·D² more loads a step than the dt kernels.  From about D = 5 (float) or
// D = 4 (double) two elements and the combine's temporaries no longer fit in
// 255 registers and spill to local memory; the spills are accepted and
// reported by ptxas (-Xptxas -v).
//
// One translation unit per state dimension: compile with -DPGT_D=<1..8>, so
// that the eight fully unrolled instantiations build side by side
// (kalman/_cuda.py).  The entry points carry the dimension in their names
// (pgt_strip_filter_scan_d6, ...).
#include <cuda_runtime.h>

#include "scan_passes.cuh"

#ifndef PGT_D
#error "compile with -DPGT_D=<state dimension, 1..8>"
#endif
#if PGT_D < 1 || PGT_D > 8
#error "PGT_D must be in 1..8"
#endif

namespace pgt {

// Sources of a step's F and Q for the shared pass bodies: loads from the
// (D, D, T) planes.
template <typename S, int D>
struct PlaneFilterSource {
  S P0[D * D];
  S h[D];
  S r;
  const S* Fs;
  const S* Qs;
  long long T;

  __device__ __forceinline__ void load(const S* scal) {
#pragma unroll
    for (int q = 0; q < D * D; ++q) P0[q] = scal[q];
#pragma unroll
    for (int q = 0; q < D; ++q) h[q] = scal[D * D + q];
    r = scal[D * D + D];
  }

  __device__ __forceinline__ void fq(long long t, S* F, S* Q) const {
#pragma unroll
    for (int q = 0; q < D * D; ++q) {
      F[q] = Fs[q * T + t];
      Q[q] = Qs[q * T + t];
    }
  }
};

template <typename S, int D>
struct PlaneSmootherSource {
  const S* Fs;
  const S* Qs;
  long long T;

  __device__ __forceinline__ void fq(long long t, S* F, S* Q) const {
#pragma unroll
    for (int q = 0; q < D * D; ++q) {
      F[q] = Fs[q * T + t];
      Q[q] = Qs[q * T + t];
    }
  }
};

// ---------------------------------------------------------------------------
// Filter pass 1.  Replaces parallel_gps_tpu/kalman/pallas_scan.py
// _strip_filter_scan_kernel (:766, pallas_call :999): per-chunk totals of the
// filtering elements built from the streamed F, Q planes and y.
// Bound: bytes — it reads (2D²+1) values a step and writes one total per
// chunk; the strided plane loads keep it above that bound.
// ---------------------------------------------------------------------------
template <typename S, int D>
__global__ void __launch_bounds__(kThreads)
    strip_filter_scan_kernel(const S* __restrict__ scal, const S* __restrict__ Fs, const S* __restrict__ Qs,
                             const S* __restrict__ y, S* __restrict__ totals, long long T, int K,
                             long long n_chunks) {
  const long long c = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (c >= n_chunks) return;
  PlaneFilterSource<S, D> p;
  p.load(scal);
  p.Fs = Fs;
  p.Qs = Qs;
  p.T = T;
  filter_scan_chunk<S, D>(p, y, totals, T, K, n_chunks, c);
}

// ---------------------------------------------------------------------------
// Filter pass 2.  Replaces pallas_scan.py _strip_filter_apply_kernel (:798,
// pallas_call :1036): re-fold seeded with the prefix, the filtered b and C,
// and the streamed log p(y_t | y_<t) from the previous moments
// (pallas_scan.py:851-896), summed per block in a fixed order (no atomics).
// Bound: bytes — (3D²+D+1) values a step, strided loads and stores.
// ---------------------------------------------------------------------------
template <typename S, int D>
__global__ void __launch_bounds__(kThreads)
    strip_filter_apply_kernel(const S* __restrict__ scal, const S* __restrict__ prefix, const S* __restrict__ Fs,
                              const S* __restrict__ Qs, const S* __restrict__ y, S* __restrict__ b_out,
                              S* __restrict__ C_out, S* __restrict__ ell_parts, long long T, int K,
                              long long n_chunks) {
  const long long c = (long long)blockIdx.x * kThreads + threadIdx.x;
  S ll = S(0);
  if (c < n_chunks) {
    PlaneFilterSource<S, D> p;
    p.load(scal);
    p.Fs = Fs;
    p.Qs = Qs;
    p.T = T;
    ll = filter_apply_chunk<S, D>(p, prefix, y, b_out, C_out, T, K, n_chunks, c);
  }
  block_sum<S>(ll, ell_parts);
}

// ---------------------------------------------------------------------------
// Smoother pass 1.  Replaces pallas_scan.py _strip_smoother_scan_kernel
// (:1795, pallas_call :1938): reverse fold of each chunk's smoothing elements
// (F, Q at t+1 and the filtered b, C at t) to its suffix total.
// Bound: bytes — (3D²+D) values a step, strided loads.
// ---------------------------------------------------------------------------
template <typename S, int D>
__global__ void __launch_bounds__(kThreads)
    strip_smoother_scan_kernel(const S* __restrict__ Fs, const S* __restrict__ Qs, const S* __restrict__ b,
                               const S* __restrict__ C, S* __restrict__ totals, long long T, int K,
                               long long n_chunks) {
  const long long c = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (c >= n_chunks) return;
  PlaneSmootherSource<S, D> p{Fs, Qs, T};
  smoother_scan_chunk<S, D>(p, b, C, totals, T, K, n_chunks, c);
}

// ---------------------------------------------------------------------------
// Smoother pass 2.  Replaces pallas_scan.py _strip_smoother_apply_kernel
// (:1840, pallas_call :1977): reverse re-fold seeded with the chunk's
// exclusive suffix; writes the smoothed g and L.
// Bound: bytes — (4D²+2D) values a step, strided loads and stores.
// ---------------------------------------------------------------------------
template <typename S, int D>
__global__ void __launch_bounds__(kThreads)
    strip_smoother_apply_kernel(const S* __restrict__ prefix, const S* __restrict__ Fs, const S* __restrict__ Qs,
                                const S* __restrict__ b, const S* __restrict__ C, S* __restrict__ g_out,
                                S* __restrict__ L_out, long long T, int K, long long n_chunks) {
  const long long c = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (c >= n_chunks) return;
  PlaneSmootherSource<S, D> p{Fs, Qs, T};
  smoother_apply_chunk<S, D>(p, prefix, b, C, g_out, L_out, T, K, n_chunks, c);
}

}  // namespace pgt

// C interface, bound with ctypes (kalman/_cuda.py), one set of entry points
// per state dimension.  Each entry launches one kernel on the given stream,
// does not synchronise, and returns cudaGetLastError() (0 on success) or
// kBadArgs.
#define PGT_CAT2(a, b) a##b
#define PGT_CAT(a, b) PGT_CAT2(a, b)
#define PGT_ENTRY(name) PGT_CAT(PGT_CAT(name, _d), PGT_D)

// Runs LAUNCH(S) for the scalar type asked for.
#define PGT_DISPATCH_TYPE(IS64, LAUNCH) \
  do {                                  \
    if (IS64) {                         \
      LAUNCH(double);                   \
    } else {                            \
      LAUNCH(float);                    \
    }                                   \
  } while (0)

extern "C" {

int PGT_ENTRY(pgt_strip_filter_scan)(int is64, const void* scal, const void* Fs, const void* Qs, const void* y,
                                     void* totals, long long T, int K, void* stream) {
  if (T < 1 || K < 1) return pgt::kBadArgs;
  const long long n_chunks = (T + K - 1) / K;
  cudaStream_t st = (cudaStream_t)stream;
#define PGT_LAUNCH(S)                                                                               \
  pgt::strip_filter_scan_kernel<S, PGT_D><<<pgt::n_blocks(n_chunks), pgt::kThreads, 0, st>>>(       \
      (const S*)scal, (const S*)Fs, (const S*)Qs, (const S*)y, (S*)totals, T, K, n_chunks)
  PGT_DISPATCH_TYPE(is64, PGT_LAUNCH);
#undef PGT_LAUNCH
  return (int)cudaGetLastError();
}

int PGT_ENTRY(pgt_strip_filter_apply)(int is64, const void* scal, const void* prefix, const void* Fs, const void* Qs,
                                      const void* y, void* b, void* C, void* ell_parts, long long T, int K,
                                      void* stream) {
  if (T < 1 || K < 1) return pgt::kBadArgs;
  const long long n_chunks = (T + K - 1) / K;
  cudaStream_t st = (cudaStream_t)stream;
#define PGT_LAUNCH(S)                                                                               \
  pgt::strip_filter_apply_kernel<S, PGT_D><<<pgt::n_blocks(n_chunks), pgt::kThreads, 0, st>>>(      \
      (const S*)scal, (const S*)prefix, (const S*)Fs, (const S*)Qs, (const S*)y, (S*)b, (S*)C,      \
      (S*)ell_parts, T, K, n_chunks)
  PGT_DISPATCH_TYPE(is64, PGT_LAUNCH);
#undef PGT_LAUNCH
  return (int)cudaGetLastError();
}

int PGT_ENTRY(pgt_strip_smoother_scan)(int is64, const void* Fs, const void* Qs, const void* b, const void* C,
                                       void* totals, long long T, int K, void* stream) {
  if (T < 1 || K < 1) return pgt::kBadArgs;
  const long long n_chunks = (T + K - 1) / K;
  cudaStream_t st = (cudaStream_t)stream;
#define PGT_LAUNCH(S)                                                                               \
  pgt::strip_smoother_scan_kernel<S, PGT_D><<<pgt::n_blocks(n_chunks), pgt::kThreads, 0, st>>>(     \
      (const S*)Fs, (const S*)Qs, (const S*)b, (const S*)C, (S*)totals, T, K, n_chunks)
  PGT_DISPATCH_TYPE(is64, PGT_LAUNCH);
#undef PGT_LAUNCH
  return (int)cudaGetLastError();
}

int PGT_ENTRY(pgt_strip_smoother_apply)(int is64, const void* prefix, const void* Fs, const void* Qs, const void* b,
                                        const void* C, void* g, void* L, long long T, int K, void* stream) {
  if (T < 1 || K < 1) return pgt::kBadArgs;
  const long long n_chunks = (T + K - 1) / K;
  cudaStream_t st = (cudaStream_t)stream;
#define PGT_LAUNCH(S)                                                                               \
  pgt::strip_smoother_apply_kernel<S, PGT_D><<<pgt::n_blocks(n_chunks), pgt::kThreads, 0, st>>>(    \
      (const S*)prefix, (const S*)Fs, (const S*)Qs, (const S*)b, (const S*)C, (S*)g, (S*)L, T, K,   \
      n_chunks)
  PGT_DISPATCH_TYPE(is64, PGT_LAUNCH);
#undef PGT_LAUNCH
  return (int)cudaGetLastError();
}

}  // extern "C"
