// The single-pass batched filter and smoother, hand-written for Hopper
// (sm_90a): B independent series (or B MCMC chains over one series) through
// ONE launch each, on time-last planes with a batch axis.
//
// Replaces parallel_gps_tpu/kalman/pallas_scan.py _batched_filter_kernel
// (:1271, pallas_call :1542) and _batched_smoother_kernel (:1385, pallas_call
// :1637).  What carries over from them is the contract — one launch per call,
// a running element carried across tiles of time inside the kernel, no
// host-side prefix between two passes, a per-series log-likelihood — and none
// of the TPU layout (8 series on sublanes, a flattened sequential grid, lane
// rolls, front padding for the reverse walk, a stash of the next block's
// boundary column, a batch padded to a multiple of 8).
//
// Design.  One thread block owns one series (grid = B) and walks its time
// axis in tiles of NT·K steps, forwards for the filter and backwards for the
// smoother.  Within a tile each thread folds its K consecutive steps to a
// total in registers, the block scans the NT totals in shared memory
// (Kogge–Stone, log2 NT rounds of filt_combine / smooth_combine, the first
// total seeded with the carry), each thread re-folds its K steps from its
// exclusive prefix and writes the moments, and the tile's last inclusive
// element becomes the carry of the next tile.  The element algebra and the
// per-step element constructors are those of the two-pass kernels (scan_passes.cuh,
// dt_elements.cuh).  Tails are handled by bounds: the filter's last tile and
// the smoother's last-processed tile (the one at the start of the series) are
// the short ones, and every step is folded exactly once.
//
// The filter's log-likelihood is summed per thread over all its steps, then
// over the block in a fixed tree, and written to ell[series]: no atomics, so
// two runs give the same bits.
//
// Layouts: an operand with a batch axis is addressed as
// base + q·plane_stride + series·batch_stride + t; a batch stride of 0 shares
// one operand between all series (one model and B observation vectors, or one
// y for B chains) without expanding it.  Outputs are contiguous (D, B, T) and
// (D, D, B, T).  Filter scalars: (B, D²+D+1) rows [P0 | h | r]; the
// smoother's projection reads h as (B, D).  A missing observation is a NaN
// of y.
//
// Shared memory: a filtering element is 3D²+2D values (33 at D = 3, 208 at
// D = 8), so the block size falls with D (TileThreads, dt_elements.cuh) to
// keep NT elements plus the carry within what a block may hold; above 48 KB
// the launcher opts in (cudaFuncAttributeMaxDynamicSharedMemorySize).
//
// What bounds these kernels on an H100: latency, by design.  B blocks of NT
// threads occupy at most B of the 132 SMs with a few warps each, and a tile
// is a chain of 2K + log2 NT dependent combines, so they sit far above their
// byte bound ((3D²+D+1) values a step for the filter, (4D²+2D) [+2 with the
// projection] for the smoother).  Splitting one series over several blocks
// needs a look-back between blocks and is not done here.
//
// One translation unit per state dimension and scalar type: compile with
// -DPGT_D=<1..8> -DPGT_F64=<0|1> (kalman/_cuda.py); the entry points carry
// both in their names (pgt_batched_filter_d3_f32, ...).  The loops around the
// combines are kept rolled (#pragma unroll 1): unrolled, the seven rounds of
// the scan alone would be seven inlined copies of the combine, and the D = 8
// units would take minutes to compile.
#include <cuda_runtime.h>

#include "scan_passes.cuh"

#ifndef PGT_D
#error "compile with -DPGT_D=<state dimension, 1..8>"
#endif
#if PGT_D < 1 || PGT_D > 8
#error "PGT_D must be in 1..8"
#endif
#ifndef PGT_F64
#error "compile with -DPGT_F64=<0 for float, 1 for double>"
#endif

namespace pgt {

extern __shared__ __align__(16) unsigned char pgt_batched_smem[];

// One series' view of the strided F and Q planes, with the filter's scalars.
template <typename S, int D>
struct SeriesFilterSource {
  S P0[D * D];
  S h[D];
  S r;
  const S* Fs;
  const S* Qs;
  long long fs;  // plane strides
  long long qs;

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
      F[q] = Fs[q * fs + t];
      Q[q] = Qs[q * qs + t];
    }
  }
};

template <typename S, int D>
struct SeriesSmootherSource {
  const S* Fs;
  const S* Qs;
  long long fs;
  long long qs;

  __device__ __forceinline__ void fq(long long t, S* F, S* Q) const {
#pragma unroll
    for (int q = 0; q < D * D; ++q) {
      F[q] = Fs[q * fs + t];
      Q[q] = Qs[q * qs + t];
    }
  }
};

template <typename S, int D>
__device__ __forceinline__ void filt_identity(Filt<S, D>& e) {
#pragma unroll
  for (int i = 0; i < D; ++i) {
    e.b[i] = S(0);
    e.eta[i] = S(0);
#pragma unroll
    for (int j = 0; j < D; ++j) {
      e.A[i * D + j] = (i == j) ? S(1) : S(0);
      e.C[i * D + j] = S(0);
      e.J[i * D + j] = S(0);
    }
  }
}

template <typename S, int D>
__device__ __forceinline__ void smooth_identity(Smooth<S, D>& e) {
#pragma unroll
  for (int i = 0; i < D; ++i) {
    e.g[i] = S(0);
#pragma unroll
    for (int j = 0; j < D; ++j) {
      e.E[i * D + j] = (i == j) ? S(1) : S(0);
      e.L[i * D + j] = S(0);
    }
  }
}

// ---------------------------------------------------------------------------
// Batched filter: filtering elements, their forward scan with a carry across
// tiles, the filtered b and C, and the per-series log-likelihood, one pass.
// Shared memory: (NT + 1) elements by component (sm[k·NT + thread], then the
// carry); the first NT values serve the final sum of the log-likelihood.
// ---------------------------------------------------------------------------
template <typename S, int D, int NT>
__global__ void __launch_bounds__(NT)
    batched_filter_kernel(const S* __restrict__ scal, const S* __restrict__ Fs, long long f_ps, long long f_bs,
                          const S* __restrict__ Qs, long long q_ps, long long q_bs, const S* __restrict__ y,
                          long long y_bs, S* __restrict__ b_out, S* __restrict__ C_out, S* __restrict__ ell,
                          long long T, int B, int K) {
  constexpr int kRows = ElementRows<D>::kFilt;
  S* sm = reinterpret_cast<S*>(pgt_batched_smem);
  S* carry_sm = sm + kRows * NT;
  const int tid = threadIdx.x;
  const long long series = blockIdx.x;
  const long long out_ps = (long long)B * T;  // plane stride of the outputs

  SeriesFilterSource<S, D> p;
  p.load(scal + series * (D * D + D + 1));
  p.Fs = Fs + series * f_bs;
  p.Qs = Qs + series * q_bs;
  p.fs = f_ps;
  p.qs = q_ps;
  const S* ys = y + series * y_bs;
  S* bo = b_out + series * T;
  S* Co = C_out + series * T;

  const long long tile = (long long)NT * K;
  S ll = S(0);
#pragma unroll 1
  for (long long tile0 = 0; tile0 < T; tile0 += tile) {
    const long long left = T - tile0;
    const int n_active = (int)(((left < tile ? left : tile) + K - 1) / K);
    const bool active = tid < n_active;
    const long long t0 = tile0 + (long long)tid * K;
    const long long t1 = (t0 + K < T) ? t0 + K : T;

    Filt<S, D> mine, pre, e;
    S F[D * D], Q[D * D], yc;
    bool observed;
    if (active) {
      // Fold this thread's steps to their total.
      filter_step<S, D>(p, ys, t0, F, Q, yc, observed, mine);
#pragma unroll 1
      for (long long t = t0 + 1; t < t1; ++t) {
        filter_step<S, D>(p, ys, t, F, Q, yc, observed, e);
        mine = filt_combine<S, D>(mine, e);
      }
      if (tid == 0) {
        // Seed the tile with the carry; thread 0's exclusive prefix is the
        // carry itself (the identity in the first tile).
        if (tile0 > 0) {
          load_filt<S, D>(carry_sm, 1, 0, pre);
          mine = filt_combine<S, D>(pre, mine);
        } else {
          filt_identity<S, D>(pre);
        }
      }
      store_filt<S, D>(sm, NT, tid, mine);
    }
    __syncthreads();
    // Inclusive Kogge–Stone scan of the totals; idle threads sit above the
    // active ones and are never read.
#pragma unroll 1
    for (int s = 1; s < NT; s <<= 1) {
      const bool takes = active && tid >= s;
      if (takes) load_filt<S, D>(sm, NT, tid - s, e);
      __syncthreads();
      if (takes) {
        mine = filt_combine<S, D>(e, mine);
        store_filt<S, D>(sm, NT, tid, mine);
      }
      __syncthreads();
    }
    if (active && tid > 0) load_filt<S, D>(sm, NT, tid - 1, pre);
    if (tid == n_active - 1) store_filt<S, D>(carry_sm, 1, 0, mine);
    __syncthreads();
    if (active) {
      // Re-fold from the exclusive prefix; write the moments and add the
      // steps' log-likelihood.
#pragma unroll 1
      for (long long t = t0; t < t1; ++t) {
        filter_step<S, D>(p, ys, t, F, Q, yc, observed, e);
        if (observed) ll += step_loglik<S, D>(p, F, Q, yc, pre, t == 0);
        pre = filt_combine<S, D>(pre, e);
#pragma unroll
        for (int a = 0; a < D; ++a) bo[a * out_ps + t] = pre.b[a];
#pragma unroll
        for (int q = 0; q < D * D; ++q) Co[q * out_ps + t] = pre.C[q];
      }
    }
  }
  // The series' log-likelihood: the threads' sums in a fixed tree.
  __syncthreads();
  sm[tid] = ll;
  __syncthreads();
#pragma unroll
  for (int s = NT / 2; s > 0; s >>= 1) {
    if (tid < s) sm[tid] += sm[tid + s];
    __syncthreads();
  }
  if (tid == 0) ell[series] = sm[0];
}

// ---------------------------------------------------------------------------
// Batched smoother: smoothing elements from F, Q at t+1 and the filtered
// (b, C) at t, their reverse scan with a carry, the smoothed g and L and,
// with PROJECT, the H-projections mean = h·g and var = hᵀ L h.  Thread j of
// a tile owns the j-th chunk counted from the tile's END, so the scan over
// threads runs from later to earlier times like the carry.
// ---------------------------------------------------------------------------
template <typename S, int D, int NT, bool PROJECT>
__global__ void __launch_bounds__(NT)
    batched_smoother_kernel(const S* __restrict__ hs, const S* __restrict__ Fs, long long f_ps, long long f_bs,
                            const S* __restrict__ Qs, long long q_ps, long long q_bs, const S* __restrict__ b,
                            long long b_ps, long long b_bs, const S* __restrict__ C, long long c_ps, long long c_bs,
                            S* __restrict__ g_out, S* __restrict__ L_out, S* __restrict__ mean_out,
                            S* __restrict__ var_out, long long T, int B, int K) {
  constexpr int kRows = ElementRows<D>::kSmooth;
  S* sm = reinterpret_cast<S*>(pgt_batched_smem);
  S* carry_sm = sm + kRows * NT;
  const int tid = threadIdx.x;
  const long long series = blockIdx.x;
  const long long out_ps = (long long)B * T;

  SeriesSmootherSource<S, D> p{Fs + series * f_bs, Qs + series * q_bs, f_ps, q_ps};
  const S* bs = b + series * b_bs;
  const S* Cs = C + series * c_bs;
  S* go = g_out + series * T;
  S* Lo = L_out + series * T;
  S h[D];
  if (PROJECT) {
#pragma unroll
    for (int a = 0; a < D; ++a) h[a] = hs[series * D + a];
  }

  const long long tile = (long long)NT * K;
#pragma unroll 1
  for (long long end = T; end > 0; end -= tile) {
    const int n_active = (int)(((end < tile ? end : tile) + K - 1) / K);
    const bool active = tid < n_active;
    const long long hi = end - (long long)tid * K;  // this thread's steps: [lo, hi)
    const long long lo = (hi - K > 0) ? hi - K : 0;

    Smooth<S, D> mine, pre, e;
    if (active) {
      smoother_step<S, D>(p, bs, b_ps, Cs, c_ps, hi - 1, T, mine);
#pragma unroll 1
      for (long long t = hi - 2; t >= lo; --t) {
        smoother_step<S, D>(p, bs, b_ps, Cs, c_ps, t, T, e);
        mine = smooth_combine<S, D>(mine, e);
      }
      if (tid == 0) {
        if (end < T) {
          load_smooth<S, D>(carry_sm, 1, 0, pre);
          mine = smooth_combine<S, D>(pre, mine);
        } else {
          smooth_identity<S, D>(pre);
        }
      }
      store_smooth<S, D>(sm, NT, tid, mine);
    }
    __syncthreads();
#pragma unroll 1
    for (int s = 1; s < NT; s <<= 1) {
      const bool takes = active && tid >= s;
      if (takes) load_smooth<S, D>(sm, NT, tid - s, e);
      __syncthreads();
      if (takes) {
        mine = smooth_combine<S, D>(e, mine);
        store_smooth<S, D>(sm, NT, tid, mine);
      }
      __syncthreads();
    }
    if (active && tid > 0) load_smooth<S, D>(sm, NT, tid - 1, pre);
    if (tid == n_active - 1) store_smooth<S, D>(carry_sm, 1, 0, mine);
    __syncthreads();
    if (active) {
#pragma unroll 1
      for (long long t = hi - 1; t >= lo; --t) {
        smoother_step<S, D>(p, bs, b_ps, Cs, c_ps, t, T, e);
        pre = smooth_combine<S, D>(pre, e);
#pragma unroll
        for (int a = 0; a < D; ++a) go[a * out_ps + t] = pre.g[a];
#pragma unroll
        for (int q = 0; q < D * D; ++q) Lo[q * out_ps + t] = pre.L[q];
        if (PROJECT) {
          S mean = h[0] * pre.g[0];
#pragma unroll
          for (int a = 1; a < D; ++a) mean += h[a] * pre.g[a];
          S var = S(0);
#pragma unroll
          for (int a = 0; a < D; ++a)
#pragma unroll
            for (int c = 0; c < D; ++c) var += h[a] * h[c] * pre.L[a * D + c];
          mean_out[series * T + t] = mean;
          var_out[series * T + t] = var;
        }
      }
    }
  }
}

}  // namespace pgt

// C interface, bound with ctypes (kalman/_cuda.py), one set of entry points
// per state dimension and scalar type.  Each entry launches one kernel on the
// given stream, does not synchronise, and returns cudaGetLastError() (0 on
// success), the error of the shared-memory opt-in, or kBadArgs.
#if PGT_F64
typedef double pgt_scalar;
#define PGT_TYPE_TAG _f64
#else
typedef float pgt_scalar;
#define PGT_TYPE_TAG _f32
#endif
#define PGT_CAT2(a, b) a##b
#define PGT_CAT(a, b) PGT_CAT2(a, b)
#define PGT_ENTRY(name) PGT_CAT(PGT_CAT(PGT_CAT(name, _d), PGT_D), PGT_TYPE_TAG)

template <bool PROJECT>
static int launch_batched_smoother(const void* h, const void* Fs, long long f_ps, long long f_bs, const void* Qs,
                                   long long q_ps, long long q_bs, const void* b, long long b_ps, long long b_bs,
                                   const void* C, long long c_ps, long long c_bs, void* g, void* L, void* mean,
                                   void* var, long long T, int B, int K, void* stream) {
  typedef pgt_scalar S;
  constexpr int NT = pgt::TileThreads<PGT_D>::kN;
  auto kern = pgt::batched_smoother_kernel<S, PGT_D, NT, PROJECT>;
  const int bytes = (int)(sizeof(S) * pgt::ElementRows<PGT_D>::kSmooth * (NT + 1));
  cudaError_t rc = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc != cudaSuccess) return (int)rc;
  kern<<<(unsigned int)B, NT, bytes, (cudaStream_t)stream>>>(
      (const S*)h, (const S*)Fs, f_ps, f_bs, (const S*)Qs, q_ps, q_bs, (const S*)b, b_ps, b_bs, (const S*)C, c_ps,
      c_bs, (S*)g, (S*)L, (S*)mean, (S*)var, T, B, K);
  return (int)cudaGetLastError();
}

extern "C" {

// scal: (B, D²+D+1) rows [P0 | h | r]; Fs, Qs: element (q, series, t) at
// q·ps + series·bs + t; y: series·y_bs + t; b (D, B, T), C (D, D, B, T),
// ell (B,) contiguous.
int PGT_ENTRY(pgt_batched_filter)(const void* scal, const void* Fs, long long f_ps, long long f_bs, const void* Qs,
                                  long long q_ps, long long q_bs, const void* y, long long y_bs, void* b, void* C,
                                  void* ell, long long T, int B, int K, void* stream) {
  typedef pgt_scalar S;
  if (T < 1 || B < 1 || K < 1) return pgt::kBadArgs;
  constexpr int NT = pgt::TileThreads<PGT_D>::kN;
  auto kern = pgt::batched_filter_kernel<S, PGT_D, NT>;
  const int bytes = (int)(sizeof(S) * pgt::ElementRows<PGT_D>::kFilt * (NT + 1));
  cudaError_t rc = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc != cudaSuccess) return (int)rc;
  kern<<<(unsigned int)B, NT, bytes, (cudaStream_t)stream>>>((const S*)scal, (const S*)Fs, f_ps, f_bs, (const S*)Qs,
                                                             q_ps, q_bs, (const S*)y, y_bs, (S*)b, (S*)C, (S*)ell,
                                                             T, B, K);
  return (int)cudaGetLastError();
}

// h: (B, D), read with project only; b, C like Fs with their own strides;
// g (D, B, T), L (D, D, B, T) and, with project, mean and var (B, T),
// contiguous.
int PGT_ENTRY(pgt_batched_smoother)(int project, const void* h, const void* Fs, long long f_ps, long long f_bs,
                                    const void* Qs, long long q_ps, long long q_bs, const void* b, long long b_ps,
                                    long long b_bs, const void* C, long long c_ps, long long c_bs, void* g, void* L,
                                    void* mean, void* var, long long T, int B, int K, void* stream) {
  if (T < 1 || B < 1 || K < 1) return pgt::kBadArgs;
  return project ? launch_batched_smoother<true>(h, Fs, f_ps, f_bs, Qs, q_ps, q_bs, b, b_ps, b_bs, C, c_ps, c_bs, g, L,
                                                 mean, var, T, B, K, stream)
                 : launch_batched_smoother<false>(h, Fs, f_ps, f_bs, Qs, q_ps, q_bs, b, b_ps, b_bs, C, c_ps, c_bs, g,
                                                  L, mean, var, T, B, K, stream);
}

}  // extern "C"
