// The batched filter and smoother as one block a series walking its tiles in
// order: the kernels' first design, kept at the units where the chained
// tiles of batched_scan.cu measured slower (kBatched*Walk there; ptxas gives
// those chained kernels 32–64 registers and 100+ KB of spills, these 255).
//
// One thread block owns one series (grid = B) and walks its time axis in
// tiles of NT·K steps, forwards for the filter and backwards for the
// smoother.  Within a tile each thread folds its K consecutive steps to a
// total in registers, the block scans the NT totals in shared memory
// (Kogge–Stone, log2 NT rounds, the first total seeded with the carry),
// each thread re-folds its K steps from its exclusive prefix and writes the
// moments, and the tile's last inclusive element becomes the carry of the
// next tile.  The filter's log-likelihood is summed per thread over all its
// steps, then over the block in a fixed tree, and written to ell[series].
// Shared memory: (NT + 1) elements by component.  Layouts and arguments as
// the chained kernels', with K the steps a thread.
#pragma once

#include <cuda_runtime.h>

#include "scan_passes.cuh"

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
    batched_walk_filter_kernel(const S* __restrict__ scal, const S* __restrict__ Fs, long long f_ps, long long f_bs,
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
    batched_walk_smoother_kernel(const S* __restrict__ hs, const S* __restrict__ Fs, long long f_ps, long long f_bs,
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
