// The fused Fisher tail of the dt-engine's backward, hand-written for Hopper
// (sm_90a).  Replaces parallel_gps_tpu/kalman/pallas_dt.py _dt_fisher_kernel
// (:839, pallas_call :1134).
//
// From dt, y and the filtered (b, C) and smoothed (g, L) moments it computes
// the cancellation-free Fisher cotangents of one LML evaluation
// (kalman/timelast.py::fisher_grads_from_smoothed),
//
//   ∇Q_k = ½ (Pp⁻¹ D Pp⁻¹ + r rᵀ),  r_k = Pp_k⁻¹ δ_k,
//   ∇F_k = r_k m̂_{k−1}ᵀ + Pp⁻¹ D E_{k−1}ᵀ,  E_{k−1} = P_{k−1} F_kᵀ Pp_k⁻¹,
//   ∇P0 += F₀ᵀ ∇Q₀ F₀,
//
// with Pp_k = F_k P_{k−1} F_kᵀ + Q_k, δ_k = m̂_k − F_k m_{k−1}, D_k = P̂_k − Pp_k,
// and chains (∇F, ∇Q) back to (coeffs, P0, dt_k) through the in-register
// build of F and Q (dt_elements.cuh: build_fq_vjp).  The (D, D, T) planes of
// F, Q and their cotangents never exist.
//
// The tail is scan-free: step k needs only step k−1 of b, C and g, which a
// thread reads directly (at k = 0: m = 0, P = P0 and m̂₋₁ = E₋₁ m̂₀), so there
// is one thread per step in a grid-stride loop and no state crosses threads.
// Neighbouring threads read and write neighbouring addresses of every plane:
// the loads and stores are coalesced.
//
// A batch axis: B series (or B chains over one series) in one launch, the
// series on the grid's second axis.  Each reads its own row of the scalar
// table and its own (D, B, T) / (D, D, B, T) moments; dt and y are shared
// (batch stride 0) or per series.  B = 1 is the single-series call, with
// the same arithmetic in the same order.  The TPU package has no batched
// Fisher kernel: under vmap it falls back to the planes and an XLA tail.
//
// Outputs: d_dt (B, T), d_y (B, T) and, per series and block, one row of sums
// [d_coeffs (kMaxCoef) | d_P0 (D², unsymmetrised) | d_H (D) | d_R].  Each
// thread sums its steps in registers, each block reduces its threads in a
// fixed tree in shared memory, and the caller adds the rows with one
// reduction: no atomics, so two runs give the same bits.
//
// Bound on an H100: bytes.  A step reads 2 + 2(D + D²) values and writes 2
// (104 bytes at D = 3 in float32) for a few hundred flops.
//
// The spectral family (RBF, D = 1..8; dt_fisher_spectral_kernel) has up to
// 513 coefficients, and its row of sums up to 586 values at D = 8: they fit
// neither a thread's registers nor, a copy per thread, a block's shared
// memory.  But a step's coefficient cotangents factor: block k's G and S
// receive em1_k·dA and es_k·dA, dA = ∂ℓ/∂Am1 of the step (dt_elements.cuh:
// spectral_vjp), so a block sums them a tile at a time as a small product.
// Each of its threads writes its step's dA (D²), weights (em1_k, es_k) and
// its other terms (d c[0], d_P0, d_H, d_R) as one column of a tile in shared
// memory; after a barrier, each thread sums, over the tile's kThreads steps
// in a fixed order, the few outputs it owns (Σ_s w_m[s]·dA_q[s], or Σ_s of a
// column's row), carried in registers from tile to tile.  The tile is
// (2D² + (D+1)/2·2 + D + 2) rows of kThreads + 1 values (the pad keeps a
// warp's reads of one step on distinct banks): 150,672 bytes at D = 8 in
// double, within a block's 232,448.  No atomics: two runs give the same bits.
// Scalars: the rows of [P0 (D²) | h (D) | r | c], c the Spectral<D> table,
// copied to shared memory once a block (SpectralScalars).
//
// The composite family (Periodic, Sum, Product; dt_fisher_composite_kernel)
// sums the same way: its Am1 = Σ_μ W_μ·K_μ (dt_elements.cuh: composite_am1)
// gives K_μ the cotangent W_μ·dA a step, and each weight w_m a cotangent
// dw_m = Σ_{μ ∋ m} ⟨dA, K_μ⟩·Π_{other factors} w, whence its rate's
// dw_m·∂w_m/∂ρ_m and dt's Σ_m dw_m·∂w_m/∂dt.  The tile holds dA (D²), the
// monomials W_μ (kMaxMonomials), the rates' terms (kMaxWeights), d_P0, d_H
// and d_R; the row of sums is [d_ρ (kMaxWeights) | d_K (kMaxMonomials·D²) |
// d_P0 | d_H | d_R], the matrices of the unused monomials left zero.  The
// similarity folded into each K_μ gets no cotangent of its own: it is a
// constant of the coefficients (the reference's stop_gradient).  210,216
// bytes of tile and table at D = 8 in double.
//
// The lane-split body (fisher_lanes; the spectral and composite units whose
// bit in k{Spectral,Composite}Lanes{F32,F64} is set).  One thread a step
// carries the whole d = 8 algebra — the inverse of Pp, about ten 8×8
// products, the build and its chain rule — and ptxas gave it 255 registers
// and 2 KB of spills in float32, 32 registers and 64–103 KB in float64,
// with one 128-thread block an SM.  Here a group of kG lanes (1, 2, 4, 8:
// the power of two ≥ D) carries a step: lane i holds row i of every d×d
// matrix (lanes ≥ D repeat row D − 1 and write nothing), the rows another
// lane needs go through the group's scratch in shared memory (four d×d
// slots, rows read in 16-byte loads), Pp⁻¹ is Gauss–Jordan elimination
// across the lanes (Pp is SPD: no pivoting; the pivot row by __shfl_sync),
// and the group's sums (⟨dA, K_μ⟩, h·P̂·h) are butterflies, so every lane
// holds the same bits.  A block of 256 threads (128 in float64 at
// D ≥ 5) runs rounds of kG-lane groups: each round stages the moments of
// its steps and of the step before them (b, g, C, L, coalesced, plane by
// plane) into shared memory, so that step t − 1 comes from there; each
// step writes its dA and its weights as one column of a tile; the tile is
// then contracted over the plan's live weights only (W_m·dA_q summed over
// the round's steps, a thread a weight and four rows of dA: one load of W
// feeds four FMAs), and its row sums (the rates' terms, dt·∂ℓ/∂u) summed
// alone.  The lanes' own sums (d_P0, d_H, d_R) stay in registers and are
// added over the groups in a fixed order at the end.  No atomics: two runs
// give the same bits.  The row of sums has the tile body's layout.  On an
// H100 it wins where the tile body spills or nearly does — float D = 8,
// double D = 7, 8 — and loses 1.3–4× below: a step's lanes hold about
// eight times one thread's registers between them, so fewer steps are in
// flight, and its chain of shuffles, shared-memory loads and group barriers
// is no shorter than one thread's algebra (PERF.md §6).
//
// One translation unit per state dimension (kalman/_cuda.py: VARIANTS):
// compile with -DPGT_D=<1..8>.
#include <cuda_runtime.h>

#include <type_traits>

#include "dt_launch.cuh"

#ifndef PGT_D
#error "compile with -DPGT_D=<state dimension, 1..8>"
#endif

namespace pgt {

// Layout of a row of sums.
template <int D>
struct FisherSums {
  static constexpr int kP0 = Exppoly<D>::kMaxCoef;
  static constexpr int kH = kP0 + D * D;
  static constexpr int kR = kH + D;
  static constexpr int kN = kR + 1;
};

// The Fisher terms of step t that do not depend on the family, from its F
// and Q: loads the smoothed (m̂, P̂) of step t into mhat, Phat and returns
// the cotangents dF and dQ, adding the first step's F₀ᵀ ∇Q₀ F₀ to acc_P0.
// ``ms`` is the plane stride of the moments (T for one series, B·T batched).
template <typename S, int D>
__device__ __forceinline__ void fisher_dfdq(const S* P0, const S* F, const S* Q, const S* b, const S* C, const S* g,
                                            const S* L, long long t, long long ms, S* mhat, S* Phat, S* dF, S* dQ,
                                            S* acc_P0) {
  const bool first = (t == 0);
  const long long tp = first ? 0 : t - 1;
  S m_prev[D], P_prev[D * D];
#pragma unroll
  for (int a = 0; a < D; ++a) {
    const S v = b[a * ms + tp];
    m_prev[a] = first ? S(0) : v;
    mhat[a] = g[a * ms + t];
  }
#pragma unroll
  for (int q = 0; q < D * D; ++q) {
    const S v = C[q * ms + tp];
    P_prev[q] = first ? P0[q] : v;
    Phat[q] = L[q * ms + t];
  }

  // Predicted moments and the only inverse: Pp = F P_prev Fᵀ + Q.
  S FP[D * D], Pp[D * D], Pi[D * D];
  mm<S, D>(F, P_prev, FP);
  mm_symout<S, D>(FP, F, Q, Pp);
  inv<S, D>(Pp, Pi);
  S mp[D], delta[D], rk[D];
  mv<S, D>(F, m_prev, mp);
#pragma unroll
  for (int a = 0; a < D; ++a) delta[a] = mhat[a] - mp[a];
  mv<S, D>(Pi, delta, rk);

  S Dk[D * D], PiD[D * D], PiDPi[D * D];
#pragma unroll
  for (int q = 0; q < D * D; ++q) Dk[q] = Phat[q] - Pp[q];
  mm<S, D>(Pi, Dk, PiD);
  mm<S, D>(PiD, Pi, PiDPi);
#pragma unroll
  for (int a = 0; a < D; ++a)
#pragma unroll
    for (int c = 0; c < D; ++c) dQ[a * D + c] = S(0.5) * (PiDPi[a * D + c] + rk[a] * rk[c]);

  // E_prev = P_prev Fᵀ Pp⁻¹; at t = 0 it is the pre-initial gain E₋₁.
  S PFt[D * D], E[D * D];
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      S s = P_prev[i * D] * F[j * D];
#pragma unroll
      for (int k = 1; k < D; ++k) s += P_prev[i * D + k] * F[j * D + k];
      PFt[i * D + j] = s;
    }
  mm<S, D>(PFt, Pi, E);
  S Em[D], mh_prev[D];
  mv<S, D>(E, mhat, Em);
#pragma unroll
  for (int a = 0; a < D; ++a) {
    const S v = g[a * ms + tp];
    mh_prev[a] = first ? Em[a] : v;
  }
#pragma unroll
  for (int a = 0; a < D; ++a)
#pragma unroll
    for (int c = 0; c < D; ++c) {
      S s = rk[a] * mh_prev[c];
#pragma unroll
      for (int k = 0; k < D; ++k) s += PiD[a * D + k] * E[c * D + k];
      dF[a * D + c] = s;
    }

  // The first step's closed-form term F₀ᵀ ∇Q₀ F₀ of ∇P0.
  if (first) {
    S QF[D * D];
    mm<S, D>(dQ, F, QF);
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) {
        S s = F[i] * QF[j];
#pragma unroll
        for (int k = 1; k < D; ++k) s += F[k * D + i] * QF[k * D + j];
        acc_P0[i * D + j] += s;
      }
  }
}

// The observation terms of a step with observation yv (NaN marks a missing
// one, which adds nothing): adds to acc_H (D; divided by r at the end) and
// acc_R and returns ∂ℓ/∂y in d_y.
template <typename S, int D>
__device__ __forceinline__ void fisher_obs(const S* h, S r, S yv, const S* mhat, const S* Phat, S* acc_H, S& acc_R,
                                           S& d_y) {
  const bool observed = !(yv != yv);
  d_y = S(0);
  if (observed) {
    S HPhat[D];
    S Hm = h[0] * mhat[0];
#pragma unroll
    for (int k = 1; k < D; ++k) Hm += h[k] * mhat[k];
#pragma unroll
    for (int c = 0; c < D; ++c) {
      S s = h[0] * Phat[c];
#pragma unroll
      for (int k = 1; k < D; ++k) s += h[k] * Phat[k * D + c];
      HPhat[c] = s;
    }
    S HPH = h[0] * HPhat[0];
#pragma unroll
    for (int c = 1; c < D; ++c) HPH += h[c] * HPhat[c];
    const S resid = yv - Hm;
    const S rinv = S(1) / r;
    // ∇H = R⁻¹ Σ [(y − Hm̂) m̂ᵀ − H P̂]; the sums are divided by R at the end.
#pragma unroll
    for (int a = 0; a < D; ++a) acc_H[a] += resid * mhat[a] - HPhat[a];
    // ∇R = ½ Σ [R⁻¹ N R⁻¹ − R⁻¹], N = resid² + H P̂ Hᵀ.
    acc_R += S(0.5) * ((resid * resid + HPH) * rinv * rinv - rinv);
    d_y = -resid * rinv;
  }
}

// Step t of the exponential polynomial: adds its share to the sums and
// returns ∂ℓ/∂dt_t and ∂ℓ/∂y_t.  ``ms`` is the plane stride of the moments
// (T for one series, B·T batched).  The same terms as fisher_dfdq and
// fisher_obs, written out in one body: so written, the Matérn units compile
// to the code they had before the spectral family (the same ptxas lines;
// built from those two functions, the f64 D = 1 unit spilled 4 bytes less).
template <typename S, int D>
__device__ __forceinline__ void fisher_step(const FilterScalars<S, D>& p, const S* dt, const S* y, const S* b,
                                            const S* C, const S* g, const S* L, long long t, long long ms, S* acc,
                                            S& d_dt, S& d_y) {
  const bool first = (t == 0);
  const long long tp = first ? 0 : t - 1;
  const S dtv = dt[t];
  S Am1[D * D], M[D * D], F[D * D], Q[D * D];
  build_fq_parts<S, D>(p.c, p.degree, p.P0, dtv, Am1, M, F, Q);

  S m_prev[D], P_prev[D * D], mhat[D], Phat[D * D];
#pragma unroll
  for (int a = 0; a < D; ++a) {
    const S v = b[a * ms + tp];
    m_prev[a] = first ? S(0) : v;
    mhat[a] = g[a * ms + t];
  }
#pragma unroll
  for (int q = 0; q < D * D; ++q) {
    const S v = C[q * ms + tp];
    P_prev[q] = first ? p.P0[q] : v;
    Phat[q] = L[q * ms + t];
  }

  // Predicted moments and the only inverse: Pp = F P_prev Fᵀ + Q.
  S FP[D * D], Pp[D * D], Pi[D * D];
  mm<S, D>(F, P_prev, FP);
  mm_symout<S, D>(FP, F, Q, Pp);
  inv<S, D>(Pp, Pi);
  S mp[D], delta[D], rk[D];
  mv<S, D>(F, m_prev, mp);
#pragma unroll
  for (int a = 0; a < D; ++a) delta[a] = mhat[a] - mp[a];
  mv<S, D>(Pi, delta, rk);

  S Dk[D * D], PiD[D * D], PiDPi[D * D], dQ[D * D];
#pragma unroll
  for (int q = 0; q < D * D; ++q) Dk[q] = Phat[q] - Pp[q];
  mm<S, D>(Pi, Dk, PiD);
  mm<S, D>(PiD, Pi, PiDPi);
#pragma unroll
  for (int a = 0; a < D; ++a)
#pragma unroll
    for (int c = 0; c < D; ++c) dQ[a * D + c] = S(0.5) * (PiDPi[a * D + c] + rk[a] * rk[c]);

  // E_prev = P_prev Fᵀ Pp⁻¹; at t = 0 it is the pre-initial gain E₋₁.
  S PFt[D * D], E[D * D];
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      S s = P_prev[i * D] * F[j * D];
#pragma unroll
      for (int k = 1; k < D; ++k) s += P_prev[i * D + k] * F[j * D + k];
      PFt[i * D + j] = s;
    }
  mm<S, D>(PFt, Pi, E);
  S Em[D], mh_prev[D];
  mv<S, D>(E, mhat, Em);
#pragma unroll
  for (int a = 0; a < D; ++a) {
    const S v = g[a * ms + tp];
    mh_prev[a] = first ? Em[a] : v;
  }
  S dF[D * D];
#pragma unroll
  for (int a = 0; a < D; ++a)
#pragma unroll
    for (int c = 0; c < D; ++c) {
      S s = rk[a] * mh_prev[c];
#pragma unroll
      for (int k = 0; k < D; ++k) s += PiD[a * D + k] * E[c * D + k];
      dF[a * D + c] = s;
    }

  // The first step's closed-form term F₀ᵀ ∇Q₀ F₀ of ∇P0.
  if (first) {
    S QF[D * D];
    mm<S, D>(dQ, F, QF);
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) {
        S s = F[i] * QF[j];
#pragma unroll
        for (int k = 1; k < D; ++k) s += F[k * D + i] * QF[k * D + j];
        acc[FisherSums<D>::kP0 + i * D + j] += s;
      }
  }

  // (∇F, ∇Q) → (coeffs, P0, dt).
  S d_c[Exppoly<D>::kMaxCoef], d_P0[D * D];
  build_fq_vjp<S, D>(p.c, p.degree, p.P0, dtv, Am1, M, dF, dQ, d_c, d_P0, d_dt);
#pragma unroll
  for (int q = 0; q < Exppoly<D>::kMaxCoef; ++q) acc[q] += d_c[q];
#pragma unroll
  for (int q = 0; q < D * D; ++q) acc[FisherSums<D>::kP0 + q] += d_P0[q];

  // Observation terms, at observed steps only (NaN marks a missing one).
  const S yv = y[t];
  const bool observed = !(yv != yv);
  d_y = S(0);
  if (observed) {
    S HPhat[D];
    S Hm = p.h[0] * mhat[0];
#pragma unroll
    for (int k = 1; k < D; ++k) Hm += p.h[k] * mhat[k];
#pragma unroll
    for (int c = 0; c < D; ++c) {
      S s = p.h[0] * Phat[c];
#pragma unroll
      for (int k = 1; k < D; ++k) s += p.h[k] * Phat[k * D + c];
      HPhat[c] = s;
    }
    S HPH = p.h[0] * HPhat[0];
#pragma unroll
    for (int c = 1; c < D; ++c) HPH += p.h[c] * HPhat[c];
    const S resid = yv - Hm;
    const S rinv = S(1) / p.r;
    // ∇H = R⁻¹ Σ [(y − Hm̂) m̂ᵀ − H P̂]; the sums are divided by R at the end.
#pragma unroll
    for (int a = 0; a < D; ++a) acc[FisherSums<D>::kH + a] += resid * mhat[a] - HPhat[a];
    // ∇R = ½ Σ [R⁻¹ N R⁻¹ − R⁻¹], N = resid² + H P̂ Hᵀ.
    acc[FisherSums<D>::kR] += S(0.5) * ((resid * resid + HPH) * rinv * rinv - rinv);
    d_y = -resid * rinv;
  }
}

template <typename S, int D>
__global__ void __launch_bounds__(kThreads)
    dt_fisher_kernel(const S* __restrict__ scal, int n_scal, int degree, const S* __restrict__ dt, long long dt_bs,
                     const S* __restrict__ y, long long y_bs, const S* __restrict__ b, const S* __restrict__ C,
                     const S* __restrict__ g, const S* __restrict__ L, S* __restrict__ ddt_out,
                     S* __restrict__ dy_out, S* __restrict__ sums, long long T) {
  constexpr int kN = FisherSums<D>::kN;
  __shared__ S red[kThreads];
  // This block's series: its scalars, its slice of every plane.
  const long long series = blockIdx.y;
  const long long ms = (long long)gridDim.y * T;
  scal += series * n_scal;
  dt += series * dt_bs;
  y += series * y_bs;
  b += series * T;
  C += series * T;
  g += series * T;
  L += series * T;
  ddt_out += series * T;
  dy_out += series * T;
  sums += series * gridDim.x * kN;
  FilterScalars<S, D> p;
  p.load(scal, degree);
  S acc[kN];
#pragma unroll
  for (int q = 0; q < kN; ++q) acc[q] = S(0);
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long t = (long long)blockIdx.x * kThreads + threadIdx.x; t < T; t += stride) {
    S d_dt, d_y;
    fisher_step<S, D>(p, dt, y, b, C, g, L, t, ms, acc, d_dt, d_y);
    ddt_out[t] = d_dt;
    dy_out[t] = d_y;
  }
  const S rinv = S(1) / p.r;
#pragma unroll
  for (int a = 0; a < D; ++a) acc[FisherSums<D>::kH + a] *= rinv;
#pragma unroll
  for (int q = 0; q < kN; ++q) {
    red[threadIdx.x] = acc[q];
    __syncthreads();
#pragma unroll
    for (int s = kThreads / 2; s > 0; s >>= 1) {
      if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
      __syncthreads();
    }
    if (threadIdx.x == 0) sums[(long long)blockIdx.x * kN + q] = red[0];
    __syncthreads();
  }
}

// The spectral family's tile of per-step terms (module comment): rows
// dA (D²) | weights em1_k, es_k (kW) | d c[0] (1) | d_P0 (D²) | d_H (D) | d_R,
// each of kPitch values, one column a step; and its row of sums,
// [d_c (Spectral<D>::kCoef) | d_P0 (D²) | d_H (D) | d_R].
template <typename S, int D>
struct SpectralFisher {
  typedef Spectral<D> Sp;
  static constexpr int kW = 2 * Sp::kBlocks;
  static constexpr int kRowPlain = D * D + kW;  // the first row summed alone
  static constexpr int kRows = kRowPlain + 1 + D * D + D + 1;
  static constexpr int kPitch = kThreads + 1;
  static constexpr int kN = Sp::kCoef + D * D + D + 1;
  static constexpr int kH = Sp::kCoef + D * D;  // d_H's first sum
  static constexpr int kPerThread = (kN + kThreads - 1) / kThreads;
  static constexpr int kTableBytes = SpectralScalars<S, D, true>::kBytes;
  static constexpr int kBytes = kTableBytes + kRows * kPitch * (int)sizeof(S);
  static_assert(kBytes <= kSmemLimit, "the spectral Fisher tile does not fit a block");
};

extern __shared__ __align__(16) unsigned char pgt_fisher_smem[];

// Σ_k row[k] over a tile's kThreads columns: a float tile in a double
// accumulator, a double one in eight interleaved partial sums added
// pairwise.  One serial float sum of 128 lost the digits of the float32
// bare Periodic's d_H, whose terms cancel to 1/10⁴ of their magnitudes
// (chip_smoke.check_fisher_edges).
template <typename S>
__device__ __forceinline__ S tile_sum(const S* row) {
  if constexpr (sizeof(S) == 4) {
    double p[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll 8
    for (int k = 0; k < kThreads; ++k) p[k & 3] += (double)row[k];
    return (S)((p[0] + p[1]) + (p[2] + p[3]));
  } else {
    S p[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) p[j] = S(0);
#pragma unroll 8
    for (int k = 0; k < kThreads; ++k) p[k & 7] += row[k];
    return ((p[0] + p[1]) + (p[2] + p[3])) + ((p[4] + p[5]) + (p[6] + p[7]));
  }
}

// The composite family's tile (module comment): rows dA (D²) | W_μ
// (kMaxMonomials) | the rates' terms (kMaxWeights) | d_P0 (D²) | d_H (D) |
// d_R, each of kPitch values, one column a step; and its row of sums,
// [d_ρ | d_K | d_P0 | d_H | d_R].  The rates' rows and the rest are
// consecutive, so that an output o < kMaxWeights or ≥ kCoef sums one row.
template <typename S, int D>
struct CompositeFisher {
  typedef Composite<D> Cp;
  static constexpr int kRowW = D * D;
  static constexpr int kRowRates = kRowW + Cp::kMaxMonomials;
  static constexpr int kRows = kRowRates + Cp::kMaxWeights + D * D + D + 1;
  static constexpr int kPitch = kThreads + 1;
  static constexpr int kN = Cp::kCoef + D * D + D + 1;
  static constexpr int kH = Cp::kCoef + D * D;  // d_H's first sum
  static constexpr int kPerThread = (kN + kThreads - 1) / kThreads;
  static constexpr int kTableBytes = TableScalars<S, D, true, Cp>::kBytes;
  static constexpr int kBytes = kTableBytes + kRows * kPitch * (int)sizeof(S);
  static_assert(kBytes <= kSmemLimit, "the composite Fisher tile does not fit a block");
};

// The tile body: one thread a step (the units whose bit in
// kSpectralLanesF* is clear).
template <typename S, int D>
__device__ __forceinline__ void fisher_spectral_tile(const S* __restrict__ scal, int n_scal, const S* __restrict__ dt,
                                                     long long dt_bs, const S* __restrict__ y, long long y_bs,
                                                     const S* __restrict__ b, const S* __restrict__ C,
                                                     const S* __restrict__ g, const S* __restrict__ L,
                                                     S* __restrict__ ddt_out, S* __restrict__ dy_out,
                                                     S* __restrict__ sums, long long T) {
  typedef SpectralFisher<S, D> A;
  constexpr int P = A::kPitch;
  // This block's series: its scalars, its slice of every plane.
  const long long series = blockIdx.y;
  const long long ms = (long long)gridDim.y * T;
  scal += series * n_scal;
  dt += series * dt_bs;
  y += series * y_bs;
  b += series * T;
  C += series * T;
  g += series * T;
  L += series * T;
  ddt_out += series * T;
  dy_out += series * T;
  sums += series * gridDim.x * A::kN;
  S* sm = reinterpret_cast<S*>(pgt_fisher_smem);
  SpectralScalars<S, D, true> p;
  p.load(scal, sm);
  S* tile = sm + A::kTableBytes / sizeof(S);
  S* col = tile + threadIdx.x;
  S out[A::kPerThread];
#pragma unroll
  for (int i = 0; i < A::kPerThread; ++i) out[i] = S(0);
  const long long stride = (long long)gridDim.x * kThreads;
#pragma unroll 1
  for (long long base = (long long)blockIdx.x * kThreads; base < T; base += stride) {
    const long long t = base + threadIdx.x;
    if (t < T) {
      const S dtv = dt[t];
      S Am1[D * D], M[D * D], F[D * D], Q[D * D], w[A::kW];
      spectral_am1<S, D>(p.c, dtv, Am1, w);
      fq_from_am1<S, D>(Am1, p.P0, M, F, Q);
      S mhat[D], Phat[D * D], dF[D * D], dQ[D * D], dP0[D * D];
#pragma unroll
      for (int q = 0; q < D * D; ++q) dP0[q] = S(0);
      fisher_dfdq<S, D>(p.P0, F, Q, b, C, g, L, t, ms, mhat, Phat, dF, dQ, dP0);
      S dA[D * D], dP0v[D * D];
      am1_vjp<S, D>(p.P0, Am1, M, dF, dQ, dA, dP0v);
      const S d_u = spectral_vjp<S, D>(p.c, dtv, dA);
      ddt_out[t] = p.c[0] * d_u;
      S dH[D], dR = S(0), d_y;
#pragma unroll
      for (int a = 0; a < D; ++a) dH[a] = S(0);
      fisher_obs<S, D>(p.h, p.r, y[t], mhat, Phat, dH, dR, d_y);
      dy_out[t] = d_y;
#pragma unroll
      for (int q = 0; q < D * D; ++q) {
        col[q * P] = dA[q];
        col[(A::kRowPlain + 1 + q) * P] = dP0[q] + dP0v[q];
      }
#pragma unroll
      for (int m = 0; m < A::kW; ++m) col[(D * D + m) * P] = w[m];
      col[A::kRowPlain * P] = dtv * d_u;
#pragma unroll
      for (int a = 0; a < D; ++a) col[(A::kRowPlain + 1 + D * D + a) * P] = dH[a];
      col[(A::kRows - 1) * P] = dR;
    } else {
#pragma unroll 1
      for (int r = 0; r < A::kRows; ++r) col[r * P] = S(0);
    }
    __syncthreads();
    // Output o: d c[0] (o = 0) and d_P0, d_H, d_R (o ≥ kCoef) sum a row;
    // block m's matrix entry q (o = 1 + m·D² + q) sums w_m·dA_q.
#pragma unroll
    for (int i = 0; i < A::kPerThread; ++i) {
      const int o = threadIdx.x + i * kThreads;
      if (o >= A::kN) break;
      S s = S(0);
      if (o == 0 || o >= A::Sp::kCoef) {
        const S* row = tile + (o == 0 ? A::kRowPlain : A::kRowPlain + 1 + (o - A::Sp::kCoef)) * P;
        s = tile_sum<S>(row);
      } else {
        const S* wr = tile + (D * D + (o - 1) / (D * D)) * P;
        const S* ar = tile + ((o - 1) % (D * D)) * P;
#pragma unroll 8
        for (int k = 0; k < kThreads; ++k) s += wr[k] * ar[k];
      }
      out[i] += s;
    }
    __syncthreads();
  }
  const S rinv = S(1) / p.r;
#pragma unroll
  for (int i = 0; i < A::kPerThread; ++i) {
    const int o = threadIdx.x + i * kThreads;
    if (o < A::kN) sums[(long long)blockIdx.x * A::kN + o] = (o >= A::kH && o < A::kH + D) ? out[i] * rinv : out[i];
  }
}

template <typename S, int D>
__device__ __forceinline__ void fisher_composite_tile(const S* __restrict__ scal, int n_scal, const S* __restrict__ dt,
                                                      long long dt_bs, const S* __restrict__ y, long long y_bs,
                                                      const S* __restrict__ b, const S* __restrict__ C,
                                                      const S* __restrict__ g, const S* __restrict__ L,
                                                      S* __restrict__ ddt_out, S* __restrict__ dy_out,
                                                      S* __restrict__ sums, long long T) {
  typedef CompositeFisher<S, D> A;
  typedef Composite<D> Cp;
  constexpr int P = A::kPitch;
  // This block's series: its scalars, its slice of every plane.
  const long long series = blockIdx.y;
  const long long ms = (long long)gridDim.y * T;
  scal += series * n_scal;
  dt += series * dt_bs;
  y += series * y_bs;
  b += series * T;
  C += series * T;
  g += series * T;
  L += series * T;
  ddt_out += series * T;
  dy_out += series * T;
  sums += series * gridDim.x * A::kN;
  S* sm = reinterpret_cast<S*>(pgt_fisher_smem);
  TableScalars<S, D, true, Cp> p;
  p.load(scal, sm);
  S* tile = sm + A::kTableBytes / sizeof(S);
  S* col = tile + threadIdx.x;
  const int n_mono = (int)p.c[Cp::kCounts + 1];
  S out[A::kPerThread];
#pragma unroll
  for (int i = 0; i < A::kPerThread; ++i) out[i] = S(0);
  const long long stride = (long long)gridDim.x * kThreads;
#pragma unroll 1
  for (long long base = (long long)blockIdx.x * kThreads; base < T; base += stride) {
    const long long t = base + threadIdx.x;
    if (t < T) {
      const S dtv = dt[t];
      S w[Cp::kMaxWeights], w_rho[Cp::kMaxWeights], w_dt[Cp::kMaxWeights], dw[Cp::kMaxWeights];
      const int n_w = composite_weights<S, D>(p.c, dtv, w, w_rho, w_dt);
      S Am1[D * D], M[D * D], F[D * D], Q[D * D];
#pragma unroll
      for (int q = 0; q < D * D; ++q) Am1[q] = S(0);
#pragma unroll 1
      for (int mu = 0; mu < n_mono; ++mu) {
        int f[Cp::kMaxFactors];
        const S Wm = composite_monomial<S, D>(p.c, mu, w, f);
        col[(A::kRowW + mu) * P] = Wm;
        CompositeMask<D> mask;
        mask.load(p.c, mu);
        const S* K = p.c + Cp::kMaxWeights + mu * D * D;
#pragma unroll
        for (int q = 0; q < D * D; ++q)
          if (mask.on(q)) Am1[q] = Am1[q] + Wm * K[q];
      }
      fq_from_am1<S, D>(Am1, p.P0, M, F, Q);
      S mhat[D], Phat[D * D], dF[D * D], dQ[D * D], dP0[D * D];
#pragma unroll
      for (int q = 0; q < D * D; ++q) dP0[q] = S(0);
      fisher_dfdq<S, D>(p.P0, F, Q, b, C, g, L, t, ms, mhat, Phat, dF, dQ, dP0);
      S dA[D * D], dP0v[D * D];
      am1_vjp<S, D>(p.P0, Am1, M, dF, dQ, dA, dP0v);
      // Each weight's cotangent: ⟨dA, K_μ⟩ times the monomial's other factors.
#pragma unroll 1
      for (int m = 0; m < n_w; ++m) dw[m] = S(0);
#pragma unroll 1
      for (int mu = 0; mu < n_mono; ++mu) {
        int f[Cp::kMaxFactors];
        composite_monomial<S, D>(p.c, mu, w, f);
        CompositeMask<D> mask;
        mask.load(p.c, mu);
        const S* K = p.c + Cp::kMaxWeights + mu * D * D;
        S gm = S(0);
#pragma unroll
        for (int q = 0; q < D * D; ++q)
          if (mask.on(q)) gm += dA[q] * K[q];
#pragma unroll
        for (int i = 0; i < Cp::kMaxFactors; ++i) {
          if (f[i] < 0) continue;
          S other = gm;
#pragma unroll
          for (int j = 0; j < Cp::kMaxFactors; ++j)
            if (j != i && f[j] >= 0) other *= w[f[j]];
          dw[f[i]] += other;
        }
      }
      S d_dt = S(0);
#pragma unroll 1
      for (int m = 0; m < Cp::kMaxWeights; ++m) {
        const bool live = m < n_w;
        if (live) d_dt += dw[m] * w_dt[m];
        col[(A::kRowRates + m) * P] = live ? dw[m] * w_rho[m] : S(0);
      }
      ddt_out[t] = d_dt;
      S dH[D], dR = S(0), d_y;
#pragma unroll
      for (int a = 0; a < D; ++a) dH[a] = S(0);
      fisher_obs<S, D>(p.h, p.r, y[t], mhat, Phat, dH, dR, d_y);
      dy_out[t] = d_y;
      constexpr int kRowP0 = A::kRowRates + Cp::kMaxWeights;
#pragma unroll
      for (int q = 0; q < D * D; ++q) {
        col[q * P] = dA[q];
        col[(kRowP0 + q) * P] = dP0[q] + dP0v[q];
      }
#pragma unroll
      for (int a = 0; a < D; ++a) col[(kRowP0 + D * D + a) * P] = dH[a];
      col[(A::kRows - 1) * P] = dR;
    } else {
#pragma unroll 1
      for (int r = 0; r < A::kRows; ++r) col[r * P] = S(0);
    }
    __syncthreads();
    // Output o: d_ρ (o < kMaxWeights) and d_P0, d_H, d_R (o ≥ kCoef) sum a
    // row; monomial μ's matrix entry q (o = kMaxWeights + μ·D² + q) sums
    // W_μ·dA_q, for the plan's monomials only.
#pragma unroll
    for (int i = 0; i < A::kPerThread; ++i) {
      const int o = threadIdx.x + i * kThreads;
      if (o >= A::kN) break;
      S s = S(0);
      if (o < Cp::kMaxWeights || o >= Cp::kCoef) {
        const S* row = tile + (A::kRowRates + (o < Cp::kMaxWeights ? o : Cp::kMaxWeights + o - Cp::kCoef)) * P;
        s = tile_sum<S>(row);
      } else if ((o - Cp::kMaxWeights) / (D * D) < n_mono) {
        const S* wr = tile + (A::kRowW + (o - Cp::kMaxWeights) / (D * D)) * P;
        const S* ar = tile + ((o - Cp::kMaxWeights) % (D * D)) * P;
#pragma unroll 8
        for (int k = 0; k < kThreads; ++k) s += wr[k] * ar[k];
      }
      out[i] += s;
    }
    __syncthreads();
  }
  const S rinv = S(1) / p.r;
#pragma unroll
  for (int i = 0; i < A::kPerThread; ++i) {
    const int o = threadIdx.x + i * kThreads;
    if (o < A::kN) sums[(long long)blockIdx.x * A::kN + o] = (o >= A::kH && o < A::kH + D) ? out[i] * rinv : out[i];
  }
}

// ---------------------------------------------------------------------------
// The lane-split body (module comment).
// ---------------------------------------------------------------------------

// Lanes a step: the power of two ≥ D, so that a group is a segment of a
// warp that __shfl_sync's width addresses.
template <int D>
struct LaneGroup {
  static constexpr int kG = D <= 1 ? 1 : (D <= 2 ? 2 : (D <= 4 ? 4 : 8));
};

// A unit's sizes.  Per group (a step): four D×D matrices of scratch, rows
// of kRP values (16-byte aligned, read a row at a time in 16-byte loads), a
// 32-byte pad between groups so that the groups of a warp read distinct
// banks.  Per block: the table, a padded copy of P0, the staged moments of
// its kSteps steps and the step before them (b, g, C, L a step, kStepPitch
// values), and the tile the Fisher sums contract (rows of kTP values, one
// column a step): dA (kQ4·4 rows, D² padded to whole quads), the weights
// (kW rows) and the rows summed alone (kR rows).
template <typename S, int D, typename Fam>
struct FisherLanes {
  static constexpr bool kComp = std::is_same<Fam, Composite<D>>::value;
  static constexpr int kG = LaneGroup<D>::kG;
  static constexpr int kThreads = (sizeof(S) == 8 && D >= 5) ? 128 : 256;
  static constexpr int kGroups = kThreads / kG;
  static constexpr int kSteps = kGroups;  // a block's steps a round
  static constexpr int kVec = 16 / (int)sizeof(S);
  static constexpr int kRP = (D + kVec - 1) / kVec * kVec;
  static constexpr int kMat = D * kRP;
  static constexpr int kGroupPitch = 4 * kMat + 32 / (int)sizeof(S);
  static constexpr int kStepPitch = 2 * kRP + 2 * kMat + kVec;
  static constexpr int kQ4 = (D * D + 3) / 4;
  // Weights whose products with dA the tile contracts, and rows summed alone:
  // spectral: (em1, es) of each block, and dt·∂ℓ/∂u; composite: the
  // monomials, and each rate's term.
  static constexpr int kW = kComp ? Composite<D>::kMaxMonomials : 2 * Spectral<D>::kBlocks;
  static constexpr int kR = kComp ? Composite<D>::kMaxWeights : 1;
  static constexpr int kRowW = kQ4 * 4;
  static constexpr int kRowR = kRowW + kW;
  static constexpr int kTileRows = kRowR + kR;
  static constexpr int kTP = kSteps + kVec;
  // Contraction units: (weight, quad of dA rows), at most kW·kQ4, dealt
  // round-robin to the threads.
  static constexpr int kUnits = (kW * kQ4 + kThreads - 1) / kThreads;
  static constexpr int kRowsPer = (kR + kThreads - 1) / kThreads;
  // The row of sums (FisherSums' order): [d_c (kCoef) | d_P0 | d_H | d_R];
  // weight m's matrix at kWOff + m·D².
  static constexpr int kCoef = kComp ? Composite<D>::kCoef : Spectral<D>::kCoef;
  static constexpr int kWOff = kComp ? Composite<D>::kMaxWeights : 1;
  static constexpr int kN = kCoef + D * D + D + 1;
  static constexpr int kH = kCoef + D * D;
  static constexpr int kFin = D * D + D + 1;  // the lanes' own sums: d_P0, d_H, d_R
  // Shared memory, in values of S, each part a multiple of kVec: the scalar
  // table (TableScalars), a padded copy of P0, the groups' scratch, the
  // staged moments, the tile.
  static constexpr int kP0 = TableScalars<S, D, true, Fam>::kBytes / (int)sizeof(S);
  static constexpr int kScratch = kP0 + kMat;
  static constexpr int kStaged = kScratch + kGroups * kGroupPitch;
  static constexpr int kTile = kStaged + (kSteps + 1) * kStepPitch;
  static constexpr int kEnd = kTile + kTileRows * kTP;
  // After the last round the staged moments and the tile hold the groups'
  // sums and the row of sums.
  static_assert(kGroups * kFin + kN <= (kSteps + 1) * kStepPitch + kTileRows * kTP, "the final sums do not fit");
  static constexpr int kBytes = kEnd * (int)sizeof(S);
  static_assert(kBytes <= kSmemLimit, "the lane-split Fisher body does not fit a block");
};

// The row at p (kRP values, 16-byte aligned) in 16-byte loads: v[0..N).
template <typename S, int N, int RP>
__device__ __forceinline__ void load_row(const S* p, S (&v)[N]) {
  if constexpr (sizeof(S) == 4) {
#pragma unroll
    for (int k = 0; k < RP; k += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + k);
      if (k < N) v[k] = x.x;
      if (k + 1 < N) v[k + 1] = x.y;
      if (k + 2 < N) v[k + 2] = x.z;
      if (k + 3 < N) v[k + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < RP; k += 2) {
      const double2 x = *reinterpret_cast<const double2*>(p + k);
      if (k < N) v[k] = x.x;
      if (k + 1 < N) v[k + 1] = x.y;
    }
  }
}

// out = x·B for the row vector x and the D×D matrix B of rows at ``rows``
// (row pitch RP): B's rows in 16-byte loads, out accumulated in k order, as
// mm's dot products are.
template <typename S, int D, int RP>
__device__ __forceinline__ void vec_mat(const S* x, const S* rows, S* out) {
  S row[D];
  load_row<S, D, RP>(rows, row);
#pragma unroll
  for (int j = 0; j < D; ++j) out[j] = x[0] * row[j];
#pragma unroll
  for (int k = 1; k < D; ++k) {
    load_row<S, D, RP>(rows + k * RP, row);
#pragma unroll
    for (int j = 0; j < D; ++j) out[j] += x[k] * row[j];
  }
}

// The sum of v over the lanes of a group (lanes ≥ D pass 0): a butterfly,
// so that every lane ends with the same bits.
template <typename S, int G>
__device__ __forceinline__ S group_sum(S v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o, G);
  return v;
}

template <typename S, int G>
__device__ __forceinline__ S from_lane(S v, int lane) {
  return __shfl_sync(0xffffffffu, v, lane, G);
}

// Row r of Am1 at dt and the step's weights (spectral: em1, es a block;
// composite: the weights w, their rate and dt derivatives).
template <typename S, int D>
__device__ __forceinline__ void lanes_am1(Spectral<D>, const S* c, S dt, int r, S* am, S* w, S*, S*) {
  typedef Spectral<D> Sp;
  const S u = dt * c[0];
#pragma unroll
  for (int j = 0; j < D; ++j) am[j] = S(0);
#pragma unroll 1
  for (int k = 0; k < Sp::kBlocks; ++k) {
    const S a = c[Sp::kCoef + 2 * k], beta = c[Sp::kCoef + 2 * k + 1];
    S sn, cs;
    dsincos(beta * u, &sn, &cs);
    const S sh = dsin(S(0.5) * beta * u);
    const S em1 = dexpm1(-a * u) * cs - S(2) * sh * sh;
    const S es = dexp(-a * u) * sn;
    const S* G = c + 1 + 2 * k * D * D + r * D;
#pragma unroll
    for (int j = 0; j < D; ++j) am[j] = am[j] + em1 * G[j] + es * G[D * D + j];
    w[2 * k] = em1;
    w[2 * k + 1] = es;
  }
}

template <typename S, int D>
__device__ __forceinline__ void lanes_am1(Composite<D>, const S* c, S dt, int r, S* am, S* w, S* w_rho, S* w_dt) {
  typedef Composite<D> Cp;
  composite_weights<S, D>(c, dt, w, w_rho, w_dt);
#pragma unroll
  for (int j = 0; j < D; ++j) am[j] = S(0);
  const int n_mono = (int)c[Cp::kCounts + 1];
#pragma unroll 1
  for (int mu = 0; mu < n_mono; ++mu) {
    int f[Cp::kMaxFactors];
    const S Wm = composite_monomial<S, D>(c, mu, w, f);
    CompositeMask<D> mask;
    mask.load(c, mu);
    const S* K = c + Cp::kMaxWeights + mu * D * D + r * D;
#pragma unroll
    for (int j = 0; j < D; ++j)
      if (mask.on(r * D + j)) am[j] = am[j] + Wm * K[j];
  }
}

// From row r of dA: ∂ℓ/∂dt of the step, the tile's weight and row-sum
// columns of the step (written by lane gl of the group: weights m ≡ gl mod
// kG), for the spectral and the composite family.
template <typename S, int D, int G>
__device__ __forceinline__ S lanes_vjp(Spectral<D>, const S* c, S dt, int r, bool row_lane, int gl, const S* dA,
                                       const S* w, S*, S*, S* col_w, S* col_r, int tp, bool live) {
  typedef Spectral<D> Sp;
  const S u = dt * c[0];
  S d_u = S(0);
#pragma unroll 1
  for (int k = 0; k < Sp::kBlocks; ++k) {
    const S a = c[Sp::kCoef + 2 * k], beta = c[Sp::kCoef + 2 * k + 1];
    S sn, cs;
    dsincos(beta * u, &sn, &cs);
    const S e = dexp(-a * u);
    const S es = e * sn;
    const S d_em1 = -a * e * cs - beta * es;
    const S d_es = -a * es + beta * e * cs;
    const S* Gk = c + 1 + 2 * k * D * D + r * D;
    S pg = S(0), ps = S(0);
#pragma unroll
    for (int j = 0; j < D; ++j) {
      pg += dA[j] * Gk[j];
      ps += dA[j] * Gk[D * D + j];
    }
    pg = group_sum<S, G>(row_lane ? pg : S(0));
    ps = group_sum<S, G>(row_lane ? ps : S(0));
    d_u += d_em1 * pg + d_es * ps;
  }
#pragma unroll 1
  for (int m = gl; m < 2 * Sp::kBlocks; m += G) col_w[m * tp] = live ? w[m] : S(0);
  if (gl == 0) col_r[0] = live ? dt * d_u : S(0);
  return c[0] * d_u;
}

template <typename S, int D, int G>
__device__ __forceinline__ S lanes_vjp(Composite<D>, const S* c, S, int r, bool row_lane, int gl, const S* dA,
                                       const S* w, S* w_rho, S* w_dt, S* col_w, S* col_r, int tp, bool live) {
  typedef Composite<D> Cp;
  const int n_w = (int)c[Cp::kCounts], n_mono = (int)c[Cp::kCounts + 1];
  S dw[Cp::kMaxWeights];
#pragma unroll 1
  for (int m = 0; m < n_w; ++m) dw[m] = S(0);
#pragma unroll 1
  for (int mu = 0; mu < n_mono; ++mu) {
    int f[Cp::kMaxFactors];
    const S Wm = composite_monomial<S, D>(c, mu, w, f);
    if ((mu & (G - 1)) == gl) col_w[mu * tp] = live ? Wm : S(0);
    CompositeMask<D> mask;
    mask.load(c, mu);
    const S* K = c + Cp::kMaxWeights + mu * D * D + r * D;
    S part = S(0);
#pragma unroll
    for (int j = 0; j < D; ++j)
      if (mask.on(r * D + j)) part += dA[j] * K[j];
    const S gm = group_sum<S, G>(row_lane ? part : S(0));
#pragma unroll
    for (int i = 0; i < Cp::kMaxFactors; ++i) {
      if (f[i] < 0) continue;
      S other = gm;
#pragma unroll
      for (int j = 0; j < Cp::kMaxFactors; ++j)
        if (j != i && f[j] >= 0) other *= w[f[j]];
      dw[f[i]] += other;
    }
  }
  S d_dt = S(0);
#pragma unroll 1
  for (int m = 0; m < n_w; ++m) d_dt += dw[m] * w_dt[m];
#pragma unroll 1
  for (int m = gl; m < Cp::kMaxWeights; m += G) col_r[m * tp] = (live && m < n_w) ? dw[m] * w_rho[m] : S(0);
  return d_dt;
}

// One step of the lane-split body: lane gl of a group of kG carries row
// r = min(gl, D − 1) of every matrix (lanes ≥ D repeat row D − 1, write
// nothing and add 0 to the group's sums).  X: the group's scratch (slots 0:
// Am1, 1: M, 2 and 3 reused in turn); prev, cur: the staged step before and
// the step itself ([b | g | C | L]); P0: the padded copy.  Returns the
// step's ∂ℓ/∂dt and ∂ℓ/∂y, adds row r of d_P0 to acc_P0 and lane r's
// observation terms to acc_H, acc_R, and writes the step's tile column.
template <typename S, int D, typename Fam>
__device__ __forceinline__ void lanes_step(const TableScalars<S, D, true, Fam>& p, const S* P0, S dtv, S yv,
                                           bool first, bool live, int gl, const S* prev, const S* cur, S* X, S* col,
                                           S* acc_P0, S& acc_H, S& acc_R, S& d_dt, S& d_y) {
  typedef FisherLanes<S, D, Fam> A;
  constexpr int G = A::kG, RP = A::kRP, M = A::kMat, TP = A::kTP;
  const bool row_lane = gl < D;
  const int r = row_lane ? gl : D - 1;
  S* Xa = X;           // Am1
  S* Xm = X + M;       // M = Am1·P0
  S* X2 = X + 2 * M;   // FP, then Dk, E, QF, dM
  S* X3 = X + 3 * M;   // Pi, then dQ
  const S* Pprev = first ? P0 : prev + 2 * RP;    // rows of the filtered covariance at t − 1
  const S* Phat = cur + 2 * RP + M;               // rows of the smoothed one at t

  constexpr int kMaxW = A::kComp ? Composite<D>::kMaxWeights : 2 * Spectral<D>::kBlocks;
  S w[kMaxW], w_rho[kMaxW], w_dt[kMaxW];
  S am[D];
  lanes_am1<S, D>(Fam(), p.c, dtv, r, am, w, w_rho, w_dt);
  S Fr[D];
#pragma unroll
  for (int j = 0; j < D; ++j) Fr[j] = (j == r) ? S(1) + am[j] : am[j];
  {
    S Mr[D];
    vec_mat<S, D, RP>(am, P0, Mr);
    if (row_lane) {
#pragma unroll
      for (int j = 0; j < D; ++j) {
        Xa[r * RP + j] = am[j];
        Xm[r * RP + j] = Mr[j];
      }
    }
    // FP = F·P_prev.
    S FPr[D];
    vec_mat<S, D, RP>(Fr, Pprev, FPr);
    if (row_lane) {
#pragma unroll
      for (int j = 0; j < D; ++j) X2[r * RP + j] = FPr[j];
    }
  }
  __syncwarp();

  // Q = −(M + Mᵀ + M·Am1ᵀ) and Pp = FP·Fᵀ + Q, each from its upper triangle
  // (fq_from_am1, mm_symout): entry (r, j) from the pair lo ≤ hi.
  S a[D];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const int lo = r < j ? r : j, hi = r < j ? j : r;
    S ml[D], ah[D], fl[D];
    load_row<S, D, RP>(Xm + lo * RP, ml);
    load_row<S, D, RP>(Xa + hi * RP, ah);
    load_row<S, D, RP>(X2 + lo * RP, fl);
    S q = ml[hi] + Xm[hi * RP + lo];
#pragma unroll
    for (int k = 0; k < D; ++k) q += ml[k] * ah[k];
    q = -q;
    S s = fl[0] * (hi == 0 ? S(1) + ah[0] : ah[0]);
#pragma unroll
    for (int k = 1; k < D; ++k) s += fl[k] * (hi == k ? S(1) + ah[k] : ah[k]);
    a[j] = s + q;
  }
  // Dk = P̂ − Pp, row r.
  S Dk[D];
  {
    S ph[D];
    load_row<S, D, RP>(Phat + r * RP, ph);
#pragma unroll
    for (int j = 0; j < D; ++j) Dk[j] = ph[j] - a[j];
  }
  // Pi = Pp⁻¹ by Gauss–Jordan elimination across the group's lanes, row k
  // the pivot of round k (Pp is SPD: no pivoting).
#pragma unroll
  for (int k = 0; k < D; ++k) {
    S piv[D];
#pragma unroll
    for (int j = 0; j < D; ++j) piv[j] = from_lane<S, G>(a[j], k);
    const S inv_p = S(1) / piv[k];
    if (r == k) {
#pragma unroll
      for (int j = 0; j < D; ++j) a[j] = (j == k) ? inv_p : a[j] * inv_p;
    } else {
      const S f = a[k] * inv_p;
#pragma unroll
      for (int j = 0; j < D; ++j) a[j] = (j == k) ? -f : a[j] - f * piv[j];
    }
  }
  // δ = m̂ − F·m_prev and r_k = Pi·δ.
  S mhat[D], mprev[D];
  load_row<S, D, RP>(cur + RP, mhat);
  load_row<S, D, RP>(prev, mprev);
  S delta;
  {
    S s = first ? S(0) : Fr[0] * mprev[0];
#pragma unroll
    for (int k = 1; k < D; ++k) s += first ? S(0) : Fr[k] * mprev[k];
    delta = mhat[r] - s;
  }
  S rk;
  {
    S s = a[0] * from_lane<S, G>(delta, 0);
#pragma unroll
    for (int k = 1; k < D; ++k) s += a[k] * from_lane<S, G>(delta, k);
    rk = s;
  }
  __syncwarp();  // FP is read
  if (row_lane) {
#pragma unroll
    for (int j = 0; j < D; ++j) {
      X2[r * RP + j] = Dk[j];
      X3[r * RP + j] = a[j];
    }
  }
  __syncwarp();
  // PiD = Pi·Dk, dQ = ½(PiD·Pi + r rᵀ).
  S PiD[D], dQ[D];
  vec_mat<S, D, RP>(a, X2, PiD);
  vec_mat<S, D, RP>(PiD, X3, dQ);
#pragma unroll
  for (int j = 0; j < D; ++j) dQ[j] = S(0.5) * (dQ[j] + rk * from_lane<S, G>(rk, j));
  // E_prev = P_prev Fᵀ Pi, row r.
  S Er[D];
  {
    S pr[D], PFt[D];
    load_row<S, D, RP>(Pprev + r * RP, pr);
#pragma unroll
    for (int j = 0; j < D; ++j) {
      S fj[D];
      load_row<S, D, RP>(Xa + j * RP, fj);
      S s = pr[0] * (j == 0 ? S(1) + fj[0] : fj[0]);
#pragma unroll
      for (int k = 1; k < D; ++k) s += pr[k] * (j == k ? S(1) + fj[k] : fj[k]);
      PFt[j] = s;
    }
    vec_mat<S, D, RP>(PFt, X3, Er);
  }
  // m̂ at t − 1; at t = 0 the pre-initial E₋₁ m̂₀.
  S mh_prev[D];
  {
    S em = Er[0] * mhat[0];
#pragma unroll
    for (int k = 1; k < D; ++k) em += Er[k] * mhat[k];
    S gp[D];
    load_row<S, D, RP>(prev + RP, gp);
#pragma unroll
    for (int j = 0; j < D; ++j) {
      const S ej = from_lane<S, G>(em, j);
      mh_prev[j] = first ? ej : gp[j];
    }
  }
  __syncwarp();  // Dk and Pi are read
  if (row_lane) {
#pragma unroll
    for (int j = 0; j < D; ++j) {
      X2[r * RP + j] = Er[j];
      X3[r * RP + j] = dQ[j];
    }
  }
  __syncwarp();
  // dF = r m̂_prevᵀ + PiD·Eᵀ.
  S dA[D];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    S e[D];
    load_row<S, D, RP>(X2 + j * RP, e);
    S s = rk * mh_prev[j];
#pragma unroll
    for (int k = 0; k < D; ++k) s += PiD[k] * e[k];
    dA[j] = s;
  }
  // The first step's F₀ᵀ ∇Q₀ F₀ of ∇P0: QF = dQ·F in slot 2, then column r
  // of F against it.
  __syncwarp();  // E is read
  if (first && row_lane) {
#pragma unroll
    for (int j = 0; j < D; ++j) {
      S s = dQ[0] * (j == 0 ? S(1) + Xa[j] : Xa[j]);
#pragma unroll
      for (int k = 1; k < D; ++k) s += dQ[k] * (j == k ? S(1) + Xa[k * RP + j] : Xa[k * RP + j]);
      X2[r * RP + j] = s;
    }
  }
  __syncwarp();
  if (first && live) {
#pragma unroll
    for (int j = 0; j < D; ++j) {
      S s = (r == 0 ? S(1) + Xa[r] : Xa[r]) * X2[j];
#pragma unroll
      for (int k = 1; k < D; ++k) s += (r == k ? S(1) + Xa[k * RP + r] : Xa[k * RP + r]) * X2[k * RP + j];
      acc_P0[j] += s;
    }
  }
  // am1_vjp with G = dQ + dQᵀ off the diagonal, dQ on it: dM = −(dQ + dQᵀ)
  // − G_upper·Am1, dA = dF − G_upperᵀ·M + dM·P0ᵀ, d_P0 = Am1ᵀ·dM.
  S Gr[D];
#pragma unroll
  for (int j = 0; j < D; ++j) Gr[j] = (j == r) ? dQ[j] : dQ[j] + X3[j * RP + r];
  S dM[D];
#pragma unroll
  for (int j = 0; j < D; ++j) dM[j] = (j == r) ? -(Gr[j] + Gr[j]) : -Gr[j];
#pragma unroll
  for (int c = 0; c < D; ++c) {
    S ac[D], mc[D];
    load_row<S, D, RP>(Xa + c * RP, ac);
    load_row<S, D, RP>(Xm + c * RP, mc);
    const S gu = c >= r ? Gr[c] : S(0);  // (r, c) with r ≤ c
    const S gl_ = c <= r ? Gr[c] : S(0);  // (c, r) with c ≤ r
#pragma unroll
    for (int k = 0; k < D; ++k) {
      dM[k] -= gu * ac[k];
      dA[k] -= gl_ * mc[k];
    }
  }
#pragma unroll
  for (int j = 0; j < D; ++j) {
    S pj[D];
    load_row<S, D, RP>(P0 + j * RP, pj);
    S s = dM[0] * pj[0];
#pragma unroll
    for (int k = 1; k < D; ++k) s += dM[k] * pj[k];
    dA[j] += s;
  }
  __syncwarp();  // QF is read
  if (row_lane) {
#pragma unroll
    for (int j = 0; j < D; ++j) X2[r * RP + j] = dM[j];
  }
  __syncwarp();
  if (live) {
    S ac[D], dP[D];
#pragma unroll
    for (int k = 0; k < D; ++k) ac[k] = Xa[k * RP + r];
    vec_mat<S, D, RP>(ac, X2, dP);
#pragma unroll
    for (int j = 0; j < D; ++j) acc_P0[j] += dP[j];
  }

  // The family's chain rule, the step's tile column, dt's cotangent.
  S* col_w = col + A::kRowW * TP;
  S* col_r = col + A::kRowR * TP;
  d_dt = lanes_vjp<S, D, G>(Fam(), p.c, dtv, r, row_lane, gl, dA, w, w_rho, w_dt, col_w, col_r, TP, live);
  if (row_lane) {
#pragma unroll
    for (int j = 0; j < D; ++j) col[(r * D + j) * TP] = live ? dA[j] : S(0);
  }

  // Observation terms.
  const bool observed = live && !(yv != yv);
  S Hm = p.h[0] * mhat[0];
#pragma unroll
  for (int k = 1; k < D; ++k) Hm += p.h[k] * mhat[k];
  S HPr = p.h[0] * Phat[r];
#pragma unroll
  for (int k = 1; k < D; ++k) HPr += p.h[k] * Phat[k * RP + r];
  const S HPH = group_sum<S, G>(row_lane ? p.h[r] * HPr : S(0));
  const S resid = yv - Hm;
  const S rinv = S(1) / p.r;
  d_y = observed ? -resid * rinv : S(0);
  if (observed) {
    acc_H += resid * mhat[r] - HPr;
    acc_R += S(0.5) * ((resid * resid + HPH) * rinv * rinv - rinv);
  }
}

// The kernel: a grid-stride loop over rounds of kSteps steps a block; each
// round stages its moments, runs a step a group and contracts the tile; at
// the end the groups' own sums are added in a fixed order and the block
// writes its row of sums.  Family tags: Spectral<D>, Composite<D>.
template <typename S, int D, typename Fam>
__device__ __forceinline__ void fisher_lanes(const S* __restrict__ scal, int n_scal, const S* __restrict__ dt,
                                             long long dt_bs, const S* __restrict__ y, long long y_bs,
                                             const S* __restrict__ b, const S* __restrict__ C,
                                             const S* __restrict__ g, const S* __restrict__ L,
                                             S* __restrict__ ddt_out, S* __restrict__ dy_out, S* __restrict__ sums,
                                             long long T) {
  typedef FisherLanes<S, D, Fam> A;
  constexpr int NT = A::kThreads, G = A::kG, RP = A::kRP, TP = A::kTP, SP = A::kStepPitch;
  const long long series = blockIdx.y;
  const long long ms = (long long)gridDim.y * T;
  scal += series * n_scal;
  dt += series * dt_bs;
  y += series * y_bs;
  b += series * T;
  C += series * T;
  g += series * T;
  L += series * T;
  ddt_out += series * T;
  dy_out += series * T;
  sums += series * gridDim.x * A::kN;
  S* sm = reinterpret_cast<S*>(pgt_fisher_smem);
  TableScalars<S, D, true, Fam> p;
  p.load(scal, sm);
  S* P0 = sm + A::kP0;
  S* staged = sm + A::kStaged;
  S* tile = sm + A::kTile;
  const int tid = threadIdx.x, grp = tid / G, gl = tid % G;
  for (int i = tid; i < A::kMat; i += NT) P0[i] = (i % RP < D) ? p.P0[(i / RP) * D + i % RP] : S(0);
  // The dA rows past D² (a ragged last quad) stay zero.
  for (int i = tid; i < (A::kRowW - D * D) * TP; i += NT) tile[D * D * TP + i] = S(0);
  int n_w = A::kW;
  if constexpr (A::kComp) n_w = (int)p.c[Composite<D>::kCounts + 1];
  int n_r = A::kR;
  if constexpr (A::kComp) n_r = (int)p.c[Composite<D>::kCounts];
  S out[A::kUnits][4], rsum[A::kRowsPer];
#pragma unroll
  for (int u = 0; u < A::kUnits; ++u)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[u][j] = S(0);
#pragma unroll
  for (int i = 0; i < A::kRowsPer; ++i) rsum[i] = S(0);
  S acc_P0[D], acc_H = S(0), acc_R = S(0);
#pragma unroll
  for (int j = 0; j < D; ++j) acc_P0[j] = S(0);
  S* X = sm + A::kScratch + grp * A::kGroupPitch;

  // Staged planes: b, g (D rows each), C, L (D² rows each), at their offsets
  // in a step.
  constexpr int kPlanes = 2 * D + 2 * D * D;
  const long long stride = (long long)gridDim.x * A::kSteps;
#pragma unroll 1
  for (long long base = (long long)blockIdx.x * A::kSteps; base < T; base += stride) {
    __syncthreads();  // the last round's staged moments and tile are read
    // Every thread's loads first, then its stores: all of them in flight
    // at once.
    constexpr int kIters = (kPlanes * (A::kSteps + 1) + NT - 1) / NT;
    S v[kIters];
#pragma unroll
    for (int k = 0; k < kIters; ++k) {
      const int i = tid + k * NT;
      const int plane = i / (A::kSteps + 1), s = i % (A::kSteps + 1);
      const long long t = base - 1 + s;
      const bool in = i < kPlanes * (A::kSteps + 1) && t >= 0 && t < T;
      const S* src = plane < D ? b + plane * ms
                     : plane < 2 * D ? g + (plane - D) * ms
                     : plane < 2 * D + D * D ? C + (plane - 2 * D) * ms
                     : L + (plane - 2 * D - D * D) * ms;
      v[k] = in ? src[t] : S(0);
    }
#pragma unroll
    for (int k = 0; k < kIters; ++k) {
      const int i = tid + k * NT;
      if (i < kPlanes * (A::kSteps + 1)) {
        const int plane = i / (A::kSteps + 1), s = i % (A::kSteps + 1);
        const int q = plane < 2 * D ? 0 : (plane - 2 * D) % (D * D);
        const int at = plane < D ? plane
                       : plane < 2 * D ? RP + plane - D
                       : 2 * RP + (plane < 2 * D + D * D ? 0 : A::kMat) + (q / D) * RP + q % D;
        staged[s * SP + at] = v[k];
      }
    }
    __syncthreads();
    const long long t = base + grp;
    const bool live = t < T;
    const long long tc = live ? t : T - 1;
    S d_dt, d_y;
    lanes_step<S, D, Fam>(p, P0, dt[tc], y[tc], tc == 0, live, gl, staged + grp * SP, staged + (grp + 1) * SP, X,
                          tile + grp, acc_P0, acc_H, acc_R, d_dt, d_y);
    if (live && gl == 0) {
      ddt_out[t] = d_dt;
      dy_out[t] = d_y;
    }
    __syncthreads();
    // Contract the tile: unit (m, quad) sums W_m[s]·dA_q[s] over the
    // round's steps, four rows of dA a unit, the plan's weights only.
#pragma unroll
    for (int u = 0; u < A::kUnits; ++u) {
      const int unit = tid + u * NT;
      if (unit < n_w * A::kQ4) {
        const S* wr = tile + (A::kRowW + unit / A::kQ4) * TP;
        const S* ar = tile + (unit % A::kQ4) * 4 * TP;
        constexpr int V = A::kVec;
#pragma unroll 2
        for (int s0 = 0; s0 < A::kSteps; s0 += V) {
          S wv[V], av[4][V];
          load_row<S, V, V>(wr + s0, wv);
#pragma unroll
          for (int j = 0; j < 4; ++j) load_row<S, V, V>(ar + j * TP + s0, av[j]);
#pragma unroll
          for (int k = 0; k < V; ++k)
#pragma unroll
            for (int j = 0; j < 4; ++j) out[u][j] += wv[k] * av[j][k];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < A::kRowsPer; ++i) {
      const int row = tid + i * NT;
      if (row < n_r) {
        const S* rr = tile + (A::kRowR + row) * TP;
        S s = S(0);
#pragma unroll 4
        for (int k = 0; k < A::kSteps; ++k) s += rr[k];
        rsum[i] += s;
      }
    }
  }
  __syncthreads();
  // The groups' own sums, then the row of sums: [d_c | d_P0 | d_H | d_R].
  S* fin = staged;
  S* row = fin + A::kGroups * A::kFin;
  if (gl < D) {
#pragma unroll
    for (int j = 0; j < D; ++j) fin[grp * A::kFin + gl * D + j] = acc_P0[j];
    fin[grp * A::kFin + D * D + gl] = acc_H;
  }
  if (gl == 0) fin[grp * A::kFin + D * D + D] = acc_R;
  for (int i = tid; i < A::kN; i += NT) row[i] = S(0);
  __syncthreads();
  const S rinv = S(1) / p.r;
  for (int o = tid; o < A::kFin; o += NT) {
    S s = S(0);
#pragma unroll 1
    for (int k = 0; k < A::kGroups; ++k) s += fin[k * A::kFin + o];
    row[A::kCoef + o] = (o >= D * D && o < D * D + D) ? s * rinv : s;
  }
  // Coefficient outputs: spectral d c[0] (the row sum) and
  // block m's matrix entry q at 1 + m·D² + q; composite d_ρ_m at m and
  // monomial μ's entry q at kMaxWeights + μ·D² + q.
  constexpr int kWOff = A::kWOff;
#pragma unroll
  for (int u = 0; u < A::kUnits; ++u) {
    const int unit = tid + u * NT;
    if (unit < n_w * A::kQ4) {
      const int m = unit / A::kQ4, q0 = (unit % A::kQ4) * 4;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (q0 + j < D * D) row[kWOff + m * D * D + q0 + j] = out[u][j];
    }
  }
#pragma unroll
  for (int i = 0; i < A::kRowsPer; ++i) {
    const int r = tid + i * NT;
    if (r < n_r) row[r] = rsum[i];
  }
  __syncthreads();
  for (int i = tid; i < A::kN; i += NT) sums[(long long)blockIdx.x * A::kN + i] = row[i];
}

// Which units run the lane-split body (bit D − 1, kF32 for float, kF64 for
// double); the rest run the tile body above, as measured on an H100: the
// lane-split body at float D = 8 (spectral 3.00 → 2.62 device ms at
// N = 1M, composite 3.53 → 3.46) and double D = 7, 8 (39–76 → 4.3–7.2 ms),
// the tile body 1.3–4× faster at the smaller units (PERF.md §6).
constexpr unsigned kSpectralLanesF32 = 0x80u, kSpectralLanesF64 = 0xC0u;
constexpr unsigned kCompositeLanesF32 = 0x80u, kCompositeLanesF64 = 0xC0u;

// A unit's body, its block, the blocks an SM must hold (the lane-split body:
// two, so that ptxas keeps a float thread within 128 registers) and its
// dynamic shared memory.
template <typename S, int D, typename Fam>
struct FisherBody {
  static constexpr bool kComp = std::is_same<Fam, Composite<D>>::value;
  static constexpr bool kLanes = kComp ? UnitBit<S, D, kCompositeLanesF32, kCompositeLanesF64>::kOn
                                       : UnitBit<S, D, kSpectralLanesF32, kSpectralLanesF64>::kOn;
  static constexpr int kThreads = kLanes ? FisherLanes<S, D, Fam>::kThreads : pgt::kThreads;
  static constexpr int kMinBlocks = kLanes ? 2 : 1;
  static constexpr int kBytes =
      kLanes ? FisherLanes<S, D, Fam>::kBytes : (kComp ? CompositeFisher<S, D>::kBytes : SpectralFisher<S, D>::kBytes);
};

template <typename S, int D>
__global__ void __launch_bounds__(FisherBody<S, D, Spectral<D>>::kThreads, FisherBody<S, D, Spectral<D>>::kMinBlocks)
    dt_fisher_spectral_kernel(const S* __restrict__ scal, int n_scal, const S* __restrict__ dt, long long dt_bs,
                              const S* __restrict__ y, long long y_bs, const S* __restrict__ b,
                              const S* __restrict__ C, const S* __restrict__ g, const S* __restrict__ L,
                              S* __restrict__ ddt_out, S* __restrict__ dy_out, S* __restrict__ sums, long long T) {
  if constexpr (FisherBody<S, D, Spectral<D>>::kLanes)
    fisher_lanes<S, D, Spectral<D>>(scal, n_scal, dt, dt_bs, y, y_bs, b, C, g, L, ddt_out, dy_out, sums, T);
  else
    fisher_spectral_tile<S, D>(scal, n_scal, dt, dt_bs, y, y_bs, b, C, g, L, ddt_out, dy_out, sums, T);
}

template <typename S, int D>
__global__ void __launch_bounds__(FisherBody<S, D, Composite<D>>::kThreads, FisherBody<S, D, Composite<D>>::kMinBlocks)
    dt_fisher_composite_kernel(const S* __restrict__ scal, int n_scal, const S* __restrict__ dt, long long dt_bs,
                               const S* __restrict__ y, long long y_bs, const S* __restrict__ b,
                               const S* __restrict__ C, const S* __restrict__ g, const S* __restrict__ L,
                               S* __restrict__ ddt_out, S* __restrict__ dy_out, S* __restrict__ sums, long long T) {
  if constexpr (FisherBody<S, D, Composite<D>>::kLanes)
    fisher_lanes<S, D, Composite<D>>(scal, n_scal, dt, dt_bs, y, y_bs, b, C, g, L, ddt_out, dy_out, sums, T);
  else
    fisher_composite_tile<S, D>(scal, n_scal, dt, dt_bs, y, y_bs, b, C, g, L, ddt_out, dy_out, sums, T);
}

}  // namespace pgt

// C interface, bound with ctypes (kalman/_cuda.py), as in dt_scan.cu: one
// set of entry points per state dimension, taking the family.
#define PGT_CAT2(a, b) a##b
#define PGT_CAT(a, b) PGT_CAT2(a, b)
#define PGT_ENTRY(name) PGT_CAT(PGT_CAT(name, _d), PGT_D)

extern "C" {

// Values in one block's row of sums.
int PGT_ENTRY(pgt_dt_fisher_n_sums)(int family) {
  if (family == pgt::kSpectral) return pgt::SpectralFisher<float, PGT_D>::kN;
  if (family == pgt::kComposite) return pgt::CompositeFisher<float, PGT_D>::kN;
#if PGT_D <= 3
  return pgt::FisherSums<PGT_D>::kN;
#else
  return pgt::kBadArgs;
#endif
}

// scal: (B, n_scal) rows [P0 (d²) | h (d) | r | coeffs]; dt, y: series·bs + t
// (bs = 0: shared); b, g (d, B, T) and C, L (d, d, B, T) contiguous; ddt, dy
// (B, T); sums: (B, n_blocks, n_sums).
int PGT_ENTRY(pgt_dt_fisher)(int is64, int family, int degree, const void* scal, const void* dt, long long dt_bs,
                             const void* y, long long y_bs, const void* b, const void* C, const void* g, const void* L,
                             void* ddt, void* dy, void* sums, long long T, int B, int n_blocks, void* stream) {
  if (pgt::bad_shape<PGT_D>(family, degree, T, 1) || n_blocks < 1 || B < 1 || B > 65535) return pgt::kBadArgs;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((unsigned int)n_blocks, (unsigned int)B);
  int rc = 0;
  if (family == pgt::kSpectral) {
#define PGT_LAUNCH(S)                                                                                              \
  rc = pgt::launch_opted_in(pgt::dt_fisher_spectral_kernel<S, PGT_D>, grid,                                        \
                            pgt::FisherBody<S, PGT_D, pgt::Spectral<PGT_D>>::kThreads,                             \
                            pgt::FisherBody<S, PGT_D, pgt::Spectral<PGT_D>>::kBytes, st, (const S*)scal,           \
                            pgt::SpectralScalars<S, PGT_D, true>::kN, (const S*)dt, dt_bs, (const S*)y, y_bs,      \
                            (const S*)b, (const S*)C, (const S*)g, (const S*)L, (S*)ddt, (S*)dy, (S*)sums, T)
    PGT_DISPATCH_TYPE(is64, PGT_LAUNCH);
#undef PGT_LAUNCH
    return rc;
  }
  if (family == pgt::kComposite) {
#define PGT_LAUNCH(S)                                                                                              \
  rc = pgt::launch_opted_in(pgt::dt_fisher_composite_kernel<S, PGT_D>, grid,                                       \
                            pgt::FisherBody<S, PGT_D, pgt::Composite<PGT_D>>::kThreads,                            \
                            pgt::FisherBody<S, PGT_D, pgt::Composite<PGT_D>>::kBytes, st, (const S*)scal,          \
                            pgt::TableScalars<S, PGT_D, true, pgt::Composite<PGT_D>>::kN, (const S*)dt, dt_bs,     \
                            (const S*)y, y_bs, (const S*)b, (const S*)C, (const S*)g, (const S*)L, (S*)ddt,        \
                            (S*)dy, (S*)sums, T)
    PGT_DISPATCH_TYPE(is64, PGT_LAUNCH);
#undef PGT_LAUNCH
    return rc;
  }
#if PGT_D <= 3
  const int n_scal = PGT_D * PGT_D + PGT_D + 2 + degree * PGT_D * PGT_D;
#define PGT_LAUNCH(S)                                                                                       \
  pgt::dt_fisher_kernel<S, PGT_D><<<grid, pgt::kThreads, 0, st>>>(                                          \
      (const S*)scal, n_scal, degree, (const S*)dt, dt_bs, (const S*)y, y_bs, (const S*)b, (const S*)C,     \
      (const S*)g, (const S*)L, (S*)ddt, (S*)dy, (S*)sums, T)
  PGT_DISPATCH_TYPE(is64, PGT_LAUNCH);
#undef PGT_LAUNCH
#endif
  return (int)cudaGetLastError();
}

}  // extern "C"
