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
// One translation unit per state dimension (kalman/_cuda.py: VARIANTS):
// compile with -DPGT_D=<1..8>.
#include <cuda_runtime.h>

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

template <typename S, int D>
__global__ void __launch_bounds__(kThreads)
    dt_fisher_spectral_kernel(const S* __restrict__ scal, int n_scal, const S* __restrict__ dt, long long dt_bs,
                              const S* __restrict__ y, long long y_bs, const S* __restrict__ b,
                              const S* __restrict__ C, const S* __restrict__ g, const S* __restrict__ L,
                              S* __restrict__ ddt_out, S* __restrict__ dy_out, S* __restrict__ sums, long long T) {
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
#pragma unroll 8
        for (int k = 0; k < kThreads; ++k) s += row[k];
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
__global__ void __launch_bounds__(kThreads)
    dt_fisher_composite_kernel(const S* __restrict__ scal, int n_scal, const S* __restrict__ dt, long long dt_bs,
                               const S* __restrict__ y, long long y_bs, const S* __restrict__ b,
                               const S* __restrict__ C, const S* __restrict__ g, const S* __restrict__ L,
                               S* __restrict__ ddt_out, S* __restrict__ dy_out, S* __restrict__ sums, long long T) {
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
#pragma unroll 8
        for (int k = 0; k < kThreads; ++k) s += row[k];
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
  rc = pgt::launch_opted_in(pgt::dt_fisher_spectral_kernel<S, PGT_D>, grid, pgt::kThreads,                         \
                            pgt::SpectralFisher<S, PGT_D>::kBytes, st, (const S*)scal,                             \
                            pgt::SpectralScalars<S, PGT_D, true>::kN, (const S*)dt, dt_bs, (const S*)y, y_bs,      \
                            (const S*)b, (const S*)C, (const S*)g, (const S*)L, (S*)ddt, (S*)dy, (S*)sums, T)
    PGT_DISPATCH_TYPE(is64, PGT_LAUNCH);
#undef PGT_LAUNCH
    return rc;
  }
  if (family == pgt::kComposite) {
#define PGT_LAUNCH(S)                                                                                              \
  rc = pgt::launch_opted_in(pgt::dt_fisher_composite_kernel<S, PGT_D>, grid, pgt::kThreads,                        \
                            pgt::CompositeFisher<S, PGT_D>::kBytes, st, (const S*)scal,                            \
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
