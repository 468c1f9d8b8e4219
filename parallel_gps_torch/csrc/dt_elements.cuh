// Element algebra of the dt-engine and strip-engine scans, as CUDA device code.
//
// Counterpart of the row-list algebra in parallel_gps_tpu/kalman/pallas_scan.py
// (_build_filtering_rows :309, _filt_combine_rows :225, _build_smoothing_rows
// :356, _smooth_combine_rows :290, the Schur-recursed _inv :132) and of the
// in-register F/Q rebuild in kalman/pallas_dt.py (_build_fq_pure :104) for the
// three transition families of the port — the exponential polynomial of
// kernels/matern.py, RBF's spectral closed form of kernels/rbf.py (the build
// closure of parallel_gps_tpu/kernels/rbf.py:267) and the composite family
// of Periodic, Sum and Product of kernels/composite.py (the builds of
// parallel_gps_tpu/kernels/periodic.py:140, base.py:242 and :420) — with
// their chain rules (build_fq_vjp, spectral_vjp, composite_weight) for the
// Fisher-tail kernel.
//
// Everything is templated on the scalar type S and the state dimension D
// (1..8; the dt kernels instantiate the exponential polynomial at 1..3 and
// the spectral and composite families at 1..8), with every loop over a
// matrix fully unrolled, so
// an element lives in registers as far as they reach: a filtering element is
// 3D²+2D values (33 at D=3, 120 at D=6, 208 at D=8), a smoothing element
// 2D²+D; beyond about D=4 the compiler spills part of it to local memory.
// Matrices are row-major arrays of D*D values.  The functions that read F and
// Q (and the products they feed) take any indexable matrix: an array, or a
// Strided view of a matrix staged in shared memory (scan_passes.cuh), read
// where it is used rather than held in registers.
#pragma once

#include <cuda_runtime.h>

namespace pgt {

__device__ __forceinline__ float dexp(float x) { return expf(x); }
__device__ __forceinline__ double dexp(double x) { return exp(x); }
__device__ __forceinline__ float dexpm1(float x) { return expm1f(x); }
__device__ __forceinline__ double dexpm1(double x) { return expm1(x); }
__device__ __forceinline__ float dlog(float x) { return logf(x); }
__device__ __forceinline__ double dlog(double x) { return log(x); }
__device__ __forceinline__ void dsincos(float x, float* s, float* c) { sincosf(x, s, c); }
__device__ __forceinline__ void dsincos(double x, double* s, double* c) { sincos(x, s, c); }
__device__ __forceinline__ float dsin(float x) { return sinf(x); }
__device__ __forceinline__ double dsin(double x) { return sin(x); }

// Coefficients of the exponential-polynomial family: [λ | N₁ | … | N_deg],
// degree ≤ D−1 (the Matérn kernels have degree D−1).
template <int D>
struct Exppoly {
  static constexpr int kMaxCoef = 1 + (D - 1) * D * D;
};

// The spectral family of the order-D RBF kernel (kernels/rbf.py), as the
// kernels read it: kBlocks eigenvalue blocks of the unit-lengthscale
// companion, each with a G and an S coefficient matrix, laid out
// [1/ℓ | G_1 | S_1 | … | G_kBlocks | S_kBlocks] (kCoef values), then the block
// table [a_1, β_1, …] (a = −α > 0).  A real root is the block with β = 0 and
// S = 0: its factors below reduce exactly to expm1(−a·u) and 0, so one code
// path serves both kinds of block.  The wrapper (kalman/dt.py) pads the
// model's coefficients, which hold no S for a real root, to this layout.
template <int D>
struct Spectral {
  static constexpr int kBlocks = (D + 1) / 2;
  static constexpr int kCoef = 1 + 2 * kBlocks * D * D;
  static constexpr int kTable = kCoef + 2 * kBlocks;
};

// The composite family (kernels/composite.py), as the kernels read it:
// Am1 = Σ_μ W_μ(dt)·K_μ, each monomial W_μ the product of at most
// kMaxFactors weights w_m(ρ_m, dt), each a closed form of one kind
// (CompositeWeight) of its rate ρ_m and dt.  Laid out, padded to fixed
// limits: [ρ (kMaxWeights) | K_0 … K_{kMaxMonomials−1} (D² each)] (kCoef
// values, the coefficients), then the plan: each weight's (kind, p, q), each
// monomial's factors (−1 for none) and its pattern of structurally nonzero
// entries as kMaskWords words of 16 bits, and the counts (n_w, n_mono).
template <int D>
struct Composite {
  static constexpr int kMaxWeights = 16;
  static constexpr int kMaxMonomials = 32;
  static constexpr int kMaxFactors = 3;
  static constexpr int kMaskWords = 4;
  static_assert(D * D <= 16 * kMaskWords, "a pattern holds D² bits");
  static constexpr int kMonoLen = kMaxFactors + kMaskWords;
  static constexpr int kCoef = kMaxWeights + kMaxMonomials * D * D;
  static constexpr int kWeights = kCoef;                        // (kind, p, q) a weight
  static constexpr int kMonomials = kWeights + 3 * kMaxWeights;  // factors and pattern a monomial
  static constexpr int kCounts = kMonomials + kMonoLen * kMaxMonomials;
  static constexpr int kTable = kCounts + 2;
};

// The kinds of a composite weight (kernels/composite.py: EXPM1, TAU, COSM1,
// SIN, SPEC_EM1, SPEC_ES).
enum CompositeWeight { kWExpm1 = 0, kWTau = 1, kWCosm1 = 2, kWSin = 3, kWSpecEm1 = 4, kWSpecEs = 5 };

// Filtering element (A, b, C, J, η); packed component order A, b, C, J, η.
template <typename S, int D>
struct Filt {
  S A[D * D];
  S b[D];
  S C[D * D];
  S J[D * D];
  S eta[D];
};

// Smoothing element (E, g, L); packed component order E, g, L.
template <typename S, int D>
struct Smooth {
  S E[D * D];
  S g[D];
  S L[D * D];
};

// Values of a filtering element (A, b, C, J, η) and of a smoothing element
// (E, g, L).
template <int D>
struct ElementRows {
  static constexpr int kFilt = 3 * D * D + 2 * D;
  static constexpr int kSmooth = 2 * D * D + D;
};

// Threads of a block (a power of two) of the kernels that scan a tile of
// elements in shared memory, one element a thread (batched_scan.cu,
// plane_scan.cu): fewer as an element grows, so that a tile fits.
template <int D>
struct TileThreads {
  static constexpr int kN = D <= 3 ? 128 : (D <= 5 ? 64 : 32);
};

// ---------------------------------------------------------------------------
// Small-matrix helpers
// ---------------------------------------------------------------------------

template <typename S, int D, typename MA, typename MB>
__device__ __forceinline__ void mm(const MA& a, const MB& b, S* out) {
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      S s = a[i * D] * b[j];
#pragma unroll
      for (int k = 1; k < D; ++k) s += a[i * D + k] * b[k * D + j];
      out[i * D + j] = s;
    }
}

template <typename S, int D>
__device__ __forceinline__ void mv(const S* a, const S* v, S* out) {
#pragma unroll
  for (int i = 0; i < D; ++i) {
    S s = a[i * D] * v[0];
#pragma unroll
    for (int k = 1; k < D; ++k) s += a[i * D + k] * v[k];
    out[i] = s;
  }
}

// out = a · btᵀ + add for a product that is symmetric in exact arithmetic:
// only the upper triangle is computed and mirrored (pallas_scan._mm_symout).
template <typename S, int D, typename MA, typename MB, typename MC>
__device__ __forceinline__ void mm_symout(const MA& a, const MB& bt, const MC& add, S* out) {
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = i; j < D; ++j) {
      S s = a[i * D] * bt[j * D];
#pragma unroll
      for (int k = 1; k < D; ++k) s += a[i * D + k] * bt[j * D + k];
      s += add[i * D + j];
      out[i * D + j] = s;
      out[j * D + i] = s;
    }
}

// How a product that is symmetric in exact arithmetic is made symmetric
// (filt_combine): kMirrored computes the upper triangle and mirrors it
// (mm_symout, pallas_scan._mm_symout); kAveraged computes both triangles
// and averages them, as the plain operator's _sym (kalman/timelast.py) —
// the full product first, then the fold; kAveragedPairs the same values, a
// pair (i, j), (j, i) at a time, which ptxas allocates differently (a
// unit's choice: tile_scan.cuh: FilterOps).  Where an element is combined
// with a carry that has gathered thousands of steps (the chained scans),
// the mirrored upper triangle lets the rounding of the two triangles'
// products drift apart from tile to tile; the average does not.
enum SymForm { kMirrored, kAveraged, kAveragedPairs };

// out = ½(X + Xᵀ), X = a · btᵀ + add.
template <typename S, int D, SymForm Form, typename MA, typename MB, typename MC>
__device__ __forceinline__ void mm_symavg(const MA& a, const MB& bt, const MC& add, S* out) {
  if constexpr (Form == kAveragedPairs) {
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = i; j < D; ++j) {
        S s = a[i * D] * bt[j * D];
#pragma unroll
        for (int k = 1; k < D; ++k) s += a[i * D + k] * bt[j * D + k];
        s += add[i * D + j];
        if (j > i) {
          S t = a[j * D] * bt[i * D];
#pragma unroll
          for (int k = 1; k < D; ++k) t += a[j * D + k] * bt[i * D + k];
          s = S(0.5) * (s + (t + add[j * D + i]));
        }
        out[i * D + j] = s;
        out[j * D + i] = s;
      }
  } else {
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) {
        S s = a[i * D] * bt[j * D];
#pragma unroll
        for (int k = 1; k < D; ++k) s += a[i * D + k] * bt[j * D + k];
        out[i * D + j] = s + add[i * D + j];
      }
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = i + 1; j < D; ++j) {
        const S v = S(0.5) * (out[i * D + j] + out[j * D + i]);
        out[i * D + j] = v;
        out[j * D + i] = v;
      }
  }
}

// (P×Q)·(Q×R) product of row-major blocks (the Schur recursion below).
template <typename S, int P, int Q, int R>
__device__ __forceinline__ void mm_rect(const S* a, const S* b, S* out) {
#pragma unroll
  for (int i = 0; i < P; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) {
      S s = a[i * Q] * b[j];
#pragma unroll
      for (int k = 1; k < Q; ++k) s += a[i * Q + k] * b[k * R + j];
      out[i * R + j] = s;
    }
}

// Inverse: closed-form adjugate for D ≤ 3, and for D > 3 the Schur-complement
// block recursion of pallas_scan._inv (:132) onto those base cases, with the
// same split k = (D+1)/2: M = [[A, B], [C, E]], S = E − C A⁻¹ B,
// M⁻¹ = [[A⁻¹ + A⁻¹B S⁻¹ C A⁻¹, −A⁻¹B S⁻¹], [−S⁻¹ C A⁻¹, S⁻¹]].
template <typename S, int D>
__device__ __forceinline__ void inv(const S* M, S* out) {
  if constexpr (D == 1) {
    out[0] = S(1) / M[0];
  } else if constexpr (D == 2) {
    const S a = M[0], b = M[1], c = M[2], e = M[3];
    const S r = S(1) / (a * e - b * c);
    out[0] = e * r;
    out[1] = -b * r;
    out[2] = -c * r;
    out[3] = a * r;
  } else if constexpr (D > 3) {
    constexpr int k = (D + 1) / 2, m = D - k;
    S A[k * k], B[k * m], C[m * k], E[m * m];
#pragma unroll
    for (int i = 0; i < k; ++i) {
#pragma unroll
      for (int j = 0; j < k; ++j) A[i * k + j] = M[i * D + j];
#pragma unroll
      for (int j = 0; j < m; ++j) B[i * m + j] = M[i * D + k + j];
    }
#pragma unroll
    for (int i = 0; i < m; ++i) {
#pragma unroll
      for (int j = 0; j < k; ++j) C[i * k + j] = M[(k + i) * D + j];
#pragma unroll
      for (int j = 0; j < m; ++j) E[i * m + j] = M[(k + i) * D + k + j];
    }
    S Ainv[k * k], CAinv[m * k], AinvB[k * m], Sc[m * m], Sinv[m * m], AS[k * m], TL[k * k], BL[m * k];
    inv<S, k>(A, Ainv);
    mm_rect<S, m, k, k>(C, Ainv, CAinv);
    mm_rect<S, k, k, m>(Ainv, B, AinvB);
    mm_rect<S, m, k, m>(CAinv, B, Sc);
#pragma unroll
    for (int q = 0; q < m * m; ++q) Sc[q] = E[q] - Sc[q];
    inv<S, m>(Sc, Sinv);
    mm_rect<S, k, m, m>(AinvB, Sinv, AS);
    mm_rect<S, k, m, k>(AS, CAinv, TL);
    mm_rect<S, m, m, k>(Sinv, CAinv, BL);
#pragma unroll
    for (int i = 0; i < k; ++i) {
#pragma unroll
      for (int j = 0; j < k; ++j) out[i * D + j] = Ainv[i * k + j] + TL[i * k + j];
#pragma unroll
      for (int j = 0; j < m; ++j) out[i * D + k + j] = -AS[i * m + j];
    }
#pragma unroll
    for (int i = 0; i < m; ++i) {
#pragma unroll
      for (int j = 0; j < k; ++j) out[(k + i) * D + j] = -BL[i * k + j];
#pragma unroll
      for (int j = 0; j < m; ++j) out[(k + i) * D + k + j] = Sinv[i * m + j];
    }
  } else {
    const S a = M[0], b = M[1], c = M[2];
    const S e = M[3], f = M[4], g = M[5];
    const S h = M[6], i = M[7], j = M[8];
    const S A00 = f * j - g * i, A01 = c * i - b * j, A02 = b * g - c * f;
    const S A10 = g * h - e * j, A11 = a * j - c * h, A12 = c * e - a * g;
    const S A20 = e * i - f * h, A21 = b * h - a * i, A22 = a * f - b * e;
    const S r = S(1) / (a * A00 + b * A10 + c * A20);
    out[0] = A00 * r; out[1] = A01 * r; out[2] = A02 * r;
    out[3] = A10 * r; out[4] = A11 * r; out[5] = A12 * r;
    out[6] = A20 * r; out[7] = A21 * r; out[8] = A22 * r;
  }
}

// ---------------------------------------------------------------------------
// Transition and noise from dt (pallas_dt._build_fq_pure, matern.py:85-101)
// ---------------------------------------------------------------------------

// F = I + Am1 and Q = −(M + Mᵀ + M·Am1ᵀ), M = Am1·P0, from Am1 = expm(dt·F) − I
// of either family.
template <typename S, int D>
__device__ __forceinline__ void fq_from_am1(const S* Am1, const S* P0, S* M, S* F, S* Q) {
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) F[i * D + j] = (i == j) ? S(1) + Am1[i * D + j] : Am1[i * D + j];
  mm<S, D>(Am1, P0, M);
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = i; j < D; ++j) {
      S s = M[i * D + j] + M[j * D + i];
#pragma unroll
      for (int k = 0; k < D; ++k) s += M[i * D + k] * Am1[j * D + k];
      Q[i * D + j] = -s;
      Q[j * D + i] = -s;
    }
}

// The exponential polynomial's F and Q, with
// Am1 = expm1(−λdt)·I + e^{−λdt} Σ_p dt^p/p! N_p.  Also returns Am1 and M,
// which the chain rule below reads.
template <typename S, int D>
__device__ __forceinline__ void build_fq_parts(const S* c, int degree, const S* P0, S dt, S* Am1, S* M, S* F, S* Q) {
  const S lam = c[0];
  const S em1 = dexpm1(-lam * dt);
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) Am1[i * D + j] = (i == j) ? em1 : S(0);
  if (degree > 0) {
    S term = dexp(-lam * dt) * dt;
#pragma unroll
    for (int p = 1; p <= D - 1; ++p) {
      if (p <= degree) {
        const int off = 1 + (p - 1) * D * D;
#pragma unroll
        for (int q = 0; q < D * D; ++q) Am1[q] = Am1[q] + term * c[off + q];
        if (p < degree) term = term * dt * (S(1) / S(p + 1));
      }
    }
  }
  fq_from_am1<S, D>(Am1, P0, M, F, Q);
}

template <typename S, int D>
__device__ __forceinline__ void build_fq(const S* c, int degree, const S* P0, S dt, S* F, S* Q) {
  S Am1[D * D], M[D * D];
  build_fq_parts<S, D>(c, degree, P0, dt, Am1, M, F, Q);
}

// Chain rule of fq_from_am1, written out by hand (the TPU kernel takes
// jax.vjp of _build_fq_pure inside its body, pallas_dt.py:927/:979): from the
// cotangents dF and dQ of one step to dA = ∂ℓ/∂Am1 and d_P0 (D², for P0 as
// the build reads it: unsymmetrised).
//
// Q's upper triangle is written to [i][j] and [j][i] from one value, so its
// cotangent is G_ij = dQ_ij + dQ_ji (dQ_ii on the diagonal).  With
// Q_ij = −(M_ij + M_ji + Σ_k M_ik Am1_jk):
//   dM_ij −= G_ij, dM_ji −= G_ij, dM_ik −= G_ij Am1_jk, dAm1_jk −= G_ij M_ik;
// through M = Am1·P0: dAm1 += dM·P0ᵀ, dP0 = Am1ᵀ·dM; through F: dAm1 += dF.
template <typename S, int D>
__device__ __forceinline__ void am1_vjp(const S* P0, const S* Am1, const S* M, const S* dF, const S* dQ, S* dA,
                                        S* d_P0) {
  S dM[D * D];
#pragma unroll
  for (int q = 0; q < D * D; ++q) {
    dM[q] = S(0);
    dA[q] = dF[q];
  }
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = i; j < D; ++j) {
      const S G = (i == j) ? dQ[i * D + i] : dQ[i * D + j] + dQ[j * D + i];
      dM[i * D + j] -= G;
      dM[j * D + i] -= G;
#pragma unroll
      for (int k = 0; k < D; ++k) {
        dM[i * D + k] -= G * Am1[j * D + k];
        dA[j * D + k] -= G * M[i * D + k];
      }
    }
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      S sa = dM[i * D] * P0[j * D];
      S sp = Am1[i] * dM[j];
#pragma unroll
      for (int k = 1; k < D; ++k) {
        sa += dM[i * D + k] * P0[j * D + k];
        sp += Am1[k * D + i] * dM[k * D + j];
      }
      dA[i * D + j] += sa;
      d_P0[i * D + j] = sp;
    }
}

// Chain rule of build_fq_parts: from dF and dQ of one step to d_c (kMaxCoef
// values, zero beyond the degree), d_P0 and d_dt (am1_vjp, then through
// Am1 = em1·I + Σ_p τ_p N_p with em1 = expm1(−λdt), τ_p = e^{−λdt} dt^p/p!
// (τ_0 = e^{−λdt}):
//   dN_p = τ_p dAm1,  dτ_p = ⟨dAm1, N_p⟩,  dem1 = tr dAm1,
//   ∂em1/∂λ = −dt τ_0, ∂em1/∂dt = −λ τ_0,
//   ∂τ_p/∂λ = −dt τ_p, ∂τ_p/∂dt = τ_{p−1} − λ τ_p.
template <typename S, int D>
__device__ __forceinline__ void build_fq_vjp(const S* c, int degree, const S* P0, S dt, const S* Am1, const S* M,
                                             const S* dF, const S* dQ, S* d_c, S* d_P0, S& d_dt) {
  S dA[D * D];
  am1_vjp<S, D>(P0, Am1, M, dF, dQ, dA, d_P0);
  const S lam = c[0];
  const S e = dexp(-lam * dt);
  S d_em1 = dA[0];
#pragma unroll
  for (int i = 1; i < D; ++i) d_em1 += dA[i * D + i];
  S d_lam = -dt * e * d_em1;
  d_dt = -lam * e * d_em1;
#pragma unroll
  for (int q = 0; q < Exppoly<D>::kMaxCoef; ++q) d_c[q] = S(0);
  S tau_prev = e;
#pragma unroll
  for (int p = 1; p <= D - 1; ++p) {
    if (p <= degree) {
      const S tau = tau_prev * dt * (S(1) / S(p));
      const int off = 1 + (p - 1) * D * D;
      S d_tau = S(0);
#pragma unroll
      for (int q = 0; q < D * D; ++q) {
        d_tau += dA[q] * c[off + q];
        d_c[off + q] = tau * dA[q];
      }
      d_lam -= dt * tau * d_tau;
      d_dt += d_tau * (tau_prev - lam * tau);
      tau_prev = tau;
    }
  }
  d_c[0] = d_lam;
}

// The spectral family's Am1 (kernels/rbf.py::spectral_transitions_m1), from
// the table ``c`` (Spectral<D>: coefficients, then the block table): with
// u = dt·c[0], each block adds em1·G + es·S, em1 = expm1(−a·u)·cos(βu) −
// 2 sin²(βu/2) and es = e^{−a·u} sin(βu).  ``w``, if given, receives the
// block's (em1, es), the weights of its G and S in Am1.  The loop over the
// blocks stays rolled: unrolled, ptxas gave the f32 D = 8 filter scan 32
// registers and 29 KB of spills (16 ms at N = 1M on an H100), rolled 255
// registers and 3.2 KB.
template <typename S, int D>
__device__ __forceinline__ void spectral_am1(const S* c, S dt, S* Am1, S* w = nullptr) {
  typedef Spectral<D> Sp;
  const S u = dt * c[0];
#pragma unroll
  for (int q = 0; q < D * D; ++q) Am1[q] = S(0);
#pragma unroll 1
  for (int k = 0; k < Sp::kBlocks; ++k) {
    const S a = c[Sp::kCoef + 2 * k], beta = c[Sp::kCoef + 2 * k + 1];
    S sn, cs;
    dsincos(beta * u, &sn, &cs);
    const S sh = dsin(S(0.5) * beta * u);
    const S em1 = dexpm1(-a * u) * cs - S(2) * sh * sh;
    const S es = dexp(-a * u) * sn;
    const S* G = c + 1 + 2 * k * D * D;
#pragma unroll
    for (int q = 0; q < D * D; ++q) Am1[q] = Am1[q] + em1 * G[q] + es * G[D * D + q];
    if (w) {
      w[2 * k] = em1;
      w[2 * k + 1] = es;
    }
  }
}

// Chain rule of the spectral Am1 from dA = ∂ℓ/∂Am1 of one step: the
// cotangents of block k's matrices are w_{2k}·dA (G) and w_{2k+1}·dA (S),
// left to the caller, which sums them over the steps (dt_fisher.cu); this
// returns ∂ℓ/∂u = Σ_k em1′⟨dA, G_k⟩ + es′⟨dA, S_k⟩ with
//   em1′ = −a·e^{−au} cos(βu) − β·e^{−au} sin(βu),  es′ = −a·es + β·e^{−au} cos(βu),
// so that d c[0] = dt·∂ℓ/∂u and d dt = c[0]·∂ℓ/∂u.  At dt = 0 every one of
// these is exactly 0 (em1 = es = 0 and u = 0).
template <typename S, int D>
__device__ __forceinline__ S spectral_vjp(const S* c, S dt, const S* dA) {
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
    const S* G = c + 1 + 2 * k * D * D;
    S pg = S(0), ps = S(0);
#pragma unroll
    for (int q = 0; q < D * D; ++q) {
      pg += dA[q] * G[q];
      ps += dA[q] * G[D * D + q];
    }
    d_u += d_em1 * pg + d_es * ps;
  }
  return d_u;
}

// One composite weight of kind ``kind`` (constants p, q) of rate rho at dt,
// and its derivatives by rho and by dt (kernels/composite.py: weights):
//   expm1(−ρdt);  τ_p = e^{−ρdt} dt^p/p! (∂ρ = −dt τ_p, ∂dt = τ_{p−1} − ρ τ_p);
//   cos θ − 1 = −2 sin²(θ/2) and sin θ, θ = (pρ)·dt (harmonic p);
//   a spectral block's em1 and es of u = dt·ρ (a = p, β = q), as spectral_am1.
// The rotation's and the spectral block's are functions of ρ·dt alone:
// ∂ρ = dt·f′ and ∂dt = ρ·f′.
template <typename S>
__device__ __forceinline__ S composite_weight(int kind, S p, S q, S rho, S dt, S& d_rho, S& d_dt) {
  if (kind == kWExpm1 || kind == kWTau) {
    const S e = dexp(-rho * dt);
    if (kind == kWExpm1) {
      d_rho = -dt * e;
      d_dt = -rho * e;
      return dexpm1(-rho * dt);
    }
    S prev = e, tau = e;
#pragma unroll 1
    for (int k = 1; k <= (int)p; ++k) {
      prev = tau;
      tau = tau * dt * (S(1) / S(k));
    }
    d_rho = -dt * tau;
    d_dt = prev - rho * tau;
    return tau;
  }
  S sn, cs;
  if (kind == kWCosm1 || kind == kWSin) {
    const S om = p * rho;
    const S th = om * dt;
    dsincos(th, &sn, &cs);
    if (kind == kWSin) {
      d_rho = p * dt * cs;
      d_dt = om * cs;
      return sn;
    }
    const S sh = dsin(S(0.5) * th);
    d_rho = -p * dt * sn;
    d_dt = -om * sn;
    return S(-2) * sh * sh;
  }
  const S u = dt * rho;
  dsincos(q * u, &sn, &cs);
  const S e = dexp(-p * u);
  const S es = e * sn;
  S w, fp;
  if (kind == kWSpecEm1) {
    const S sh = dsin(S(0.5) * q * u);
    w = dexpm1(-p * u) * cs - S(2) * sh * sh;
    fp = -p * e * cs - q * es;
  } else {
    w = es;
    fp = -p * es + q * e * cs;
  }
  d_rho = dt * fp;
  d_dt = rho * fp;
  return w;
}

// The weights of step dt, w[m] for m < n_w (and their derivatives by rate
// and by dt where w_rho is given).  The weights and the factors that index
// them are read at run time: ``w`` is a small array of the thread's local
// memory, read a few times a monomial; Am1 below is written through fixed
// indices only.
template <typename S, int D>
__device__ __forceinline__ int composite_weights(const S* c, S dt, S* w, S* w_rho = nullptr, S* w_dt = nullptr) {
  typedef Composite<D> Cp;
  const int n_w = (int)c[Cp::kCounts];
#pragma unroll 1
  for (int m = 0; m < n_w; ++m) {
    const S* spec = c + Cp::kWeights + 3 * m;
    S dr, dd;
    w[m] = composite_weight<S>((int)spec[0], spec[1], spec[2], c[m], dt, dr, dd);
    if (w_rho) {
      w_rho[m] = dr;
      w_dt[m] = dd;
    }
  }
  return n_w;
}

// Monomial ``mu``'s factors (−1 for none) and its value from the weights.
template <typename S, int D>
__device__ __forceinline__ S composite_monomial(const S* c, int mu, const S* w, int* f) {
  typedef Composite<D> Cp;
  const S* spec = c + Cp::kMonomials + Cp::kMonoLen * mu;
  S W = S(1);
#pragma unroll
  for (int i = 0; i < Cp::kMaxFactors; ++i) {
    f[i] = (int)spec[i];
    if (f[i] >= 0) W = (i == 0) ? w[f[i]] : W * w[f[i]];
  }
  return W;
}

// Bit q of monomial mu's pattern: whether K_mu[q] is structurally nonzero.
template <int D>
struct CompositeMask {
  unsigned words[Composite<D>::kMaskWords];
  template <typename S>
  __device__ __forceinline__ void load(const S* c, int mu) {
    const S* spec = c + Composite<D>::kMonomials + Composite<D>::kMonoLen * mu + Composite<D>::kMaxFactors;
#pragma unroll
    for (int k = 0; k < Composite<D>::kMaskWords; ++k) words[k] = (16 * k < D * D) ? (unsigned)spec[k] : 0u;
  }
  __device__ __forceinline__ bool on(int q) const { return (words[q >> 4] >> (q & 15)) & 1u; }
};

// The composite family's Am1 = Σ_μ W_μ·K_μ over the structurally nonzero
// entries, in the plan's order (kernels/composite.py:
// composite_transitions_m1).
template <typename S, int D>
__device__ __forceinline__ void composite_am1(const S* c, S dt, S* Am1) {
  typedef Composite<D> Cp;
  S w[Cp::kMaxWeights];
  composite_weights<S, D>(c, dt, w);
#pragma unroll
  for (int q = 0; q < D * D; ++q) Am1[q] = S(0);
  const int n_mono = (int)c[Cp::kCounts + 1];
#pragma unroll 1
  for (int mu = 0; mu < n_mono; ++mu) {
    int f[Cp::kMaxFactors];
    const S Wm = composite_monomial<S, D>(c, mu, w, f);
    CompositeMask<D> mask;
    mask.load(c, mu);
    const S* K = c + Cp::kMaxWeights + mu * D * D;
#pragma unroll
    for (int q = 0; q < D * D; ++q)
      if (mask.on(q)) Am1[q] = Am1[q] + Wm * K[q];
  }
}

// The Am1 of a family that reads its coefficients from a table (tags
// Spectral<D>, Composite<D>).
template <typename S, int D>
__device__ __forceinline__ void table_am1(Spectral<D>, const S* c, S dt, S* Am1) {
  spectral_am1<S, D>(c, dt, Am1);
}

template <typename S, int D>
__device__ __forceinline__ void table_am1(Composite<D>, const S* c, S dt, S* Am1) {
  composite_am1<S, D>(c, dt, Am1);
}

// ---------------------------------------------------------------------------
// Filtering elements (pallas_scan._build_filtering_rows, _filt_combine_rows)
// ---------------------------------------------------------------------------

// Element of step t from its F, Q and observation.  mask is 1 for an observed
// step and 0 for a missing one (then K = 0: A=F, C=Q, b=η=J=0).  is_first
// marks global t = 0, which updates against (m0 = 0, P0).
template <typename S, int D, typename M>
__device__ __forceinline__ void build_filtering(const M& F, const M& Q, S y, S mask, const S* h, S r,
                                                const S* P0, bool is_first, Filt<S, D>& e) {
  S HQ[D], HF[D];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    S sq = h[0] * Q[j], sf = h[0] * F[j];
#pragma unroll
    for (int k = 1; k < D; ++k) {
      sq += h[k] * Q[k * D + j];
      sf += h[k] * F[k * D + j];
    }
    HQ[j] = sq;
    HF[j] = sf;
  }
  S s = h[0] * HQ[0];
#pragma unroll
  for (int j = 1; j < D; ++j) s += h[j] * HQ[j];
  const S Sinv_m = mask / (s + r);
  const S Sy = Sinv_m * y;
#pragma unroll
  for (int a = 0; a < D; ++a) {
    const S K = HQ[a] * Sinv_m;
    e.b[a] = K * y;
    e.eta[a] = HF[a] * Sy;
#pragma unroll
    for (int c = 0; c < D; ++c) {
      e.A[a * D + c] = F[a * D + c] - K * HF[c];
      e.C[a * D + c] = Q[a * D + c] - K * HQ[c];
      e.J[a * D + c] = HF[a] * HF[c] * Sinv_m;
    }
  }
  if (is_first) {
    S P0h[D];
    mv<S, D>(P0, h, P0h);
    S s1 = h[0] * P0h[0];
#pragma unroll
    for (int k = 1; k < D; ++k) s1 += h[k] * P0h[k];
    const S S1 = s1 + r;
#pragma unroll
    for (int a = 0; a < D; ++a) {
      const S K1 = P0h[a] / S1;
      e.b[a] = mask * (K1 * y);
#pragma unroll
      for (int c = 0; c < D; ++c) {
        e.A[a * D + c] = S(0);
        e.C[a * D + c] = P0[a * D + c] - mask * (K1 * P0h[c]);
      }
    }
  }
}

// e1 ∘ e2 with e1 the earlier element.  C1 and J2 are symmetric, so
// I + J2 C1 = (I + C1 J2)ᵀ and its inverse is Vᵀ: one inverse per combine.
// C and J are symmetric in exact arithmetic (SymForm): the sequential folds
// of a chunk (scan_passes.cuh, batched_walk.cuh) mirror their upper
// triangles, as the reference's fold does; the tiled and chained scans
// (tile_scan.cuh: FilterOps) average the two triangles, as the plain
// operator does.
template <typename S, int D, SymForm Form = kMirrored>
__device__ __forceinline__ Filt<S, D> filt_combine(const Filt<S, D>& e1, const Filt<S, D>& e2) {
  Filt<S, D> o;
  S M[D * D], V[D * D], U[D * D], T1[D * D], W[D * D];
  mm<S, D>(e1.C, e2.J, M);
#pragma unroll
  for (int i = 0; i < D; ++i) M[i * D + i] += S(1);
  inv<S, D>(M, V);
  mm<S, D>(e2.A, V, U);
  mm<S, D>(U, e1.A, o.A);
  S v1[D], v2[D];
  mv<S, D>(e1.C, e2.eta, v1);
#pragma unroll
  for (int i = 0; i < D; ++i) v1[i] += e1.b[i];
  mv<S, D>(U, v1, v2);
#pragma unroll
  for (int i = 0; i < D; ++i) o.b[i] = v2[i] + e2.b[i];
  mm<S, D>(U, e1.C, T1);
  if constexpr (Form != kMirrored)
    mm_symavg<S, D, Form>(T1, e2.A, e2.C, o.C);
  else
    mm_symout<S, D>(T1, e2.A, e2.C, o.C);
  // W = A1ᵀ Vᵀ: W[i][j] = Σ_k A1[k][i] V[j][k].
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      S s = e1.A[i] * V[j * D];
#pragma unroll
      for (int k = 1; k < D; ++k) s += e1.A[k * D + i] * V[j * D + k];
      W[i * D + j] = s;
    }
  mv<S, D>(e2.J, e1.b, v1);
#pragma unroll
  for (int i = 0; i < D; ++i) v1[i] = e2.eta[i] - v1[i];
  mv<S, D>(W, v1, v2);
#pragma unroll
  for (int i = 0; i < D; ++i) o.eta[i] = v2[i] + e1.eta[i];
  mm<S, D>(W, e2.J, T1);
  // J = (W J2) A1 + J1, symmetric: bt = A1ᵀ.
  S A1t[D * D];
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) A1t[i * D + j] = e1.A[j * D + i];
  if constexpr (Form != kMirrored)
    mm_symavg<S, D, Form>(T1, A1t, e1.J, o.J);
  else
    mm_symout<S, D>(T1, A1t, e1.J, o.J);
  return o;
}

// ---------------------------------------------------------------------------
// Smoothing elements (pallas_scan._build_smoothing_rows, _smooth_combine_rows)
// ---------------------------------------------------------------------------

// Element of step t < T−1 from the next step's Fn, Qn and the filtered
// moments (m, P) at t.
template <typename S, int D, typename M>
__device__ __forceinline__ void build_smoothing(const M& Fn, const M& Qn, const S* m, const S* P, Smooth<S, D>& e) {
  S FP[D * D], Pp[D * D], Pinv[D * D], T1[D * D];
  mm<S, D>(Fn, P, FP);
  mm_symout<S, D>(FP, Fn, Qn, Pp);
  inv<S, D>(Pp, Pinv);
  mm<S, D>(Pinv, FP, T1);
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) e.E[i * D + j] = T1[j * D + i];
  S EF[D * D], v[D];
  mm<S, D>(e.E, Fn, EF);
  mv<S, D>(EF, m, v);
#pragma unroll
  for (int a = 0; a < D; ++a) e.g[a] = m[a] - v[a];
  // L = P − E Pp Eᵀ, symmetric: PpE[c][k1] = Σ_k2 Pp[k1][k2] E[c][k2].
  S PpE[D * D];
#pragma unroll
  for (int c = 0; c < D; ++c)
#pragma unroll
    for (int k1 = 0; k1 < D; ++k1) {
      S s = Pp[k1 * D] * e.E[c * D];
#pragma unroll
      for (int k2 = 1; k2 < D; ++k2) s += Pp[k1 * D + k2] * e.E[c * D + k2];
      PpE[c * D + k1] = s;
    }
#pragma unroll
  for (int a = 0; a < D; ++a)
#pragma unroll
    for (int c = a; c < D; ++c) {
      S s = e.E[a * D] * PpE[c * D];
#pragma unroll
      for (int k1 = 1; k1 < D; ++k1) s += e.E[a * D + k1] * PpE[c * D + k1];
      const S v2 = P[a * D + c] - s;
      e.L[a * D + c] = v2;
      e.L[c * D + a] = v2;
    }
}

// The global-last element: (E = 0, g = m, L = P).
template <typename S, int D>
__device__ __forceinline__ void build_smoothing_last(const S* m, const S* P, Smooth<S, D>& e) {
#pragma unroll
  for (int q = 0; q < D * D; ++q) {
    e.E[q] = S(0);
    e.L[q] = P[q];
  }
#pragma unroll
  for (int a = 0; a < D; ++a) e.g[a] = m[a];
}

// e1 ∘ e2 with e1 the LATER (suffix) element and e2 the current one.
template <typename S, int D>
__device__ __forceinline__ Smooth<S, D> smooth_combine(const Smooth<S, D>& e1, const Smooth<S, D>& e2) {
  Smooth<S, D> o;
  mm<S, D>(e2.E, e1.E, o.E);
  S v[D];
  mv<S, D>(e2.E, e1.g, v);
#pragma unroll
  for (int i = 0; i < D; ++i) o.g[i] = v[i] + e2.g[i];
  S T1[D * D];
  mm<S, D>(e2.E, e1.L, T1);
  mm_symout<S, D>(T1, e2.E, e2.L, o.L);
  return o;
}

// ---------------------------------------------------------------------------
// Packed (n, stride) component planes
// ---------------------------------------------------------------------------

template <typename S, int D>
__device__ __forceinline__ void load_filt(const S* X, long long stride, long long i, Filt<S, D>& e) {
  int k = 0;
#pragma unroll
  for (int q = 0; q < D * D; ++q) e.A[q] = X[(k++) * stride + i];
#pragma unroll
  for (int q = 0; q < D; ++q) e.b[q] = X[(k++) * stride + i];
#pragma unroll
  for (int q = 0; q < D * D; ++q) e.C[q] = X[(k++) * stride + i];
#pragma unroll
  for (int q = 0; q < D * D; ++q) e.J[q] = X[(k++) * stride + i];
#pragma unroll
  for (int q = 0; q < D; ++q) e.eta[q] = X[(k++) * stride + i];
}

template <typename S, int D>
__device__ __forceinline__ void store_filt(S* X, long long stride, long long i, const Filt<S, D>& e) {
  int k = 0;
#pragma unroll
  for (int q = 0; q < D * D; ++q) X[(k++) * stride + i] = e.A[q];
#pragma unroll
  for (int q = 0; q < D; ++q) X[(k++) * stride + i] = e.b[q];
#pragma unroll
  for (int q = 0; q < D * D; ++q) X[(k++) * stride + i] = e.C[q];
#pragma unroll
  for (int q = 0; q < D * D; ++q) X[(k++) * stride + i] = e.J[q];
#pragma unroll
  for (int q = 0; q < D; ++q) X[(k++) * stride + i] = e.eta[q];
}

template <typename S, int D>
__device__ __forceinline__ void load_smooth(const S* X, long long stride, long long i, Smooth<S, D>& e) {
  int k = 0;
#pragma unroll
  for (int q = 0; q < D * D; ++q) e.E[q] = X[(k++) * stride + i];
#pragma unroll
  for (int q = 0; q < D; ++q) e.g[q] = X[(k++) * stride + i];
#pragma unroll
  for (int q = 0; q < D * D; ++q) e.L[q] = X[(k++) * stride + i];
}

template <typename S, int D>
__device__ __forceinline__ void store_smooth(S* X, long long stride, long long i, const Smooth<S, D>& e) {
  int k = 0;
#pragma unroll
  for (int q = 0; q < D * D; ++q) X[(k++) * stride + i] = e.E[q];
#pragma unroll
  for (int q = 0; q < D; ++q) X[(k++) * stride + i] = e.g[q];
#pragma unroll
  for (int q = 0; q < D * D; ++q) X[(k++) * stride + i] = e.L[q];
}

}  // namespace pgt
