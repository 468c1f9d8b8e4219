// The four passes of the two-pass chunked scans, as device code shared by the
// dt-engine kernels (dt_scan.cu: F and Q rebuilt from dt) and the
// plane-streaming strip kernels (strip_scan.cu: F and Q loaded from (D, D, T)
// planes).  The two engines differ only in the source of a step's F and Q.
//
// A filter source ``Src`` provides the members P0 (D²), h (D), r and
//     void fq(long long t, S* F, S* Q) const;   // F_t, Q_t, row-major
// (the dt filter sources also build(dt, F, Q), F and Q from a dt value; the
// bodies that stage F and Q read only P0, h and r); a smoother source
// provides fq alone.
//
// Each thread owns chunk c: the K consecutive steps [c·K, min(T, (c+1)·K)).
//
// Every body stages its rows through shared memory a warp at a time
// (ChunkStage): filter_apply_staged its outputs, smoother_apply_staged its
// moments in and out, smoother_scan_staged its moments in, filter_scan_staged
// its y and dt in (the pass-1 bodies in one buffer or two, ScanRounds), and
// filter_apply_planes / filter_scan_planes / smoother_apply_planes /
// smoother_scan_planes the F and Q planes too (the strip filter, and the
// strip smoother's units where that stage fits and measured faster) — but
// filter_scan_direct, the filter's pass 1 at the units where reading its
// rows strided measured faster.
#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "dt_launch.cuh"

namespace pgt {

// Filtering element of step t; also returns its F, Q and cleaned observation.
template <typename S, int D, typename Src>
__device__ __forceinline__ void filter_step(const Src& p, const S* y, long long t, S* F, S* Q, S& yc, bool& observed,
                                            Filt<S, D>& e) {
  const S yv = y[t];
  observed = !(yv != yv);  // NaN marks a missing observation
  yc = observed ? yv : S(0);
  p.fq(t, F, Q);
  build_filtering<S, D>(F, Q, yc, observed ? S(1) : S(0), p.h, p.r, p.P0, t == 0, e);
}

// Smoothing element of step t from the filtered (m, P) at t: F, Q of step
// t+1; the global-last step is (E = 0, g = m, L = P).
template <typename S, int D, typename Src>
__device__ __forceinline__ void smoothing_element(const Src& p, const S* m, const S* P, long long t, long long T,
                                                  Smooth<S, D>& e) {
  if (t == T - 1) {
    build_smoothing_last<S, D>(m, P, e);
  } else {
    S Fn[D * D], Qn[D * D];
    p.fq(t + 1, Fn, Qn);
    build_smoothing<S, D>(Fn, Qn, m, P, e);
  }
}

// Smoothing element of step t, its filtered (m, P) read from b and C.
// ``bs`` and ``cs`` are the plane strides of b and C (T for one series; B·T
// with a batch axis).
template <typename S, int D, typename Src>
__device__ __forceinline__ void smoother_step(const Src& p, const S* b, long long bs, const S* C, long long cs,
                                              long long t, long long T, Smooth<S, D>& e) {
  S m[D], P[D * D];
#pragma unroll
  for (int a = 0; a < D; ++a) m[a] = b[a * bs + t];
#pragma unroll
  for (int q = 0; q < D * D; ++q) P[q] = C[q * cs + t];
  smoothing_element<S, D>(p, m, P, t, T, e);
}

// log p(y_t | y_<t) of an observed step from its F, Q and the moments before
// it: the prefix-included element before step t, or (0, P0) at global t = 0.
template <typename S, int D, typename Src, typename M>
__device__ __forceinline__ S step_loglik(const Src& p, const M& F, const M& Q, S yc, const Filt<S, D>& acc,
                                         bool is_first) {
  const S log2pi = S(1.8378770664093454835606594728112);  // log(2π)
  S mprev[D], Pprev[D * D];
#pragma unroll
  for (int a = 0; a < D; ++a) mprev[a] = is_first ? S(0) : acc.b[a];
#pragma unroll
  for (int q = 0; q < D * D; ++q) Pprev[q] = is_first ? p.P0[q] : acc.C[q];
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
  return S(-0.5) * (diff * diff / var + dlog(var) + log2pi);
}

// Filter pass 1 reading its steps directly, each thread its own chunk's y
// and F, Q from the source, strided by K: fold chunk c to its total, from the
// element of its first step t0, every later step combined in.
template <typename S, int D, typename Src>
__device__ __forceinline__ void filter_scan_direct(const Src& p, const S* y, S* totals, long long T, int K,
                                                   long long n_chunks, long long c) {
  const long long t0 = c * K;
  const long long t1 = (t0 + K < T) ? t0 + K : T;
  S F[D * D], Q[D * D], yc;
  bool observed;
  Filt<S, D> acc, e;
  filter_step<S, D>(p, y, t0, F, Q, yc, observed, acc);
  for (long long t = t0 + 1; t < t1; ++t) {
    filter_step<S, D>(p, y, t, F, Q, yc, observed, e);
    acc = filt_combine<S, D>(acc, e);
  }
  store_filt<S, D>(totals, n_chunks, c, acc);
}

// Shared memory of the staged pass-2 bodies: each warp stages kR steps of its
// 32 chunks' kRows rows — by default b then C, D + D² rows, the filter's
// outputs, the smoother's inputs b, C and, in the same places, its outputs
// g, L — a chunk's kR values of a row in a slot of kR + 1 (the pad keeps the
// warp's writes, 32 slots kR+1 apart, on distinct banks; the smoother that
// stages its planes keeps the step after a round there).  kR fills one
// 32-byte sector: 8 steps at float, 4 at double.  A block is kWarps warps.
template <typename S, int D, int Rows = D + D * D, int Warps = kThreads / 32>
struct ChunkStage {
  static constexpr int kR = 32 / sizeof(S);
  static constexpr int kRows = Rows;
  static constexpr int kSlot = kR + 1;
  static constexpr int kRow = 32 * kSlot;  // one row of a warp's region
  static constexpr int kWarp = kRows * kRow;
  static constexpr int kWarps = Warps;
  static constexpr int kThreads = 32 * Warps;
  static constexpr int kBytes = Warps * kWarp * (int)sizeof(S);
};

// Row i of a warp's region read as row i of a D×D matrix: a matrix of one
// step staged in shared memory, read by the algebra where it is used.
template <typename S, int kStride>
struct Strided {
  const S* p;
  __device__ __forceinline__ S operator[](int i) const { return p[i * kStride]; }
};

// The rows a stage copy moves: row i < kN is at(i, T), T values in device
// memory.  MomentRows: b (D rows) then C (D²).
template <typename P, int D>
struct MomentRows {
  static constexpr int kN = D + D * D;
  P b, C;
  __device__ __forceinline__ P at(int row, long long T) const { return row < D ? b + row * T : C + (row - D) * T; }
};

// The filter's inputs: F (D² rows), Q (D²), y.
template <typename S, int D>
struct FilterPlaneRows {
  static constexpr int kN = 2 * D * D + 1;
  const S* Fs;
  const S* Qs;
  const S* y;
  __device__ __forceinline__ const S* at(int row, long long T) const {
    return row < D * D ? Fs + row * T : (row < 2 * D * D ? Qs + (row - D * D) * T : y);
  }
};

// The dt filter's inputs: y, then dt.
template <typename S>
struct FilterDtRows {
  static constexpr int kN = 2;
  const S* y;
  const S* dt;
  __device__ __forceinline__ const S* at(int row, long long) const { return row == 0 ? y : dt; }
};

// The smoother's inputs: b (D rows), C (D²), F (D²), Q (D²).
template <typename S, int D>
struct SmootherPlaneRows {
  static constexpr int kN = 3 * D * D + D;
  const S* b;
  const S* C;
  const S* Fs;
  const S* Qs;
  __device__ __forceinline__ const S* at(int row, long long T) const {
    if (row < D) return b + row * T;
    if (row < D + D * D) return C + (row - D) * T;
    if (row < D + 2 * D * D) return Fs + (row - D - D * D) * T;
    return Qs + (row - D - 2 * D * D) * T;
  }
};

// One round's copy between the stage and device memory of the rows ``rows``
// (the first Rows::kN rows of the region): value i·32 + lane of a row is
// step r0 + lane % kR of chunk c0 + i·(32/kR) + lane / kR, so each load or
// store instruction covers 32/kR whole sectors, in place of 32 partial
// sectors when each thread moves its own chunk's values.  Steps past a chunk
// (r0 + s ≥ K) or past T are not moved.  In each lane it touches the same
// stage values in every round and every row, in either direction.  The copy
// in is asynchronous (cp.async): every value of the lane's share is in
// flight at once, and has landed when it returns (the caller synchronises
// the warp) — or, with kWait false, is committed as one group and left in
// flight (the caller waits on it, __pipeline_wait_prior).
template <typename S, bool kToStage, typename Rows, bool kWait = true>
__device__ __forceinline__ void stage_rows(const Rows& rows, S* stage, long long c0, int K, long long T, int r0) {
  typedef ChunkStage<S, 1> G;  // kR, kSlot and kRow do not depend on D
  constexpr int R = G::kR;
  const int lane = threadIdx.x & 31;
  const int s = lane % R;
#pragma unroll 1
  for (int row = 0; row < Rows::kN; ++row) {
    const auto dev = rows.at(row, T);
    S* sm = stage + row * G::kRow + s;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int j = i * (32 / R) + lane / R;
      const long long t = (c0 + j) * K + r0 + s;
      if (r0 + s < K && t < T) {
        if constexpr (kToStage) {
          __pipeline_memcpy_async(sm + j * G::kSlot, dev + t, sizeof(S));
        } else {
          dev[t] = sm[j * G::kSlot];
        }
      }
    }
  }
  if constexpr (kToStage) {
    __pipeline_commit();
    if constexpr (kWait) __pipeline_wait_prior(0);
  }
}

// Filter pass 2: re-fold chunk c seeded with its exclusive prefix, step by
// step in order, write the filtered moments, and return the chunk's share of
// the log-likelihood.  Its stores are staged through ``stage`` (the calling warp's
// ChunkStage<S, D>::kWarp values of shared memory).  The warp folds kR steps
// of each of its 32 chunks into shared memory, synchronises, and writes each
// output row as whole sectors (stage_rows).  Every thread of the warp calls
// it, chunk or not (c ≥ n_chunks); the round count is the warp's first
// chunk's.
template <typename S, int D, typename Src>
__device__ __forceinline__ S filter_apply_staged(const Src& p, const S* prefix, const S* y, S* b_out, S* C_out,
                                                 long long T, int K, long long n_chunks, long long c, S* stage) {
  typedef ChunkStage<S, D> G;
  constexpr int R = G::kR;
  const int lane = threadIdx.x & 31;
  const long long c0 = c - lane;  // the warp's first chunk
  const long long t0 = c * K;
  const long long t1 = (c < n_chunks) ? ((t0 + K < T) ? t0 + K : T) : t0;
  const long long span = (c0 * K < T) ? ((T - c0 * K < K) ? T - c0 * K : K) : 0;  // the same for the warp
  S ll = S(0);
  Filt<S, D> acc, e;
  if (c < n_chunks) load_filt<S, D>(prefix, n_chunks, c, acc);
  S* slot = stage + lane * G::kSlot;
#pragma unroll 1
  for (int r0 = 0; r0 < span; r0 += R) {
#pragma unroll 1
    for (int s = 0; s < R; ++s) {
      const long long t = t0 + r0 + s;
      if (t >= t1) break;
      S F[D * D], Q[D * D], yc;
      bool observed;
      filter_step<S, D>(p, y, t, F, Q, yc, observed, e);
      if (observed) ll += step_loglik<S, D>(p, F, Q, yc, acc, t == 0);
      acc = filt_combine<S, D>(acc, e);
#pragma unroll
      for (int a = 0; a < D; ++a) slot[a * G::kRow + s] = acc.b[a];
#pragma unroll
      for (int q = 0; q < D * D; ++q) slot[(D + q) * G::kRow + s] = acc.C[q];
    }
    __syncwarp();
    stage_rows<S, false>(MomentRows<S*, D>{b_out, C_out}, stage, c0, K, T, r0);
    __syncwarp();
  }
  return ll;
}

// Filter pass 2 with its loads and stores staged: filter_apply_staged's fold,
// in the same order, through ``stage`` (the calling warp's
// ChunkStage<S, D, 2D² + 1>::kWarp values).  A round copies kR steps of the
// warp's 32 chunks' F, Q and y rows in as whole sectors (stage_rows); each
// thread folds its kR steps, the algebra reading F and Q where it uses them
// (Strided), and writes each step's b, C over the first D + D² stage rows of
// that step, which it has consumed; the warp copies them out as whole
// sectors.  Every thread of the warp calls it, chunk or not; the rounds are
// the warp's first chunk's.
template <typename S, int D, typename Src>
__device__ __forceinline__ S filter_apply_planes(const Src& p, const S* prefix, const S* Fs, const S* Qs, const S* y,
                                                 S* b_out, S* C_out, long long T, int K, long long n_chunks,
                                                 long long c, S* stage) {
  typedef ChunkStage<S, D> G;
  constexpr int R = G::kR;
  constexpr int kQ = D * D * G::kRow;  // the Q rows; the y row at 2·kQ
  const int lane = threadIdx.x & 31;
  const long long c0 = c - lane;  // the warp's first chunk
  const long long t0 = c * K;
  const long long t1 = (c < n_chunks) ? ((t0 + K < T) ? t0 + K : T) : t0;
  const long long span = (c0 * K < T) ? ((T - c0 * K < K) ? T - c0 * K : K) : 0;  // the same for the warp
  S ll = S(0);
  Filt<S, D> acc, e;
  if (c < n_chunks) load_filt<S, D>(prefix, n_chunks, c, acc);
  S* slot = stage + lane * G::kSlot;
  const FilterPlaneRows<S, D> in{Fs, Qs, y};
#pragma unroll 1
  for (int r0 = 0; r0 < span; r0 += R) {
    // The copy-out of the round before read, in this lane, the stage values
    // this copy-in writes: no barrier between them.
    stage_rows<S, true>(in, stage, c0, K, T, r0);
    __syncwarp();
#pragma unroll 1
    for (int s = 0; s < R; ++s) {
      const long long t = t0 + r0 + s;
      if (t >= t1) break;
      const Strided<S, G::kRow> F{slot + s}, Q{slot + kQ + s};
      const S yv = slot[2 * kQ + s];
      const bool observed = !(yv != yv);  // NaN marks a missing observation
      const S yc = observed ? yv : S(0);
      build_filtering<S, D>(F, Q, yc, observed ? S(1) : S(0), p.h, p.r, p.P0, t == 0, e);
      if (observed) ll += step_loglik<S, D>(p, F, Q, yc, acc, t == 0);
      acc = filt_combine<S, D>(acc, e);
#pragma unroll
      for (int a = 0; a < D; ++a) slot[a * G::kRow + s] = acc.b[a];
#pragma unroll
      for (int q = 0; q < D * D; ++q) slot[(D + q) * G::kRow + s] = acc.C[q];
    }
    __syncwarp();
    stage_rows<S, false>(MomentRows<S*, D>{b_out, C_out}, stage, c0, K, T, r0);
  }
  return ll;
}

// Sum of one value per thread over the block of N threads (a power of two),
// in a fixed tree (no atomics); thread 0 writes it to parts[blockIdx.x].
// Every thread of the block calls it.
template <typename S, int N = kThreads>
__device__ __forceinline__ void block_sum(S value, S* parts) {
  __shared__ S red[N];
  red[threadIdx.x] = value;
  __syncthreads();
#pragma unroll
  for (int s = N / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) parts[blockIdx.x] = red[0];
}

// A pass-1 budget, the filter's or the smoother's, one fixed choice a unit:
// each warp stages the rows the map ``Rows`` names (Rows::kN of them: the
// smoother's moments b, C, D + D², or with its planes 3D² + D; the strip
// filter's F, Q and y, 2D² + 1; the dt filter's y and dt, 2) of its 32 chunks
// (ChunkStage) in one buffer, in two (the next round's copy in flight while a
// round is folded), or in none (Buffers = 0: a dt filter unit that reads its
// rows directly, filter_scan_direct); after kTableBytes a block of other
// shared memory (the spectral dt units' scalar table), in blocks of 4, 2 or
// 1 warps, whichever leaves an SM the most warps (BlockWarps).  No
// per-thread sum is kept.  G's rows are all the buffers'.
template <typename S, typename Rows, int Buffers, int TableBytes = 0>
struct ScanStage {
  static constexpr int kBuffers = Buffers;
  static constexpr int kRows = Rows::kN;  // a buffer's
  static constexpr int kTableBytes = TableBytes;
  static constexpr int kWarpBytes = ChunkStage<S, 1, Buffers * kRows, 1>::kBytes;
  static constexpr int kWarps = BlockWarps<kWarpBytes, kTableBytes>::kN;
  static_assert(kWarpBytes + kTableBytes <= kSmemLimit, "a pass-1 unit's stage does not fit one warp a block");
  typedef ChunkStage<S, 1, Buffers * kRows, kWarps> G;
  static constexpr int kThreads = G::kThreads;
  static constexpr int kBytes = kTableBytes + G::kBytes;  // dynamic shared memory a block
};

// The buffers of a filter pass-1 unit (bit D − 1 of the per-unit masks):
// none where it reads its rows directly (filter_scan_direct), else two at the
// units of the second pair of masks, one at the rest.
template <typename S, int D, unsigned kStagedF32, unsigned kStagedF64, unsigned kTwoF32, unsigned kTwoF64>
struct FilterScanBuffers {
  static constexpr int kN =
      !UnitBit<S, D, kStagedF32, kStagedF64>::kOn ? 0 : (UnitBit<S, D, kTwoF32, kTwoF64>::kOn ? 2 : 1);
};

// The copy in of a pass-1 body's rounds — the smoother's the last round
// first, the filter's (kForward) the first round first — into one buffer of
// kBufValues values or two: next(r0) returns the buffer that holds round r0
// once it has landed, and has issued the round after it in the walk in the
// other buffer.  Every lane of the warp calls it for every round; the caller
// synchronises the warp after it and again before the next call, after which
// another lane's copy may overwrite what it read.
template <typename S, typename Rows, int kBufValues, int kBuffers, bool kForward = false>
struct ScanRounds {
  static_assert(kBuffers == 1 || kBuffers == 2, "one buffer or two");
  Rows rows;
  S* stage;
  long long c0;
  int K;
  long long T;
  int k;      // rounds taken
  int r_top;  // the warp's last round, ((span − 1) / kR)·kR, or −1 where it has none

  __device__ __forceinline__ S* buffer(int i) const { return stage + (kBuffers == 2 ? (i & 1) * kBufValues : 0); }

  // Issues the walk's first round (r_top backwards, 0 forwards) where two
  // buffers overlap.
  __device__ __forceinline__ void start(int top) {
    k = 0;
    r_top = top;
    if (kBuffers == 2 && top >= 0) stage_rows<S, true, Rows, false>(rows, buffer(0), c0, K, T, kForward ? 0 : top);
  }

  __device__ __forceinline__ S* next(int r0) {
    constexpr int R = ChunkStage<S, 1>::kR;
    S* buf = buffer(k);
    if constexpr (kBuffers == 2) {
      if (kForward ? r0 + R <= r_top : r0 >= R) {
        stage_rows<S, true, Rows, false>(rows, buffer(k + 1), c0, K, T, kForward ? r0 + R : r0 - R);
        __pipeline_wait_prior(1);  // this round's group; the next one's stays in flight
      } else {
        __pipeline_wait_prior(0);
      }
    } else {
      stage_rows<S, true>(rows, buf, c0, K, T, r0);
    }
    ++k;
    return buf;
  }
};

// Filter pass 1 with its rows staged: fold chunk c to its total, in
// filter_scan_direct's order — the element of the chunk's first step t0
// assigned, every later step's combined in, acc = filt_combine(acc, e), up
// to t1 − 1 — through ``stage`` (the calling warp's kBuffers ×
// ChunkStage<S, D, Rows::kN>::kWarp values).  A round copies kR steps of the
// warp's 32 chunks' rows in as whole sectors (ScanRounds, forwards); each
// thread folds its kR steps, ``element(slot, s, t, e)`` building the element
// of step t from the lane's slot at step s of the round.  Every thread of the
// warp calls it, chunk or not (c ≥ n_chunks); the rounds are the warp's first
// chunk's, and only the series' last chunk can be shorter than K.
template <typename S, int D, int kBuffers, typename Rows, typename Element>
__device__ __forceinline__ void filter_scan_rounds(const Rows& rows, const Element& element, S* totals, long long T,
                                                   int K, long long n_chunks, long long c, S* stage) {
  typedef ChunkStage<S, D, Rows::kN> G;
  constexpr int R = G::kR;
  const int lane = threadIdx.x & 31;
  const long long c0 = c - lane;  // the warp's first chunk
  const long long t0 = c * K;
  const long long t1 = (c < n_chunks) ? ((t0 + K < T) ? t0 + K : T) : t0;
  const long long span = (c0 * K < T) ? ((T - c0 * K < K) ? T - c0 * K : K) : 0;  // the same for the warp
  Filt<S, D> acc, e;
  ScanRounds<S, Rows, G::kWarp, kBuffers, true> rounds{rows, stage, c0, K, T};
  rounds.start(span > 0 ? (int)((span - 1) / R) * R : -1);
#pragma unroll 1
  for (int r0 = 0; r0 < span; r0 += R) {
    const S* slot = rounds.next(r0) + lane * G::kSlot;
    __syncwarp();
#pragma unroll 1
    for (int s = 0; s < R; ++s) {
      const long long t = t0 + r0 + s;
      if (t >= t1) break;
      element(slot, s, t, e);
      if (t == t0) {
        acc = e;
      } else {
        acc = filt_combine<S, D>(acc, e);
      }
    }
    // A later round's copy in writes stage values that other lanes read.
    __syncwarp();
  }
  if (c < n_chunks) store_filt<S, D>(totals, n_chunks, c, acc);
}

// The filtering element of a step whose F, Q and y rows are staged
// (FilterPlaneRows): build_filtering reads F and Q where it uses them
// (Strided), as filter_apply_planes does; ``p`` gives P0, h and r.
template <typename S, int D, typename Src>
struct PlaneElement {
  typedef ChunkStage<S, D> G;
  static constexpr int kQ = D * D * G::kRow;  // the Q rows; the y row at 2·kQ
  const Src& p;
  __device__ __forceinline__ void operator()(const S* slot, int s, long long t, Filt<S, D>& e) const {
    const Strided<S, G::kRow> F{slot + s}, Q{slot + kQ + s};
    const S yv = slot[2 * kQ + s];
    const bool observed = !(yv != yv);  // NaN marks a missing observation
    build_filtering<S, D>(F, Q, observed ? yv : S(0), observed ? S(1) : S(0), p.h, p.r, p.P0, t == 0, e);
  }
};

// The filtering element of a step whose y and dt are staged (FilterDtRows):
// F and Q built from the staged dt (the source's build).
template <typename S, int D, typename Src>
struct DtElement {
  typedef ChunkStage<S, D> G;
  const Src& p;
  __device__ __forceinline__ void operator()(const S* slot, int s, long long t, Filt<S, D>& e) const {
    const S yv = slot[s];
    const bool observed = !(yv != yv);  // NaN marks a missing observation
    S F[D * D], Q[D * D];
    p.build(slot[G::kRow + s], F, Q);
    build_filtering<S, D>(F, Q, observed ? yv : S(0), observed ? S(1) : S(0), p.h, p.r, p.P0, t == 0, e);
  }
};

// Filter pass 1 of the strip units: their F, Q and y rows staged.
template <typename S, int D, int kBuffers, typename Src>
__device__ __forceinline__ void filter_scan_planes(const Src& p, const S* Fs, const S* Qs, const S* y, S* totals,
                                                   long long T, int K, long long n_chunks, long long c, S* stage) {
  filter_scan_rounds<S, D, kBuffers>(FilterPlaneRows<S, D>{Fs, Qs, y}, PlaneElement<S, D, Src>{p}, totals, T, K,
                                     n_chunks, c, stage);
}

// Filter pass 1 of the dt units that stage: their y and dt rows staged.
template <typename S, int D, int kBuffers, typename Src>
__device__ __forceinline__ void filter_scan_staged(const Src& p, const S* dt, const S* y, S* totals, long long T,
                                                   int K, long long n_chunks, long long c, S* stage) {
  filter_scan_rounds<S, D, kBuffers>(FilterDtRows<S>{y, dt}, DtElement<S, D, Src>{p}, totals, T, K, n_chunks, c,
                                     stage);
}

// Smoother pass 1: reverse fold of chunk c to its suffix total, its loads
// staged through ``stage`` (the calling warp's kBuffers × ChunkStage<S,
// D>::kWarp values of shared memory): smoother_apply_staged's rounds without
// the seed and without the copy out.  A round copies kR steps of the warp's
// 32 chunks' b, C rows in as whole sectors (ScanRounds: with two buffers the
// next round's copy is in flight while this one is folded); each thread
// folds its kR steps backwards, F and Q of step t + 1 from the source.  The
// fold has no seed: it starts from the element of the chunk's last step,
// t1 − 1, and combines every earlier step's in, acc = smooth_combine(acc,
// e), down to t0.  Every thread of the warp calls it, chunk or not
// (c ≥ n_chunks); the rounds are the warp's first chunk's, and only the
// series' last chunk can be shorter than K.
template <typename S, int D, int kBuffers, typename Src>
__device__ __forceinline__ void smoother_scan_staged(const Src& p, const S* b, const S* C, S* totals, long long T,
                                                     int K, long long n_chunks, long long c, S* stage) {
  typedef ChunkStage<S, D> G;
  constexpr int R = G::kR;
  const int lane = threadIdx.x & 31;
  const long long c0 = c - lane;  // the warp's first chunk
  const long long t0 = c * K;
  const long long t1 = (c < n_chunks) ? ((t0 + K < T) ? t0 + K : T) : t0;
  const long long span = (c0 * K < T) ? ((T - c0 * K < K) ? T - c0 * K : K) : 0;  // the same for the warp
  const int r_first = span > 0 ? (int)((span - 1) / R) * R : -1;
  Smooth<S, D> acc, e;
  ScanRounds<S, MomentRows<const S*, D>, G::kWarp, kBuffers> rounds{{b, C}, stage, c0, K, T};
  rounds.start(r_first);
#pragma unroll 1
  for (int r0 = r_first; r0 >= 0; r0 -= R) {
    S* slot = rounds.next(r0) + lane * G::kSlot;
    __syncwarp();
#pragma unroll 1
    for (int s = R - 1; s >= 0; --s) {
      const long long t = t0 + r0 + s;
      if (t >= t1) continue;
      S m[D], P[D * D];
#pragma unroll
      for (int a = 0; a < D; ++a) m[a] = slot[a * G::kRow + s];
#pragma unroll
      for (int q = 0; q < D * D; ++q) P[q] = slot[(D + q) * G::kRow + s];
      smoothing_element<S, D>(p, m, P, t, T, e);
      if (t == t1 - 1) {
        acc = e;
      } else {
        acc = smooth_combine<S, D>(acc, e);
      }
    }
    // A later round's copy in writes stage values that other lanes read.
    __syncwarp();
  }
  if (c < n_chunks) store_smooth<S, D>(totals, n_chunks, c, acc);
}

// Smoother pass 1 with its planes staged too: smoother_scan_staged's fold, in
// the same order, through ``stage`` (the calling warp's kBuffers ×
// ChunkStage<S, D, 3D² + D>::kWarp values): each round copies in the b, C
// rows and the F, Q rows of the round's kR steps.  The step after the round
// is kept in the pad of the lane's F, Q slots of the round's buffer, as
// smoother_apply_planes keeps it: the next chunk's first step, read once,
// directly, then the first step of the round just folded (with two buffers,
// copied into the other buffer's pad, which no copy in writes).  The chunk
// length K is a multiple of kR.
template <typename S, int D, int kBuffers>
__device__ __forceinline__ void smoother_scan_planes(const S* b, const S* C, const S* Fs, const S* Qs, S* totals,
                                                     long long T, int K, long long n_chunks, long long c, S* stage) {
  typedef ChunkStage<S, D, 3 * D * D + D> G;
  constexpr int R = G::kR;
  constexpr int kF = (D + D * D) * G::kRow;  // the F rows
  constexpr int kQ = kF + D * D * G::kRow;   // the Q rows
  const int lane = threadIdx.x & 31;
  const long long c0 = c - lane;  // the warp's first chunk
  const long long t0 = c * K;
  const long long t1 = (c < n_chunks) ? ((t0 + K < T) ? t0 + K : T) : t0;
  const long long span = (c0 * K < T) ? ((T - c0 * K < K) ? T - c0 * K : K) : 0;  // the same for the warp
  const int r_first = span > 0 ? (int)((span - 1) / R) * R : -1;
  Smooth<S, D> acc, e;
  ScanRounds<S, SmootherPlaneRows<S, D>, G::kWarp, kBuffers> rounds{{b, C, Fs, Qs}, stage, c0, K, T};
  if (t1 < T) {  // a chunk with a step after it
    S* slot = rounds.buffer(0) + lane * G::kSlot;
#pragma unroll
    for (int q = 0; q < D * D; ++q) {
      slot[kF + q * G::kRow + R] = Fs[q * T + t1];
      slot[kQ + q * G::kRow + R] = Qs[q * T + t1];
    }
  }
  rounds.start(r_first);
#pragma unroll 1
  for (int r0 = r_first; r0 >= 0; r0 -= R) {
    S* slot = rounds.next(r0) + lane * G::kSlot;
    __syncwarp();
#pragma unroll 1
    for (int s = R - 1; s >= 0; --s) {
      const long long t = t0 + r0 + s;
      if (t >= t1) continue;
      S m[D], P[D * D];
#pragma unroll
      for (int a = 0; a < D; ++a) m[a] = slot[a * G::kRow + s];
#pragma unroll
      for (int q = 0; q < D * D; ++q) P[q] = slot[(D + q) * G::kRow + s];
      if (t == T - 1) {
        build_smoothing_last<S, D>(m, P, e);
      } else {
        const Strided<S, G::kRow> Fn{slot + kF + s + 1}, Qn{slot + kQ + s + 1};
        build_smoothing<S, D>(Fn, Qn, m, P, e);
      }
      if (t == t1 - 1) {
        acc = e;
      } else {
        acc = smooth_combine<S, D>(acc, e);
      }
    }
    // The round's first step is the step after the next round's last.
    S* next = rounds.buffer(rounds.k) + lane * G::kSlot;
#pragma unroll
    for (int q = 0; q < D * D; ++q) {
      next[kF + q * G::kRow + R] = slot[kF + q * G::kRow];
      next[kQ + q * G::kRow + R] = slot[kQ + q * G::kRow];
    }
    // A later round's copy in writes stage values that other lanes read.
    __syncwarp();
  }
  if (c < n_chunks) store_smooth<S, D>(totals, n_chunks, c, acc);
}

// Smoother pass 2: reverse re-fold of chunk c seeded with its exclusive
// suffix, step by step from its end; writes the smoothed moments.  Its loads
// and stores go through ``stage`` (the calling warp's
// ChunkStage<S, D>::kWarp values of shared memory).  A round is kR steps of
// each of the warp's 32 chunks, from the chunks' ends towards their starts:
// the warp copies their b, C rows in as whole sectors, each thread folds its
// kR steps backwards and overwrites each step's (m, P) in its slot with the
// smoothed (g, L), and the warp copies the rows out as whole sectors.  Every
// thread of the warp calls it, chunk or not (c ≥ n_chunks); the rounds are
// the warp's first chunk's, and only the series' last chunk can be shorter
// than K (its steps past T are masked).
template <typename S, int D, typename Src>
__device__ __forceinline__ void smoother_apply_staged(const Src& p, const S* prefix, const S* b, const S* C, S* g_out,
                                                      S* L_out, long long T, int K, long long n_chunks, long long c,
                                                      S* stage) {
  typedef ChunkStage<S, D> G;
  constexpr int R = G::kR;
  const int lane = threadIdx.x & 31;
  const long long c0 = c - lane;  // the warp's first chunk
  const long long t0 = c * K;
  const long long t1 = (c < n_chunks) ? ((t0 + K < T) ? t0 + K : T) : t0;
  const long long span = (c0 * K < T) ? ((T - c0 * K < K) ? T - c0 * K : K) : 0;  // the same for the warp
  Smooth<S, D> acc, e;
  if (c < n_chunks) load_smooth<S, D>(prefix, n_chunks, c, acc);
  S* slot = stage + lane * G::kSlot;
#pragma unroll 1
  for (int r0 = span > 0 ? (int)((span - 1) / R) * R : -1; r0 >= 0; r0 -= R) {
    // The copy-out of the round before touched, in this lane, the stage
    // values this copy-in writes: no barrier between them.
    stage_rows<S, true>(MomentRows<const S*, D>{b, C}, stage, c0, K, T, r0);
    __syncwarp();
#pragma unroll 1
    for (int s = R - 1; s >= 0; --s) {
      const long long t = t0 + r0 + s;
      if (t >= t1) continue;
      S m[D], P[D * D];
#pragma unroll
      for (int a = 0; a < D; ++a) m[a] = slot[a * G::kRow + s];
#pragma unroll
      for (int q = 0; q < D * D; ++q) P[q] = slot[(D + q) * G::kRow + s];
      smoothing_element<S, D>(p, m, P, t, T, e);
      acc = smooth_combine<S, D>(acc, e);
#pragma unroll
      for (int a = 0; a < D; ++a) slot[a * G::kRow + s] = acc.g[a];
#pragma unroll
      for (int q = 0; q < D * D; ++q) slot[(D + q) * G::kRow + s] = acc.L[q];
    }
    __syncwarp();
    stage_rows<S, false>(MomentRows<S*, D>{g_out, L_out}, stage, c0, K, T, r0);
  }
}

// Smoother pass 2 with its planes staged too: smoother_apply_staged's
// reverse fold, in the same order, through ``stage`` (the calling warp's
// ChunkStage<S, D, 3D² + D>::kWarp values): each round copies in the b, C
// rows and the F, Q rows of the round's kR steps.  A step reads F, Q of the
// step after it (smoothing_element): for the round's last step that is the
// step after the round, which each lane keeps in the pad of its F, Q slots —
// for the chunk's last round the next chunk's first step (another lane's
// chunk: read once, directly), then, as the rounds walk back, the first step
// of the round just folded.  The chunk length K is a multiple of kR.
template <typename S, int D>
__device__ __forceinline__ void smoother_apply_planes(const S* prefix, const S* b, const S* C, const S* Fs,
                                                      const S* Qs, S* g_out, S* L_out, long long T, int K,
                                                      long long n_chunks, long long c, S* stage) {
  typedef ChunkStage<S, D> G;
  constexpr int R = G::kR;
  constexpr int kF = (D + D * D) * G::kRow;  // the F rows
  constexpr int kQ = kF + D * D * G::kRow;   // the Q rows
  const int lane = threadIdx.x & 31;
  const long long c0 = c - lane;  // the warp's first chunk
  const long long t0 = c * K;
  const long long t1 = (c < n_chunks) ? ((t0 + K < T) ? t0 + K : T) : t0;
  const long long span = (c0 * K < T) ? ((T - c0 * K < K) ? T - c0 * K : K) : 0;  // the same for the warp
  Smooth<S, D> acc, e;
  if (c < n_chunks) load_smooth<S, D>(prefix, n_chunks, c, acc);
  S* slot = stage + lane * G::kSlot;
  if (t1 < T) {  // a chunk with a step after it
#pragma unroll
    for (int q = 0; q < D * D; ++q) {
      slot[kF + q * G::kRow + R] = Fs[q * T + t1];
      slot[kQ + q * G::kRow + R] = Qs[q * T + t1];
    }
  }
  const SmootherPlaneRows<S, D> in{b, C, Fs, Qs};
#pragma unroll 1
  for (int r0 = span > 0 ? (int)((span - 1) / R) * R : -1; r0 >= 0; r0 -= R) {
    // The copy-out of the round before touched, in this lane, the stage
    // values this copy-in writes: no barrier between them.
    stage_rows<S, true>(in, stage, c0, K, T, r0);
    __syncwarp();
#pragma unroll 1
    for (int s = R - 1; s >= 0; --s) {
      const long long t = t0 + r0 + s;
      if (t >= t1) continue;
      S m[D], P[D * D];
#pragma unroll
      for (int a = 0; a < D; ++a) m[a] = slot[a * G::kRow + s];
#pragma unroll
      for (int q = 0; q < D * D; ++q) P[q] = slot[(D + q) * G::kRow + s];
      if (t == T - 1) {
        build_smoothing_last<S, D>(m, P, e);
      } else {
        const Strided<S, G::kRow> Fn{slot + kF + s + 1}, Qn{slot + kQ + s + 1};
        build_smoothing<S, D>(Fn, Qn, m, P, e);
      }
      acc = smooth_combine<S, D>(acc, e);
#pragma unroll
      for (int a = 0; a < D; ++a) slot[a * G::kRow + s] = acc.g[a];
#pragma unroll
      for (int q = 0; q < D * D; ++q) slot[(D + q) * G::kRow + s] = acc.L[q];
    }
    // The round's first step is the step after the next round's last.
#pragma unroll
    for (int q = 0; q < D * D; ++q) {
      slot[kF + q * G::kRow + R] = slot[kF + q * G::kRow];
      slot[kQ + q * G::kRow + R] = slot[kQ + q * G::kRow];
    }
    __syncwarp();
    stage_rows<S, false>(MomentRows<S*, D>{g_out, L_out}, stage, c0, K, T, r0);
  }
}

}  // namespace pgt
