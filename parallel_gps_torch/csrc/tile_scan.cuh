// What the single-pass scans share (plane_scan.cu, batched_scan.cu): an
// element read and written as a flat array of component rows, the in-block
// Kogge–Stone scan of a tile's thread totals, and the protocol by which one
// block hands its tile's total to another that runs at the same time —
// values, fence, flag; a reader polls the flag with a bound on its spin and
// reads the values from L2, past its SM's L1, which is not coherent across
// SMs.  A block takes its tile from an atomic ticket (each kernel's own
// ticket-to-tile map), so a tile it waits on belongs to a block that already
// runs: no order of scheduling can deadlock.
#pragma once

#include <cuda_runtime.h>

#include "dt_elements.cuh"

namespace pgt {

constexpr int kFlagAgg = 1;   // agg[tile] holds the tile's aggregate
constexpr int kFlagIncl = 2;  // incl[tile] holds the inclusive total up to the tile
constexpr int kSpinOverrun = 1;

// The element a scan runs on, by kind.  An element is kRows values of S in
// packed row order (Filt: A, b, C, J, η; Smooth: E, g, L), so it is read and
// written as a flat array.
// kWarpLookBack: which look-back the kind's units run (look_back_warp, else
// look_back_thread) in plane_scan.cu, as measured on the card (its notes).
// The filter's combine averages the two triangles of C and J (SymForm): in
// the chained association, with the upper triangle mirrored, the float32
// chunk prefix of the quasi-periodic model (d = 8, N = 1M) lost every digit
// (chip_smoke.qp_prefix_precision; plane.chained_plain_scan models it on
// the CPU).  The pairwise layout at double D = 6, where ptxas gave the
// full-product layout 64 registers and 55 KB of spills (4× the time); the
// full-product layout elsewhere, 14% faster at float D = 8 (PERF.md §6).
template <typename S, int D>
struct FilterOps {
  typedef Filt<S, D> Elem;
  static constexpr int kRows = ElementRows<D>::kFilt;
  static constexpr bool kWarpLookBack = D <= 4 || D >= 7;
  static constexpr SymForm kForm = (sizeof(S) == 8 && D == 6) ? kAveragedPairs : kAveraged;
  __device__ static __forceinline__ Elem combine(const Elem& a, const Elem& b) {
    return filt_combine<S, D, kForm>(a, b);
  }
};

template <typename S, int D>
struct SmootherOps {
  typedef Smooth<S, D> Elem;
  static constexpr int kRows = ElementRows<D>::kSmooth;
  static constexpr bool kWarpLookBack = D <= 6;
  __device__ static __forceinline__ Elem combine(const Elem& a, const Elem& b) { return smooth_combine<S, D>(a, b); }
};

// Element i of component rows X (row k at X[k·stride]).
template <typename S, typename E>
__device__ __forceinline__ void load_rows(const S* X, long long stride, long long i, E& e) {
  constexpr int n = sizeof(E) / sizeof(S);
  S* v = reinterpret_cast<S*>(&e);
#pragma unroll
  for (int k = 0; k < n; ++k) v[k] = X[k * stride + i];
}

template <typename S, typename E>
__device__ __forceinline__ void store_rows(S* X, long long stride, long long i, const E& e) {
  constexpr int n = sizeof(E) / sizeof(S);
  const S* v = reinterpret_cast<const S*>(&e);
#pragma unroll
  for (int k = 0; k < n; ++k) X[k * stride + i] = v[k];
}

// An element another block published: read from L2, past this SM's L1.
template <typename S, typename E>
__device__ __forceinline__ void load_published(const S* X, E& e) {
  constexpr int n = sizeof(E) / sizeof(S);
  S* v = reinterpret_cast<S*>(&e);
#pragma unroll
  for (int k = 0; k < n; ++k) v[k] = __ldcg(X + k);
}

// Values, fence, flag: a reader that sees the flag sees the values.
template <typename S, typename E>
__device__ __forceinline__ void publish(S* X, int* flag, int state, const E& e) {
  store_rows<S, E>(X, 1, 0, e);
  __threadfence();
  atomicExch(flag, state);
}

// The port of _local_scan_kernel: inclusive Kogge–Stone scan of the tile's
// n_valid elements, thread i's in ``mine`` (forwards: from thread 0 up;
// reverse: from thread n_valid−1 down).  On return ``mine`` and sm[k·NT + i]
// hold thread i's inclusive element.  Every thread of the block calls it.
template <typename S, int NT, typename Ops>
__device__ __forceinline__ void block_scan(typename Ops::Elem& mine, S* sm, int n_valid, bool reverse) {
  typedef typename Ops::Elem E;
  const int tid = threadIdx.x;
  const bool valid = tid < n_valid;
  if (valid) store_rows<S, E>(sm, NT, tid, mine);
  __syncthreads();
#pragma unroll 1
  for (int s = 1; s < n_valid; s <<= 1) {
    const int partner = reverse ? tid + s : tid - s;  // the scan-earlier element
    const bool takes = valid && partner >= 0 && partner < n_valid;
    E e;
    if (takes) load_rows<S, E>(sm, NT, partner, e);
    __syncthreads();
    if (takes) {
      mine = Ops::combine(e, mine);
      store_rows<S, E>(sm, NT, tid, mine);
    }
    __syncthreads();
  }
}

// The flag of a predecessor once it is set, or 0 after max_polls polls (the
// overrun is recorded in status[1]).
__device__ __forceinline__ int wait_flag(const int* flag, int* status, long long max_polls) {
  const volatile int* f = flag;
  unsigned int ns = 32;
#pragma unroll 1
  for (long long poll = 0; poll < max_polls; ++poll) {
    const int state = *f;
    if (state != 0) {
      __threadfence();
      return state;
    }
    __nanosleep(ns);
    if (ns < 256) ns <<= 1;
  }
  atomicExch(status + 1, kSpinOverrun);
  return 0;
}

}  // namespace pgt
