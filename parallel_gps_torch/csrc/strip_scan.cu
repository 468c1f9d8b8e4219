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
// reported by ptxas (-Xptxas -v).  The four kernels stage their rows through
// shared memory a warp at a time (scan_passes.cuh: ChunkStage), each unit by
// its own budget (ApplyStage, StripFilterScan and StripScan below), the
// filter's pass 1 at the units where that measured faster.
//
// One translation unit per state dimension: compile with -DPGT_D=<1..8>, so
// that the eight fully unrolled instantiations build side by side
// (kalman/_cuda.py).  The entry points carry the dimension in their names
// (pgt_strip_filter_scan_d6, ...).
#include <cuda_runtime.h>

#include <type_traits>

#include "scan_passes.cuh"

#ifndef PGT_D
#error "compile with -DPGT_D=<state dimension, 1..8>"
#endif
#if PGT_D < 1 || PGT_D > 8
#error "PGT_D must be in 1..8"
#endif

namespace pgt {

// Sources of a step's F and Q for the shared pass bodies that read them
// directly: loads from the (D, D, T) planes (the bodies that stage F and Q
// read only the filter's P0, h and r).
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
// The pass-2 kernels' shared-memory budget, one fixed choice a unit (state
// dimension, scalar type), mirrored by kalman/strip.py (apply_stage) and
// checked against it when the library loads (kalman/_cuda.py).
//
// Each warp stages kR steps of its 32 chunks (ChunkStage).  The filter
// stages its F, Q and y rows, and writes b and C over the consumed F, Q
// (2D² + 1 rows).  The smoother stages either its b, C, F and Q rows, g and
// L written over b and C (3D² + D rows), or its moments alone, b and C in and
// g and L out in the same places (D + D² rows), F and Q loaded strided.  A
// block is 4, 2 or 1 warps, whichever leaves an SM the most warps by shared
// memory (the larger block on a tie), within the 232,448 bytes a block may
// opt in to.  The smoother's whole stage costs warps an SM (at D = 6 float:
// 1 in place of 4), so where it is taken is a measured choice (PERF.md §6),
// not the largest stage that fits; it does not fit at D = 8 double (256,000
// bytes a warp).
// ---------------------------------------------------------------------------
// (dt_launch.cuh: kSmemLimit, BlockWarps.)

// Smoother units that stage their planes: bit D − 1, where that stage
// measured faster than the moments alone on an H100 (PERF.md §6, row 9): D ≤ 6
// in float, D = 1, 3..6 in double (at D = 2 double and D = 7, 8 the
// moments-only stage was faster, and at D = 8 double the planes do not fit).
constexpr unsigned kSmootherPlanesF32 = 0x3Fu;
constexpr unsigned kSmootherPlanesF64 = 0x3Du;

template <typename S, int D, bool kSmoother>
struct ApplyStage {
  static constexpr unsigned kMask = sizeof(S) == 8 ? kSmootherPlanesF64 : kSmootherPlanesF32;
  static constexpr bool kPlanes = !kSmoother || ((kMask >> (D - 1)) & 1u);
  static constexpr int kRows = !kPlanes ? D + D * D : (kSmoother ? 3 * D * D + D : 2 * D * D + 1);
  // Bytes a warp: its region, and the filter's block_sum values.
  static constexpr int kWarpBytes =
      ChunkStage<S, D, kRows, 1>::kBytes + (kSmoother ? 0 : 32 * (int)sizeof(S));
  static constexpr int kWarps = BlockWarps<kWarpBytes>::kN;
  static_assert(kWarpBytes <= kSmemLimit, "a pass-2 unit's stage does not fit one warp a block");
  typedef ChunkStage<S, D, kRows, kWarps> G;
  static constexpr int kThreads = G::kThreads;
  static constexpr int kBytes = G::kBytes;  // dynamic shared memory a block
};

extern __shared__ __align__(16) unsigned char pgt_strip_smem[];

// The calling warp's region of a staged kernel's dynamic shared memory, by
// its budget A (ApplyStage, ScanStage).
template <typename A, typename S>
__device__ __forceinline__ S* apply_stage_warp() {
  return reinterpret_cast<S*>(pgt_strip_smem) + (threadIdx.x / 32) * A::G::kWarp;
}

// ---------------------------------------------------------------------------
// Filter pass 1.  Replaces parallel_gps_tpu/kalman/pallas_scan.py
// _strip_filter_scan_kernel (:766, pallas_call :999): per-chunk totals of the
// filtering elements built from the streamed F, Q planes and y.
// Bound: bytes — (2D²+1) values a step in, one total a chunk out.  Loaded
// strided by K, a thread walking its own chunk, they took 5.7 device ms at
// D = 3, T = 10M float on an NVIDIA H100 80GB HBM3 at 700 W, 24× the bound
// (PERF.md §6, row 6); so each warp of the units of kFilterScanStagedF32 /
// kFilterScanStagedF64 stages them: kR steps of its 32 chunks' F, Q and y
// rows copied in as whole sectors, build_filtering reading F and Q from the
// stage (filter_scan_planes), in two buffers at the units of
// kFilterScanTwoF32 / kFilterScanTwoF64, else in one; blocks by ScanStage
// (StripFilterScan), mirrored by kalman/strip.py (scan_stage,
// FILTER_SCAN_STAGED, FILTER_SCAN_TWO_BUFFERS).  Measured on that card: the
// stage won at D ≤ 7 in float (7.2× at D = 3, 10M) and D = 2..6 in double;
// at float D = 8 and double D = 7, 8 a warp's stage (126–165 KB) leaves one
// warp an SM, and it lost to the parent's strided reads at eight warps an SM
// (6.44 against 5.49 device ms at float D = 8, 1M), as at double D = 1
// (0.039 against 0.031); those units read directly (filter_scan_direct).
// Two buffers won by more than 1% at D ≤ 3 in float and D = 2, 3 in double.
// ---------------------------------------------------------------------------
constexpr unsigned kFilterScanStagedF32 = 0x7Fu;
constexpr unsigned kFilterScanStagedF64 = 0x3Eu;
constexpr unsigned kFilterScanTwoF32 = 0x7u;
constexpr unsigned kFilterScanTwoF64 = 0x6u;

template <typename S, int D>
using StripFilterScan =
    ScanStage<S, FilterPlaneRows<S, D>,
              FilterScanBuffers<S, D, kFilterScanStagedF32, kFilterScanStagedF64, kFilterScanTwoF32, kFilterScanTwoF64>::kN>;

template <typename S, int D>
__global__ void __launch_bounds__((StripFilterScan<S, D>::kThreads))
    strip_filter_scan_kernel(const S* __restrict__ scal, const S* __restrict__ Fs, const S* __restrict__ Qs,
                             const S* __restrict__ y, S* __restrict__ totals, long long T, int K,
                             long long n_chunks) {
  typedef StripFilterScan<S, D> A;
  const long long c = (long long)blockIdx.x * A::kThreads + threadIdx.x;
  PlaneFilterSource<S, D> p;
  p.load(scal);
  if constexpr (A::kBuffers == 0) {
    p.Fs = Fs;
    p.Qs = Qs;
    p.T = T;
    if (c < n_chunks) filter_scan_direct<S, D>(p, y, totals, T, K, n_chunks, c);
  } else {
    filter_scan_planes<S, D, A::kBuffers>(p, Fs, Qs, y, totals, T, K, n_chunks, c, apply_stage_warp<A, S>());
  }
}

// ---------------------------------------------------------------------------
// Filter pass 2.  Replaces pallas_scan.py _strip_filter_apply_kernel (:798,
// pallas_call :1036): re-fold seeded with the prefix, the filtered b and C,
// and the streamed log p(y_t | y_<t) from the previous moments
// (pallas_scan.py:851-896), summed per block in a fixed order (no atomics).
// Bound: bytes — (3D²+D+1) values a step.  A thread walking its own chunk
// loads and stores them strided by K, 32 partial sectors an instruction; so
// each warp stages them (ApplyStage): its F, Q and y rows copied in and its
// b, C rows copied out as whole sectors (filter_apply_planes).
// ---------------------------------------------------------------------------
template <typename S, int D>
__global__ void __launch_bounds__((ApplyStage<S, D, false>::kThreads))
    strip_filter_apply_kernel(const S* __restrict__ scal, const S* __restrict__ prefix, const S* __restrict__ Fs,
                              const S* __restrict__ Qs, const S* __restrict__ y, S* __restrict__ b_out,
                              S* __restrict__ C_out, S* __restrict__ ell_parts, long long T, int K,
                              long long n_chunks) {
  typedef ApplyStage<S, D, false> A;
  const long long c = (long long)blockIdx.x * A::kThreads + threadIdx.x;
  PlaneFilterSource<S, D> p;  // its P0, h and r; F and Q come from the stage
  p.load(scal);
  const S ll =
      filter_apply_planes<S, D>(p, prefix, Fs, Qs, y, b_out, C_out, T, K, n_chunks, c, apply_stage_warp<A, S>());
  block_sum<S, A::kThreads>(ll, ell_parts);
}

// ---------------------------------------------------------------------------
// Smoother pass 1.  Replaces pallas_scan.py _strip_smoother_scan_kernel
// (:1795, pallas_call :1938): reverse fold of each chunk's smoothing elements
// (F, Q at t+1 and the filtered b, C at t) to its suffix total.
// Bound: bytes — (3D²+D) values a step.  Loaded strided by K, a thread
// walking its own chunk, they took 8.4 ms at D = 3, T = 10M float on an
// NVIDIA H100 80GB HBM3 at 700 W, 23× the bound; so each warp stages them
// (StripScan): b, C, F and Q copied in as whole sectors
// (smoother_scan_planes), or b and C alone, F and Q loaded strided
// (smoother_scan_staged).
//
// The budget, one fixed choice a unit, mirrored by kalman/strip.py
// (scan_stage) and checked against it when the library loads: the units of
// bit D − 1 of kScanPlanesF32 / kScanPlanesF64 stage their planes, the rest
// their moments alone, in two buffers at the units of kScanTwoF32 /
// kScanTwoF64, else in one (ScanStage: 4, 2 or 1 warps a block by
// BlockWarps).  The planes measured faster on an H100 at D ≤ 7 in float and
// D ≤ 6 in double (PERF.md §6, row 8); at D = 8 float and D = 7 double the
// moments alone (at D = 7 double the planes' unit gets 64 registers and
// 20 KB of spills, 3.5× slower), and at D = 8 double the planes do not fit.
// Two buffers measured more than 1% faster at D = 1, 2 in float and D = 1, 2,
// 4, 7 in double; elsewhere one (two halve the warps an SM, and lost by up
// to 1.7×, or do not fit).
// ---------------------------------------------------------------------------
constexpr unsigned kScanPlanesF32 = 0x7Fu;
constexpr unsigned kScanPlanesF64 = 0x3Fu;
constexpr unsigned kScanTwoF32 = 0x3u;
constexpr unsigned kScanTwoF64 = 0x4Bu;

template <typename S, int D>
using StripScanPlanes = UnitBit<S, D, kScanPlanesF32, kScanPlanesF64>;

template <typename S, int D>
using StripScan = ScanStage<S, std::conditional_t<StripScanPlanes<S, D>::kOn, SmootherPlaneRows<S, D>, MomentRows<const S*, D>>,
                            UnitBit<S, D, kScanTwoF32, kScanTwoF64>::kOn ? 2 : 1>;

template <typename S, int D>
__global__ void __launch_bounds__((StripScan<S, D>::kThreads))
    strip_smoother_scan_kernel(const S* __restrict__ Fs, const S* __restrict__ Qs, const S* __restrict__ b,
                               const S* __restrict__ C, S* __restrict__ totals, long long T, int K,
                               long long n_chunks) {
  typedef StripScan<S, D> A;
  const long long c = (long long)blockIdx.x * A::kThreads + threadIdx.x;
  S* stage = apply_stage_warp<A, S>();
  if constexpr (StripScanPlanes<S, D>::kOn) {
    smoother_scan_planes<S, D, A::kBuffers>(b, C, Fs, Qs, totals, T, K, n_chunks, c, stage);
  } else {
    PlaneSmootherSource<S, D> p{Fs, Qs, T};
    smoother_scan_staged<S, D, A::kBuffers>(p, b, C, totals, T, K, n_chunks, c, stage);
  }
}

// ---------------------------------------------------------------------------
// Smoother pass 2.  Replaces pallas_scan.py _strip_smoother_apply_kernel
// (:1840, pallas_call :1977): reverse re-fold seeded with the chunk's
// exclusive suffix; writes the smoothed g and L.
// Bound: bytes — (4D²+2D) values a step, strided by K when a thread walks its
// own chunk; so each warp stages them (ApplyStage): b, C, F and Q copied in
// and g, L copied out as whole sectors (smoother_apply_planes), or b, C in
// and g, L out alone, F and Q loaded strided (smoother_apply_staged).
// ---------------------------------------------------------------------------
template <typename S, int D>
__global__ void __launch_bounds__((ApplyStage<S, D, true>::kThreads))
    strip_smoother_apply_kernel(const S* __restrict__ prefix, const S* __restrict__ Fs, const S* __restrict__ Qs,
                                const S* __restrict__ b, const S* __restrict__ C, S* __restrict__ g_out,
                                S* __restrict__ L_out, long long T, int K, long long n_chunks) {
  typedef ApplyStage<S, D, true> A;
  const long long c = (long long)blockIdx.x * A::kThreads + threadIdx.x;
  S* stage = apply_stage_warp<A, S>();
  if constexpr (A::kPlanes) {
    smoother_apply_planes<S, D>(prefix, b, C, Fs, Qs, g_out, L_out, T, K, n_chunks, c, stage);
  } else {
    PlaneSmootherSource<S, D> p{Fs, Qs, T};
    smoother_apply_staged<S, D>(p, prefix, b, C, g_out, L_out, T, K, n_chunks, c, stage);
  }
}

}  // namespace pgt

// C interface, bound with ctypes (kalman/_cuda.py), one set of entry points
// per state dimension.  Each entry launches one kernel on the given stream,
// does not synchronise, and returns cudaGetLastError() (0 on success) or
// kBadArgs.
#define PGT_CAT2(a, b) a##b
#define PGT_CAT(a, b) PGT_CAT2(a, b)
#define PGT_ENTRY(name) PGT_CAT(PGT_CAT(name, _d), PGT_D)

extern "C" {

int PGT_ENTRY(pgt_strip_filter_scan)(int is64, const void* scal, const void* Fs, const void* Qs, const void* y,
                                     void* totals, long long T, int K, void* stream) {
  if (T < 1 || K < 1) return pgt::kBadArgs;
  const long long n_chunks = (T + K - 1) / K;
  int rc = 0;
#define PGT_LAUNCH(S)                                                                                         \
  {                                                                                                           \
    typedef pgt::StripFilterScan<S, PGT_D> A;                                                                 \
    rc = pgt::launch_opted_in(pgt::strip_filter_scan_kernel<S, PGT_D>, pgt::n_blocks(n_chunks, A::kThreads),  \
                              A::kThreads, A::kBytes, (cudaStream_t)stream, (const S*)scal, (const S*)Fs,     \
                              (const S*)Qs, (const S*)y, (S*)totals, T, K, n_chunks);                         \
  }
  PGT_DISPATCH_TYPE(is64, PGT_LAUNCH);
#undef PGT_LAUNCH
  return rc;
}

// The pass-2 kernels' budget (ApplyStage) of this unit, for the filter
// (smoother = 0) or the smoother: threads a block, rows a warp stages, and
// dynamic shared memory a block in bytes.
#define PGT_APPLY_STAGE(FIELD)                                                                    \
  (is64 ? (smoother ? pgt::ApplyStage<double, PGT_D, true>::FIELD : pgt::ApplyStage<double, PGT_D, false>::FIELD) \
        : (smoother ? pgt::ApplyStage<float, PGT_D, true>::FIELD : pgt::ApplyStage<float, PGT_D, false>::FIELD))

int PGT_ENTRY(pgt_strip_apply_threads)(int is64, int smoother) { return PGT_APPLY_STAGE(kThreads); }
int PGT_ENTRY(pgt_strip_apply_rows)(int is64, int smoother) { return PGT_APPLY_STAGE(kRows); }
int PGT_ENTRY(pgt_strip_apply_smem)(int is64, int smoother) { return PGT_APPLY_STAGE(kBytes); }
#undef PGT_APPLY_STAGE

// Blocks of the pass-2 kernel an SM holds at once (the CUDA occupancy
// calculator: registers, shared memory, threads), or minus the error code.
int PGT_ENTRY(pgt_strip_apply_blocks_per_sm)(int is64, int smoother) {
  using pgt::ApplyStage;
  using pgt::blocks_per_sm;
  if (is64) {
    return smoother ? blocks_per_sm<ApplyStage<double, PGT_D, true>>(pgt::strip_smoother_apply_kernel<double, PGT_D>)
                    : blocks_per_sm<ApplyStage<double, PGT_D, false>>(pgt::strip_filter_apply_kernel<double, PGT_D>);
  }
  return smoother ? blocks_per_sm<ApplyStage<float, PGT_D, true>>(pgt::strip_smoother_apply_kernel<float, PGT_D>)
                  : blocks_per_sm<ApplyStage<float, PGT_D, false>>(pgt::strip_filter_apply_kernel<float, PGT_D>);
}

// The pass-1 budget of this unit, the filter's (StripFilterScan, smoother =
// 0) or the smoother's (StripScan): threads a block, rows a warp stages in a
// buffer, dynamic shared memory a block in bytes, buffers, and the blocks an
// SM holds at once (as above).
#define PGT_SCAN_BUDGET(S, FIELD) (smoother ? pgt::StripScan<S, PGT_D>::FIELD : pgt::StripFilterScan<S, PGT_D>::FIELD)
#define PGT_SCAN_STAGE(FIELD) (is64 ? PGT_SCAN_BUDGET(double, FIELD) : PGT_SCAN_BUDGET(float, FIELD))
int PGT_ENTRY(pgt_strip_scan_threads)(int is64, int smoother) { return PGT_SCAN_STAGE(kThreads); }
int PGT_ENTRY(pgt_strip_scan_rows)(int is64, int smoother) { return PGT_SCAN_STAGE(kRows); }
int PGT_ENTRY(pgt_strip_scan_smem)(int is64, int smoother) { return PGT_SCAN_STAGE(kBytes); }
int PGT_ENTRY(pgt_strip_scan_buffers)(int is64, int smoother) { return PGT_SCAN_STAGE(kBuffers); }
#undef PGT_SCAN_STAGE
#undef PGT_SCAN_BUDGET

int PGT_ENTRY(pgt_strip_scan_blocks_per_sm)(int is64, int smoother) {
  using pgt::blocks_per_sm;
  using pgt::StripFilterScan;
  using pgt::StripScan;
  if (is64) {
    return smoother ? blocks_per_sm<StripScan<double, PGT_D>>(pgt::strip_smoother_scan_kernel<double, PGT_D>)
                    : blocks_per_sm<StripFilterScan<double, PGT_D>>(pgt::strip_filter_scan_kernel<double, PGT_D>);
  }
  return smoother ? blocks_per_sm<StripScan<float, PGT_D>>(pgt::strip_smoother_scan_kernel<float, PGT_D>)
                  : blocks_per_sm<StripFilterScan<float, PGT_D>>(pgt::strip_filter_scan_kernel<float, PGT_D>);
}

int PGT_ENTRY(pgt_strip_filter_apply)(int is64, const void* scal, const void* prefix, const void* Fs, const void* Qs,
                                      const void* y, void* b, void* C, void* ell_parts, long long T, int K,
                                      void* stream) {
  if (T < 1 || K < 1) return pgt::kBadArgs;
  const long long n_chunks = (T + K - 1) / K;
  int rc = 0;
#define PGT_LAUNCH(S)                                                                                     \
  {                                                                                                       \
    typedef pgt::ApplyStage<S, PGT_D, false> A;                                                           \
    rc = pgt::launch_opted_in(pgt::strip_filter_apply_kernel<S, PGT_D>, pgt::n_blocks(n_chunks, A::kThreads), \
                              A::kThreads, A::kBytes, (cudaStream_t)stream, (const S*)scal, (const S*)prefix, \
                              (const S*)Fs, (const S*)Qs, (const S*)y, (S*)b, (S*)C, (S*)ell_parts, T, K,   \
                              n_chunks);                                                                  \
  }
  PGT_DISPATCH_TYPE(is64, PGT_LAUNCH);
#undef PGT_LAUNCH
  return rc;
}

int PGT_ENTRY(pgt_strip_smoother_scan)(int is64, const void* Fs, const void* Qs, const void* b, const void* C,
                                       void* totals, long long T, int K, void* stream) {
  if (T < 1 || K < 1) return pgt::kBadArgs;
  const long long n_chunks = (T + K - 1) / K;
  int rc = 0;
#define PGT_LAUNCH(S)                                                                                       \
  {                                                                                                         \
    typedef pgt::StripScan<S, PGT_D> A;                                                                     \
    /* smoother_scan_planes keeps the step after a round in its pad */                                      \
    if (pgt::StripScanPlanes<S, PGT_D>::kOn && K % A::G::kR != 0) return pgt::kBadArgs;                     \
    rc = pgt::launch_opted_in(pgt::strip_smoother_scan_kernel<S, PGT_D>, pgt::n_blocks(n_chunks, A::kThreads), \
                              A::kThreads, A::kBytes, (cudaStream_t)stream, (const S*)Fs, (const S*)Qs,       \
                              (const S*)b, (const S*)C, (S*)totals, T, K, n_chunks);                        \
  }
  PGT_DISPATCH_TYPE(is64, PGT_LAUNCH);
#undef PGT_LAUNCH
  return rc;
}

int PGT_ENTRY(pgt_strip_smoother_apply)(int is64, const void* prefix, const void* Fs, const void* Qs, const void* b,
                                        const void* C, void* g, void* L, long long T, int K, void* stream) {
  if (T < 1 || K < 1) return pgt::kBadArgs;
  const long long n_chunks = (T + K - 1) / K;
  int rc = 0;
#define PGT_LAUNCH(S)                                                                                       \
  {                                                                                                         \
    typedef pgt::ApplyStage<S, PGT_D, true> A;                                                              \
    /* smoother_apply_planes keeps the step after a round in its pad */                                     \
    if (A::kPlanes && K % A::G::kR != 0) return pgt::kBadArgs;                                              \
    rc = pgt::launch_opted_in(pgt::strip_smoother_apply_kernel<S, PGT_D>, pgt::n_blocks(n_chunks, A::kThreads), \
                              A::kThreads, A::kBytes, (cudaStream_t)stream, (const S*)prefix, (const S*)Fs,   \
                              (const S*)Qs, (const S*)b, (const S*)C, (S*)g, (S*)L, T, K, n_chunks);         \
  }
  PGT_DISPATCH_TYPE(is64, PGT_LAUNCH);
#undef PGT_LAUNCH
  return rc;
}

}  // extern "C"
