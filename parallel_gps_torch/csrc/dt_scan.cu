// The four scan passes of the dt-engine, hand-written for Hopper (sm_90a).
//
// Each thread owns a contiguous chunk of K time steps.  For every step it
// rebuilds the transition F and the noise Q from dt and the kernel's
// transition coefficients (dt_elements.cuh: build_fq) and forms the scan
// element in registers (the pass bodies are scan_passes.cuh, shared with the
// plane-streaming kernels of strip_scan.cu); nothing per step but dt, y and
// the moments is read or written.  A pass-1 kernel folds each chunk to its total; the exclusive
// prefix over the (n, n_chunks) totals runs between the passes (plain PyTorch
// on the device, kalman/dt.py); a pass-2 kernel re-folds each chunk seeded
// with its prefix and writes the moments.
//
// Layouts are time-last, as at the port's public functions: dt, y (T,);
// b, g (D, T); C, L (D, D, T); totals and prefixes (n, n_chunks).
// Scalars (dt_launch.cuh): filter [P0 (D²) | h (D) | r | coeffs], smoother
// [P0 | coeffs]; the spectral family's coefficients are followed by its
// block table (dt_elements.cuh: Spectral).
//
// Three transition families: the exponential polynomial of the Matérn kernels
// (D = 1..3, its coefficients held in each thread's registers), RBF's
// spectral closed form (D = 1..8, up to 513 coefficients) and the composite
// family of Periodic, Sum and Product (D = 1..8, up to 2,338 coefficients
// and plan values): the last two read their table from shared memory,
// TableScalars, and their staged kernels size their blocks by their
// shared-memory budget, TableApply and ScanStage.
//
// One translation unit per state dimension (kalman/_cuda.py: VARIANTS):
// compile with -DPGT_D=<1..8>; the entry points carry the dimension in their
// names (pgt_dt_filter_scan_d3, ...) and take the family.
//
// What bounds these kernels on an H100, and what the design does about it:
// the work per step is a dependent chain of small dense algebra (a filtering
// combine at D=3 is ~400 flops with a 3x3 inverse), so each thread is
// latency-bound on its own chain, and the card is kept busy by many
// independent chunks in flight; the elements stay in registers and the F/Q
// planes never exist in memory.  Memory access is the other bound: a thread
// walks its own chunk, so a warp's loads are strided by K and are not
// coalesced; reads of one or two rows (dt, y) are served by L1, and the
// passes that read b and C pay for it.  A warp's stores strided by K touch 32
// partial sectors each.  The kernels that move the moments therefore stage
// them through shared memory a warp at a time (scan_passes.cuh: ChunkStage):
// the filter's pass-2 stores (filter_apply_staged), the smoother's pass-2
// loads and stores (smoother_apply_staged) and its pass-1 loads
// (smoother_scan_staged), and the filter's pass-1 loads of y and dt
// (filter_scan_staged) at the two units where that measured faster than
// reading them strided; the other passes read dt strided.  Each kernel below notes
// which of the two bounds it.
#include <cuda_runtime.h>

#include "scan_passes.cuh"

#ifndef PGT_D
#error "compile with -DPGT_D=<state dimension, 1..8>"
#endif
#if PGT_D < 1 || PGT_D > 8
#error "PGT_D must be in 1..8"
#endif

namespace pgt {

// The dt-engine's sources of a step's F and Q for the shared pass bodies
// (scan_passes.cuh): rebuilt from dt[t] and the transition coefficients (the
// filter's by build, F and Q from a dt value, which the staged filter scan
// applies to its staged dt).
template <typename S, int D>
struct DtFilterSource : FilterScalars<S, D> {
  const S* dt;
  __device__ __forceinline__ void build(S dtv, S* F, S* Q) const {
    build_fq<S, D>(this->c, this->degree, this->P0, dtv, F, Q);
  }
  __device__ __forceinline__ void fq(long long t, S* F, S* Q) const { build(dt[t], F, Q); }
};

template <typename S, int D>
struct DtSmootherSource : SmootherScalars<S, D> {
  const S* dt;
  __device__ __forceinline__ void fq(long long t, S* F, S* Q) const {
    build_fq<S, D>(this->c, this->degree, this->P0, dt[t], F, Q);
  }
};

// The sources of the families that read a table (Fam: Spectral<D> or
// Composite<D>): the same rebuild, the coefficients read from the block's
// shared-memory table (TableScalars).
template <typename S, int D, typename Fam>
struct TableFilterSource : TableScalars<S, D, true, Fam> {
  const S* dt;
  __device__ __forceinline__ void build(S dtv, S* F, S* Q) const {
    S Am1[D * D], M[D * D];
    table_am1<S, D>(Fam{}, this->c, dtv, Am1);
    fq_from_am1<S, D>(Am1, this->P0, M, F, Q);
  }
  __device__ __forceinline__ void fq(long long t, S* F, S* Q) const { build(dt[t], F, Q); }
};

template <typename S, int D, typename Fam>
struct TableSmootherSource : TableScalars<S, D, false, Fam> {
  const S* dt;
  __device__ __forceinline__ void fq(long long t, S* F, S* Q) const {
    S Am1[D * D], M[D * D];
    table_am1<S, D>(Fam{}, this->c, dt[t], Am1);
    fq_from_am1<S, D>(Am1, this->P0, M, F, Q);
  }
};

extern __shared__ __align__(16) unsigned char pgt_dt_smem[];

// The calling warp's region of the staged kernels' dynamic shared memory.
template <typename S, int D>
__device__ __forceinline__ S* warp_stage() {
  return reinterpret_cast<S*>(pgt_dt_smem) + (threadIdx.x / 32) * ChunkStage<S, D>::kWarp;
}

// The calling warp's stage of a budget A (SpectralApply, ScanStage): after
// A::kTableBytes of the block's scalar table, if any.
template <typename A, typename S>
__device__ __forceinline__ S* table_warp_stage() {
  return reinterpret_cast<S*>(pgt_dt_smem) + A::kTableBytes / sizeof(S) + (threadIdx.x / 32) * A::G::kWarp;
}

// ---------------------------------------------------------------------------
// Filter pass 1.  Replaces parallel_gps_tpu/kalman/pallas_dt.py
// _dt_filter_scan_kernel (:179, pallas_call :341): per-chunk totals.
// Bound: the combine chain (it reads 8 bytes a step and writes one total
// per chunk); 0.19 / 0.14 / 0.26 device ms at T = 10M f32, D = 1, 2, 3,
// each thread reading its own chunk's y and dt strided by K (PERF.md §6,
// row 1).  Those two rows mostly hit L1, but each load sits on the thread's
// dependent chain; so a unit of the first pair of masks below stages them a
// warp at a time instead, kR steps of its 32 chunks copied in as whole
// sectors (filter_scan_staged), in two buffers at the units of the second
// pair; the rest read them directly (filter_scan_direct).  Staged won on an
// H100 only where the fold is shortest against its loads, the exponential
// polynomial's f32 D = 1 (0.095 against 0.19 device ms at 10M), and at the
// spectral f32 D = 7 (0.586 against 0.609 at 1M); elsewhere it lost by up to
// 60% (the staged body takes more registers, 157 against 128 at f32 D = 3,
// and two warp barriers a round), and two buffers won nowhere by more than
// 1%.  Blocks by ScanStage (DtFilterScan below; the spectral family's,
// SpectralFilterScan, count its table first).
// ---------------------------------------------------------------------------
constexpr unsigned kDtFilterScanStagedF32 = 0x1u;
constexpr unsigned kDtFilterScanStagedF64 = 0x0u;
constexpr unsigned kDtFilterScanTwoF32 = 0x0u;
constexpr unsigned kDtFilterScanTwoF64 = 0x0u;
constexpr unsigned kSpectralFilterScanStagedF32 = 0x40u;
constexpr unsigned kSpectralFilterScanStagedF64 = 0x0u;
constexpr unsigned kSpectralFilterScanTwoF32 = 0x0u;
constexpr unsigned kSpectralFilterScanTwoF64 = 0x0u;

template <typename S, int D>
using DtFilterScan = ScanStage<S, FilterDtRows<S>, FilterScanBuffers<S, D, kDtFilterScanStagedF32, kDtFilterScanStagedF64,
                                                                     kDtFilterScanTwoF32, kDtFilterScanTwoF64>::kN>;

// Filter pass 1 of chunk c by the unit's budget A: staged or direct.  Every
// thread of the block calls it.
template <typename A, typename S, int D, typename Src>
__device__ __forceinline__ void dt_filter_scan_body(const Src& p, const S* dt, const S* y, S* totals, long long T,
                                                    int K, long long n_chunks, long long c) {
  if constexpr (A::kBuffers == 0) {
    if (c < n_chunks) filter_scan_direct<S, D>(p, y, totals, T, K, n_chunks, c);
  } else {
    filter_scan_staged<S, D, A::kBuffers>(p, dt, y, totals, T, K, n_chunks, c, table_warp_stage<A, S>());
  }
}

template <typename S, int D>
__global__ void __launch_bounds__((DtFilterScan<S, D>::kThreads))
    dt_filter_scan_kernel(const S* __restrict__ scal, int degree, const S* __restrict__ dt, const S* __restrict__ y,
                          S* __restrict__ totals, long long T, int K, long long n_chunks) {
  typedef DtFilterScan<S, D> A;
  const long long c = (long long)blockIdx.x * A::kThreads + threadIdx.x;
  DtFilterSource<S, D> p;
  p.load(scal, degree);
  p.dt = dt;
  dt_filter_scan_body<A, S, D>(p, dt, y, totals, T, K, n_chunks, c);
}

// ---------------------------------------------------------------------------
// Filter pass 2.  Replaces pallas_dt.py _dt_filter_apply_kernel (:208,
// pallas_call :369): seeded re-fold, filtered moments, and the streamed
// log p(y_t | y_<t) (pallas_dt.py:270-281) from the previous moments — the
// prefix-included element before step t, or (0, P0) at global t = 0.
// Per-thread sums are reduced per block in a fixed order (no atomics).
// Bound: bytes, 0.173 ms at T = 10M f32, D = 3 (dt, y and the prefixes in,
// b and C out).  Its stores, 12 values a step at D = 3, are most of its
// cost when each thread writes its own chunk's, strided by K: 8.5 ms of
// device time on an NVIDIA H100 80GB HBM3 at 700 W, against 0.26 ms for
// pass 1's same fold and reads.  So each warp stages kR steps of its 32
// chunks in shared memory and writes every row as whole 32-byte sectors
// (filter_apply_staged; ChunkStage<S, D>::kBytes of dynamic shared memory a
// block, 54 KB at D = 3 float, above the 48 KB static limit, hence the
// opt-in in the launcher): 0.87 ms on the same card.
// ---------------------------------------------------------------------------
template <typename S, int D>
__global__ void __launch_bounds__(kThreads)
    dt_filter_apply_kernel(const S* __restrict__ scal, int degree, const S* __restrict__ prefix,
                           const S* __restrict__ dt, const S* __restrict__ y, S* __restrict__ b_out,
                           S* __restrict__ C_out, S* __restrict__ ell_parts, long long T, int K, long long n_chunks) {
  const long long c = (long long)blockIdx.x * kThreads + threadIdx.x;
  DtFilterSource<S, D> p;
  p.load(scal, degree);
  p.dt = dt;
  const S ll = filter_apply_staged<S, D>(p, prefix, y, b_out, C_out, T, K, n_chunks, c, warp_stage<S, D>());
  block_sum<S>(ll, ell_parts);
}

// Launches a staged kernel with its ChunkStage<S, D>::kBytes of dynamic
// shared memory a block (dt_launch.cuh: launch_opted_in).
template <typename S, int D, typename Kern, typename... Args>
int launch_staged(Kern kern, long long n_chunks, cudaStream_t st, Args... args) {
  return launch_opted_in(kern, n_blocks(n_chunks), kThreads, ChunkStage<S, D>::kBytes, st, args...);
}

// ---------------------------------------------------------------------------
// Smoother pass 1.  Replaces pallas_dt.py _dt_smoother_scan_kernel (:553,
// pallas_call :685): reverse fold of each chunk to its suffix total.  The
// next step's dt is read directly (t+1 < T), in place of the TPU kernel's
// cross-strip boundary-dt column.
// Bound: bytes, 0.159 ms at T = 10M f32, D = 3 (dt, b and C in).  Loaded
// strided by K, a thread walking its own chunk, its b and C (12 values a step
// at D = 3) took 4.2 ms on an NVIDIA H100 80GB HBM3 at 700 W; so each warp
// stages them, kR steps of its 32 chunks copied in as whole sectors
// (smoother_scan_staged), in blocks set by ScanStage (the moments' rows, no
// table).
//
// The smoother pass 1's units, of each family, that stage two buffers, the
// next round's copy in flight while one is folded (bit D − 1), where that
// measured more than 1% faster on an H100 (PERF.md §6, row 3: float D = 1, 3
// and spectral D = 1, 4; two buffers halve the warps an SM, and lost by up to
// 1.8× at spectral D ≥ 5); the rest stage one.  The double units were not
// timed, and stage one.
// ---------------------------------------------------------------------------
constexpr unsigned kDtScanTwoF32 = 0x5u;
constexpr unsigned kDtScanTwoF64 = 0x0u;
constexpr unsigned kSpectralScanTwoF32 = 0x9u;
constexpr unsigned kSpectralScanTwoF64 = 0x0u;

template <typename S, int D>
using DtScan = ScanStage<S, MomentRows<const S*, D>, UnitBit<S, D, kDtScanTwoF32, kDtScanTwoF64>::kOn ? 2 : 1>;

template <typename S, int D>
__global__ void __launch_bounds__((DtScan<S, D>::kThreads))
    dt_smoother_scan_kernel(const S* __restrict__ scal, int degree, const S* __restrict__ dt,
                            const S* __restrict__ b, const S* __restrict__ C, S* __restrict__ totals, long long T,
                            int K, long long n_chunks) {
  typedef DtScan<S, D> A;
  const long long c = (long long)blockIdx.x * A::kThreads + threadIdx.x;
  DtSmootherSource<S, D> p;
  p.load(scal, degree);
  p.dt = dt;
  smoother_scan_staged<S, D, A::kBuffers>(p, b, C, totals, T, K, n_chunks, c, table_warp_stage<A, S>());
}

// ---------------------------------------------------------------------------
// Smoother pass 2.  Replaces pallas_dt.py _dt_smoother_apply_kernel (:589,
// pallas_call :724): reverse re-fold seeded with the chunk's exclusive
// suffix; writes the smoothed g and L.
// Bound: bytes, 0.302 ms at T = 10M f32, D = 3 (dt, b, C and the suffixes
// in, g and L out).  Each thread walking its own chunk reads b, C and writes
// g, L strided by K, 24 values a step at D = 3: 12.3 ms on an NVIDIA H100
// 80GB HBM3 at 700 W.  So each warp stages kR steps of its 32 chunks:
// b, C copied in as whole sectors, folded in place into g, L, copied out as
// whole sectors (smoother_apply_staged; the filter's ChunkStage<S, D>::kBytes
// of dynamic shared memory a block, opted in): 1.26 ms of device time on the
// same card, 1.4–1.5 ms in events around its wrapper.
// ---------------------------------------------------------------------------
template <typename S, int D>
__global__ void __launch_bounds__(kThreads)
    dt_smoother_apply_kernel(const S* __restrict__ scal, int degree, const S* __restrict__ prefix,
                             const S* __restrict__ dt, const S* __restrict__ b, const S* __restrict__ C,
                             S* __restrict__ g_out, S* __restrict__ L_out, long long T, int K, long long n_chunks) {
  const long long c = (long long)blockIdx.x * kThreads + threadIdx.x;
  DtSmootherSource<S, D> p;
  p.load(scal, degree);
  p.dt = dt;
  smoother_apply_staged<S, D>(p, prefix, b, C, g_out, L_out, T, K, n_chunks, c, warp_stage<S, D>());
}

// ---------------------------------------------------------------------------
// The spectral and composite families: the same four passes (pallas_dt.py:179,
// :208, :553, :589 with RBF's build closure, rbf.py:267, or a Periodic, Sum
// or Product build, periodic.py:140, base.py:242, :420), F and Q rebuilt from
// the shared-memory table.  Bound: as the exponential polynomial's, plus the
// build — the spectral family's (D+1)/2 blocks of 2 transcendentals and 2·D²
// multiply-adds a step; the composite family's n_w weights (a transcendental
// or two each) and, for each of its monomials, up to two multiplies and one
// multiply-add for each structurally nonzero entry.
//
// The composite units' pass-1 filter reads y and dt directly and their
// smoother pass 1 stages one buffer, at every unit (the masks below): the
// choices of the spectral units at most of theirs, not measured for this
// family.
// ---------------------------------------------------------------------------
constexpr unsigned kCompositeFilterScanStagedF32 = 0x0u;
constexpr unsigned kCompositeFilterScanStagedF64 = 0x0u;
constexpr unsigned kCompositeFilterScanTwoF32 = 0x0u;
constexpr unsigned kCompositeFilterScanTwoF64 = 0x0u;
constexpr unsigned kCompositeScanTwoF32 = 0x0u;
constexpr unsigned kCompositeScanTwoF64 = 0x0u;

// The pass-2 kernels' budget, one fixed choice a unit: the scalar table, then
// each warp's ChunkStage<S, D> (D + D² rows, as the exponential polynomial's)
// — 4 warps of it exceed a block's 232,448 bytes at D ≥ 7 (258,048 B at
// D = 7 float) — in blocks of 4, 2 or 1 warps, whichever leaves an SM the
// most warps (BlockWarps; the filter's block_sum values are counted too).
template <typename S, int D, bool kFilter, typename Fam>
struct TableApply {
  typedef ChunkStage<S, D, D + D * D, 1> G;
  static constexpr int kTableBytes = TableScalars<S, D, kFilter, Fam>::kBytes;
  static constexpr int kWarpBytes = G::kBytes + (kFilter ? 32 * (int)sizeof(S) : 0);
  static constexpr int kWarps = BlockWarps<kWarpBytes, kTableBytes>::kN;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBytes = kTableBytes + kWarps * G::kBytes;  // dynamic shared memory a block
  static_assert(kWarpBytes + kTableBytes <= kSmemLimit, "a pass-2 unit does not fit one warp a block");
};

template <typename S, int D, bool kFilter>
using SpectralApply = TableApply<S, D, kFilter, Spectral<D>>;
template <typename S, int D, bool kFilter>
using CompositeApply = TableApply<S, D, kFilter, Composite<D>>;

// The filter's pass 1: the table, then each warp's stage of its y and dt
// rows, or none (the units that read them directly), in blocks set by
// ScanStage.
template <typename S, int D>
using SpectralFilterScan =
    ScanStage<S, FilterDtRows<S>,
              FilterScanBuffers<S, D, kSpectralFilterScanStagedF32, kSpectralFilterScanStagedF64,
                                kSpectralFilterScanTwoF32, kSpectralFilterScanTwoF64>::kN,
              SpectralScalars<S, D, true>::kBytes>;
template <typename S, int D>
using CompositeFilterScan =
    ScanStage<S, FilterDtRows<S>,
              FilterScanBuffers<S, D, kCompositeFilterScanStagedF32, kCompositeFilterScanStagedF64,
                                kCompositeFilterScanTwoF32, kCompositeFilterScanTwoF64>::kN,
              TableScalars<S, D, true, Composite<D>>::kBytes>;

// The smoother's pass 1: the table, then each warp's stage of its moments
// (smoother_scan_staged), in blocks set by ScanStage.
template <typename S, int D>
using SpectralScan = ScanStage<S, MomentRows<const S*, D>,
                               UnitBit<S, D, kSpectralScanTwoF32, kSpectralScanTwoF64>::kOn ? 2 : 1,
                               SpectralScalars<S, D, false>::kBytes>;
template <typename S, int D>
using CompositeScan = ScanStage<S, MomentRows<const S*, D>,
                                UnitBit<S, D, kCompositeScanTwoF32, kCompositeScanTwoF64>::kOn ? 2 : 1,
                                TableScalars<S, D, false, Composite<D>>::kBytes>;

// The four passes of a table family's unit of budget A; every thread of the
// block calls each.
template <typename A, typename S, int D, typename Fam>
__device__ __forceinline__ void table_filter_scan(const S* scal, const S* dt, const S* y, S* totals, long long T,
                                                  int K, long long n_chunks) {
  TableFilterSource<S, D, Fam> p;
  p.load(scal, reinterpret_cast<S*>(pgt_dt_smem));
  p.dt = dt;
  const long long c = (long long)blockIdx.x * A::kThreads + threadIdx.x;
  dt_filter_scan_body<A, S, D>(p, dt, y, totals, T, K, n_chunks, c);
}

template <typename A, typename S, int D, typename Fam>
__device__ __forceinline__ void table_filter_apply(const S* scal, const S* prefix, const S* dt, const S* y, S* b_out,
                                                   S* C_out, S* ell_parts, long long T, int K, long long n_chunks) {
  TableFilterSource<S, D, Fam> p;
  p.load(scal, reinterpret_cast<S*>(pgt_dt_smem));
  p.dt = dt;
  const long long c = (long long)blockIdx.x * A::kThreads + threadIdx.x;
  const S ll = filter_apply_staged<S, D>(p, prefix, y, b_out, C_out, T, K, n_chunks, c, table_warp_stage<A, S>());
  block_sum<S, A::kThreads>(ll, ell_parts);
}

template <typename A, typename S, int D, typename Fam>
__device__ __forceinline__ void table_smoother_scan(const S* scal, const S* dt, const S* b, const S* C, S* totals,
                                                    long long T, int K, long long n_chunks) {
  TableSmootherSource<S, D, Fam> p;
  p.load(scal, reinterpret_cast<S*>(pgt_dt_smem));
  p.dt = dt;
  const long long c = (long long)blockIdx.x * A::kThreads + threadIdx.x;
  smoother_scan_staged<S, D, A::kBuffers>(p, b, C, totals, T, K, n_chunks, c, table_warp_stage<A, S>());
}

template <typename A, typename S, int D, typename Fam>
__device__ __forceinline__ void table_smoother_apply(const S* scal, const S* prefix, const S* dt, const S* b,
                                                     const S* C, S* g_out, S* L_out, long long T, int K,
                                                     long long n_chunks) {
  TableSmootherSource<S, D, Fam> p;
  p.load(scal, reinterpret_cast<S*>(pgt_dt_smem));
  p.dt = dt;
  const long long c = (long long)blockIdx.x * A::kThreads + threadIdx.x;
  smoother_apply_staged<S, D>(p, prefix, b, C, g_out, L_out, T, K, n_chunks, c, table_warp_stage<A, S>());
}

// The kernels, one a pass and family.
#define PGT_TABLE_KERNELS(FAM, FAMILY_T, FILTER_SCAN, SCAN, APPLY)                                                  \
  template <typename S, int D>                                                                                      \
  __global__ void __launch_bounds__((FILTER_SCAN<S, D>::kThreads))                                                 \
      dt_filter_scan_##FAM##_kernel(const S* __restrict__ scal, const S* __restrict__ dt, const S* __restrict__ y,  \
                                    S* __restrict__ totals, long long T, int K, long long n_chunks) {              \
    table_filter_scan<FILTER_SCAN<S, D>, S, D, FAMILY_T<D>>(scal, dt, y, totals, T, K, n_chunks);                   \
  }                                                                                                                 \
  template <typename S, int D>                                                                                      \
  __global__ void __launch_bounds__((APPLY<S, D, true>::kThreads))                                                 \
      dt_filter_apply_##FAM##_kernel(const S* __restrict__ scal, const S* __restrict__ prefix,                      \
                                     const S* __restrict__ dt, const S* __restrict__ y, S* __restrict__ b_out,      \
                                     S* __restrict__ C_out, S* __restrict__ ell_parts, long long T, int K,          \
                                     long long n_chunks) {                                                          \
    table_filter_apply<APPLY<S, D, true>, S, D, FAMILY_T<D>>(scal, prefix, dt, y, b_out, C_out, ell_parts, T, K,    \
                                                             n_chunks);                                             \
  }                                                                                                                 \
  template <typename S, int D>                                                                                      \
  __global__ void __launch_bounds__((SCAN<S, D>::kThreads))                                                        \
      dt_smoother_scan_##FAM##_kernel(const S* __restrict__ scal, const S* __restrict__ dt,                         \
                                      const S* __restrict__ b, const S* __restrict__ C, S* __restrict__ totals,     \
                                      long long T, int K, long long n_chunks) {                                     \
    table_smoother_scan<SCAN<S, D>, S, D, FAMILY_T<D>>(scal, dt, b, C, totals, T, K, n_chunks);                     \
  }                                                                                                                 \
  template <typename S, int D>                                                                                      \
  __global__ void __launch_bounds__((APPLY<S, D, false>::kThreads))                                                \
      dt_smoother_apply_##FAM##_kernel(const S* __restrict__ scal, const S* __restrict__ prefix,                    \
                                       const S* __restrict__ dt, const S* __restrict__ b, const S* __restrict__ C,  \
                                       S* __restrict__ g_out, S* __restrict__ L_out, long long T, int K,            \
                                       long long n_chunks) {                                                        \
    table_smoother_apply<APPLY<S, D, false>, S, D, FAMILY_T<D>>(scal, prefix, dt, b, C, g_out, L_out, T, K,         \
                                                                n_chunks);                                          \
  }

PGT_TABLE_KERNELS(spectral, Spectral, SpectralFilterScan, SpectralScan, SpectralApply)
PGT_TABLE_KERNELS(composite, Composite, CompositeFilterScan, CompositeScan, CompositeApply)
#undef PGT_TABLE_KERNELS

}  // namespace pgt

// C interface, bound with ctypes (kalman/_cuda.py), one set of entry points
// per state dimension.  Each entry launches one kernel on the given stream,
// does not synchronise, and returns cudaGetLastError() (0 on success) or
// kBadArgs.  ``family`` is kExppoly (D ≤ 3 units only), kSpectral or
// kComposite; ``degree`` is the exponential polynomial's.
#define PGT_CAT2(a, b) a##b
#define PGT_CAT(a, b) PGT_CAT2(a, b)
#define PGT_ENTRY(name) PGT_CAT(PGT_CAT(name, _d), PGT_D)

extern "C" {

#if PGT_D == 1
int pgt_threads_per_block(void) { return pgt::kThreads; }

const char* pgt_error_string(int rc) {
  if (rc == pgt::kBadArgs) return "unsupported arguments (family, d, degree, T or chunk)";
  return cudaGetErrorString((cudaError_t)rc);
}
#endif

int PGT_ENTRY(pgt_dt_filter_scan)(int is64, int family, int degree, const void* scal, const void* dt, const void* y,
                                  void* totals, long long T, int K, void* stream) {
  if (pgt::bad_shape<PGT_D>(family, degree, T, K)) return pgt::kBadArgs;
  const long long n_chunks = (T + K - 1) / K;
  cudaStream_t st = (cudaStream_t)stream;
  int rc = 0;
  if (family == pgt::kSpectral) {
#define PGT_LAUNCH(S)                                                                                           \
  {                                                                                                             \
    typedef pgt::SpectralFilterScan<S, PGT_D> A;                                                                \
    rc = pgt::launch_opted_in(pgt::dt_filter_scan_spectral_kernel<S, PGT_D>, pgt::n_blocks(n_chunks, A::kThreads), \
                              A::kThreads, A::kBytes, st, (const S*)scal, (const S*)dt, (const S*)y, (S*)totals, \
                              T, K, n_chunks);                                                                  \
  }
    PGT_DISPATCH_TYPE(is64, PGT_LAUNCH);
#undef PGT_LAUNCH
    return rc;
  }
  if (family == pgt::kComposite) {
#define PGT_LAUNCH(S)                                                                                           \
  {                                                                                                             \
    typedef pgt::CompositeFilterScan<S, PGT_D> A;                                                                \
    rc = pgt::launch_opted_in(pgt::dt_filter_scan_composite_kernel<S, PGT_D>, pgt::n_blocks(n_chunks, A::kThreads), \
                              A::kThreads, A::kBytes, st, (const S*)scal, (const S*)dt, (const S*)y, (S*)totals, \
                              T, K, n_chunks);                                                                  \
  }
    PGT_DISPATCH_TYPE(is64, PGT_LAUNCH);
#undef PGT_LAUNCH
    return rc;
  }
#if PGT_D <= 3
#define PGT_LAUNCH(S)                                                                                          \
  {                                                                                                            \
    typedef pgt::DtFilterScan<S, PGT_D> A;                                                                     \
    rc = pgt::launch_opted_in(pgt::dt_filter_scan_kernel<S, PGT_D>, pgt::n_blocks(n_chunks, A::kThreads),     \
                              A::kThreads, A::kBytes, st, (const S*)scal, degree, (const S*)dt, (const S*)y,   \
                              (S*)totals, T, K, n_chunks);                                                     \
  }
  PGT_DISPATCH_TYPE(is64, PGT_LAUNCH);
#undef PGT_LAUNCH
#endif
  return rc;
}

// The pass-2 kernels' blocks at this unit: threads a block and dynamic shared
// memory a block in bytes, of the filter (smoother = 0) or the smoother.
#define PGT_APPLY(A, FIELD)                                                                                      \
  (is64 ? (smoother ? pgt::A<double, PGT_D, false>::FIELD : pgt::A<double, PGT_D, true>::FIELD)                    \
        : (smoother ? pgt::A<float, PGT_D, false>::FIELD : pgt::A<float, PGT_D, true>::FIELD))
int PGT_ENTRY(pgt_dt_apply_threads)(int is64, int family, int smoother) {
  if (family == pgt::kSpectral) return PGT_APPLY(SpectralApply, kThreads);
  if (family == pgt::kComposite) return PGT_APPLY(CompositeApply, kThreads);
  return pgt::kThreads;
}

int PGT_ENTRY(pgt_dt_apply_smem)(int is64, int family, int smoother) {
  if (family == pgt::kSpectral) return PGT_APPLY(SpectralApply, kBytes);
  if (family == pgt::kComposite) return PGT_APPLY(CompositeApply, kBytes);
#if PGT_D <= 3
  return is64 ? pgt::ChunkStage<double, PGT_D>::kBytes : pgt::ChunkStage<float, PGT_D>::kBytes;
#else
  return pgt::kBadArgs;
#endif
}
#undef PGT_APPLY

int PGT_ENTRY(pgt_dt_filter_apply)(int is64, int family, int degree, const void* scal, const void* prefix,
                                   const void* dt, const void* y, void* b, void* C, void* ell_parts, long long T,
                                   int K, void* stream) {
  if (pgt::bad_shape<PGT_D>(family, degree, T, K)) return pgt::kBadArgs;
  const long long n_chunks = (T + K - 1) / K;
  int rc = 0;
  if (family == pgt::kSpectral) {
#define PGT_LAUNCH(S)                                                                                          \
  {                                                                                                            \
    typedef pgt::SpectralApply<S, PGT_D, true> A;                                                              \
    rc = pgt::launch_opted_in(pgt::dt_filter_apply_spectral_kernel<S, PGT_D>, pgt::n_blocks(n_chunks, A::kThreads), \
                              A::kThreads, A::kBytes, (cudaStream_t)stream, (const S*)scal, (const S*)prefix,  \
                              (const S*)dt, (const S*)y, (S*)b, (S*)C, (S*)ell_parts, T, K, n_chunks);         \
  }
    PGT_DISPATCH_TYPE(is64, PGT_LAUNCH);
#undef PGT_LAUNCH
    return rc;
  }
  if (family == pgt::kComposite) {
#define PGT_LAUNCH(S)                                                                                          \
  {                                                                                                            \
    typedef pgt::CompositeApply<S, PGT_D, true> A;                                                              \
    rc = pgt::launch_opted_in(pgt::dt_filter_apply_composite_kernel<S, PGT_D>, pgt::n_blocks(n_chunks, A::kThreads), \
                              A::kThreads, A::kBytes, (cudaStream_t)stream, (const S*)scal, (const S*)prefix,  \
                              (const S*)dt, (const S*)y, (S*)b, (S*)C, (S*)ell_parts, T, K, n_chunks);         \
  }
    PGT_DISPATCH_TYPE(is64, PGT_LAUNCH);
#undef PGT_LAUNCH
    return rc;
  }
#if PGT_D <= 3
#define PGT_LAUNCH(S)                                                                                            \
  {                                                                                                              \
    auto kern = pgt::dt_filter_apply_kernel<S, PGT_D>;                                                           \
    rc = pgt::launch_staged<S, PGT_D>(kern, n_chunks, (cudaStream_t)stream, (const S*)scal, degree,              \
                                      (const S*)prefix, (const S*)dt, (const S*)y, (S*)b, (S*)C, (S*)ell_parts,  \
                                      T, K, n_chunks);                                                           \
  }
  PGT_DISPATCH_TYPE(is64, PGT_LAUNCH);
#undef PGT_LAUNCH
#endif
  return rc;
}

// The pass-1 budget (ScanStage) of the filter (smoother = 0) or the smoother
// at this unit and family: threads a block, rows a warp stages in a buffer,
// dynamic shared memory a block in bytes and buffers (0: the filter unit
// reads its rows directly); and the blocks an SM holds at once (the CUDA
// occupancy calculator: registers, shared memory, threads), or minus the
// error code.  kBadArgs for the exponential polynomial above D = 3.
#define PGT_SCAN_BUDGET(A, S, FIELD) (smoother ? pgt::A##Scan<S, PGT_D>::FIELD : pgt::A##FilterScan<S, PGT_D>::FIELD)
#define PGT_SCAN_STAGE(FIELD)                                                                                    \
  (family == pgt::kSpectral ? (is64 ? PGT_SCAN_BUDGET(Spectral, double, FIELD) : PGT_SCAN_BUDGET(Spectral, float, FIELD)) \
   : family == pgt::kComposite                                                                                      \
       ? (is64 ? PGT_SCAN_BUDGET(Composite, double, FIELD) : PGT_SCAN_BUDGET(Composite, float, FIELD))              \
   : PGT_D > 3              ? pgt::kBadArgs                                                                          \
                            : (is64 ? PGT_SCAN_BUDGET(Dt, double, FIELD) : PGT_SCAN_BUDGET(Dt, float, FIELD)))
int PGT_ENTRY(pgt_dt_scan_threads)(int is64, int family, int smoother) { return PGT_SCAN_STAGE(kThreads); }
int PGT_ENTRY(pgt_dt_scan_rows)(int is64, int family, int smoother) { return PGT_SCAN_STAGE(kRows); }
int PGT_ENTRY(pgt_dt_scan_smem)(int is64, int family, int smoother) { return PGT_SCAN_STAGE(kBytes); }
int PGT_ENTRY(pgt_dt_scan_buffers)(int is64, int family, int smoother) { return PGT_SCAN_STAGE(kBuffers); }
#undef PGT_SCAN_STAGE
#undef PGT_SCAN_BUDGET

int PGT_ENTRY(pgt_dt_scan_blocks_per_sm)(int is64, int family, int smoother) {
  using pgt::blocks_per_sm;
#define PGT_BLOCKS(A, kern, S) blocks_per_sm<pgt::A<S, PGT_D>>(pgt::kern<S, PGT_D>)
  if (family == pgt::kSpectral) {
    if (smoother) {
      return is64 ? PGT_BLOCKS(SpectralScan, dt_smoother_scan_spectral_kernel, double)
                  : PGT_BLOCKS(SpectralScan, dt_smoother_scan_spectral_kernel, float);
    }
    return is64 ? PGT_BLOCKS(SpectralFilterScan, dt_filter_scan_spectral_kernel, double)
                : PGT_BLOCKS(SpectralFilterScan, dt_filter_scan_spectral_kernel, float);
  }
  if (family == pgt::kComposite) {
    if (smoother) {
      return is64 ? PGT_BLOCKS(CompositeScan, dt_smoother_scan_composite_kernel, double)
                  : PGT_BLOCKS(CompositeScan, dt_smoother_scan_composite_kernel, float);
    }
    return is64 ? PGT_BLOCKS(CompositeFilterScan, dt_filter_scan_composite_kernel, double)
                : PGT_BLOCKS(CompositeFilterScan, dt_filter_scan_composite_kernel, float);
  }
#if PGT_D <= 3
  if (smoother) {
    return is64 ? PGT_BLOCKS(DtScan, dt_smoother_scan_kernel, double) : PGT_BLOCKS(DtScan, dt_smoother_scan_kernel, float);
  }
  return is64 ? PGT_BLOCKS(DtFilterScan, dt_filter_scan_kernel, double) : PGT_BLOCKS(DtFilterScan, dt_filter_scan_kernel, float);
#else
  return pgt::kBadArgs;
#endif
#undef PGT_BLOCKS
}

int PGT_ENTRY(pgt_dt_smoother_scan)(int is64, int family, int degree, const void* scal, const void* dt,
                                    const void* b, const void* C, void* totals, long long T, int K, void* stream) {
  if (pgt::bad_shape<PGT_D>(family, degree, T, K)) return pgt::kBadArgs;
  const long long n_chunks = (T + K - 1) / K;
  cudaStream_t st = (cudaStream_t)stream;
  int rc = 0;
  if (family == pgt::kSpectral) {
#define PGT_LAUNCH(S)                                                                                           \
  {                                                                                                             \
    typedef pgt::SpectralScan<S, PGT_D> A;                                                                      \
    rc = pgt::launch_opted_in(pgt::dt_smoother_scan_spectral_kernel<S, PGT_D>, pgt::n_blocks(n_chunks, A::kThreads), \
                              A::kThreads, A::kBytes, st, (const S*)scal, (const S*)dt, (const S*)b, (const S*)C, \
                              (S*)totals, T, K, n_chunks);                                                      \
  }
    PGT_DISPATCH_TYPE(is64, PGT_LAUNCH);
#undef PGT_LAUNCH
    return rc;
  }
  if (family == pgt::kComposite) {
#define PGT_LAUNCH(S)                                                                                           \
  {                                                                                                             \
    typedef pgt::CompositeScan<S, PGT_D> A;                                                                      \
    rc = pgt::launch_opted_in(pgt::dt_smoother_scan_composite_kernel<S, PGT_D>, pgt::n_blocks(n_chunks, A::kThreads), \
                              A::kThreads, A::kBytes, st, (const S*)scal, (const S*)dt, (const S*)b, (const S*)C, \
                              (S*)totals, T, K, n_chunks);                                                      \
  }
    PGT_DISPATCH_TYPE(is64, PGT_LAUNCH);
#undef PGT_LAUNCH
    return rc;
  }
#if PGT_D <= 3
#define PGT_LAUNCH(S)                                                                                          \
  {                                                                                                            \
    typedef pgt::DtScan<S, PGT_D> A;                                                                           \
    rc = pgt::launch_opted_in(pgt::dt_smoother_scan_kernel<S, PGT_D>, pgt::n_blocks(n_chunks, A::kThreads),   \
                              A::kThreads, A::kBytes, st, (const S*)scal, degree, (const S*)dt, (const S*)b,   \
                              (const S*)C, (S*)totals, T, K, n_chunks);                                        \
  }
  PGT_DISPATCH_TYPE(is64, PGT_LAUNCH);
#undef PGT_LAUNCH
#endif
  return rc;
}

int PGT_ENTRY(pgt_dt_smoother_apply)(int is64, int family, int degree, const void* scal, const void* prefix,
                                     const void* dt, const void* b, const void* C, void* g, void* L, long long T,
                                     int K, void* stream) {
  if (pgt::bad_shape<PGT_D>(family, degree, T, K)) return pgt::kBadArgs;
  const long long n_chunks = (T + K - 1) / K;
  int rc = 0;
  if (family == pgt::kSpectral) {
#define PGT_LAUNCH(S)                                                                                            \
  {                                                                                                              \
    typedef pgt::SpectralApply<S, PGT_D, false> A;                                                               \
    rc = pgt::launch_opted_in(pgt::dt_smoother_apply_spectral_kernel<S, PGT_D>,                                  \
                              pgt::n_blocks(n_chunks, A::kThreads), A::kThreads, A::kBytes, (cudaStream_t)stream, \
                              (const S*)scal, (const S*)prefix, (const S*)dt, (const S*)b, (const S*)C, (S*)g,    \
                              (S*)L, T, K, n_chunks);                                                            \
  }
    PGT_DISPATCH_TYPE(is64, PGT_LAUNCH);
#undef PGT_LAUNCH
    return rc;
  }
  if (family == pgt::kComposite) {
#define PGT_LAUNCH(S)                                                                                            \
  {                                                                                                              \
    typedef pgt::CompositeApply<S, PGT_D, false> A;                                                               \
    rc = pgt::launch_opted_in(pgt::dt_smoother_apply_composite_kernel<S, PGT_D>,                                  \
                              pgt::n_blocks(n_chunks, A::kThreads), A::kThreads, A::kBytes, (cudaStream_t)stream, \
                              (const S*)scal, (const S*)prefix, (const S*)dt, (const S*)b, (const S*)C, (S*)g,    \
                              (S*)L, T, K, n_chunks);                                                            \
  }
    PGT_DISPATCH_TYPE(is64, PGT_LAUNCH);
#undef PGT_LAUNCH
    return rc;
  }
#if PGT_D <= 3
#define PGT_LAUNCH(S)                                                                                            \
  {                                                                                                              \
    auto kern = pgt::dt_smoother_apply_kernel<S, PGT_D>;                                                         \
    rc = pgt::launch_staged<S, PGT_D>(kern, n_chunks, (cudaStream_t)stream, (const S*)scal, degree,              \
                                      (const S*)prefix, (const S*)dt, (const S*)b, (const S*)C, (S*)g, (S*)L, T, \
                                      K, n_chunks);                                                              \
  }
  PGT_DISPATCH_TYPE(is64, PGT_LAUNCH);
#undef PGT_LAUNCH
#endif
  return rc;
}

}  // extern "C"
