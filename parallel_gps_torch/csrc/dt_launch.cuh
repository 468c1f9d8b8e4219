// What the two-pass kernel sources share on the launch side: the block size,
// the scalar tables a dt kernel reads its model from, the argument check, the
// dispatch on scalar type, the shared-memory budget of a staged block, the
// launch with opted-in shared memory and the occupancy such a launch gets.
#pragma once

#include <cuda_runtime.h>

#include "dt_elements.cuh"

namespace pgt {

constexpr int kThreads = 128;
constexpr int kBadArgs = -1;
// The transition families of kalman/dt.py, as its wrappers pass them.
constexpr int kExppoly = 0;
constexpr int kSpectral = 1;
constexpr int kComposite = 2;

template <typename S, int D>
struct FilterScalars {
  S P0[D * D];
  S h[D];
  S r;
  S c[Exppoly<D>::kMaxCoef];
  int degree;

  __device__ __forceinline__ void load(const S* scal, int deg) {
    degree = deg;
#pragma unroll
    for (int q = 0; q < D * D; ++q) P0[q] = scal[q];
#pragma unroll
    for (int q = 0; q < D; ++q) h[q] = scal[D * D + q];
    r = scal[D * D + D];
    const S* cs = scal + D * D + D + 1;
#pragma unroll
    for (int q = 0; q < Exppoly<D>::kMaxCoef; ++q) c[q] = (q < 1 + deg * D * D) ? cs[q] : S(0);
  }
};

template <typename S, int D>
struct SmootherScalars {
  S P0[D * D];
  S c[Exppoly<D>::kMaxCoef];
  int degree;

  __device__ __forceinline__ void load(const S* scal, int deg) {
    degree = deg;
#pragma unroll
    for (int q = 0; q < D * D; ++q) P0[q] = scal[q];
    const S* cs = scal + D * D;
#pragma unroll
    for (int q = 0; q < Exppoly<D>::kMaxCoef; ++q) c[q] = (q < 1 + deg * D * D) ? cs[q] : S(0);
  }
};

// The dt kernels' families: the exponential polynomial at D ≤ 3, of degree
// ≤ D − 1 (the Matérn range), and the spectral and composite families
// (degree unused).
template <int D>
inline bool bad_shape(int family, int degree, long long T, int K) {
  const bool ok =
      (family == kExppoly && D <= 3 && degree >= 0 && degree <= D - 1) || family == kSpectral || family == kComposite;
  return !ok || T < 1 || K < 1;
}

// The scalar table of a family that reads its coefficients from a table
// (Fam: Spectral<D> or Composite<D>) as a dt kernel reads it, copied once a
// block from device memory into shared memory (every thread then reads the
// same address, a broadcast): the filter's [P0 (D²) | h (D) | r | c], the
// smoother's [P0 | c], c the family's coefficients and table — up to 594
// values at D = 8 for the spectral family and 2,411 for the composite one,
// which do not fit a thread's registers beside the scan element.  kBytes is
// rounded up to 16 bytes, so that what follows it in shared memory stays
// aligned.
template <typename S, int D, bool kFilter, typename Fam = Spectral<D>>
struct TableScalars {
  static constexpr int kC = kFilter ? D * D + D + 1 : D * D;  // where c starts
  static constexpr int kN = kC + Fam::kTable;
  static constexpr int kBytes = (kN * (int)sizeof(S) + 15) / 16 * 16;
  const S* P0;
  const S* h;
  S r;
  const S* c;

  // Every thread of the block calls it; it returns after the copy has landed.
  __device__ __forceinline__ void load(const S* scal, S* sm) {
    for (int i = threadIdx.x; i < kN; i += blockDim.x) sm[i] = scal[i];
    __syncthreads();
    P0 = sm;
    h = kFilter ? sm + D * D : nullptr;
    r = kFilter ? sm[D * D + D] : S(0);
    c = sm + kC;
  }
};

template <typename S, int D, bool kFilter>
using SpectralScalars = TableScalars<S, D, kFilter, Spectral<D>>;

inline unsigned int n_blocks(long long n_chunks, int threads = kThreads) {
  return (unsigned int)((n_chunks + threads - 1) / threads);
}

// A block's shared-memory budget on an H100.
constexpr int kSmemLimit = 232448;    // a block's opt-in limit, bytes
constexpr int kSmemPerSM = 233472;    // an SM's shared memory, bytes
constexpr int kSmemReserved = 1024;   // the runtime's share of it for each block

// Warps a block of a stage of kBytesPerWarp bytes a warp and kBytesPerBlock
// more a block: of 1, 2, 4, the count whose blocks leave an SM the most warps
// by shared memory (kRes*), the larger on a tie, among those within a
// block's limit.  (Static members, not a constexpr function: nvcc keeps host
// functions out of device code.)
template <int kBytesPerWarp, int kBytesPerBlock = 0>
struct BlockWarps {
  static constexpr int kRes1 = kSmemPerSM / (kBytesPerWarp + kBytesPerBlock + kSmemReserved);
  static constexpr int kRes2 = 2 * kBytesPerWarp + kBytesPerBlock <= kSmemLimit
                                   ? 2 * (kSmemPerSM / (2 * kBytesPerWarp + kBytesPerBlock + kSmemReserved))
                                   : 0;
  static constexpr int kRes4 = 4 * kBytesPerWarp + kBytesPerBlock <= kSmemLimit
                                   ? 4 * (kSmemPerSM / (4 * kBytesPerWarp + kBytesPerBlock + kSmemReserved))
                                   : 0;
  static constexpr int kN = (kRes4 >= kRes2 && kRes4 >= kRes1) ? 4 : (kRes2 >= kRes1 ? 2 : 1);
};

// Bit D − 1 of a per-unit choice, kF32 for float and kF64 for double.
template <typename S, int D, unsigned kF32, unsigned kF64>
struct UnitBit {
  static constexpr bool kOn = (((sizeof(S) == 8 ? kF64 : kF32) >> (D - 1)) & 1u) != 0;
};

// Launches ``kern`` on ``blocks`` blocks of ``threads`` threads with ``bytes``
// of dynamic shared memory a block, opted in first (above the 48 KB default;
// up to 227 KB a block on an H100, static shared memory included); returns
// the opt-in's error or the launch's, so that a refused launch is reported.
template <typename Kern, typename... Args>
int launch_opted_in(Kern kern, dim3 blocks, int threads, int bytes, cudaStream_t st, Args... args) {
  const cudaError_t rc = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc != cudaSuccess) return (int)rc;
  kern<<<blocks, threads, bytes, st>>>(args...);
  return (int)cudaGetLastError();
}

// Blocks of ``kern``, launched as budget A says (A::kThreads threads and
// A::kBytes of dynamic shared memory a block), that an SM holds at once (the
// CUDA occupancy calculator: registers, shared memory, threads), or minus the
// error code.
template <typename A, typename Kern>
int blocks_per_sm(Kern kern) {
  int blocks = 0;
  cudaError_t rc = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, A::kBytes);
  if (rc == cudaSuccess) rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, A::kThreads, A::kBytes);
  return rc == cudaSuccess ? blocks : -(int)rc;
}

}  // namespace pgt

// Runs LAUNCH(S) for the scalar type asked for.
#define PGT_DISPATCH_TYPE(IS64, LAUNCH) \
  do {                                  \
    if (IS64) {                         \
      LAUNCH(double);                   \
    } else {                            \
      LAUNCH(float);                    \
    }                                   \
  } while (0)
