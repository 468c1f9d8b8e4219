// What the two-pass kernel sources share on the launch side: the block size,
// the scalar tables a dt kernel reads its model from, the argument check, the
// dispatch on scalar type and state dimension, and the launch with opted-in
// shared memory.
#pragma once

#include <cuda_runtime.h>

#include "dt_elements.cuh"

namespace pgt {

constexpr int kThreads = 128;
constexpr int kBadArgs = -1;

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

inline bool bad_shape(int d, int degree, long long T, int K) {
  return d < 1 || d > 3 || degree < 0 || degree > d - 1 || T < 1 || K < 1;
}

inline unsigned int n_blocks(long long n_chunks, int threads = kThreads) {
  return (unsigned int)((n_chunks + threads - 1) / threads);
}

// Launches ``kern`` on ``blocks`` blocks of ``threads`` threads with ``bytes``
// of dynamic shared memory a block, opted in first (above the 48 KB default;
// up to 227 KB a block on an H100, static shared memory included); returns
// the opt-in's error or the launch's, so that a refused launch is reported.
template <typename Kern, typename... Args>
int launch_opted_in(Kern kern, unsigned int blocks, int threads, int bytes, cudaStream_t st, Args... args) {
  const cudaError_t rc = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc != cudaSuccess) return (int)rc;
  kern<<<blocks, threads, bytes, st>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace pgt

// Runs LAUNCH(S, D) for the scalar type and state dimension asked for.
#define PGT_DISPATCH(IS64, D, LAUNCH)   \
  do {                                  \
    if (IS64) {                         \
      if ((D) == 1) {                   \
        LAUNCH(double, 1);              \
      } else if ((D) == 2) {            \
        LAUNCH(double, 2);              \
      } else {                          \
        LAUNCH(double, 3);              \
      }                                 \
    } else {                            \
      if ((D) == 1) {                   \
        LAUNCH(float, 1);               \
      } else if ((D) == 2) {            \
        LAUNCH(float, 2);               \
      } else {                          \
        LAUNCH(float, 3);               \
      }                                 \
    }                                   \
  } while (0)
