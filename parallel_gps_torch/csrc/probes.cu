// Probe kernels, hand-written for Hopper (sm_90a): what the access patterns
// of the port's kernels cost on the card, apart from their algebra.  They
// replace the Pallas kernels of the repository's three probe programs:
//
//   copy_*  scripts/bench_dma_probe.py copy_kernel (:56; pallas_call :69,
//           strided tiles, and :93, blocked tiles): a pure copy;
//   read_*  scripts/bench_r4_attrib.py read_kernel (:98; pallas_call :118):
//           the read floor of a strip-filter pass;
//   tile_*  scripts/bench_grid_isolation.py k_noop (:102), k_stream (:105),
//           k_carry (:109), k_outwrite (:123), passed to run (:76;
//           pallas_call :90): the cost of a block against its tile length.
//
// The Pallas bodies compute throw-away values; each kernel here computes a
// defined result instead, so that it can be held against its plain PyTorch
// version (parallel_gps_torch/probes/), and none reads less than the Pallas
// probe moved.  Every sum is taken in one fixed order (a thread's steps in
// sequence, then a tree over the block, as scan_passes.cuh::block_sum), which
// the plain versions repeat, so the two agree bit for bit.
//
// Bound: all of them move bytes and do next to no arithmetic, so device
// memory bounds them (3.35 TB/s on an H100 SXM); what they measure is how
// far each access pattern stays from it.  Layouts: rows of T steps, row-major
// (row r, step t at r*T + t), as the port holds its planes ((d, d, T) is
// d*d rows).  f32 and f64 instantiations.
#include <cuda_runtime.h>

namespace pgt_probe {

// Threads per block of the chunk pattern: the two-pass kernels' block
// (dt_launch.cuh: kThreads), one thread per chunk of K steps.
constexpr int kChunkThreads = 128;
// Threads per block of the coalesced copies and the tile probes.
constexpr int kTileThreads = 256;
constexpr int kBadArgs = -1;

template <typename S>
struct Vec;
// 16-byte vectors: kWidth values each.
template <>
struct Vec<float> {
  using type = float4;
  static constexpr int kWidth = 4;
};
template <>
struct Vec<double> {
  using type = double2;
  static constexpr int kWidth = 2;
};

// Sum of one value per thread over the block in a fixed tree; red[0] holds
// it on return.  Every thread of the block calls it.
template <typename S, int N>
__device__ __forceinline__ void tree_sum(S value, S* red) {
  red[threadIdx.x] = value;
  __syncthreads();
#pragma unroll
  for (int s = N / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// Copies of an (n, T) buffer (bench_dma_probe.py).
// ---------------------------------------------------------------------------

// The two-pass kernels' pattern: thread c copies steps [cK, cK + K) of every
// row, a step at a time, so neighbouring threads touch addresses K values
// apart.
template <typename S>
__global__ void __launch_bounds__(kChunkThreads)
    copy_chunk_kernel(const S* __restrict__ src, S* __restrict__ dst, int n, long long T, int K, long long n_chunks) {
  const long long c = (long long)blockIdx.x * kChunkThreads + threadIdx.x;
  if (c >= n_chunks) return;
  const long long t0 = c * K;
  const long long t1 = (t0 + K < T) ? t0 + K : T;
  for (long long t = t0; t < t1; ++t)
    for (int r = 0; r < n; ++r) dst[r * T + t] = src[r * T + t];
}

// Neighbouring threads take neighbouring 16-byte vectors of the flat buffer;
// the first threads also take the values past the last whole vector.
template <typename S>
__global__ void __launch_bounds__(kTileThreads)
    copy_coalesced_kernel(const S* __restrict__ src, S* __restrict__ dst, long long N) {
  using V = typename Vec<S>::type;
  const long long i = (long long)blockIdx.x * kTileThreads + threadIdx.x;
  const long long n_vec = N / Vec<S>::kWidth;
  if (i < n_vec) reinterpret_cast<V*>(dst)[i] = reinterpret_cast<const V*>(src)[i];
  const long long tail = n_vec * Vec<S>::kWidth;
  if (i < N - tail) dst[tail + i] = src[tail + i];
}

// The Pallas probe's blocked layout (n_tiles, n, tile): one block copies one
// contiguous tile of n * tile values (a multiple of the vector width).
template <typename S>
__global__ void __launch_bounds__(kTileThreads)
    copy_blocked_kernel(const S* __restrict__ src, S* __restrict__ dst, long long tile_values) {
  using V = typename Vec<S>::type;
  const long long n_vec = tile_values / Vec<S>::kWidth;
  const V* s = reinterpret_cast<const V*>(src + (long long)blockIdx.x * tile_values);
  V* d = reinterpret_cast<V*>(dst + (long long)blockIdx.x * tile_values);
  for (long long j = threadIdx.x; j < n_vec; j += kTileThreads) d[j] = s[j];
}

// ---------------------------------------------------------------------------
// Read floor of a strip-filter pass (bench_r4_attrib.py): F and Q (d2 rows
// each) and y, read once.  A step's value is the sum of its d2 F values, then
// its d2 Q values, then y and 1 where y is observed (NaN = missing: nothing),
// as the Pallas read_kernel sums F, Q, y and the mask.  Block b owns steps
// [b * kChunkThreads * K, (b + 1) * kChunkThreads * K) in both patterns and
// writes their sum to parts[b].
// ---------------------------------------------------------------------------

template <typename S>
__device__ __forceinline__ S step_value(const S* __restrict__ F, const S* __restrict__ Q, const S* __restrict__ y,
                                        int d2, long long T, long long t) {
  S s = F[t];
  for (int q = 1; q < d2; ++q) s += F[q * T + t];
  for (int q = 0; q < d2; ++q) s += Q[q * T + t];
  const S yv = y[t];
  if (!isnan(yv)) {
    s += yv;
    s += S(1);
  }
  return s;
}

// Thread j of block b sums K steps of the block's range: in the strip
// kernels' chunk pattern, steps [cK, cK + K) of chunk c = b * kChunkThreads + j
// in order; coalesced, steps j, j + kChunkThreads, ..., so a warp reads 32
// neighbouring steps of each row at once.
template <typename S, bool kCoalesced>
__global__ void __launch_bounds__(kChunkThreads)
    read_kernel(const S* __restrict__ F, const S* __restrict__ Q, const S* __restrict__ y, S* __restrict__ parts,
                int d2, long long T, int K) {
  __shared__ S red[kChunkThreads];
  const long long first = (long long)blockIdx.x * kChunkThreads * K;
  const long long base = kCoalesced ? first + threadIdx.x : first + (long long)threadIdx.x * K;
  S acc = S(0);
  for (int i = 0; i < K; ++i) {
    const long long t = base + (kCoalesced ? (long long)i * kChunkThreads : (long long)i);
    if (t < T) acc += step_value(F, Q, y, d2, T, t);
  }
  tree_sum<S, kChunkThreads>(acc, red);
  if (threadIdx.x == 0) parts[blockIdx.x] = red[0];
}

// ---------------------------------------------------------------------------
// Tile probes (bench_grid_isolation.py): block b owns steps
// [b * tile, (b + 1) * tile), tile a multiple of kTileThreads; thread j reads
// steps j, j + kTileThreads, ... of it (coalesced), each step's rows in order.
// ---------------------------------------------------------------------------

// Sum of the tile's values over `rows` rows, in the thread-then-tree order.
template <typename S>
__device__ __forceinline__ S tile_sum(const S* __restrict__ x, int rows, long long T, int tile, long long b, S* red) {
  S acc = S(0);
  for (int i = 0; i < tile / kTileThreads; ++i) {
    const long long t = b * tile + (long long)i * kTileThreads + threadIdx.x;
    if (t < T)
      for (int r = 0; r < rows; ++r) acc += x[r * T + t];
  }
  tree_sum<S, kTileThreads>(acc, red);
  return red[0];
}

// k_noop: each block writes one value, 1.
template <typename S>
__global__ void __launch_bounds__(kTileThreads) tile_noop_kernel(S* __restrict__ out) {
  if (threadIdx.x == 0) out[blockIdx.x] = S(1);
}

// k_stream: each block reads its tile of `rows` rows and writes their sum.
template <typename S>
__global__ void __launch_bounds__(kTileThreads)
    tile_stream_kernel(const S* __restrict__ x, S* __restrict__ parts, int rows, long long T, int tile) {
  __shared__ S red[kTileThreads];
  const S s = tile_sum(x, rows, T, tile, blockIdx.x, red);
  if (threadIdx.x == 0) parts[blockIdx.x] = s;
}

// k_outwrite: reads 3 rows, writes row 0 to the 12 rows of out12 and the
// tile's sum of the 3 rows to parts.
template <typename S>
__global__ void __launch_bounds__(kTileThreads)
    tile_outwrite_kernel(const S* __restrict__ x, S* __restrict__ out12, S* __restrict__ parts, long long T, int tile) {
  __shared__ S red[kTileThreads];
  S acc = S(0);
  for (int i = 0; i < tile / kTileThreads; ++i) {
    const long long t = (long long)blockIdx.x * tile + (long long)i * kTileThreads + threadIdx.x;
    if (t < T) {
      const S x0 = x[t];
      acc += x0;
      acc += x[T + t];
      acc += x[2 * T + t];
#pragma unroll
      for (int k = 0; k < 12; ++k) out12[k * T + t] = x0;
    }
  }
  tree_sum<S, kTileThreads>(acc, red);
  if (threadIdx.x == 0) parts[blockIdx.x] = red[0];
}

// k_carry: a carry across tiles.  On the card blocks run in no order, so one
// block walks the tiles in order (as the batched kernels walk a series): for
// each it reads the tile's row, adds k to carry value k behind a barrier, and
// writes the tile's sum plus carry value 32; the carry ends at k * n_tiles.
template <typename S>
__global__ void __launch_bounds__(kTileThreads)
    tile_carry_kernel(const S* __restrict__ x, S* __restrict__ out, S* __restrict__ carry_out, long long T, int tile,
                      long long n_tiles) {
  __shared__ S red[kTileThreads];
  __shared__ S carry[33];
  if (threadIdx.x < 33) carry[threadIdx.x] = S(0);
  for (long long b = 0; b < n_tiles; ++b) {
    const S s = tile_sum(x, 1, T, tile, b, red);
    if (threadIdx.x < 33) carry[threadIdx.x] += S(threadIdx.x);
    __syncthreads();
    if (threadIdx.x == 0) out[b] = s + carry[32];
    __syncthreads();
  }
  if (threadIdx.x < 33) carry_out[threadIdx.x] = carry[threadIdx.x];
}

inline unsigned int blocks_for(long long work, int per_block) { return (unsigned int)((work + per_block - 1) / per_block); }

}  // namespace pgt_probe

// C interface, bound with ctypes (kalman/_cuda.py).  Each entry launches one
// kernel on the given stream (is64: double, else float), does not
// synchronise, and returns cudaGetLastError() (0 on success) or kBadArgs.
extern "C" {

#define PGT_PROBE_DISPATCH(IS64, LAUNCH) \
  do {                                   \
    if (IS64) {                          \
      LAUNCH(double);                    \
    } else {                             \
      LAUNCH(float);                     \
    }                                    \
  } while (0)

int pgt_probe_copy_chunk(int is64, const void* src, void* dst, int n, long long T, int K, void* stream) {
  if (n < 1 || T < 1 || K < 1) return pgt_probe::kBadArgs;
  const long long n_chunks = (T + K - 1) / K;
#define PGT_LAUNCH(S)                                                                                            \
  pgt_probe::copy_chunk_kernel<S><<<pgt_probe::blocks_for(n_chunks, pgt_probe::kChunkThreads),                   \
                                    pgt_probe::kChunkThreads, 0, (cudaStream_t)stream>>>((const S*)src, (S*)dst, n, \
                                                                                         T, K, n_chunks)
  PGT_PROBE_DISPATCH(is64, PGT_LAUNCH);
#undef PGT_LAUNCH
  return (int)cudaGetLastError();
}

int pgt_probe_copy_coalesced(int is64, const void* src, void* dst, long long N, void* stream) {
  if (N < 1) return pgt_probe::kBadArgs;
  // One thread a whole vector, at least as many threads as tail values.
  const long long n_vec = N / (is64 ? 2 : 4);
  const unsigned int n_blocks = pgt_probe::blocks_for(n_vec > 4 ? n_vec : 4, pgt_probe::kTileThreads);
#define PGT_LAUNCH(S)                                                                                      \
  pgt_probe::copy_coalesced_kernel<S><<<n_blocks, pgt_probe::kTileThreads, 0, (cudaStream_t)stream>>>(     \
      (const S*)src, (S*)dst, N)
  PGT_PROBE_DISPATCH(is64, PGT_LAUNCH);
#undef PGT_LAUNCH
  return (int)cudaGetLastError();
}

int pgt_probe_copy_blocked(int is64, const void* src, void* dst, long long n_tiles, long long tile_values,
                           void* stream) {
  if (n_tiles < 1 || tile_values < 1 || tile_values % (is64 ? 2 : 4) != 0) return pgt_probe::kBadArgs;
#define PGT_LAUNCH(S)                                                                                      \
  pgt_probe::copy_blocked_kernel<S><<<(unsigned int)n_tiles, pgt_probe::kTileThreads, 0, (cudaStream_t)stream>>>( \
      (const S*)src, (S*)dst, tile_values)
  PGT_PROBE_DISPATCH(is64, PGT_LAUNCH);
#undef PGT_LAUNCH
  return (int)cudaGetLastError();
}

// coalesced: 1 for the coalesced pattern, 0 for the chunk pattern.
int pgt_probe_read(int is64, int coalesced, const void* F, const void* Q, const void* y, void* parts, int d2,
                   long long T, int K, void* stream) {
  if (d2 < 1 || T < 1 || K < 1) return pgt_probe::kBadArgs;
  const unsigned int n_blocks = pgt_probe::blocks_for(T, pgt_probe::kChunkThreads * K);
#define PGT_LAUNCH_PATTERN(S, C)                                                                          \
  pgt_probe::read_kernel<S, C><<<n_blocks, pgt_probe::kChunkThreads, 0, (cudaStream_t)stream>>>(          \
      (const S*)F, (const S*)Q, (const S*)y, (S*)parts, d2, T, K)
#define PGT_LAUNCH(S)                \
  if (coalesced) {                   \
    PGT_LAUNCH_PATTERN(S, true);     \
  } else {                           \
    PGT_LAUNCH_PATTERN(S, false);    \
  }
  PGT_PROBE_DISPATCH(is64, PGT_LAUNCH);
#undef PGT_LAUNCH
#undef PGT_LAUNCH_PATTERN
  return (int)cudaGetLastError();
}

int pgt_probe_tile_noop(int is64, void* out, long long n_tiles, void* stream) {
  if (n_tiles < 1) return pgt_probe::kBadArgs;
#define PGT_LAUNCH(S)                                                                                        \
  pgt_probe::tile_noop_kernel<S><<<(unsigned int)n_tiles, pgt_probe::kTileThreads, 0, (cudaStream_t)stream>>>( \
      (S*)out)
  PGT_PROBE_DISPATCH(is64, PGT_LAUNCH);
#undef PGT_LAUNCH
  return (int)cudaGetLastError();
}

static bool bad_tile(long long T, int tile) {
  return T < 1 || tile < pgt_probe::kTileThreads || tile % pgt_probe::kTileThreads != 0;
}

int pgt_probe_tile_stream(int is64, const void* x, void* parts, int rows, long long T, int tile, void* stream) {
  if (rows < 1 || bad_tile(T, tile)) return pgt_probe::kBadArgs;
#define PGT_LAUNCH(S)                                                                                          \
  pgt_probe::tile_stream_kernel<S><<<pgt_probe::blocks_for(T, tile), pgt_probe::kTileThreads, 0,               \
                                     (cudaStream_t)stream>>>((const S*)x, (S*)parts, rows, T, tile)
  PGT_PROBE_DISPATCH(is64, PGT_LAUNCH);
#undef PGT_LAUNCH
  return (int)cudaGetLastError();
}

int pgt_probe_tile_outwrite(int is64, const void* x, void* out12, void* parts, long long T, int tile, void* stream) {
  if (bad_tile(T, tile)) return pgt_probe::kBadArgs;
#define PGT_LAUNCH(S)                                                                                          \
  pgt_probe::tile_outwrite_kernel<S><<<pgt_probe::blocks_for(T, tile), pgt_probe::kTileThreads, 0,             \
                                       (cudaStream_t)stream>>>((const S*)x, (S*)out12, (S*)parts, T, tile)
  PGT_PROBE_DISPATCH(is64, PGT_LAUNCH);
#undef PGT_LAUNCH
  return (int)cudaGetLastError();
}

int pgt_probe_tile_carry(int is64, const void* x, void* out, void* carry, long long T, int tile, void* stream) {
  if (bad_tile(T, tile)) return pgt_probe::kBadArgs;
  const long long n_tiles = (T + tile - 1) / tile;
#define PGT_LAUNCH(S)                                                                                      \
  pgt_probe::tile_carry_kernel<S><<<1, pgt_probe::kTileThreads, 0, (cudaStream_t)stream>>>((const S*)x, (S*)out, \
                                                                                           (S*)carry, T, tile, n_tiles)
  PGT_PROBE_DISPATCH(is64, PGT_LAUNCH);
#undef PGT_LAUNCH
  return (int)cudaGetLastError();
}

#undef PGT_PROBE_DISPATCH

}  // extern "C"
