// The single-pass batched filter and smoother, hand-written for Hopper
// (sm_90a): B independent series (or B MCMC chains over one series) through
// ONE launch each, on time-last planes with a batch axis.
//
// Replaces parallel_gps_tpu/kalman/pallas_scan.py _batched_filter_kernel
// (:1271, pallas_call :1542) and _batched_smoother_kernel (:1385, pallas_call
// :1637).  What carries over from them is the contract — one launch per call,
// a running element carried across tiles of time inside the kernel, no
// host-side prefix between two passes, a per-series log-likelihood — and none
// of the TPU layout (8 series on sublanes, a flattened sequential grid, lane
// rolls, front padding for the reverse walk, a stash of the next block's
// boundary column, a batch padded to a multiple of 8).
//
// Design.  Every (series, tile) pair is a block of its own: a series of T
// steps is ceil(T / (NT·K)) tiles of NT threads × K steps, and the grid
// covers B × n_tiles blocks (4,096 at B = 64, T = 65,536 and tiles of
// 1,024).  A block takes its tile from an atomic ticket: ticket k is tile
// k / B of series k % B (counted from the series' end for the smoother), so
// the first wave spans every series and every tile a block waits on belongs
// to a block that already runs (tile_scan.cuh).  A block does its tile's own
// work before it waits on anything: each thread folds its K steps (the
// smoother backwards, its element at t reading F, Q at t + 1), and the block
// scans the NT thread totals in shared memory without a carry (block_scan:
// the tile's aggregate and each thread's in-tile exclusive prefix).  Then
// its first thread waits for the inclusive total of the tile just before it
// in scan order — of that tile alone — and publishes combine(that total,
// aggregate) as its own: a chained scan whose association, and so whose
// bits, do not depend on the order in which blocks ran (a decoupled
// look-back folds whatever predecessors have published when it polls, and
// its bits change from run to run).  Each thread then re-folds its steps
// seeded with combine(incl_prev, its exclusive prefix) and writes the
// moments.  Tails are handled by bounds: the last tile of a series is the
// short one, and only its last chunk is shorter than K.
//
// Rows: at the units of the kBatched*Staged masks each warp copies its 32
// chunks' input rows — the filter's F, Q and y (2D² + 1), the smoother's b,
// C, F and Q (3D² + D) — into shared memory as whole sectors (stage_rows,
// ChunkStage: a chunk is one round, one 32-byte sector of a row) once,
// folds and re-folds from there, the algebra reading F and Q where it uses
// them (Strided), writes each step's moments over the rows that step has
// consumed, and copies them out as whole sectors.  The smoother's step after
// a chunk (the next chunk's first) is read once, directly, into the pad of
// the lane's F, Q slots; its H-projections (mean, var) are stored directly.
// The other units read every step directly, each thread its own chunk's, in
// both folds (faster where a warp's stage would leave an SM one or two
// warps).  Each choice was measured a unit on an H100 (PERF.md §6).  At the
// units of the kBatched*Walk masks, where every chained form measured
// slower, the kernels are batched_walk.cuh's: one block a series.
//
// The filter's log-likelihood: each thread sums its steps' terms, the block
// its threads' in a fixed tree into parts[series, tile]; the last block of a
// series to finish (a per-series arrival counter after a fence, CUDA's
// threadFenceReduction pattern) sums the partials in tile order into
// ell[series].  No float atomics: two launches give the same bits.
//
// No hang: a wait is bounded (max_polls polls with __nanosleep back-off); on
// overrun it records status[1] and carries a NaN element, so that the series'
// later tiles and its ell are NaN and no successor waits forever; the
// wrapper raises.  Scratch, zeroed by the wrapper every call: status (ticket,
// overrun), flags (B × n_tiles), the filter's arrival counters (B); left as
// allocated: incl (B × n_tiles elements) and parts (B × n_tiles), each
// written before it is flagged or counted and read only after.
//
// Layouts: an operand with a batch axis is addressed as
// base + q·plane_stride + series·batch_stride + t; a batch stride of 0 shares
// one operand between all series (one model and B observation vectors, or one
// y for B chains) without expanding it.  Outputs are contiguous (D, B, T) and
// (D, D, B, T).  Filter scalars: (B, D²+D+1) rows [P0 | h | r]; the
// smoother's projection reads h as (B, D).  A missing observation is a NaN
// of y.
//
// What bounds these kernels on an H100: bytes, (2D²+1) values a step in and
// D+D² out for the filter, (3D²+D) in and D+D² [+2] out for the smoother
// (0.150 / 0.210 ms at B = 64, T = 65,536, D = 3, float32), read once with
// the stage.  Measured there on an NVIDIA H100 80GB HBM3 at 700 W: 0.46 and
// 0.39 device ms, 3.1× and 1.9× those bounds, against 1.39 and 1.34 ms for
// one block walking each series; a staged block of 104 KB (the filter)
// leaves an SM 8 warps, and the chain adds one poll, one load of an element
// from L2 and one combine a tile to each series' critical path.
//
// One translation unit per state dimension and scalar type: compile with
// -DPGT_D=<1..8> -DPGT_F64=<0|1> (kalman/_cuda.py); the entry points carry
// both in their names (pgt_batched_filter_d3_f32, ...).  The loops around the
// combines are kept rolled (#pragma unroll 1): unrolled, the D = 8 units
// would take minutes to compile.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "batched_walk.cuh"
#include "scan_passes.cuh"
#include "tile_scan.cuh"

#ifndef PGT_D
#error "compile with -DPGT_D=<state dimension, 1..8>"
#endif
#if PGT_D < 1 || PGT_D > 8
#error "PGT_D must be in 1..8"
#endif
#ifndef PGT_F64
#error "compile with -DPGT_F64=<0 for float, 1 for double>"
#endif

namespace pgt {

// The units (bit D − 1) that stage their rows, by pass and scalar type, where
// that measured faster on an H100 (PERF.md §6); the rest read them directly.
// kalman/batched.py: STAGED mirrors them.
constexpr unsigned kBatchedFilterStagedF32 = 0x5u;
constexpr unsigned kBatchedFilterStagedF64 = 0x3du;
constexpr unsigned kBatchedSmootherStagedF32 = 0x27u;
constexpr unsigned kBatchedSmootherStagedF64 = 0x7fu;
// The units that keep one block walking each series' tiles
// (batched_walk.cuh), where these chained kernels measured slower: ptxas
// gives them 32–64 registers and 100+ KB of spills (kalman/batched.py:
// WALK).
constexpr unsigned kBatchedFilterWalkF32 = 0x0u;
constexpr unsigned kBatchedFilterWalkF64 = 0xc0u;
constexpr unsigned kBatchedSmootherWalkF32 = 0x0u;
constexpr unsigned kBatchedSmootherWalkF64 = 0x80u;
// The smoother units whose combines are calls (__noinline__): inlined, ptxas
// gives the kernel 64 registers there (255 with the calls).
constexpr unsigned kBatchedSmootherCallsF32 = 0x0u;
constexpr unsigned kBatchedSmootherCallsF64 = 0x40u;
// Steps a thread of the units that read directly (kalman/batched.py:
// DIRECT_CHUNK) and of those that walk (WALK_CHUNK); a staged unit's chunk
// is one 32-byte sector of a row, 8 steps in float and 4 in double.
constexpr int kBatchedDirectChunk = 4;
constexpr int kBatchedWalkChunk = 8;

// A unit's tile: NT = kThreads threads of K = kK steps; shared memory a
// block, in values of S: the warps' stages (kRows rows each, ChunkStage's
// layout: a staged chunk is one round; none where the unit reads directly),
// the thread totals
// (kElem × NT, block_scan's; then the log-likelihood tree), the prefix
// (kElem) and the filter's scalars (kScal), then four ints (the ticket, and
// whether the tile has a prefix).  A block is 4, 2 or 1 warps, whichever
// leaves an SM the most warps by shared memory (BlockWarps).
template <typename S, int D, bool kFilter>
struct BatchedTile {
  static constexpr bool kWalk = kFilter ? UnitBit<S, D, kBatchedFilterWalkF32, kBatchedFilterWalkF64>::kOn
                                        : UnitBit<S, D, kBatchedSmootherWalkF32, kBatchedSmootherWalkF64>::kOn;
  static constexpr bool kStaged =
      !kWalk && (kFilter ? UnitBit<S, D, kBatchedFilterStagedF32, kBatchedFilterStagedF64>::kOn
                         : UnitBit<S, D, kBatchedSmootherStagedF32, kBatchedSmootherStagedF64>::kOn);
  static constexpr int kElem = kFilter ? ElementRows<D>::kFilt : ElementRows<D>::kSmooth;
  static constexpr int kScal = kFilter ? D * D + D + 1 : 0;
  static constexpr int kRows = !kStaged ? 0 : (kFilter ? 2 * D * D + 1 : 3 * D * D + D);
  static constexpr int kR = ChunkStage<S, 1>::kR;
  static constexpr int kK = kWalk ? kBatchedWalkChunk : (kStaged ? kR : kBatchedDirectChunk);
  static constexpr int kWarpValues = kRows * ChunkStage<S, 1>::kRow;  // a warp's stage
  static constexpr int kWarpBytes = (int)sizeof(S) * (kWarpValues + 32 * kElem);
  static constexpr int kBlockBytes = (int)sizeof(S) * (kElem + kScal) + 4 * (int)sizeof(int);
  static constexpr int kWarps = kWalk ? TileThreads<D>::kN / 32 : BlockWarps<kWarpBytes, kBlockBytes>::kN;
  static_assert(kWarpBytes + kBlockBytes <= kSmemLimit, "a batched unit's tile does not fit one warp a block");
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kTile = kThreads * kK;
  static constexpr int kBytes = kWalk ? (int)sizeof(S) * kElem * (kThreads + 1) : kWarps * kWarpBytes + kBlockBytes;
};

template <typename S, int D>
__device__ __noinline__ Smooth<S, D> smooth_combine_call(const Smooth<S, D>& a, const Smooth<S, D>& b) {
  return smooth_combine<S, D>(a, b);
}

// The smoother's combines: inlined, or calls at the units of
// kBatchedSmootherCalls*.
template <typename S, int D>
struct BatchedSmootherOps : SmootherOps<S, D> {
  __device__ static __forceinline__ Smooth<S, D> combine(const Smooth<S, D>& a, const Smooth<S, D>& b) {
    if constexpr (UnitBit<S, D, kBatchedSmootherCallsF32, kBatchedSmootherCallsF64>::kOn)
      return smooth_combine_call<S, D>(a, b);
    return smooth_combine<S, D>(a, b);
  }
};

template <typename S>
__device__ __forceinline__ S quiet_nan() {
  return S(__int_as_float(0x7fffffff));
}

// Every value of an element NaN: what a tile carries past an overrun wait.
template <typename S, typename E>
__device__ __forceinline__ void fill_nan(E& e) {
  S* v = reinterpret_cast<S*>(&e);
#pragma unroll
  for (int k = 0; k < (int)(sizeof(E) / sizeof(S)); ++k) v[k] = quiet_nan<S>();
}

// One series' filter scalars, read from shared memory where the algebra
// uses them (step_loglik, build_filtering: P0, h, r).
template <typename S, int D>
struct TileScalars {
  const S* P0;
  const S* h;
  S r;
};

// A thread's chunk of a filter tile: its steps' F, Q and y, in the lane's
// slots of the warp's stage (read by the algebra where it uses them,
// Strided) or in device memory.  Every member is inlined: a call, at D = 8
// in double, would put the chunk's state on the stack.
template <typename S, int D, typename U>
struct FilterChunk {
  typedef ChunkStage<S, D> G;
  static constexpr int kQ = D * D * G::kRow;  // the Q rows of a round; the y row at 2·kQ
  TileScalars<S, D> p;
  S* slots;  // the lane's slot of round 0
  const S* Ft;
  const S* Qt;
  const S* yt;
  long long f_ps, q_ps;
  long long v0;     // the chunk's first step in the tile
  bool has_first;   // the chunk holds the series' first step

  // Step u's filtering element and, with kLoglik, log p(y | the steps
  // before), against ``acc``, the moments before it.
  template <bool kLoglik>
  __device__ __forceinline__ S step(int u, const Filt<S, D>& acc, Filt<S, D>& e) const {
    if constexpr (U::kStaged) {
      const S* slot = slots + u;
      return element<kLoglik>(Strided<S, G::kRow>{slot}, Strided<S, G::kRow>{slot + kQ}, slot[2 * kQ], u, acc, e);
    } else {
      const long long v = v0 + u;
      S F[D * D], Q[D * D];
#pragma unroll
      for (int q = 0; q < D * D; ++q) {
        F[q] = Ft[q * f_ps + v];
        Q[q] = Qt[q * q_ps + v];
      }
      return element<kLoglik>(F, Q, yt[v], u, acc, e);
    }
  }

  template <bool kLoglik, typename M>
  __device__ __forceinline__ S element(const M& F, const M& Q, S yv, int u, const Filt<S, D>& acc,
                                       Filt<S, D>& e) const {
    const bool observed = !(yv != yv);  // NaN marks a missing observation
    const S yc = observed ? yv : S(0);
    const bool first = has_first && u == 0;
    build_filtering<S, D>(F, Q, yc, observed ? S(1) : S(0), p.h, p.r, p.P0, first, e);
    if constexpr (kLoglik) {
      if (observed) return step_loglik<S, D>(p, F, Q, yc, acc, first);
    }
    return S(0);
  }

  // Step u's b and C, over the stage rows it has consumed, or stored.
  __device__ __forceinline__ void put(int u, const Filt<S, D>& acc, S* bt, S* Ct, long long out_ps) const {
    if constexpr (U::kStaged) {
      S* slot = slots + u;
#pragma unroll
      for (int a = 0; a < D; ++a) slot[a * G::kRow] = acc.b[a];
#pragma unroll
      for (int q = 0; q < D * D; ++q) slot[(D + q) * G::kRow] = acc.C[q];
    } else {
#pragma unroll
      for (int a = 0; a < D; ++a) bt[a * out_ps + v0 + u] = acc.b[a];
#pragma unroll
      for (int q = 0; q < D * D; ++q) Ct[q * out_ps + v0 + u] = acc.C[q];
    }
  }
};

// A thread's chunk of a smoother tile: step t's smoothing element from b, C
// at t and F, Q at t + 1 — in the lane's slots of the warp's stage (the step
// after the chunk in the pad after its last step) or in device memory.
// Every member is inlined.
template <typename S, int D, typename U>
struct SmootherChunk {
  typedef ChunkStage<S, D> G;
  static constexpr int kF = (D + D * D) * G::kRow;  // the F rows of a round
  static constexpr int kQ = kF + D * D * G::kRow;   // the Q rows
  S* slots;  // the lane's slot of round 0
  const S* Ft;
  const S* Qt;
  const S* bt;
  const S* Ct;
  long long f_ps, q_ps, b_ps, c_ps;
  long long v0;
  int steps;
  int last;  // the series' last step's index in the chunk, or −1

  __device__ __forceinline__ void element(int u, Smooth<S, D>& e) const {
    S m[D], P[D * D];
    if constexpr (U::kStaged) {
      const S* at = slots + u;
#pragma unroll
      for (int a = 0; a < D; ++a) m[a] = at[a * G::kRow];
#pragma unroll
      for (int q = 0; q < D * D; ++q) P[q] = at[(D + q) * G::kRow];
      if (u == last) {
        build_smoothing_last<S, D>(m, P, e);
      } else {
        // F, Q of the next step: the next slot, or after the chunk's last
        // step the pad.
        build_smoothing<S, D>(Strided<S, G::kRow>{at + 1 + kF}, Strided<S, G::kRow>{at + 1 + kQ}, m, P, e);
      }
    } else {
      const long long v = v0 + u;
#pragma unroll
      for (int a = 0; a < D; ++a) m[a] = bt[a * b_ps + v];
#pragma unroll
      for (int q = 0; q < D * D; ++q) P[q] = Ct[q * c_ps + v];
      if (u == last) {
        build_smoothing_last<S, D>(m, P, e);
      } else {
        S Fn[D * D], Qn[D * D];
#pragma unroll
        for (int q = 0; q < D * D; ++q) {
          Fn[q] = Ft[q * f_ps + v + 1];
          Qn[q] = Qt[q * q_ps + v + 1];
        }
        build_smoothing<S, D>(Fn, Qn, m, P, e);
      }
    }
  }

  // Step u's g and L, over the stage rows it has consumed, or stored.
  __device__ __forceinline__ void put(int u, const Smooth<S, D>& acc, S* gt, S* Lt, long long out_ps) const {
    if constexpr (U::kStaged) {
      S* at = slots + u;
#pragma unroll
      for (int a = 0; a < D; ++a) at[a * G::kRow] = acc.g[a];
#pragma unroll
      for (int q = 0; q < D * D; ++q) at[(D + q) * G::kRow] = acc.L[q];
    } else {
#pragma unroll
      for (int a = 0; a < D; ++a) gt[a * out_ps + v0 + u] = acc.g[a];
#pragma unroll
      for (int q = 0; q < D * D; ++q) Lt[q * out_ps + v0 + u] = acc.L[q];
    }
  }
};

// The block's ticket: its (series, tile), tile counted from the series' end
// with ``reverse``.  Every thread of the block calls it.
__device__ __forceinline__ void take_ticket(int* status, int* meta, int B, long long n_tiles, bool reverse,
                                            long long& series, long long& tile) {
  if (threadIdx.x == 0) meta[0] = atomicAdd(status, 1);
  __syncthreads();
  const long long ticket = meta[0];
  series = ticket % B;
  tile = reverse ? n_tiles - 1 - ticket / B : ticket / B;
}

// The chain: the block's first thread waits for the inclusive total of the
// tile before it in scan order (``prev``, none for the first tile), publishes
// combine(that total, aggregate) as the tile's own, and leaves the total in
// prefix_sm with meta[1] = 1 (0 for the first tile).  After a spin of more
// than max_polls polls the total is NaN (status[1] records it).
template <typename S, typename Ops>
__device__ __forceinline__ void chain_tile(const typename Ops::Elem& aggregate, long long at, long long prev,
                                           int* flags, S* incl, int* status, long long max_polls, S* prefix_sm,
                                           int* meta) {
  typedef typename Ops::Elem E;
  constexpr int n = Ops::kRows;
  if (prev < 0) {
    publish<S, E>(incl + at * n, flags + at, kFlagIncl, aggregate);
    meta[1] = 0;
    return;
  }
  E before;
  if (wait_flag(flags + prev, status, max_polls))
    load_published<S, E>(incl + prev * n, before);
  else
    fill_nan<S, E>(before);
  publish<S, E>(incl + at * n, flags + at, kFlagIncl, Ops::combine(before, aggregate));
  store_rows<S, E>(prefix_sm, 1, 0, before);
  meta[1] = 1;
}

// The sum of one value a thread over the block (NT a power of two) in a
// fixed tree through red (NT values); thread 0 returns it.
template <typename S, int NT>
__device__ __forceinline__ S tree_sum(S value, S* red) {
  red[threadIdx.x] = value;
  __syncthreads();
#pragma unroll
  for (int s = NT / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  return red[0];
}

// ---------------------------------------------------------------------------
// Batched filter: filtering elements, their forward chained scan, the
// filtered b and C, and the per-series log-likelihood, one pass.
// ---------------------------------------------------------------------------
template <typename S, int D>
__global__ void __launch_bounds__(BatchedTile<S, D, true>::kThreads)
    batched_filter_kernel(const S* __restrict__ scal, const S* __restrict__ Fs, long long f_ps, long long f_bs,
                          const S* __restrict__ Qs, long long q_ps, long long q_bs, const S* __restrict__ y,
                          long long y_bs, S* __restrict__ b_out, S* __restrict__ C_out, S* __restrict__ ell,
                          long long T, int B, long long n_tiles, int* status, S* incl, S* parts,
                          long long max_polls) {
  typedef BatchedTile<S, D, true> U;
  typedef Filt<S, D> E;
  typedef FilterOps<S, D> Ops;
  typedef ChunkStage<S, D> G;
  constexpr int NT = U::kThreads, K = U::kK;
  S* stage = reinterpret_cast<S*>(pgt_batched_smem);
  S* sm = stage + U::kWarps * U::kWarpValues;
  S* prefix_sm = sm + U::kElem * NT;
  S* scal_sm = prefix_sm + U::kElem;
  int* meta = reinterpret_cast<int*>(scal_sm + U::kScal);
  int* flags = status + 2;
  int* arrivals = flags + (long long)B * n_tiles;
  const int tid = threadIdx.x, lane = tid & 31;

  long long series, tile;
  take_ticket(status, meta, B, n_tiles, false, series, tile);
  for (int i = tid; i < U::kScal; i += NT) scal_sm[i] = scal[series * U::kScal + i];
  const long long t0 = tile * U::kTile;
  const long long n = (T - t0 < U::kTile) ? T - t0 : U::kTile;  // steps of the tile
  const int n_chunks = (int)((n + K - 1) / K);
  const bool active = tid < n_chunks;
  const long long v0 = (long long)tid * K;                       // the chunk's first step in the tile
  const int steps = active ? (int)((n - v0 < K) ? n - v0 : K) : 0;
  const S* Ft = Fs + series * f_bs + t0;
  const S* Qt = Qs + series * q_bs + t0;
  const S* yt = y + series * y_bs + t0;
  const long long out_ps = (long long)B * T;  // plane stride of the outputs
  S* bt = b_out + series * T + t0;
  S* Ct = C_out + series * T + t0;
  S* wstage = stage + (tid >> 5) * U::kWarpValues;
  const long long c0 = tid - lane;  // the warp's first chunk
  if constexpr (U::kStaged) {
    stage_rows<S, true>(FilterPlaneRows<S, D>{Ft, Qt, yt, f_ps, q_ps}, wstage, c0, K, n, 0);
  }
  __syncthreads();  // the scalars, and every lane's copy in
  const FilterChunk<S, D, U> chunk{{scal_sm, scal_sm + D * D, scal_sm[D * D + D]},
                                   wstage + lane * G::kSlot, Ft, Qt, yt, f_ps, q_ps, v0, t0 + v0 == 0};

  // This thread's total: its steps folded in order.
  E mine;
#pragma unroll 1
  for (int u = 0; u < steps; ++u) {
    E e;
    chunk.template step<false>(u, mine, e);
    mine = u ? Ops::combine(mine, e) : e;
  }
  block_scan<S, NT, Ops>(mine, sm, n_chunks, false);
  E before;
  if (active && tid > 0) load_rows<S, E>(sm, NT, tid - 1, before);
  E aggregate;
  if (tid == 0) load_rows<S, E>(sm, NT, n_chunks - 1, aggregate);
  if (tid == 0) {
    const long long at = series * n_tiles + tile;
    chain_tile<S, Ops>(aggregate, at, tile > 0 ? at - 1 : -1, flags, incl, status, max_polls, prefix_sm, meta);
  }
  __syncthreads();

  // Re-fold seeded with combine(incl_prev, exclusive prefix): the moments and
  // the steps' log-likelihood.
  E acc;
  bool seeded = meta[1] != 0;
  if (seeded) load_rows<S, E>(prefix_sm, 1, 0, acc);
  if (active && tid > 0) {
    acc = seeded ? Ops::combine(acc, before) : before;
    seeded = true;
  }
  if (!seeded) filt_identity<S, D>(acc);
  S ll = S(0);
#pragma unroll 1
  for (int u = 0; u < steps; ++u) {
    E e;
    ll += chunk.template step<true>(u, acc, e);
    acc = (seeded || u) ? Ops::combine(acc, e) : e;
    chunk.put(u, acc, bt, Ct, out_ps);
  }
  if constexpr (U::kStaged) {
    __syncwarp();
    stage_rows<S, false>(MomentRows<S*, D>{bt, Ct, out_ps, out_ps}, wstage, c0, K, n, 0);
  }

  // The tile's share of the log-likelihood, then the series' in tile order.
  const S tile_ll = tree_sum<S, NT>(ll, sm);
  if (tid == 0) {
    const long long first = series * n_tiles;
    parts[first + tile] = tile_ll;
    __threadfence();
    if (atomicAdd(arrivals + series, 1) == n_tiles - 1) {
      __threadfence();
      S sum = S(0);
#pragma unroll 1
      for (long long j = 0; j < n_tiles; ++j) sum += __ldcg(parts + first + j);
      ell[series] = sum;
    }
  }
}

// ---------------------------------------------------------------------------
// Batched smoother: smoothing elements from F, Q at t+1 and the filtered
// (b, C) at t, their reverse chained scan, the smoothed g and L and, with
// PROJECT, the H-projections mean = h·g and var = hᵀ L h.  A thread's chunk
// runs forwards in time and is folded backwards; the block scan over the
// threads and the chain over the tiles run from later to earlier times.
// ---------------------------------------------------------------------------
template <typename S, int D, bool PROJECT>
__global__ void __launch_bounds__(BatchedTile<S, D, false>::kThreads)
    batched_smoother_kernel(const S* __restrict__ hs, const S* __restrict__ Fs, long long f_ps, long long f_bs,
                            const S* __restrict__ Qs, long long q_ps, long long q_bs, const S* __restrict__ b,
                            long long b_ps, long long b_bs, const S* __restrict__ C, long long c_ps, long long c_bs,
                            S* __restrict__ g_out, S* __restrict__ L_out, S* __restrict__ mean_out,
                            S* __restrict__ var_out, long long T, int B, long long n_tiles, int* status, S* incl,
                            long long max_polls) {
  typedef BatchedTile<S, D, false> U;
  typedef Smooth<S, D> E;
  typedef BatchedSmootherOps<S, D> Ops;
  typedef ChunkStage<S, D> G;
  constexpr int NT = U::kThreads, K = U::kK;
  constexpr int kF = (D + D * D) * G::kRow;  // the F rows of a round
  constexpr int kQ = kF + D * D * G::kRow;   // the Q rows
  S* stage = reinterpret_cast<S*>(pgt_batched_smem);
  S* sm = stage + U::kWarps * U::kWarpValues;
  S* prefix_sm = sm + U::kElem * NT;
  int* meta = reinterpret_cast<int*>(prefix_sm + U::kElem);
  int* flags = status + 2;
  const int tid = threadIdx.x, lane = tid & 31;

  long long series, tile;
  take_ticket(status, meta, B, n_tiles, true, series, tile);
  const long long t0 = tile * U::kTile;
  const long long n = (T - t0 < U::kTile) ? T - t0 : U::kTile;
  const int n_chunks = (int)((n + K - 1) / K);
  const bool active = tid < n_chunks;
  const long long v0 = (long long)tid * K;
  const int steps = active ? (int)((n - v0 < K) ? n - v0 : K) : 0;
  const S* Ft = Fs + series * f_bs + t0;
  const S* Qt = Qs + series * q_bs + t0;
  const S* bt = b + series * b_bs + t0;
  const S* Ct = C + series * c_bs + t0;
  const long long out_ps = (long long)B * T;
  S* gt = g_out + series * T + t0;
  S* Lt = L_out + series * T + t0;
  S h[D];
  if (PROJECT) {
#pragma unroll
    for (int a = 0; a < D; ++a) h[a] = hs[series * D + a];
  }
  S* wstage = stage + (tid >> 5) * U::kWarpValues;
  const long long c0 = tid - lane;
  if constexpr (U::kStaged) {
    stage_rows<S, true, SmootherPlaneRows<S, D>, false>(SmootherPlaneRows<S, D>{bt, Ct, Ft, Qt, b_ps, c_ps, f_ps, q_ps},
                                                        wstage, c0, K, n, 0);
    // The step after a whole chunk, read once, directly, into the pad after
    // the chunk's last step (a stage position no copy writes).
    if (steps == K && t0 + v0 + K < T) {
      S* pad = wstage + lane * G::kSlot + K;
#pragma unroll
      for (int q = 0; q < D * D; ++q) {
        pad[kF + q * G::kRow] = Ft[q * f_ps + v0 + K];
        pad[kQ + q * G::kRow] = Qt[q * q_ps + v0 + K];
      }
    }
    __pipeline_wait_prior(0);
    __syncwarp();
  }

  const long long last = T - 1 - t0 - v0;  // the series' last step in this chunk, if it is
  const SmootherChunk<S, D, U> chunk{wstage + lane * G::kSlot, Ft, Qt, bt, Ct, f_ps, q_ps, b_ps, c_ps, v0, steps,
                                     last < steps ? (int)last : -1};

  // This thread's suffix total: its steps folded from the last.
  E mine;
#pragma unroll 1
  for (int u = steps - 1; u >= 0; --u) {
    E e;
    chunk.element(u, e);
    mine = (u < steps - 1) ? Ops::combine(mine, e) : e;
  }
  block_scan<S, NT, Ops>(mine, sm, n_chunks, true);
  E before;
  const bool has_before = active && tid + 1 < n_chunks;
  if (has_before) load_rows<S, E>(sm, NT, tid + 1, before);
  E aggregate;
  if (tid == 0) load_rows<S, E>(sm, NT, 0, aggregate);
  if (tid == 0) {
    const long long at = series * n_tiles + tile;
    chain_tile<S, Ops>(aggregate, at, tile + 1 < n_tiles ? at + 1 : -1, flags, incl, status, max_polls, prefix_sm,
                       meta);
  }
  __syncthreads();

  E acc;
  bool seeded = meta[1] != 0;
  if (seeded) load_rows<S, E>(prefix_sm, 1, 0, acc);
  if (has_before) {
    acc = seeded ? Ops::combine(acc, before) : before;
    seeded = true;
  }
#pragma unroll 1
  for (int u = steps - 1; u >= 0; --u) {
    const long long v = v0 + u;
    E e;
    chunk.element(u, e);
    acc = (seeded || u < steps - 1) ? Ops::combine(acc, e) : e;
    chunk.put(u, acc, gt, Lt, out_ps);
    if (PROJECT) {
      S mean = h[0] * acc.g[0];
#pragma unroll
      for (int a = 1; a < D; ++a) mean += h[a] * acc.g[a];
      S var = S(0);
#pragma unroll
      for (int a = 0; a < D; ++a)
#pragma unroll
        for (int c = 0; c < D; ++c) var += h[a] * h[c] * acc.L[a * D + c];
      mean_out[series * T + t0 + v] = mean;
      var_out[series * T + t0 + v] = var;
    }
  }
  if constexpr (U::kStaged) {
    __syncwarp();
    stage_rows<S, false>(MomentRows<S*, D>{gt, Lt, out_ps, out_ps}, wstage, c0, K, n, 0);
  }
}

}  // namespace pgt

// C interface, bound with ctypes (kalman/_cuda.py), one set of entry points
// per state dimension and scalar type.  Each entry launches one kernel on the
// given stream, does not synchronise, and returns cudaGetLastError() (0 on
// success), the error of the shared-memory opt-in, or kBadArgs.
#if PGT_F64
typedef double pgt_scalar;
#define PGT_TYPE_TAG _f64
#else
typedef float pgt_scalar;
#define PGT_TYPE_TAG _f32
#endif
#define PGT_CAT2(a, b) a##b
#define PGT_CAT(a, b) PGT_CAT2(a, b)
#define PGT_ENTRY(name) PGT_CAT(PGT_CAT(PGT_CAT(name, _d), PGT_D), PGT_TYPE_TAG)

namespace {

typedef pgt::BatchedTile<pgt_scalar, PGT_D, true> FilterTile;
typedef pgt::BatchedTile<pgt_scalar, PGT_D, false> SmootherTile;

// Tiles of a series, or 0 where the grid would not fit an int.
long long n_tiles(long long T, int B, int tile) {
  const long long n = (T + tile - 1) / tile;
  return n * B > 0x7fffffffLL ? 0 : n;
}

template <typename A, typename Kern>
int tile_field(Kern kern, int field) {
  switch (field) {
    case 0: return A::kThreads;
    case 1: return A::kK;
    case 2: return A::kRows;
    case 3: return A::kBytes;
    default: return pgt::blocks_per_sm<A>(kern);
  }
}

// A unit's kernels: the chained tiles, or one block walking each series
// (Tile::kWalk).  Templates on the tile, so that only the unit's own kernel
// is compiled.
template <typename Tile>
int filter_field(int field) {
  if constexpr (Tile::kWalk)
    return tile_field<Tile>(pgt::batched_walk_filter_kernel<pgt_scalar, PGT_D, Tile::kThreads>, field);
  else
    return tile_field<Tile>(pgt::batched_filter_kernel<pgt_scalar, PGT_D>, field);
}

template <typename Tile>
int smoother_field(int field) {
  if constexpr (Tile::kWalk)
    return tile_field<Tile>(pgt::batched_walk_smoother_kernel<pgt_scalar, PGT_D, Tile::kThreads, false>, field);
  else
    return tile_field<Tile>(pgt::batched_smoother_kernel<pgt_scalar, PGT_D, false>, field);
}

template <typename Tile>
int launch_batched_filter(const void* scal, const void* Fs, long long f_ps, long long f_bs, const void* Qs,
                          long long q_ps, long long q_bs, const void* y, long long y_bs, void* b, void* C, void* ell,
                          long long T, int B, long long tiles, void* status, void* incl, void* parts,
                          long long max_polls, void* stream) {
  typedef pgt_scalar S;
  if constexpr (Tile::kWalk)
    return pgt::launch_opted_in(pgt::batched_walk_filter_kernel<S, PGT_D, Tile::kThreads>, dim3((unsigned int)B),
                                Tile::kThreads, Tile::kBytes, (cudaStream_t)stream, (const S*)scal, (const S*)Fs, f_ps,
                                f_bs, (const S*)Qs, q_ps, q_bs, (const S*)y, y_bs, (S*)b, (S*)C, (S*)ell, T, B,
                                Tile::kK);
  else
    return pgt::launch_opted_in(pgt::batched_filter_kernel<S, PGT_D>, dim3((unsigned int)(tiles * B)), Tile::kThreads,
                                Tile::kBytes, (cudaStream_t)stream, (const S*)scal, (const S*)Fs, f_ps, f_bs,
                                (const S*)Qs, q_ps, q_bs, (const S*)y, y_bs, (S*)b, (S*)C, (S*)ell, T, B, tiles,
                                (int*)status, (S*)incl, (S*)parts, max_polls);
}

template <typename Tile, bool PROJECT>
int launch_batched_smoother(const void* h, const void* Fs, long long f_ps, long long f_bs, const void* Qs,
                            long long q_ps, long long q_bs, const void* b, long long b_ps, long long b_bs,
                            const void* C, long long c_ps, long long c_bs, void* g, void* L, void* mean, void* var,
                            long long T, int B, long long tiles, void* status, void* incl, long long max_polls,
                            void* stream) {
  typedef pgt_scalar S;
  if constexpr (Tile::kWalk)
    return pgt::launch_opted_in(pgt::batched_walk_smoother_kernel<S, PGT_D, Tile::kThreads, PROJECT>,
                                dim3((unsigned int)B), Tile::kThreads, Tile::kBytes, (cudaStream_t)stream, (const S*)h,
                                (const S*)Fs, f_ps, f_bs, (const S*)Qs, q_ps, q_bs, (const S*)b, b_ps, b_bs,
                                (const S*)C, c_ps, c_bs, (S*)g, (S*)L, (S*)mean, (S*)var, T, B, Tile::kK);
  else
    return pgt::launch_opted_in(pgt::batched_smoother_kernel<S, PGT_D, PROJECT>, dim3((unsigned int)(tiles * B)),
                                Tile::kThreads, Tile::kBytes, (cudaStream_t)stream, (const S*)h, (const S*)Fs, f_ps,
                                f_bs, (const S*)Qs, q_ps, q_bs, (const S*)b, b_ps, b_bs, (const S*)C, c_ps, c_bs,
                                (S*)g, (S*)L, (S*)mean, (S*)var, T, B, tiles, (int*)status, (S*)incl, max_polls);
}

}  // namespace

extern "C" {

// This unit's tile, by pass (smoother = 0 the filter, 1 the smoother):
// field 0 threads a block, 1 steps a thread, 2 rows a warp stages (0: read
// directly), 3 dynamic shared memory a block in bytes, 4 blocks an SM holds
// (the occupancy calculator; minus an error code).
int PGT_ENTRY(pgt_batched_tile)(int smoother, int field) {
  return smoother ? smoother_field<SmootherTile>(field) : filter_field<FilterTile>(field);
}

// scal: (B, D²+D+1) rows [P0 | h | r]; Fs, Qs: element (q, series, t) at
// q·ps + series·bs + t; y: series·y_bs + t; b (D, B, T), C (D, D, B, T),
// ell (B,) contiguous; status: int (2 + B·n_tiles + B: ticket, overrun,
// flags, arrivals), zeroed; incl: (B·n_tiles, 3D²+2D) and parts (B·n_tiles)
// need not be; n_tiles = ceil(T / (threads · steps)).
int PGT_ENTRY(pgt_batched_filter)(const void* scal, const void* Fs, long long f_ps, long long f_bs, const void* Qs,
                                  long long q_ps, long long q_bs, const void* y, long long y_bs, void* b, void* C,
                                  void* ell, long long T, int B, void* status, void* incl, void* parts,
                                  long long max_polls, void* stream) {
  if (T < 1 || B < 1 || max_polls < 0) return pgt::kBadArgs;
  const long long tiles = n_tiles(T, B, FilterTile::kTile);
  if (tiles < 1) return pgt::kBadArgs;
  return launch_batched_filter<FilterTile>(scal, Fs, f_ps, f_bs, Qs, q_ps, q_bs, y, y_bs, b, C, ell, T, B, tiles, status,
                                           incl, parts, max_polls, stream);
}

// h: (B, D), read with project only; b, C like Fs with their own strides;
// g (D, B, T), L (D, D, B, T) and, with project, mean and var (B, T),
// contiguous; status: int (2 + B·n_tiles: ticket, overrun, flags), zeroed;
// incl: (B·n_tiles, 2D²+D) need not be.
int PGT_ENTRY(pgt_batched_smoother)(int project, const void* h, const void* Fs, long long f_ps, long long f_bs,
                                    const void* Qs, long long q_ps, long long q_bs, const void* b, long long b_ps,
                                    long long b_bs, const void* C, long long c_ps, long long c_bs, void* g, void* L,
                                    void* mean, void* var, long long T, int B, void* status, void* incl,
                                    long long max_polls, void* stream) {
  if (T < 1 || B < 1 || max_polls < 0) return pgt::kBadArgs;
  const long long tiles = n_tiles(T, B, SmootherTile::kTile);
  if (tiles < 1) return pgt::kBadArgs;
  return project ? launch_batched_smoother<SmootherTile, true>(h, Fs, f_ps, f_bs, Qs, q_ps, q_bs, b, b_ps, b_bs, C,
                                                               c_ps, c_bs, g, L, mean, var, T, B, tiles, status, incl,
                                                               max_polls, stream)
                 : launch_batched_smoother<SmootherTile, false>(h, Fs, f_ps, f_bs, Qs, q_ps, q_bs, b, b_ps, b_bs, C,
                                                                c_ps, c_bs, g, L, mean, var, T, B, tiles, status, incl,
                                                                max_polls, stream);
}

}  // extern "C"
