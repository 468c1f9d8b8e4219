// The single-pass plane scan and the tiled plane transpose, hand-written for
// Hopper (sm_90a): the kernels of the time-first fused Kalman path
// (kalman/plane.py; pkf / pks / pkfs on an LGSSM with engine="strip").
//
// Replaces parallel_gps_tpu/kalman/pallas_scan.py _carry_scan_kernel (:428,
// pallas_call :514, behind pallas_plane_scan :464), with _local_scan_kernel
// (:410, the in-block Kogge–Stone that no pallas_call reaches) as its device
// function block_scan, and _transpose_kernel (:531, pallas_call :553, behind
// plane_transpose :535).
//
// plane_scan computes what pallas_plane_scan returns: the inclusive scan of
// packed element rows (n, T) — filtering rows [A | b | C | J | η], n = 3D²+2D,
// or smoothing rows [E | g | L], n = 2D²+D — forwards, or backwards with
// ``reverse``.  The argument order of the combine is the TPU kernel's:
// combine(earlier, later) in scan order, within a tile and across tiles.
// What carries over is the contract: one read and one write of the planes,
// one launch, no host step between passes.  None of the TPU layout does: no
// identity padding to a block multiple, no lane rolls or masks, no (n, 128)
// carry.
//
// What bounds it on an H100: bytes.  At N = 10M, D = 3, float32 the filter
// moves 33 rows in and 33 out (2.64 GB, 0.788 ms at 3.35 TB/s) against about
// 0.06 ms of operations (one filt_combine a step); the smoother 21 + 21 rows
// (1.68 GB, 0.501 ms).
//
// Design.
//  - Several steps a thread.  A block of NT threads (TileThreads: 128 / 64 /
//    32 at D ≤ 3 / ≤ 5 / ≤ 8) owns a tile of NT·Steps consecutive steps
//    (PlaneSteps below).  With Steps = 1 thread i loads column t0 + i of each
//    row into registers; with Steps > 1 the block copies the tile into shared
//    memory, a step a thread, every copy in flight at once (cp.async), and
//    thread i folds its Steps consecutive steps there.  Either way a warp
//    reads 32 consecutive values of a row and every access to device memory
//    is coalesced (a thread walking its own K steps of a row costs 38× the
//    coalesced copy on this card).  Steps past T are never combined.
//  - block_scan (the port of _local_scan_kernel): Kogge–Stone over the NT
//    thread totals in shared memory, log2 NT rounds; each reads its partner,
//    synchronises, combines and writes.  The tile's last thread total (first,
//    for reverse) is its aggregate.  With Steps > 1 each thread then re-folds
//    its steps seeded with its exclusive prefix (the tile's prefix and the
//    thread totals before it), writes them back to shared memory, and the
//    block copies the tile out as it came in.
//  - A decoupled look-back across tiles, the card's form of the TPU kernel's
//    carried sequential grid.  A block takes its tile from an atomic ticket
//    (for reverse, ticket k is tile n_tiles−1−k), so every tile it waits on
//    belongs to a block that already runs.  Its first warp publishes the
//    tile's aggregate (values, fence, flag AGG) and looks back 32
//    predecessors at a time: lane i polls the flag of the (i+1)-th, until
//    every flag up to the nearest INCL is set; that INCL ends the look-back;
//    the lanes up to it load their AGG or INCL (from L2) and fold them in a
//    tree that keeps the scan order, the earlier element always on the left
//    (5 dependent combines for 32 predecessors, where one thread walking
//    them spends one a predecessor); a window with no INCL is folded whole
//    and the next 32 are polled.  It then publishes the tile's inclusive
//    total (INCL), and every thread folds the prefix into its steps.  The
//    first tile in scan order publishes INCL at once.  In the units where
//    kWarpLookBack is false the block's first thread alone does the same,
//    one predecessor at a time, nearest first, up to the first INCL.
//    Why not one block walking the tiles in order, as the TPU grid does: on
//    this card one block walking tiles costs 0.687 µs a tile before any
//    algebra, and about 25 µs a tile of 1,024 steps with the D = 3 algebra
//    (the batched filter: 1.625 ms for 64 such tiles a block).  One series of
//    N = 10M is 9,766 such tiles, about 250 ms on one of the 132 SMs, four
//    times the whole two-pass pkfs on the same model (63.8 ms).
//    What the look-back costs, at N = 10M, D = 3, float32 on an NVIDIA H100
//    80GB HBM3 at 700 W (filter / smoother rows): with one step a thread and
//    one thread walking the predecessors, 7.968 / 5.256 ms (78,125 tiles,
//    25.46 / 34.70 predecessors folded a tile), ten times the bound: a block
//    stays resident through its look-back, a dependent poll, load and
//    combine a predecessor.  The warp's look-back alone (one step a thread):
//    6.5 / 3.3 ms, 63 / 90 predecessors a tile.  Four steps a thread, the
//    tile copied in by cp.async: 1.9–2.0 / 1.0 device ms (19,532 tiles,
//    44–52 / 70–71 predecessors a tile); two steps: 3.8 / 1.8 ms; four steps
//    with one thread walking: 2.8 / 1.5 ms (19 / 29 a tile).  Wider states
//    (N = 1M float32 RBF rows): the warp's look-back is 1.3× as fast as the
//    one-thread walk at D = 4 (both kinds), 2× as fast on D = 7, 8 filter
//    rows, 8–23% faster on D = 5, 6 smoother rows, and 14–30% behind it on
//    D = 5, 6 filter and D = 7, 8 smoother rows (every filter unit spills
//    there; the split follows neither the element's size nor its spills).  So each
//    kind's units take the faster one (kWarpLookBack): one thread walking
//    on D = 5, 6 filter and D = 7, 8 smoother rows, the warp elsewhere
//    (double units take the same split; measured in double at D = 3 only,
//    where the warp's is 1.4× / 1.7× as fast with one step a thread).
//  - No hang.  A spin is bounded (max_polls polls of a window with
//    __nanosleep back-off); on overrun the kernel sets status[1], publishes
//    what it has so that no other block waits on it, and the wrapper raises.
//  - Scratch: status (ticket, error, predecessors folded by all look-backs
//    together) and flags (n_tiles), zeroed by the wrapper; agg and incl
//    (n_tiles, n), left as allocated (a tile's values are written before its
//    flag is raised and read only after).  Reads of another block's agg /
//    incl bypass L1 (__ldcg), which is not coherent across SMs.
//
// plane_transpose: a (rows, cols) → (cols, rows) copy through shared memory.
// Bound: bytes (Fs of N = 10M, D = 3, float32: 0.72 GB, 0.215 ms; the 3-row
// means 0.072 ms).  A copy is as fast as the bytes it keeps in flight, so
// where a side is w ≤ 64 wide (every d and d² of the path for d ≤ 8) a block
// moves L steps of the long side, L the largest power of two with w·L values
// in 40 KB (1,024 at w = 9 float): one contiguous run of w·L values on one
// side, w runs of L on the other, each read and written as 16-byte vectors,
// four loads in flight a thread before it stores any, the run walked by
// incrementing (step, row) with no division a value.  Where a pointer is not
// 16-byte aligned or the long side is not a multiple of four floats (two
// doubles) the same kernel moves a value at a time.  Both sides wider than
// 64: 32 × 32 tiles (no path of the port takes them).  Ragged edges are
// masked.  Measured at N = 10M float32 on an NVIDIA H100 80GB HBM3 at 700 W
// (device time): 0.245 ms Fs in and 0.244 ms covariances out, against
// 1.156 and 0.299 ms for x.t().contiguous(); 0.086 ms for the 3-row means
// out (bound 0.072), against 0.109 ms.
//
// One translation unit per state dimension and scalar type: compile with
// -DPGT_D=<1..8> -DPGT_F64=<0|1> (kalman/_cuda.py); entry points carry both
// in their names (pgt_plane_scan_d3_f32, ...).  The transpose does not depend
// on D and is built in the D = 1 units only (pgt_plane_transpose_f32 / _f64).
// The loops around the combines are kept rolled (#pragma unroll 1): unrolled,
// the D = 8 units would take minutes to compile.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "dt_launch.cuh"

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

constexpr int kFlagAgg = 1;   // agg[tile] holds the tile's aggregate
constexpr int kFlagIncl = 2;  // incl[tile] holds the inclusive total up to the tile
constexpr int kSpinOverrun = 1;

// The element a scan runs on, by kind.  An element is kRows values of S in
// packed row order (Filt: A, b, C, J, η; Smooth: E, g, L), so it is read and
// written as a flat array.
// kWarpLookBack: which look-back the kind's units run (look_back_warp, else
// look_back_thread), as measured on the card (module notes).
template <typename S, int D>
struct FilterOps {
  typedef Filt<S, D> Elem;
  static constexpr int kRows = ElementRows<D>::kFilt;
  static constexpr bool kWarpLookBack = D <= 4 || D >= 7;
  __device__ static __forceinline__ Elem combine(const Elem& a, const Elem& b) { return filt_combine<S, D>(a, b); }
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

// The look-back, run by one thread: publishes the tile's aggregate, folds
// its predecessors' into ``prefix`` one at a time, nearest first, up to the
// first INCL, and publishes the tile's inclusive total.  Returns the number
// of predecessors folded (0: the first tile in scan order, which has no
// prefix).
template <typename S, typename Ops>
__device__ __forceinline__ int look_back_thread(const typename Ops::Elem& aggregate, long long tile, long long first,
                                                 int step, int* flags, S* agg, S* incl, int* status,
                                                 long long max_polls, typename Ops::Elem& prefix) {
  typedef typename Ops::Elem E;
  constexpr int n = Ops::kRows;
  if (tile == first) {
    publish<S, E>(incl + tile * n, flags + tile, kFlagIncl, aggregate);
    return 0;
  }
  publish<S, E>(agg + tile * n, flags + tile, kFlagAgg, aggregate);
  int folded = 0;
  E x;
#pragma unroll 1
  for (long long j = tile - step;; j -= step) {
    const int state = wait_flag(flags + j, status, max_polls);
    if (state == 0) break;  // overrun: the wrapper raises
    load_published<S, E>((state == kFlagIncl ? incl : agg) + j * n, x);
    prefix = folded ? Ops::combine(x, prefix) : x;
    ++folded;
    if (state == kFlagIncl) break;
  }
  publish<S, E>(incl + tile * n, flags + tile, kFlagIncl, folded ? Ops::combine(prefix, aggregate) : aggregate);
  return folded;
}

// The look-back, run by the block's first warp (module notes): publishes the
// tile's aggregate, folds its predecessors' into lane 0's ``prefix``, and
// publishes the tile's inclusive total.  ``win`` is kRows × 32 values of
// shared memory, by component (win[k·ld + lane]).  Returns the number of
// predecessors folded (0: the first tile in scan order, which has no
// prefix), the same in every lane.  Every lane of the warp calls it.
template <typename S, typename Ops>
__device__ __forceinline__ int look_back_warp(const typename Ops::Elem& aggregate, long long tile, long long first,
                                          int step, int* flags, S* agg, S* incl, int* status, long long max_polls,
                                          S* win, int ld, typename Ops::Elem& prefix) {
  typedef typename Ops::Elem E;
  constexpr int n = Ops::kRows;
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  if (tile == first) {
    if (lane == 0) publish<S, E>(incl + tile * n, flags + tile, kFlagIncl, aggregate);
    return 0;
  }
  if (lane == 0) publish<S, E>(agg + tile * n, flags + tile, kFlagAgg, aggregate);
  const long long behind = (tile - first) * step;  // predecessors in scan order
  int folded = 0;
#pragma unroll 1
  for (long long base = 0; base < behind; base += 32) {
    // Lane i's predecessor is base + i + 1 tiles back in scan order.  The
    // window is ready once every flag before its nearest INCL is set (every
    // flag, where none is INCL); each poll reads every lane's flag again, so
    // that an AGG that has turned INCL since is seen.
    const bool has = base + lane < behind;
    const long long j = tile - (base + lane + 1) * step;
    const volatile int* f = flags + (has ? j : tile);
    int state = 0;
    unsigned found = 0;
    bool ready = false;
    unsigned int ns = 32;
#pragma unroll 1
    for (long long poll = 0; poll < max_polls; ++poll) {
      if (has) state = *f;
      found = __ballot_sync(kAll, has && state == kFlagIncl);
      const unsigned unset = __ballot_sync(kAll, has && state == 0);
      if (unset == 0 || (found && __ffs(found) < __ffs(unset))) {
        ready = true;
        break;
      }
      __nanosleep(ns);
      if (ns < 256) ns <<= 1;
    }
    if (!ready) {  // overrun: the wrapper raises
      if (lane == 0) atomicExch(status + 1, kSpinOverrun);
      break;
    }
    __threadfence();  // the values after their flags
    const int last = found ? __ffs(found) - 1 : (int)(behind - base < 32 ? behind - base - 1 : 31);
    if (lane <= last) {
      E x;
      load_published<S, E>((state == kFlagIncl ? incl : agg) + j * n, x);
      store_rows<S, E>(win, ld, lane, x);
    }
    __syncwarp();
    // Lanes 0..last in a tree: lane i folds in lane i + off, the earlier
    // predecessor, on its left.
#pragma unroll 1
    for (int off = 1; off <= last; off <<= 1) {
      if ((lane & (2 * off - 1)) == 0 && lane + off <= last) {
        E earlier, later;
        load_rows<S, E>(win, ld, lane + off, earlier);
        load_rows<S, E>(win, ld, lane, later);
        store_rows<S, E>(win, ld, lane, Ops::combine(earlier, later));
      }
      __syncwarp();
    }
    if (lane == 0) {
      E w;
      load_rows<S, E>(win, ld, 0, w);
      prefix = folded ? Ops::combine(w, prefix) : w;
    }
    folded += last + 1;
    __syncwarp();  // lane 0 has read the window before the next one is stored
    if (found) break;
  }
  if (lane == 0)
    publish<S, E>(incl + tile * n, flags + tile, kFlagIncl, folded ? Ops::combine(prefix, aggregate) : aggregate);
  return folded;
}

// Steps a thread at most, and the shared memory a block's tile may take: a
// unit takes the largest count up to kMax whose tile fits kBytes (kSteps,
// below).  At D = 3 float32 four steps measured fastest (see the module
// notes); the staged tile grows with the element (kRows × NT × Steps values,
// 88 KB a block at D = 3 float32 and four steps) and so the count falls
// with D: 2 at D ≤ 5, 1 above, and less in double where a tile over kBytes
// would leave one block an SM (D = 3 double: 1).
template <int D>
struct PlaneSteps {
  static constexpr int kMax = D <= 3 ? 4 : (D <= 5 ? 2 : 1);
  static constexpr int kBytes = 96 * 1024;
};

// Shared memory of plane_scan_kernel, in values of S: with Steps > 1 the
// staged tile (kRows rows of kStageRow), then the thread totals (kRows × NT:
// block_scan, then the look-back's window), then the prefix (kRows); two
// ints follow (the tile and whether it has a prefix).  A staged row holds
// thread i's step s at s·(NT + kPad) + i: a thread's own steps, and the
// copy's consecutive steps, fall on distinct banks.
template <int NT, int Steps, int kRows>
struct PlaneSmem {
  static constexpr int kPad = Steps > 1 ? 32 / Steps : 0;
  static constexpr int kStageRow = Steps > 1 ? Steps * (NT + kPad) : 0;
  static constexpr int kValues = kRows * (kStageRow + NT + 1);
  __device__ static __forceinline__ int at(int u) { return (u % Steps) * (NT + kPad) + u / Steps; }
};

extern __shared__ __align__(16) unsigned char pgt_plane_smem[];

template <typename S, int D, int NT, int Steps, typename Ops>
__global__ void __launch_bounds__(NT)
    plane_scan_kernel(const S* __restrict__ in, S* __restrict__ out, long long T, long long n_tiles, int reverse,
                      int* status, int* flags, S* agg, S* incl, long long max_polls) {
  typedef typename Ops::Elem E;
  typedef PlaneSmem<NT, Steps, Ops::kRows> M;
  constexpr int kRows = Ops::kRows;
  S* stage = reinterpret_cast<S*>(pgt_plane_smem);
  S* sm = stage + kRows * M::kStageRow;
  S* prefix_sm = sm + kRows * NT;
  int* meta = reinterpret_cast<int*>(prefix_sm + kRows);
  const int tid = threadIdx.x;

  if (tid == 0) {
    const int ticket = atomicAdd(status, 1);
    meta[0] = reverse ? (int)(n_tiles - 1 - ticket) : ticket;
  }
  __syncthreads();
  const long long tile = meta[0];
  const long long t0 = tile * (NT * Steps);
  const int n_valid = (int)((T - t0 < NT * Steps) ? T - t0 : NT * Steps);  // steps of the tile
  const int n_thr = (n_valid + Steps - 1) / Steps;                          // threads with a step
  const bool valid = tid < n_thr;
  const int n_mine = valid ? min(Steps, n_valid - tid * Steps) : 0;

  E mine;
  if constexpr (Steps == 1) {
    if (valid) load_rows<S, E>(in, T, t0 + tid, mine);
  } else {
    // The copy in: asynchronous (cp.async), so that every value of the
    // thread's share is in flight at once and none passes through registers.
#pragma unroll 1
    for (int k = 0; k < kRows; ++k)
#pragma unroll
      for (int m = 0; m < Steps; ++m) {
        const int u = tid + m * NT;
        if (u < n_valid) __pipeline_memcpy_async(stage + k * M::kStageRow + M::at(u), in + k * T + t0 + u, sizeof(S));
      }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    // This thread's total: its steps in scan order.
#pragma unroll 1
    for (int i = 0; i < n_mine; ++i) {
      E e;
      load_rows<S, E>(stage, M::kStageRow, M::at(tid * Steps + (reverse ? n_mine - 1 - i : i)), e);
      mine = i ? Ops::combine(mine, e) : e;
    }
  }
  block_scan<S, NT, Ops>(mine, sm, n_thr, reverse != 0);

  // The fold of the thread totals before this thread's, in scan order.
  E before;
  const bool has_before = Steps > 1 && valid && (reverse ? tid + 1 < n_thr : tid > 0);
  if (has_before) load_rows<S, E>(sm, NT, reverse ? tid + 1 : tid - 1, before);
  E aggregate;
  if (tid == 0) load_rows<S, E>(sm, NT, reverse ? 0 : n_thr - 1, aggregate);
  __syncthreads();  // sm is read: the look-back's window may reuse it
  if (tid < (Ops::kWarpLookBack ? 32 : 1)) {
    E prefix;
    const long long first = reverse ? n_tiles - 1 : 0;
    const int step = reverse ? -1 : 1;
    int folded;
    if constexpr (Ops::kWarpLookBack)
      folded = look_back_warp<S, Ops>(aggregate, tile, first, step, flags, agg, incl, status, max_polls, sm, NT, prefix);
    else
      folded = look_back_thread<S, Ops>(aggregate, tile, first, step, flags, agg, incl, status, max_polls, prefix);
    if (tid == 0) {
      if (folded) {
        store_rows<S, E>(prefix_sm, 1, 0, prefix);
        atomicAdd(status + 2, folded);
      }
      meta[1] = folded;
    }
  }
  __syncthreads();
  if constexpr (Steps == 1) {
    if (valid) {
      if (meta[1]) {
        E prefix;
        load_rows<S, E>(prefix_sm, 1, 0, prefix);
        mine = Ops::combine(prefix, mine);
      }
      store_rows<S, E>(out, T, t0 + tid, mine);
    }
  } else {
    if (valid) {
      // Re-fold this thread's steps seeded with its exclusive prefix.
      E acc;
      bool seeded = meta[1] != 0;
      if (seeded) load_rows<S, E>(prefix_sm, 1, 0, acc);
      if (has_before) {
        acc = seeded ? Ops::combine(acc, before) : before;
        seeded = true;
      }
#pragma unroll 1
      for (int i = 0; i < n_mine; ++i) {
        const int at = M::at(tid * Steps + (reverse ? n_mine - 1 - i : i));
        E e;
        load_rows<S, E>(stage, M::kStageRow, at, e);
        acc = (seeded || i) ? Ops::combine(acc, e) : e;
        store_rows<S, E>(stage, M::kStageRow, at, acc);
      }
    }
    __syncthreads();
#pragma unroll 1
    for (int k = 0; k < kRows; ++k)
#pragma unroll
      for (int m = 0; m < Steps; ++m) {
        const int u = tid + m * NT;
        if (u < n_valid) out[k * T + t0 + u] = stage[k * M::kStageRow + M::at(u)];
      }
  }
}

constexpr int kTile = 32;     // the wide transpose's tile edge
constexpr int kTileRows = 8;  // rows of threads: each thread moves kTile / kTileRows values of a tile
constexpr int kTransposeThreads = kTile * kTileRows;
constexpr int kNarrow = 64;            // widest side the narrow path takes
constexpr int kRunBytes = 40 * 1024;   // what a narrow block stages, at most
constexpr int kBatch = 4;              // vectors a thread loads before it stores any

// Long-side steps a block of the narrow path moves: the largest power of two
// L ≥ 64 with w·L values in kRunBytes (1,024 at w = 9 float, 128 at w = 64
// float, 64 at w = 64 double); 0 where both sides are wider than kNarrow.
inline int transpose_run(long long rows, long long cols, int itemsize) {
  const long long w = cols <= kNarrow ? cols : rows;
  if (w > kNarrow) return 0;
  int L = 64;
  while (2LL * L * w * itemsize <= kRunBytes) L *= 2;
  return L;
}

inline long long transpose_blocks(long long rows, long long cols, int run) {
  if (run) return ((cols <= kNarrow ? rows : cols) + run - 1) / run;
  return ((rows + kTile - 1) / kTile) * ((cols + kTile - 1) / kTile);
}

// V values of S, loaded and stored as one access of V·sizeof(S) bytes.
template <typename S, int V>
struct alignas(V * sizeof(S)) Pack {
  S v[V];
};

// A position (s, k) on the narrow-major side, k < w, walked without
// division, with ``a`` its tile offset k·stride + s kept alongside.
struct Walk {
  int k, a, w, stride;
  __device__ Walk(int e, int w_, int stride_) : k(e % w_), a((e % w_) * stride_ + e / w_), w(w_), stride(stride_) {}
  __device__ __forceinline__ void next() {  // (s, k) → (s, k + 1)
    a += stride;
    if (++k == w) {
      k = 0;
      a += 1 - w * stride;
    }
  }
  __device__ __forceinline__ void skip(int ds, int dk) {  // ds·w + dk values on, dk < w
    k += dk;
    a += dk * stride + ds;
    if (k >= w) {
      k -= w;
      a += 1 - w * stride;
    }
  }
};

// The narrow path.  The block's n ≤ L steps of the long side are one run of
// w·n values on the narrow-major side (from s0·w) and w runs of n on the
// other (row k from k·len + s0); the tile holds them as tile[k·(L+V) + s].
// Accesses to device memory are V values wide (16 bytes where the caller
// found both pointers aligned and len a multiple of V, else one value),
// kBatch of them in flight a thread; the narrow-major run is walked by
// incrementing (s, k), the rows by a shift.  The tile's rows are read and
// written V values at a time too (the pad of V keeps them 16-byte aligned),
// the narrow-major run a value at a time.
template <typename S, int V>
__device__ __forceinline__ void transpose_narrow(const S* __restrict__ in, S* __restrict__ out, long long len, int w,
                                                 bool narrow_in, int L, S* tile) {
  typedef Pack<S, V> P;
  constexpr int NT = kTransposeThreads;
  const int tid = threadIdx.x;
  const long long s0 = (long long)blockIdx.x * L;
  const int n = (int)((len - s0 < L) ? len - s0 : L);
  const int stride = L + V;
  const int run = w * n;                 // values of the narrow-major run
  const int run_vecs = run / V;          // its whole vectors
  const int row_vecs = L / V;            // vectors a row holds in a full block, a power of two
  const int row_shift = __ffs(row_vecs) - 1;
  const int n_vecs = n / V;              // whole vectors of each row here
  const bool tail = n_vecs * V < n;      // values past them (the last block only)
  // Thread tid takes the run's vectors tid, tid + NT, …: its walk starts at
  // value V·tid and skips divmod(V·NT, w) a vector, both divided once.
  const int ds = V * NT / w, dk = V * NT - ds * w;
  Walk walk(V * tid, w, stride);
  const S* run_in = in + s0 * w;
  S* run_out = out + s0 * w;
  if (narrow_in) {
#pragma unroll 1
    for (int u0 = tid; u0 < run_vecs; u0 += kBatch * NT) {
      P v[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b)
        if (u0 + b * NT < run_vecs) v[b] = reinterpret_cast<const P*>(run_in)[u0 + b * NT];
#pragma unroll
      for (int b = 0; b < kBatch && u0 + b * NT < run_vecs; ++b) {
        Walk at = walk;
#pragma unroll
        for (int j = 0; j < V; ++j, at.next()) tile[at.a] = v[b].v[j];
        walk.skip(ds, dk);
      }
    }
    if (tid == 0) {  // the run's values past its whole vectors (the last block only)
      Walk at(run_vecs * V, w, stride);
      for (int e = run_vecs * V; e < run; ++e, at.next()) tile[at.a] = run_in[e];
    }
  } else {
#pragma unroll 1
    for (int i0 = tid; i0 < w * row_vecs; i0 += kBatch * NT) {
      P v[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int i = i0 + b * NT, k = i >> row_shift, q = i & (row_vecs - 1);
        if (k < w && q < n_vecs) v[b] = reinterpret_cast<const P*>(in + k * len + s0)[q];
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int i = i0 + b * NT, k = i >> row_shift, q = i & (row_vecs - 1);
        if (k < w && q < n_vecs) reinterpret_cast<P*>(tile + k * stride)[q] = v[b];
      }
    }
    for (int k = tid; tail && k < w; k += NT)  // each row's last values
      for (int s = n_vecs * V; s < n; ++s) tile[k * stride + s] = in[k * len + s0 + s];
  }
  __syncthreads();
  if (narrow_in) {
#pragma unroll 4
    for (int i = tid; i < w * row_vecs; i += NT) {
      const int k = i >> row_shift, q = i & (row_vecs - 1);
      if (k < w && q < n_vecs) reinterpret_cast<P*>(out + k * len + s0)[q] = reinterpret_cast<const P*>(tile + k * stride)[q];
    }
    for (int k = tid; tail && k < w; k += NT)
      for (int s = n_vecs * V; s < n; ++s) out[k * len + s0 + s] = tile[k * stride + s];
  } else {
#pragma unroll 4
    for (int u = tid; u < run_vecs; u += NT, walk.skip(ds, dk)) {
      P v;
      Walk at = walk;
#pragma unroll
      for (int j = 0; j < V; ++j, at.next()) v.v[j] = tile[at.a];
      reinterpret_cast<P*>(run_out)[u] = v;
    }
    if (tid == 0) {
      Walk at(run_vecs * V, w, stride);
      for (int e = run_vecs * V; e < run; ++e, at.next()) run_out[e] = tile[at.a];
    }
  }
}

// out (cols, rows) = in (rows, cols)ᵀ.  A side w ≤ kNarrow (every d and d² of
// the plane path for d ≤ 8): the narrow path, ``run`` long-side steps a
// block; ``vec`` picks its 16-byte accesses.  Both sides wide: a kTile ×
// kTile tile, a warp a row of it.  The tile is the dynamic shared memory.
template <typename S>
__global__ void __launch_bounds__(kTransposeThreads)
    plane_transpose_kernel(const S* __restrict__ in, S* __restrict__ out, long long rows, long long cols, int run,
                           int vec) {
  S* tile = reinterpret_cast<S*>(pgt_plane_smem);
  if (run) {
    const bool narrow_in = cols <= kNarrow;  // (len, w) → (w, len); else (w, len) → (len, w)
    const long long len = narrow_in ? rows : cols;
    const int w = (int)(narrow_in ? cols : rows);
    if (vec)
      transpose_narrow<S, 16 / sizeof(S)>(in, out, len, w, narrow_in, run, tile);
    else
      transpose_narrow<S, 1>(in, out, len, w, narrow_in, run, tile);
    return;
  }
  const int tid = threadIdx.x;
  const long long b = blockIdx.x;
  const long long col_tiles = (cols + kTile - 1) / kTile;
  const long long r0 = (b / col_tiles) * kTile, c0 = (b % col_tiles) * kTile;
  const int tx = tid % kTile, ty = tid / kTile;
#pragma unroll
  for (int j = ty; j < kTile; j += kTileRows) {
    const long long r = r0 + j, c = c0 + tx;
    if (r < rows && c < cols) tile[j * (kTile + 1) + tx] = in[r * cols + c];
  }
  __syncthreads();
#pragma unroll
  for (int j = ty; j < kTile; j += kTileRows) {
    const long long c = c0 + j, r = r0 + tx;
    if (c < cols && r < rows) out[c * rows + r] = tile[tx * (kTile + 1) + j];
  }
}

}  // namespace pgt

// C interface, bound with ctypes (kalman/_cuda.py).  Each entry launches one
// kernel on the given stream, does not synchronise, and returns
// cudaGetLastError() (0 on success), the error of the shared-memory opt-in,
// or kBadArgs.
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
#define PGT_TYPED(name) PGT_CAT(name, PGT_TYPE_TAG)

namespace {

constexpr int kNT = pgt::TileThreads<PGT_D>::kN;
constexpr int kMaxSteps = pgt::PlaneSteps<PGT_D>::kMax;

// Dynamic shared memory of a block of the scan, in bytes.
template <typename Ops, int Steps>
constexpr int scan_bytes() {
  return (int)(sizeof(pgt_scalar) * pgt::PlaneSmem<kNT, Steps, Ops::kRows>::kValues + 2 * sizeof(int));
}

// This unit's steps a thread: the most, of 4, 2 and 1 up to kMaxSteps, whose
// filter tile (the larger kind) fits PlaneSteps::kBytes.
constexpr int pick_steps() {
  typedef pgt::FilterOps<pgt_scalar, PGT_D> F;
  if (kMaxSteps >= 4 && scan_bytes<F, 4>() <= pgt::PlaneSteps<PGT_D>::kBytes) return 4;
  if (kMaxSteps >= 2 && scan_bytes<F, 2>() <= pgt::PlaneSteps<PGT_D>::kBytes) return 2;
  return 1;
}
constexpr int kSteps = pick_steps();

template <typename Ops>
int launch_plane_scan(int reverse, const void* in, void* out, long long T, void* status, void* flags, void* agg,
                      void* incl, long long max_polls, void* stream) {
  typedef pgt_scalar S;
  const long long n_tiles = (T + kNT * kSteps - 1) / (kNT * kSteps);
  if (n_tiles > 0x7fffffffLL) return pgt::kBadArgs;
  auto kern = pgt::plane_scan_kernel<S, PGT_D, kNT, kSteps, Ops>;
  constexpr int bytes = scan_bytes<Ops, kSteps>();
  cudaError_t rc = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc != cudaSuccess) return (int)rc;
  kern<<<(unsigned int)n_tiles, kNT, bytes, (cudaStream_t)stream>>>((const S*)in, (S*)out, T, n_tiles, reverse,
                                                                    (int*)status, (int*)flags, (S*)agg, (S*)incl,
                                                                    max_polls);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Threads of a block of the scan, and steps a thread, at this D and scalar
// type: a tile is threads × steps consecutive steps.
int PGT_ENTRY(pgt_plane_scan_threads)(void) { return kNT; }
int PGT_ENTRY(pgt_plane_scan_steps)(void) { return kSteps; }

// in, out: contiguous (n, T) rows, n = 3D²+2D (smoother = 0) or 2D²+D
// (smoother = 1); status: int (ticket, error, predecessors folded), zeroed;
// flags: int (n_tiles,), zeroed; agg, incl: (n_tiles, n), need not be
// zeroed; n_tiles = ceil(T / (threads · steps)).
int PGT_ENTRY(pgt_plane_scan)(int smoother, int reverse, const void* in, void* out, long long T, void* status,
                              void* flags, void* agg, void* incl, long long max_polls, void* stream) {
  if (T < 1 || max_polls < 0) return pgt::kBadArgs;
  return smoother ? launch_plane_scan<pgt::SmootherOps<pgt_scalar, PGT_D>>(reverse, in, out, T, status, flags, agg,
                                                                           incl, max_polls, stream)
                  : launch_plane_scan<pgt::FilterOps<pgt_scalar, PGT_D>>(reverse, in, out, T, status, flags, agg,
                                                                         incl, max_polls, stream);
}

#if PGT_D == 1
// Long-side steps a block of the transpose moves for this shape (0: the
// both-sides-wide tiles).
int PGT_TYPED(pgt_plane_transpose_run)(long long rows, long long cols) {
  return pgt::transpose_run(rows, cols, (int)sizeof(pgt_scalar));
}

// in: contiguous (rows, cols); out: contiguous (cols, rows).
int PGT_TYPED(pgt_plane_transpose)(const void* in, void* out, long long rows, long long cols, void* stream) {
  if (rows < 1 || cols < 1) return pgt::kBadArgs;
  typedef pgt_scalar S;
  constexpr int V = 16 / sizeof(S);
  const int run = pgt::transpose_run(rows, cols, (int)sizeof(S));
  const long long n_blocks = pgt::transpose_blocks(rows, cols, run);
  if (n_blocks > 0x7fffffffLL) return pgt::kBadArgs;
  const long long len = cols <= pgt::kNarrow ? rows : cols;
  const int vec = run && (unsigned long long)in % 16 == 0 && (unsigned long long)out % 16 == 0 && len % V == 0;
  const size_t bytes = sizeof(S) * (run ? (size_t)(cols <= pgt::kNarrow ? cols : rows) * (run + (vec ? V : 1))
                                        : (size_t)pgt::kTile * (pgt::kTile + 1));
  pgt::plane_transpose_kernel<S><<<(unsigned int)n_blocks, pgt::kTransposeThreads, bytes, (cudaStream_t)stream>>>(
      (const S*)in, (S*)out, rows, cols, run, vec);
  return (int)cudaGetLastError();
}
#endif

}  // extern "C"
