// Windowed semiring segment-combine for Hopper (sm_90a), two entries.
//
// K1, gravfm_segment_combine, replaces
// repro/kernels/edge_gather.py:segment_combine_pallas (the only
// pl.pallas_call of the JAX package) together with the epilogue of
// segment_combine_windows (unwritten windows -> identity, slice to
// num_segments), over one layout.
//
// K2, gravfm_segment_combine_windows, replaces
// repro/kernels/edge_gather.py:segment_combine_windows as the shard engine
// calls it: the same function over a stack of per-shard layouts (one
// tile_start and rel row per shard, vals (batch, shard, lane)) in one
// launch, one block per (window, query x shard). Its bound and design are
// K1's; the blocks of the extra grid rows are independent.
//
// What it computes. The lanes of a static EdgeLayout are sorted by
// destination segment and cut into tiles of tile_e lanes; window w owns
// the tiles [tile_start[w], tile_start[w+1]) and the rows
// [w*tile_r, (w+1)*tile_r). For every query b of the batch:
//   out[b, w*tile_r + r] = fold over the lanes of window w with rel == r
//                          of vals[b, lane]
// with fold one of add / min / max, for float32 or int32 values. Padding
// lanes hold rel == tile_r and match no row. Rows >= num_segments are not
// stored, and a window that owns no tile stores the identity.
//
// Design. The TPU kernel walked the tiles in a sequential grid and kept a
// window's output block resident in VMEM across consecutive tiles. Hopper
// blocks run in parallel and in no order, so here one block owns one
// (window, query) pair and walks the window's whole tile range itself:
//   * tile_r accumulators live in shared memory (tile_r * 4 bytes),
//     filled with the identity;
//   * the block's threads read rel and vals as 16-byte vectors (4 lanes a
//     thread, neighbouring threads on neighbouring addresses) and fold runs
//     of equal rel in registers. Lanes are sorted by row, so a thread's run
//     stays open across its strided vectors: a hub row spanning many tiles
//     costs each thread one shared-memory atomic when the run ends, not
//     one per vector. (float32 add in shared memory is a compare-and-swap
//     loop, so contended atomics cost most there.)
//   * the block stores its tile_r rows once, bounded by num_segments.
// There is no one-hot (tile_r x tile_e) compare as in the Pallas body:
// each lane is read and folded exactly once.
//
// Bound. The work is memory-bound: per call it reads rel (4 B a lane) and
// vals (4 B a lane per query) once and writes 4 B per output row per
// query; the fold is one operation per lane. The design reads every input
// byte once with vector loads and keeps all partial sums on chip, so the
// device-memory traffic is that minimum plus tile_start.
//
// Determinism. min and max (float32 through the sign-split integer
// atomics below) and int32 add are exact and independent of order.
// float32 add through shared-memory atomics is exact up to the order of
// the adds, which varies from run to run; callers compare it with the
// plain version at rtol = atol = 1e-5 (the tolerance the JAX tests apply
// to the Pallas kernel against its oracle).
//
// Known weak spot: a hub window (many tiles) runs serially in one block;
// splitting long windows across blocks is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;

enum Combiner : int { kAdd = 0, kMin = 1, kMax = 2 };
enum DType : int { kFloat32 = 0, kInt32 = 1 };

template <typename T> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<int> { using type = int4; };

template <typename T, int OP> __device__ __forceinline__ T identity();
template <> __device__ __forceinline__ float identity<float, kAdd>() { return 0.0f; }
template <> __device__ __forceinline__ float identity<float, kMin>() { return __int_as_float(0x7f800000); }
template <> __device__ __forceinline__ float identity<float, kMax>() { return __int_as_float(0xff800000); }
template <> __device__ __forceinline__ int identity<int, kAdd>() { return 0; }
template <> __device__ __forceinline__ int identity<int, kMin>() { return INT32_MAX; }
template <> __device__ __forceinline__ int identity<int, kMax>() { return INT32_MIN; }

template <typename T, int OP>
__device__ __forceinline__ T combine(T a, T b) {
  if constexpr (OP == kAdd) return a + b;
  else if constexpr (OP == kMin) return a < b ? a : b;
  else return a > b ? a : b;
}

// Shared-memory fold. float min/max: a float with the sign bit clear
// orders like its bits as a signed int, one with the sign bit set orders
// in reverse of its bits as an unsigned int, so each half is one native
// integer atomic (and -0.0 takes the negative half, below +0.0).
template <typename T, int OP>
__device__ __forceinline__ void atomic_fold(T* addr, T v) {
  if constexpr (OP == kAdd) {
    atomicAdd(addr, v);
  } else if constexpr (std::is_same<T, float>::value && OP == kMin) {
    if (!signbit(v)) atomicMin(reinterpret_cast<int*>(addr), __float_as_int(v));
    else atomicMax(reinterpret_cast<unsigned*>(addr), __float_as_uint(v));
  } else if constexpr (std::is_same<T, float>::value && OP == kMax) {
    if (!signbit(v)) atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
    else atomicMin(reinterpret_cast<unsigned*>(addr), __float_as_uint(v));
  } else if constexpr (OP == kMin) {
    atomicMin(addr, v);
  } else {
    atomicMax(addr, v);
  }
}

// One block's whole job, shared by both kernels: fold the 16-byte lane
// vectors [q_lo, q_hi) of one lane row (rel, vals) into tile_r shared
// accumulators `acc`, then store them to out[row0 .. row0 + tile_r),
// bounded by num_segments.
template <typename T, int OP>
__device__ __forceinline__ void fold_window(T* acc,
                                            const int* __restrict__ rel,
                                            const T* __restrict__ vals,
                                            T* __restrict__ out,
                                            long long q_lo, long long q_hi,
                                            long long row0,
                                            int num_segments, int tile_r) {
  for (int r = threadIdx.x; r < tile_r; r += blockDim.x) acc[r] = identity<T, OP>();
  __syncthreads();

  using V4 = typename Vec4<T>::type;
  const int4* rel4 = reinterpret_cast<const int4*>(rel);
  const V4* vals4 = reinterpret_cast<const V4*>(vals);
  // The thread's open run: row `cur` (tile_r = none) with partial `part`.
  // It stays open across the thread's strided vectors, so a hub row that
  // spans many tiles costs each thread one atomic, not one per vector.
  int cur = tile_r;
  T part = identity<T, OP>();
  for (long long q = q_lo + threadIdx.x; q < q_hi; q += blockDim.x) {
    const int4 r4 = __ldg(rel4 + q);
    const V4 v4 = vals4[q];
    const int rs[4] = {r4.x, r4.y, r4.z, r4.w};
    const T vs[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (rs[j] == cur) {
        part = combine<T, OP>(part, vs[j]);
      } else {
        if (cur < tile_r) atomic_fold<T, OP>(&acc[cur], part);
        cur = rs[j];
        part = vs[j];
      }
    }
  }
  if (cur < tile_r) atomic_fold<T, OP>(&acc[cur], part);
  __syncthreads();

  for (int r = threadIdx.x; r < tile_r; r += blockDim.x) {
    const long long row = row0 + r;
    if (row < num_segments) out[row] = acc[r];
  }
}

// K1: block (w, b) folds window w of the one layout for query b.
template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
segment_combine_kernel(const int* __restrict__ tile_start,
                       const int* __restrict__ rel,
                       const T* __restrict__ vals, T* __restrict__ out,
                       long long num_lanes, int num_segments, int tile_e,
                       int tile_r) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int w = blockIdx.x;
  const long long b = blockIdx.y;
  fold_window<T, OP>(reinterpret_cast<T*>(smem_raw), rel,
                     vals + b * num_lanes, out + b * num_segments,
                     (long long)tile_start[w] * tile_e / 4,
                     (long long)tile_start[w + 1] * tile_e / 4,
                     (long long)w * tile_r, num_segments, tile_r);
}

// K2: block (w, b * n_shards + s) folds window w of shard s's layout for
// query b. Shard s reads its own tile_start row, so the tiles a shorter
// shard was padded with (past its tile_start[s][n_windows]) are never read.
template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
segment_combine_windows_kernel(const int* __restrict__ tile_start,
                               const int* __restrict__ rel,
                               const T* __restrict__ vals,
                               T* __restrict__ out, int n_windows,
                               int n_shards, long long num_lanes,
                               int num_segments, int tile_e, int tile_r) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int w = blockIdx.x;
  const long long bs = blockIdx.y;
  const long long s = bs % n_shards;
  const int* ts = tile_start + s * (n_windows + 1);
  fold_window<T, OP>(reinterpret_cast<T*>(smem_raw), rel + s * num_lanes,
                     vals + bs * num_lanes, out + bs * num_segments,
                     (long long)ts[w] * tile_e / 4,
                     (long long)ts[w + 1] * tile_e / 4,
                     (long long)w * tile_r, num_segments, tile_r);
}

template <typename T, int OP>
cudaError_t launch(const int* tile_start, const int* rel, const void* vals,
                   void* out, int n_windows, int batch, long long num_lanes,
                   int num_segments, int tile_e, int tile_r,
                   cudaStream_t stream) {
  const dim3 grid(n_windows, batch);
  const size_t smem = (size_t)tile_r * sizeof(T);
  segment_combine_kernel<T, OP><<<grid, kThreads, smem, stream>>>(
      tile_start, rel, static_cast<const T*>(vals), static_cast<T*>(out),
      num_lanes, num_segments, tile_e, tile_r);
  return cudaGetLastError();
}

template <typename T, int OP>
cudaError_t launch_windows(const int* tile_start, const int* rel,
                           const void* vals, void* out, int n_windows,
                           int n_shards, int batch, long long num_lanes,
                           int num_segments, int tile_e, int tile_r,
                           cudaStream_t stream) {
  const dim3 grid(n_windows, batch * n_shards);
  const size_t smem = (size_t)tile_r * sizeof(T);
  segment_combine_windows_kernel<T, OP><<<grid, kThreads, smem, stream>>>(
      tile_start, rel, static_cast<const T*>(vals), static_cast<T*>(out),
      n_windows, n_shards, num_lanes, num_segments, tile_e, tile_r);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes. vals is (batch, num_lanes) and out is
// (batch, num_segments), both contiguous; num_lanes = tile_start[n_windows]
// * tile_e; tile_e is a multiple of 4 and every pointer 16-byte aligned.
// Launches on `stream`, does not synchronise, returns the cudaError_t of
// the launch (0 = cudaSuccess).
extern "C" int gravfm_segment_combine(const int* tile_start, const int* rel,
                                      const void* vals, void* out,
                                      int n_windows, int batch,
                                      long long num_lanes, int num_segments,
                                      int tile_e, int tile_r, int combiner,
                                      int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int key = dtype * 3 + combiner;
  switch (key) {
    case kFloat32 * 3 + kAdd:
      return launch<float, kAdd>(tile_start, rel, vals, out, n_windows, batch, num_lanes, num_segments, tile_e, tile_r, s);
    case kFloat32 * 3 + kMin:
      return launch<float, kMin>(tile_start, rel, vals, out, n_windows, batch, num_lanes, num_segments, tile_e, tile_r, s);
    case kFloat32 * 3 + kMax:
      return launch<float, kMax>(tile_start, rel, vals, out, n_windows, batch, num_lanes, num_segments, tile_e, tile_r, s);
    case kInt32 * 3 + kAdd:
      return launch<int, kAdd>(tile_start, rel, vals, out, n_windows, batch, num_lanes, num_segments, tile_e, tile_r, s);
    case kInt32 * 3 + kMin:
      return launch<int, kMin>(tile_start, rel, vals, out, n_windows, batch, num_lanes, num_segments, tile_e, tile_r, s);
    case kInt32 * 3 + kMax:
      return launch<int, kMax>(tile_start, rel, vals, out, n_windows, batch, num_lanes, num_segments, tile_e, tile_r, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// C entry point of K2, bound with ctypes. tile_start is (n_shards,
// n_windows + 1), rel is (n_shards, num_lanes), vals is (batch, n_shards,
// num_lanes) and out is (batch, n_shards, num_segments), all contiguous;
// tile_start[s][n_windows] * tile_e <= num_lanes for every shard s. The
// other conditions are K1's. Launches on `stream`, does not synchronise,
// returns the cudaError_t of the launch (0 = cudaSuccess).
extern "C" int gravfm_segment_combine_windows(
    const int* tile_start, const int* rel, const void* vals, void* out,
    int n_windows, int n_shards, int batch, long long num_lanes,
    int num_segments, int tile_e, int tile_r, int combiner, int dtype,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype * 3 + combiner) {
    case kFloat32 * 3 + kAdd:
      return launch_windows<float, kAdd>(tile_start, rel, vals, out, n_windows, n_shards, batch, num_lanes, num_segments, tile_e, tile_r, s);
    case kFloat32 * 3 + kMin:
      return launch_windows<float, kMin>(tile_start, rel, vals, out, n_windows, n_shards, batch, num_lanes, num_segments, tile_e, tile_r, s);
    case kFloat32 * 3 + kMax:
      return launch_windows<float, kMax>(tile_start, rel, vals, out, n_windows, n_shards, batch, num_lanes, num_segments, tile_e, tile_r, s);
    case kInt32 * 3 + kAdd:
      return launch_windows<int, kAdd>(tile_start, rel, vals, out, n_windows, n_shards, batch, num_lanes, num_segments, tile_e, tile_r, s);
    case kInt32 * 3 + kMin:
      return launch_windows<int, kMin>(tile_start, rel, vals, out, n_windows, n_shards, batch, num_lanes, num_segments, tile_e, tile_r, s);
    case kInt32 * 3 + kMax:
      return launch_windows<int, kMax>(tile_start, rel, vals, out, n_windows, n_shards, batch, num_lanes, num_segments, tile_e, tile_r, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
