// Windowed semiring segment-combine for Hopper (sm_90a).
//
// One kernel, one C entry (gravfm_segment_combine_windows), launched by
// both wrappers of kernels/edge_gather.py:
//   * K1, segment_combine, replaces
//     repro/kernels/edge_gather.py:segment_combine_pallas (the only
//     pl.pallas_call of the JAX package) with the epilogue of
//     segment_combine_windows, over one layout: a stack of one shard;
//   * K2, segment_combine_windows, replaces
//     repro/kernels/edge_gather.py:segment_combine_windows as the shard
//     engine calls it: the same function over a stack of per-shard
//     layouts (rel (S, L), vals (B, S, L)) in one launch.
//
// What it computes. The lanes of a static EdgeLayout are sorted by
// destination segment and cut into tiles of tile_e lanes; window w owns
// the tiles [tile_start[w], tile_start[w+1]) and the rows
// [w*tile_r, (w+1)*tile_r). For every query b and shard s:
//   out[b, s, w*tile_r + r] = fold over the lanes of shard s's window w
//                             with rel == r of vals[b, s, lane]
// with fold one of add / min / max, for float32 or int32 values. Padding
// lanes hold rel == tile_r and match no row. Rows >= num_segments are not
// stored, and a window that owns no tile stores the identity (the shard
// engine's window_written epilogue rests on that).
//
// Bound. The work is bound by bytes: a call must read rel once (4 B a
// lane), vals once per query (4 B a lane) and write 4 B per output row
// per query; the fold is one operation per lane, three orders of
// magnitude under the card's rate. There is no product anywhere, so the
// tensor cores (wgmma) have nothing to do here. The design keeps every
// partial on chip and moves that minimum, plus the work list and, for
// the few windows cut into several items, their partial rows.
//
// Design, one point for each way the first version lost time (the
// measurements behind each choice are in PERF.md's findings):
//   1. One rel read for the whole batch. A block folds a chunk of QB <= 8
//      queries (a compile-time constant picked from the batch: 1, 2, 4 or
//      8) over the same lanes: QB x tile_r accumulators in shared memory,
//      rel read once per chunk. (The first version read rel once per
//      query, 2x the bound's bytes at B=8.)
//   2. Warp-segmented fold. Lanes are sorted by row, so a row's lanes are
//      consecutive. A thread folds its 4 lanes, a segmented inclusive scan
//      over the warp (__shfl_up_sync, keyed by each thread's last row)
//      joins a row across threads, and only the thread where a row ends
//      issues the shared-memory atomic: one a row a warp, where a
//      per-thread fold costs one for each thread the row touches. That
//      matters most for float32 add, whose shared-memory atomic is a
//      compare-and-swap loop on sm_90 (cuobjdump -sass shows
//      ATOMS.CAST.SPIN); int32 add, min and max are single native ATOMS
//      (float32 min/max through the sign-split integer atomics below). A
//      variant that kept each thread's open run in registers for the
//      native atomics measured the same within the run-to-run spread, so
//      one fold serves every combiner.
//   3. Balanced work list. kernels/layout.py:work_list cuts each (shard,
//      window) tile range into items of at most WORK_TILES tiles, once per
//      layout, on the host, sorted by size, most first; one block an item.
//      A window that owns no tile is one empty item (it stores the
//      identity). A window cut into k items is finished in the same
//      launch: each item stores its partial rows to its slot of `scratch`
//      (allocated by the wrapper), fences, and counts itself on the
//      window's arrival counter (kept with the layout on the device); the
//      last to arrive folds the k slots in slot order, stores the rows and
//      sets the counter back to 0 for the next call. No block waits on
//      another, so no launch order can deadlock.
//   4. Bytes in flight. A persistent variant (SMs x resident blocks
//      walking the work list; one producer warp streaming rel and QB vals
//      rows through a 4-stage shared-memory ring with cp.async.bulk and
//      mbarriers; 8 consumer warps) was built and measured on the card:
//      it was 8-20 % slower than this grid of one block per item at every
//      shape, with every check passing. It is not kept. Each thread here
//      keeps one 16-byte rel load and QB 16-byte vals loads in flight per
//      step; its registers (40 to 47 a thread at QB <= 4, 57 to 61 at
//      QB = 8, as ptxas reports them) let 4 to 6 blocks of 256 threads
//      share an SM, which the measurements show is enough to stream
//      within 20 % of the bound.
//
// Determinism. min and max (float32 through the sign-split integer
// atomics) and int32 add are exact and independent of order. float32 add
// is exact up to the order of the adds: fixed within a warp's scan and
// across a split window's partials, but the shared-memory atomics of
// different warps land in a varying order, so the last bits vary from
// run to run; callers compare it with the plain version at
// rtol = atol = 1e-5 (the tolerance the JAX tests apply to the Pallas
// kernel against its oracle).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr size_t kSmemMax = 232448;  // a Hopper block's dynamic shared memory

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

// ---------------------------------------------------------------------------
// Design point 2: the warp-segmented fold.
// ---------------------------------------------------------------------------

// One warp's fold of 128 consecutive lanes (4 a thread, in lane order)
// for nq <= QB queries into the shared accumulators acc[j*tile_r + row].
// Lanes are sorted by row (padding and lanes past the range hold tile_r,
// which matches no row), so a row's lanes are consecutive: each thread
// folds its own 4 lanes, then a segmented inclusive scan over the warp
// (__shfl_up_sync, keyed by each thread's last row) joins a row's lanes
// across threads, and only the thread where a row ends issues the shared
// atomic. A row costs one atomic a warp it touches, where a per-thread
// fold cost one for each thread it touches.
template <typename T, int OP, int QB>
__device__ __forceinline__ void fold_warp(T* acc, const int (&k)[4],
                                          T (&v)[QB][4], int nq,
                                          int tile_r) {
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  // Query-independent: which neighbours share this thread's last row.
  unsigned same = 0;
#pragma unroll
  for (int d = 1, bit = 0; d < 32; d <<= 1, ++bit) {
    const int up = __shfl_up_sync(kAll, k[3], d);
    if (lane >= d && up == k[3]) same |= 1u << bit;
  }
  const int prev_last = __shfl_up_sync(kAll, k[3], 1);
  const int next_first = __shfl_down_sync(kAll, k[0], 1);
  // The run of the last row ends here unless the next thread starts with
  // it; the run of the first row (if it is not also the last) ends here
  // and joins the previous thread's scan if that ended on the same row.
  const bool emit_last = (lane == 31 || next_first != k[3]) && k[3] < tile_r;
  const bool emit_first = k[0] != k[3] && k[0] < tile_r;
  const bool join_first = lane > 0 && prev_last == k[0];
  const bool emit_1 = k[1] != k[0] && k[1] != k[3];
  const bool emit_2 = k[2] != k[1] && k[2] != k[3];
  const T id = identity<T, OP>();
#pragma unroll
  for (int j = 0; j < QB; ++j) {
    if (j >= nq) break;
    T last = v[j][3];
    last = combine<T, OP>(k[2] == k[3] ? v[j][2] : id, last);
    last = combine<T, OP>(k[1] == k[3] ? v[j][1] : id, last);
    last = combine<T, OP>(k[0] == k[3] ? v[j][0] : id, last);
#pragma unroll
    for (int d = 1, bit = 0; d < 32; d <<= 1, ++bit) {
      const T up = __shfl_up_sync(kAll, last, d);
      if (same & (1u << bit)) last = combine<T, OP>(up, last);
    }
    const T prev = __shfl_up_sync(kAll, last, 1);
    T* a = acc + j * tile_r;
    if (emit_first) {
      T first = v[j][0];
      first = combine<T, OP>(first, k[1] == k[0] ? v[j][1] : id);
      first = combine<T, OP>(first, k[2] == k[0] ? v[j][2] : id);
      atomic_fold<T, OP>(a + k[0], join_first ? combine<T, OP>(prev, first) : first);
    }
    if (emit_1) atomic_fold<T, OP>(a + k[1], combine<T, OP>(v[j][1], k[2] == k[1] ? v[j][2] : id));
    if (emit_2) atomic_fold<T, OP>(a + k[2], v[j][2]);
    if (emit_last) atomic_fold<T, OP>(a + k[3], last);
  }
}

// ---------------------------------------------------------------------------
// Design point 3: the work list.
// ---------------------------------------------------------------------------

// Item header: shard, window, tiles [lo, hi); for a window cut into
// several items its arrival counter, this item's partial slot, the
// window's first slot and its item count (kernels/layout.py:work_list).
struct Item {
  int shard, window, tile_lo, tile_hi, counter, slot, first_slot, parts;
};

__device__ __forceinline__ Item load_item(const int* items, int i) {
  const int4* p = reinterpret_cast<const int4*>(items) + 2 * (long long)i;
  const int4 a = __ldg(p), b = __ldg(p + 1);
  return Item{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
}

// ---------------------------------------------------------------------------
// The kernel.
// ---------------------------------------------------------------------------

// Block i folds work item i for every query, QB queries at a time: the
// item's rel vectors are read once per chunk of QB queries, with 16-byte
// loads, neighbouring threads on neighbouring vectors. The item's tile_r
// rows go to out, or, for a window cut into several items, to the item's
// partial slot in `scratch` (slot, query, row); the last item of such a
// window to arrive folds the window's slots in slot order, stores the
// rows and sets the window's arrival counter back to 0.
template <typename T, int OP, int QB>
__global__ void __launch_bounds__(kThreads)
segment_combine_kernel(const int* __restrict__ items,
                       int* __restrict__ arrivals, T* __restrict__ scratch,
                       const int* __restrict__ rel,
                       const T* __restrict__ vals, T* __restrict__ out,
                       int n_shards, int batch, long long num_lanes,
                       int num_segments, int tile_e, int tile_r) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* acc = reinterpret_cast<T*>(smem_raw);
  __shared__ int last;
  const Item it = load_item(items, blockIdx.x);
  const long long q_lo = (long long)it.tile_lo * tile_e / 4;
  const long long q_hi = (long long)it.tile_hi * tile_e / 4;
  const long long row0 = (long long)it.window * tile_r;
  using V4 = typename Vec4<T>::type;
  const int4* rel4 = reinterpret_cast<const int4*>(rel + it.shard * num_lanes);
  const long long vstride4 = n_shards * num_lanes / 4;

  for (int b0 = 0; b0 < batch; b0 += QB) {
    const int nq = min(QB, batch - b0);
    for (int i = threadIdx.x; i < QB * tile_r; i += blockDim.x) acc[i] = identity<T, OP>();
    __syncthreads();
    const V4* vals4 = reinterpret_cast<const V4*>(vals) +
                      ((long long)b0 * n_shards + it.shard) * num_lanes / 4;
    // Whole warps walk the range together (the scan needs every lane).
    for (long long base = q_lo; base < q_hi; base += blockDim.x) {
      const long long q = base + threadIdx.x;
      const bool live = q < q_hi;
      int4 r4 = make_int4(tile_r, tile_r, tile_r, tile_r);
      if (live) r4 = __ldg(rel4 + q);
      T vs[QB][4];
#pragma unroll
      for (int j = 0; j < QB; ++j) {
        V4 v4{};
        if (live && j < nq) v4 = vals4[j * vstride4 + q];
        vs[j][0] = v4.x; vs[j][1] = v4.y; vs[j][2] = v4.z; vs[j][3] = v4.w;
      }
      const int ks[4] = {r4.x, r4.y, r4.z, r4.w};
      fold_warp<T, OP, QB>(acc, ks, vs, nq, tile_r);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nq * tile_r; i += blockDim.x) {
      const int j = i / tile_r, r = i - j * tile_r;
      const long long b = b0 + j;
      if (it.parts > 1) {
        scratch[((long long)it.slot * batch + b) * tile_r + r] = acc[i];
      } else if (row0 + r < num_segments) {
        out[(b * n_shards + it.shard) * num_segments + row0 + r] = acc[i];
      }
    }
    __syncthreads();
  }
  if (it.parts == 1) return;

  // Publish this item's partials, then count it in; the last to arrive
  // folds the window.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(arrivals + it.counter, 1) == it.parts - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (long long i = threadIdx.x; i < (long long)batch * tile_r; i += blockDim.x) {
    const long long b = i / tile_r;
    const int r = (int)(i - b * tile_r);
    if (row0 + r >= num_segments) continue;
    const T* p = scratch + ((long long)it.first_slot * batch + b) * tile_r + r;
    T v = __ldcg(p);
    for (int k = 1; k < it.parts; ++k) v = combine<T, OP>(v, __ldcg(p + (long long)k * batch * tile_r));
    out[(b * n_shards + it.shard) * num_segments + row0 + r] = v;
  }
  if (threadIdx.x == 0) arrivals[it.counter] = 0;
}

// The queries a block folds together: the least power of two >= batch,
// at most 8.
inline int pick_qb(int batch) { return batch >= 8 ? 8 : batch > 2 ? 4 : batch; }

template <typename T, int QB>
size_t smem_bytes(int tile_r) { return (size_t)QB * tile_r * sizeof(T); }

template <typename T, int OP, int QB>
cudaError_t launch(const int* items, int n_items, int* arrivals,
                   void* scratch, const int* rel, const void* vals, void* out,
                   int n_shards, int batch, long long num_lanes,
                   int num_segments, int tile_e, int tile_r,
                   cudaStream_t stream) {
  auto* kernel = segment_combine_kernel<T, OP, QB>;
  const size_t smem = smem_bytes<T, QB>(tile_r);
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<n_items, kThreads, smem, stream>>>(
      items, arrivals, static_cast<T*>(scratch), rel,
      static_cast<const T*>(vals), static_cast<T*>(out), n_shards, batch,
      num_lanes, num_segments, tile_e, tile_r);
  return cudaGetLastError();
}

template <typename T, int OP>
cudaError_t launch_any(const int* items, int n_items, int* arrivals,
                       void* scratch, const int* rel, const void* vals,
                       void* out, int n_shards, int batch, long long num_lanes,
                       int num_segments, int tile_e, int tile_r,
                       cudaStream_t stream) {
  switch (pick_qb(batch)) {
    case 1: return launch<T, OP, 1>(items, n_items, arrivals, scratch, rel, vals, out, n_shards, batch, num_lanes, num_segments, tile_e, tile_r, stream);
    case 2: return launch<T, OP, 2>(items, n_items, arrivals, scratch, rel, vals, out, n_shards, batch, num_lanes, num_segments, tile_e, tile_r, stream);
    case 4: return launch<T, OP, 4>(items, n_items, arrivals, scratch, rel, vals, out, n_shards, batch, num_lanes, num_segments, tile_e, tile_r, stream);
    default: return launch<T, OP, 8>(items, n_items, arrivals, scratch, rel, vals, out, n_shards, batch, num_lanes, num_segments, tile_e, tile_r, stream);
  }
}

}  // namespace

// Dynamic shared memory a launch over `batch` queries and tile_r rows
// needs, in bytes (the wrapper checks it against a block's 227 KB).
extern "C" long long gravfm_segment_combine_smem(int batch, int tile_r) {
  switch (pick_qb(batch)) {
    case 1: return (long long)smem_bytes<int, 1>(tile_r);
    case 2: return (long long)smem_bytes<int, 2>(tile_r);
    case 4: return (long long)smem_bytes<int, 4>(tile_r);
    default: return (long long)smem_bytes<int, 8>(tile_r);
  }
}

// C entry point, bound with ctypes; both wrappers launch it (K1 with one
// shard). items is the layout's work list ((n_items, 8) int32,
// kernels/layout.py:work_list) and arrivals its counters (0 between
// calls); scratch holds (slots, batch, tile_r) values for the split
// windows' partials. rel is (n_shards, num_lanes), vals (batch, n_shards,
// num_lanes), out (batch, n_shards, num_segments), all contiguous; tile_e
// is a multiple of 4 and every pointer 16-byte aligned. Launches on
// `stream`, does not synchronise, returns the cudaError_t of the launch
// (0 = cudaSuccess).
extern "C" int gravfm_segment_combine_windows(
    const int* items, int n_items, int* arrivals, void* scratch,
    const int* rel, const void* vals, void* out, int n_shards, int batch,
    long long num_lanes, int num_segments, int tile_e, int tile_r,
    int combiner, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype * 3 + combiner) {
    case kFloat32 * 3 + kAdd:
      return launch_any<float, kAdd>(items, n_items, arrivals, scratch, rel, vals, out, n_shards, batch, num_lanes, num_segments, tile_e, tile_r, s);
    case kFloat32 * 3 + kMin:
      return launch_any<float, kMin>(items, n_items, arrivals, scratch, rel, vals, out, n_shards, batch, num_lanes, num_segments, tile_e, tile_r, s);
    case kFloat32 * 3 + kMax:
      return launch_any<float, kMax>(items, n_items, arrivals, scratch, rel, vals, out, n_shards, batch, num_lanes, num_segments, tile_e, tile_r, s);
    case kInt32 * 3 + kAdd:
      return launch_any<int, kAdd>(items, n_items, arrivals, scratch, rel, vals, out, n_shards, batch, num_lanes, num_segments, tile_e, tile_r, s);
    case kInt32 * 3 + kMin:
      return launch_any<int, kMin>(items, n_items, arrivals, scratch, rel, vals, out, n_shards, batch, num_lanes, num_segments, tile_e, tile_r, s);
    case kInt32 * 3 + kMax:
      return launch_any<int, kMax>(items, n_items, arrivals, scratch, rel, vals, out, n_shards, batch, num_lanes, num_segments, tile_e, tile_r, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
