// Windowed lane gather for Hopper (sm_90a): out[s, c] = table[s, idx[s, c]]
// restricted, per tile of idx, to a window of the table's columns, plus a
// count of the in-range indices the windows missed. The result equals the
// full lane gather (gather.cu) exactly when that count is 0.
//
// Replaces tsdf_tpu/kernels/gather.py:lane_gather_windowed_op (its
// _lane_gather_windowed_kernel). The contract is the TPU kernel's: idx is
// cut into tiles of `bs` rows by 128 columns; a tile's window starts at
//   m0 = min((m >> 7) << 7, width - wb*128),
// m the tile's smallest in-range index (width - 1 if it has none), and
// spans wb*128 columns; an element is covered iff m0 <= idx < m0 + wb*128;
// a covered element reads table[s, idx], any other gives 0; an in-range
// element that is not covered counts as a miss; an out-of-range index
// gives 0 and never counts. Rows and columns beyond the arrays (the TPU
// kernel's padding, filled with an out-of-range index) take no part.
//
// On the TPU the window saved scans of 128-lane table blocks. Hopper
// gathers per thread, so the window is no copy here: it is only the rule
// that decides which elements read the table. A block takes one tile:
//   1. each thread loads its quads of the tile's indices (four consecutive
//      columns of one row, a 16-byte __ldcs where cols % 4 == 0 and idx and
//      out are 16-byte aligned)
//      and keeps kHeld of them in registers, taking the smallest in-range
//      index as it goes;
//   2. the block minimum: warp shuffles, one shared word a warp, one
//      barrier, and every thread folds the words itself;
//   3. each thread checks its own quads against the window and reads the
//      covered words in place through the read-only path (coherent indices
//      give coalesced row segments), writing 16 bytes with __stcs.
// A tile of more than kThreads * kHeld quads (bs > 64) reads the rest of
// its indices again in step 3, from L1/L2. Nothing is staged, so no tiling
// is refused. The block sums its misses and adds them with one atomicAdd
// where it counted any.
//
// What bounds it on this card: bytes. Per element a 4 B index read and 4 B
// written; of the table, the words the covered indices name. No thread
// divides per element: a quad slot q of a tile is row q / 32, columns
// 4 (q % 32) .. + 3. It moves 32-bit words, so f32 and i32 tables pass
// through bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLane = 128;
constexpr int kQuadsPerRow = kLane / 4;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kHeld = 4;  // quads a thread keeps in registers: bs 64

inline bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

struct Tile {
  const int32_t* idx;    // its first index
  uint32_t* out;         // its first output
  const uint32_t* tab;   // its first table row
  int n_rows, n_cols;    // inside the arrays
};

// Quad slot q of the tile; `none` (an out-of-range index) where the slot
// or one of its columns lies outside the arrays. HELD: a first read,
// streamed; else a read the tile makes again, kept in cache.
template <bool VEC, bool HELD>
__device__ __forceinline__ int4 load_quad(const Tile& t, int cols, int q,
                                          int32_t none) {
  int4 v = make_int4(none, none, none, none);
  const int r = q >> 5, c = (q & (kQuadsPerRow - 1)) << 2;
  if (r >= t.n_rows || c >= t.n_cols) return v;
  const int32_t* p = t.idx + (int64_t)r * cols + c;
  if constexpr (VEC) {
    const int4* p4 = reinterpret_cast<const int4*>(p);
    return HELD ? __ldcs(p4) : __ldg(p4);
  } else {
    v.x = __ldg(p);
    if (c + 1 < t.n_cols) v.y = __ldg(p + 1);
    if (c + 2 < t.n_cols) v.z = __ldg(p + 2);
    if (c + 3 < t.n_cols) v.w = __ldg(p + 3);
    return v;
  }
}

__device__ __forceinline__ int32_t in_range_min(int32_t m, int32_t j,
                                                int32_t width) {
  return (uint32_t)j < (uint32_t)width ? min(m, j) : m;
}

__device__ __forceinline__ int32_t quad_min(int32_t m, int4 v, int32_t width) {
  m = in_range_min(m, v.x, width);
  m = in_range_min(m, v.y, width);
  m = in_range_min(m, v.z, width);
  return in_range_min(m, v.w, width);
}

struct Window {
  uint32_t m0, span, width;
};

// One element: the covered word, else 0; counts an in-range miss.
__device__ __forceinline__ uint32_t take(const uint32_t* __restrict__ row,
                                         int32_t j, const Window& w,
                                         int& missed) {
  const bool covered = (uint32_t)j - w.m0 < w.span;
  missed += ((uint32_t)j < w.width) & !covered;
  return covered ? __ldg(row + j) : 0u;
}

template <bool VEC>
__device__ __forceinline__ void gather_quad(const Tile& t, int cols, int q,
                                            int4 v, const Window& w,
                                            int& missed) {
  const int r = q >> 5, c = (q & (kQuadsPerRow - 1)) << 2;
  if (r >= t.n_rows || c >= t.n_cols) return;
  const uint32_t* row = t.tab + (int64_t)r * w.width;
  uint32_t* p = t.out + (int64_t)r * cols + c;
  const uint32_t a = take(row, v.x, w, missed), b = take(row, v.y, w, missed),
                 d = take(row, v.z, w, missed), e = take(row, v.w, w, missed);
  if constexpr (VEC) {
    __stcs(reinterpret_cast<uint4*>(p), make_uint4(a, b, d, e));
  } else {
    p[0] = a;
    if (c + 1 < t.n_cols) p[1] = b;
    if (c + 2 < t.n_cols) p[2] = d;
    if (c + 3 < t.n_cols) p[3] = e;
  }
}

// VEC: cols % 4 == 0 and idx, out 16-byte aligned, so every quad is one
// aligned 16-byte word of idx and of out (tiles start on 128 columns).
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
lane_gather_windowed_kernel(const uint32_t* __restrict__ table,
                            const int32_t* __restrict__ idx,
                            uint32_t* __restrict__ out,
                            int32_t* __restrict__ miss, int rows, int cols,
                            int width, int bs, int wb, uint32_t col_tiles) {
  __shared__ int32_t warp_min[kWarps];
  __shared__ int32_t warp_miss[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const uint32_t rt = blockIdx.x / col_tiles;
  const int row0 = (int)rt * bs;
  const int col0 = (int)(blockIdx.x - rt * col_tiles) * kLane;
  const int64_t first = (int64_t)row0 * cols + col0;
  const Tile t{idx + first, out + first, table + (int64_t)row0 * width,
               min(bs, rows - row0), min(kLane, cols - col0)};
  const int slots = t.n_rows * kQuadsPerRow;

  // 1. the indices, kHeld quads of them kept; their in-range minimum
  int4 held[kHeld];
  int32_t m = width - 1;
#pragma unroll
  for (int u = 0; u < kHeld; ++u) {
    held[u] = load_quad<VEC, true>(t, cols, threadIdx.x + u * kThreads, width);
    m = quad_min(m, held[u], width);
  }
  for (int q = threadIdx.x + kHeld * kThreads; q < slots; q += kThreads)
    m = quad_min(m, load_quad<VEC, false>(t, cols, q, width), width);

  // 2. the tile's minimum and its window
  m = __reduce_min_sync(0xffffffffu, m);
  if (lane == 0) warp_min[warp] = m;
  __syncthreads();
  m = warp_min[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) m = min(m, warp_min[i]);
  const int span = wb * kLane;
  const Window w{(uint32_t)min((m >> 7) << 7, width - span), (uint32_t)span,
                 (uint32_t)width};

  // 3. the covered words, in place
  int missed = 0;
#pragma unroll
  for (int u = 0; u < kHeld; ++u)
    gather_quad<VEC>(t, cols, threadIdx.x + u * kThreads, held[u], w, missed);
  for (int q = threadIdx.x + kHeld * kThreads; q < slots; q += kThreads)
    gather_quad<VEC>(t, cols, q, load_quad<VEC, false>(t, cols, q, width), w,
                     missed);
  missed = __reduce_add_sync(0xffffffffu, missed);
  if (lane == 0) warp_miss[warp] = missed;
  __syncthreads();
  if (threadIdx.x == 0) {
    int32_t sum = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) sum += warp_miss[i];
    if (sum > 0) atomicAdd(miss, sum);
  }
}

}  // namespace

// table: (rows, width) 32-bit words, contiguous, width a multiple of 128;
// idx, out: (rows, cols); miss: one int32 the caller zeroed. bs: rows per
// tile; wb: window width in blocks of 128 columns, at most width / 128.
// A block a tile.
extern "C" int tsdf_lane_gather_windowed(const void* table, const void* idx,
                                         void* out, void* miss, int rows,
                                         int cols, int width, int bs, int wb,
                                         void* stream) {
  if (rows <= 0 || cols <= 0) return (int)cudaSuccess;
  if (bs <= 0 || wb <= 0 || width % kLane != 0 || wb * kLane > width) {
    return (int)cudaErrorInvalidValue;
  }
  const bool vector = cols % 4 == 0 && aligned16(idx) && aligned16(out);
  const int64_t col_tiles = (cols + kLane - 1) / kLane;
  const int64_t tiles = (rows + (int64_t)bs - 1) / bs * col_tiles;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const cudaStream_t st = (cudaStream_t)stream;
  if (vector) {
    lane_gather_windowed_kernel<true><<<(unsigned)tiles, kThreads, 0, st>>>(
        (const uint32_t*)table, (const int32_t*)idx, (uint32_t*)out,
        (int32_t*)miss, rows, cols, width, bs, wb, (uint32_t)col_tiles);
  } else {
    lane_gather_windowed_kernel<false><<<(unsigned)tiles, kThreads, 0, st>>>(
        (const uint32_t*)table, (const int32_t*)idx, (uint32_t*)out,
        (int32_t*)miss, rows, cols, width, bs, wb, (uint32_t)col_tiles);
  }
  return (int)cudaGetLastError();
}
