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
// On the TPU the window saved scans of 128-lane table blocks. On Hopper
// the reason for a window is another one: a block stages its tile's window
// (bs rows by wb*128 words, 64 KB at the defaults) into shared memory with
// coalesced loads and gathers from there, in place of scattered reads of
// device memory. One block per tile: a pass over the tile's indices for
// the minimum (warp shuffles, then one word per warp through shared
// memory), the staging loop, a second pass that gathers from shared memory
// and counts, and one atomicAdd from a block that counted a miss.
//
// What bounds it on this card: bytes. Per element a 4 B index (read twice,
// the second time from L1/L2) and 4 B written; per tile bs*wb*512 B of
// table, all of it whether the tile needs it or not, which is more than a
// direct gather moves when the indices of a tile are few or clustered.
// It moves 32-bit words, so f32 and i32 tables pass through bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLane = 128;
constexpr int kThreads = 256;

__global__ void lane_gather_windowed_kernel(
    const uint32_t* __restrict__ table, const int32_t* __restrict__ idx,
    uint32_t* __restrict__ out, int32_t* __restrict__ miss, int rows, int cols,
    int width, int bs, int wb) {
  extern __shared__ uint32_t window[];  // bs rows of wb*128 words
  __shared__ int32_t warp_word[kThreads / 32];
  __shared__ int32_t tile_min;

  const int row0 = blockIdx.x * bs;
  const int col0 = blockIdx.y * kLane;
  const int n_rows = min(bs, rows - row0);
  const int n_cols = min(kLane, cols - col0);
  const int n = n_rows * n_cols;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // pass 1: the tile's smallest in-range index
  int32_t m = width - 1;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int r = e / n_cols;
    const int c = e - r * n_cols;
    const int32_t j = idx[(int64_t)(row0 + r) * cols + col0 + c];
    if (j >= 0 && j < width) m = min(m, j);
  }
  for (int d = 16; d > 0; d >>= 1) m = min(m, __shfl_xor_sync(0xffffffffu, m, d));
  if (lane == 0) warp_word[warp] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    int32_t t = warp_word[0];
    for (int k = 1; k < kThreads / 32; ++k) t = min(t, warp_word[k]);
    tile_min = t;
  }
  __syncthreads();
  const int span = wb * kLane;
  const int m0 = min((tile_min >> 7) << 7, width - span);

  // stage the window: rows [row0, row0 + n_rows), columns [m0, m0 + span)
  const int staged = n_rows * span;
  for (int e = threadIdx.x; e < staged; e += blockDim.x) {
    const int r = e / span;
    const int c = e - r * span;
    window[e] = table[(int64_t)(row0 + r) * width + m0 + c];
  }
  __syncthreads();

  // pass 2: gather from shared memory, count the misses
  int missed = 0;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int r = e / n_cols;
    const int c = e - r * n_cols;
    const int64_t at = (int64_t)(row0 + r) * cols + col0 + c;
    const int32_t j = idx[at];
    const bool in_range = j >= 0 && j < width;
    const bool covered = j >= m0 && j < m0 + span;
    out[at] = covered ? window[r * span + (j - m0)] : 0u;
    missed += (in_range && !covered) ? 1 : 0;
  }
  for (int d = 16; d > 0; d >>= 1) missed += __shfl_xor_sync(0xffffffffu, missed, d);
  __syncthreads();  // warp_word is reused
  if (lane == 0) warp_word[warp] = missed;
  __syncthreads();
  if (threadIdx.x == 0) {
    int32_t t = 0;
    for (int k = 0; k < kThreads / 32; ++k) t += warp_word[k];
    if (t > 0) atomicAdd(miss, t);
  }
}

}  // namespace

// table: (rows, width) 32-bit words, contiguous, width a multiple of 128;
// idx, out: (rows, cols); miss: one int32 the caller zeroed. bs: rows per
// tile; wb: window width in blocks of 128 columns, at most width / 128.
extern "C" int tsdf_lane_gather_windowed(const void* table, const void* idx,
                                         void* out, void* miss, int rows,
                                         int cols, int width, int bs, int wb,
                                         void* stream) {
  if (rows <= 0 || cols <= 0) return (int)cudaSuccess;
  if (bs <= 0 || wb <= 0 || width % kLane != 0 || wb * kLane > width) {
    return (int)cudaErrorInvalidValue;
  }
  const int row_tiles = (rows + bs - 1) / bs;
  const int col_tiles = (cols + kLane - 1) / kLane;
  if (col_tiles > 65535) return (int)cudaErrorInvalidConfiguration;
  const size_t shared = (size_t)bs * wb * kLane * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      lane_gather_windowed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shared);
  if (err != cudaSuccess) return (int)err;
  lane_gather_windowed_kernel<<<dim3(row_tiles, col_tiles), kThreads, shared,
                                (cudaStream_t)stream>>>(
      (const uint32_t*)table, (const int32_t*)idx, (uint32_t*)out,
      (int32_t*)miss, rows, cols, width, bs, wb);
  return (int)cudaGetLastError();
}
