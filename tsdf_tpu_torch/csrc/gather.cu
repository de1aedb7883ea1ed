// Lane gather for Hopper (sm_90a): out[s, c] = table[s, idx[s, c]], and 0
// where idx[s, c] is outside [0, W).
//
// Replaces tsdf_tpu/kernels/gather.py:lane_gather_op. The TPU's only
// gather is a 128-lane dynamic_gather inside one vector register, so the
// Pallas kernel scanned the table 128 lanes at a time and selected by
// block. Hopper gathers per thread.
//
// It moves 32-bit words whatever their type, so float32 and int32 tables
// (the marching-cubes triangle table, vertex counts and voxel indices)
// pass through bit for bit, with no float round trip.
//
// What bounds it on this card: bytes. Per output element it reads a 4 B
// index and writes 4 B, and at 512^3 those streams are 2.4 GB of the
// 2.9 GB the marching-cubes lookups must move; the table words are the
// rest. So the indices and outputs are streamed at full width: a thread
// takes four consecutive outputs, with one 16-byte index load and one
// 16-byte store where the pointers are 16-byte aligned and a row's four
// outputs cannot straddle two rows, and keeps kUnroll such quads in flight.
// No thread divides a 64-bit index: the row of an output comes from its
// block's tile and a 32-bit split.
//
// The caller's tables come in three kinds, and the wrapper picks one of
// three launches for them (kernels/gather.py:lane_gather_launch):
//   * kBroadcast: one row broadcast over every row (row stride 0) that fits
//     in shared memory (the vertex counts, 1 KB; the triangle table, 24 KB).
//     The row is irrelevant, so the gather is one flat stream. A block
//     stages the table once with 16-byte loads and walks many quads on a
//     persistent grid (a few blocks an SM), so the staging is paid per
//     block, not per row; lookups read shared memory.
//   * kRows: narrow contiguous rows (at most 64 words: the 36-word slot
//     vertices and the 24-word slot voxels of each cube). A block takes a
//     tile of rows, copies their table words into shared memory with
//     coalesced 16-byte loads, and gathers the tile's outputs from there.
//   * kDirect: anything else (the 1.2 MB model depth image of the ICP
//     association, broadcast; wide rows). Tiles of rows as kRows, but the
//     table is read in place through the read-only path; a table that
//     small stays in the 50 MB L2.
//
// tsdf_lane_gather_if_missed is the exact fallback of the windowed gather
// (gather_windowed.cu, kernels/gather.py:lane_gather_checked): the kDirect
// body behind a guard. Launched unconditionally after the windowed kernel,
// every block first reads the windowed kernel's miss word and exits when it
// is 0; else the launch rewrites the whole output at the rate of kDirect.
// So the decision is taken on the device and the host reads nothing (the
// lax.cond of the JAX lane_gather_checked). Its grid is capped at the
// blocks the card holds at once, each walking tiles with a grid stride, so
// the launch that finds no miss costs one wave of blocks that read one word.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// the launch codes of kernels/gather.py:lane_gather_launch
constexpr int kBroadcast = 0;
constexpr int kRows = 1;
constexpr int kDirect = 2;

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // quads in flight per thread

__device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

// Copy n words from global memory into shared memory, 16 bytes a load
// where the source is aligned (dst is the 16-byte aligned dynamic base).
__device__ __forceinline__ void stage(const uint32_t* __restrict__ src,
                                      uint32_t* dst, int n) {
  int done = 0;
  if (aligned16(src)) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (int i = threadIdx.x; i < n / 4; i += blockDim.x) d4[i] = __ldg(s4 + i);
    done = n / 4 * 4;
  }
  for (int i = done + threadIdx.x; i < n; i += blockDim.x) dst[i] = __ldg(src + i);
}

// The word idx names in one row: shared memory, or global through the
// read-only path.
template <bool SHARED>
__device__ __forceinline__ uint32_t pick(const uint32_t* row, int32_t j,
                                         int32_t width) {
  if ((uint32_t)j >= (uint32_t)width) return 0u;
  if constexpr (SHARED) {
    return row[j];
  } else {
    return __ldg(row + j);
  }
}

// kBroadcast: out[i] = table[idx[i]] over the flat stream of n outputs,
// the table (width words) staged in shared memory by every block.
__global__ void __launch_bounds__(kThreads)
gather_broadcast_kernel(const uint32_t* __restrict__ table,
                        const int32_t* __restrict__ idx,
                        uint32_t* __restrict__ out, int64_t n, int width) {
  extern __shared__ uint4 smem[];
  uint32_t* tab = reinterpret_cast<uint32_t*>(smem);
  stage(table, tab, width);
  __syncthreads();
  const int64_t step = (int64_t)gridDim.x * kThreads * kUnroll;
  const int64_t first = (int64_t)blockIdx.x * kThreads * kUnroll + threadIdx.x;
  int64_t vec_end = 0;
  if (aligned16(idx) && aligned16(out)) {
    const int64_t nq = n / 4;
    const int4* idx4 = reinterpret_cast<const int4*>(idx);
    uint4* out4 = reinterpret_cast<uint4*>(out);
    for (int64_t q0 = first; q0 < nq; q0 += step) {
      int4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t q = q0 + u * kThreads;
        if (q < nq) v[u] = __ldcs(idx4 + q);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t q = q0 + u * kThreads;
        if (q < nq)
          __stcs(out4 + q, make_uint4(pick<true>(tab, v[u].x, width),
                                      pick<true>(tab, v[u].y, width),
                                      pick<true>(tab, v[u].z, width),
                                      pick<true>(tab, v[u].w, width)));
      }
    }
    vec_end = nq * 4;
  }
  // the scalar rest: all of it when a pointer is not aligned, else n % 4
  for (int64_t i = vec_end + (int64_t)blockIdx.x * kThreads + threadIdx.x;
       i < n; i += (int64_t)gridDim.x * kThreads)
    out[i] = pick<true>(tab, idx[i], width);
}

// kRows (STAGE) and kDirect: the tile of rows [tile * tile_rows, ...) and
// their outputs, tile_rows * cols < 2^31 (the wrapper checks). STAGE
// copies the tile's table rows into the dynamic shared memory smem.
template <bool STAGE>
__device__ __forceinline__ void gather_rows_tile(
    const uint32_t* __restrict__ table, const int32_t* __restrict__ idx,
    uint32_t* __restrict__ out, int64_t rows, int cols, int width,
    int64_t row_stride, int tile_rows, int64_t tile, uint4* smem) {
  const int64_t s0 = tile * tile_rows;
  const int nr = (int)min((int64_t)tile_rows, rows - s0);
  const uint32_t n = (uint32_t)nr * (uint32_t)cols;
  const uint32_t* src = table + s0 * row_stride;
  const uint32_t* tab = reinterpret_cast<const uint32_t*>(smem);
  if constexpr (STAGE) {
    stage(src, reinterpret_cast<uint32_t*>(smem), nr * width);
    __syncthreads();
  }
  // row r of this tile: in shared memory, or in place
  auto row = [&](uint32_t r) -> const uint32_t* {
    if constexpr (STAGE) {
      return tab + r * (uint32_t)width;
    } else {
      return src + (int64_t)r * row_stride;
    }
  };
  const int32_t* tidx = idx + s0 * cols;
  uint32_t* tout = out + s0 * cols;
  // quads stay inside one row when cols % 4 == 0, and the tile then starts
  // on a multiple of 4 outputs
  if (cols % 4 == 0 && aligned16(idx) && aligned16(out)) {
    const uint32_t nq = n / 4, ucols = (uint32_t)cols;
    const int4* idx4 = reinterpret_cast<const int4*>(tidx);
    uint4* out4 = reinterpret_cast<uint4*>(tout);
    for (uint32_t q0 = threadIdx.x; q0 < nq; q0 += kThreads * kUnroll) {
      int4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const uint32_t q = q0 + u * kThreads;
        if (q < nq) v[u] = __ldcs(idx4 + q);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const uint32_t q = q0 + u * kThreads;
        if (q < nq) {
          const uint32_t* r = row(4 * q / ucols);
          __stcs(out4 + q, make_uint4(pick<STAGE>(r, v[u].x, width),
                                      pick<STAGE>(r, v[u].y, width),
                                      pick<STAGE>(r, v[u].z, width),
                                      pick<STAGE>(r, v[u].w, width)));
        }
      }
    }
    return;
  }
  for (uint32_t e = threadIdx.x; e < n; e += kThreads)
    tout[e] = pick<STAGE>(row(e / (uint32_t)cols), tidx[e], width);
}

// kRows (STAGE) and kDirect: block b owns tile b.
template <bool STAGE>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const uint32_t* __restrict__ table,
                   const int32_t* __restrict__ idx,
                   uint32_t* __restrict__ out, int64_t rows, int cols,
                   int width, int64_t row_stride, int tile_rows) {
  extern __shared__ uint4 smem[];
  gather_rows_tile<STAGE>(table, idx, out, rows, cols, width, row_stride,
                          tile_rows, blockIdx.x, smem);
}

// The guarded fallback of the windowed gather: kDirect over tiles
// blockIdx.x, + gridDim.x, ..., only where *only_if is not 0.
__global__ void __launch_bounds__(kThreads)
lane_gather_if_missed_kernel(const uint32_t* __restrict__ table,
                             const int32_t* __restrict__ idx,
                             uint32_t* __restrict__ out, int64_t rows,
                             int cols, int width, int64_t row_stride,
                             int tile_rows, int64_t tiles,
                             const int32_t* __restrict__ only_if) {
  if (*only_if == 0) return;
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x)
    gather_rows_tile<false>(table, idx, out, rows, cols, width, row_stride,
                            tile_rows, tile, nullptr);
}

// The blocks of `kernel` (kThreads each, `shared` dynamic bytes) that the
// current device holds at once.
template <typename Kernel>
int64_t resident_blocks(Kernel kernel, size_t shared) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                shared);
  return (int64_t)(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
}

int launch_broadcast(const void* table, const void* idx, void* out,
                     int64_t n, int width, cudaStream_t st) {
  const size_t shared = (size_t)width * 4;
  const int64_t per_block = (int64_t)kThreads * kUnroll * 4;
  int64_t blocks = (n + per_block - 1) / per_block;
  const int64_t resident = resident_blocks(gather_broadcast_kernel, shared);
  if (blocks > resident) blocks = resident;
  gather_broadcast_kernel<<<(unsigned)blocks, kThreads, shared, st>>>(
      (const uint32_t*)table, (const int32_t*)idx, (uint32_t*)out, n, width);
  return (int)cudaGetLastError();
}

}  // namespace

// launch: kBroadcast, kRows or kDirect; tile_rows: the rows a block of kRows
// or kDirect owns (kernels/gather.py:lane_gather_launch picks both).
extern "C" int tsdf_lane_gather(const void* table, const void* idx, void* out,
                                long long rows, long long cols,
                                long long width, long long row_stride,
                                int launch, int tile_rows, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int64_t n = (int64_t)rows * cols;
  if (n <= 0) return (int)cudaSuccess;
  if (launch == kBroadcast)
    return launch_broadcast(table, idx, out, n, (int)width, st);
  if ((launch != kRows && launch != kDirect) || tile_rows <= 0)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((rows + tile_rows - 1) / tile_rows);
  if (launch == kRows) {
    gather_rows_kernel<true><<<blocks, kThreads,
                               (size_t)tile_rows * width * 4, st>>>(
        (const uint32_t*)table, (const int32_t*)idx, (uint32_t*)out, rows,
        (int)cols, (int)width, row_stride, tile_rows);
  } else {
    gather_rows_kernel<false><<<blocks, kThreads, 0, st>>>(
        (const uint32_t*)table, (const int32_t*)idx, (uint32_t*)out, rows,
        (int)cols, (int)width, row_stride, tile_rows);
  }
  return (int)cudaGetLastError();
}

// only_if: one int32 on the device; the launch writes nothing when it is 0.
// After the stream: tile_rows, the rows of a kDirect tile
// (kernels/gather.py:lane_gather_launch). The grid is the tiles, at most
// the blocks the card holds at once.
extern "C" int tsdf_lane_gather_if_missed(const void* table, const void* idx,
                                          void* out, const void* only_if,
                                          long long rows, long long cols,
                                          long long width,
                                          long long row_stride, void* stream,
                                          int tile_rows) {
  if (rows <= 0 || cols <= 0) return (int)cudaSuccess;
  if (tile_rows <= 0) return (int)cudaErrorInvalidValue;
  const int64_t tiles = (rows + tile_rows - 1) / tile_rows;
  int64_t blocks = resident_blocks(lane_gather_if_missed_kernel, 0);
  if (blocks > tiles) blocks = tiles;
  lane_gather_if_missed_kernel<<<(unsigned)blocks, kThreads, 0,
                                 (cudaStream_t)stream>>>(
      (const uint32_t*)table, (const int32_t*)idx, (uint32_t*)out, rows,
      (int)cols, (int)width, row_stride, tile_rows, tiles,
      (const int32_t*)only_if);
  return (int)cudaGetLastError();
}

// Shared by every entry point's Python wrapper to name a launch error.
extern "C" const char* tsdf_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
