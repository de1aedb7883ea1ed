// The gather-roofline probe for Hopper (sm_90a): the rate of in-row
// gathers from a table tile held on chip.
//
// Replaces tools/probe_gather_roofline.py:bench_kernel (its _kern): for
// every (512, 128) tile of a float32 table, and every element (r, c),
// out[r, c] = sum over i < g of tab[r, clip(idx[r, c] + i, 0, 127)], the
// sum taken in the order of i. The TPU probe held each tile in VMEM and
// measured the vector unit's dynamic gather, the ceiling of its integrate's
// candidate lookups. Here one block takes one tile. A tile is 256 KB, more
// than a block's 227 KB of shared memory, so the block stages it 64 rows
// (32 KB) at a time, with coalesced 16-byte loads, and every gather reads
// shared memory: the rate it reaches is the card's shared-memory gather
// ceiling (random columns of a row: bank conflicts as chance gives them).
//
// What bounds it: the table, the indices and the output are read or
// written once (12 B an element); the g gathers, adds and clips an
// element costs happen on chip. With --fmad=false the sums round as the
// plain twin's (kernels/gather.py:gather_probe_plain).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWidth = 128;   // a table row: the TPU's lane width
constexpr int kTileRows = 512;
constexpr int kChunkRows = 64;  // rows staged in shared memory at a time
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
probe_gather_kernel(const float* __restrict__ tab,
                    const int32_t* __restrict__ idx,
                    float* __restrict__ out, int64_t rows, int g) {
  __shared__ float4 stage[kChunkRows * kWidth / 4];
  const float* s = reinterpret_cast<const float*>(stage);
  const int c = threadIdx.x % kWidth;
  const int r_first = threadIdx.x / kWidth;
  constexpr int kRowStep = kThreads / kWidth;
  for (int chunk = 0; chunk < kTileRows; chunk += kChunkRows) {
    const int64_t row0 = (int64_t)blockIdx.x * kTileRows + chunk;
    if (row0 >= rows) break;
    const int64_t left = rows - row0;
    const int n = left < kChunkRows ? (int)left : kChunkRows;
    const float4* src = reinterpret_cast<const float4*>(tab + row0 * kWidth);
    for (int e = threadIdx.x; e < n * kWidth / 4; e += kThreads) {
      stage[e] = src[e];
    }
    __syncthreads();
    for (int r = r_first; r < n; r += kRowStep) {
      const int64_t at = (row0 + r) * kWidth + c;
      const int base = idx[at];
      const float* row = s + r * kWidth;
      float acc = 0.0f;
      for (int i = 0; i < g; ++i) {
        acc = acc + row[min(max(base + i, 0), kWidth - 1)];
      }
      out[at] = acc;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int tsdf_probe_gather(const void* tab, const void* idx, void* out,
                                 long long rows, int g, void* stream) {
  const long long blocks = (rows + kTileRows - 1) / kTileRows;
  if (blocks == 0) return (int)cudaSuccess;
  probe_gather_kernel<<<(unsigned)blocks, kThreads, 0,
                        (cudaStream_t)stream>>>(
      (const float*)tab, (const int32_t*)idx, (float*)out, rows, g);
  return (int)cudaGetLastError();
}
