// The gather-roofline probe for Hopper (sm_90a): the rate of in-row
// gathers from a table held on chip.
//
// Replaces tools/probe_gather_roofline.py:bench_kernel (its _kern): for
// every element (r, c) of a (rows, 128) float32 table,
// out[r, c] = sum over i < g of tab[r, clip(idx[r, c] + i, 0, 127)], the
// sum taken in the order of i. The TPU probe held (512, 128) tiles in VMEM
// and measured the vector unit's dynamic gather, the ceiling of its
// integrate's candidate lookups. Rows are independent, so that tile means
// nothing here: a block takes a chunk of 64 rows (32 KB), stages it with
// coalesced 16-byte loads into shared memory, and gathers from there (a
// block a chunk: every SM works, about four chunks each at 32768 rows). Each gather stays one
// 4-byte shared-memory load, so the rate it reaches is the card's
// shared-memory gather ceiling (random columns of a row: bank conflicts as
// chance gives them).
//
// What bounds it: the shared-memory wavefronts. A warp gathers 32 columns
// of one row and takes as many wavefronts as the most distinct words that
// fall in one bank (kernels/gather.py:probe_wavefronts counts them); an SM
// serves one a clock. The table, the indices and the output are read or
// written once (12 B an element). A thread sums kSums rows at once, so
// that kSums chains of dependent adds are in flight; each sum still runs
// in the order of i. With --fmad=false the sums round as the plain twin's
// (kernels/gather.py:gather_probe_plain).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWidth = 128;     // a table row: the TPU's lane width
constexpr int kChunkRows = 64;  // rows a block stages and gathers
constexpr int kThreads = 256;
constexpr int kRowStep = kThreads / kWidth;
constexpr int kSums = 4;  // rows a thread sums at once
static_assert(kChunkRows % (kRowStep * kSums) == 0, "rows a pass");

__global__ void __launch_bounds__(kThreads)
probe_gather_kernel(const float* __restrict__ tab,
                    const int32_t* __restrict__ idx,
                    float* __restrict__ out, int64_t rows, int g) {
  __shared__ float4 stage[kChunkRows * kWidth / 4];
  const float* s = reinterpret_cast<const float*>(stage);
  const int64_t row0 = (int64_t)blockIdx.x * kChunkRows;
  const int64_t left = rows - row0;
  const int n = left < kChunkRows ? (int)left : kChunkRows;
  const float4* src = reinterpret_cast<const float4*>(tab + row0 * kWidth);
  for (int e = threadIdx.x; e < n * kWidth / 4; e += kThreads) {
    stage[e] = __ldcs(src + e);
  }
  __syncthreads();
  const int c = threadIdx.x % kWidth;
  const int64_t at0 = row0 * kWidth + c;
  // rows r, r + kRowStep, ...: kSums of them a pass; a row past the chunk
  // gathers from the (unwritten) rest of the stage and is not stored
  for (int r = threadIdx.x / kWidth; r < n; r += kRowStep * kSums) {
    int base[kSums];
    float acc[kSums];
#pragma unroll
    for (int k = 0; k < kSums; ++k) {
      const int rk = r + k * kRowStep;
      base[k] = rk < n ? __ldcs(idx + at0 + rk * kWidth) : 0;
      acc[k] = 0.0f;
    }
    for (int i = 0; i < g; ++i) {
#pragma unroll
      for (int k = 0; k < kSums; ++k) {
        const float* row = s + (r + k * kRowStep) * kWidth;
        acc[k] = acc[k] + row[min(max(base[k] + i, 0), kWidth - 1)];
      }
    }
#pragma unroll
    for (int k = 0; k < kSums; ++k) {
      const int rk = r + k * kRowStep;
      if (rk < n) __stcs(out + at0 + rk * kWidth, acc[k]);
    }
  }
}

}  // namespace

// tab, idx, out: (rows, 128), contiguous, tab 16-byte aligned. A block a
// chunk of kChunkRows rows.
extern "C" int tsdf_probe_gather(const void* tab, const void* idx, void* out,
                                 long long rows, int g, void* stream) {
  if (rows <= 0) return (int)cudaSuccess;
  const long long blocks = (rows + kChunkRows - 1) / kChunkRows;
  probe_gather_kernel<<<(unsigned)blocks, kThreads, 0,
                        (cudaStream_t)stream>>>(
      (const float*)tab, (const int32_t*)idx, (float*)out, rows, g);
  return (int)cudaGetLastError();
}
