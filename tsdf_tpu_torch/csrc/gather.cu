// Lane gather for Hopper (sm_90a): out[s, c] = table[s, idx[s, c]], and 0
// where idx[s, c] is outside [0, W).
//
// Replaces tsdf_tpu/kernels/gather.py:lane_gather_op. The TPU's only
// gather is a 128-lane dynamic_gather inside one vector register, so the
// Pallas kernel scanned the table 128 lanes at a time and selected by
// block. Hopper gathers per thread: one thread per output element loads
// its index and the word it names.
//
// It moves 32-bit words whatever their type, so float32 and int32 tables
// (the marching-cubes triangle table, vertex counts and voxel indices)
// pass through bit for bit, with no float round trip.
//
// What bounds it on this card: bytes. Per output element it reads a 4 B
// index and writes 4 B; the table read is a gather, but the callers'
// tables are either tiny and broadcast (row stride 0, a few KB that stay
// in L1/L2) or narrow rows (12-36 words) next to the output row being
// written, so consecutive threads touch neighbouring lines.
//
// tsdf_lane_gather_if_missed is the same kernel behind a guard: every
// thread first reads one int32 on the device and returns when it is 0. It
// is the exact fallback of the windowed gather (gather_windowed.cu,
// kernels/gather.py:lane_gather_checked): launched unconditionally after
// it, it rewrites the output only when the windowed kernel counted a miss,
// so the decision is taken on the device and the host reads nothing (the
// lax.cond of the JAX lane_gather_checked).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void lane_gather_kernel(const uint32_t* __restrict__ table,
                                   const int32_t* __restrict__ idx,
                                   uint32_t* __restrict__ out, int64_t n,
                                   int64_t cols, int64_t width,
                                   int64_t row_stride,
                                   const int32_t* __restrict__ only_if) {
  if (only_if != nullptr && *only_if == 0) return;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int64_t s = i / cols;
    const int32_t j = idx[i];
    out[i] = (j >= 0 && j < width) ? table[s * row_stride + j] : 0u;
  }
}

}  // namespace

namespace {

int launch_lane_gather(const void* table, const void* idx, void* out,
                       long long rows, long long cols, long long width,
                       long long row_stride, const void* only_if,
                       void* stream) {
  const int64_t n = (int64_t)rows * cols;
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > (1 << 20)) blocks = 1 << 20;  // grid-stride beyond this
  lane_gather_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)table, (const int32_t*)idx, (uint32_t*)out, n, cols,
      width, row_stride, (const int32_t*)only_if);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tsdf_lane_gather(const void* table, const void* idx, void* out,
                                long long rows, long long cols,
                                long long width, long long row_stride,
                                void* stream) {
  return launch_lane_gather(table, idx, out, rows, cols, width, row_stride,
                            nullptr, stream);
}

// only_if: one int32 on the device; the launch writes nothing when it is 0.
extern "C" int tsdf_lane_gather_if_missed(const void* table, const void* idx,
                                          void* out, const void* only_if,
                                          long long rows, long long cols,
                                          long long width,
                                          long long row_stride, void* stream) {
  return launch_lane_gather(table, idx, out, rows, cols, width, row_stride,
                            only_if, stream);
}

// Shared by every entry point's Python wrapper to name a launch error.
extern "C" const char* tsdf_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
