// Row gather for Hopper (sm_90a): out[j, :] = table[idx[j], :], with idx
// clamped to [0, N). Rows are copied as bytes, so any dtype passes through
// unchanged.
//
// Replaces tsdf_tpu/kernels/gather.py:row_gather_op (its
// _row_gather_kernel). The TPU version exists to turn each row into one DMA:
// the row indices ride scalar prefetch and a BlockSpec index map selects
// the source row. Here a block loads its own indices: 256 of them into
// shared memory, clamped, with one coalesced read; then its threads copy
// the 256 rows' bytes with the widest vector that divides the row (16 B
// for the four-float [depth, flow] rows of the SceneFusion correspondence
// lookup, 4 B for the three-float rows of the deformation field), so that
// the writes of a block are one contiguous run.
//
// What bounds it on this card: bytes. Per row it reads a 4 B index and
// row_bytes of table and writes row_bytes; the table reads are scattered,
// each one a whole row, so what the memory system moves beyond the count
// is the unused part of each 32 B sector a short row touches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 256;  // rows of output per block
constexpr int kThreads = 256;

template <typename V>
__global__ void row_gather_kernel(const V* __restrict__ table,
                                  const int32_t* __restrict__ idx,
                                  V* __restrict__ out, int64_t n_idx,
                                  int32_t n_rows, int64_t vec_per_row) {
  __shared__ int32_t rows[kRows];
  const int64_t j0 = (int64_t)blockIdx.x * kRows;
  const int64_t left = n_idx - j0;
  const int count = left < kRows ? (int)left : kRows;
  for (int r = threadIdx.x; r < count; r += blockDim.x) {
    const int32_t v = idx[j0 + r];
    rows[r] = min(max(v, 0), n_rows - 1);
  }
  __syncthreads();
  const int64_t total = (int64_t)count * vec_per_row;
  for (int64_t e = threadIdx.x; e < total; e += blockDim.x) {
    const int64_t r = e / vec_per_row;
    const int64_t k = e - r * vec_per_row;
    out[(j0 + r) * vec_per_row + k] = table[(int64_t)rows[r] * vec_per_row + k];
  }
}

template <typename V>
int launch(const void* table, const void* idx, void* out, int64_t n_idx,
           int32_t n_rows, int64_t row_bytes, cudaStream_t st) {
  const int64_t blocks = (n_idx + kRows - 1) / kRows;
  row_gather_kernel<V><<<(unsigned)blocks, kThreads, 0, st>>>(
      (const V*)table, (const int32_t*)idx, (V*)out, n_idx, n_rows,
      row_bytes / (int64_t)sizeof(V));
  return (int)cudaGetLastError();
}

}  // namespace

// table: n_rows rows of row_bytes bytes, contiguous; idx: n_idx int32;
// out: n_idx rows of row_bytes bytes. The vector width is the largest of
// 16, 8, 4, 2, 1 bytes that divides row_bytes and both base addresses.
extern "C" int tsdf_row_gather(const void* table, const void* idx, void* out,
                               long long n_idx, long long n_rows,
                               long long row_bytes, void* stream) {
  if (n_idx <= 0 || row_bytes <= 0) return (int)cudaSuccess;
  if (n_rows <= 0 || n_rows > 2147483647LL ||
      (n_idx + kRows - 1) / kRows > 2147483647LL) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const uintptr_t bits =
      (uintptr_t)table | (uintptr_t)out | (uintptr_t)row_bytes;
  const int32_t n = (int32_t)n_rows;
  if (bits % 16 == 0) return launch<uint4>(table, idx, out, n_idx, n, row_bytes, st);
  if (bits % 8 == 0) return launch<uint2>(table, idx, out, n_idx, n, row_bytes, st);
  if (bits % 4 == 0) return launch<uint32_t>(table, idx, out, n_idx, n, row_bytes, st);
  if (bits % 2 == 0) return launch<uint16_t>(table, idx, out, n_idx, n, row_bytes, st);
  return launch<uint8_t>(table, idx, out, n_idx, n, row_bytes, st);
}
