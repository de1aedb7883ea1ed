// Row gather for Hopper (sm_90a): out[j, :] = table[clamp(idx[j], 0, N-1), :].
// Rows are copied as bytes, so any dtype passes through unchanged.
//
// Replaces tsdf_tpu/kernels/gather.py:row_gather_op (its
// _row_gather_kernel). On the TPU each row is one DMA: the row indices ride
// scalar prefetch and a BlockSpec index map selects the source row. Here
// nothing is staged: a thread loads its indices, clamps them in registers,
// issues all of its row reads through the read-only path (ld.global.nc)
// before any store, and stores the rows with st.global.cs (evict first:
// the output, which the kernel never reads, should not push the table's
// rows out of L2). There is no shared memory, no barrier and no division
// on the device.
//
// The two widths of the SceneFusion path are compiled instances:
//   kRows16: 16-byte rows (the [depth, flow] rows of the correspondence
//            lookup). A warp takes 32 x kRows16PerThread consecutive rows,
//            lane l the rows l, l + 32, ...: every index load and every
//            16-byte row store of the warp covers 32 consecutive elements.
//   kRows12: 12-byte rows (the deformation field's three floats, the taps
//            of deform_points). A thread takes a pair of consecutive rows:
//            one 8-byte index load, each row read as one 8-byte and one
//            4-byte load (in the order the row's own 8-byte alignment
//            allows), the pair's 24 bytes stored as three 8-byte words. An
//            idx base that is not 8-byte aligned loads its indices one at a
//            time (the instance kRows12 + kScalarIdx); an odd J leaves one
//            row to the first block's first thread.
// Any other width, or bases these cannot take, runs the generic instance:
// the widest word that divides the row and both bases, a 2-D block of
// bx x by threads (bx lanes over a row's words, a power of two up to 32;
// by rows) and 32-bit word counters. tsdf_row_gather_instance reports the
// choice, which is made here from the width and the pointers.
//
// What bounds it on this card: bytes. Per row it reads a 4 B index and
// writes row_bytes; of the table it reads the distinct rows the indices
// name. Repeated rows (the correspondence lookup's dead slots all read
// pixel 0, and neighbouring vertices share voxels) hit L1 through the
// read-only path. A sweep on the H100 (PERF.md §6) chose the mappings:
// 16-byte rows stored 64 contiguous bytes a thread ran 1.8x slower than
// lanes 32 rows apart, and a 12-byte row read as three words (a load
// instruction each, scattered) ran 1.5x slower than as two.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows16PerThread = 4;  // 16-byte rows a thread, 32 rows apart

// The instances, as tsdf_row_gather_instance reports them.
constexpr int kGeneric = 0;  // + log2 of the word's bytes, 0..4
constexpr int kRows12 = 5;
constexpr int kRows16 = 6;
constexpr int kScalarIdx = 8;  // added: kRows12 loads its indices one at a time

__device__ __forceinline__ int32_t clamp_row(int32_t v, int32_t n_rows) {
  return min(max(v, 0), n_rows - 1);
}

__global__ void __launch_bounds__(kThreads)
rows16_kernel(const uint4* __restrict__ table, const int32_t* __restrict__ idx,
              uint4* __restrict__ out, int64_t n_idx, int32_t n_rows) {
  constexpr int R = kRows16PerThread;
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * (kThreads / 32);
  for (int64_t c = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5;
       c * (32 * R) < n_idx; c += warps) {
    const int64_t j0 = c * (32 * R) + lane;
    int32_t r[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int64_t j = j0 + 32 * k;
      r[k] = j < n_idx ? clamp_row(__ldcs(idx + j), n_rows) : 0;
    }
    uint4 v[R];
#pragma unroll
    for (int k = 0; k < R; ++k) v[k] = __ldg(table + r[k]);
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int64_t j = j0 + 32 * k;
      if (j < n_idx) __stcs(out + j, v[k]);
    }
  }
}

// Row r of a table of 12-byte rows (a 4-byte aligned base): one 8-byte and
// one 4-byte load, the 8-byte one on whichever part is 8-byte aligned.
__device__ __forceinline__ void load_row12(const uint32_t* __restrict__ table,
                                           int32_t r, uint32_t (&w)[3]) {
  const uint32_t* p = table + 3 * (int64_t)r;
  const bool even = ((uintptr_t)p & 7) == 0;
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(even ? p : p + 1));
  const uint32_t s = __ldg(even ? p + 2 : p);
  w[0] = even ? v.x : s;
  w[1] = even ? v.y : v.x;
  w[2] = even ? s : v.y;
}

// 12-byte rows, a pair a thread on a grid-stride loop over `pairs`; with
// an odd J, the first block's first thread copies the last row.
template <bool IDX8>
__global__ void __launch_bounds__(kThreads)
rows12_kernel(const uint32_t* __restrict__ table,
              const int32_t* __restrict__ idx, uint32_t* __restrict__ out,
              int64_t pairs, int32_t n_rows, bool odd) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t g = (int64_t)blockIdx.x * kThreads + threadIdx.x; g < pairs;
       g += stride) {
    int32_t r0, r1;
    if constexpr (IDX8) {
      const int2 v = __ldcs(reinterpret_cast<const int2*>(idx) + g);
      r0 = v.x;
      r1 = v.y;
    } else {
      r0 = __ldcs(idx + 2 * g);
      r1 = __ldcs(idx + 2 * g + 1);
    }
    uint32_t a[3], b[3];
    load_row12(table, clamp_row(r0, n_rows), a);
    load_row12(table, clamp_row(r1, n_rows), b);
    uint2* o = reinterpret_cast<uint2*>(out) + 3 * g;
    __stcs(o, make_uint2(a[0], a[1]));
    __stcs(o + 1, make_uint2(a[2], b[0]));
    __stcs(o + 2, make_uint2(b[1], b[2]));
  }
  if (odd && blockIdx.x == 0 && threadIdx.x == 0) {
    uint32_t a[3];
    load_row12(table, clamp_row(__ldcs(idx + 2 * pairs), n_rows), a);
    uint32_t* o = out + 6 * pairs;
    __stcs(o, a[0]);
    __stcs(o + 1, a[1]);
    __stcs(o + 2, a[2]);
  }
}

// Any width: words of V; blockDim (bx, by), a row for each of the block's
// by rows of threads, grid-stride.
template <typename V>
__global__ void __launch_bounds__(kThreads)
generic_kernel(const V* __restrict__ table, const int32_t* __restrict__ idx,
               V* __restrict__ out, int64_t n_idx, int32_t n_rows,
               int32_t words) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.y;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.y + threadIdx.y; j < n_idx;
       j += stride) {
    const V* src = table + (int64_t)clamp_row(__ldg(idx + j), n_rows) * words;
    V* dst = out + j * words;
    for (int32_t k = threadIdx.x; k < words; k += blockDim.x)
      dst[k] = __ldg(src + k);
  }
}

// kRows16 needs 16-byte aligned table and out; kRows12 a 4-byte aligned
// table and an 8-byte aligned out (each pair stores three 8-byte words).
int pick(const void* table, const void* idx, const void* out,
         int64_t row_bytes) {
  const uintptr_t t = (uintptr_t)table, o = (uintptr_t)out;
  if (row_bytes == 16 && ((t | o) & 15) == 0) return kRows16;
  if (row_bytes == 12 && (t & 3) == 0 && (o & 7) == 0)
    return kRows12 + (((uintptr_t)idx & 7) == 0 ? 0 : kScalarIdx);
  const uintptr_t bits = t | o | (uintptr_t)row_bytes;
  int lg = 4;
  while (lg > 0 && (bits & ((uintptr_t(1) << lg) - 1)) != 0) --lg;
  return kGeneric + lg;
}

// A grid of `blocks`, at least one (an odd last row) and at most 2^31 - 1
// (the kernels stride over the rest).
inline unsigned grid(int64_t blocks) {
  return (unsigned)(blocks < 1 ? 1 : blocks > 2147483647LL ? 2147483647LL
                                                            : blocks);
}

template <typename V>
int launch_generic(const void* table, const void* idx, void* out,
                   int64_t n_idx, int32_t n_rows, int64_t row_bytes,
                   cudaStream_t st) {
  const int64_t words = row_bytes / (int64_t)sizeof(V);
  if (words > 2147483647LL) return (int)cudaErrorInvalidValue;
  int bx = 1;
  while (bx < 32 && bx < words) bx *= 2;
  const dim3 block(bx, kThreads / bx);
  generic_kernel<V><<<grid((n_idx + block.y - 1) / block.y), block, 0, st>>>(
      (const V*)table, (const int32_t*)idx, (V*)out, n_idx, n_rows,
      (int32_t)words);
  return (int)cudaGetLastError();
}

}  // namespace

// The instance tsdf_row_gather launches for these arguments: kGeneric plus
// log2 of its word's bytes (0..4), kRows12 or kRows16, plus kScalarIdx
// where kRows12 loads its indices one at a time.
extern "C" int tsdf_row_gather_instance(const void* table, const void* idx,
                                        const void* out, long long row_bytes) {
  return pick(table, idx, out, row_bytes);
}

// table: n_rows rows of row_bytes bytes, contiguous; idx: n_idx int32;
// out: n_idx rows of row_bytes bytes.
extern "C" int tsdf_row_gather(const void* table, const void* idx, void* out,
                               long long n_idx, long long n_rows,
                               long long row_bytes, void* stream) {
  if (n_idx <= 0 || row_bytes <= 0) return (int)cudaSuccess;
  if (n_rows <= 0 || n_rows > 2147483647LL) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int32_t n = (int32_t)n_rows;
  const int instance = pick(table, idx, out, row_bytes);
  if (instance == kRows16) {
    const int64_t rows_a_block = (int64_t)kThreads * kRows16PerThread;
    rows16_kernel<<<grid((n_idx + rows_a_block - 1) / rows_a_block), kThreads,
                    0, st>>>((const uint4*)table, (const int32_t*)idx,
                             (uint4*)out, n_idx, n);
    return (int)cudaGetLastError();
  }
  if (instance == kRows12 || instance == kRows12 + kScalarIdx) {
    const int64_t pairs = n_idx / 2;
    const unsigned blocks = grid((pairs + kThreads - 1) / kThreads);
    if (instance == kRows12) {
      rows12_kernel<true><<<blocks, kThreads, 0, st>>>(
          (const uint32_t*)table, (const int32_t*)idx, (uint32_t*)out, pairs,
          n, (n_idx & 1) != 0);
    } else {
      rows12_kernel<false><<<blocks, kThreads, 0, st>>>(
          (const uint32_t*)table, (const int32_t*)idx, (uint32_t*)out, pairs,
          n, (n_idx & 1) != 0);
    }
    return (int)cudaGetLastError();
  }
  switch (instance) {
    case kGeneric + 4:
      return launch_generic<uint4>(table, idx, out, n_idx, n, row_bytes, st);
    case kGeneric + 3:
      return launch_generic<uint2>(table, idx, out, n_idx, n, row_bytes, st);
    case kGeneric + 2:
      return launch_generic<uint32_t>(table, idx, out, n_idx, n, row_bytes, st);
    case kGeneric + 1:
      return launch_generic<uint16_t>(table, idx, out, n_idx, n, row_bytes, st);
    default:
      return launch_generic<uint8_t>(table, idx, out, n_idx, n, row_bytes, st);
  }
}
