// Bilateral depth filter for Hopper (sm_90a).
//
// Replaces tsdf_tpu/kernels/bilateral.py:bilateral_filter_pallas (its
// _kernel). The TPU kernel kept the whole padded image in VMEM and walked
// it in row blocks of 24 so that the unrolled tap loop stayed compilable;
// none of that carries over. Here one thread filters one pixel: a block of
// 32x8 threads stages its pixel tile plus a halo of `radius` in shared
// memory, zero-filled outside the image (zero depth is "no data", so the
// padding is inert), and every thread walks the (2r+1)^2 window out of
// shared memory.
//
// What bounds it on this card: operations, not bytes. At 640x480 the image
// is read once and written once, 2.5 MB (< 1 us at 3.35 TB/s), while each
// of the 307200 pixels does 121 taps at the default radius of 5: 3.7e7
// expf and about twelve float32 operations a tap, 4.5e8 in all (~7 us at
// 67 TFLOP/s, more in practice because expf goes through the special-
// function unit). The tile in shared memory is what keeps the 121 reads a
// pixel away from L2; the halo costs a block 756 loads for 256 pixels.
//
// Rounding: the arithmetic is that of the plain twin ops/bilateral.py, tap
// for tap (dy outer, dx inner, the same accumulation order). The spatial
// weights come from the host, computed in double and cast to float32, so
// the device never evaluates expf of the spatial term; the range weight is
// expf (not __expf), the division is IEEE, and the library is built with
// --fmad=false, so no product and sum contract into one rounding.
//
// Types: float32 or uint16 depth. A uint16 image is converted on load and
// rounded with rintf (half to even, as torch.round) on store.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The block is the pixel tile (blockDim.x x blockDim.y, chosen by the
// wrapper). Dynamic shared memory: (blockDim.y + 2r) x (blockDim.x + 2r)
// depth values, then the (2r+1)^2 spatial weights.
template <typename T>
__global__ void bilateral_kernel(const T* __restrict__ in, T* __restrict__ out,
                                 const float* __restrict__ weights, int height,
                                 int width, int radius, float range_c) {
  extern __shared__ float smem[];
  const int tile_w = blockDim.x;
  const int tile_h = blockDim.y;
  const int tw = tile_w + 2 * radius;
  const int th = tile_h + 2 * radius;
  const int side = 2 * radius + 1;
  float* tile = smem;
  float* wsp = smem + tw * th;

  const int tid = threadIdx.y * tile_w + threadIdx.x;
  const int nthreads = tile_w * tile_h;
  const int x0 = blockIdx.x * tile_w - radius;
  const int y0 = blockIdx.y * tile_h - radius;
  for (int i = tid; i < tw * th; i += nthreads) {
    const int ty = i / tw;
    const int tx = i - ty * tw;
    const int gx = x0 + tx;
    const int gy = y0 + ty;
    float v = 0.0f;
    if (gx >= 0 && gx < width && gy >= 0 && gy < height)
      v = (float)in[(int64_t)gy * width + gx];
    tile[i] = v;
  }
  for (int i = tid; i < side * side; i += nthreads) wsp[i] = weights[i];
  __syncthreads();

  const int x = blockIdx.x * tile_w + threadIdx.x;
  const int y = blockIdx.y * tile_h + threadIdx.y;
  if (x >= width || y >= height) return;

  const float* row0 = tile + threadIdx.y * tw + threadIdx.x;
  const float centre = row0[radius * tw + radius];
  float num = 0.0f;
  float den = 0.0f;
  for (int dy = 0; dy < side; ++dy) {
    const float* row = row0 + dy * tw;
    const float* wrow = wsp + dy * side;
    for (int dx = 0; dx < side; ++dx) {
      const float tap = row[dx];
      const float dv = tap - centre;
      const float w_c = expf(-(dv * dv) * range_c);
      const float wgt = (tap > 0.0f) ? wrow[dx] * w_c : 0.0f;
      num = num + tap * wgt;
      den = den + wgt;
    }
  }
  float r = 0.0f;
  if (centre > 0.0f) r = num / fmaxf(den, 1e-12f);
  if (sizeof(T) == sizeof(float))
    out[(int64_t)y * width + x] = (T)r;
  else
    out[(int64_t)y * width + x] = (T)rintf(r);
}

}  // namespace

// `shared_bytes` is what the tile, its halo and the weights take for this
// block and radius; the wrapper computes it and refuses a radius whose tile
// does not fit before it launches.
extern "C" int tsdf_bilateral(const void* in, void* out, const void* weights,
                              int height, int width, int radius,
                              float range_c, int is_u16, int tile_w,
                              int tile_h, int shared_bytes, void* stream) {
  const dim3 block(tile_w, tile_h);
  const dim3 grid((width + tile_w - 1) / tile_w,
                  (height + tile_h - 1) / tile_h);
  const size_t shared = (size_t)shared_bytes;
  if (is_u16) {
    bilateral_kernel<uint16_t><<<grid, block, shared, (cudaStream_t)stream>>>(
        (const uint16_t*)in, (uint16_t*)out, (const float*)weights, height,
        width, radius, range_c);
  } else {
    bilateral_kernel<float><<<grid, block, shared, (cudaStream_t)stream>>>(
        (const float*)in, (float*)out, (const float*)weights, height, width,
        radius, range_c);
  }
  return (int)cudaGetLastError();
}
