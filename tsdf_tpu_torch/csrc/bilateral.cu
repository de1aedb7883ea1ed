// Bilateral depth filter for Hopper (sm_90a).
//
// Replaces tsdf_tpu/kernels/bilateral.py:bilateral_filter_pallas (its
// _kernel). The TPU kernel kept the whole padded image in VMEM and walked
// it in row blocks of 24 so that the unrolled tap loop stayed compilable;
// none of that carries over. Here a block of BX x BY threads stages a tile
// of BX x (BY * K) pixels plus a halo of the radius in shared memory,
// zero-filled outside the image (zero depth is "no data", so the padding
// is inert), then the (2r+1)^2 spatial weights, and each thread filters a
// vertical strip of K pixels.
//
// What bounds it on this card: issued instructions. At 640x480 the image
// is read once and written once, 2.5 MB (< 1 us at 3.35 TB/s), while each
// of the 307200 pixels does 121 taps at the default radius of 5, each an
// IEEE expf (about eight instructions, the library is built with
// --fmad=false) and about eight more operations. What keeps the
// instructions a tap down:
//   - the radius is a template parameter for the radii the paths use
//     (5: the default sigma_space 3.0; 3: sigma_space 1.7), so the tap
//     loops unroll fully and every shared-memory address is an immediate
//     offset (the compiler reads the weights four at a time and keeps
//     them for the strip's next row). Any other radius runs the instance
//     of the same kernel whose radius is a runtime value;
//   - a thread walks the strip's 2r + K tile rows once, outer, with dx
//     inner: each tap it reads serves every pixel of the strip whose
//     window holds it (pixel j sees tile row rho as dy = rho - j, which
//     rises with rho, so each pixel still accumulates in the twin's
//     order), and the K independent sums give the scheduler parallel
//     chains;
//   - no select a tap in the compiled instances: a finite tap <= 0 (no
//     data) is stored in the tile as -FLT_MAX. For a centre > 0 its dv is
//     -FLT_MAX - centre, dv^2 overflows to +inf and, with range_c > 0,
//     expf(-inf) = +0, so it adds w_s * 0 = +0 to den and -FLT_MAX * +0 =
//     -0 to num: exactly what the twin's zero weight adds. A NaN, +inf or
//     -inf tap is stored as it is and, as in the twin, turns num into NaN
//     (a NaN tap also turns den into NaN, where the twin's stays finite;
//     the quotient is NaN either way). A centre <= 0 gives 0 whatever its
//     sums hold. range_c = 0 (sigma_colour infinite) would make the
//     stored taps' weight NaN, so it runs the runtime-radius instance,
//     which keeps the twin's select;
//   - the tile shape: 32x16 pixels give 600 blocks at 640x480, all
//     resident at once on the card's 132 SMs (kernels/bilateral.py).
//
// Rounding: the arithmetic is that of the plain twin ops/bilateral.py, tap
// for tap (dy outer, dx inner, the same accumulation order). The spatial
// weights come from the host, computed in double and cast to float32, so
// the device never evaluates expf of the spatial term; the range weight is
// expf (not __expf), the division is IEEE, and no tap is skipped.
//
// Types: float32 or uint16 depth. A uint16 image is converted on load and
// rounded with rintf (half to even, as torch.round) on store.

#include <cuda_runtime.h>
#include <stdint.h>
#include <float.h>
#include <math.h>

namespace {

// The launch shape: BX x BY threads, K output rows a thread.
constexpr int BX = 32;
constexpr int BY = 8;
constexpr int K = 2;

// RF: the compiled radius, or 0 for the instance that takes `radius` at
// run time. Dynamic shared memory: the tile, (BY*K + 2r) rows of
// (BX + 2r) floats, then the (2r+1)^2 spatial weights, dy outer.
template <typename T, int RF>
__global__ void __launch_bounds__(BX * BY)
    bilateral_strip(const T* __restrict__ in, T* __restrict__ out,
                    const float* __restrict__ weights, int height, int width,
                    int radius, float range_c) {
  extern __shared__ float smem[];
  const int r = RF > 0 ? RF : radius;
  const int side = 2 * r + 1;
  const int tw = BX + 2 * r;
  const int th = BY * K + 2 * r;
  float* tile = smem;
  float* wsm = smem + tw * th;

  const int x0 = blockIdx.x * BX - r;
  const int y0 = blockIdx.y * (BY * K) - r;
  for (int ty = threadIdx.y; ty < th; ty += BY) {
    const int gy = y0 + ty;
    const bool row_in = gy >= 0 && gy < height;
    for (int tx = threadIdx.x; tx < tw; tx += BX) {
      const int gx = x0 + tx;
      float v = 0.0f;
      if (row_in && gx >= 0 && gx < width)
        v = (float)in[(int64_t)gy * width + gx];
      if (RF > 0 && v <= 0.0f && v > -INFINITY) v = -FLT_MAX;
      tile[ty * tw + tx] = v;
    }
  }
  const int tid = threadIdx.y * BX + threadIdx.x;
  for (int i = tid; i < side * side; i += BX * BY) wsm[i] = weights[i];
  __syncthreads();

  // the strip: pixels (x, y_0 + j), j < K; tile row rho holds image row
  // y_0 - r + rho
  const float* base = tile + threadIdx.y * K * tw + threadIdx.x;
  float centre[K], num[K], den[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    centre[j] = base[(r + j) * tw + r];
    num[j] = 0.0f;
    den[j] = 0.0f;
  }
#pragma unroll
  for (int rho = 0; rho < 2 * r + K; ++rho) {
    const float* row = base + rho * tw;
#pragma unroll
    for (int dx = 0; dx < side; ++dx) {
      const float tap = row[dx];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int dy = rho - j;
        if (dy < 0 || dy > 2 * r) continue;
        const float w_s = wsm[dy * side + dx];
        const float dv = tap - centre[j];
        const float w_c = expf(-(dv * dv) * range_c);
        float wgt = w_s * w_c;
        if (RF == 0 && !(tap > 0.0f)) wgt = 0.0f;
        num[j] = num[j] + tap * wgt;
        den[j] = den[j] + wgt;
      }
    }
  }
  const int x = blockIdx.x * BX + threadIdx.x;
  if (x >= width) return;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int y = blockIdx.y * (BY * K) + threadIdx.y * K + j;
    if (y >= height) break;
    float v = 0.0f;
    if (centre[j] > 0.0f) v = num[j] / fmaxf(den[j], 1e-12f);
    if (sizeof(T) == sizeof(float))
      out[(int64_t)y * width + x] = (T)v;
    else
      out[(int64_t)y * width + x] = (T)rintf(v);
  }
}

template <int RF, typename T>
int launch(const void* in, void* out, const float* weights, int height,
           int width, int radius, float range_c, size_t shared,
           cudaStream_t stream) {
  if (shared > 48 * 1024) {
    // above 48 KB a block must opt in (up to 227 KB on Hopper)
    const cudaError_t err = cudaFuncSetAttribute(
        bilateral_strip<T, RF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shared);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((width + BX - 1) / BX, (height + BY * K - 1) / (BY * K));
  bilateral_strip<T, RF><<<grid, dim3(BX, BY), shared, stream>>>(
      (const T*)in, (T*)out, weights, height, width, radius, range_c);
  return (int)cudaGetLastError();
}

// A compiled instance runs only its own radius and a range_c > 0.
template <typename T>
int dispatch(int instance, const void* in, void* out, const float* weights,
             int height, int width, int radius, float range_c, size_t shared,
             cudaStream_t stream) {
  const bool compiled = instance == radius && range_c > 0.0f;
  if (instance == 5 && compiled)
    return launch<5, T>(in, out, weights, height, width, radius, range_c,
                        shared, stream);
  if (instance == 3 && compiled)
    return launch<3, T>(in, out, weights, height, width, radius, range_c,
                        shared, stream);
  if (instance == 0)
    return launch<0, T>(in, out, weights, height, width, radius, range_c,
                        shared, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The first twelve arguments keep their meaning across versions of this
// entry point: `weights` is the device array of the (2r+1)^2 float32
// spatial weights, tile_w x tile_h the block's threads, `shared_bytes` the
// block's dynamic shared memory (the wrapper computes it and refuses a
// radius whose tile does not fit). Then `rows`, the output rows a thread
// filters, and `instance`, the compiled radius to run (5 or 3) or 0 for
// the runtime-radius kernel. A launch shape other than the compiled one,
// or an instance that does not take this radius and range_c, returns
// cudaErrorInvalidValue.
extern "C" int tsdf_bilateral(const void* in, void* out, const void* weights,
                              int height, int width, int radius,
                              float range_c, int is_u16, int tile_w,
                              int tile_h, int shared_bytes, void* stream,
                              int rows, int instance) {
  if (tile_w != BX || tile_h != BY || rows != K)
    return (int)cudaErrorInvalidValue;
  const size_t shared = (size_t)shared_bytes;
  const cudaStream_t s = (cudaStream_t)stream;
  if (is_u16)
    return dispatch<uint16_t>(instance, in, out, (const float*)weights,
                              height, width, radius, range_c, shared, s);
  return dispatch<float>(instance, in, out, (const float*)weights, height,
                         width, radius, range_c, shared, s);
}
