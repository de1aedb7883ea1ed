// The decimated ("fast") and the warped (deformed-centre, with or without
// colour) variants of the TSDF integration for Hopper (sm_90a): one kernel
// template, instantiated by integrate_fast.cu and integrate_warped.cu; the
// rigid colour kernels walk bricks instead (integrate_bricks.cuh), and
// share only this file's line pre-pass.
//
// Replaces tsdf_tpu/kernels/integrate.py:integrate_pallas(mode="fast")
// (its _kernel_fast) and integrate_warped_pallas (its _kernel_warped; see
// integrate_warped.cu). The TPU kernels had no per-lane gather: they warped
// the depth (and packed rgb) image along each voxel column's image line in
// two lane-gather passes and selected the matching candidate. Here one
// thread per voxel reads its pixel directly, so only the contract is
// ported: which pixel a voxel samples, the gates, the update, the miss
// count.
//
//   FAST = false: the pixel is the voxel's own rounded projection, as in
//     integrate.cu (the ops/integrate.py contract): nothing is skipped.
//   FAST = true: the decimated line convention of _kernel_fast (and of
//     integrate_bricks.cuh's fast colour strip). The row is
//     pyr = round(fy*Y/Z + cy); the sampled pixel is (r, 4c) with
//     r = 2*(clip(pyr, 0, H-1) / 2) and c = round((alpha + beta*r) / 4) on
//     the voxel column's image line px = alpha + beta*py. A voxel whose
//     column is steeper than |beta| = 1 is skipped; those inside the image
//     are counted into *miss.
//   WARPED = true (never with FAST): the voxel's centre is not computed
//     from its indices but read from deform[z, y, x, 0:3], the deformed
//     world-space centre of a non-rigid volume; everything after the
//     centre is the FAST = false path, expression for expression.
//   COLOR = true: where the voxel is updated and |sdf| < trunc, its three
//     colour bytes move towards the pixel's rgb at rate
//     max(1/w', 1/max_weight), w' the new (capped, if asked) weight.
//
// The line of a column depends on (z, x) only, so a pre-pass
// (fit_lines_kernel, one thread per column, sx*sz threads) writes alpha and
// beta once and the voxel kernel reads them coalesced along x. Evaluating
// them per voxel would cost every one of the sx*sy*sz threads two more
// projections and five more IEEE divisions in a kernel that is bound by
// its per-thread instructions, not its bytes (see integrate_bricks.cuh).
//
// What bounds these kernels on this card. Bytes set the floor: 16 B per
// updated voxel for tsdf and weight, 6 B per voxel in the colour band;
// the images (1.2 MB depth, 0.9 MB rgb at 640x480) stay in the 50 MB L2.
// As in the one-thread-per-voxel form integrate_bricks.cuh replaced, the
// projection every thread does before its gates costs more than the bytes. The design: threads x-fastest so tsdf/weight
// accesses are 128-byte runs and a warp's colour bytes are one 96-byte run
// (the (Z, Y, X, 3) u8 layout of the .tsdf file is kept: no f32 colour
// planes); a 3-D launch grid (x blocks, y, z) so no thread divides a
// 64-bit index; voxels that fail the gates touch no volume memory; the
// volume is updated in place; a byte that is not updated is not written.
// The miss count is one __syncthreads_count per block and one atomicAdd
// from blocks that counted any (none, for an upright camera).
//
// Rounding: rintf (half to even, as torch.round) and --fmad=false, every
// expression in the order of its plain twin in ops/integrate.py, so twin
// and kernel agree bit for bit.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace tsdf_variants {

constexpr float kBig = 1.0e6f;  // projections are clipped to +-kBig pixels
constexpr int kThreads = 256;

// params: pose_inv rows 0-2 (12), fx, fy, cx, cy, offset (3),
// voxel size (3), truncation distance, max weight.

__device__ __forceinline__ float clip_big(float v) {
  return fminf(fmaxf(v, -kBig), kBig);
}

// One thread per voxel column (z, x): lines[(z*sx + x)] = (alpha, beta).
// y_far = Y - 0.5 voxels with Y the column length rounded up to 128. With
// FLAG_STEEP, a column steeper than |beta| = 1 also sets *steep (the brick
// cull of integrate_bricks.cuh then keeps every brick).
template <bool FLAG_STEEP>
static __global__ void fit_lines_kernel(float2* __restrict__ lines,
                                        const float* __restrict__ p, int sx,
                                        int sz, float y_far,
                                        unsigned* __restrict__ steep) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int z = blockIdx.y;
  if (x >= sx) return;
  const float wx = ((float)x + 0.5f) * p[19] + p[16];
  const float wz = ((float)z + 0.5f) * p[21] + p[18];
  const float kx = p[2] * wz + p[3];
  const float ky = p[6] * wz + p[7];
  const float kz = p[10] * wz + p[11];
  float px[2], py[2];
  const float wy[2] = {p[17] + 0.5f * p[20], p[17] + y_far * p[20]};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float cx = p[0] * wx + p[1] * wy[i] + kx;
    const float cy = p[4] * wx + p[5] * wy[i] + ky;
    const float cz = p[8] * wx + p[9] * wy[i] + kz;
    px[i] = p[12] * cx / cz + p[14];
    py[i] = p[13] * cy / cz + p[15];
  }
  float denom = py[1] - py[0];
  if (fabsf(denom) < 1e-12f) denom = 1e-12f;
  float beta = (px[1] - px[0]) / denom;
  float alpha = px[0] - beta * py[0];
  beta = isfinite(beta) ? clip_big(beta) : 0.0f;
  alpha = isfinite(alpha) ? clip_big(alpha) : -kBig;
  lines[(int64_t)z * sx + x] = make_float2(alpha, beta);
  if (FLAG_STEEP && !(fabsf(beta) <= 1.0f)) *steep = 1u;
}

template <bool FAST, bool COLOR, bool WARPED>
__global__ void integrate_variant_kernel(
    float* __restrict__ tsdf, float* __restrict__ weight,
    uint8_t* __restrict__ color, const float* __restrict__ deform,
    const float* __restrict__ depth,
    const uint8_t* __restrict__ rgb, const float2* __restrict__ lines,
    int* __restrict__ miss, const float* __restrict__ p, int sx, int width,
    int height, int cap_weight) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  const int z = blockIdx.z;
  const bool valid = x < sx;
  const int64_t i = ((int64_t)z * gridDim.y + y) * sx + x;

  float wx, wy, wz;
  if (WARPED) {
    // 12 B a voxel, x fastest: a warp reads one 384-byte run
    const float* c = deform + 3 * i;
    wx = valid ? c[0] : 0.0f;
    wy = valid ? c[1] : 0.0f;
    wz = valid ? c[2] : 0.0f;
  } else {
    wx = ((float)x + 0.5f) * p[19] + p[16];
    wy = ((float)y + 0.5f) * p[20] + p[17];
    wz = ((float)z + 0.5f) * p[21] + p[18];
  }

  bool in_img = false;
  bool missed = false;
  int pixel = 0;
  float cz;
  if (FAST) {
    const float ky = p[6] * wz + p[7];
    const float kz = p[10] * wz + p[11];
    const float cy = p[4] * wx + p[5] * wy + ky;
    cz = p[8] * wx + p[9] * wy + kz;
    float py = p[13] * cy / cz + p[15];
    py = isfinite(py) ? clip_big(py) : -1.0f;
    const int pyr = (int)rintf(py);
    if (valid) {
      const float2 line = lines[(int64_t)z * sx + x];
      const int pyd = min(max(pyr, 0), height - 1) >> 1;
      const float row = (float)pyd * 2.0f;
      const int col = (int)rintf(clip_big(line.x + line.y * row) / 4.0f);
      const int pxd = col * 4;
      in_img = pyr >= 0 && pyr < height && pxd >= 0 && pxd < width;
      pixel = (pyd * 2) * width + pxd;
      if (!(fabsf(line.y) <= 1.0f)) {
        missed = in_img;
        in_img = false;
      }
    }
    const int n = __syncthreads_count(missed);
    if (threadIdx.x == 0 && n > 0) atomicAdd(miss, n);
  } else {
    const float cx = p[0] * wx + p[1] * wy + p[2] * wz + p[3];
    const float cy = p[4] * wx + p[5] * wy + p[6] * wz + p[7];
    cz = p[8] * wx + p[9] * wy + p[10] * wz + p[11];
    if (valid && cz > 0.0f) {
      const float px = rintf((p[12] * cx + p[14] * cz) / cz);
      const float py = rintf((p[13] * cy + p[15] * cz) / cz);
      in_img = px >= 0.0f && px < (float)width && py >= 0.0f &&
               py < (float)height;
      if (in_img) pixel = (int)py * width + (int)px;
    }
  }
  if (!in_img || !(cz > 0.0f)) return;

  const float d = depth[pixel];
  if (!(d > 0.0f)) return;
  const float sdf = d - cz;
  const float trunc = p[22];
  if (!(sdf >= -trunc)) return;
  const float obs = fminf(sdf, trunc);

  const float w = weight[i];
  const float t = tsdf[i];
  float new_w = w + 1.0f;
  const float new_d = (t * w + obs) / new_w;
  if (cap_weight) new_w = fminf(new_w, p[23]);
  tsdf[i] = new_d;
  weight[i] = new_w;

  if (COLOR) {
    if (!(fabsf(sdf) < trunc)) return;
    const float rate = fmaxf(1.0f / new_w, 1.0f / p[23]);
    uint8_t* c = color + 3 * i;
    const uint8_t* s = rgb + 3 * (int64_t)pixel;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float old = (float)c[k];
      const float blended = old + rate * ((float)s[k] - old);
      c[k] = (uint8_t)fminf(fmaxf(rintf(blended), 0.0f), 255.0f);
    }
  }
}

// Launch the variant on ``stream``; FAST runs the line pre-pass first
// (``lines`` holds sx*sz float2, ``miss`` one int32 the caller zeroed).
// ``deform`` is the (sz, sy, sx, 3) f32 field of a WARPED launch.
template <bool FAST, bool COLOR, bool WARPED = false>
int launch(void* tsdf, void* weight, void* color, const void* depth,
           const void* rgb, void* lines, void* miss, const void* params,
           int sx, int sy, int sz, int width, int height, int cap_weight,
           void* stream, const void* deform = nullptr) {
  static_assert(!(FAST && WARPED), "a deformed column has no image line");
  if (sx <= 0 || sy <= 0 || sz <= 0) return (int)cudaSuccess;
  if (sy > 65535 || sz > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = (cudaStream_t)stream;
  const int threads = sx >= kThreads ? kThreads : ((sx + 31) / 32) * 32;
  const unsigned xb = (unsigned)((sx + threads - 1) / threads);
  if (FAST) {
    const int y_pad = ((sy + 127) / 128) * 128;
    fit_lines_kernel<false><<<dim3(xb, sz), threads, 0, st>>>(
        (float2*)lines, (const float*)params, sx, sz, (float)y_pad - 0.5f,
        nullptr);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  integrate_variant_kernel<FAST, COLOR, WARPED>
      <<<dim3(xb, sy, sz), threads, 0, st>>>(
      (float*)tsdf, (float*)weight, (uint8_t*)color, (const float*)deform,
      (const float*)depth,
      (const uint8_t*)rgb, (const float2*)lines, (int*)miss,
      (const float*)params, sx, width, height, cap_weight);
  return (int)cudaGetLastError();
}

}  // namespace tsdf_variants
