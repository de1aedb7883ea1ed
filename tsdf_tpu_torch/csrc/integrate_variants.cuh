// The warped TSDF integration (deformed centres, with or without colour)
// for Hopper (sm_90a), instantiated by integrate_warped.cu, and the column
// line pre-pass of the decimated ("fast") convention, which the brick walk
// of integrate_bricks.cuh runs for integrate_fast.cu and the colour-fast
// entry point of integrate_color.cu.
//
// Replaces tsdf_tpu/kernels/integrate.py:integrate_warped_pallas (its
// _kernel_warped; see integrate_warped.cu). The TPU kernel had no per-lane
// gather: it warped the depth (and packed rgb) image along each voxel
// column's image line in two lane-gather passes and selected the matching
// candidate. Here one thread per voxel reads its 12-byte deformed centre
// from deform[z, y, x, 0:3], projects it with the expressions of
// ops/integrate.py:integrate in their order and reads its pixel directly,
// so only the contract is ported: which pixel a voxel samples, the gates,
// the update. With COLOR, where the voxel is updated and |sdf| < trunc, its
// three colour bytes move towards the pixel's rgb at rate
// max(1/w', 1/max_weight), w' the new (capped, if asked) weight.
//
// The line of a column depends on (z, x) only, so the fast convention's
// pre-pass (fit_lines_kernel, one thread per column, sx*sz threads) writes
// alpha and beta once, and the brick walk reads them coalesced along x.
//
// What bounds the warped kernel on this card: bytes set the floor, 12 B of
// centre per voxel and 16 B of tsdf and weight per updated voxel (0.0604
// ms at 255^3 under the field two real updates leave, NVIDIA H100 80GB HBM3
// at 700 W, PERF.md); it runs within 1.4-1.7x of it. Its centres come from
// the field, so it cannot cull bricks of voxels as the rigid kernels do.
// The design: threads x-fastest, so a warp's centres are one 384-byte run,
// its tsdf/weight accesses 128-byte runs and its colour bytes one 96-byte
// run (the (Z, Y, X, 3) u8 layout of the .tsdf file is kept); a 3-D launch
// grid (x blocks, y, z) so no thread divides a 64-bit index; voxels that
// fail the gates touch no volume memory; the volume is updated in place;
// a byte that is not updated is not written.
//
// Rounding: rintf (half to even, as torch.round) and --fmad=false, every
// expression in the order of its plain twin in ops/integrate.py, so twin
// and kernel agree bit for bit. tsdf and weight are float or bf16
// (storage.cuh): widened on load, rounded once on store.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "storage.cuh"

namespace tsdf_variants {

constexpr float kBig = 1.0e6f;  // projections are clipped to +-kBig pixels
constexpr int kThreads = 256;

// params: pose_inv rows 0-2 (12), fx, fy, cx, cy, offset (3),
// voxel size (3), truncation distance, max weight.

__device__ __forceinline__ float clip_big(float v) {
  return fminf(fmaxf(v, -kBig), kBig);
}

// One thread per voxel column (z, x): lines[(z*sx + x)] = (alpha, beta).
// y_far = Y - 0.5 voxels with Y the column length rounded up to 128. A
// column steeper than |beta| = 1 also sets *steep (the brick cull of
// integrate_bricks.cuh then keeps every brick). zg is the volume's first
// plane in the whole volume (0 unless it is a z-slab).
static __global__ void fit_lines_kernel(float2* __restrict__ lines,
                                        const float* __restrict__ p, int sx,
                                        int sz, float y_far,
                                        unsigned* __restrict__ steep, int zg) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int z = blockIdx.y;
  if (x >= sx) return;
  const float wx = ((float)x + 0.5f) * p[19] + p[16];
  const float wz = ((float)(zg + z) + 0.5f) * p[21] + p[18];
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
  if (!(fabsf(beta) <= 1.0f)) *steep = 1u;
}

template <typename T, bool COLOR>
__global__ void integrate_warped_kernel(
    T* __restrict__ tsdf, T* __restrict__ weight,
    uint8_t* __restrict__ color, const float* __restrict__ deform,
    const float* __restrict__ depth, const uint8_t* __restrict__ rgb,
    const float* __restrict__ p, int sx, int width, int height,
    int cap_weight) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  const int z = blockIdx.z;
  if (x >= sx) return;
  const int64_t i = ((int64_t)z * gridDim.y + y) * sx + x;

  // 12 B a voxel, x fastest: a warp reads one 384-byte run
  const float* c = deform + 3 * i;
  const float wx = c[0];
  const float wy = c[1];
  const float wz = c[2];

  const float cx = p[0] * wx + p[1] * wy + p[2] * wz + p[3];
  const float cy = p[4] * wx + p[5] * wy + p[6] * wz + p[7];
  const float cz = p[8] * wx + p[9] * wy + p[10] * wz + p[11];
  if (!(cz > 0.0f)) return;
  const float px = rintf((p[12] * cx + p[14] * cz) / cz);
  const float py = rintf((p[13] * cy + p[15] * cz) / cz);
  if (!(px >= 0.0f && px < (float)width && py >= 0.0f &&
        py < (float)height))
    return;
  const int pixel = (int)py * width + (int)px;

  const float d = depth[pixel];
  if (!(d > 0.0f)) return;
  const float sdf = d - cz;
  const float trunc = p[22];
  if (!(sdf >= -trunc)) return;
  const float obs = fminf(sdf, trunc);

  const float w = tsdf_storage::load(weight + i);
  const float t = tsdf_storage::load(tsdf + i);
  float new_w = w + 1.0f;
  const float new_d = (t * w + obs) / new_w;
  if (cap_weight) new_w = fminf(new_w, p[23]);
  tsdf_storage::store(tsdf + i, new_d);
  tsdf_storage::store(weight + i, new_w);

  if (COLOR) {
    if (!(fabsf(sdf) < trunc)) return;
    const float rate = fmaxf(1.0f / new_w, 1.0f / p[23]);
    uint8_t* c8 = color + 3 * i;
    const uint8_t* s = rgb + 3 * (int64_t)pixel;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float old = (float)c8[k];
      const float blended = old + rate * ((float)s[k] - old);
      c8[k] = (uint8_t)fminf(fmaxf(rintf(blended), 0.0f), 255.0f);
    }
  }
}

// Launch the warped kernel on ``stream``: tsdf and weight of type T,
// ``deform`` the (sz, sy, sx, 3) f32 field of deformed centres; ``color``
// and ``rgb`` with COLOR only.
template <typename T, bool COLOR>
int launch_warped(void* tsdf, void* weight, void* color, const void* deform,
                  const void* depth, const void* rgb, const void* params,
                  int sx, int sy, int sz, int width, int height,
                  int cap_weight, void* stream) {
  if (sx <= 0 || sy <= 0 || sz <= 0) return (int)cudaSuccess;
  if (sy > 65535 || sz > 65535) return (int)cudaErrorInvalidConfiguration;
  const int threads = sx >= kThreads ? kThreads : ((sx + 31) / 32) * 32;
  const unsigned xb = (unsigned)((sx + threads - 1) / threads);
  integrate_warped_kernel<T, COLOR>
      <<<dim3(xb, sy, sz), threads, 0, (cudaStream_t)stream>>>(
          (T*)tsdf, (T*)weight, (uint8_t*)color, (const float*)deform,
          (const float*)depth, (const uint8_t*)rgb, (const float*)params, sx,
          width, height, cap_weight);
  return (int)cudaGetLastError();
}

}  // namespace tsdf_variants
