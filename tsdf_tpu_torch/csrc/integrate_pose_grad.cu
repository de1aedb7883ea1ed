// The adjoint of the rigid TSDF integration (the backward of
// integrate_pose) for Hopper (sm_90a).
//
// Replaces tsdf_tpu/kernels/integrate.py:_pose_grad_pallas (its
// _kernel_pose_grad). Per voxel it computes the cotangents of tsdf_in and
// weight_in, and the 12 sums of dL/dx_c[i] * (x_w, y_w, z_w, 1) that are
// the rows R_wc | t_wc of the pose_inv cotangent. The TPU kernel had no
// per-lane gather, so it looked up depth and its two gradient images by a
// line-warp candidate sweep over three tables and wrote a broadcast
// (96, 128) partial block per grid step. Here one thread per voxel
// projects its centre and reads its pixel directly, with the prologue of
// integrate.cu expression for expression, so its gates equal the forward
// kernel's bit for bit; only the contract is ported
// (ops/integrate_diff.py:integrate_pose_grad is the plain twin).
//
// What bounds it on this card. Bytes: every voxel reads gbar_d and gbar_w
// and writes dd and dw (16 B); an updated voxel also reads tsdf and weight
// (8 B) and three image taps, which stay in the 50 MB L2 (depth, Gx, Gy:
// 3.7 MB at 640x480). At 512^3 with ~27 M voxels updated that is ~2.37 GB,
// ~0.71 ms at 3.35 TB/s. The design:
//   * a block is 32 x 8 threads over 32 x-neighbours and 64 y rows of one
//     z slice; a warp's loads and stores are 128-byte runs along x, and
//     each thread loads its 8 voxels' gbar_d/gbar_w before it computes, so
//     16 loads a thread are in flight;
//   * a voxel that fails the gates writes dd = gbar_d, dw = gbar_w and
//     touches no other memory;
//   * the 12 sums are deterministic, with no atomics: each thread adds its
//     voxels' float32 terms into float64 accumulators, a warp reduces them
//     by shuffles, the block's 8 warp rows in shared memory in a fixed
//     order, and the block writes one row of a (blocks, 12) float64
//     buffer, which the wrapper sums in a fixed order. Two runs give the
//     same bits, and float64 keeps the sums of ~10^8 terms exact to far
//     below float32 rounding.
//
// Rounding: rintf (half to even, as torch.round) and --fmad=false, every
// expression in the order of the twin, so dd and dw equal it bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBX = 32;                  // threads along x: one warp
constexpr int kBY = 8;                   // warps along y
constexpr int kRows = 8;                 // y rows a thread walks, kBY apart
constexpr int kTileY = kBY * kRows;      // y rows a block covers
constexpr int kSums = 12;

// params: pose_inv rows 0-2 (12), fx, fy, cx, cy, offset (3),
// voxel size (3), truncation distance, max weight.
__global__ void __launch_bounds__(kBX * kBY)
pose_grad_kernel(const float* __restrict__ tsdf,
                 const float* __restrict__ weight,
                 const float* __restrict__ gbar_d,
                 const float* __restrict__ gbar_w,
                 const float* __restrict__ depth,
                 const float* __restrict__ gx_img,
                 const float* __restrict__ gy_img,
                 float* __restrict__ dd, float* __restrict__ dw,
                 double* __restrict__ partials,
                 const float* __restrict__ p, int sx, int sy, int width,
                 int height, int cap_weight, int image_term) {
  const int x = blockIdx.x * kBX + threadIdx.x;
  const int z = blockIdx.z;
  const int y0 = blockIdx.y * kTileY + threadIdx.y;
  double acc[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) acc[k] = 0.0;

  if (x < sx) {
    const int64_t plane = (int64_t)z * sy;
    float gd[kRows], gw[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int y = y0 + j * kBY;
      const int64_t i = (plane + y) * sx + x;
      gd[j] = y < sy ? gbar_d[i] : 0.0f;
      gw[j] = y < sy ? gbar_w[i] : 0.0f;
    }
    const float trunc = p[22];
    const float max_weight = p[23];
    const float fx = p[12];
    const float fy = p[13];
    const float wx = ((float)x + 0.5f) * p[19] + p[16];
    const float wz = ((float)z + 0.5f) * p[21] + p[18];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int y = y0 + j * kBY;
      if (y >= sy) continue;
      const int64_t i = (plane + y) * sx + x;
      const float wy = ((float)y + 0.5f) * p[20] + p[17];

      // the prologue of integrate.cu: camera point, pixel, gates
      const float cx = p[0] * wx + p[1] * wy + p[2] * wz + p[3];
      const float cy = p[4] * wx + p[5] * wy + p[6] * wz + p[7];
      const float cz = p[8] * wx + p[9] * wy + p[10] * wz + p[11];
      bool update = false;
      int64_t pix = 0;
      float sdf = 0.0f;
      if (cz > 0.0f) {
        const float px = rintf((p[12] * cx + p[14] * cz) / cz);
        const float py = rintf((p[13] * cy + p[15] * cz) / cz);
        if (px >= 0.0f && px < (float)width && py >= 0.0f &&
            py < (float)height) {
          pix = (int64_t)py * width + (int64_t)px;
          const float d = depth[pix];
          sdf = d - cz;
          update = d > 0.0f && sdf >= -trunc;
        }
      }
      if (!update) {
        dd[i] = gd[j];
        dw[i] = gw[j];
        continue;
      }

      // volume cotangents: d new_d / d tsdf_in = w / (w+1); d new_d / d w
      // = (tsdf_in - min(sdf, trunc)) / (w+1)^2; the capped weight's slope
      // is 1 below the cap, 0.5 at the tie, 0 above
      const float w = weight[i];
      const float t = tsdf[i];
      const float new_w = w + 1.0f;
      dd[i] = gd[j] * (w / new_w);
      const float o = fminf(sdf, trunc);
      float capfac = 1.0f;
      if (cap_weight) {
        capfac = (new_w < max_weight ? 1.0f : 0.0f) +
                 0.5f * (new_w == max_weight ? 1.0f : 0.0f);
      }
      dw[i] = gd[j] * ((t - o) / (new_w * new_w)) + gw[j] * capfac;
      if (!(sdf < trunc)) continue;  // the clamp is flat: no pose term

      // dL/dx_c
      const float coef = gd[j] / new_w;
      float dxc, dyc, dzc;
      if (image_term) {
        const float gxv = gx_img[pix];
        const float gyv = gy_img[pix];
        const float zc2 = cz * cz;
        dxc = coef * gxv * fx / cz;
        dyc = coef * gyv * fy / cz;
        dzc = coef * (-gxv * fx * cx / zc2 - gyv * fy * cy / zc2 - 1.0f);
      } else {
        dxc = 0.0f;
        dyc = 0.0f;
        dzc = -coef;
      }
      acc[0] += (double)(dxc * wx);
      acc[1] += (double)(dxc * wy);
      acc[2] += (double)(dxc * wz);
      acc[3] += (double)dxc;
      acc[4] += (double)(dyc * wx);
      acc[5] += (double)(dyc * wy);
      acc[6] += (double)(dyc * wz);
      acc[7] += (double)dyc;
      acc[8] += (double)(dzc * wx);
      acc[9] += (double)(dzc * wy);
      acc[10] += (double)(dzc * wz);
      acc[11] += (double)dzc;
    }
  }

  // the block's 12 sums, in a fixed order
#pragma unroll
  for (int k = 0; k < kSums; ++k) {
#pragma unroll
    for (int off = kBX / 2; off > 0; off >>= 1) {
      acc[k] += __shfl_down_sync(0xffffffffu, acc[k], off);
    }
  }
  __shared__ double rows[kBY][kSums];
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < kSums; ++k) rows[threadIdx.y][k] = acc[k];
  }
  __syncthreads();
  if (threadIdx.y == 0 && threadIdx.x < kSums) {
    double s = 0.0;
#pragma unroll
    for (int r = 0; r < kBY; ++r) s += rows[r][threadIdx.x];
    const int64_t block =
        ((int64_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +
        blockIdx.x;
    partials[block * kSums + threadIdx.x] = s;
  }
}

}  // namespace

// partials: (n_blocks, 12) float64 with n_blocks = ceil(sx/32) *
// ceil(sy/64) * sz; a count that disagrees is refused.
extern "C" int tsdf_integrate_pose_grad(
    const void* tsdf, const void* weight, const void* gbar_d,
    const void* gbar_w, const void* depth, const void* gx, const void* gy,
    void* dd, void* dw, void* partials, long long n_blocks,
    const void* params, int sx, int sy, int sz, int width, int height,
    int cap_weight, int image_term, void* stream) {
  const dim3 block(kBX, kBY, 1);
  const dim3 grid((sx + kBX - 1) / kBX, (sy + kTileY - 1) / kTileY, sz);
  if ((long long)grid.x * grid.y * grid.z != n_blocks || sz > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  pose_grad_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)tsdf, (const float*)weight, (const float*)gbar_d,
      (const float*)gbar_w, (const float*)depth, (const float*)gx,
      (const float*)gy, (float*)dd, (float*)dw, (double*)partials,
      (const float*)params, sx, sy, width, height, cap_weight, image_term);
  return (int)cudaGetLastError();
}
