// Rigid projective TSDF integration for Hopper (sm_90a).
//
// Replaces tsdf_tpu/kernels/integrate.py:integrate_pallas (its _kernel,
// modes "exact" and "line"). The TPU kernel had no per-lane gather, so it
// warped each voxel column onto an image line and matched candidate
// columns, skipping (and counting) voxels it could not resolve. Here one
// thread per voxel projects its centre and reads its pixel directly: the
// ops/integrate.py contract holds for every voxel, nothing is skipped and
// there is no miss count.
//
// What bounds it on this card. Bytes set the floor: tsdf and weight are
// 8 B of reads and 8 B of writes per updated voxel, 2 GiB per frame at
// 512^3 if every voxel were in view (>= 0.64 ms at 3.35 TB/s). Measured on
// an H100 at 512^3, the work every one of the 134 M threads does before
// its gates (64-bit index division, two IEEE divisions) costs more: a frame
// with no depth at all takes as long as a real one, ~1 ms (PERF.md).
// Indexing by a 3-D grid instead of dividing is the first step of a later
// speed PR. The design:
//   * threads are laid out x-fastest, so a warp's loads and stores of
//     tsdf/weight are 128-byte coalesced runs;
//   * a voxel that fails the geometric gates (behind the camera, outside
//     the image, no depth, far behind the surface) returns before touching
//     tsdf/weight, so only voxels in the frustum's band cost bytes;
//   * the depth image (1.2 MB at 640x480) stays in the 50 MB L2, so the
//     per-voxel pixel read is a cache hit, not a DRAM transaction;
//   * tsdf/weight are updated in place: no copy of the volume per frame.
//
// Rounding: the pixel is round((fx*X + cx*Z) / Z) with rintf (half to
// even, as torch.round), and the library is built with --fmad=false, so
// each product and sum rounds as in the PyTorch twin ops/integrate.py.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// params: pose_inv rows 0-2 (12), fx, fy, cx, cy, offset (3),
// voxel size (3), truncation distance, max weight.
__global__ void integrate_kernel(float* __restrict__ tsdf,
                                 float* __restrict__ weight,
                                 const float* __restrict__ depth,
                                 const float* __restrict__ params, int sx,
                                 int sy, int sz, int width, int height,
                                 int cap_weight) {
  const int64_t n = (int64_t)sx * sy * sz;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int x = (int)(i % sx);
  const int64_t zy = i / sx;
  const int y = (int)(zy % sy);
  const int z = (int)(zy / sy);

  const float* p = params;
  const float wx = ((float)x + 0.5f) * p[19] + p[16];
  const float wy = ((float)y + 0.5f) * p[20] + p[17];
  const float wz = ((float)z + 0.5f) * p[21] + p[18];

  const float cx = p[0] * wx + p[1] * wy + p[2] * wz + p[3];
  const float cy = p[4] * wx + p[5] * wy + p[6] * wz + p[7];
  const float cz = p[8] * wx + p[9] * wy + p[10] * wz + p[11];
  if (!(cz > 0.0f)) return;

  const float px = rintf((p[12] * cx + p[14] * cz) / cz);
  const float py = rintf((p[13] * cy + p[15] * cz) / cz);
  if (!(px >= 0.0f && px < (float)width && py >= 0.0f &&
        py < (float)height))
    return;

  const float d = depth[(int64_t)py * width + (int64_t)px];
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
}

}  // namespace

extern "C" int tsdf_integrate(void* tsdf, void* weight, const void* depth,
                              const void* params, int sx, int sy, int sz,
                              int width, int height, int cap_weight,
                              void* stream) {
  const int64_t n = (int64_t)sx * sy * sz;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  integrate_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (float*)tsdf, (float*)weight, (const float*)depth,
      (const float*)params, sx, sy, sz, width, height, cap_weight);
  return (int)cudaGetLastError();
}
