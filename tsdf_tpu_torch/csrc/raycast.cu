// Sphere-traced TSDF raycast for Hopper (sm_90a).
//
// Replaces tsdf_tpu/kernels/raycast.py:raycast_pallas, the slab sweep,
// and the kernels/gather.py:lane_gather_op calls it made. The TPU has no
// per-lane gather, so the sweep resampled the volume slab by slab along
// image lines. Here one thread marches one ray with real trilinear reads:
// the ops/raycast.py contract (ray_directions, slab_near_far, march_rays)
// evaluated per pixel, expression for expression.
//
// What bounds it on this card: the latency of dependent loads. Every step
// reads 8 taps whose addresses depend on the previous step's sample, and a
// 512^3 f32 volume (512 MiB) does not fit the 50 MB L2. The design:
//   * 16x16 pixel tiles per block: neighbouring rays march through
//     neighbouring voxels, so a warp's taps share cache lines and L2
//     sectors;
//   * sphere tracing (step = clip(0.75 * tsdf, 0.05 trunc, 0.9 trunc),
//     the twin's default; its fixed-step mode has no kernel) crosses free
//     space in few, long steps, so a ray issues few dependent reads
//     before it reaches the band around the surface;
//   * many resident threads per SM hide the remaining latency; the state
//     of a ray is a handful of registers and no shared memory is used.
// The empty-brick skip of the TPU sweep is later work.
//
// Built with --fmad=false and IEEE division/sqrt, so each sample rounds
// as in the PyTorch twin.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMarching = 0;
constexpr int kHit = 1;
constexpr int kMiss = 2;
// ops/raycast.py:march_rays' default step scale
constexpr float kStepScale = 0.75f;

struct Grid {
  const float* __restrict__ tsdf;
  int sx, sy, sz;
  float vs[3];
};

// ops/trilinear.py:trilinear_sample at one grid-local point, with the
// reference's border rules.
__device__ __forceinline__ float trilinear(const Grid& g, float p0, float p1,
                                           float p2) {
  const int size[3] = {g.sx, g.sy, g.sz};
  float p[3] = {p0, p1, p2};
  int lower[3];
  float frac[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float max_value = (float)size[a] * g.vs[a];
    if (p[a] >= max_value) p[a] = max_value - g.vs[a] / 10.0f;
    if (p[a] < 0.0f) p[a] = 0.0f;
    const float q = p[a] / g.vs[a] - 0.5f;
    const float lo = fmaxf(floorf(q), 0.0f);
    frac[a] = q - lo;
    lower[a] = (int)lo;
  }
  const int x0 = min(lower[0], g.sx - 1), x1 = min(lower[0] + 1, g.sx - 1);
  const int y0 = min(lower[1], g.sy - 1), y1 = min(lower[1] + 1, g.sy - 1);
  const int z0 = min(lower[2], g.sz - 1), z1 = min(lower[2] + 1, g.sz - 1);
  const int64_t sx = g.sx, sy = g.sy;
  const float* v = g.tsdf;
  const float c000 = v[((int64_t)z0 * sy + y0) * sx + x0];
  const float c001 = v[((int64_t)z1 * sy + y0) * sx + x0];
  const float c010 = v[((int64_t)z0 * sy + y1) * sx + x0];
  const float c011 = v[((int64_t)z1 * sy + y1) * sx + x0];
  const float c100 = v[((int64_t)z0 * sy + y0) * sx + x1];
  const float c101 = v[((int64_t)z1 * sy + y0) * sx + x1];
  const float c110 = v[((int64_t)z0 * sy + y1) * sx + x1];
  const float c111 = v[((int64_t)z1 * sy + y1) * sx + x1];
  const float u = frac[0], w1 = frac[1], w2 = frac[2];
  return c000 * (1.0f - u) * (1.0f - w1) * (1.0f - w2) +
         c001 * (1.0f - u) * (1.0f - w1) * w2 +
         c010 * (1.0f - u) * w1 * (1.0f - w2) +
         c011 * (1.0f - u) * w1 * w2 +
         c100 * u * (1.0f - w1) * (1.0f - w2) +
         c101 * u * (1.0f - w1) * w2 +
         c110 * u * w1 * (1.0f - w2) +
         c111 * u * w1 * w2;
}

// params: K^-1 (9), R (9), origin (3), space min (3), space max (3),
// voxel size (3), truncation distance.
__global__ void raycast_kernel(const float* __restrict__ tsdf,
                               float* __restrict__ verts,
                               const float* __restrict__ params, int sx,
                               int sy, int sz, int width, int height,
                               int max_steps) {
  const int px = blockIdx.x * blockDim.x + threadIdx.x;
  const int py = blockIdx.y * blockDim.y + threadIdx.y;
  if (px >= width || py >= height) return;
  const float* ki = params;
  const float* rot = params + 9;
  const float* origin = params + 18;
  const float* smin = params + 21;
  const float* smax = params + 24;
  Grid g{tsdf, sx, sy, sz, {params[27], params[28], params[29]}};
  const float trunc = params[30];

  // ray_directions: normalize(R @ K^-1 @ (x, y, 1))
  const float fx = (float)px, fy = (float)py;
  float dc[3], d[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) dc[i] = ki[3 * i] * fx + ki[3 * i + 1] * fy + ki[3 * i + 2];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    d[i] = rot[3 * i] * dc[0] + rot[3 * i + 1] * dc[1] + rot[3 * i + 2] * dc[2];
  const float norm = sqrtf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]);
#pragma unroll
  for (int i = 0; i < 3; ++i) d[i] = d[i] / norm;

  // slab_near_far
  float near_t = -INFINITY, far_t = INFINITY;
  bool par_miss = false;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float safe = d[a] == 0.0f ? 1e-20f : d[a];
    const float t1 = (smin[a] - origin[a]) / safe;
    const float t2 = (smax[a] - origin[a]) / safe;
    near_t = fmaxf(near_t, fminf(t1, t2));
    far_t = fminf(far_t, fmaxf(t1, t2));
    const bool inside = origin[a] >= smin[a] && origin[a] <= smax[a];
    if (d[a] == 0.0f && !inside) par_miss = true;
  }
  const bool intersects = near_t <= far_t && far_t >= 0.0f && !par_miss;
  near_t = fmaxf(near_t, 0.0f);

  float start[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) start[a] = origin[a] + near_t * d[a] - smin[a];
  const float max_t = far_t - near_t;

  // march_rays
  const float fixed_step = trunc * 0.05f;
  const float max_step = trunc * 0.9f;
  float t = 0.0f, hit_t = 0.0f;
  float prev_tsdf = 0.0f + trunc;
  float prev_step = 0.0f + fixed_step;
  int status = intersects ? kMarching : kMiss;
  for (int count = 0; count < max_steps && status == kMarching; ++count) {
    const float s = trilinear(g, start[0] + t * d[0], start[1] + t * d[1],
                              start[2] + t * d[2]);
    const float frac = prev_tsdf / (prev_tsdf - s);
    const float t_refined = t - prev_step + frac * prev_step;
    const bool hit = s <= 0.0f;
    const float new_hit_t = s < 0.0f ? t_refined : t;
    const bool backface = s > 0.0f && prev_tsdf < 0.0f;
    const float step = fminf(fmaxf(kStepScale * s, fixed_step), max_step);
    const float new_t = t + step;
    const bool escaped = !hit && !backface && new_t >= max_t;
    if (hit) {
      status = kHit;
      hit_t = new_hit_t;
    }
    if (backface || escaped) status = kMiss;
    if (!hit) t = new_t;
    prev_tsdf = s;
    prev_step = step;
  }

  float* out = verts + ((int64_t)py * width + px) * 3;
#pragma unroll
  for (int a = 0; a < 3; ++a)
    out[a] = status == kHit ? start[a] + hit_t * d[a] + smin[a] : NAN;
}

}  // namespace

extern "C" int tsdf_raycast(const void* tsdf, void* verts, const void* params,
                            int sx, int sy, int sz, int width, int height,
                            int max_steps, void* stream) {
  const dim3 block(16, 16);
  const dim3 grid((width + block.x - 1) / block.x,
                  (height + block.y - 1) / block.y);
  raycast_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)tsdf, (float*)verts, (const float*)params, sx, sy, sz,
      width, height, max_steps);
  return (int)cudaGetLastError();
}
