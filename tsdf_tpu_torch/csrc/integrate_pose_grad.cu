// The adjoint of the rigid TSDF integration (the backward of
// integrate_pose) for Hopper (sm_90a).
//
// Replaces tsdf_tpu/kernels/integrate.py:_pose_grad_pallas (its
// _kernel_pose_grad). Per voxel it computes the cotangents of tsdf_in and
// weight_in, and the 12 sums of dL/dx_c[i] * (x_w, y_w, z_w, 1) that are
// the rows R_wc | t_wc of the pose_inv cotangent. The TPU kernel had no
// per-lane gather, so it looked up depth and its two gradient images by a
// line-warp candidate sweep over three tables and wrote a broadcast
// (96, 128) partial block per grid step. Here each voxel projects its
// centre and reads its pixel directly; only the contract is ported
// (ops/integrate_diff.py:integrate_pose_grad is the plain twin).
//
// What bounds it on this card: bytes. Every voxel reads gbar_d and gbar_w
// and writes dd and dw (16 B); an updated voxel also reads tsdf and weight
// (8 B); the depth frame (1.2 MB at 640x480) stays in the 50 MB L2. At
// 512^3 with ~27 M voxels updated that is ~2.37 GB, 0.7076 ms at 3.35 TB/s
// (NVIDIA H100 80GB HBM3 at 700 W, PERF.md), 2.15 GB of it the 16 B a
// voxel: the floor is a streaming copy of gbar into (dd, dw). The design,
// on the bricks of integrate_bricks.cuh (32 x 4 x 8 voxels), its depth
// maximum and its exact-convention cull, whose kept set holds every voxel
// the forward updates and so every voxel gated here:
//   * a culled brick is a copy, dd = gbar_d and dw = gbar_w: no
//     projection, no tsdf, weight or depth read, nothing summed. Its own
//     launch of 64 registers takes a row of bricks along x a block,
//     re-tests the row's bricks with the cull's function and streams the
//     row's z slices (kBY whole lines, together in memory) 16 B a thread
//     where the brick is culled;
//   * a live brick is the z-strip walk over the cull's list: a thread owns
//     one (x, y) of the brick and its kBZ voxels, issues its gbar loads
//     first, reuses p0*wx + p1*wy of each camera row as integrate.cu's
//     strip does (so the gates equal the forward's bit for bit), writes dd
//     and dw at every voxel of the strip, and adds the float32 terms of
//     its voxels in the band, cast to float64, into 12 sums in shared
//     memory, which only this launch carries; it reads the two depth
//     neighbours of a band voxel's pixel for the image gradient;
//   * the sums are deterministic with no atomics although the list's order
//     varies between runs: each brick's 12 sums are reduced in a fixed
//     order (the thread's strip in z, a tree over the warp's 32 x, the
//     block's 4 warps in y) and written to the brick's own row of a
//     (bricks, 12) float64 buffer, a culled brick's row zero; the wrapper
//     sums the rows in one fixed-order torch.sum. Two runs give the same
//     bits, and float64 keeps the sums of ~10^8 terms exact to far below
//     float32 rounding. kernels/integrate.py:pose_grad_partials is this
//     order in plain PyTorch.
// On that card at 512^3 the copy takes ~0.54 ms for the 0.6736 of the
// bricks a real frame culls (0.74 for all of them, where a device copy of
// the same bytes takes 0.72) and the walk ~0.61 ms for the rest, 2.2x
// their bytes, as the forward's walk: each thread's chain of dependent
// loads at 16 warps an SM (a cap of 80 or 64 registers spills and is
// slower; running the copy beside the walk on a second stream was too).

// Rounding: rintf (half to even, as torch.round) and --fmad=false, every
// expression in the order of the twin, so dd and dw equal it bit for bit.
//
// Storage: tsdf, weight, the cotangents gbar_d, gbar_w and dd, dw are all
// of the volume's type T, float or bf16 (storage.cuh). A bf16 instance
// widens what it loads and rounds dd and dw once when it stores them: the
// JAX backward computes them in float32 from the float32 widening of the
// bf16 cotangents and casts them to the volume's dtype, which gives the
// same bits. The culled bricks' copy moves T words (8 a 16-byte vector in
// bf16) and the 12 float64 sums are the float instance's arithmetic.
//
// Slabs: a rank of a mesh (parallel/ops.py:integrate_pose_sharded) runs the
// adjoint on its z-slab of the volume. The _slab entry points take the
// slab's first plane zg and form every centre, in the cull, the copy and
// the walk, from the voxel's plane in the whole volume, so a slab's dd, dw
// and per-brick partials are the whole volume's for the same planes (and
// bricks, where zg is a multiple of kBZ). A whole volume keeps instances
// without the plane, whose code is the form before slabs.

#include <type_traits>

#include "integrate_bricks.cuh"

namespace {

using tsdf_bricks::kBX;
using tsdf_bricks::kBY;
using tsdf_bricks::kBZ;
using tsdf_bricks::kDepthMax;
using tsdf_bricks::kLiveCount;
using tsdf_bricks::kLiveList;

constexpr int kSums = 12;
constexpr int kCopyThreads = 256;
constexpr int kCopyBlocksPerSM = 4;   // 64 registers a thread
constexpr int kMaxRowBricks = 1024;   // bricks along x: sx <= 32768
constexpr int kWalkBlocksPerSM = 4;   // 128 registers a thread
constexpr int kWalkWaves = 16;

// The central difference of the depth frame at an updated voxel's pixel
// (whose depth is > 0) along a stride of 1 (x) or the width (y), as
// ops/integrate_diff.py:depth_image_gradients computes it: zero where a
// neighbour is outside the image or holds no depth > 0 (NaN included).
__device__ __forceinline__ float depth_gradient(const float* __restrict__ depth,
                                               int pixel, int stride,
                                               bool has_low, bool has_high) {
  if (!has_low || !has_high) return 0.0f;
  const float low = __ldg(depth + pixel - stride);
  const float high = __ldg(depth + pixel + stride);
  return low > 0.0f && high > 0.0f ? (high - low) * 0.5f : 0.0f;
}

// The culled bricks: dd = gbar_d, dw = gbar_w, and a zero row of partials.
// A block takes a row of bricks (by, bz) at a time. Its threads first test
// the row's bricks with brick_cull_kernel's function on the same
// parameters (so with the same verdict as the list the walk takes), then
// stream each z slice of the row, kBY whole lines along x that lie
// together in memory, 16 B a thread (VEC: x a multiple of the 4 floats or
// 8 bf16 of 16 B and the four arrays 16-byte aligned; else one word),
// copying where the brick is culled. SLAB: the volume is a z-slab whose
// planes start at the whole volume's zg (the cull tests the whole volume's
// centres).
template <typename T, bool VEC, bool SLAB>
__global__ void __launch_bounds__(kCopyThreads, kCopyBlocksPerSM)
pose_grad_copy_kernel(const T* __restrict__ gbar_d,
                      const T* __restrict__ gbar_w,
                      T* __restrict__ dd, T* __restrict__ dw,
                      double* __restrict__ partials,
                      const float* __restrict__ params, int sx, int sy,
                      int sz, int nbx, int nby, int nbz, int width,
                      int height, int zg) {
  const int zs = SLAB ? zg : 0;
  // a 16-byte vector holds 4 floats or 8 bf16; the copy moves bits only
  using V = typename std::conditional<VEC, float4, T>::type;
  constexpr int kLanes = VEC ? (int)(sizeof(float4) / sizeof(T)) : 1;
  __shared__ bool culled[kMaxRowBricks];
  const unsigned* head = reinterpret_cast<const unsigned*>(params);
  const float dmax = __uint_as_float(head[kDepthMax]);
  const int q = sx / kLanes;  // vectors a line
  for (int r = blockIdx.x; r < nby * nbz; r += gridDim.x) {
    const int by = r % nby, bz = r / nby;
    const int y0 = by * kBY, z0 = bz * kBZ;
    bool any = false;
    for (int bx = threadIdx.x; bx < nbx; bx += blockDim.x) {
      const bool c = tsdf_bricks::brick_culled<false>(
          params, dmax, bx * kBX, y0, zs + z0, width, height);
      culled[bx] = c;
      any |= c;
      if (c) {
        double* row = partials + ((int64_t)r * nbx + bx) * kSums;
#pragma unroll
        for (int k = 0; k < kSums; ++k) row[k] = 0.0;
      }
    }
    if (!__syncthreads_or(any)) continue;
    const int n = min(kBY, sy - y0) * q;  // vectors a z slice of the row
    const int nz = min(kBZ, sz - z0);
    for (int k = 0; k < nz; ++k) {
      const int64_t base = ((int64_t)(z0 + k) * sy + y0) * q;
      for (int u = threadIdx.x; u < n; u += blockDim.x) {
        if (!culled[(u % q) * kLanes / kBX]) continue;
        reinterpret_cast<V*>(dd)[base + u] =
            reinterpret_cast<const V*>(gbar_d)[base + u];
        reinterpret_cast<V*>(dw)[base + u] =
            reinterpret_cast<const V*>(gbar_w)[base + u];
      }
    }
    __syncthreads();  // the flags are rewritten for the next row
  }
}

// The live bricks, from the cull's list. SLAB: the volume is a z-slab
// whose planes start at the whole volume's zg; a voxel's centre is formed
// from its plane in the whole volume, so its terms are the whole volume's
// bits. A whole volume takes the instance without it (integrate_bricks.cuh
// says why the brick walks keep one).
template <typename T, bool SLAB>
__global__ void __launch_bounds__(kBX * kBY, kWalkBlocksPerSM)
pose_grad_walk_kernel(const T* __restrict__ tsdf,
                      const T* __restrict__ weight,
                      const T* __restrict__ gbar_d,
                      const T* __restrict__ gbar_w,
                      const float* __restrict__ depth,
                      T* __restrict__ dd, T* __restrict__ dw,
                      double* __restrict__ partials,
                      const float* __restrict__ params, int sx, int sy,
                      int sz, int nbx, int nby, int width, int height,
                      int cap_weight, int image_term, int zg) {
  const int zs = SLAB ? zg : 0;
  const float* p = params;
  const unsigned* head = reinterpret_cast<const unsigned*>(params);
  const unsigned live = head[kLiveCount];
  const int64_t plane = (int64_t)sx * sy;
  const float trunc = p[22];
  const float max_weight = p[23];
  const float fx = p[12];
  const float fy = p[13];
  // each thread's 12 float64 sums, kept here rather than in registers: the
  // few voxels in the band add to them, every voxel needs the registers
  __shared__ double acc[kSums][kBX * kBY];
  const int tid = threadIdx.y * kBX + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kSums; ++k) acc[k][tid] = 0.0;
  for (unsigned i = blockIdx.x; i < live; i += gridDim.x) {
    const int b = (int)head[kLiveList + i];
    bool in_band = false;
    // the thread's strip: voxels (x, y, z0 .. z0 + nz - 1)
    const int row = b / nbx;
    const int x = (b % nbx) * kBX + threadIdx.x;
    const int y = (row % nby) * kBY + threadIdx.y;
    const int z0 = (row / nby) * kBZ;
    const int nz = min(kBZ, sz - z0);
    const int64_t i0 = ((int64_t)z0 * sy + y) * sx + x;
    if (x < sx && y < sy) {
      float gd[kBZ], gw[kBZ];
#pragma unroll
      for (int k = 0; k < kBZ; ++k) {
        if (k < nz) {
          gd[k] = tsdf_storage::load(gbar_d + i0 + k * plane);
          gw[k] = tsdf_storage::load(gbar_w + i0 + k * plane);
        }
      }
      const float wx = ((float)x + 0.5f) * p[19] + p[16];
      const float wy = ((float)y + 0.5f) * p[20] + p[17];
      // the (x, y) part of each camera row, summed first as in the twin
      const float ax = p[0] * wx + p[1] * wy;
      const float ay = p[4] * wx + p[5] * wy;
      const float az = p[8] * wx + p[9] * wy;
      // integrate.cu's prologue: camera point, pixel, depth tap, gates
      int pixel[kBZ];
      float cz[kBZ], sdf[kBZ];
      bool upd[kBZ];
#pragma unroll
      for (int k = 0; k < kBZ; ++k) {
        const float wz = ((float)(zs + z0 + k) + 0.5f) * p[21] + p[18];
        const float cx = ax + p[2] * wz + p[3];
        const float cy = ay + p[6] * wz + p[7];
        cz[k] = az + p[10] * wz + p[11];
        bool in_img = false;
        pixel[k] = 0;
        if (k < nz && cz[k] > 0.0f) {
          const float px = rintf((p[12] * cx + p[14] * cz[k]) / cz[k]);
          const float py = rintf((p[13] * cy + p[15] * cz[k]) / cz[k]);
          in_img = px >= 0.0f && px < (float)width && py >= 0.0f &&
                   py < (float)height;
          if (in_img) pixel[k] = (int)py * width + (int)px;
        }
        const float d = in_img ? __ldg(depth + pixel[k]) : 0.0f;
        sdf[k] = d - cz[k];
        upd[k] = in_img && d > 0.0f && sdf[k] >= -trunc;
      }
      float w[kBZ], t[kBZ];
#pragma unroll
      for (int k = 0; k < kBZ; ++k) {
        if (upd[k]) {
          w[k] = tsdf_storage::load(weight + i0 + k * plane);
          t[k] = tsdf_storage::load(tsdf + i0 + k * plane);
        }
      }
#pragma unroll
      for (int k = 0; k < kBZ; ++k) {
        if (k >= nz) continue;
        const int64_t v = i0 + k * plane;
        if (!upd[k]) {
          tsdf_storage::store(dd + v, gd[k]);
          tsdf_storage::store(dw + v, gw[k]);
          continue;
        }
        // volume cotangents: d new_d / d tsdf_in = w / (w+1); d new_d / d w
        // = (tsdf_in - min(sdf, trunc)) / (w+1)^2; the capped weight's
        // slope is 1 below the cap, 0.5 at the tie, 0 above
        const float new_w = w[k] + 1.0f;
        tsdf_storage::store(dd + v, gd[k] * (w[k] / new_w));
        const float o = fminf(sdf[k], trunc);
        float capfac = 1.0f;
        if (cap_weight) {
          capfac = (new_w < max_weight ? 1.0f : 0.0f) +
                   0.5f * (new_w == max_weight ? 1.0f : 0.0f);
        }
        tsdf_storage::store(
            dw + v, gd[k] * ((t[k] - o) / (new_w * new_w)) + gw[k] * capfac);
        if (!(sdf[k] < trunc)) continue;  // the clamp is flat: no pose term
        in_band = true;

        // dL/dx_c, with the voxel's centre and camera point again
        const float wz = ((float)(zs + z0 + k) + 0.5f) * p[21] + p[18];
        const float coef = gd[k] / new_w;
        float dxc, dyc, dzc;
        if (image_term) {
          const float cx = ax + p[2] * wz + p[3];
          const float cy = ay + p[6] * wz + p[7];
          const float gxv = depth_gradient(depth, pixel[k], 1,
                                           pixel[k] % width > 0,
                                           pixel[k] % width < width - 1);
          const float gyv = depth_gradient(depth, pixel[k], width,
                                           pixel[k] >= width,
                                           pixel[k] < (height - 1) * width);
          const float zc2 = cz[k] * cz[k];
          dxc = coef * gxv * fx / cz[k];
          dyc = coef * gyv * fy / cz[k];
          dzc = coef * (-gxv * fx * cx / zc2 - gyv * fy * cy / zc2 - 1.0f);
        } else {
          dxc = 0.0f;
          dyc = 0.0f;
          dzc = -coef;
        }
        acc[0][tid] += (double)(dxc * wx);
        acc[1][tid] += (double)(dxc * wy);
        acc[2][tid] += (double)(dxc * wz);
        acc[3][tid] += (double)dxc;
        acc[4][tid] += (double)(dyc * wx);
        acc[5][tid] += (double)(dyc * wy);
        acc[6][tid] += (double)(dyc * wz);
        acc[7][tid] += (double)dyc;
        acc[8][tid] += (double)(dzc * wx);
        acc[9][tid] += (double)(dzc * wy);
        acc[10][tid] += (double)(dzc * wz);
        acc[11][tid] += (double)dzc;
      }
    }

    // the brick's 12 sums in a fixed order into its own row: a tree over
    // the warp's 32 x (lane i adds lane i + 16, then i + 8, ...), then the
    // block's warps in y. A brick with no voxel in
    // the band added nothing: its row is zero and the sums stay zero.
    if (!__syncthreads_or(in_band)) {
      if (tid < kSums) partials[(int64_t)b * kSums + tid] = 0.0;
      continue;
    }
    for (int off = kBX / 2; off > 0; off >>= 1) {
      if (threadIdx.x < off) {
#pragma unroll
        for (int k = 0; k < kSums; ++k) acc[k][tid] += acc[k][tid + off];
      }
      __syncwarp();
    }
    __syncthreads();
    if (tid < kSums) {
      double sum = 0.0;
#pragma unroll
      for (int r = 0; r < kBY; ++r) sum += acc[tid][r * kBX];
      partials[(int64_t)b * kSums + tid] = sum;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kSums; ++k) acc[k][tid] = 0.0;
  }
}

}  // namespace

namespace {

template <typename T, bool SLAB>
int pose_grad(const void* tsdf, const void* weight, const void* gbar_d,
              const void* gbar_w, const void* depth, void* dd, void* dw,
              void* partials, long long n_blocks, const void* params, int sx,
              int sy, int sz, int width, int height, int cap_weight,
              int image_term, void* stream, int zg) {
  if (sx <= 0 || sy <= 0 || sz <= 0) {
    return n_blocks == 0 ? (int)cudaSuccess : (int)cudaErrorInvalidValue;
  }
  const int nbx = (sx + kBX - 1) / kBX;
  const int nby = (sy + kBY - 1) / kBY;
  const int nbz = (sz + kBZ - 1) / kBZ;
  const long long bricks = (long long)nbx * nby * nbz;
  if (bricks != n_blocks) return (int)cudaErrorInvalidValue;
  if (bricks > (1 << 30) || nbx > kMaxRowBricks) {
    return (int)cudaErrorInvalidConfiguration;
  }
  cudaStream_t st = (cudaStream_t)stream;
  float* scratch = (float*)const_cast<void*>(params);
  using tsdf_bricks::kMaxThreads;
  const int n = width * height;
  int blocks = (n + kMaxThreads - 1) / kMaxThreads;
  if (blocks > tsdf_bricks::kMaxBlocks) blocks = tsdf_bricks::kMaxBlocks;
  if (blocks < 1) blocks = 1;
  tsdf_bricks::depth_max_kernel<<<blocks, kMaxThreads, 0, st>>>(
      (const float*)depth, n, (unsigned*)scratch + kDepthMax);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  tsdf_bricks::brick_cull_kernel<false>
      <<<(unsigned)((bricks + kMaxThreads - 1) / kMaxThreads), kMaxThreads, 0,
         st>>>(scratch, nbx, nby, nbz, width, height, SLAB ? zg : 0);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  sms = sms > 0 ? sms : 1;
  const int rows = nby * nbz;
  const int copy_grid =
      rows < sms * kCopyBlocksPerSM ? rows : sms * kCopyBlocksPerSM;
  const bool vec =
      sx % (int)(sizeof(float4) / sizeof(T)) == 0 &&
      ((uintptr_t)gbar_d | (uintptr_t)gbar_w | (uintptr_t)dd |
       (uintptr_t)dw) % 16 == 0;
  if (vec) {
    pose_grad_copy_kernel<T, true, SLAB><<<copy_grid, kCopyThreads, 0, st>>>(
        (const T*)gbar_d, (const T*)gbar_w, (T*)dd, (T*)dw,
        (double*)partials, scratch, sx, sy, sz, nbx, nby, nbz, width,
        height, zg);
  } else {
    pose_grad_copy_kernel<T, false, SLAB><<<copy_grid, kCopyThreads, 0, st>>>(
        (const T*)gbar_d, (const T*)gbar_w, (T*)dd, (T*)dw,
        (double*)partials, scratch, sx, sy, sz, nbx, nby, nbz, width,
        height, zg);
  }
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  const long long walk_grid = (long long)sms * kWalkBlocksPerSM * kWalkWaves;
  pose_grad_walk_kernel<T, SLAB>
      <<<(unsigned)(walk_grid < bricks ? walk_grid : bricks), dim3(kBX, kBY),
         0, st>>>((const T*)tsdf, (const T*)weight, (const T*)gbar_d,
                  (const T*)gbar_w, (const float*)depth, (T*)dd, (T*)dw,
                  (double*)partials, scratch, sx, sy, sz, nbx, nby, width,
                  height, cap_weight, image_term, zg);
  return (int)cudaGetLastError();
}

}  // namespace

// params holds 24 floats and then the zeroed scratch of the brick walk
// (kernels/integrate.py:pose_grad_cuda); partials: (n_blocks, 12) float64
// with n_blocks the count of bricks, ceil(sx/32) * ceil(sy/4) * ceil(sz/8)
// (a count that disagrees is refused). Four launches on the stream: the
// depth maximum, the brick cull, the copy of the culled bricks, the walk of
// the live ones.
// tsdf, weight, gbar_d, gbar_w, dd and dw are float32 here, bfloat16 in
// tsdf_integrate_pose_grad_bf16. The _slab entry points take a z-slab of a
// volume, whose first plane in the whole volume is zg, after the stream.
extern "C" int tsdf_integrate_pose_grad(
    const void* tsdf, const void* weight, const void* gbar_d,
    const void* gbar_w, const void* depth,
    void* dd, void* dw, void* partials, long long n_blocks, const void* params,
    int sx, int sy, int sz, int width, int height, int cap_weight,
    int image_term, void* stream) {
  return pose_grad<float, false>(tsdf, weight, gbar_d, gbar_w, depth, dd, dw,
                                 partials, n_blocks, params, sx, sy, sz, width,
                                 height, cap_weight, image_term, stream, 0);
}

extern "C" int tsdf_integrate_pose_grad_bf16(
    const void* tsdf, const void* weight, const void* gbar_d,
    const void* gbar_w, const void* depth,
    void* dd, void* dw, void* partials, long long n_blocks, const void* params,
    int sx, int sy, int sz, int width, int height, int cap_weight,
    int image_term, void* stream) {
  return pose_grad<tsdf_storage::bf16, false>(
      tsdf, weight, gbar_d, gbar_w, depth, dd, dw, partials, n_blocks, params,
      sx, sy, sz, width, height, cap_weight, image_term, stream, 0);
}

extern "C" int tsdf_integrate_pose_grad_slab(
    const void* tsdf, const void* weight, const void* gbar_d,
    const void* gbar_w, const void* depth,
    void* dd, void* dw, void* partials, long long n_blocks, const void* params,
    int sx, int sy, int sz, int width, int height, int cap_weight,
    int image_term, void* stream, int zg) {
  return pose_grad<float, true>(tsdf, weight, gbar_d, gbar_w, depth, dd, dw,
                                partials, n_blocks, params, sx, sy, sz, width,
                                height, cap_weight, image_term, stream, zg);
}

extern "C" int tsdf_integrate_pose_grad_slab_bf16(
    const void* tsdf, const void* weight, const void* gbar_d,
    const void* gbar_w, const void* depth,
    void* dd, void* dw, void* partials, long long n_blocks, const void* params,
    int sx, int sy, int sz, int width, int height, int cap_weight,
    int image_term, void* stream, int zg) {
  return pose_grad<tsdf_storage::bf16, true>(
      tsdf, weight, gbar_d, gbar_w, depth, dd, dw, partials, n_blocks, params,
      sx, sy, sz, width, height, cap_weight, image_term, stream, zg);
}
