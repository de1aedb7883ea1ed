// The brick walk of the rigid TSDF integrations for Hopper (sm_90a), one
// kernel template over (storage, fast, colour), instantiated by integrate.cu (depth,
// each voxel's own pixel), integrate_fast.cu (depth, the decimated line
// convention, "fast") and integrate_color.cu (depth + colour, both
// conventions); its pre-passes and its cull also serve the pose adjoint of
// integrate_pose_grad.cu, whose gated voxels are the exact integrate's
// updated ones.
//
// What bounds these kernels on this card. Bytes set the floor: tsdf and
// weight are 8 B of reads and 8 B of writes per updated voxel (0.13 ms a
// frame at 512^3 for the ~27 M voxels a real frame updates), three colour
// bytes read and written per voxel in the colour band. The work before the
// gates is what held the one-thread-per-voxel form at 5-6.5x that floor: a
// frame with no depth cost as much as a real one (PERF.md). This design
// cuts that work three ways:
//   * bricks of kBX x kBY x kBZ voxels (x fastest), a block of kBX x kBY
//     threads a brick: no thread divides a voxel index, a warp's
//     tsdf/weight accesses are 128-byte runs and its colour bytes one
//     96-byte run (the (Z, Y, X, 3) u8 layout of the .tsdf file is kept);
//   * a conservative brick cull, first, in a pre-pass of one thread a
//     brick: the planes below are evaluated at the 8 corners of the brick's
//     box of voxel centres, widened by one voxel each way, and a brick whose
//     8 corners are all outside one plane is dropped; the others are
//     appended to a list, and the brick kernel's blocks walk only that
//     list, so a culled brick costs no block and touches no depth or volume
//     memory (on an H100 at 512^3, launching a block for every brick and
//     returning from the culled ones cost ~0.1 ms, a third of a real
//     frame: the card's rate of starting blocks).
//     Camera-space X, Y, Z and u = fx X + cx Z, v = fy Y + cy Z are affine
//     in the voxel index, so a plane's function that is negative at all 8
//     corners is negative on the whole box. The planes, with margins of
//     mu pixels on u and kMarginPx on v, which a voxel that passes the
//     gates is inside of by 1.5 pixels or more:
//       Z <= 0 (behind the camera), u + mu Z < 0, (W - 1 + mu) Z - u < 0,
//       v + m Z < 0, (H - 1 + m) Z - v < 0, Z > dmax + trunc,
//     dmax the largest depth of the frame (a first pre-pass reduces it); a
//     frame with no depth > 0 culls every brick. The widening puts a voxel
//     or more of slack between the box's corners and any kept voxel, far
//     more than the rounding of either.
//     The exact pixel (FAST = false) is round(u / Z), round(v / Z): a kept
//     voxel has u / Z >= -0.5, so mu = kMarginPx = 2 leaves 1.5 pixels.
//     The fast pixel (FAST = true) is (r, 4c) on the voxel column's image
//     line px = alpha + beta py, which passes through the voxel's own
//     projection (u / Z, v / Z): the row r = 2 floor(pyr / 2) with
//     pyr = round(v / Z) is within 1.5 of v / Z, so on a line with
//     |beta| <= 1 the line's column at r is within 1.5 of u / Z, and
//     rounding it to a multiple of 4 moves it 2 more: the sampled column is
//     within 3.5 pixels of u / Z, and mu = kFastMarginPx = 5 leaves 1.5
//     (the rows are gated by pyr as the exact pixel is: m = 2 holds). A
//     column steeper than |beta| = 1 is never updated, but its voxels in
//     the image count as misses wherever they lie, even behind the camera:
//     the line pre-pass raises a flag for any such column, and then the
//     cull keeps every brick so that the miss count is whole.
//     kernels/integrate.py:brick_cull is the same test in plain PyTorch,
//     held against the twins on the CPU;
//   * a z-strip per thread: a thread owns one (x, y) of its brick and walks
//     its kBZ voxels. p0*wx + p1*wy of each camera row is computed once
//     (C sums left to right, so the reused partial gives the same bits),
//     and the loop is unrolled so the projections and depth reads of all
//     kBZ voxels are issued before any of their tsdf/weight loads: several
//     memory round trips in flight per thread.
// The per-voxel gates still run for every voxel of a kept brick; the depth
// and colour images (1.2 + 0.9 MB at 640x480) stay in the 50 MB L2; the
// volume is updated in place, and a colour byte outside the band is not
// written.
//
// Rounding: rintf (half to even, as torch.round), IEEE divisions, and the
// library built with --fmad=false, so each product and sum rounds as in
// the PyTorch twins ops/integrate.py:integrate and integrate_fast, in
// their order: kernel and twin agree bit for bit.
//
// Storage: tsdf and weight are float (T = float) or bfloat16 (T = bf16,
// storage.cuh): a strip widens the two it loads and rounds the two it
// stores once; the arithmetic between is the float instance's. In bf16 an
// updated voxel moves 8 B of tsdf and weight, not 16.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "integrate_variants.cuh"
#include "storage.cuh"

namespace tsdf_bricks {
// internal linkage: each source that includes this header gets its own
// kernels, as it would from an anonymous namespace of its own
namespace {

// a brick: kBX x kBY threads, each walking kBZ voxels in z
// (kernels/integrate.py:BRICK mirrors these)
constexpr int kBX = 32;
constexpr int kBY = 4;
constexpr int kBZ = 8;
constexpr float kMarginPx = 2.0f;      // kernels/integrate.py:CULL_MARGIN_PX
constexpr float kFastMarginPx = 5.0f;  // kernels/integrate.py:FAST_CULL_MARGIN_PX
constexpr int kBlocksPerSM = 8;        // 64 registers a thread
// The brick kernel's grid, in SMs' worth of resident blocks: bricks differ
// in work (partly culled, partly outside the image), and a grid of many
// waves lets the card balance them. On an H100 at 512^3, one wave with a
// fixed stride over the list lost to a block a brick on a real frame; 16
// waves cost a frame with no live brick ~0.01 ms of empty blocks.
constexpr int kWaves = 16;
constexpr int kMaxThreads = 256;
constexpr int kMaxBlocks = 4096;  // the depth pre-pass: about a pixel a thread

// params: pose_inv rows 0-2 (12), fx, fy, cx, cy, offset (3),
// voxel size (3), truncation distance, max weight; then the scratch the
// wrapper allocates zeroed (kernels/integrate.py:kernel_params): one word
// into which the pre-pass writes the largest depth > 0 of the frame as
// float bits (non-negative floats order as unsigned integers), one word
// counting the live bricks, one the line pre-pass sets when a voxel column
// is steeper than |beta| = 1 (fast only), and the list of live bricks, one
// word each of all of the volume's bricks.
constexpr int kParams = 24;
constexpr int kDepthMax = kParams;
constexpr int kLiveCount = kParams + 1;
constexpr int kSteep = kParams + 2;
constexpr int kLiveList = kParams + 3;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Pre-pass 1: the largest depth > 0 of the frame (0 if none; +inf if any
// is +inf; NaN never counts), by block and then one atomicMax a block.
__global__ void __launch_bounds__(kMaxThreads)
depth_max_kernel(const float* __restrict__ depth, int n,
                 unsigned* __restrict__ dmax) {
  __shared__ float part[kMaxThreads / 32];
  float m = 0.0f;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const float d = depth[i];
    m = fmaxf(m, d > 0.0f ? d : 0.0f);
  }
  m = warp_max(m);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = threadIdx.x < blockDim.x / 32 ? part[threadIdx.x] : 0.0f;
    m = warp_max(m);
    if (threadIdx.x == 0) atomicMax(dmax, __float_as_uint(m));
  }
}

// True when no voxel of the brick at (x0, y0, z0) can pass the gates: all
// 8 corners of its widened box outside one plane, or no depth at all. z0 is
// the brick's first plane in the whole volume: a z-slab's local index plus
// the slab's first plane, so that a slab computes the whole volume's centres.
template <bool FAST>
__device__ __forceinline__ bool brick_culled(const float* __restrict__ p,
                                             float dmax, int x0, int y0,
                                             int z0, int width, int height) {
  constexpr float mu = FAST ? kFastMarginPx : kMarginPx;
  const float right = (float)(width - 1) + mu;
  const float bottom = (float)(height - 1) + kMarginPx;
  unsigned all = 0x3fu;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int ix = (c & 1) ? x0 + kBX : x0 - 1;
    const int iy = (c & 2) ? y0 + kBY : y0 - 1;
    const int iz = (c & 4) ? z0 + kBZ : z0 - 1;
    const float wx = ((float)ix + 0.5f) * p[19] + p[16];
    const float wy = ((float)iy + 0.5f) * p[20] + p[17];
    const float wz = ((float)iz + 0.5f) * p[21] + p[18];
    const float cx = p[0] * wx + p[1] * wy + p[2] * wz + p[3];
    const float cy = p[4] * wx + p[5] * wy + p[6] * wz + p[7];
    const float cz = p[8] * wx + p[9] * wy + p[10] * wz + p[11];
    const float u = p[12] * cx + p[14] * cz;
    const float v = p[13] * cy + p[15] * cz;
    all &= (unsigned)(cz <= 0.0f) | (unsigned)(u + mu * cz < 0.0f) << 1 |
           (unsigned)(right * cz - u < 0.0f) << 2 |
           (unsigned)(v + kMarginPx * cz < 0.0f) << 3 |
           (unsigned)(bottom * cz - v < 0.0f) << 4 |
           (unsigned)(cz > dmax + p[22]) << 5;
  }
  return all != 0u || !(dmax > 0.0f);
}

// Pre-pass 2: one thread a brick, b = (bz * nby + by) * nbx + bx; the live
// ones are appended to the list, one atomicAdd a warp. The order of the
// list varies from run to run; the bricks are independent, so the volume
// does not (the pose adjoint keeps its sums by brick id for the same
// reason). In fast mode a steep column keeps every brick. zg is the
// volume's first plane in the whole volume (0 unless it is a z-slab).
template <bool FAST>
__global__ void __launch_bounds__(kMaxThreads)
brick_cull_kernel(float* __restrict__ params, int nbx, int nby, int nbz,
                  int width, int height, int zg) {
  const float* p = params;
  unsigned* head = reinterpret_cast<unsigned*>(params);
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  bool live = false;
  if (b < nbx * nby * nbz) {
    const int bx = b % nbx, t = b / nbx;
    live = (FAST && head[kSteep] != 0u) ||
           !brick_culled<FAST>(p, __uint_as_float(head[kDepthMax]), bx * kBX,
                               (t % nby) * kBY, zg + (t / nby) * kBZ, width,
                               height);
  }
  const unsigned mask = __ballot_sync(0xffffffffu, live);
  if (mask == 0u) return;
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(mask) - 1;
  unsigned base = 0u;
  if (lane == leader) base = atomicAdd(head + kLiveCount, __popc(mask));
  base = __shfl_sync(0xffffffffu, base, leader);
  if (live) head[kLiveList + base + __popc(mask & ((1u << lane) - 1u))] = b;
}

// What one thread's strip reads and writes besides tsdf and weight.
struct Frame {
  uint8_t* __restrict__ color;       // (Z, Y, X, 3), COLOR only
  const float* __restrict__ depth;
  const uint8_t* __restrict__ rgb;   // (H, W, 3), COLOR only
  const float2* __restrict__ lines;  // (Z, X) column lines, FAST only
};

// The z-strip of one thread: voxels (x, y, z0 .. z0 + kBZ - 1) of the whole
// volume, whose centres it computes, its first plane zl in this volume (a
// z-slab's planes start at the whole volume's zg: z0 = zg + zl), their
// camera rows' (x, y) parts ax, ay, az already summed. Adds the strip's
// in-image voxels of steep columns to ``missed`` (FAST).
template <typename T, bool FAST, bool COLOR>
__device__ __forceinline__ void fuse_strip(
    T* __restrict__ tsdf, T* __restrict__ weight, const Frame& f,
    const float* __restrict__ p, float ax, float ay, float az, int64_t i0,
    int64_t plane, int x, int z0, int zl, int nz, int sx, int width,
    int height, int cap_weight, int& missed) {
  const float trunc = p[22];
  int pixel[kBZ];
  float cz[kBZ];
  bool in_img[kBZ];
#pragma unroll
  for (int k = 0; k < kBZ; ++k) {
    in_img[k] = false;
    pixel[k] = 0;
    const float wz = ((float)(z0 + k) + 0.5f) * p[21] + p[18];
    if constexpr (FAST) {
      // integrate_variants.cuh's decimated pixel, in its order
      const float ky = p[6] * wz + p[7];
      const float kz = p[10] * wz + p[11];
      const float cy = ay + ky;
      cz[k] = az + kz;
      if (k < nz) {
        float py = p[13] * cy / cz[k] + p[15];
        py = isfinite(py) ? tsdf_variants::clip_big(py) : -1.0f;
        const int pyr = (int)rintf(py);
        const float2 line = __ldg(f.lines + (int64_t)(zl + k) * sx + x);
        const int pyd = min(max(pyr, 0), height - 1) >> 1;
        const float row = (float)pyd * 2.0f;
        const int col = (int)rintf(
            tsdf_variants::clip_big(line.x + line.y * row) / 4.0f);
        const int pxd = col * 4;
        const bool in = pyr >= 0 && pyr < height && pxd >= 0 && pxd < width;
        pixel[k] = (pyd * 2) * width + pxd;
        const bool matched = fabsf(line.y) <= 1.0f;
        missed += (int)(in && !matched);
        in_img[k] = in && matched && cz[k] > 0.0f;
      }
    } else {
      const float cx = ax + p[2] * wz + p[3];
      const float cy = ay + p[6] * wz + p[7];
      cz[k] = az + p[10] * wz + p[11];
      if (k < nz && cz[k] > 0.0f) {
        const float px = rintf((p[12] * cx + p[14] * cz[k]) / cz[k]);
        const float py = rintf((p[13] * cy + p[15] * cz[k]) / cz[k]);
        in_img[k] = px >= 0.0f && px < (float)width && py >= 0.0f &&
                    py < (float)height;
        if (in_img[k]) pixel[k] = (int)py * width + (int)px;
      }
    }
  }
  float d[kBZ];
#pragma unroll
  for (int k = 0; k < kBZ; ++k)
    d[k] = in_img[k] ? __ldg(f.depth + pixel[k]) : 0.0f;
  bool upd[kBZ];
  float sdf[kBZ], w[kBZ], t[kBZ];
#pragma unroll
  for (int k = 0; k < kBZ; ++k) {
    sdf[k] = d[k] - cz[k];
    upd[k] = in_img[k] && d[k] > 0.0f && sdf[k] >= -trunc;
    if (upd[k]) {
      w[k] = tsdf_storage::load(weight + i0 + k * plane);
      t[k] = tsdf_storage::load(tsdf + i0 + k * plane);
    }
  }
#pragma unroll
  for (int k = 0; k < kBZ; ++k) {
    if (!upd[k]) continue;
    const float obs = fminf(sdf[k], trunc);
    float new_w = w[k] + 1.0f;
    const float new_d = (t[k] * w[k] + obs) / new_w;
    if (cap_weight) new_w = fminf(new_w, p[23]);
    tsdf_storage::store(tsdf + i0 + k * plane, new_d);
    tsdf_storage::store(weight + i0 + k * plane, new_w);
    if (COLOR && fabsf(sdf[k]) < trunc) {
      const float rate = fmaxf(1.0f / new_w, 1.0f / p[23]);
      uint8_t* c = f.color + 3 * (i0 + k * plane);
      const uint8_t* s = f.rgb + 3 * (int64_t)pixel[k];
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const float old = (float)c[ch];
        const float blended = old + rate * ((float)__ldg(s + ch) - old);
        c[ch] = (uint8_t)fminf(fmaxf(rintf(blended), 0.0f), 255.0f);
      }
    }
  }
}

// kWaves * kBlocksPerSM blocks an SM walk the list of live bricks with a
// fixed stride, one brick a block at a time: a culled brick costs no block.
// SLAB: the volume is a z-slab whose planes start at the whole volume's zg.
// A whole volume takes the instance without it, whose code is the form
// before slabs: with a run-time first plane the depth-only walk's inner loop
// took ~45 more SASS instructions and 3 % more time on an H100.
template <typename T, bool FAST, bool COLOR, bool SLAB>
__global__ void __launch_bounds__(kBX * kBY, kBlocksPerSM)
integrate_kernel(T* __restrict__ tsdf, T* __restrict__ weight,
                 Frame f, const float* __restrict__ params,
                 int* __restrict__ miss, int sx, int sy, int sz, int nbx,
                 int nby, int width, int height, int cap_weight, int zg) {
  const int zs = SLAB ? zg : 0;
  const float* p = params;
  const unsigned* head = reinterpret_cast<const unsigned*>(params);
  const unsigned live = head[kLiveCount];
  const int64_t plane = (int64_t)sx * sy;
  int missed = 0;
  for (unsigned i = blockIdx.x; i < live; i += gridDim.x) {
    const int b = (int)head[kLiveList + i];
    const int t = b / nbx;
    const int x = (b % nbx) * kBX + threadIdx.x;
    const int y = (t % nby) * kBY + threadIdx.y;
    const int z0 = (t / nby) * kBZ;
    if (x >= sx || y >= sy) continue;
    const float wx = ((float)x + 0.5f) * p[19] + p[16];
    const float wy = ((float)y + 0.5f) * p[20] + p[17];
    // the (x, y) part of each camera row, summed first as in the twins
    fuse_strip<T, FAST, COLOR>(
        tsdf, weight, f, p, p[0] * wx + p[1] * wy, p[4] * wx + p[5] * wy,
        p[8] * wx + p[9] * wy, ((int64_t)z0 * sy + y) * sx + x, plane, x,
        zs + z0, z0, min(kBZ, sz - z0), sx, width, height, cap_weight, missed);
  }
  if constexpr (FAST) {
    missed = __reduce_add_sync(0xffffffffu, missed);
    if ((threadIdx.x & 31) == 0 && missed > 0) atomicAdd(miss, missed);
  }
}

// params holds kParams floats and then the zeroed scratch above, 3 words
// and one a brick: ceil(sx/kBX) * ceil(sy/kBY) * ceil(sz/kBZ) of them
// (kernels/integrate.py:brick_grid). Launches on the stream: the depth
// maximum, the column lines (FAST: ``lines`` holds sx*sz float2, ``miss``
// one int32 the caller zeroed), the brick cull, the live bricks. zg is the
// volume's first plane in the whole volume: 0, or a z-slab's first plane
// (exact as a float below 2^24), so that every centre, line and cull is
// the whole volume's.
template <typename T, bool FAST, bool COLOR>
int launch(T* tsdf, T* weight, const Frame& f, void* lines,
           int* miss, void* params, int sx, int sy, int sz, int width,
           int height, int cap_weight, cudaStream_t st, int zg) {
  if (sx <= 0 || sy <= 0 || sz <= 0) return (int)cudaSuccess;
  float* scratch = (float*)params;
  const int nbx = (sx + kBX - 1) / kBX;
  const int nby = (sy + kBY - 1) / kBY;
  const int nbz = (sz + kBZ - 1) / kBZ;
  const int64_t bricks = (int64_t)nbx * nby * nbz;
  if (bricks > (1 << 30)) return (int)cudaErrorInvalidConfiguration;
  const int n = width * height;
  int blocks = (n + kMaxThreads - 1) / kMaxThreads;
  blocks = blocks < 1 ? 1 : (blocks > kMaxBlocks ? kMaxBlocks : blocks);
  depth_max_kernel<<<blocks, kMaxThreads, 0, st>>>(
      f.depth, n, (unsigned*)scratch + kDepthMax);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  if constexpr (FAST) {
    if (sz > 65535) return (int)cudaErrorInvalidConfiguration;
    const int threads = sx >= kMaxThreads ? kMaxThreads : ((sx + 31) / 32) * 32;
    const int y_pad = ((sy + 127) / 128) * 128;
    const dim3 grid((sx + threads - 1) / threads, sz);
    tsdf_variants::fit_lines_kernel<<<grid, threads, 0, st>>>(
        (float2*)lines, scratch, sx, sz, (float)y_pad - 0.5f,
        (unsigned*)scratch + kSteep, zg);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  brick_cull_kernel<FAST>
      <<<(unsigned)((bricks + kMaxThreads - 1) / kMaxThreads), kMaxThreads, 0,
         st>>>(scratch, nbx, nby, nbz, width, height, zg);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int64_t grid = (int64_t)(sms > 0 ? sms : 1) * kBlocksPerSM * kWaves;
  if (grid > bricks) grid = bricks;
  if (zg == 0) {
    integrate_kernel<T, FAST, COLOR, false>
        <<<(unsigned)grid, dim3(kBX, kBY), 0, st>>>(
            tsdf, weight, f, scratch, miss, sx, sy, sz, nbx, nby, width,
            height, cap_weight, 0);
  } else {
    integrate_kernel<T, FAST, COLOR, true>
        <<<(unsigned)grid, dim3(kBX, kBY), 0, st>>>(
            tsdf, weight, f, scratch, miss, sx, sy, sz, nbx, nby, width,
            height, cap_weight, zg);
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace tsdf_bricks
