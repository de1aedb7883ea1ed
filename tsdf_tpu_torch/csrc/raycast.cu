// Sphere-traced TSDF raycast for Hopper (sm_90a).
//
// Replaces tsdf_tpu/kernels/raycast.py:raycast_pallas, the slab sweep,
// and the kernels/gather.py:lane_gather_op calls it made. The TPU has no
// per-lane gather, so the sweep resampled the volume slab by slab along
// image lines. Here one thread marches one ray with real trilinear reads:
// the ops/raycast.py contract (ray_directions, slab_near_far, march_rays)
// evaluated per pixel, expression for expression. Sphere tracing (step =
// clip(0.75 * tsdf, 0.05 trunc, 0.9 trunc), the twin's default; its
// fixed-step mode has no kernel) crosses free space in steps of ~1.4
// voxels.
//
// What bounds it on this card. On an H100 at 512^3 / 640x480 a render
// takes ~85 M samples, 276 a ray (PERF.md). The one-sample-at-a-time form
// before this one was bound by the latency of each ray's chain of
// dependent samples: a sample's eight taps are dependent loads that miss
// the 50 MB L2 (the volume is 512 MiB), its loop body was 216
// instructions (75 of them 64-bit tap addresses), and 62 registers a
// thread left room for 4 blocks an SM, so the 1200 blocks ran in 2.3
// waves (a quarter of the rays took 0.45 ms, all of them 1.04). Almost
// every sample lies in free space or behind a surface, where the volume
// is constant. The design:
//   * uniform bricks, the bit-exact form of the TPU sweep's empty-brick
//     skip (tsdf_tpu/kernels/raycast.py:92-114). A pre-pass
//     (brick_table_kernel) writes one float per brick of kBrick^3 voxels:
//     the brick's value when every voxel of the brick and of a one-voxel
//     apron on its high side of each axis (clamped at the volume's edge,
//     as the taps are) is bitwise equal to the others, else NaN ("load");
//     a NaN voxel makes its brick NaN. A sample whose lower corner lies in
//     a uniform brick reads only voxels of that closed box, so it takes
//     the brick's value for its eight taps and evaluates the same weight
//     expression, its common products taken once: the same bits, with no
//     volume load and no tap address. The samples themselves are all
//     kept, because each step depends on the exact bits of its sample.
//     kernels/raycast.py:uniform_bricks is the table in plain PyTorch,
//     held on the CPU. The pre-pass reads a brick only when its box can
//     meet a ray of the view (a conservative frustum test of its corners,
//     as integrate_bricks.cuh's cull; the others are marked NaN unread: a
//     wrong NaN costs loads, never bits), so its cost is the bytes in
//     view. The table (1 MiB at 512^3) stays in L2, and a ray keeps its
//     current brick's entry in a register;
//   * fewer instructions a sample: the secant refinement only on the step
//     that hits; the per-launch constants size * vs and size * vs - vs/10
//     hoisted (the same expressions, so the same bits); tap offsets in
//     32 bits from one base and three strides (the wrapper refuses a
//     volume of 2^31 voxels or more); read-only loads through __ldg. The
//     three IEEE divisions p / vs stay: they set which voxel a sample
//     reads and its weights;
//   * persistent warps that take 8x4 pixel tiles from a counter: rays of
//     a tile march through neighbouring voxels and bricks, and no wave of
//     blocks waits for its longest rays.
//
// Built with --fmad=false and IEEE division/sqrt, so each sample rounds
// as in the PyTorch twin.
//
// Storage: the volume is float or bf16 (storage.cuh). A bf16 instance tests
// its bricks for bitwise uniformity on the 16-bit words, stores a uniform
// brick's value widened to float in the table, and widens each tap it
// loads (2-byte reads): a sample's arithmetic is the float instance's on
// the widened values, as the twin casts after its gather.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "storage.cuh"

namespace {

constexpr int kMarching = 0;
constexpr int kHit = 1;
constexpr int kMiss = 2;
// ops/raycast.py:march_rays' default step scale
constexpr float kStepScale = 0.75f;

// the brick of the uniform table (kernels/raycast.py:RAY_BRICK)
constexpr int kBrickLog = 3;
constexpr int kBrick = 1 << kBrickLog;
// the pre-pass: a block of 32 x kBrick threads checks kGroup bricks along
// x in each of kChunk layers along z
constexpr int kGroup = 32 / kBrick;
constexpr int kChunk = 16;
// pixels of margin around the image in the pre-pass's frustum test
constexpr float kMarginPx = 2.0f;
// the march: blocks of kMarchThreads threads whose warps take tiles of
// kTileW x kTileH pixels from a counter until none is left; kMarchBlocks
// an SM at least, so up to 64 registers a thread (on an H100, caps of 40
// and 32 registers spilled and ran slower)
constexpr int kMarchThreads = 256;
constexpr int kMarchBlocks = 4;
constexpr int kTileW = 8;
constexpr int kTileH = 32 / kTileW;

// params (kernels/raycast.py:kernel_params): K^-1 (9), camera->world
// rotation (9), ray origin (3), space min (3), space max (3), voxel size
// (3), truncation distance, world->camera rows 0-2 (12), fx, fy, cx, cy;
// then the scratch the kernel writes before it reads it: the march's tile
// counter (zeroed by the pre-pass) and the brick table, one word a brick.
constexpr int kRot = 9;
constexpr int kOrigin = 18;
constexpr int kSmin = 21;
constexpr int kSmax = 24;
constexpr int kVs = 27;
constexpr int kTrunc = 30;
constexpr int kPoseInv = 31;
constexpr int kIntr = 43;
constexpr int kParams = 47;
constexpr int kCounter = kParams;
constexpr int kTable = kParams + 1;

// The pre-pass. Block (bx, by, bz) of 32 x kBrick threads owns bricks
// bx*kGroup .. bx*kGroup + kGroup - 1 along x at brick row by, in layers
// bz*kChunk .. bz*kChunk + kChunk - 1. First every warp tests some of those
// bricks' boxes against the view (lane = brick x corner). Then thread
// (x, y) streams its voxel column through each live layer's kBrick + 1
// planes (the last the z apron), the threads of the last row the y apron
// too, the last lane the x apron of the group's last brick, and the first
// lane of each brick's eight checks the x apron of the brick before it.
// No load waits for another and no barrier separates the layers, so a
// block keeps many loads in flight: the pass runs at the memory's rate
// over the bricks in view. The mismatches gather in shared memory, one
// word a layer; the table is written after one barrier.
template <typename T>
__global__ void __launch_bounds__(32 * kBrick)
brick_table_kernel(const T* __restrict__ tsdf, float* __restrict__ params,
                   int sx, int sy, int sz, int nbx, int nby, int nbz,
                   int width, int height) {
  using Word = typename tsdf_storage::Storage<T>::Word;
  const float* p = params;
  float* table = params + kTable;
  // the stored words, compared bitwise (widened to 32 bits in registers)
  const Word* bits = reinterpret_cast<const Word*>(tsdf);
  __shared__ unsigned live_s[kChunk], bad_s[kChunk], first_s[kChunk][kGroup];
  const int lane = threadIdx.x, row = threadIdx.y;
  const int bx0 = blockIdx.x * kGroup, by = blockIdx.y;
  const int bz0 = blockIdx.z * kChunk;
  const int layers = min(kChunk, nbz - bz0);
  const int k = lane >> kBrickLog;  // this lane's brick in the group
  if ((blockIdx.x | blockIdx.y | blockIdx.z | lane | row) == 0)
    reinterpret_cast<unsigned*>(params)[kCounter] = 0u;
  const float* pi = p + kPoseInv;
  const float right = (float)(width - 1) + kMarginPx;
  const float bottom = (float)(height - 1) + kMarginPx;
  for (int l = row; l < kChunk; l += kBrick) {
    // lane = brick (lane / 8) x corner (lane % 8) of the brick's box of
    // sample points, widened by one voxel each way: voxel centres
    // b*kBrick - 1 .. b*kBrick + kBrick + 1 on each axis
    const int c = lane & 7;
    const int b[3] = {bx0 + k, by, bz0 + l};
    float w[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const int i = (c >> a) & 1 ? b[a] * kBrick + kBrick + 1 : b[a] * kBrick - 1;
      w[a] = ((float)i + 0.5f) * p[kVs + a] + p[kSmin + a];
    }
    const float cx = pi[0] * w[0] + pi[1] * w[1] + pi[2] * w[2] + pi[3];
    const float cy = pi[4] * w[0] + pi[5] * w[1] + pi[6] * w[2] + pi[7];
    const float cz = pi[8] * w[0] + pi[9] * w[1] + pi[10] * w[2] + pi[11];
    const float u = p[kIntr] * cx + p[kIntr + 2] * cz;
    const float v = p[kIntr + 1] * cy + p[kIntr + 3] * cz;
    unsigned out = (unsigned)(cz <= 0.0f) |
                   (unsigned)(u + kMarginPx * cz < 0.0f) << 1 |
                   (unsigned)(right * cz - u < 0.0f) << 2 |
                   (unsigned)(v + kMarginPx * cz < 0.0f) << 3 |
                   (unsigned)(bottom * cz - v < 0.0f) << 4;
    // outside one plane at all 8 corners: no ray of the view meets it
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) out &= __shfl_xor_sync(0xffffffffu, out, o);
    const unsigned live = __ballot_sync(
        0xffffffffu, c == 0 && out == 0u && bx0 + k < nbx && l < layers);
    if (lane == 0) {
      unsigned group = 0u;
#pragma unroll
      for (int g = 0; g < kGroup; ++g) group |= ((live >> (g * 8)) & 1u) << g;
      live_s[l] = group;
      bad_s[l] = 0u;
    }
  }
  __syncthreads();
  const int x = min(bx0 * kBrick + lane, sx - 1);
  const int x_apron = min((bx0 + kGroup) * kBrick, sx - 1);
  const int y = min(by * kBrick + row, sy - 1);
  const int y_apron = min((by + 1) * kBrick, sy - 1);
  const int x_first = min((bx0 + k) * kBrick, sx - 1);
  const int y_first = min(by * kBrick, sy - 1);
  const bool apron_prev = (lane & (kBrick - 1)) == 0 && k > 0;
#pragma unroll 2
  for (int l = 0; l < layers; ++l) {
    if (live_s[l] == 0u) continue;  // the same in the whole block
    const int z0 = (bz0 + l) * kBrick;
    const unsigned first =
        __ldg(bits + (min(z0, sz - 1) * sy + y_first) * sx + x_first);
    unsigned v[kBrick + 1], va[kBrick + 1];
#pragma unroll
    for (int dz = 0; dz <= kBrick; ++dz) {
      const int zrow = min(z0 + dz, sz - 1) * sy;
      v[dz] = __ldg(bits + (zrow + y) * sx + x);
      va[dz] = row == kBrick - 1 ? __ldg(bits + (zrow + y_apron) * sx + x) : v[dz];
    }
    // the first voxel of the brick before this lane's (the x apron)
    const unsigned first_prev = __shfl_up_sync(0xffffffffu, first, 1);
    unsigned bad = 0u;
#pragma unroll
    for (int dz = 0; dz <= kBrick; ++dz) {
      bad |= (unsigned)(v[dz] != first || va[dz] != first) << k;
      if (apron_prev)
        bad |= (unsigned)(v[dz] != first_prev || va[dz] != first_prev) << (k - 1);
    }
    if (lane == 31) {
#pragma unroll
      for (int dz = 0; dz <= kBrick; ++dz) {
        const int zrow = min(z0 + dz, sz - 1) * sy;
        bad |= (unsigned)(__ldg(bits + (zrow + y) * sx + x_apron) != first) << k;
        if (row == kBrick - 1)
          bad |= (unsigned)(__ldg(bits + (zrow + y_apron) * sx + x_apron) != first) << k;
      }
    }
    bad = __reduce_or_sync(0xffffffffu, bad);
    if (lane == 0 && bad != 0u) atomicOr(&bad_s[l], bad);
    if (row == 0 && (lane & (kBrick - 1)) == 0) first_s[l][k] = first;
  }
  __syncthreads();
  const int t = row * 32 + lane;
  if (t < layers * kGroup) {
    const int l = t / kGroup, g = t % kGroup;
    if (bx0 + g < nbx) {
      const bool uniform = ((live_s[l] & ~bad_s[l]) >> g) & 1u;
      table[((bz0 + l) * nby + by) * nbx + bx0 + g] =
          uniform ? tsdf_storage::Storage<T>::widen(first_s[l][g]) : NAN;
    }
  }
}

template <typename T>
struct Grid {
  const T* __restrict__ tsdf;
  const float* __restrict__ table;
  int sx, sy, sz, nbx, nby;
  float vs[3];
  float max_value[3];  // size * vs
  float pulled[3];     // size * vs - vs / 10
};

// ops/trilinear.py:trilinear_sample's weighted sum of the eight taps
__device__ __forceinline__ float blend(float c000, float c001, float c010,
                                       float c011, float c100, float c101,
                                       float c110, float c111, float u,
                                       float w1, float w2) {
  return c000 * (1.0f - u) * (1.0f - w1) * (1.0f - w2) +
         c001 * (1.0f - u) * (1.0f - w1) * w2 +
         c010 * (1.0f - u) * w1 * (1.0f - w2) +
         c011 * (1.0f - u) * w1 * w2 +
         c100 * u * (1.0f - w1) * (1.0f - w2) +
         c101 * u * (1.0f - w1) * w2 +
         c110 * u * w1 * (1.0f - w2) +
         c111 * u * w1 * w2;
}

// ops/trilinear.py:trilinear_sample at one grid-local point, with the
// reference's border rules. ``brick`` and ``value`` are the ray's current
// brick and its table entry.
template <typename T>
__device__ __forceinline__ float trilinear(const Grid<T>& g, float p0, float p1,
                                           float p2, int& brick,
                                           float& value) {
  float p[3] = {p0, p1, p2};
  int lower[3];
  float frac[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    if (p[a] >= g.max_value[a]) p[a] = g.pulled[a];
    if (p[a] < 0.0f) p[a] = 0.0f;
    const float q = p[a] / g.vs[a] - 0.5f;
    // q < size - 0.5 after the pull-back, so lo <= size - 1
    const float lo = fmaxf(floorf(q), 0.0f);
    frac[a] = q - lo;
    lower[a] = (int)lo;
  }
  const int b = ((lower[2] >> kBrickLog) * g.nby + (lower[1] >> kBrickLog)) *
                    g.nbx + (lower[0] >> kBrickLog);
  if (b != brick) {
    brick = b;
    value = __ldg(g.table + b);
  }
  const float u = frac[0], w1 = frac[1], w2 = frac[2];
  if (!isnan(value)) {
    // blend() with all eight taps equal to value, its common products
    // taken once: the same roundings in the same order, so the same bits
    const float a0 = value * (1.0f - u), a1 = value * u;
    const float b00 = a0 * (1.0f - w1), b01 = a0 * w1;
    const float b10 = a1 * (1.0f - w1), b11 = a1 * w1;
    return b00 * (1.0f - w2) + b00 * w2 + b01 * (1.0f - w2) + b01 * w2 +
           b10 * (1.0f - w2) + b10 * w2 + b11 * (1.0f - w2) + b11 * w2;
  }
  // the taps clamp to the last voxel of each axis
  const int base = (lower[2] * g.sy + lower[1]) * g.sx + lower[0];
  const int dx = lower[0] + 1 < g.sx ? 1 : 0;
  const int dy = lower[1] + 1 < g.sy ? g.sx : 0;
  const int dz = lower[2] + 1 < g.sz ? g.sx * g.sy : 0;
  const T* v = g.tsdf + base;
  using tsdf_storage::ldg;
  return blend(ldg(v), ldg(v + dz), ldg(v + dy), ldg(v + dy + dz),
               ldg(v + dx), ldg(v + dx + dz), ldg(v + dx + dy),
               ldg(v + dx + dy + dz), u, w1, w2);
}

// One ray: the ops/raycast.py contract at pixel (px, py), written to verts.
template <typename T>
__device__ __forceinline__ void march(const Grid<T>& g, const float* __restrict__ params,
                                      float* __restrict__ verts, int px, int py,
                                      int width, int max_steps) {
  const float* ki = params;
  const float* rot = params + kRot;
  const float* origin = params + kOrigin;
  const float* smin = params + kSmin;
  const float* smax = params + kSmax;
  const float trunc = params[kTrunc];

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
  int brick = -1;
  float value = NAN;
  for (int count = 0; count < max_steps && status == kMarching; ++count) {
    const float s = trilinear(g, start[0] + t * d[0], start[1] + t * d[1],
                              start[2] + t * d[2], brick, value);
    // torch.clamp keeps a NaN, and a NaN sample never hits: the twin's ray
    // then marches on at t = NaN until max_steps and misses
    if (isnan(s)) break;
    const bool hit = s <= 0.0f;
    const bool backface = s > 0.0f && prev_tsdf < 0.0f;
    const float step = fminf(fmaxf(kStepScale * s, fixed_step), max_step);
    const float new_t = t + step;
    const bool escaped = !hit && !backface && new_t >= max_t;
    if (hit) {
      status = kHit;
      hit_t = t;
      if (s < 0.0f) {  // the secant refinement
        const float frac = prev_tsdf / (prev_tsdf - s);
        hit_t = t - prev_step + frac * prev_step;
      }
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

// Persistent warps: each takes a tile of kTileW x kTileH pixels from the
// counter, marches its 32 rays, and takes the next, so warps whose rays
// end early take more tiles and no wave of blocks waits for a few long
// rays.
template <typename T>
__global__ void __launch_bounds__(kMarchThreads, kMarchBlocks)
raycast_kernel(const T* __restrict__ tsdf, float* __restrict__ verts,
               float* __restrict__ params, int sx, int sy, int sz, int nbx,
               int nby, int width, int height, int max_steps) {
  Grid<T> g;
  g.tsdf = tsdf;
  g.table = params + kTable;
  g.sx = sx, g.sy = sy, g.sz = sz, g.nbx = nbx, g.nby = nby;
  const int size[3] = {sx, sy, sz};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    g.vs[a] = params[kVs + a];
    g.max_value[a] = (float)size[a] * g.vs[a];
    g.pulled[a] = g.max_value[a] - g.vs[a] / 10.0f;
  }
  unsigned* next = reinterpret_cast<unsigned*>(params) + kCounter;
  const int lane = threadIdx.x & 31;
  const int tiles_x = (width + kTileW - 1) / kTileW;
  const unsigned tiles = (unsigned)(tiles_x * ((height + kTileH - 1) / kTileH));
  for (;;) {
    unsigned tile = 0u;
    if (lane == 0) tile = atomicAdd(next, 1u);
    tile = __shfl_sync(0xffffffffu, tile, 0);
    if (tile >= tiles) break;
    const int px = (int)(tile % tiles_x) * kTileW + (lane % kTileW);
    const int py = (int)(tile / tiles_x) * kTileH + lane / kTileW;
    if (px < width && py < height) march(g, params, verts, px, py, width, max_steps);
  }
}

}  // namespace

// params holds kParams floats and then the scratch: the tile counter and
// the brick table, one word for each of ceil(sx/kBrick) * ceil(sy/kBrick)
// * ceil(sz/kBrick) bricks (kernels/raycast.py:brick_table_shape). Two
// launches on the stream: the brick table, the march.
namespace {

template <typename T>
int raycast(const void* tsdf, void* verts, const void* params, int sx, int sy,
            int sz, int width, int height, int max_steps, void* stream) {
  if (sx <= 0 || sy <= 0 || sz <= 0 || (int64_t)sx * sy * sz >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  float* scratch = (float*)const_cast<void*>(params);
  const int nbx = (sx + kBrick - 1) / kBrick;
  const int nby = (sy + kBrick - 1) / kBrick;
  const int nbz = (sz + kBrick - 1) / kBrick;
  brick_table_kernel<T><<<dim3((nbx + kGroup - 1) / kGroup, nby,
                            (nbz + kChunk - 1) / kChunk),
                       dim3(32, kBrick), 0, st>>>(
      (const T*)tsdf, scratch, sx, sy, sz, nbx, nby, nbz, width, height);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, raycast_kernel<T>,
                                                kMarchThreads, 0);
  const int64_t warps = (int64_t)((width + kTileW - 1) / kTileW) *
                        ((height + kTileH - 1) / kTileH);
  int64_t blocks = (int64_t)(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  const int64_t needed = (warps * 32 + kMarchThreads - 1) / kMarchThreads;
  if (blocks > needed) blocks = needed;
  raycast_kernel<T><<<(unsigned)blocks, kMarchThreads, 0, st>>>(
      (const T*)tsdf, (float*)verts, scratch, sx, sy, sz, nbx, nby, width,
      height, max_steps);
  return (int)cudaGetLastError();
}

}  // namespace

// tsdf is float32 here, bfloat16 in tsdf_raycast_bf16.
extern "C" int tsdf_raycast(const void* tsdf, void* verts, const void* params,
                            int sx, int sy, int sz, int width, int height,
                            int max_steps, void* stream) {
  return raycast<float>(tsdf, verts, params, sx, sy, sz, width, height,
                        max_steps, stream);
}

extern "C" int tsdf_raycast_bf16(const void* tsdf, void* verts,
                                 const void* params, int sx, int sy, int sz,
                                 int width, int height, int max_steps,
                                 void* stream) {
  return raycast<tsdf_storage::bf16>(tsdf, verts, params, sx, sy, sz, width,
                                     height, max_steps, stream);
}
