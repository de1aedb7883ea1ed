// The linearisation of a Levenberg-Marquardt step on the depth residuals of
// a differentiable render, for Hopper (sm_90a): config 4's pose step
// (tools/run_config4.py, pipelines/pose_recovery.py:lm_step).
//
// Replaces no TPU kernel. The JAX package takes the step's (H*W, 6)
// Jacobian by jax.jacfwd through the Newton correction
// (tsdf_tpu/ops/raycast_diff.py), which XLA fuses; the port took it by six
// forward-mode dual passes of plain PyTorch, ~3500 launches a step whose
// dispatch held the card 96 % idle. Here one thread takes a ray through
// the whole linearisation, the chain rule written out: the direction
// normalize(R K^-1 p) and its six tangents, the point p0 = c + t0 d, its
// eight taps, f(p0) and the analytic trilinear gradient (zero along a
// coordinate the border rules hold), the frozen slope f' = grad f . d
// (|f'| >= 1e-6, its sign kept), t* = t0 - f / f' and
// dt* = -grad f . (dc + t0 dd) / f', v = c + t* d and
// dv = dc + dt* d + t* dd, the camera depth z through P^-1 as
// Camera.world_to_camera writes it (its w row included) and dz, the band's
// mask, r and the row J. ops/lm_linearise.py:linearise is the plain twin.
//
// The pose's tangents: each block's first six threads differentiate
// se3_exp at the step's xi in dual numbers, both branches of its
// Rodrigues coefficients (utils/se3.py:_abc) included, form
// dP_j = dE_j P0 and d(P^-1)_j = -P^-1 dP_j P^-1 (the tangent of the LU
// inverse) into shared memory; every block runs the same code on the same
// bits, so all blocks agree, and nothing is read back to the host.
//
// The sums: each thread accumulates its rays' 21 entries of J^T J, 6 of
// J^T r, r^2 and the inlier count in float64 (a product of two float32 is
// exact in float64); a block reduces them by warp shuffles and then across
// its warps in a fixed order, and writes its row of partials; a second,
// one-block launch sums the rows in a fixed order (a warp a term) and
// writes J^T J in full, J^T r, sum r^2 and the count. No atomics: a call
// repeats its bits.
//
// What bounds it on this card: a ray reads ~41 bytes (t0, hit, target and
// eight 4-byte taps, two pairs of 32-byte sectors in a float32 volume), so
// 307200 rays are ~12.6 MB, ~4 us at 3.35 TB/s; its ~700 float32 and 29
// float64 operations are ~0.2 GFLOP in all. The taps are dependent loads
// that miss L2, behind the loads of t0, hit and target: a thread takes five
// rays, whose t0, hit and target it loads while the block's first threads
// form the tangents, so that 240 blocks of 256 threads (116 registers, two
// blocks an SM) cover 640x480 in one wave; the rays of a warp are
// neighbouring pixels, whose taps share sectors. On an H100 at 512^3 /
// 640x480 it takes ~0.05 ms, ~15x its bound (four rays a thread, 300
// blocks in 1.14 waves and no prefetch, took ~0.07): each ray's loads and
// ~700 dependent operations run one after another in a thread.
//
// Built with --fmad=false and IEEE division/sqrt, as the other kernels.
// Storage: the volume is float or bf16 (storage.cuh); a bf16 tap is
// widened and the arithmetic is the float instance's.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "storage.cuh"

namespace {

// kernels/lm.py:RAYS_PER_BLOCK is kThreads * kRaysPerThread
constexpr int kThreads = 256;
constexpr int kRaysPerThread = 5;
constexpr int kRaysPerBlock = kThreads * kRaysPerThread;
constexpr int kWarps = kThreads / 32;
// the terms a block sums: J^T J's upper triangle (21, row-major), J^T r
// (6), r^2, inliers
constexpr int kTerms = 29;
constexpr int kJtr = 21;
// the output (ops/lm_linearise.py:SUMS): J^T J in full (36), J^T r (6),
// sum r^2, inliers; then the blocks' rows of kTerms partials
constexpr int kSums = 44;

struct Dual {
  float v, t;
};
__device__ __forceinline__ Dual dual(float v) { return {v, 0.0f}; }
__device__ __forceinline__ Dual operator+(Dual a, Dual b) { return {a.v + b.v, a.t + b.t}; }
__device__ __forceinline__ Dual operator-(Dual a, Dual b) { return {a.v - b.v, a.t - b.t}; }
__device__ __forceinline__ Dual operator-(Dual a) { return {-a.v, -a.t}; }
__device__ __forceinline__ Dual operator*(Dual a, Dual b) {
  return {a.v * b.v, a.t * b.v + a.v * b.t};
}
__device__ __forceinline__ Dual operator/(Dual a, Dual b) {
  const float q = a.v / b.v;
  return {q, (a.t - b.t * q) / b.v};
}
__device__ __forceinline__ Dual dsqrt(Dual a) {
  const float s = sqrtf(a.v);
  return {s, a.t / (2.0f * s)};
}
__device__ __forceinline__ Dual dsin(Dual a) { return {sinf(a.v), a.t * cosf(a.v)}; }
__device__ __forceinline__ Dual dcos(Dual a) { return {cosf(a.v), -(a.t * sinf(a.v))}; }

// what a block holds in shared memory
struct Shared {
  float ki[9];      // K^-1, row-major
  float rot[9];     // the twisted pose's rotation
  float origin[3];  // its centre
  float pi[2][4];   // rows 2 and 3 of its inverse
  float smin[3], vs[3], max_value[3], pulled[3];
  // a twist axis: dR (9), dc (3), rows 2 and 3 of d(P^-1) (8)
  float tan[6][20];
  double red[kWarps][kTerms];
};

// The tangent along twist axis j of se3_exp(xi) P0 and of its inverse
// (utils/se3.py:se3_exp, matmul_small, Camera.set_pose), into s.tan[j].
__device__ void pose_tangent(const float* __restrict__ xi,
                             const float* __restrict__ pose0,
                             const float* __restrict__ pose_inv, int j,
                             Shared& s) {
  Dual x[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) x[k] = {xi[k], k == j ? 1.0f : 0.0f};
  const Dual w0 = x[0], w1 = x[1], w2 = x[2], zero = dual(0.0f);
  const Dual t2 = w0 * w0 + w1 * w1 + w2 * w2;
  const Dual k[3][3] = {{zero, -w2, w1}, {w2, zero, -w0}, {-w1, w0, zero}};
  Dual kk[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      kk[i][c] = k[i][0] * k[0][c] + k[i][1] * k[1][c] + k[i][2] * k[2][c];
  // _abc: the Taylor series below theta^2 = 1e-8
  Dual a, b, cc;
  if (t2.v < 1e-8f) {
    a = dual(1.0f) - t2 / dual(6.0f);
    b = dual(0.5f) - t2 / dual(24.0f);
    cc = dual(1.0f / 6.0f) - t2 / dual(120.0f);
  } else {
    const Dual theta = dsqrt(t2);
    a = dsin(theta) / theta;
    b = (dual(1.0f) - dcos(theta)) / t2;
    cc = (dual(1.0f) - a) / t2;
  }
  // E = [R, V v; 0 1] with R = I + a K + b K^2, V = I + b K + c K^2
  Dual e[3][4];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    Dual vrow[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const Dual eye = dual(i == c ? 1.0f : 0.0f);
      e[i][c] = eye + a * k[i][c] + b * kk[i][c];
      vrow[c] = eye + b * k[i][c] + cc * kk[i][c];
    }
    e[i][3] = vrow[0] * x[3] + vrow[1] * x[4] + vrow[2] * x[5];
  }
  // dP = dE P0: rows 0-2 (E's last row has no tangent, so dP's has none)
  float dp[4][4];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      dp[i][c] = e[i][0].t * pose0[c] + e[i][1].t * pose0[4 + c] +
                 e[i][2].t * pose0[8 + c] + e[i][3].t * pose0[12 + c];
#pragma unroll
  for (int c = 0; c < 4; ++c) dp[3][c] = 0.0f;
  // d(P^-1) = -P^-1 (dP P^-1), rows 2 and 3
  float m[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      m[i][c] = dp[i][0] * pose_inv[c] + dp[i][1] * pose_inv[4 + c] +
                dp[i][2] * pose_inv[8 + c] + dp[i][3] * pose_inv[12 + c];
  float* out = s.tan[j];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int c = 0; c < 3; ++c) out[3 * i + c] = dp[i][c];
    out[9 + i] = dp[i][3];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float* pr = pose_inv + 4 * (2 + r);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      out[12 + 4 * r + c] =
          -(pr[0] * m[0][c] + pr[1] * m[1][c] + pr[2] * m[2][c] + pr[3] * m[3][c]);
  }
}

// One ray's residual and row of J, or false outside the band (no hit, no
// target depth, or the corrected depth beyond band_mm of the target).
template <typename T>
__device__ __forceinline__ bool linearise_ray(const Shared& s, const T* __restrict__ tsdf,
                                              int sx, int sy, int sz, int px, int py,
                                              float t0, float target, float band,
                                              float& r, float jac[6]) {
  // ray_directions: normalize(R K^-1 p), the raw direction and norm kept
  const float fx = (float)px, fy = (float)py;
  float kp[3], raw[3], d[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) kp[i] = s.ki[3 * i] * fx + s.ki[3 * i + 1] * fy + s.ki[3 * i + 2];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    raw[i] = s.rot[3 * i] * kp[0] + s.rot[3 * i + 1] * kp[1] + s.rot[3 * i + 2] * kp[2];
  const float norm = sqrtf(raw[0] * raw[0] + raw[1] * raw[1] + raw[2] * raw[2]);
#pragma unroll
  for (int i = 0; i < 3; ++i) d[i] = raw[i] / norm;

  // ops/trilinear.py:trilinear_sample_and_grad at p0 = c + t0 d
  int lower[3];
  float frac[3];
  bool free[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float p = s.origin[a] + t0 * d[a] - s.smin[a];
    free[a] = p >= 0.0f && p < s.max_value[a];
    float q = p >= s.max_value[a] ? s.pulled[a] : p;
    if (q < 0.0f) q = 0.0f;
    const float g = q / s.vs[a] - 0.5f;
    // g < size - 0.5 after the pull-back, so lo <= size - 1
    const float lo = fmaxf(floorf(g), 0.0f);
    frac[a] = g - lo;
    lower[a] = (int)lo;
  }
  const int base = (lower[2] * sy + lower[1]) * sx + lower[0];
  const int ox = lower[0] + 1 < sx ? 1 : 0;
  const int oy = lower[1] + 1 < sy ? sx : 0;
  const int oz = lower[2] + 1 < sz ? sx * sy : 0;
  const T* v = tsdf + base;
  using tsdf_storage::ldg;
  const float c000 = ldg(v), c001 = ldg(v + oz), c010 = ldg(v + oy),
              c011 = ldg(v + oy + oz), c100 = ldg(v + ox), c101 = ldg(v + ox + oz),
              c110 = ldg(v + ox + oy), c111 = ldg(v + ox + oy + oz);
  const float u = frac[0], w1 = frac[1], w2 = frac[2];
  const float f = c000 * (1.0f - u) * (1.0f - w1) * (1.0f - w2) +
                  c001 * (1.0f - u) * (1.0f - w1) * w2 +
                  c010 * (1.0f - u) * w1 * (1.0f - w2) +
                  c011 * (1.0f - u) * w1 * w2 +
                  c100 * u * (1.0f - w1) * (1.0f - w2) +
                  c101 * u * (1.0f - w1) * w2 +
                  c110 * u * w1 * (1.0f - w2) +
                  c111 * u * w1 * w2;
  const float fu = (c100 - c000) * (1.0f - w1) * (1.0f - w2) + (c101 - c001) * (1.0f - w1) * w2 +
                   (c110 - c010) * w1 * (1.0f - w2) + (c111 - c011) * w1 * w2;
  const float fv = (c010 - c000) * (1.0f - u) * (1.0f - w2) + (c011 - c001) * (1.0f - u) * w2 +
                   (c110 - c100) * u * (1.0f - w2) + (c111 - c101) * u * w2;
  const float fw = (c001 - c000) * (1.0f - u) * (1.0f - w1) + (c011 - c010) * (1.0f - u) * w1 +
                   (c101 - c100) * u * (1.0f - w1) + (c111 - c110) * u * w1;
  const float fa[3] = {fu, fv, fw};
  float g[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) g[a] = free[a] ? fa[a] / s.vs[a] : 0.0f;

  // the frozen slope and the Newton correction
  float fp = g[0] * d[0] + g[1] * d[1] + g[2] * d[2];
  if (fabsf(fp) < 1e-6f) fp = fp < 0.0f ? -1e-6f : 1e-6f;
  const float ts = t0 - f / fp;
  float vv[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) vv[i] = s.origin[i] + ts * d[i];
  const float* p2 = s.pi[0];
  const float* p3 = s.pi[1];
  const float num = p2[0] * vv[0] + p2[1] * vv[1] + p2[2] * vv[2] + p2[3];
  const float den = p3[0] * vv[0] + p3[1] * vv[1] + p3[2] * vv[2] + p3[3];
  const float z = num / den;
  if (!(fabsf(z - target) < band)) return false;
  r = z - target;

#pragma unroll
  for (int j = 0; j < 6; ++j) {
    const float* tj = s.tan[j];
    float ddr[3], dd[3], dp[3], dv[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      ddr[i] = tj[3 * i] * kp[0] + tj[3 * i + 1] * kp[1] + tj[3 * i + 2] * kp[2];
    const float dn = d[0] * ddr[0] + d[1] * ddr[1] + d[2] * ddr[2];
#pragma unroll
    for (int i = 0; i < 3; ++i) dd[i] = (ddr[i] - d[i] * dn) / norm;
#pragma unroll
    for (int i = 0; i < 3; ++i) dp[i] = tj[9 + i] + t0 * dd[i];
    const float dt = -(g[0] * dp[0] + g[1] * dp[1] + g[2] * dp[2]) / fp;
#pragma unroll
    for (int i = 0; i < 3; ++i) dv[i] = tj[9 + i] + dt * d[i] + ts * dd[i];
    const float* q2 = tj + 12;
    const float* q3 = tj + 16;
    const float dnum = q2[0] * vv[0] + q2[1] * vv[1] + q2[2] * vv[2] + q2[3] +
                       (p2[0] * dv[0] + p2[1] * dv[1] + p2[2] * dv[2]);
    const float dden = q3[0] * vv[0] + q3[1] * vv[1] + q3[2] * vv[2] + q3[3] +
                       (p3[0] * dv[0] + p3[1] * dv[1] + p3[2] * dv[2]);
    jac[j] = (dnum - z * dden) / den;
  }
  return true;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
linearise_kernel(const T* __restrict__ tsdf, const float* __restrict__ t0,
                 const unsigned char* __restrict__ hit, const float* __restrict__ target,
                 const float* __restrict__ xi, const float* __restrict__ pose0,
                 const float* __restrict__ pose, const float* __restrict__ pose_inv,
                 const float* __restrict__ k_inv, const float* __restrict__ space_min,
                 const float* __restrict__ voxel_size, double* __restrict__ partials,
                 float* __restrict__ rows, int sx, int sy, int sz, int width, int n,
                 float band) {
  __shared__ Shared s;
  const int tid = threadIdx.x;
  // this thread's rays' inputs, loaded while the tangents are formed
  float in_t0[kRaysPerThread], in_target[kRaysPerThread];
  bool in_hit[kRaysPerThread];
#pragma unroll
  for (int q = 0; q < kRaysPerThread; ++q) {
    const int i = blockIdx.x * kRaysPerBlock + q * kThreads + tid;
    in_t0[q] = i < n ? t0[i] : 0.0f;
    in_target[q] = i < n ? target[i] : 0.0f;
    in_hit[q] = i < n && hit[i] != 0;
  }
  if (tid < 6) {
    pose_tangent(xi, pose0, pose_inv, tid, s);
  } else if (tid == 32) {
    const int size[3] = {sx, sy, sz};
    for (int i = 0; i < 9; ++i) {
      s.ki[i] = k_inv[i];
      s.rot[i] = pose[4 * (i / 3) + i % 3];
    }
    for (int a = 0; a < 3; ++a) {
      s.origin[a] = pose[4 * a + 3];
      s.smin[a] = space_min[a];
      s.vs[a] = voxel_size[a];
      s.max_value[a] = s.vs[a] * (float)size[a];
      s.pulled[a] = s.max_value[a] - s.vs[a] / 10.0f;
    }
    for (int c = 0; c < 4; ++c) {
      s.pi[0][c] = pose_inv[8 + c];
      s.pi[1][c] = pose_inv[12 + c];
    }
  }
  __syncthreads();

  double acc[kTerms];
#pragma unroll
  for (int k = 0; k < kTerms; ++k) acc[k] = 0.0;
#pragma unroll 1
  for (int q = 0; q < kRaysPerThread; ++q) {
    const int i = blockIdx.x * kRaysPerBlock + q * kThreads + tid;
    if (i >= n) break;
    const float tgt = in_target[q];
    float r = 0.0f, jac[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    const bool m = in_hit[q] && tgt > 0.0f &&
                   linearise_ray(s, tsdf, sx, sy, sz, i % width, i / width, in_t0[q],
                                 tgt, band, r, jac);
    if (m) {
      int k = 0;
#pragma unroll
      for (int a = 0; a < 6; ++a)
#pragma unroll
        for (int b = a; b < 6; ++b) acc[k++] += (double)jac[a] * (double)jac[b];
#pragma unroll
      for (int a = 0; a < 6; ++a) acc[kJtr + a] += (double)jac[a] * (double)r;
      acc[kJtr + 6] += (double)r * (double)r;
      acc[kJtr + 7] += 1.0;
    } else {
      r = 0.0f;
#pragma unroll
      for (int a = 0; a < 6; ++a) jac[a] = 0.0f;
    }
    if (rows != nullptr) {
      float* out = rows + (int64_t)i * 8;
      out[0] = r;
#pragma unroll
      for (int a = 0; a < 6; ++a) out[1 + a] = jac[a];
      out[7] = m ? 1.0f : 0.0f;
    }
  }

  // the block's sums, in a fixed order: each warp by shuffles, then the
  // warps in turn
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int k = 0; k < kTerms; ++k) {
    double v = acc[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) s.red[warp][k] = v;
  }
  __syncthreads();
  if (tid < kTerms) {
    double v = s.red[0][tid];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v += s.red[w][tid];
    partials[(int64_t)blockIdx.x * kTerms + tid] = v;
  }
}

// One block of kTerms warps: warp k sums term k of every block's row in a
// fixed order and writes it to its place (or places) in sums.
__global__ void __launch_bounds__(32 * kTerms)
finish_kernel(const double* __restrict__ partials, int blocks, double* __restrict__ sums) {
  const int k = threadIdx.x >> 5, lane = threadIdx.x & 31;
  double v = 0.0;
  for (int b = lane; b < blocks; b += 32) v += partials[(int64_t)b * kTerms + k];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if (lane != 0) return;
  if (k < kJtr) {
    // the k-th entry (a, b), a <= b, of the upper triangle
    int a = 0, start = 0;
    while (k >= start + 6 - a) {
      start += 6 - a;
      ++a;
    }
    const int b = a + k - start;
    sums[6 * a + b] = v;
    sums[6 * b + a] = v;
  } else {
    sums[36 + k - kJtr] = v;
  }
}

template <typename T>
int lm_linearise(const void* tsdf, const void* t0, const void* hit, const void* target,
                 const void* xi, const void* pose0, const void* pose, const void* pose_inv,
                 const void* k_inv, const void* space_min, const void* voxel_size, void* out,
                 void* rows, int sx, int sy, int sz, int width, int height, float band,
                 void* stream) {
  if (sx <= 0 || sy <= 0 || sz <= 0 || (int64_t)sx * sy * sz >= (1LL << 31) ||
      width <= 0 || height <= 0 || (int64_t)width * height >= (1LL << 31) - kRaysPerBlock)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int n = width * height;
  const int blocks = (n + kRaysPerBlock - 1) / kRaysPerBlock;
  double* sums = (double*)out;
  double* partials = sums + kSums;
  linearise_kernel<T><<<blocks, kThreads, 0, st>>>(
      (const T*)tsdf, (const float*)t0, (const unsigned char*)hit, (const float*)target,
      (const float*)xi, (const float*)pose0, (const float*)pose, (const float*)pose_inv,
      (const float*)k_inv, (const float*)space_min, (const float*)voxel_size, partials,
      (float*)rows, sx, sy, sz, width, n, band);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  finish_kernel<<<1, 32 * kTerms, 0, st>>>(partials, blocks, sums);
  return (int)cudaGetLastError();
}

}  // namespace

// out holds kSums doubles and then ceil(width * height / kRaysPerBlock)
// rows of kTerms partials (kernels/lm.py:lm_linearise sizes it); rows, if not null,
// (width * height, 8) floats: r, J's six entries, the mask. tsdf is float32
// here, bfloat16 in tsdf_lm_linearise_bf16; the other tensors float32 but
// hit (bool, one byte a ray). Two launches on the stream.
extern "C" int tsdf_lm_linearise(const void* tsdf, const void* t0, const void* hit,
                                 const void* target, const void* xi, const void* pose0,
                                 const void* pose, const void* pose_inv, const void* k_inv,
                                 const void* space_min, const void* voxel_size, void* out,
                                 void* rows, int sx, int sy, int sz, int width, int height,
                                 float band, void* stream) {
  return lm_linearise<float>(tsdf, t0, hit, target, xi, pose0, pose, pose_inv, k_inv,
                             space_min, voxel_size, out, rows, sx, sy, sz, width, height,
                             band, stream);
}

extern "C" int tsdf_lm_linearise_bf16(const void* tsdf, const void* t0, const void* hit,
                                      const void* target, const void* xi, const void* pose0,
                                      const void* pose, const void* pose_inv,
                                      const void* k_inv, const void* space_min,
                                      const void* voxel_size, void* out, void* rows, int sx,
                                      int sy, int sz, int width, int height, float band,
                                      void* stream) {
  return lm_linearise<tsdf_storage::bf16>(tsdf, t0, hit, target, xi, pose0, pose, pose_inv,
                                          k_inv, space_min, voxel_size, out, rows, sx, sy,
                                          sz, width, height, band, stream);
}
