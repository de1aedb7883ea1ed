// Rigid projective TSDF integration for Hopper (sm_90a).
//
// Replaces tsdf_tpu/kernels/integrate.py:integrate_pallas (its _kernel,
// modes "exact" and "line"). The TPU kernel had no per-lane gather, so it
// warped each voxel column onto an image line and matched candidate
// columns, skipping (and counting) voxels it could not resolve. Here each
// voxel projects its centre and reads its pixel directly: the
// ops/integrate.py contract holds for every voxel, nothing is skipped and
// there is no miss count.
//
// The kernel, what bounds it and its design (bricks culled in a pre-pass,
// a list of the live ones, a z-strip a thread) are in integrate_bricks.cuh;
// this file instantiates its depth-only form at each voxel's own pixel.

#include "integrate_bricks.cuh"

namespace {

template <typename T>
int integrate(void* tsdf, void* weight, const void* depth, const void* params,
              int sx, int sy, int sz, int width, int height, int cap_weight,
              void* stream) {
  const tsdf_bricks::Frame f{nullptr, (const float*)depth, nullptr, nullptr};
  return tsdf_bricks::launch<T, false, false>(
      (T*)tsdf, (T*)weight, f, nullptr, nullptr, const_cast<void*>(params),
      sx, sy, sz, width, height, cap_weight, (cudaStream_t)stream);
}

}  // namespace

// params holds 24 floats and then the zeroed scratch of the brick walk
// (kernels/integrate.py:integrate_cuda). Three launches on the stream: the
// depth maximum, the brick cull, the live bricks. tsdf and weight are
// float32 here, bfloat16 in tsdf_integrate_bf16.
extern "C" int tsdf_integrate(void* tsdf, void* weight, const void* depth,
                              const void* params, int sx, int sy, int sz,
                              int width, int height, int cap_weight,
                              void* stream) {
  return integrate<float>(tsdf, weight, depth, params, sx, sy, sz, width,
                          height, cap_weight, stream);
}

extern "C" int tsdf_integrate_bf16(void* tsdf, void* weight, const void* depth,
                                   const void* params, int sx, int sy, int sz,
                                   int width, int height, int cap_weight,
                                   void* stream) {
  return integrate<tsdf_storage::bf16>(tsdf, weight, depth, params, sx, sy,
                                       sz, width, height, cap_weight, stream);
}
