// Rigid TSDF integration under the decimated line convention (sm_90a).
//
// Replaces tsdf_tpu/kernels/integrate.py:integrate_pallas(mode="fast")
// (its _kernel_fast). This file instantiates the brick walk of
// integrate_bricks.cuh without colour, tsdf_bricks::launch<true, false>: the
// same four launches as the colour-fast entry point of integrate_color.cu
// (the depth maximum; the column lines, which also raise the steep-column
// flag; the brick cull with the fast margin, which keeps every brick when a
// column is steeper than |beta| = 1; the z-strips of the live bricks with
// the miss count).
//
// What bounds it on this card: bytes, 16 B of tsdf and weight read and
// written per updated voxel (0.1309 ms for the ~27 M voxels a real 512^3
// frame updates, NVIDIA H100 80GB HBM3 at 700 W, PERF.md); a frame with no
// depth culls every brick and costs the pre-passes alone.

#include "integrate_bricks.cuh"

namespace {

template <typename T>
int integrate_fast(void* tsdf, void* weight, const void* depth, void* lines,
                   void* miss, const void* params, int sx, int sy, int sz,
                   int width, int height, int cap_weight, void* stream,
                   int z0) {
  const tsdf_bricks::Frame f{nullptr, (const float*)depth, nullptr,
                             (const float2*)lines};
  return tsdf_bricks::launch<T, true, false>(
      (T*)tsdf, (T*)weight, f, lines, (int*)miss, const_cast<void*>(params),
      sx, sy, sz, width, height, cap_weight, (cudaStream_t)stream, z0);
}

}  // namespace

// params holds 24 floats and then the zeroed scratch of the brick walk
// (kernels/integrate.py:integrate_fast_cuda); lines: scratch of sx*sz
// float2; miss: one int32, zeroed by the caller. tsdf and weight are
// float32 here, bfloat16 in tsdf_integrate_fast_bf16. z0: the volume's
// first plane in the whole volume, as in tsdf_integrate.
extern "C" int tsdf_integrate_fast(void* tsdf, void* weight,
                                   const void* depth, void* lines, void* miss,
                                   const void* params, int sx, int sy, int sz,
                                   int width, int height, int cap_weight,
                                   void* stream, int z0) {
  return integrate_fast<float>(tsdf, weight, depth, lines, miss, params, sx,
                               sy, sz, width, height, cap_weight, stream, z0);
}

extern "C" int tsdf_integrate_fast_bf16(void* tsdf, void* weight,
                                        const void* depth, void* lines,
                                        void* miss, const void* params, int sx,
                                        int sy, int sz, int width, int height,
                                        int cap_weight, void* stream, int z0) {
  return integrate_fast<tsdf_storage::bf16>(tsdf, weight, depth, lines, miss,
                                            params, sx, sy, sz, width, height,
                                            cap_weight, stream, z0);
}
