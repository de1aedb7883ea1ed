// Rigid TSDF integration under the decimated line convention (sm_90a).
//
// Replaces tsdf_tpu/kernels/integrate.py:integrate_pallas(mode="fast")
// (its _kernel_fast). The kernel, its design and what bounds it are in
// integrate_variants.cuh; this file instantiates the depth-only variant.

#include "integrate_variants.cuh"

// lines: scratch of sx*sz float2; miss: one int32, zeroed by the caller.
extern "C" int tsdf_integrate_fast(void* tsdf, void* weight,
                                   const void* depth, void* lines, void* miss,
                                   const void* params, int sx, int sy, int sz,
                                   int width, int height, int cap_weight,
                                   void* stream) {
  return tsdf_variants::launch<true, false>(
      tsdf, weight, nullptr, depth, nullptr, lines, miss, params, sx, sy, sz,
      width, height, cap_weight, stream);
}
