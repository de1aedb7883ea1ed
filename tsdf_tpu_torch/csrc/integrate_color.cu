// Rigid TSDF + colour integration (sm_90a).
//
// Replaces tsdf_tpu/kernels/integrate.py:integrate_color_pallas (its
// _kernel_color): modes "exact" and "line" are tsdf_integrate_color (every
// voxel reads its own pixel), mode "fast" is tsdf_integrate_color_fast
// (the decimated line convention). The kernel, its design and what bounds
// it are in integrate_variants.cuh; this file instantiates the two colour
// variants.

#include "integrate_variants.cuh"

// color: (Z, Y, X, 3) u8, updated in place; rgb: (H, W, 3) u8.
extern "C" int tsdf_integrate_color(void* tsdf, void* weight, void* color,
                                    const void* depth, const void* rgb,
                                    const void* params, int sx, int sy,
                                    int sz, int width, int height,
                                    int cap_weight, void* stream) {
  return tsdf_variants::launch<false, true>(
      tsdf, weight, color, depth, rgb, nullptr, nullptr, params, sx, sy, sz,
      width, height, cap_weight, stream);
}

// lines: scratch of sx*sz float2; miss: one int32, zeroed by the caller.
extern "C" int tsdf_integrate_color_fast(void* tsdf, void* weight,
                                         void* color, const void* depth,
                                         const void* rgb, void* lines,
                                         void* miss, const void* params,
                                         int sx, int sy, int sz, int width,
                                         int height, int cap_weight,
                                         void* stream) {
  return tsdf_variants::launch<true, true>(
      tsdf, weight, color, depth, rgb, lines, miss, params, sx, sy, sz,
      width, height, cap_weight, stream);
}
