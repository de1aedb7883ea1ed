// Rigid TSDF + colour integration (sm_90a).
//
// Replaces tsdf_tpu/kernels/integrate.py:integrate_color_pallas (its
// _kernel_color): modes "exact" and "line" are tsdf_integrate_color (every
// voxel reads its own pixel), mode "fast" is tsdf_integrate_color_fast
// (the decimated line convention). The kernel, what bounds it and its
// design (bricks culled in a pre-pass, a list of the live ones, a z-strip a
// thread, the colour blend in the strip) are in integrate_bricks.cuh; this
// file instantiates its two colour forms.

#include "integrate_bricks.cuh"

namespace {

template <typename T, bool FAST>
int integrate_color(void* tsdf, void* weight, void* color, const void* depth,
                    const void* rgb, void* lines, void* miss,
                    const void* params, int sx, int sy, int sz, int width,
                    int height, int cap_weight, void* stream, int z0) {
  const tsdf_bricks::Frame f{(uint8_t*)color, (const float*)depth,
                             (const uint8_t*)rgb, (const float2*)lines};
  return tsdf_bricks::launch<T, FAST, true>(
      (T*)tsdf, (T*)weight, f, lines, (int*)miss, const_cast<void*>(params),
      sx, sy, sz, width, height, cap_weight, (cudaStream_t)stream, z0);
}

}  // namespace

// color: (Z, Y, X, 3) u8, updated in place; rgb: (H, W, 3) u8. params
// holds 24 floats and then the zeroed scratch of the brick walk
// (kernels/integrate.py:integrate_color_cuda). Three launches: the depth
// maximum, the brick cull, the live bricks. tsdf and weight are float32
// here, bfloat16 in the _bf16 entry points. z0: the volume's first plane
// in the whole volume, as in tsdf_integrate.
extern "C" int tsdf_integrate_color(void* tsdf, void* weight, void* color,
                                    const void* depth, const void* rgb,
                                    const void* params, int sx, int sy,
                                    int sz, int width, int height,
                                    int cap_weight, void* stream, int z0) {
  return integrate_color<float, false>(tsdf, weight, color, depth, rgb,
                                       nullptr, nullptr, params, sx, sy, sz,
                                       width, height, cap_weight, stream, z0);
}

extern "C" int tsdf_integrate_color_bf16(void* tsdf, void* weight, void* color,
                                         const void* depth, const void* rgb,
                                         const void* params, int sx, int sy,
                                         int sz, int width, int height,
                                         int cap_weight, void* stream, int z0) {
  return integrate_color<tsdf_storage::bf16, false>(
      tsdf, weight, color, depth, rgb, nullptr, nullptr, params, sx, sy, sz,
      width, height, cap_weight, stream, z0);
}

// lines: scratch of sx*sz float2; miss: one int32, zeroed by the caller.
// Four launches: the depth maximum, the column lines, the brick cull, the
// live bricks.
extern "C" int tsdf_integrate_color_fast(void* tsdf, void* weight,
                                         void* color, const void* depth,
                                         const void* rgb, void* lines,
                                         void* miss, const void* params,
                                         int sx, int sy, int sz, int width,
                                         int height, int cap_weight,
                                         void* stream, int z0) {
  return integrate_color<float, true>(tsdf, weight, color, depth, rgb, lines,
                                      miss, params, sx, sy, sz, width, height,
                                      cap_weight, stream, z0);
}

extern "C" int tsdf_integrate_color_fast_bf16(
    void* tsdf, void* weight, void* color, const void* depth, const void* rgb,
    void* lines, void* miss, const void* params, int sx, int sy, int sz,
    int width, int height, int cap_weight, void* stream, int z0) {
  return integrate_color<tsdf_storage::bf16, true>(
      tsdf, weight, color, depth, rgb, lines, miss, params, sx, sy, sz, width,
      height, cap_weight, stream, z0);
}
