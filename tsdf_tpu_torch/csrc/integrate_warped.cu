// TSDF integration at the deformed centres of a non-rigid volume (sm_90a).
//
// Replaces tsdf_tpu/kernels/integrate.py:integrate_warped_pallas (its
// _kernel_warped). The TPU kernel could not gather a pixel per voxel, so
// it matched each voxel's warped projection against a window of candidate
// image columns around its column's fitted line (two bands, nk candidates),
// skipped what fell outside, counted the skipped voxels and returned a mask
// of them for a top-up pass. Here one thread per voxel reads its 12-byte
// deformed centre from the (Z, Y, X, 3) field, projects it with the
// expressions of ops/integrate.py:integrate in their order, and reads its
// one depth pixel: nothing is skipped, so there is no miss count and no
// mask. A centre that is NaN or infinite, or that lands on Z == 0, gives a
// pixel that is NaN or infinite and fails the in-image comparisons, as in
// the plain twin.
//
// What bounds it on this card: bytes set the floor (12 B of centre per
// voxel, 8 B of tsdf and weight read and 8 B written per updated voxel; the
// 1.2 MB depth image stays in L2), and as for the rigid variants the
// projection every thread does costs more than the bytes. The kernel and
// its design are in integrate_variants.cuh: x-fastest threads on a
// 3-D launch grid, so a warp's centres are one 384-byte run and its
// tsdf/weight accesses 128-byte runs; voxels that fail a gate touch no
// volume memory; the volume is updated in place.
//
// The colour entry point is the same kernel with the u8 colour blend of
// integrate_color.cu. The JAX package has that combination only as plain
// XLA (ops/integrate.py with rgb= on a deformed volume).

#include "integrate_variants.cuh"

// deform: (sz, sy, sx, 3) f32, contiguous. tsdf and weight are float32
// here, bfloat16 in the _bf16 entry points.
extern "C" int tsdf_integrate_warped(void* tsdf, void* weight,
                                     const void* deform, const void* depth,
                                     const void* params, int sx, int sy,
                                     int sz, int width, int height,
                                     int cap_weight, void* stream) {
  return tsdf_variants::launch_warped<float, false>(
      tsdf, weight, nullptr, deform, depth, nullptr, params, sx, sy, sz,
      width, height, cap_weight, stream);
}

extern "C" int tsdf_integrate_warped_bf16(void* tsdf, void* weight,
                                          const void* deform,
                                          const void* depth,
                                          const void* params, int sx, int sy,
                                          int sz, int width, int height,
                                          int cap_weight, void* stream) {
  return tsdf_variants::launch_warped<tsdf_storage::bf16, false>(
      tsdf, weight, nullptr, deform, depth, nullptr, params, sx, sy, sz,
      width, height, cap_weight, stream);
}

// color: (sz, sy, sx, 3) u8, updated in place; rgb: (H, W, 3) u8.
extern "C" int tsdf_integrate_warped_color(void* tsdf, void* weight,
                                           void* color, const void* deform,
                                           const void* depth, const void* rgb,
                                           const void* params, int sx, int sy,
                                           int sz, int width, int height,
                                           int cap_weight, void* stream) {
  return tsdf_variants::launch_warped<float, true>(
      tsdf, weight, color, deform, depth, rgb, params, sx, sy, sz, width,
      height, cap_weight, stream);
}

extern "C" int tsdf_integrate_warped_color_bf16(
    void* tsdf, void* weight, void* color, const void* deform,
    const void* depth, const void* rgb, const void* params, int sx, int sy,
    int sz, int width, int height, int cap_weight, void* stream) {
  return tsdf_variants::launch_warped<tsdf_storage::bf16, true>(
      tsdf, weight, color, deform, depth, rgb, params, sx, sy, sz, width,
      height, cap_weight, stream);
}
