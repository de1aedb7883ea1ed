// The storage types of a volume's tsdf and weight: float32, or bfloat16
// (TSDFVolume.astype), which halves the bytes every kernel that reads the
// volume moves. Every kernel computes in float32: it widens what it loads
// (exact) and rounds what it stores once, to nearest even
// (__float2bfloat16_rn, as torch's and jnp's casts do), so each bf16
// instance equals its plain twin bit for bit as the float32 one does.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tsdf_storage {

using bf16 = __nv_bfloat16;

// the stored word of a value of type T: what a bitwise test compares
template <typename T>
struct Storage;

template <>
struct Storage<float> {
  using Word = unsigned;
  static __device__ __forceinline__ float widen(unsigned w) {
    return __uint_as_float(w);
  }
};

template <>
struct Storage<bf16> {
  using Word = unsigned short;
  // a bf16 is the high half of the float32 with the same bits
  static __device__ __forceinline__ float widen(unsigned w) {
    return __uint_as_float(w << 16);
  }
};

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const bf16* p) {
  return __bfloat162float(*p);
}

// a load through the read-only path
__device__ __forceinline__ float ldg(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg(const bf16* p) {
  return Storage<bf16>::widen(
      __ldg(reinterpret_cast<const unsigned short*>(p)));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

}  // namespace tsdf_storage
