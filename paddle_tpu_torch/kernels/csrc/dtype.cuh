// Element types of the port's CUDA kernels (f32 and bf16): 16-byte loads
// into f32, and the rounding points the TPU kernels have. Shared by the
// paged-attention family (ragged_tc.cuh) and the flash-attention family
// (flash_common.cuh).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ptt {

template <typename T>
struct Traits;

template <>
struct Traits<float> {
  static constexpr int kVec = 4;  // elements per 16-byte load
  __device__ static __forceinline__ void load(const float* src, float* dst) {
    const float4 v = *reinterpret_cast<const float4*>(src);
    dst[0] = v.x;
    dst[1] = v.y;
    dst[2] = v.z;
    dst[3] = v.w;
  }
  __device__ static __forceinline__ float get(float x) { return x; }
  __device__ static __forceinline__ float round(float x) { return x; }
  __device__ static __forceinline__ float store(float x) { return x; }
};

template <>
struct Traits<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static __forceinline__ void load(const __nv_bfloat16* src,
                                              float* dst) {
    const uint4 v = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(p[i]);
      dst[2 * i] = f.x;
      dst[2 * i + 1] = f.y;
    }
  }
  __device__ static __forceinline__ float get(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  // round-to-nearest-even, as XLA's astype(bfloat16) and torch's .to()
  __device__ static __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  __device__ static __forceinline__ __nv_bfloat16 store(float x) {
    return __float2bfloat16_rn(x);
  }
};

}  // namespace ptt
