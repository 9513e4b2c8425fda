// Shared helpers for the port's kernels: element conversion and the
// wrap-around index used by every ERP sampler.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace matry {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// floor-mod: the result lies in [0, n) for any i.
__device__ __forceinline__ int wrap(int i, int n) {
  int r = i % n;
  return r < 0 ? r + n : r;
}

}  // namespace matry
