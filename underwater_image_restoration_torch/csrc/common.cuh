// Shared device helpers of the port's kernels: dtype conversion, the
// rounding points, and a 3x3 depthwise tap sum.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace uir {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, like astype(bf16)
}

// Rounds v to T and back: the materialization points of the TPU kernels.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// sum_k tap[k] * buf[(k / 3) * pw + k % 3]: a 3x3 depthwise tap sum whose
// top-left input is buf[0] in a buffer pw wide.
__device__ __forceinline__ float tap9(const float* buf, int pw,
                                      const float* __restrict__ tap) {
  float t = 0.f;
#pragma unroll
  for (int k = 0; k < 9; ++k)
    t = fmaf(__ldg(tap + k), buf[(k / 3) * pw + k % 3], t);
  return t;
}

}  // namespace uir

// Each library is built from one .cu file that includes this header once.
extern "C" const char* uir_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
