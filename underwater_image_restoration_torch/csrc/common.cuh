// Shared device helpers of the port's kernels: dtype conversion and the
// channel LayerNorm of a zero-padded pixel patch into shared memory.
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

// LayerNorm over C channels of every pixel of the patch whose top-left
// image position is (row0, col0), PH x PW pixels, written channel-major to
// ln[c * PH * PW + q] in T.  Statistics and affine in f32 (torch eps 1e-5
// semantics); pixels outside the image are written as zero, which is the
// zero padding of the depthwise conv that reads them (the 1x1 before it has
// no bias, so a zero LN output gives a zero conv input).
template <typename T>
__device__ void ln_patch(const T* __restrict__ xb, T* __restrict__ ln,
                         const float* __restrict__ scale,
                         const float* __restrict__ bias, int C, int H, int W,
                         int row0, int col0, int PH, int PW, float eps) {
  const int np = PH * PW;
  const size_t plane = (size_t)H * W;
  for (int q = threadIdx.x; q < np; q += blockDim.x) {
    const int r = row0 + q / PW, c = col0 + q % PW;
    if (r < 0 || r >= H || c < 0 || c >= W) {
      for (int ch = 0; ch < C; ++ch) ln[ch * np + q] = from_f<T>(0.f);
      continue;
    }
    const T* xp = xb + (size_t)r * W + c;
    float s = 0.f;
    for (int ch = 0; ch < C; ++ch) s += to_f(xp[ch * plane]);
    const float mean = s / C;
    float v = 0.f;
    for (int ch = 0; ch < C; ++ch) {
      const float d = to_f(xp[ch * plane]) - mean;
      v += d * d;
    }
    const float rstd = rsqrtf(v / C + eps);
    for (int ch = 0; ch < C; ++ch)
      ln[ch * np + q] = from_f<T>((to_f(xp[ch * plane]) - mean) * rstd *
                                      __ldg(scale + ch) +
                                  __ldg(bias + ch));
  }
}

// s[i] = sum_c in[c * np + q] * w[c * ld + i], i < 8: eight output channels
// of a 1x1 conv at pixel q of a channel-major shared buffer; w is read as
// two float4 broadcasts (ld and w 16-byte aligned).
template <typename T>
__device__ __forceinline__ void project8(float (&s)[8], const T* in, int np,
                                         int q, const float* __restrict__ w,
                                         int ld, int C) {
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = 0.f;
  for (int c = 0; c < C; ++c) {
    const float l = to_f(in[c * np + q]);
    const float4 w0 = __ldg(reinterpret_cast<const float4*>(w));
    const float4 w1 = __ldg(reinterpret_cast<const float4*>(w + 4));
    w += ld;
    s[0] = fmaf(l, w0.x, s[0]);
    s[1] = fmaf(l, w0.y, s[1]);
    s[2] = fmaf(l, w0.z, s[2]);
    s[3] = fmaf(l, w0.w, s[3]);
    s[4] = fmaf(l, w1.x, s[4]);
    s[5] = fmaf(l, w1.y, s[5]);
    s[6] = fmaf(l, w1.z, s[6]);
    s[7] = fmaf(l, w1.w, s[7]);
  }
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
