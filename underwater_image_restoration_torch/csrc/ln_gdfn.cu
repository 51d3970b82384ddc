// LN + GDFN forward: y = x + W_out^T (gelu(t1) * t2),
// [t1; t2] = dwconv3x3(W_in^T LayerNorm_C(x)), on channels-first (B, C, H, W).
//
// Replaces the TPU kernel of the JAX package
// ops/fused_gdfn_banded.py:479 _fwd_call (_fwd_kernel:187), and computes the
// same function as fused_block.py:628 _fwd_call.
//
// Design.  One block owns a TH x TW patch of one image:
//   1. LayerNorm of the (TH+2) x (TW+2) halo patch into shared memory, in
//      the compute type (the TPU kernel rounds the LN output there too),
//      zero outside the image, which is the dwconv's zero padding (the 1x1
//      before it has no bias);
//   2. the hidden channels go in chunks of G gate pairs (t1 channel g with
//      t2 channel hid + g): project_in of the chunk over the halo patch into
//      shared memory (f32, not rounded: the TPU kernel's composed
//      contraction does not round between the 1x1 and the taps either), the
//      3x3 taps and the gate per output pixel (rounded to the compute type,
//      as the TPU kernel does), and project_out accumulated in f32 shared
//      memory;
//   3. y = x + round(acc).  Only x is read and only y written.
// The TPU kernel folds project_in and the taps into one 9C-deep matrix to
// fill its 128-wide systolic array; on the FMA pipe that costs 9C / (C + 9)
// times the multiply-adds, so here the two stay apart.  Hidden widths
// (42, 85, 170, 340) are zero-padded by the wrapper to a multiple of G: a
// zero column of W_in gives t = 0, gelu(0) * 0 = 0, and the zero row of
// W_out adds nothing.  Work items (pixel, channel group) are strided over
// 256 threads a block.  Plain FMA, no tensor cores yet.
//
// What bounds it on an H100.  Per pixel it needs 2 * 2hid * (C + 9) +
// 2 * hid * C flops against 2 * C * itemsize bytes of x and y (30-700
// flop/byte over the levels, above the card's bf16 ridge only at the deep
// levels): at peak rates the 256x256 levels are bound by bytes, the deep
// ones by operations.  This version runs the operations on the f32 FMA pipe
// (67 TFLOP/s), not the bf16 tensor cores (989 TFLOP/s).
#include <cstdint>

#include "common.cuh"

namespace {

using uir::from_f;
using uir::to_f;

constexpr int kThreads = 256;
// gate pairs a chunk; the wrapper lays the weights out for its own chunk
// size (ops/fused_gdfn.py GATE_CHUNK) and passes it, and a launch with
// another one is refused
constexpr int G = 16;

// win: [C][2 * hid_pad], chunk m at columns [2Gm, 2Gm + G) (t1 channels
// Gm..) and [2Gm + G, 2G(m+1)) (t2 channels hid + Gm..); taps: [2 * hid_pad]
// [9] in the same channel order; wout: [hid_pad][C].
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ln_gdfn_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
                       const float* __restrict__ scale,
                       const float* __restrict__ bias,
                       const float* __restrict__ win,
                       const float* __restrict__ taps,
                       const float* __restrict__ wout, int C, int H, int W,
                       int hid_pad, int TH, int TW, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int PW = TW + 2, NP = PW * (TH + 2), P = TH * TW;
  float* acc = reinterpret_cast<float*>(smem);  // [C][P]
  float* pb = acc + (size_t)C * P;              // [2G][NP]: project_in
  T* ln = reinterpret_cast<T*>(pb + 2 * G * NP);  // [C][NP]
  T* ob = ln + (size_t)C * NP;                    // [G][P]: gated product

  const int b = blockIdx.z;
  const int r0 = blockIdx.y * TH, c0 = blockIdx.x * TW;
  const int tid = threadIdx.x;
  const size_t plane = (size_t)H * W;
  const int wcols = 2 * hid_pad;

  for (int i = tid; i < C * P; i += blockDim.x) acc[i] = 0.f;
  uir::ln_patch<T>(x + (size_t)b * C * plane, ln, scale, bias, C, H, W,
                   r0 - 1, c0 - 1, TH + 2, PW, eps);
  __syncthreads();

  for (int m = 0; m < hid_pad / G; ++m) {
    // project_in of the chunk over the halo patch: items (pixel, 8 channels)
    for (int it = tid; it < NP * (2 * G / 8); it += blockDim.x) {
      const int q = it % NP, c8 = 8 * (it / NP);
      float s[8];
      uir::project8<T>(s, ln, NP, q, win + 2 * G * m + c8, wcols, C);
#pragma unroll
      for (int i = 0; i < 8; ++i) pb[(c8 + i) * NP + q] = s[i];
    }
    __syncthreads();

    // taps and gate: items (pixel, gate pair)
    for (int it = tid; it < P * G; it += blockDim.x) {
      const int p = it % P, g = it / P;
      const int base = (p / TW) * PW + p % TW;
      const float* ta = taps + (size_t)(2 * G * m + g) * 9;
      const float t1 = uir::tap9(pb + g * NP + base, PW, ta);
      const float t2 = uir::tap9(pb + (G + g) * NP + base, PW, ta + 9 * G);
      const float ge = 0.5f * t1 * (1.f + erff(t1 * 0.70710678118654752f));
      ob[g * P + p] = from_f<T>(ge * t2);
    }
    __syncthreads();

    // project_out, accumulated: items (pixel, 4 output channels)
    for (int it = tid; it < P * (C / 4); it += blockDim.x) {
      const int p = it % P, o = 4 * (it / P);
      const float* wr = wout + (size_t)G * m * C + o;
      float u0 = 0.f, u1 = 0.f, u2 = 0.f, u3 = 0.f;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float ov = to_f(ob[g * P + p]);
        const float4 w4 = __ldg(reinterpret_cast<const float4*>(wr));
        wr += C;
        u0 = fmaf(ov, w4.x, u0);
        u1 = fmaf(ov, w4.y, u1);
        u2 = fmaf(ov, w4.z, u2);
        u3 = fmaf(ov, w4.w, u3);
      }
      acc[o * P + p] += u0;
      acc[(o + 1) * P + p] += u1;
      acc[(o + 2) * P + p] += u2;
      acc[(o + 3) * P + p] += u3;
    }
    // the next chunk's first phase writes only pb; its barrier orders this
    // phase's reads of ob before the next overwrite
  }
  __syncthreads();

  for (int it = tid; it < P * C; it += blockDim.x) {
    const int p = it % P, o = it / P;
    const int r = r0 + p / TW, cc = c0 + p % TW;
    if (r >= H || cc >= W) continue;
    const size_t idx = ((size_t)b * C + o) * plane + (size_t)r * W + cc;
    y[idx] = from_f<T>(to_f(x[idx]) + uir::round_to<T>(acc[o * P + p]));
  }
}

template <typename T>
int launch(const void* x, void* y, const float* scale, const float* bias,
           const float* win, const float* taps, const float* wout, int B,
           int C, int H, int W, int hid_pad, int TH, int TW, float eps,
           cudaStream_t stream) {
  const size_t np = (size_t)(TH + 2) * (TW + 2), p = (size_t)TH * TW;
  const size_t smem = (C * p + 2 * G * np) * sizeof(float) +
                      (C * np + G * p) * sizeof(T);
  auto kern = ln_gdfn_fwd_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (hid_pad % G || C % 4) return (int)cudaErrorInvalidValue;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), scale, bias, win, taps,
      wout, C, H, W, hid_pad, TH, TW, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int uir_ln_gdfn_fwd(const void* x, void* y, const void* scale,
                               const void* bias, const void* win,
                               const void* taps, const void* wout, int B,
                               int C, int H, int W, int hid_pad,
                               int gate_chunk, int bf16, int TH, int TW,
                               float eps, void* stream) {
  if (gate_chunk != G) return (int)cudaErrorInvalidValue;
  const auto* s = static_cast<const float*>(scale);
  const auto* bi = static_cast<const float*>(bias);
  const auto* wi = static_cast<const float*>(win);
  const auto* tp = static_cast<const float*>(taps);
  const auto* wo = static_cast<const float*>(wout);
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(x, y, s, bi, wi, tp, wo, B, C, H, W,
                                 hid_pad, TH, TW, eps, st);
  return launch<float>(x, y, s, bi, wi, tp, wo, B, C, H, W, hid_pad, TH, TW,
                       eps, st);
}
