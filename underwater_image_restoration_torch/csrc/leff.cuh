// Stages shared by the LN + LeFF forward (csrc/ln_leff.cu) and backward
// (csrc/ln_leff_bwd.cu) on channels-last tokens: gelu and its derivative,
// the per-pixel LayerNorm prep, fc1's epilogue and g2's 3x3 window.  Each
// library wraps them in kernels and epilogue types of its own names, so a
// profile tells the forward's launches from the backward's.
//
// Rounding points (the TPU kernels'): LN statistics and affine in f32,
// rounded to T; fc1 summed in f32, rounded, then its bias (rounded to T, as
// the TPU kernel casts it) added in T; gelu in f32 of that, rounded; the
// taps (f32) summed in f32, rounded, their bias (rounded to T) added in T;
// gelu, rounded.  The biases come as f32 and are rounded here, so the
// wrappers launch no cast for them.
#pragma once

#include "gemm.cuh"

namespace uir {
namespace leff {

namespace mm = uir::mma;
using bf16 = __nv_bfloat16;
using gemm::warp_sum;

__device__ __forceinline__ float gelu_f(float t) {
  return 0.5f * t * (1.f + erff(t * 0.70710678118654752f));
}

// d gelu / dt, exact (erf) form: Phi(t) + t * phi(t)
__device__ __forceinline__ float gelu_grad(float t) {
  return 0.5f * (1.f + erff(t * 0.70710678118654752f)) +
         t * 0.39894228040143268f * expf(-0.5f * t * t);
}

// gelu(t) and gelu'(t) from one erf, bit-equal to gelu_f and gelu_grad
__device__ __forceinline__ void gelu_both(float t, float& g, float& gp) {
  const float e = erff(t * 0.70710678118654752f);
  g = 0.5f * t * (1.f + e);
  gp = 0.5f * (1.f + e) + t * 0.39894228040143268f * expf(-0.5f * t * t);
}

// Mean and rstd of the C channels at xp, a warp a pixel (lanes over
// channels).
template <typename T>
__device__ __forceinline__ void ln_stats(const T* xp, int C, int lane,
                                         float eps, float& mean,
                                         float& rstd) {
  float sum = 0.f;
  for (int ch = lane; ch < C; ch += 32) sum += to_f(xp[ch]);
  mean = warp_sum(sum) / C;
  float var = 0.f;
  for (int ch = lane; ch < C; ch += 32) {
    const float d = to_f(xp[ch]) - mean;
    var += d * d;
  }
  rstd = rsqrtf(warp_sum(var) / C + eps);
}

// The prep stage, a warp a pixel of the slice (M pixels, HW an image):
// LN = round(LN x) into NP bf16 planes [pixel][C]; with stats, (mean, rstd)
// a pixel; with dy, dyk = round(s_b dy) into planes like LN's.
template <typename T, int NP>
__device__ void prep(const T* __restrict__ x, const T* __restrict__ dy,
                     const float* __restrict__ scale,
                     const float* __restrict__ bias,
                     const float* __restrict__ s, float2* __restrict__ stats,
                     bf16* __restrict__ ln, bf16* __restrict__ dyk, int M,
                     int HW, int C, float eps) {
  const int lane = threadIdx.x & 31;
  const size_t lo = (size_t)M * C;
  for (int m = blockIdx.x * (blockDim.x / 32) + (threadIdx.x >> 5); m < M;
       m += gridDim.x * (blockDim.x / 32)) {
    const size_t base = (size_t)m * C;
    float mean, rstd;
    ln_stats(x + base, C, lane, eps, mean, rstd);
    if (stats != nullptr && lane == 0) stats[m] = make_float2(mean, rstd);
    for (int ch = lane; ch < C; ch += 32)
      mm::put<NP>(ln, lo, base + ch,
                  round_to<T>((to_f(x[base + ch]) - mean) * rstd *
                                  __ldg(scale + ch) +
                              __ldg(bias + ch)));
    if (dy == nullptr) continue;
    const float sb = __ldg(s + m / HW);
    for (int ch = lane; ch < C; ch += 32)
      mm::put<NP>(dyk, lo, base + ch, round_to<T>(to_f(dy[base + ch]) * sb));
  }
}

// fc1's epilogue: g1 = round(gelu(t1)) and, when t1 is given, t1 =
// round(round(LN W1) + b1), both [pixel][hid] in T.
template <typename T>
struct Fc1 {
  T* t1;
  T* g1;
  const float* b1;
  int M, N;
  __device__ void operator()(const float* o, int ld, int bm, int bn, int m0,
                             int n0, int, int, int) const {
    gemm::for_pairs(o, ld, bm, bn, m0, n0, M, N,
                    [&](int m, int n, float v0, float v1) {
                      const float a = round_to<T>(
                          round_to<T>(v0) + round_to<T>(__ldg(b1 + n)));
                      const float b = round_to<T>(
                          round_to<T>(v1) + round_to<T>(__ldg(b1 + n + 1)));
                      const size_t i = (size_t)m * N + n;
                      if (t1 != nullptr) gemm::store2(t1, i, a, b);
                      gemm::store2(g1, i, gelu_f(a), gelu_f(b));
                    });
  }
};

// g2's 3x3 window: a thread walks consecutive pixels of a slice in one
// channel pair (n, n + 1), keeping the taps, their biases and a 3x3 window
// of g1 (zero outside the image) in registers, three new g1 loads a pixel:
// t2() is round(round(taps * g1) + round(b_dw)) at the current pixel, next()
// moves to the following one.
template <typename T>
struct Window {
  const T* g1;  // [pixel][N]
  int N, H, W;
  float2 tk[9];
  float ba, bb;
  float2 win[3][3];  // rows h - 1 + i, columns w - 1 + j
  int h, w, n;
  size_t base;  // pixel (0, 0) of the current image

  __device__ float2 at(int hh, int wc) const {
    return hh >= 0 && hh < H && wc >= 0 && wc < W
               ? gemm::load2(g1, (base + (size_t)hh * W + wc) * N + n)
               : make_float2(0.f, 0.f);
  }
  // Starts at pixel m of the slice, channel pair n.
  __device__ void start(const float* taps, const float* bdw, int m, int n_) {
    n = n_;
#pragma unroll
    for (int k = 0; k < 9; ++k)
      tk[k] = __ldg(reinterpret_cast<const float2*>(taps + k * N + n));
    ba = round_to<T>(__ldg(bdw + n));
    bb = round_to<T>(__ldg(bdw + n + 1));
    const int hw = m % (H * W);
    h = hw / W, w = hw % W;
    base = (size_t)m - hw;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) win[i][j] = at(h - 1 + i, w - 1 + j);
  }
  // t2 of the current pixel (zeros outside the image add nothing)
  __device__ float2 t2() const {
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      sa = fmaf(tk[k].x, win[k / 3][k % 3].x, sa);
      sb = fmaf(tk[k].y, win[k / 3][k % 3].y, sb);
    }
    return make_float2(round_to<T>(round_to<T>(sa) + ba),
                       round_to<T>(round_to<T>(sb) + bb));
  }
  // Moves to the next pixel of the slice (more: a pixel follows).
  __device__ void next(bool more) {
    if (++w < W) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        win[i][0] = win[i][1];
        win[i][1] = win[i][2];
        win[i][2] = at(h - 1 + i, w + 1);
      }
    } else if (more) {
      w = 0;
      if (++h == H) h = 0, base += (size_t)H * W;
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) win[i][j] = at(h - 1 + i, j - 1);
    }
  }
};

}  // namespace leff
}  // namespace uir
