// LN + LeFF forward on channels-last tokens x (B, H, W, C):
//   y = x + s_b * (fc2(gelu(dw3x3(gelu(fc1(LayerNorm_C(x)))))))
// (residual = 0 drops the "x +"), fc1 C -> hid with bias, dw3x3 depthwise
// with bias and zero padding, fc2 hid -> C with bias, s_b a per-image scale.
//
// Replaces the TPU kernel of the JAX package ops/fused_leff.py:301 _fwd_call
// (_fwd_kernel:99), which worked channels-first; the port's AST keeps its
// tokens channels-last, so this kernel reads and writes them as they are and
// its caller pays no relayout.
//
// Rounding points (the TPU kernel's): LN statistics and affine in f32,
// rounded to T; fc1 summed in f32, rounded, then its bias added in T; gelu in
// f32 of that, rounded; the depthwise taps (f32, not rounded) summed in f32,
// rounded, bias added in T; gelu, rounded; fc2 summed in f32 over the whole
// hidden width, rounded, bias added in T; times s_b in f32, rounded; x + that
// in T.  The wrapper passes fc1 and fc2 in T and the three biases rounded to
// T, as the TPU kernel casts them.
//
// Design.  One block owns a TH x TW pixel tile of one image and its 1-pixel
// halo:
//   1. LayerNorm of the (TH+2) x (TW+2) halo patch, a warp a pixel (lanes
//      over channels, shuffle sums), into shared memory channel-major in T;
//   2. the hidden width goes in chunks of G channels.  The depthwise 3x3 acts
//      on each hidden channel alone, so a chunk's share of the output is
//      exact by itself.  Each chunk copies its fc1 columns and fc2 rows into
//      shared memory as f32 (every thread loading its pieces at once), then
//      computes fc1 over the halo patch (recomputed on the halo, as
//      ln_gdfn.cu does; zero outside the image, which is the 3x3's zero
//      padding), the taps and the second gelu on the tile, and adds the
//      chunk's fc2 terms into per-pixel f32 accumulators of width C in
//      shared memory.  A whole tile's hidden activations (hid reaches 2048
//      at C = 512) never have to fit at once;
//   3. y from the accumulators, x and s_b.  Only x is read, only y written.
// Tiles are 8 x 8 pixels, smaller where the LN patch, the accumulators and
// the chunk's weights would not fit the 227 KB a block may use
// (ops/fused_leff.py tile_shape and shared_bytes, which mirror the layout
// below): larger tiles recompute less of the halo but leave fewer blocks
// on the card.  Shared strides of the column-wise reads are odd, free of
// bank conflicts, and the weight reads are broadcasts.  The fc1 loop is
// unrolled eight deep, so a warp keeps eight rows of shared loads in
// flight.  Plain FMA, no tensor cores yet.
//
// What bounds it on an H100.  Per pixel it does 4 C hid + 18 hid flops
// against 2 C itemsize bytes of x and y: about 4 C flops a byte at hid = 4C
// in bf16 (128-2048 over the AST levels), so at peak rates the levels with
// C >= 128 are bound by operations and those with C = 32 and 64 by bytes.
// This version runs the operations on the f32 FMA pipe (67 TFLOP/s), not
// the bf16 tensor cores (989 TFLOP/s), with three shared loads for eight
// multiply-adds in fc1 and two for four in fc2, and recomputes fc1 on the
// halo ((TH+2)(TW+2)/(TH TW) of it, 1.6x at 8 x 8, 2.3x at 4 x 4).
#include <cstdint>

#include "common.cuh"

namespace {

using uir::from_f;
using uir::round_to;
using uir::to_f;

constexpr int kThreads = 256;
// hidden channels a chunk; the wrapper pads the hidden width to a multiple
// of it (ops/fused_leff.py HIDDEN_CHUNK) and passes it, and a launch with
// another one is refused
constexpr int G = 32;

__device__ __forceinline__ float gelu(float t) {
  return 0.5f * t * (1.f + erff(t * 0.70710678118654752f));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Eight consecutive T values of global memory (16-byte aligned in bf16,
// 32-byte in f32) into two float4 of shared memory (16-byte aligned).
__device__ __forceinline__ void stage8(float* dstf, const float* src) {
  float4* dst = reinterpret_cast<float4*>(dstf);
  dst[0] = __ldg(reinterpret_cast<const float4*>(src));
  dst[1] = __ldg(reinterpret_cast<const float4*>(src) + 1);
}
__device__ __forceinline__ void stage8(float* dstf,
                                       const __nv_bfloat16* src) {
  float4* dst = reinterpret_cast<float4*>(dstf);
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(src));
  const auto* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  const float2 c = __bfloat1622float2(h[2]), d = __bfloat1622float2(h[3]);
  dst[0] = make_float4(a.x, a.y, b.x, b.y);
  dst[1] = make_float4(c.x, c.y, d.x, d.y);
}

// w1: [C][hid] in T; b1, bdw: [hid] f32; taps: [9][hid] f32 with
// k = 3 * dh + dw; w2: [hid][C] in T; b2: [C] f32; s: [B] f32.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ln_leff_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
                       const float* __restrict__ scale,
                       const float* __restrict__ bias,
                       const T* __restrict__ w1,
                       const float* __restrict__ b1,
                       const float* __restrict__ taps,
                       const float* __restrict__ bdw,
                       const T* __restrict__ w2,
                       const float* __restrict__ b2,
                       const float* __restrict__ s, int H, int W, int C,
                       int hid, int TH, int TW, int residual, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int PW = TW + 2, NP = PW * (TH + 2), P = TH * TW;
  const int LS = NP | 1, AS = P | 1;  // odd strides
  float* acc = reinterpret_cast<float*>(smem);  // [C][AS]
  float* g1 = acc + (size_t)C * AS;              // [G][NP]: gelu(fc1)
  float* g2 = g1 + G * NP;                       // [G][P]: gelu(dw3x3)
  float* w1s = g2 + G * P;                       // [C][G]: fc1 columns
  float* w2s = w1s + (size_t)C * G;              // [G][C]: fc2 rows
  T* ln = reinterpret_cast<T*>(w2s + (size_t)G * C);  // [C][LS]

  const int b = blockIdx.z;
  const int r0 = blockIdx.y * TH, c0 = blockIdx.x * TW;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  for (int i = tid; i < C * AS; i += blockDim.x) acc[i] = 0.f;
  for (int q = warp; q < NP; q += blockDim.x >> 5) {
    const int r = r0 - 1 + q / PW, c = c0 - 1 + q % PW;
    if (r < 0 || r >= H || c < 0 || c >= W) {
      for (int ch = lane; ch < C; ch += 32) ln[ch * LS + q] = from_f<T>(0.f);
      continue;
    }
    const T* xp = x + (((size_t)b * H + r) * W + c) * C;
    float sum = 0.f;
    for (int ch = lane; ch < C; ch += 32) sum += to_f(xp[ch]);
    const float mean = warp_sum(sum) / C;
    float var = 0.f;
    for (int ch = lane; ch < C; ch += 32) {
      const float d = to_f(xp[ch]) - mean;
      var += d * d;
    }
    const float rstd = rsqrtf(warp_sum(var) / C + eps);
    for (int ch = lane; ch < C; ch += 32)
      ln[ch * LS + q] = from_f<T>((to_f(xp[ch]) - mean) * rstd *
                                      __ldg(scale + ch) +
                                  __ldg(bias + ch));
  }

  for (int j0 = 0; j0 < hid; j0 += G) {
    // the chunk's fc1 columns (C rows of G) and fc2 rows (G x C, one
    // contiguous block), eight values a piece; the previous chunk's reads
    // of both finished at the barrier that ends it
    for (int i = tid; i < C * (G / 8); i += blockDim.x) {
      const int c = i / (G / 8), k = 8 * (i % (G / 8));
      stage8(w1s + c * G + k, w1 + (size_t)c * hid + j0 + k);
    }
    for (int i = tid; i < G * C / 8; i += blockDim.x)
      stage8(w2s + 8 * i, w2 + (size_t)j0 * C + 8 * i);
    __syncthreads();

    // fc1 and gelu over the halo patch: items (pixel, 8 hidden channels)
    for (int it = tid; it < NP * (G / 8); it += blockDim.x) {
      const int q = it % NP, j8 = 8 * (it / NP);
      const int r = r0 - 1 + q / PW, c = c0 - 1 + q % PW;
      const bool inside = r >= 0 && r < H && c >= 0 && c < W;
      float sv[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      const float* wc = w1s + j8;
#pragma unroll 8
      for (int ch = 0; ch < C; ++ch, wc += G) {
        const float l = to_f(ln[ch * LS + q]);
        const float4 wa = *reinterpret_cast<const float4*>(wc);
        const float4 wb = *reinterpret_cast<const float4*>(wc + 4);
        sv[0] = fmaf(l, wa.x, sv[0]);
        sv[1] = fmaf(l, wa.y, sv[1]);
        sv[2] = fmaf(l, wa.z, sv[2]);
        sv[3] = fmaf(l, wa.w, sv[3]);
        sv[4] = fmaf(l, wb.x, sv[4]);
        sv[5] = fmaf(l, wb.y, sv[5]);
        sv[6] = fmaf(l, wb.z, sv[6]);
        sv[7] = fmaf(l, wb.w, sv[7]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float t =
            round_to<T>(round_to<T>(sv[i]) + __ldg(b1 + j0 + j8 + i));
        g1[(j8 + i) * NP + q] = inside ? round_to<T>(gelu(t)) : 0.f;
      }
    }
    __syncthreads();

    // depthwise 3x3 and gelu on the tile: items (pixel, hidden channel)
    for (int it = tid; it < P * G; it += blockDim.x) {
      const int p = it % P, j = it / P;
      const float* gj = g1 + j * NP + (p / TW) * PW + p % TW;
      const float* tj = taps + j0 + j;
      float t = 0.f;
#pragma unroll
      for (int k = 0; k < 9; ++k)
        t = fmaf(__ldg(tj + k * hid), gj[(k / 3) * PW + k % 3], t);
      t = round_to<T>(round_to<T>(t) + __ldg(bdw + j0 + j));
      g2[j * P + p] = round_to<T>(gelu(t));
    }
    __syncthreads();

    // fc2 terms of the chunk into the accumulators: items (pixel, 4 output
    // channels), each always the same thread's, so no barrier guards acc
    for (int it = tid; it < P * (C / 4); it += blockDim.x) {
      const int p = it % P, o = 4 * (it / P);
      const float* wr = w2s + o;
      float u0 = 0.f, u1 = 0.f, u2 = 0.f, u3 = 0.f;
#pragma unroll 8
      for (int j = 0; j < G; ++j, wr += C) {
        const float gv = g2[j * P + p];
        const float4 w4 = *reinterpret_cast<const float4*>(wr);
        u0 = fmaf(gv, w4.x, u0);
        u1 = fmaf(gv, w4.y, u1);
        u2 = fmaf(gv, w4.z, u2);
        u3 = fmaf(gv, w4.w, u3);
      }
      acc[o * AS + p] += u0;
      acc[(o + 1) * AS + p] += u1;
      acc[(o + 2) * AS + p] += u2;
      acc[(o + 3) * AS + p] += u3;
    }
    // the next chunk overwrites w1s, w2s and g1
    __syncthreads();
  }

  const float sb = __ldg(s + b);
  for (int it = tid; it < P * C; it += blockDim.x) {
    const int o = it % C, p = it / C;
    const int r = r0 + p / TW, c = c0 + p % TW;
    if (r >= H || c >= W) continue;
    const size_t idx = (((size_t)b * H + r) * W + c) * C + o;
    const float yd =
        round_to<T>(round_to<T>(acc[o * AS + p]) + __ldg(b2 + o));
    const float sc = round_to<T>(yd * sb);
    y[idx] = from_f<T>(residual ? to_f(x[idx]) + sc : sc);
  }
}

template <typename T>
int launch(const void* x, void* y, const float* scale, const float* bias,
           const void* w1, const float* b1, const float* taps,
           const float* bdw, const void* w2, const float* b2,
           const float* s, int B, int H, int W, int C, int hid, int TH,
           int TW, int residual, float eps, cudaStream_t stream) {
  const size_t np = (size_t)(TH + 2) * (TW + 2), p = (size_t)TH * TW;
  const size_t smem =
      (C * (p | 1) + G * np + G * p + 2 * (size_t)C * G) * sizeof(float) +
      C * (np | 1) * sizeof(T);
  auto kern = ln_leff_fwd_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), scale, bias,
      static_cast<const T*>(w1), b1, taps, bdw, static_cast<const T*>(w2),
      b2, s, H, W, C, hid, TH, TW, residual, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int uir_ln_leff_fwd(const void* x, void* y, const void* scale,
                               const void* bias, const void* w1,
                               const void* b1, const void* taps,
                               const void* bdw, const void* w2,
                               const void* b2, const void* s, int B, int H,
                               int W, int C, int hid_pad, int chunk,
                               int residual, int bf16, int TH, int TW,
                               float eps, void* stream) {
  // C % 8: the eight-value pieces of the fc2 rows stay aligned
  if (chunk != G || hid_pad % G || C % 8 || B < 1 || TH < 1 || TW < 1)
    return (int)cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(x, y, f(scale), f(bias), w1, f(b1),
                                 f(taps), f(bdw), w2, f(b2), f(s), B, H, W,
                                 C, hid_pad, TH, TW, residual, eps, st);
  return launch<float>(x, y, f(scale), f(bias), w1, f(b1), f(taps), f(bdw),
                       w2, f(b2), f(s), B, H, W, C, hid_pad, TH, TW,
                       residual, eps, st);
}
