// LN + GDFN backward: the vector-Jacobian product of
// y = x + W_out^T (gelu(t1) * t2), [t1; t2] = dwconv3x3(W_in^T LN_C(x)),
// on channels-first (B, C, H, W): dx, dscale, dbias, dW_in, dtaps, dW_out.
//
// Replaces the TPU kernels of the JAX package
// ops/fused_gdfn_banded.py:517 _bwd_call (_bwd_kernel:295) and
// ops/fused_block.py:663 _bwd_call (_bwd_kernel:484), which compute one
// function.
//
// Design.  LN is per pixel, so dx on a TH x TW tile is local: it needs dt on
// a 1-pixel halo (the transposed 3x3), hence t1, t2 and W_out dy there, hence
// LN(x) on a 2-pixel halo.  A block walks over tiles (tile = blockIdx.x,
// blockIdx.x + gridDim.x, ...), and per tile:
//   1. LN of the 2-pixel-halo patch and dy on the 1-pixel halo, in shared
//      memory (zero outside the image);
//   2. per chunk of G gate pairs, as the forward: u = W_in^T LN on the
//      2-pixel halo (f32); on the 1-pixel halo t1, t2 (taps), the gate's
//      cotangent round(W_out dy) and dt1 = dgo t2 gelu'(t1), dt2 = dgo
//      gelu(t1); the gate output o = round(gelu(t1) t2) on the tile;
//      du = transposed taps of dt on the tile; the tile's shares of dW_out
//      (o dy^T), dtaps (dt * shifted u) and dW_in (LN du^T); and
//      dLN += W_in du (f32);
//   3. the LayerNorm backward of the tile (grad.cuh) gives dx and the
//      shares of dscale and dbias.
// The weight-gradient shares accumulate in the block's own row of `part`;
// a second launch sums the rows in block order (deterministic, no float
// atomics).  Cotangents round to the compute type where autograd through the
// plain version rounds them (the gate output's and the LN output's, and the
// LN input's before the residual is added); every weight-gradient sum is
// f32.  The TPU kernel's composed 9C-deep dK and its decomposition
// (_decompose_dk) are not needed: the chain stays unfolded, so dW_in and
// dtaps come out directly.  Weight-gradient products and tap gradients sum
// over the tile one warp an output block (grad.cuh).  Plain FMA, no tensor
// cores yet.
//
// What bounds it on an H100.  Per pixel it recomputes the forward chain
// (2 * 2hid * (C + 9) flops) and runs the backward chains (about twice
// that) against 3 * C * itemsize bytes of x, dy and dx: far above the
// card's bf16 ridge at every level, so at peak rates it is bound by
// operations.  This version runs them on the f32 FMA pipe (67 TFLOP/s).
#include <cstdint>

#include "grad.cuh"

namespace {

using uir::from_f;
using uir::round_to;
using uir::to_f;

constexpr int kThreads = 256;
// gate pairs a chunk (ops/fused_gdfn.py GATE_CHUNK; a launch with another
// value is refused, as in the forward)
constexpr int G = 16;

__device__ __forceinline__ float gelu_f(float t) {
  return 0.5f * t * (1.f + erff(t * 0.70710678118654752f));
}

// d gelu / dt, exact (erf) form: Phi(t) + t * phi(t)
__device__ __forceinline__ float gelu_grad(float t) {
  return 0.5f * (1.f + erff(t * 0.70710678118654752f)) +
         t * 0.39894228040143268f * expf(-0.5f * t * t);
}

// win: [C][2 * hid_pad] in the forward's chunk layout; taps: [2 * hid_pad][9];
// winT: [2 * hid_pad][C] (win transposed); woutT: [C][hid_pad] (W_out
// transposed).  part row (E floats): dW_in [C][2 * hid_pad], dtaps
// [2 * hid_pad][9], dW_out [hid_pad][C], dscale [C], dbias [C].
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ln_gdfn_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                       T* __restrict__ dx, const float* __restrict__ scale,
                       const float* __restrict__ bias,
                       const float* __restrict__ win,
                       const float* __restrict__ taps,
                       const float* __restrict__ winT,
                       const float* __restrict__ woutT,
                       float* __restrict__ part, int B, int C, int H, int W,
                       int hid_pad, int TH, int TW, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int PW2 = TW + 2, NP2 = PW2 * (TH + 2);
  const int PW4 = TW + 4, NP4 = PW4 * (TH + 4), P = TH * TW;
  float* ub = reinterpret_cast<float*>(smem);  // [2G][NP4]: W_in^T LN
  float* dt = ub + 2 * G * NP4;                // [2G][NP2]: dt1, dt2
  float* du = dt + 2 * G * NP2;                // [2G][P]
  float* acc = du + 2 * G * P;                 // [C][P]: dLN, f32
  float* ov = acc + (size_t)C * P;             // [G][P]: gate output
  T* ln = reinterpret_cast<T*>(ov + G * P);    // [C][NP4]
  T* dyb = ln + (size_t)C * NP4;               // [C][NP2]

  const int tid = threadIdx.x;
  const int tiles_x = (W + TW - 1) / TW;
  const int per_img = tiles_x * ((H + TH - 1) / TH);
  const size_t plane = (size_t)H * W;
  const int wcols = 2 * hid_pad;
  const size_t E = (size_t)C * wcols + (size_t)wcols * 9 +
                   (size_t)hid_pad * C + 2 * C;
  float* g_win = part + blockIdx.x * E;
  float* g_taps = g_win + (size_t)C * wcols;
  float* g_wout = g_taps + (size_t)wcols * 9;
  float* g_sc = g_wout + (size_t)hid_pad * C;
  float* g_bi = g_sc + C;
  for (size_t e = tid; e < E; e += blockDim.x) g_win[e] = 0.f;

  for (int tile = blockIdx.x; tile < B * per_img; tile += gridDim.x) {
    const int b = tile / per_img, t = tile % per_img;
    const int r0 = (t / tiles_x) * TH, c0 = (t % tiles_x) * TW;
    const T* xb = x + (size_t)b * C * plane;
    const T* dyg = dy + (size_t)b * C * plane;
    __syncthreads();  // the previous tile is done with every buffer
    uir::ln_patch<T>(xb, ln, scale, bias, C, H, W, r0 - 2, c0 - 2, TH + 4,
                     PW4, eps);
    for (int i = tid; i < C * NP2; i += blockDim.x) {
      const int ch = i / NP2, q = i % NP2;
      const int r = r0 - 1 + q / PW2, cc = c0 - 1 + q % PW2;
      dyb[i] = uir::in_image(r, cc, H, W)
                   ? dyg[ch * plane + (size_t)r * W + cc]
                   : from_f<T>(0.f);
    }
    for (int i = tid; i < C * P; i += blockDim.x) acc[i] = 0.f;
    __syncthreads();

    for (int m = 0; m < hid_pad / G; ++m) {
      // u = W_in^T LN for the chunk over the 2-pixel-halo patch
      for (int it = tid; it < NP4 * (2 * G / 8); it += blockDim.x) {
        const int q = it % NP4, c8 = 8 * (it / NP4);
        float s[8];
        uir::project8<T>(s, ln, NP4, q, win + 2 * G * m + c8, wcols, C);
#pragma unroll
        for (int i = 0; i < 8; ++i) ub[(c8 + i) * NP4 + q] = s[i];
      }
      __syncthreads();

      // on the 1-pixel halo: t1, t2, the gate's cotangent, dt1, dt2; the
      // gate output on the tile
      for (int it = tid; it < NP2 * G; it += blockDim.x) {
        const int q = it % NP2, g = it / NP2;
        const int qy = q / PW2, qx = q % PW2;
        const bool tile_px = qy >= 1 && qy <= TH && qx >= 1 && qx <= TW;
        float d1 = 0.f, d2 = 0.f, o = 0.f;
        if (uir::in_image(r0 - 1 + qy, c0 - 1 + qx, H, W)) {
          const float* ta = taps + (size_t)(2 * G * m + g) * 9;
          const int base = qy * PW4 + qx;
          const float t1 = uir::tap9(ub + g * NP4 + base, PW4, ta);
          const float t2 =
              uir::tap9(ub + (G + g) * NP4 + base, PW4, ta + 9 * G);
          const float* wc = woutT + G * m + g;
          float s = 0.f;
          for (int ch = 0; ch < C; ++ch)
            s = fmaf(to_f(dyb[ch * NP2 + q]),
                     __ldg(wc + (size_t)ch * hid_pad), s);
          const float dgo = round_to<T>(s);
          const float ge = gelu_f(t1);
          d1 = dgo * t2 * gelu_grad(t1);
          d2 = dgo * ge;
          o = round_to<T>(ge * t2);
        }
        dt[g * NP2 + q] = d1;
        dt[(G + g) * NP2 + q] = d2;
        if (tile_px) ov[g * P + (qy - 1) * TW + qx - 1] = o;
      }
      __syncthreads();

      // the tile's shares of dW_out (o dy^T) and dtaps; du on the tile
      uir::outer_acc<float, T>(g_wout + (size_t)G * m * C, C, ov, 0, G, dyb,
                               1, C, TH, TW);
      uir::tap_grad_acc<float>(g_taps + (size_t)2 * G * m * 9, dt, 1, ub, 2,
                               2 * G, TH, TW);
      uir::tap9_t<float>(du, dt, taps + (size_t)2 * G * m * 9, 2 * G, TH, TW,
                         r0, c0, H, W);
      __syncthreads();

      // the tile's share of dW_in (LN du^T); dLN += W_in du
      uir::outer_acc<T, float>(g_win + 2 * G * m, wcols, ln, 2, C, du, 0,
                               2 * G, TH, TW);
      for (int it = tid; it < P * (C / 8); it += blockDim.x) {
        const int p = it % P, c8 = 8 * (it / P);
        float s[8];
        uir::project8<float>(s, du, P, p, winT + (size_t)2 * G * m * C + c8,
                             C, 2 * G);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[(c8 + i) * P + p] += s[i];
      }
      __syncthreads();
    }

    uir::ln_backward_tile<T>(xb, dyg, dx + (size_t)b * C * plane, acc, ub,
                             scale, g_sc, g_bi, C, H, W, r0, c0, TH, TW, eps);
  }
}

template <typename T>
int launch(const void* x, const void* dy, void* dx, const float* scale,
           const float* bias, const float* win, const float* taps,
           const float* winT, const float* woutT, float* part, float* grads,
           int B, int C, int H, int W, int hid_pad, int TH, int TW,
           int groups, float eps, cudaStream_t stream) {
  const size_t np2 = (size_t)(TH + 2) * (TW + 2);
  const size_t np4 = (size_t)(TH + 4) * (TW + 4), p = (size_t)TH * TW;
  const size_t smem =
      (2 * G * np4 + 2 * G * np2 + 2 * G * p + C * p + G * p) * sizeof(float) +
      (C * np4 + C * np2) * sizeof(T);
  if (hid_pad % G || C % 8 || !uir::tile_ok(TH, TW))
    return (int)cudaErrorInvalidValue;
  auto kern = ln_gdfn_bwd_kernel<T>;
  cudaError_t e = uir::set_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<groups, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<T*>(dx),
      scale, bias, win, taps, winT, woutT, part, B, C, H, W, hid_pad, TH, TW,
      eps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int E = C * 2 * hid_pad + 2 * hid_pad * 9 + hid_pad * C + 2 * C;
  return (int)uir::reduce_rows(part, grads, groups, E, stream);
}

}  // namespace

// Two launches: the tile kernel (grid `groups`, each block's partial row in
// part [groups][E]) and the ordered row sum into grads [E].
extern "C" int uir_ln_gdfn_bwd(const void* x, const void* dy, void* dx,
                               const void* scale, const void* bias,
                               const void* win, const void* taps,
                               const void* winT, const void* woutT,
                               void* part, void* grads, int B, int C, int H,
                               int W, int hid_pad, int gate_chunk, int bf16,
                               int TH, int TW, int groups, float eps,
                               void* stream) {
  if (gate_chunk != G) return (int)cudaErrorInvalidValue;
  const auto* s = static_cast<const float*>(scale);
  const auto* bi = static_cast<const float*>(bias);
  const auto* wi = static_cast<const float*>(win);
  const auto* tp = static_cast<const float*>(taps);
  const auto* wiT = static_cast<const float*>(winT);
  const auto* woT = static_cast<const float*>(woutT);
  auto* pt = static_cast<float*>(part);
  auto* gr = static_cast<float*>(grads);
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(x, dy, dx, s, bi, wi, tp, wiT, woT, pt, gr,
                                 B, C, H, W, hid_pad, TH, TW, groups, eps, st);
  return launch<float>(x, dy, dx, s, bi, wi, tp, wiT, woT, pt, gr, B, C, H, W,
                       hid_pad, TH, TW, groups, eps, st);
}
