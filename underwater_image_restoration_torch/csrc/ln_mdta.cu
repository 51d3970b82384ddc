// LN + MDTA forward: y = x + MDTA(LayerNorm_C(x)) on channels-first
// (B, C, H, W), the first half of a SpectralBlock, with the reference's
// dead-code quirks (attnf, kf and q1x1_1 are never computed; vf is the
// second half of kv / kv_conv).
//
// Replaces the TPU kernels of the JAX package
// ops/fused_attn_composed.py:523 _fwd_call (_fwd_kernel:139) and
// fused_attn_banded.py:648 _fwd_call (_fwd_kernel:183), which compute one
// function and were split on the TPU only to fit its VMEM.
//
// Design.  The attention is global over the image, so the forward takes two
// launches over TH x TW tiles:
//   1. stats: LayerNorm of the tile with a 1-pixel halo; q and k as a 1x1
//      over the halo patch then the 3x3 taps, in chunks of 16 channels
//      (f32 between the two, like the TPU kernel's composed contraction;
//      q and k rounded to the compute type, like the TPU kernel); the tile's
//      partial head-diagonal gram G = q k^T and row sums of squares Sq, Sk.
//      The last block of each image to finish (atomic ticket) sums the
//      partials in tile order, so the result does not depend on block
//      scheduling.
//   2. apply: each block rebuilds A = softmax_head(temp * G * rq * rk^T),
//      rq = rsqrt(max(Sq, 1e-24)) (fused_attn.py:92 _attn_from_stats), then
//      with a 2-pixel halo: v = dw(W_v LN) (f32) and out = W_po^T (A v) on
//      the 1-pixel-halo region (zero outside the image: the zero padding of
//      kv_conv), vf = dw(W_kvf out) (f32) and y = x + W_pof^T (A vf) on the
//      tile.  Intermediates stay in shared memory; only x is read (twice)
//      and y written.
// The TPU kernels fold each 1x1 -> 3x3 chain into one 9C-deep matrix to fill
// the systolic array; on the FMA pipe that costs 9C / (C + 9) times the
// multiply-adds, so the chains stay apart here.  Work items (pixel, channel
// group) are strided over 256 threads a block; plain FMA, no tensor cores
// yet.
//
// What bounds it on an H100.  Per pixel ~2 * (3C(C + 9) + 3C^2 + 9C +
// 3C * CPH) flops against x and y (2 * C * itemsize bytes, x read twice
// here): 150-1000 flop/byte over the levels, so at peak rates the deep
// levels are bound by operations and the 256x256 ones near the ridge.  This
// version runs the operations on the f32 FMA pipe (67 TFLOP/s), not the
// bf16 tensor cores (989 TFLOP/s).
#include <cstdint>

#include "common.cuh"

namespace {

using uir::from_f;
using uir::to_f;

constexpr int kThreads = 256;
constexpr int CH = 16;  // channels a chunk of a 1x1 -> 3x3 chain

// 1x1 of in (channel-major, np pixels a channel) to the 16 output channels
// [16m, 16m + 16) of w ([C][ld]) at every pixel: out [16][np] f32.
template <typename T>
__device__ void project_chunk(float* out, const T* in, int np,
                              const float* __restrict__ w, int ld, int C,
                              int m) {
  for (int it = threadIdx.x; it < np * (CH / 8); it += blockDim.x) {
    const int q = it % np, c8 = 8 * (it / np);
    float s[8];
    uir::project8<T>(s, in, np, q, w + CH * m + c8, ld, C);
#pragma unroll
    for (int i = 0; i < 8; ++i) out[(c8 + i) * np + q] = s[i];
  }
}

template <typename T, int CPH>
__global__ void __launch_bounds__(kThreads)
    ln_mdta_stats_kernel(const T* __restrict__ x,
                         const float* __restrict__ scale,
                         const float* __restrict__ bias,
                         const float* __restrict__ wqk,
                         const float* __restrict__ tqk,
                         float* __restrict__ part, int* __restrict__ counters,
                         float* __restrict__ stats, int C, int H, int W,
                         int TH, int TW, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int is_last;
  const int PW = TW + 2, NP = PW * (TH + 2), P = TH * TW;
  const int QS = 2 * C + 1;  // padded pixel-major row: q[0..C), k[C..2C)
  float* pb = reinterpret_cast<float*>(smem);  // [CH][NP]
  T* ln = reinterpret_cast<T*>(pb + CH * NP);  // [C][NP]
  T* qk = ln + (size_t)C * NP;                 // [P][QS]

  const int b = blockIdx.z;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  const int ntiles = gridDim.x * gridDim.y;
  const int r0 = blockIdx.y * TH, c0 = blockIdx.x * TW;
  const int tid = threadIdx.x;
  const size_t plane = (size_t)H * W;

  uir::ln_patch<T>(x + (size_t)b * C * plane, ln, scale, bias, C, H, W,
                   r0 - 1, c0 - 1, TH + 2, PW, eps);
  __syncthreads();

  // q (channels [0, C)) and k ([C, 2C)) in chunks: 1x1 over the halo patch,
  // then the taps at the tile's pixels
  for (int m = 0; m < 2 * C / CH; ++m) {
    project_chunk<T>(pb, ln, NP, wqk, 2 * C, C, m);
    __syncthreads();
    for (int it = tid; it < P * CH; it += blockDim.x) {
      const int p = it % P, ch = it / P;
      const int ty = p / TW, tx = p % TW;
      float t = 0.f;  // pixels past the image edge add nothing to the gram
      if (r0 + ty < H && c0 + tx < W)
        t = uir::tap9(pb + ch * NP + ty * PW + tx, PW,
                      tqk + (CH * m + ch) * 9);
      qk[(size_t)p * QS + CH * m + ch] = from_f<T>(t);
    }
    __syncthreads();
  }

  // this tile's partial stats: G[i][jj] (head-diagonal), then Sq, Sk
  const int E = C * CPH + 2 * C;
  float* mine = part + ((size_t)b * ntiles + tile) * E;
  for (int e = tid; e < E; e += blockDim.x) {
    int i, j;
    if (e < C * CPH) {
      i = e / CPH;
      j = C + (i / CPH) * CPH + e % CPH;
    } else if (e < C * CPH + C) {
      i = j = e - C * CPH;
    } else {
      i = j = C + e - C * CPH - C;
    }
    float s = 0.f;
    for (int p = 0; p < P; ++p)
      s = fmaf(to_f(qk[p * QS + i]), to_f(qk[p * QS + j]), s);
    mine[e] = s;
  }

  // the last block of this image to finish sums the partials in tile order
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(counters + b, 1) == ntiles - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const float* pp = part + (size_t)b * ntiles * E;
  for (int e = tid; e < E; e += blockDim.x) {
    float s = 0.f;
    for (int t = 0; t < ntiles; ++t) s += __ldcg(pp + (size_t)t * E + e);
    stats[(size_t)b * E + e] = s;
  }
  if (tid == 0) counters[b] = 0;
}

// dst[i][p] = round(sum_jj A[i][jj] * src[head(i) * CPH + jj][p]) for every
// channel i and pixel p < np: the head-diagonal attention product.
template <typename T, int CPH>
__device__ void attend(T* dst, const float* src, const float* A, int C,
                       int np) {
  for (int it = threadIdx.x; it < np * C; it += blockDim.x) {
    const int p = it % np, i = it / np;
    const float* ar = A + i * CPH;
    const float* sr = src + (i / CPH) * CPH * np + p;
    float s = 0.f;
#pragma unroll
    for (int jj = 0; jj < CPH; ++jj) s = fmaf(ar[jj], sr[jj * np], s);
    dst[i * np + p] = from_f<T>(s);
  }
}

// u[0..4) = sum_i w[i][o..o+4) * in[i][p]: four output channels of a 1x1
template <typename T>
__device__ __forceinline__ float4 project4(const T* in, int np, int p,
                                           const float* __restrict__ w,
                                           int C, int o) {
  float4 u = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = 0; i < C; ++i) {
    const float v = to_f(in[i * np + p]);
    const float4 w4 =
        __ldg(reinterpret_cast<const float4*>(w + (size_t)i * C + o));
    u.x = fmaf(v, w4.x, u.x);
    u.y = fmaf(v, w4.y, u.y);
    u.z = fmaf(v, w4.z, u.z);
    u.w = fmaf(v, w4.w, u.w);
  }
  return u;
}

template <typename T, int CPH>
__global__ void __launch_bounds__(kThreads)
    ln_mdta_apply_kernel(const T* __restrict__ x, T* __restrict__ y,
                         const float* __restrict__ scale,
                         const float* __restrict__ bias,
                         const float* __restrict__ wv,
                         const float* __restrict__ tv,
                         const float* __restrict__ wkvf,
                         const float* __restrict__ tvf,
                         const float* __restrict__ wpo,
                         const float* __restrict__ wpof,
                         const float* __restrict__ temp,
                         const float* __restrict__ stats, int C, int H, int W,
                         int TH, int TW, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int PW2 = TW + 2, NP2 = PW2 * (TH + 2);
  const int PW4 = TW + 4, NP4 = PW4 * (TH + 4), P = TH * TW;
  float* A = reinterpret_cast<float*>(smem);  // [C][CPH]
  float* pb = A + C * CPH;                    // [CH][NP4]: a 1x1 chunk
  float* v = pb + CH * NP4;                   // [C][NP2]: v, later vf [C][P]
  T* ln = reinterpret_cast<T*>(v + (size_t)C * NP2);  // [C][NP4]
  T* os = ln + (size_t)C * NP4;  // [C][NP2]: A v, later A vf [C][P]
  T* ob = os + (size_t)C * NP2;  // [C][NP2]: out

  const int b = blockIdx.z;
  const int r0 = blockIdx.y * TH, c0 = blockIdx.x * TW;
  const int tid = threadIdx.x;
  const size_t plane = (size_t)H * W;

  // A from the image's stats: l2-normalize, temperature, per-head softmax
  const float* st = stats + (size_t)b * (C * CPH + 2 * C);
  for (int i = tid; i < C; i += blockDim.x) {
    const int h = i / CPH;
    const float rq = rsqrtf(fmaxf(st[C * CPH + i], 1e-24f));
    const float t = temp[h];
    float m = -INFINITY;
    for (int jj = 0; jj < CPH; ++jj) {
      const float rk = rsqrtf(fmaxf(st[C * CPH + C + h * CPH + jj], 1e-24f));
      const float lg = st[i * CPH + jj] * rq * rk * t;
      A[i * CPH + jj] = lg;
      m = fmaxf(m, lg);
    }
    float s = 0.f;
    for (int jj = 0; jj < CPH; ++jj) {
      const float e = expf(A[i * CPH + jj] - m);
      A[i * CPH + jj] = e;
      s += e;
    }
    for (int jj = 0; jj < CPH; ++jj) A[i * CPH + jj] /= s;
  }
  uir::ln_patch<T>(x + (size_t)b * C * plane, ln, scale, bias, C, H, W,
                   r0 - 2, c0 - 2, TH + 4, PW4, eps);
  __syncthreads();

  // v on the 1-pixel-halo region, in chunks: 1x1 over the 2-pixel-halo
  // patch, then the taps
  for (int m = 0; m < C / CH; ++m) {
    project_chunk<T>(pb, ln, NP4, wv, C, C, m);
    __syncthreads();
    for (int it = tid; it < NP2 * CH; it += blockDim.x) {
      const int q = it % NP2, ch = it / NP2;
      v[(CH * m + ch) * NP2 + q] =
          uir::tap9(pb + ch * NP4 + (q / PW2) * PW4 + q % PW2, PW4,
                    tv + (CH * m + ch) * 9);
    }
    __syncthreads();
  }
  attend<T, CPH>(os, v, A, C, NP2);
  __syncthreads();

  // out = W_po^T (A v), zero outside the image (kv_conv's zero padding)
  for (int it = tid; it < NP2 * (C / 4); it += blockDim.x) {
    const int q = it % NP2, o = 4 * (it / NP2);
    const int r = r0 - 1 + q / PW2, cc = c0 - 1 + q % PW2;
    float4 u = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r >= 0 && r < H && cc >= 0 && cc < W)
      u = project4<T>(os, NP2, q, wpo, C, o);
    ob[o * NP2 + q] = from_f<T>(u.x);
    ob[(o + 1) * NP2 + q] = from_f<T>(u.y);
    ob[(o + 2) * NP2 + q] = from_f<T>(u.z);
    ob[(o + 3) * NP2 + q] = from_f<T>(u.w);
  }
  __syncthreads();

  // vf on the tile, in chunks: 1x1 over the 1-pixel-halo region, then taps
  float* vf = v;  // [C][P]; v is dead after attend
  for (int m = 0; m < C / CH; ++m) {
    project_chunk<T>(pb, ob, NP2, wkvf, C, C, m);
    __syncthreads();
    for (int it = tid; it < P * CH; it += blockDim.x) {
      const int p = it % P, ch = it / P;
      vf[(CH * m + ch) * P + p] =
          uir::tap9(pb + ch * NP2 + (p / TW) * PW2 + p % TW, PW2,
                    tvf + (CH * m + ch) * 9);
    }
    __syncthreads();
  }
  T* of = os;  // [C][P]; os is dead after out
  attend<T, CPH>(of, vf, A, C, P);
  __syncthreads();

  // y = x + W_pof^T (A vf)
  for (int it = tid; it < P * (C / 4); it += blockDim.x) {
    const int p = it % P, o = 4 * (it / P);
    const int r = r0 + p / TW, cc = c0 + p % TW;
    if (r >= H || cc >= W) continue;
    const float4 u = project4<T>(of, P, p, wpof, C, o);
    const float uo[4] = {u.x, u.y, u.z, u.w};
    const size_t pix = (size_t)b * C * plane + (size_t)r * W + cc;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const size_t idx = pix + (size_t)(o + i) * plane;
      y[idx] = from_f<T>(to_f(x[idx]) + uir::round_to<T>(uo[i]));
    }
  }
}

template <typename K>
cudaError_t set_smem(K kern, size_t smem) {
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int CPH>
int stats(const void* x, const float* scale, const float* bias,
          const float* wqk, const float* tqk, float* part, int* counters,
          float* st, int B, int C, int H, int W, int TH, int TW, float eps,
          cudaStream_t stream) {
  const size_t np = (size_t)(TH + 2) * (TW + 2);
  const size_t smem = CH * np * sizeof(float) +
                      (C * np + (size_t)TH * TW * (2 * C + 1)) * sizeof(T);
  auto kern = ln_mdta_stats_kernel<T, CPH>;
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  kern<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(x), scale,
                                         bias, wqk, tqk, part, counters, st,
                                         C, H, W, TH, TW, eps);
  return (int)cudaGetLastError();
}

template <typename T, int CPH>
int apply(const void* x, void* y, const float* scale, const float* bias,
          const float* wv, const float* tv, const float* wkvf,
          const float* tvf, const float* wpo, const float* wpof,
          const float* temp, const float* st, int B, int C, int H, int W,
          int TH, int TW, float eps, cudaStream_t stream) {
  const size_t np2 = (size_t)(TH + 2) * (TW + 2);
  const size_t np4 = (size_t)(TH + 4) * (TW + 4);
  const size_t smem = (C * CPH + CH * np4 + C * np2) * sizeof(float) +
                      (C * np4 + 2 * C * np2) * sizeof(T);
  auto kern = ln_mdta_apply_kernel<T, CPH>;
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), scale, bias, wv, tv,
      wkvf, tvf, wpo, wpof, temp, st, C, H, W, TH, TW, eps);
  return (int)cudaGetLastError();
}

#define UIR_DISPATCH(FN, ...)                                          \
  do {                                                                 \
    if (C % CH) return (int)cudaErrorInvalidValue;                     \
    if (bf16) {                                                        \
      if (cph == 8) return FN<__nv_bfloat16, 8>(__VA_ARGS__);          \
      if (cph == 16) return FN<__nv_bfloat16, 16>(__VA_ARGS__);        \
      if (cph == 32) return FN<__nv_bfloat16, 32>(__VA_ARGS__);        \
    } else {                                                           \
      if (cph == 8) return FN<float, 8>(__VA_ARGS__);                  \
      if (cph == 16) return FN<float, 16>(__VA_ARGS__);                \
      if (cph == 32) return FN<float, 32>(__VA_ARGS__);                \
    }                                                                  \
    return (int)cudaErrorInvalidValue;                                 \
  } while (0)

}  // namespace

extern "C" int uir_ln_mdta_stats(const void* x, const void* scale,
                                 const void* bias, const void* wqk,
                                 const void* tqk, void* part, void* counters,
                                 void* st, int B, int C, int H, int W,
                                 int cph, int bf16, int TH, int TW, float eps,
                                 void* stream) {
  UIR_DISPATCH(stats, x, static_cast<const float*>(scale),
               static_cast<const float*>(bias), static_cast<const float*>(wqk),
               static_cast<const float*>(tqk), static_cast<float*>(part),
               static_cast<int*>(counters), static_cast<float*>(st), B, C, H,
               W, TH, TW, eps, static_cast<cudaStream_t>(stream));
}

extern "C" int uir_ln_mdta_apply(const void* x, void* y, const void* scale,
                                 const void* bias, const void* wv,
                                 const void* tv, const void* wkvf,
                                 const void* tvf, const void* wpo,
                                 const void* wpof, const void* temp,
                                 const void* st, int B, int C, int H, int W,
                                 int cph, int bf16, int TH, int TW, float eps,
                                 void* stream) {
  UIR_DISPATCH(apply, x, y, static_cast<const float*>(scale),
               static_cast<const float*>(bias), static_cast<const float*>(wv),
               static_cast<const float*>(tv), static_cast<const float*>(wkvf),
               static_cast<const float*>(tvf), static_cast<const float*>(wpo),
               static_cast<const float*>(wpof),
               static_cast<const float*>(temp), static_cast<const float*>(st),
               B, C, H, W, TH, TW, eps, static_cast<cudaStream_t>(stream));
}
