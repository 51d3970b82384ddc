// Window attention forward: for every window and head,
//   S = (q * scale) k^T + bias[head] (+ mask[window % nW])        (f32)
//   P = softmax_row(S), or, when sparse,
//   P = softmax_row(S) * w1 + relu(S)^2 * w2,  (w1, w2) = softmax(w)
//   out = P v, rounded to q's dtype.
//
// Replaces the TPU kernel of the JAX package ops/pallas.py:110 _fwd_pallas
// (_kernel_nomask:75, _kernel_masked:92).  Its backward there is a plain
// recompute, not a kernel; the port's is the same (ops/window_attention.py).
//
// Design.  One block of 128 threads owns one (window, head): it stages q
// (pre-scaled, as the TPU kernel scales q in f32 before the product), k and
// v of its N <= 64 tokens and d <= 64 channels in shared memory as f32,
// computes the N x N scores with the bias and the mask, takes each row's
// softmax (max subtracted) with a warp a row, mixes in relu(S)^2 when
// sparse, and writes P v.  The mix weights are computed on the card from w,
// so the host never waits for them.  q, k, v and out are addressed through
// their (window, head, token) strides with unit channel stride, so the
// heads can be views of the projections' (B', N, heads * d) outputs and the
// result lands in the (B', N, heads * d) layout that the output projection
// reads: no head split or merge is copied.  k rows and P rows are padded
// by one word so that the column-wise reads are free of bank conflicts.
//
// What bounds it on an H100.  Per (window, head) it moves 4 N d elements
// and does 4 N^2 d flops, N / itemsize flops a byte (32 in bf16 at N = 64),
// far below the bf16 tensor-core ridge (~295): at peak rates it is bound by
// bytes.  This version runs the products on the f32 FMA pipe from shared
// memory (two shared loads a multiply-add), far from either bound.
#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

using uir::from_f;
using uir::to_f;

constexpr int kThreads = 128;
constexpr int kMaxN = 64;
constexpr int kMaxD = 64;

struct Strides {
  long long b, h, n;  // window, head and token strides; channel stride 1
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    window_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           Strides sq, Strides sk, Strides sv, Strides so,
                           const float* __restrict__ bias,
                           const float* __restrict__ mask,
                           const float* __restrict__ w, int H, int N, int D,
                           int nW, float scale) {
  extern __shared__ __align__(16) float sm[];
  const int KD = D + 1, PN = N + 1;
  float* qs = sm;            // [N][D], pre-scaled
  float* ks = qs + N * D;    // [N][D + 1]
  float* vs = ks + N * KD;   // [N][D]
  float* ps = vs + N * D;    // [N][N + 1]: scores, then probabilities

  const int bw = blockIdx.x / H, hh = blockIdx.x % H;
  const int tid = threadIdx.x;
  const T* qb = q + bw * sq.b + hh * sq.h;
  const T* kb = k + bw * sk.b + hh * sk.h;
  const T* vb = v + bw * sv.b + hh * sv.h;
  for (int e = tid; e < N * D; e += blockDim.x) {
    const int i = e / D, t = e % D;
    qs[e] = to_f(qb[i * sq.n + t]) * scale;
    ks[i * KD + t] = to_f(kb[i * sk.n + t]);
    vs[e] = to_f(vb[i * sv.n + t]);
  }
  __syncthreads();

  const float* bh = bias + (size_t)hh * N * N;
  const float* mw = mask ? mask + (size_t)(bw % nW) * N * N : nullptr;
  for (int e = tid; e < N * N; e += blockDim.x) {
    const int i = e / N, j = e % N;
    const float* qi = qs + i * D;
    const float* kj = ks + j * KD;
    float s = 0.f;
    for (int t = 0; t < D; ++t) s = fmaf(qi[t], kj[t], s);
    s += __ldg(bh + e);
    if (mw) s += __ldg(mw + e);
    ps[i * PN + j] = s;
  }
  __syncthreads();

  // row softmax, a warp a row; N <= 64, so a lane holds two entries
  float w1 = 1.f, w2 = 0.f;
  if (w) {
    const float e0 = expf(__ldg(w)), e1 = expf(__ldg(w + 1));
    const float sw = e0 + e1;
    w1 = e0 / sw;
    w2 = e1 / sw;
  }
  const int warp = tid >> 5, lane = tid & 31;
  for (int i = warp; i < N; i += blockDim.x >> 5) {
    float* row = ps + i * PN;
    const bool has0 = lane < N, has1 = lane + 32 < N;
    const float s0 = has0 ? row[lane] : -INFINITY;
    const float s1 = has1 ? row[lane + 32] : -INFINITY;
    float m = fmaxf(s0, s1);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const float e0 = has0 ? expf(s0 - m) : 0.f;
    const float e1 = has1 ? expf(s1 - m) : 0.f;
    float sum = e0 + e1;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (has0) {
      float p = e0 / sum;
      if (w) {
        const float r = fmaxf(s0, 0.f);
        p = p * w1 + r * r * w2;
      }
      row[lane] = p;
    }
    if (has1) {
      float p = e1 / sum;
      if (w) {
        const float r = fmaxf(s1, 0.f);
        p = p * w1 + r * r * w2;
      }
      row[lane + 32] = p;
    }
  }
  __syncthreads();

  T* ob = out + bw * so.b + hh * so.h;
  for (int e = tid; e < N * D; e += blockDim.x) {
    const int i = e / D, t = e % D;
    const float* pi = ps + i * PN;
    float o = 0.f;
    for (int j = 0; j < N; ++j) o = fmaf(pi[j], vs[j * D + t], o);
    ob[i * so.n + t] = from_f<T>(o);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out,
           Strides sq, Strides sk, Strides sv, Strides so, const float* bias,
           const float* mask, const float* w, int BQ, int H, int N, int D,
           int nW, float scale, cudaStream_t stream) {
  const size_t smem = (size_t)(2 * N * D + N * (D + 1) + N * (N + 1)) *
                      sizeof(float);
  auto kern = window_attn_fwd_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<BQ * H, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, sk, sv, so, bias,
      mask, w, H, N, D, nW, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// strides: 12 values, (window, head, token) of q, k, v and out, in
// elements; mask and w may be null (no shift mask; the dense softmax).
extern "C" int uir_window_attn_fwd(const void* q, const void* k,
                                   const void* v, void* out,
                                   const long long* strides,
                                   const void* bias, const void* mask,
                                   const void* w, int BQ, int H, int N,
                                   int D, int nW, float scale, int bf16,
                                   void* stream) {
  if (N < 1 || N > kMaxN || D < 1 || D > kMaxD || BQ < 1 || H < 1 ||
      (mask && (nW < 1 || BQ % nW)))
    return (int)cudaErrorInvalidValue;
  const Strides sq{strides[0], strides[1], strides[2]};
  const Strides sk{strides[3], strides[4], strides[5]};
  const Strides sv{strides[6], strides[7], strides[8]};
  const Strides so{strides[9], strides[10], strides[11]};
  const auto* bi = static_cast<const float*>(bias);
  const auto* mk = static_cast<const float*>(mask);
  const auto* ww = static_cast<const float*>(w);
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(q, k, v, out, sq, sk, sv, so, bi, mk, ww,
                                 BQ, H, N, D, nW, scale, st);
  return launch<float>(q, k, v, out, sq, sk, sv, so, bi, mk, ww, BQ, H, N,
                       D, nW, scale, st);
}
