// Window attention forward: for every window and head,
//   S = scale (q k^T) + bias[head] (+ mask[window % nW])          (f32)
//   P = softmax_row(S), or, when sparse,
//   P = softmax_row(S) * w1 + relu(S)^2 * w2,  (w1, w2) = softmax(w)
//   out = P v, rounded to q's dtype.
//
// Replaces the TPU kernel of the JAX package ops/pallas.py:110 _fwd_pallas
// (_kernel_nomask:75, _kernel_masked:92).  Its backward there is a plain
// recompute; the port's is csrc/window_attn_bwd.cu.
//
// What bounds it on an H100.  Per (window, head) it moves 4 N d elements
// and does 4 N^2 d flops, N / itemsize flops a byte (32 in bf16 at N = 64),
// far below the bf16 tensor-core ridge (~295): at peak rates it is bound by
// bytes.  The design keeps every intermediate on chip and the loads in
// flight behind the products.
//
// Design (the stages in csrc/wattn.cuh).  A block of four warps owns one
// head and walks a run of windows (ops/window_attention.py fwd_plan): the
// head's bias plus the window's shift mask is staged once in shared memory
// as an f32 tile and restaged only when the run reaches the next mask
// index (a run holds a mask index's windows of every image, so the f32
// mask is read once a head and mask index, not once a window).  q, k and v
// of the next window copy into shared memory by cp.async while the current
// one computes.  A warp owns 16 query rows: S = q k^T on mma.sync m16n8k16
// (ldmatrix fragments, f32 accumulators in registers), the scale applied to
// the f32 accumulators (q is never rounded after scaling: 1/sqrt(d) is not
// a power of two), the bias and mask added from shared memory, the row
// softmax in registers (a quad of lanes a row), the relu(S)^2 mix, then P v
// with P's A fragments built from the registers (P is never stored).  The
// output goes through the warp's staging rows to the (B', N, heads * d)
// layout in 16-byte stores.  Operands: bf16 calls take P as one bf16 plane;
// f32 calls carry q, k, v and P as three bf16 planes, six passes a product
// (about 2^-24 of each product, wattn.cuh planes; TF32 stays off).  N <= 64
// and d <= 128 run on zero-padded 64 x 16 DK tiles (wattn.cuh tiles_of);
// P v walks the head width in halves of at most 64 channels (wattn.cuh
// rows_out), so at d = 128 a warp holds the accumulators of d = 64.  The
// shared memory a block takes (smem_bytes) sets how many blocks an SM
// holds: four at d = 32 in bf16, one at d = 128 (about 129 KiB in bf16,
// 188 KiB in f32); ops/window_attention.py fwd_plan plans from the same
// figure.
#include <cstdint>

#include "wattn.cuh"

namespace {

namespace mm = uir::mma;
namespace wa = uir::wattn;
using bf16 = __nv_bfloat16;
using wa::kThreads;
using wa::Strides;
using wa::Walk;

// The block's shared memory (mirrored by ops/window_attention.py
// fwd_smem_bytes): the bias and mask tile, q, k, v (NBUF windows of NP
// planes), four warps' staging rows of a half width.
template <typename T, int DK>
constexpr size_t smem_bytes() {
  constexpr int NP = wa::planes<T>(), NBUF = NP == 1 ? 2 : 1;
  return wa::kBiasFloats * sizeof(float) +
         (size_t)NBUF * 3 * NP * wa::kMaxN * mm::pad_ld(16 * DK) *
             sizeof(bf16) +
         (size_t)4 * 16 * wa::stage_ld<T, wa::out_dk(DK)>() * sizeof(T);
}

template <typename T, int DK>
__global__ void __launch_bounds__(kThreads)
    window_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           Strides sq, Strides sk, Strides sv, Strides so,
                           const float* __restrict__ bias,
                           const float* __restrict__ mask,
                           const float* __restrict__ w, Walk wk, float scale,
                           unsigned vec) {
  constexpr int NP = wa::planes<T>();  // bf16 planes an operand
  constexpr int NBUF = NP == 1 ? 2 : 1;  // cp.async double buffer
  constexpr int LD = mm::pad_ld(16 * DK);
  constexpr size_t PLANE = (size_t)wa::kMaxN * LD;
  constexpr size_t OPND = NP * PLANE;
  constexpr int SLD = wa::stage_ld<T, wa::out_dk(DK)>();
  extern __shared__ __align__(16) unsigned char smem[];
  float* bm = reinterpret_cast<float*>(smem);
  bf16* tiles = reinterpret_cast<bf16*>(bm + wa::kBiasFloats);
  T* stg = reinterpret_cast<T*>(tiles + NBUF * 3 * OPND) +
           (threadIdx.x >> 5) * 16 * SLD;

  const int h = blockIdx.x / wk.G, g = blockIdx.x % wk.G;
  const int i0 = g * wk.per, i1 = min(wk.BQ, i0 + wk.per);
  const int warp = threadIdx.x >> 5;
  const bool rows = 16 * warp < wk.N;  // the warp holds a query row
  float w1, w2;
  wa::mix_weights(w, w1, w2);

  auto load_window = [&](int i, int buf) {
    const long long b = (long long)(i % wk.T) * wk.nW + i / wk.T;
    bf16* t = tiles + buf * 3 * OPND;
    wa::stage<T, NP>(t, PLANE, LD, 16 * DK, q + b * sq.b + h * sq.h, sq.n,
                     wk.N, wk.D, vec & 1);
    wa::stage<T, NP>(t + OPND, PLANE, LD, 16 * DK, k + b * sk.b + h * sk.h,
                     sk.n, wk.N, wk.D, vec & 2);
    wa::stage<T, NP>(t + 2 * OPND, PLANE, LD, 16 * DK,
                     v + b * sv.b + h * sv.h, sv.n, wk.N, wk.D, vec & 4);
    mm::cp_async_commit();
  };

  int jcur = -1;
  if (NBUF == 2 && i0 < i1) load_window(i0, 0);
  for (int i = i0; i < i1; ++i) {
    const int buf = NBUF == 2 ? (i - i0) & 1 : 0;
    if (NBUF == 1) {
      load_window(i, 0);
    } else if (i + 1 < i1) {
      load_window(i + 1, buf ^ 1);
      mm::cp_async_wait<1>();
    } else {
      mm::cp_async_wait<0>();
    }
    const int j = i / wk.T;
    if (j != jcur) {
      wa::stage_bias(bm, bias + (size_t)h * wk.N * wk.N,
                     mask ? mask + (size_t)j * wk.N * wk.N : nullptr, wk.N);
      jcur = j;
    }
    __syncthreads();
    if (rows) {
      const bf16* t = tiles + buf * 3 * OPND;
      float s[8][4], p[8][4];
      wa::scores<NP, DK>(s, t, t + OPND, LD, PLANE, bm, scale);
      wa::softmax_rows(p, s);
      if (w) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float r = fmaxf(s[jj][e], 0.f);
            p[jj][e] = p[jj][e] * w1 + r * r * w2;
          }
      }
      const long long b = (long long)(i % wk.T) * wk.nW + j;
      wa::rows_out<T, NP, DK>(p, t + 2 * OPND, LD, PLANE, 1.f, stg,
                              out + b * so.b + h * so.h, so.n, 16 * warp,
                              wk.N, wk.D, vec & 8);
    }
    __syncthreads();
  }
}

template <typename T, int DK>
int launch(const void* q, const void* k, const void* v, void* out,
           Strides sq, Strides sk, Strides sv, Strides so, const float* bias,
           const float* mask, const float* w, Walk wk, float scale,
           unsigned vec, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, DK>();
  auto kern = window_attn_fwd_kernel<T, DK>;
  static const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<wk.H * wk.G, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, sk, sv, so, bias,
      mask, w, wk, scale, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int DK, const void* q, const void* k, const void* v, void* out,
             Strides sq, Strides sk, Strides sv, Strides so,
             const float* bias, const float* mask, const float* w, Walk wk,
             float scale, unsigned vec, cudaStream_t st) {
  switch (DK) {
    case 1:
      return launch<T, 1>(q, k, v, out, sq, sk, sv, so, bias, mask, w, wk,
                          scale, vec, st);
    case 2:
      return launch<T, 2>(q, k, v, out, sq, sk, sv, so, bias, mask, w, wk,
                          scale, vec, st);
    case 3:
      return launch<T, 3>(q, k, v, out, sq, sk, sv, so, bias, mask, w, wk,
                          scale, vec, st);
    case 4:
      return launch<T, 4>(q, k, v, out, sq, sk, sv, so, bias, mask, w, wk,
                          scale, vec, st);
    default:
      return launch<T, 8>(q, k, v, out, sq, sk, sv, so, bias, mask, w, wk,
                          scale, vec, st);
  }
}

}  // namespace

// strides: 12 values, (window, head, token) of q, k, v and out, in
// elements; mask and w may be null (no shift mask; the dense softmax).
// per: windows a block walks (ops/window_attention.py fwd_plan); vec: bit t
// set where tensor t of (q, k, v, out) has 16-byte aligned rows.
extern "C" int uir_window_attn_fwd(const void* q, const void* k,
                                   const void* v, void* out,
                                   const long long* strides,
                                   const void* bias, const void* mask,
                                   const void* w, int BQ, int H, int N,
                                   int D, int nW, int per, float scale,
                                   int bf16, int vec, void* stream) {
  if (N < 1 || N > wa::kMaxN || D < 1 || D > wa::kMaxD || BQ < 1 || H < 1 ||
      per < 1 || (mask && (nW < 1 || BQ % nW)))
    return (int)cudaErrorInvalidValue;
  if (!mask) nW = 1;
  const Strides sq{strides[0], strides[1], strides[2]};
  const Strides sk{strides[3], strides[4], strides[5]};
  const Strides sv{strides[6], strides[7], strides[8]};
  const Strides so{strides[9], strides[10], strides[11]};
  const Walk wk{BQ, H, N, D, nW, BQ / nW, per, (BQ + per - 1) / per};
  const auto* bi = static_cast<const float*>(bias);
  const auto* mk = static_cast<const float*>(mask);
  const auto* ww = static_cast<const float*>(w);
  auto st = static_cast<cudaStream_t>(stream);
  const int DK = wa::tiles_of(D);
  if (bf16)
    return dispatch<__nv_bfloat16>(DK, q, k, v, out, sq, sk, sv, so, bi, mk,
                                   ww, wk, scale, (unsigned)vec, st);
  return dispatch<float>(DK, q, k, v, out, sq, sk, sv, so, bi, mk, ww, wk,
                         scale, (unsigned)vec, st);
}
