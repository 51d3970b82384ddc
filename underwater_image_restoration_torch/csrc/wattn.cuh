// Shared stages of the window-attention kernels (csrc/window_attn.cu, the
// forward, and csrc/window_attn_bwd.cu, its recompute backward) on the
// tensor cores.
//
// A block of four warps owns one head and walks a run of windows
// (ops/window_attention.py fwd_plan, bwd_plan: the run's windows in (mask
// index, image) order, so the bias and mask tile is staged once a head and
// mask index, not once a window).  A window's q, k, v (and dO) are staged as
// zero-padded 64 x 16 DK tiles of bf16 planes (one plane for bf16 operands,
// three for f32 ones, planes below); warp w owns query rows 16 w ..
// 16 w + 15, whose scores stay in registers in the m16n8 accumulator
// layout: s[j][e] is row 16 w + lane / 4 + 8 (e / 2), key 8 j + 2 (lane %
// 4) + e % 2.  Keys past N get -inf from the bias tile, so they take no
// weight in the softmax and no relu² term; rows past N are computed on
// zeros and never stored.
//
// Head widths.  d <= 64 runs on DK = ceil(d / 16) 16-column tiles, d in
// (64, 128] on DK = 8 (the channels past d are zeros).  The products that
// sum over d (S = q k^T, dP = dO v^T) take every k16 step of the width
// into one accumulator; the products whose output runs over d (P v, dS k,
// P^T dO, dS^T q) walk it in halves of at most four tiles (out_dk), so a
// warp's output accumulators, and its staging rows, stay those of d = 64.
#pragma once

#include <cmath>
#include <cstdint>

#include "mma.cuh"

namespace uir {
namespace wattn {

using mma::bf16;

constexpr int kThreads = 128;  // four warps of 16 query rows
constexpr int kMaxN = 64;
constexpr int kMaxD = 128;
// f32 row of the bias tile: float2 reads of eight rows by four lanes fall
// on distinct banks in each half-warp
constexpr int kBLD = kMaxN + 8;
constexpr int kBiasFloats = kMaxN * kBLD;

// bf16 planes an operand (mma.cuh): one for bf16; hi, mid and lo for f32,
// six passes a product, about 2^-24 of each.  hi/lo pairs (about 2^-17)
// leave too little room under the 1e-4 limit for the backward's dw, a
// difference of two sums that cancel; the forward takes the same planes,
// so the backward recomputes the forward's scores.
template <typename T>
__host__ __device__ constexpr int planes() {
  return sizeof(T) == 4 ? 3 : 1;
}

struct Strides {
  long long b, h, n;  // window, head and token strides; channel stride 1
};

// What the grid walks: block (h, g) takes windows idx in [g per, (g + 1)
// per) of BQ, idx = j T + t for mask index j < nW and image t < T = BQ /
// nW, i.e. window t nW + j (nW = 1 without a mask).
struct Walk {
  int BQ, H, N, D, nW, T, per, G;
};

__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two consecutive values at (row, col) of NP planes of a bf16 tile.
template <int NP>
__device__ __forceinline__ void put_pair(bf16* p, size_t plane, float x,
                                         float y) {
  bf16 a[NP], b[NP];
  mma::planes<NP>(x, a);
  mma::planes<NP>(y, b);
#pragma unroll
  for (int k = 0; k < NP; ++k)
    *reinterpret_cast<uint32_t*>(p + k * plane) = pack(a[k], b[k]);
}

// Stages one (window, head) operand, rows [0, 64) x channels [0, dp), into
// its NP planes (plane stride `plane`, row stride ld); rows >= N and
// channels >= D are zeros.  A bf16 operand whose rows are 16-byte aligned
// (vec) copies asynchronously (the caller commits the group); anything
// else goes through registers, where an f32 value is split into its planes.
template <typename T, int NP>
__device__ __forceinline__ void stage(bf16* dst, size_t plane, int ld, int dp,
                                      const T* __restrict__ src, long long sn,
                                      int N, int D, bool vec) {
  const int cpr = dp / 8;  // 8-channel chunks a row
  for (int e = threadIdx.x; e < kMaxN * cpr; e += kThreads) {
    const int r = e / cpr, c = 8 * (e % cpr);
    bf16* d = dst + r * ld + c;
    const T* s = src + r * sn + c;
    const bool full = r < N && vec && c + 8 <= D;
    if constexpr (NP == 1) {
      if (full) {
        mma::cp_async16(d, s, true);
        continue;
      }
    }
    float v[8];
    if (full) {
      const float4 a = *reinterpret_cast<const float4*>(s);
      const float4 b = *reinterpret_cast<const float4*>(s + 4);
      v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
      v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        v[i] = r < N && c + i < D ? to_f(s[i]) : 0.f;
    }
    uint32_t w[NP][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bf16 a[NP], b[NP];
      mma::planes<NP>(v[2 * i], a);
      mma::planes<NP>(v[2 * i + 1], b);
#pragma unroll
      for (int k = 0; k < NP; ++k) w[k][i] = pack(a[k], b[k]);
    }
#pragma unroll
    for (int k = 0; k < NP; ++k)
      *reinterpret_cast<uint4*>(d + k * plane) =
          make_uint4(w[k][0], w[k][1], w[k][2], w[k][3]);
  }
}

// bm = bias[h] (+ mask[j]) over rows and keys < N, -inf at keys >= N (no
// weight), 0 at rows >= N (never stored).
__device__ __forceinline__ void stage_bias(float* bm,
                                           const float* __restrict__ bias_h,
                                           const float* __restrict__ mask_j,
                                           int N) {
  for (int e = threadIdx.x; e < kMaxN * kMaxN; e += kThreads) {
    const int r = e / kMaxN, c = e % kMaxN;
    float v = -INFINITY;
    if (c < N) {
      v = 0.f;
      if (r < N) {
        v = __ldg(bias_h + r * N + c);
        if (mask_j) v += __ldg(mask_j + r * N + c);
      }
    }
    bm[r * kBLD + c] = v;
  }
}

// The (w1, w2) = softmax(w) mix weights, (1, 0) for the dense softmax.
__device__ __forceinline__ void mix_weights(const float* __restrict__ w,
                                            float& w1, float& w2) {
  w1 = 1.f;
  w2 = 0.f;
  if (w) {
    const float e0 = expf(__ldg(w)), e1 = expf(__ldg(w + 1));
    const float sw = e0 + e1;
    w1 = e0 / sw;
    w2 = e1 / sw;
  }
}

// The passes of a split product (mma.cuh), smallest first: pass t takes
// plane pass_a(t) of A and pass_b(t) of B; NP planes take the last
// passes(NP) of (1, 1), (2, 0), (0, 2), (1, 0), (0, 1), (0, 0).  The
// tensor cores add into an f32 accumulator without rounding to nearest
// (the low bits are cut), so each pass runs over every k step before the
// next, and the small passes go in while the accumulator is small: the
// hi x hi pass last, its cuts about 2^-23 of the sum a k step.
__host__ __device__ constexpr int passes(int np) {
  return np == 1 ? 1 : np == 2 ? 3 : 6;
}
__host__ __device__ constexpr int pass_a(int t) {
  return t == 0 || t == 3 ? 1 : t == 1 ? 2 : 0;
}
__host__ __device__ constexpr int pass_b(int t) {
  return t == 0 || t == 4 ? 1 : t == 2 ? 2 : 0;
}

// acc = A B: A the warp's 16 rows of a [row][k] tile a, B^T the 64 rows of
// a [n][k] tile b (NP planes each, k16 steps over 16 DK): the warp's row
// block of a b^T (q k^T, dO v^T).
template <int NP, int DK>
__device__ __forceinline__ void rows_times_rows(float (&acc)[8][4],
                                                const bf16* a, const bf16* b,
                                                int ld, size_t plane) {
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int t = 6 - passes(NP); t < 6; ++t)
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      uint32_t fa[4];
      mma::frag_a<false>(fa, a + pass_a(t) * plane + 16 * warp * ld + 16 * kk,
                         ld);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t fb[4];
        mma::frag_b2<false>(fb, b + pass_b(t) * plane + 16 * jp * ld + 16 * kk,
                            ld);
        mma::mma16816(acc[2 * jp], fa, fb[0], fb[1]);
        mma::mma16816(acc[2 * jp + 1], fa, fb[2], fb[3]);
      }
    }
}

// The A fragment (16 x 16) of keys 16 kk .. 16 kk + 15 from accumulator
// tiles t0 (keys 16 kk ..) and t1 (16 kk + 8 ..), in NP planes: the
// FlashAttention-2 reuse, the scores never leave the registers.
template <int NP>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[NP][4],
                                         const float (&t0)[4],
                                         const float (&t1)[4]) {
  const float x[4][2] = {{t0[0], t0[1]}, {t0[2], t0[3]},
                         {t1[0], t1[1]}, {t1[2], t1[3]}};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    bf16 p[NP], q[NP];
    mma::planes<NP>(x[i][0], p);
    mma::planes<NP>(x[i][1], q);
#pragma unroll
    for (int k = 0; k < NP; ++k) a[k][i] = pack(p[k], q[k]);
  }
}

// o = P b over the 64 keys: P the warp's rows from registers (accumulator
// layout), b a [key][channel] tile of 16 DK channels (P v, dS k).
template <int NP, int DK>
__device__ __forceinline__ void regs_times_tile(float (&o)[2 * DK][4],
                                                const float (&p)[8][4],
                                                const bf16* b, int ld,
                                                size_t plane) {
#pragma unroll
  for (int j = 0; j < 2 * DK; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  uint32_t fa[4][NP][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    acc_to_a<NP>(fa[kk], p[2 * kk], p[2 * kk + 1]);
#pragma unroll
  for (int t = 6 - passes(NP); t < 6; ++t)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int jp = 0; jp < DK; ++jp) {
        uint32_t fb[4];
        mma::frag_b2<true>(fb, b + pass_b(t) * plane + 16 * kk * ld + 16 * jp,
                           ld);
        mma::mma16816(o[2 * jp], fa[kk][pass_a(t)], fb[0], fb[1]);
        mma::mma16816(o[2 * jp + 1], fa[kk][pass_a(t)], fb[2], fb[3]);
      }
}

// o = A^T b for the warp's 16 rows of A^T: A a [k][row] tile a (row stride
// lda, plane stride pa; the warp's rows are its columns 16 w ..), b a
// [k][channel] tile (ldb, pb) of 16 DK channels, over the first nk k16
// steps (P^T dO, dS^T q).
template <int NP, int DK>
__device__ __forceinline__ void cols_times_tile(float (&o)[2 * DK][4],
                                                const bf16* a, int lda,
                                                size_t pa, const bf16* b,
                                                int ldb, size_t pb, int nk) {
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < 2 * DK; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
#pragma unroll
  for (int t = 6 - passes(NP); t < 6; ++t)
#pragma unroll
    for (int ki = 0; ki < 4; ++ki) {
      if (ki >= nk) continue;
      uint32_t fa[4];
      mma::frag_a<true>(fa, a + pass_a(t) * pa + 16 * ki * lda + 16 * warp,
                        lda);
#pragma unroll
      for (int jp = 0; jp < DK; ++jp) {
        uint32_t fb[4];
        mma::frag_b2<true>(fb, b + pass_b(t) * pb + 16 * ki * ldb + 16 * jp,
                           ldb);
        mma::mma16816(o[2 * jp], fa, fb[0], fb[1]);
        mma::mma16816(o[2 * jp + 1], fa, fb[2], fb[3]);
      }
    }
}

// The warp's scores s = scale (q k^T) + bm: the scale on the f32 products,
// as the TPU kernel scales q in f32.
template <int NP, int DK>
__device__ __forceinline__ void scores(float (&s)[8][4], const bf16* qs,
                                       const bf16* ks, int ld, size_t plane,
                                       const float* bm, float scale) {
  rows_times_rows<NP, DK>(s, qs, ks, ld, plane);
  const int lane = threadIdx.x & 31;
  const int r0 = 16 * (threadIdx.x >> 5) + (lane >> 2), c0 = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float2 b = *reinterpret_cast<const float2*>(
          bm + (r0 + 8 * hf) * kBLD + 8 * j + c0);
      s[j][2 * hf] = fmaf(s[j][2 * hf], scale, b.x);
      s[j][2 * hf + 1] = fmaf(s[j][2 * hf + 1], scale, b.y);
    }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// sm = softmax of each of the lane's two rows of s, max subtracted (a
// row's 64 entries sit in a quad of lanes).
__device__ __forceinline__ void softmax_rows(float (&sm)[8][4],
                                             const float (&s)[8][4]) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      m = fmaxf(m, fmaxf(s[j][2 * hf], s[j][2 * hf + 1]));
    m = quad_max(m);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 2 * hf; e < 2 * hf + 2; ++e) {
        sm[j][e] = expf(s[j][e] - m);
        sum += sm[j][e];
      }
    const float inv = 1.f / quad_sum(sum);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 2 * hf; e < 2 * hf + 2; ++e) sm[j][e] *= inv;
  }
}

// Two consecutive values rounded to T, one 4- or 8-byte store.
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The warp's 16 x 16 DK accumulators o (rows r0 .. r0 + 15), times mul and
// rounded to T, into dst (row stride sn; rows < N, channels < D) through
// the warp's staging rows stg (16 x ld of T), so that each row leaves in
// 16-byte pieces where dst's rows are 16-byte aligned (vec).
template <typename T, int DK>
__device__ __forceinline__ void store_tile(const float (&o)[2 * DK][4],
                                           float mul, T* stg, int ld,
                                           T* __restrict__ dst, long long sn,
                                           int r0, int N, int D, bool vec) {
  const int lane = threadIdx.x & 31;
  const int rr = lane >> 2, cc = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 2 * DK; ++j)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      store2(stg + (rr + 8 * hf) * ld + 8 * j + cc, o[j][2 * hf] * mul,
             o[j][2 * hf + 1] * mul);
  __syncwarp();
  constexpr int kEl = 16 / sizeof(T);  // elements in 16 bytes
  constexpr int kCpr = 16 * DK / kEl;  // 16-byte pieces a row
  for (int e = lane; e < 16 * kCpr; e += 32) {
    const int r = e / kCpr, c = (e % kCpr) * kEl;
    if (r0 + r >= N || c >= D) continue;
    T* d = dst + (r0 + r) * sn + c;
    const T* s = stg + r * ld + c;
    if (vec && c + kEl <= D) {
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s);
    } else {
      for (int i = 0; i < kEl && c + i < D; ++i) d[i] = s[i];
    }
  }
  __syncwarp();
}

// Row length, in T, of a warp's output staging rows: 16 DK channels plus 16
// bytes.
template <typename T, int DK>
__host__ __device__ constexpr int stage_ld() {
  return 16 * DK + 16 / (int)sizeof(T);
}

// 16-column tiles of a half of the head width: the output products' step.
__host__ __device__ constexpr int out_dk(int dk) { return dk < 4 ? dk : 4; }

// The warp's rows of P b (P in registers, the regs_times_tile layout) over
// the 16 DK channels of b, a half (out_dk tiles) at a time, each half times
// mul and stored to dst's channels (store_tile; stg holds the warp's
// stage_ld<T, out_dk(DK)> rows): P v, dS k.
template <typename T, int NP, int DK>
__device__ __forceinline__ void rows_out(const float (&p)[8][4],
                                         const bf16* b, int ld, size_t plane,
                                         float mul, T* stg,
                                         T* __restrict__ dst, long long sn,
                                         int r0, int N, int D, bool vec) {
  constexpr int OD = out_dk(DK);
#pragma unroll
  for (int hh = 0; hh < DK / OD; ++hh) {
    float o[2 * OD][4];
    regs_times_tile<NP, OD>(o, p, b + 16 * OD * hh, ld, plane);
    store_tile<T, OD>(o, mul, stg, stage_ld<T, OD>(), dst + 16 * OD * hh, sn,
                      r0, N, D - 16 * OD * hh, vec);
  }
}

// The warp's keys' rows of A^T b (cols_times_tile: a [k][row] plane, b a
// [k][channel] tile of 16 DK channels, over nk k16 steps), a half at a
// time, each times mul and stored: P^T dO, dS^T q.
template <typename T, int NP, int DK>
__device__ __forceinline__ void cols_out(const bf16* a, int lda, size_t pa,
                                         const bf16* b, int ldb, size_t pb,
                                         int nk, float mul, T* stg,
                                         T* __restrict__ dst, long long sn,
                                         int r0, int N, int D, bool vec) {
  constexpr int OD = out_dk(DK);
#pragma unroll
  for (int hh = 0; hh < DK / OD; ++hh) {
    float o[2 * OD][4];
    cols_times_tile<NP, OD>(o, a, lda, pa, b + 16 * OD * hh, ldb, pb, nk);
    store_tile<T, OD>(o, mul, stg, stage_ld<T, OD>(), dst + 16 * OD * hh, sn,
                      r0, N, D - 16 * OD * hh, vec);
  }
}

// DK of a head width: ceil(d / 16) up to 4, else 8.
__host__ __device__ constexpr int tiles_of(int d) {
  return (d + 15) / 16 <= 4 ? (d + 15) / 16 : 8;
}

}  // namespace wattn
}  // namespace uir
