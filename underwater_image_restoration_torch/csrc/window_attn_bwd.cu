// Window attention backward: the vector-Jacobian product of
// csrc/window_attn.cu's function for the cotangent dO, recomputed from the
// inputs (the attention is never stored):
//   S = scale (q k^T) + bias[head] (+ mask),  sm = softmax_row(S),
//   P = w1 sm + w2 relu(S)^2,  (w1, w2) = softmax(w)  ((1, 0) when dense)
//   dV = P^T dO,  dP = dO V^T,
//   dS = w1 sm (dP - rowsum(dP sm)) + 2 w2 relu(S) dP,
//   dq = scale dS k,  dk = scale dS^T q,  dbias[head] = sum over windows of
//   dS,  dw = w1 w2 (S1 - S2) (1, -1) with S1 = sum dP sm, S2 = sum dP
//   relu(S)^2 (the Jacobian of softmax(w)); the mask gets no gradient.
//
// Replaces the backward of the JAX package's window attention,
// ops/pallas.py:191 _wa_bwd, which recomputes through the plain core under
// jax.vjp (no pallas_call): the same algorithm, as one kernel.
//
// What bounds it on an H100.  Per (window, head) it reads q, k, v and dO
// and writes dq, dk and dv (7 N d elements) and does five N x N x d
// products (10 N^2 d flops), 46 flops a byte in bf16 at N = 64, d = 32:
// bound by bytes, like the forward.  Autograd through the plain version
// instead makes some twenty passes over (B', heads, N, N) f32 tensors.
//
// Design (the stages in csrc/wattn.cuh, shared with the forward).  A block
// of four warps owns one head and walks a planned run of windows
// (ops/window_attention.py bwd_plan: a fixed number of blocks a head, from
// the SM count), the bias and mask tile staged as in the forward, q, k, v
// and dO of the next window copied by cp.async behind the current one.
// Warp w recomputes its 16 query rows' scores, softmax and P in registers,
// writes P to shared memory, takes dP = dO V^T on the tensor cores, dS in
// registers (row sums by quad shuffles), writes dS to shared memory, and
// dq = dS k with dS's A fragments from the registers; after a barrier it
// takes dV = P^T dO and dK = dS^T q for keys 16 w .. 16 w + 15, the
// transposed operands loaded by ldmatrix.trans from the P and dS tiles.
// All five products run on mma.sync m16n8k16 on the forward's operand
// planes (wattn.cuh planes): one bf16 plane a bf16 operand (P and dS
// rounded to bf16); three planes an f32 one (P and dS too), six passes a
// product.
//
// Head widths up to 128 (wattn.cuh tiles_of).  S and dP sum over the whole
// width in one accumulator (each pass over every k step, as at d <= 64);
// dq, dK and dV walk it in halves of at most 64 channels (wattn.cuh
// rows_out, cols_out), so a warp's registers stay those of d = 64.  A bf16
// call at d = 128 holds q, k, v and dO of two windows (about 199 KiB a
// block, one block an SM).  An f32 one cannot hold all four (three planes
// of 136-wide rows: 204 KiB before P and dS), so it runs three phases a
// window over two operand slots (phased): dO and v, then dP; q and k, then
// S, P, dS, dq and dK; dO again, then dV.  It reads dO twice (an eighth
// more bytes), and its sums run in the order of the unphased kernel.  Every
// block count comes from smem_bytes (ops/window_attention.py
// bwd_smem_bytes).
//
// dbias and dw in a fixed order, no float atomics: each lane adds its own
// dS entries into the block's f32 dbias tile in shared memory, window
// after window; each lane sums its dP sm and dP relu(S)^2 terms of a
// window in f32 and adds them to two f64 sums (S1 - S2 cancels).  At the
// end the block writes its tile and its two sums (lanes and warps in a
// fixed tree) to its own row of the workspace; reduce_rows (grad.cuh) sums
// the dbias rows in block order and one warp sums the f64 rows in a fixed
// order and applies the Jacobian of softmax(w).  Two calls give the same
// bits.
#include <cstdint>

#include "grad.cuh"
#include "wattn.cuh"

namespace {

namespace mm = uir::mma;
namespace wa = uir::wattn;
using bf16 = __nv_bfloat16;
using wa::kThreads;
using wa::Strides;
using wa::Walk;

constexpr int kPLD = mm::pad_ld(wa::kMaxN);  // bf16 row of a P / dS plane

// f32 operands at d > 64 (three planes of 136-wide rows) cannot all four
// stay in shared memory (q, k, v and dO would take 204 KiB of the 227 a
// block may have): such a call stages two at a time, in three phases a
// window (phased below).
template <typename T, int DK>
__host__ __device__ constexpr bool phased() {
  return wa::planes<T>() > 1 && DK > 4;
}

// Operand tiles a block holds: q, k, v and dO of NBUF windows, or two.
template <typename T, int DK>
__host__ __device__ constexpr int slots() {
  return phased<T, DK>() ? 2 : (wa::planes<T>() == 1 ? 2 : 1) * 4;
}

// The block's shared memory (mirrored by ops/window_attention.py
// bwd_smem_bytes): the bias and mask tile, the dbias tile, the operand
// slots, the P and dS planes, four warps' staging rows of a half width and
// the f64 reduction.
template <typename T, int DK>
constexpr size_t smem_bytes() {
  constexpr int NP = wa::planes<T>();
  return 2 * wa::kBiasFloats * sizeof(float) +
         (size_t)slots<T, DK>() * NP * wa::kMaxN * mm::pad_ld(16 * DK) *
             sizeof(bf16) +
         (size_t)2 * NP * wa::kMaxN * kPLD * sizeof(bf16) +
         (size_t)4 * 16 * wa::stage_ld<T, wa::out_dk(DK)>() * sizeof(T) +
         8 * sizeof(double);
}

struct Grads {
  void *dq, *dk, *dv;  // null where not wanted
  Strides sdq, sdk, sdv;
  float* part;         // [G][H][N N] dbias rows, or null
  double* sums;        // [G][H][2] rows of (S1, S2), or null
};

template <typename T, int DK>
__global__ void __launch_bounds__(kThreads)
    window_attn_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ dO,
                           Strides sq, Strides sk, Strides sv, Strides sg,
                           Grads gr, const float* __restrict__ bias,
                           const float* __restrict__ mask,
                           const float* __restrict__ w, Walk wk, float scale,
                           unsigned vec) {
  constexpr int NP = wa::planes<T>();
  constexpr bool PHASED = phased<T, DK>();
  constexpr int NBUF = NP == 1 ? 2 : 1;
  constexpr int LD = mm::pad_ld(16 * DK);
  constexpr size_t PLANE = (size_t)wa::kMaxN * LD;
  constexpr size_t OPND = NP * PLANE;
  constexpr size_t PPLANE = (size_t)wa::kMaxN * kPLD;
  constexpr int SLD = wa::stage_ld<T, wa::out_dk(DK)>();
  extern __shared__ __align__(16) unsigned char smem[];
  float* bm = reinterpret_cast<float*>(smem);
  float* db = bm + wa::kBiasFloats;  // the block's dbias sums
  bf16* tiles = reinterpret_cast<bf16*>(db + wa::kBiasFloats);
  bf16* ps = tiles + slots<T, DK>() * OPND;  // P planes
  bf16* ds = ps + NP * PPLANE;               // dS planes
  T* stg0 = reinterpret_cast<T*>(ds + NP * PPLANE);
  double* red = reinterpret_cast<double*>(stg0 + 4 * 16 * SLD);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  T* stg = stg0 + warp * 16 * SLD;
  const int h = blockIdx.x / wk.G, g = blockIdx.x % wk.G;
  const int i0 = g * wk.per, i1 = min(wk.BQ, i0 + wk.per);
  const bool rows = 16 * warp < wk.N;
  const int r0 = 16 * warp + (lane >> 2), c0 = 2 * (lane & 3);
  const int nk = (wk.N + 15) / 16;  // key k16 steps of the transposed ones
  float w1, w2;
  wa::mix_weights(w, w1, w2);
  const bool sums = gr.sums && w;
  double acc1 = 0.0, acc2 = 0.0;
  if (gr.part)
    for (int e = threadIdx.x; e < wa::kBiasFloats; e += kThreads) db[e] = 0.f;

  // operand t (0 q, 1 k, 2 v, 3 dO) of window i into slot `slot`
  auto stage_op = [&](int t, int i, bf16* slot) {
    const long long b = (long long)(i % wk.T) * wk.nW + i / wk.T;
    const T* src = t == 0 ? q : t == 1 ? k : t == 2 ? v : dO;
    const Strides s = t == 0 ? sq : t == 1 ? sk : t == 2 ? sv : sg;
    wa::stage<T, NP>(slot, PLANE, LD, 16 * DK, src + b * s.b + h * s.h, s.n,
                     wk.N, wk.D, vec & (1u << t));
  };
  auto load_window = [&](int i, int buf) {
    bf16* t = tiles + buf * 4 * OPND;
#pragma unroll
    for (int o = 0; o < 4; ++o) stage_op(o, i, t + o * OPND);
    mm::cp_async_commit();
  };

  int jcur = -1;
  if (!PHASED && NBUF == 2 && i0 < i1) load_window(i0, 0);
  for (int i = i0; i < i1; ++i) {
    const int buf = NBUF == 2 ? (i - i0) & 1 : 0;
    // slots: q, k, v, dO of the window, or (phased) A and B
    const bf16* tq = tiles + buf * 4 * OPND;
    const bf16* tk = tq + OPND;
    const bf16* tv = tq + 2 * OPND;
    const bf16* tg = tq + 3 * OPND;
    float dp[8][4];
    if constexpr (PHASED) {
      // phase 1: dP = dO v^T from slots A (dO) and B (v)
      stage_op(3, i, tiles);
      stage_op(2, i, tiles + OPND);
      tq = tg = tiles;
      tk = tiles + OPND;
    } else if (NBUF == 1) {
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
    const long long b = (long long)(i % wk.T) * wk.nW + j;
    if constexpr (PHASED) {
      if (rows)
        wa::rows_times_rows<NP, DK>(dp, tiles, tiles + OPND, LD, PLANE);
      __syncthreads();
      // phase 2: q and k into slots A and B
      stage_op(0, i, tiles);
      stage_op(1, i, tiles + OPND);
      __syncthreads();
    }
    if (rows) {
      float s[8][4], sm[8][4];
      wa::scores<NP, DK>(s, tq, tk, LD, PLANE, bm, scale);
      wa::softmax_rows(sm, s);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[jj][e] = fmaxf(s[jj][e], 0.f);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int e = 2 * hf;
          wa::put_pair<NP>(ps + (r0 + 8 * hf) * kPLD + 8 * jj + c0, PPLANE,
                           sm[jj][e] * w1 + s[jj][e] * s[jj][e] * w2,
                           sm[jj][e + 1] * w1 +
                               s[jj][e + 1] * s[jj][e + 1] * w2);
        }
      }
      // s now holds relu(S)
      if constexpr (!PHASED)
        wa::rows_times_rows<NP, DK>(dp, tg, tv, LD, PLANE);
      float t1 = 0.f, t2 = 0.f, rs[2] = {0.f, 0.f};
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float a = dp[jj][e] * sm[jj][e];
          rs[e >> 1] += a;
          t1 += a;
          t2 += dp[jj][e] * s[jj][e] * s[jj][e];
        }
      if (sums) {
        acc1 += (double)t1;
        acc2 += (double)t2;
      }
      rs[0] = wa::quad_sum(rs[0]);
      rs[1] = wa::quad_sum(rs[1]);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[jj][e] = w1 * sm[jj][e] * (dp[jj][e] - rs[e >> 1]) +
                      2.f * w2 * s[jj][e] * dp[jj][e];
      // dp now holds dS
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int off = (r0 + 8 * hf) * wa::kBLD + 8 * jj + c0;
          if (gr.part) {
            float2 a = *reinterpret_cast<float2*>(db + off);
            a.x += dp[jj][2 * hf];
            a.y += dp[jj][2 * hf + 1];
            *reinterpret_cast<float2*>(db + off) = a;
          }
          wa::put_pair<NP>(ds + (r0 + 8 * hf) * kPLD + 8 * jj + c0, PPLANE,
                           dp[jj][2 * hf], dp[jj][2 * hf + 1]);
        }
      if (gr.dq) {
        const Strides& so = gr.sdq;
        wa::rows_out<T, NP, DK>(dp, tk, LD, PLANE, scale, stg,
                                static_cast<T*>(gr.dq) + b * so.b + h * so.h,
                                so.n, 16 * warp, wk.N, wk.D, vec & 16);
      }
    }
    __syncthreads();
    // keys 16 w .. 16 w + 15: A = dS^T (or P^T) from the [query][key]
    // planes, B = q (or dO) rows, over the queries; the P and dS rows of a
    // warp without queries were never written, and nk stops before them
    if (rows && gr.dk) {
      const Strides& so = gr.sdk;
      wa::cols_out<T, NP, DK>(ds, kPLD, PPLANE, tq, LD, PLANE, nk, scale,
                              stg,
                              static_cast<T*>(gr.dk) + b * so.b + h * so.h,
                              so.n, 16 * warp, wk.N, wk.D, vec & 32);
    }
    if constexpr (PHASED) {
      // phase 3: dO again into slot A
      __syncthreads();
      if (gr.dv) stage_op(3, i, tiles);
      __syncthreads();
    }
    if (rows && gr.dv) {
      const Strides& so = gr.sdv;
      wa::cols_out<T, NP, DK>(ps, kPLD, PPLANE, tg, LD, PLANE, nk, 1.f, stg,
                              static_cast<T*>(gr.dv) + b * so.b + h * so.h,
                              so.n, 16 * warp, wk.N, wk.D, vec & 64);
    }
    __syncthreads();
  }

  // the block's row of the workspace
  const size_t row = (size_t)g * wk.H + h;
  if (gr.part) {
    float* dst = gr.part + row * wk.N * wk.N;
    for (int e = threadIdx.x; e < wk.N * wk.N; e += kThreads)
      dst[e] = db[(e / wk.N) * wa::kBLD + e % wk.N];
  }
  if (sums) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc1 += __shfl_xor_sync(0xffffffffu, acc1, off);
      acc2 += __shfl_xor_sync(0xffffffffu, acc2, off);
    }
    if (lane == 0) {
      red[2 * warp] = acc1;
      red[2 * warp + 1] = acc2;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      gr.sums[2 * row] = ((red[0] + red[2]) + red[4]) + red[6];
      gr.sums[2 * row + 1] = ((red[1] + red[3]) + red[5]) + red[7];
    }
  }
}

// dw = w1 w2 (S1 - S2) (1, -1) from the rows of (S1, S2), summed by one warp
// in a fixed order.
__global__ void window_attn_dw_kernel(const double* __restrict__ sums,
                                      int rows, const float* __restrict__ w,
                                      float* __restrict__ dw) {
  const int l = threadIdx.x;
  double a = 0.0, b = 0.0;
  for (int r = l; r < rows; r += 32) {
    a += sums[2 * r];
    b += sums[2 * r + 1];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
  if (l == 0) {
    const double e0 = exp((double)w[0]), e1 = exp((double)w[1]);
    const double p0 = e0 / (e0 + e1), p1 = e1 / (e0 + e1);
    const double d = p0 * p1 * (a - b);
    dw[0] = (float)d;
    dw[1] = (float)-d;
  }
}

template <typename T, int DK>
int launch(const void* q, const void* k, const void* v, const void* dO,
           Strides sq, Strides sk, Strides sv, Strides sg, const Grads& gr,
           const float* bias, const float* mask, const float* w, Walk wk,
           float scale, unsigned vec, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, DK>();
  auto kern = window_attn_bwd_kernel<T, DK>;
  static const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<wk.H * wk.G, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dO), sq, sk, sv, sg,
      gr, bias, mask, w, wk, scale, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int DK, const void* q, const void* k, const void* v,
             const void* dO, Strides sq, Strides sk, Strides sv, Strides sg,
             const Grads& gr, const float* bias, const float* mask,
             const float* w, Walk wk, float scale, unsigned vec,
             cudaStream_t st) {
  switch (DK) {
    case 1:
      return launch<T, 1>(q, k, v, dO, sq, sk, sv, sg, gr, bias, mask, w, wk,
                          scale, vec, st);
    case 2:
      return launch<T, 2>(q, k, v, dO, sq, sk, sv, sg, gr, bias, mask, w, wk,
                          scale, vec, st);
    case 3:
      return launch<T, 3>(q, k, v, dO, sq, sk, sv, sg, gr, bias, mask, w, wk,
                          scale, vec, st);
    case 4:
      return launch<T, 4>(q, k, v, dO, sq, sk, sv, sg, gr, bias, mask, w, wk,
                          scale, vec, st);
    default:
      return launch<T, 8>(q, k, v, dO, sq, sk, sv, sg, gr, bias, mask, w, wk,
                          scale, vec, st);
  }
}

}  // namespace

// strides: 21 values, (window, head, token) of q, k, v, dO, dq, dk and dv,
// in elements.  dq, dk, dv null where not wanted; dbias (H, N, N) f32 and
// part ([G][H][N N] f32, G = ceil(BQ / per)) both null or both given; dw
// (2,) f32 and sums ([G][H][2] f64) both null or both given, and only with
// w (sparse).  mask and w may be null.  per: windows a block walks
// (ops/window_attention.py bwd_plan).  vec: bit t set where tensor t of
// (q, k, v, dO, dq, dk, dv) has 16-byte aligned rows.  Launches the
// kernel, then reduce_rows where dbias is wanted and the dw step where dw
// is.
extern "C" int uir_window_attn_bwd(
    const void* q, const void* k, const void* v, const void* dO, void* dq,
    void* dk, void* dv, const long long* strides, const void* bias,
    const void* mask, const void* w, void* part, void* sums, void* dbias,
    void* dw, int BQ, int H, int N, int D, int nW, int per, float scale,
    int bf16, int vec, void* stream) {
  if (N < 1 || N > wa::kMaxN || D < 1 || D > wa::kMaxD || BQ < 1 || H < 1 ||
      per < 1 || (mask && (nW < 1 || BQ % nW)) || !part != !dbias ||
      !sums != !dw || (dw && !w))
    return (int)cudaErrorInvalidValue;
  if (!mask) nW = 1;
  Strides s[7];
  for (int t = 0; t < 7; ++t)
    s[t] = Strides{strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
  const Walk wk{BQ, H, N, D, nW, BQ / nW, per, (BQ + per - 1) / per};
  const Grads gr{dq, dk, dv, s[4], s[5], s[6], static_cast<float*>(part),
                 static_cast<double*>(sums)};
  const auto* bi = static_cast<const float*>(bias);
  const auto* mk = static_cast<const float*>(mask);
  const auto* ww = static_cast<const float*>(w);
  auto st = static_cast<cudaStream_t>(stream);
  const int DK = wa::tiles_of(D);
  int err = bf16 ? dispatch<__nv_bfloat16>(DK, q, k, v, dO, s[0], s[1], s[2],
                                           s[3], gr, bi, mk, ww, wk, scale,
                                           (unsigned)vec, st)
                 : dispatch<float>(DK, q, k, v, dO, s[0], s[1], s[2], s[3],
                                   gr, bi, mk, ww, wk, scale, (unsigned)vec,
                                   st);
  if (err) return err;
  if (dbias) {
    err = (int)uir::reduce_rows(static_cast<const float*>(part),
                                static_cast<float*>(dbias), wk.G,
                                H * N * N, st);
    if (err) return err;
  }
  if (dw) {
    window_attn_dw_kernel<<<1, 32, 0, st>>>(static_cast<const double*>(sums),
                                            wk.G * H, ww,
                                            static_cast<float*>(dw));
    err = (int)cudaGetLastError();
  }
  return err;
}
