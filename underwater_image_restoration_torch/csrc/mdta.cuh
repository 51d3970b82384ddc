// Stages shared by the LN + MDTA forward (csrc/ln_mdta.cu) and backward
// (csrc/ln_mdta_bwd.cu), both staged over the batch in image slices with
// pixel-major ([pixel][channel]) intermediates in one workspace: the prep
// (LN statistics and round(LN x) planes), the weights' bf16 planes, A from
// an image's stats, the depthwise taps pass, the product epilogues, and the
// launch sequences of the forward chain (u and the taps; outs, out, u_vf,
// vf and outf).  Each library wraps the device functions in kernels, and the
// epilogues in types, of its own names, so a profile tells the forward's
// launches from the backward's; the sequences take those as arguments.
//
// Rounding points (the TPU kernels'): LN, q, k, outs, out and outf round to
// T; u, v, u_vf and vf stay f32.  In bf16 a value rounded to T is exactly
// bf16 (NPT = 1 plane) and an f32 value (a weight, A, v, vf) a hi/lo pair
// (NFT = 2), so a product takes 1 or 2 passes; in f32 every value is three
// planes (mma.cuh), 6 passes: the backward's dtemp cancels too far for
// hi/lo pairs, and the forward's gram sums over up to 65536 pixels.
#pragma once

#include <type_traits>

#include "gemm.cuh"

// a failed launch returns its error from a function returning cudaError_t
#define UIR_MDTA_TRY(call)                 \
  do {                                     \
    const cudaError_t e_ = (call);         \
    if (e_ != cudaSuccess) return e_;      \
  } while (0)

namespace uir {
namespace mdta {

namespace mm = uir::mma;
namespace gm = uir::gemm;
using bf16 = __nv_bfloat16;
using gm::kThreads;
using gm::Opnd;
using gm::Tile;
using gm::warp_sum;

constexpr int PT = 32;      // pixels a block of the prep (and of dLN)
constexpr int DW_T = 128;   // threads (channel pairs) a block of a taps pass
constexpr int DW_W = 64;    // columns a thread of a taps pass walks
constexpr int AHEAD = 4;    // columns a taps pass loads ahead
constexpr int MAX_C = 256;  // widest C (the backward's dLN holds C a block)
constexpr int MAX_SPLITS_A = 32;  // pixel ranges an image of a K = pixels
                                  // per-image product (the gram, dA)

// bf16 planes of a value rounded to T (NPT) and of an f32 value (NFT)
template <typename T>
constexpr int NPT = std::is_same<T, float>::value ? 3 : 1;
template <typename T>
constexpr int NFT = std::is_same<T, float>::value ? 3 : 2;

// the product tiles: M = pixels, A a pixel-major plane set; B a weight
// stored [out][in] (TPn: read as W^T), [in][out] or a per-image A (TPt,
// TPf: f32 A operand), BN outputs wide (64, or 16 and 32 for the narrow
// levels, a warp a row of 16 pixels); K = pixels (TK): A and B stored
// [pixel][channel], a long k loop of four stages whose k tiles add
// round-to-nearest (gemm.cuh Sums)
template <int NP, int NF>
using TPn = Tile<128, 64, 4, 2, false, false, NP, NF>;
template <int NP, int NF, int BN = 64>
using TPt = Tile<128, BN, BN < 64 ? 8 : 4, BN < 64 ? 1 : 2, false, true, NP,
                 NF>;
template <int NF, int BN = 64>
using TPf = Tile<128, BN, BN < 64 ? 8 : 4, BN < 64 ? 1 : 2, false, false, NF,
                 NF>;
template <int NPA, int NPB>
using TK = Tile<64, 64, 2, 4, true, true, NPA, NPB, 4, true>;

// the f32 weights, as their parameters store them: w_qkv (C, 3C), w_po
// (C, C), w_kv (C, 2C) (its vf half read in place), w_pof (C, C), the taps
// (3, 3, 3C) and (3, 3, 2C), the temperatures (heads)
struct Weights {
  const float *qkv, *po, *kv, *pof, *tqkv, *tkv, *temp;
};

// The planes of n values from p (plane stride n), unused ones aliased.
inline Opnd planes(const bf16* p, size_t n, int np) {
  return Opnd{{p, np > 1 ? p + n : p, np > 2 ? p + 2 * n : p}, 0, 0};
}

// A pixel-major piece of a slice of P pixels as np planes [pixel][ld]
// (plane stride P ld), an image's HW pixels zs apart.
inline Opnd pixel_planes(const bf16* p, int np, int P, int ld, int HW) {
  Opnd o = planes(p, (size_t)P * ld, np);
  o.ld = ld;
  o.zs = (long long)HW * ld;
  return o;
}

// ---- the prep

// The sum over groups of lp lanes (16 or 32) of a warp: gemm.cuh warp_sum's
// tree for 32.
__device__ __forceinline__ float group_sum(float v, int lp) {
  for (int off = lp / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// LN statistics (with stats) and LN = round(LN x) into NP planes [pixel][C]
// of PT pixels a block; with dy, dy into planes like LN's.  x and dy are
// read through a shared tile [PT][C + 1] so the NCHW loads coalesce.
template <typename T, int NP>
__device__ void prep(const T* __restrict__ x, const T* __restrict__ dy,
                     const float* __restrict__ scale,
                     const float* __restrict__ bias, float2* __restrict__ stats,
                     bf16* __restrict__ ln, bf16* __restrict__ dyp, int P,
                     int HW, int C, float eps) {
  extern __shared__ float tile[];  // [PT][C + 1]
  const int m0 = blockIdx.x * PT, CS = C + 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t lo = (size_t)P * C;
  // a warp a channel, lanes over pixels: coalesced in (B, C, H, W)
  auto load = [&](const T* src) {
    const int m = m0 + lane;
    const size_t at = m < P ? (size_t)(m / HW) * C * HW + m % HW : 0;
    for (int c = warp; c < C; c += kThreads / 32)
      tile[lane * CS + c] = m < P ? to_f(src[at + (size_t)c * HW]) : 0.f;
  };
  load(x);
  __syncthreads();
  // lanes over channels: a warp a pixel, or, at C <= 16, a half-warp a
  // pixel (the warp's sum tree would add lanes holding zeros first, an
  // exact step, so the half-warp's tree gives the same bits)
  const int lp = C <= 16 ? 16 : 32, sub = lane / lp, cl = lane % lp;
  // unrolled: the pixels' shuffle chains interleave
#pragma unroll 4
  for (int r0 = warp * (32 / lp); r0 < PT && m0 + r0 < P;
       r0 += kThreads / lp) {
    const int r = r0 + sub;
    const bool ok = r < PT && m0 + r < P;
    const float* xp = tile + r * CS;
    float s = 0.f;
    if (ok)
      for (int c = cl; c < C; c += lp) s += xp[c];
    const float mean = group_sum(s, lp) / C;
    float v = 0.f;
    if (ok)
      for (int c = cl; c < C; c += lp) {
        const float d = xp[c] - mean;
        v += d * d;
      }
    const float rstd = rsqrtf(group_sum(v, lp) / C + eps);
    if (!ok) continue;
    if (stats != nullptr && cl == 0) stats[m0 + r] = make_float2(mean, rstd);
    for (int c = cl; c < C; c += lp)
      mm::put<NP>(ln, lo, (size_t)(m0 + r) * C + c,
                  round_to<T>((xp[c] - mean) * rstd * __ldg(scale + c) +
                              __ldg(bias + c)));
  }
  if (dy == nullptr) return;
  __syncthreads();
  load(dy);
  __syncthreads();
  for (int r = warp; r < PT && m0 + r < P; r += kThreads / 32)
    for (int c = lane; c < C; c += 32)
      mm::put<NP>(dyp, lo, (size_t)(m0 + r) * C + c, tile[r * CS + c]);
}

inline size_t prep_smem(int C) { return PT * (C + 1) * sizeof(float); }

// ---- the weights' planes, once a call

// The NF bf16 planes of four f32 weights (w_qkv, w_po, w_kv, w_pof) into
// the workspace: plane k of weight i at out + off[i] + k * n[i].
struct WeightSet {
  const float* w[4];
  int n[4];
  size_t off[4];
};

inline WeightSet weight_set(const Weights& wt, int C, int NF) {
  const size_t cc = (size_t)C * C;
  return WeightSet{{wt.qkv, wt.po, wt.kv, wt.pof},
                   {3 * C * C, C * C, 2 * C * C, C * C},
                   {0, NF * 3 * cc, NF * 4 * cc, NF * 6 * cc}};
}

// grid (ceil(3 C^2 / kThreads), 4)
template <int NF>
__device__ void weight_planes(const WeightSet& ws, bf16* __restrict__ out) {
  const int i = blockIdx.y;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < ws.n[i];
       e += gridDim.x * blockDim.x)
    mm::put<NF>(out + ws.off[i], ws.n[i], e, __ldg(ws.w[i] + e));
}

// weight i of the set as an operand: its rows cols wide, from column off
inline Opnd weight(const bf16* wts, const WeightSet& ws, int i, int cols,
                   int off, int NF) {
  Opnd o = planes(wts + ws.off[i] + off, ws.n[i], NF);
  o.ld = cols;
  return o;
}

// ---- the attention matrix of an image

// A [C][C] at a32 + base, block-diagonal (zero outside the heads), f32 and
// as NF planes at ap + base (plane stride lo): A = softmax(temp G rq rk^T)
// a head, rq = rsqrt(max(Sq, 1e-24)) (fused_attn.py:92 _attn_from_stats),
// from the image's stats st: gram [C][CPH], Sq [C], Sk [C].  A thread a
// row finds its softmax within the head, then the block writes the matrix,
// consecutive threads on consecutive entries.  Ends synchronized.
template <int CPH, int NF>
__device__ void attention(const float* st, const float* __restrict__ temp,
                          float* __restrict__ a32, bf16* __restrict__ ap,
                          size_t lo, size_t base, int C) {
  __shared__ float rows[MAX_C * CPH];  // [C][CPH]: each row within its head
  const int CC = C * CPH;
  for (int i = threadIdx.x; i < C; i += blockDim.x) {
    const int h = i / CPH;
    const float rq = rsqrtf(fmaxf(st[CC + i], 1e-24f));
    const float t = temp[h];
    float a[CPH];
    float m = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < CPH; ++jj) {
      const float rk = rsqrtf(fmaxf(st[CC + C + h * CPH + jj], 1e-24f));
      a[jj] = st[i * CPH + jj] * rq * rk * t;
      m = fmaxf(m, a[jj]);
    }
    float s = 0.f;
#pragma unroll
    for (int jj = 0; jj < CPH; ++jj) {
      a[jj] = expf(a[jj] - m);
      s += a[jj];
    }
#pragma unroll
    for (int jj = 0; jj < CPH; ++jj) rows[i * CPH + jj] = a[jj] / s;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < C * C; e += blockDim.x) {
    const int i = e / C, j = e % C;
    const float v = i / CPH == j / CPH ? rows[i * CPH + j % CPH] : 0.f;
    a32[base + e] = v;
    mm::put<NF>(ap, lo, base + e, v);
  }
  __syncthreads();
}

// ---- product epilogues (each library names its own subclasses)

// f32 [row][ld]; row = batch * zrows + m
struct F32Out {
  float* out;
  int ld, M, N;
  long long zrows;
  __device__ void operator()(const float* o, int l, int bm, int bn, int m0,
                             int n0, int, int, int batch) const {
    float* ob = out + batch * zrows * ld;
    gm::for_pairs(o, l, bm, bn, m0, n0, M, N,
                  [&](int m, int n, float v0, float v1) {
                    gm::store2(ob, (size_t)m * ld + n, v0, v1);
                  });
  }
};

// round to T, into NP planes [row][ld]; row = batch * zrows + m
template <typename T, int NP>
struct RoundOut {
  bf16* out;
  size_t lo;
  int ld, M, N;
  long long zrows;
  __device__ void operator()(const float* o, int l, int bm, int bn, int m0,
                             int n0, int, int, int batch) const {
    bf16* ob = out + batch * zrows * ld;
    gm::for_pairs(o, l, bm, bn, m0, n0, M, N,
                  [&](int m, int n, float v0, float v1) {
                    mm::put2<NP>(ob, lo, (size_t)m * ld + n, round_to<T>(v0),
                                 round_to<T>(v1));
                  });
  }
};

// the rows of a split product: problem p's split s of batch b at
// part[p] + b * bs + s * M * N[p], row-major M x N[p]
struct RowsOut {
  float* part[2];
  int M, N[2];
  long long bs;
  __device__ void operator()(const float* o, int l, int bm, int bn, int m0,
                             int n0, int prob, int split, int batch) const {
    const int n = N[prob];
    float* row = part[prob] + batch * bs + (size_t)split * M * n;
    gm::for_pairs(o, l, bm, bn, m0, n0, M, n,
                  [&](int m, int c, float v0, float v1) {
                    gm::store2(row, (size_t)m * n + c, v0, v1);
                  });
  }
};

// ---- the taps

// A 3x3 window of a channel pair (c, c + 1) of a pixel-major plane
// [pixel][ld] (f32, or T for dT), rows h - 1 + i and columns w - 1 + j of
// the image whose pixel (0, 0) is img0 (zero outside the image), sliding
// along a row: three new loads a pixel.
template <typename V>
struct Win {
  const V* p;
  int ld, c, H, W;
  size_t img0;
  float2 v[3][3];
  __device__ float2 at(int hh, int ww) const {
    return hh >= 0 && hh < H && ww >= 0 && ww < W
               ? gm::load2(p, (img0 + (size_t)hh * W + ww) * ld + c)
               : make_float2(0.f, 0.f);
  }
  __device__ void start(int h, int w) {
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) v[i][j] = at(h - 1 + i, w - 1 + j);
  }
  __device__ void slide(int h, int w) {  // to column w + 1
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      v[i][0] = v[i][1];
      v[i][1] = v[i][2];
      v[i][2] = at(h - 1 + i, w + 2);
    }
  }
};

// Row segments of a taps pass: segment s is (image row, run of DW_W
// columns), segment-fastest; an image's segments are consecutive.  A thread
// takes channel pair gid % (NC / 2) of segment gid / (NC / 2), so
// consecutive threads read consecutive channels of a pixel and no thread
// idles at small C.  (Two image rows a thread, sharing a 4 x 3 window,
// measured slower.)
struct RowSeg {
  int h, w0, w1;
  size_t img0;
  __device__ RowSeg(int s, int H, int W) {
    const int ns = (W + DW_W - 1) / DW_W;
    const int row = s / ns;
    h = row % H;
    w0 = (s % ns) * DW_W;
    w1 = min(W, w0 + DW_W);
    img0 = (size_t)(row / H) * H * W;
  }
};

inline int segments(int I, int H, int W) {
  return I * H * ((W + DW_W - 1) / DW_W);
}

// out(p) = sum_k tap_k[c] u(p + d_k), d_k = (k / 3 - 1, k % 3 - 1), a
// thread a channel pair of u [pixel][ldu] (f32, NC channels); the taps as
// their parameter stores them, tap k of channel c at taps[k * ldk + c].
// Channels c < NT round to T and go to the planes tq [pixel][ldt]; the
// others stay f32, split into the planes fq [pixel][ldf] at column c - NT.
// With ssq, the segment's sums of squares of the rounded channels c < NT go
// to its row [segments][NT] (the forward's Sq and Sk).
template <typename T>
__device__ void taps(const float* __restrict__ u, int ldu,
                     const float* __restrict__ tp_, int ldk, int NC, int NT,
                     bf16* __restrict__ tq, size_t tq_lo, int ldt,
                     bf16* __restrict__ fq, size_t fq_lo, int ldf,
                     float* __restrict__ ssq, int segs, int H, int W) {
  const int gid = blockIdx.x * DW_T + threadIdx.x;
  const int c = 2 * (gid % (NC / 2)), s = gid / (NC / 2);
  if (s >= segs) return;
  const RowSeg sg(s, H, W);
  float2 tp[9];
#pragma unroll
  for (int k = 0; k < 9; ++k)
    tp[k] = __ldg(reinterpret_cast<const float2*>(tp_ + k * ldk + c));
  Win<float> win{u, ldu, c, H, W, sg.img0};
  win.start(sg.h, sg.w0);
  float q0 = 0.f, q1 = 0.f;
  for (int w4 = sg.w0; w4 < sg.w1; w4 += AHEAD) {
    // the window's next AHEAD columns, loaded before any is used, so their
    // loads are in flight together
    float2 nx[3][AHEAD];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < AHEAD; ++j)
        nx[i][j] = win.at(sg.h - 1 + i, w4 + 2 + j);
#pragma unroll
    for (int j = 0; j < AHEAD; ++j) {
      const int w = w4 + j;
      if (w >= sg.w1) break;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        s0 = fmaf(tp[k].x, win.v[k / 3][k % 3].x, s0);
        s1 = fmaf(tp[k].y, win.v[k / 3][k % 3].y, s1);
      }
      const size_t pix = sg.img0 + (size_t)sg.h * W + w;
      if (c < NT) {
        const float r0 = round_to<T>(s0), r1 = round_to<T>(s1);
        mm::put2<NPT<T>>(tq, tq_lo, pix * ldt + c, r0, r1);
        q0 = fmaf(r0, r0, q0);
        q1 = fmaf(r1, r1, q1);
      } else {
        mm::put2<NFT<T>>(fq, fq_lo, pix * ldf + c - NT, s0, s1);
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        win.v[i][0] = win.v[i][1];
        win.v[i][1] = win.v[i][2];
        win.v[i][2] = nx[i][j];
      }
    }
  }
  if (ssq != nullptr && c < NT)
    *reinterpret_cast<float2*>(ssq + (size_t)s * NT + c) =
        make_float2(q0, q1);
}

// the grid of a taps pass over NC channels
inline int taps_grid(int NC, int segs) {
  return (NC / 2 * segs + DW_T - 1) / DW_T;
}

// ---- the forward chain's launch sequences

// Kernel signatures of a library's taps pass (a __global__ wrapping taps).
using TapsKernel = void (*)(const float*, int, const float*, int, int, int,
                            bf16*, size_t, int, bf16*, size_t, int, float*,
                            int, int, int);

// 3-4 of a slice of I images (P pixels): u = LN W_qkv (f32 [P][3C]), then
// the taps: round(q), round(k) into the planes qk [P][2C] and v into the
// planes v [P][C]; with ssq, the row segments' sums of squares of round(q)
// and round(k) [segments][2C].  F32E: the library's F32Out.
template <typename T, class F32E, int BN = 64>
cudaError_t qkv_stage(TapsKernel taps_k, const Opnd& LN, const Opnd& Wqkv,
                      const float* tqkv, float* u, bf16* qk, bf16* v,
                      float* ssq, int I, int H, int W, int C,
                      cudaStream_t st) {
  constexpr int NP = NPT<T>, NF = NFT<T>;
  const int P = I * H * W, C2 = 2 * C, C3 = 3 * C;
  UIR_MDTA_TRY((gm::launch<TPt<NP, NF, BN>>(
      gm::simple(LN, Wqkv, P, C3, C), 1, F32E{{u, C3, P, C3, 0}}, st)));
  const int segs = segments(I, H, W);
  taps_k<<<taps_grid(C3, segs), DW_T, 0, st>>>(
      u, C3, tqkv, C3, C3, C2, qk, (size_t)P * C2, C2, v, (size_t)P * C, C,
      ssq, segs, H, W);
  return cudaGetLastError();
}

// 5-9 of a slice: outs = round(A v) (per image, block-diagonal: an n tile
// takes only the k of its heads), out = round(outs W_po), u_vf = out W_kvf
// (f32), vf by the taps (planes), outf = round(A vf).  V, Ab: v's planes
// and the images' A planes; the outputs [P][C].  RoundE, F32E: the
// library's RoundOut and F32Out.
template <typename T, template <typename, int> class RoundE, class F32E,
          int BN = 64>
cudaError_t apply_stage(TapsKernel taps_k, const Opnd& V, const Opnd& Ab,
                        const Opnd& Wpo, const Opnd& Wkvf, const float* tvf,
                        int ldk, bf16* outs, bf16* out, float* uvf, bf16* vf,
                        bf16* outf, int I, int H, int W, int C, int CPH,
                        cudaStream_t st) {
  constexpr int NP = NPT<T>, NF = NFT<T>;
  const int HW = H * W, P = I * HW;
  const size_t pc = (size_t)P * C;
  gm::Args a = gm::simple(V, Ab, HW, C, C);
  a.band = CPH;
  UIR_MDTA_TRY((gm::launch<TPf<NF, BN>>(
      a, I, RoundE<T, NP>{{outs, pc, C, HW, C, HW}}, st)));
  UIR_MDTA_TRY((gm::launch<TPt<NP, NF, BN>>(
      gm::simple(pixel_planes(outs, NP, P, C, HW), Wpo, P, C, C), 1,
      RoundE<T, NP>{{out, pc, C, P, C, 0}}, st)));
  UIR_MDTA_TRY((gm::launch<TPt<NP, NF, BN>>(
      gm::simple(pixel_planes(out, NP, P, C, HW), Wkvf, P, C, C), 1,
      F32E{{uvf, C, P, C, 0}}, st)));
  const int segs = segments(I, H, W);
  taps_k<<<taps_grid(C, segs), DW_T, 0, st>>>(
      uvf, C, tvf, ldk, C, 0, nullptr, 0, C, vf, pc, C, nullptr, segs, H, W);
  UIR_MDTA_TRY(cudaGetLastError());
  a = gm::simple(pixel_planes(vf, NF, P, C, HW), Ab, HW, C, C);
  a.band = CPH;
  return gm::launch<TPf<NF, BN>>(
      a, I, RoundE<T, NP>{{outf, pc, C, HW, C, HW}}, st);
}

}  // namespace mdta
}  // namespace uir
