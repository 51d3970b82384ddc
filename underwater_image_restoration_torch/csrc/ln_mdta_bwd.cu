// LN + MDTA backward: the vector-Jacobian product of
// y = x + MDTA(LayerNorm_C(x)) on channels-first (B, C, H, W), with the
// forward's dead-code quirks (attnf, kf and q1x1_1 never reach y, so their
// gradients are zero and the wrapper writes them as zeros).
//
// Replaces the TPU kernels of the JAX package
// ops/fused_attn_composed.py:574 _bwd_call (_bwd_kernel:253),
// ops/fused_attn_banded.py:707 _bwd_call (_bwd_kernel:337) and
// ops/fused_attn.py:560 _bwd_call (_bwd_kernel:219), which compute one
// function (split on the TPU to fit its VMEM).
//
// What bounds it on an H100.  Per pixel it recomputes the forward (about
// 2 (4C^2 + 36C + 3C^2 + 4C CPH) flops) and runs the backward chains (about
// twice that) against x, dy and dx (3 C itemsize bytes): at peak rates it
// is bound by the tensor cores' operations at C >= 64 and by bytes below.
// A tile-local design (each block recomputing LN on a 2-pixel halo, as
// this kernel once did) cannot feed the tensor cores: its ten channel-major
// planes shrink the tile to 4 x 4 pixels at C = 128, too small an M, with
// the halo recomputed 4x, and its per-tile shares went to global memory a
// tile at a time.
//
// Design.  The backward runs as a sequence of launches over the batch in
// image slices whose intermediates live pixel-major ([pixel][channel]) in
// one workspace (ops/fused_mdta.py bwd_plan keeps it within
// BWD_WORKSPACE_BYTES).  Every 1x1 and every per-head product is a
// tensor-core product through gemm.cuh (mma.sync m16n8k16, M = pixels, or
// K = pixels for the weight gradients and dA), its elementwise work in the
// epilogue; the depthwise taps, LN and the per-image softmax backward run
// on the FMA pipe.  Steps 1-9 recompute the forward with the forward's own
// stages (csrc/mdta.cuh, shared with csrc/ln_mdta.cu).  Once a call, the
// weights' bf16 planes go into the workspace; then per slice:
//   1. prep: LN statistics, LN = round(LN x) and dy as bf16 planes, x and
//      dy read through a shared tile of 32 pixels (coalesced in NCHW);
//   2. A = softmax(temp G rq rk^T) of each image from the forward's saved
//      stats (gram G, row sums of squares Sq, Sk), block-diagonal [C][C];
//   3. u = LN W_qkv (f32), then 4. the taps: round(q), round(k) and v;
//   5. outs = round(A v) (per image, block-diagonal: an n tile takes only
//      the k of its heads), 6. out = round(outs W_po), 7. u_vf = out W_kvf,
//      8. vf by the taps, 9. outf = round(A vf);
//   10. d_outf = round(dy W_pof^T), 11. dvf = A^T d_outf, 12. d(u_vf) by
//      the transposed taps with the rows of dtaps_vf, 13. d_out =
//      round(d(u_vf) W_kvf^T), 14. d_outs = round(d_out W_po^T), 15. dv =
//      A^T d_outs;
//   16. dA = sum_p d_outf vf^T + d_outs v^T over the diagonal (head)
//      tiles, each image's pixels split into at most 32 ranges, a row each;
//   17. a block an image sums its dA rows in order and runs the softmax
//      and l2-normalize backward: dS = A (dA - rowsum(dA A)), dtemp = sum
//      dS G rq rk, dP = temp dS, M = rq dP rk^T, alpha_q = rq^3 sum_j dP G
//      rk and alpha_k = rk^3 sum_i dP G rq (zero where S < 1e-24: the
//      rsqrt(max(S, 1e-24)) gate, fused_attn.py:92);
//   18. dq = round(M k - alpha_q q), dk = round(M^T q - alpha_k k), one
//      launch of two products (zero outside the rows the stats cover);
//   19. d(u_qkv) by the transposed taps of [dq; dk; dv], with the rows of
//      dtaps_qkv;
//   20-21. dW_pof, dW_po, dW_kvf and dW_qkv (K = pixels), split over pixel
//      ranges, a row a split;
//   22. dLN = d(u_qkv) W_qkv^T, a block owning 32 pixels and every channel,
//      its epilogue running the LayerNorm backward (dx = dy + round(dx_ln)
//      in NCHW) and its shares of dscale and dbias;
//   23. the rows summed in a fixed order into the gradients, added to the
//      earlier slices' sums in slice order.
// Every weight is read from its parameter as stored (f32, planes made once
// a call), with ldmatrix or ldmatrix.trans as the product needs, and the
// taps in their (3, 3, ch) layout: no transposed copies.  In bf16 the
// activations rounded to T are exactly bf16 (one plane) and the f32 values
// (the weights, A and M, v, vf and the f32 cotangents) hi/lo pairs, so a
// product takes 1 or 2 passes.  In f32 every operand is carried as three
// planes (mma.cuh) and a product takes 6 passes: with hi/lo pairs (about
// 2^-17 of each value) dtemp, a sum of dS G over each head's entries that
// cancels to a few percent of its terms, read 2.3e-4 of its max|ref|
// against the limit of 1e-4; three planes hold every value to f32's
// precision.  No float atomics and no ticket: two runs give the same bits.
//
// Context parallelism.  On a band of the map's rows the softmax backward
// needs dA over every pixel, so the backward is split around a sum of dA
// over the ranks, one slice a call, the slice's workspace kept between the
// halves: uir_ln_mdta_bwd_stage1 runs steps 1-16 and writes each image's dA
// (the rank's share: dy is zero on the halo rows, so only the band's own
// cotangents contribute, and d_out reaches the halo rows' v where the
// transposed taps carry it); uir_ln_mdta_bwd_stage2 runs 17-23 from the
// summed dA, takes dtemp from the rank's own dA (dtemp is linear in dA,
// and the ranks' parameter gradients are summed after the step), and
// zeroes dq and dk outside the rows whose q and k the stats hold.  On the
// whole map the two give uir_ln_mdta_bwd's bits.
//
// Rounding points (the TPU kernels', as autograd through the plain version
// rounds): LN, q, k, outs, out, outf, d_outf, d_out, d_outs, dq, dk and dLN
// round to T; v, vf, u, u_vf, dvf, dv, d(u) and every weight-gradient sum
// stay f32; dx = round(dy + round(dx_ln)).
//
// What bounds this design.  Its pixel-major planes (bwd_workspace_bytes
// counts them: 56 C bytes a pixel in bf16) each make one to three trips
// through device memory, far more traffic than the function's own bound
// (x, dy and dx once); the taps passes and the short-K products are bound
// by their loads' latency rather than by the tensor cores.
#include <cstdint>

#include "mdta.cuh"

namespace {

namespace mm = uir::mma;
namespace gm = uir::gemm;
namespace md = uir::mdta;
using bf16 = __nv_bfloat16;
using gm::kThreads;
using gm::Opnd;
using gm::Tile;
using gm::warp_sum;
using md::DW_T;
using md::MAX_C;
using md::NFT;
using md::NPT;
using md::PT;
using uir::from_f;
using uir::round_to;
using uir::to_f;

// ---- 1. prep (csrc/mdta.cuh): LN statistics, LN and dy as bf16 planes

template <typename T, int NP>
__global__ void __launch_bounds__(kThreads)
    ln_mdta_bwd_prep_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                            const float* __restrict__ scale,
                            const float* __restrict__ bias,
                            float2* __restrict__ stats, bf16* __restrict__ ln,
                            bf16* __restrict__ dyp, int P, int HW, int C,
                            float eps) {
  md::prep<T, NP>(x, dy, scale, bias, stats, ln, dyp, P, HW, C, eps);
}

// ---- 0. the weights' planes, once a call (csrc/mdta.cuh)

template <int NF>
__global__ void __launch_bounds__(kThreads)
    ln_mdta_bwd_weights_kernel(md::WeightSet ws, bf16* __restrict__ out) {
  md::weight_planes<NF>(ws, out);
}

// ---- 2. the attention matrix of each image (csrc/mdta.cuh), from the
// forward's saved stats: gram [C][CPH], Sq [C], Sk [C] an image

template <int CPH, int NF>
__global__ void __launch_bounds__(kThreads)
    ln_mdta_bwd_attn_kernel(const float* __restrict__ stats,
                            const float* __restrict__ temp,
                            float* __restrict__ a32, bf16* __restrict__ ap,
                            size_t lo, int C) {
  md::attention<CPH, NF>(stats + (size_t)blockIdx.x * (C * CPH + 2 * C),
                         temp, a32, ap, lo, (size_t)blockIdx.x * C * C, C);
}

// ---- product epilogues (csrc/mdta.cuh), named for this library

struct MdtaBwdF32Epi : md::F32Out {};
template <typename T, int NP>
struct MdtaBwdRoundEpi : md::RoundOut<T, NP> {};
struct MdtaBwdRowsEpi : md::RowsOut {};

// the value of NP planes (stride lo) at i
template <int NP>
__device__ __forceinline__ float plane_at(const bf16* p, size_t lo,
                                          size_t i) {
  float v = 0.f;
#pragma unroll
  for (int k = NP - 1; k >= 0; --k) v += __bfloat162float(p[i + k * lo]);
  return v;
}

// 18. dq = round(M k - alpha_q q) (problem 0) and dk = round(M^T q -
// alpha_k k) (problem 1) into dqk [pixel][2C] in T, from the product with
// round(q), round(k) (qk planes [pixel][2C]); per image (batch).
template <typename T, int NP>
struct MdtaBwdDqkEpi {
  const bf16* qk;
  size_t qk_lo;
  const float* alpha;  // [images][2C]
  T* dqk;
  int M, C;
  int p0, p1;  // the pixels of an image whose q and k the stats hold
  __device__ void operator()(const float* o, int l, int bm, int bn, int m0,
                             int n0, int prob, int, int batch) const {
    const float* al = alpha + (size_t)batch * 2 * C + prob * C;
    const size_t row0 = (size_t)batch * M;
    gm::for_pairs(o, l, bm, bn, m0, n0, M, C,
                  [&](int m, int n, float v0, float v1) {
                    const size_t i = (row0 + m) * 2 * C + prob * C + n;
                    const bool in = m >= p0 && m < p1;
                    const float a = v0 - al[n] * plane_at<NP>(qk, qk_lo, i);
                    const float b =
                        v1 - al[n + 1] * plane_at<NP>(qk, qk_lo, i + 1);
                    gm::store2(dqk, i, in ? round_to<T>(a) : 0.f,
                               in ? round_to<T>(b) : 0.f);
                  });
  }
};

// 22. dLN's epilogue: the tile holds dLN (f32) of PT pixels and all C
// channels.  The LayerNorm backward (dx = round(dy + round(dx_ln)), NCHW)
// with the prep's statistics, and the block's shares of dscale and dbias
// (dLN rounded to T first: the LN output is materialized in T) into its row
// of part [blocks][2C].
template <typename T>
struct MdtaBwdDlnEpi {
  const T* x;
  const T* dy;
  T* dx;
  const float2* stats;
  const float* scale;
  float* part;
  int P, C, HW;
  __device__ void operator()(const float* o, int l, int, int, int m0, int,
                             int, int, int) const {
    __shared__ float2 red[kThreads / 32][PT];
    __shared__ float2 tot[PT];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int m = m0 + lane;
    const bool in = m < P;
    const size_t at = in ? (size_t)(m / HW) * C * HW + m % HW : 0;
    const float2 st = in ? stats[m] : make_float2(0.f, 0.f);
    // lanes over pixels, warps over channels: coalesced in NCHW
    float s1 = 0.f, s2 = 0.f;
    if (in)
      for (int c = warp; c < C; c += kThreads / 32) {
        const float xh = (to_f(x[at + (size_t)c * HW]) - st.x) * st.y;
        const float g = round_to<T>(o[lane * l + c]) * __ldg(scale + c);
        s1 += g;
        s2 = fmaf(g, xh, s2);
      }
    red[warp][lane] = make_float2(s1, s2);
    __syncthreads();
    if (threadIdx.x < PT) {
      float a = 0.f, b = 0.f;
      for (int w = 0; w < kThreads / 32; ++w) {
        a += red[w][threadIdx.x].x;
        b += red[w][threadIdx.x].y;
      }
      tot[threadIdx.x] = make_float2(a / C, b / C);
    }
    __syncthreads();
    if (in) {
      const float2 sm = tot[lane];
      for (int c = warp; c < C; c += kThreads / 32) {
        const size_t i = at + (size_t)c * HW;
        const float xh = (to_f(x[i]) - st.x) * st.y;
        const float g = round_to<T>(o[lane * l + c]) * __ldg(scale + c);
        const float dxl = round_to<T>(st.y * (g - sm.x - xh * sm.y));
        dx[i] = from_f<T>(to_f(dy[i]) + dxl);
      }
    }
    float* row = part + (size_t)blockIdx.x * 2 * C;
    for (int c = warp; c < C; c += kThreads / 32) {
      float a = 0.f, b = 0.f;
      if (in) {
        const float dl = round_to<T>(o[lane * l + c]);
        const float xh = (to_f(x[at + (size_t)c * HW]) - st.x) * st.y;
        a = dl * xh;
        b = dl;
      }
      a = warp_sum(a);
      b = warp_sum(b);
      if (lane == 0) {
        row[c] = a;
        row[C + c] = b;
      }
    }
  }
};

// ---- 4, 8. the taps (csrc/mdta.cuh)

template <typename T>
__global__ void __launch_bounds__(DW_T)
    ln_mdta_bwd_taps_kernel(const float* __restrict__ u, int ldu,
                            const float* __restrict__ taps, int ldk, int NC,
                            int NT, bf16* __restrict__ tq, size_t tq_lo,
                            int ldt, bf16* __restrict__ fq, size_t fq_lo,
                            int ldf, float* __restrict__ ssq, int segs, int H,
                            int W) {
  md::taps<T>(u, ldu, taps, ldk, NC, NT, tq, tq_lo, ldt, fq, fq_lo, ldf, ssq,
              segs, H, W);
}

// ---- 12, 19. the transposed taps and the taps' gradient

// du(p) = sum_k tap_k[c] d(p - d_k) into the split planes du [pixel][NC]
// (taps as above), and the segment's share of dtaps[c][k] = sum_p d(p)
// u(p + d_k) into its row of part [segments][NC * 9], a thread a channel
// pair.  d: channels c < NT from dT [pixel][ldT] (in T), the others from
// dF [pixel][ldF] (f32) at c - NT; u [pixel][ldu] f32.
template <typename T>
__global__ void __launch_bounds__(DW_T)
    ln_mdta_bwd_taps_t_kernel(const T* __restrict__ dT, int ldT,
                              const float* __restrict__ dF, int ldF,
                              const float* __restrict__ u, int ldu,
                              const float* __restrict__ taps, int ldk,
                              int NC, int NT, bf16* __restrict__ du,
                              size_t du_lo, float* __restrict__ part,
                              int segs, int H, int W) {
  const int gid = blockIdx.x * DW_T + threadIdx.x;
  const int c = 2 * (gid % (NC / 2)), s = gid / (NC / 2);
  if (s >= segs) return;
  const md::RowSeg sg(s, H, W);
  float2 tp[9], gt[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    tp[k] = __ldg(reinterpret_cast<const float2*>(taps + k * ldk + c));
    gt[k] = make_float2(0.f, 0.f);
  }
  // the window of d: T below NT, f32 from there (a pair never straddles it)
  md::Win<float> uw{u, ldu, c, H, W, sg.img0};
  uw.start(sg.h, sg.w0);
  auto run = [&](auto& dw) {
    dw.start(sg.h, sg.w0);
    for (int w = sg.w0; w < sg.w1; ++w) {
      float s0 = 0.f, s1 = 0.f;  // d(p - d_k) at window (2 - k/3, 2 - k%3)
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        s0 = fmaf(tp[k].x, dw.v[2 - k / 3][2 - k % 3].x, s0);
        s1 = fmaf(tp[k].y, dw.v[2 - k / 3][2 - k % 3].y, s1);
      }
      const size_t pix = sg.img0 + (size_t)sg.h * W + w;
      mm::put2<NFT<T>>(du, du_lo, pix * NC + c, s0, s1);
      const float2 dc = dw.v[1][1];
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        gt[k].x = fmaf(dc.x, uw.v[k / 3][k % 3].x, gt[k].x);
        gt[k].y = fmaf(dc.y, uw.v[k / 3][k % 3].y, gt[k].y);
      }
      dw.slide(sg.h, w);
      uw.slide(sg.h, w);
    }
  };
  if (c < NT) {
    md::Win<T> dw{dT, ldT, c, H, W, sg.img0};
    run(dw);
  } else {
    md::Win<float> dw{dF, ldF, c - NT, H, W, sg.img0};
    run(dw);
  }
  float* r = part + (size_t)s * NC * 9 + c * 9;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    r[k] = gt[k].x;
    r[9 + k] = gt[k].y;
  }
}

// ---- 17. the softmax and l2-normalize backward of each image

// The image's softmax and l2-normalize backward from its dA [C][CPH] in
// shared memory (sh, followed by dP [C][CPH], rq, rk and a row's dtemp
// [C] each): M and M^T (planes, zero outside the heads), alpha and dtemp.
// dtemp is taken from dAt (shared, [C][CPH]): dA itself on a whole map;
// on a band of a row-sharded map, the rank's own dA while dA is the sum
// over the ranks (dtemp is linear in dA, and the ranks' parameter
// gradients are summed after the step).
template <int CPH, int NF>
__device__ void softmax_bwd(const float* st, const float* __restrict__ temp,
                            const float* __restrict__ A, float* sh,
                            const float* dAt, bf16* __restrict__ mhi,
                            bf16* __restrict__ mti, float* __restrict__ al,
                            float* __restrict__ dtemp, int C) {
  const int CC = C * CPH, NH = C / CPH;
  const float* dA = sh;  // [C][CPH]
  float* dP = sh + CC;   // [C][CPH]
  float* rq = dP + CC;   // [C]
  float* rk = rq + C;    // [C]
  float* rowdt = rk + C; // [C]
  const size_t mb = (size_t)blockIdx.x * C * C,
               mlo = (size_t)gridDim.x * C * C;
  for (int i = threadIdx.x; i < C; i += blockDim.x) {
    rq[i] = rsqrtf(fmaxf(st[CC + i], 1e-24f));
    rk[i] = rsqrtf(fmaxf(st[CC + C + i], 1e-24f));
  }
  // M and M^T, zero outside the heads
  for (size_t e = threadIdx.x; e < (size_t)C * C; e += blockDim.x)
#pragma unroll
    for (int k = 0; k < NF; ++k)
      mhi[mb + e + k * mlo] = mti[mb + e + k * mlo] = __float2bfloat16(0.f);
  __syncthreads();
  for (int i = threadIdx.x; i < C; i += blockDim.x) {
    const int h = i / CPH;
    const float* ar = A + (size_t)i * C + h * CPH;
    const float* dar = dA + i * CPH;
    const float* dat = dAt + i * CPH;
    float s = 0.f, sdt = 0.f;
    for (int jj = 0; jj < CPH; ++jj) s = fmaf(dar[jj], ar[jj], s);
    if (dat == dar)
      sdt = s;
    else
      for (int jj = 0; jj < CPH; ++jj) sdt = fmaf(dat[jj], ar[jj], sdt);
    float rd = 0.f, cq = 0.f;
    for (int jj = 0; jj < CPH; ++jj) {
      const int j = h * CPH + jj;
      const float g = st[i * CPH + jj];
      const float ds = ar[jj] * (dar[jj] - s);
      const float dst = dat == dar ? ds : ar[jj] * (dat[jj] - sdt);
      rd = fmaf(dst, g * rq[i] * rk[j], rd);
      const float dp = temp[h] * ds;
      dP[i * CPH + jj] = dp;
      const float mv = rq[i] * dp * rk[j];
      mm::put<NF>(mhi, mlo, mb + (size_t)i * C + j, mv);
      mm::put<NF>(mti, mlo, mb + (size_t)j * C + i, mv);
      cq = fmaf(dp * g, rk[j], cq);
    }
    rowdt[i] = rd;
    al[i] = st[CC + i] >= 1e-24f ? rq[i] * rq[i] * rq[i] * cq : 0.f;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < C; j += blockDim.x) {
    const int h = j / CPH, jj = j % CPH;
    float ck = 0.f;
    for (int ii = 0; ii < CPH; ++ii) {
      const int i = h * CPH + ii;
      ck = fmaf(dP[i * CPH + jj] * st[i * CPH + jj], rq[i], ck);
    }
    al[C + j] = st[CC + C + j] >= 1e-24f ? rk[j] * rk[j] * rk[j] * ck : 0.f;
  }
  for (int h = threadIdx.x; h < NH; h += blockDim.x) {
    float s = 0.f;
    for (int ii = 0; ii < CPH; ++ii) s += rowdt[h * CPH + ii];
    dtemp[h] = s;
  }
}

// The image's dA [C][CPH] into d (a block an image): its rows in order,
// within the heads.
template <int CPH>
__device__ void sum_dA(const float* __restrict__ rw, int nrows, float* d,
                       int C) {
  for (int e = threadIdx.x; e < C * CPH; e += blockDim.x) {
    const int i = e / CPH, j = (i / CPH) * CPH + e % CPH;
    float s = 0.f;
    for (int r = 0; r < nrows; ++r) s += rw[(size_t)r * C * C + i * C + j];
    d[e] = s;
  }
}

template <int CPH, int NF>
__global__ void __launch_bounds__(kThreads)
    ln_mdta_bwd_softmax_kernel(const float* __restrict__ stats,
                               const float* __restrict__ temp,
                               const float* __restrict__ a32,
                               const float* __restrict__ rows, int nrows,
                               bf16* __restrict__ mhi, bf16* __restrict__ mti,
                               float* __restrict__ alpha,
                               float* __restrict__ dtemp, int C) {
  extern __shared__ float sh[];
  const int b = blockIdx.x, CC = C * CPH;
  sum_dA<CPH>(rows + (size_t)b * nrows * C * C, nrows, sh, C);
  softmax_bwd<CPH, NF>(stats + (size_t)b * (CC + 2 * C), temp,
                       a32 + (size_t)b * C * C, sh, sh, mhi, mti,
                       alpha + (size_t)b * 2 * C, dtemp + (size_t)b * (C / CPH),
                       C);
}

// stage 1's last launch: each image's dA [C][CPH] into dA [images][C CPH]
template <int CPH>
__global__ void __launch_bounds__(kThreads)
    ln_mdta_bwd_da_kernel(const float* __restrict__ rows, int nrows,
                          float* __restrict__ dA, int C) {
  sum_dA<CPH>(rows + (size_t)blockIdx.x * nrows * C * C, nrows,
              dA + (size_t)blockIdx.x * C * CPH, C);
}

// stage 2's softmax backward: dA, the sum over the ranks, and the rank's
// own dAt for dtemp, each [images][C CPH]
template <int CPH, int NF>
__global__ void __launch_bounds__(kThreads)
    ln_mdta_bwd_softmax_split_kernel(
        const float* __restrict__ stats, const float* __restrict__ temp,
        const float* __restrict__ a32, const float* __restrict__ dA,
        const float* __restrict__ dAt, bf16* __restrict__ mhi,
        bf16* __restrict__ mti, float* __restrict__ alpha,
        float* __restrict__ dtemp, int C) {
  extern __shared__ float sh[];
  const int b = blockIdx.x, CC = C * CPH;
  float* t = sh + 2 * CC + 3 * C;  // after softmax_bwd's pieces
  for (int e = threadIdx.x; e < CC; e += blockDim.x) {
    sh[e] = dA[(size_t)b * CC + e];
    t[e] = dAt[(size_t)b * CC + e];
  }
  __syncthreads();
  softmax_bwd<CPH, NF>(stats + (size_t)b * (CC + 2 * C), temp,
                       a32 + (size_t)b * C * C, sh, t, mhi, mti,
                       alpha + (size_t)b * 2 * C, dtemp + (size_t)b * (C / CPH),
                       C);
}

// ---- the workspace

// The workspace of one slice of I images of HW pixels, each piece 256-byte
// aligned (ops/fused_mdta.py bwd_workspace_bytes mirrors it).  The pieces
// from UVF on form a region whose values are dead after step 16 (u_vf and
// dvf after 12); dq, dk and d(u_qkv), written from step 18 on, reuse it.
enum Piece {
  WTS,  // the weights' planes, written once a call
  STATS, LN, DY, U, QK, V, OUTS, OUT, OUTF, DUVF, DOUT, DV, A32, AP, MP, MTP,
  ALPHA, ROWS_A, ROWS_W1, ROWS_KVF, ROWS_QKV, ROWS_TV, ROWS_TQ, ROWS_LN,
  UVF, DVF, VF, DOF, DOUTS,  // the region ...
  DQK, DU,                   // ... and what reuses it
  NPIECES
};

struct Layout {
  size_t off[NPIECES], total;
  Layout(int I, int H, int W, int C, int NP, int NF, int item, int Ks,
         int KsA) {
    const size_t HW = (size_t)H * W, p = I * HW, c = C;
    const int splits_w = (int)((p + Ks - 1) / Ks);
    const int splits_a = (int)((HW + KsA - 1) / KsA);
    const int segs = md::segments(I, H, W);
    const int blocks = (int)((p + PT - 1) / PT);
    const size_t pl = (size_t)NP * 2 * p * c;  // planes of T values [P][C]
    const size_t fs = (size_t)NF * 2 * p * c;  // planes of f32 values
    const size_t fa = 4 * p * c;               // f32 values
    const size_t cc = (size_t)I * C * C, ccs = (size_t)NF * 2 * cc;
    const size_t sz[NPIECES] = {
        (size_t)NF * 2 * 7 * c * c,               // the weights' planes
        8 * p, pl, pl, 3 * fa, 2 * pl, fs, pl, pl, pl, fs, pl, fa,
        4 * cc, ccs, ccs, ccs, 4 * (size_t)I * 2 * c,
        4 * cc * 2 * splits_a,                    // dA rows
        4 * (size_t)splits_w * 2 * c * c,         // dW_pof, dW_po rows
        4 * (size_t)splits_w * c * c,             // dW_kvf rows
        4 * (size_t)splits_w * 3 * c * c,         // dW_qkv rows
        4 * (size_t)segs * 9 * c,                 // dtaps_vf rows
        4 * (size_t)segs * 27 * c,                // dtaps_qkv rows
        4 * (size_t)blocks * 2 * c,               // dscale, dbias rows
        fa, fa, fs, pl, pl,                       // UVF, DVF, VF, DOF, DOUTS
        (size_t)item * p * 2 * c, 3 * fs};        // DQK, DU
    auto up = [](size_t n) { return (n + 255) / 256 * 256; };
    size_t at = 0;
    for (int i = 0; i < UVF; ++i) off[i] = at, at += up(sz[i]);
    size_t end = at;
    for (int i = UVF; i < DQK; ++i) off[i] = end, end += up(sz[i]);
    off[DQK] = at;
    off[DU] = at + up(sz[DQK]);
    total = end > off[DU] + up(sz[DU]) ? end : off[DU] + up(sz[DU]);
  }
};

// What a call runs: the whole backward (WHOLE), or its two halves around a
// sum of dA over the ranks that hold the map's other rows, each on one
// slice whose workspace the second half finds as the first left it: STAGE1
// (the weights' planes, steps 1-16, then each image's dA into dA) and
// STAGE2 (steps 17-23, from dA, the sum, and dAt, the rank's own; dq and
// dk zero outside rows [r0, r1)).
enum Mode { WHOLE, STAGE1, STAGE2 };

template <typename T, int CPH>
int launch(Mode mode, const T* x, const T* dy, T* dx, const float* scale,
           const float* bias, const md::Weights& wt, const float* stats,
           unsigned char* work, float* grads, float* dtemp, float* dA,
           const float* dAt, int B, int C, int H, int W, int imgs, int Ks,
           int KsA, int r0, int r1, int accumulate, float eps,
           cudaStream_t st) {
  constexpr int NP = NPT<T>, NF = NFT<T>;
  const int HW = H * W, C2 = 2 * C, C3 = 3 * C, ES = C * CPH + 2 * C;
  const Layout L(imgs, H, W, C, NP, NF, sizeof(T), Ks, KsA);
  const int splits_a = (HW + KsA - 1) / KsA;  // dA rows an image and product
  auto bfp = [&](Piece i) { return reinterpret_cast<bf16*>(work + L.off[i]); };
  auto f32p = [&](Piece i) {
    return reinterpret_cast<float*>(work + L.off[i]);
  };
  auto* stat2 = reinterpret_cast<float2*>(work + L.off[STATS]);
  T* dqk = reinterpret_cast<T*>(work + L.off[DQK]);
  using TPn = md::TPn<NP, NF>;  // T x W^T
  using TPt = md::TPt<NP, NF>;  // T x W, T x A
  using TPf = md::TPf<NF>;      // f32 x W^T, A
  // K = pixels: a long k loop, four stages, the k tiles' sums added
  // round-to-nearest (gemm.cuh, Sums): dtemp cancels too far for the
  // tensor cores' truncating adds over thousands of pixels
  using TKt = md::TK<NP, NP>;  // T^T x T
  using TKf = md::TK<NP, NF>;  // T^T x f32
  // 0. the weights' planes: w_qkv, w_po, w_kv, w_pof from WTS on
  const long long cc = (long long)C * C;
  bf16* wts = bfp(WTS);
  const md::WeightSet ws = md::weight_set(wt, C, NF);
  if (mode != STAGE2) {
    ln_mdta_bwd_weights_kernel<NF>
        <<<dim3((3 * C * C + kThreads - 1) / kThreads, 4), kThreads, 0,
            st>>>(ws, wts);
    UIR_TRY(cudaGetLastError());
  }
  const Opnd Wqkv = md::weight(wts, ws, 0, C3, 0, NF);
  const Opnd Wpo = md::weight(wts, ws, 1, C, 0, NF);
  const Opnd Wkvf = md::weight(wts, ws, 2, C2, C, NF);
  const Opnd Wpof = md::weight(wts, ws, 3, C, 0, NF);
  for (int b0 = 0; b0 < B; b0 += imgs) {
    const int I = min(imgs, B - b0), P = I * HW;
    // this slice's rows: weight-gradient splits, taps segments, dLN blocks
    const int splits = (P + Ks - 1) / Ks, blocks = (P + PT - 1) / PT;
    const size_t pc = (size_t)P * C, base = (size_t)b0 * C * HW;
    // piece i as np planes [pixel][ld] (plane stride P ld), an image's
    // pixels zs apart
    auto pl = [&](Piece i, int np, int ld = 0) {
      return md::pixel_planes(bfp(i), np, P, ld ? ld : C, HW);
    };
    const size_t mlo = (size_t)I * C * C;  // plane stride of A, M, M^T
    auto per_image = [&](Piece i) {
      Opnd o = md::planes(bfp(i), mlo, NF);
      o.ld = C;
      o.zs = cc;
      return o;
    };
    const Opnd Ab = per_image(AP), Mb = per_image(MP), Mt = per_image(MTP);
    const float* stb = stats + (size_t)b0 * ES;
    const int segs = md::segments(I, H, W);
    const int g3 = md::taps_grid(C3, segs), g1 = md::taps_grid(C, segs);
    const long long sa = (long long)splits_a * cc;
    gm::Args a;
    if (mode != STAGE2) {
      // 1, 2
      ln_mdta_bwd_prep_kernel<T, NP>
          <<<(P + PT - 1) / PT, kThreads, md::prep_smem(C), st>>>(
              x + base, dy + base, scale, bias, stat2, bfp(LN), bfp(DY), P, HW,
              C, eps);
      UIR_TRY(cudaGetLastError());
      ln_mdta_bwd_attn_kernel<CPH, NF><<<I, kThreads, 0, st>>>(
          stb, wt.temp, f32p(A32), bfp(AP), mlo, C);
      UIR_TRY(cudaGetLastError());
      // 3, 4: u, then round(q), round(k) and v; 5-9: outs, out, u_vf, vf,
      // outf (csrc/mdta.cuh)
      UIR_TRY((md::qkv_stage<T, MdtaBwdF32Epi>(
          ln_mdta_bwd_taps_kernel<T>, pl(LN, NP), Wqkv, wt.tqkv, f32p(U),
          bfp(QK), bfp(V), nullptr, I, H, W, C, st)));
      UIR_TRY((md::apply_stage<T, MdtaBwdRoundEpi, MdtaBwdF32Epi>(
          ln_mdta_bwd_taps_kernel<T>, pl(V, NF), Ab, Wpo, Wkvf, wt.tkv + C, C2,
          bfp(OUTS), bfp(OUT), f32p(UVF), bfp(VF), bfp(OUTF), I, H, W, C, CPH,
          st)));
      // 10-15: d_outf, dvf, d(u_vf) and dtaps_vf, d_out, d_outs, dv
      UIR_TRY(gm::launch<TPn>(
          gm::simple(pl(DY, NP), Wpof, P, C, C), 1,
          MdtaBwdRoundEpi<T, NP>{{bfp(DOF), pc, C, P, C, 0}}, st));
      a = gm::simple(pl(DOF, NP), Ab, HW, C, C);
      a.band = CPH;
      UIR_TRY(gm::launch<TPt>(a, I, MdtaBwdF32Epi{{f32p(DVF), C, HW, C, HW}},
                              st));
      ln_mdta_bwd_taps_t_kernel<T><<<g1, DW_T, 0, st>>>(
          static_cast<const T*>(nullptr), 0, f32p(DVF), C, f32p(UVF), C,
          wt.tkv + C, C2, C, 0, bfp(DUVF), pc, f32p(ROWS_TV), segs, H, W);
      UIR_TRY(cudaGetLastError());
      UIR_TRY(gm::launch<TPf>(
          gm::simple(pl(DUVF, NF), Wkvf, P, C, C), 1,
          MdtaBwdRoundEpi<T, NP>{{bfp(DOUT), pc, C, P, C, 0}}, st));
      UIR_TRY(gm::launch<TPn>(
          gm::simple(pl(DOUT, NP), Wpo, P, C, C), 1,
          MdtaBwdRoundEpi<T, NP>{{bfp(DOUTS), pc, C, P, C, 0}}, st));
      a = gm::simple(pl(DOUTS, NP), Ab, HW, C, C);
      a.band = CPH;
      UIR_TRY(
          gm::launch<TPt>(a, I, MdtaBwdF32Epi{{f32p(DV), C, HW, C, HW}}, st));
      // 16, 17: dA over the head tiles, then the per-image softmax backward
      a = gm::simple(pl(DOF, NP), pl(VF, NF), C, C, HW);
      a.A[1] = pl(DOUTS, NP);
      a.B[1] = pl(V, NF);
      a.Ks = KsA;
      a.nprob = 2;
      a.splits = splits_a;
      a.diag = 1;
      UIR_TRY(gm::launch<TKf>(
          a, I,
          MdtaBwdRowsEpi{
              {{f32p(ROWS_A), f32p(ROWS_A) + sa}, C, {C, C}, 2 * sa}},
          st));
      if (mode == STAGE1) {
        // each image's dA, to be summed over the ranks
        ln_mdta_bwd_da_kernel<CPH><<<I, kThreads, 0, st>>>(
            f32p(ROWS_A), 2 * splits_a, dA + (size_t)b0 * C * CPH, C);
        UIR_TRY(cudaGetLastError());
        continue;
      }
    }
    if (mode == WHOLE) {
      const size_t ssm = (2 * (size_t)C * CPH + 3 * C) * sizeof(float);
      static const cudaError_t es = gm::set_smem(
          ln_mdta_bwd_softmax_kernel<CPH, NF>,
          (2 * (size_t)MAX_C * CPH + 3 * MAX_C) * sizeof(float));
      UIR_TRY(es);
      ln_mdta_bwd_softmax_kernel<CPH, NF><<<I, kThreads, ssm, st>>>(
          stb, wt.temp, f32p(A32), f32p(ROWS_A), 2 * splits_a, bfp(MP),
          bfp(MTP), f32p(ALPHA), dtemp + (size_t)b0 * (C / CPH), C);
    } else {
      const size_t ssm = (3 * (size_t)C * CPH + 3 * C) * sizeof(float);
      static const cudaError_t es = gm::set_smem(
          ln_mdta_bwd_softmax_split_kernel<CPH, NF>,
          (3 * (size_t)MAX_C * CPH + 3 * MAX_C) * sizeof(float));
      UIR_TRY(es);
      ln_mdta_bwd_softmax_split_kernel<CPH, NF><<<I, kThreads, ssm, st>>>(
          stb, wt.temp, f32p(A32), dA + (size_t)b0 * C * CPH,
          dAt + (size_t)b0 * C * CPH, bfp(MP), bfp(MTP), f32p(ALPHA),
          dtemp + (size_t)b0 * (C / CPH), C);
    }
    UIR_TRY(cudaGetLastError());
    // 18, 19: dq, dk; d(u_qkv) and dtaps_qkv
    const Opnd qk = pl(QK, NP, C2);
    const Opnd kk{{qk.pl[0] + C, qk.pl[1] + C, qk.pl[2] + C}, C2, qk.zs};
    a = gm::simple(kk, Mb, HW, C, C);
    a.A[1] = qk;
    a.B[1] = Mt;
    a.nprob = 2;
    a.band = CPH;
    UIR_TRY(gm::launch<TPn>(
        a, I,
        MdtaBwdDqkEpi<T, NP>{bfp(QK), (size_t)P * C2, f32p(ALPHA), dqk, HW,
                             C, r0 * W, r1 * W},
        st));
    ln_mdta_bwd_taps_t_kernel<T><<<g3, DW_T, 0, st>>>(
        dqk, C2, f32p(DV), C, f32p(U), C3, wt.tqkv, C3, C3, C2, bfp(DU),
        (size_t)P * C3, f32p(ROWS_TQ), segs, H, W);
    UIR_TRY(cudaGetLastError());
    // 20, 21: the weight gradients, split over pixel ranges
    a = gm::simple(pl(OUTF, NP), pl(DY, NP), C, C, P);
    a.A[1] = pl(OUTS, NP);
    a.B[1] = pl(DOUT, NP);
    a.Ks = Ks;
    a.nprob = 2;
    a.splits = splits;
    const long long sw = (long long)splits * cc;
    UIR_TRY(gm::launch<TKt>(
        a, 1,
        MdtaBwdRowsEpi{{{f32p(ROWS_W1), f32p(ROWS_W1) + sw}, C, {C, C}, 0}},
        st));
    a = gm::simple(pl(OUT, NP), pl(DUVF, NF), C, C, P);
    a.A[1] = pl(LN, NP);
    a.B[1] = pl(DU, NF, C3);
    a.N[1] = C3;
    a.Ks = Ks;
    a.nprob = 2;
    a.splits = splits;
    UIR_TRY(gm::launch<TKf>(
        a, 1,
        MdtaBwdRowsEpi{{{f32p(ROWS_KVF), f32p(ROWS_QKV)}, C, {C, C3}, 0}},
        st));
    // 22: dLN and the LayerNorm backward
    const MdtaBwdDlnEpi<T> de{x + base, dy + base, dx + base, stat2, scale,
                              f32p(ROWS_LN), P, C, HW};
    const gm::Args ad = gm::simple(pl(DU, NF, C3), Wqkv, P, C, C3);
    if (C <= 128)
      UIR_TRY((gm::launch<Tile<PT, 128, 1, 8, false, false, NF, NF>>(
          ad, 1, de, st)));
    else
      UIR_TRY((gm::launch<Tile<PT, 256, 1, 8, false, false, NF, NF>>(
          ad, 1, de, st)));
    // 23: the rows, in order, into the gradients
    const int c2 = C * C;
    UIR_TRY(gm::reduce_rows<7>(
        {{f32p(ROWS_W1), splits, c2, 0, 0, 0},
         {f32p(ROWS_KVF), splits, c2, c2, 0, 0},
         {f32p(ROWS_TV), segs, 9 * C, 2 * c2, 0, 0},
         {f32p(ROWS_W1) + sw, splits, c2, 2 * c2 + 9 * C, 0, 0},
         {f32p(ROWS_QKV), splits, 3 * c2, 3 * c2 + 9 * C, 0, 0},
         {f32p(ROWS_TQ), segs, 27 * C, 6 * c2 + 9 * C, 0, 0},
         {f32p(ROWS_LN), blocks, 2 * C, 6 * c2 + 36 * C, 0, 0}},
        grads, b0 > 0 || accumulate, st));
  }
  return 0;
}

int run(Mode mode, const void* x, const void* dy, void* dx,
        const void* scale, const void* bias, const void* wqkv,
        const void* tqkv, const void* wpo, const void* wkv, const void* tkv,
        const void* wpof, const void* temp, const void* stats, void* work,
        void* grads, void* dtemp, void* dA, const void* dAt, int B, int C,
        int H, int W, int cph, int bf16, int imgs, int Ks, int KsA, int r0,
        int r1, int accumulate, float eps, void* stream) {
  if (C % 16 || C > MAX_C || C % cph || B < 1 || H < 1 || W < 1 ||
      imgs < 1 || Ks < gm::BK || Ks % gm::BK || KsA < gm::BK ||
      KsA % gm::BK || (H * W + KsA - 1) / KsA > md::MAX_SPLITS_A ||
      r0 < 0 || r1 > H || r0 >= r1 || (mode != WHOLE && B > imgs))
    return (int)cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const md::Weights wt{f(wqkv), f(wpo), f(wkv), f(wpof), f(tqkv), f(tkv),
                       f(temp)};
  auto* wk = static_cast<unsigned char*>(work);
  auto* gr = static_cast<float*>(grads);
  auto* dt = static_cast<float*>(dtemp);
  auto* da = static_cast<float*>(dA);
  auto st = static_cast<cudaStream_t>(stream);
#define UIR_MDTA_BWD(TT, CPH)                                               \
  return launch<TT, CPH>(mode, static_cast<const TT*>(x),                  \
                         static_cast<const TT*>(dy), static_cast<TT*>(dx), \
                         f(scale), f(bias), wt, f(stats), wk, gr, dt, da,  \
                         f(dAt), B, C, H, W, imgs, Ks, KsA, r0, r1,        \
                         accumulate, eps, st)
  if (bf16) {
    if (cph == 8) UIR_MDTA_BWD(__nv_bfloat16, 8);
    if (cph == 16) UIR_MDTA_BWD(__nv_bfloat16, 16);
    if (cph == 32) UIR_MDTA_BWD(__nv_bfloat16, 32);
  } else {
    if (cph == 8) UIR_MDTA_BWD(float, 8);
    if (cph == 16) UIR_MDTA_BWD(float, 16);
    if (cph == 32) UIR_MDTA_BWD(float, 32);
  }
#undef UIR_MDTA_BWD
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The backward over the batch in slices of `imgs` images: one launch a call
// (the weights' planes), then 23 a slice.  The weights in f32 as their
// parameters store them: w_qkv (C, 3C), w_po (C, C), w_kv (C, 2C) (its vf
// half read in place), w_pof (C, C), t_qkv (3, 3, 3C), t_kv (3, 3, 2C)
// (its vf half read in place); stats [B][C cph + 2C] as the forward wrote
// them.  work: one slice's workspace (Layout); grads [6C^2 + 38C] as
// ops/fused_mdta.py lays them out; dtemp [B][C / cph].  Ks: pixels a split
// of the weight-gradient products, KsA of an image's dA product (multiples
// of 32).
extern "C" int uir_ln_mdta_bwd(
    const void* x, const void* dy, void* dx, const void* scale,
    const void* bias, const void* wqkv, const void* tqkv, const void* wpo,
    const void* wkv, const void* tkv, const void* wpof, const void* temp,
    const void* stats, void* work, void* grads, void* dtemp, int B, int C,
    int H, int W, int cph, int bf16, int imgs, int Ks, int KsA, float eps,
    void* stream) {
  return run(WHOLE, x, dy, dx, scale, bias, wqkv, tqkv, wpo, wkv, tkv, wpof,
             temp, stats, work, grads, dtemp, nullptr, nullptr, B, C, H, W,
             cph, bf16, imgs, Ks, KsA, 0, H, 0, eps, stream);
}

// The backward's first half on one slice of B <= imgs images of a band of
// a row-sharded map (x and dy: the band with its halo rows, dy zero on
// them; stats: the sum over the ranks): the weights' planes, steps 1-16,
// then each image's dA [B][C cph] (the rank's share) into dA: 18 launches.
// The workspace keeps what the second half reads.
extern "C" int uir_ln_mdta_bwd_stage1(
    const void* x, const void* dy, const void* scale, const void* bias,
    const void* wqkv, const void* tqkv, const void* wpo, const void* wkv,
    const void* tkv, const void* wpof, const void* temp, const void* stats,
    void* work, void* dA, int B, int C, int H, int W, int cph, int bf16,
    int imgs, int Ks, int KsA, float eps, void* stream) {
  return run(STAGE1, x, dy, nullptr, scale, bias, wqkv, tqkv, wpo, wkv, tkv,
             wpof, temp, stats, work, nullptr, nullptr, dA, nullptr, B, C, H,
             W, cph, bf16, imgs, Ks, KsA, 0, H, 0, eps, stream);
}

// Its second half on the same slice and workspace: steps 17-23 from dA
// (the sum over the ranks) and dAt (the rank's own, for dtemp), dq and dk
// zero outside rows [r0, r1) (the band without its halo: the q and k the
// stats hold); dx [B] and dtemp [B][C / cph], the weight gradients added
// to grads when accumulate (a later slice): 7 launches.  With r0 = 0, r1 =
// H and dA = dAt, the two halves give uir_ln_mdta_bwd's bits.
extern "C" int uir_ln_mdta_bwd_stage2(
    const void* x, const void* dy, void* dx, const void* scale,
    const void* bias, const void* wqkv, const void* tqkv, const void* wpo,
    const void* wkv, const void* tkv, const void* wpof, const void* temp,
    const void* stats, void* work, void* grads, void* dtemp, const void* dA,
    const void* dAt, int B, int C, int H, int W, int cph, int bf16, int imgs,
    int Ks, int KsA, int r0, int r1, int accumulate, float eps,
    void* stream) {
  return run(STAGE2, x, dy, dx, scale, bias, wqkv, tqkv, wpo, wkv, tkv, wpof,
             temp, stats, work, grads, dtemp, const_cast<void*>(dA), dAt, B,
             C, H, W, cph, bf16, imgs, Ks, KsA, r0, r1, accumulate, eps,
             stream);
}
