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
// Design.  The softmax couples every pixel of an image: dA, summed over all
// pixels, is needed before any dq or dk.  So three launches:
//   (a) v pass, over TH x TW tiles: recompute A from the forward's saved
//       per-image stats (gram G, row sums of squares Sq, Sk) and the
//       temperature; with LN on a 2-pixel halo, v and out on the 1-pixel
//       halo, vf and outf on the tile (as the apply kernel).  Then the
//       cotangents: d_outf = round(W_pof dy) on the 1-pixel halo, dvf =
//       A^T d_outf, d(u_vf) by the transposed taps, d_out = round(W_kvf
//       d(u_vf)), d_outs = round(W_po d_out), dv = A^T d_outs (to global
//       memory, f32), and the tile's partial dA = sum d_outf vf^T + d_outs
//       v^T.  The tile's shares of dW_pof, dW_kvf, dtaps_vf and dW_po go to
//       the block's partial row.  The last tile of each image to finish
//       (atomic ticket) sums that image's dA partials in tile order and does
//       the per-image softmax and l2-normalize backward: dS = A (dA -
//       rowsum(dA A)), dtemp = sum dS Ghat with Ghat = G rq rk, dP = temp dS,
//       and writes M = rq dP rk^T, alpha_q = rq^3 sum_j dP G rk and alpha_k
//       = rk^3 sum_i dP G rq, each zero where the row's S < 1e-24 (the
//       rsqrt(max(S, 1e-24)) gate, fused_attn.py:92).
//   (b) q/k pass, over tiles: recompute round(q), round(k) on the 1-pixel
//       halo; dq = round(M k - alpha_q q), dk = round(M^T q - alpha_k k);
//       read dv on the halo; the transposed taps of [dq; dk; dv] give
//       d(u_qkv) on the tile, then dLN = W_qkv d(u_qkv), the tile's shares
//       of dW_qkv and dtaps_qkv, and the LayerNorm backward (grad.cuh): dx
//       and the shares of dscale and dbias.
//   (c) the ordered sum of the blocks' partial rows (grad.cuh).
// Each block of (a) and (b) walks over tiles blockIdx.x, blockIdx.x +
// gridDim.x, ... and owns one partial row (the first Ea floats written by
// (a), the rest by (b)); no float atomics, and no result depends on block
// scheduling.  Cotangents round to the compute type where autograd through
// the plain version rounds them; weight-gradient sums are f32.  The chains
// stay unfolded (1x1, then the taps), so dW and dtaps come out directly; the
// TPU kernels' composed dK and its decomposition are not needed.  Plain FMA,
// no tensor cores yet.
//
// What bounds it on an H100.  Per pixel it recomputes the forward (about
// 2 * (4C^2 + 36C + 3C^2 + 4C * CPH) flops) and runs the backward chains
// (about twice that) against x, dy and dx (3 * C * itemsize bytes) plus dv
// (written and read once, f32): above the card's bf16 ridge at every level,
// so bound by operations at peak rates.  This version runs them on the f32
// FMA pipe (67 TFLOP/s).
#include <cstdint>

#include "grad.cuh"

namespace {

using uir::from_f;
using uir::round_to;
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

// out[c][q] = f(sum_i in[i][q] * w[i][c]) for every channel c < C and pixel
// q < np of channel-major buffers: a 1x1 conv, w [C][C]; f rounds to T when
// `round` is set.
template <typename TI, typename TO, typename T>
__device__ void project_all(TO* out, const TI* in, int np,
                            const float* __restrict__ w, int C, bool round) {
  for (int it = threadIdx.x; it < np * (C / 8); it += blockDim.x) {
    const int q = it % np, c8 = 8 * (it / np);
    float s[8];
    uir::project8<TI>(s, in, np, q, w + c8, C, C);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      out[(c8 + i) * np + q] = from_f<TO>(round ? round_to<T>(s[i]) : s[i]);
  }
}

// A = softmax_head(temp * G * rq * rk^T) of one image, [C][CPH]
template <int CPH>
__device__ void attention_matrix(float* A, const float* st,
                                 const float* __restrict__ temp, int C) {
  for (int i = threadIdx.x; i < C; i += blockDim.x) {
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
}

// dst[i][p] = round(sum_jj A[i][jj] * src[head(i) * CPH + jj][p])
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

// buf[h * CPH + jj][q] <- sum_i A[h * CPH + i][jj] * buf[h * CPH + i][q]:
// A^T applied per head and pixel, in place
template <int CPH>
__device__ void attend_t_inplace(float* buf, const float* A, int C, int np) {
  for (int it = threadIdx.x; it < np * (C / CPH); it += blockDim.x) {
    const int q = it % np, h = it / np;
    float* b = buf + (size_t)h * CPH * np + q;
    const float* ah = A + h * CPH * CPH;
    float in[CPH];
#pragma unroll
    for (int i = 0; i < CPH; ++i) in[i] = b[i * np];
#pragma unroll
    for (int jj = 0; jj < CPH; ++jj) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < CPH; ++i) s = fmaf(ah[i * CPH + jj], in[i], s);
      b[jj * np] = s;
    }
  }
}

// (a): see the file comment.  part row: dW_pof [C][C], dW_kvf [C][C],
// dtaps_vf [C][9], dW_po [C][C] (Ea floats), then (b)'s.  partA: one dA
// [C][CPH] per (image, tile); bstats: M [C][CPH], alpha_q [C], alpha_k [C]
// per image; dtemp_img [B][heads].
template <typename T, int CPH>
__global__ void __launch_bounds__(kThreads)
    ln_mdta_bwd_v_kernel(
        const T* __restrict__ x, const T* __restrict__ dy,
        const float* __restrict__ scale, const float* __restrict__ bias,
        const float* __restrict__ wqkv, const float* __restrict__ taps3,
        const float* __restrict__ wvf, const float* __restrict__ tvf,
        const float* __restrict__ wpo, const float* __restrict__ wpoT,
        const float* __restrict__ wpofT, const float* __restrict__ wvfT,
        const float* __restrict__ temp, const float* __restrict__ stats,
        float* __restrict__ dv, float* __restrict__ partA,
        int* __restrict__ counters, float* __restrict__ bstats,
        float* __restrict__ dtemp_img, float* __restrict__ part, int E,
        int B, int C, int H, int W, int TH, int TW, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int is_last;
  const int PW2 = TW + 2, NP2 = PW2 * (TH + 2);
  const int PW4 = TW + 4, NP4 = PW4 * (TH + 4), P = TH * TW;
  const int CC = C * CPH, NH = C / CPH;
  float* A = reinterpret_cast<float*>(smem);  // [C][CPH]
  float* dA = A + CC;                         // [C][CPH]
  float* pb = dA + CC;                        // [CH][NP4]
  float* v = pb + CH * NP4;                   // [C][NP2]
  float* uvf = v + (size_t)C * NP2;           // [C][NP2]: W_kvf^T out
  float* dof = uvf + (size_t)C * NP2;         // [C][NP2]: d_outf, then dvf
  float* vf = dof + (size_t)C * NP2;  // [C][P]: vf, d(u_vf), then d_outs
  float* ofd = vf + (size_t)C * P;    // [C][P]: outf (as T), then d_out
  T* r1 = reinterpret_cast<T*>(ofd + (size_t)C * P);  // LN [C][NP4], dy
  T* os = r1 + (size_t)C * NP4;                        // [C][NP2]: A v
  T* orr = os + (size_t)C * NP2;                       // [C][NP2]: out
  T* of = reinterpret_cast<T*>(ofd);

  const int tid = threadIdx.x;
  const int tiles_x = (W + TW - 1) / TW;
  const int per_img = tiles_x * ((H + TH - 1) / TH);
  const size_t plane = (size_t)H * W;
  const int ES = CC + 2 * C;  // floats of one image's stats / bstats
  float* g_pof = part + (size_t)blockIdx.x * E;
  float* g_kvf = g_pof + C * C;
  float* g_tvf = g_kvf + C * C;
  float* g_po = g_tvf + 9 * C;
  for (int e = tid; e < 3 * C * C + 9 * C; e += blockDim.x) g_pof[e] = 0.f;

  for (int tile = blockIdx.x; tile < B * per_img; tile += gridDim.x) {
    const int b = tile / per_img, t = tile % per_img;
    const int r0 = (t / tiles_x) * TH, c0 = (t % tiles_x) * TW;
    const float* st = stats + (size_t)b * ES;
    __syncthreads();  // the previous tile is done with every buffer
    attention_matrix<CPH>(A, st, temp, C);
    for (int i = tid; i < CC; i += blockDim.x) dA[i] = 0.f;
    uir::ln_patch<T>(x + (size_t)b * C * plane, r1, scale, bias, C, H, W,
                     r0 - 2, c0 - 2, TH + 4, PW4, eps);
    __syncthreads();

    // forward recompute: v on the 1-pixel halo, A v, out (zero outside the
    // image), u_vf = W_kvf^T out there, vf and outf on the tile
    for (int m = 0; m < C / CH; ++m) {
      project_chunk<T>(pb, r1, NP4, wqkv + 2 * C, 3 * C, C, m);
      __syncthreads();
      for (int it = tid; it < NP2 * CH; it += blockDim.x) {
        const int q = it % NP2, ch = it / NP2;
        v[(CH * m + ch) * NP2 + q] =
            uir::tap9(pb + ch * NP4 + (q / PW2) * PW4 + q % PW2, PW4,
                      taps3 + (2 * C + CH * m + ch) * 9);
      }
      __syncthreads();
    }
    attend<T, CPH>(os, v, A, C, NP2);
    __syncthreads();
    for (int it = tid; it < NP2 * (C / 8); it += blockDim.x) {
      const int q = it % NP2, c8 = 8 * (it / NP2);
      float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (uir::in_image(r0 - 1 + q / PW2, c0 - 1 + q % PW2, H, W))
        uir::project8<T>(s, os, NP2, q, wpo + c8, C, C);
#pragma unroll
      for (int i = 0; i < 8; ++i) orr[(c8 + i) * NP2 + q] = from_f<T>(s[i]);
    }
    __syncthreads();
    project_all<T, float, T>(uvf, orr, NP2, wvf, C, false);
    __syncthreads();
    for (int it = tid; it < P * C; it += blockDim.x) {
      const int p = it % P, c = it / P;
      vf[c * P + p] = uir::tap9(uvf + c * NP2 + (p / TW) * PW2 + p % TW, PW2,
                                tvf + c * 9);
    }
    __syncthreads();
    attend<T, CPH>(of, vf, A, C, P);
    // dy on the 1-pixel halo (zero outside the image) over the dead LN
    const T* dyg = dy + (size_t)b * C * plane;
    for (int i = tid; i < C * NP2; i += blockDim.x) {
      const int ch = i / NP2, q = i % NP2;
      const int r = r0 - 1 + q / PW2, cc = c0 - 1 + q % PW2;
      r1[i] = uir::in_image(r, cc, H, W) ? dyg[ch * plane + (size_t)r * W + cc]
                                         : from_f<T>(0.f);
    }
    __syncthreads();

    // dW_pof share (outf dy^T); d_outf = round(W_pof dy) on the halo
    uir::outer_acc<T, T>(g_pof, C, of, 0, C, r1, 1, C, TH, TW);
    project_all<T, float, T>(dof, r1, NP2, wpofT, C, true);
    __syncthreads();
    // dA = sum_p d_outf vf^T per head (the d_outs v^T half comes below)
    for (int h = 0; h < NH; ++h)
      uir::outer_acc<float, float>(dA + h * CPH * CPH, CPH,
                                   dof + (size_t)h * CPH * NP2, 1, CPH,
                                   vf + (size_t)h * CPH * P, 0, CPH, TH, TW);
    __syncthreads();
    attend_t_inplace<CPH>(dof, A, C, NP2);  // dvf = A^T d_outf
    __syncthreads();
    // d(u_vf) on the tile (into vf); dtaps_vf share
    uir::tap9_t<float>(vf, dof, tvf, C, TH, TW, r0, c0, H, W);
    uir::tap_grad_acc<float>(g_tvf, dof, 1, uvf, 1, C, TH, TW);
    __syncthreads();
    // dW_kvf share (out d(u_vf)^T); d_out = round(W_kvf d(u_vf))
    uir::outer_acc<T, float>(g_kvf, C, orr, 1, C, vf, 0, C, TH, TW);
    project_all<float, float, T>(ofd, vf, P, wvfT, C, true);
    __syncthreads();
    // dW_po share (outs d_out^T); d_outs = round(W_po d_out) (into vf)
    uir::outer_acc<T, float>(g_po, C, os, 1, C, ofd, 0, C, TH, TW);
    project_all<float, float, T>(vf, ofd, P, wpoT, C, true);
    __syncthreads();
    // dA += sum_p d_outs v^T per head, then the tile's partial to global
    // memory; dv = A^T d_outs
    for (int h = 0; h < NH; ++h)
      uir::outer_acc<float, float>(dA + h * CPH * CPH, CPH,
                                   vf + (size_t)h * CPH * P, 0, CPH,
                                   v + (size_t)h * CPH * NP2, 1, CPH, TH, TW);
    for (int it = tid; it < P * NH; it += blockDim.x) {
      const int p = it % P, h = it / P;
      const int r = r0 + p / TW, cc = c0 + p % TW;
      if (!uir::in_image(r, cc, H, W)) continue;
      const float* ah = A + h * CPH * CPH;
      float in[CPH];
#pragma unroll
      for (int i = 0; i < CPH; ++i) in[i] = vf[(h * CPH + i) * P + p];
      float* out = dv + ((size_t)b * C + h * CPH) * plane + (size_t)r * W + cc;
#pragma unroll
      for (int jj = 0; jj < CPH; ++jj) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < CPH; ++i) s = fmaf(ah[i * CPH + jj], in[i], s);
        out[jj * plane] = s;
      }
    }
    __syncthreads();
    float* mine = partA + ((size_t)b * per_img + t) * CC;
    for (int it = tid; it < CC; it += blockDim.x) mine[it] = dA[it];

    // the last tile of image b to finish does the per-image step
    __threadfence();
    __syncthreads();
    if (tid == 0) is_last = atomicAdd(counters + b, 1) == per_img - 1;
    __syncthreads();
    if (!is_last) continue;
    __threadfence();
    float* dAt = v;    // [C][CPH]: dA of the image
    float* dP = uvf;   // [C][CPH]
    float* rq = pb;    // [C]
    float* rk = pb + C;
    float* rowdt = pb + 2 * C;
    const float* pa = partA + (size_t)b * per_img * CC;
    for (int e = tid; e < CC; e += blockDim.x) {
      float s = 0.f;
      for (int tt = 0; tt < per_img; ++tt)
        s += __ldcg(pa + (size_t)tt * CC + e);
      dAt[e] = s;
    }
    for (int i = tid; i < C; i += blockDim.x) {
      rq[i] = rsqrtf(fmaxf(st[CC + i], 1e-24f));
      rk[i] = rsqrtf(fmaxf(st[CC + C + i], 1e-24f));
    }
    __syncthreads();
    float* bs = bstats + (size_t)b * ES;
    for (int i = tid; i < C; i += blockDim.x) {
      const int h = i / CPH;
      const float* ar = A + i * CPH;
      const float* dar = dAt + i * CPH;
      float s = 0.f;
      for (int jj = 0; jj < CPH; ++jj) s = fmaf(dar[jj], ar[jj], s);
      float rd = 0.f, cq = 0.f;
      for (int jj = 0; jj < CPH; ++jj) {
        const float g = st[i * CPH + jj];
        const float rkj = rk[h * CPH + jj];
        const float ds = ar[jj] * (dar[jj] - s);
        rd = fmaf(ds, g * rq[i] * rkj, rd);
        const float dp = temp[h] * ds;
        dP[i * CPH + jj] = dp;
        bs[i * CPH + jj] = rq[i] * dp * rkj;
        cq = fmaf(dp * g, rkj, cq);
      }
      rowdt[i] = rd;
      bs[CC + i] = st[CC + i] >= 1e-24f ? rq[i] * rq[i] * rq[i] * cq : 0.f;
    }
    __syncthreads();
    for (int j = tid; j < C; j += blockDim.x) {
      const int h = j / CPH, jj = j % CPH;
      float ck = 0.f;
      for (int ii = 0; ii < CPH; ++ii) {
        const int i = h * CPH + ii;
        ck = fmaf(dP[i * CPH + jj] * st[i * CPH + jj], rq[i], ck);
      }
      bs[CC + C + j] =
          st[CC + C + j] >= 1e-24f ? rk[j] * rk[j] * rk[j] * ck : 0.f;
    }
    for (int h = tid; h < NH; h += blockDim.x) {
      float s = 0.f;
      for (int ii = 0; ii < CPH; ++ii) s += rowdt[h * CPH + ii];
      dtemp_img[b * NH + h] = s;
    }
    if (tid == 0) counters[b] = 0;
  }
}

// (b): see the file comment.  Its part-row slice (after (a)'s Ea floats):
// dW_qkv [C][3C], dtaps_qkv [3C][9], dscale [C], dbias [C].
template <typename T, int CPH>
__global__ void __launch_bounds__(kThreads)
    ln_mdta_bwd_qk_kernel(
        const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ dx,
        const float* __restrict__ scale, const float* __restrict__ bias,
        const float* __restrict__ wqkv, const float* __restrict__ taps3,
        const float* __restrict__ wqkvT, const float* __restrict__ bstats,
        const float* __restrict__ dv, float* __restrict__ part, int E,
        int Ea, int B, int C, int H, int W, int TH, int TW, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int PW2 = TW + 2, NP2 = PW2 * (TH + 2);
  const int PW4 = TW + 4, NP4 = PW4 * (TH + 4), P = TH * TW;
  const int CC = C * CPH;
  float* Mb = reinterpret_cast<float*>(smem);  // [C][CPH], alpha_q, alpha_k
  float* pb = Mb + CC + 2 * C;                 // [CH][NP4]
  float* dvb = pb + CH * NP4;                  // [C][NP2]
  float* du = dvb + (size_t)C * NP2;           // [CH][P]
  float* acc = du + CH * P;                    // [C][P]: dLN, f32
  T* ln = reinterpret_cast<T*>(acc + (size_t)C * P);  // [C][NP4]
  T* qk = ln + (size_t)C * NP4;  // [2C][NP2]: round(q), round(k); dq, dk

  const int tid = threadIdx.x;
  const int tiles_x = (W + TW - 1) / TW;
  const int per_img = tiles_x * ((H + TH - 1) / TH);
  const size_t plane = (size_t)H * W;
  const int nqk = 2 * C / CH;
  float* g_w = part + (size_t)blockIdx.x * E + Ea;
  float* g_t = g_w + 3 * C * C;
  float* g_sc = g_t + 27 * C;
  float* g_bi = g_sc + C;
  for (int e = tid; e < 3 * C * C + 29 * C; e += blockDim.x) g_w[e] = 0.f;

  for (int tile = blockIdx.x; tile < B * per_img; tile += gridDim.x) {
    const int b = tile / per_img, t = tile % per_img;
    const int r0 = (t / tiles_x) * TH, c0 = (t % tiles_x) * TW;
    const T* xb = x + (size_t)b * C * plane;
    __syncthreads();  // the previous tile is done with every buffer
    const float* bs = bstats + (size_t)b * (CC + 2 * C);
    for (int i = tid; i < CC + 2 * C; i += blockDim.x) Mb[i] = bs[i];
    uir::ln_patch<T>(xb, ln, scale, bias, C, H, W, r0 - 2, c0 - 2, TH + 4,
                     PW4, eps);
    const float* dvg = dv + (size_t)b * C * plane;
    for (int i = tid; i < C * NP2; i += blockDim.x) {
      const int ch = i / NP2, q = i % NP2;
      const int r = r0 - 1 + q / PW2, cc = c0 - 1 + q % PW2;
      dvb[i] = uir::in_image(r, cc, H, W)
                   ? dvg[ch * plane + (size_t)r * W + cc] : 0.f;
    }
    for (int i = tid; i < C * P; i += blockDim.x) acc[i] = 0.f;
    __syncthreads();

    // round(q), round(k) on the 1-pixel halo, zero outside the image
    for (int m = 0; m < nqk; ++m) {
      project_chunk<T>(pb, ln, NP4, wqkv, 3 * C, C, m);
      __syncthreads();
      for (int it = tid; it < NP2 * CH; it += blockDim.x) {
        const int q = it % NP2, ch = it / NP2;
        const int qy = q / PW2, qx = q % PW2;
        float s = 0.f;
        if (uir::in_image(r0 - 1 + qy, c0 - 1 + qx, H, W))
          s = uir::tap9(pb + ch * NP4 + qy * PW4 + qx, PW4,
                        taps3 + (CH * m + ch) * 9);
        qk[(CH * m + ch) * NP2 + q] = from_f<T>(s);
      }
      __syncthreads();
    }
    // dq = round(M k - alpha_q q), dk = round(M^T q - alpha_k k), in place
    const float* aq = Mb + CC;
    const float* ak = aq + C;
    for (int it = tid; it < NP2 * (C / CPH); it += blockDim.x) {
      const int q = it % NP2, h = it / NP2;
      T* qh = qk + (size_t)h * CPH * NP2 + q;
      T* kh = qh + (size_t)C * NP2;
      const float* mh = Mb + h * CPH * CPH;
      float qv[CPH], kv[CPH];
#pragma unroll
      for (int i = 0; i < CPH; ++i) {
        qv[i] = to_f(qh[i * NP2]);
        kv[i] = to_f(kh[i * NP2]);
      }
#pragma unroll
      for (int i = 0; i < CPH; ++i) {
        float s = -aq[h * CPH + i] * qv[i];
#pragma unroll
        for (int j = 0; j < CPH; ++j) s = fmaf(mh[i * CPH + j], kv[j], s);
        qh[i * NP2] = from_f<T>(s);
      }
#pragma unroll
      for (int j = 0; j < CPH; ++j) {
        float s = -ak[h * CPH + j] * kv[j];
#pragma unroll
        for (int i = 0; i < CPH; ++i) s = fmaf(mh[i * CPH + j], qv[i], s);
        kh[j * NP2] = from_f<T>(s);
      }
    }
    __syncthreads();

    // chunks of [q; k; v]: u = W^T LN (for the taps' gradient), d(u) by the
    // transposed taps, the shares of dtaps and dW, dLN += W d(u)
    for (int m = 0; m < 3 * C / CH; ++m) {
      project_chunk<T>(pb, ln, NP4, wqkv, 3 * C, C, m);
      __syncthreads();
      const float* tm = taps3 + (size_t)CH * m * 9;
      if (m < nqk) {
        const T* src = qk + (size_t)CH * m * NP2;
        uir::tap9_t<T>(du, src, tm, CH, TH, TW, r0, c0, H, W);
        uir::tap_grad_acc<T>(g_t + CH * m * 9, src, 1, pb, 2, CH, TH, TW);
      } else {
        const float* src = dvb + (size_t)CH * (m - nqk) * NP2;
        uir::tap9_t<float>(du, src, tm, CH, TH, TW, r0, c0, H, W);
        uir::tap_grad_acc<float>(g_t + CH * m * 9, src, 1, pb, 2, CH, TH, TW);
      }
      __syncthreads();
      uir::outer_acc<T, float>(g_w + CH * m, 3 * C, ln, 2, C, du, 0, CH, TH,
                               TW);
      for (int it = tid; it < P * (C / 8); it += blockDim.x) {
        const int p = it % P, c8 = 8 * (it / P);
        float s[8];
        uir::project8<float>(s, du, P, p, wqkvT + (size_t)CH * m * C + c8, C,
                             CH);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[(c8 + i) * P + p] += s[i];
      }
      __syncthreads();
    }

    uir::ln_backward_tile<T>(xb, dy + (size_t)b * C * plane,
                             dx + (size_t)b * C * plane, acc, pb, scale, g_sc,
                             g_bi, C, H, W, r0, c0, TH, TW, eps);
  }
}

size_t smem_v(int C, int cph, int TH, int TW, size_t itemsize) {
  const size_t np2 = (size_t)(TH + 2) * (TW + 2);
  const size_t np4 = (size_t)(TH + 4) * (TW + 4), p = (size_t)TH * TW;
  return (2 * (size_t)C * cph + CH * np4 + 3 * C * np2 + 2 * C * p) *
             sizeof(float) +
         (C * np4 + 2 * C * np2) * itemsize;
}

size_t smem_qk(int C, int cph, int TH, int TW, size_t itemsize) {
  const size_t np2 = (size_t)(TH + 2) * (TW + 2);
  const size_t np4 = (size_t)(TH + 4) * (TW + 4), p = (size_t)TH * TW;
  return ((size_t)C * cph + 2 * C + CH * np4 + C * np2 + CH * p + C * p) *
             sizeof(float) +
         (C * np4 + 2 * C * np2) * itemsize;
}

struct Args {
  const void *x, *dy;
  void* dx;
  const float *scale, *bias, *wqkv, *taps3, *wqkvT, *wvf, *tvf, *wpo, *wpoT,
      *wpofT, *wvfT, *temp, *stats;
  float *dv, *partA;
  int* counters;
  float *bstats, *dtemp, *part, *grads;
  int B, C, H, W, THa, TWa, THb, TWb, groups;
  float eps;
  cudaStream_t stream;
};

template <typename T, int CPH>
int launch(const Args& a) {
  const int C = a.C;
  if (C % CH || !uir::tile_ok(a.THa, a.TWa) || !uir::tile_ok(a.THb, a.TWb))
    return (int)cudaErrorInvalidValue;
  const int Ea = 3 * C * C + 9 * C, E = Ea + 3 * C * C + 29 * C;
  auto kv = ln_mdta_bwd_v_kernel<T, CPH>;
  auto kq = ln_mdta_bwd_qk_kernel<T, CPH>;
  const size_t sv = smem_v(C, CPH, a.THa, a.TWa, sizeof(T));
  const size_t sq = smem_qk(C, CPH, a.THb, a.TWb, sizeof(T));
  cudaError_t e = uir::set_smem(kv, sv);
  if (e != cudaSuccess) return (int)e;
  e = uir::set_smem(kq, sq);
  if (e != cudaSuccess) return (int)e;
  kv<<<a.groups, kThreads, sv, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.dy), a.scale, a.bias,
      a.wqkv, a.taps3, a.wvf, a.tvf, a.wpo, a.wpoT, a.wpofT, a.wvfT, a.temp,
      a.stats, a.dv, a.partA, a.counters, a.bstats, a.dtemp, a.part, E, a.B, C,
      a.H, a.W, a.THa, a.TWa, a.eps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  kq<<<a.groups, kThreads, sq, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.dy),
      static_cast<T*>(a.dx), a.scale, a.bias, a.wqkv, a.taps3, a.wqkvT,
      a.bstats, a.dv, a.part, E, Ea, a.B, C, a.H, a.W, a.THb, a.TWb, a.eps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)uir::reduce_rows(a.part, a.grads, a.groups, E, a.stream);
}

}  // namespace

// Three launches: the v pass and the q/k pass (grid `groups` each; block g
// owns row g of part [groups][E]) and the ordered row sum into grads [E].
// dv [B][C][H][W], partA [B * tiles of the v pass][C][cph], counters [B]
// (zero on entry, zero again on exit), bstats [B][C * cph + 2C] and
// dtemp [B][C / cph] are scratch the wrapper allocates.
extern "C" int uir_ln_mdta_bwd(
    const void* x, const void* dy, void* dx, const void* scale,
    const void* bias, const void* wqkv, const void* taps3, const void* wqkvT,
    const void* wvf, const void* tvf, const void* wpo, const void* wpoT,
    const void* wpofT, const void* wvfT, const void* temp, const void* stats,
    void* dv, void* partA, void* counters, void* bstats, void* dtemp,
    void* part, void* grads, int B, int C, int H, int W, int cph, int bf16,
    int THa, int TWa, int THb, int TWb, int groups, float eps, void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  Args a{x, dy, dx, f(scale), f(bias), f(wqkv), f(taps3), f(wqkvT), f(wvf),
         f(tvf), f(wpo), f(wpoT), f(wpofT), f(wvfT), f(temp), f(stats),
         static_cast<float*>(dv), static_cast<float*>(partA),
         static_cast<int*>(counters), static_cast<float*>(bstats),
         static_cast<float*>(dtemp), static_cast<float*>(part),
         static_cast<float*>(grads), B, C, H, W, THa, TWa, THb, TWb, groups,
         eps, static_cast<cudaStream_t>(stream)};
  if (bf16) {
    if (cph == 8) return launch<__nv_bfloat16, 8>(a);
    if (cph == 16) return launch<__nv_bfloat16, 16>(a);
    if (cph == 32) return launch<__nv_bfloat16, 32>(a);
  } else {
    if (cph == 8) return launch<float, 8>(a);
    if (cph == 16) return launch<float, 16>(a);
    if (cph == 32) return launch<float, 32>(a);
  }
  return (int)cudaErrorInvalidValue;
}
