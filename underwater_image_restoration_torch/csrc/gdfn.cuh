// The tile's forward half shared by the LN + GDFN forward (csrc/ln_gdfn.cu)
// and backward (csrc/ln_gdfn_bwd.cu), both tile-local: a block owns a
// TH x TW pixel tile of one image and the halo its 3x3 taps need.
//   - ln_planes: round(LN x) over the tile and a halo of HALO pixels as
//     channel-major bf16 planes (zero outside the image, the depthwise
//     conv's padding), a thread a patch position;
//   - stage_weights: a chunk of G gate pairs' W_in columns and W_out rows
//     (bf16 hi/lo planes of the f32 weights) staged by cp.async, so the
//     next chunk's loads overlap this one's work;
//   - project_in: u = W_in^T LN over the halo on the tensor cores (M = halo
//     positions, N = 2G, K = C), f32 into shared memory;
//   - gelu_both and the tap sums (common.cuh tap9) of the epilogue.
// Operands: LN is exactly T (one bf16 plane in bf16, a hi/lo pair in f32);
// the weights are hi/lo pairs, so u takes 2 passes in bf16 and 3 in f32.
#pragma once

#include "grad.cuh"
#include "mma.cuh"

namespace uir {
namespace gdfn {

namespace mm = uir::mma;
using bf16 = __nv_bfloat16;

// gate pairs a chunk (ops/fused_gdfn.py GATE_CHUNK; a launch with another
// value is refused)
constexpr int G = 16;
constexpr int G2 = 2 * G;
// global loads a thread keeps in flight while staging a patch
constexpr int BATCH = 8;

__host__ __device__ constexpr int up16(int n) { return (n + 15) / 16 * 16; }
__host__ __device__ constexpr size_t al16(size_t n) {
  return (n + 15) / 16 * 16;
}

// gelu(t) and d gelu / dt, exact (erf) form: t Phi(t) and Phi(t) + t phi(t),
// from one erf
__device__ __forceinline__ void gelu_both(float t, float& g, float& gp) {
  const float e = erff(t * 0.70710678118654752f);
  g = 0.5f * t * (1.f + e);
  gp = 0.5f * (1.f + e) + t * 0.39894228040143268f * expf(-0.5f * t * t);
}

// A chunk's weights in shared memory: W_in columns [CP][2G] (row stride
// WLD) and W_out rows [G][CP] (row stride OLDW), two planes each (hi, lo);
// W_out at wo in a buffer of wbuf elements.
struct ChunkWeights {
  int CP, WLD, OLDW;
  size_t wi_pl, wo_pl, wo, wbuf;
  __host__ __device__ explicit ChunkWeights(int C) {
    CP = up16(C);
    WLD = mm::pad_ld(G2);
    OLDW = mm::pad_ld(CP);
    wi_pl = (size_t)CP * WLD;
    wo_pl = (size_t)G * OLDW;
    wo = 2 * wi_pl;
    wbuf = 2 * wi_pl + 2 * wo_pl;
  }
};

// x's raw bits in the LN planes: bf16 in plane 0; f32's upper 16 bits in
// plane 0 and lower 16 in plane 1 (exact, unlike the hi/lo split).
template <int NA>
__device__ __forceinline__ void put_bits(bf16* p, size_t lo, size_t i,
                                         float v) {
  const uint32_t u = __float_as_uint(v);
  reinterpret_cast<uint16_t*>(p)[i] = (uint16_t)(u >> 16);
  reinterpret_cast<uint16_t*>(p)[i + lo] = (uint16_t)(u & 0xffffu);
}
template <>
__device__ __forceinline__ void put_bits<1>(bf16* p, size_t, size_t i,
                                            float v) {
  p[i] = __float2bfloat16(v);  // v is a bf16 value: exact
}
template <int NA>
__device__ __forceinline__ float get_bits(const bf16* p, size_t lo,
                                          size_t i) {
  const auto* u = reinterpret_cast<const uint16_t*>(p);
  return __uint_as_float(((uint32_t)u[i] << 16) | u[i + lo]);
}
template <>
__device__ __forceinline__ float get_bits<1>(const bf16* p, size_t,
                                             size_t i) {
  return __bfloat162float(p[i]);
}

// The tile's LN patch (a halo of HALO pixels) into NA bf16 planes (plane
// stride lo, rows LS apart, zero outside the image): a thread a patch
// position stages its pixel's channels as raw bits in its own column of the
// planes (BATCH loads in flight; consecutive threads on consecutive
// positions), takes the statistics from there (f32, channels in order) and
// writes round(LN x) over the same column.  With stat, keeps the tile
// pixels' mean and rstd in stat [2][P].  Ends synchronized.
template <typename T, int NA, int HALO>
__device__ void ln_planes(const T* __restrict__ xb, bf16* ln, size_t lo,
                          int LS, const float* __restrict__ scale,
                          const float* __restrict__ bias, float* stat, int C,
                          int H, int W, int r0, int c0, int TH, int TW,
                          float eps) {
  const int PW = TW + 2 * HALO, NPQ = PW * (TH + 2 * HALO), P = TH * TW;
  const size_t plane = (size_t)H * W;
  for (int q = threadIdx.x; q < NPQ; q += blockDim.x) {
    const int qy = q / PW, qx = q % PW;
    const int r = r0 - HALO + qy, c = c0 - HALO + qx;
    if (!uir::in_image(r, c, H, W)) {  // zero bits: the conv's padding
      for (int ch = 0; ch < C; ++ch) put_bits<NA>(ln, lo, ch * LS + q, 0.f);
      continue;
    }
    const T* xp = xb + (size_t)r * W + c;
    for (int ch0 = 0; ch0 < C; ch0 += BATCH) {
      float v[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u)
        v[u] = ch0 + u < C ? to_f(xp[(ch0 + u) * plane]) : 0.f;
#pragma unroll
      for (int u = 0; u < BATCH; ++u)
        if (ch0 + u < C) put_bits<NA>(ln, lo, (ch0 + u) * LS + q, v[u]);
    }
    float s = 0.f;
    for (int ch = 0; ch < C; ++ch) s += get_bits<NA>(ln, lo, ch * LS + q);
    const float mean = s / C;
    float v = 0.f;
    for (int ch = 0; ch < C; ++ch) {
      const float d = get_bits<NA>(ln, lo, ch * LS + q) - mean;
      v += d * d;
    }
    const float rstd = rsqrtf(v / C + eps);
    for (int ch = 0; ch < C; ++ch)
      mm::put<NA>(ln, lo, ch * LS + q,
                  round_to<T>((get_bits<NA>(ln, lo, ch * LS + q) - mean) *
                                  rstd * __ldg(scale + ch) +
                              __ldg(bias + ch)));
    if (stat != nullptr && qy >= HALO && qy < TH + HALO && qx >= HALO &&
        qx < TW + HALO) {
      const int p = (qy - HALO) * TW + qx - HALO;
      stat[p] = mean;
      stat[P + p] = rstd;
    }
  }
  __syncthreads();
}

// cp.async of chunk m's W_in columns [CP][2G] and W_out rows [G][CP] (both
// planes; rows or columns past C zero-filled) into buffer w.
__device__ inline void stage_weights(bf16* w, const bf16* win_h,
                                     const bf16* win_l, const bf16* wo_h,
                                     const bf16* wo_l, const ChunkWeights& L,
                                     int C, int wcols, int m) {
  for (int i = threadIdx.x; i < L.CP * (G2 / 8); i += blockDim.x) {
    const int c = i / (G2 / 8), cc = 8 * (i % (G2 / 8));
    const bool ok = c < C;
    const size_t src = (size_t)c * wcols + G2 * m + cc;
    bf16* d = w + c * L.WLD + cc;
    mm::cp_async16(d, ok ? win_h + src : win_h, ok);
    mm::cp_async16(d + L.wi_pl, ok ? win_l + src : win_l, ok);
  }
  const int nc = L.CP / 8;
  for (int i = threadIdx.x; i < G * nc; i += blockDim.x) {
    const int g = i / nc, cc = 8 * (i % nc);
    const bool ok = cc < C;
    const size_t src = (size_t)(G * m + g) * C + cc;
    bf16* d = w + L.wo + g * L.OLDW + cc;
    mm::cp_async16(d, ok ? wo_h + src : wo_h, ok);
    mm::cp_async16(d + L.wo_pl, ok ? wo_l + src : wo_l, ok);
  }
}

// u = W_in^T LN over the patch (M = patch positions in MQ / 16 tiles of 16,
// N = 2G, K = CP), a warp an m tile: ub [2G][NPQ] f32 for positions < NPQ.
// ln: NA planes [CP][LSL] (plane stride ln_pl); wi: the chunk's W_in
// buffer (ChunkWeights).
template <int NA>
__device__ void project_in(float* ub, int NPQ, int MQ, const bf16* ln,
                           size_t ln_pl, int LSL, const bf16* wi,
                           const ChunkWeights& L, int nwarp) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  for (int mt = warp; mt < MQ / 16; mt += nwarp) {
    float a4[4][4] = {};
    for (int k0 = 0; k0 < L.CP; k0 += 16) {
      uint32_t a[NA][4], bw[4][2][2];
#pragma unroll
      for (int pl = 0; pl < NA; ++pl)
        mm::frag_a<true>(a[pl], ln + pl * ln_pl + k0 * LSL + mt * 16, LSL);
#pragma unroll
      for (int np = 0; np < 2; ++np)
#pragma unroll
        for (int pl = 0; pl < 2; ++pl) {
          uint32_t r[4];
          mm::frag_b2<true>(r, wi + pl * L.wi_pl + k0 * L.WLD + 16 * np,
                            L.WLD);
          bw[2 * np][pl][0] = r[0], bw[2 * np][pl][1] = r[1];
          bw[2 * np + 1][pl][0] = r[2], bw[2 * np + 1][pl][1] = r[3];
        }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mm::mma_split<NA, 2>(a4[ni], a, bw[ni]);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = mt * 16 + g8 + 8 * (e >> 1);
        if (q < NPQ) ub[(ni * 8 + 2 * t4 + (e & 1)) * NPQ + q] = a4[ni][e];
      }
  }
}

}  // namespace gdfn
}  // namespace uir
