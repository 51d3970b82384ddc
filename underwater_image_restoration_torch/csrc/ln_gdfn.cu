// LN + GDFN forward: y = x + W_out^T (gelu(t1) * t2),
// [t1; t2] = dwconv3x3(W_in^T LayerNorm_C(x)), on channels-first (B, C, H, W).
//
// Replaces the TPU kernel of the JAX package
// ops/fused_gdfn_banded.py:479 _fwd_call (_fwd_kernel:187), and computes the
// same function as fused_block.py:628 _fwd_call.
//
// What bounds it on an H100.  Per pixel it needs 2 * 2hid * (C + 9) +
// 2 * hid * C flops against 2 * C * itemsize bytes of x and y (30-700
// flop/byte over the levels): at peak rates the 256x256 levels are bound by
// bytes, the deep ones by the tensor cores' operations.  Staging the 2 hid
// hidden values a pixel through device memory (as the LeFF forward does)
// would move about ten times x's bytes at C <= 32, so the design stays
// tile-local (as ln_gdfn_bwd.cu argues for the backward), with its 1x1
// products on the tensor cores, the chunk's weights staged once a block,
// and project_out's f32 accumulators in registers.
//
// Design.  A block owns a TH x TW tile of one image (ops/fused_gdfn.py
// fwd_tile_shape) and a range of the hidden chunks (a split; fwd_splits):
//   1. LN of the tile with a 1-pixel halo into channel-major bf16 planes (x
//      staged by coalesced loads; csrc/gdfn.cuh ln_planes), zero outside
//      the image, which is the depthwise conv's zero padding (the 1x1
//      before it has no bias);
//   2. per chunk of G gate pairs (t1 channel g with t2 channel hid + g), the
//      chunk's W_in columns and W_out rows staged by cp.async (the next
//      chunk's while this one computes; csrc/gdfn.cuh stage_weights), then
//      - u = W_in^T LN over the halo on the tensor cores (M = halo pixels,
//        N = 2G, K = C; csrc/gdfn.cuh project_in), f32 in shared memory, not
//        rounded (the TPU kernel's composed contraction does not round
//        between the 1x1 and the taps either);
//      - the 3x3 taps and the gate on the FMA pipe, o = round(gelu(t1) t2)
//        into bf16 planes [G][P], a thread a gate pair and tile column
//        sliding a 3x3 window of u down its rows, the taps in registers;
//      - project_out on the tensor cores: acc += W_out^T o (M = C, N = tile
//        pixels, K = G), its f32 accumulators in registers over the chunks
//        (C_pad x P <= 8192: 32 a thread);
//   3. acc through a shared tile to y = x + round(acc) in NCHW (consecutive
//      threads on consecutive pixels of a channel); or, where the hidden
//      width is split over blocks to fill the card (few tiles: the deep
//      levels at small batch), each split's acc as an f32 row of partial
//      sums, and a second launch y = x + round(sum of the rows in order).
// Hidden widths (42, 85, 170, 340) are zero-padded by the wrapper to a
// multiple of G: a zero column of W_in gives t = 0, gelu(0) * 0 = 0, and
// the zero row of W_out adds nothing.  Operands: LN and o are exactly T
// (one bf16 plane in bf16, a hi/lo pair in f32) and the f32 weights hi/lo
// pairs, made once a call by the wrapper: a product takes 2 passes in bf16
// and 3 in f32.  No float atomics: two runs give the same bits.
//
// Rounding points (the TPU kernel's): LN and the gate output round to T;
// project_in and the taps stay f32; y = round(x + round(project_out)).
#include <cstdint>
#include <type_traits>

#include "gdfn.cuh"

namespace {

namespace mm = uir::mma;
namespace gd = uir::gdfn;
using bf16 = __nv_bfloat16;
using gd::G;
using gd::G2;
using gd::al16;
using gd::up16;
using uir::from_f;
using uir::round_to;
using uir::to_f;

constexpr int kThreads = 256;
constexpr int NWARP = kThreads / 32;
// project_out's accumulator tiles (16 channels x 16 pixels) a warp:
// C_pad x P <= ACC_TILES * NWARP * 256 = 8192 (ops/fused_gdfn.py FWD_ACC)
constexpr int ACC_TILES = 4;

// Shared-memory layout of one block (ops/fused_gdfn.py fwd_shared_bytes
// mirrors it).  NA: planes of LN and o (2 in f32).  LN on the 1-pixel halo,
// channel-major [CP][LSL] (M space [0, MQ)); f32 u [2G][NP2]; the chunk's
// weights (csrc/gdfn.cuh ChunkWeights) in two buffers; o [G][LDP].  After
// the chunks the f32 y tile [C][P] takes the room of LN and u.
struct Smem {
  int CP, NP2, P, MQ, LSL, LDP;
  size_t ln, ub, wts, ov, total;
  __host__ __device__ Smem(int C, int TH, int TW, int NA) {
    const gd::ChunkWeights cw(C);
    CP = up16(C);
    NP2 = (TH + 2) * (TW + 2);
    P = TH * TW;
    MQ = up16(NP2);
    LSL = mm::pad_ld(MQ);
    LDP = mm::pad_ld(P);
    const size_t b2 = sizeof(bf16);
    const size_t lnb = al16(NA * (size_t)CP * LSL * b2);
    const size_t ubb = 4 * (size_t)G2 * NP2, accb = 4 * (size_t)C * P;
    ln = 0;
    ub = lnb;
    wts = ub + al16(accb > lnb + ubb ? accb - lnb : ubb);
    ov = wts + al16(2 * cw.wbuf * b2);
    total = ov + al16(NA * (size_t)G * LDP * b2);
  }
};

// win_h/win_l: the hi/lo planes of W_in [C][2 hid_pad] in the chunk layout
// (chunk m at columns [2Gm, 2Gm + G) for t1, [2Gm + G, 2G(m + 1)) for t2);
// taps: [2 hid_pad][9] f32 in the same channel order; wo_h/wo_l: W_out
// [hid_pad][C].  Block (tile, split): chunks [split nch / splits, (split +
// 1) nch / splits); part [splits][B][C][H][W] when splits > 1.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ln_gdfn_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
                       float* __restrict__ part,
                       const float* __restrict__ scale,
                       const float* __restrict__ bias,
                       const bf16* __restrict__ win_h,
                       const bf16* __restrict__ win_l,
                       const float* __restrict__ taps,
                       const bf16* __restrict__ wo_h,
                       const bf16* __restrict__ wo_l, int B, int C, int H,
                       int W, int hid_pad, int TH, int TW, float eps) {
  constexpr int NA = std::is_same<T, float>::value ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem L(C, TH, TW, NA);
  const gd::ChunkWeights cw(C);
  bf16* ln = reinterpret_cast<bf16*>(smem + L.ln);
  float* ub = reinterpret_cast<float*>(smem + L.ub);  // [2G][NP2]: u
  bf16* wts = reinterpret_cast<bf16*>(smem + L.wts);
  bf16* ov = reinterpret_cast<bf16*>(smem + L.ov);    // [NA][G][LDP]
  float* yt = reinterpret_cast<float*>(smem);         // [C][P], at the end
  const size_t ln_pl = (size_t)L.CP * L.LSL, ov_pl = (size_t)G * L.LDP;
  const int NP2 = L.NP2, P = L.P, PW2 = TW + 2;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int tiles_x = (W + TW - 1) / TW;
  const int per_img = tiles_x * ((H + TH - 1) / TH);
  const int b = blockIdx.x / per_img, t = blockIdx.x % per_img;
  const int r0 = (t / tiles_x) * TH, c0 = (t % tiles_x) * TW;
  const size_t plane = (size_t)H * W;
  const T* xb = x + (size_t)b * C * plane;
  const int wcols = 2 * hid_pad, nch = hid_pad / G;
  const int splits = gridDim.y, split = blockIdx.y;
  const int m_begin = split * nch / splits;
  const int m_end = (split + 1) * nch / splits;

  // LN rows past C and columns past the patch stay zero (the products read
  // them as padding)
  for (size_t i = tid; i < L.ub / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  gd::stage_weights(wts, win_h, win_l, wo_h, wo_l, cw, C, wcols, m_begin);
  mm::cp_async_commit();
  gd::ln_planes<T, NA, 1>(xb, ln, ln_pl, L.LSL, scale, bias, nullptr, C, H,
                          W, r0, c0, TH, TW, eps);

  // this thread's gate pair, tile column and run of rows in the gate phase:
  // RS = kThreads / (G TW) runs a column
  const int rs = kThreads / (G * TW);
  const int g_gate = tid / (TW * rs), px_gate = tid % TW;
  const int run_rows = (TH + rs - 1) / rs;
  const int py0_gate = (tid % (TW * rs)) / TW * run_rows;
  const int py1_gate = min(TH, py0_gate + run_rows);

  // project_out's accumulator tiles of this warp: w * tpw + i, tile (mt,
  // pp) = channels [16 mt, 16 mt + 16) x tile pixels [16 pp, 16 pp + 16)
  const int ntn = P / 16, ntt = (L.CP / 16) * ntn;
  const int tpw = (ntt + NWARP - 1) / NWARP;
  float acc[ACC_TILES][2][4];
#pragma unroll
  for (int i = 0; i < ACC_TILES; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int m = m_begin; m < m_end; ++m) {
    const int buf = (m - m_begin) & 1;
    if (m + 1 < m_end)
      gd::stage_weights(wts + (buf ^ 1) * cw.wbuf, win_h, win_l, wo_h, wo_l,
                        cw, C, wcols, m + 1);
    mm::cp_async_commit();
    mm::cp_async_wait<1>();
    __syncthreads();
    const bf16* wi = wts + buf * cw.wbuf;
    const bf16* wo = wi + cw.wo;

    // u = W_in^T LN over the 1-pixel halo: M = halo pixels, N = 2G, K = C
    gd::project_in<NA>(ub, NP2, L.MQ, ln, ln_pl, L.LSL, wi, cw, NWARP);
    __syncthreads();

    // the taps and the gate at the tile's pixels, o = round(gelu(t1) t2):
    // a thread a (gate pair g, tile column px, run of rows) with g's taps
    // in registers, sliding a 3x3 window of u (t1's and t2's) down its rows
    // (tile pixel (py, px) is halo position (py + 1, px + 1))
    if (g_gate < G) {
      const float* ta = taps + (size_t)(G2 * m + g_gate) * 9;
      float k1[9], k2[9], u1[3][3], u2[3][3];
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        k1[k] = __ldg(ta + k);
        k2[k] = __ldg(ta + 9 * G + k);
      }
      const float* b1 = ub + g_gate * NP2 + px_gate;
      const float* b2 = b1 + G * NP2;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          u1[i][j] = b1[(py0_gate + i) * PW2 + j];
          u2[i][j] = b2[(py0_gate + i) * PW2 + j];
        }
      for (int py = py0_gate; py < py1_gate; ++py) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          u1[2][j] = b1[(py + 2) * PW2 + j];
          u2[2][j] = b2[(py + 2) * PW2 + j];
        }
        float t1 = 0.f, t2 = 0.f;  // tap9's order
#pragma unroll
        for (int k = 0; k < 9; ++k) {
          t1 = fmaf(k1[k], u1[k / 3][k % 3], t1);
          t2 = fmaf(k2[k], u2[k / 3][k % 3], t2);
        }
        const float ge = 0.5f * t1 * (1.f + erff(t1 * 0.70710678118654752f));
        mm::put<NA>(ov, ov_pl, (size_t)g_gate * L.LDP + py * TW + px_gate,
                    round_to<T>(ge * t2));
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          u1[0][j] = u1[1][j], u1[1][j] = u1[2][j];
          u2[0][j] = u2[1][j], u2[1][j] = u2[2][j];
        }
      }
    }
    __syncthreads();

    // acc += W_out^T o: M = C, N = tile pixels, K = G (one k16 step)
#pragma unroll
    for (int i = 0; i < ACC_TILES; ++i) {
      const int idx = warp * tpw + i;
      if (i >= tpw || idx >= ntt) break;
      const int mt = idx / ntn, pp = idx % ntn;
      uint32_t a[2][4], bw[2][NA][2];
#pragma unroll
      for (int pl = 0; pl < 2; ++pl)
        mm::frag_a<true>(a[pl], wo + pl * cw.wo_pl + mt * 16, cw.OLDW);
#pragma unroll
      for (int pl = 0; pl < NA; ++pl) {
        uint32_t r[4];
        mm::frag_b2<true>(r, ov + pl * ov_pl + pp * 16, L.LDP);
        bw[0][pl][0] = r[0], bw[0][pl][1] = r[1];
        bw[1][pl][0] = r[2], bw[1][pl][1] = r[3];
      }
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
        mm::mma_split<2, NA>(acc[i][ni], a, bw[ni]);
    }
    __syncthreads();  // the next chunk overwrites u, o and this buffer
  }

  // acc into the y tile [C][P] (over LN and u), then out in NCHW
#pragma unroll
  for (int i = 0; i < ACC_TILES; ++i) {
    const int idx = warp * tpw + i;
    if (i >= tpw || idx >= ntt) break;
    const int mt = idx / ntn, pp = idx % ntn;
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = mt * 16 + g8 + 8 * h;
        if (c >= C) continue;
        const int p = pp * 16 + ni * 8 + 2 * t4;
        yt[(size_t)c * P + p] = acc[i][ni][2 * h];
        yt[(size_t)c * P + p + 1] = acc[i][ni][2 * h + 1];
      }
  }
  __syncthreads();
  // a thread a tile pixel and every (kThreads / P)-th channel, UNR values
  // of x loaded before any y is stored
  constexpr int UNR = 8;
  const int p = tid % P, cs = kThreads / P;
  const int r = r0 + p / TW, cc = c0 + p % TW;
  if (uir::in_image(r, cc, H, W)) {
    const size_t pix = (size_t)b * C * plane + (size_t)r * W + cc;
    for (int c0_ = tid / P; c0_ < C; c0_ += UNR * cs) {
      float xv[UNR];
#pragma unroll
      for (int u = 0; u < UNR; ++u) {
        const int c = c0_ + u * cs;
        xv[u] = c < C && splits == 1 ? to_f(x[pix + (size_t)c * plane]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < UNR; ++u) {
        const int c = c0_ + u * cs;
        if (c >= C) break;
        const size_t i = pix + (size_t)c * plane;
        const float a = yt[c * P + p];
        if (splits == 1)
          y[i] = from_f<T>(xv[u] + round_to<T>(a));
        else
          part[(size_t)split * B * C * plane + i] = a;
      }
    }
  }
}

// The kernels' weight operands from the f32 parameters, once a call (for
// the forward and the backward): W_in (C, 2 hid) into the chunk layout
// [C][2 hid_pad] (chunk m's columns: t1 channels [Gm, Gm + G), then the t2
// channels hid + [Gm, Gm + G)) as bf16 hi/lo planes; the taps (3, 3, 2 hid)
// into [2 hid_pad][9] f32 in the same channel order; W_out (hid, C) into
// [hid_pad][C] hi/lo planes; the padded hidden channels zero (as
// ops/fused_gdfn.py kernel_operands lays them out, bit for bit).
__global__ void __launch_bounds__(kThreads)
    ln_gdfn_weights_kernel(const float* __restrict__ w_in,
                           const float* __restrict__ w_dw,
                           const float* __restrict__ w_out,
                           bf16* __restrict__ win_h, bf16* __restrict__ win_l,
                           float* __restrict__ taps, bf16* __restrict__ wo_h,
                           bf16* __restrict__ wo_l, int C, int hid,
                           int hid_pad) {
  const int wcols = 2 * hid_pad;
  const int n_in = C * wcols, n_taps = wcols * 9, n_out = hid_pad * C;
  // the source column of chunk-layout column j in W_in and the taps, or -1
  auto source = [&](int j) {
    const int m = j / G2, r = j % G2;
    const int s = G * m + (r < G ? r : r - G);
    return s < hid ? (r < G ? s : hid + s) : -1;
  };
  // hi = bf16(v), lo = bf16(v - hi): csrc/mma.cuh's planes
  auto put = [](bf16* hi, bf16* lo, int i, float v) {
    const bf16 h = __float2bfloat16(v);
    hi[i] = h;
    lo[i] = __float2bfloat16(v - __bfloat162float(h));
  };
  for (int e = blockIdx.x * blockDim.x + threadIdx.x;
       e < n_in + n_taps + n_out; e += gridDim.x * blockDim.x) {
    if (e < n_in) {
      const int src = source(e % wcols);
      put(win_h, win_l, e,
          src < 0 ? 0.f : w_in[(size_t)(e / wcols) * 2 * hid + src]);
    } else if (e < n_in + n_taps) {
      const int t = e - n_in, src = source(t / 9);
      taps[t] = src < 0 ? 0.f : w_dw[(size_t)(t % 9) * 2 * hid + src];
    } else {
      const int o = e - n_in - n_taps, g = o / C;
      put(wo_h, wo_l, o, g < hid ? w_out[o] : 0.f);
    }
  }
}

// y = x + round(sum over the splits' rows, in order), elementwise over n
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ln_gdfn_fwd_sum_kernel(const T* __restrict__ x, T* __restrict__ y,
                           const float* __restrict__ part, int splits,
                           size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += part[k * n + i];
    y[i] = from_f<T>(to_f(x[i]) + round_to<T>(s));
  }
}

template <typename T>
int launch(const void* x, void* y, float* part, const float* scale,
           const float* bias, const bf16* win_h, const bf16* win_l,
           const float* taps, const bf16* wo_h, const bf16* wo_l, int B,
           int C, int H, int W, int hid_pad, int TH, int TW, int splits,
           float eps, cudaStream_t stream) {
  constexpr int NA = std::is_same<T, float>::value ? 2 : 1;
  const Smem L(C, TH, TW, NA);
  // whole k16 steps over the tile's pixels, whole pixels a thread in the
  // output; project_out's accumulators
  if (hid_pad % G || C % 8 || TH < 1 || TW < 1 || G * TW > kThreads ||
      L.P % 16 || kThreads % L.P || L.CP * L.P > ACC_TILES * NWARP * 256 ||
      splits < 1 ||
      splits > hid_pad / G || (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  auto kern = ln_gdfn_fwd_kernel<T>;
  cudaError_t e = uir::set_smem(kern, L.total);
  if (e != cudaSuccess) return (int)e;
  const int tiles = B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  kern<<<dim3(tiles, splits), kThreads, L.total, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), part, scale, bias, win_h,
      win_l, taps, wo_h, wo_l, B, C, H, W, hid_pad, TH, TW, eps);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  const size_t n = (size_t)B * C * H * W;
  const int grid = (int)std::min<size_t>((n + kThreads - 1) / kThreads, 4096);
  ln_gdfn_fwd_sum_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), part, splits, n);
  return (int)cudaGetLastError();
}

}  // namespace

// The weight operands (ln_gdfn_weights_kernel) into win_h, win_l ([C][2
// hid_pad] each), taps ([2 hid_pad][9] f32), wo_h, wo_l ([hid_pad][C]):
// one launch.
extern "C" int uir_ln_gdfn_weights(const void* w_in, const void* w_dw,
                                   const void* w_out, void* win_h,
                                   void* win_l, void* taps, void* wo_h,
                                   void* wo_l, int C, int hid, int hid_pad,
                                   void* stream) {
  if (hid_pad % G || hid > hid_pad || C < 1) return (int)cudaErrorInvalidValue;
  const int n = C * 2 * hid_pad + 2 * hid_pad * 9 + hid_pad * C;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto h = [](void* p) { return static_cast<__nv_bfloat16*>(p); };
  ln_gdfn_weights_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      f(w_in), f(w_dw), f(w_out), h(win_h), h(win_l),
      static_cast<float*>(taps), h(wo_h), h(wo_l), C, hid, hid_pad);
  return (int)cudaGetLastError();
}

// One launch, or two when the hidden width is split over `splits` blocks a
// tile (the tile kernel writing part [splits][B][C][H][W], then their
// ordered sum with the residual).  win_*, wo_*: the bf16 hi and lo planes
// of W_in (chunk layout) and W_out; taps f32.
extern "C" int uir_ln_gdfn_fwd(const void* x, void* y, void* part,
                               const void* scale, const void* bias,
                               const void* win_h, const void* win_l,
                               const void* taps, const void* wo_h,
                               const void* wo_l, int B, int C, int H, int W,
                               int hid_pad, int gate_chunk, int bf16, int TH,
                               int TW, int splits, float eps, void* stream) {
  if (gate_chunk != G) return (int)cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto h = [](const void* p) { return static_cast<const __nv_bfloat16*>(p); };
  auto* pt = static_cast<float*>(part);
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(x, y, pt, f(scale), f(bias), h(win_h),
                                 h(win_l), f(taps), h(wo_h), h(wo_l), B, C, H,
                                 W, hid_pad, TH, TW, splits, eps, st);
  return launch<float>(x, y, pt, f(scale), f(bias), h(win_h), h(win_l),
                       f(taps), h(wo_h), h(wo_l), B, C, H, W, hid_pad, TH, TW,
                       splits, eps, st);
}
