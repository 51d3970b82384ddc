// LN + GDFN backward: the vector-Jacobian product of
// y = x + W_out^T (gelu(t1) * t2), [t1; t2] = dwconv3x3(W_in^T LN_C(x)),
// on channels-first (B, C, H, W): dx, dscale, dbias, dW_in, dtaps, dW_out.
//
// Replaces the TPU kernels of the JAX package
// ops/fused_gdfn_banded.py:517 _bwd_call (_bwd_kernel:295) and
// ops/fused_block.py:663 _bwd_call (_bwd_kernel:484), which compute one
// function.
//
// What bounds it on an H100.  Per pixel it recomputes the forward chain
// (2 * 2hid * (C + 9) flops) and runs the backward chains (about twice
// that) against 3 * C * itemsize bytes of x, dy and dx: above the card's
// bf16 ridge at every level, so at peak rates it is bound by operations,
// most of them the five 1x1 products.  At the Spectral widths (C = 16-128)
// a tile's LN patch and f32 dLN fit in shared memory, and staging the
// hidden planes through device memory would write 2 hid f32 values a pixel
// (six times x's bytes at C <= 32), so the design stays tile-local and
// moves the products onto the tensor cores.
//
// Design.  LN is per pixel, so dx on a TH x TW tile is local: it needs dt on
// a 1-pixel halo (the transposed 3x3), hence t1, t2 and W_out dy there, hence
// LN(x) on a 2-pixel halo.  The tile's forward half (LN planes, the weights'
// staging, u) is the forward's own (csrc/gdfn.cuh, shared with
// csrc/ln_gdfn.cu).  A block walks over tiles (tile = blockIdx.x,
// blockIdx.x + gridDim.x, ...), and per tile:
//   1. LN of the 2-pixel-halo patch (x staged through shared memory by
//      coalesced loads, statistics a pixel; the tile's kept) and dy on the
//      1-pixel halo, channel-major bf16 planes (zero outside the image);
//   2. per chunk of G gate pairs, the chunk's W_in columns and W_out rows
//      staged by cp.async (the next chunk's while this one computes), then
//      five tensor-core products (mma.cuh) and the elementwise work between:
//      - u = W_in^T LN on the 2-pixel halo (M = halo pixels, N = 2G, K = C);
//      - W_out dy on the 1-pixel halo (M = halo pixels, N = G, K = C); its
//        epilogue forms t1, t2 (taps of u), the gate's cotangent dgo =
//        round(W_out dy), dt1 = dgo t2 gelu'(t1), dt2 = dgo gelu(t1) and the
//        gate output o = round(gelu(t1) t2) on the tile;
//      - the tile's share of dW_out = o dy^T (K = tile pixels); on the FMA
//        pipe, du = transposed taps of dt and the share of dtaps (dt *
//        shifted u), one sliding 3x3 window a channel and tile column;
//      - the tile's share of dW_in = LN du^T (K = tile pixels), and
//        dLN += W_in du (K = 2G) into f32 accumulators that stay in
//        registers over the chunks (C_pad x P <= 8192: 16 a thread);
//   3. the LayerNorm backward of the tile from the kept statistics, every
//      thread on a share of a pixel's channels, gives dx and the shares of
//      dscale and dbias.
// The weight-gradient shares accumulate in the block's own row of `part`;
// a second launch sums the rows in block order (deterministic, no float
// atomics; every k step adds into its accumulators in a fixed order).
//
// Operands.  LN, dy and o are exactly T; the weights (f32, as the forward's
// composed contraction keeps them) and du (f32) are carried as bf16 hi/lo
// planes (mma.cuh): in bf16 dW_out = o dy^T takes one pass, a product with
// a weight or du two, and dLN (weights times du) three; in f32 every
// operand is split.  Cotangents round
// to the compute type where autograd through the plain version rounds them
// (the gate output's and the LN output's, and the LN input's before the
// residual is added); every weight-gradient sum is f32.  The TPU kernel's
// composed 9C-deep dK and its decomposition (_decompose_dk) are not needed:
// the chain stays unfolded, so dW_in and dtaps come out directly.
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
using gd::gelu_both;
using gd::up16;
using uir::from_f;
using uir::round_to;
using uir::to_f;

constexpr int kThreads = 512;
constexpr int NWARP = kThreads / 32;
// dLN accumulator tiles (16 x 16) a warp: C_pad x P <= 8192
constexpr int ACC_TILES = 2;

// Shared-memory layout of one block (ops/fused_gdfn.py bwd_shared_bytes
// mirrors it).  NA: planes of LN, dy and o (2 in f32).  Planes are
// channel-major with padded rows (mma.cuh pad_ld): LN on the 2-pixel halo
// at q (M space [0, MQ4)), dy on the 1-pixel halo at q + 1 (M space
// [0, MD)), du [2G][P] and o [G][P]; the chunk's W_in columns [CP][2G] and
// W_out rows [G][CP], two planes each, in two buffers; f32 u [2G][NP4] and
// dt [2G][NP2], whose room takes dLN [C][P] and the LayerNorm backward's
// partial sums [2][kThreads] after the chunks; the tile pixels' LN mean and
// rstd [2][P].
struct Smem {
  int CP, NP4, NP2, P, MQ4, MD, LSL, LSD, LDP, WLD, OLDW;
  size_t ln, dy, wts, wbuf, wi_pl, wo, wo_pl, r1, du, ov, stat, total;
  __host__ __device__ Smem(int C, int TH, int TW, int NA) {
    CP = up16(C);
    NP4 = (TH + 4) * (TW + 4);
    NP2 = (TH + 2) * (TW + 2);
    P = TH * TW;
    MQ4 = up16(NP4);
    MD = up16(NP2 + 1);
    LSL = mm::pad_ld(MQ4);
    LSD = mm::pad_ld(MD);
    LDP = mm::pad_ld(P);
    WLD = mm::pad_ld(G2);
    OLDW = mm::pad_ld(CP);
    const size_t b2 = sizeof(bf16);
    wi_pl = (size_t)CP * WLD;          // elements of a W_in plane
    wo_pl = (size_t)G * OLDW;          // of a W_out plane
    wo = 2 * wi_pl;                    // W_out's offset in a buffer
    wbuf = 2 * wi_pl + 2 * wo_pl;      // elements of a weight buffer
    ln = 0;
    dy = ln + al16(NA * (size_t)CP * LSL * b2);
    wts = dy + al16(NA * (size_t)CP * LSD * b2);
    r1 = wts + al16(2 * wbuf * b2);
    const size_t r1b = 4 * (size_t)G2 * (NP4 + NP2);
    const size_t accb = 4 * ((size_t)C * P + 2 * kThreads);
    du = r1 + al16(r1b > accb ? r1b : accb);
    ov = du + al16(2 * (size_t)G2 * LDP * b2);
    stat = ov + al16(NA * (size_t)G * LDP * b2);
    total = stat + al16(4 * 2 * (size_t)P);
  }
};

// du on the tile (the transposed taps of dt, into du's hi/lo planes, zero
// outside the image) and the tile's share of dtaps (dt times the shifted
// u), a thread a (channel j of the chunk, tile column) walking the rows
// with a 3x3 window of dt (1-pixel halo) and of u (2-pixel halo; both zero
// outside the image).  The columns' dtaps sums meet in a fixed butterfly
// over the TW lanes of a channel, added into dst [2G][9].
__device__ void stencils(float* dst, bf16* du, size_t du_pl, int LDP,
                         const float* dt, const float* ub,
                         const float* __restrict__ taps, int TH, int TW,
                         int r0, int c0, int H, int W) {
  const int PW2 = TW + 2, NP2 = PW2 * (TH + 2);
  const int PW4 = TW + 4, NP4 = PW4 * (TH + 4);
  // G2 * TW is a multiple of 32: every warp of a round is whole
  for (int it = threadIdx.x; it < G2 * TW; it += blockDim.x) {
    const int j = it / TW, px = it % TW;
    float tp[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) tp[k] = __ldg(taps + j * 9 + k);
    // D: dt rows py .. py + 2 of the 1-pixel halo, columns px .. px + 2;
    // U: u rows py + 1 .. py + 3 of the 2-pixel halo, columns px + 1 ..
    // px + 3 (tile pixel (py, px) sits at (py + 1, px + 1) and (py + 2,
    // px + 2))
    const float* dj = dt + (size_t)j * NP2 + px;
    const float* uj = ub + (size_t)j * NP4 + PW4 + px + 1;
    float D[3][3], U[3][3], acc[9];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        D[i][c] = dj[i * PW2 + c];
        U[i][c] = uj[i * PW4 + c];
      }
#pragma unroll
    for (int k = 0; k < 9; ++k) acc[k] = 0.f;
    for (int py = 0; py < TH; ++py) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        D[2][c] = dj[(py + 2) * PW2 + c];
        U[2][c] = uj[(py + 2) * PW4 + c];
      }
      // du(p) = sum_k tap_k dt(p - d_k), d_k = (k / 3 - 1, k % 3 - 1)
      float v = 0.f;
      if (uir::in_image(r0 + py, c0 + px, H, W))
#pragma unroll
        for (int k = 0; k < 9; ++k)
          v = fmaf(tp[k], D[2 - k / 3][2 - k % 3], v);
      mm::put<2>(du, du_pl, (size_t)j * LDP + py * TW + px, v);
      // dtaps_k += dt(p) u(p + d_k)
      const float dv = D[1][1];
#pragma unroll
      for (int k = 0; k < 9; ++k) acc[k] = fmaf(dv, U[k / 3][k % 3], acc[k]);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        D[0][c] = D[1][c], D[1][c] = D[2][c];
        U[0][c] = U[1][c], U[1][c] = U[2][c];
      }
    }
    for (int off = TW / 2; off > 0; off >>= 1)
#pragma unroll
      for (int k = 0; k < 9; ++k)
        acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], off);
    if (px == 0)
#pragma unroll
      for (int k = 0; k < 9; ++k) dst[j * 9 + k] += acc[k];
  }
}

// The LayerNorm backward of the tile (as grad.cuh ln_backward_tile, from
// the statistics ln_planes kept): acc [C][P] holds the f32 gradient at the
// LN output, rounded to T first; dx = round(dy + round(dx_ln)).  kThreads / P
// threads a pixel split its channels, their partial sums added in a fixed
// order through red [2][kThreads]; then dsc/dbi get the tile's shares of
// dscale and dbias, a warp a channel.  Ends synchronized.
template <typename T>
__device__ void ln_backward(const T* __restrict__ xb,
                            const T* __restrict__ dyb, T* __restrict__ dxb,
                            const float* acc, const float* stat, float* red,
                            const float* __restrict__ scale, float* dsc,
                            float* dbi, int C, int H, int W, int r0, int c0,
                            int TH, int TW) {
  const int P = TH * TW, S = kThreads / P;
  const size_t plane = (size_t)H * W;
  const int p = threadIdx.x % P, si = threadIdx.x / P;
  const int r = r0 + p / TW, cc = c0 + p % TW;
  const bool in = uir::in_image(r, cc, H, W);
  const size_t pix = (size_t)r * W + cc;
  const float mean = stat[p], rstd = stat[P + p];
  float s1 = 0.f, s2 = 0.f;
  if (in)
#pragma unroll 4
    for (int ch = si; ch < C; ch += S) {
      const float xh = (to_f(xb[ch * plane + pix]) - mean) * rstd;
      const float g = round_to<T>(acc[ch * P + p]) * __ldg(scale + ch);
      s1 += g;
      s2 = fmaf(g, xh, s2);
    }
  red[si * P + p] = s1;
  red[kThreads + si * P + p] = s2;
  __syncthreads();
  s1 = s2 = 0.f;
  for (int i = 0; i < S; ++i) {
    s1 += red[i * P + p];
    s2 += red[kThreads + i * P + p];
  }
  s1 /= C;
  s2 /= C;
  if (in)
#pragma unroll 4
    for (int ch = si; ch < C; ch += S) {
      const size_t idx = ch * plane + pix;
      const float xh = (to_f(xb[idx]) - mean) * rstd;
      const float g = round_to<T>(acc[ch * P + p]) * __ldg(scale + ch);
      const float dxl = rstd * (g - s1 - xh * s2);
      dxb[idx] = from_f<T>(to_f(dyb[idx]) + round_to<T>(dxl));
    }
  const int lane = threadIdx.x & 31;
  for (int ch = threadIdx.x >> 5; ch < C; ch += kThreads / 32) {
    float a = 0.f, b = 0.f;
    for (int q = lane; q < P; q += 32) {
      const int rq = r0 + q / TW, cq = c0 + q % TW;
      if (!uir::in_image(rq, cq, H, W)) continue;
      const float dl = round_to<T>(acc[ch * P + q]);
      const float xh =
          (to_f(xb[ch * plane + (size_t)rq * W + cq]) - stat[q]) * stat[P + q];
      a = fmaf(dl, xh, a);
      b += dl;
    }
    a = uir::warp_sum(a);
    b = uir::warp_sum(b);
    if (lane == 0) {
      dsc[ch] += a;
      dbi[ch] += b;
    }
  }
  __syncthreads();
}

// win_h/win_l: [C][2 hid_pad] in the forward's chunk layout; taps:
// [2 hid_pad][9] f32; wo_h/wo_l: W_out [hid_pad][C]; the hi/lo planes of the
// f32 weights.  part row (E floats): dW_in [C][2 hid_pad], dtaps
// [2 hid_pad][9], dW_out [hid_pad][C], dscale [C], dbias [C].
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ln_gdfn_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                       T* __restrict__ dx, const float* __restrict__ scale,
                       const float* __restrict__ bias,
                       const bf16* __restrict__ win_h,
                       const bf16* __restrict__ win_l,
                       const float* __restrict__ taps,
                       const bf16* __restrict__ wo_h,
                       const bf16* __restrict__ wo_l,
                       float* __restrict__ part, int B, int C, int H, int W,
                       int hid_pad, int TH, int TW, float eps) {
  constexpr int NA = std::is_same<T, float>::value ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem L(C, TH, TW, NA);
  const gd::ChunkWeights cw(C);
  bf16* ln = reinterpret_cast<bf16*>(smem + L.ln);
  bf16* dyp = reinterpret_cast<bf16*>(smem + L.dy);
  bf16* wts = reinterpret_cast<bf16*>(smem + L.wts);
  float* ub = reinterpret_cast<float*>(smem + L.r1);  // [2G][NP4]: u
  float* dt = ub + G2 * L.NP4;                        // [2G][NP2]: dt1, dt2
  float* acc = ub;                                    // [C][P]: dLN, f32
  float* red = acc + (size_t)C * L.P;                 // [2][kThreads]
  float* stat = reinterpret_cast<float*>(smem + L.stat);  // [2][P]
  bf16* du = reinterpret_cast<bf16*>(smem + L.du);    // [2][2G][LDP]
  bf16* ov = reinterpret_cast<bf16*>(smem + L.ov);    // [NA][G][LDP]
  const size_t ln_pl = (size_t)L.CP * L.LSL, dy_pl = (size_t)L.CP * L.LSD;
  const size_t du_pl = (size_t)G2 * L.LDP, ov_pl = (size_t)G * L.LDP;
  const int NP4 = L.NP4, NP2 = L.NP2, P = L.P;
  const int PW2 = TW + 2, PW4 = TW + 4;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int tiles_x = (W + TW - 1) / TW;
  const int per_img = tiles_x * ((H + TH - 1) / TH);
  const size_t plane = (size_t)H * W;
  const int wcols = 2 * hid_pad, nch = hid_pad / G;
  const size_t E = (size_t)C * wcols + (size_t)wcols * 9 +
                   (size_t)hid_pad * C + 2 * C;
  float* g_win = part + blockIdx.x * E;
  float* g_taps = g_win + (size_t)C * wcols;
  float* g_wout = g_taps + (size_t)wcols * 9;
  float* g_sc = g_wout + (size_t)hid_pad * C;
  float* g_bi = g_sc + C;
  for (size_t e = tid; e < E; e += blockDim.x) g_win[e] = 0.f;
  // the LN and dy planes once: rows past C and columns past the patch stay
  // zero (the products read them as padding)
  for (size_t i = tid; i < L.wts / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  // dLN tiles (16 channels x 16 pixels) of this warp: w * tpw + i
  const int ntn = P / 16, ntt = (L.CP / 16) * ntn;
  const int tpw = (ntt + NWARP - 1) / NWARP;

  for (int tile = blockIdx.x; tile < B * per_img; tile += gridDim.x) {
    const int b = tile / per_img, t = tile % per_img;
    const int r0 = (t / tiles_x) * TH, c0 = (t % tiles_x) * TW;
    const T* xb = x + (size_t)b * C * plane;
    const T* dyg = dy + (size_t)b * C * plane;
    __syncthreads();  // the previous tile is done with every buffer
    gd::stage_weights(wts, win_h, win_l, wo_h, wo_l, cw, C, wcols, 0);
    mm::cp_async_commit();
    gd::ln_planes<T, NA, 2>(xb, ln, ln_pl, L.LSL, scale, bias, stat, C, H, W,
                            r0, c0, TH, TW, eps);
    for (int i0 = tid; i0 < C * NP2; i0 += gd::BATCH * blockDim.x) {
      float v[gd::BATCH];
#pragma unroll
      for (int u = 0; u < gd::BATCH; ++u) {
        const int i = i0 + u * blockDim.x, ch = i / NP2, q = i % NP2;
        const int r = r0 - 1 + q / PW2, cc = c0 - 1 + q % PW2;
        v[u] = i < C * NP2 && uir::in_image(r, cc, H, W)
                   ? to_f(dyg[ch * plane + (size_t)r * W + cc])
                   : 0.f;
      }
#pragma unroll
      for (int u = 0; u < gd::BATCH; ++u) {
        const int i = i0 + u * blockDim.x;
        if (i < C * NP2)
          mm::put<NA>(dyp, dy_pl, (size_t)(i / NP2) * L.LSD + i % NP2 + 1,
                      v[u]);
      }
    }
    float dacc[ACC_TILES][2][4];
#pragma unroll
    for (int i = 0; i < ACC_TILES; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dacc[i][j][e] = 0.f;

    for (int m = 0; m < nch; ++m) {
      if (m + 1 < nch)
        gd::stage_weights(wts + ((m + 1) & 1) * L.wbuf, win_h, win_l, wo_h,
                          wo_l, cw, C, wcols, m + 1);
      mm::cp_async_commit();
      mm::cp_async_wait<1>();
      __syncthreads();
      const bf16* wi = wts + (m & 1) * L.wbuf;
      const bf16* wo = wi + L.wo;

      // u = W_in^T LN over the 2-pixel halo: M = halo pixels, N = 2G, K = C
      gd::project_in<NA>(ub, NP4, L.MQ4, ln, ln_pl, L.LSL, wi, cw, NWARP);
      __syncthreads();

      // W_out dy over the 1-pixel halo (M = dy's plane positions s = q + 1,
      // N = G, K = C); the epilogue: t1, t2, dgo, dt1, dt2 and the gate
      // output on the tile
      for (int mt = warp; mt < L.MD / 16; mt += NWARP) {
        float a2[2][4] = {};
        for (int k0 = 0; k0 < L.CP; k0 += 16) {
          uint32_t a[NA][4], bw[2][2][2];
#pragma unroll
          for (int pl = 0; pl < NA; ++pl)
            mm::frag_a<true>(a[pl], dyp + pl * dy_pl + k0 * L.LSD + mt * 16,
                             L.LSD);
#pragma unroll
          for (int pl = 0; pl < 2; ++pl) {
            uint32_t r[4];
            mm::frag_b2<false>(r, wo + pl * L.wo_pl + k0, L.OLDW);
            bw[0][pl][0] = r[0], bw[0][pl][1] = r[1];
            bw[1][pl][0] = r[2], bw[1][pl][1] = r[3];
          }
#pragma unroll
          for (int ni = 0; ni < 2; ++ni)
            mm::mma_split<NA, 2>(a2[ni], a, bw[ni]);
        }
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int q = mt * 16 + g8 + 8 * (e >> 1) - 1;
            const int g = ni * 8 + 2 * t4 + (e & 1);
            if (q < 0 || q >= NP2) continue;
            const int qy = q / PW2, qx = q % PW2;
            const bool tile_px = qy >= 1 && qy <= TH && qx >= 1 && qx <= TW;
            float d1 = 0.f, d2 = 0.f, o = 0.f;
            if (uir::in_image(r0 - 1 + qy, c0 - 1 + qx, H, W)) {
              const float* ta = taps + (size_t)(G2 * m + g) * 9;
              const int base = qy * PW4 + qx;
              const float t1 = uir::tap9(ub + g * NP4 + base, PW4, ta);
              const float t2 =
                  uir::tap9(ub + (G + g) * NP4 + base, PW4, ta + 9 * G);
              const float dgo = round_to<T>(a2[ni][e]);
              float ge, gp;
              gelu_both(t1, ge, gp);
              d1 = dgo * t2 * gp;
              d2 = dgo * ge;
              o = round_to<T>(ge * t2);
            }
            dt[g * NP2 + q] = d1;
            dt[(G + g) * NP2 + q] = d2;
            if (tile_px)
              mm::put<NA>(ov, ov_pl, (size_t)g * L.LDP + (qy - 1) * TW + qx - 1,
                          o);
          }
      }
      __syncthreads();

      // the tile's share of dW_out = o dy^T: M = G, N = C, K = tile pixels
      // (dy's pixel pairs read as 32-bit fragments: its plane keeps the halo)
      for (int np = warp; np < L.CP / 16; np += NWARP) {
        // the row's values, read before the product so the loads overlap it
        float2 prev[2][2];
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int c = np * 16 + ni * 8 + 2 * t4;
            prev[ni][h] = c < C ? *reinterpret_cast<const float2*>(
                                      g_wout + (size_t)(G * m + g8 + 8 * h) *
                                                   C + c)
                                : make_float2(0.f, 0.f);
          }
        float a2[2][4] = {};
        for (int k0 = 0; k0 < P; k0 += 16) {
          uint32_t a[NA][4], bw[2][NA][2];
#pragma unroll
          for (int pl = 0; pl < NA; ++pl)
            mm::frag_a<false>(a[pl], ov + pl * ov_pl + k0, L.LDP);
#pragma unroll
          for (int ni = 0; ni < 2; ++ni) {
            const bf16* row = dyp + (size_t)(np * 16 + ni * 8 + g8) * L.LSD;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int k = k0 + 2 * t4 + 8 * h;  // tile pixel, even
              const int pos = (k / TW + 1) * PW2 + k % TW + 2;
#pragma unroll
              for (int pl = 0; pl < NA; ++pl)
                bw[ni][pl][h] = mm::ld_pair(row + pl * dy_pl + pos);
            }
          }
#pragma unroll
          for (int ni = 0; ni < 2; ++ni)
            mm::mma_split<NA, NA>(a2[ni], a, bw[ni]);
        }
#pragma unroll
        for (int ni = 0; ni < 2; ++ni) {
          const int c = np * 16 + ni * 8 + 2 * t4;
          if (c >= C) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float2*>(g_wout +
                                       (size_t)(G * m + g8 + 8 * h) * C + c) =
                make_float2(prev[ni][h].x + a2[ni][2 * h],
                            prev[ni][h].y + a2[ni][2 * h + 1]);
        }
      }
      // du on the tile and the tile's share of dtaps
      stencils(g_taps + (size_t)G2 * m * 9, du, du_pl, L.LDP, dt, ub,
               taps + (size_t)G2 * m * 9, TH, TW, r0, c0, H, W);
      __syncthreads();

      // the tile's share of dW_in = LN du^T: M = C, N = 2G, K = tile pixels
      // (LN's pixel pairs read as 32-bit fragments)
      for (int u = warp; u < (L.CP / 16) * 2; u += NWARP) {
        const int mt = u >> 1, np = u & 1;
        float2 prev[2][2];
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int c = mt * 16 + g8 + 8 * h;
            prev[ni][h] =
                c < C ? *reinterpret_cast<const float2*>(
                            g_win + (size_t)c * wcols + G2 * m + np * 16 +
                            ni * 8 + 2 * t4)
                      : make_float2(0.f, 0.f);
          }
        float a2[2][4] = {};
        for (int k0 = 0; k0 < P; k0 += 16) {
          uint32_t a[NA][4], bw[2][2][2];
#pragma unroll
          for (int pl = 0; pl < NA; ++pl)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int row = mt * 16 + g8 + 8 * (e & 1);
              const int k = k0 + 2 * t4 + 8 * (e >> 1);
              const int pos = (k / TW + 2) * PW4 + k % TW + 2;
              a[pl][e] = mm::ld_pair(ln + pl * ln_pl + (size_t)row * L.LSL +
                                     pos);
            }
#pragma unroll
          for (int pl = 0; pl < 2; ++pl) {
            uint32_t r[4];
            mm::frag_b2<false>(r, du + pl * du_pl + np * 16 * L.LDP + k0,
                               L.LDP);
            bw[0][pl][0] = r[0], bw[0][pl][1] = r[1];
            bw[1][pl][0] = r[2], bw[1][pl][1] = r[3];
          }
#pragma unroll
          for (int ni = 0; ni < 2; ++ni)
            mm::mma_split<NA, 2>(a2[ni], a, bw[ni]);
        }
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int c = mt * 16 + g8 + 8 * h;
            if (c >= C) continue;
            *reinterpret_cast<float2*>(g_win + (size_t)c * wcols + G2 * m +
                                       np * 16 + ni * 8 + 2 * t4) =
                make_float2(prev[ni][h].x + a2[ni][2 * h],
                            prev[ni][h].y + a2[ni][2 * h + 1]);
          }
      }
      // dLN += W_in du: M = C, N = tile pixels, K = 2G, in registers
#pragma unroll
      for (int i = 0; i < ACC_TILES; ++i) {
        const int idx = warp * tpw + i;
        if (i >= tpw || idx >= ntt) break;
        const int mt = idx / ntn, pp = idx % ntn;
#pragma unroll
        for (int k0 = 0; k0 < G2; k0 += 16) {
          uint32_t a[2][4], bw[2][2][2];
#pragma unroll
          for (int pl = 0; pl < 2; ++pl) {
            mm::frag_a<false>(a[pl], wi + pl * L.wi_pl + mt * 16 * L.WLD + k0,
                              L.WLD);
            uint32_t r[4];
            mm::frag_b2<true>(r, du + pl * du_pl + k0 * L.LDP + pp * 16,
                              L.LDP);
            bw[0][pl][0] = r[0], bw[0][pl][1] = r[1];
            bw[1][pl][0] = r[2], bw[1][pl][1] = r[3];
          }
#pragma unroll
          for (int ni = 0; ni < 2; ++ni)
            mm::mma_split<2, 2>(dacc[i][ni], a, bw[ni]);
        }
      }
      __syncthreads();  // the next chunk overwrites u, dt, du and weights
    }

    // dLN into shared memory ([C][P], over u and dt), then the LayerNorm
    // backward of the tile
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
          acc[(size_t)c * P + p] = dacc[i][ni][2 * h];
          acc[(size_t)c * P + p + 1] = dacc[i][ni][2 * h + 1];
        }
    }
    __syncthreads();
    ln_backward<T>(xb, dyg, dx + (size_t)b * C * plane, acc, stat, red, scale,
                   g_sc, g_bi, C, H, W, r0, c0, TH, TW);
  }
}

template <typename T>
int launch(const void* x, const void* dy, void* dx, const float* scale,
           const float* bias, const bf16* win_h, const bf16* win_l,
           const float* taps, const bf16* wo_h, const bf16* wo_l,
           float* part, float* grads, int B, int C, int H, int W, int hid_pad,
           int TH, int TW, int groups, float eps, cudaStream_t stream) {
  constexpr int NA = std::is_same<T, float>::value ? 2 : 1;
  const Smem L(C, TH, TW, NA);
  // whole k16 steps over the tile's pixels; dLN's accumulators a warp
  if (hid_pad % G || C % 8 || !uir::tile_ok(TH, TW) || TW % 4 ||
      L.P % 16 || kThreads % L.P || L.CP * L.P > ACC_TILES * NWARP * 256)
    return (int)cudaErrorInvalidValue;
  auto kern = ln_gdfn_bwd_kernel<T>;
  cudaError_t e = uir::set_smem(kern, L.total);
  if (e != cudaSuccess) return (int)e;
  kern<<<groups, kThreads, L.total, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<T*>(dx),
      scale, bias, win_h, win_l, taps, wo_h, wo_l, part, B, C, H, W, hid_pad,
      TH, TW, eps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int E = C * 2 * hid_pad + 2 * hid_pad * 9 + hid_pad * C + 2 * C;
  return (int)uir::reduce_rows(part, grads, groups, E, stream);
}

}  // namespace

// Two launches: the tile kernel (grid `groups`, each block's partial row in
// part [groups][E]) and the ordered row sum into grads [E].  win_*, wo_*:
// the bf16 hi and lo planes of W_in (chunk layout) and W_out.
extern "C" int uir_ln_gdfn_bwd(const void* x, const void* dy, void* dx,
                               const void* scale, const void* bias,
                               const void* win_h, const void* win_l,
                               const void* taps, const void* wo_h,
                               const void* wo_l, void* part, void* grads,
                               int B, int C, int H, int W, int hid_pad,
                               int gate_chunk, int bf16, int TH, int TW,
                               int groups, float eps, void* stream) {
  if (gate_chunk != G) return (int)cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto h = [](const void* p) { return static_cast<const __nv_bfloat16*>(p); };
  auto* pt = static_cast<float*>(part);
  auto* gr = static_cast<float*>(grads);
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(x, dy, dx, f(scale), f(bias), h(win_h),
                                 h(win_l), f(taps), h(wo_h), h(wo_l), pt, gr,
                                 B, C, H, W, hid_pad, TH, TW, groups, eps, st);
  return launch<float>(x, dy, dx, f(scale), f(bias), h(win_h), h(win_l),
                       f(taps), h(wo_h), h(wo_l), pt, gr, B, C, H, W, hid_pad,
                       TH, TW, groups, eps, st);
}
