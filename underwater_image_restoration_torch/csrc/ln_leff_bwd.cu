// LN + LeFF backward: the vector-Jacobian product of
//   y = x + s_b * fc2(gelu(dw3x3(gelu(fc1(LayerNorm_C(x))))))
// on channels-last tokens x (B, H, W, C) (residual = 0 drops the "x +"):
// dx, dscale, dbias, dW1 (C, hid), db1, dtaps (hid, 9), db_dw, dW2 (hid, C)
// and db2.  The per-image scale s_b (DropPath's 0 or 1/keep) gets none, as
// in the TPU kernel's VJP.
//
// Replaces the TPU kernel of the JAX package ops/fused_leff.py:337 _bwd_call
// (_bwd_kernel:152).  That kernel streamed row bands through VMEM and
// finalized each band's LayerNorm backward one band late (its rolling lag-1
// dLN); a block here owns a pixel tile and recomputes what its halo needs,
// as csrc/ln_gdfn_bwd.cu does, so no band waits on another.
//
// Design.  dx on a TH x TW tile needs dt1 on the tile, which needs dt2 on a
// 1-pixel halo (the transposed 3x3), which needs t2 there, which needs
// g1 = gelu(fc1(LN x)) on a 2-pixel halo, and W2 (s dy) on the 1-pixel halo.
// A block walks over tiles (blockIdx.x, blockIdx.x + gridDim.x, ...), and
// per tile:
//   1. LN of the 2-pixel-halo patch and dyk = round(s_b dy) on the 1-pixel
//      halo, a warp a pixel (lanes over channels), channel-major in shared
//      memory (zero outside the image); the tile's share of db2;
//   2. the hidden width in chunks of G channels (the 3x3 is depthwise, so a
//      chunk is exact by itself); per chunk, its fc1 columns and fc2 rows
//      staged in shared memory as f32, then
//      - t1 = fc1 LN + b1 on the 2-pixel halo: g1 (zero outside the image,
//        the 3x3's zero padding), gelu'(t1) on the tile;
//      - on the 1-pixel halo: dg2 = W2 dyk, t2 from the taps, dt2 =
//        dg2 gelu'(t2) (zero outside the image), g2 = gelu(t2) on the tile;
//      - on the tile: dt1 = (transposed taps of round(dt2)) gelu'(t1), zero
//        outside the image, a warp a hidden channel, which also sums the
//        tile's shares of db1 and db_dw;
//      - the tile's shares of dtaps (dt2 times the shifted g1), dW1
//        (LN round(dt1)^T) and dW2 (g2 dyk^T), a thread a 4 x 4 block of
//        outputs, and dLN += W1 round(dt1) into a per-pixel f32
//        accumulator;
//   3. the LayerNorm backward of the tile: dx, and the shares of dscale and
//      dbias.
// Every weight-gradient share counts only the pixels the tile owns: the halo
// is recomputed, never summed.  The shares add into the block's own row of
// `part` (written by that block alone, in its own order); a second launch
// sums the rows in block order (grad.cuh reduce_rows): no float atomics, so
// two runs give the same bits.  The weight products sum in the kernel, as
// the TPU kernel's body does, with per-block rows rather than a second
// kernel split over pixels: that would have to write g2 and dt1 (hid wide)
// to device memory.  The wrapper caps the number of rows by their size
// (ops/fused_leff.py PART_BYTES; a row is 8.5 MB at C = 512, hid = 2048).
//
// Rounding points (the TPU kernel's, _bwd_kernel:224-249): dyk =
// round(s_b dy); dg2 and dt2 stay f32 (dtaps and db_dw from the f32 dt2);
// dt2 rounds before the transposed taps; dt1 stays f32 for db1 and rounds
// before dW1 and dLN; dLN stays f32; dx = dy + round(dx_ln) in T
// (round(dx_ln) without the residual).  The recomputed forward rounds where
// csrc/ln_leff.cu does.  Autograd through the plain version rounds some
// cotangents elsewhere (dg2, dt2, dLN and the weight gradients in bf16), so
// the two agree exactly in f32 and within bf16 roundoff in bf16.
//
// What bounds it on an H100.  Per pixel the required work is the forward's
// fc1 and taps and the backward's dg2, dW2, dW1 and dLN products and three
// tap sums: 10 C hid + 54 hid flops against 3 C itemsize bytes of x, dy and
// dx, far above the bf16 ridge, so at peak rates it is bound by operations.  This version runs
// them on the f32 FMA pipe (67 TFLOP/s), with fc1 recomputed on the 2-pixel
// halo ((TH+4)(TW+4)/(TH TW): 2.25x at 8 x 8, 4x at 4 x 4) and dg2 on the
// 1-pixel halo; plain FMA, no tensor cores yet.
#include <cstdint>

#include "grad.cuh"

namespace {

using uir::from_f;
using uir::in_image;
using uir::round_to;
using uir::to_f;
using uir::warp_sum;

constexpr int kThreads = 256;
// hidden channels a chunk; the wrapper passes it with every launch
// (ops/fused_leff.py BWD_CHUNK), and a launch with another one is refused
constexpr int G = 16;
// hidden channels of one item of the fc1 and W2 dyk products (a multiple
// of 4 dividing G): each channel step reads one activation and JW / 4
// float4 weight broadcasts for JW multiply-adds
constexpr int JW = 8;

__device__ __forceinline__ float gelu_f(float t) {
  return 0.5f * t * (1.f + erff(t * 0.70710678118654752f));
}

// d gelu / dt, exact (erf) form: Phi(t) + t * phi(t)
__device__ __forceinline__ float gelu_grad(float t) {
  return 0.5f * (1.f + erff(t * 0.70710678118654752f)) +
         t * 0.39894228040143268f * expf(-0.5f * t * t);
}

// Eight consecutive T values of global memory (16-byte aligned in bf16,
// 32-byte in f32) as f32.
__device__ __forceinline__ void load8(float (&v)[8], const float* src) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(src));
  const float4 b = __ldg(reinterpret_cast<const float4*>(src) + 1);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void load8(float (&v)[8],
                                      const __nv_bfloat16* src) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(src));
  const auto* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// Mean and rstd of the C channels at xp, a warp a pixel (lanes over
// channels), as csrc/ln_leff.cu computes them.
template <typename T>
__device__ __forceinline__ void ln_stats(const T* xp, int C, int lane,
                                         float eps, float& mean,
                                         float& rstd) {
  float sum = 0.f;
  for (int ch = lane; ch < C; ch += 32) sum += to_f(xp[ch]);
  mean = warp_sum(sum) / C;
  float var = 0.f;
  for (int ch = lane; ch < C; ch += 32) {
    const float d = to_f(xp[ch]) - mean;
    var += d * d;
  }
  rstd = rsqrtf(warp_sum(var) / C + eps);
}

// s[i] = sum_{ch < n} a[ch * lda] * w[ch * G + i], i < JW: JW hidden
// channels of a 1x1 product at one pixel of a channel-major shared plane
// (a, in T) with the chunk's staged weights (w, f32, [C][G], 16-byte
// aligned rows; reads are broadcasts).
template <typename T>
__device__ __forceinline__ void project(float (&s)[JW], int n, const T* a,
                                        int lda, const float* w) {
#pragma unroll
  for (int i = 0; i < JW; ++i) s[i] = 0.f;
#pragma unroll 8
  for (int ch = 0; ch < n; ++ch, w += G) {
    const float l = to_f(a[ch * lda]);
#pragma unroll
    for (int i = 0; i < JW; i += 4) {
      const float4 w4 = *reinterpret_cast<const float4*>(w + i);
      s[i] = fmaf(l, w4.x, s[i]);
      s[i + 1] = fmaf(l, w4.y, s[i + 1]);
      s[i + 2] = fmaf(l, w4.z, s[i + 2]);
      s[i + 3] = fmaf(l, w4.w, s[i + 3]);
    }
  }
}

// dst[i * ldd + o] += sum over tile pixels p of a[i][p] * b[o][p] for i < NI
// and o < NO (multiples of 4): a tile's share of a 1x1 weight gradient, a
// thread a 4 x 4 block of outputs summing the pixels in order, then four
// float4 read-modify-writes of the block's row that do not wait on each
// other.  (grad.cuh outer_acc, a warp a block with lanes over pixels, waits
// on one read of the row per block and at 4 x 4 tiles spends 80 shuffles on
// 16 multiply-adds: 2.9x slower here, where the rows reach 1 GiB.)  Pixel p of the tile sits at a[i * sa + ha * (pwa + 1) + (p / TW) *
// pwa + p % TW] (a plane on a halo of ha pixels, pwa = TW + 2 ha); b alike.
template <typename TA, typename TB>
__device__ void outer4(float* dst, int ldd, const TA* a, int sa, int ha,
                       int NI, const TB* b, int sb, int hb, int NO, int TH,
                       int TW) {
  const int P = TH * TW, pwa = TW + 2 * ha, pwb = TW + 2 * hb;
  const TA* a0 = a + ha * (pwa + 1);
  const TB* b0 = b + hb * (pwb + 1);
  const int nbo = NO / 4;
  for (int it = threadIdx.x; it < (NI / 4) * nbo; it += blockDim.x) {
    const int o0 = 4 * (it % nbo), i0 = 4 * (it / nbo);
    float s[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) s[e] = 0.f;
    for (int p = 0; p < P; ++p) {
      const int pa = (p / TW) * pwa + p % TW, pb = (p / TW) * pwb + p % TW;
      float av[4], bv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        av[u] = to_f(a0[(i0 + u) * sa + pa]);
        bv[u] = to_f(b0[(o0 + u) * sb + pb]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v)
          s[4 * u + v] = fmaf(av[u], bv[v], s[4 * u + v]);
    }
    float4* d[4];
    float4 r[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      d[u] = reinterpret_cast<float4*>(dst + (size_t)(i0 + u) * ldd + o0);
      r[u] = *d[u];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      r[u].x += s[4 * u];
      r[u].y += s[4 * u + 1];
      r[u].z += s[4 * u + 2];
      r[u].w += s[4 * u + 3];
      *d[u] = r[u];
    }
  }
}

// Weight-gradient row of one block (E floats): dW1 [C][hid], db1 [hid],
// dtaps [hid][9], db_dw [hid], dW2 [hid][C], db2 [C], dscale [C], dbias [C].
__host__ __device__ __forceinline__ size_t row_size(int C, int hid) {
  return 2 * (size_t)C * hid + 11 * (size_t)hid + 3 * (size_t)C;
}

// w1: [C][hid] in T; b1, bdw: [hid] f32; taps: [9][hid] f32 with
// k = 3 * dh + dw; w2: [hid][C] in T; s: [B] f32.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ln_leff_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                       T* __restrict__ dx, const float* __restrict__ scale,
                       const float* __restrict__ bias,
                       const T* __restrict__ w1,
                       const float* __restrict__ b1,
                       const float* __restrict__ taps,
                       const float* __restrict__ bdw,
                       const T* __restrict__ w2,
                       const float* __restrict__ s, float* __restrict__ part,
                       int B, int H, int W, int C, int hid, int TH, int TW,
                       int residual, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int PW2 = TW + 2, NP2 = PW2 * (TH + 2);
  const int PW4 = TW + 4, NP4 = PW4 * (TH + 4), P = TH * TW;
  // odd strides where lanes walk over channels
  const int LS4 = NP4 | 1, LS2 = NP2 | 1, AS = P | 1;
  float* acc = reinterpret_cast<float*>(smem);  // [C][AS]: dLN, f32
  float* w1s = acc + (size_t)C * AS;             // [C][G]: fc1 columns
  float* w2t = w1s + (size_t)C * G;              // [C][G]: fc2 rows^T
  float* g1 = w2t + (size_t)C * G;               // [G][NP4]: gelu(t1)
  float* dt2 = g1 + G * NP4;                     // [G][NP2]: dt2, f32
  float* gp = dt2 + G * NP2;                     // [G][P]: gelu'(t1)
  float* g2 = gp + G * P;                        // [G][P]: gelu(t2)
  float* d1 = g2 + G * P;                        // [G][P]: round(dt1)
  float* st = d1 + G * P;                        // [2P]: LN mean, rstd
  T* ln = reinterpret_cast<T*>(st + 2 * P);      // [C][LS4]
  T* dyk = ln + (size_t)C * LS4;                 // [C][LS2]

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nw = nthr >> 5;
  const int tiles_x = (W + TW - 1) / TW;
  const int per_img = tiles_x * ((H + TH - 1) / TH);
  const size_t E = row_size(C, hid);
  float* g_w1 = part + blockIdx.x * E;
  float* g_b1 = g_w1 + (size_t)C * hid;
  float* g_taps = g_b1 + hid;
  float* g_bdw = g_taps + (size_t)hid * 9;
  float* g_w2 = g_bdw + hid;
  float* g_b2 = g_w2 + (size_t)hid * C;
  float* g_sc = g_b2 + C;
  float* g_bi = g_sc + C;
  // E is a multiple of 8 (C % 8, hid % G), so rows stay 32-byte aligned
  for (size_t e = tid; e < E / 4; e += nthr)
    reinterpret_cast<float4*>(g_w1)[e] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int tile = blockIdx.x; tile < B * per_img; tile += gridDim.x) {
    const int b = tile / per_img, t = tile % per_img;
    const int r0 = (t / tiles_x) * TH, c0 = (t % tiles_x) * TW;
    const float sb = __ldg(s + b);
    __syncthreads();  // the previous tile is done with every buffer

    for (int q = warp; q < NP4; q += nw) {
      const int r = r0 - 2 + q / PW4, c = c0 - 2 + q % PW4;
      if (!in_image(r, c, H, W)) {
        for (int ch = lane; ch < C; ch += 32) ln[ch * LS4 + q] = from_f<T>(0.f);
        continue;
      }
      const T* xp = x + (((size_t)b * H + r) * W + c) * C;
      float mean, rstd;
      ln_stats(xp, C, lane, eps, mean, rstd);
      for (int ch = lane; ch < C; ch += 32)
        ln[ch * LS4 + q] = from_f<T>((to_f(xp[ch]) - mean) * rstd *
                                         __ldg(scale + ch) +
                                     __ldg(bias + ch));
    }
    for (int q = warp; q < NP2; q += nw) {
      const int r = r0 - 1 + q / PW2, c = c0 - 1 + q % PW2;
      if (!in_image(r, c, H, W)) {
        for (int ch = lane; ch < C; ch += 32) dyk[ch * LS2 + q] = from_f<T>(0.f);
        continue;
      }
      const T* dp = dy + (((size_t)b * H + r) * W + c) * C;
      for (int ch = lane; ch < C; ch += 32)
        dyk[ch * LS2 + q] = from_f<T>(to_f(dp[ch]) * sb);
    }
    for (int i = tid; i < C * AS; i += nthr) acc[i] = 0.f;
    __syncthreads();

    // the tile's share of db2, a thread a channel
    for (int ch = tid; ch < C; ch += nthr) {
      float a = 0.f;
      for (int p = 0; p < P; ++p)
        a += to_f(dyk[ch * LS2 + (p / TW + 1) * PW2 + p % TW + 1]);
      g_b2[ch] += a;
    }

    for (int j0 = 0; j0 < hid; j0 += G) {
      // the chunk's fc1 columns and fc2 rows (transposed), both [C][G]
      for (int i = tid; i < C * (G / 8); i += nthr) {
        const int c = i / (G / 8), k = 8 * (i % (G / 8));
        float v[8];
        load8(v, w1 + (size_t)c * hid + j0 + k);
        float4* d = reinterpret_cast<float4*>(w1s + c * G + k);
        d[0] = make_float4(v[0], v[1], v[2], v[3]);
        d[1] = make_float4(v[4], v[5], v[6], v[7]);
      }
      for (int i = tid; i < G * (C / 8); i += nthr) {
        const int j = i % G, c8 = 8 * (i / G);
        float v[8];
        load8(v, w2 + (size_t)(j0 + j) * C + c8);
#pragma unroll
        for (int u = 0; u < 8; ++u) w2t[(c8 + u) * G + j] = v[u];
      }
      __syncthreads();

      // t1 on the 2-pixel halo: items (pixel, JW hidden channels)
      for (int it = tid; it < NP4 * (G / JW); it += nthr) {
        const int q = it % NP4, j8 = JW * (it / NP4);
        const int qy = q / PW4, qx = q % PW4;
        const bool inside = in_image(r0 - 2 + qy, c0 - 2 + qx, H, W);
        const bool tile_px = qy >= 2 && qy < TH + 2 && qx >= 2 && qx < TW + 2;
        float sv[JW];
        project<T>(sv, inside ? C : 0, ln + q, LS4, w1s + j8);
#pragma unroll
        for (int i = 0; i < JW; ++i) {
          const int j = j8 + i;
          const float t1 =
              round_to<T>(round_to<T>(sv[i]) + __ldg(b1 + j0 + j));
          g1[j * NP4 + q] = inside ? round_to<T>(gelu_f(t1)) : 0.f;
          if (tile_px) gp[j * P + (qy - 2) * TW + qx - 2] = gelu_grad(t1);
        }
      }
      __syncthreads();

      // on the 1-pixel halo: items (pixel, JW hidden channels)
      for (int it = tid; it < NP2 * (G / JW); it += nthr) {
        const int q = it % NP2, j8 = JW * (it / NP2);
        const int qy = q / PW2, qx = q % PW2;
        const bool inside = in_image(r0 - 1 + qy, c0 - 1 + qx, H, W);
        const bool tile_px = qy >= 1 && qy <= TH && qx >= 1 && qx <= TW;
        float dg[JW];
        project<T>(dg, inside ? C : 0, dyk + q, LS2, w2t + j8);
#pragma unroll
        for (int i = 0; i < JW; ++i) {
          const int j = j8 + i;
          float dt = 0.f, gv = 0.f;
          if (inside) {
            // q's 3x3 starts at (qy, qx) of the 2-pixel-halo plane
            const float* gj = g1 + j * NP4 + qy * PW4 + qx;
            const float* tj = taps + j0 + j;
            float t2 = 0.f;
#pragma unroll
            for (int k = 0; k < 9; ++k)
              t2 = fmaf(__ldg(tj + k * hid), gj[(k / 3) * PW4 + k % 3], t2);
            t2 = round_to<T>(round_to<T>(t2) + __ldg(bdw + j0 + j));
            dt = dg[i] * gelu_grad(t2);
            gv = round_to<T>(gelu_f(t2));
          }
          dt2[j * NP2 + q] = dt;
          if (tile_px) g2[j * P + (qy - 1) * TW + qx - 1] = gv;
        }
      }
      __syncthreads();

      // dt1 on the tile, a warp a hidden channel (lanes over pixels), and
      // the tile's shares of db1 (f32 dt1) and db_dw (f32 dt2)
      for (int j = warp; j < G; j += nw) {
        const float* tj = taps + j0 + j;
        const float* dj = dt2 + j * NP2;
        float s1 = 0.f, s2 = 0.f;
        for (int p = lane; p < P; p += 32) {
          const int py = p / TW, px = p % TW;
          float d = 0.f;
          if (in_image(r0 + py, c0 + px, H, W)) {
            // sum_k tap_k round(dt2)(p - d_k), d_k = (k / 3 - 1, k % 3 - 1)
            const float* dc = dj + (py + 2) * PW2 + px + 2;
            float u = 0.f;
#pragma unroll
            for (int k = 0; k < 9; ++k)
              u = fmaf(__ldg(tj + k * hid),
                       round_to<T>(dc[-(k / 3) * PW2 - k % 3]), u);
            d = u * gp[j * P + p];
            s2 += dj[(py + 1) * PW2 + px + 1];
          }
          d1[j * P + p] = round_to<T>(d);
          s1 += d;
        }
        s1 = warp_sum(s1);
        s2 = warp_sum(s2);
        if (lane == 0) {
          g_b1[j0 + j] += s1;
          g_bdw[j0 + j] += s2;
        }
      }
      __syncthreads();

      // the tile's shares of dtaps, dW1 and dW2; dLN += W1 round(dt1)
      uir::tap_grad_acc<float>(g_taps + (size_t)j0 * 9, dt2, 1, g1, 2, G, TH,
                               TW);
      outer4<T, float>(g_w1 + j0, hid, ln, LS4, 2, C, d1, P, 0, G, TH, TW);
      outer4<float, T>(g_w2 + (size_t)j0 * C, C, g2, P, 0, G, dyk, LS2, 1, C,
                       TH, TW);
      for (int it = tid; it < P * (C / 4); it += nthr) {
        const int p = it % P, c4 = 4 * (it / P);
        float u0 = 0.f, u1 = 0.f, u2 = 0.f, u3 = 0.f;
        const float* wr = w1s + c4 * G;
#pragma unroll 8
        for (int j = 0; j < G; ++j) {
          const float dv = d1[j * P + p];
          u0 = fmaf(wr[j], dv, u0);
          u1 = fmaf(wr[G + j], dv, u1);
          u2 = fmaf(wr[2 * G + j], dv, u2);
          u3 = fmaf(wr[3 * G + j], dv, u3);
        }
        acc[c4 * AS + p] += u0;
        acc[(c4 + 1) * AS + p] += u1;
        acc[(c4 + 2) * AS + p] += u2;
        acc[(c4 + 3) * AS + p] += u3;
      }
      // the next chunk overwrites the weights and the chunk planes
      __syncthreads();
    }

    // LayerNorm backward of the tile, a warp a pixel: dx, and the pixel's
    // mean and rstd for the dscale/dbias shares below
    for (int p = warp; p < P; p += nw) {
      const int r = r0 + p / TW, c = c0 + p % TW;
      if (!in_image(r, c, H, W)) continue;
      const size_t base = (((size_t)b * H + r) * W + c) * C;
      float mean, rstd;
      ln_stats(x + base, C, lane, eps, mean, rstd);
      float s1 = 0.f, s2 = 0.f;
      for (int ch = lane; ch < C; ch += 32) {
        const float xh = (to_f(x[base + ch]) - mean) * rstd;
        const float g = acc[ch * AS + p] * __ldg(scale + ch);
        s1 += g;
        s2 = fmaf(g, xh, s2);
      }
      s1 = warp_sum(s1) / C;
      s2 = warp_sum(s2) / C;
      for (int ch = lane; ch < C; ch += 32) {
        const float xh = (to_f(x[base + ch]) - mean) * rstd;
        const float g = acc[ch * AS + p] * __ldg(scale + ch);
        const float dxl = round_to<T>(rstd * (g - s1 - xh * s2));
        dx[base + ch] =
            from_f<T>(residual ? to_f(dy[base + ch]) + dxl : dxl);
      }
      if (lane == 0) {
        st[p] = mean;
        st[P + p] = rstd;
      }
    }
    __syncthreads();
    // the tile's shares of dscale and dbias, a thread a channel, pixels in
    // order
    for (int ch = tid; ch < C; ch += nthr) {
      float a = 0.f, bsum = 0.f;
      for (int p = 0; p < P; ++p) {
        const int r = r0 + p / TW, c = c0 + p % TW;
        if (!in_image(r, c, H, W)) continue;
        const float dl = acc[ch * AS + p];
        const float xh =
            (to_f(x[(((size_t)b * H + r) * W + c) * C + ch]) - st[p]) *
            st[P + p];
        a = fmaf(dl, xh, a);
        bsum += dl;
      }
      g_sc[ch] += a;
      g_bi[ch] += bsum;
    }
  }
}

template <typename T>
int launch(const void* x, const void* dy, void* dx, const float* scale,
           const float* bias, const void* w1, const float* b1,
           const float* taps, const float* bdw, const void* w2,
           const float* s, float* part, float* grads, int B, int H, int W,
           int C, int hid, int TH, int TW, int groups, int residual,
           float eps, cudaStream_t stream) {
  const size_t np2 = (size_t)(TH + 2) * (TW + 2);
  const size_t np4 = (size_t)(TH + 4) * (TW + 4), p = (size_t)TH * TW;
  const size_t smem = (C * (p | 1) + 2 * (size_t)C * G + G * np4 + G * np2 +
                       3 * G * p + 2 * p) * sizeof(float) +
                      C * ((np4 | 1) + (np2 | 1)) * sizeof(T);
  auto kern = ln_leff_bwd_kernel<T>;
  cudaError_t e = uir::set_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<groups, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<T*>(dx),
      scale, bias, static_cast<const T*>(w1), b1, taps, bdw,
      static_cast<const T*>(w2), s, part, B, H, W, C, hid, TH, TW, residual,
      eps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)uir::reduce_rows(part, grads, groups, (int)row_size(C, hid),
                               stream);
}

}  // namespace

// Two launches: the tile kernel (grid `groups`, each block's weight-gradient
// row in part [groups][E]) and the ordered row sum into grads [E].
extern "C" int uir_ln_leff_bwd(const void* x, const void* dy, void* dx,
                               const void* scale, const void* bias,
                               const void* w1, const void* b1,
                               const void* taps, const void* bdw,
                               const void* w2, const void* s, void* part,
                               void* grads, int B, int H, int W, int C,
                               int hid_pad, int chunk, int residual, int bf16,
                               int TH, int TW, int groups, float eps,
                               void* stream) {
  // C % 8 and hid_pad % G: the eight-value loads stay aligned
  if (chunk != G || hid_pad % G || C % 8 || B < 1 || groups < 1 ||
      !uir::tile_ok(TH, TW))
    return (int)cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto* pt = static_cast<float*>(part);
  auto* gr = static_cast<float*>(grads);
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(x, dy, dx, f(scale), f(bias), w1, f(b1),
                                 f(taps), f(bdw), w2, f(s), pt, gr, B, H, W,
                                 C, hid_pad, TH, TW, groups, residual, eps,
                                 st);
  return launch<float>(x, dy, dx, f(scale), f(bias), w1, f(b1), f(taps),
                       f(bdw), w2, f(s), pt, gr, B, H, W, C, hid_pad, TH, TW,
                       groups, residual, eps, st);
}
