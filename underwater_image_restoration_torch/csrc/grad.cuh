// Shared device helpers of the port's backward kernels: tile-pixel
// indexing, the transposed 3x3 depthwise tap sum, the tiles' shares of
// weight gradients, the channel-LayerNorm backward of a tile, and the
// ordered reduction of per-block partial rows.
//
// A tile is TH x TW pixels whose top-left image position is (r0, c0); TW
// divides 32 (tile_ok).
// Channel-major shared planes hold it with a halo of 0, 1 or 2 pixels:
// pixel (py, px) of the tile sits at (py + h) * (TW + 2h) + px + h.
// Weight-gradient partials accumulate in one row of global memory per
// block (written by that block alone, in its own order); reduce_rows sums
// the rows in block order, so no result depends on block scheduling and no
// float atomics are used.
#pragma once

#include "common.cuh"

namespace uir {

__device__ __forceinline__ bool in_image(int r, int c, int H, int W) {
  return r >= 0 && r < H && c >= 0 && c < W;
}

// out[c][p] = sum_k taps[c][k] * d[c][p - d_k] for every tile pixel p, the
// transposed (adjoint) depthwise 3x3 with zero padding: d is channel-major
// on the tile's 1-pixel halo (zero outside the image), d_k = (k / 3 - 1,
// k % 3 - 1).  Pixels of the tile outside the image get 0.
template <typename TD>
__device__ void tap9_t(float* out, const TD* d, const float* __restrict__ taps,
                       int NC, int TH, int TW, int r0, int c0, int H, int W) {
  const int P = TH * TW, PW2 = TW + 2, NP2 = PW2 * (TH + 2);
  for (int it = threadIdx.x; it < NC * P; it += blockDim.x) {
    const int p = it % P, c = it / P;
    const int py = p / TW, px = p % TW;
    float s = 0.f;
    if (in_image(r0 + py, c0 + px, H, W)) {
      const TD* dc = d + (size_t)c * NP2 + (py + 2) * PW2 + px + 2;
      const float* tc = taps + (size_t)c * 9;
#pragma unroll
      for (int k = 0; k < 9; ++k)
        s = fmaf(__ldg(tc + k), to_f(dc[-(k / 3) * PW2 - k % 3]), s);
    }
    out[(size_t)c * P + p] = s;
  }
}

// The weight-gradient products below are sums over the tile's pixels, one
// warp an output block: lane l takes pixels l, l + 32, ... (TW divides 32,
// so its column is fixed and its row steps by 32 / TW), and the block is
// summed over the lanes by shuffles.  Neighbouring lanes read neighbouring
// pixels of one channel plane, so shared-memory reads do not conflict
// whatever the planes' strides.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// dst[c * 9 + k] += sum over tile pixels p of d[c][p] * u[c][p + d_k]: the
// tile's share of a depthwise tap gradient.  d is on a halo of hd pixels, u
// on a halo of hu >= 1 pixels (zero outside the image).
template <typename TD>
__device__ void tap_grad_acc(float* dst, const TD* d, int hd, const float* u,
                             int hu, int NC, int TH, int TW) {
  const int PWd = TW + 2 * hd, NPd = PWd * (TH + 2 * hd);
  const int PWu = TW + 2 * hu, NPu = PWu * (TH + 2 * hu);
  const int lane = threadIdx.x & 31, px = lane % TW;
  for (int c = threadIdx.x >> 5; c < NC; c += blockDim.x >> 5) {
    const TD* dc = d + (size_t)c * NPd + hd * PWd + hd + px;
    const float* uc = u + (size_t)c * NPu + (hu - 1) * PWu + hu - 1 + px;
    float s[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int py = lane / TW; py < TH; py += 32 / TW) {
      const float dv = to_f(dc[py * PWd]);
      const float* up = uc + py * PWu;
#pragma unroll
      for (int k = 0; k < 9; ++k)
        s[k] = fmaf(dv, up[(k / 3) * PWu + k % 3], s[k]);
    }
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const float t = warp_sum(s[k]);
      if (lane == k) dst[c * 9 + k] += t;
    }
  }
}

// dst[i * ldd + o] += sum over tile pixels p of a[i][p] * b[o][p] for i < NI
// and o < NO (both multiples of 4): the tile's share of a 1x1 conv's weight
// gradient, 4 x 4 outputs a warp.  a is on a halo of ha pixels, b on a halo
// of hb.
template <typename TA, typename TB>
__device__ void outer_acc(float* dst, int ldd, const TA* a, int ha, int NI,
                          const TB* b, int hb, int NO, int TH, int TW) {
  const int PWa = TW + 2 * ha, NPa = PWa * (TH + 2 * ha);
  const int PWb = TW + 2 * hb, NPb = PWb * (TH + 2 * hb);
  const int lane = threadIdx.x & 31, px = lane % TW;
  const int nbi = NI / 4;
  for (int it = threadIdx.x >> 5; it < nbi * (NO / 4);
       it += blockDim.x >> 5) {
    const int i0 = 4 * (it % nbi), o0 = 4 * (it / nbi);
    const TA* ai = a + (size_t)i0 * NPa + ha * PWa + ha + px;
    const TB* bo = b + (size_t)o0 * NPb + hb * PWb + hb + px;
    float s[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) s[e] = 0.f;
    for (int py = lane / TW; py < TH; py += 32 / TW) {
      float av[4], bv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        av[u] = to_f(ai[u * NPa + py * PWa]);
        bv[u] = to_f(bo[u * NPb + py * PWb]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v)
          s[4 * u + v] = fmaf(av[u], bv[v], s[4 * u + v]);
    }
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const float t = warp_sum(s[e]);
      if (lane == e) dst[(size_t)(i0 + e / 4) * ldd + o0 + e % 4] += t;
    }
  }
}

// launch check of a backward tile: TW divides 32 (the products above
// assume it)
inline bool tile_ok(int TH, int TW) {
  return TH > 0 && TW > 0 && 32 % TW == 0;
}

// LayerNorm backward of a tile.  acc [C][P] holds the f32 gradient at the
// LN output; it is rounded to T first (the LN output is materialized in T,
// so its cotangent is too).  For every in-image pixel: dx = round(dy +
// round(dx_ln)), the residual's cotangent plus the LN input's, each rounded
// where autograd through the plain version rounds it.  dsc/dbi get the
// tile's shares of dscale (sum dln * xhat) and dbias (sum dln).  st is 2P
// floats of scratch.  Ends with the block synchronized.
template <typename T>
__device__ void ln_backward_tile(const T* __restrict__ xb,
                                 const T* __restrict__ dyb, T* __restrict__ dxb,
                                 const float* acc, float* st,
                                 const float* __restrict__ scale, float* dsc,
                                 float* dbi, int C, int H, int W, int r0,
                                 int c0, int TH, int TW, float eps) {
  const int P = TH * TW;
  const size_t plane = (size_t)H * W;
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const int r = r0 + p / TW, cc = c0 + p % TW;
    st[p] = 0.f;
    st[P + p] = 0.f;
    if (!in_image(r, cc, H, W)) continue;
    const size_t pix = (size_t)r * W + cc;
    float s = 0.f;
    for (int ch = 0; ch < C; ++ch) s += to_f(xb[ch * plane + pix]);
    const float mean = s / C;
    float v = 0.f;
    for (int ch = 0; ch < C; ++ch) {
      const float d = to_f(xb[ch * plane + pix]) - mean;
      v += d * d;
    }
    const float rstd = rsqrtf(v / C + eps);
    float s1 = 0.f, s2 = 0.f;
    for (int ch = 0; ch < C; ++ch) {
      const float xh = (to_f(xb[ch * plane + pix]) - mean) * rstd;
      const float g = round_to<T>(acc[ch * P + p]) * __ldg(scale + ch);
      s1 += g;
      s2 = fmaf(g, xh, s2);
    }
    s1 /= C;
    s2 /= C;
    for (int ch = 0; ch < C; ++ch) {
      const size_t idx = ch * plane + pix;
      const float xh = (to_f(xb[idx]) - mean) * rstd;
      const float g = round_to<T>(acc[ch * P + p]) * __ldg(scale + ch);
      const float dxl = rstd * (g - s1 - xh * s2);
      dxb[idx] = from_f<T>(to_f(dyb[idx]) + round_to<T>(dxl));
    }
    st[p] = mean;
    st[P + p] = rstd;
  }
  __syncthreads();
  // one warp a channel, lanes over pixels (as the products above)
  const int lane = threadIdx.x & 31;
  for (int ch = threadIdx.x >> 5; ch < C; ch += blockDim.x >> 5) {
    float a = 0.f, b = 0.f;
    for (int p = lane; p < P; p += 32) {
      const int r = r0 + p / TW, cc = c0 + p % TW;
      if (!in_image(r, cc, H, W)) continue;
      const float dl = round_to<T>(acc[ch * P + p]);
      const float xh =
          (to_f(xb[ch * plane + (size_t)r * W + cc]) - st[p]) * st[P + p];
      a = fmaf(dl, xh, a);
      b += dl;
    }
    a = warp_sum(a);
    b = warp_sum(b);
    if (lane == 0) {
      dsc[ch] += a;
      dbi[ch] += b;
    }
  }
  __syncthreads();
}

// out[e] = sum over g < rows of part[g * E + e], in g order.
__global__ void reduce_rows_kernel(const float* __restrict__ part,
                                   float* __restrict__ out, int rows, int E) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  float s = 0.f;
  for (int g = 0; g < rows; ++g) s += part[(size_t)g * E + e];
  out[e] = s;
}

inline cudaError_t reduce_rows(const float* part, float* out, int rows, int E,
                               cudaStream_t stream) {
  reduce_rows_kernel<<<(E + 255) / 256, 256, 0, stream>>>(part, out, rows, E);
  return cudaGetLastError();
}

template <typename K>
cudaError_t set_smem(K kern, size_t smem) {
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace uir
