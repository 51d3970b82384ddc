// Shared device helpers of the tile-local backward kernel
// (csrc/ln_gdfn_bwd.cu): tile-pixel indexing, the channel-LayerNorm backward
// of a tile, and the ordered reduction of per-block partial rows.
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

// the sum over a warp's lanes (a fixed shuffle tree)
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// launch check of a backward tile: TW divides 32 (ln_gdfn_bwd's products
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
