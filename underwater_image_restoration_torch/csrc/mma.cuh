// Tensor-core building blocks of the backward kernels (csrc/ln_leff_bwd.cu,
// csrc/ln_gdfn_bwd.cu): a warp-level bf16 product on shared-memory
// operands, asynchronous staging of operand tiles, and the hi/lo split
// that carries f32 operands through bf16 products.
//
// Why.  The 1x1 products of both backward passes (fc1 and fc2's transpose,
// project_in and project_out, their weight gradients, dLN) are where the
// work is: at the port's widths they are far above the H100's bf16 ridge,
// so the f32 FMA pipe (67 TFLOP/s) bounded the kernels before.  Here they
// run as mma.sync.m16n8k16 (bf16 in, f32 accumulate; HMMA in the SASS)
// against the 989 TFLOP/s of the tensor cores.
//
// The product.  A warp multiplies 16 x 16 A fragments by 16 x 8 B fragments
// loaded from shared memory with ldmatrix; an operand stored K-major (A as
// [k][m], B as [k][n]) loads with ldmatrix.trans.  A caller adds the k16
// steps into its accumulators in a fixed order, so two runs give the same
// bits.  Rows of an operand tile are 16-byte aligned and padded so that
// eight consecutive rows fall on distinct 16-byte bank groups (pad_ld).
//
// f32 operands.  A value v that is not exactly bf16 is carried as two
// planes, hi = bf16(v) and lo = bf16(v - hi), which hold v to about 2^-17
// of |v|.  A product takes a_hi b_hi + a_hi b_lo when only b is split, and
// adds a_lo b_hi when a is split too (the a_lo b_lo term, about 2^-18 of
// each product, is dropped).  An operand that is exactly bf16 (every
// operand of a bf16 LeFF call; LN, dy and the gate output of a bf16 GDFN
// call) has one plane and costs one pass.
//
// Staging.  cp_async16 copies 16 bytes from device memory into shared
// memory without passing through registers, zero-filling when the source
// lies outside the operand; a caller commits a group for the next tile and
// waits for the current one, so loads overlap the products.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace uir {
namespace mma {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Elements of a shared-memory row of n bf16 values: n rounded up to 8 (16
// bytes), plus 8 when that is an even number of 16-byte units, so that the
// rows of an 8 x 8 ldmatrix (or of eight lanes' 32-bit loads) hit distinct
// banks.
__host__ __device__ constexpr int pad_ld(int n) {
  return ((n + 7) / 8) % 2 ? (n + 7) / 8 * 8 : (n + 7) / 8 * 8 + 8;
}

// ---- asynchronous staging

// 16 bytes from src (global) to dst (shared); zeros when !valid (src is
// then not read, but must be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---- the hi/lo split

__device__ __forceinline__ void split(float v, bf16& hi, bf16& lo) {
  hi = __float2bfloat16(v);
  lo = __float2bfloat16(v - __bfloat162float(hi));
}

// Stores v into plane 0 (and its remainder into plane 1 when NP == 2) at
// index i: hi[i], hi[i + lo_off].
template <int NP>
__device__ __forceinline__ void put(bf16* p, size_t lo_off, size_t i,
                                    float v) {
  bf16 hi, lo;
  split(v, hi, lo);
  p[i] = hi;
  if constexpr (NP == 2) p[i + lo_off] = lo;
}

// Two consecutive values (i even), as one 32-bit store a plane.
template <int NP>
__device__ __forceinline__ void put2(bf16* p, size_t lo_off, size_t i,
                                     float v0, float v1) {
  __nv_bfloat162 hi, lo;
  split(v0, hi.x, lo.x);
  split(v1, hi.y, lo.y);
  *reinterpret_cast<__nv_bfloat162*>(p + i) = hi;
  if constexpr (NP == 2)
    *reinterpret_cast<__nv_bfloat162*>(p + i + lo_off) = lo;
}

// ---- fragments

// ldmatrix of four 8 x 8 b16 matrices (.trans: each transposed)
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// The A fragment (16 x 16, m x k) whose (0, 0) element is at p: stored
// [m][k] (element (m, k) at p[m * ld + k]) or, with km, [k][m] (at
// p[k * ld + m]).  p and ld keep every row 16-byte aligned.
template <bool KM>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* p,
                                       int ld) {
  const int l = threadIdx.x & 31;
  if (KM)
    ldsm4_t(a, p + ((l & 7) + 8 * (l >> 4)) * ld + 8 * ((l >> 3) & 1));
  else
    ldsm4(a, p + (l & 15) * ld + 8 * (l >> 4));
}

// The B fragments of two n8 tiles (k16 x n16) whose (k 0, n 0) element is at
// p: b[0], b[1] the first tile's, b[2], b[3] the second's.  Stored [n][k]
// (element (k, n) at p[n * ld + k]) or, with kn, [k][n] (at p[k * ld + n]).
template <bool KN>
__device__ __forceinline__ void frag_b2(uint32_t (&b)[4], const bf16* p,
                                        int ld) {
  const int l = threadIdx.x & 31;
  if (KN)
    ldsm4_t(b, p + ((l & 7) + 8 * ((l >> 3) & 1)) * ld + 8 * (l >> 4));
  else
    ldsm4(b, p + ((l & 7) + 8 * (l >> 4)) * ld + 8 * ((l >> 3) & 1));
}

// 32-bit load of two consecutive bf16 values (4-byte aligned): a fragment
// register where an operand's consecutive k values are consecutive in
// memory but its rows are not 16-byte aligned.
__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a b on the tensor cores (m16n8k16, bf16 in, f32 accumulate).
// Accumulator element e of lane l sits at row l / 4 + 8 (e / 2), column
// 2 (l % 4) + e % 2.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One k16 step of a split product into d: a[0] b[0], then a[0] b[1] when B
// has a lo plane (NPB == 2), then a[1] b[0] when A has one (NPA == 2).
template <int NPA, int NPB>
__device__ __forceinline__ void mma_split(float (&d)[4],
                                          const uint32_t (&a)[NPA][4],
                                          const uint32_t (&b)[NPB][2]) {
  mma16816(d, a[0], b[0][0], b[0][1]);
  if constexpr (NPB == 2) mma16816(d, a[0], b[1][0], b[1][1]);
  if constexpr (NPA == 2) mma16816(d, a[1], b[0][0], b[0][1]);
}

}  // namespace mma
}  // namespace uir
