// Tensor-core building blocks: a warp-level bf16 product on shared-memory
// operands, asynchronous staging of operand tiles, and the hi/lo split that
// carries f32 operands through bf16 products.  csrc/ln_gdfn.cu and
// csrc/ln_gdfn_bwd.cu use them inside their tiles (csrc/gdfn.cuh), and the
// window attention's kernels inside their warps (csrc/wattn.cuh);
// csrc/gemm.cuh builds the staged kernels' product launch (csrc/ln_mdta.cu,
// csrc/ln_mdta_bwd.cu, csrc/ln_leff.cu, csrc/ln_leff_bwd.cu) on them.
//
// Why.  The 1x1 and per-head products of these kernels (fc1 and fc2 and
// their transposes, project_in and project_out, the attention's, their
// weight gradients, dLN) are where the work is: at the port's widths they
// are far above the H100's bf16 ridge, so the f32 FMA pipe (67 TFLOP/s)
// bounded the kernels before.  Here they run as mma.sync.m16n8k16 (bf16 in,
// f32 accumulate; HMMA in the SASS) against the 989 TFLOP/s of the tensor
// cores.
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
// each product, is dropped).  Where a sum cancels far enough to need full
// f32 (csrc/ln_mdta_bwd.cu in f32: its dtemp; the window attention's dw),
// or an f32 check runs close to its limit (the LN+LeFF forward, the window
// attention's forward), a value is carried as three planes, hi, mid =
// bf16(v - hi) and lo = bf16(v - hi - mid), about 2^-24 of |v|, and a
// product takes the passes (i, j) of plane i of a and j of b with i + j <=
// 2, about 2^-24 of each product.  An operand that is
// exactly bf16 (every operand of a bf16 LeFF call; LN, dy and the gate
// output of a bf16 GDFN call; the activations rounded to T of a bf16 MDTA
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

// The NP planes of v: plane k the bf16 of what planes 0..k-1 leave.
template <int NP>
__device__ __forceinline__ void planes(float v, bf16 (&pl)[NP]) {
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    pl[k] = __float2bfloat16(v);
    v -= __bfloat162float(pl[k]);
  }
}

// Stores v into its NP planes at index i: p[i], p[i + plane], ...
template <int NP>
__device__ __forceinline__ void put(bf16* p, size_t plane, size_t i,
                                    float v) {
  bf16 pl[NP];
  planes<NP>(v, pl);
#pragma unroll
  for (int k = 0; k < NP; ++k) p[i + k * plane] = pl[k];
}

// Two consecutive values (i even), as one 32-bit store a plane.
template <int NP>
__device__ __forceinline__ void put2(bf16* p, size_t plane, size_t i,
                                     float v0, float v1) {
  bf16 a[NP], b[NP];
  planes<NP>(v0, a);
  planes<NP>(v1, b);
#pragma unroll
  for (int k = 0; k < NP; ++k)
    *reinterpret_cast<__nv_bfloat162*>(p + i + k * plane) =
        __halves2bfloat162(a[k], b[k]);
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

// One k16 step of a split product into d: the passes (i, j) of plane i of a
// and plane j of b with i + j <= max(NPA, NPB) - 1, in the order (0, 0),
// (0, 1), (1, 0), (0, 2), (2, 0), (1, 1): with two planes a[0] b[0], then
// a[0] b[1] when B has a lo plane, then a[1] b[0] when A has one.  Written
// out pass by pass, so every instantiation is straight-line code.
template <int NPA, int NPB>
__device__ __forceinline__ void mma_split(float (&d)[4],
                                          const uint32_t (&a)[NPA][4],
                                          const uint32_t (&b)[NPB][2]) {
  constexpr bool three = NPA > 2 || NPB > 2;
  mma16816(d, a[0], b[0][0], b[0][1]);
  if constexpr (NPB > 1) mma16816(d, a[0], b[1][0], b[1][1]);
  if constexpr (NPA > 1) mma16816(d, a[1], b[0][0], b[0][1]);
  if constexpr (NPB > 2) mma16816(d, a[0], b[2][0], b[2][1]);
  if constexpr (NPA > 2) mma16816(d, a[2], b[0][0], b[0][1]);
  if constexpr (three && NPA > 1 && NPB > 1)
    mma16816(d, a[1], b[1][0], b[1][1]);
}

}  // namespace mma
}  // namespace uir
