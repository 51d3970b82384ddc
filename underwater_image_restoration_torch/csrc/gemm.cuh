// The port's tensor-core product launch, shared by the staged kernels
// (csrc/ln_mdta.cu, csrc/ln_mdta_bwd.cu, csrc/ln_leff.cu,
// csrc/ln_leff_bwd.cu): a block tile of A B on mma.sync (mma.cuh) over
// operand tiles staged by cp.async, handed as f32 to an epilogue functor;
// and the ordered sum of the rows that split products and per-block shares
// leave behind.
//
// Operands.  An Opnd is a matrix in device memory as bf16 planes: hi and,
// for an f32 operand, lo (and mid; mma.cuh's split), rows ld elements
// apart; zs is the elements between two batches (the z index's images), so
// a launch can take one operand per image.  A tile says how each operand is
// stored (A [k][m] or [m][k], B [k][n] or [n][k]) and how many planes each
// has: a product takes 1 pass when both are exactly bf16, 2 when one is
// split in two, 3 when both are, 6 when both are split in three.
//
// Staging.  A tile's k loop keeps STAGES - 1 operand tiles in flight
// (cp.async groups) while it multiplies the current one: 2 stages where K
// is a few tiles deep, more where a block walks a long K (pixels) and the
// loads' latency, not the products, would set its pace.
//
// Sums.  mma.sync adds its products into the f32 accumulator with
// truncation, so a sum over a long K (thousands of pixels) drifts toward
// zero by about one f32 ulp a step.  With RN, each k tile's passes go into
// a fresh accumulator that is then added to the running sum by an ordinary
// (round-to-nearest) f32 add: the drift stays within a k tile.
//
// The launch.  blockIdx.x is the m tile, blockIdx.y the n tile, blockIdx.z
// = (batch * splits + split) * nprob + prob.  Problem 1 takes A[1], B[1]
// and its own N; split s covers k in [s Ks, min(K, (s + 1) Ks)).  With
// band > 0, B is block-diagonal in bands of that width (zero outside them)
// and an n tile takes only the k of its own bands; with diag, only the
// diagonal output tiles run (n0 = m0, BM = BN).  k slices add into the
// accumulators in order and each k16 step's passes in mma_split's order,
// so two runs give the same bits.
//
// Rows.  A product split over k, or an epilogue that reduces over its
// tile's pixels, writes its own row of partial sums; reduce_rows sums rows
// in a fixed order (a thread an output, or a warp an output for a segment
// of TALL rows or more: lanes over the rows in order, then a fixed shuffle
// tree), never with float atomics.
#pragma once

#include <cstdint>

#include "mma.cuh"

namespace uir {
namespace gemm {

namespace mm = uir::mma;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int BK = 32;  // k depth of a staged operand tile

struct Opnd {
  const bf16* pl[3];  // the planes (unused ones unread)
  int ld;
  long long zs;  // elements from one batch's operand to the next's
};

// One block tile of a product: BM x BN outputs, WM x WN warps, A stored
// [k][m] (AKM) or [m][k], B stored [k][n] (BKN) or [n][k], NPA and NPB
// planes (1 to 3).  Shared memory holds STAGES stages of operand
// tiles and, after the k loop, the f32 result tile (OLD floats a row); RN:
// the k tiles' sums added round-to-nearest (see Sums).
template <int BM_, int BN_, int WM_, int WN_, bool AKM_, bool BKN_, int NPA_,
          int NPB_ = NPA_, int STAGES_ = 2, bool RN_ = false>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_;
  static constexpr int NPA = NPA_, NPB = NPB_, STAGES = STAGES_;
  static constexpr bool RN = RN_;
  static_assert(STAGES >= 2, "a stage in flight while one is multiplied");
  static constexpr bool AKM = AKM_, BKN = BKN_;
  static_assert(WM * WN * 32 == kThreads, "one warp a warp tile");
  static constexpr int TM = BM / WM, TN = BN / WN;
  static constexpr int MI = TM / 16, NI = TN / 8;
  static_assert(MI >= 1 && NI >= 2 && NI % 2 == 0, "warp tile shape");
  static constexpr int ALD = mm::pad_ld(AKM ? BM : BK);
  static constexpr int BLD = mm::pad_ld(BKN ? BN : BK);
  static constexpr int AT = (AKM ? BK : BM) * ALD;  // elements a plane
  static constexpr int BT = (BKN ? BK : BN) * BLD;
  static constexpr int STAGE = NPA * AT + NPB * BT;
  static constexpr int OLD = BN + 8;
  static constexpr size_t OPER_BYTES = (size_t)STAGES * STAGE * sizeof(bf16);
  static constexpr size_t OUT_BYTES = (size_t)BM * OLD * sizeof(float);
  static constexpr size_t SMEM = OPER_BYTES > OUT_BYTES ? OPER_BYTES
                                                        : OUT_BYTES;
};

// Stage the operand tiles of k slice [k0, k0 + BK) with cp.async; rows and
// columns outside (M, N, kend) are zero-filled.
template <class TL>
__device__ void load_stage(bf16* s, const Opnd& A, const Opnd& B, int M,
                           int N, int kend, int m0, int n0, int k0) {
  bf16* sa = s;
  bf16* sb = s + TL::NPA * TL::AT;
  constexpr int ACH = TL::AKM ? BK * (TL::BM / 8) : TL::BM * (BK / 8);
  for (int i = threadIdx.x; i < ACH; i += kThreads) {
    int r, cc;
    bool ok;
    size_t src;
    if (TL::AKM) {  // rows k, chunks of 8 m
      r = i / (TL::BM / 8), cc = 8 * (i % (TL::BM / 8));
      ok = k0 + r < kend && m0 + cc < M;
      src = (size_t)(k0 + r) * A.ld + m0 + cc;
    } else {  // rows m, chunks of 8 k
      r = i / (BK / 8), cc = 8 * (i % (BK / 8));
      ok = m0 + r < M && k0 + cc < kend;
      src = (size_t)(m0 + r) * A.ld + k0 + cc;
    }
    bf16* d = sa + r * TL::ALD + cc;
#pragma unroll
    for (int pl = 0; pl < TL::NPA; ++pl)
      mm::cp_async16(d + pl * TL::AT, ok ? A.pl[pl] + src : A.pl[pl], ok);
  }
  constexpr int BCH = TL::BKN ? BK * (TL::BN / 8) : TL::BN * (BK / 8);
  for (int i = threadIdx.x; i < BCH; i += kThreads) {
    int r, cc;
    bool ok;
    size_t src;
    if (TL::BKN) {  // rows k, chunks of 8 n
      r = i / (TL::BN / 8), cc = 8 * (i % (TL::BN / 8));
      ok = k0 + r < kend && n0 + cc < N;
      src = (size_t)(k0 + r) * B.ld + n0 + cc;
    } else {  // rows n, chunks of 8 k
      r = i / (BK / 8), cc = 8 * (i % (BK / 8));
      ok = n0 + r < N && k0 + cc < kend;
      src = (size_t)(n0 + r) * B.ld + k0 + cc;
    }
    bf16* d = sb + r * TL::BLD + cc;
#pragma unroll
    for (int pl = 0; pl < TL::NPB; ++pl)
      mm::cp_async16(d + pl * TL::BT, ok ? B.pl[pl] + src : B.pl[pl], ok);
  }
}

// The block's BM x BN tile of A B over k in [kbeg, kend), left in shared
// memory as f32 (row r at out[r * TL::OLD]); the block is synchronized.
template <class TL>
__device__ float* tile_product(bf16* smem, const Opnd& A, const Opnd& B,
                               int M, int N, int kbeg, int kend, int m0,
                               int n0) {
  float acc[TL::MI][TL::NI][4];
#pragma unroll
  for (int i = 0; i < TL::MI; ++i)
#pragma unroll
    for (int j = 0; j < TL::NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp % TL::WM, wn = warp / TL::WM;
  const int nk = (kend - kbeg + BK - 1) / BK;
  constexpr int S = TL::STAGES;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nk)
      load_stage<TL>(smem + s * TL::STAGE, A, B, M, N, kend, m0, n0,
                     kbeg + s * BK);
    mm::cp_async_commit();
  }
  for (int t = 0; t < nk; ++t) {
    mm::cp_async_wait<S - 2>();
    // stage t has landed for every thread, and every thread is done with
    // stage t - 1, whose buffer the next load refills
    __syncthreads();
    if (t + S - 1 < nk)
      load_stage<TL>(smem + ((t + S - 1) % S) * TL::STAGE, A, B, M, N, kend,
                     m0, n0, kbeg + (t + S - 1) * BK);
    mm::cp_async_commit();
    const bf16* sa = smem + (t % S) * TL::STAGE;
    const bf16* sb = sa + TL::NPA * TL::AT;
    float part[TL::RN ? TL::MI : 1][TL::RN ? TL::NI : 1][4];
    if constexpr (TL::RN) {
#pragma unroll
      for (int i = 0; i < TL::MI; ++i)
#pragma unroll
        for (int j = 0; j < TL::NI; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[TL::MI][TL::NPA][4];
      uint32_t bfr[TL::NI][TL::NPB][2];
#pragma unroll
      for (int mi = 0; mi < TL::MI; ++mi) {
        const int m = wm * TL::TM + mi * 16;
#pragma unroll
        for (int pl = 0; pl < TL::NPA; ++pl)
          mm::frag_a<TL::AKM>(af[mi][pl],
                              sa + pl * TL::AT +
                                  (TL::AKM ? kk * TL::ALD + m
                                           : m * TL::ALD + kk),
                              TL::ALD);
      }
#pragma unroll
      for (int ni = 0; ni < TL::NI; ni += 2) {
        const int n = wn * TL::TN + ni * 8;
#pragma unroll
        for (int pl = 0; pl < TL::NPB; ++pl) {
          uint32_t r[4];
          mm::frag_b2<TL::BKN>(r,
                               sb + pl * TL::BT +
                                   (TL::BKN ? kk * TL::BLD + n
                                            : n * TL::BLD + kk),
                               TL::BLD);
          bfr[ni][pl][0] = r[0];
          bfr[ni][pl][1] = r[1];
          bfr[ni + 1][pl][0] = r[2];
          bfr[ni + 1][pl][1] = r[3];
        }
      }
#pragma unroll
      for (int mi = 0; mi < TL::MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < TL::NI; ++ni) {
          if constexpr (TL::RN)
            mm::mma_split<TL::NPA, TL::NPB>(part[mi][ni], af[mi], bfr[ni]);
          else
            mm::mma_split<TL::NPA, TL::NPB>(acc[mi][ni], af[mi], bfr[ni]);
        }
    }
    if constexpr (TL::RN) {
#pragma unroll
      for (int i = 0; i < TL::MI; ++i)
#pragma unroll
        for (int j = 0; j < TL::NI; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
    }
  }
  mm::cp_async_wait<0>();
  __syncthreads();  // the result tile reuses the operand buffers
  float* out = reinterpret_cast<float*>(smem);
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mi = 0; mi < TL::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < TL::NI; ++ni) {
      const int r = wm * TL::TM + mi * 16 + g;
      const int c = wn * TL::TN + ni * 8 + 2 * t4;
      *reinterpret_cast<float2*>(out + r * TL::OLD + c) =
          make_float2(acc[mi][ni][0], acc[mi][ni][1]);
      *reinterpret_cast<float2*>(out + (r + 8) * TL::OLD + c) =
          make_float2(acc[mi][ni][2], acc[mi][ni][3]);
    }
  __syncthreads();
  return out;
}

// What one product launch computes (see the file comment).
struct Args {
  Opnd A[2], B[2];
  int M, N[2], K;
  int Ks;       // k a split
  int nprob;    // 1 or 2
  int splits;   // splits a batch
  int band;     // > 0: B block-diagonal in bands of this width
  int diag;     // only the diagonal output tiles
};

// The epilogue is called as epi(out, ld, bm, bn, m0, n0, prob, split,
// batch) by every thread of the block, with the result tile in shared
// memory (row r at out[r * ld]).
template <class TL, class Epi>
__global__ void __launch_bounds__(kThreads)
    gemm_kernel(Args a, Epi epi) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int prob = blockIdx.z % a.nprob;
  const int split = (blockIdx.z / a.nprob) % a.splits;
  const int batch = blockIdx.z / (a.nprob * a.splits);
  const int N = a.N[prob];
  const int m0 = blockIdx.x * TL::BM;
  const int n0 = a.diag ? m0 : blockIdx.y * TL::BN;
  if (n0 >= N) return;  // the whole block: a narrower problem's tile
  int kbeg = split * a.Ks, kend = min(a.K, kbeg + a.Ks);
  if (a.band > 0) {
    kbeg = max(kbeg, n0 / a.band * a.band);
    kend = min(kend, (n0 + TL::BN + a.band - 1) / a.band * a.band);
  }
  Opnd A = a.A[prob], B = a.B[prob];
#pragma unroll
  for (int pl = 0; pl < 3; ++pl) {
    A.pl[pl] += batch * A.zs;
    B.pl[pl] += batch * B.zs;
  }
  const float* out = tile_product<TL>(smem, A, B, a.M, N, kbeg, kend, m0, n0);
  epi(out, TL::OLD, TL::BM, TL::BN, m0, n0, prob, split, batch);
}

template <class K>
cudaError_t set_smem(K kern, size_t smem) {
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Launches the product over `batches` batches: grid (m tiles, n tiles of
// the widest problem, batches * splits * nprob).
// the shared-memory attribute, set once a kernel (one card a process)
template <class TL, class Epi>
cudaError_t launch(const Args& a, int batches, const Epi& epi,
                   cudaStream_t stream) {
  auto kern = gemm_kernel<TL, Epi>;
  static const cudaError_t e = set_smem(kern, TL::SMEM);
  if (e != cudaSuccess) return e;
  const int n = a.nprob == 2 ? max(a.N[0], a.N[1]) : a.N[0];
  const dim3 grid((a.M + TL::BM - 1) / TL::BM,
                  a.diag ? 1 : (n + TL::BN - 1) / TL::BN,
                  batches * a.splits * a.nprob);
  kern<<<grid, kThreads, TL::SMEM, stream>>>(a, epi);
  return cudaGetLastError();
}

// A product of one problem, one split, one batch: C = A B, M x N over K.
inline Args simple(const Opnd& A, const Opnd& B, int M, int N, int K) {
  Args a{};
  a.A[0] = a.A[1] = A;
  a.B[0] = a.B[1] = B;
  a.M = M;
  a.N[0] = a.N[1] = N;
  a.K = a.Ks = K;
  a.nprob = a.splits = 1;
  return a;
}

// ---- epilogue helpers

// Calls f(m, n, v0, v1) for the result pairs (n, n + 1) of a tile inside
// (M, N), consecutive threads on consecutive pairs of a row.
template <class F>
__device__ __forceinline__ void for_pairs(const float* o, int ld, int bm,
                                          int bn, int m0, int n0, int M,
                                          int N, F f) {
  const int hp = bn / 2;
  for (int i = threadIdx.x; i < bm * hp; i += blockDim.x) {
    const int r = i / hp, c = 2 * (i % hp);
    const int m = m0 + r, n = n0 + c;
    if (m >= M || n >= N) continue;
    const float2 v = *reinterpret_cast<const float2*>(o + r * ld + c);
    f(m, n, v.x, v.y);
  }
}

// Two consecutive values (i even) in one load or store, as f32.
__device__ __forceinline__ float2 load2(const float* p, size_t i) {
  return *reinterpret_cast<const float2*>(p + i);
}
__device__ __forceinline__ float2 load2(const bf16* p, size_t i) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + i));
}
__device__ __forceinline__ void store2(float* p, size_t i, float a, float b) {
  *reinterpret_cast<float2*>(p + i) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, size_t i, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p + i) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ---- the ordered row sum

// out[off + e] (+)= sum over the rows of part[row][e] for each segment,
// in a fixed order: a thread an output summing the rows in order, or, for
// a segment of TALL rows or more, a warp an output whose lane l sums rows
// l, l + 32, ... in order before a fixed shuffle tree.  Segments start on
// warp boundaries (vbase, in threads); unused ones have no rows.
// accumulate adds to the previous slices' sums.
constexpr int TALL = 64;
struct Seg {
  const float* part;
  int rows, width, off, lanes, vbase;
};
template <int NS>
struct Segs {
  Seg s[NS];
  int total;  // threads
};

template <int NS>
Segs<NS> make_segs(const Seg (&in)[NS]) {
  Segs<NS> out{};
  int v = 0;
  for (int i = 0; i < NS; ++i) {
    out.s[i] = in[i];
    out.s[i].lanes = in[i].rows >= TALL ? 32 : 1;
    out.s[i].vbase = v;
    v += (in[i].width * out.s[i].lanes + 31) / 32 * 32;
  }
  out.total = v;
  return out;
}

template <int NS>
__global__ void reduce_rows_kernel(Segs<NS> segs, float* __restrict__ out,
                                   int accumulate) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= segs.total) return;  // a multiple of 32: whole warps leave
  int i = 0;
  while (i + 1 < NS && v >= segs.s[i + 1].vbase) ++i;
  const Seg sg = segs.s[i];
  const int rel = v - sg.vbase, e = rel / sg.lanes, lane = rel % sg.lanes;
  float a = 0.f;
  if (e < sg.width)
    for (int g = lane; g < sg.rows; g += sg.lanes)
      a += sg.part[(size_t)g * sg.width + e];
  if (sg.lanes == 32) a = warp_sum(a);  // the warp lies in one segment
  if (e < sg.width && lane == 0) {
    float* o = out + sg.off + e;
    *o = accumulate ? *o + a : a;
  }
}

template <int NS>
cudaError_t reduce_rows(const Seg (&in)[NS], float* out, int accumulate,
                        cudaStream_t stream) {
  const Segs<NS> segs = make_segs(in);
  reduce_rows_kernel<NS><<<(segs.total + 255) / 256, 256, 0, stream>>>(
      segs, out, accumulate);
  return cudaGetLastError();
}

}  // namespace gemm
}  // namespace uir

#define UIR_TRY(call)                       \
  do {                                      \
    const cudaError_t e_ = (call);          \
    if (e_ != cudaSuccess) return (int)e_;  \
  } while (0)
