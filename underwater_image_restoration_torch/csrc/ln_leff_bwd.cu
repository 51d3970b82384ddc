// LN + LeFF backward: the vector-Jacobian product of
//   y = x + s_b * fc2(gelu(dw3x3(gelu(fc1(LayerNorm_C(x))))))
// on channels-last tokens x (B, H, W, C) (residual = 0 drops the "x +"):
// dx, dscale, dbias, dW1 (C, hid), db1, dtaps (hid, 9), db_dw, dW2 (hid, C)
// and db2.  The per-image scale s_b (DropPath's 0 or 1/keep) gets none, as
// in the TPU kernel's VJP.
//
// Replaces the TPU kernel of the JAX package ops/fused_leff.py:337 _bwd_call
// (_bwd_kernel:152), which streamed row bands through VMEM and finalized
// each band's LayerNorm backward one band late.
//
// What bounds it on an H100.  Per pixel the required work is the forward's
// fc1 and taps and the backward's dg2, dW2, dW1 and dLN products and three
// tap sums: 10 C hid + 54 hid flops against 3 C itemsize bytes of x, dy and
// dx, far above the bf16 ridge: at peak rates it is bound by the tensor
// cores' operations.  A tile-local design (each block recomputing fc1 on a
// 2-pixel halo, as this kernel once did) cannot feed them: its LN patch and
// f32 dLN accumulators in shared memory shrink the tile to 4 x 4 pixels at
// C = 512, too small an M for tensor-core tiles, with fc1 recomputed 4x.
//
// Design.  The backward runs as a short sequence of launches over the
// batch in image slices, each 1x1 product a tensor-core product (mma.cuh:
// mma.sync m16n8k16, bf16 in, f32 accumulate, operand tiles staged by
// cp.async in two stages) over pixels x channels, its elementwise work in
// the epilogue:
//   1. prep: LN statistics (mean, rstd in f32) a pixel, LN = round(LN x)
//      and dyk = round(s_b dy), a warp a pixel;
//   2. fc1 (M = pixels, N = hid, K = C): t1 = round(round(LN W1) + b1) and
//      g1 = round(gelu(t1)), both in T;
//   3. dg2 = dyk W2^T (M = pixels, N = hid, K = C); the epilogue walks
//      consecutive pixels with a sliding 3x3 window of g1 (zero outside the
//      image), t2 = round(round(taps * g1) + b_dw), and stores dt2 = dg2
//      gelu'(t2) in f32 and g2 = round(gelu(t2));
//   4. the depthwise pass on the FMA pipe (9-tap work), a thread a hidden
//      channel walking DW_R image rows by DW_W columns with a sliding 3x3
//      window: round(dt1) = round((transposed taps of round(dt2))
//      gelu'(t1)); the patch's shares of db1 (f32 dt1), db_dw (f32 dt2),
//      dtaps (dt2 x shifted g1) and db2;
//   5. dW1^T = round(dt1)^T LN and dW2 = g2^T dyk (M = hid, N = C, K =
//      pixels), one launch, split over pixel ranges, each split writing its
//      own row;
//   6. dLN = round(dt1) W1^T (M = pixels, N = C, K = hid): a block owns 32
//      whole pixel rows (C <= 512), and its epilogue runs the LayerNorm
//      backward (dx = dy + round(dx_ln), or round(dx_ln) without the
//      residual) and the block's shares of dscale and dbias;
//   7. the sum of every launch's rows into the gradients in a fixed order,
//      added to the previous slices' sums in slice order.
// No float atomics: every share is written to its own row and the rows are
// summed in a fixed order, so two runs give the same bits.  The hidden-wide
// intermediates (t1, g1, g2, round(dt1) in T, dt2 in f32) and the rows live
// in one workspace the wrapper allocates and sizes by its slices
// (ops/fused_leff.py bwd_plan, WORKSPACE_BYTES).
//
// Rounding points (the TPU kernel's, _bwd_kernel:224-249): dyk =
// round(s_b dy); dg2 and dt2 stay f32 (dtaps and db_dw from the f32 dt2);
// dt2 rounds before the transposed taps; dt1 stays f32 for db1 and rounds
// before dW1 and dLN; dLN stays f32; dx = dy + round(dx_ln) in T
// (round(dx_ln) without the residual).  The recomputed forward rounds where
// csrc/ln_leff.cu does.  In bf16 every product operand (LN, W1, W2, dyk, g2,
// round(dt1)) is exactly bf16, one pass each; in f32 each is carried as a
// bf16 hi/lo pair (mma.cuh), three passes.  Autograd through the plain
// version rounds some cotangents elsewhere (dg2, dt2, dLN and the weight
// gradients in bf16), so the two agree to the split's roundoff (about
// 2^-17 of an operand) in f32 and within bf16 roundoff in bf16.
#include <cstdint>
#include <type_traits>

#include "grad.cuh"
#include "mma.cuh"

namespace {

namespace mm = uir::mma;
using bf16 = __nv_bfloat16;
using uir::from_f;
using uir::round_to;
using uir::to_f;
using uir::warp_sum;

constexpr int kThreads = 256;
constexpr int BK = 32;       // k depth of a staged operand tile
constexpr int FM = 32;       // pixels a block of the dLN launch
constexpr int DW_T = 128;    // threads a block of the depthwise pass
constexpr int DW_R = 2;      // image rows a thread of the depthwise pass
constexpr int DW_W = 64;     // columns a thread of the depthwise pass
constexpr int MAX_C = 512;   // widest C the dLN launch holds in one block

__device__ __forceinline__ float gelu_f(float t) {
  return 0.5f * t * (1.f + erff(t * 0.70710678118654752f));
}

// d gelu / dt, exact (erf) form: Phi(t) + t * phi(t)
__device__ __forceinline__ float gelu_grad(float t) {
  return 0.5f * (1.f + erff(t * 0.70710678118654752f)) +
         t * 0.39894228040143268f * expf(-0.5f * t * t);
}

// gelu(t) and gelu'(t) from one erf, bit-equal to gelu_f and gelu_grad
__device__ __forceinline__ void gelu_both(float t, float& g, float& gp) {
  const float e = erff(t * 0.70710678118654752f);
  g = 0.5f * t * (1.f + e);
  gp = 0.5f * (1.f + e) + t * 0.39894228040143268f * expf(-0.5f * t * t);
}

// Two consecutive T values (i even) as f32, in one load.
__device__ __forceinline__ float2 load2(const float* p, size_t i) {
  return *reinterpret_cast<const float2*>(p + i);
}
__device__ __forceinline__ float2 load2(const bf16* p, size_t i) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + i));
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

// A product operand in device memory: bf16 planes hi and (when split) lo,
// rows ld elements apart.
struct Opnd {
  const bf16* hi;
  const bf16* lo;
  int ld;
};

// One block tile of a product: BM x BN outputs, WM x WN warps, A stored
// [k][m] (AKM) or [m][k], B stored [k][n] (BKN) or [n][k], NP planes an
// operand (2: hi/lo split).  Shared memory holds two stages of operand tiles
// and, after the k loop, the f32 result tile (OLD floats a row).
template <int BM_, int BN_, int WM_, int WN_, bool AKM_, bool BKN_, int NP_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_, NP = NP_;
  static constexpr bool AKM = AKM_, BKN = BKN_;
  static_assert(WM * WN * 32 == kThreads, "one warp a warp tile");
  static constexpr int TM = BM / WM, TN = BN / WN;
  static constexpr int MI = TM / 16, NI = TN / 8;
  static_assert(MI >= 1 && NI >= 2 && NI % 2 == 0, "warp tile shape");
  static constexpr int ALD = mm::pad_ld(AKM ? BM : BK);
  static constexpr int BLD = mm::pad_ld(BKN ? BN : BK);
  static constexpr int AT = (AKM ? BK : BM) * ALD;  // elements a plane
  static constexpr int BT = (BKN ? BK : BN) * BLD;
  static constexpr int STAGE = NP * (AT + BT);
  static constexpr int OLD = BN + 8;
  static constexpr size_t OPER_BYTES = 2 * STAGE * sizeof(bf16);
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
  bf16* sb = s + TL::NP * TL::AT;
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
    mm::cp_async16(d, ok ? A.hi + src : A.hi, ok);
    if constexpr (TL::NP == 2)
      mm::cp_async16(d + TL::AT, ok ? A.lo + src : A.lo, ok);
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
    mm::cp_async16(d, ok ? B.hi + src : B.hi, ok);
    if constexpr (TL::NP == 2)
      mm::cp_async16(d + TL::BT, ok ? B.lo + src : B.lo, ok);
  }
}

// The block's BM x BN tile of A B over k in [kbeg, kend), left in shared
// memory as f32 (row r at out[r * TL::OLD]); the block is synchronized.
// k slices add into the accumulators in order, each k16 step's split passes
// in mma_split's order.
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
  if (nk > 0) load_stage<TL>(smem, A, B, M, N, kend, m0, n0, kbeg);
  mm::cp_async_commit();
  for (int t = 0; t < nk; ++t) {
    if (t + 1 < nk)
      load_stage<TL>(smem + ((t + 1) & 1) * TL::STAGE, A, B, M, N, kend, m0,
                     n0, kbeg + (t + 1) * BK);
    mm::cp_async_commit();
    mm::cp_async_wait<1>();
    __syncthreads();
    const bf16* sa = smem + (t & 1) * TL::STAGE;
    const bf16* sb = sa + TL::NP * TL::AT;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[TL::MI][TL::NP][4];
      uint32_t bfr[TL::NI][TL::NP][2];
#pragma unroll
      for (int mi = 0; mi < TL::MI; ++mi) {
        const int m = wm * TL::TM + mi * 16;
#pragma unroll
        for (int pl = 0; pl < TL::NP; ++pl)
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
        for (int pl = 0; pl < TL::NP; ++pl) {
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
        for (int ni = 0; ni < TL::NI; ++ni)
          mm::mma_split<TL::NP, TL::NP>(acc[mi][ni], af[mi], bfr[ni]);
    }
    __syncthreads();  // the next stage's load overwrites this one
  }
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

// A product launch: blockIdx.x the m tile, blockIdx.y the n tile, blockIdx.z
// = nprob * split + problem (problem 1 takes A1, B1).  Split s covers
// k in [s Ks, min(K, (s + 1) Ks)).  The epilogue gets the result tile.
template <class TL, class Epi>
__global__ void __launch_bounds__(kThreads)
    ln_leff_bwd_gemm_kernel(Opnd A0, Opnd B0, Opnd A1, Opnd B1, int M,
                            int N, int K, int Ks, int nprob, Epi epi) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int prob = blockIdx.z % nprob, split = blockIdx.z / nprob;
  const int kbeg = split * Ks, kend = min(K, kbeg + Ks);
  const int m0 = blockIdx.x * TL::BM, n0 = blockIdx.y * TL::BN;
  const float* out = tile_product<TL>(smem, prob ? A1 : A0, prob ? B1 : B0,
                                      M, N, kbeg, kend, m0, n0);
  epi(out, TL::OLD, TL::BM, TL::BN, m0, n0, prob, split);
}

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

// Two consecutive values (i even), rounded to T, in one store.
__device__ __forceinline__ void store2(float* p, size_t i, float a, float b) {
  *reinterpret_cast<float2*>(p + i) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, size_t i, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p + i) = __floats2bfloat162_rn(a, b);
}

// 2. fc1's epilogue: t1 and g1 [pixel][hid] in T
template <typename T>
struct Fc1Epi {
  T* t1;
  T* g1;
  const float* b1;
  int M, N;
  __device__ void operator()(const float* o, int ld, int bm, int bn, int m0,
                             int n0, int, int) const {
    for_pairs(o, ld, bm, bn, m0, n0, M, N,
              [&](int m, int n, float v0, float v1) {
                const float a =
                    round_to<T>(round_to<T>(v0) + __ldg(b1 + n));
                const float b =
                    round_to<T>(round_to<T>(v1) + __ldg(b1 + n + 1));
                const size_t i = (size_t)m * N + n;
                store2(t1, i, a, b);
                store2(g1, i, gelu_f(a), gelu_f(b));
              });
  }
};

// 3. dg2's epilogue: t2 from g1's 3x3 neighbourhood, dt2 (f32) and g2
// (planes) [pixel][hid]
template <typename T, int NP>
struct Dg2Epi {
  const T* g1;
  const float* taps;  // [9][hid]
  const float* bdw;
  float* dt2;
  bf16* g2;
  size_t g2_lo;
  int M, N, H, W;
  // dt2 and g2 of a channel from t2's tap sum s and its bias bd
  __device__ float one(float s, float bd, float dg, float& gv) const {
    const float t2 = round_to<T>(round_to<T>(s) + bd);
    float g, gp;
    gelu_both(t2, g, gp);
    gv = round_to<T>(g);
    return dg * gp;
  }
  // g1 pair (n, n + 1) at row hh, column wc of the image whose pixel
  // (0, 0) is base; zero outside the image
  __device__ float2 g1_at(size_t base, int hh, int wc, int n) const {
    return hh >= 0 && hh < H && wc >= 0 && wc < W
               ? load2(g1, (base + (size_t)hh * W + wc) * N + n)
               : make_float2(0.f, 0.f);
  }
  // A thread keeps one pair of columns (its taps and biases in registers)
  // and walks bm / (kThreads / (bn / 2)) consecutive pixels of the tile
  // with a sliding 3x3 window of g1 (three new loads a pixel).
  __device__ void operator()(const float* o, int ld, int bm, int bn, int m0,
                             int n0, int, int) const {
    const int hp = bn / 2, per = bm / (kThreads / hp);
    const int c = 2 * (threadIdx.x % hp), n = n0 + c;
    const int rbeg = (threadIdx.x / hp) * per;
    const int rend = min(rbeg + per, M - m0);
    if (n >= N || rbeg >= rend) return;
    float2 tk[9];
#pragma unroll
    for (int k = 0; k < 9; ++k)
      tk[k] = __ldg(reinterpret_cast<const float2*>(taps + k * N + n));
    const float ba = __ldg(bdw + n), bb = __ldg(bdw + n + 1);
    const int hw = (m0 + rbeg) % (H * W);
    int h = hw / W, w = hw % W;
    size_t base = (size_t)(m0 + rbeg) - hw;
    float2 win[3][3];  // rows h - 1 + i, columns w - 1 + j
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        win[i][j] = g1_at(base, h - 1 + i, w - 1 + j, n);
    for (int r = rbeg; r < rend; ++r) {
      float sa = 0.f, sb = 0.f;  // zeros outside the image add nothing
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        sa = fmaf(tk[k].x, win[k / 3][k % 3].x, sa);
        sb = fmaf(tk[k].y, win[k / 3][k % 3].y, sb);
      }
      const float2 v = *reinterpret_cast<const float2*>(o + r * ld + c);
      float ga, gb;
      const float da = one(sa, ba, v.x, ga);
      const float db = one(sb, bb, v.y, gb);
      const size_t q = (size_t)(m0 + r) * N + n;
      *reinterpret_cast<float2*>(dt2 + q) = make_float2(da, db);
      mm::put2<NP>(g2, g2_lo, q, ga, gb);
      if (++w < W) {
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          win[i][0] = win[i][1];
          win[i][1] = win[i][2];
          win[i][2] = g1_at(base, h - 1 + i, w + 1, n);
        }
      } else if (r + 1 < rend) {
        w = 0;
        if (++h == H) h = 0, base += (size_t)H * W;
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
          for (int j = 0; j < 3; ++j)
            win[i][j] = g1_at(base, h - 1 + i, j - 1, n);
      }
    }
  }
};

// 5. the weight gradients' epilogue: problem 0 is dW1^T (stored as dW1
// [C][hid]), problem 1 dW2 [hid][C]; split s writes its own rows.
struct WgradEpi {
  float* part;  // [2][splits][hid * C]
  int M, N, splits;
  __device__ void operator()(const float* o, int ld, int bm, int bn, int m0,
                             int n0, int prob, int split) const {
    float* row = part + ((size_t)prob * splits + split) * M * N;
    for_pairs(o, ld, bm, bn, m0, n0, M, N,
              [&](int m, int n, float v0, float v1) {
                if (prob == 0) {
                  row[(size_t)n * M + m] = v0;
                  row[(size_t)(n + 1) * M + m] = v1;
                } else {
                  *reinterpret_cast<float2*>(row + (size_t)m * N + n) =
                      make_float2(v0, v1);
                }
              });
  }
};

// 6. dLN's epilogue: the LayerNorm backward of the block's pixels (a warp a
// pixel) and its shares of dscale and dbias (a thread a channel, pixels in
// order) into its row of part [blocks][2C].
template <typename T>
struct DlnEpi {
  const T* x;
  const T* dy;
  T* dx;
  const float2* stats;
  const float* scale;
  float* part;
  int M, C, residual;
  __device__ void operator()(const float* o, int ld, int bm, int, int m0,
                             int, int, int) const {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int r = warp; r < bm; r += kThreads / 32) {
      const int m = m0 + r;
      if (m >= M) break;
      const float2 st = stats[m];
      const size_t base = (size_t)m * C;
      float s1 = 0.f, s2 = 0.f;
      for (int ch = lane; ch < C; ch += 32) {
        const float xh = (to_f(x[base + ch]) - st.x) * st.y;
        const float g = o[r * ld + ch] * __ldg(scale + ch);
        s1 += g;
        s2 = fmaf(g, xh, s2);
      }
      s1 = warp_sum(s1) / C;
      s2 = warp_sum(s2) / C;
      for (int ch = lane; ch < C; ch += 32) {
        const float xh = (to_f(x[base + ch]) - st.x) * st.y;
        const float g = o[r * ld + ch] * __ldg(scale + ch);
        const float dxl = round_to<T>(st.y * (g - s1 - xh * s2));
        dx[base + ch] =
            from_f<T>(residual ? to_f(dy[base + ch]) + dxl : dxl);
      }
    }
    float* row = part + (size_t)blockIdx.x * 2 * C;
    for (int ch = threadIdx.x; ch < C; ch += kThreads) {
      float a = 0.f, b = 0.f;
      for (int r = 0; r < bm && m0 + r < M; ++r) {
        const float2 st = stats[m0 + r];
        const float dl = o[r * ld + ch];
        const float xh =
            (to_f(x[(size_t)(m0 + r) * C + ch]) - st.x) * st.y;
        a = fmaf(dl, xh, a);
        b += dl;
      }
      row[ch] = a;
      row[C + ch] = b;
    }
  }
};

// 1. prep: a warp a pixel of the slice (M pixels, HW a image).
template <typename T, int NP>
__global__ void __launch_bounds__(kThreads)
    ln_leff_bwd_prep_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                const float* __restrict__ scale,
                const float* __restrict__ bias, const float* __restrict__ s,
                float2* __restrict__ stats, bf16* __restrict__ ln,
                bf16* __restrict__ dyk, int M, int HW, int C, float eps) {
  const int lane = threadIdx.x & 31;
  const size_t lo = (size_t)M * C;
  for (int m = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5); m < M;
       m += gridDim.x * (kThreads / 32)) {
    const size_t base = (size_t)m * C;
    float mean, rstd;
    ln_stats(x + base, C, lane, eps, mean, rstd);
    if (lane == 0) stats[m] = make_float2(mean, rstd);
    const float sb = __ldg(s + m / HW);
    for (int ch = lane; ch < C; ch += 32) {
      mm::put<NP>(ln, lo, base + ch,
                  round_to<T>((to_f(x[base + ch]) - mean) * rstd *
                                  __ldg(scale + ch) +
                              __ldg(bias + ch)));
      mm::put<NP>(dyk, lo, base + ch, round_to<T>(to_f(dy[base + ch]) * sb));
    }
  }
}

// 4. the depthwise pass.  blockIdx.y is a group of DW_R image rows and a
// segment of DW_W columns of the slice (segment-fastest).  Blocks x < hch: a
// thread a hidden channel j walks the segment's columns with a sliding
// window (the next column loaded a step ahead); blocks beyond: a thread a
// channel c of dyk, for db2.  Row y of part1 [groups][11 hid] holds the
// group and segment's db1 [hid], dtaps [hid][9], db_dw [hid]; of part2
// [groups][C], db2.
template <typename T, int NP>
__global__ void __launch_bounds__(DW_T)
    ln_leff_bwd_dw_kernel(const T* __restrict__ t1, const T* __restrict__ g1,
                          const float* __restrict__ dt2,
                          const float* __restrict__ taps,
                          const T* __restrict__ dy,
                          const float* __restrict__ s, bf16* __restrict__ d1,
                          size_t d1_lo, float* __restrict__ part1,
                          float* __restrict__ part2, int H, int W, int C,
                          int hid, int hch) {
  const int hg = (H + DW_R - 1) / DW_R, ns = (W + DW_W - 1) / DW_W;
  const int grp = blockIdx.y / ns, seg = blockIdx.y % ns;
  const int b = grp / hg, h0 = (grp % hg) * DW_R;
  const int nr = min(DW_R, H - h0);
  const int w0 = seg * DW_W, w1 = min(W, w0 + DW_W);
  const size_t img0 = (size_t)b * H * W;  // pixel (b, 0, 0) of the slice
  if ((int)blockIdx.x >= hch) {
    const int c = (blockIdx.x - hch) * DW_T + threadIdx.x;
    if (c >= C) return;
    const float sb = __ldg(s + b);
    float a = 0.f;
    for (int r = 0; r < nr; ++r)
      for (int w = w0; w < w1; ++w)
        a += round_to<T>(to_f(dy[(img0 + (size_t)(h0 + r) * W + w) * C + c]) *
                         sb);
    part2[(size_t)blockIdx.y * C + c] = a;
    return;
  }
  const int j = blockIdx.x * DW_T + threadIdx.x;
  if (j >= hid) return;
  float tp[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) tp[k] = __ldg(taps + k * hid + j);
  // window[i][dc]: rows h0 - 1 + i, columns w - 1 + dc (zero outside); nD,
  // nG: column w + 1's and nT: t1 at (h0 + r, w), loaded one step ahead
  float D[DW_R + 2][3], G[DW_R + 2][3], nD[DW_R + 2], nG[DW_R + 2];
  float nT[DW_R];
#pragma unroll
  for (int i = 0; i < DW_R + 2; ++i) {
    const int hh = h0 - 1 + i;
    const bool in = hh >= 0 && hh < H;
    const size_t q = (img0 + (size_t)hh * W + w0) * hid + j;
    D[i][0] = in && w0 > 0 ? dt2[q - hid] : 0.f;
    G[i][0] = in && w0 > 0 ? to_f(g1[q - hid]) : 0.f;
    D[i][1] = in ? dt2[q] : 0.f;
    G[i][1] = in ? to_f(g1[q]) : 0.f;
    nD[i] = in && w0 + 1 < W ? dt2[q + hid] : 0.f;
    nG[i] = in && w0 + 1 < W ? to_f(g1[q + hid]) : 0.f;
  }
#pragma unroll
  for (int r = 0; r < DW_R; ++r)
    nT[r] = r < nr
                ? to_f(t1[(img0 + (size_t)(h0 + r) * W + w0) * hid + j])
                : 0.f;
  float sb1 = 0.f, sbdw = 0.f, st[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) st[k] = 0.f;
  for (int w = w0; w < w1; ++w) {
    float tv[DW_R];
#pragma unroll
    for (int r = 0; r < DW_R; ++r) {
      tv[r] = nT[r];
      const bool ok = r < nr && w + 1 < w1;
      nT[r] = ok ? to_f(t1[(img0 + (size_t)(h0 + r) * W + w + 1) * hid + j])
                 : 0.f;
    }
#pragma unroll
    for (int i = 0; i < DW_R + 2; ++i) {
      D[i][2] = nD[i];
      G[i][2] = nG[i];
      const int hh = h0 - 1 + i;
      const bool ok = hh >= 0 && hh < H && w + 2 < W;
      const size_t q = (img0 + (size_t)hh * W + w + 2) * hid + j;
      nD[i] = ok ? dt2[q] : 0.f;
      nG[i] = ok ? to_f(g1[q]) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < DW_R; ++r) {
      if (r >= nr) break;
      // dt1 = sum_k tap_k round(dt2)(p - d_k), d_k = (k / 3 - 1, k % 3 - 1)
      float u = 0.f;
#pragma unroll
      for (int k = 0; k < 9; ++k)
        u = fmaf(tp[k], round_to<T>(D[r + 2 - k / 3][2 - k % 3]), u);
      const float d = u * gelu_grad(tv[r]);
      mm::put<NP>(d1, d1_lo, (img0 + (size_t)(h0 + r) * W + w) * hid + j,
                  round_to<T>(d));
      sb1 += d;
      const float dv = D[r + 1][1];
      sbdw += dv;
      // dtaps_k += dt2(p) g1(p + d_k)
#pragma unroll
      for (int k = 0; k < 9; ++k)
        st[k] = fmaf(dv, G[r + k / 3][k % 3], st[k]);
    }
#pragma unroll
    for (int i = 0; i < DW_R + 2; ++i) {
      D[i][0] = D[i][1];
      D[i][1] = D[i][2];
      G[i][0] = G[i][1];
      G[i][1] = G[i][2];
    }
  }
  float* r = part1 + (size_t)blockIdx.y * 11 * hid;
  r[j] = sb1;
#pragma unroll
  for (int k = 0; k < 9; ++k) r[hid + j * 9 + k] = st[k];
  r[10 * hid + j] = sbdw;
}

// 7. out[off + e] (+)= sum over the rows of part[row][e] for each segment,
// in a fixed order: a thread an output summing the rows in order, or, for
// a segment of TALL rows or more, a warp an output whose lane l sums rows
// l, l + 32, ... in order before a fixed shuffle tree.  Segments start on
// warp boundaries (vbase, in threads).  accumulate adds to the previous
// slices' sums.
constexpr int TALL = 64;
struct Seg {
  const float* part;
  int rows, width, off, lanes, vbase;
};
constexpr int NSEG = 5;
struct Segs {
  Seg s[NSEG];
  int total;  // threads
};

Segs make_segs(const Seg (&in)[NSEG]) {
  Segs out{};
  int v = 0;
  for (int i = 0; i < NSEG; ++i) {
    out.s[i] = in[i];
    out.s[i].lanes = in[i].rows >= TALL ? 32 : 1;
    out.s[i].vbase = v;
    v += (in[i].width * out.s[i].lanes + 31) / 32 * 32;
  }
  out.total = v;
  return out;
}

__global__ void ln_leff_bwd_reduce_kernel(Segs segs, float* __restrict__ out,
                              int accumulate) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= segs.total) return;  // a multiple of 32: whole warps leave
  int i = 0;
  while (i + 1 < NSEG && v >= segs.s[i + 1].vbase) ++i;
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

// The workspace of one slice of P pixels (rows image rows), in order, each
// piece 256-byte aligned (ops/fused_leff.py bwd_workspace_bytes mirrors it).
struct Layout {
  size_t off[13];
  Layout(int P, int rows, int C, int hid, int NP, int item, int Ks) {
    const size_t p = P;
    const size_t splits = (P + Ks - 1) / Ks, fb = (P + FM - 1) / FM;
    const size_t sz[12] = {8 * p,
                           (size_t)NP * 2 * p * C,     // ln planes
                           (size_t)NP * 2 * p * C,     // dyk planes
                           p * hid * item,             // t1
                           p * hid * item,             // g1
                           4 * p * hid,                // dt2
                           (size_t)NP * 2 * p * hid,   // g2 planes
                           (size_t)NP * 2 * p * hid,   // round(dt1) planes
                           4 * 2 * splits * hid * C,   // dW1^T, dW2 rows
                           4 * (size_t)rows * 11 * hid,  // depthwise rows
                           4 * (size_t)rows * C,         // db2 rows
                           4 * fb * 2 * C};              // dscale/dbias rows
    off[0] = 0;
    for (int i = 0; i < 12; ++i)
      off[i + 1] = off[i] + (sz[i] + 255) / 256 * 256;
  }
};

template <class TL, class Epi>
cudaError_t gemm(dim3 grid, const Opnd& A0, const Opnd& B0, const Opnd& A1,
                 const Opnd& B1, int M, int N, int K, int Ks, int nprob,
                 const Epi& epi, cudaStream_t stream) {
  auto kern = ln_leff_bwd_gemm_kernel<TL, Epi>;
  cudaError_t e = uir::set_smem(kern, TL::SMEM);
  if (e != cudaSuccess) return e;
  kern<<<grid, kThreads, TL::SMEM, stream>>>(A0, B0, A1, B1, M, N, K, Ks,
                                              nprob, epi);
  return cudaGetLastError();
}

template <typename T, int BNF>
cudaError_t dln(int P, const Opnd& A, const Opnd& B, int C, int hid,
                const DlnEpi<T>& epi, cudaStream_t stream) {
  constexpr int NP = std::is_same<T, float>::value ? 2 : 1;
  using TL = Tile<FM, BNF, 1, 8, false, false, NP>;
  return gemm<TL>(dim3((P + FM - 1) / FM, 1, 1), A, B, A, B, P, C, hid, hid,
                  1, epi, stream);
}

#define UIR_TRY(call)                       \
  do {                                      \
    const cudaError_t e_ = (call);          \
    if (e_ != cudaSuccess) return (int)e_;  \
  } while (0)

template <typename T>
int launch(const T* x, const T* dy, T* dx, const float* scale,
           const float* bias, const bf16* w1h, const bf16* w1l,
           const float* b1, const float* taps, const float* bdw,
           const bf16* w2h, const bf16* w2l, const float* s,
           unsigned char* work, float* grads, int B, int H, int W, int C,
           int hid, int imgs, int Ks, int residual, float eps,
           cudaStream_t st) {
  constexpr int NP = std::is_same<T, float>::value ? 2 : 1;
  const int HW = H * W;
  // the depthwise pass's row groups and column segments an image
  const int hg = (H + DW_R - 1) / DW_R * ((W + DW_W - 1) / DW_W);
  const Layout L(imgs * HW, imgs * hg, C, hid, NP, sizeof(T), Ks);
  auto* stats = reinterpret_cast<float2*>(work + L.off[0]);
  auto* ln = reinterpret_cast<bf16*>(work + L.off[1]);
  auto* dyk = reinterpret_cast<bf16*>(work + L.off[2]);
  auto* t1 = reinterpret_cast<T*>(work + L.off[3]);
  auto* g1 = reinterpret_cast<T*>(work + L.off[4]);
  auto* dt2 = reinterpret_cast<float*>(work + L.off[5]);
  auto* g2 = reinterpret_cast<bf16*>(work + L.off[6]);
  auto* d1 = reinterpret_cast<bf16*>(work + L.off[7]);
  auto* partW = reinterpret_cast<float*>(work + L.off[8]);
  auto* partD1 = reinterpret_cast<float*>(work + L.off[9]);
  auto* partD2 = reinterpret_cast<float*>(work + L.off[10]);
  auto* partF = reinterpret_cast<float*>(work + L.off[11]);
  const Opnd W1{w1h, w1l, hid}, W2{w2h, w2l, C};
  using TA = Tile<128, 128, 2, 4, false, true, NP>;   // fc1: B = W1 [C][hid]
  using TB = Tile<128, 128, 2, 4, false, false, NP>;  // dg2: B = W2 [hid][C]
  using TW = Tile<128, 64, 4, 2, true, true, NP>;     // dW1^T, dW2
  for (int b0 = 0; b0 < B; b0 += imgs) {
    const int nb = min(imgs, B - b0), P = nb * HW, rows = nb * hg;
    const size_t px0 = (size_t)b0 * HW;
    const size_t pc = (size_t)P * C, ph = (size_t)P * hid;
    const Opnd LN{ln, ln + pc, C}, DYK{dyk, dyk + pc, C};
    const Opnd G2{g2, g2 + ph, hid}, D1{d1, d1 + ph, hid};
    const int splits = (P + Ks - 1) / Ks, fblocks = (P + FM - 1) / FM;

    ln_leff_bwd_prep_kernel<T, NP><<<(P + 7) / 8, kThreads, 0, st>>>(
        x + px0 * C, dy + px0 * C, scale, bias, s + b0, stats, ln, dyk, P, HW,
        C, eps);
    UIR_TRY(cudaGetLastError());
    const dim3 gmn((P + 127) / 128, (hid + 127) / 128, 1);
    UIR_TRY(gemm<TA>(gmn, LN, W1, LN, W1, P, hid, C, C, 1,
                     Fc1Epi<T>{t1, g1, b1, P, hid}, st));
    UIR_TRY(gemm<TB>(gmn, DYK, W2, DYK, W2, P, hid, C, C, 1,
                     Dg2Epi<T, NP>{g1, taps, bdw, dt2, g2, ph, P, hid, H, W},
                     st));
    const int hch = (hid + DW_T - 1) / DW_T, cch = (C + DW_T - 1) / DW_T;
    ln_leff_bwd_dw_kernel<T, NP><<<dim3(hch + cch, rows), DW_T, 0, st>>>(
        t1, g1, dt2, taps, dy + px0 * C, s + b0, d1, ph, partD1, partD2, H,
        W, C, hid, hch);
    UIR_TRY(cudaGetLastError());
    UIR_TRY(gemm<TW>(dim3((hid + 127) / 128, (C + 63) / 64, 2 * splits), D1,
                     LN, G2, DYK, hid, C, P, Ks, 2,
                     WgradEpi{partW, hid, C, splits}, st));
    const DlnEpi<T> de{x + px0 * C, dy + px0 * C, dx + px0 * C, stats,
                       scale, partF, P, C, residual};
    if (C <= 128)
      UIR_TRY((dln<T, 128>(P, D1, W1, C, hid, de, st)));
    else if (C <= 256)
      UIR_TRY((dln<T, 256>(P, D1, W1, C, hid, de, st)));
    else
      UIR_TRY((dln<T, 512>(P, D1, W1, C, hid, de, st)));
    const int ch = C * hid;
    const Segs segs = make_segs(
        {{partW, splits, ch, 0, 0, 0},
         {partD1, rows, 11 * hid, ch, 0, 0},
         {partW + (size_t)splits * ch, splits, ch, ch + 11 * hid, 0, 0},
         {partD2, rows, C, 2 * ch + 11 * hid, 0, 0},
         {partF, fblocks, 2 * C, 2 * ch + 11 * hid + C, 0, 0}});
    ln_leff_bwd_reduce_kernel<<<(segs.total + 255) / 256, 256, 0, st>>>(
        segs, grads, b0 > 0);
    UIR_TRY(cudaGetLastError());
  }
  return 0;
}

}  // namespace

// The backward over the batch in slices of `imgs` images, seven launches a
// slice (prep, fc1, dg2, depthwise, weight gradients, dLN, row sums); Ks:
// pixels a split of the weight-gradient products (a multiple of 32).  work:
// the workspace of one slice (Layout); grads [E] as ops/fused_leff.py
// bwd_row_size lays it out.  w1l and w2l (the lo planes) are read only in
// f32.
extern "C" int uir_ln_leff_bwd(const void* x, const void* dy, void* dx,
                               const void* scale, const void* bias,
                               const void* w1h, const void* w1l,
                               const void* b1, const void* taps,
                               const void* bdw, const void* w2h,
                               const void* w2l, const void* s, void* work,
                               void* grads, int B, int H, int W, int C,
                               int hid_pad, int residual, int bf16, int imgs,
                               int Ks, float eps, void* stream) {
  // C % 8 and hid_pad % 16: 16-byte operand rows and whole k16 steps
  if (hid_pad % 16 || C % 8 || C > MAX_C || B < 1 || H < 1 || W < 1 ||
      imgs < 1 || Ks < BK || Ks % BK)
    return (int)cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto h = [](const void* p) {
    return static_cast<const __nv_bfloat16*>(p);
  };
  auto* wk = static_cast<unsigned char*>(work);
  auto* gr = static_cast<float*>(grads);
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(
        h(x), h(dy), static_cast<__nv_bfloat16*>(dx), f(scale), f(bias),
        h(w1h), h(w1l), f(b1), f(taps), f(bdw), h(w2h), h(w2l), f(s), wk, gr,
        B, H, W, C, hid_pad, imgs, Ks, residual, eps, st);
  return launch<float>(f(x), f(dy), static_cast<float*>(dx), f(scale),
                       f(bias), h(w1h), h(w1l), f(b1), f(taps), f(bdw),
                       h(w2h), h(w2l), f(s), wk, gr, B, H, W, C, hid_pad,
                       imgs, Ks, residual, eps, st);
}
