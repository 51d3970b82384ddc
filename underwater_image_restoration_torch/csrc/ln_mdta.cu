// LN + MDTA forward: y = x + MDTA(LayerNorm_C(x)) on channels-first
// (B, C, H, W), the first half of a SpectralBlock, with the reference's
// dead-code quirks (attnf, kf and q1x1_1 are never computed; vf is the
// second half of kv / kv_conv); and each image's stats (the head-diagonal
// gram G = q k^T [C][CPH], Sq [C], Sk [C]) for the backward.
//
// Replaces the TPU kernels of the JAX package
// ops/fused_attn_composed.py:523 _fwd_call (_fwd_kernel:139),
// ops/fused_attn_banded.py:648 _fwd_call (_fwd_kernel:183) and
// ops/fused_attn.py:507 _fwd_call (_fwd_kernel:109), which compute one
// function and were split on the TPU only to fit its VMEM.
//
// What bounds it on an H100.  Per pixel about 2 (3C^2 + 27C + C CPH + 2C
// CPH + 3C^2 + 9C) flops against x and y (2 C itemsize bytes): at peak
// rates the 256x256 levels (C = 16, 32) are bound by bytes and the deep
// ones by the tensor cores' operations.  The attention couples every pixel
// of an image, so a tile-local kernel must finish the gram before it applies
// A: two passes, each recomputing LN and q, k or v on a halo, the second
// holding about seven channel-major planes of a tile on a 2-pixel halo
// (4 x 8 pixels at C = 128, v recomputed 3.4x), too small an M for the
// tensor cores, and the gram summed across blocks.
//
// Design.  The forward runs as a sequence of launches over the batch in
// image slices whose intermediates live pixel-major ([pixel][channel]) in
// one workspace (ops/fused_mdta.py fwd_plan keeps it within
// FWD_WORKSPACE_BYTES).  Every 1x1 and per-head product is a tensor-core
// product through gemm.cuh (mma.sync, M = pixels, or K = pixels for the
// gram), its elementwise work in the epilogue; the depthwise taps and the
// per-image softmax run on the FMA pipe.  The stages up to outf are the
// backward's own (csrc/mdta.cuh).  Once a call, the weights' bf16 planes go
// into the workspace; then per slice:
//   1. prep: LN = round(LN x) as bf16 planes, x read through a shared tile
//      of 32 pixels (coalesced in NCHW);
//   2. u = LN W_qkv (f32), 3. the taps: round(q), round(k) and v as planes,
//      and each row segment's sums of squares of round(q) and round(k);
//   4. the gram: G = q^T k over the diagonal (head) tiles, K = pixels, each
//      image's pixels split into at most 32 ranges, a row each;
//   5. a block an image sums its gram rows and its segments' Sq and Sk in
//      order into the stats the backward reads, then A = softmax(temp G rq
//      rk^T) (f32 and planes);
//   6-10. outs = round(A v), out = round(outs W_po), u_vf = out W_kvf, vf
//      by the taps, outf = round(A vf) (csrc/mdta.cuh);
//   11. y = x + round(outf W_pof), taken transposed (M = channels) so the
//      epilogue writes NCHW with consecutive threads on consecutive pixels.
// No float atomics and no ticket: every sum runs in a fixed order, so two
// runs give the same bits.  Operands as csrc/mdta.cuh says: in bf16 a
// product takes 1 or 2 passes, in f32 6 (three planes a value: the gram
// sums up to 65536 pixels).
//
// Context parallelism.  A rank holds a band of the map's rows, and A needs
// the gram and Sq, Sk over every pixel: the forward is split into two
// entries around a sum of the stats over the ranks.  uir_ln_mdta_fwd_stats
// runs steps 1-4 and the stats of step 5 over rows [r0, r1) of its input
// (the band without its halo rows): the gram's K range starts r0 rows into
// each image, and Sq, Sk sum only those rows' segments.
// uir_ln_mdta_fwd_apply recomputes LN, u and v (steps 1-3) rather than
// keep them in a workspace across the sum, forms A from the stats it is
// given and runs 6-11.  On the whole map the two give uir_ln_mdta_fwd's
// bits: the same sums in the same order.
//
// Rounding points (the TPU kernels'): LN, q, k, A v, project_out's output,
// A vf and project_outf's output round to T; v, vf and the gram stay f32;
// y = round(x + round(project_outf)).
#include <cstdint>

#include "mdta.cuh"

namespace {

namespace mm = uir::mma;
namespace gm = uir::gemm;
namespace md = uir::mdta;
using bf16 = __nv_bfloat16;
using gm::kThreads;
using gm::Opnd;
using md::DW_T;
using md::NFT;
using md::NPT;
using md::PT;
using uir::from_f;
using uir::round_to;
using uir::to_f;

// ---- 1. prep (csrc/mdta.cuh): LN as bf16 planes

template <typename T, int NP>
__global__ void __launch_bounds__(kThreads)
    ln_mdta_fwd_prep_kernel(const T* __restrict__ x,
                            const float* __restrict__ scale,
                            const float* __restrict__ bias,
                            bf16* __restrict__ ln, int P, int HW, int C,
                            float eps) {
  md::prep<T, NP>(x, static_cast<const T*>(nullptr), scale, bias, nullptr,
                  ln, nullptr, P, HW, C, eps);
}

// ---- the weights' planes, once a call (csrc/mdta.cuh)

template <int NF>
__global__ void __launch_bounds__(kThreads)
    ln_mdta_fwd_weights_kernel(md::WeightSet ws, bf16* __restrict__ out) {
  md::weight_planes<NF>(ws, out);
}

// ---- 3, 9. the taps (csrc/mdta.cuh)

template <typename T>
__global__ void __launch_bounds__(DW_T)
    ln_mdta_fwd_taps_kernel(const float* __restrict__ u, int ldu,
                            const float* __restrict__ taps, int ldk, int NC,
                            int NT, bf16* __restrict__ tq, size_t tq_lo,
                            int ldt, bf16* __restrict__ fq, size_t fq_lo,
                            int ldf, float* __restrict__ ssq, int segs, int H,
                            int W) {
  md::taps<T>(u, ldu, taps, ldk, NC, NT, tq, tq_lo, ldt, fq, fq_lo, ldf, ssq,
              segs, H, W);
}

// ---- product epilogues (csrc/mdta.cuh), named for this library

struct MdtaFwdF32Epi : md::F32Out {};
template <typename T, int NP>
struct MdtaFwdRoundEpi : md::RoundOut<T, NP> {};
struct MdtaFwdGramEpi : md::RowsOut {};

// 11. y = x + round(W_pof^T outf^T) into NCHW: the product is taken
// transposed (M = channels, N = pixels of the slice), so the tile's rows
// are channels and consecutive threads take consecutive pixels of a
// channel: the loads of x, the stores of y and the tile's reads coalesce.
// A thread keeps one pixel (bn divides the block) and loads its UNR values
// of x before it stores any y.
template <typename T>
struct MdtaFwdOutEpi {
  static constexpr int UNR = 4;
  const T* x;
  T* y;
  int P, C, HW;
  __device__ void operator()(const float* o, int l, int bm, int bn, int m0,
                             int n0, int, int, int) const {
    const int c = threadIdx.x % bn, rs = blockDim.x / bn, n = n0 + c;
    if (n >= P) return;
    const int mb = min(bm, C - m0);
    const size_t pix = (size_t)(n / HW) * C * HW + n % HW;
    for (int r0 = threadIdx.x / bn; r0 < mb; r0 += UNR * rs) {
      float xv[UNR];
#pragma unroll
      for (int u = 0; u < UNR; ++u) {
        const int r = r0 + u * rs;
        xv[u] = r < mb ? to_f(x[pix + (size_t)(m0 + r) * HW]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < UNR; ++u) {
        const int r = r0 + u * rs;
        if (r >= mb) break;
        y[pix + (size_t)(m0 + r) * HW] =
            from_f<T>(xv[u] + round_to<T>(o[r * l + c]));
      }
    }
  }
};

// the last product's tile: BN channels (the products' width) by 128
// pixels, A = W_pof read as [k][m], B = outf [pixel][channel]
template <int NP, int NF, int BN>
using TOut = gm::Tile<BN, 128, BN / 16, 128 / BN, true, false, NF, NP>;

// ---- 5. each image's stats and attention matrix

// An image's stats [C CPH + 2C] into st: the gram [C][CPH] (within the
// heads) as the sum of its nrows rows [C][C] in order, Sq and Sk as the
// sums of nseg segments' rows [2C] from ssq (kThreads / 2C threads a value
// when 2C < kThreads, each over a run of consecutive rows, their sums
// added in run order).  part: kThreads floats of shared memory.  Ends
// synchronized.
template <int CPH>
__device__ void image_stats(const float* __restrict__ rw, int nrows,
                            const float* __restrict__ sq, int nseg,
                            float* __restrict__ st, float* part, int C) {
  const int CC = C * CPH, C2 = 2 * C;
  for (int e = threadIdx.x; e < CC; e += blockDim.x) {
    const int i = e / CPH, j = (i / CPH) * CPH + e % CPH;
    float s = 0.f;
    for (int r = 0; r < nrows; ++r) s += rw[(size_t)r * C * C + i * C + j];
    st[e] = s;
  }
  const int runs = max(1, kThreads / C2), len = (nseg + runs - 1) / runs;
  for (int t = threadIdx.x; t < runs * C2; t += blockDim.x) {
    const int e = t % C2, run = t / C2;
    float s = 0.f;
    const int r1 = min(nseg, (run + 1) * len);
#pragma unroll 8
    for (int r = run * len; r < r1; ++r) s += sq[(size_t)r * C2 + e];
    part[t] = s;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < C2; e += blockDim.x) {
    float s = 0.f;
    for (int r = 0; r < runs; ++r) s += part[r * C2 + e];
    st[CC + e] = s;
  }
  __syncthreads();  // the image's stats, written by this block, are read
}

// Block b (an image of the slice): its stats from the gram's nrows rows
// and from segments [seg0, seg0 + nseg) of its segs segments' Sq, Sk rows
// (the rows of the map the stats cover); with a32, then A from them
// (csrc/mdta.cuh).
template <int CPH, int NF>
__global__ void __launch_bounds__(kThreads)
    ln_mdta_fwd_attn_kernel(const float* __restrict__ rows, int nrows,
                            const float* __restrict__ ssq, int segs, int seg0,
                            int nseg, const float* __restrict__ temp,
                            float* __restrict__ stats, float* __restrict__ a32,
                            bf16* __restrict__ ap, size_t lo, int C) {
  __shared__ float part[2 * md::MAX_C > kThreads ? 2 * md::MAX_C : kThreads];
  const int b = blockIdx.x, ES = C * CPH + 2 * C;
  float* st = stats + (size_t)b * ES;
  image_stats<CPH>(rows + (size_t)b * nrows * C * C, nrows,
                   ssq + ((size_t)b * segs + seg0) * 2 * C, nseg, st, part,
                   C);
  if (a32 != nullptr)
    md::attention<CPH, NF>(st, temp, a32, ap, lo, (size_t)b * C * C, C);
}

// Block b: A of image b from the stats it is given (the apply entry).
template <int CPH, int NF>
__global__ void __launch_bounds__(kThreads)
    ln_mdta_fwd_a_kernel(const float* __restrict__ stats,
                         const float* __restrict__ temp,
                         float* __restrict__ a32, bf16* __restrict__ ap,
                         size_t lo, int C) {
  md::attention<CPH, NF>(stats + (size_t)blockIdx.x * (C * CPH + 2 * C),
                         temp, a32, ap, lo, (size_t)blockIdx.x * C * C, C);
}

// ---- the workspace

// The workspace of one slice of I images of HW pixels (ops/fused_mdta.py
// fwd_workspace_bytes mirrors it), each piece 256-byte aligned.  Two
// regions alternate: R1 holds LN, then u; once the taps have read u, outs,
// then u_vf, then outf, each written after the last read of what it
// overwrites.  R2 holds round(q), round(k) and v; then out, then vf.
enum Piece { WTS, A32, AP, ROWS_G, ROWS_S, R1, R2, NPIECES };

struct Layout {
  size_t off[NPIECES], total, u, v;  // u: U's offset in R1, v: V's in R2
  Layout(int I, int H, int W, int C, int NP, int NF, int KsA) {
    const size_t HW = (size_t)H * W, p = I * HW, c = C;
    const int splits_a = (int)((HW + KsA - 1) / KsA);
    const size_t pl = (size_t)NP * 2 * p * c;  // planes of T values [P][C]
    const size_t fs = (size_t)NF * 2 * p * c;  // planes of f32 values
    const size_t fa = 4 * p * c;               // f32 values
    const size_t cc = (size_t)I * C * C;
    auto up = [](size_t n) { return (n + 255) / 256 * 256; };
    u = up(pl);
    v = up(2 * pl);
    const size_t sz[NPIECES] = {
        (size_t)NF * 2 * 7 * c * c,                // the weights' planes
        4 * cc, (size_t)NF * 2 * cc,               // A: f32, planes
        4 * cc * splits_a,                         // the gram's rows
        4 * (size_t)md::segments(I, H, W) * 2 * c, // Sq, Sk rows
        u + 3 * fa,                                // R1: LN, U
        v + fs};                                   // R2: QK, V
    size_t at = 0;
    for (int i = 0; i < NPIECES; ++i) off[i] = at, at += up(sz[i]);
    total = at;
  }
};

// What a call runs: the whole forward (WHOLE), or its two halves around a
// sum of the stats over the ranks that hold the map's other rows: STATS
// (steps 1-4 and the stats of step 5 over rows [r0, r1) of each image,
// into stats) and APPLY (steps 1-3 again, A from the stats it is given,
// 6-11).
enum Mode { WHOLE, STATS, APPLY };

// BN: the products' output tile width (C for C = 16, 32; else 64)
template <typename T, int CPH, int BN>
int launch(Mode mode, const T* x, T* y, const float* scale,
           const float* bias, const md::Weights& wt, float* stats,
           unsigned char* work, int B, int C, int H, int W, int imgs,
           int KsA, int r0, int r1, float eps, cudaStream_t st) {
  constexpr int NP = NPT<T>, NF = NFT<T>;
  const int HW = H * W, C2 = 2 * C, C3 = 3 * C, ES = C * CPH + 2 * C;
  const Layout L(imgs, H, W, C, NP, NF, KsA);
  // the gram's pixels: rows [r0, r1) of each image, a row of partial sums
  // a range of KsA pixels
  const int KA = (r1 - r0) * W, splits_a = (KA + KsA - 1) / KsA;
  const int ns = md::segments(1, 1, W);  // segments an image row
  auto at = [&](Piece i, size_t off = 0) { return work + L.off[i] + off; };
  auto bfp = [&](Piece i, size_t off = 0) {
    return reinterpret_cast<bf16*>(at(i, off));
  };
  auto f32p = [&](Piece i, size_t off = 0) {
    return reinterpret_cast<float*>(at(i, off));
  };
  const long long cc = (long long)C * C;
  bf16* wts = bfp(WTS);
  const md::WeightSet ws = md::weight_set(wt, C, NF);
  ln_mdta_fwd_weights_kernel<NF>
      <<<dim3((3 * C * C + kThreads - 1) / kThreads, 4), kThreads, 0, st>>>(
          ws, wts);
  UIR_TRY(cudaGetLastError());
  const Opnd Wqkv = md::weight(wts, ws, 0, C3, 0, NF);
  const Opnd Wpo = md::weight(wts, ws, 1, C, 0, NF);
  const Opnd Wkvf = md::weight(wts, ws, 2, C2, C, NF);
  const Opnd Wpof = md::weight(wts, ws, 3, C, 0, NF);
  for (int b0 = 0; b0 < B; b0 += imgs) {
    const int I = min(imgs, B - b0), P = I * HW;
    const size_t base = (size_t)b0 * C * HW;
    auto pl = [&](bf16* p, int np, int ld = 0) {
      return md::pixel_planes(p, np, P, ld ? ld : C, HW);
    };
    const size_t mlo = (size_t)I * C * C;  // plane stride of A
    Opnd Ab = md::planes(bfp(AP), mlo, NF);
    Ab.ld = C;
    Ab.zs = cc;
    bf16* qk = bfp(R2);
    bf16* v = bfp(R2, L.v);

    // 1-3: LN; u, round(q), round(k), v and the Sq, Sk rows
    ln_mdta_fwd_prep_kernel<T, NP>
        <<<(P + PT - 1) / PT, kThreads, md::prep_smem(C), st>>>(
            x + base, scale, bias, bfp(R1), P, HW, C, eps);
    UIR_TRY(cudaGetLastError());
    UIR_TRY((md::qkv_stage<T, MdtaFwdF32Epi, BN>(
        ln_mdta_fwd_taps_kernel<T>, pl(bfp(R1), NP), Wqkv, wt.tqkv,
        f32p(R1, L.u), qk, v, mode == APPLY ? nullptr : f32p(ROWS_S), I, H,
        W, C, st)));
    if (mode == APPLY) {
      // 5: A from the stats given
      ln_mdta_fwd_a_kernel<CPH, NF><<<I, kThreads, 0, st>>>(
          stats + (size_t)b0 * ES, wt.temp, f32p(A32), bfp(AP), mlo, C);
      UIR_TRY(cudaGetLastError());
    } else {
      // 4: the gram over the head tiles and rows [r0, r1), a row a pixel
      // range of an image
      Opnd q = pl(qk, NP, C2);
      for (auto& p : q.pl) p += (size_t)r0 * W * C2;
      const Opnd k{{q.pl[0] + C, q.pl[1] + C, q.pl[2] + C}, C2, q.zs};
      gm::Args a = gm::simple(q, k, C, C, KA);
      a.Ks = KsA;
      a.splits = splits_a;
      a.diag = 1;
      const long long sa = (long long)splits_a * cc;
      UIR_TRY((gm::launch<md::TK<NP, NP>>(
          a, I, MdtaFwdGramEpi{{{f32p(ROWS_G), f32p(ROWS_G)}, C, {C, C}, sa}},
          st)));
      // 5: the stats (rows [r0, r1)), then A
      ln_mdta_fwd_attn_kernel<CPH, NF><<<I, kThreads, 0, st>>>(
          f32p(ROWS_G), splits_a, f32p(ROWS_S), md::segments(1, H, W),
          r0 * ns, (r1 - r0) * ns, wt.temp, stats + (size_t)b0 * ES,
          mode == STATS ? nullptr : f32p(A32), bfp(AP), mlo, C);
      UIR_TRY(cudaGetLastError());
      if (mode == STATS) continue;
    }
    // 6-10: outs, out, u_vf, vf, outf (each over what is dead: Layout)
    UIR_TRY((md::apply_stage<T, MdtaFwdRoundEpi, MdtaFwdF32Epi, BN>(
        ln_mdta_fwd_taps_kernel<T>, pl(v, NF), Ab, Wpo, Wkvf, wt.tkv + C, C2,
        bfp(R1), bfp(R2), f32p(R1), bfp(R2), bfp(R1), I, H, W, C, CPH, st)));
    // 11: y = x + round(W_pof^T outf^T), M = channels, N = pixels
    UIR_TRY((gm::launch<TOut<NP, NF, BN>>(
        gm::simple(Wpof, pl(bfp(R1), NP), C, P, C), 1,
        MdtaFwdOutEpi<T>{x + base, y + base, P, C, HW}, st)));
  }
  return 0;
}

// the products' tile width by C: 16 and 32 wide at C = 16 and 32 (a 64-wide
// tile would leave 3/4 or 1/2 of its outputs idle), 64 from C = 64
template <typename T, int CPH>
int launch_c(Mode mode, const T* x, T* y, const float* scale,
             const float* bias, const md::Weights& wt, float* stats,
             unsigned char* work, int B, int C, int H, int W, int imgs,
             int KsA, int r0, int r1, float eps, cudaStream_t st) {
  if constexpr (CPH <= 16)
    if (C <= 16)
      return launch<T, CPH, 16>(mode, x, y, scale, bias, wt, stats, work, B,
                                C, H, W, imgs, KsA, r0, r1, eps, st);
  if (C <= 32)
    return launch<T, CPH, 32>(mode, x, y, scale, bias, wt, stats, work, B, C,
                              H, W, imgs, KsA, r0, r1, eps, st);
  return launch<T, CPH, 64>(mode, x, y, scale, bias, wt, stats, work, B, C,
                            H, W, imgs, KsA, r0, r1, eps, st);
}

int run(Mode mode, const void* x, void* y, const void* scale,
        const void* bias, const void* wqkv, const void* tqkv, const void* wpo,
        const void* wkv, const void* tkv, const void* wpof, const void* temp,
        void* stats, void* work, int B, int C, int H, int W, int cph,
        int bf16, int imgs, int KsA, int r0, int r1, float eps,
        void* stream) {
  if (C % 16 || C > md::MAX_C || C % cph || B < 1 || H < 1 || W < 1 ||
      imgs < 1 || KsA < gm::BK || KsA % gm::BK ||
      (H * W + KsA - 1) / KsA > md::MAX_SPLITS_A || r0 < 0 || r1 > H ||
      r0 >= r1)
    return (int)cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const md::Weights wt{f(wqkv), f(wpo), f(wkv), f(wpof), f(tqkv), f(tkv),
                       f(temp)};
  auto* sts = static_cast<float*>(stats);
  auto* wk = static_cast<unsigned char*>(work);
  auto st = static_cast<cudaStream_t>(stream);
#define UIR_MDTA_FWD(TT, CPH)                                               \
  return launch_c<TT, CPH>(mode, static_cast<const TT*>(x),                \
                           static_cast<TT*>(y), f(scale), f(bias), wt, sts, \
                           wk, B, C, H, W, imgs, KsA, r0, r1, eps, st)
  if (bf16) {
    if (cph == 8) UIR_MDTA_FWD(__nv_bfloat16, 8);
    if (cph == 16) UIR_MDTA_FWD(__nv_bfloat16, 16);
    if (cph == 32) UIR_MDTA_FWD(__nv_bfloat16, 32);
  } else {
    if (cph == 8) UIR_MDTA_FWD(float, 8);
    if (cph == 16) UIR_MDTA_FWD(float, 16);
    if (cph == 32) UIR_MDTA_FWD(float, 32);
  }
#undef UIR_MDTA_FWD
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The forward over the batch in slices of `imgs` images: one launch a call
// (the weights' planes), then 11 a slice.  The weights in f32 as their
// parameters store them (csrc/mdta.cuh Weights); stats [B][C cph + 2C]
// (each image's gram [C][cph], Sq [C], Sk [C], as ln_mdta_bwd reads them);
// work: one slice's workspace (Layout); KsA: pixels a range of an image's
// gram (a multiple of 32).
extern "C" int uir_ln_mdta_fwd(const void* x, void* y, const void* scale,
                               const void* bias, const void* wqkv,
                               const void* tqkv, const void* wpo,
                               const void* wkv, const void* tkv,
                               const void* wpof, const void* temp,
                               void* stats, void* work, int B, int C, int H,
                               int W, int cph, int bf16, int imgs, int KsA,
                               float eps, void* stream) {
  return run(WHOLE, x, y, scale, bias, wqkv, tqkv, wpo, wkv, tkv, wpof, temp,
             stats, work, B, C, H, W, cph, bf16, imgs, KsA, 0, H, eps,
             stream);
}

// The forward's first half on a band of a row-sharded map (x: the band
// with its halo rows): one launch a call, then 5 a slice (prep, u, the
// taps, the gram, the stats), each image's stats over rows [r0, r1) of x
// (the band without its halo) into stats, as uir_ln_mdta_fwd lays them
// out.  Summed over the ranks, they are the whole map's.
extern "C" int uir_ln_mdta_fwd_stats(
    const void* x, const void* scale, const void* bias, const void* wqkv,
    const void* tqkv, const void* wpo, const void* wkv, const void* tkv,
    const void* wpof, const void* temp, void* stats, void* work, int B,
    int C, int H, int W, int cph, int bf16, int imgs, int KsA, int r0,
    int r1, float eps, void* stream) {
  return run(STATS, x, nullptr, scale, bias, wqkv, tqkv, wpo, wkv, tkv, wpof,
             temp, stats, work, B, C, H, W, cph, bf16, imgs, KsA, r0, r1, eps,
             stream);
}

// Its second half: y from x and the stats it is given (the sum over the
// ranks); LN, u and v recomputed, one launch a call, then 10 a slice
// (prep, u, the taps, A, outs, out, u_vf, the taps, outf, y).  With the
// whole map's stats on the whole map, y is uir_ln_mdta_fwd's, bit for bit.
extern "C" int uir_ln_mdta_fwd_apply(
    const void* x, void* y, const void* scale, const void* bias,
    const void* wqkv, const void* tqkv, const void* wpo, const void* wkv,
    const void* tkv, const void* wpof, const void* temp, const void* stats,
    void* work, int B, int C, int H, int W, int cph, int bf16, int imgs,
    int KsA, float eps, void* stream) {
  return run(APPLY, x, y, scale, bias, wqkv, tqkv, wpo, wkv, tkv, wpof, temp,
             const_cast<void*>(stats), work, B, C, H, W, cph, bf16, imgs, KsA,
             0, H, eps, stream);
}
