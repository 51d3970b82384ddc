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
// batch in image slices, each 1x1 product a tensor-core product (the
// shared launch of gemm.cuh: mma.sync m16n8k16, bf16 in, f32 accumulate,
// operand tiles staged by cp.async in two stages) over pixels x channels,
// its elementwise work in the epilogue; the prep, fc1 and g1-window stages
// are leff.cuh's, shared with the forward (csrc/ln_leff.cu):
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

#include "leff.cuh"

namespace {

namespace mm = uir::mma;
namespace gm = uir::gemm;
namespace lf = uir::leff;
using bf16 = __nv_bfloat16;
using gm::kThreads;
using gm::Opnd;
using gm::Tile;
using uir::from_f;
using uir::round_to;
using uir::to_f;
using gm::warp_sum;

constexpr int FM = 32;       // pixels a block of the dLN launch
constexpr int DW_T = 128;    // threads a block of the depthwise pass
constexpr int DW_R = 2;      // image rows a thread of the depthwise pass
constexpr int DW_W = 64;     // columns a thread of the depthwise pass
constexpr int MAX_C = 512;   // widest C the dLN launch holds in one block

// 2. fc1's epilogue (csrc/leff.cuh): t1 and g1 [pixel][hid] in T
template <typename T>
struct Fc1Epi : lf::Fc1<T> {};

// 3. dg2's epilogue: t2 from g1's 3x3 neighbourhood (csrc/leff.cuh
// Window), dt2 (f32) and g2 (planes) [pixel][hid]
template <typename T, int NP>
struct Dg2Epi {
  const T* g1;
  const float* taps;  // [9][hid]
  const float* bdw;
  float* dt2;
  bf16* g2;
  size_t g2_lo;
  int M, N, H, W;
  // A thread keeps one pair of columns and walks bm / (kThreads / (bn / 2))
  // consecutive pixels of the tile with a sliding 3x3 window of g1.
  __device__ void operator()(const float* o, int ld, int bm, int bn, int m0,
                             int n0, int, int, int) const {
    const int hp = bn / 2, per = bm / (kThreads / hp);
    const int c = 2 * (threadIdx.x % hp), n = n0 + c;
    const int rbeg = (threadIdx.x / hp) * per;
    const int rend = min(rbeg + per, M - m0);
    if (n >= N || rbeg >= rend) return;
    lf::Window<T> win{g1, N, H, W};
    win.start(taps, bdw, m0 + rbeg, n);
    for (int r = rbeg; r < rend; ++r) {
      const float2 t2 = win.t2();
      const float2 v = *reinterpret_cast<const float2*>(o + r * ld + c);
      float ga, gpa, gb, gpb;
      lf::gelu_both(t2.x, ga, gpa);
      lf::gelu_both(t2.y, gb, gpb);
      const size_t q = (size_t)(m0 + r) * N + n;
      *reinterpret_cast<float2*>(dt2 + q) = make_float2(v.x * gpa, v.y * gpb);
      mm::put2<NP>(g2, g2_lo, q, round_to<T>(ga), round_to<T>(gb));
      win.next(r + 1 < rend);
    }
  }
};

// 5. the weight gradients' epilogue: problem 0 is dW1^T (stored as dW1
// [C][hid]), problem 1 dW2 [hid][C]; split s writes its own rows.
struct WgradEpi {
  float* part;  // [2][splits][hid * C]
  int M, N, splits;
  __device__ void operator()(const float* o, int ld, int bm, int bn, int m0,
                             int n0, int prob, int split, int) const {
    float* row = part + ((size_t)prob * splits + split) * M * N;
    gm::for_pairs(o, ld, bm, bn, m0, n0, M, N,
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
                             int, int, int, int) const {
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

// 1. prep (csrc/leff.cuh): LN statistics, LN and dyk, a warp a pixel.
template <typename T, int NP>
__global__ void __launch_bounds__(kThreads)
    ln_leff_bwd_prep_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                            const float* __restrict__ scale,
                            const float* __restrict__ bias,
                            const float* __restrict__ s,
                            float2* __restrict__ stats, bf16* __restrict__ ln,
                            bf16* __restrict__ dyk, int M, int HW, int C,
                            float eps) {
  lf::prep<T, NP>(x, dy, scale, bias, s, stats, ln, dyk, M, HW, C, eps);
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
      const float d = u * lf::gelu_grad(tv[r]);
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

template <typename T, int BNF>
cudaError_t dln(int P, const Opnd& A, const Opnd& B, int C, int hid,
                const DlnEpi<T>& epi, cudaStream_t stream) {
  constexpr int NP = std::is_same<T, float>::value ? 2 : 1;
  using TL = Tile<FM, BNF, 1, 8, false, false, NP>;
  return gm::launch<TL>(gm::simple(A, B, P, C, hid), 1, epi, stream);
}

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
  const Opnd W1{{w1h, w1l, w1l}, hid, 0}, W2{{w2h, w2l, w2l}, C, 0};
  using TA = Tile<128, 128, 2, 4, false, true, NP>;   // fc1: B = W1 [C][hid]
  using TB = Tile<128, 128, 2, 4, false, false, NP>;  // dg2: B = W2 [hid][C]
  using TW = Tile<128, 64, 4, 2, true, true, NP>;     // dW1^T, dW2
  for (int b0 = 0; b0 < B; b0 += imgs) {
    const int nb = min(imgs, B - b0), P = nb * HW, rows = nb * hg;
    const size_t px0 = (size_t)b0 * HW;
    const size_t pc = (size_t)P * C, ph = (size_t)P * hid;
    const Opnd LN{{ln, ln + pc, ln + pc}, C, 0};
    const Opnd DYK{{dyk, dyk + pc, dyk + pc}, C, 0};
    const Opnd G2{{g2, g2 + ph, g2 + ph}, hid, 0};
    const Opnd D1{{d1, d1 + ph, d1 + ph}, hid, 0};
    const int splits = (P + Ks - 1) / Ks, fblocks = (P + FM - 1) / FM;

    ln_leff_bwd_prep_kernel<T, NP><<<(P + 7) / 8, kThreads, 0, st>>>(
        x + px0 * C, dy + px0 * C, scale, bias, s + b0, stats, ln, dyk, P, HW,
        C, eps);
    UIR_TRY(cudaGetLastError());
    UIR_TRY(gm::launch<TA>(gm::simple(LN, W1, P, hid, C), 1,
                           Fc1Epi<T>{{t1, g1, b1, P, hid}}, st));
    UIR_TRY(gm::launch<TB>(
        gm::simple(DYK, W2, P, hid, C), 1,
        Dg2Epi<T, NP>{g1, taps, bdw, dt2, g2, ph, P, hid, H, W}, st));
    const int hch = (hid + DW_T - 1) / DW_T, cch = (C + DW_T - 1) / DW_T;
    ln_leff_bwd_dw_kernel<T, NP><<<dim3(hch + cch, rows), DW_T, 0, st>>>(
        t1, g1, dt2, taps, dy + px0 * C, s + b0, d1, ph, partD1, partD2, H,
        W, C, hid, hch);
    UIR_TRY(cudaGetLastError());
    gm::Args wa = gm::simple(D1, LN, hid, C, P);
    wa.A[1] = G2;
    wa.B[1] = DYK;
    wa.Ks = Ks;
    wa.nprob = 2;
    wa.splits = splits;
    UIR_TRY(gm::launch<TW>(wa, 1, WgradEpi{partW, hid, C, splits}, st));
    const DlnEpi<T> de{x + px0 * C, dy + px0 * C, dx + px0 * C, stats,
                       scale, partF, P, C, residual};
    if (C <= 128)
      UIR_TRY((dln<T, 128>(P, D1, W1, C, hid, de, st)));
    else if (C <= 256)
      UIR_TRY((dln<T, 256>(P, D1, W1, C, hid, de, st)));
    else
      UIR_TRY((dln<T, 512>(P, D1, W1, C, hid, de, st)));
    const int ch = C * hid;
    UIR_TRY(gm::reduce_rows<5>(
        {{partW, splits, ch, 0, 0, 0},
         {partD1, rows, 11 * hid, ch, 0, 0},
         {partW + (size_t)splits * ch, splits, ch, ch + 11 * hid, 0, 0},
         {partD2, rows, C, 2 * ch + 11 * hid, 0, 0},
         {partF, fblocks, 2 * C, 2 * ch + 11 * hid + C, 0, 0}},
        grads, b0 > 0, st));
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
      imgs < 1 || Ks < gm::BK || Ks % gm::BK)
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
