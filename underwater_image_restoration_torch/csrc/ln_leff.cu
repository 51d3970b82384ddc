// LN + LeFF forward on channels-last tokens x (B, H, W, C):
//   y = x + s_b * (fc2(gelu(dw3x3(gelu(fc1(LayerNorm_C(x)))))))
// (residual = 0 drops the "x +"), fc1 C -> hid with bias, dw3x3 depthwise
// with bias and zero padding, fc2 hid -> C with bias, s_b a per-image scale.
//
// Replaces the TPU kernel of the JAX package ops/fused_leff.py:301 _fwd_call
// (_fwd_kernel:99), which worked channels-first; the port's AST keeps its
// tokens channels-last, so this kernel reads and writes them as they are and
// its caller pays no relayout.
//
// Rounding points (the TPU kernel's): LN statistics and affine in f32,
// rounded to T; fc1 summed in f32, rounded, then its bias added in T; gelu in
// f32 of that, rounded; the depthwise taps (f32, not rounded) summed in f32,
// rounded, bias added in T; gelu, rounded; fc2 summed in f32 over the whole
// hidden width, rounded, bias added in T; times s_b in f32, rounded; x + that
// in T.  The wrapper passes fc1 and fc2 as bf16 planes of their values in T
// (three in f32) and the three biases in f32; the kernel rounds them to T,
// as the TPU kernel casts them.
//
// What bounds it on an H100.  Per pixel it does 4 C hid + 18 hid flops
// against 2 C itemsize bytes of x and y: about 4 C flops a byte at hid = 4C
// in bf16 (128-2048 over the AST levels), so at peak rates the levels with
// C >= 128 are bound by the tensor cores' operations and those with C = 32
// and 64 by bytes.
//
// Design.  A tile-local kernel (a block owning a pixel tile and its halo)
// cannot feed the tensor cores at the wide levels: its LN patch, hidden
// chunk and f32 accumulators shrink the tile to 4 x 4 pixels at C = 512,
// too small an M, with fc1 recomputed 2.3x on the halo.  So the forward
// runs as four launches over the batch in image slices, the two 1x1
// products on the tensor cores through gemm.cuh (M = pixels), the stages
// shared with the backward from leff.cuh:
//   1. prep: LN = round(LN x) into bf16 planes [pixel][C], a warp a pixel;
//   2. fc1 (M = pixels, N = hid, K = C): g1 = round(gelu(round(round(LN W1)
//      + b1))) [pixel][hid] in T, in the epilogue;
//   3. g2 = round(gelu(round(round(taps * g1) + b_dw))) into bf16 planes
//      [pixel][hid] on the FMA pipe: a thread a channel pair walking
//      consecutive pixels with a sliding 3x3 window of g1 (zero outside the
//      image), three new loads a pixel;
//   4. fc2 (M = pixels, N = C, K = hid): y = x + round(round(round(acc) +
//      b2) s_b), in the epilogue.
// g1 and g2 make one round trip through device memory each (2 hid
// itemsize bytes a pixel, 4 hid in f32); the slices keep that workspace
// within ops/fused_leff.py FWD_WORKSPACE_BYTES (fwd_plan).  In bf16 every
// product operand (LN, W1, g2, W2) is exactly bf16, one pass; in f32 each
// is three bf16 planes, hi, mid and lo (mma.cuh), six passes, about 2^-24
// of a product, and each k tile's sum is added round-to-nearest (gemm.cuh
// RN): with hi/lo pairs (about 2^-17) and truncating sums over the hidden
// width, an f32 AST train step's losses drifted past the limit of
// chip_smoke.py phase 7(d) (three Adam steps against the plain model).
// No float atomics: two runs give the same bits.
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

constexpr int DW_T = 128;  // threads a block of the g2 stage
constexpr int DW_P = 32;   // consecutive pixels a thread of the g2 stage

// 1. prep (csrc/leff.cuh): LN, a warp a pixel.
template <typename T, int NP>
__global__ void __launch_bounds__(kThreads)
    ln_leff_fwd_prep_kernel(const T* __restrict__ x,
                            const float* __restrict__ scale,
                            const float* __restrict__ bias,
                            bf16* __restrict__ ln, int M, int HW, int C,
                            float eps) {
  lf::prep<T, NP>(x, static_cast<const T*>(nullptr), scale, bias, nullptr,
                  nullptr, ln, nullptr, M, HW, C, eps);
}

// 2. fc1's epilogue (csrc/leff.cuh): g1 [pixel][hid] in T
template <typename T>
struct LeffFwdFc1Epi : lf::Fc1<T> {};

// 3. g2 from g1's 3x3 window (csrc/leff.cuh): a warp covers 32 channel
// pairs of a run of DW_P consecutive pixels of the slice; warp w of the
// grid takes channel group w % groups and run w / groups.
template <typename T, int NP>
__global__ void __launch_bounds__(DW_T)
    ln_leff_fwd_dw_kernel(const T* __restrict__ g1,
                          const float* __restrict__ taps,
                          const float* __restrict__ bdw, bf16* __restrict__ g2,
                          int M, int hid, int H, int W) {
  const int groups = (hid / 2 + 31) / 32;
  const int gw = blockIdx.x * (DW_T / 32) + (threadIdx.x >> 5);
  const int n = 2 * (32 * (gw % groups) + (threadIdx.x & 31));
  const int m0 = (gw / groups) * DW_P, m1 = min(M, m0 + DW_P);
  if (n >= hid || m0 >= M) return;
  const size_t lo = (size_t)M * hid;
  lf::Window<T> win{g1, hid, H, W};
  win.start(taps, bdw, m0, n);
  for (int m = m0; m < m1; ++m) {
    const float2 t2 = win.t2();
    mm::put2<NP>(g2, lo, (size_t)m * hid + n,
                 round_to<T>(lf::gelu_f(t2.x)), round_to<T>(lf::gelu_f(t2.y)));
    win.next(m + 1 < m1);
  }
}

// 4. fc2's epilogue: y [pixel][C] in T
template <typename T>
struct LeffFwdFc2Epi {
  const T* x;
  T* y;
  const float* b2;
  const float* s;  // [images of the slice], or none: ones
  int M, N, HW, residual;
  __device__ void operator()(const float* o, int ld, int bm, int bn, int m0,
                             int n0, int, int, int) const {
    gm::for_pairs(o, ld, bm, bn, m0, n0, M, N,
                  [&](int m, int n, float v0, float v1) {
                    const float sb = s != nullptr ? __ldg(s + m / HW) : 1.f;
                    const size_t i = (size_t)m * N + n;
                    const float ba = round_to<T>(__ldg(b2 + n));
                    const float bb = round_to<T>(__ldg(b2 + n + 1));
                    float a =
                        round_to<T>(round_to<T>(round_to<T>(v0) + ba) * sb);
                    float b =
                        round_to<T>(round_to<T>(round_to<T>(v1) + bb) * sb);
                    if (residual) {
                      const float2 xv = gm::load2(x, i);
                      a += xv.x;
                      b += xv.y;
                    }
                    gm::store2(y, i, a, b);
                  });
  }
};

// The workspace of one slice of P pixels, in order, each piece 256-byte
// aligned (ops/fused_leff.py fwd_workspace_bytes mirrors it): LN planes,
// g1 in T, g2 planes.
struct Layout {
  size_t off[4];
  Layout(int P, int C, int hid, int NP, int item) {
    const size_t p = P;
    const size_t sz[3] = {(size_t)NP * 2 * p * C, p * hid * item,
                          (size_t)NP * 2 * p * hid};
    off[0] = 0;
    for (int i = 0; i < 3; ++i)
      off[i + 1] = off[i] + (sz[i] + 255) / 256 * 256;
  }
};

// bf16 planes an operand: three in f32 (hi, mid, lo), one in bf16
template <typename T>
constexpr int planes() {
  return std::is_same<T, float>::value ? 3 : 1;
}

// a product's tile: f32 calls add each k tile round-to-nearest
template <typename T, int BN, int WM, int WN>
using FwdTile = Tile<128, BN, WM, WN, false, true, planes<T>(), planes<T>(),
                     2, (planes<T>() > 1)>;

template <typename T, class TF2>
int launch(const T* x, T* y, const float* scale, const float* bias,
           const bf16* w1h, const bf16* w1l, const bf16* w1x,
           const float* b1, const float* taps, const float* bdw,
           const bf16* w2h, const bf16* w2l, const bf16* w2x,
           const float* b2, const float* s, unsigned char* work, int B, int H,
           int W, int C, int hid, int imgs, int residual, float eps,
           cudaStream_t st) {
  constexpr int NP = planes<T>();
  const int HW = H * W;
  const Layout L(imgs * HW, C, hid, NP, sizeof(T));
  auto* ln = reinterpret_cast<bf16*>(work + L.off[0]);
  auto* g1 = reinterpret_cast<T*>(work + L.off[1]);
  auto* g2 = reinterpret_cast<bf16*>(work + L.off[2]);
  const Opnd W1{{w1h, w1l, w1x}, hid, 0}, W2{{w2h, w2l, w2x}, C, 0};
  using TA = FwdTile<T, 128, 2, 4>;  // fc1: B = W1 [C][hid]
  for (int b0 = 0; b0 < B; b0 += imgs) {
    const int nb = min(imgs, B - b0), P = nb * HW;
    const size_t px0 = (size_t)b0 * HW;
    const Opnd LN{{ln, ln + (size_t)P * C, ln + 2 * (size_t)P * C}, C, 0};
    const Opnd G2{{g2, g2 + (size_t)P * hid, g2 + 2 * (size_t)P * hid},
                  hid, 0};
    ln_leff_fwd_prep_kernel<T, NP><<<(P + 7) / 8, kThreads, 0, st>>>(
        x + px0 * C, scale, bias, ln, P, HW, C, eps);
    UIR_TRY(cudaGetLastError());
    UIR_TRY(gm::launch<TA>(gm::simple(LN, W1, P, hid, C), 1,
                           LeffFwdFc1Epi<T>{{nullptr, g1, b1, P, hid}}, st));
    const int warps = (hid / 2 + 31) / 32 * ((P + DW_P - 1) / DW_P);
    ln_leff_fwd_dw_kernel<T, NP>
        <<<(warps + DW_T / 32 - 1) / (DW_T / 32), DW_T, 0, st>>>(
            g1, taps, bdw, g2, P, hid, H, W);
    UIR_TRY(cudaGetLastError());
    UIR_TRY(gm::launch<TF2>(
        gm::simple(G2, W2, P, C, hid), 1,
        LeffFwdFc2Epi<T>{x + px0 * C, y + px0 * C, b2,
                         s != nullptr ? s + b0 : nullptr, P, C, HW,
                         residual},
        st));
  }
  return 0;
}

template <typename T>
int launch_c(const T* x, T* y, const float* scale, const float* bias,
             const bf16* w1h, const bf16* w1l, const bf16* w1x,
             const float* b1, const float* taps, const float* bdw,
             const bf16* w2h, const bf16* w2l, const bf16* w2x,
             const float* b2, const float* s, unsigned char* work, int B,
             int H, int W, int C, int hid, int imgs, int residual, float eps,
             cudaStream_t st) {
  // fc2: B = W2 [hid][C]; a narrower n tile at C <= 64
  if (C <= 64)
    return launch<T, FwdTile<T, 64, 4, 2>>(
        x, y, scale, bias, w1h, w1l, w1x, b1, taps, bdw, w2h, w2l, w2x, b2,
        s, work, B, H, W, C, hid, imgs, residual, eps, st);
  return launch<T, FwdTile<T, 128, 2, 4>>(
      x, y, scale, bias, w1h, w1l, w1x, b1, taps, bdw, w2h, w2l, w2x, b2, s,
      work, B, H, W, C, hid, imgs, residual, eps, st);
}

}  // namespace

// The forward over the batch in slices of `imgs` images, four launches a
// slice (prep, fc1, g2, fc2).  work: the workspace of one slice (Layout).
// w1l, w1x, w2l and w2x (the mid and lo planes) are read only in f32; s
// may be null (ones).
extern "C" int uir_ln_leff_fwd(const void* x, void* y, const void* scale,
                               const void* bias, const void* w1h,
                               const void* w1l, const void* b1,
                               const void* taps, const void* bdw,
                               const void* w2h, const void* w2l,
                               const void* b2, const void* w1x,
                               const void* w2x, const void* s, void* work,
                               int B, int H, int W, int C, int hid_pad,
                               int residual, int bf16, int imgs, float eps,
                               void* stream) {
  // C % 8 and hid_pad % 16: 16-byte operand rows and whole k16 steps
  if (hid_pad % 16 || C % 8 || B < 1 || H < 1 || W < 1 || imgs < 1)
    return (int)cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto h = [](const void* p) {
    return static_cast<const __nv_bfloat16*>(p);
  };
  auto* wk = static_cast<unsigned char*>(work);
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_c<__nv_bfloat16>(
        h(x), static_cast<__nv_bfloat16*>(y), f(scale), f(bias), h(w1h),
        h(w1l), h(w1x), f(b1), f(taps), f(bdw), h(w2h), h(w2l), h(w2x),
        f(b2), f(s), wk, B, H, W, C, hid_pad, imgs, residual, eps, st);
  return launch_c<float>(f(x), static_cast<float*>(y), f(scale), f(bias),
                         h(w1h), h(w1l), h(w1x), f(b1), f(taps), f(bdw),
                         h(w2h), h(w2l), h(w2x), f(b2), f(s), wk, B, H, W, C,
                         hid_pad, imgs, residual, eps, st);
}
