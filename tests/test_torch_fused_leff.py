"""The port's LN+LeFF (ops/fused_leff.py) against the JAX package, on the
CPU.

- ``ln_leff_plain`` vs the TPU kernel ``fused_leff.fused_ln_leff`` in
  interpret mode at (2, 8, 16, 128) (the port takes channels-last tokens,
  the TPU kernel channels-first), f32 and bf16, with the per-image scale
  s = [0, 1.25] and ``residual=False``, and with s = None and the residual;
- vs the unfused JAX chain (``ops.LayerNorm`` over tokens, then
  ``models/blocks.py LeFF``) at 8 x 8, a shape the TPU kernel's
  ``supports`` refuses, f32;
- the CUDA forward's staged algorithm (csrc/ln_leff.cu), written in torch
  over the operands ``kernel_weights`` lays out (the width 48 zero-padded
  to 64): the batch in image slices, LN, fc1 and fc2 as the tensor-core
  products take them (f32 operands as three bf16 planes), g2 from g1's 3x3
  window, the biases rounded where the kernels add them; the forward's
  planner (slices within FWD_WORKSPACE_BYTES at every AST@256 shape, serve
  batch 8 and train batch 16);
- the CPU route takes the plain version and counts no launch;
- ``ln_leff_bwd_plain`` (autograd through the plain version) vs ``jax.vjp``
  of the TPU kernel's VJP (row 12, ``fused_leff.py:337 _bwd_call``) in
  interpret mode at (2, 8, 16, 128), with and without the residual and with
  s = [0, 1.25]: every gradient, and the TPU VJP's zero ds;
- the CUDA backward's staged algorithm (csrc/ln_leff_bwd.cu) written in
  torch over the operands ``kernel_weights`` lays out: the batch in image
  slices, the five tensor-core products (f32 operands as bf16 hi/lo
  planes), the depthwise pass's rows, the weight gradients split over
  pixel ranges, dLN with the LayerNorm backward in blocks of pixels, every
  row summed in order, the TPU kernel's rounding points; against the plain
  backward in f32 and bf16;
- the backward's planner (slices within WORKSPACE_BYTES, aligned launch
  arguments); its wrapper refuses a CPU tensor.

Weights keep unit variance through fc1, the taps and fc2, with non-zero
biases, so the branch is O(1).  Tolerances, over max(1, max|ref|): f32
3e-5 (f32 sums in another order, XLA's erf rational against torch's erf);
bf16 1.6e-2 of max|ref|, two bf16 ulps (both round at the same points; a
sum on the other side of a rounding boundary moves the branch one ulp,
which the scale 1.25 and its rounding can make two).  Gradients: each over
its own max|ref|, f32 3e-5 (weight gradients sum over 4096 pixels in
another order); the kernel algorithm in bf16 2e-2, the card's limit
(``chip_smoke.py`` phase 7(a)): it rounds at the TPU kernel's points and
autograd through the plain version at others (dg2, dt2, dLN and the weight
gradients), a bf16 ulp apart.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from underwater_image_restoration_tpu.models.blocks import LeFF as JaxLeFF
from underwater_image_restoration_tpu.ops import LayerNorm as JaxLayerNorm
from underwater_image_restoration_tpu.ops import fused_leff as jax_fused_leff
from underwater_image_restoration_torch.ops import fused_leff
from underwater_image_restoration_torch.ops.layers import (
    gelu,
    layer_norm_last,
)

TOL = {torch.float32: 3e-5, torch.bfloat16: 1.6e-2}


def _weights(c, hid, seed):
    rng = np.random.default_rng(seed)

    def n(fan_in, *shape):
        return (rng.standard_normal(shape) / fan_in ** 0.5).astype(np.float32)

    return (1 + 0.1 * n(1, c), 0.1 * n(1, c), n(c, c, hid),
            0.1 * n(1, hid), n(9, 3, 3, hid), 0.1 * n(1, hid),
            n(hid, hid, c), 0.1 * n(1, c))


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, dtype):
    want = np.asarray(want, np.float32)
    top = np.abs(want).max()
    lim = TOL[dtype] * (max(1.0, top) if dtype == torch.float32 else top)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, atol=lim,
                               rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("s, residual", [((0.0, 1.25), False),
                                         (None, True)],
                         ids=["scaled-branch", "residual"])
def test_plain_matches_pallas(dtype, s, residual):
    b, c, h, w = 2, 8, 16, 128
    x = _x((b, h, w, c), 1)
    ws = _weights(c, 4 * c, 0)
    sv = None if s is None else np.array(s, np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jax_fused_leff.fused_ln_leff(
        jnp.asarray(x.transpose(0, 3, 1, 2)).astype(jdt),
        *(jnp.asarray(a) for a in ws),
        None if sv is None else jnp.asarray(sv), interpret=True,
        residual=residual)
    got = fused_leff.ln_leff_plain(
        torch.from_numpy(x).to(dtype), *(torch.from_numpy(a) for a in ws),
        s=None if sv is None else torch.from_numpy(sv), residual=residual)
    assert got.dtype == dtype
    _close(got.float().numpy(),
           np.asarray(want.astype(jnp.float32)).transpose(0, 2, 3, 1), dtype)
    if s is not None:  # s_b = 0 zeroes the first image's branch
        assert not got[0].any()


def test_plain_matches_unfused_jax_chain():
    b, c, h, w = 2, 8, 8, 8
    assert not jax_fused_leff.supports(h, w, c, 4 * c, 4)
    x = _x((b, h, w, c), 2)
    sc, bi, w1, b1, wdw, bdw, w2, b2 = _weights(c, 4 * c, 3)
    tokens = jnp.asarray(x.reshape(b, h * w, c))
    ln = JaxLayerNorm().apply({"params": {"scale": sc, "bias": bi}}, tokens)
    leff = JaxLeFF(c, 4 * c).apply({"params": {
        "linear1": {"kernel": w1, "bias": b1},
        "dwconv": {"kernel": wdw[:, :, None, :], "bias": bdw},
        "linear2": {"kernel": w2, "bias": b2}}}, ln)
    want = np.asarray(tokens + leff).reshape(b, h, w, c)
    got = fused_leff.ln_leff_plain(
        torch.from_numpy(x), *(torch.from_numpy(a) for a in (
            sc, bi, w1, b1, wdw, bdw, w2, b2)))
    _close(got.numpy(), want, torch.float32)


def _shifted(t, dh, dw):
    """t(p + (dh, dw)) on (n, h, w, ch), zero outside the image."""
    h, w = t.shape[1:3]
    tp = F.pad(t, (0, 0, 1, 1, 1, 1))
    return tp[:, 1 + dh:1 + dh + h, 1 + dw:1 + dw + w]


def _kernel_algorithm(x, scale, bias, w1, b1, w_dw, b_dw, w2, b2, s,
                      residual, imgs, eps=1e-5):
    """csrc/ln_leff.cu's staged design in torch: the batch in slices of
    ``imgs`` images, per slice LN (rounded), fc1 with g1 in its epilogue, g2
    from g1's 3x3 window (zero outside the image), fc2 with y in its
    epilogue; the products as the tensor cores take them (f32 operands
    split into three bf16 planes), the biases rounded to the compute dtype
    where they are added."""
    dt = x.dtype
    split = dt == torch.float32
    b, h, w, c = x.shape
    w1k, b1k, taps, bdwk, w2k, b2k, hp = fused_leff.kernel_weights(
        w1, b1, w_dw, b_dw, w2, b2, dt)
    assert w1k.dtype == w2k.dtype == dt and hp % fused_leff.HIDDEN_CHUNK == 0
    assert taps.shape == (9, hp)
    w1k, w2k = w1k.float(), w2k.float()

    def rnd(t):
        return t.to(dt).float()

    sb = torch.ones(b) if s is None else s.float()
    y = torch.empty_like(x)
    for b0 in range(0, b, imgs):
        xs = x[b0:b0 + imgs].float()
        n, p = xs.shape[0], xs.shape[0] * h * w
        mean = xs.mean(-1, keepdim=True)
        rstd = torch.rsqrt((xs - mean).square().mean(-1, keepdim=True) + eps)
        ln = rnd((xs - mean) * rstd * scale + bias).reshape(p, c)
        t1 = rnd(rnd(_mm(ln, w1k, split, 3)) + rnd(b1k))
        g1 = rnd(gelu(t1)).view(n, h, w, hp)
        t2 = sum(taps[k] * _shifted(g1, k // 3 - 1, k % 3 - 1)
                 for k in range(9))
        g2 = rnd(gelu(rnd(rnd(t2) + rnd(bdwk)))).reshape(p, hp)
        yd = rnd(rnd(_mm(g2, w2k, split, 3)) + rnd(b2k))
        yd = rnd(yd * sb[b0:b0 + n].repeat_interleave(h * w)[:, None])
        out = xs.reshape(p, c) + yd if residual else yd
        y[b0:b0 + n] = out.view(n, h, w, c).to(dt)
    return y


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("residual", [True, False])
def test_kernel_algorithm_matches_plain(dtype, residual):
    """Three images in two slices, 10 x 12, C = 16, hidden width 48 (padded
    to 64), s with a zero in the unscaled branch."""
    b, h, w, c, hid = 3, 10, 12, 16, 48
    x = torch.from_numpy(_x((b, h, w, c), 4)).to(dtype)
    ws = [torch.from_numpy(a) for a in _weights(c, hid, 5)]
    s = torch.tensor([1.25, 0.5, 1.0]) if residual else \
        torch.tensor([0.5, 0.0, 1.25])
    got = _kernel_algorithm(x, *ws, s, residual, 2)
    want = fused_leff.ln_leff_plain(x, *ws, s=s, residual=residual)
    _close(got.float().numpy(), want.float().numpy(), dtype)


def test_tile_shapes_and_hidden_padding():
    """The forward's slices at every AST width, both dtypes: the workspace
    mirrors the kernel's layout and stays within FWD_WORKSPACE_BYTES, the
    slices cover the batch evenly, four launches a slice; an image wider
    than the budget is a slice by itself.  The hidden width pads with zeros
    (and is not copied when it needs no padding); the biases stay f32, for
    the kernels to round."""
    for itemsize in (2, 4):
        for c in (32, 64, 128, 256, 512):
            plan = fused_leff.fwd_plan(8, 32, 32, c, 4 * c, itemsize)
            assert plan.workspace == fused_leff.fwd_workspace_bytes(
                plan.imgs, 32, 32, c, 4 * c, itemsize)
            assert plan.workspace <= fused_leff.FWD_WORKSPACE_BYTES
            assert plan.imgs * plan.slices >= 8 > plan.imgs * (
                plan.slices - 1)
            assert plan.launches == fused_leff.FWD_LAUNCHES * plan.slices
    big = fused_leff.fwd_plan(2, 1024, 1024, 64, 256, 2)
    assert big.imgs == 1 and big.slices == 2
    assert big.workspace > fused_leff.FWD_WORKSPACE_BYTES
    ws = [torch.from_numpy(a) for a in _weights(8, 40, 6)]
    *ops, hp = fused_leff.kernel_weights(*ws[2:], torch.bfloat16)
    assert hp == 64 and ops[0].shape == (8, 64) and ops[4].shape == (64, 8)
    assert ops[0].dtype == ops[4].dtype == torch.bfloat16
    assert not ops[0][:, 40:].any() and not ops[4][40:].any()
    assert torch.equal(ops[0][:, :40], ws[2].bfloat16())
    assert torch.equal(ops[1][:40], ws[3])  # biases f32, rounded in-kernel
    assert torch.equal(ops[2][:, :40], ws[4].reshape(9, 40))  # taps stay f32
    ws = [torch.from_numpy(a) for a in _weights(8, 32, 6)]
    ops = fused_leff.kernel_weights(*ws[2:], torch.float32)
    assert ops[-1] == 32 and ops[0] is ws[2] and ops[4] is ws[6]


@pytest.mark.parametrize("batch", [8, 16], ids=["serve-b8", "train-b16"])
@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "f32"])
def test_forward_plan_within_budget(batch, itemsize):
    """The forward's planner at every AST@256 shape: the workspace within
    FWD_WORKSPACE_BYTES, the fewest slices that fit (one image more a slice
    would not), the batch covered evenly."""
    for c, side in ((32, 256), (64, 128), (128, 64), (256, 32), (512, 16),
                    (512, 32), (256, 64), (128, 128), (64, 256)):
        plan = fused_leff.fwd_plan(batch, side, side, c, 4 * c, itemsize)
        assert plan.workspace <= fused_leff.FWD_WORKSPACE_BYTES
        assert plan.imgs * plan.slices >= batch > plan.imgs * (
            plan.slices - 1)
        if plan.slices > 1:
            most = -(-batch // (plan.slices - 1))
            assert fused_leff.fwd_workspace_bytes(
                most, side, side, c, 4 * c, itemsize) > \
                fused_leff.FWD_WORKSPACE_BYTES


def test_cpu_tensor_takes_plain_version():
    x = torch.from_numpy(_x((1, 8, 8, 8), 7))
    ws = [torch.from_numpy(a).requires_grad_() for a in _weights(8, 32, 8)]
    before = sum(fused_leff.ln_leff.launches.values())
    got = fused_leff.ln_leff(x, *ws)
    assert torch.equal(got, fused_leff.ln_leff_plain(x, *ws))
    assert got.requires_grad  # the plain version carries gradients
    assert sum(fused_leff.ln_leff.launches.values()) == before


GRAD_TOL = {torch.float32: 3e-5, torch.bfloat16: 2e-2}


def _grads_close(got, want, dtype):
    assert len(got) == len(want)
    for i, (g, r) in enumerate(zip(got, want)):
        g, r = np.asarray(g, np.float32), np.asarray(r, np.float32)
        assert g.shape == r.shape, i
        top = float(np.abs(r).max())
        assert top > 0, i
        np.testing.assert_allclose(g, r, atol=GRAD_TOL[dtype] * top, rtol=0,
                                   err_msg=f"gradient {i}")


@pytest.mark.parametrize("s, residual", [((0.0, 1.25), False),
                                         ((0.0, 1.25), True),
                                         (None, True)],
                         ids=["scaled-branch", "scaled-residual",
                              "residual"])
def test_plain_backward_matches_pallas_vjp(s, residual):
    b, c, h, w = 2, 8, 16, 128
    x = _x((b, h, w, c), 11)
    dy = _x((b, h, w, c), 12)
    ws = _weights(c, 4 * c, 13)
    sv = np.ones(b, np.float32) if s is None else np.array(s, np.float32)

    def f(xc, *args):
        return jax_fused_leff.fused_ln_leff(xc, *args, interpret=True,
                                            residual=residual)

    _, vjp = jax.vjp(f, jnp.asarray(x.transpose(0, 3, 1, 2)),
                     *(jnp.asarray(a) for a in ws), jnp.asarray(sv))
    want = vjp(jnp.asarray(dy.transpose(0, 3, 1, 2)))
    assert not np.asarray(want[-1]).any()  # the TPU VJP gives s no gradient
    want = [np.asarray(want[0]).transpose(0, 2, 3, 1)] + [
        np.asarray(g) for g in want[1:-1]]
    got = fused_leff.ln_leff_bwd_plain(
        torch.from_numpy(x), torch.from_numpy(dy),
        *(torch.from_numpy(a) for a in ws),
        s=None if s is None else torch.from_numpy(sv), residual=residual)
    _grads_close([g.numpy() for g in got], want, torch.float32)


def _gelu_grad(t):
    return (0.5 * (1 + torch.erf(t * 0.5 ** 0.5))
            + t * torch.exp(-0.5 * t * t) / (2 * np.pi) ** 0.5)


def _split(t, planes=2):
    """csrc/mma.cuh's planes of an f32 operand, as f32: hi = bf16(t), lo =
    bf16(t - hi); with three, hi, mid = bf16(t - hi), lo = bf16(t - hi -
    mid)."""
    out = []
    for _ in range(planes):
        out.append(t.bfloat16().float())
        t = t - out[-1]
    return out


def _mm(a, b, split, planes=2):
    """a @ b as the kernel's tensor-core products take it: bf16 operands,
    f32 sums; with ``split`` (an f32 call) each operand as its planes, the
    passes (i, j) with i + j < planes: a_hi b_hi + a_hi b_lo + a_lo b_hi
    with two (the backward), six passes with three (the forward)."""
    if not split:
        return a @ b
    pa, pb = _split(a, planes), _split(b, planes)
    return sum(pa[i] @ pb[j] for i in range(planes)
               for j in range(planes - i))


def _in_order(rows):
    """Rows summed one after another, as the kernel's ordered row sum does
    below 64 rows (from 64, a warp an output: lanes over the rows, then a
    fixed shuffle tree; not reached at these sizes)."""
    out = rows[0]
    for r in rows[1:]:
        out = out + r
    return out


def _backward_algorithm(x, dy, scale, bias, w1, b1, w_dw, b_dw, w2, b2, s,
                        residual, imgs, ks, eps=1e-5):
    """csrc/ln_leff_bwd.cu's staged design in torch: the batch in slices of
    ``imgs`` images, per slice prep (LN, dyk), fc1 (t1, g1), dg2 with t2
    from g1's neighbourhood (dt2 f32, g2), the depthwise pass (round(dt1)
    and a row of shares an image row), dW1 and dW2 split over ``ks``-pixel
    ranges, dLN and the LayerNorm backward in blocks of 32 pixels; every
    launch's rows summed in order, slices added in order; the TPU kernel's
    rounding points, the f32 operands of an f32 call split."""
    dt = x.dtype
    split = dt == torch.float32
    b, h, w, c = x.shape
    hid = w1.shape[1]
    w1k, b1k, taps, bdwk, w2k, _, hp = fused_leff.kernel_weights(
        w1, b1, w_dw, b_dw, w2, b2, dt)
    w1k, w2k = w1k.float(), w2k.float()
    fm = fused_leff.BWD_DLN_PIXELS
    assert ks % fused_leff.BWD_K == 0

    def rnd(t):
        return t.to(dt).float()

    def shifted(t, dh, dw):
        """t(p + (dh, dw)) on (n, h, w, hp), zero outside the image."""
        tp = F.pad(t, (0, 0, 1, 1, 1, 1))
        return tp[:, 1 + dh:1 + dh + h, 1 + dw:1 + dw + w]

    sb = torch.ones(b) if s is None else s.float()
    grads = None
    dx = torch.empty_like(x)
    for b0 in range(0, b, imgs):
        xs, dys = x[b0:b0 + imgs].float(), dy[b0:b0 + imgs].float()
        n, p = xs.shape[0], xs.shape[0] * h * w
        # prep
        mean = xs.mean(-1, keepdim=True)
        rstd = torch.rsqrt((xs - mean).square().mean(-1, keepdim=True) + eps)
        xh = (xs - mean) * rstd
        ln = rnd(xh * scale + bias)
        dyk = rnd(dys * sb[b0:b0 + n].view(-1, 1, 1, 1))
        # fc1, then dg2 and its epilogue
        t1 = rnd(rnd(_mm(ln.reshape(p, c), w1k, split)) + rnd(b1k))
        g1 = rnd(F.gelu(t1)).view(n, h, w, hp)
        t1 = t1.view(n, h, w, hp)
        dg2 = _mm(dyk.reshape(p, c), w2k.t(), split).view(n, h, w, hp)
        t2 = torch.zeros(n, h, w, hp)
        for k in range(9):
            t2 = t2 + taps[k] * shifted(g1, k // 3 - 1, k % 3 - 1)
        t2 = rnd(rnd(t2) + rnd(bdwk))
        dt2 = dg2 * _gelu_grad(t2)
        g2 = rnd(F.gelu(t2))
        # the depthwise pass: a row of shares an image row
        dt1 = torch.zeros(n, h, w, hp)
        for k in range(9):
            dt1 = dt1 + taps[k] * rnd(shifted(dt2, 1 - k // 3, 1 - k % 3))
        dt1 = dt1 * _gelu_grad(t1)
        d1 = rnd(dt1)
        dtaps = torch.stack([(dt2 * shifted(g1, k // 3 - 1, k % 3 - 1))
                             for k in range(9)], -1)
        rows_d = torch.cat([dt1, dtaps.reshape(n, h, w, 9 * hp), dt2], -1)
        rows_b2 = dyk
        # a row of shares a patch of BWD_DW_ROWS rows and BWD_DW_COLS
        # columns, patches in (image, row, column) order
        r, q = fused_leff.BWD_DW_ROWS, fused_leff.BWD_DW_COLS
        rows_d, rows_b2 = (
            torch.stack([t[:, i:i + r, j:j + q].sum((1, 2))
                         for i in range(0, h, r) for j in range(0, w, q)], 1)
            .reshape(-1, t.shape[-1]) for t in (rows_d, rows_b2))
        # the weight gradients, split over pixel ranges
        lnf, dykf = ln.reshape(p, c), dyk.reshape(p, c)
        d1f, g2f = d1.reshape(p, hp), g2.reshape(p, hp)
        rows_w1, rows_w2 = [], []
        for k0 in range(0, p, ks):
            r = slice(k0, k0 + ks)
            rows_w1.append(_mm(d1f[r].t(), lnf[r], split).t().reshape(-1))
            rows_w2.append(_mm(g2f[r].t(), dykf[r], split).reshape(-1))
        # dLN and the LayerNorm backward, blocks of fm pixels
        dl = _mm(d1f, w1k.t(), split)
        xhf = xh.reshape(p, c)
        gs = dl * scale.float()
        dxl = rnd(rstd.reshape(p, 1) * (gs - gs.mean(-1, keepdim=True) - xhf
                                        * (gs * xhf).mean(-1, keepdim=True)))
        out = dys.reshape(p, c) + dxl if residual else dxl
        dx[b0:b0 + n] = out.view(n, h, w, c).to(dt)
        rows_ln = [torch.cat([(dl[i:i + fm] * xhf[i:i + fm]).sum(0),
                              dl[i:i + fm].sum(0)]) for i in range(0, p, fm)]
        sl = torch.cat([_in_order(rows_w1), _in_order(list(rows_d)),
                        _in_order(rows_w2), _in_order(list(rows_b2)),
                        _in_order(rows_ln)])
        grads = sl if grads is None else grads + sl
    d_w1, d_b1, d_taps, d_bdw, d_w2, d_b2, d_sc, d_bi = grads.split(
        (c * hp, hp, 9 * hp, hp, hp * c, c, c, c))
    return (dx, d_sc, d_bi, d_w1.view(c, hp)[:, :hid], d_b1[:hid],
            d_taps.view(hp, 9)[:hid].t().reshape(3, 3, hid), d_bdw[:hid],
            d_w2.view(hp, c)[:hid], d_b2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("residual", [True, False])
def test_backward_kernel_algorithm_matches_plain(dtype, residual):
    """Three slices of one image, 10 x 12 (120 pixels: weight-gradient
    splits of 64 and dLN blocks of 32, both ragged), hidden width 48
    (padded to 64), s with a zero."""
    b, h, w, c, hid = 3, 10, 12, 8, 48
    x = torch.from_numpy(_x((b, h, w, c), 14)).to(dtype)
    dy = torch.from_numpy(_x((b, h, w, c), 15)).to(dtype)
    ws = [torch.from_numpy(a) for a in _weights(c, hid, 16)]
    s = (torch.tensor([1.25, 0.0, 0.5]) if residual
         else torch.tensor([0.5, 1.25, 0.0]))
    got = _backward_algorithm(x, dy, *ws, s, residual, 1, 64)
    want = fused_leff.ln_leff_bwd_plain(x, dy, *ws, s=s, residual=residual)
    assert got[0].dtype == dtype
    _grads_close([t.float().numpy() for t in got],
                 [t.float().numpy() for t in want], dtype)


def test_backward_tiles_and_rows():
    """The backward's planner at every AST@256 width, batch 16, both
    dtypes: each slice's workspace (intermediates and weight-gradient rows)
    stays within WORKSPACE_BYTES, the slices cover the batch evenly, and
    the launch arguments stay aligned (C a multiple of 8 up to 512, the
    hidden width of 16, a split's pixels of the staged k depth); the widest
    workspace, 64@256² in bf16, walks the batch in four slices of four, and
    a 1024² image, whose workspace exceeds the cap, is a slice by itself."""
    for itemsize in (2, 4):
        for c, side in ((32, 256), (64, 128), (128, 64), (256, 32),
                        (512, 16), (512, 32), (256, 64), (128, 128),
                        (64, 256)):
            hp = 4 * c
            plan = fused_leff.bwd_plan(16, side, side, c, hp, itemsize)
            assert plan.workspace <= fused_leff.WORKSPACE_BYTES
            assert plan.workspace == fused_leff.bwd_workspace_bytes(
                plan.imgs, side, side, c, hp, itemsize, plan.split_pixels)
            assert plan.imgs * plan.slices >= 16 > \
                plan.imgs * (plan.slices - 1)
            assert plan.launches == fused_leff.BWD_LAUNCHES * plan.slices
            assert c % 8 == 0 and c <= fused_leff.BWD_MAX_C
            assert hp % 16 == 0
            assert plan.split_pixels % fused_leff.BWD_K == 0
            assert plan.split_pixels >= fused_leff.BWD_K
    assert fused_leff.bwd_plan(16, 256, 256, 64, 256, 2)[:2] == (4, 4)
    # an image wider than the cap is a slice by itself
    big = fused_leff.bwd_plan(2, 1024, 1024, 32, 128, 2)
    assert big.imgs == 1 and big.slices == 2
    assert big.workspace > fused_leff.WORKSPACE_BYTES
    assert fused_leff.bwd_row_size(512, 2048) % 8 == 0


def test_backward_kernel_refuses_cpu_tensor():
    """The backward's wrapper launches the CUDA kernel only; on the CPU,
    autograd differentiates ``ln_leff_plain`` and never reaches it."""
    x = torch.from_numpy(_x((1, 8, 8, 8), 17))
    ws = [torch.from_numpy(a) for a in _weights(8, 32, 18)]
    before = sum(fused_leff.ln_leff_bwd.launches.values())
    with pytest.raises(ValueError, match="CUDA tensor"):
        fused_leff.ln_leff_bwd(x, torch.ones_like(x), *ws)
    assert sum(fused_leff.ln_leff_bwd.launches.values()) == before
