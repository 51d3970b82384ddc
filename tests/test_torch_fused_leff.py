"""The port's LN+LeFF (ops/fused_leff.py) against the JAX package, on the
CPU.

- ``ln_leff_plain`` vs the TPU kernel ``fused_leff.fused_ln_leff`` in
  interpret mode at (2, 8, 16, 128) (the port takes channels-last tokens,
  the TPU kernel channels-first), f32 and bf16, with the per-image scale
  s = [0, 1.25] and ``residual=False``, and with s = None and the residual;
- vs the unfused JAX chain (``ops.LayerNorm`` over tokens, then
  ``models/blocks.py LeFF``) at 8 x 8, a shape the TPU kernel's
  ``supports`` refuses, f32;
- the CUDA kernel's algorithm (csrc/ln_leff.cu), written in torch over the
  operands ``kernel_weights`` lays out: pixel tiles with a one-pixel halo,
  hidden chunks of HIDDEN_CHUNK (the width 48 zero-padded to 64) whose fc2
  terms add into f32 accumulators, ragged edge tiles;
- the CPU route takes the plain version and counts no launch.

Weights keep unit variance through fc1, the taps and fc2, with non-zero
biases, so the branch is O(1).  Tolerances, over max(1, max|ref|): f32
3e-5 (f32 sums in another order, XLA's erf rational against torch's erf);
bf16 1.6e-2 of max|ref|, two bf16 ulps (both round at the same points; a
sum on the other side of a rounding boundary moves the branch one ulp,
which the scale 1.25 and its rounding can make two).
"""
import flax.linen as nn
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


def _kernel_algorithm(x, scale, bias, w1, b1, w_dw, b_dw, w2, b2, s,
                      residual, th, tw, eps=1e-5):
    """csrc/ln_leff.cu in torch: one (TH, TW) tile at a time with its halo,
    the hidden width in chunks over the kernel's operands."""
    dt = x.dtype
    b, h, w, c = x.shape
    *ops, hp = fused_leff.kernel_weights(w1, b1, w_dw, b_dw, w2, b2, dt)
    w1k, b1k, taps, bdwk, w2k, b2k = ops
    assert w1k.dtype == w2k.dtype == dt  # staged as f32 by the kernel
    w1k, w2k = w1k.float(), w2k.float()
    g = fused_leff.HIDDEN_CHUNK
    assert hp % g == 0 and taps.shape == (9, hp)

    def rnd(t):
        return t.to(dt).float()

    ln = rnd(layer_norm_last(x, scale, bias, eps))
    pad = (0, 0, 1, th + 1, 1, tw + 1)
    lnp = F.pad(ln, pad)
    inside = F.pad(torch.ones(b, h, w, 1), pad)
    y = torch.empty_like(x)
    for r0 in range(0, h, th):
        for c0 in range(0, w, tw):
            patch = lnp[:, r0:r0 + th + 2, c0:c0 + tw + 2]
            keep = inside[:, r0:r0 + th + 2, c0:c0 + tw + 2]
            acc = torch.zeros(b, th, tw, c)
            for j0 in range(0, hp, g):
                j = slice(j0, j0 + g)
                t1 = rnd(rnd(patch @ w1k[:, j]) + b1k[j])
                g1 = rnd(gelu(t1)) * keep
                t2 = sum(taps[3 * dh + dw, j] * g1[:, dh:dh + th, dw:dw + tw]
                         for dh in range(3) for dw in range(3))
                g2 = rnd(gelu(rnd(rnd(t2) + bdwk[j])))
                acc += g2 @ w2k[j]
            yd = rnd(rnd(acc) + b2k)
            sc = rnd(yd * (1.0 if s is None else s.view(-1, 1, 1, 1)))
            xt = x[:, r0:r0 + th, c0:c0 + tw].float()
            out = xt + sc[:, :xt.shape[1], :xt.shape[2]] if residual else \
                sc[:, :xt.shape[1], :xt.shape[2]]
            y[:, r0:r0 + th, c0:c0 + tw] = out.to(dt)
    return y


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("residual", [True, False])
def test_kernel_algorithm_matches_plain(dtype, residual):
    b, h, w, c, hid = 2, 10, 12, 12, 48
    x = torch.from_numpy(_x((b, h, w, c), 4)).to(dtype)
    ws = [torch.from_numpy(a) for a in _weights(c, hid, 5)]
    s = torch.tensor([1.25, 0.5])
    got = _kernel_algorithm(x, *ws, s, residual, 4, 8)
    want = fused_leff.ln_leff_plain(x, *ws, s=s, residual=residual)
    _close(got.float().numpy(), want.float().numpy(), dtype)


def test_tile_shapes_and_hidden_padding():
    """Every AST width gets a tile whose shared memory fits a block, in
    both dtypes; the hidden width pads with zeros."""
    want = {2: [(8, 8), (8, 8), (8, 8), (8, 8), (4, 4)],
            4: [(8, 8), (8, 8), (8, 8), (4, 8), (2, 4)]}
    for itemsize, tiles in want.items():
        got = [fused_leff.tile_shape(c, itemsize)
               for c in (32, 64, 128, 256, 512)]
        assert got == tiles
        for c, (th, tw) in zip((32, 64, 128, 256, 512), got):
            assert fused_leff.shared_bytes(c, th, tw, itemsize) <= \
                fused_leff.MAX_SHARED
    ws = [torch.from_numpy(a) for a in _weights(8, 40, 6)]
    *ops, hp = fused_leff.kernel_weights(*ws[2:], torch.bfloat16)
    assert hp == 64 and ops[0].shape == (8, 64) and ops[4].shape == (64, 8)
    assert ops[0].dtype == ops[4].dtype == torch.bfloat16
    assert not ops[0][:, 40:].any() and not ops[4][40:].any()
    assert torch.equal(ops[0][:, :40], ws[2].bfloat16())
    assert torch.equal(ops[1][:40], ws[3].bfloat16().float())
    assert torch.equal(ops[2][:, :40], ws[4].reshape(9, 40))  # taps stay f32


def test_cpu_tensor_takes_plain_version():
    x = torch.from_numpy(_x((1, 8, 8, 8), 7))
    ws = [torch.from_numpy(a).requires_grad_() for a in _weights(8, 32, 8)]
    before = sum(fused_leff.ln_leff.launches.values())
    got = fused_leff.ln_leff(x, *ws)
    assert torch.equal(got, fused_leff.ln_leff_plain(x, *ws))
    assert got.requires_grad  # the plain version carries gradients
    assert sum(fused_leff.ln_leff.launches.values()) == before
