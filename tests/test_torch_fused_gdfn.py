"""The port's LN+GDFN (ops/fused_gdfn.py) against the JAX package's Pallas
kernels, run in interpret mode on the CPU.

- plain ``ln_gdfn`` vs ``fused_gdfn_banded.fused_ln_gdfn_banded`` and
  ``fused_block.fused_ln_gdfn`` at (1, 8, 16, 128), and vs the banded kernel
  alone at (1, 8, 8, 64) (fused_block takes only W % 128 == 0).  Hidden
  width 21 is not a multiple of 8, like the model's 42/85/170/340.
- the operands the CUDA kernel reads (``kernel_weights``: hidden channels in
  chunks of gate pairs, zero-padded hidden width) give the same function
  when used the way the kernel uses them.
- ``ln_gdfn_bwd_plain`` (autograd through the plain version) vs ``jax.vjp``
  of ``fused_ln_gdfn_banded`` (TPU kernel row 2) at (1, 8, 16, 128) and
  (1, 8, 8, 64) and of ``fused_block.fused_ln_gdfn`` (row 8) at
  (1, 8, 16, 128): all six gradients;
- the CUDA backward kernel's algorithm (csrc/ln_gdfn_bwd.cu), written in
  torch over the kernel's operand layout with its tensor-core products'
  bf16 hi/lo split of f32 operands, gives the plain backward's gradients
  (at C = 32 in f32 within the card's limit, 1e-4 of max|ref|), and
  ``unchunk`` undoes the layout; the backward's tile choice;
- the CUDA forward kernel's algorithm (csrc/ln_gdfn.cu: its tensor-core
  products over bf16 hi/lo planes, the hidden width split over blocks and
  the splits' sums added in order) against the plain version, and its tile
  and split rule.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from underwater_image_restoration_tpu.ops import fused_block, fused_gdfn_banded
from underwater_image_restoration_torch.ops import fused_gdfn
from underwater_image_restoration_torch.ops.layers import layer_norm_channels

C = 8
TOL = 3e-5  # x max(1, max|ref|), as tests/test_fused_attn_composed.py


def _weights(seed, c):
    rng = np.random.default_rng(seed)
    hid = int(c * 2.66)

    def u(bound, *shape):
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    return (1 + 0.1 * rng.standard_normal(c).astype(np.float32),
            0.1 * rng.standard_normal(c).astype(np.float32),
            u(c ** -0.5, c, 2 * hid), u(1 / 3, 3, 3, 2 * hid),
            u(hid ** -0.5, hid, c))


def _case(shape, seed=0):
    x = np.random.default_rng(seed + 1).standard_normal(shape).astype(
        np.float32)
    return x, _weights(seed, shape[1])


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want,
                               atol=TOL * max(1.0, float(np.abs(want).max())))


def _port(x, w):
    return fused_gdfn.ln_gdfn(torch.from_numpy(x),
                              *(torch.from_numpy(a) for a in w))


@pytest.mark.parametrize("ref, shape", [
    (fused_gdfn_banded.fused_ln_gdfn_banded, (1, C, 16, 128)),
    (fused_block.fused_ln_gdfn, (1, C, 16, 128)),
    (fused_gdfn_banded.fused_ln_gdfn_banded, (1, C, 8, 64)),
], ids=["banded-16x128", "whole-16x128", "banded-8x64"])
def test_plain_matches_pallas(ref, shape):
    x, w = _case(shape)
    want = ref(jnp.asarray(x), *(jnp.asarray(a) for a in w))
    _close(_port(x, w).numpy(), want)


def test_cpu_tensor_takes_plain_version():
    x, w = _case((2, C, 8, 8), seed=3)
    before = sum(fused_gdfn.ln_gdfn.launches.values())
    got = _port(x, w)
    want = fused_gdfn.ln_gdfn_plain(torch.from_numpy(x),
                                    *(torch.from_numpy(a) for a in w))
    assert torch.equal(got, want)
    assert sum(fused_gdfn.ln_gdfn.launches.values()) == before


def _emulate_kernel(x, scale, bias, w_in, w_dw, w_out):
    """The CUDA kernel's arithmetic over its own operands: project_in and
    the taps in chunk order [t1 of chunk m, t2 of chunk m], hidden width
    zero-padded to a multiple of GATE_CHUNK."""
    b, c, h, w = x.shape
    win, taps, wo, hp = fused_gdfn.kernel_weights(w_in, w_dw, w_out)
    ln = layer_norm_channels(x, scale, bias)
    t = fused_gdfn.dwconv3x3(fused_gdfn.conv1x1(ln, win),
                             taps.t().reshape(3, 3, 2 * hp))
    t = t.view(b, hp // fused_gdfn.GATE_CHUNK, 2, fused_gdfn.GATE_CHUNK, h, w)
    t1, t2 = (t[:, :, i].reshape(b, hp, h, w) for i in (0, 1))
    return x + fused_gdfn.conv1x1(F.gelu(t1) * t2, wo)


def test_kernel_operand_layout():
    x, w = _case((2, C, 8, 12), seed=5)
    args = [torch.from_numpy(a) for a in (x, *w)]
    win, taps, wo, hp = fused_gdfn.kernel_weights(*args[3:])
    assert hp == 32 and win.shape == (C, 2 * hp)
    assert taps.shape == (2 * hp, 9) and wo.shape == (hp, C)
    _close(_emulate_kernel(*args).numpy(),
           fused_gdfn.ln_gdfn_plain(*args).numpy())


def _dy(shape, seed=9):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("ref, shape", [
    (fused_gdfn_banded.fused_ln_gdfn_banded, (1, C, 16, 128)),
    (fused_gdfn_banded.fused_ln_gdfn_banded, (1, C, 8, 64)),
    (fused_block.fused_ln_gdfn, (1, C, 16, 128)),
], ids=["banded-16x128", "banded-8x64", "whole-16x128"])
def test_plain_backward_matches_pallas_vjp(ref, shape):
    x, w = _case(shape)
    dy = _dy(shape)
    _, vjp = jax.vjp(ref, jnp.asarray(x), *(jnp.asarray(a) for a in w))
    want = vjp(jnp.asarray(dy))
    got = fused_gdfn.ln_gdfn_bwd_plain(
        torch.from_numpy(x), torch.from_numpy(dy),
        *(torch.from_numpy(a) for a in w))
    assert len(got) == len(want) == 6
    for g, r in zip(got, want):
        assert g.shape == r.shape
        _close(g.numpy(), r)


def _tap_t(d, taps):
    """sum_k taps[:, k] d(p - d_k): the transposed zero-padded 3x3."""
    c = d.shape[1]
    return F.conv2d(d, taps.flip(1).reshape(c, 1, 3, 3), padding=1,
                    groups=c)


def _tap_grad(d, u):
    """(C, 9): sum_p d(p) u(p + d_k), the depthwise taps' gradient."""
    b, c, h, w = u.shape
    cols = F.unfold(u.reshape(b * c, 1, h, w), 3, padding=1)
    return torch.einsum("bcl,bckl->ck", d.reshape(b, c, h * w),
                        cols.reshape(b, c, 9, h * w))


def _ln_backward(x, dln, scale, eps=1e-5):
    """The LayerNorm backward of grad.cuh ln_backward_tile."""
    mean = x.mean(1, keepdim=True)
    rstd = torch.rsqrt((x - mean).square().mean(1, keepdim=True) + eps)
    xh = (x - mean) * rstd
    g = dln * scale.view(1, -1, 1, 1)
    dx = rstd * (g - g.mean(1, keepdim=True)
                 - xh * (g * xh).mean(1, keepdim=True))
    return dx, (dln * xh).sum((0, 2, 3)), dln.sum((0, 2, 3))


def _split(t):
    """csrc/mma.cuh's planes of an f32 operand, as f32: hi = bf16(t), lo =
    bf16(t - hi)."""
    hi = t.bfloat16().float()
    return hi, (t - hi).bfloat16().float()


def _product(f, a, b, split):
    """The bilinear f(a, b) as the kernel's tensor-core products take it:
    with ``split``, f(a_hi, b_hi) + f(a_hi, b_lo) + f(a_lo, b_hi), f32
    sums of bf16 products (an operand that is exactly bf16 has lo = 0)."""
    if not split:
        return f(a, b)
    (ah, al), (bh, bl) = _split(a), _split(b)
    return f(ah, bh) + f(ah, bl) + f(al, bh)


def _emulate_backward(x, dy, scale, bias, w_in, w_dw, w_out, split=True):
    """The CUDA backward's algorithm over its operands (chunked, padded
    hidden width): recompute u and t; the gate's cotangent W_out dy; dt1 =
    dgo t2 gelu'(t1), dt2 = dgo gelu(t1); du by the transposed taps; dW_in
    = LN du^T, dtaps = dt * shifted u, dW_out = o dy^T; dLN = W_in du; the
    LN backward; dx = dy + dx_ln.  With ``split`` the five 1x1 products
    take their f32 operands as bf16 hi/lo planes, as the kernel's tensor
    cores do.  The wrapper's ``unchunk`` restores the argument layouts."""
    b, c, h, w = x.shape
    hid, g = w_out.shape[0], fused_gdfn.GATE_CHUNK
    win, taps, wo, hp = fused_gdfn.kernel_weights(w_in, w_dw, w_out)
    ln = layer_norm_channels(x, scale, bias)
    u = _product(fused_gdfn.conv1x1, ln, win, split)
    t = fused_gdfn.dwconv3x3(u, taps.t().reshape(3, 3, 2 * hp))
    t = t.view(b, hp // g, 2, g, h, w)
    t1, t2 = (t[:, :, i].reshape(b, hp, h, w) for i in (0, 1))
    dgo = _product(fused_gdfn.conv1x1, dy, wo.t(), split)
    gelu_grad = (0.5 * (1 + torch.erf(t1 * 0.5 ** 0.5))
                 + t1 * torch.exp(-0.5 * t1 * t1) / (2 * np.pi) ** 0.5)
    dt = torch.stack([(dgo * t2 * gelu_grad).view(b, hp // g, g, h, w),
                      (dgo * F.gelu(t1)).view(b, hp // g, g, h, w)], 2)
    dt = dt.reshape(b, 2 * hp, h, w)
    du = _tap_t(dt, taps)
    dx_ln, dsc, dbi = _ln_backward(
        x, _product(fused_gdfn.conv1x1, du, win.t(), split), scale)
    d_win = _product(lambda a, b: torch.einsum("bchw,bkhw->ck", a, b), ln,
                     du, split)
    d_wo = _product(lambda a, b: torch.einsum("bghw,bchw->gc", a, b),
                    F.gelu(t1) * t2, dy, split)
    return (dy + dx_ln, dsc, dbi, fused_gdfn.unchunk(d_win, hid, 1),
            fused_gdfn.unchunk(_tap_grad(dt, u), hid, 0).t().reshape(
                3, 3, 2 * hid), d_wo[:hid])


def test_backward_kernel_algorithm():
    x, w = _case((2, C, 8, 12), seed=6)
    args = [torch.from_numpy(a) for a in (x, _dy(x.shape), *w)]
    got = _emulate_backward(*args)
    want = fused_gdfn.ln_gdfn_bwd_plain(*args)
    for g, r in zip(got, want):
        assert g.shape == r.shape
        _close(g.numpy(), r.numpy())


def test_backward_split_products_f32():
    """At C = 32 in f32 (hidden 85, padded to 96), the split products stay
    within the card's f32 limit, 1e-4 of each gradient's max|ref|, of the
    plain backward, and they are not the exact f32 products."""
    x, w = _case((2, 32, 8, 12), seed=8)
    args = [torch.from_numpy(a) for a in (x, _dy(x.shape, 10), *w)]
    got = _emulate_backward(*args)
    exact = _emulate_backward(*args, split=False)
    want = fused_gdfn.ln_gdfn_bwd_plain(*args)
    for g, e, r in zip(got, exact, want):
        assert g.shape == r.shape
        top = float(r.abs().max())
        assert float((g - r).abs().max()) <= 1e-4 * top
    assert not all(torch.equal(g, e) for g, e in zip(got, exact))


def test_backward_tile_shapes():
    """The backward's tile at every Spectral width, both dtypes: its dLN
    accumulators fit the registers and its shared memory a block."""
    want = {2: [(16, 16), (16, 16), (8, 16), (8, 8)],
            4: [(16, 16), (8, 16), (8, 16), (4, 8)]}
    for itemsize, tiles in want.items():
        got = [fused_gdfn.bwd_tile_shape(c, itemsize)
               for c in (16, 32, 64, 128)]
        assert got == tiles
        for c, (th, tw) in zip((16, 32, 64, 128), got):
            assert 32 % tw == 0 and th * tw % 16 == 0
            assert -(-c // 16) * 16 * th * tw <= fused_gdfn.BWD_ACC
            assert fused_gdfn.bwd_shared_bytes(c, th, tw, itemsize) <= \
                fused_gdfn.MAX_SHARED


def _emulate_forward(x, scale, bias, w_in, w_dw, w_out, splits=1):
    """csrc/ln_gdfn.cu's arithmetic over its operands (``kernel_operands``):
    u = W_in^T LN with the weights' bf16 hi/lo planes (and LN's in f32), the
    taps, o = round(gelu(t1) t2) in chunk order; project_out over each of
    ``splits`` ranges of the chunks with the same split products, the
    ranges' sums added in order; y = x + round(acc)."""
    g = fused_gdfn.GATE_CHUNK
    ops = fused_gdfn.kernel_operands(w_in, w_dw, w_out)
    hp, nch = ops.hid_pad, ops.hid_pad // g
    win = ops.win_h.float() + ops.win_l.float()
    wo = ops.wo_h.float() + ops.wo_l.float()
    ln = layer_norm_channels(x, scale, bias).float()
    u = _product(fused_gdfn.conv1x1, ln, win, True)
    t = fused_gdfn.dwconv3x3(u, ops.taps.t().reshape(3, 3, 2 * hp))
    b, _, h, w = t.shape
    t = t.view(b, nch, 2, g, h, w)
    o = (F.gelu(t[:, :, 0]) * t[:, :, 1]).reshape(b, hp, h, w)
    o = o.to(x.dtype).float()
    acc = None
    for s in range(splits):
        m0, m1 = g * (s * nch // splits), g * ((s + 1) * nch // splits)
        part = _product(fused_gdfn.conv1x1, o[:, m0:m1], wo[m0:m1], True)
        acc = part if acc is None else acc + part
    return x + acc.to(x.dtype)


@pytest.mark.parametrize("splits", [1, 3], ids=["whole", "3-splits"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_forward_kernel_algorithm(dtype, splits):
    """The forward kernel's split products and hidden splits at C = 32
    (hidden 85 in 6 chunks of 16) on 2 x 8 x 12, against the plain version
    in the card's limits: f32 5e-5 and bf16 2e-2 of max|branch|, weights
    scaled to unit variance so the branch is O(1)."""
    x, w = _case((2, 32, 8, 12), seed=4)
    w = [a * np.float32(f) for a, f in zip(w, (1, 1, 3 ** 0.5, 3 ** 0.5,
                                               2 * 3 ** 0.5))]
    args = [torch.from_numpy(a) for a in (x, *w)]
    args[0] = args[0].to(dtype)
    got = _emulate_forward(*args, splits=splits)
    want = fused_gdfn.ln_gdfn_plain(*args)
    branch = float((want.float() - args[0].float()).abs().max())
    err = float((got.float() - want.float()).abs().max())
    assert branch > 1
    assert err <= (5e-5 if dtype == torch.float32 else 2e-2) * branch


def test_forward_tile_shapes_and_splits():
    """The forward's tile at every Spectral width, both dtypes: its
    project_out accumulators fit the registers (C_pad x pixels <= FWD_ACC)
    and its shared memory a block, two blocks a multiprocessor in bf16; the
    hidden width split over blocks only where a batch leaves fewer tiles
    than FWD_BLOCKS_PER_SM a multiprocessor (C = 128 at 32x32, serve batch
    8: 2 splits), at most one a chunk; the launches as the splits say (the
    weights' operands, the tiles, and the splits' sum where split)."""
    for itemsize in (2, 4):
        tiles = [fused_gdfn.fwd_tile_shape(c, itemsize)
                 for c in (16, 32, 64, 128)]
        assert tiles == [(16, 16), (16, 16), (8, 16), (8, 8)]
        for c, (th, tw) in zip((16, 32, 64, 128), tiles):
            assert th * tw % 16 == 0
            assert -(-c // 16) * 16 * th * tw <= fused_gdfn.FWD_ACC
            smem = fused_gdfn.fwd_shared_bytes(c, th, tw, itemsize)
            assert smem <= fused_gdfn.MAX_SHARED
            if itemsize == 2:
                assert 2 * smem <= 228 * 1024
    want = {8: [1, 1, 1, 2, 1], 16: [1, 1, 1, 1, 1]}
    for batch, splits in want.items():
        got = []
        for c, side in ((16, 256), (32, 128), (64, 64), (128, 32),
                        (32, 256)):
            th, tw = fused_gdfn.fwd_tile_shape(c, 2)
            hp = fused_gdfn.padded_hidden(int(c * 2.66))
            n = fused_gdfn.fwd_splits(batch * -(-side // th) * -(-side // tw),
                                      hp)
            assert 1 <= n <= hp // fused_gdfn.GATE_CHUNK
            assert fused_gdfn.fwd_launches(batch, side, side, c, hp, 2) == \
                (2 if n == 1 else 3)
            got.append(n)
        assert got == splits
    assert fused_gdfn.fwd_splits(1, 48) == 3  # one tile: a block a chunk


def test_backward_kernel_refuses_cpu_tensor():
    """The backward's wrapper launches the CUDA kernel only; on the CPU,
    autograd differentiates ``ln_gdfn_plain`` and never reaches it."""
    x, w = _case((1, C, 8, 8), seed=2)
    args = [torch.from_numpy(a) for a in (x, _dy(x.shape), *w)]
    before = sum(fused_gdfn.ln_gdfn_bwd.launches.values())
    with pytest.raises(ValueError, match="CUDA tensor"):
        fused_gdfn.ln_gdfn_bwd(*args)
    assert sum(fused_gdfn.ln_gdfn_bwd.launches.values()) == before
