"""LN + MDTA forward: ``y = x + MDTA(LayerNorm_C(x))`` on channels-first
``(B, C, H, W)``, the first half of a SpectralBlock.

Counterpart of the JAX package's ``ops/fused_attn_composed.py:694
fused_ln_mdta_composed`` and ``fused_attn_banded.py:841 fused_ln_mdta_banded``
(one function), with the same argument layouts: scale/bias ``(C,)``, w_qkv
``(C, 3C)``, t_qkv ``(3, 3, 3C)``, temp ``(1, heads, 1, 1)``, w_po ``(C, C)``,
w_kv ``(C, 2C)``, t_kv ``(3, 3, 2C)``, w_pof ``(C, C)``.

The reference's dead code stays dead: the frequency-q chain (``q1x1_1``), the
``kf`` half of kv and ``attnf`` never change the output and are not computed;
the spatial attention is applied to ``vf``, the second half of kv.

``ln_mdta`` launches the two CUDA kernels of ``csrc/ln_mdta.cu`` (stats, then
apply) for a CUDA tensor and takes ``ln_mdta_plain`` for a CPU one.  Rounding
points follow the TPU kernels: LN output, q and k, A·v, project_out's output,
A·vf and project_outf's output round to x.dtype; v and vf stay f32.

On CUDA the forward is ``LnMdtaFn``, whose backward launches
``csrc/ln_mdta_bwd.cu`` (the VJP of the JAX package's
``fused_attn_composed.py:574``, ``fused_attn_banded.py:707`` and
``fused_attn.py:560`` ``_bwd_call``).  It saves x, the weights and the
per-image stats the stats kernel wrote (gram and row sums of squares), as
the TPU VJP saves (x, G, Sq, Sk).  ``ln_mdta_bwd`` is that backward's wrapper
and ``ln_mdta_bwd_plain`` its plain version (autograd through
``ln_mdta_plain``); the dead ``kf`` half of w_kv / t_kv gets zeros.
"""
from __future__ import annotations

import collections

import torch
from torch.autograd.function import once_differentiable

from . import _kernels
from .attention import channel_attention_core
from .fused_gdfn import conv1x1, dwconv3x3
from .layers import l2_normalize, layer_norm_channels


def ln_mdta_plain(x, scale, bias, w_qkv, t_qkv, temp, w_po, w_kv, t_kv,
                  w_pof, num_heads: int, eps: float = 1e-5):
    """Plain PyTorch version of the kernels (the CPU path and the kernels'
    reference on the card)."""
    b, c, h, w = x.shape
    dt = x.dtype

    def heads(t):
        return t.reshape(b, num_heads, c // num_heads, h * w)

    ln = layer_norm_channels(x, scale, bias, eps).float()
    qkv = dwconv3x3(conv1x1(ln, w_qkv.float()), t_qkv.float())
    q, k, v = qkv[:, :c], qkv[:, c:2 * c], qkv[:, 2 * c:]
    q = l2_normalize(heads(q.to(dt).float()))
    k = l2_normalize(heads(k.to(dt).float()))
    outs, attn = channel_attention_core(q, k, heads(v), temp)
    out = conv1x1(outs.to(dt).float().reshape(b, c, h, w), w_po.float())
    vf = dwconv3x3(conv1x1(out.to(dt).float(), w_kv[:, c:].float()),
                   t_kv[:, :, c:].float())
    outf = torch.einsum("bhcd,bhdl->bhcl", attn, heads(vf)).to(dt)
    yf = conv1x1(outf.float().reshape(b, c, h, w), w_pof.float())
    return x + yf.to(dt)


def kernel_weights(w_qkv, t_qkv, w_kv, t_kv):
    """The kernels' operands, f32 and contiguous: the q/k 1x1 (C, 2C) and
    taps (2C, 9), the v 1x1 (C, C) and taps (C, 9), and the live vf half of
    the kv chain, 1x1 (C, C) and taps (C, 9); taps index k = 3 * dh + dw."""
    c = w_qkv.shape[0]
    taps = t_qkv.float().reshape(9, 3 * c).t()
    taps2 = t_kv.float().reshape(9, 2 * c).t()
    wq = w_qkv.float()
    return tuple(t.contiguous() for t in (
        wq[:, :2 * c], taps[:2 * c], wq[:, 2 * c:], taps[2 * c:],
        w_kv[:, c:].float(), taps2[c:]))


def tile_shape(c: int) -> tuple[int, int]:
    """(TH, TW) of one thread block: the apply kernel keeps ~7 channel-major
    copies of its tile with a 2-pixel halo in shared memory, so the tile
    shrinks as C grows to stay under the 227 KB a block may use."""
    if c <= 32:
        return 16, 16
    if c <= 64:
        return 8, 16
    return 4, 8


def bwd_tile_shapes(c: int) -> tuple[tuple[int, int], tuple[int, int]]:
    """(TH, TW) of the backward's v pass and q/k pass.  The v pass keeps
    about ten channel-major copies of its tile (LN on a 2-pixel halo, v,
    out, u_vf and their cotangents on a 1-pixel halo), the q/k pass about
    six, so both shrink with C to stay under the 227 KB a block may use."""
    if c <= 16:
        return (16, 16), (16, 16)
    if c <= 32:
        return (8, 16), (8, 16)
    if c <= 64:
        return (8, 8), (8, 8)
    return (4, 4), (4, 8)


def _check_heads(c, num_heads):
    cph = c // num_heads
    if c % 16 or c % num_heads or cph not in (8, 16, 32):
        raise ValueError(f"ln_mdta: C={c} with {num_heads} heads; the "
                         "kernels take C a multiple of 16 and 8, 16 or 32 "
                         "channels a head")
    return cph


def forward_with_stats(x, scale, bias, w_qkv, t_qkv, temp, w_po, w_kv,
                       t_kv, w_pof, num_heads, eps: float = 1e-5):
    """The CUDA forward of a CUDA tensor: (y, stats), stats holding each
    image's gram, Sq and Sk (what the backward needs besides x)."""
    b, c, h, w = x.shape
    _kernels.check_input("ln_mdta", x, scale, bias, w_qkv, t_qkv, temp, w_po,
                         w_kv, t_kv, w_pof)
    cph = _check_heads(c, num_heads)
    lib = _kernels.library("ln_mdta")
    wqk, tqk, wv, tv, wvf, tvf = kernel_weights(w_qkv, t_qkv, w_kv, t_kv)
    sc = scale.float().contiguous()
    bi = bias.float().contiguous()
    tp = temp.float().reshape(-1).contiguous()
    wpo = w_po.float().contiguous()
    wpof = w_pof.float().contiguous()
    th, tw = tile_shape(c)
    ntiles = -(-h // th) * -(-w // tw)
    e = c * cph + 2 * c
    part = torch.empty(b * ntiles * e, device=x.device, dtype=torch.float32)
    counters = torch.zeros(b, device=x.device, dtype=torch.int32)
    stats = torch.empty(b * e, device=x.device, dtype=torch.float32)
    y = torch.empty_like(x)
    bf16 = int(x.dtype == torch.bfloat16)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.uir_ln_mdta_stats(
        x.data_ptr(), sc.data_ptr(), bi.data_ptr(), wqk.data_ptr(),
        tqk.data_ptr(), part.data_ptr(), counters.data_ptr(),
        stats.data_ptr(), b, c, h, w, cph, bf16, th, tw, float(eps), stream)
    _kernels.check(lib, err, "ln_mdta stats")
    ln_mdta.launches[(c, h, w)] += 1
    err = lib.uir_ln_mdta_apply(
        x.data_ptr(), y.data_ptr(), sc.data_ptr(), bi.data_ptr(),
        wv.data_ptr(), tv.data_ptr(), wvf.data_ptr(), tvf.data_ptr(),
        wpo.data_ptr(), wpof.data_ptr(),
        tp.data_ptr(), stats.data_ptr(), b, c, h, w, cph, bf16, th, tw,
        float(eps), stream)
    _kernels.check(lib, err, "ln_mdta apply")
    ln_mdta.launches[(c, h, w)] += 1
    return y, stats


def ln_mdta_bwd_plain(x, dy, scale, bias, w_qkv, t_qkv, temp, w_po, w_kv,
                      t_kv, w_pof, num_heads: int, eps: float = 1e-5):
    """Gradients of ``ln_mdta_plain`` at (x, weights) for the cotangent dy,
    by autograd: (dx, dscale, dbias, dw_qkv, dt_qkv, dtemp, dw_po, dw_kv,
    dt_kv, dw_pof)."""
    ins = [t.detach().requires_grad_() for t in
           (x, scale, bias, w_qkv, t_qkv, temp, w_po, w_kv, t_kv, w_pof)]
    with torch.enable_grad():
        y = ln_mdta_plain(*ins, num_heads, eps=eps)
        return torch.autograd.grad(y, ins, dy)


def ln_mdta_bwd(x, dy, scale, bias, w_qkv, t_qkv, temp, w_po, w_kv, t_kv,
                w_pof, num_heads: int, stats, eps: float = 1e-5):
    """The LN+MDTA backward's CUDA kernels, on CUDA tensors, with ``stats``
    as ``forward_with_stats`` wrote them.  Returns the gradients in the
    order of ``ln_mdta_bwd_plain``, dx in x.dtype and the rest f32."""
    b, c, h, w = x.shape
    _kernels.check_input("ln_mdta_bwd", x, dy, scale, bias, w_qkv, t_qkv,
                         temp, w_po, w_kv, t_kv, w_pof, stats)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError("ln_mdta_bwd: dy must match x in shape and dtype")
    cph = _check_heads(c, num_heads)
    lib = _kernels.library("ln_mdta_bwd")
    f32 = dict(device=x.device, dtype=torch.float32)
    wqkv = w_qkv.float().contiguous()
    taps3 = t_qkv.float().reshape(9, 3 * c).t().contiguous()
    wvf = w_kv[:, c:].float().contiguous()
    tvf = t_kv.float().reshape(9, 2 * c).t()[c:].contiguous()
    wpo = w_po.float().contiguous()
    ops = (x, dy.contiguous(), torch.empty_like(x),
           scale.float().contiguous(), bias.float().contiguous(), wqkv, taps3,
           wqkv.t().contiguous(), wvf, tvf, wpo, wpo.t().contiguous(),
           w_pof.float().t().contiguous(), wvf.t().contiguous(),
           temp.float().reshape(-1).contiguous(), stats)
    (tha, twa), (thb, twb) = bwd_tile_shapes(c)
    tiles_a = -(-h // tha) * -(-w // twa)
    tiles_b = -(-h // thb) * -(-w // twb)
    groups = _kernels.block_rows(b * max(tiles_a, tiles_b), x.device)
    sizes = (c * c, c * c, 9 * c, c * c, 3 * c * c, 27 * c, c, c)
    scratch = (torch.empty(b * c * h * w, **f32),            # dv
               torch.empty(b * tiles_a * c * cph, **f32),    # dA partials
               torch.zeros(b, device=x.device, dtype=torch.int32),
               torch.empty(b * (c * cph + 2 * c), **f32),    # M, alphas
               torch.empty(b * num_heads, **f32),            # dtemp
               torch.empty(groups * sum(sizes), **f32),      # partial rows
               torch.empty(sum(sizes), **f32))               # grads
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.uir_ln_mdta_bwd(
        *(t.data_ptr() for t in ops + scratch), b, c, h, w, cph,
        int(x.dtype == torch.bfloat16), tha, twa, thb, twb, groups,
        float(eps), stream)
    _kernels.check(lib, err, "ln_mdta_bwd")
    ln_mdta_bwd.launches[(c, h, w)] += 3  # v pass, q/k pass, row sum
    g_pof, g_kvf, g_tvf, g_po, g_qkv, g_t3, dsc, dbi = scratch[-1].split(sizes)
    zero = torch.zeros(c, c, **f32)
    dw_kv = torch.cat([zero, g_kvf.view(c, c)], 1)
    dt_kv = torch.cat([zero[:, :9], g_tvf.view(c, 9)]).t().reshape(3, 3,
                                                                   2 * c)
    dtemp = scratch[4].view(b, num_heads).sum(0).view(1, num_heads, 1, 1)
    return (ops[2], dsc, dbi, g_qkv.view(c, 3 * c),
            g_t3.view(3 * c, 9).t().reshape(3, 3, 3 * c), dtemp,
            g_po.view(c, c), dw_kv, dt_kv, g_pof.view(c, c))


class LnMdtaFn(torch.autograd.Function):
    """The CUDA forward with the CUDA backward; saves x, the weights and the
    per-image stats."""

    @staticmethod
    def forward(ctx, x, scale, bias, w_qkv, t_qkv, temp, w_po, w_kv, t_kv,
                w_pof, num_heads, eps):
        y, stats = forward_with_stats(x, scale, bias, w_qkv, t_qkv, temp,
                                      w_po, w_kv, t_kv, w_pof, num_heads, eps)
        ctx.num_heads, ctx.eps = num_heads, eps
        ctx.save_for_backward(x, scale, bias, w_qkv, t_qkv, temp, w_po, w_kv,
                              t_kv, w_pof, stats)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, *ws, stats = ctx.saved_tensors
        grads = ln_mdta_bwd(x, dy, *ws, ctx.num_heads, stats, eps=ctx.eps)
        return (grads[0],) + tuple(g.to(t.dtype) for g, t in
                                   zip(grads[1:], ws)) + (None, None)


def ln_mdta(x, scale, bias, w_qkv, t_qkv, temp, w_po, w_kv, t_kv, w_pof,
            num_heads: int, eps: float = 1e-5):
    """``x + MDTA(LayerNorm(x))``: the CUDA kernels (forward and backward)
    for a CUDA tensor, the plain version for a CPU tensor."""
    if x.device.type == "cpu":
        return ln_mdta_plain(x, scale, bias, w_qkv, t_qkv, temp, w_po, w_kv,
                             t_kv, w_pof, num_heads, eps)
    return LnMdtaFn.apply(x, scale, bias, w_qkv, t_qkv, temp, w_po, w_kv,
                          t_kv, w_pof, num_heads, eps)


# launches of the CUDA kernel(s), by (C, H, W); the CPU path adds none
ln_mdta.launches = collections.Counter()
ln_mdta_bwd.launches = collections.Counter()
