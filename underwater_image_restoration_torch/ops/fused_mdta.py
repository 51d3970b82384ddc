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
"""
from __future__ import annotations

import collections

import torch

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


def ln_mdta(x, scale, bias, w_qkv, t_qkv, temp, w_po, w_kv, t_kv, w_pof,
            num_heads: int, eps: float = 1e-5):
    """``x + MDTA(LayerNorm(x))``: the CUDA kernels for a CUDA tensor, the
    plain version for a CPU tensor."""
    if x.device.type == "cpu":
        return ln_mdta_plain(x, scale, bias, w_qkv, t_qkv, temp, w_po, w_kv,
                             t_kv, w_pof, num_heads, eps)
    b, c, h, w = x.shape
    _kernels.check_input("ln_mdta", x, scale, bias, w_qkv, t_qkv, temp, w_po,
                         w_kv, t_kv, w_pof)
    cph = c // num_heads
    if c % 16 or c % num_heads or cph not in (8, 16, 32):
        raise ValueError(f"ln_mdta: C={c} with {num_heads} heads; the "
                         "kernels take C a multiple of 16 and 8, 16 or 32 "
                         "channels a head")
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
    return y


# launches of the CUDA kernel(s), by (C, H, W); the CPU path adds none
ln_mdta.launches = collections.Counter()
