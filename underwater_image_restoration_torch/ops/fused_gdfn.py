"""LN + GDFN forward: ``y = x + GDFN(LayerNorm_C(x))`` on channels-first
``(B, C, H, W)``, the second half of a SpectralBlock.

Counterpart of the JAX package's ``ops/fused_gdfn_banded.py:607
fused_ln_gdfn_banded`` with the same argument layouts: scale/bias ``(C,)``,
w_in ``(C, 2*hid)``, w_dw ``(3, 3, 2*hid)``, w_out ``(hid, C)``.

``ln_gdfn`` launches the CUDA kernel ``csrc/ln_gdfn.cu`` for a CUDA tensor and
takes the plain version ``ln_gdfn_plain`` for a CPU one.  Rounding points
follow the TPU kernel: the LN output, the gated product and project_out's
output round to x.dtype; project_in and the taps act in f32 on the rounded
LN output (the composed contraction) and weights stay f32.
"""
from __future__ import annotations

import collections

import torch
import torch.nn.functional as F

from . import _kernels
from .layers import gelu, layer_norm_channels


def conv1x1(t, w):
    """1x1 conv of (B, Cin, H, W) with an (Cin, Cout) matrix."""
    return F.conv2d(t, w.t()[:, :, None, None])


def dwconv3x3(t, taps):
    """Zero-padded 3x3 depthwise conv with taps (3, 3, C)."""
    return F.conv2d(t, taps.permute(2, 0, 1)[:, None], padding=1,
                    groups=t.shape[1])


def ln_gdfn_plain(x, scale, bias, w_in, w_dw, w_out, eps: float = 1e-5):
    """Plain PyTorch version of the kernel (the CPU path and the kernel's
    reference on the card)."""
    hid = w_out.shape[0]
    ln = layer_norm_channels(x, scale, bias, eps)
    t = dwconv3x3(conv1x1(ln.float(), w_in.float()), w_dw.float())
    t1, t2 = t[:, :hid], t[:, hid:]
    o = (gelu(t1) * t2).to(x.dtype)
    return x + conv1x1(o.float(), w_out.float()).to(x.dtype)


def tile_shape(c: int) -> tuple[int, int]:
    """(TH, TW) of one thread block: 256 pixels up to C = 32, fewer above so
    the block's shared memory (LN patch and f32 accumulators, ~100-130 KB)
    stays under the 227 KB a block may use."""
    if c <= 32:
        return 16, 16
    if c <= 64:
        return 8, 16
    return 8, 8


# gate pairs a chunk of the kernel's weight layout; passed with every launch,
# and csrc/ln_gdfn.cu refuses any other value than its own G
GATE_CHUNK = 16


def kernel_weights(w_in, w_dw, w_out):
    """The kernel's operands, hidden width zero-padded to hid_pad, a multiple
    of GATE_CHUNK, with the channels of chunk m ordered [t1 of the chunk,
    t2 of the chunk]: W_in (C, 2 * hid_pad), taps (2 * hid_pad, 9) with
    k = 3 * dh + dw, W_out (hid_pad, C).  Returns them and hid_pad."""
    c, g2 = w_in.shape
    hid = g2 // 2
    hp = -(-hid // GATE_CHUNK) * GATE_CHUNK
    n = hp // GATE_CHUNK

    def chunked(t, dim):
        """Pad the t1 and t2 halves along dim to hp, interleave chunks."""
        a, b = t.float().split(hid, dim)
        pad = [0, 0] * (t.dim() - 1 - dim) + [0, hp - hid]
        a, b = F.pad(a, pad), F.pad(b, pad)
        shape = a.shape[:dim] + (n, 1, GATE_CHUNK) + a.shape[dim + 1:]
        out = torch.cat([a.reshape(shape), b.reshape(shape)], dim + 1)
        return out.reshape(a.shape[:dim] + (2 * hp,) + a.shape[dim + 1:])

    win = chunked(w_in, 1)
    taps = chunked(w_dw.reshape(9, g2).t(), 0)
    wo = F.pad(w_out.float(), [0, 0, 0, hp - hid])
    return win.contiguous(), taps.contiguous(), wo.contiguous(), hp


def ln_gdfn(x, scale, bias, w_in, w_dw, w_out, eps: float = 1e-5):
    """``x + GDFN(LayerNorm(x))``: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor."""
    if x.device.type == "cpu":
        return ln_gdfn_plain(x, scale, bias, w_in, w_dw, w_out, eps)
    b, c, h, w = x.shape
    _kernels.check_input("ln_gdfn", x, scale, bias, w_in, w_dw, w_out)
    lib = _kernels.library("ln_gdfn")
    win, taps, wo, hp = kernel_weights(w_in, w_dw, w_out)
    sc = scale.float().contiguous()
    bi = bias.float().contiguous()
    y = torch.empty_like(x)
    th, tw = tile_shape(c)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.uir_ln_gdfn_fwd(
        x.data_ptr(), y.data_ptr(), sc.data_ptr(), bi.data_ptr(),
        win.data_ptr(), taps.data_ptr(), wo.data_ptr(), b, c, h, w, hp,
        GATE_CHUNK, int(x.dtype == torch.bfloat16), th, tw, float(eps),
        stream)
    _kernels.check(lib, err, "ln_gdfn")
    ln_gdfn.launches[(c, h, w)] += 1
    return y


# launches of the CUDA kernel(s), by (C, H, W); the CPU path adds none
ln_gdfn.launches = collections.Counter()
