"""LN + LeFF forward: ``y = x + s_b * LeFF(LayerNorm_C(x))`` with
``LeFF(z) = fc2(gelu(dw3x3(gelu(fc1(z)))))``, the token-MLP half of an AST
block, on channels-last tokens ``(B, H, W, C)``.

Counterpart of the JAX package's ``ops/fused_leff.py:429 fused_ln_leff``
(the TPU kernel ``_fwd_call:301``), with its argument layouts: scale/bias
``(C,)``, w1 ``(C, hid)``, b1 ``(hid,)``, w_dw ``(3, 3, hid)``, b_dw
``(hid,)``, w2 ``(hid, C)``, b2 ``(C,)``, s ``(B,)`` f32 (None: ones; the
per-image DropPath scale), ``residual=False`` returning the scaled branch
alone.  The TPU kernel took channels-first ``(B, C, H, W)``; the port's AST
keeps its tokens channels-last, so the kernel reads them as they are.

``ln_leff`` launches ``csrc/ln_leff.cu`` for a CUDA tensor and takes the
plain version ``ln_leff_plain`` for a CPU one.  The rounding points are the
TPU kernel's: the LN output rounds to x.dtype; fc1, the taps and fc2 sum in
f32 and round once, before their bias is added in x.dtype; each gelu acts in
f32 on the rounded value and rounds; the s_b scale acts in f32.  fc1, fc2
and the biases are cast to x.dtype, the taps stay f32.

There is no backward kernel yet (TPU kernel row 12 comes with the AST train
step), so the CUDA route refuses inputs that would need a gradient rather
than return a result detached from them.
"""
from __future__ import annotations

import collections

import torch
import torch.nn.functional as F

from . import _kernels
from .layers import gelu, layer_norm_last


def ln_leff_plain(x, scale, bias, w1, b1, w_dw, b_dw, w2, b2, s=None,
                  eps: float = 1e-5, residual: bool = True):
    """Plain PyTorch version of the kernel (the CPU path and the kernel's
    reference on the card)."""
    dt = x.dtype
    hid = w1.shape[1]
    ln = layer_norm_last(x, scale, bias, eps)
    t1 = torch.matmul(ln.float(), w1.to(dt).float()).to(dt) + b1.to(dt)
    g1 = gelu(t1.float()).to(dt)
    t2 = F.conv2d(g1.float().permute(0, 3, 1, 2),
                  w_dw.float().permute(2, 0, 1)[:, None], padding=1,
                  groups=hid).permute(0, 2, 3, 1)
    g2 = gelu((t2.to(dt) + b_dw.to(dt)).float()).to(dt)
    yd = torch.matmul(g2.float(), w2.to(dt).float()).to(dt) + b2.to(dt)
    if s is not None:
        yd = (yd.float() * s.float().view(-1, 1, 1, 1)).to(dt)
    return x + yd if residual else yd


# hidden channels a chunk of the kernel; passed with every launch, and
# csrc/ln_leff.cu refuses any other value than its own G
HIDDEN_CHUNK = 32


# tiles a block may take, largest first, and the shared memory it may use
TILES = ((8, 8), (4, 8), (4, 4), (2, 4), (2, 2))
MAX_SHARED = 227 * 1024


def shared_bytes(c: int, th: int, tw: int, itemsize: int) -> int:
    """Shared memory of one block of csrc/ln_leff.cu (its layout, mirrored):
    f32 accumulators (C, P|1), gelu(fc1) (G, NP), gelu(dw) (G, P), the
    chunk's fc1 columns and fc2 rows (2 C G, f32), and the LN halo patch
    (C, NP|1) in the compute dtype; P = TH TW, NP = (TH+2)(TW+2)."""
    p, np_ = th * tw, (th + 2) * (tw + 2)
    g = HIDDEN_CHUNK
    return (4 * (c * (p | 1) + g * np_ + g * p + 2 * c * g)
            + itemsize * c * (np_ | 1))


def tile_shape(c: int, itemsize: int) -> tuple[int, int]:
    """(TH, TW) of one thread block: 8 x 8, or the largest smaller tile
    whose accumulators hold at most 16384 values and whose shared memory
    fits a block (bf16: 8 x 8 up to C = 256, 4 x 4 at 512; f32: 4 x 8 at
    256, 2 x 4 at 512).  Larger tiles recompute less of the halo but leave
    fewer blocks on the card."""
    for th, tw in TILES:
        if th * tw * c <= 16384 and shared_bytes(c, th, tw, itemsize) <= \
                MAX_SHARED:
            return th, tw
    raise ValueError(f"ln_leff: no tile fits C={c} in shared memory")


def kernel_weights(w1, b1, w_dw, b_dw, w2, b2, dtype):
    """The kernel's operands, contiguous: fc1 ``(C, hid_pad)`` and fc2
    ``(hid_pad, C)`` in ``dtype``; fc1's bias, the taps ``(9, hid_pad)``
    (k = 3 dh + dw), their bias and fc2's bias in f32, the biases rounded to
    ``dtype`` (the taps are not); the hidden width zero-padded to a multiple
    of HIDDEN_CHUNK: a zero fc1 column and bias give gelu(0) = 0 through the
    taps, and a zero fc2 row adds nothing.  Returns them and hid_pad."""
    hid = w1.shape[1]
    pad = -hid % HIDDEN_CHUNK

    def r(t):
        return t.to(dtype).float()

    ops = (F.pad(w1.to(dtype), (0, pad)), F.pad(r(b1), (0, pad)),
           F.pad(w_dw.float().reshape(9, hid), (0, pad)),
           F.pad(r(b_dw), (0, pad)), F.pad(w2.to(dtype), (0, 0, 0, pad)),
           r(b2))
    return tuple(t.contiguous() for t in ops) + (hid + pad,)


def _forward_cuda(x, scale, bias, w1, b1, w_dw, b_dw, w2, b2, s, eps,
                  residual):
    if x.device.type != "cuda":
        raise ValueError(f"ln_leff: the CUDA kernel takes a CUDA tensor, x "
                         f"is on {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ln_leff: x must be float32 or bfloat16, not "
                        f"{x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"ln_leff: x must be contiguous (B, H, W, C) tokens,"
                         f" got shape {tuple(x.shape)}")
    b, h, w, c = x.shape
    if c % 8 or w1.shape[0] != c or tuple(w2.shape) != (w1.shape[1], c):
        raise ValueError(f"ln_leff: C={c} must be a multiple of 8 and match "
                         f"w1 {tuple(w1.shape)} and w2 {tuple(w2.shape)}")
    for t in (scale, bias, w1, b1, w_dw, b_dw, w2, b2, s):
        if t is not None and t.device != x.device:
            raise ValueError(f"ln_leff: weights on {t.device}, x on "
                             f"{x.device}")
    lib = _kernels.library("ln_leff")
    *ops, hp = kernel_weights(w1, b1, w_dw, b_dw, w2, b2, x.dtype)
    sc = scale.float().contiguous()
    bi = bias.float().contiguous()
    sb = (torch.ones(b, device=x.device) if s is None
          else s.float().reshape(b).contiguous())
    y = torch.empty_like(x)
    th, tw = tile_shape(c, x.element_size())
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.uir_ln_leff_fwd(
        x.data_ptr(), y.data_ptr(), sc.data_ptr(), bi.data_ptr(),
        *(t.data_ptr() for t in ops), sb.data_ptr(), b, h, w, c, hp,
        HIDDEN_CHUNK, int(residual), int(x.dtype == torch.bfloat16), th, tw,
        float(eps), stream)
    _kernels.check(lib, err, "ln_leff")
    ln_leff.launches[(c, h, w)] += 1
    return y


def ln_leff(x, scale, bias, w1, b1, w_dw, b_dw, w2, b2, s=None,
            eps: float = 1e-5, residual: bool = True):
    """``x + s_b * LeFF(LayerNorm(x))`` on (B, H, W, C): the CUDA kernel for
    a CUDA tensor, the plain version for a CPU tensor."""
    if x.device.type == "cpu":
        return ln_leff_plain(x, scale, bias, w1, b1, w_dw, b_dw, w2, b2, s,
                             eps, residual)
    ins = (x, scale, bias, w1, b1, w_dw, b_dw, w2, b2, s)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in ins):
        raise RuntimeError(
            "ln_leff: the CUDA kernel has no backward yet (the LN+LeFF "
            "backward is TPU kernel row 12, ROADMAP.md), and its result "
            "would not carry gradients: run under torch.no_grad(), or take "
            "the plain version (use_kernels=False)")
    return _forward_cuda(x, scale, bias, w1, b1, w_dw, b_dw, w2, b2, s, eps,
                         residual)


# launches of the CUDA kernel, by (C, H, W); the CPU path adds none
ln_leff.launches = collections.Counter()
