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

``ln_leff`` launches ``csrc/ln_leff.cu`` for a CUDA tensor (four launches
a slice of the batch: LN, fc1 and fc2 on the tensor cores, g2's 3x3 window
between them; ``fwd_plan`` sizes the slices) and takes the plain version
``ln_leff_plain`` for a CPU one.  The rounding points are the
TPU kernel's: the LN output rounds to x.dtype; fc1, the taps and fc2 sum in
f32 and round once, before their bias is added in x.dtype; each gelu acts in
f32 on the rounded value and rounds; the s_b scale acts in f32.  fc1, fc2
and the biases are cast to x.dtype, the taps stay f32.

On CUDA the forward is ``LnLeffFn``, which prepares the kernels' operands
once a call (``kernel_operands``) for both passes and whose backward launches
``csrc/ln_leff_bwd.cu`` (the VJP of the JAX package's ``fused_leff.py:337
_bwd_call``: tensor-core products over pixels x channels, the batch walked
in image slices, ``bwd_plan``); it saves x, the prepared operands and s,
never the hidden activations, and gives s no gradient, as the TPU VJP
does.  ``ln_leff_bwd`` is that backward's wrapper and ``ln_leff_bwd_plain``
its plain version (autograd through ``ln_leff_plain``).

The forward is the ``torch.library`` custom op ``torch.ops.uir.ln_leff``
(y and ``pack_operands``' two buffers; the kernels on the card, the plain
version on the CPU, a fake implementation for tracing), which ``LnLeffFn``
and the call without a gradient both go through, so ``torch.export``
records it as one node.
"""
from __future__ import annotations

import collections
from typing import Optional

import torch
import torch.nn.functional as F
from torch import Tensor
from torch.autograd.function import once_differentiable

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


# the kernels' products stage k in tiles of this depth (csrc/gemm.cuh BK);
# the hidden width is zero-padded to a multiple of it
HIDDEN_CHUNK = 32
# the forward's launches a slice of images (csrc/ln_leff.cu): LN, fc1, g2's
# 3x3 window, fc2
FWD_LAUNCHES = 4
# a slice's forward workspace (LN, g1, g2) stays within this many bytes
FWD_WORKSPACE_BYTES = 256 << 20


def _pad_last(t, n, dim=-1):
    """t zero-padded by n along ``dim`` (-1 or 0); t itself when n = 0."""
    if n == 0:
        return t
    return F.pad(t, (0, n) if dim == -1 else (0, 0, 0, n))


def kernel_weights(w1, b1, w_dw, b_dw, w2, b2, dtype):
    """The kernels' operands, contiguous: fc1 ``(C, hid_pad)`` and fc2
    ``(hid_pad, C)`` in ``dtype``; fc1's bias, the taps ``(9, hid_pad)``
    (k = 3 dh + dw), their bias and fc2's bias in f32 (the kernels round the
    biases to ``dtype`` where they add them; the taps stay f32); the hidden
    width zero-padded to a multiple of HIDDEN_CHUNK (no copy when it is
    one): a zero fc1 column and bias give gelu(0) = 0 through the taps, and
    a zero fc2 row adds nothing.  Returns them and hid_pad."""
    hid = w1.shape[1]
    pad = -hid % HIDDEN_CHUNK
    ops = (_pad_last(w1.to(dtype), pad), _pad_last(b1.float(), pad),
           _pad_last(w_dw.float().reshape(9, hid), pad),
           _pad_last(b_dw.float(), pad), _pad_last(w2.to(dtype), pad, 0),
           b2.float())
    return tuple(t.contiguous() for t in ops) + (hid + pad,)


class Operands(collections.namedtuple(
        "Operands", "w1h w1l b1 taps bdw w2h w2l b2 w1x w2x hid_pad")):
    """The kernels' weight operands (``kernel_operands``): fc1 and fc2 as
    bf16 planes (hi, mid as w1l/w2l, lo as w1x/w2x), then hid_pad."""


def pack_operands(w1, b1, w_dw, b_dw, w2, b2, dtype):
    """``kernel_weights`` packed into two buffers: fc1 and fc2 as three bf16
    planes each (``_kernels.split_bf16``: hi, mid, lo of fc1, then of fc2),
    and fc1's bias, the taps, their bias and fc2's bias in f32, each buffer
    one piece after another.  Returns (planes, f32 values, hid_pad)."""
    w1k, b1k, taps, bdwk, w2k, b2k, hp = kernel_weights(w1, b1, w_dw, b_dw,
                                                        w2, b2, dtype)
    planes = torch.cat([t.reshape(-1) for t in (
        *_kernels.split_bf16(w1k, 3), *_kernels.split_bf16(w2k, 3))])
    return planes, torch.cat([b1k, taps.reshape(-1), bdwk, b2k]), hp


def unpack_operands(planes, values, c, hid_pad):
    """``Operands`` as views of ``pack_operands``' two buffers."""
    n = c * hid_pad
    w1h, w1l, w1x, w2h, w2l, w2x = planes.split(n)
    b1, taps, bdw, b2 = values.split((hid_pad, 9 * hid_pad, hid_pad, c))
    return Operands(w1h.view(c, hid_pad), w1l.view(c, hid_pad), b1,
                    taps.view(9, hid_pad), bdw, w2h.view(hid_pad, c),
                    w2l.view(hid_pad, c), b2, w1x.view(c, hid_pad),
                    w2x.view(hid_pad, c), hid_pad)


def kernel_operands(w1, b1, w_dw, b_dw, w2, b2, dtype):
    """``kernel_weights`` with fc1 and fc2 as the bf16 planes the
    tensor-core products read (``_kernels.split_bf16``, three planes: the
    forward reads all three in f32, the backward hi and mid as its hi/lo
    pair; in bf16 they are exact and only hi is read): prepared once a
    call, for the forward and the backward (views of ``pack_operands``'
    buffers)."""
    planes, values, hp = pack_operands(w1, b1, w_dw, b_dw, w2, b2, dtype)
    return unpack_operands(planes, values, w1.shape[0], hp)


def _align256(n: int) -> int:
    return -(-n // 256) * 256


def fwd_workspace_bytes(imgs: int, h: int, w: int, c: int, hid_pad: int,
                        itemsize: int) -> int:
    """Bytes of the forward's workspace for a slice of ``imgs`` images
    (csrc/ln_leff.cu Layout, mirrored): LN (C a pixel) and g2 (hid) as bf16
    planes, three in f32 (hi, mid, lo), and g1 (hid, in the compute dtype),
    each piece 256-byte aligned."""
    p = imgs * h * w
    npl = 3 if itemsize == 4 else 1
    return (_align256(npl * 2 * p * c) + _align256(p * hid_pad * itemsize)
            + _align256(npl * 2 * p * hid_pad))


class FwdPlan(collections.namedtuple(
        "FwdPlan", "imgs slices workspace launches")):
    """How the forward walks a batch: images a slice, slices, workspace
    bytes, launches a call."""


def fwd_plan(b: int, h: int, w: int, c: int, hid_pad: int,
             itemsize: int) -> FwdPlan:
    """The fewest slices whose workspace stays within FWD_WORKSPACE_BYTES,
    the batch split evenly between them; an image whose own workspace
    exceeds it is a slice by itself."""
    one = fwd_workspace_bytes(1, h, w, c, hid_pad, itemsize)
    most = max(1, min(b, FWD_WORKSPACE_BYTES // one))
    while most > 1 and fwd_workspace_bytes(most, h, w, c, hid_pad,
                                           itemsize) > FWD_WORKSPACE_BYTES:
        most -= 1
    slices = -(-b // most)
    imgs = -(-b // slices)
    return FwdPlan(imgs, slices,
                   fwd_workspace_bytes(imgs, h, w, c, hid_pad, itemsize),
                   FWD_LAUNCHES * slices)


def _check(what, x, w1, w2, *weights):
    """What the kernels take: contiguous float32/bfloat16 (B, H, W, C)
    tokens on a CUDA device, C a multiple of 8 matching w1 (C, hid) and w2
    (hid, C), the weights on x's device, none of them a DTensor."""
    _kernels.check_plain(what, x, w1, w2, *weights)
    if x.device.type != "cuda":
        raise ValueError(f"{what}: the CUDA kernel takes a CUDA tensor, x "
                         f"is on {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: x must be float32 or bfloat16, not "
                        f"{x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{what}: x must be contiguous (B, H, W, C) tokens,"
                         f" got shape {tuple(x.shape)}")
    c = x.shape[3]
    if c % 8 or w1.shape[0] != c or tuple(w2.shape) != (w1.shape[1], c):
        raise ValueError(f"{what}: C={c} must be a multiple of 8 and match "
                         f"w1 {tuple(w1.shape)} and w2 {tuple(w2.shape)}")
    for t in (w1, w2, *weights):
        if t is not None and t.device != x.device:
            raise ValueError(f"{what}: weights on {t.device}, x on "
                             f"{x.device}")


def _scales(s, b, device):
    """The per-image scale as the kernels read it: (B,) f32, ones for
    None."""
    return (torch.ones(b, device=device) if s is None
            else s.float().reshape(b).contiguous())


def _forward_cuda(x, scale, bias, ops, s, eps, residual):
    """The forward's launches over prepared operands (``kernel_operands``)."""
    b, h, w, c = x.shape
    lib = _kernels.library("ln_leff")
    sc = scale.float().contiguous()
    bi = bias.float().contiguous()
    sb = None if s is None else _scales(s, b, x.device)
    plan = fwd_plan(b, h, w, c, ops.hid_pad, x.element_size())
    work = torch.empty(plan.workspace, device=x.device, dtype=torch.uint8)
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.uir_ln_leff_fwd(
        x.data_ptr(), y.data_ptr(), sc.data_ptr(), bi.data_ptr(),
        *(t.data_ptr() for t in ops[:-1]),
        0 if sb is None else sb.data_ptr(), work.data_ptr(), b, h, w, c,
        ops.hid_pad, int(residual), int(x.dtype == torch.bfloat16),
        plan.imgs, float(eps), stream)
    _kernels.check(lib, err, "ln_leff")
    ln_leff.launches[(c, h, w)] += plan.launches
    return y


def ln_leff_bwd_plain(x, dy, scale, bias, w1, b1, w_dw, b_dw, w2, b2, s=None,
                      eps: float = 1e-5, residual: bool = True):
    """Gradients of ``ln_leff_plain`` at (x, weights) for the cotangent dy,
    by autograd: (dx, dscale, dbias, dw1, db1, dw_dw, db_dw, dw2, db2).  s
    is held fixed (it gets no gradient)."""
    ins = [t.detach().requires_grad_() for t in
           (x, scale, bias, w1, b1, w_dw, b_dw, w2, b2)]
    with torch.enable_grad():
        y = ln_leff_plain(*ins, s=s, eps=eps, residual=residual)
        return torch.autograd.grad(y, ins, dy)


# the backward's launches a slice of images (csrc/ln_leff_bwd.cu): prep,
# fc1, dg2, the depthwise pass, the weight gradients, dLN with the
# LayerNorm backward, the ordered row sums
BWD_LAUNCHES = 7
# a slice's workspace (its hidden-wide intermediates and weight-gradient
# rows) stays within this many bytes; the batch is walked in slices
WORKSPACE_BYTES = 1 << 30
# the kernel's tiles, mirrored: the k depth of a staged operand tile (a
# split's pixels are a multiple of it), the dLN launch's pixels a block,
# and the weight-gradient launch's output tile (hidden x C)
BWD_K = 32
BWD_DLN_PIXELS = 32
BWD_WGRAD_TILE = (128, 64)
# the widest C whose dLN rows one block holds
BWD_MAX_C = 512
# image rows and columns a thread of the depthwise pass walks (a row of
# shares each such patch)
BWD_DW_ROWS = 2
BWD_DW_COLS = 64


def bwd_workspace_bytes(imgs: int, h: int, w: int, c: int, hid_pad: int,
                        itemsize: int, ks: int) -> int:
    """Bytes of the backward's workspace for a slice of ``imgs`` images
    (csrc/ln_leff_bwd.cu Layout, mirrored): LN statistics (2 f32 a pixel);
    LN and dyk (C a pixel) and g2 and round(dt1) (hid) as bf16 planes, two
    in f32 (hi/lo); t1 and g1 (hid, in the compute dtype) and dt2 (hid,
    f32); the weight-gradient rows (two products, a row a split of ``ks``
    pixels), the depthwise pass's rows (11 hid + C a patch of BWD_DW_ROWS
    image rows and BWD_DW_COLS columns) and dLN's (2 C a block of pixels).
    Each piece 256-byte aligned."""
    p = imgs * h * w
    rows = imgs * -(-h // BWD_DW_ROWS) * -(-w // BWD_DW_COLS)
    npl = 2 if itemsize == 4 else 1
    splits = -(-p // ks)
    blocks = -(-p // BWD_DLN_PIXELS)
    sizes = (8 * p, npl * 2 * p * c, npl * 2 * p * c,
             p * hid_pad * itemsize, p * hid_pad * itemsize, 4 * p * hid_pad,
             npl * 2 * p * hid_pad, npl * 2 * p * hid_pad,
             4 * 2 * splits * hid_pad * c, 4 * rows * 11 * hid_pad,
             4 * rows * c, 4 * blocks * 2 * c)
    return sum(_align256(n) for n in sizes)


def bwd_split_pixels(pixels: int, c: int, hid_pad: int, sms: int) -> int:
    """Pixels a split of the weight-gradient launch: enough splits that its
    blocks (two products of ceil(hid/128) x ceil(C/64) output tiles each)
    reach two a multiprocessor, a multiple of BWD_K."""
    th, tc = BWD_WGRAD_TILE
    tiles = -(-hid_pad // th) * -(-c // tc)
    splits = max(1, -(-sms // tiles))
    return -(-pixels // (splits * BWD_K)) * BWD_K


class BwdPlan(collections.namedtuple(
        "BwdPlan", "imgs slices split_pixels workspace launches")):
    """How the backward walks a batch: images a slice, slices, pixels a
    weight-gradient split, workspace bytes, launches a call."""


def bwd_plan(b: int, h: int, w: int, c: int, hid_pad: int, itemsize: int,
             sms: int = 132) -> BwdPlan:
    """The fewest slices whose workspace stays within WORKSPACE_BYTES, the
    batch split evenly between them (an H100 has 132 multiprocessors); an
    image whose own workspace exceeds it is a slice by itself."""
    for most in range(b, 1, -1):
        ks = bwd_split_pixels(most * h * w, c, hid_pad, sms)
        if bwd_workspace_bytes(most, h, w, c, hid_pad, itemsize, ks) <= \
                WORKSPACE_BYTES:
            break
    else:
        most = 1
    slices = -(-b // most)
    imgs = -(-b // slices)
    ks = bwd_split_pixels(imgs * h * w, c, hid_pad, sms)
    return BwdPlan(imgs, slices, ks,
                   bwd_workspace_bytes(imgs, h, w, c, hid_pad, itemsize, ks),
                   BWD_LAUNCHES * slices)


def bwd_row_size(c: int, hid_pad: int) -> int:
    """Floats of the gradients the kernel writes: dw1, db1, the taps
    (hid_pad, 9), db_dw, dw2, db2, dscale, dbias."""
    return 2 * c * hid_pad + 11 * hid_pad + 3 * c


def _backward_cuda(x, dy, scale, bias, ops, hid, s, eps, residual):
    """The backward's launches over prepared operands (``kernel_operands``):
    the gradients as ``ln_leff_bwd`` returns them."""
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError("ln_leff_bwd: dy must match x in shape and dtype")
    b, h, w, c = x.shape
    if c > BWD_MAX_C:
        raise ValueError(f"ln_leff_bwd: C={c} is wider than {BWD_MAX_C}")
    hp = ops.hid_pad
    lib = _kernels.library("ln_leff_bwd")
    sc = scale.float().contiguous()
    bi = bias.float().contiguous()
    sb = _scales(s, b, x.device)
    dy = dy.contiguous()
    plan = bwd_plan(b, h, w, c, hp, x.element_size(),
                    _kernels.sm_count(x.device))
    work = torch.empty(plan.workspace, device=x.device, dtype=torch.uint8)
    grads = torch.empty(bwd_row_size(c, hp), device=x.device,
                        dtype=torch.float32)
    dx = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.uir_ln_leff_bwd(
        x.data_ptr(), dy.data_ptr(), dx.data_ptr(), sc.data_ptr(),
        bi.data_ptr(), ops.w1h.data_ptr(), ops.w1l.data_ptr(),
        ops.b1.data_ptr(), ops.taps.data_ptr(), ops.bdw.data_ptr(),
        ops.w2h.data_ptr(), ops.w2l.data_ptr(), sb.data_ptr(),
        work.data_ptr(), grads.data_ptr(), b, h, w, c, hp, int(residual),
        int(x.dtype == torch.bfloat16), plan.imgs, plan.split_pixels,
        float(eps), stream)
    _kernels.check(lib, err, "ln_leff_bwd")
    ln_leff_bwd.launches[(c, h, w)] += plan.launches
    g_w1, g_b1, g_taps, g_bdw, g_w2, g_b2, dsc, dbi = grads.split(
        (c * hp, hp, 9 * hp, hp, hp * c, c, c, c))
    return (dx, dsc, dbi, g_w1.view(c, hp)[:, :hid].contiguous(), g_b1[:hid],
            g_taps.view(hp, 9)[:hid].t().reshape(3, 3, hid), g_bdw[:hid],
            g_w2.view(hp, c)[:hid], g_b2)


def ln_leff_bwd(x, dy, scale, bias, w1, b1, w_dw, b_dw, w2, b2, s=None,
                eps: float = 1e-5, residual: bool = True):
    """The LN+LeFF backward's CUDA kernels, on CUDA tensors.  Returns (dx,
    dscale, dbias, dw1, db1, dw_dw, db_dw, dw2, db2): dx in x.dtype, the rest
    f32 in the arguments' shapes (the hidden padding dropped)."""
    _check("ln_leff_bwd", x, w1, w2, dy, scale, bias, b1, w_dw, b_dw, b2, s)
    ops = kernel_operands(w1, b1, w_dw, b_dw, w2, b2, x.dtype)
    return _backward_cuda(x, dy, scale, bias, ops, w1.shape[1], s, eps,
                          residual)


@torch.library.custom_op("uir::ln_leff", mutates_args=(),
                         device_types="cuda")
def _ln_leff_op(x: Tensor, scale: Tensor, bias: Tensor, w1: Tensor,
                b1: Tensor, w_dw: Tensor, b_dw: Tensor, w2: Tensor,
                b2: Tensor, s: Optional[Tensor], eps: float,
                residual: bool) -> tuple[Tensor, Tensor, Tensor]:
    """``torch.ops.uir.ln_leff``: (y, then ``pack_operands``' two buffers),
    the kernels on the card, the plain version on the CPU."""
    _check("ln_leff", x, w1, w2, scale, bias, b1, w_dw, b_dw, b2, s)
    planes, values, hp = pack_operands(w1, b1, w_dw, b_dw, w2, b2, x.dtype)
    y = _forward_cuda(x, scale, bias,
                      unpack_operands(planes, values, x.shape[3], hp), s, eps,
                      residual)
    return y, planes, values


@_ln_leff_op.register_kernel("cpu")
def _(x, scale, bias, w1, b1, w_dw, b_dw, w2, b2, s, eps, residual):
    planes, values, _ = pack_operands(w1, b1, w_dw, b_dw, w2, b2, x.dtype)
    return (ln_leff_plain(x, scale, bias, w1, b1, w_dw, b_dw, w2, b2, s, eps,
                          residual), planes, values)


@_ln_leff_op.register_fake
def _(x, scale, bias, w1, b1, w_dw, b_dw, w2, b2, s, eps, residual):
    c, hp = x.shape[3], -(-w1.shape[1] // HIDDEN_CHUNK) * HIDDEN_CHUNK
    return (torch.empty_like(x),
            x.new_empty(6 * c * hp, dtype=torch.bfloat16),
            x.new_empty(11 * hp + c, dtype=torch.float32))


class LnLeffFn(torch.autograd.Function):
    """The CUDA forward (``torch.ops.uir.ln_leff``, which prepares the
    kernels' operands once a call) with the CUDA backward; saves x, the
    operands and s.  Gradients come back for the Function's own inputs (the
    views ``LeFF.operands()`` passes), f32 for f32 parameters; none for
    s."""

    @staticmethod
    def forward(ctx, x, scale, bias, w1, b1, w_dw, b_dw, w2, b2, s, eps,
                residual):
        y, planes, values = torch.ops.uir.ln_leff(
            x, scale, bias, w1, b1, w_dw, b_dw, w2, b2, s, eps, residual)
        ctx.eps, ctx.residual, ctx.hid = eps, residual, w1.shape[1]
        ctx.dtypes = tuple(t.dtype for t in (scale, bias, w1, b1, w_dw,
                                              b_dw, w2, b2))
        ctx.save_for_backward(x, scale, bias, s, planes, values)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, scale, bias, s, planes, values = ctx.saved_tensors
        hp = -(-ctx.hid // HIDDEN_CHUNK) * HIDDEN_CHUNK
        grads = _backward_cuda(x, dy, scale, bias,
                               unpack_operands(planes, values, x.shape[3],
                                               hp),
                               ctx.hid, s, ctx.eps, ctx.residual)
        return ((grads[0],) + tuple(g.to(d) for g, d in
                                    zip(grads[1:], ctx.dtypes)) + (None,) * 3)


def ln_leff(x, scale, bias, w1, b1, w_dw, b_dw, w2, b2, s=None,
            eps: float = 1e-5, residual: bool = True):
    """``x + s_b * LeFF(LayerNorm(x))`` on (B, H, W, C): the CUDA kernels
    (forward and backward) for a CUDA tensor, the plain version for a CPU
    tensor.  Without a gradient to take, the forward on the card is the
    custom op ``torch.ops.uir.ln_leff`` alone; with one, ``LnLeffFn``.
    Under ``torch.export`` a call without a gradient is the op on the CPU
    too (what the program records)."""
    args = (x, scale, bias, w1, b1, w_dw, b_dw, w2, b2)
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in args)
    if x.device.type == "cpu" and (grad or not torch.compiler.is_exporting()):
        return ln_leff_plain(*args, s, eps, residual)
    if grad:
        return LnLeffFn.apply(*args, s, eps, residual)
    return torch.ops.uir.ln_leff(*args, s, eps, residual)[0]


# launches of the CUDA kernels, by (C, H, W); the CPU path adds none
ln_leff.launches = collections.Counter()
ln_leff_bwd.launches = collections.Counter()


def ln_leff_rows(x, scale, bias, w1, b1, w_dw, b_dw, w2, b2, s=None,
                 eps: float = 1e-5, residual: bool = True, cp=None,
                 fn=None):
    """``fn`` (``ln_leff``, the default, or ``ln_leff_plain``) of the
    rank's band of a row-sharded map (``cp``, a
    ``core.meshes.ContextParallel``; the whole map without it): the band
    with one row of each neighbouring rank's (none past the map's edge, where
    the kernel zero-pads g1 as the whole map's call does), its result
    cropped to the band.  The 3x3 taps of a band row read the halo rows'
    g1, so the band's rows are the whole map's.  In the backward the crop
    gives the halo rows a zero cotangent; the kernel's dx on them is what
    the neighbour's rows are owed through the taps, and the halo exchange's
    adjoint adds it there; the weight gradients are the band's share (the
    train step sums them over the ranks)."""
    fn = ln_leff if fn is None else fn
    args = (scale, bias, w1, b1, w_dw, b_dw, w2, b2)
    if cp is None or cp.size == 1:
        return fn(x, *args, s=s, eps=eps, residual=residual)
    from ..parallel.context import halo_rows

    ext, top = halo_rows(x, 1, 1, cp, dim=1, zeros=False)
    y = fn(ext.contiguous(), *args, s=s, eps=eps, residual=residual)
    return y[:, top:top + x.shape[1]].contiguous()
