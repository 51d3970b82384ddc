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

The forward kernel is tile-local (a block owns a pixel tile, its 1-pixel
halo and a range of the hidden chunks) with its 1x1 products on the tensor
cores; ``fwd_tile_shape`` and ``fwd_splits`` choose its tile and how many
blocks share a tile's hidden width.  On CUDA the forward is ``LnGdfnFn``,
whose backward launches ``csrc/ln_gdfn_bwd.cu`` (the VJP of the JAX
package's ``fused_gdfn_banded.py:517 _bwd_call`` and ``fused_block.py:663``;
tile-local too, the forward's half of its tile shared through
``csrc/gdfn.cuh``).  Both read the f32 weights as bf16 hi/lo planes in
``kernel_operands``' layout, which the forward makes on the card once a call
and saves for the backward with x, as the TPU VJP saves x and the
weights.  ``ln_gdfn_bwd`` is that backward's
wrapper and ``ln_gdfn_bwd_plain`` its plain version (autograd through
``ln_gdfn_plain``).

The forward is the ``torch.library`` custom op ``torch.ops.uir.ln_gdfn``
(y and the weights' operands; the kernel on the card, the plain version
and ``kernel_operands`` on the CPU, a fake implementation for tracing),
which ``LnGdfnFn`` and the call without a gradient both go through, so
``torch.export`` records it as one node.
"""
from __future__ import annotations

import collections
import functools

import torch
import torch.nn.functional as F
from torch import Tensor
from torch.autograd.function import once_differentiable

from . import _kernels
from .layers import gelu, layer_norm_channels, wide


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
    t = dwconv3x3(conv1x1(wide(ln), wide(w_in)), wide(w_dw))
    t1, t2 = t[:, :hid], t[:, hid:]
    o = (gelu(t1) * t2).to(x.dtype)
    return x + conv1x1(wide(o), wide(w_out)).to(x.dtype)


# gate pairs a chunk of the kernel's weight layout; passed with every launch,
# and csrc/ln_gdfn.cu refuses any other value than its own G
GATE_CHUNK = 16


def padded_hidden(hid: int) -> int:
    """The hidden width zero-padded to a multiple of GATE_CHUNK (the
    kernels' hid_pad)."""
    return -(-hid // GATE_CHUNK) * GATE_CHUNK


def kernel_weights(w_in, w_dw, w_out):
    """The kernel's operands, hidden width zero-padded to hid_pad, a multiple
    of GATE_CHUNK, with the channels of chunk m ordered [t1 of the chunk,
    t2 of the chunk]: W_in (C, 2 * hid_pad), taps (2 * hid_pad, 9) with
    k = 3 * dh + dw, W_out (hid_pad, C).  Returns them and hid_pad."""
    c, g2 = w_in.shape
    hid = g2 // 2
    hp = padded_hidden(hid)
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


class Operands(collections.namedtuple(
        "Operands", "win_h win_l taps wo_h wo_l hid_pad")):
    """The kernels' weight operands (``kernel_operands``)."""


def kernel_operands(w_in, w_dw, w_out):
    """``kernel_weights`` with W_in and W_out as the bf16 hi/lo planes the
    tensor-core products read (``_kernels.split_bf16``): prepared once a
    call, for the forward and the backward."""
    win, taps, wo, hp = kernel_weights(w_in, w_dw, w_out)
    return Operands(*_kernels.split_bf16(win), taps,
                    *_kernels.split_bf16(wo), hp)


def unchunk(t, hid, dim):
    """Inverse of ``kernel_weights``'s layout along ``dim``: drop the
    zero-padded hidden channels and put the t1 and t2 halves back in order
    (2 * hid_pad -> 2 * hid)."""
    hp2 = t.shape[dim]
    shape = t.shape[:dim] + (hp2 // (2 * GATE_CHUNK), 2, GATE_CHUNK) + \
        t.shape[dim + 1:]
    t = t.reshape(shape)
    a, b = (t.select(dim + 1, i).flatten(dim, dim + 1).narrow(dim, 0, hid)
            for i in (0, 1))
    return torch.cat([a, b], dim)


# tiles the kernels may take, largest first, and the shared memory a block
# may use
BWD_TILES = ((16, 16), (8, 16), (8, 8), (4, 8), (4, 4))
FWD_TILES = ((16, 16), (8, 16), (8, 8), (4, 8))
MAX_SHARED = 227 * 1024
# the forward's project_out accumulators stay in registers: C (padded to
# 16) x tile pixels at most this many (32 a thread of its 256)
FWD_ACC = 8192
# blocks of the forward kernel a multiprocessor holds (its shared memory,
# about 70-105 KB in bf16, and its registers): fwd_splits fills this many
FWD_BLOCKS_PER_SM = 2
# dLN's f32 accumulators stay in registers: C (padded to 16) x tile pixels
# at most this many (16 a thread of the kernel's BWD_THREADS)
BWD_ACC = 8192
BWD_THREADS = 512


def _pad_ld(n: int) -> int:
    """csrc/mma.cuh pad_ld: a shared-memory row of n bf16 values, in
    elements, rounded to 16 bytes and an odd number of 16-byte units."""
    u = -(-n // 8)
    return 8 * u if u % 2 else 8 * u + 8


def _up16(n: int) -> int:
    return -(-n // 16) * 16


def bwd_shared_bytes(c: int, th: int, tw: int, itemsize: int) -> int:
    """Shared memory of one block of csrc/ln_gdfn_bwd.cu (its Smem layout,
    mirrored; each region 16-byte aligned): the LN patch on the 2-pixel halo
    and dy on the 1-pixel halo as bf16 planes (two in f32: hi/lo), C padded
    to 16, rows padded for the tensor-core loads; the chunk's W_in columns
    and W_out rows (hi and lo) in two buffers; f32 u and dt (whose room
    takes dLN and the LayerNorm backward's partial sums after the chunks);
    du (hi and lo) and the gate output (planes as LN); the tile's LN mean
    and rstd."""
    npl = 2 if itemsize == 4 else 1
    cp = _up16(c)
    np4, np2, p = (th + 4) * (tw + 4), (th + 2) * (tw + 2), th * tw
    g = GATE_CHUNK

    def al(n):
        return -(-n // 16) * 16

    ln = al(npl * cp * _pad_ld(_up16(np4)) * 2)
    dy = al(npl * cp * _pad_ld(_up16(np2 + 1)) * 2)
    wts = al(2 * (2 * cp * _pad_ld(2 * g) + 2 * g * _pad_ld(cp)) * 2)
    r1 = al(max(4 * 2 * g * (np4 + np2), 4 * (c * p + 2 * BWD_THREADS)))
    du = al(2 * 2 * g * _pad_ld(p) * 2)
    ov = al(npl * g * _pad_ld(p) * 2)
    return ln + dy + wts + r1 + du + ov + al(4 * 2 * p)


def bwd_tile_shape(c: int, itemsize: int) -> tuple[int, int]:
    """(TH, TW) of the backward kernel: the largest tile (least halo
    recompute) whose dLN accumulators fit the registers and whose shared
    memory fits a block (bf16: 16 x 16 up to C = 32, 8 x 16 at 64, 8 x 8 at
    128; f32: 16 x 16 at 16, 8 x 16 at 32 and 64, 4 x 8 at 128)."""
    for th, tw in BWD_TILES:
        if _up16(c) * th * tw <= BWD_ACC and \
                bwd_shared_bytes(c, th, tw, itemsize) <= MAX_SHARED:
            return th, tw
    raise ValueError(f"ln_gdfn_bwd: no tile fits C={c} in shared memory")


def fwd_shared_bytes(c: int, th: int, tw: int, itemsize: int) -> int:
    """Shared memory of one block of csrc/ln_gdfn.cu (its Smem layout,
    mirrored; each region 16-byte aligned): the LN patch on the 1-pixel halo
    as bf16 planes (two in f32: hi/lo), C padded to 16, rows padded for the
    tensor-core loads; f32 u of a chunk on the halo (with LN, the room of
    the f32 output tile [C][P] after the chunks); the chunk's W_in columns
    and W_out rows (hi and lo) in two buffers; the gate output (planes as
    LN)."""
    npl = 2 if itemsize == 4 else 1
    cp = _up16(c)
    np2, p = (th + 2) * (tw + 2), th * tw
    g = GATE_CHUNK

    def al(n):
        return -(-n // 16) * 16

    ln = al(npl * cp * _pad_ld(_up16(np2)) * 2)
    ub, acc = 4 * 2 * g * np2, 4 * c * p
    wts = al(2 * (2 * cp * _pad_ld(2 * g) + 2 * g * _pad_ld(cp)) * 2)
    return ln + al(max(ub, acc - ln)) + wts + al(npl * g * _pad_ld(p) * 2)


@functools.lru_cache(maxsize=None)
def fwd_tile_shape(c: int, itemsize: int) -> tuple[int, int]:
    """(TH, TW) of the forward kernel: the largest tile (least halo
    recompute) whose project_out accumulators fit the registers and whose
    shared memory fits a block (16 x 16 up to C = 32, 8 x 16 at 64, 8 x 8
    at 128, both dtypes)."""
    for th, tw in FWD_TILES:
        if _up16(c) * th * tw <= FWD_ACC and \
                fwd_shared_bytes(c, th, tw, itemsize) <= MAX_SHARED:
            return th, tw
    raise ValueError(f"ln_gdfn: no tile fits C={c} in shared memory")


def fwd_splits(tiles: int, hid_pad: int, sms: int = 132) -> int:
    """Blocks that share a tile's hidden chunks: as many as fit
    FWD_BLOCKS_PER_SM blocks a multiprocessor over ``tiles`` tiles in one
    wave (an H100 has 132), at least 1 and at most one a chunk.  Only the
    deep levels at small batch have so few tiles (C = 128 at 32x32, batch
    8: 128 tiles, 2 splits)."""
    return max(1, min(hid_pad // GATE_CHUNK,
                      FWD_BLOCKS_PER_SM * sms // tiles))


def _forward_cuda(x, scale, bias, w_in, w_dw, w_out, eps):
    """The forward's launches (``_launch``): y and the weights' operands
    (``kernel_operands``' layout, made on the card; the backward's too)."""
    y, planes, taps = _launch(x, scale, bias, w_in, w_dw, w_out, eps)
    return y, _operands(planes, taps, x.shape[1], w_out.shape[0])


def _operands(planes, taps, c, hid):
    """``Operands`` as views of the forward's bf16 planes (W_in hi and lo,
    W_out hi and lo, one after another) and f32 taps."""
    hp = padded_hidden(hid)
    n_in, n_out = c * 2 * hp, hp * c
    win_h, win_l, wo_h, wo_l = planes.split((n_in, n_in, n_out, n_out))
    return Operands(win_h, win_l, taps, wo_h, wo_l, hp)


def _launch(x, scale, bias, w_in, w_dw, w_out, eps):
    """The forward's launches: the weights' operands, the tile kernel, then,
    when the hidden width is split, the ordered sum of the splits' rows.
    Returns y, the operands' bf16 planes and the f32 taps."""
    _kernels.check_input("ln_gdfn", x, scale, bias, w_in, w_dw, w_out)
    b, c, h, w = x.shape
    lib = _kernels.library("ln_gdfn")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    hid = w_out.shape[0]
    hp = padded_hidden(hid)
    n_in, n_out = c * 2 * hp, hp * c
    planes = torch.empty(2 * (n_in + n_out), device=x.device,
                         dtype=torch.bfloat16)
    taps = torch.empty(2 * hp * 9, device=x.device, dtype=torch.float32)
    ops = _operands(planes, taps, c, hid)
    # held until the launch: a copy freed earlier could be handed to the
    # next copy (the model's weights are views) before the kernel reads it
    src = [t.float().contiguous() for t in (w_in, w_dw, w_out)]
    err = lib.uir_ln_gdfn_weights(
        *(t.data_ptr() for t in src), *(t.data_ptr() for t in ops[:5]), c,
        hid, hp, stream)
    _kernels.check(lib, err, "ln_gdfn weights")
    sc = scale.float().contiguous()
    bi = bias.float().contiguous()
    y = torch.empty_like(x)
    th, tw = fwd_tile_shape(c, x.element_size())
    tiles = b * -(-h // th) * -(-w // tw)
    splits = fwd_splits(tiles, ops.hid_pad, _kernels.sm_count(x.device))
    part = (torch.empty(splits * x.numel(), device=x.device,
                        dtype=torch.float32) if splits > 1 else None)
    err = lib.uir_ln_gdfn_fwd(
        x.data_ptr(), y.data_ptr(), 0 if part is None else part.data_ptr(),
        sc.data_ptr(), bi.data_ptr(), *(t.data_ptr() for t in ops[:5]), b,
        c, h, w, ops.hid_pad, GATE_CHUNK, int(x.dtype == torch.bfloat16), th,
        tw, splits, float(eps), stream)
    _kernels.check(lib, err, "ln_gdfn")
    ln_gdfn.launches[(c, h, w)] += 2 if splits == 1 else 3  # fwd_launches
    return y, planes, taps


@torch.library.custom_op("uir::ln_gdfn", mutates_args=(),
                         device_types="cuda")
def _ln_gdfn_op(x: Tensor, scale: Tensor, bias: Tensor, w_in: Tensor,
                w_dw: Tensor, w_out: Tensor,
                eps: float) -> tuple[Tensor, Tensor, Tensor]:
    """``torch.ops.uir.ln_gdfn``: (y, the weights' bf16 planes, the f32
    taps), the kernel on the card (``_launch``), the plain version and
    ``kernel_operands`` on the CPU."""
    return _launch(x, scale, bias, w_in, w_dw, w_out, eps)


@_ln_gdfn_op.register_kernel("cpu")
def _(x, scale, bias, w_in, w_dw, w_out, eps):
    ops = kernel_operands(w_in, w_dw, w_out)
    planes = torch.cat([t.reshape(-1) for t in
                        (ops.win_h, ops.win_l, ops.wo_h, ops.wo_l)])
    return (ln_gdfn_plain(x, scale, bias, w_in, w_dw, w_out, eps), planes,
            ops.taps.reshape(-1))


@_ln_gdfn_op.register_fake
def _(x, scale, bias, w_in, w_dw, w_out, eps):
    c, hp = x.shape[1], padded_hidden(w_out.shape[0])
    return (torch.empty_like(x),
            x.new_empty(2 * (c * 2 * hp + hp * c), dtype=torch.bfloat16),
            x.new_empty(2 * hp * 9, dtype=torch.float32))


def fwd_launches(b: int, h: int, w: int, c: int, hid_pad: int,
                 itemsize: int, sms: int = 132) -> int:
    """Launches of one forward call: the weights' operands, the tile
    kernel, and the sum of the splits' rows when ``fwd_splits`` splits the
    hidden width."""
    th, tw = fwd_tile_shape(c, itemsize)
    tiles = b * -(-h // th) * -(-w // tw)
    return 2 if fwd_splits(tiles, hid_pad, sms) == 1 else 3



def ln_gdfn_bwd_plain(x, dy, scale, bias, w_in, w_dw, w_out,
                      eps: float = 1e-5):
    """Gradients of ``ln_gdfn_plain`` at (x, weights) for the cotangent dy,
    by autograd: (dx, dscale, dbias, dw_in, dw_dw, dw_out)."""
    ins = [t.detach().requires_grad_() for t in
           (x, scale, bias, w_in, w_dw, w_out)]
    with torch.enable_grad():
        y = ln_gdfn_plain(*ins, eps=eps)
        return torch.autograd.grad(y, ins, dy)


def ln_gdfn_bwd(x, dy, scale, bias, w_in, w_dw, w_out, eps: float = 1e-5):
    """The LN+GDFN backward's CUDA kernel, on CUDA tensors.  Returns (dx,
    dscale, dbias, dw_in, dw_dw, dw_out), dx in x.dtype and the rest f32."""
    b, c, h, w = x.shape
    _kernels.check_input("ln_gdfn_bwd", x, dy, scale, bias, w_in, w_dw,
                         w_out)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError("ln_gdfn_bwd: dy must match x in shape and dtype")
    if c % 8:
        raise ValueError(f"ln_gdfn_bwd: C={c} must be a multiple of 8")
    return _backward_cuda(x, dy, scale, bias,
                          kernel_operands(w_in, w_dw, w_out), w_out.shape[0],
                          eps)


def _backward_cuda(x, dy, scale, bias, ops, hid, eps):
    """The backward's launches over prepared operands (``kernel_operands``):
    the tile kernel, then the ordered sum of the blocks' rows."""
    b, c, h, w = x.shape
    lib = _kernels.library("ln_gdfn_bwd")
    hp = ops.hid_pad
    sc = scale.float().contiguous()
    bi = bias.float().contiguous()
    dy = dy.contiguous()
    th, tw = bwd_tile_shape(c, x.element_size())
    groups = _kernels.block_rows(b * -(-h // th) * -(-w // tw), x.device)
    sizes = (c * 2 * hp, 2 * hp * 9, hp * c, c, c)
    part = torch.empty(groups * sum(sizes), device=x.device,
                       dtype=torch.float32)
    grads = torch.empty(sum(sizes), device=x.device, dtype=torch.float32)
    dx = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.uir_ln_gdfn_bwd(
        x.data_ptr(), dy.data_ptr(), dx.data_ptr(), sc.data_ptr(),
        bi.data_ptr(), *(t.data_ptr() for t in ops[:5]), part.data_ptr(),
        grads.data_ptr(), b, c, h, w, hp, GATE_CHUNK,
        int(x.dtype == torch.bfloat16), th, tw, groups, float(eps), stream)
    _kernels.check(lib, err, "ln_gdfn_bwd")
    ln_gdfn_bwd.launches[(c, h, w)] += 2  # tiles, then the row sum
    g_win, g_taps, g_wo, dsc, dbi = grads.split(sizes)
    dw_in = unchunk(g_win.view(c, 2 * hp), hid, 1)
    dw_dw = unchunk(g_taps.view(2 * hp, 9), hid, 0).t().reshape(3, 3,
                                                                 2 * hid)
    return (dx, dsc, dbi, dw_in, dw_dw, g_wo.view(hp, c)[:hid])


class LnGdfnFn(torch.autograd.Function):
    """The CUDA forward (``torch.ops.uir.ln_gdfn``) with the CUDA backward;
    saves x, the LayerNorm's affine and the weights' operands (made once a
    call for both)."""

    @staticmethod
    def forward(ctx, x, scale, bias, w_in, w_dw, w_out, eps):
        y, planes, taps = torch.ops.uir.ln_gdfn(x, scale, bias, w_in, w_dw,
                                                w_out, eps)
        ctx.eps, ctx.hid = eps, w_out.shape[0]
        ctx.dtypes = tuple(t.dtype for t in (scale, bias, w_in, w_dw, w_out))
        ctx.save_for_backward(x, scale, bias, planes, taps)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, scale, bias, planes, taps = ctx.saved_tensors
        if dy.shape != x.shape or dy.dtype != x.dtype:
            raise ValueError("ln_gdfn_bwd: dy must match x in shape and "
                             "dtype")
        grads = _backward_cuda(x, dy, scale, bias,
                               _operands(planes, taps, x.shape[1], ctx.hid),
                               ctx.hid, ctx.eps)
        return (grads[0],) + tuple(g.to(dt) for g, dt in
                                   zip(grads[1:], ctx.dtypes)) + (None,)


def ln_gdfn(x, scale, bias, w_in, w_dw, w_out, eps: float = 1e-5):
    """``x + GDFN(LayerNorm(x))``: the CUDA kernels (forward and backward)
    for a CUDA tensor, the plain version for a CPU tensor.  Without a
    gradient to take, the forward on the card is the custom op
    ``torch.ops.uir.ln_gdfn`` alone; with one, ``LnGdfnFn``.  Under
    ``torch.export`` a call without a gradient is the op on the CPU too
    (what the program records)."""
    args = (x, scale, bias, w_in, w_dw, w_out)
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in args)
    if x.device.type == "cpu" and (grad or not torch.compiler.is_exporting()):
        return ln_gdfn_plain(*args, eps)
    if grad:
        return LnGdfnFn.apply(*args, eps)
    return torch.ops.uir.ln_gdfn(*args, eps)[0]


# launches of the CUDA kernel(s), by (C, H, W); the CPU path adds none
ln_gdfn.launches = collections.Counter()
ln_gdfn_bwd.launches = collections.Counter()


def ln_gdfn_rows(x, scale, bias, w_in, w_dw, w_out, eps: float = 1e-5,
                 cp=None, use_kernels: bool = True):
    """``ln_gdfn`` (or, without ``use_kernels``, ``ln_gdfn_plain``) of the
    rank's band of a row-sharded NCHW map (``cp``, a
    ``core.meshes.ContextParallel``; the whole map without it): the band
    with one row of each neighbouring rank's (none past the map's edge,
    where the kernel zero-pads as the whole map's call does), its result
    cropped to the band.  The 3x3 taps of a band row read the halo rows'
    hidden values, so the band's rows are the whole map's.  In the backward
    the crop gives the halo rows a zero cotangent; the kernel's dx on them
    is what the neighbour's rows are owed through the taps, and the halo
    exchange's adjoint adds it there; the weight gradients are the band's
    share (the train step sums them over the ranks)."""
    fn = ln_gdfn if use_kernels else ln_gdfn_plain
    args = (scale, bias, w_in, w_dw, w_out)
    if cp is None or cp.size == 1:
        return fn(x, *args, eps=eps)
    from ..parallel.context import halo_rows

    ext, top = halo_rows(x, 1, 1, cp, dim=2, zeros=False)
    y = fn(ext.contiguous(), *args, eps=eps)
    return y[:, :, top:top + x.shape[2]].contiguous()
