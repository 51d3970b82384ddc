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

``ln_mdta`` launches the CUDA kernels of ``csrc/ln_mdta.cu`` for a CUDA
tensor and takes ``ln_mdta_plain`` for a CPU one: tensor-core products over
the batch in image slices (``fwd_plan`` sizing them), the per-image gram in
rows over pixel ranges summed in order.  Rounding points follow the TPU
kernels: LN output, q and k, A·v, project_out's output, A·vf and
project_outf's output round to x.dtype; v and vf stay f32.

On CUDA the forward is ``LnMdtaFn``, whose backward launches
``csrc/ln_mdta_bwd.cu`` (the VJP of the JAX package's
``fused_attn_composed.py:574``, ``fused_attn_banded.py:707`` and
``fused_attn.py:560`` ``_bwd_call``): staged like the forward, whose stages
it shares (``csrc/mdta.cuh``), ``bwd_plan`` sizing its slices.  It saves x,
the weights and the per-image stats the forward wrote (gram and row sums of
squares), as the TPU VJP saves (x, G, Sq, Sk).  ``ln_mdta_bwd`` is that backward's wrapper
and ``ln_mdta_bwd_plain`` its plain version (autograd through
``ln_mdta_plain``); the dead ``kf`` half of w_kv / t_kv gets zeros.

The forward is the ``torch.library`` custom op ``torch.ops.uir.ln_mdta``
(y and the stats; the kernels on the card, ``_plain`` on the CPU, a fake
implementation for tracing), which ``LnMdtaFn`` and the call without a
gradient both go through, so ``torch.export`` records it as one node.

Context parallelism: ``ln_mdta_rows`` takes a rank's band of the map's rows.
A's gram and row sums of squares span every pixel, so the function is two
halves around a sum over the ranks: ``ln_mdta_stats`` (the band's own rows'
stats) and ``ln_mdta_apply`` (y from the summed stats), each the split
entries of ``csrc/ln_mdta.cu`` on the card and ``ln_mdta_stats_plain`` /
``ln_mdta_apply_plain`` on the CPU; with a gradient on the card,
``LnMdtaRowsFn``, whose backward (``ln_mdta_bwd_rows``) runs the
backward's two stages a slice at a time around the sum of dA.
"""
from __future__ import annotations

import collections

import torch
from torch import Tensor
from torch.autograd.function import once_differentiable

from . import _kernels
from .attention import channel_attention_core
from .fused_gdfn import conv1x1, dwconv3x3
from .layers import l2_normalize, layer_norm_channels, wide


def ln_mdta_plain(x, scale, bias, w_qkv, t_qkv, temp, w_po, w_kv, t_kv,
                  w_pof, num_heads: int, eps: float = 1e-5):
    """Plain PyTorch version of the kernels (the CPU path and the kernels'
    reference on the card)."""
    return _plain(x, scale, bias, w_qkv, t_qkv, temp, w_po, w_kv, t_kv,
                  w_pof, num_heads, eps)


def _plain(x, scale, bias, w_qkv, t_qkv, temp, w_po, w_kv, t_kv, w_pof,
           num_heads, eps, with_stats=False):
    """``ln_mdta_plain``; with ``with_stats``, (y, stats) with the stats the
    kernels write (each image's gram within the heads, Sq and Sk of
    round(q) and round(k), ``forward_with_stats``' layout)."""
    b, c, h, w = x.shape
    dt = x.dtype

    def heads(t):
        return t.reshape(b, num_heads, c // num_heads, h * w)

    ln = wide(layer_norm_channels(x, scale, bias, eps))
    qkv = dwconv3x3(conv1x1(ln, wide(w_qkv)), wide(t_qkv))
    q, k, v = qkv[:, :c], qkv[:, c:2 * c], qkv[:, 2 * c:]
    q, k = heads(wide(q.to(dt))), heads(wide(k.to(dt)))
    outs, attn = channel_attention_core(l2_normalize(q), l2_normalize(k),
                                        heads(v), temp)
    y = _apply_tail(x, outs, attn, w_po, w_kv, t_kv, w_pof, num_heads)
    if not with_stats:
        return y
    return y, _gram_stats(q, k).reshape(-1)


def _gram_stats(q, k):
    """(B, C cph + 2C): each image's gram within the heads, Sq and Sk of
    q and k (B, heads, cph, pixels)."""
    b = q.shape[0]
    gram = torch.einsum("bhil,bhjl->bhij", q, k).reshape(b, -1)
    return torch.cat([gram, q.square().sum(-1).reshape(b, -1),
                      k.square().sum(-1).reshape(b, -1)], 1)


def _apply_tail(x, outs, attn, w_po, w_kv, t_kv, w_pof, num_heads):
    """y from outs = A v and A (f32): project_out, the kv chain's vf, A vf,
    project_outf and the residual, rounding where the kernels round."""
    b, c, h, w = x.shape
    dt = x.dtype
    out = conv1x1(wide(outs.to(dt)).reshape(b, c, h, w), wide(w_po))
    vf = dwconv3x3(conv1x1(wide(out.to(dt)), wide(w_kv[:, c:])),
                   wide(t_kv[:, :, c:]))
    outf = torch.einsum("bhcd,bhdl->bhcl", attn,
                        vf.reshape(b, num_heads, c // num_heads, h * w))
    yf = conv1x1(wide(outf.to(dt)).reshape(b, c, h, w), wide(w_pof))
    return x + yf.to(dt)


def ln_mdta_stats_plain(x, scale, bias, w_qkv, t_qkv, num_heads: int,
                        r0: int, r1: int, eps: float = 1e-5):
    """The first half of ``ln_mdta_plain`` on a band of a row-sharded map
    (x the band with its halo rows): each image's stats (B, C cph + 2C),
    its gram within the heads, Sq and Sk of round(q) and round(k) over
    rows [r0, r1) of x (the band without its halo).  Summed over the ranks,
    they are the whole map's."""
    b, c = x.shape[:2]
    ln = wide(layer_norm_channels(x, scale, bias, eps))
    qk = dwconv3x3(conv1x1(ln, wide(w_qkv[:, :2 * c])),
                   wide(t_qkv[:, :, :2 * c]))
    qk = wide(qk[:, :, r0:r1].to(x.dtype)).reshape(
        b, 2, num_heads, c // num_heads, -1)
    return _gram_stats(qk[:, 0], qk[:, 1])


def ln_mdta_apply_plain(x, stats, scale, bias, w_qkv, t_qkv, temp, w_po,
                        w_kv, t_kv, w_pof, num_heads: int,
                        eps: float = 1e-5):
    """The second half: y from x and the stats it is given (the sum over
    the ranks), A = softmax(temp G rq rk^T) a head with rq =
    rsqrt(max(Sq, 1e-24)) as the kernels form it."""
    b, c, h, w = x.shape
    nh, cph = num_heads, c // num_heads
    ln = wide(layer_norm_channels(x, scale, bias, eps))
    v = dwconv3x3(conv1x1(ln, wide(w_qkv[:, 2 * c:])),
                  wide(t_qkv[:, :, 2 * c:]))
    v = v.reshape(b, nh, cph, h * w)
    stats = wide(stats.reshape(b, -1))
    cc = c * cph
    rq = torch.rsqrt(stats[:, cc:cc + c].clamp_min(1e-24))
    rk = torch.rsqrt(stats[:, cc + c:].clamp_min(1e-24))
    logits = (stats[:, :cc].reshape(b, nh, cph, cph)
              * rq.reshape(b, nh, cph, 1) * rk.reshape(b, nh, 1, cph)
              * wide(temp))
    attn = torch.softmax(logits, dim=-1)
    outs = torch.einsum("bhcd,bhdl->bhcl", attn, v)
    return _apply_tail(x, outs, attn, w_po, w_kv, t_kv, w_pof, nh)


def _check_heads(c, num_heads):
    cph = c // num_heads
    if c % 16 or c % num_heads or cph not in (8, 16, 32):
        raise ValueError(f"ln_mdta: C={c} with {num_heads} heads; the "
                         "kernels take C a multiple of 16 and 8, 16 or 32 "
                         "channels a head")
    return cph


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


# the backward's launches a slice of images (csrc/ln_mdta_bwd.cu): prep,
# A, u, the taps, outs, out, u_vf, the taps, outf, d_outf, dvf, the
# transposed taps, d_out, d_outs, dv, dA, the softmax backward, dq and dk,
# the transposed taps, two weight-gradient launches, dLN, the row sums; and
# once a call, the weights' bf16 planes
BWD_LAUNCHES = 23
# a slice's workspace (its pixel-major intermediates and rows) stays within
# this many bytes; the batch is walked in slices
BWD_WORKSPACE_BYTES = 512 << 20
# the kernel's tiles, mirrored: the k depth of a staged operand tile (a
# split's pixels are a multiple of it), the pixels a block of the prep and
# dLN launches, the columns of an image row a thread of the taps passes
# walks, the output tile of the K-over-pixels products, the widest C
BWD_K = 32
BWD_PIXELS = 32
BWD_TAPS_COLS = 64
BWD_WGRAD_TILE = 64
BWD_MAX_C = 256
# an image's dA product (and the forward's gram) is split over at most this
# many pixel ranges of about BWD_IMAGE_SPLIT pixels each
BWD_IMAGE_SPLITS = 32
BWD_IMAGE_SPLIT = 2048


def _align256(n: int) -> int:
    return -(-n // 256) * 256


def bwd_planes(itemsize: int) -> tuple[int, int]:
    """bf16 planes a value of the kernels' products takes (the forward's
    and the backward's): (rounded to the compute dtype, f32).  bf16: (1, 2), a T value exact, an f32 one a hi/lo
    pair; f32: (3, 3), every value to f32's precision (dtemp's sum cancels
    too far for hi/lo pairs)."""
    return (3, 3) if itemsize == 4 else (1, 2)


def _round_k(n: int) -> int:
    return -(-n // BWD_K) * BWD_K


def bwd_image_split_pixels(hw: int) -> int:
    """Pixels a split of an image's dA product (and of the forward's gram):
    at most BWD_IMAGE_SPLITS splits of about BWD_IMAGE_SPLIT pixels, a
    multiple of BWD_K."""
    splits = min(BWD_IMAGE_SPLITS, -(-hw // BWD_IMAGE_SPLIT))
    return _round_k(-(-hw // splits))


def bwd_split_pixels(pixels: int, c: int, sms: int) -> int:
    """Pixels a split of the weight-gradient products: enough splits that
    the widest launch (two products of ceil(C/64) x ceil(3C/64) tiles)
    reaches four blocks a multiprocessor, a multiple of BWD_K."""
    t = BWD_WGRAD_TILE
    tiles = 2 * -(-c // t) * -(-3 * c // t)
    splits = max(1, -(-4 * sms // tiles))
    return _round_k(-(-pixels // splits))


def bwd_workspace_bytes(imgs: int, h: int, w: int, c: int, itemsize: int,
                        ks: int, ksa: int) -> int:
    """Bytes of the backward's workspace for a slice of ``imgs`` images
    (csrc/ln_mdta_bwd.cu Layout, mirrored): the weights' planes (7 C^2
    values); LN statistics (2 f32 a pixel); pixel-major planes of C
    channels, ``bwd_planes`` bf16 planes of a value (in the compute dtype,
    or f32) or 4 bytes (f32 values): LN, dy, u (3C, f32), round(q),
    round(k) (2C), v (planes), outs, out, outf, d(u_vf) (planes), d_out, dv
    (f32); per image A (f32, and planes), M and M^T (planes) and alpha
    (2C); the rows of dA (two a split), of the weight gradients (a split of
    ``ks`` pixels), of the taps' gradients (a segment of BWD_TAPS_COLS
    columns of an image row) and of dscale and dbias (a block of
    BWD_PIXELS pixels); then a region of values dead before dq and dk are
    formed (u_vf, dvf (f32), vf (planes), d_outf, d_outs), which dq and dk
    (2C, in the compute dtype) and d(u_qkv) (3C, planes) reuse.  Each piece
    256-byte aligned."""
    hw = h * w
    p = imgs * hw
    npt, nf = bwd_planes(itemsize)
    pl, fs, fa = npt * 2 * p * c, nf * 2 * p * c, 4 * p * c
    cc = imgs * c * c
    splits_w = -(-p // ks)
    splits_a = -(-hw // ksa)
    segs = imgs * h * -(-w // BWD_TAPS_COLS)
    blocks = -(-p // BWD_PIXELS)
    sizes = (nf * 2 * 7 * c * c,
             8 * p, pl, pl, 3 * fa, 2 * pl, fs, pl, pl, pl, fs, pl, fa,
             4 * cc, *(nf * 2 * cc,) * 3, 4 * imgs * 2 * c,
             4 * cc * 2 * splits_a, 4 * splits_w * 2 * c * c,
             4 * splits_w * c * c, 4 * splits_w * 3 * c * c,
             4 * segs * 9 * c, 4 * segs * 27 * c, 4 * blocks * 2 * c)
    region = sum(_align256(n) for n in (fa, fa, fs, pl, pl))
    reuse = _align256(itemsize * p * 2 * c) + _align256(3 * fs)
    return sum(_align256(n) for n in sizes) + max(region, reuse)


class BwdPlan(collections.namedtuple(
        "BwdPlan", "imgs slices split_pixels image_split_pixels workspace "
        "launches")):
    """How the backward walks a batch: images a slice, slices, pixels a
    weight-gradient split, pixels a split of an image's dA, workspace
    bytes, launches a call."""


def bwd_plan(b: int, h: int, w: int, c: int, itemsize: int,
             sms: int = 132) -> BwdPlan:
    """The fewest slices whose workspace stays within BWD_WORKSPACE_BYTES,
    the batch split evenly between them (an H100 has 132
    multiprocessors); an image whose own workspace exceeds it is a slice by
    itself."""
    ksa = bwd_image_split_pixels(h * w)
    for most in range(b, 1, -1):
        ks = bwd_split_pixels(most * h * w, c, sms)
        if bwd_workspace_bytes(most, h, w, c, itemsize, ks, ksa) <= \
                BWD_WORKSPACE_BYTES:
            break
    else:
        most = 1
    slices = -(-b // most)
    imgs = -(-b // slices)
    ks = bwd_split_pixels(imgs * h * w, c, sms)
    return BwdPlan(imgs, slices, ks, ksa,
                   bwd_workspace_bytes(imgs, h, w, c, itemsize, ks, ksa),
                   BWD_LAUNCHES * slices + 1)


def bwd_row_size(c: int) -> int:
    """Floats of the weight gradients the kernel writes: dW_pof, the vf
    half of dW_kv, the vf taps (C, 9), dW_po, dW_qkv, the qkv taps (3C, 9),
    dscale, dbias."""
    return 6 * c * c + 38 * c


# the forward's launches a slice of images (csrc/ln_mdta.cu): prep, u, the
# taps, the gram, the stats and A, outs, out, u_vf, the taps, outf, y; and
# once a call, the weights' bf16 planes
FWD_LAUNCHES = 11
# a slice's forward workspace stays within this many bytes
FWD_WORKSPACE_BYTES = 256 << 20


def fwd_workspace_bytes(imgs: int, h: int, w: int, c: int, itemsize: int,
                        ksa: int) -> int:
    """Bytes of the forward's workspace for a slice of ``imgs`` images
    (csrc/ln_mdta.cu Layout, mirrored): the weights' planes (7 C^2 values),
    per image A (f32 and planes), the gram's rows (a range of ``ksa``
    pixels of an image), the Sq and Sk rows (a segment of BWD_TAPS_COLS
    columns of an image row); then two regions of pixel-major values that
    the stages alternate between: LN (C, planes of a value in the compute
    dtype) and u (3C, f32), later outs, u_vf and outf; round(q), round(k)
    (2C) and v (C, planes of an f32 value), later out and vf.  Each piece
    256-byte aligned."""
    hw = h * w
    p = imgs * hw
    npt, nf = bwd_planes(itemsize)
    pl, fs, fa = npt * 2 * p * c, nf * 2 * p * c, 4 * p * c
    cc = imgs * c * c
    segs = imgs * h * -(-w // BWD_TAPS_COLS)
    sizes = (nf * 2 * 7 * c * c, 4 * cc, nf * 2 * cc,
             4 * cc * -(-hw // ksa), 4 * segs * 2 * c,
             _align256(pl) + 3 * fa, _align256(2 * pl) + fs)
    return sum(_align256(n) for n in sizes)


class FwdPlan(collections.namedtuple(
        "FwdPlan", "imgs slices image_split_pixels workspace launches")):
    """How the forward walks a batch: images a slice, slices, pixels a
    range of an image's gram, workspace bytes, launches a call."""


def fwd_plan(b: int, h: int, w: int, c: int, itemsize: int) -> FwdPlan:
    """The fewest slices whose workspace stays within FWD_WORKSPACE_BYTES,
    the batch split evenly between them; an image whose own workspace
    exceeds it is a slice by itself.  The gram's pixel ranges are the
    backward's dA ranges (``bwd_image_split_pixels``).  Remembered by its
    arguments and the budget (a model calls it for the same few shapes)."""
    key = (b, h, w, c, itemsize, FWD_WORKSPACE_BYTES, bwd_image_split_pixels)
    plan = _fwd_plans.get(key)
    if plan is None:
        plan = _fwd_plans[key] = _fwd_plan(b, h, w, c, itemsize)
    return plan


_fwd_plans: dict = {}


def _fwd_plan(b, h, w, c, itemsize):
    ksa = bwd_image_split_pixels(h * w)
    one = fwd_workspace_bytes(1, h, w, c, itemsize, ksa)
    most = max(1, min(b, FWD_WORKSPACE_BYTES // one))
    while most > 1 and fwd_workspace_bytes(most, h, w, c, itemsize,
                                           ksa) > FWD_WORKSPACE_BYTES:
        most -= 1
    slices = -(-b // most)
    imgs = -(-b // slices)
    return FwdPlan(imgs, slices, ksa,
                   fwd_workspace_bytes(imgs, h, w, c, itemsize, ksa),
                   FWD_LAUNCHES * slices + 1)


def forward_with_stats(x, scale, bias, w_qkv, t_qkv, temp, w_po, w_kv,
                       t_kv, w_pof, num_heads, eps: float = 1e-5):
    """The CUDA forward of a CUDA tensor: (y, stats), stats holding each
    image's gram [C][C / heads], Sq [C] and Sk [C] (what the backward needs
    besides x).  The kernels read every weight from its parameter, as it is
    stored (a launch a call writes their bf16 planes into the workspace)."""
    b, c, h, w = x.shape
    _kernels.check_input("ln_mdta", x, scale, bias, w_qkv, t_qkv, temp, w_po,
                         w_kv, t_kv, w_pof)
    cph = _check_heads(c, num_heads)
    if c > BWD_MAX_C:
        raise ValueError(f"ln_mdta: C={c} is wider than {BWD_MAX_C}")
    lib = _kernels.library("ln_mdta")
    plan = fwd_plan(b, h, w, c, x.element_size())
    work = torch.empty(plan.workspace, device=x.device, dtype=torch.uint8)
    stats = torch.empty(b * (c * cph + 2 * c), device=x.device,
                        dtype=torch.float32)
    y = torch.empty_like(x)
    ops = (x, y, *(t.float().contiguous() for t in (
        scale, bias, w_qkv, t_qkv, w_po, w_kv, t_kv, w_pof, temp)), stats,
        work)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.uir_ln_mdta_fwd(
        *(t.data_ptr() for t in ops), b, c, h, w, cph,
        int(x.dtype == torch.bfloat16), plan.imgs, plan.image_split_pixels,
        float(eps), stream)
    _kernels.check(lib, err, "ln_mdta")
    ln_mdta.launches[(c, h, w)] += plan.launches
    return y, stats


def ln_mdta_bwd(x, dy, scale, bias, w_qkv, t_qkv, temp, w_po, w_kv, t_kv,
                w_pof, num_heads: int, stats, eps: float = 1e-5):
    """The LN+MDTA backward's CUDA kernels, on CUDA tensors, with ``stats``
    as ``forward_with_stats`` wrote them.  Returns the gradients in the
    order of ``ln_mdta_bwd_plain``, dx in x.dtype and the rest f32.  The
    kernels read every weight from its parameter, as it is stored (a launch
    a call writes their bf16 planes, ``bwd_planes``, into the workspace):
    nothing is transposed or copied here."""
    b, c, h, w = x.shape
    _kernels.check_input("ln_mdta_bwd", x, dy, scale, bias, w_qkv, t_qkv,
                         temp, w_po, w_kv, t_kv, w_pof, stats)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError("ln_mdta_bwd: dy must match x in shape and dtype")
    cph = _check_heads(c, num_heads)
    if c > BWD_MAX_C:
        raise ValueError(f"ln_mdta_bwd: C={c} is wider than {BWD_MAX_C}")
    lib = _kernels.library("ln_mdta_bwd")
    f32 = dict(device=x.device, dtype=torch.float32)
    plan = bwd_plan(b, h, w, c, x.element_size(),
                    _kernels.sm_count(x.device))
    work = torch.empty(plan.workspace, device=x.device, dtype=torch.uint8)
    grads = torch.empty(bwd_row_size(c), **f32)
    dtemp = torch.empty(b * num_heads, **f32)
    dx = torch.empty_like(x)
    ops = (x, dy.contiguous(), dx, *(t.float().contiguous() for t in (
        scale, bias, w_qkv, t_qkv, w_po, w_kv, t_kv, w_pof, temp)), stats,
        work, grads, dtemp)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.uir_ln_mdta_bwd(
        *(t.data_ptr() for t in ops), b, c, h, w, cph,
        int(x.dtype == torch.bfloat16), plan.imgs, plan.split_pixels,
        plan.image_split_pixels, float(eps), stream)
    _kernels.check(lib, err, "ln_mdta_bwd")
    ln_mdta_bwd.launches[(c, h, w)] += plan.launches
    return _unpack_grads(grads, dx, dtemp, c, num_heads)


@torch.library.custom_op("uir::ln_mdta", mutates_args=(),
                         device_types="cuda")
def _ln_mdta_op(x: Tensor, scale: Tensor, bias: Tensor, w_qkv: Tensor,
                t_qkv: Tensor, temp: Tensor, w_po: Tensor, w_kv: Tensor,
                t_kv: Tensor, w_pof: Tensor, num_heads: int,
                eps: float) -> tuple[Tensor, Tensor]:
    """``torch.ops.uir.ln_mdta``: (y, stats), the kernels on the card
    (``forward_with_stats``), the plain version on the CPU."""
    return forward_with_stats(x, scale, bias, w_qkv, t_qkv, temp, w_po,
                              w_kv, t_kv, w_pof, num_heads, eps)


@_ln_mdta_op.register_kernel("cpu")
def _(x, scale, bias, w_qkv, t_qkv, temp, w_po, w_kv, t_kv, w_pof,
      num_heads, eps):
    return _plain(x, scale, bias, w_qkv, t_qkv, temp, w_po, w_kv, t_kv,
                  w_pof, num_heads, eps, with_stats=True)


@_ln_mdta_op.register_fake
def _(x, scale, bias, w_qkv, t_qkv, temp, w_po, w_kv, t_kv, w_pof,
      num_heads, eps):
    b, c = x.shape[:2]
    return (torch.empty_like(x),
            x.new_empty(b * (c * (c // num_heads) + 2 * c),
                        dtype=torch.float32))


class LnMdtaFn(torch.autograd.Function):
    """The CUDA forward (``torch.ops.uir.ln_mdta``) with the CUDA backward;
    saves x, the weights and the per-image stats."""

    @staticmethod
    def forward(ctx, x, scale, bias, w_qkv, t_qkv, temp, w_po, w_kv, t_kv,
                w_pof, num_heads, eps):
        y, stats = torch.ops.uir.ln_mdta(x, scale, bias, w_qkv, t_qkv, temp,
                                         w_po, w_kv, t_kv, w_pof, num_heads,
                                         eps)
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
    for a CUDA tensor, the plain version for a CPU tensor.  Without a
    gradient to take, the forward on the card is the custom op
    ``torch.ops.uir.ln_mdta`` alone; with one, ``LnMdtaFn``.  Under
    ``torch.export`` a call without a gradient is the op on the CPU too
    (what the program records)."""
    args = (x, scale, bias, w_qkv, t_qkv, temp, w_po, w_kv, t_kv, w_pof)
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in args)
    if x.device.type == "cpu" and (grad or not torch.compiler.is_exporting()):
        return ln_mdta_plain(*args, num_heads, eps)
    if grad:
        return LnMdtaFn.apply(*args, num_heads, eps)
    return torch.ops.uir.ln_mdta(*args, num_heads, eps)[0]


# launches of the CUDA kernel(s), by (C, H, W); the CPU path adds none
ln_mdta.launches = collections.Counter()
ln_mdta_bwd.launches = collections.Counter()


# ---------------------------------------------------------------------------
# a band of a row-sharded map (context parallelism): the attention's stats
# (each image's gram and row sums of squares over all pixels) are summed
# over the ranks between the forward's two halves, and dA between the
# backward's

# rows of each neighbouring rank's a band takes: qkv's taps, then kv's taps
# on out = A v (a band row's vf reads out a row out, whose v reads x one
# more row out); the outermost halo row's own values are wrong (its taps
# read past the rows given) and reach only halo rows of y, which are
# cropped
MDTA_HALO = 2
# launches a slice of images of the split entries (csrc/ln_mdta.cu,
# csrc/ln_mdta_bwd.cu), and one a call of each forward half for the
# weights' planes: stats (prep, u, the taps, the gram, the stats); apply
# (LN, u and v recomputed, then A from the stats, outs, out, u_vf, the
# taps, outf, y); stage 1 (the weights' planes, steps 1-16, each image's
# dA); stage 2 (the softmax backward, dq and dk, the transposed taps, two
# weight-gradient launches, dLN, the row sums)
FWD_STATS_LAUNCHES = 5
FWD_APPLY_LAUNCHES = 10
BWD_STAGE1_LAUNCHES = 18
BWD_STAGE2_LAUNCHES = 7


def _weights32(scale, bias, w_qkv, t_qkv, temp, w_po, w_kv, t_kv, w_pof):
    """The f32 weights in the C entries' order."""
    return tuple(t.float().contiguous() for t in (
        scale, bias, w_qkv, t_qkv, w_po, w_kv, t_kv, w_pof, temp))


def _check_split(what, x, c, num_heads, *tensors):
    _kernels.check_input(what, x, *tensors)
    cph = _check_heads(c, num_heads)
    if c > BWD_MAX_C:
        raise ValueError(f"{what}: C={c} is wider than {BWD_MAX_C}")
    return cph


def ln_mdta_stats(x, scale, bias, w_qkv, t_qkv, temp, w_po, w_kv, t_kv,
                  w_pof, num_heads: int, r0: int, r1: int,
                  eps: float = 1e-5):
    """Each image's stats (B, C cph + 2C) f32 over rows [r0, r1) of x: the
    kernels of ``uir_ln_mdta_fwd_stats`` for a CUDA tensor (sliced as
    ``fwd_plan`` says), ``ln_mdta_stats_plain`` for a CPU one."""
    if x.device.type == "cpu":
        return ln_mdta_stats_plain(x, scale, bias, w_qkv, t_qkv, num_heads,
                                   r0, r1, eps)
    b, c, h, w = x.shape
    ws = (scale, bias, w_qkv, t_qkv, temp, w_po, w_kv, t_kv, w_pof)
    cph = _check_split("ln_mdta_stats", x, c, num_heads, *ws)
    lib = _kernels.library("ln_mdta")
    plan = fwd_plan(b, h, w, c, x.element_size())
    work = torch.empty(plan.workspace, device=x.device, dtype=torch.uint8)
    stats = torch.empty(b, c * cph + 2 * c, device=x.device,
                        dtype=torch.float32)
    ops = (x, *_weights32(*ws), stats, work)
    err = lib.uir_ln_mdta_fwd_stats(
        *(t.data_ptr() for t in ops), b, c, h, w, cph,
        int(x.dtype == torch.bfloat16), plan.imgs, plan.image_split_pixels,
        r0, r1, float(eps), torch.cuda.current_stream(x.device).cuda_stream)
    _kernels.check(lib, err, "ln_mdta_stats")
    ln_mdta_stats.launches[(c, h, w)] += 1 + FWD_STATS_LAUNCHES * plan.slices
    return stats


def ln_mdta_apply(x, scale, bias, w_qkv, t_qkv, temp, w_po, w_kv, t_kv,
                  w_pof, num_heads: int, stats, eps: float = 1e-5):
    """y from x and the stats it is given: the kernels of
    ``uir_ln_mdta_fwd_apply`` for a CUDA tensor, ``ln_mdta_apply_plain``
    for a CPU one."""
    ws = (scale, bias, w_qkv, t_qkv, temp, w_po, w_kv, t_kv, w_pof)
    if x.device.type == "cpu":
        return ln_mdta_apply_plain(x, stats, *ws, num_heads, eps)
    b, c, h, w = x.shape
    cph = _check_split("ln_mdta_apply", x, c, num_heads, *ws, stats)
    if stats.shape != (b, c * cph + 2 * c) or stats.dtype != torch.float32:
        raise ValueError(f"ln_mdta_apply: stats of shape {tuple(stats.shape)}"
                         f" and {stats.dtype}; expected ({b}, "
                         f"{c * cph + 2 * c}) float32")
    lib = _kernels.library("ln_mdta")
    plan = fwd_plan(b, h, w, c, x.element_size())
    work = torch.empty(plan.workspace, device=x.device, dtype=torch.uint8)
    y = torch.empty_like(x)
    ops = (x, y, *_weights32(*ws), stats.contiguous(), work)
    err = lib.uir_ln_mdta_fwd_apply(
        *(t.data_ptr() for t in ops), b, c, h, w, cph,
        int(x.dtype == torch.bfloat16), plan.imgs, plan.image_split_pixels,
        float(eps), torch.cuda.current_stream(x.device).cuda_stream)
    _kernels.check(lib, err, "ln_mdta_apply")
    ln_mdta_apply.launches[(c, h, w)] += 1 + FWD_APPLY_LAUNCHES * plan.slices
    return y


def bwd_rows_plan(b: int, h: int, w: int, c: int, itemsize: int,
                  sms: int = 132, h_max: int | None = None) -> BwdPlan:
    """The split backward's plan on a band of ``h`` rows: the slices of
    ``bwd_plan`` at ``h_max`` rows (the tallest band with its halo of any
    rank, so that every rank makes as many slices, and as many sums over
    the ranks), their splits and workspace at ``h``."""
    p = bwd_plan(b, max(h, h_max or h), w, c, itemsize, sms)
    ks = bwd_split_pixels(p.imgs * h * w, c, sms)
    ksa = bwd_image_split_pixels(h * w)
    return BwdPlan(p.imgs, p.slices, ks, ksa,
                   bwd_workspace_bytes(p.imgs, h, w, c, itemsize, ks, ksa),
                   (BWD_STAGE1_LAUNCHES + BWD_STAGE2_LAUNCHES) * p.slices)


def ln_mdta_bwd_stage1(x, dy, ws32, stats, work, plan, num_heads: int,
                       eps: float = 1e-5):
    """Stage 1 of the split backward on one slice of images (CUDA tensors;
    ``ws32`` from ``_weights32``): each image's dA (B, C cph), the rank's
    share.  ``work`` keeps what stage 2 reads."""
    b, c, h, w = x.shape
    cph = c // num_heads
    lib = _kernels.library("ln_mdta_bwd")
    da = torch.empty(b, c * cph, device=x.device, dtype=torch.float32)
    ops = (x, dy, *ws32, stats, work, da)
    err = lib.uir_ln_mdta_bwd_stage1(
        *(t.data_ptr() for t in ops), b, c, h, w, cph,
        int(x.dtype == torch.bfloat16), plan.imgs, plan.split_pixels,
        plan.image_split_pixels, float(eps),
        torch.cuda.current_stream(x.device).cuda_stream)
    _kernels.check(lib, err, "ln_mdta_bwd_stage1")
    ln_mdta_bwd_stage1.launches[(c, h, w)] += BWD_STAGE1_LAUNCHES
    return da


def ln_mdta_bwd_stage2(x, dy, dx, ws32, stats, work, plan, grads, dtemp,
                       da, da_own, num_heads: int, r0: int, r1: int,
                       accumulate: bool, eps: float = 1e-5):
    """Stage 2 on the slice stage 1 left in ``work``: dx into ``dx``, dtemp
    (from ``da_own``) into ``dtemp``, the weight gradients into ``grads``
    (added to them when ``accumulate``); dq and dk zero outside rows [r0,
    r1)."""
    b, c, h, w = x.shape
    lib = _kernels.library("ln_mdta_bwd")
    ops = (x, dy, dx, *ws32, stats, work, grads, dtemp, da, da_own)
    err = lib.uir_ln_mdta_bwd_stage2(
        *(t.data_ptr() for t in ops), b, c, h, w, c // num_heads,
        int(x.dtype == torch.bfloat16), plan.imgs, plan.split_pixels,
        plan.image_split_pixels, r0, r1, int(accumulate), float(eps),
        torch.cuda.current_stream(x.device).cuda_stream)
    _kernels.check(lib, err, "ln_mdta_bwd_stage2")
    ln_mdta_bwd_stage2.launches[(c, h, w)] += BWD_STAGE2_LAUNCHES


def ln_mdta_bwd_rows(x, dy, scale, bias, w_qkv, t_qkv, temp, w_po, w_kv,
                     t_kv, w_pof, num_heads: int, stats, r0: int, r1: int,
                     cp=None, eps: float = 1e-5, h_max: int | None = None):
    """The split backward on CUDA tensors: x the band with its halo rows,
    dy zero on them, ``stats`` the sum over the ranks.  Slice by slice,
    stage 1, the sum of its dA over the context group ``cp`` (none without
    one), stage 2.  Returns ``ln_mdta_bwd``'s gradients: dx on the rows of
    x, the weights' and dtemp this rank's shares."""
    b, c, h, w = x.shape
    ws = (scale, bias, w_qkv, t_qkv, temp, w_po, w_kv, t_kv, w_pof)
    _check_split("ln_mdta_bwd_rows", x, c, num_heads, dy, *ws, stats)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError("ln_mdta_bwd_rows: dy must match x in shape and "
                         "dtype")
    from ..parallel.context import reduce_sum

    f32 = dict(device=x.device, dtype=torch.float32)
    plan = bwd_rows_plan(b, h, w, c, x.element_size(),
                         _kernels.sm_count(x.device), h_max)
    work = torch.empty(plan.workspace, device=x.device, dtype=torch.uint8)
    grads = torch.empty(bwd_row_size(c), **f32)
    dtemp = torch.empty(b, num_heads, **f32)
    dx = torch.empty_like(x)
    ws32, dy = _weights32(*ws), dy.contiguous()
    stats = stats.contiguous()
    for i in range(plan.slices):
        sl = slice(i * plan.imgs, min(b, (i + 1) * plan.imgs))
        da = ln_mdta_bwd_stage1(x[sl], dy[sl], ws32, stats[sl], work, plan,
                                num_heads, eps)
        ln_mdta_bwd_stage2(x[sl], dy[sl], dx[sl], ws32, stats[sl], work,
                           plan, grads, dtemp[sl], reduce_sum(da, cp), da,
                           num_heads, r0, r1, i > 0, eps)
    return _unpack_grads(grads, dx, dtemp, c, num_heads)


def _unpack_grads(grads, dx, dtemp, c, num_heads):
    """The backward's gradient rows in ``ln_mdta_bwd_plain``'s order and
    layouts, the dead ``kf`` half of w_kv and t_kv zeros."""
    f32 = dict(device=grads.device, dtype=torch.float32)
    sizes = (c * c, c * c, 9 * c, c * c, 3 * c * c, 27 * c, c, c)
    g_pof, g_kvf, g_tvf, g_po, g_qkv, g_t3, dsc, dbi = grads.split(sizes)
    zero = torch.zeros(c, c, **f32)
    dw_kv = torch.cat([zero, g_kvf.view(c, c)], 1)
    dt_kv = torch.cat([zero[:, :9], g_tvf.view(c, 9)]).t().reshape(3, 3,
                                                                   2 * c)
    return (dx, dsc, dbi, g_qkv.view(c, 3 * c),
            g_t3.view(3 * c, 9).t().reshape(3, 3, 3 * c),
            dtemp.reshape(-1, num_heads).sum(0).view(1, num_heads, 1, 1),
            g_po.view(c, c), dw_kv, dt_kv, g_pof.view(c, c))


class LnMdtaRowsFn(torch.autograd.Function):
    """``LnMdtaFn``'s sibling on a band with its halo rows: the stats
    kernels over rows [r0, r1), their sum over the context group, the
    apply kernels; saves x, the weights and the summed stats.  The
    backward is ``ln_mdta_bwd_rows``."""

    @staticmethod
    def forward(ctx, x, scale, bias, w_qkv, t_qkv, temp, w_po, w_kv, t_kv,
                w_pof, num_heads, eps, r0, r1, cp, h_max):
        from ..parallel.context import reduce_sum

        ws = (scale, bias, w_qkv, t_qkv, temp, w_po, w_kv, t_kv, w_pof)
        stats = reduce_sum(ln_mdta_stats(x, *ws, num_heads, r0, r1, eps), cp)
        y = ln_mdta_apply(x, *ws, num_heads, stats, eps)
        ctx.args = (num_heads, r0, r1, cp, eps, h_max)
        ctx.save_for_backward(x, *ws, stats)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, *ws, stats = ctx.saved_tensors
        num_heads, r0, r1, cp, eps, h_max = ctx.args
        grads = ln_mdta_bwd_rows(x, dy, *ws, num_heads, stats, r0, r1, cp,
                                 eps, h_max)
        return (grads[0],) + tuple(g.to(t.dtype) for g, t in
                                   zip(grads[1:], ws)) + (None,) * 6


def ln_mdta_rows(x, scale, bias, w_qkv, t_qkv, temp, w_po, w_kv, t_kv,
                 w_pof, num_heads: int, eps: float = 1e-5, cp=None,
                 use_kernels: bool = True):
    """``ln_mdta`` (or, without ``use_kernels``, ``ln_mdta_plain``) of the
    rank's band of a row-sharded NCHW map (``cp``, a
    ``core.meshes.ContextParallel``; the whole map without it): the band
    with MDTA_HALO rows of each neighbouring rank's (none past the map's
    edge, where the kernels zero-pad as the whole map's call does); the
    stats over the band's own rows, summed over the context group; the
    apply half on the extended band; its result cropped to the band.  With
    a gradient on CUDA tensors, ``LnMdtaRowsFn``; otherwise the halves'
    wrappers (the kernels on the card, the plain halves on the CPU) or the
    plain halves, with the differentiable sum between them.  The weight
    gradients and dtemp are the band's shares (the train step sums them
    over the ranks); the dx of the halo rows goes back to their owners
    through the halo exchange's adjoint."""
    ws = (scale, bias, w_qkv, t_qkv, temp, w_po, w_kv, t_kv, w_pof)
    if cp is None or cp.size == 1:
        fn = ln_mdta if use_kernels else ln_mdta_plain
        return fn(x, *ws, num_heads, eps)
    from ..parallel.context import all_reduce_sum, halo_rows

    h = x.shape[2]
    ext, r0 = halo_rows(x, MDTA_HALO, MDTA_HALO, cp, dim=2, zeros=False)
    ext, r1 = ext.contiguous(), r0 + h
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (ext, *ws))
    if use_kernels and ext.device.type == "cuda" and grad:
        h_max = h + MDTA_HALO * min(2, cp.size - 1)
        y = LnMdtaRowsFn.apply(ext, *ws, num_heads, eps, r0, r1, cp, h_max)
    elif use_kernels:
        stats = all_reduce_sum(
            ln_mdta_stats(ext, *ws, num_heads, r0, r1, eps), cp)
        y = ln_mdta_apply(ext, *ws, num_heads, stats, eps)
    else:
        stats = all_reduce_sum(ln_mdta_stats_plain(
            ext, *ws[:4], num_heads, r0, r1, eps), cp)
        y = ln_mdta_apply_plain(ext, stats, *ws, num_heads, eps)
    return y[:, :, r0:r1].contiguous()


ln_mdta_stats.launches = collections.Counter()
ln_mdta_apply.launches = collections.Counter()
ln_mdta_bwd_stage1.launches = collections.Counter()
ln_mdta_bwd_stage2.launches = collections.Counter()
