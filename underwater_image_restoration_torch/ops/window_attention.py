"""Window attention: ``softmax(q kᵀ scale + bias [+ mask])``, mixed with
``relu(·)²`` by ``softmax(w)`` when sparse, times v.

Counterpart of the JAX package's ``ops/pallas.py:217 window_attention``
(the TPU kernel ``_fwd_pallas:110``) with the same arguments: q, k, v
``(B', heads, N, d)`` with B' = batch * windows, bias ``(heads, N, N)``,
``sparse_w`` the (2,) mix vector or None, mask ``(nW, N, N)`` or None.

``window_attention`` launches ``csrc/window_attn.cu`` for CUDA tensors
through the custom op ``torch.ops.uir.window_attn`` (which ``torch.export``
records as one node; the plain version on the CPU) and, with a gradient to
take, ``WindowAttnFn``, whose backward launches ``csrc/window_attn_bwd.cu``
(``window_attn_bwd``): the same recompute from the inputs as the TPU
kernel's custom VJP (``pallas.py:191``), as one kernel.  CPU tensors take
the plain versions, ``window_attention_plain`` and ``window_attention_bwd``
(autograd through the plain version).  The kernels take N <= 64 and d <=
128 (a window of at most 8 x 8 tokens, heads of at most 128 channels); any
other shape raises.  q, k, v may be strided views with a unit channel
stride (``attention.split_heads`` of the projections), and the result is a
view of a (B', N, heads * d) tensor, so ``attention.merge_heads`` of it
copies nothing.

Both kernels walk the windows in blocks of one head each (``fwd_plan``,
``bwd_plan``): a block takes a run of windows in (mask index, image) order,
so that it stages the head's bias and a mask index's mask once for the run.
A call aims at one wave of blocks: as many a multiprocessor as its shared
memory lets one hold (``fwd_smem_bytes``, ``bwd_smem_bytes``, the kernels'
``smem_bytes``), at most four: four forward and two backward at d = 32 in
bf16, one of each at d = 128.  The backward's blocks each write one row of
dbias and dw partials, summed in block order (no float atomics), so its
block count is fixed by the shape, the dtype and the SM count alone and two
calls give the same bits.
"""
from __future__ import annotations

import collections
import ctypes
from typing import Optional

import torch
from torch import Tensor

from . import _kernels
from .attention import window_attention_core

MAX_N = 64
MAX_D = 128
# shared memory an H100 multiprocessor gives its blocks, and what each
# block of them reserves for itself
SM_SHARED_BYTES = 228 << 10
BLOCK_RESERVED_BYTES = 1 << 10
# the registers' limit: a block's 128 threads take 96 to 128 registers each
# in bf16 at d <= 64 (ptxas -v on an H100), so four blocks an SM at most
MAX_BLOCKS_PER_SM = 4
# the backward's rows of dbias and dw partials: (N * N f32, two f64) a
# block
BWD_WORKSPACE_BYTES = 64 << 20
_BIAS_BYTES = 4 * MAX_N * (MAX_N + 8)  # the f32 bias and mask tile


class Plan(collections.namedtuple(
        "Plan", "blocks_per_head windows_per_block workspace launches")):
    """How a kernel walks B' windows: ``blocks_per_head`` blocks a head,
    each taking ``windows_per_block`` consecutive windows of the
    (mask index, image) order (the last block fewer); the backward's
    workspace bytes (its rows of partials) and its launches for a call
    that wants dbias and dw (the kernel, reduce_rows, the dw step)."""


def _pad_ld(n: int) -> int:
    """csrc/mma.cuh pad_ld: a bf16 row of n, padded."""
    u = -(-n // 8)
    return 8 * u if u % 2 else 8 * u + 8


def _tiles(d: int) -> int:
    """csrc/wattn.cuh tiles_of: 16-column tiles of a head width."""
    dk = -(-d // 16)
    return dk if dk <= 4 else 8


def _layout(d: int, itemsize: int):
    """(bf16 planes an operand, cp.async buffers, padded operand row, warp
    staging bytes) of the kernels at head width d."""
    planes = 1 if itemsize == 2 else 3
    dk = _tiles(d)
    stage = 4 * 16 * (16 * min(dk, 4) + 16 // itemsize) * itemsize
    return planes, 2 if planes == 1 else 1, _pad_ld(16 * dk), stage


def fwd_smem_bytes(d: int, itemsize: int) -> int:
    """csrc/window_attn.cu smem_bytes: the bias and mask tile, q, k and v
    of the buffered windows, the warps' staging rows."""
    planes, nbuf, ld, stage = _layout(d, itemsize)
    return _BIAS_BYTES + nbuf * 3 * planes * MAX_N * ld * 2 + stage


def bwd_smem_bytes(d: int, itemsize: int) -> int:
    """csrc/window_attn_bwd.cu smem_bytes: two f32 tiles (bias and mask,
    dbias), the operand slots (q, k, v, dO of the buffered windows; two in
    an f32 call at d > 64, which runs in phases), the P and dS planes, the
    staging rows and the f64 reduction."""
    planes, nbuf, ld, stage = _layout(d, itemsize)
    slots = 2 if planes > 1 and _tiles(d) > 4 else 4 * nbuf
    return (2 * _BIAS_BYTES + slots * planes * MAX_N * ld * 2
            + 2 * planes * MAX_N * _pad_ld(MAX_N) * 2 + stage + 64)


def blocks_per_sm(smem: int) -> int:
    """Blocks of ``smem`` bytes of shared memory a multiprocessor holds, at
    most MAX_BLOCKS_PER_SM."""
    return max(1, min(MAX_BLOCKS_PER_SM,
                      SM_SHARED_BYTES // (smem + BLOCK_RESERVED_BYTES)))


def _walk(bq: int, heads: int, blocks: int) -> tuple[int, int]:
    g = max(1, min(bq, -(-blocks // heads)))
    per = -(-bq // g)
    return -(-bq // per), per


def fwd_plan(bq: int, heads: int, sms: int = 132, *, d: int,
             itemsize: int) -> Plan:
    """The forward's walk for heads of d channels in a dtype of
    ``itemsize`` bytes: one wave of blocks (``blocks_per_sm`` of its shared
    memory on each of ``sms`` multiprocessors; an H100 has 132), at least
    one window a block."""
    g, per = _walk(bq, heads,
                   blocks_per_sm(fwd_smem_bytes(d, itemsize)) * sms)
    return Plan(g, per, 0, 1)


def bwd_row_bytes(n: int) -> int:
    """Workspace bytes of one block's row: its dbias tile (N * N f32) and
    its two f64 sums."""
    return 4 * n * n + 16


def bwd_plan(bq: int, heads: int, n: int, sms: int = 132, *, d: int,
             itemsize: int) -> Plan:
    """The backward's walk: one wave of blocks, as ``fwd_plan``, fewer
    where the rows would exceed BWD_WORKSPACE_BYTES.  The count depends on
    the shape, the dtype and the SM count alone, so the rows' sums are the
    same from call to call."""
    most = max(1, BWD_WORKSPACE_BYTES // (heads * bwd_row_bytes(n)))
    wave = blocks_per_sm(bwd_smem_bytes(d, itemsize)) * sms
    g, per = _walk(bq, heads, min(wave, most * heads))
    return Plan(g, per, g * heads * bwd_row_bytes(n), 3)


def block_windows(bq: int, nw: int, per: int, g: int) -> list[int]:
    """The windows block g of a head takes, in its order: run positions
    [g per, (g + 1) per), position i = j T + t (T = B' / nW images) being
    window t nW + j, so that a mask index's windows are consecutive (nW = 1
    without a mask)."""
    t_img = bq // nw
    return [(i % t_img) * nw + i // t_img
            for i in range(g * per, min(bq, (g + 1) * per))]


def window_attention_plain(q, k, v, bias, *, scale: float, sparse_w=None,
                           mask=None):
    """Plain PyTorch version of the kernel (the CPU path and the kernel's
    reference on the card)."""
    return window_attention_core(q, k, v, bias, scale=scale,
                                 sparse_w=sparse_w, mask=mask)


def _check(q, k, v, bias, sparse_w, mask):
    _kernels.check_plain("window_attn", q, k, v, bias, sparse_w, mask)
    bq, h, n, d = q.shape
    if q.device.type != "cuda":
        raise ValueError(f"window_attn: the CUDA kernel takes CUDA tensors, "
                         f"q is on {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"window_attn: q must be float32 or bfloat16, not "
                        f"{q.dtype}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"window_attn: q, k, v must share one shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("window_attn: q, k, v must share one dtype")
    if not (1 <= n <= MAX_N and 1 <= d <= MAX_D):
        raise ValueError(f"window_attn: the kernel takes N <= {MAX_N} tokens "
                         f"and d <= {MAX_D} channels a head, got N={n}, "
                         f"d={d}")
    if tuple(bias.shape) != (h, n, n):
        raise ValueError(f"window_attn: bias must be ({h}, {n}, {n}), got "
                         f"{tuple(bias.shape)}")
    if mask is not None and (mask.dim() != 3 or mask.shape[1:] != (n, n)
                             or bq % mask.shape[0]):
        raise ValueError(f"window_attn: mask must be (nW, {n}, {n}) with nW "
                         f"dividing {bq}, got {tuple(mask.shape)}")
    if sparse_w is not None and sparse_w.numel() != 2:
        raise ValueError("window_attn: sparse_w must hold two values")
    for t in (k, v, bias, mask, sparse_w):
        if t is not None and t.device != q.device:
            raise ValueError(f"window_attn: operands on {t.device}, q on "
                             f"{q.device}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("window_attn: q, k, v need a unit channel stride")


def _vec_bits(*ts) -> int:
    """Bit i set where tensor i (or None) has 16-byte aligned rows: its
    address and its window, head and token strides multiples of 16 bytes,
    so the kernels move it in 16-byte pieces."""
    bits = 0
    for i, t in enumerate(ts):
        if t is not None:
            e = t.element_size()
            sb, sh, sn = t.stride()[:3]
            if (t.data_ptr() | sb * e | sh * e | sn * e) % 16 == 0:
                bits |= 1 << i
    return bits


def _operands(bias, sparse_w, mask):
    bi = bias.float().contiguous()
    mk = None if mask is None else mask.float().contiguous()
    w = None if sparse_w is None else sparse_w.float().contiguous()
    return bi, mk, w


def _ptr(t):
    return None if t is None else t.data_ptr()


def _forward_cuda(q, k, v, bias, scale, sparse_w, mask):
    _check(q, k, v, bias, sparse_w, mask)
    bq, h, n, d = q.shape
    lib = _kernels.library("window_attn")
    out = _out_like(q)
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out)
                                         for s in t.stride()[:3]))
    bi, mk, w = _operands(bias, sparse_w, mask)
    plan = fwd_plan(bq, h, _kernels.sm_count(q.device), d=d,
                    itemsize=q.element_size())
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.uir_window_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
        bi.data_ptr(), _ptr(mk), _ptr(w), bq, h, n, d,
        1 if mk is None else mk.shape[0], plan.windows_per_block,
        float(scale), int(q.dtype == torch.bfloat16),
        _vec_bits(q, k, v, out), stream)
    _kernels.check(lib, err, "window_attn")
    window_attention.launches[(bq, h, n, d, mask is not None)] += 1
    return out


def window_attention_bwd(g, q, k, v, bias, *, scale: float, sparse_w=None,
                         mask=None, need=(True,) * 5):
    """(dq, dk, dv, dbias, dw) for the cotangent g, by autograd through the
    plain version recomputed from the inputs, as the TPU kernel's VJP does;
    None where ``need`` says no (and dw None for the dense softmax)."""
    ins = [q, k, v, bias, sparse_w]
    need = [t is not None and nd for t, nd in zip(ins, need)]
    ins = [None if t is None else t.detach().requires_grad_(nd)
           for t, nd in zip(ins, need)]
    with torch.enable_grad():
        out = window_attention_plain(*ins[:4], scale=scale, sparse_w=ins[4],
                                     mask=mask)
        wrt = [t for t, nd in zip(ins, need) if nd]
        got = iter(torch.autograd.grad(out, wrt, g) if wrt else ())
    return tuple(next(got) if nd else None for nd in need)


def window_attn_bwd(g, q, k, v, bias, *, scale: float, sparse_w=None,
                    mask=None, need=(True,) * 5):
    """(dq, dk, dv, dbias, dw) for the cotangent g, as
    ``window_attention_bwd`` returns them: ``csrc/window_attn_bwd.cu`` for
    CUDA tensors (dq, dk, dv in q's dtype and, where q's layout is dense,
    its strides; dbias and dw in f32, then the dtypes of bias and sparse_w),
    the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return window_attention_bwd(g, q, k, v, bias, scale=scale,
                                    sparse_w=sparse_w, mask=mask, need=need)
    _check(q, k, v, bias, sparse_w, mask)
    if g.shape != q.shape or g.dtype != q.dtype or g.device != q.device:
        raise ValueError(f"window_attn_bwd: g must match q, got "
                         f"{tuple(g.shape)} {g.dtype} on {g.device}")
    if g.stride(-1) != 1:
        g = g.contiguous()
    bq, h, n, d = q.shape
    need = [t is not None and nd
            for t, nd in zip((q, k, v, bias, sparse_w), need)]
    lib = _kernels.library("window_attn_bwd")
    dq, dk, dv = (torch.empty_like(t) if nd else None
                  for t, nd in zip((q, k, v), need))
    strides = (ctypes.c_longlong * 21)(*(
        s for t in (q, k, v, g, dq, dk, dv)
        for s in (t.stride()[:3] if t is not None else (0, 0, 0))))
    bi, mk, w = _operands(bias, sparse_w, mask)
    plan = bwd_plan(bq, h, n, _kernels.sm_count(q.device), d=d,
                    itemsize=q.element_size())
    rows = plan.blocks_per_head * h
    f32 = dict(device=q.device, dtype=torch.float32)
    part = torch.empty(rows * n * n, **f32) if need[3] else None
    dbias = torch.empty((h, n, n), **f32) if need[3] else None
    sums = (torch.empty(2 * rows, device=q.device, dtype=torch.float64)
            if need[4] else None)
    dw = torch.empty(2, **f32) if need[4] else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.uir_window_attn_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), _ptr(dq),
        _ptr(dk), _ptr(dv), strides, bi.data_ptr(), _ptr(mk), _ptr(w),
        _ptr(part), _ptr(sums), _ptr(dbias), _ptr(dw), bq, h, n, d,
        1 if mk is None else mk.shape[0], plan.windows_per_block,
        float(scale), int(q.dtype == torch.bfloat16),
        _vec_bits(q, k, v, g, dq, dk, dv), stream)
    _kernels.check(lib, err, "window_attn_bwd")
    window_attn_bwd.launches[(bq, h, n, d, mask is not None)] += \
        1 + need[3] + need[4]
    if dbias is not None:
        dbias = dbias.to(bias.dtype)
    if dw is not None:
        dw = dw.to(sparse_w.dtype)
    return dq, dk, dv, dbias, dw


def _out_like(q):
    """The kernel's output for q: (B', heads, N, d), a view of a
    (B', N, heads, d) tensor."""
    bq, h, n, d = q.shape
    return q.new_empty((bq, n, h, d)).transpose(1, 2)


@torch.library.custom_op("uir::window_attn", mutates_args=(),
                         device_types="cuda")
def _window_attn_op(q: Tensor, k: Tensor, v: Tensor, bias: Tensor,
                    sparse_w: Optional[Tensor], mask: Optional[Tensor],
                    scale: float) -> Tensor:
    """``torch.ops.uir.window_attn``: the kernel on the card
    (``_forward_cuda``), the plain version on the CPU, both in
    ``_out_like``'s layout."""
    return _forward_cuda(q, k, v, bias, scale, sparse_w, mask)


@_window_attn_op.register_kernel("cpu")
def _(q, k, v, bias, sparse_w, mask, scale):
    out = _out_like(q)
    out.copy_(window_attention_plain(q, k, v, bias, scale=scale,
                                     sparse_w=sparse_w, mask=mask))
    return out


@_window_attn_op.register_fake
def _(q, k, v, bias, sparse_w, mask, scale):
    return _out_like(q)


class WindowAttnFn(torch.autograd.Function):
    """The CUDA forward (``torch.ops.uir.window_attn``); the backward
    recomputes from the inputs in ``csrc/window_attn_bwd.cu`` (the
    attention matrices are never stored)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, sparse_w, mask, scale):
        ctx.scale = scale
        ctx.save_for_backward(q, k, v, bias, sparse_w, mask)
        return torch.ops.uir.window_attn(q, k, v, bias, sparse_w, mask,
                                         scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, sparse_w, mask = ctx.saved_tensors
        return window_attn_bwd(
            g, q, k, v, bias, scale=ctx.scale, sparse_w=sparse_w, mask=mask,
            need=ctx.needs_input_grad[:5]) + (None, None)


def window_attention(q, k, v, bias, *, scale: float, sparse_w=None,
                     mask=None):
    """The CUDA kernel (with the kernel backward) for CUDA tensors, the
    plain version for CPU tensors.  Without a gradient to take, the forward
    on the card is the custom op ``torch.ops.uir.window_attn`` alone,
    without the autograd Function (a fifth of a small call's host time).
    Under ``torch.export`` a call without a gradient is the op on the CPU
    too (what the program records)."""
    grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (q, k, v, bias, sparse_w))
    if q.device.type == "cpu" and (grad or not torch.compiler.is_exporting()):
        return window_attention_plain(q, k, v, bias, scale=scale,
                                      sparse_w=sparse_w, mask=mask)
    if grad:
        return WindowAttnFn.apply(q, k, v, bias, sparse_w, mask,
                                  float(scale))
    return torch.ops.uir.window_attn(q, k, v, bias, sparse_w, mask,
                                     float(scale))


# launches of the CUDA kernels, by (B', heads, N, d, masked): one a forward
# call; the backward's kernel, reduce_rows where dbias is wanted and the dw
# step where dw is; the CPU path adds none
window_attention.launches = collections.Counter()
window_attn_bwd.launches = collections.Counter()
