"""Window attention: ``softmax(q kᵀ scale + bias [+ mask])``, mixed with
``relu(·)²`` by ``softmax(w)`` when sparse, times v.

Counterpart of the JAX package's ``ops/pallas.py:217 window_attention``
(the TPU kernel ``_fwd_pallas:110``) with the same arguments: q, k, v
``(B', heads, N, d)`` with B' = batch * windows, bias ``(heads, N, N)``,
``sparse_w`` the (2,) mix vector or None, mask ``(nW, N, N)`` or None.

``window_attention`` launches ``csrc/window_attn.cu`` for CUDA tensors
through ``WindowAttnFn``, whose backward recomputes through the plain
version, as the TPU kernel's custom VJP does (``pallas.py:191``); it takes
the plain version ``window_attention_plain`` for CPU tensors.  The kernel
takes N <= 64 and d <= 64 (a window of at most 8 x 8 tokens); any other
shape raises.  q, k, v may be strided views with a unit channel stride
(``attention.split_heads`` of the projections), and the result is a view
of a (B', N, heads * d) tensor, so ``attention.merge_heads`` of it copies
nothing.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from . import _kernels
from .attention import window_attention_core

MAX_N = 64
MAX_D = 64


def window_attention_plain(q, k, v, bias, *, scale: float, sparse_w=None,
                           mask=None):
    """Plain PyTorch version of the kernel (the CPU path and the kernel's
    reference on the card)."""
    return window_attention_core(q, k, v, bias, scale=scale,
                                 sparse_w=sparse_w, mask=mask)


def _check(q, k, v, bias, sparse_w, mask):
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


def _forward_cuda(q, k, v, bias, scale, sparse_w, mask):
    _check(q, k, v, bias, sparse_w, mask)
    bq, h, n, d = q.shape
    lib = _kernels.library("window_attn")
    out = torch.empty((bq, n, h, d), device=q.device,
                      dtype=q.dtype).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out)
                                         for s in t.stride()[:3]))
    bi = bias.float().contiguous()
    mk = None if mask is None else mask.float().contiguous()
    w = None if sparse_w is None else sparse_w.float().contiguous()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.uir_window_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
        bi.data_ptr(), None if mk is None else mk.data_ptr(),
        None if w is None else w.data_ptr(), bq, h, n, d,
        1 if mk is None else mk.shape[0], float(scale),
        int(q.dtype == torch.bfloat16), stream)
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


class WindowAttnFn(torch.autograd.Function):
    """The CUDA forward; the backward recomputes through the plain version
    (the attention matrices are never stored)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, sparse_w, mask, scale):
        ctx.scale = scale
        ctx.save_for_backward(q, k, v, bias, sparse_w, mask)
        return _forward_cuda(q, k, v, bias, scale, sparse_w, mask)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, sparse_w, mask = ctx.saved_tensors
        return window_attention_bwd(
            g, q, k, v, bias, scale=ctx.scale, sparse_w=sparse_w, mask=mask,
            need=ctx.needs_input_grad[:5]) + (None, None)


def window_attention(q, k, v, bias, *, scale: float, sparse_w=None,
                     mask=None):
    """The CUDA kernel (with the recompute backward) for CUDA tensors, the
    plain version for CPU tensors."""
    if q.device.type == "cpu":
        return window_attention_plain(q, k, v, bias, scale=scale,
                                      sparse_w=sparse_w, mask=mask)
    return WindowAttnFn.apply(q, k, v, bias, sparse_w, mask, float(scale))


# launches of the CUDA kernel, by (B', heads, N, d, masked); the CPU path
# adds none
window_attention.launches = collections.Counter()
