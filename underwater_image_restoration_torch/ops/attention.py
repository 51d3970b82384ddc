"""Attention cores, counterparts of the JAX package's ``ops/attention.py``:
the MDTA channel attention (``:125``) and the windowed attention with its
sparse relu²/softmax mix (``:23-76``, ``:111-122``).

``window_attention_core`` is the plain version of the window-attention
kernel (``ops.window_attention``); every product and the softmax run in
f32 and the result is rounded to q's dtype once.
"""
from __future__ import annotations

import torch

from .layers import wide


def channel_attention_core(q, k, v, temperature):
    """'Transposed' attention: softmax over channels, linear in pixels.

    q, k, v: (B, H, c_h, L); temperature: (1, H, 1, 1).  Returns
    (out (B, H, c_h, L) in q.dtype, attn (B, H, c_h, c_h) f32, f64 for
    f64 inputs)."""
    attn = torch.einsum("bhcl,bhdl->bhcd", wide(q), wide(k))
    attn = torch.softmax(attn * wide(temperature), dim=-1)
    out = torch.einsum("bhcd,bhdl->bhcl", attn, wide(v))
    return out.to(q.dtype), attn


def sparse_mix_weights(w):
    """softmax over the learnable 2-vector ``w``: the weights of the softmax
    and relu² terms."""
    e = torch.exp(w.float())
    s = e.sum()
    return e[0] / s, e[1] / s


def window_attention_core(q, k, v, bias, *, scale: float, sparse_w=None,
                          mask=None):
    """Windowed attention.

    q: (B', H, N, d), B' = batch * windows; k, v: (B', H, Nk, d); bias:
    (H, N, Nk) relative-position bias; ``sparse_w`` None for the plain
    softmax, else the (2,) mix vector: ``w1 * softmax(a) + w2 * relu(a)²``;
    mask: (nW, N, Nk) additive, window ``i`` of the batch taking
    ``mask[i % nW]``.  Returns (B', H, N, d) in q's dtype."""
    bq, nh, n, _ = q.shape
    attn = torch.einsum("bhnd,bhmd->bhnm", q.float() * scale, k.float())
    attn = attn + bias[None].float()
    if mask is not None:
        nw = mask.shape[0]
        attn = (attn.reshape(bq // nw, nw, nh, n, -1)
                + mask[None, :, None].float()).reshape(bq, nh, n, -1)
    if sparse_w is None:
        attn = torch.softmax(attn, dim=-1)
    else:
        w1, w2 = sparse_mix_weights(sparse_w)
        attn = (torch.softmax(attn, dim=-1) * w1
                + torch.relu(attn).square() * w2)
    out = torch.einsum("bhnm,bhmd->bhnd", attn, v.float())
    return out.to(q.dtype)


def split_heads(x, num_heads: int):
    """(B', N, C) -> (B', H, N, C/H), a view."""
    b, n, c = x.shape
    return x.view(b, n, num_heads, c // num_heads).transpose(1, 2)


def merge_heads(x):
    """(B', H, N, d) -> (B', N, H*d) (free when x came from ``split_heads``'s
    layout)."""
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)
