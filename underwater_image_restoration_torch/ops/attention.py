"""MDTA channel attention core, counterpart of
the JAX package's ``ops/attention.py:125``."""
from __future__ import annotations

import torch


def channel_attention_core(q, k, v, temperature):
    """'Transposed' attention: softmax over channels, linear in pixels.

    q, k, v: (B, H, c_h, L); temperature: (1, H, 1, 1).  Returns
    (out (B, H, c_h, L) in q.dtype, attn (B, H, c_h, c_h) f32)."""
    attn = torch.einsum("bhcl,bhdl->bhcd", q.float(), k.float())
    attn = torch.softmax(attn * temperature.float(), dim=-1)
    out = torch.einsum("bhcd,bhdl->bhcl", attn, v.float())
    return out.to(q.dtype), attn
