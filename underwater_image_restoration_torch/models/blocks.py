"""Token-space blocks of the AST, counterparts of the JAX package's
``models/blocks.py``: ``Mlp`` (``:233``), ``LeFF`` (``:248``) and
``WindowAttentionSparse`` (``:310``), with the reference's parameter names
(``mlp.linear1.0.weight``, ``attn.qkv.to_q.weight``, ...), so a reference
``state_dict`` loads as it is.

The LeFF's forward belongs to the block, which sends LayerNorm and LeFF
together to ``ops.ln_leff`` (``operands()`` gives the weights in that
function's layout).  FRFN and the New* blocks come with the New* models.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops import window_attention, window_attention_plain
from ..ops.attention import merge_heads, split_heads
from ..ops.layers import Conv2d, Linear, gelu
from ..ops.windows import relative_position_index


class Mlp(nn.Module):
    """fc1 -> gelu -> fc2 over tokens."""

    def __init__(self, dim: int, hidden_dim: int, device=None):
        super().__init__()
        self.fc1 = Linear(dim, hidden_dim, device=device)
        self.fc2 = Linear(hidden_dim, dim, device=device)

    def forward(self, x):
        return self.fc2(gelu(self.fc1(x)))


class LeFF(nn.Module):
    """Linear -> gelu -> depthwise 3x3 -> gelu -> Linear (parameters only;
    the block runs it through ``ops.ln_leff``)."""

    def __init__(self, dim: int, hidden_dim: int, device=None):
        super().__init__()
        # Sequentials keep the reference's names (linear1.0.weight, ...)
        self.linear1 = nn.Sequential(Linear(dim, hidden_dim, device=device))
        self.dwconv = nn.Sequential(Conv2d(hidden_dim, hidden_dim, 3,
                                           padding=1, groups=hidden_dim,
                                           device=device))
        self.linear2 = nn.Sequential(Linear(hidden_dim, dim, device=device))

    def operands(self):
        """(w1 (C, hid), b1, taps (3, 3, hid), b_dw, w2 (hid, C), b2)."""
        fc1, dw, fc2 = self.linear1[0], self.dwconv[0], self.linear2[0]
        return (fc1.weight.t(), fc1.bias, dw.weight[:, 0].permute(1, 2, 0),
                dw.bias, fc2.weight.t(), fc2.bias)


class LinearProjection(nn.Module):
    """The reference's q and kv projections (``to_q``, ``to_kv``)."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.to_q = Linear(dim, dim, device=device)
        self.to_kv = Linear(dim, 2 * dim, device=device)


class WindowAttentionSparse(nn.Module):
    """Self-attention inside windows of ``win_size``² tokens with a
    relative-position bias and, when ``sparse``, the softmax/relu² mix.
    x: (B * nW, N, C) -> (B * nW, N, C)."""

    def __init__(self, dim: int, win_size: int, num_heads: int,
                 sparse: bool = True, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.qkv = LinearProjection(dim, device=device)
        self.proj = Linear(dim, dim, device=device)
        self.relative_position_bias_table = nn.Parameter(torch.zeros(
            (2 * win_size - 1) ** 2, num_heads, device=device))
        self.w = (nn.Parameter(torch.ones(2, device=device)) if sparse
                  else None)
        # recomputed from win_size, so not saved (the reference's buffer is
        # dropped on load, tools.convert.load_reference_state_dict)
        self.register_buffer(
            "relative_position_index",
            torch.from_numpy(relative_position_index(win_size, win_size)).to(
                device), persistent=False)

    def bias(self):
        """(heads, N, N) f32 relative-position bias."""
        n = self.relative_position_index.shape[0]
        b = self.relative_position_bias_table[
            self.relative_position_index.view(-1)]
        return b.view(n, n, -1).permute(2, 0, 1)

    def forward(self, x, mask=None, use_kernels: bool = True):
        c = x.shape[-1]
        nh = self.num_heads
        q = split_heads(self.qkv.to_q(x), nh)
        kv = self.qkv.to_kv(x)
        k, v = split_heads(kv[..., :c], nh), split_heads(kv[..., c:], nh)
        attend = window_attention if use_kernels else window_attention_plain
        out = attend(q, k, v, self.bias(), scale=self.scale,
                     sparse_w=self.w, mask=mask)
        return self.proj(merge_heads(out))
