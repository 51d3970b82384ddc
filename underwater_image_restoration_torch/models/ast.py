"""AST, the Adaptive Sparse Transformer U-Net (NCHW in and out), counterpart
of the JAX package's ``models/ast.py:85-366``.

Four FFN-only encoder levels, a bottleneck and four decoder levels with
shifted-window sparse attention, channel-concat skips and a global
residual.  Inside, activations are channels-last tokens (B, L, C); the
convolutions see them as NCHW views with channels-last strides.  Parameter
names and layouts are the reference's (``tools.convert``).  Parameters are
f32; ``compute_dtype`` is the type of the activations.

Every block sends LayerNorm + LeFF to ``ops.ln_leff`` and its window
attention core to ``ops.window_attention``: the CUDA kernels for CUDA
tensors, the plain versions for CPU ones.  ``forward(x,
use_kernels=False)`` takes the plain versions on any device.

Kept quirks of the reference: odd blocks of a level shift by win // 2; a
level whose resolution is at most the window uses one window of the whole
map and no shift; ``mlp_ratio`` is not passed to the blocks, which use 4.
DropPath is the identity at inference.  In training mode (``train()``, as
the train step runs it) each block draws its two DropPath decisions, the
attention branch's then the LeFF branch's (the JAX block's order), from the
``generator`` that ``forward`` threads through the layers; both routes
(``use_kernels`` True or False) draw the same numbers.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..ops import (
    DropPath,
    image_to_tokens,
    leaky_relu,
    ln_leff,
    ln_leff_plain,
    shift_mask,
    tokens_to_image,
    window_partition,
    window_reverse,
)
from ..ops.layers import Conv2d, ConvTranspose2d, TokenLayerNorm
from .blocks import WindowAttentionSparse, _image, _tokens, make_token_mlp


class ASTInputProj(nn.Module):
    """conv3x3 + LeakyReLU(0.01) -> tokens."""

    def __init__(self, cin: int, cout: int, device=None):
        super().__init__()
        self.proj = nn.Sequential(Conv2d(cin, cout, 3, padding=1,
                                         device=device))

    def forward(self, x):
        return _tokens(leaky_relu(self.proj(x), 0.01))


class ASTOutputProj(nn.Module):
    """tokens -> conv3x3 -> NCHW."""

    def __init__(self, cin: int, cout: int, device=None):
        super().__init__()
        self.proj = nn.Sequential(Conv2d(cin, cout, 3, padding=1,
                                         device=device))

    def forward(self, x):
        return self.proj(_image(x))


class ASTDownsample(nn.Module):
    """tokens -> conv4x4 stride 2 pad 1 -> tokens."""

    def __init__(self, cin: int, cout: int, device=None):
        super().__init__()
        self.conv = nn.Sequential(Conv2d(cin, cout, 4, stride=2, padding=1,
                                         device=device))

    def forward(self, x):
        return _tokens(self.conv(_image(x)))


class ASTUpsample(nn.Module):
    """tokens -> transposed conv2x2 stride 2 -> tokens."""

    def __init__(self, cin: int, cout: int, device=None):
        super().__init__()
        self.deconv = nn.Sequential(ConvTranspose2d(cin, cout, 2, stride=2,
                                                    device=device))

    def forward(self, x):
        return _tokens(self.deconv(_image(x)))


class ASTTransformerBlock(nn.Module):
    """(Shifted-)window attention when ``att``, then LayerNorm + token MLP,
    each a residual branch."""

    def __init__(self, dim: int, input_resolution: int, num_heads: int,
                 win_size: int = 8, shift_size: int = 0,
                 mlp_ratio: float = 4.0, drop_path: float = 0.0,
                 token_mlp: str = "leff", att: bool = True,
                 sparse_att: bool = False, device=None):
        super().__init__()
        if input_resolution <= win_size:
            shift_size, win_size = 0, input_resolution
        self.win_size, self.shift_size = win_size, shift_size
        self.att = att
        self.token_mlp = token_mlp
        if att:
            self.norm1 = TokenLayerNorm(dim, device=device)
            self.attn = WindowAttentionSparse(dim, win_size, num_heads,
                                              sparse=sparse_att,
                                              device=device)
        self.drop_path = DropPath(drop_path)
        self.norm2 = TokenLayerNorm(dim, device=device)
        self.mlp = make_token_mlp(token_mlp, dim, int(dim * mlp_ratio),
                                  device=device)

    def forward(self, x, use_kernels: bool = True, generator=None):
        b, l, c = x.shape
        h = w = math.isqrt(l)
        ws, ss = self.win_size, self.shift_size
        if self.att:
            mask = shift_mask(h, w, ws, ss, x.device) if ss > 0 else None
            img = tokens_to_image(self.norm1(x), h, w)
            if ss > 0:
                img = torch.roll(img, (-ss, -ss), (1, 2))
            wins = window_partition(img, ws).reshape(-1, ws * ws, c)
            wins = self.attn(wins, mask=mask, use_kernels=use_kernels)
            img = window_reverse(wins.reshape(-1, ws, ws, c), ws, h, w)
            if ss > 0:
                img = torch.roll(img, (ss, ss), (1, 2))
            x = x + self.drop_path(image_to_tokens(img), generator)
        if self.token_mlp != "leff":
            return x + self.drop_path(self.mlp(self.norm2(x)), generator)
        leff = ln_leff if use_kernels else ln_leff_plain
        y = leff(tokens_to_image(x, h, w), self.norm2.weight, self.norm2.bias,
                 *self.mlp.operands(),
                 s=self.drop_path.sample_scale(b, generator),
                 eps=self.norm2.eps)
        return image_to_tokens(y)


class BasicASTLayer(nn.Module):
    """``depth`` blocks; odd ones shift by win // 2 when ``shift_flag``."""

    def __init__(self, dim: int, input_resolution: int, depth: int,
                 num_heads: int, win_size: int,
                 drop_path: Sequence[float] = (0.0,),
                 token_mlp: str = "leff", shift_flag: bool = True,
                 att: bool = False, sparse_att: bool = False, device=None):
        super().__init__()
        self.blocks = nn.ModuleList([
            ASTTransformerBlock(
                dim, input_resolution, num_heads, win_size,
                shift_size=win_size // 2 if shift_flag and i % 2 else 0,
                drop_path=float(drop_path[min(i, len(drop_path) - 1)]),
                token_mlp=token_mlp, att=att, sparse_att=sparse_att,
                device=device)
            for i in range(depth)])

    def forward(self, x, use_kernels: bool = True, generator=None):
        for block in self.blocks:
            x = block(x, use_kernels, generator)
        return x


class AST(nn.Module):
    """NCHW in [-1, 1], (B, 3, S, S) -> (B, 3, S, S) with S = img_size."""

    def __init__(self, img_size: int = 256, in_chans: int = 3,
                 dd_in: int = 3, embed_dim: int = 32,
                 depths: Sequence[int] = (2, 2, 2, 2, 2, 2, 2, 2, 2),
                 num_heads: Sequence[int] = (1, 2, 4, 8, 16, 16, 8, 4, 2),
                 win_size: int = 8, mlp_ratio: float = 4.0,
                 drop_path_rate: float = 0.1, token_mlp: str = "leff",
                 shift_flag: bool = True,
                 compute_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        e, s, d, nh = embed_dim, img_size, depths, num_heads
        # mlp_ratio is taken and, as in the reference, not passed on
        self.img_size, self.dd_in = img_size, dd_in
        self.compute_dtype = compute_dtype
        enc_dpr = list(np.linspace(0.0, drop_path_rate, sum(d[:4])))
        dec_dpr = enc_dpr[::-1]
        starts = np.cumsum((0,) + tuple(d[:4]))
        dstarts = np.cumsum((0,) + tuple(d[5:]))

        def layer(i, dim, reso, dpr, att):
            return BasicASTLayer(dim, reso, d[i], nh[i], win_size,
                                 drop_path=dpr, token_mlp=token_mlp,
                                 shift_flag=shift_flag, att=att,
                                 sparse_att=att, device=device)

        self.input_proj = ASTInputProj(in_chans, e, device=device)
        for i in range(4):
            setattr(self, f"encoderlayer_{i}", layer(
                i, e << i, s >> i, enc_dpr[starts[i]:starts[i + 1]], False))
            setattr(self, f"dowsample_{i}", ASTDownsample(
                e << i, e << (i + 1), device=device))
        self.conv = layer(4, e << 4, s >> 4, [drop_path_rate] * d[4], True)
        for i in range(4):
            cin = (e << 4) if i == 0 else (e << (5 - i))
            setattr(self, f"upsample_{i}", ASTUpsample(
                cin, e << (3 - i), device=device))
            setattr(self, f"decoderlayer_{i}", layer(
                5 + i, e << (4 - i), s >> (3 - i),
                dec_dpr[dstarts[i]:dstarts[i + 1]], True))
        self.output_proj = ASTOutputProj(2 * e, in_chans, device=device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        """The reference's init from an explicit generator: torch's default
        for every conv (weight and bias U(+-1/sqrt(fan_in)), fan_in of the
        weight's dim 1, as torch counts it for transposed convs too), then
        trunc_normal(0.02) on every Linear weight with a zero bias; the
        bias tables trunc_normal(0.02), ``w`` ones, LayerNorm ones/zeros.
        The truncation at +-2 (100 std) is a clamp here: no draw reaches
        it."""
        dev = generator.device

        def normal(p, std=0.02):
            r = torch.randn(p.shape, generator=generator, device=dev)
            p.copy_((r * std).clamp_(-2.0, 2.0))

        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                bound = 1.0 / math.sqrt(m.weight[0].numel())
                for p in (m.weight, m.bias):
                    if p is not None:
                        r = torch.rand(p.shape, generator=generator,
                                       device=dev)
                        p.copy_((r * 2 - 1) * bound)
            elif isinstance(m, nn.Linear):
                normal(m.weight)
                m.bias.zero_()
            elif isinstance(m, WindowAttentionSparse):
                normal(m.relative_position_bias_table)

    def forward(self, x, use_kernels: bool = True,
                generator: torch.Generator | None = None):
        """``generator``: where DropPath draws in training mode (required
        there at a non-zero ``drop_path_rate``; unused at inference)."""
        if x.shape[-2:] != (self.img_size, self.img_size):
            raise ValueError(f"AST(img_size={self.img_size}) takes "
                             f"{self.img_size}x{self.img_size} images, got "
                             f"{tuple(x.shape[-2:])}")
        k, g = use_kernels, generator
        x = x.to(self.compute_dtype)
        skips = []
        y = self.input_proj(x)
        for i in range(4):
            y = getattr(self, f"encoderlayer_{i}")(y, k, g)
            skips.append(y)
            y = getattr(self, f"dowsample_{i}")(y)
        y = self.conv(y, k, g)
        for i in range(4):
            y = torch.cat([getattr(self, f"upsample_{i}")(y), skips[3 - i]],
                          -1)
            y = getattr(self, f"decoderlayer_{i}")(y, k, g)
        y = self.output_proj(y)
        return x + y if self.dd_in == 3 else y
