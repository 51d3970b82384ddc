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

``remat`` (``ops.layers.make_remat``, policy None/"full" or "dots")
checkpoints every block, as the JAX layer does, but where a block is
LN+LeFF alone (an encoder level: no attention, the LeFF token MLP) on the
LN+LeFF kernel: its autograd Function keeps x and the operands, so a
checkpoint would only replay the kernel (the JAX layer's stage-hoisted
path).  On the card the attention blocks then run ``window_attention`` and
``ln_leff`` again in the backward; on the CPU every block recomputes.  The
recompute draws the forward's DropPath decisions again.
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
from ..ops.fused_leff import ln_leff_rows
from ..ops.layers import (
    Conv2d,
    ConvTranspose2d,
    TokenLayerNorm,
    make_remat,
    no_remat,
)
from ..parallel import cp_ops
from .blocks import WindowAttentionSparse, _image, _tokens, make_token_mlp


def trunc_normal_(p, generator: torch.Generator, std: float = 0.02,
                  bound: float = 2.0):
    """Fill ``p`` with N(0, std) truncated to [-bound, bound] (timm's
    ``trunc_normal_``), drawn from ``generator``: the entries drawn outside
    are drawn again until none is."""
    dev = generator.device
    r = torch.randn(p.shape, generator=generator, device=dev) * std
    out = r.abs() > bound
    while bool(out.any()):
        r[out] = torch.randn(int(out.sum()), generator=generator,
                             device=dev) * std
        out = r.abs() > bound
    p.copy_(r)


class ASTInputProj(nn.Module):
    """conv3x3 + LeakyReLU(0.01) -> tokens."""

    def __init__(self, cin: int, cout: int, device=None):
        super().__init__()
        self.proj = nn.Sequential(Conv2d(cin, cout, 3, padding=1,
                                         device=device))

    def forward(self, x, cp=None):
        """NCHW (the rank's band of rows with ``cp``) -> tokens."""
        return _tokens(leaky_relu(cp_ops.conv(self.proj[0], x, cp), 0.01))


class ASTOutputProj(nn.Module):
    """tokens -> conv3x3 -> NCHW."""

    def __init__(self, cin: int, cout: int, device=None):
        super().__init__()
        self.proj = nn.Sequential(Conv2d(cin, cout, 3, padding=1,
                                         device=device))

    def forward(self, x, cp=None):
        return cp_ops.conv(self.proj[0], _image(x, cp), cp)


class ASTDownsample(nn.Module):
    """tokens -> conv4x4 stride 2 pad 1 -> tokens."""

    def __init__(self, cin: int, cout: int, device=None):
        super().__init__()
        self.conv = nn.Sequential(Conv2d(cin, cout, 4, stride=2, padding=1,
                                         device=device))

    def forward(self, x, cp=None):
        """With ``cp`` the rank's band, of an even number of rows (one halo
        row each side: output row o reads rows 2o - 1 to 2o + 2)."""
        return _tokens(cp_ops.conv(self.conv[0], _image(x, cp), cp))


class ASTUpsample(nn.Module):
    """tokens -> transposed conv2x2 stride 2 -> tokens."""

    def __init__(self, cin: int, cout: int, device=None):
        super().__init__()
        self.deconv = nn.Sequential(ConvTranspose2d(cin, cout, 2, stride=2,
                                                    device=device))

    def forward(self, x, cp=None):
        """Row-local: a band of rows gives twice its rows."""
        return _tokens(self.deconv(_image(x, cp)))


class ASTTransformerBlock(nn.Module):
    """(Shifted-)window attention when ``att``, then LayerNorm + token MLP,
    each a residual branch."""

    # the model's remat transform (``AST(remat=True)``)
    remat = staticmethod(no_remat)

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

    def forward(self, x, use_kernels: bool = True, generator=None, cp=None):
        """``cp``: the tokens are the rank's band of the map's rows (a
        multiple of the window where the block attends): the rolls move a
        halo strip, the attention takes the band's windows and their rows
        of the shift mask, LN+LeFF the band with a halo row each side.
        Checkpointed under remat unless the block is LN+LeFF alone on its
        kernel."""
        rt = (no_remat if not self.att and self.token_mlp == "leff"
              and use_kernels and x.is_cuda else self.remat)
        return rt(self._forward)(x, use_kernels, generator, cp)

    def _forward(self, x, use_kernels, generator, cp):
        b, l, c = x.shape
        h, w = cp_ops.band_shape(l, cp)
        ws, ss = self.win_size, self.shift_size
        if self.att:
            mask = (shift_mask(h * cp_ops.context_size(cp), w, ws, ss,
                               x.device, cp) if ss > 0 else None)
            img = tokens_to_image(self.norm1(x), h, w)
            if ss > 0:
                img = cp_ops.roll2d(img, -ss, -ss, cp)
            wins = window_partition(img, ws).reshape(-1, ws * ws, c)
            wins = self.attn(wins, mask=mask, use_kernels=use_kernels)
            img = window_reverse(wins.reshape(-1, ws, ws, c), ws, h, w)
            if ss > 0:
                img = cp_ops.roll2d(img, ss, ss, cp)
            x = x + self.drop_path(image_to_tokens(img), generator)
        if self.token_mlp != "leff":
            return x + self.drop_path(self.mlp(self.norm2(x), cp), generator)
        y = ln_leff_rows(tokens_to_image(x, h, w), self.norm2.weight,
                         self.norm2.bias, *self.mlp.operands(),
                         s=self.drop_path.sample_scale(b, generator),
                         eps=self.norm2.eps, cp=cp,
                         fn=ln_leff if use_kernels else ln_leff_plain)
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

    def forward(self, x, use_kernels: bool = True, generator=None, cp=None):
        for block in self.blocks:
            x = block(x, use_kernels, generator, cp)
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
                 compute_dtype: torch.dtype = torch.float32, device=None,
                 cp=None, remat: bool = False, remat_policy=None):
        super().__init__()
        e, s, d, nh = embed_dim, img_size, depths, num_heads
        # the rank's place on the context dimension: the forward takes and
        # gives the rank's band of the images' rows (not a module: the
        # state_dict is the single-device one)
        self.cp = cp
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
        rt = make_remat(remat, remat_policy)
        for m in self.modules():
            if isinstance(m, ASTTransformerBlock):
                m.remat = rt

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        """The reference's init from an explicit generator: torch's default
        for every conv (weight and bias U(+-1/sqrt(fan_in)), fan_in of the
        weight's dim 1, as torch counts it for transposed convs too), then
        trunc_normal(0.02) on every Linear weight with a zero bias; the
        bias tables trunc_normal(0.02), ``w`` ones, LayerNorm ones/zeros.
        The truncation is at +-2 (100 std): no draw reaches it."""
        dev = generator.device
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                bound = 1.0 / math.sqrt(m.weight[0].numel())
                for p in (m.weight, m.bias):
                    if p is not None:
                        r = torch.rand(p.shape, generator=generator,
                                       device=dev)
                        p.copy_((r * 2 - 1) * bound)
            elif isinstance(m, nn.Linear):
                trunc_normal_(m.weight, generator)
                m.bias.zero_()
            elif isinstance(m, WindowAttentionSparse):
                trunc_normal_(m.relative_position_bias_table, generator)

    def _level_banded(self, layer: BasicASTLayer, side: int) -> bool:
        """Whether a level of ``side`` rows runs on the ranks' bands: the
        context group divides its rows, and where it attends, each band
        holds whole windows (else the level runs whole on every rank)."""
        blk = layer.blocks[0]
        return cp_ops.cp_spatial_viable(
            side, self.cp, multiple=blk.win_size if blk.att else 1)

    def forward(self, x, use_kernels: bool = True,
                generator: torch.Generator | None = None):
        """``generator``: where DropPath draws in training mode (required
        there at a non-zero ``drop_path_rate``; unused at inference).  With
        ``cp`` (context parallelism) x is the rank's band of the images'
        rows, rows [c S/n, (c+1) S/n), and so is the output."""
        cp = self.cp if cp_ops.context_size(self.cp) > 1 else None
        n = cp_ops.context_size(cp)
        if (x.shape[-2] * n, x.shape[-1]) != (self.img_size, self.img_size):
            raise ValueError(f"AST(img_size={self.img_size}) takes "
                             f"{self.img_size}x{self.img_size} images"
                             + (f" as bands of {self.img_size // n} rows on "
                                f"{n} ranks" if n > 1 else "")
                             + f", got {tuple(x.shape[-2:])}")
        k, g, s = use_kernels, generator, self.img_size
        x = x.to(self.compute_dtype)
        enc = [getattr(self, f"encoderlayer_{i}") for i in range(4)]
        dec = [getattr(self, f"decoderlayer_{i}") for i in range(4)]
        lay = ([self._level_banded(enc[i], s >> i) for i in range(4)]
               + [self._level_banded(self.conv, s >> 4)]
               + [self._level_banded(dec[i], s >> (3 - i))
                  for i in range(4)])
        top = cp is not None
        y = cp_ops.between(self.input_proj, x, cp, top, lay[0], 2, 1)
        skips = []
        for i in range(4):
            y = enc[i](y, k, g, cp if lay[i] else None)
            skips.append(y)
            y = cp_ops.between(getattr(self, f"dowsample_{i}"), y, cp,
                               lay[i], lay[i + 1])
        y = self.conv(y, k, g, cp if lay[4] else None)
        for i in range(4):
            y = cp_ops.between(getattr(self, f"upsample_{i}"), y, cp,
                               lay[4 + i], lay[5 + i])
            skip = cp_ops.relayout(skips[3 - i], cp, lay[3 - i], lay[5 + i])
            y = dec[i](torch.cat([y, skip], -1), k, g,
                       cp if lay[5 + i] else None)
        y = cp_ops.between(self.output_proj, y, cp, lay[8], top, 1, 2)
        return x + y if self.dd_in == 3 else y
