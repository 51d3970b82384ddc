"""The New* family (NCHW in and out): NewModel, NewBigModel and
NewBigFRFNModel, counterparts of the JAX package's ``models/new_model.py``
(``EncoderBlock:61``, ``DecoderBlock:127``, ``_NewFamilyBase:206``).

A token U-Net: an input projection, four encoder levels of parallel
spatial (LayerNorm + token MLP) and frequency (DWT or FFT, token MLP,
inverse) branches, a bottleneck and four decoder levels of MDASSA
attention plus LayerNorm + token MLP, channel-concat skips, an output
projection and a global residual.  NewBigModel and NewBigFRFNModel take
two blocks a level (the second encoder at the first level's drop-path
rate), NewBigFRFNModel FRFN token MLPs.  Activations are channels-last
tokens; parameter names and layouts are the reference's
(``tools.convert``).  Parameters are f32; ``compute_dtype`` is the type of
the activations.

On the kernels' path (``use_kernels``, the default, with CUDA tensors) each
LeFF that follows a LayerNorm goes to ``ops.ln_leff`` (the encoders'
without the residual, the decoders' with it and DropPath's scale) and every
window attention to ``ops.window_attention`` (two a decoder, self and
cross, at head widths up to 128); ``use_kernels=False`` takes the plain
versions on any device.  Everything else is plain torch, as in the JAX
package.

Kept quirks of the reference: the encoders' Fourier mode transforms the
spatial branch's output over the (L, C) token axes, real part, in f32, and
then never uses ``norm2`` (its parameters stay and get no gradient: zeros
in ``train.make_train_step``); the decoders apply LayerNorm twice before
the attention (theirs and MDASSA's), their MLP residual adds
``x + shortcut`` (the reference's ``y`` and ``x`` are one expression), and
their DropPath rate is 0 (the reference passes none); a level whose side
is at most the window takes one window of the whole map.  In training mode
(``train()``) an encoder draws the frequency branch's DropPath, then the
spatial branch's (the order of the JAX return ``shortcut + dp2(freq) +
dp1(x)``), from the ``generator`` that ``forward`` threads through the
blocks, on both routes alike.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..ops import (
    DropPath,
    image_to_tokens,
    ln_leff,
    ln_leff_plain,
    tokens_to_image,
)
from ..ops.layers import Linear, TokenLayerNorm
from ..ops.wavelets import dwt2d, idwt2d
from .blocks import (
    MDASSA,
    Downsample,
    InputProjection,
    OutputProjection,
    Upsample,
    WindowAttentionSparse,
    _fft_real,
    make_token_mlp,
)


def _fft_tokens_real(x, inverse: bool = False):
    """real(fftn) (or of ifftn) of (B, L, C) tokens over their (L, C) axes,
    in f32, rounded to x's dtype."""
    return _fft_real(x, inverse, (-2, -1))


def _ln_mlp(norm, mlp, x, use_kernels, s=None, residual=True):
    """LayerNorm + LeFF through ``ops.ln_leff`` (or its plain version) on
    contiguous channels-last tokens; returns tokens."""
    b, l, c = x.shape
    h = math.isqrt(l)
    leff = ln_leff if use_kernels else ln_leff_plain
    y = leff(tokens_to_image(x, h, h), norm.weight, norm.bias,
             *mlp.operands(), s=s, residual=residual, eps=norm.eps)
    return image_to_tokens(y)


class EncoderBlock(nn.Module):
    """shortcut + DropPath(frequency branch) + DropPath(spatial branch)."""

    def __init__(self, dim: int, token_mlp: str = "leff",
                 freq_mlp: str = "leff", drop_path: float = 0.0,
                 use_dwt: str = "Fourier", device=None):
        super().__init__()
        hidden = 4 * dim
        self.token_mlp, self.use_dwt = token_mlp, use_dwt
        self.norm1 = TokenLayerNorm(dim, device=device)
        self.norm2 = TokenLayerNorm(dim, device=device)
        self.mlp = make_token_mlp(token_mlp, dim, hidden, device=device)
        self.freq_mlp = make_token_mlp(freq_mlp, dim, hidden, device=device)
        self.drop_path = DropPath(drop_path)
        self.drop_path2 = DropPath(drop_path)

    def forward(self, x, use_kernels: bool = True, generator=None):
        b, l, c = x.shape
        h = math.isqrt(l)
        if self.token_mlp == "leff":
            # the unscaled branch also feeds the Fourier quirk, so DropPath
            # stays outside the kernel
            sp = _ln_mlp(self.norm1, self.mlp, x, use_kernels,
                         residual=False)
        else:
            sp = self.mlp(self.norm1(x))
        if self.use_dwt == "Wavelet":
            fx = image_to_tokens(dwt2d(tokens_to_image(self.norm2(x), h, h)))
        elif self.use_dwt == "Fourier":
            fx = _fft_tokens_real(sp)
        else:
            fx = self.norm2(x)
        fx = self.freq_mlp(fx)
        if self.use_dwt == "Wavelet":
            fx = image_to_tokens(idwt2d(tokens_to_image(fx, h // 2, h // 2)))
        elif self.use_dwt == "Fourier":
            fx = _fft_tokens_real(fx, inverse=True)
        fx = self.drop_path2(fx, generator)
        return x + fx + self.drop_path(sp, generator)


class DecoderBlock(nn.Module):
    """Concat the skip, LayerNorm + MDASSA with its residual, LayerNorm +
    token MLP with its residual, Linear back to ``dim``."""

    def __init__(self, dim: int, input_resolution: int, num_heads: int = 4,
                 win_size: int = 8, token_mlp: str = "leff",
                 drop_path: float = 0.0, enc_out: bool = True,
                 use_dwt: str = "Fourier", device=None):
        super().__init__()
        ws = min(win_size, input_resolution)
        mdim = 2 * dim if enc_out else dim
        self.token_mlp = token_mlp
        self.norm1 = TokenLayerNorm(mdim, device=device)
        self.mdassa = MDASSA(mdim, ws, num_heads, use_dwt, device=device)
        self.norm2 = TokenLayerNorm(mdim, device=device)
        self.mlp = make_token_mlp(token_mlp, mdim, 4 * mdim, device=device)
        self.drop_path = DropPath(drop_path)
        self.mlp_proj = Linear(mdim, dim, device=device)

    def forward(self, x, enc_out=None, use_kernels: bool = True,
                generator=None):
        if enc_out is not None:
            x = torch.cat([x, enc_out], -1)
        x = self.mdassa(self.norm1(x), use_kernels) + x
        if self.token_mlp == "leff":
            x = _ln_mlp(self.norm2, self.mlp, x, use_kernels,
                        s=self.drop_path.sample_scale(x.shape[0], generator))
        else:
            x = x + self.drop_path(self.mlp(self.norm2(x)), generator)
        return self.mlp_proj(x)


class NewFamily(nn.Module):
    """The shared skeleton, NCHW in [-1, 1], (B, 3, S, S) -> (B, 3, S, S)
    with S = img_size."""

    def __init__(self, img_size: int = 256, dd_in: int = 3,
                 embed_dim: int = 32, drop_path_rate: float = 0.1,
                 use_dwt: str = "Fourier", token_mlp: str = "leff",
                 blocks_per_level: int = 1,
                 compute_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        e, s, tm = embed_dim, img_size, token_mlp
        self.img_size, self.compute_dtype = img_size, compute_dtype
        self.blocks_per_level = blocks_per_level
        enc_dpr = np.linspace(0.0, drop_path_rate, 4)
        self.input_proj = InputProjection(dd_in, e, device=device)
        for lvl in range(4):
            dim = e << lvl
            for i, name in enumerate(self._names("encoder", lvl)):
                setattr(self, name, EncoderBlock(
                    dim, tm, tm, float(enc_dpr[0 if i else lvl]), use_dwt,
                    device=device))
            setattr(self, f"downsample_{lvl}", Downsample(dim, device=device))
        self.bottleneck = DecoderBlock(16 * e, s // 16, token_mlp=tm,
                                       enc_out=False, use_dwt=use_dwt,
                                       device=device)
        for lvl in range(3, -1, -1):
            dim = e << lvl
            setattr(self, f"upsample_{lvl}", Upsample(2 * dim, device=device))
            for i, name in enumerate(self._names("decoder", lvl)):
                setattr(self, name, DecoderBlock(
                    dim, s >> lvl, token_mlp=tm, enc_out=not i,
                    use_dwt=use_dwt, device=device))
        self.output_proj = OutputProjection(e, dd_in, device=device)

    def _names(self, kind, lvl):
        return [f"{kind}_{lvl}"] + [f"{kind}_{lvl}_{i}"
                                    for i in range(1, self.blocks_per_level)]

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        """The reference's init from an explicit generator: torch's default
        for every Linear and conv (weight and bias U(+-1/sqrt(fan_in))),
        the bias tables trunc_normal(0.02) (the truncation at +-2, 100 std,
        is a clamp here: no draw reaches it), ``w`` ones, LayerNorm
        ones/zeros."""
        dev = generator.device
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                bound = 1.0 / math.sqrt(m.weight[0].numel())
                for p in (m.weight, m.bias):
                    if p is not None:
                        r = torch.rand(p.shape, generator=generator,
                                       device=dev)
                        p.copy_((r * 2 - 1) * bound)
            elif isinstance(m, WindowAttentionSparse):
                t = m.relative_position_bias_table
                r = torch.randn(t.shape, generator=generator, device=dev)
                t.copy_((r * 0.02).clamp_(-2.0, 2.0))

    def forward(self, x, use_kernels: bool = True,
                generator: torch.Generator | None = None):
        """``generator``: where DropPath draws in training mode (required
        there at a non-zero ``drop_path_rate``; unused at inference)."""
        if x.shape[-2:] != (self.img_size, self.img_size):
            raise ValueError(f"{type(self).__name__}(img_size="
                             f"{self.img_size}) takes {self.img_size}x"
                             f"{self.img_size} images, got "
                             f"{tuple(x.shape[-2:])}")
        k, g = use_kernels, generator
        x = x.to(self.compute_dtype)
        y = self.input_proj(x)
        skips = []
        for lvl in range(4):
            for name in self._names("encoder", lvl):
                y = getattr(self, name)(y, k, g)
            skips.append(y)
            y = getattr(self, f"downsample_{lvl}")(y)
        y = self.bottleneck(y, None, k, g)
        for lvl in range(3, -1, -1):
            y = getattr(self, f"upsample_{lvl}")(y)
            for i, name in enumerate(self._names("decoder", lvl)):
                y = getattr(self, name)(y, None if i else skips[lvl], k, g)
        return self.output_proj(y) + x


class NewModel(NewFamily):
    """MyModel (reference model.py:162-274): img_size 256, one block a
    level, LeFF."""

    def __init__(self, img_size: int = 256, **kwargs):
        super().__init__(img_size=img_size, **kwargs)


class NewBigModel(NewFamily):
    """MyBigModel (reference model.py:277-463): img_size 512, two blocks a
    level, LeFF, its working forward (input_proj -> U-Net -> output_proj +
    x; the reference's own forward names undefined layers)."""

    def __init__(self, img_size: int = 512, **kwargs):
        super().__init__(img_size=img_size, blocks_per_level=2, **kwargs)


class NewBigFRFNModel(NewFamily):
    """MyBigFRFNModel (reference model.py:465-640): NewBigModel with FRFN
    token and frequency MLPs."""

    def __init__(self, img_size: int = 512, **kwargs):
        super().__init__(img_size=img_size, blocks_per_level=2,
                         token_mlp="frfn", **kwargs)
