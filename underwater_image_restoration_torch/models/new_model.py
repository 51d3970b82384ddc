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

``remat`` (``ops.layers.make_remat``, policy None/"full" or "dots")
checkpoints every encoder and decoder block, the bottleneck excepted, as the
JAX model does: on the card their ``ln_leff`` and window attentions run
again in the backward, with the forward's DropPath decisions.
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
from ..ops.fused_leff import ln_leff_rows
from ..ops.layers import Linear, TokenLayerNorm, make_remat, no_remat
from ..ops.wavelets import dwt2d, idwt2d
from ..parallel import cp_ops
from .blocks import (
    MDASSA,
    Downsample,
    InputProjection,
    OutputProjection,
    Upsample,
    WindowAttentionSparse,
    make_token_mlp,
)


def _ln_mlp(norm, mlp, x, use_kernels, s=None, residual=True, cp=None):
    """LayerNorm + LeFF through ``ops.ln_leff`` (or its plain version) on
    contiguous channels-last tokens (the rank's band with ``cp``, a halo
    row each side); returns tokens."""
    h, w = cp_ops.band_shape(x.shape[1], cp)
    y = ln_leff_rows(tokens_to_image(x, h, w), norm.weight, norm.bias,
                     *mlp.operands(), s=s, residual=residual, eps=norm.eps,
                     cp=cp, fn=ln_leff if use_kernels else ln_leff_plain)
    return image_to_tokens(y)


class EncoderBlock(nn.Module):
    """shortcut + DropPath(frequency branch) + DropPath(spatial branch)."""

    # the model's remat transform (``NewFamily(remat=True)``)
    remat = staticmethod(no_remat)

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

    def forward(self, x, use_kernels: bool = True, generator=None, cp=None):
        """``cp``: the tokens are the rank's band of the map's rows (an
        even number in the Wavelet mode): LN+LeFF and the token MLPs' taps
        read a halo row each side, the Haar DWT is the band's own, the
        IDWT runs on the gathered half-size map (its backward, the
        reference's quirk, mixes rows across the map), and the Fourier
        mode's (L, C) FFT is distributed over the sharded L."""
        return self.remat(self._forward)(x, use_kernels, generator, cp)

    def _forward(self, x, use_kernels, generator, cp):
        b, l, c = x.shape
        h, w = cp_ops.band_shape(l, cp)
        if self.token_mlp == "leff":
            # the unscaled branch also feeds the Fourier quirk, so DropPath
            # stays outside the kernel
            sp = _ln_mlp(self.norm1, self.mlp, x, use_kernels,
                         residual=False, cp=cp)
        else:
            sp = self.mlp(self.norm1(x), cp)
        if self.use_dwt == "Wavelet":
            fx = image_to_tokens(dwt2d(tokens_to_image(self.norm2(x), h, w)))
        elif self.use_dwt == "Fourier":
            fx = cp_ops.fftn_real_tokens(sp, cp=cp)
        else:
            fx = self.norm2(x)
        fx = self.freq_mlp(fx, cp)
        if self.use_dwt == "Wavelet":
            fx = cp_ops.gather_rows(tokens_to_image(fx, h // 2, w // 2), cp)
            fx = image_to_tokens(cp_ops.slice_rows(idwt2d(fx), cp))
        elif self.use_dwt == "Fourier":
            fx = cp_ops.fftn_real_tokens(fx, inverse=True, cp=cp)
        fx = self.drop_path2(fx, generator)
        return x + fx + self.drop_path(sp, generator)


class DecoderBlock(nn.Module):
    """Concat the skip, LayerNorm + MDASSA with its residual, LayerNorm +
    token MLP with its residual, Linear back to ``dim``."""

    # the model's remat transform (``NewFamily(remat=True)``; never the
    # bottleneck's)
    remat = staticmethod(no_remat)

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
                generator=None, cp=None):
        """``cp``: the tokens are the rank's band of the map's rows (a
        multiple of the window)."""
        return self.remat(self._forward)(x, enc_out, use_kernels, generator,
                                         cp)

    def _forward(self, x, enc_out, use_kernels, generator, cp):
        if enc_out is not None:
            x = torch.cat([x, enc_out], -1)
        x = self.mdassa(self.norm1(x), use_kernels, cp) + x
        if self.token_mlp == "leff":
            x = _ln_mlp(self.norm2, self.mlp, x, use_kernels,
                        s=self.drop_path.sample_scale(x.shape[0], generator),
                        cp=cp)
        else:
            x = x + self.drop_path(self.mlp(self.norm2(x), cp), generator)
        return self.mlp_proj(x)


class NewFamily(nn.Module):
    """The shared skeleton, NCHW in [-1, 1], (B, 3, S, S) -> (B, 3, S, S)
    with S = img_size."""

    def __init__(self, img_size: int = 256, dd_in: int = 3,
                 embed_dim: int = 32, drop_path_rate: float = 0.1,
                 use_dwt: str = "Fourier", token_mlp: str = "leff",
                 blocks_per_level: int = 1,
                 compute_dtype: torch.dtype = torch.float32, device=None,
                 cp=None, remat: bool = False, remat_policy=None):
        super().__init__()
        e, s, tm = embed_dim, img_size, token_mlp
        self.img_size, self.compute_dtype = img_size, compute_dtype
        self.embed_dim, self.use_dwt = embed_dim, use_dwt
        # the rank's place on the context dimension: the forward takes and
        # gives the rank's band of the images' rows (not a module: the
        # state_dict is the single-device one)
        self.cp = cp
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
        rt = make_remat(remat, remat_policy)
        for m in self.modules():
            if isinstance(m, (EncoderBlock, DecoderBlock)) and \
                    m is not self.bottleneck:
                m.remat = rt

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

    def _level_banded(self, side: int, win: int = 0, dim: int = 0) -> bool:
        """Whether a level of ``side`` rows runs on the ranks' bands: the
        context group divides its rows, each band holds whole windows of
        ``win`` where the level attends and an even number of rows in the
        Wavelet mode (the Haar transforms pair rows), and the group divides
        the ``dim`` channels of an encoder's Fourier token FFT (else the
        level runs whole on every rank)."""
        cp = self.cp
        mult = max(win, 2 if self.use_dwt == "Wavelet" else 1)
        if dim and self.use_dwt == "Fourier" and \
                dim % cp_ops.context_size(cp):
            return False
        return cp_ops.cp_spatial_viable(side, cp, multiple=mult)

    def forward(self, x, use_kernels: bool = True,
                generator: torch.Generator | None = None):
        """``generator``: where DropPath draws in training mode (required
        there at a non-zero ``drop_path_rate``; unused at inference).  With
        ``cp`` (context parallelism) x is the rank's band of the images'
        rows, rows [c S/n, (c+1) S/n), and so is the output."""
        cp = self.cp if cp_ops.context_size(self.cp) > 1 else None
        n = cp_ops.context_size(cp)
        if (x.shape[-2] * n, x.shape[-1]) != (self.img_size, self.img_size):
            raise ValueError(f"{type(self).__name__}(img_size="
                             f"{self.img_size}) takes {self.img_size}x"
                             f"{self.img_size} images"
                             + (f" as bands of {self.img_size // n} rows on "
                                f"{n} ranks" if n > 1 else "")
                             + f", got {tuple(x.shape[-2:])}")
        k, g, s, e = use_kernels, generator, self.img_size, self.embed_dim
        x = x.to(self.compute_dtype)
        enc = [self._level_banded(s >> lvl, dim=e << lvl) for lvl in range(4)]
        mid = self._level_banded(s >> 4, self.bottleneck.mdassa.win_size)
        dec = [self._level_banded(s >> lvl, getattr(
            self, f"decoder_{lvl}").mdassa.win_size) for lvl in range(4)]
        top = cp is not None
        y = cp_ops.between(self.input_proj, x, cp, top, enc[0], 2, 1)
        skips = []
        for lvl in range(4):
            for name in self._names("encoder", lvl):
                y = getattr(self, name)(y, k, g, cp if enc[lvl] else None)
            skips.append(y)
            y = cp_ops.between(getattr(self, f"downsample_{lvl}"), y, cp,
                               enc[lvl], enc[lvl + 1] if lvl < 3 else mid)
        y = self.bottleneck(y, None, k, g, cp if mid else None)
        cur = mid
        for lvl in range(3, -1, -1):
            y = cp_ops.between(getattr(self, f"upsample_{lvl}"), y, cp, cur,
                               dec[lvl])
            cur = dec[lvl]
            for i, name in enumerate(self._names("decoder", lvl)):
                skip = None if i else cp_ops.relayout(skips[lvl], cp,
                                                      enc[lvl], cur)
                y = getattr(self, name)(y, skip, k, g, cp if cur else None)
        return cp_ops.between(self.output_proj, y, cp, cur, top, 1, 2) + x


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
