"""SpectralTransformer (NCHW), counterpart of
the JAX package's ``models/spectral_transformer.py:601-905``.

A Restormer-style U-Net of SpectralBlocks (``x + MDTA(LN(x))``, then
``x + GDFN(LN(x))``) with FFT-based upsampling.  Parameter names and OIHW
layouts are the reference's, so a reference ``state_dict`` loads as it is
(``tools.convert``).  Parameters are f32; ``compute_dtype`` is the type of
the activations, as the JAX package's ``dtype``: convs run in it, LayerNorm
statistics and the UpS spectral path in f32.

Every block at every level sends both halves to ``ops.ln_mdta`` and
``ops.ln_gdfn``: the CUDA kernels for CUDA tensors, the plain versions for
CPU ones.  ``forward(x, use_kernels=False)`` takes the plain versions on any
device; tests and ``chip_smoke.py`` use it as the reference.

With ``cp`` (context parallelism, a ``core.meshes.ContextParallel``) the
forward takes and gives the rank's band of the images' rows.  A level runs
on bands where the group divides its rows and each band holds at least
``MDTA_HALO`` rows: the blocks through ``ln_mdta_rows`` (the attention's
stats summed over the ranks between the kernels' halves) and
``ln_gdfn_rows``, the 3x3 convs through ``cp_ops.conv`` (a halo row each
side), the pixel (un)shuffles and 1x1 convs on the band, the UpS FFT pair
through the distributed FFT (``cp_ops.fft2_chw``,
``cp_ops.spectral_tile_upsample``; the group also divides the level's
columns).  A level that cannot runs whole on every rank
(``cp_ops.between``, ``cp_ops.relayout``).

``remat`` (``ops.layers.make_remat``, policy None/"full" or "dots") mirrors
the JAX model's placement: the three UpS modules are always checkpointed
(their spectral path holds full-resolution complex intermediates), and a
SpectralBlock wherever its halves do not run on the kernels (the CPU, or
``use_kernels=False``).  On the card both halves always run the kernels,
whose autograd Functions keep x, the weights and the stats alone, so a
checkpoint there would only replay both kernel forwards (the JAX model's
``_remat_fused_blocks`` at its default): only the UpS recompute.

``inv_mag``, ``AGSSF`` and ``SFCA`` (reference SpectralTransformer.py:9-74,
the JAX package's ``:291-358``) are defined with the reference's parameter
names and, as there, never called by the model.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import (
    LayerNorm,
    fft2,
    gelu,
    ifft2,
    inv_mag,
    leaky_relu,
    pixel_shuffle,
    pixel_unshuffle,
    safe_abs,
    safe_angle,
)
from ..ops.fused_gdfn import ln_gdfn_rows
from ..ops.fused_mdta import MDTA_HALO, ln_mdta_rows
from ..ops.layers import Conv2d, make_remat, no_remat
from ..parallel import cp_ops


def _conv(cin, cout, k=1, groups=1, bias=False, device=None):
    return Conv2d(cin, cout, k, padding=k // 2, groups=groups, bias=bias,
                  device=device)


def _matrix(conv):
    """(Cin, Cout) matrix of a bias-free 1x1 conv."""
    return conv.weight[:, :, 0, 0].t()


def _taps(conv):
    """(3, 3, C) taps of a depthwise 3x3 conv."""
    return conv.weight[:, 0].permute(1, 2, 0)


def _conv_rows(module, x, cp):
    """A conv module on the whole map (its own forward, hooks included),
    or on the rank's band with the halo rows it reads (``cp_ops.conv``)."""
    return module(x) if cp is None else cp_ops.conv(module, x, cp)


class AGSSF(nn.Module):
    """ECA-style channel gate on the phase-only reconstruction (reference
    SpectralTransformer.py:15-41): sigmoid of a 1D conv over the channels
    of ``inv_mag(x)``'s spatial mean, times x.  ``conv`` is the reference's
    ``nn.Conv1d(1, 1, k, bias=False)``, k from the channel count."""

    def __init__(self, channels: int, b: int = 1, gamma: int = 2,
                 device=None):
        super().__init__()
        k = self.kernel_size(channels, b, gamma)
        self.conv = nn.Conv1d(1, 1, k, padding=(k - 1) // 2, bias=False,
                              device=device)

    @staticmethod
    def kernel_size(channels: int, b: int = 1, gamma: int = 2) -> int:
        """|log2(C) / gamma + b / gamma| truncated, made odd."""
        k = int(abs((math.log2(channels) / gamma) + b / gamma))
        return k if k % 2 else k + 1

    def forward(self, x):
        y = inv_mag(x).float().mean(dim=(2, 3))  # (B, C)
        y = F.conv1d(y[:, None], self.conv.weight.float(),
                     padding=self.conv.padding)[:, 0]
        gate = torch.sigmoid(y)[:, :, None, None]
        return (x.float() * gate).to(x.dtype)


class SFCA(nn.Module):
    """Dual spatial/frequency channel attention fused by a 1x1 and AGSSF
    (reference SpectralTransformer.py:43-74): a spatial branch (1x1 to 2C,
    leaky relu, grouped 3x3 to C, leaky relu, plus a 1x1 of x) and a
    frequency branch (real(fft2(x)), 1x1 to 2C, gelu, 1x1 to C,
    real(ifft2(.)), plus a 1x1 of x), concatenated, a 1x1 to C, then the
    gate.  The reference's chunk-and-cat after conv_1 is a no-op."""

    def __init__(self, channels: int, relu_slope: float = 0.2, device=None):
        super().__init__()
        c = channels
        self.relu_slope = relu_slope

        def conv(cin, cout, k=1, groups=1):
            return _conv(cin, cout, k, groups=groups, bias=True,
                         device=device)

        self.conv_1 = conv(c, 2 * c)
        self.conv_2 = conv(2 * c, c, 3, groups=c)
        self.identity1 = conv(c, c)
        self.conv_f1 = conv(c, 2 * c)
        self.conv_f2 = conv(2 * c, c)
        self.identity2 = conv(c, c)
        self.con2X1 = conv(2 * c, c)
        self.agssf = AGSSF(c, device=device)

    def forward(self, x):
        out = leaky_relu(self.conv_1(x), self.relu_slope)
        out = leaky_relu(self.conv_2(out), self.relu_slope)
        out = out + self.identity1(x)
        x_fft = fft2(x.float()).real.to(x.dtype)
        x_fft = self.conv_f2(gelu(self.conv_f1(x_fft)))
        recon = ifft2(x_fft.float()).real.to(x.dtype) + self.identity2(x)
        return self.agssf(self.con2X1(torch.cat([out, recon], dim=1)))


class MDTA(nn.Module):
    """Parameter holder of the MDTA half (reference names).  ``q1X1_1``
    belongs to the dead frequency-q chain: it is created so reference
    checkpoints load strict, and never used."""

    def __init__(self, c: int, num_heads: int, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.temperature = nn.Parameter(torch.ones(1, num_heads, 1, 1,
                                                   device=device))
        self.qkv = _conv(c, 3 * c, device=device)
        self.qkv_conv = _conv(3 * c, 3 * c, 3, groups=3 * c, device=device)
        self.project_out = _conv(c, c, device=device)
        self.q1X1_1 = _conv(c, c, device=device)
        self.kv = _conv(c, 2 * c, device=device)
        self.kv_conv = _conv(2 * c, 2 * c, 3, groups=2 * c, device=device)
        self.project_outf = _conv(c, c, device=device)

    def operands(self):
        return (_matrix(self.qkv), _taps(self.qkv_conv), self.temperature,
                _matrix(self.project_out), _matrix(self.kv),
                _taps(self.kv_conv), _matrix(self.project_outf))


class GDFN(nn.Module):
    """Parameter holder of the GDFN half (reference names)."""

    def __init__(self, c: int, expansion_factor: float, device=None):
        super().__init__()
        hid = int(c * expansion_factor)
        self.project_in = _conv(c, 2 * hid, device=device)
        self.conv = _conv(2 * hid, 2 * hid, 3, groups=2 * hid, device=device)
        self.project_out = _conv(hid, c, device=device)

    def operands(self):
        return (_matrix(self.project_in), _taps(self.conv),
                _matrix(self.project_out))


class SpectralBlock(nn.Module):
    """LN + MDTA residual, then LN + GDFN residual."""

    # the model's remat transform (``SpectralTransformer(remat=True)``)
    remat = staticmethod(no_remat)

    def __init__(self, c: int, num_heads: int, expansion_factor: float,
                 device=None):
        super().__init__()
        self.norm1 = LayerNorm(c, device=device)
        self.attn = MDTA(c, num_heads, device=device)
        self.norm2 = LayerNorm(c, device=device)
        self.ffn = GDFN(c, expansion_factor, device=device)

    def forward(self, x, use_kernels: bool = True, cp=None):
        """``cp``: x is the rank's band of the map's rows (at least
        MDTA_HALO); without it the whole map.  Checkpointed under remat
        unless both halves run on the kernels."""
        rt = no_remat if use_kernels and x.is_cuda else self.remat
        return rt(self._forward)(x, use_kernels, cp)

    def _forward(self, x, use_kernels, cp):
        x = ln_mdta_rows(x, self.norm1.weight, self.norm1.bias,
                         *self.attn.operands(), self.attn.num_heads, cp=cp,
                         use_kernels=use_kernels)
        return ln_gdfn_rows(x, self.norm2.weight, self.norm2.bias,
                            *self.ffn.operands(), cp=cp,
                            use_kernels=use_kernels)


class Stage(nn.Sequential):
    """A run of SpectralBlocks (reference ``nn.Sequential`` of blocks)."""

    def forward(self, x, use_kernels: bool = True, cp=None):
        for block in self:
            x = block(x, use_kernels, cp)
        return x


class DownSample(nn.Module):
    """conv3x3 C -> C/2, pixel_unshuffle(2): 2C at H/2 (on an even band,
    the band of the half map)."""

    def __init__(self, c: int, device=None):
        super().__init__()
        self.body = nn.Sequential(_conv(c, c // 2, 3, device=device))

    def forward(self, x, cp=None):
        return pixel_unshuffle(_conv_rows(self.body[0], x, cp), 2)


class SpectralUpSample(nn.Module):
    """FFT-domain 2x upsample: amplitude/phase 1x1 MLPs in f32, 2x2 tile,
    polar recombine, inverse FFT, then a 1x1 in the compute dtype."""

    def __init__(self, c: int, channel_red: bool, device=None):
        super().__init__()

        def fuse():
            return nn.Sequential(_conv(c, c, bias=True, device=device),
                                 nn.LeakyReLU(0.1),
                                 _conv(c, c, bias=True, device=device))

        self.amp_fuse = fuse()
        self.pha_fuse = fuse()
        self.post = _conv(c, c // 2 if channel_red else c, bias=True,
                          device=device)

    def forward(self, x, cp=None):
        """``cp``: x is the rank's band; the FFT pair is distributed (the
        amplitude and phase MLPs and the zero stuffing are the band's
        own)."""
        f = cp_ops.fft2_chw(x.float(), cp)
        mag = self.amp_fuse(safe_abs(f))
        pha = self.pha_fuse(safe_angle(f))
        return self.post(cp_ops.spectral_tile_upsample(mag, pha, cp).to(
            x.dtype))


class ShuffleUpSample(nn.Module):
    """conv3x3 C -> 2C, pixel_shuffle(2): C/2 at 2H."""

    def __init__(self, c: int, device=None):
        super().__init__()
        self.body = nn.Sequential(_conv(c, 2 * c, 3, device=device))

    def forward(self, x, cp=None):
        return pixel_shuffle(_conv_rows(self.body[0], x, cp), 2)


class UpS(nn.Module):
    """concat(FFT-up, shuffle-up), then a 1x1 C -> C/2; checkpointed under
    remat."""

    remat = staticmethod(no_remat)

    def __init__(self, c: int, device=None):
        super().__init__()
        self.Fups = SpectralUpSample(c, True, device=device)
        self.Sups = ShuffleUpSample(c, device=device)
        self.reduce = _conv(c, c // 2, device=device)

    def forward(self, x, cp=None):
        return self.remat(self._forward)(x, cp)

    def _forward(self, x, cp):
        return self.reduce(torch.cat([self.Fups(x, cp), self.Sups(x, cp)],
                                     dim=1))


class SpectralTransformer(nn.Module):
    """NCHW in [-1, 1], (B, 3, H, W) -> (B, 3, H, W).  H and W must be
    multiples of 8 (three DownSamples)."""

    def __init__(self, num_blocks: Sequence[int] = (2, 3, 3, 4),
                 num_heads: Sequence[int] = (1, 2, 4, 8),
                 channels: Sequence[int] = (16, 32, 64, 128),
                 num_refinement: int = 4, expansion_factor: float = 2.66,
                 compute_dtype: torch.dtype = torch.float32, device=None,
                 cp=None, remat: bool = False, remat_policy=None):
        super().__init__()
        nb, nh, ch, ef = num_blocks, num_heads, channels, expansion_factor
        self.compute_dtype = compute_dtype
        # the rank's place on the context dimension: the forward takes and
        # gives the rank's band of the images' rows (not a module: the
        # state_dict is the single-device one)
        self.cp = cp

        def stage(n, c, heads):
            return Stage(*[SpectralBlock(c, heads, ef, device=device)
                           for _ in range(n)])

        self.embed_conv_rgb = _conv(3, ch[0], 3, device=device)
        self.encoders = nn.ModuleList(
            [stage(nb[i], ch[i], nh[i]) for i in range(4)])
        self.down1 = DownSample(ch[0], device=device)
        self.down2 = DownSample(ch[1], device=device)
        self.down3 = DownSample(ch[2], device=device)
        self.ups_1 = UpS(ch[3], device=device)
        self.ups_2 = UpS(ch[2], device=device)
        self.ups_3 = UpS(ch[1], device=device)
        self.reduces1 = _conv(ch[3], ch[2], device=device)
        self.reduces2 = _conv(ch[2], ch[1], device=device)
        self.decoders = nn.ModuleList([stage(nb[2], ch[2], nh[2]),
                                       stage(nb[1], ch[1], nh[1]),
                                       stage(nb[0], ch[1], nh[0])])
        self.refinement = stage(num_refinement, ch[1], nh[0])
        self.outputl = _conv(ch[1], 8, 3, device=device)
        self.output = _conv(8, 3, 3, device=device)
        rt = make_remat(remat, remat_policy)
        for m in self.modules():
            if isinstance(m, (SpectralBlock, UpS)):
                m.remat = rt

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        """torch's default init from an explicit generator: every conv
        weight and bias U(+-1/sqrt(fan_in)); LayerNorm ones/zeros and
        temperatures ones stay as constructed."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                bound = 1.0 / math.sqrt(fan_in)
                for p in (m.weight, m.bias):
                    if p is not None:
                        r = torch.rand(p.shape, generator=generator,
                                       device=generator.device)
                        p.copy_((r * 2 - 1) * bound)

    def levels_banded(self, h: int, w: int):
        """For a map of h x w (the whole map's) under ``cp``: whether each
        of the four levels runs on bands (the group divides its rows, each
        band at least MDTA_HALO rows; the bands of level i + 1 are then
        those of level i halved, so DownSample and the pixel shuffle stay
        on the band) and whether each UpS runs there too (its level's
        columns divide as well, for the distributed FFT)."""
        cp = self.cp if cp_ops.context_size(self.cp) > 1 else None
        lv = [cp_ops.cp_spatial_viable(h >> i, cp, min_rows=MDTA_HALO)
              for i in range(4)]
        ups = [lv[i] and cp_ops.cp_fft_viable(h >> i, w >> i, cp)
               for i in range(4)]
        return lv, ups

    def forward(self, x, use_kernels: bool = True):
        """With ``cp``, x is the rank's band of the images' rows, rows
        [c H/n, (c+1) H/n), and so is the output."""
        k = use_kernels
        enc = self.encoders
        cp = self.cp if cp_ops.context_size(self.cp) > 1 else None
        # a strided input (an NHWC batch permuted) would give cuDNN's
        # channels-last output, which the kernels do not take
        x = x.to(self.compute_dtype).contiguous()
        # without cp every level is whole and each step below the module's
        # own call on the whole map
        lv, ups = self.levels_banded(x.shape[2] * cp_ops.context_size(cp),
                                     x.shape[3])

        def on(b):
            return cp if b else None

        def between(fn, y, src, dst):
            return cp_ops.between(fn, y, cp, src, dst, 2, 2)

        def up(mod, y, i):  # level i + 1 -> level i
            y = cp_ops.relayout(y, cp, lv[i + 1], ups[i + 1], 2)
            return between(mod, y, ups[i + 1], lv[i])

        fo = between(lambda y, c: _conv_rows(self.embed_conv_rgb, y, c), x,
                     True, lv[0])
        enc1 = enc[0](fo, k, on(lv[0]))
        enc2 = enc[1](between(self.down1, enc1, lv[0], lv[1]), k, on(lv[1]))
        enc3 = enc[2](between(self.down2, enc2, lv[1], lv[2]), k, on(lv[2]))
        enc4 = enc[3](between(self.down3, enc3, lv[2], lv[3]), k, on(lv[3]))
        d3 = self.reduces1(torch.cat([up(self.ups_1, enc4, 2), enc3], dim=1))
        dec3 = self.decoders[0](d3, k, on(lv[2]))
        d2 = self.reduces2(torch.cat([up(self.ups_2, dec3, 1), enc2], dim=1))
        dec2 = self.decoders[1](d2, k, on(lv[1]))
        fd = self.decoders[2](torch.cat([up(self.ups_3, dec2, 0), enc1],
                                        dim=1), k, on(lv[0]))
        fr = self.refinement(fd, k, on(lv[0]))
        return between(lambda y, c: _conv_rows(
            self.output, _conv_rows(self.outputl, y, c), c), fr, lv[0], True)
