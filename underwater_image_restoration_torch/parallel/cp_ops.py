"""Context-parallel dispatchers used inside the model forwards, the port's
counterparts of the JAX package's ``parallel/cp_ops.py``.

Every function takes a ``cp`` (``core.meshes.ContextParallel``) or None.
With ``cp`` None (or a group of one) the argument is the whole map and the
single-device op runs; with ``cp`` it is the rank's band of rows
(``cp.band``) and the op exchanges what crosses the band's edges:

- ``roll2d``: the cyclic rolls of shifted windows, one halo strip;
- ``window_attention``: the rank's windows and its rows of the shift mask;
- ``fft2``/``ifft2``, ``fftn_real_spatial``/``ifftn_real_spatial`` (NHWC),
  ``fft2_chw``/``ifft2_chw`` and ``spectral_tile_upsample`` (NCHW, the
  SpectralTransformer's UpS): the distributed 2-D FFT of a row-sharded
  image; ``fftn_real_tokens``: the
  New* encoders' FFT over the (L, C) token axes with L sharded, by the same
  transpose recipe;
- ``conv2d``: a convolution of an NCHW band (the 3x3/pad 1 projections and
  samplers, the AST's 4x4/stride 2/pad 1 downsample, depthwise taps) over
  the band with the halo rows it reads from its neighbours, zeros past the
  map's edge;
- ``gather_rows`` / ``slice_rows`` / ``relayout``: a level whose shapes
  are not viable on bands runs whole on every rank (gathered, computed,
  the rank's rows sliced back), where the JAX dispatchers fall back to
  local compute and XLA's partitioner gathers.

XLA's partitioner gave the JAX package the convolutions, the taps and the
token FFT for free; the port routes each explicitly.  Viability is decided
by the models from the global shapes (``cp_spatial_viable``,
``cp_fft_viable``, ``cp_attention_viable``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..ops.spectral import fft2 as _fft2
from ..ops.spectral import ifft2 as _ifft2
from ..ops.spectral import safe_abs, zero_stuff2x
from ..ops.spectral import spectral_tile_upsample as _tile_upsample
from ..ops.window_attention import window_attention as _local_attention
from .context import (
    cp_roll2d,
    cp_window_attention_qkv,
    gather_rows,
    halo_rows,
    sharded_fft2,
    sharded_ifft2,
    slice_rows,
)


def context_size(cp) -> int:
    return 1 if cp is None else int(cp.size)


def cp_spatial_viable(h: int, cp, min_rows: int = 1,
                      multiple: int = 1) -> bool:
    """True when a map of ``h`` rows can be held as bands: the group
    divides h, each band has at least ``min_rows`` rows, a multiple of
    ``multiple``."""
    n = context_size(cp)
    if n <= 1 or h % n:
        return False
    band = h // n
    return band >= min_rows and band % multiple == 0


def cp_fft_viable(h: int, w: int, cp) -> bool:
    """The distributed FFT also shards the columns, so the group divides
    w as well."""
    return cp_spatial_viable(h, cp) and w % context_size(cp) == 0


def cp_attention_viable(n_win_h: int, cp) -> bool:
    """The windows of a band are whole: the group divides the window
    rows."""
    n = context_size(cp)
    return n > 1 and n_win_h % n == 0


def _banded(cp) -> bool:
    return cp is not None and cp.size > 1


def band_shape(l: int, cp):
    """(band rows, width) of a square map held as (B, L, C) tokens: the
    rank's band when ``cp``, else the whole map."""
    w = math.isqrt(l * context_size(cp))
    if w * (l // w) != l or w * w != l * context_size(cp):
        raise ValueError(f"{l} tokens are not a band of a square map over "
                         f"{context_size(cp)} ranks")
    return l // w, w


def roll2d(x, shift_h: int, shift_w: int, cp=None):
    """``torch.roll`` over the spatial axes of NHWC; one halo strip when
    ``x`` is a band."""
    if shift_h == 0 and shift_w == 0:
        return x
    if not _banded(cp):
        return torch.roll(x, (shift_h, shift_w), (1, 2))
    return cp_roll2d(x, shift_h, shift_w, cp)


def fft2(x, cp=None):
    """2-D FFT over (H, W) of NHWC, complex64; the distributed transpose
    decomposition on a band."""
    if not _banded(cp):
        return torch.fft.fftn(x.to(torch.complex64), dim=(1, 2))
    return sharded_fft2(x, cp)


def ifft2(x, cp=None):
    if not _banded(cp):
        return torch.fft.ifftn(x.to(torch.complex64), dim=(1, 2))
    return sharded_ifft2(x, cp)


def fft2_chw(x, cp=None):
    """2-D FFT over the last two axes (H, W) of NCHW (``ops.fft2``); on a
    band the distributed transpose decomposition (complex64; the group
    divides W)."""
    if not _banded(cp):
        return _fft2(x)
    b, c, h, w = x.shape
    return sharded_fft2(x.reshape(b * c, h, w), cp).reshape(b, c, h, w)


def ifft2_chw(x, cp=None):
    if not _banded(cp):
        return _ifft2(x)
    b, c, h, w = x.shape
    return sharded_ifft2(x.reshape(b * c, h, w), cp).reshape(b, c, h, w)


def spectral_tile_upsample(mag, phase, cp=None):
    """SpectralUpSample's core on NCHW (``ops.spectral_tile_upsample``):
    polar recombine, the inverse FFT (distributed on a band), abs, then
    the zero stuffing, which is the band's own (rows [r, r + h) of the map
    go to rows [2r, 2r + 2h) of the 2x map)."""
    if not _banded(cp):
        return _tile_upsample(mag, phase)
    comp = torch.complex(mag * torch.cos(phase), mag * torch.sin(phase))
    return zero_stuff2x(safe_abs(ifft2_chw(comp, cp)))


def fftn_real_spatial(x, cp=None):
    """real(fft2(x)) over (H, W) of NHWC in f32, rounded to x's dtype
    (contiguous): the reference's lossy frequency projection."""
    if not _banded(cp):
        return torch.fft.fftn(x.float(), dim=(1, 2)).real.to(
            x.dtype).contiguous()
    return sharded_fft2(x.float(), cp).real.to(x.dtype).contiguous()


def ifftn_real_spatial(x, cp=None):
    if not _banded(cp):
        return torch.fft.ifftn(x.float(), dim=(1, 2)).real.to(
            x.dtype).contiguous()
    return sharded_ifft2(x.float(), cp).real.to(x.dtype).contiguous()


def fftn_real_tokens(x, inverse: bool = False, cp=None):
    """real(fftn) (or of ifftn) of (B, L, C) tokens over their (L, C) axes
    in f32, rounded to x's dtype: the New* encoders' Fourier quirk; with L
    sharded, FFT over C, all-to-all to shard C, FFT over L, all-to-all back
    (the group divides C)."""
    if not _banded(cp):
        f = torch.fft.ifftn if inverse else torch.fft.fftn
        return f(x.float(), dim=(-2, -1)).real.to(x.dtype).contiguous()
    f = sharded_ifft2 if inverse else sharded_fft2
    return f(x.float(), cp).real.to(x.dtype).contiguous()


def window_attention(q, k, v, bias, *, scale: float, sparse_w=None,
                     mask=None, cp=None, n_win_h: Optional[int] = None):
    """``ops.window_attention`` of the rank's windows with its rows of the
    global shift mask when ``cp`` (``n_win_h`` the map's window rows), the
    single-device call otherwise."""
    if not _banded(cp):
        return _local_attention(q, k, v, bias, scale=scale,
                                sparse_w=sparse_w, mask=mask)
    return cp_window_attention_qkv(q, k, v, bias, scale=scale, cp=cp,
                                   n_win_h=n_win_h, sparse_w=sparse_w,
                                   mask=mask)


def conv2d(x, weight, bias=None, stride: int = 1, padding: int = 0,
           groups: int = 1, cp=None):
    """``F.conv2d`` of NCHW ``x`` (square kernel, stride and padding),
    weight and bias cast to x's dtype; on a band the rank's rows of the
    whole map's result: the band with ``padding`` rows of the previous rank
    above and ``k - stride - padding`` of the next below (zeros past the
    map's edge), convolved without row padding.  The band's start and
    length are multiples of the stride."""
    b = None if bias is None else bias.to(x.dtype)
    w = weight.to(x.dtype)
    if not _banded(cp):
        return F.conv2d(x, w, b, stride, padding, 1, groups)
    k = weight.shape[-1]
    if x.shape[2] % stride:
        raise ValueError(f"conv2d: a band of {x.shape[2]} rows at stride "
                         f"{stride}")
    ext, _ = halo_rows(x, padding, k - stride - padding, cp, dim=2)
    return F.conv2d(ext, w, b, stride, (0, padding), 1, groups)


def conv(module, x, cp=None):
    """``conv2d`` with an ``nn.Conv2d``'s parameters and geometry."""
    return conv2d(x, module.weight, module.bias, module.stride[0],
                  module.padding[0], module.groups, cp)


def relayout(x, cp, banded: bool, to_banded: bool, dim: int = 1):
    """``x`` held whole or as the rank's band (``banded``) as the next
    level holds it (``to_banded``): gathered or sliced along ``dim``."""
    if not _banded(cp) or banded == to_banded:
        return x
    return slice_rows(x, cp, dim) if to_banded else gather_rows(x, cp, dim)


def between(fn, x, cp, banded: bool, to_banded: bool, in_dim: int = 1,
            out_dim: int = 1):
    """``fn(x, cp)`` from one level's layout (``banded``: x the rank's band)
    to the next's (``to_banded``): on the bands where both levels hold
    bands, else on the whole map (gathered along ``in_dim`` before, the
    rank's rows along ``out_dim`` sliced after)."""
    if not _banded(cp):
        return fn(x, None)
    if banded and to_banded:
        return fn(x, cp)
    y = fn(relayout(x, cp, banded, False, in_dim), None)
    return relayout(y, cp, False, to_banded, out_dim)


__all__ = ["band_shape", "between", "context_size", "conv", "conv2d",
           "cp_attention_viable", "cp_fft_viable", "cp_spatial_viable",
           "fft2", "fft2_chw", "fftn_real_spatial", "fftn_real_tokens",
           "gather_rows", "ifft2", "ifft2_chw", "ifftn_real_spatial",
           "relayout", "roll2d", "slice_rows", "spectral_tile_upsample",
           "window_attention"]
