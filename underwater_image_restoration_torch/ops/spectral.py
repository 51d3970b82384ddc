"""FFT helpers (NCHW, spatial dims -2/-1), counterparts of
the JAX package's ``ops/spectral.py``."""
from __future__ import annotations

import torch


def fft2(x):
    """2D FFT over the spatial dims (complex output)."""
    return torch.fft.fft2(x)


def ifft2(x):
    return torch.fft.ifft2(x)


def safe_abs(f):
    """|f|; torch's abs backward already uses sgn(0) = 0, so exactly-zero
    bins get a zero (not NaN) gradient."""
    return torch.abs(f)


class _SafeAtan2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, im, re):
        ctx.save_for_backward(im, re)
        return torch.atan2(im, re)

    @staticmethod
    def backward(ctx, g):
        im, re = ctx.saved_tensors
        d = re * re + im * im
        zero = d == 0
        d = torch.where(zero, torch.ones_like(d), d)
        return (torch.where(zero, 0.0, re / d) * g,
                torch.where(zero, 0.0, -im / d) * g)


def safe_angle(f):
    """angle(f) as ``atan2(im, re)`` — including angle(-0.0+0j) = pi — with
    a zero gradient where |f| == 0 (the analytic one is NaN there)."""
    return _SafeAtan2.apply(f.imag, f.real)


def inv_mag(x):
    """Phase-only reconstruction (reference SpectralTransformer.py:9-13):
    ``ifft2(exp(i * angle(fft2(x)))).real`` in f32, returned in x.dtype;
    ``safe_angle`` keeps a zero gradient at exactly-zero bins."""
    pha = safe_angle(fft2(x.float()))
    return ifft2(torch.complex(torch.cos(pha), torch.sin(pha))).real.to(
        x.dtype)


def zero_stuff2x(x):
    """(B, C, H, W) -> (B, C, 2H, 2W) with x at the even positions."""
    b, c, h, w = x.shape
    out = x.new_zeros((b, c, 2 * h, 2 * w))
    out[:, :, ::2, ::2] = x
    return out


def spectral_tile_upsample(mag, phase):
    """Tile magnitude/phase 2x2, recombine polar, ifft2, abs — computed by
    the identity ifft2(tile(F, 2, 2)) == zero_stuff2x(ifft2(F)): one (H, W)
    inverse FFT instead of a (2H, 2W) one."""
    comp = torch.complex(mag * torch.cos(phase), mag * torch.sin(phase))
    return zero_stuff2x(safe_abs(ifft2(comp)))
