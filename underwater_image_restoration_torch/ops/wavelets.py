"""Haar DWT and IDWT with the reference's own backward passes, counterparts
of the JAX package's ``ops/wavelets.py`` (``dwt2d:107``, ``idwt2d:168``).

Layout NHWC (B, H, W, C), as the New* models' channels-last tokens are.
The reference expands one 2x2 Haar filter to every (out, in) channel pair,
so the convolutions collapse:

- ``dwt2d``: each band is the Haar filter applied to the channel sum,
  repeated C/4 times, bands [ll, lh, hl, hh] -> (B, H/2, W/2, C);
- ``idwt2d``: output channel 4g + o is reconstruction filter o applied to
  the sum of the CONSECUTIVE input channels 4g .. 4g + 3 -> (B, 2H, 2W, C).

Kept quirks (trained checkpoints depend on them): the backward passes are the
reference's, not the adjoints of these forwards.  ``dwt2d``'s regroups the
bands' channels with the reference's rearrange before its transposed
convolution (``_dwt2d_bwd:132``); ``idwt2d``'s mixes pixels into channels
through raw NCHW reshapes (``_idwt2d_bwd:211``), and on maps whose side is
not a multiple of 4, where those reshapes fail in the reference, it takes
the forward's true adjoint (``_idwt2d_true_adjoint:200``).  Everything is
computed in f32 and rounded to the input's dtype once; the results are
contiguous.  C must be a multiple of 4.
"""
from __future__ import annotations

import math

import torch

from .layers import constant

_S = 1.0 / math.sqrt(2.0)
# the reference reverses pywt's decomposition filters and keeps the
# reconstruction ones: dec_lo = rec_lo = (s, s), dec_hi = rec_hi = (s, -s)
_LO = (_S, _S)
_HI = (_S, -_S)


def _filters(device):
    """(4, 2, 2) f32 filters, bands [ll, lh, hl, hh], w[i, j] = row[j] col[i]
    (the same for decomposition and reconstruction)."""
    lo = constant(_LO, device)
    hi = constant(_HI, device)

    def outer(row, col):
        return col[:, None] * row[None, :]

    return torch.stack([outer(lo, lo), outer(lo, hi), outer(hi, lo),
                        outer(hi, hi)])


def _unshuffle(x):
    """(B, 2h, 2w, c) -> (B, h, w, 4c), channel c * 4 + i * 2 + j holding
    pixel (2h + i, 2w + j) (torch's pixel_unshuffle order)."""
    b, hh, ww, c = x.shape
    x = x.reshape(b, hh // 2, 2, ww // 2, 2, c)
    return x.permute(0, 1, 3, 5, 2, 4).reshape(b, hh // 2, ww // 2, 4 * c)


def _check(x):
    if x.dim() != 4 or x.shape[-1] % 4:
        raise ValueError(f"the Haar transforms take (B, H, W, C) with C a "
                         f"multiple of 4, got {tuple(x.shape)}")


class _Dwt(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        _check(x)
        b, h, w, c = x.shape
        filt = _filters(x.device)
        patches = _unshuffle(x.float().sum(-1, keepdim=True))
        bands = patches @ filt.reshape(4, 4).t()       # [pos, band]
        return bands.repeat_interleave(c // 4, dim=-1).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        # the reference's rearrange 'b (n c) h w -> b c n h w' before its
        # transposed convolution with the stacked broadcast filters: every
        # output channel gets sum_m convT(group_sum_m, f_m), where group m
        # sums the regrouped channels m q .. m q + q - 1
        b, h2, w2, c = g.shape
        q = c // 4
        gn = g.float().permute(0, 3, 1, 2)               # (B, C, h2, w2)
        gp = gn.reshape(b, 4, q, h2, w2).transpose(1, 2).reshape(
            b, c, h2, w2)
        sums = gp.reshape(b, 4, q, h2, w2).sum(2)         # (B, 4, h2, w2)
        scat = torch.einsum("bnhw,nij->bhiwj", sums, _filters(g.device))
        dx = scat.reshape(b, 2 * h2, 2 * w2, 1)
        return dx.expand(b, 2 * h2, 2 * w2, c).to(g.dtype).contiguous()


def _idwt_true_adjoint(g):
    b, hh, ww, c = g.shape
    gp = _unshuffle(g.float()).reshape(b, hh // 2, ww // 2, c // 4, 4, 2, 2)
    ds = torch.einsum("bhwgoij,oij->bhwg", gp, _filters(g.device))
    return ds.repeat_interleave(4, dim=-1)


class _Idwt(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        _check(x)
        b, h, w, c = x.shape
        s = x.float().reshape(b, h, w, c // 4, 4).sum(-1)  # (B, h, w, q)
        t = s[..., None, None, None] * _filters(x.device)  # (.., q, o, i, j)
        out = t.permute(0, 1, 5, 2, 6, 3, 4).reshape(b, 2 * h, 2 * w, c)
        return out.to(x.dtype).contiguous()

    @staticmethod
    def backward(ctx, g):
        b, hh, ww, c = g.shape
        h, w = hh // 2, ww // 2
        if h % 4 or w % 4:
            return _idwt_true_adjoint(g).to(g.dtype)
        # the reference's dx.reshape(B, -1, H // 2, W // 2) of the NCHW
        # cotangent, a band-filter convolution of its channel sum with the
        # reconstruction filters, each band repeated and reshaped back
        gm = g.float().permute(0, 3, 1, 2).reshape(b, -1, h // 2, w // 2)
        sm = gm.sum(1, keepdim=True).permute(0, 2, 3, 1)
        bands = _unshuffle(sm) @ _filters(g.device).reshape(4, 4).t()
        bands = bands.permute(0, 3, 1, 2)                  # (B, 4, h/4, w/4)
        qd = gm.shape[1] // 4
        out = [bands[:, n:n + 1].expand(b, qd, h // 4, w // 4).reshape(
            b, -1, h, w) for n in range(4)]
        return torch.cat(out, 1).permute(0, 2, 3, 1).to(g.dtype).contiguous()


def dwt2d(x):
    """(B, H, W, C) -> (B, H/2, W/2, C): bands [ll, lh, hl, hh], each C/4
    equal channels."""
    return _Dwt.apply(x)


def idwt2d(x):
    """(B, H, W, C) -> (B, 2H, 2W, C), consecutive channel quadruples
    summed."""
    return _Idwt.apply(x)
