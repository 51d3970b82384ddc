"""Pixel shuffle/unshuffle (NCHW) and the token/image reshapes, counterparts
of the JAX package's ``ops/resample.py``.

Torch channel order: ``pixel_unshuffle(r)`` puts input pixel (h*r+i, w*r+j)
of channel c at output channel c*r*r + i*r + j; ``pixel_shuffle`` inverts it.
"""
from __future__ import annotations

import torch.nn.functional as F


def pixel_unshuffle(x, r: int = 2):
    return F.pixel_unshuffle(x, r)


def pixel_shuffle(x, r: int = 2):
    return F.pixel_shuffle(x, r)


def tokens_to_image(x, h: int | None = None, w: int | None = None):
    """(B, L, C) -> (B, H, W, C) (a view of contiguous tokens); L must be a
    square if h/w are not given."""
    b, l, c = x.shape
    if h is None:
        h = w = int(round(l ** 0.5))
        if h * w != l:
            raise ValueError(f"token length {l} is not square")
    return x.reshape(b, h, w, c)


def image_to_tokens(x):
    """(B, H, W, C) -> (B, H*W, C)."""
    b, h, w, c = x.shape
    return x.reshape(b, h * w, c)
