"""Pixel shuffle/unshuffle (NCHW), counterparts of
the JAX package's ``ops/resample.py``.

Torch channel order: ``pixel_unshuffle(r)`` puts input pixel (h*r+i, w*r+j)
of channel c at output channel c*r*r + i*r + j; ``pixel_shuffle`` inverts it.
"""
from __future__ import annotations

import torch.nn.functional as F


def pixel_unshuffle(x, r: int = 2):
    return F.pixel_unshuffle(x, r)


def pixel_shuffle(x, r: int = 2):
    return F.pixel_shuffle(x, r)
