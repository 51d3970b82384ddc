"""Elementwise and normalization layers (NCHW), counterparts of
the JAX package's ``ops/layers.py``."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def layer_norm_channels(x, scale, bias, eps: float = 1e-5):
    """LayerNorm over the channel dim of (B, C, H, W): statistics and affine
    in f32 (bf16 mean/var over C=16 would lose ~2 decimal digits), result in
    ``x.dtype``."""
    xf = x.float()
    mean = xf.mean(dim=1, keepdim=True)
    var = (xf - mean).square().mean(dim=1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    cshape = (1, -1, 1, 1)
    y = y * scale.float().view(cshape) + bias.float().view(cshape)
    return y.to(x.dtype)


class LayerNorm(nn.Module):
    """Channel LayerNorm with torch's eps (1e-5) and the reference's
    parameter names (``weight``/``bias``)."""

    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x):
        return layer_norm_channels(x, self.weight, self.bias, self.eps)


def gelu(x):
    """Exact (erf) GELU, torch's nn.GELU default."""
    return F.gelu(x)


def leaky_relu(x, negative_slope: float = 0.01):
    return F.leaky_relu(x, negative_slope)


def l2_normalize(x, dim: int = -1, eps: float = 1e-12):
    """F.normalize(x, dim=dim) written as ``x / sqrt(max(s, eps^2))`` so an
    exactly-zero row has a zero gradient; sums in f32, result in x.dtype."""
    xf = x.float()
    s = xf.square().sum(dim=dim, keepdim=True)
    return (xf / torch.sqrt(torch.clamp_min(s, eps * eps))).to(x.dtype)
