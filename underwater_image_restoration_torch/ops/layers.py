"""Convolution, dense, elementwise and normalization layers, counterparts of
the JAX package's ``ops/layers.py``.

Parameters are f32; each layer computes in its input's dtype (the JAX
package's ``dtype``), casting the weights to it.  ``Linear`` keeps
``Dense``'s rounding points: the product is accumulated in f32 (f32 math
for f32 inputs; for bf16 inputs PyTorch's bf16 matmul accumulates in f32)
and rounded to the compute dtype once, before the bias is added in that
dtype.  Channel LayerNorm (``layer_norm_channels``) is over dim 1 of NCHW,
token LayerNorm (``layer_norm_last``) over the last dim of (B, L, C); both
keep their statistics and affine in f32 (f64 for f64 inputs, ``wide``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def wide(t):
    """``t`` in the dtype the plain versions accumulate in: f32, or f64
    for an f64 tensor (a check in f64 then runs in f64 throughout)."""
    return t.double() if t.dtype == torch.float64 else t.float()


def layer_norm_channels(x, scale, bias, eps: float = 1e-5):
    """LayerNorm over the channel dim of (B, C, H, W): statistics and affine
    in f32 (bf16 mean/var over C=16 would lose ~2 decimal digits), result in
    ``x.dtype``."""
    xf = wide(x)
    mean = xf.mean(dim=1, keepdim=True)
    var = (xf - mean).square().mean(dim=1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    cshape = (1, -1, 1, 1)
    y = y * wide(scale).view(cshape) + wide(bias).view(cshape)
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


def layer_norm_last(x, scale, bias, eps: float = 1e-5):
    """LayerNorm over the last dim (tokens (B, L, C)): statistics and affine
    in f32, result in ``x.dtype``."""
    y = F.layer_norm(x.float(), (x.shape[-1],), scale.float(), bias.float(),
                     eps)
    return y.to(x.dtype)


class TokenLayerNorm(LayerNorm):
    """LayerNorm over the last dim, same parameters as ``LayerNorm``."""

    def forward(self, x):
        return layer_norm_last(x, self.weight, self.bias, self.eps)


class Conv2d(nn.Conv2d):
    """nn.Conv2d whose f32 parameters are cast to the input's dtype."""

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), b, self.stride,
                        self.padding, self.dilation, self.groups)


class ConvTranspose2d(nn.ConvTranspose2d):
    """nn.ConvTranspose2d (weight ``(in, out, kh, kw)``, the reference's
    layout) whose f32 parameters are cast to the input's dtype."""

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv_transpose2d(x, self.weight.to(x.dtype), b, self.stride,
                                  self.padding, self.output_padding,
                                  self.groups, self.dilation)


class Linear(nn.Linear):
    """nn.Linear with ``Dense``'s rounding points: the product rounded to
    x.dtype, then the bias added in x.dtype."""

    def forward(self, x):
        y = F.linear(x, self.weight.to(x.dtype))
        return y if self.bias is None else y + self.bias.to(x.dtype)


def gelu(x):
    """Exact (erf) GELU, torch's nn.GELU default."""
    return F.gelu(x)


def leaky_relu(x, negative_slope: float = 0.01):
    return F.leaky_relu(x, negative_slope)


def l2_normalize(x, dim: int = -1, eps: float = 1e-12):
    """F.normalize(x, dim=dim) written as ``x / sqrt(max(s, eps^2))`` so an
    exactly-zero row has a zero gradient; sums in f32, result in x.dtype."""
    xf = wide(x)
    s = xf.square().sum(dim=dim, keepdim=True)
    return (xf / torch.sqrt(torch.clamp_min(s, eps * eps))).to(x.dtype)
