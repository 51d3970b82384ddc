"""Loss primitives on NCHW images, counterparts of the JAX package's
``losses/primitives.py`` (which works on NHWC: its spatial axes (1, 2) are
(-2, -1) here, and its channel axis -1 is dim 1).  Every loss is a float32
scalar, whatever the input dtype."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.layers import constant

# BT.601 luma weights over the RGB channel dim
Y_COEFFS = (0.299, 0.587, 0.114)


def l1_loss(pred, target):
    return (pred.float() - target.float()).abs().mean()


def mse_loss(pred, target):
    return (pred.float() - target.float()).square().mean()


def charbonnier_loss(pred, target, eps: float = 1e-3):
    """mean(sqrt(d^2 + eps^2))."""
    d = pred.float() - target.float()
    return torch.sqrt(d * d + eps * eps).mean()


def color_loss(pred, target):
    """Per-channel spatial MSE, averaged over (B, C)."""
    d = pred.float() - target.float()
    return d.square().mean(dim=(-2, -1)).mean()


def _luma(x):
    w = constant(Y_COEFFS, x.device)
    return (x.float() * w.view(1, 3, 1, 1)).sum(dim=1)


def luminance_loss(pred, target):
    """MSE between BT.601 luma maps."""
    return (_luma(pred) - _luma(target)).square().mean()


def psnr(target, pred):
    """20 log10(1 / RMSE) over inputs clamped to [0, 1]."""
    d = pred.float().clamp(0, 1) - target.float().clamp(0, 1)
    return 20.0 * torch.log10(1.0 / torch.sqrt(d.square().mean()))


_LAPLACIAN = ((0.0, 1.0, 0.0), (1.0, -4.0, 1.0), (0.0, 1.0, 0.0))


def _laplacian_filter(x):
    """Depthwise 3x3 Laplacian, VALID padding (a ``conv2d`` with
    ``groups=C``), in f32."""
    c = x.shape[1]
    k = constant(_LAPLACIAN, x.device)
    return F.conv2d(x.float(), k.expand(c, 1, 3, 3), groups=c)


def gradient_loss(pred, target):
    """L1 between Laplacian-filtered maps."""
    return l1_loss(_laplacian_filter(pred), _laplacian_filter(target))


def tv_loss(x, weight: float = 1.0):
    """Total variation: 2 (h_tv / count_h + w_tv / count_w) / B, the squared
    differences of neighbours summed along H and along W."""
    xf = x.float()
    b, c, h, w = x.shape
    h_tv = (xf[:, :, 1:, :] - xf[:, :, :-1, :]).square().sum()
    w_tv = (xf[:, :, :, 1:] - xf[:, :, :, :-1]).square().sum()
    return weight * 2.0 * (h_tv / (c * (h - 1) * w)
                           + w_tv / (c * h * (w - 1))) / b
