"""Single-scale SSIM on NCHW tensors, the part of the JAX package's
``losses/msssim.py`` that validation needs (``_gaussian_kernel``,
``_filter_separable``, ``_ssim_per_channel``, ``ssim``), numerically the
pytorch_msssim package's (the reference's dependency).

11-tap gaussian window (sigma 1.5), separable depthwise filtering (a
``conv2d`` with ``groups=C``, first along H, then along W) with VALID
padding, K1 = 0.01, K2 = 0.03, in f32.  ``ms_ssim`` and the losses built on
it are ROADMAP.md queue 1, item 5.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _gaussian_kernel(size: int, sigma: float) -> np.ndarray:
    coords = np.arange(size, dtype=np.float32) - size // 2
    g = np.exp(-(coords ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _filter_separable(x, win1d):
    """Depthwise separable gaussian filter, VALID padding, NCHW."""
    c, k = x.shape[1], len(win1d)
    w = torch.as_tensor(win1d, device=x.device)
    x = F.conv2d(x, w.view(1, 1, k, 1).expand(c, 1, k, 1), groups=c)
    return F.conv2d(x, w.view(1, 1, 1, k).expand(c, 1, 1, k), groups=c)


def _ssim_per_channel(x, y, win1d, data_range=1.0, k1=0.01, k2=0.03):
    """(ssim, cs), each the (B, C) spatial mean of its map."""
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    x = x.float()
    y = y.float()
    mu1 = _filter_separable(x, win1d)
    mu2 = _filter_separable(y, win1d)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _filter_separable(x * x, win1d) - mu1_sq
    sigma2_sq = _filter_separable(y * y, win1d) - mu2_sq
    sigma12 = _filter_separable(x * y, win1d) - mu1_mu2
    cs_map = (2 * sigma12 + c2) / (sigma1_sq + sigma2_sq + c2)
    ssim_map = ((2 * mu1_mu2 + c1) / (mu1_sq + mu2_sq + c1)) * cs_map
    return ssim_map.mean(dim=(2, 3)), cs_map.mean(dim=(2, 3))


def ssim(x, y, data_range: float = 1.0, win_size: int = 11,
         win_sigma: float = 1.5):
    """Single-scale SSIM of NCHW images, size-averaged scalar."""
    win = _gaussian_kernel(win_size, win_sigma)
    s, _ = _ssim_per_channel(x, y, win, data_range)
    return s.mean()
