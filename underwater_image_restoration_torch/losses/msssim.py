"""SSIM and MS-SSIM on NCHW tensors, counterparts of the JAX package's
``losses/msssim.py``, numerically the pytorch_msssim package's (the
reference's dependency).

11-tap gaussian window (sigma 1.5), separable depthwise filtering (a
``conv2d`` with ``groups=C``, first along H, then along W) with VALID
padding, K1 = 0.01, K2 = 0.03, in f32.  MS-SSIM: 5 scales weighted
``_MS_WEIGHTS``; between scales a 2x2 average pool (stride 2) with
symmetric zero padding of (H % 2, W % 2), the padding counted; ReLU on the
contrast-structure terms and on the last scale's SSIM; the product of
cs^w over the scales times ssim^w of the last.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.layers import constant


def _gaussian_kernel(size: int, sigma: float) -> np.ndarray:
    coords = np.arange(size, dtype=np.float32) - size // 2
    g = np.exp(-(coords ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _filter_separable(x, win1d):
    """Depthwise separable gaussian filter, VALID padding, NCHW."""
    c, k = x.shape[1], len(win1d)
    w = constant(tuple(win1d.tolist()), x.device)
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


def _avg_pool2(x):
    """2x2 mean pool, stride 2, after symmetric zero padding of
    (H % 2, W % 2), the padding counted."""
    return F.avg_pool2d(x, 2, padding=(x.shape[-2] % 2, x.shape[-1] % 2),
                        count_include_pad=True)


_MS_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def ms_ssim(x, y, data_range: float = 1.0, win_size: int = 11,
            win_sigma: float = 1.5, weights=None):
    """Multi-scale SSIM of NCHW images, size-averaged scalar.  The smallest
    scale must still fit the window: min(H, W) > (win_size - 1) * 2^4
    (pytorch_msssim's guard; below it the last level underflows to NaN)."""
    w = constant(tuple(weights if weights is not None else _MS_WEIGHTS),
                 x.device)
    min_side = min(x.shape[-2], x.shape[-1])
    need = (win_size - 1) * 2 ** (len(w) - 1)
    if min_side <= need:
        raise ValueError(
            f"ms_ssim needs image sides > {need} for {len(w)} scales with "
            f"win_size={win_size}; got {x.shape[-2]}x{x.shape[-1]}")
    win = _gaussian_kernel(win_size, win_sigma)
    x, y = x.float(), y.float()
    mcs = []
    for i in range(len(w)):
        ssim_pc, cs = _ssim_per_channel(x, y, win, data_range)
        if i < len(w) - 1:
            mcs.append(torch.relu(cs))
            x, y = _avg_pool2(x), _avg_pool2(y)
    stack = torch.stack(mcs + [torch.relu(ssim_pc)])  # (levels, B, C)
    return (stack ** w.view(-1, 1, 1)).prod(dim=0).mean()
