"""Validation metrics (reference ModelTrainer.py:17-24), counterparts of the
JAX package's ``train/metrics.py`` on NCHW tensors.

``psnr`` is 20 log10(1 / RMSE) over tensors clamped to [0, 1], with the
reference's quirk that validation tensors live in [-1, 1], so the clamp
saturates half the range.  ``ssim_metric`` is single-scale SSIM,
data_range 1 (``losses.msssim.ssim``).  The per-sample forms give one value
a sample, so padding rows can be masked.
"""
from __future__ import annotations

from ..losses.msssim import _gaussian_kernel, _ssim_per_channel, ssim


def ssim_metric(target, pred, data_range: float = 1.0):
    return ssim(target, pred, data_range=data_range)


def per_sample_psnr(target, pred):
    """(B, C, H, W) -> (B,) PSNR a sample."""
    d = pred.float().clamp(0, 1) - target.float().clamp(0, 1)
    rmse = d.square().mean(dim=(1, 2, 3)).sqrt()
    return 20.0 * (1.0 / rmse).log10()


def per_sample_ssim(target, pred, data_range: float = 1.0):
    """(B, C, H, W) -> (B,) SSIM a sample (the mean over its channels)."""
    s, _ = _ssim_per_channel(target, pred, _gaussian_kernel(11, 1.5),
                             data_range)
    return s.mean(dim=1)
