"""Focal Frequency Loss on NCHW images, counterpart of the JAX package's
``losses/ffl.py`` (the focal_frequency_loss package's method, Jiang et al.,
ICCV 2021, with its whole option surface; the reference uses the defaults).

- spectrum: orthonormal 2D FFT over the spatial dims of each (optionally
  patch-cropped) channel,
- weight matrix: |F_pred - F_true| ** alpha (optionally log1p'd), divided
  by its spatial max per (batch, patch, channel) (or by the global max with
  ``batch_matrix``), NaNs zeroed, clamped to [0, 1], detached,
- loss: mean(weight * |F_pred - F_true|^2) * loss_weight.
"""
from __future__ import annotations

import torch


def _patch_fft(x, patch_factor: int):
    """(B, C, H, W) -> complex spectra (B, P, C, H/p, W/p), orthonormal;
    patches in row-major order."""
    b, c, h, w = x.shape
    if h % patch_factor or w % patch_factor:
        raise ValueError(
            f"patch_factor={patch_factor} must divide image sides {h}x{w}")
    p = patch_factor
    x = x.reshape(b, c, p, h // p, p, w // p).permute(0, 2, 4, 1, 3, 5)
    x = x.reshape(b, p * p, c, h // p, w // p)
    return torch.fft.fft2(x, norm="ortho")


def focal_frequency_loss(pred, target, loss_weight: float = 1.0,
                         alpha: float = 1.0, patch_factor: int = 1,
                         ave_spectrum: bool = False, log_matrix: bool = False,
                         batch_matrix: bool = False):
    fp = _patch_fft(pred.float(), patch_factor)
    ft = _patch_fft(target.float(), patch_factor)
    if ave_spectrum:
        fp = fp.mean(dim=0, keepdim=True)
        ft = ft.mean(dim=0, keepdim=True)
    d = fp - ft
    freq_distance = d.real ** 2 + d.imag ** 2  # (B, P, C, h, w)

    with torch.no_grad():
        matrix = torch.sqrt(freq_distance) ** alpha
        if log_matrix:
            matrix = torch.log(matrix + 1.0)
        if batch_matrix:
            matrix = matrix / matrix.max()
        else:
            matrix = matrix / matrix.amax(dim=(-2, -1), keepdim=True)
        matrix = torch.nan_to_num(matrix, nan=0.0).clamp(0.0, 1.0)

    return (matrix * freq_distance).mean() * loss_weight
