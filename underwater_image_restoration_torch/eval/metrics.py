"""Offline evaluation metrics, counterparts of the JAX package's
``eval/metrics.py``.

- ``save_img``: [-1, 1] float -> [0, 255] PNG.
- ``psnr_float_pm1``: skimage's PSNR on float arrays, whose inferred
  data_range is 2 (range (-1, 1)), as the eval notebook computed it.
- ``to_gray_u8`` / ``psnr_gray_u8``: BT.601 grayscale uint8 PSNR, data
  range 255 (the notebook's cv2 BGR2GRAY + skimage pass).
- ``ssim_pair_u8``: SSIM of uint8 RGB pairs (``losses.msssim.ssim`` on
  /255 floats, data_range 1), on the CUDA device unless asked otherwise.
- ``drop_lowest``: the notebook's ``np.sort(PSNR)[4:]`` trimming.
"""
from __future__ import annotations

import os

import numpy as np


def save_img(arr_pm1: np.ndarray, path: str):
    """HWC (or CHW) float in [-1, 1] -> uint8 PNG ((x + 1) / 2 * 255).
    PIL is imported here: only writing files needs it."""
    from PIL import Image

    a = np.asarray(arr_pm1)
    if a.ndim == 3 and a.shape[0] in (1, 3) and a.shape[-1] not in (1, 3):
        a = a.transpose(1, 2, 0)
    a = np.clip((a + 1.0) / 2.0, 0.0, 1.0)
    a = (a * 255).astype(np.uint8)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    Image.fromarray(a.squeeze()).save(path)


def psnr_float_pm1(ref: np.ndarray, pred: np.ndarray) -> float:
    """skimage-compatible PSNR for float arrays in [-1, 1]: data_range 2."""
    mse = float(np.mean((np.asarray(ref, np.float64)
                         - np.asarray(pred, np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10((2.0 ** 2) / mse)


def to_gray_u8(img_u8: np.ndarray) -> np.ndarray:
    """BT.601 luma with cv2-style rounding on uint8 RGB."""
    f = img_u8.astype(np.float64)
    y = f[..., 0] * 0.299 + f[..., 1] * 0.587 + f[..., 2] * 0.114
    return np.clip(np.round(y), 0, 255).astype(np.uint8)


def psnr_gray_u8(ref_u8: np.ndarray, pred_u8: np.ndarray) -> float:
    mse = float(np.mean((ref_u8.astype(np.float64)
                         - pred_u8.astype(np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(255.0 ** 2 / mse)


def ssim_pair_u8(a_u8: np.ndarray, b_u8: np.ndarray, device=None) -> float:
    """SSIM of uint8 RGB (H, W, 3) pairs (data_range 1 on /255 floats), on
    ``device``: the first CUDA device by default, ``"cpu"`` when asked."""
    import torch

    from .._device import resolve_device
    from ..losses.msssim import ssim

    dev = resolve_device(device)

    def nchw(u8):
        t = torch.tensor(np.asarray(u8), device=dev)
        return (t.float() / 255.0).permute(2, 0, 1)[None]

    return float(ssim(nchw(a_u8), nchw(b_u8), data_range=1.0))


def drop_lowest(values: np.ndarray, n: int = 4) -> np.ndarray:
    """np.sort(x)[n:]: the notebook drops the 4 lowest PSNR samples before
    averaging."""
    return np.sort(np.asarray(values))[n:]
