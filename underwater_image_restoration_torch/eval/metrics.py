"""Image dump and PSNR (counterparts of
``eval/metrics.py:25 save_img`` and ``:39 psnr_float_pm1`` in the JAX
package)."""
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
