"""Window partition/reverse and the shifted-window helpers, counterparts of
the JAX package's ``ops/windows.py`` (dilation 1; the dilated path comes
with the New* models).

Layout is channels-last, as the AST's tokens are: (B, H, W, C) ->
(B * H/ws * W/ws, ws, ws, C), windows row-major over the (H/ws, W/ws) grid
of each image, so window ``i`` of the batch uses shift mask ``i % nW``.

``shift_window_mask`` and ``relative_position_index`` are numpy builders
(the model's static shapes make them constants); ``shift_mask`` keeps one
copy of each mask on each device.  Under context parallelism a rank holds
a band of the map's rows, and its windows are window rows
[c nWh/n, (c+1) nWh/n) of the (nWh, nWw) grid: ``mask_rows`` (and
``shift_mask(..., cp=)``) gives the mask of those windows alone.
"""
from __future__ import annotations

import numpy as np
import torch


def window_partition(x, win_size: int):
    """(B, H, W, C) -> (B * nW, ws, ws, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // win_size, win_size, w // win_size, win_size, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, win_size, win_size, c)


def window_reverse(windows, win_size: int, h: int, w: int):
    """(B * nW, ws, ws, C) -> (B, H, W, C), the inverse of
    ``window_partition``."""
    c = windows.shape[-1]
    b = windows.shape[0] // ((h // win_size) * (w // win_size))
    x = windows.reshape(b, h // win_size, w // win_size, win_size, win_size,
                        c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


def shift_window_mask(h: int, w: int, win_size: int,
                      shift_size: int) -> np.ndarray:
    """The shifted-window attention mask: (nW, ws*ws, ws*ws) float32, 0 for
    pairs of one region of the rolled image and -100 across regions."""
    img = np.zeros((h, w), dtype=np.int32)
    slices = (slice(0, -win_size), slice(-win_size, -shift_size),
              slice(-shift_size, None))
    cnt = 0
    for hs in slices:
        for ws in slices:
            img[hs, ws] = cnt
            cnt += 1
    img = img.reshape(h // win_size, win_size, w // win_size, win_size)
    img = img.transpose(0, 2, 1, 3).reshape(-1, win_size * win_size)
    diff = img[:, None, :] - img[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def relative_position_index(win_h: int, win_w: int) -> np.ndarray:
    """(N, N) index into the (2 win_h - 1)(2 win_w - 1) relative-position
    bias table, N = win_h * win_w."""
    coords = np.stack(np.meshgrid(np.arange(win_h), np.arange(win_w),
                                  indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel = rel.astype(np.int64)
    rel[:, :, 0] += win_h - 1
    rel[:, :, 1] += win_w - 1
    rel[:, :, 0] *= 2 * win_w - 1
    return rel.sum(-1)


_MASKS: dict = {}


def mask_rows(mask, cp, n_win_h: int):
    """The rows of a (nW, N, N) mask of a map of ``n_win_h`` window rows
    that belong to the windows of ``cp``'s band (window rows
    [c nWh/n, (c+1) nWh/n), contiguous in the mask); ``mask`` itself
    without ``cp`` or at one rank."""
    if mask is None or cp is None or cp.size == 1:
        return mask
    per = mask.shape[0] // n_win_h
    rows = cp.band(n_win_h)
    return mask[rows.start * per:rows.stop * per]


def shift_mask(h: int, w: int, win_size: int, shift_size: int,
               device, cp=None) -> torch.Tensor:
    """``shift_window_mask`` of the (h, w) map as a float32 tensor on
    ``device``, built once a (h, w, ws, ss, device); with ``cp`` the rows of
    its band's windows (``mask_rows``).  One built while a tracer runs
    (``torch.export`` gives a fake tensor here) is not kept."""
    key = (h, w, win_size, shift_size, str(torch.device(device)))
    m = _MASKS.get(key)
    if m is None:
        m = torch.from_numpy(shift_window_mask(h, w, win_size,
                                               shift_size)).to(device)
        if type(m) is torch.Tensor:
            _MASKS[key] = m
    return mask_rows(m, cp, h // win_size)
