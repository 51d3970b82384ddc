"""UIQM, the Underwater Image Quality Measure (reference ``uqim_utils.py``),
the port's own copy of the JAX package's ``eval/uiqm.py`` (numpy and
scipy, no device).

UIQM = 0.0282*UICM + 0.2953*UISM + 3.5753*UICONM  (uqim_utils.py:176-190),
with
- UICM: asymmetric alpha-trimmed colorfulness over RG = R-G and
  YB = (R+G)/2 - B  (uqim_utils.py:10-48),
- UISM: Sobel-edge EME sharpness, 10x10 blocks, BT.601-ish channel weights
  with the reference's 0.144 blue coefficient quirk (uqim_utils.py:84-108),
- UICONM: log-AMEE contrast over 10x10 blocks (uqim_utils.py:141-174).

Vectorized over blocks; the reference's numerical quirks are kept:
- the trimmed mean skips one extra leading element (s = T_a_L + 1,
  uqim_utils.py:23-26) while the weight still divides by K-T_a_L-T_a_R;
- blocks where min==0 or max==0 contribute 0 to EME (uqim_utils.py:75-78);
- Sobel magnitudes are rescaled to max 255 before the edge map product
  (uqim_utils.py:53-55).

The eval notebook feeds cv2 (BGR) arrays into getUIQM, so the published
UIQM=4.33 is computed with R and B swapped;
``compute_uiqm(..., emulate_cv2=True)`` replicates that.

Divergence from the reference: its sobel() divides by np.max(mag)
unconditionally and yields NaN for an all-zero (flat) channel;
``_sobel_mag`` guards that division, so a flat channel contributes 0 to
UISM instead of poisoning the whole score.
"""
from __future__ import annotations

import math

import numpy as np
from scipy import ndimage


def _mu_a(x: np.ndarray, alpha_l: float = 0.1, alpha_r: float = 0.1) -> float:
    """Asymmetric alpha-trimmed mean with the reference's off-by-one
    (sum over sorted[T_a_L+1 : K-T_a_R], weight 1/(K-T_a_L-T_a_R))."""
    x = np.sort(x, kind="stable")
    k = x.size
    t_l = math.ceil(alpha_l * k)
    t_r = math.floor(alpha_r * k)
    weight = 1.0 / (k - t_l - t_r)
    return float(weight * x[int(t_l + 1): int(k - t_r)].sum())


def _uicm(x: np.ndarray) -> float:
    r, g, b = (x[..., i].reshape(-1).astype(np.float64) for i in range(3))
    rg = r - g
    yb = (r + g) / 2.0 - b
    mu_rg, mu_yb = _mu_a(rg), _mu_a(yb)
    s_rg = float(np.mean((rg - mu_rg) ** 2))
    s_yb = float(np.mean((yb - mu_yb) ** 2))
    l = math.hypot(mu_rg, mu_yb)
    rt = math.sqrt(s_rg + s_yb)
    return -0.0268 * l + 0.1586 * rt


def _sobel_mag(x: np.ndarray) -> np.ndarray:
    dx = ndimage.sobel(x, 0)
    dy = ndimage.sobel(x, 1)
    mag = np.hypot(dx, dy)
    m = mag.max()
    if m > 0:
        mag = mag * (255.0 / m)
    return mag


def _block_reduce(x: np.ndarray, win: int):
    """Crop to a multiple of win and return (k2, k1, win*win[, C]) blocks'
    per-block max and min."""
    k2, k1 = x.shape[0] // win, x.shape[1] // win
    x = x[: k2 * win, : k1 * win]
    if x.ndim == 2:
        b = x.reshape(k2, win, k1, win)
        axes = (1, 3)
    else:
        b = x.reshape(k2, win, k1, win, -1)
        axes = (1, 3, 4)
    return k1, k2, b.max(axis=axes), b.min(axis=axes)


def _eme(x: np.ndarray, win: int) -> float:
    k1, k2, bmax, bmin = _block_reduce(x, win)
    ok = (bmin != 0.0) & (bmax != 0.0)
    ratio = np.where(ok, bmax / np.where(ok, bmin, 1.0), 1.0)
    val = np.log(ratio, where=ok, out=np.zeros_like(ratio)).sum()
    return float(2.0 / (k1 * k2) * val)


def _uism(x: np.ndarray) -> float:
    emes = []
    for c in range(3):
        ch = x[..., c]
        edge_map = _sobel_mag(ch) * ch
        emes.append(_eme(edge_map, 10))
    # reference weights: 0.299 R, 0.587 G, 0.144 B (uqim_utils.py:104-106;
    # 0.144 instead of BT.601's 0.114 — quirk preserved)
    return 0.299 * emes[0] + 0.587 * emes[1] + 0.144 * emes[2]


def _uiconm(x: np.ndarray, win: int = 10) -> float:
    k1, k2, bmax, bmin = _block_reduce(x, win)
    top = bmax - bmin
    bot = bmax + bmin
    ok = np.isfinite(top) & np.isfinite(bot) & (bot != 0.0) & (top != 0.0)
    ratio = np.where(ok, top / np.where(ok, bot, 1.0), 1.0)
    val = (ratio * np.log(ratio, where=ok, out=np.zeros_like(ratio))).sum()
    return float(-1.0 / (k1 * k2) * val)


def compute_uiqm(image_rgb: np.ndarray, emulate_cv2: bool = False):
    """Returns (uiqm, uicm, uism, uiconm) for an HWC **RGB** image array.

    emulate_cv2=True reproduces the eval notebook's feed (eval.ipynb cell
    9a86b5b4): cv2.imread yields BGR and the notebook passes it straight into
    the RGB-coefficient math, so the published UIQM=4.33 has R and B
    swapped.  With the flag set the math sees channels in BGR order.
    """
    x = np.asarray(image_rgb).astype(np.float32)
    if emulate_cv2:
        x = x[..., ::-1]
    c1, c2, c3 = 0.0282, 0.2953, 3.5753
    uicm = _uicm(x)
    uism = _uism(x)
    uiconm = _uiconm(x, 10)
    return c1 * uicm + c2 * uism + c3 * uiconm, uicm, uism, uiconm


def getUIQM(x: np.ndarray):
    """Name-parity shim (reference uqim_utils.py:176).

    Like the reference's getUIQM it applies the RGB-coefficient math to
    whatever channel order the caller hands it (the notebook hands it BGR).
    """
    return compute_uiqm(x)
