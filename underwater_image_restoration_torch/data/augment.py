"""Online pair-consistent augmentation, the port's own copy of the JAX
package's ``data/augment.py`` (numpy only).

Probabilities and ranges come from the reference's offline DataAugmentor
(DataAugmentor.py:15-20): hflip p=0.5, vflip p=0.5, gaussian noise p=0.3 with
sigma in [0.02, 0.1] of the [0,1] range, contrast p=0.4 with factor in
[0.7, 1.3].  Geometric ops (flips) share randomness across the pair;
photometric degradations (noise, contrast) hit the raw side only, so the
restoration target stays clean.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    flip_prob: float = 0.5
    noise_prob: float = 0.3
    noise_level: tuple = (0.02, 0.1)
    contrast_prob: float = 0.4
    contrast_range: tuple = (0.7, 1.3)
    enabled: bool = True


def _adjust_contrast_u8(img: np.ndarray, factor: np.ndarray) -> np.ndarray:
    """torchvision TF.adjust_contrast semantics: blend with the mean of the
    grayscale (BT.601) image; grayscale mean is computed on rounded L values.
    img: (B,H,W,C) uint8; factor: (B,) float."""
    f = img.astype(np.float32)
    gray = f[..., 0] * 0.299 + f[..., 1] * 0.587 + f[..., 2] * 0.114
    mean = np.round(gray).mean(axis=(1, 2))[:, None, None, None]
    fac = factor[:, None, None, None].astype(np.float32)
    out = fac * f + (1.0 - fac) * mean
    return np.clip(out, 0.0, 255.0).round().astype(np.uint8)


def augment_pair_batch(
    raw: np.ndarray,
    ref: np.ndarray,
    rng: np.random.Generator,
    cfg: AugmentConfig = AugmentConfig(),
):
    """(B,H,W,C) uint8 pair -> augmented pair.  Deterministic given rng state."""
    if not cfg.enabled:
        return raw, ref
    b = raw.shape[0]
    hflip = rng.random(b) < cfg.flip_prob
    vflip = rng.random(b) < cfg.flip_prob
    do_noise = rng.random(b) < cfg.noise_prob
    sigma = rng.uniform(*cfg.noise_level, size=b)
    do_contrast = rng.random(b) < cfg.contrast_prob
    contrast = rng.uniform(*cfg.contrast_range, size=b)
    # noise field drawn unconditionally so the rng stream length is
    # data-independent -> resumable mid-epoch with a counter-based seed
    noise = rng.standard_normal(raw.shape, dtype=np.float32)

    raw = raw.copy()
    ref = ref.copy()
    if hflip.any():
        raw[hflip] = raw[hflip, :, ::-1]
        ref[hflip] = ref[hflip, :, ::-1]
    if vflip.any():
        raw[vflip] = raw[vflip, ::-1]
        ref[vflip] = ref[vflip, ::-1]
    if do_noise.any():
        idx = np.nonzero(do_noise)[0]
        f = raw[idx].astype(np.float32) / 255.0
        f = f + noise[idx] * sigma[idx, None, None, None].astype(np.float32)
        raw[idx] = (np.clip(f, 0.0, 1.0) * 255.0).round().astype(np.uint8)
    if do_contrast.any():
        idx = np.nonzero(do_contrast)[0]
        raw[idx] = _adjust_contrast_u8(raw[idx], contrast[idx])
    return raw, ref
