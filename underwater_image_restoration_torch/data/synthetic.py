"""Synthetic paired data for tests and benchmarks (the port's own copy of
the JAX package's ``data/synthetic.py``).

A procedural 'underwater' degradation: the reference image is a smooth random
field; the raw image applies a blue-green color cast + haze, which is the
kind of mapping the restoration models learn.
"""
from __future__ import annotations

import numpy as np


def synthetic_pair_batch(
    batch: int, size: int, seed: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (raw, ref) uint8 NHWC batches."""
    rng = np.random.default_rng(seed)
    # smooth field: low-res noise upsampled by FFT zero-pad (cheap, no scipy)
    low = rng.random((batch, 8, 8, 3)).astype(np.float32)
    f = np.fft.rfft2(low, axes=(1, 2))
    pad = np.zeros((batch, size, size // 2 + 1, 3), np.complex64)
    pad[:, :4, :5] = f[:, :4, :5]
    pad[:, -4:, :5] = f[:, -4:, :5]
    ref = np.fft.irfft2(pad, s=(size, size), axes=(1, 2)).real
    ref = (ref - ref.min()) / (np.ptp(ref) + 1e-8)
    # underwater cast: attenuate red, add green-blue veil, mild blur-free haze
    cast = np.array([0.35, 0.85, 0.9], np.float32)
    veil = np.array([0.05, 0.25, 0.3], np.float32)
    raw = ref * cast + veil * (1.0 - ref)
    raw = np.clip(raw + rng.normal(0, 0.02, raw.shape).astype(np.float32), 0, 1)
    return (
        (raw * 255).round().astype(np.uint8),
        (np.clip(ref, 0, 1) * 255).round().astype(np.uint8),
    )
