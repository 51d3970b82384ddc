"""String-dispatched composite losses, counterpart of the JAX package's
``losses/__init__.py`` ``LossFunction`` on NCHW images.

Ported names: L1, L1withColor, L1ColorLum, L2, charbonnier, Luminance,
LuminanceCharbonnier and AdaptiveLuminanceCharbonnier, with the reference's
quirks kept: L1/L1withColor/L1ColorLum/L2 divide by B*C (``bc_divided``: the
value is not a batch mean), and the Adaptive pair weights its two terms by
softmax(-log(detached losses)), which couples the whole batch
(``batch_linear`` is False).  The other names of ``LOSS_NAMES`` need
MS-SSIM, FFL, the gradient loss or the VGG16 trunk, and raise
NotImplementedError until they are ported (ROADMAP.md queue 1, item 5).
"""
from __future__ import annotations

import torch

from .primitives import (
    charbonnier_loss,
    color_loss,
    l1_loss,
    luminance_loss,
    mse_loss,
    psnr,
)

LOSS_NAMES = [
    "L1", "L1withColor", "L1ColorLum", "L2", "charbonnier", "perceptual",
    "gradient", "ms_ssim", "ffl", "mix", "fflMixTV", "bigMix",
    "fflCharbonnier", "fflMix", "LuminanceCharbonnier", "Luminance",
    "AdaptiveLuminanceCharbonnier", "AdaptiveLuminanceFFL", "LuminanceFFL",
    "ssimFFLCharbonnier",
]
PORTED = ("L1", "L1withColor", "L1ColorLum", "L2", "charbonnier",
          "Luminance", "LuminanceCharbonnier", "AdaptiveLuminanceCharbonnier")


def _adaptive_pair(a, b):
    """0.5/0.5 weights modulated by softmax(-log(detached losses))."""
    losses = torch.stack([a, b])
    scales = torch.softmax(-torch.log(losses.detach() + 1e-6), dim=0)
    return (losses * 0.5 * scales).sum()


class LossFunction:
    """name -> (pred, truth) -> float32 scalar, on NCHW images."""

    def __init__(self, loss_name: str):
        if loss_name not in LOSS_NAMES:
            raise ValueError(f"Unsupported loss: {loss_name}")
        if loss_name not in PORTED:
            raise NotImplementedError(
                f"loss '{loss_name}' is not ported yet: the remaining losses "
                "(MS-SSIM, FFL, gradient, VGG16 perceptual) are ROADMAP.md "
                "queue 1, item 5")
        self.loss_name = loss_name
        # how the loss scales with the batch (consumers: grad accumulation)
        self.bc_divided = loss_name in ("L1", "L1withColor", "L1ColorLum",
                                        "L2")
        self.batch_linear = not (self.bc_divided
                                 or loss_name.startswith("Adaptive"))

    def getloss(self, pred, truth):
        name, p, t = self.loss_name, pred, truth
        bc = t.shape[0] * t.shape[1]  # B * C of NCHW, as the reference
        if name == "L1":
            return l1_loss(p, t) / bc
        if name in ("L1withColor", "L1ColorLum"):
            loss = 0.5 * color_loss(p, t)
            loss = loss + 0.25 * l1_loss(p, t)
            loss = loss + 0.25 * luminance_loss(p, t)
            return loss / bc
        if name == "L2":
            return mse_loss(p, t) / bc
        if name == "charbonnier":
            return charbonnier_loss(p, t)
        if name == "LuminanceCharbonnier":
            return luminance_loss(p, t) + charbonnier_loss(p, t)
        if name == "Luminance":
            return luminance_loss(p, t)
        return _adaptive_pair(charbonnier_loss(p, t), luminance_loss(p, t))

    __call__ = getloss


__all__ = [
    "LOSS_NAMES",
    "LossFunction",
    "PORTED",
    "charbonnier_loss",
    "color_loss",
    "l1_loss",
    "luminance_loss",
    "mse_loss",
    "psnr",
]
