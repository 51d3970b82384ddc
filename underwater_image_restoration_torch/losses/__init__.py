"""String-dispatched composite losses, counterpart of the JAX package's
``losses/__init__.py`` ``LossFunction`` on NCHW images: all 20 names of the
reference with its weights.

Kept quirks: L1/L1withColor/L1ColorLum/L2 divide by B*C (``bc_divided``:
the value is not a batch mean); the Adaptive pair weights its two terms by
softmax(-log(detached losses)), which couples the whole batch
(``batch_linear`` is False); ``fflMix`` returns the 6-tuple (loss, charb,
perc, grad, ffl, ssim) (``returns_components``).  The perceptual family
needs ImageNet VGG16 weights: without a weights file ``LossFunction``
raises FileNotFoundError unless the caller passes
``allow_placeholder_vgg=True``.
"""
from __future__ import annotations

import copy
import os

import torch

from .ffl import focal_frequency_loss
from .msssim import ms_ssim, ssim
from .perceptual import vgg_perceptual_loss
from .primitives import (
    charbonnier_loss,
    color_loss,
    gradient_loss,
    l1_loss,
    luminance_loss,
    mse_loss,
    psnr,
    tv_loss,
)

LOSS_NAMES = [
    "L1", "L1withColor", "L1ColorLum", "L2", "charbonnier", "perceptual",
    "gradient", "ms_ssim", "ffl", "mix", "fflMixTV", "bigMix",
    "fflCharbonnier", "fflMix", "LuminanceCharbonnier", "Luminance",
    "AdaptiveLuminanceCharbonnier", "AdaptiveLuminanceFFL", "LuminanceFFL",
    "ssimFFLCharbonnier",
]
# losses whose value depends on ImageNet-pretrained VGG16 features
PERCEPTUAL_FAMILY = frozenset(
    {"perceptual", "mix", "bigMix", "fflMix", "fflMixTV"})
# the names of fflMix's five components, as the train step logs them
COMPONENTS = ("Charbonnier", "Perceptual", "Gradient Loss", "FFL Loss",
              "MS_SSIM Loss")


def _adaptive_pair(a, b, batch_mean=None):
    """0.5/0.5 weights modulated by softmax(-log(detached losses));
    ``batch_mean`` (data parallelism) turns the rank's detached losses into
    the global batch's before the weights are formed."""
    losses = torch.stack([a, b])
    d = losses.detach()
    if batch_mean is not None:
        d = batch_mean(d)
    scales = torch.softmax(-torch.log(d + 1e-6), dim=0)
    return (losses * 0.5 * scales).sum()


class LossFunction:
    """name -> (pred, truth) -> float32 scalar (the 6-tuple for fflMix), on
    NCHW images."""

    def __init__(self, loss_name: str, vgg_weights: str = "",
                 allow_placeholder_vgg: bool = False):
        if loss_name not in LOSS_NAMES:
            raise ValueError(f"Unsupported loss: {loss_name}")
        if loss_name in PERCEPTUAL_FAMILY and not allow_placeholder_vgg \
                and not (vgg_weights and os.path.exists(vgg_weights)):
            raise FileNotFoundError(
                f"Loss '{loss_name}' needs ImageNet-pretrained VGG16 "
                f"features (reference losses.py:219-222) but no weights "
                f"file was found (vgg_weights={vgg_weights!r}). Pass "
                "--vgg-weights with an .npz of HWIO kernels or a "
                "torch.save'd torchvision vgg16().features.state_dict(), or "
                "opt into the random placeholder trunk with "
                "--allow-placeholder-vgg (training will NOT match the "
                "reference).")
        self.loss_name = loss_name
        self._vgg = vgg_weights
        self.returns_components = loss_name == "fflMix"
        # how the loss scales with the batch (consumers: grad accumulation
        # and the masked per-sample validation loss)
        self.bc_divided = loss_name in ("L1", "L1withColor", "L1ColorLum",
                                        "L2")
        self.batch_linear = not (self.bc_divided
                                 or loss_name.startswith("Adaptive"))
        # data parallelism: the rank's detached batch means -> the global
        # batch's (the Adaptive pair's weights)
        self.batch_mean = None

    def with_batch_mean(self, batch_mean) -> "LossFunction":
        """A copy whose Adaptive weights are formed from
        ``batch_mean(the rank's detached losses)``: the global batch's
        under data parallelism (the ranks' rows are equal in number, so the
        mean of the ranks' batch means is the global one)."""
        other = copy.copy(self)
        other.batch_mean = batch_mean
        return other

    def _perc(self, p, t):
        return vgg_perceptual_loss(p, t, weights_path=self._vgg)

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
        if name == "perceptual":
            return self._perc(p, t)
        if name == "gradient":
            return gradient_loss(p, t)
        if name == "ms_ssim":
            return 1.0 - ms_ssim(p, t)
        if name == "ffl":
            return focal_frequency_loss(p, t)
        if name == "mix":
            return (0.03 * charbonnier_loss(p, t) + 0.025 * self._perc(p, t)
                    + 0.02 * gradient_loss(p, t)
                    + 0.01 * (1.0 - ms_ssim(p, t)))
        if name == "fflMixTV":
            return (0.03 * charbonnier_loss(p, t) + 0.025 * self._perc(p, t)
                    + 0.02 * gradient_loss(p, t)
                    + 0.01 * (1.0 - ms_ssim(p, t))
                    + 0.02 * focal_frequency_loss(p, t) + tv_loss(p))
        if name == "bigMix":
            return (0.4 * charbonnier_loss(p, t) + 0.25 * self._perc(p, t)
                    + 0.25 * gradient_loss(p, t)
                    + 0.1 * (1.0 - ms_ssim(p, t)))
        if name == "fflCharbonnier":
            return focal_frequency_loss(p, t) + charbonnier_loss(p, t)
        if name == "fflMix":
            charb = charbonnier_loss(p, t)
            perc = self._perc(p, t)
            grad = gradient_loss(p, t)
            ffl = focal_frequency_loss(p, t)
            ssim_l = 1.0 - ms_ssim(p, t)
            loss = (0.03 * charb + 0.025 * perc + 0.01 * grad + 0.005 * ffl
                    + 0.1 * ssim_l)
            return loss, charb, perc, grad, ffl, ssim_l
        if name == "LuminanceCharbonnier":
            return luminance_loss(p, t) + charbonnier_loss(p, t)
        if name == "Luminance":
            return luminance_loss(p, t)
        if name == "AdaptiveLuminanceCharbonnier":
            return _adaptive_pair(charbonnier_loss(p, t), luminance_loss(p, t),
                                  self.batch_mean)
        if name == "AdaptiveLuminanceFFL":
            return _adaptive_pair(focal_frequency_loss(p, t),
                                  luminance_loss(p, t), self.batch_mean)
        if name == "LuminanceFFL":
            return focal_frequency_loss(p, t) + luminance_loss(p, t)
        # ssimFFLCharbonnier
        return (0.025 * focal_frequency_loss(p, t)
                + 0.025 * charbonnier_loss(p, t) + (1.0 - ms_ssim(p, t)))

    __call__ = getloss


__all__ = [
    "COMPONENTS",
    "LOSS_NAMES",
    "LossFunction",
    "PERCEPTUAL_FAMILY",
    "charbonnier_loss",
    "color_loss",
    "focal_frequency_loss",
    "gradient_loss",
    "l1_loss",
    "luminance_loss",
    "mse_loss",
    "ms_ssim",
    "psnr",
    "ssim",
    "tv_loss",
    "vgg_perceptual_loss",
]
