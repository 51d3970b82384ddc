"""VGG16 perceptual loss on NCHW images, counterpart of the JAX package's
``losses/perceptual.py`` (reference losses.py:215-255).

The frozen VGG16 feature trunk (torchvision's ``vgg16().features`` up to
index 22) as plain ``conv2d`` + ReLU + ``max_pool2d`` over weight tensors:
the inputs are normalized with the ImageNet mean and std, resized
bilinearly to 224x224 (no antialiasing, as the reference's
``F.interpolate``), and the loss is the sum over the four taps (after the
ReLUs of features 3, 8, 15 and 22) of the mean L1 distance.

Weights (``load_vgg16_weights``): the ``.npz`` of HWIO kernels that the
JAX package's converter writes, or a ``torch.save``d torchvision
``vgg16().features.state_dict()`` (mapped by ``tools.convert_vgg16``).
Without a file, a deterministic He-normal placeholder (numpy
``default_rng(1234)``, bit-equal to the JAX package's) with a warning
once; training against it does not match the reference, so
``LossFunction`` refuses the perceptual family without a file unless the
caller opts in.
"""
from __future__ import annotations

import functools
import os
import warnings

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.layers import constant
from ..tools.convert_vgg16 import convert_state_dict

# (name, out_channels, in_channels); "M" = 2x2 max pool.  torchvision's
# vgg16.features layout up to index 22
_VGG16_CFG = [
    ("conv0", 64, 3),
    ("conv2", 64, 64),
    "M",
    ("conv5", 128, 64),
    ("conv7", 128, 128),
    "M",
    ("conv10", 256, 128),
    ("conv12", 256, 256),
    ("conv14", 256, 256),
    "M",
    ("conv17", 512, 256),
    ("conv19", 512, 512),
    ("conv21", 512, 512),
]
# feature taps: after the ReLU of these convs (torch indices 3, 8, 15, 22)
_TAPS = {"conv2", "conv7", "conv14", "conv21"}

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)

_warned = False


def _placeholder_weights() -> dict:
    """He-normal HWIO kernels from numpy ``default_rng(1234)``, zero
    biases."""
    global _warned
    if not _warned:
        warnings.warn(
            "VGG16 weights file not found — using deterministic placeholder "
            "weights. Perceptual-loss training will not match the reference "
            "until you provide converted weights (an .npz of HWIO kernels, "
            "or a torchvision vgg16().features state dict).",
            stacklevel=2,
        )
        _warned = True
    rng = np.random.default_rng(1234)
    out = {}
    for item in _VGG16_CFG:
        if item == "M":
            continue
        name, oc, ic = item
        fan_in = ic * 9
        out[f"{name}.kernel"] = (
            rng.standard_normal((3, 3, ic, oc)).astype(np.float32)
            * np.sqrt(2.0 / fan_in)
        )
        out[f"{name}.bias"] = np.zeros((oc,), np.float32)
    return out


def load_vgg16_weights(path: str = "") -> dict:
    """``{conv<i>.kernel: HWIO, conv<i>.bias}`` float32 numpy arrays from
    ``path`` (an ``.npz``, else a torchvision features state dict), or the
    placeholder when ``path`` is empty or missing."""
    if not (path and os.path.exists(path)):
        return _placeholder_weights()
    if path.endswith(".npz"):
        with np.load(path) as z:
            data = dict(z)
    else:
        data = convert_state_dict(torch.load(path, map_location="cpu",
                                             weights_only=True))
    weights = {}
    for item in _VGG16_CFG:
        if item == "M":
            continue
        name, oc, ic = item
        k = data[f"{name}.kernel"]
        if k.shape != (3, 3, ic, oc):
            raise ValueError(f"{path}: {name}.kernel has shape {k.shape}, "
                             f"not {(3, 3, ic, oc)}")
        weights[f"{name}.kernel"] = k.astype(np.float32)
        weights[f"{name}.bias"] = data[f"{name}.bias"].astype(np.float32)
    return weights


@functools.lru_cache(maxsize=4)
def _trunk(path: str, device: torch.device) -> tuple:
    """The trunk's layers on ``device``: ("M", None, None) or (name, OIHW
    kernel, bias), loaded once a (path, device)."""
    weights = load_vgg16_weights(path)
    layers = []
    for item in _VGG16_CFG:
        if item == "M":
            layers.append(("M", None, None))
            continue
        name = item[0]
        k = torch.from_numpy(weights[f"{name}.kernel"].transpose(3, 2, 0, 1)
                             .astype(np.float32))
        b = torch.from_numpy(weights[f"{name}.bias"].astype(np.float32))
        layers.append((name, k.to(device), b.to(device)))
    return tuple(layers)


def _vgg_features(x, layers) -> list:
    """The four tap activations of NCHW ``x``."""
    feats = []
    for name, k, b in layers:
        if name == "M":
            x = F.max_pool2d(x, 2)
            continue
        x = torch.relu(F.conv2d(x, k, b, padding=1))
        if name in _TAPS:
            feats.append(x)
    return feats


def resize_bilinear(x, h: int, w: int):
    """Bilinear resize of NCHW ``x``, half-pixel centres, no antialiasing
    (``F.interpolate(mode="bilinear", align_corners=False)``)."""
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False,
                         antialias=False)


def vgg_perceptual_loss(pred, target, weights_path: str = "",
                        resize: bool = True):
    """Sum over the four VGG16 taps of the mean L1 distance (reference
    losses.py:232-248, feature_layers [0, 1, 2, 3], no style terms)."""
    layers = _trunk(weights_path, pred.device)
    mean = constant(_IMAGENET_MEAN, pred.device).view(1, 3, 1, 1)
    std = constant(_IMAGENET_STD, pred.device).view(1, 3, 1, 1)
    p = (pred.float() - mean) / std
    t = (target.float() - mean) / std
    if resize:
        p = resize_bilinear(p, 224, 224)
        t = resize_bilinear(t, 224, 224)
    loss = 0.0
    for a, b in zip(_vgg_features(p, layers), _vgg_features(t, layers)):
        loss = loss + (a - b).abs().mean()
    return loss
