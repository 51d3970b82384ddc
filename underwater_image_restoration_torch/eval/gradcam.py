"""Grad-CAM (reference ``src/Interpretability.ipynb``), the port's counterpart
of the JAX package's ``eval/gradcam.py``.

The notebook runs pytorch_grad_cam's GradCAM on ``model.output_proj.proj``
with a sum-of-output target.  Here a forward hook takes the target
module's activation A (and puts a leaf in its place, so the rest of the
forward runs on it), G = d(sum(output))/dA, then
CAM = relu(sum_c GAP(G)_c * A_c), min-max normalized and bilinearly resized
to the input: the standard GradCAM weighting.  Token activations (B, L, C)
are read as (B, sqrt L, sqrt L, C).  On CUDA the backward through the blocks
is the kernels' own.
"""
from __future__ import annotations

import math
from typing import Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F


def _find(model, target: Union[str, Sequence[str]]):
    """The first module whose dotted name is ``target`` or ends with it
    (a sequence of names is joined with dots)."""
    suffix = target if isinstance(target, str) else ".".join(target)
    for name, module in model.named_modules():
        if name == suffix or name.endswith("." + suffix):
            return module
    raise ValueError(f"no module with path suffix {suffix!r}")


def grad_cam(model, x, target: Union[str, Sequence[str]]):
    """Grad-CAM of ``model`` on NCHW images ``x`` for the module ``target``
    (a dotted name or its suffix, e.g. ``"outputl"`` or
    ``"output_proj.proj"``).  Returns (cam: float32 (H, W) numpy in [0, 1],
    the first image's, at the input's size; the activation A as the module
    gave it, numpy).  An unknown target raises ValueError."""
    module = _find(model, target)
    act = {}

    def hook(_mod, _inp, out):
        if "a" in act or not isinstance(out, torch.Tensor):
            return None
        act["a"] = out.detach().float().requires_grad_()
        return act["a"].to(out.dtype)

    handle = module.register_forward_hook(hook)
    try:
        with torch.enable_grad():
            y = model(x)
            if "a" not in act:
                raise ValueError(f"module {target!r} gave no tensor")
            (g,) = torch.autograd.grad(y.float().sum(), act["a"])
    finally:
        handle.remove()
    a = act["a"].detach()
    if a.dim() == 3:  # tokens (B, L, C) -> (B, H, W, C)
        hw = math.isqrt(a.shape[1])
        a_hwc = a.reshape(a.shape[0], hw, hw, a.shape[2])
        g = g.reshape(a_hwc.shape)
    else:  # (B, C, H, W) -> (B, H, W, C)
        a_hwc, g = a.permute(0, 2, 3, 1), g.permute(0, 2, 3, 1)
    weights = g.mean(dim=(1, 2), keepdim=True)  # GAP over space
    cam = torch.relu((weights * a_hwc).sum(-1))[0]
    cam = cam - cam.min()
    cam = cam / (cam.max() + 1e-8)
    return resize_cam(cam, tuple(x.shape[2:])).cpu().numpy(), \
        a.cpu().numpy()


def resize_cam(cam, size):
    """A (h, w) map resized bilinearly to ``size`` (half-pixel centers, as
    ``jax.image.resize``; antialiased when it shrinks); the map itself at
    its own size."""
    if tuple(cam.shape) == tuple(size):
        return cam
    return F.interpolate(cam[None, None], size=size, mode="bilinear",
                         align_corners=False,
                         antialias=cam.shape[0] > size[0])[0, 0]
