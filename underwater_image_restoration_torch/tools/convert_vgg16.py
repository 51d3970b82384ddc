"""torchvision's VGG16 ``features`` state dict -> the ``.npz`` layout of the
perceptual loss (``losses/perceptual.py``): HWIO kernels named
``conv<i>.kernel`` / ``conv<i>.bias`` for the feature indices
0, 2, 5, 7, 10, 12, 14, 17, 19, 21.

The mapping only: no weights are downloaded.  ``losses.perceptual``
applies it to a ``torch.save``d ``vgg16().features.state_dict()``.
"""
from __future__ import annotations

import numpy as np

_CONV_IDXS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21)


def convert_state_dict(features_state: dict) -> dict:
    """``vgg16().features.state_dict()`` (tensors or arrays) -> npz dict of
    float32 numpy arrays."""
    out = {}
    for i in _CONV_IDXS:
        w = np.asarray(features_state[f"{i}.weight"])  # OIHW
        b = np.asarray(features_state[f"{i}.bias"])
        out[f"conv{i}.kernel"] = w.transpose(2, 3, 1, 0).astype(np.float32)
        out[f"conv{i}.bias"] = b.astype(np.float32)
    return out
