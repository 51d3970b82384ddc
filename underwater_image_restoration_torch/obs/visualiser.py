"""Inference/visualization path (reference ``src/utils/Visualiser.py``), the
port's counterpart of the JAX package's ``obs/visualiser.py``.

``process_image_using_model``: PIL open -> bicubic resize 256^2 -> normalize
(mean/std 0.5) -> model -> clip [0,1] -> PNG under ``Images/<dir><name>.png``
(Visualiser.py:15-61).  Works on any callable ``apply(x_nhwc) -> y_nhwc``
of float32 numpy arrays.  ``load_model_from_weights`` builds a model on the
device and loads a port checkpoint directory (``train.checkpoint``), a
``.npz`` of the JAX package's flat parameters or a reference ``.pth``.
"""
from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np


def prep_image(path: str, size: int = 256) -> np.ndarray:
    """The probe's input: (1, size, size, 3) float32 in [-1, 1]."""
    from PIL import Image

    with Image.open(path) as im:
        rgb = im.convert("RGB").resize((size, size), Image.BICUBIC)
    arr = np.asarray(rgb, np.float32) / 255.0
    return ((arr - 0.5) / 0.5)[None]  # (1,H,W,3) in [-1,1]


def save_from_array(directory: str, save_name: str, result: np.ndarray,
                    root: str = "Images"):
    """NHWC/HWC float array -> clip[0,1] -> uint8 PNG (Visualiser.py:36-61).
    The reference clips to [0,1] although the model works in [-1,1];
    behaviour kept."""
    from PIL import Image

    arr = np.asarray(result)
    if arr.ndim == 4:
        arr = arr[0]
    arr = np.clip(arr, 0.0, 1.0)
    arr = (arr * 255).astype(np.uint8)
    img = Image.fromarray(arr).convert("RGB")
    out_dir = os.path.join(root, directory) if directory else root
    os.makedirs(out_dir, exist_ok=True)
    img.save(os.path.join(out_dir, f"{save_name}.png"))
    return img


def process_image_using_model(
    apply_fn: Callable[[np.ndarray], np.ndarray],
    file_to_test: str,
    directory: str,
    save_name: str,
    size: int = 256,
    logger=None,
):
    x = prep_image(file_to_test, size)
    y = np.asarray(apply_fn(x))
    img = save_from_array(directory, save_name, y)
    if logger is not None:
        logger.log_image(img, save_name)
    return img


def model_apply(model, use_kernels: bool = True):
    """``apply(x)``: float32 NHWC numpy in [-1, 1] -> the model's float32
    NHWC numpy output, in eval mode on the model's device.  A model built
    with a context group (``cp``) takes each rank's band of the rows and
    gathers the output: every rank of the group calls ``apply``."""
    import torch

    dev = next(model.parameters()).device
    cp = getattr(model, "cp", None)
    if cp is not None and cp.size == 1:
        cp = None

    @torch.no_grad()
    def apply(x):
        was_training = model.training
        model.eval()
        try:
            t = torch.as_tensor(np.ascontiguousarray(x)).to(dev)
            t = t.permute(0, 3, 1, 2)
            if cp is not None:  # every rank its band, then the whole image
                from ..parallel import gather_replicated

                t = t[:, :, cp.band(t.shape[2])]
            y = model(t.contiguous(), use_kernels)
            if cp is not None:
                y = gather_replicated(y, cp, 2)
        finally:
            model.train(was_training)
        return y.permute(0, 2, 3, 1).float().cpu().numpy()

    return apply


def load_model_from_weights(ckpt_path: str, config, arch: Optional[str] = None,
                            img_size: Optional[int] = None, device=None):
    """Build ``arch`` (default ``config.arch``) in ``config.compute_dtype``
    on ``device`` (default: the CPU with ``config.use_cpu``, else CUDA) and
    load ``ckpt_path`` (reference Visualiser.py:64-67) through
    ``eval.load_model``: a checkpoint directory of ``train.checkpoint``, a
    ``.npz`` of the JAX package's flat parameters or a reference ``.pth``.
    ``img_size`` specializes the size-dependent archs (AST, New*) to the
    inference resolution."""
    from ..core.config import compute_dtype_of
    from ..eval.evaluate import load_model

    if device is None and config.use_cpu:
        device = "cpu"
    return load_model(ckpt_path, arch or config.arch, device,
                      compute_dtype_of(config),
                      img_size or config.image_size, config.use_dwt)
