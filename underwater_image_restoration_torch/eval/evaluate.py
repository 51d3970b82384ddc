"""Batched inference, counterpart of the JAX package's ``eval/evaluate.py``
(``_batched_apply``, ``_run_batched``, ``infer_directory`` and the ``infer``
subcommand).

uint8 NHWC batches go to the model's device, are normalized there
(``(u8 / 255 - 0.5) / 0.5``), run through the model in NCHW and come back as
float32 NHWC in [-1, 1].  A failing batch raises: there is no retry at a
smaller batch, which would hide a kernel fault.

Run as:  python -m underwater_image_restoration_torch.eval infer ...
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .metrics import save_img


def batched_apply(model, batch_size: int, use_kernels: bool = True):
    """``(apply_b, batch_size)``: ``apply_b(u8 (B, H, W, 3))`` returns the
    model's output as a float32 (B, H, W, 3) tensor on the model's device,
    without waiting for it.  ``use_kernels=False`` takes the kernels' plain
    versions (a reference for tests and the chip check)."""
    dev = next(model.parameters()).device

    @torch.no_grad()
    def apply_b(u8):
        t = torch.as_tensor(np.ascontiguousarray(u8)).to(dev,
                                                         non_blocking=True)
        x = (t.float() / 255.0 - 0.5) / 0.5
        y = model(x.permute(0, 3, 1, 2).contiguous(), use_kernels=use_kernels)
        return y.permute(0, 2, 3, 1).float()

    return apply_b, batch_size


def run_batched(u8_iter, n_images: int, apply_b, batch_size: int):
    """Yield (index, float32 HWC output) in order, B images per call.

    The last short batch is zero-padded to the batch size (the model is
    batch-independent, so padding rows cannot leak into real ones).  One
    batch stays in flight while the host copies out the previous one."""
    pending = None  # (indices, device tensor)
    buf, idxs = [], []

    def dispatch():
        nonlocal pending
        batch = np.stack(buf)
        if len(buf) < batch_size:
            pad = np.zeros((batch_size - len(buf),) + batch.shape[1:],
                           batch.dtype)
            batch = np.concatenate([batch, pad])
        out = apply_b(batch)
        prev, pending = pending, (list(idxs), out)
        buf.clear()
        idxs.clear()
        return prev

    def drain(entry):
        if entry is not None:
            host = entry[1].cpu().numpy()
            for j, gi in enumerate(entry[0]):
                yield gi, host[j]

    for i, u8 in zip(range(n_images), u8_iter):
        buf.append(u8)
        idxs.append(i)
        if len(buf) == batch_size:
            yield from drain(dispatch())
    if buf:
        yield from drain(dispatch())
    yield from drain(pending)


def infer_directory(model, input_dir: str, out_dir: str, size: int = 256,
                    batch_size: int = 8) -> int:
    """U45-style unpaired inference: sorted listing, resize, model, dump
    ``<index>.png``.  Returns the number of images."""
    from ..data.uieb import decode_image

    exts = (".jpg", ".jpeg", ".png", ".bmp", ".tiff")
    files = sorted(f for f in os.listdir(input_dir)
                   if f.lower().endswith(exts))
    if not files:
        return 0
    apply_b, bs = batched_apply(model, min(batch_size, len(files)))
    u8s = (decode_image(os.path.join(input_dir, f), size) for f in files)
    for idx, y in run_batched(u8s, len(files), apply_b, bs):
        save_img(y, os.path.join(out_dir, f"{idx}.png"))
    return len(files)


def load_model(weights: str, arch: str, device=None,
               compute_dtype: torch.dtype = torch.float32,
               img_size: int = 256, use_dwt: str = "Fourier"):
    """Build ``arch`` (AST and the New* models for ``img_size`` x
    ``img_size`` images, the New* models with ``use_dwt``; the
    SpectralTransformer takes any size) and load ``weights``: a ``.npz`` of
    the JAX package's flat parameters, or a reference ``.pth``
    checkpoint."""
    from ..models import init_model
    from ..tools.convert import load_reference_state_dict, params_from_jax

    model = init_model(arch, device=device, compute_dtype=compute_dtype,
                       img_size=img_size, use_dwt=use_dwt)
    if weights.endswith(".npz"):
        with np.load(weights) as z:
            model.load_state_dict(params_from_jax(dict(z)), strict=True)
    else:
        sd = torch.load(weights, map_location="cpu", weights_only=True)
        load_reference_state_dict(model, sd)
    return model


_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def main(argv=None):
    p = argparse.ArgumentParser(prog="underwater_image_restoration_torch.eval")
    sub = p.add_subparsers(dest="cmd", required=True)
    pi = sub.add_parser("infer", help="U45 inference over a directory")
    pi.add_argument("--weights", required=True,
                    help=".npz of JAX flat params or reference .pth")
    pi.add_argument("-a", "--arch", default="SpectralTransformer")
    pi.add_argument("--input", required=True)
    pi.add_argument("--out", default="uTest")
    pi.add_argument("--size", type=int, default=256,
                    help="images are resized to size x size (the img_size "
                         "of AST and the New* models)")
    pi.add_argument("--use-dwt", default="Fourier",
                    help="the New* models' frequency branch: Wavelet or "
                         "Fourier")
    pi.add_argument("--batch", type=int, default=8,
                    help="images per forward")
    pi.add_argument("--compute-dtype", choices=sorted(_DTYPES),
                    default="bf16")
    pi.add_argument("--device", default=None,
                    help="default: the first CUDA device (raises without "
                         "one); 'cpu' runs the plain versions")
    args = p.parse_args(argv)
    model = load_model(args.weights, args.arch, args.device,
                       _DTYPES[args.compute_dtype], args.size, args.use_dwt)
    n = infer_directory(model, args.input, args.out, args.size, args.batch)
    print(f"wrote {n} images to {args.out}")
    return n


if __name__ == "__main__":
    main()
