"""Offline evaluation, counterpart of the JAX package's ``eval/evaluate.py``
(the CLI form of the reference's ``eval.ipynb``):

1. ``evaluate_pairs``: the model over the paired test split, pred/ref PNG
   pairs dumped ([-1, 1] -> u8), float PSNR an image (subcommand
   ``pairs``).
2. ``infer_directory``: U45-style unpaired inference, resized, outputs
   dumped (``infer``).
3. ``uiqm_sweep``: UIQM over a directory, cv2's BGR order emulated by
   default (``uiqm``).
4. ``dir_ssim_psnr``: SSIM and grayscale-u8 PSNR over dumped pairs, the
   PSNR mean without its 4 lowest samples (``ssim-psnr``).
5. ``loss_sanity``: every loss name on (x, x) (``loss-sanity``).

uint8 NHWC batches go to the model's device, are normalized there
(``(u8 / 255 - 0.5) / 0.5``), run through the model in NCHW and come back as
float32 NHWC in [-1, 1].  A failing batch raises: there is no retry at a
smaller batch, which would hide a kernel fault; running out of device
memory says to pass a smaller ``--batch``.

Run as:  python -m underwater_image_restoration_torch.eval <subcommand> ...
"""
from __future__ import annotations

import argparse
import contextlib
import os

import numpy as np
import torch

from .metrics import (
    drop_lowest,
    psnr_float_pm1,
    psnr_gray_u8,
    save_img,
    ssim_pair_u8,
    to_gray_u8,
)
from .uiqm import compute_uiqm


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


@contextlib.contextmanager
def _batch_fits(batch_size: int):
    """Re-raise the device running out of memory with the way out."""
    try:
        yield
    except torch.cuda.OutOfMemoryError as e:
        raise torch.cuda.OutOfMemoryError(
            f"out of device memory at batch {batch_size}: pass a smaller "
            f"--batch ({e})") from e


def evaluate_pairs(model, test_raw_dir: str, test_ref_dir: str,
                   out_pred: str = "test", out_ref: str = "ref",
                   image_size: int = 1024, batch_log: int = 20,
                   batch_size: int = 8, use_kernels: bool = True):
    """The model over the sorted-listing pairs of the two directories,
    resized to ``image_size``: ``<i>.png`` pred and ref pairs dumped;
    returns the float PSNR of each image (data_range 2)."""
    from ..data import UIEBDataset

    ds = UIEBDataset(test_raw_dir, test_ref_dir, image_size)
    bs = min(batch_size, max(1, len(ds)))
    apply_b, bs = batched_apply(model, bs, use_kernels)
    refs = {}

    def raws():
        for i in range(len(ds)):
            raw_u8, refs[i] = ds[i]
            yield raw_u8

    psnrs = []
    with _batch_fits(bs):
        for i, y in run_batched(raws(), len(ds), apply_b, bs):
            ref = (refs.pop(i).astype(np.float32) / 255.0 - 0.5) / 0.5
            save_img(y, os.path.join(out_pred, f"{i}.png"))
            save_img(ref, os.path.join(out_ref, f"{i}.png"))
            psnrs.append(psnr_float_pm1(ref, y))
            if (i + 1) % batch_log == 0:
                print(f"Processed {i + 1}/{len(ds)} test images")
    psnrs = np.asarray(psnrs)
    print("Evaluation Results:")
    print(f"Average PSNR: {psnrs.mean():.2f} dB")
    return psnrs


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
    with _batch_fits(bs):
        for idx, y in run_batched(u8s, len(files), apply_b, bs):
            save_img(y, os.path.join(out_dir, f"{idx}.png"))
    return len(files)


def uiqm_sweep(image_dir: str, size: int = 256, emulate_cv2: bool = True):
    """UIQM of every image in a directory (resized to size x size)."""
    from ..data.uieb import decode_image

    vals = np.asarray([
        compute_uiqm(decode_image(os.path.join(image_dir, f), size),
                     emulate_cv2=emulate_cv2)[0]
        for f in sorted(os.listdir(image_dir))])
    print("UIQM on {0} samples {1} ± {2}".format(
        len(vals), np.round(vals.mean(), 3), np.round(vals.std(), 3)))
    return vals


def dir_ssim_psnr(gen_dir: str, gt_dir: str, size: int = 256,
                  drop_n: int = 4, device=None):
    """SSIM (on ``device``) and grayscale PSNR over same-named dumped pairs;
    the printed PSNR mean drops the ``drop_n`` lowest samples (the
    notebook's quirk).  Returns (SSIMs, PSNRs), every sample."""
    from ..data.uieb import decode_image

    ssims, psnrs = [], []
    for f in sorted(os.listdir(gen_dir)):
        gen = decode_image(os.path.join(gen_dir, f), size)
        gt = decode_image(os.path.join(gt_dir, f), size)
        ssims.append(ssim_pair_u8(gen, gt, device))
        psnrs.append(psnr_gray_u8(to_gray_u8(gt), to_gray_u8(gen)))
    ssims = np.asarray(ssims)
    trimmed = drop_lowest(np.asarray(psnrs), drop_n)
    print("SSIM on {0} samples {1} ± {2}".format(
        len(ssims), np.round(ssims.mean(), 3), np.round(ssims.std(), 3)))
    print("PSNR on {0} samples {1} ± {2}".format(
        len(trimmed), np.round(trimmed.mean(), 3), np.round(trimmed.std(), 3)))
    return ssims, np.asarray(psnrs)


def loss_sanity(image_path: str | None = None, size: int = 64,
                vgg_weights: str = "", device=None):
    """Every loss name on identity inputs (x, x), the reference's
    ``src/Loss.ipynb`` cell 0: its floor value, on ``device``.  The
    perceptual family may run on the placeholder trunk here (the floor of
    loss(x, x) is 0 with either trunk); the MS-SSIM names are skipped below
    161 pixels a side."""
    from .._device import resolve_device
    from ..data import decode_image, synthetic_pair_batch
    from ..losses import LOSS_NAMES, LossFunction

    if image_path:
        u8 = decode_image(image_path, size)[None]
    else:
        u8 = synthetic_pair_batch(1, size)[0]
    x = torch.as_tensor(u8).to(resolve_device(device)).float() / 255.0
    x = (x * 2.0 - 1.0).permute(0, 3, 1, 2).contiguous()
    out = {}
    with torch.no_grad():
        for name in LOSS_NAMES:
            fn = LossFunction(name, vgg_weights=vgg_weights,
                              allow_placeholder_vgg=True)
            try:
                v = fn(x, x)
            except ValueError as e:  # ms_ssim needs > 160 pixels a side
                print(f"{name}: skipped ({e})")
                continue
            out[name] = float(v[0] if fn.returns_components else v)
            print(f"{name}: {out[name]:.6g}")
    return out


def load_model(weights: str, arch: str, device=None,
               compute_dtype: torch.dtype = torch.float32,
               img_size: int = 256, use_dwt: str = "Fourier"):
    """Build ``arch`` (AST and the New* models for ``img_size`` x
    ``img_size`` images, the New* models with ``use_dwt``; the
    SpectralTransformer takes any size) on ``device`` and load ``weights``:
    a checkpoint directory of ``train.checkpoint`` (a manager directory's
    latest step, or one step's directory), a ``.npz`` of the JAX package's
    flat parameters, or a reference ``.pth`` checkpoint."""
    from ..models import init_model
    from ..tools.convert import load_reference_state_dict, params_from_jax
    from ..train.checkpoint import restore_params

    model = init_model(arch, device=device, compute_dtype=compute_dtype,
                       img_size=img_size, use_dwt=use_dwt)
    if weights.endswith(".npz"):
        with np.load(weights) as z:
            model.load_state_dict(params_from_jax(dict(z)), strict=True)
    elif weights.endswith(".pth"):
        sd = torch.load(weights, map_location="cpu", weights_only=True)
        load_reference_state_dict(model, sd)
    else:
        model.load_state_dict(restore_params(weights), strict=True)
    return model


_DTYPES = {"fp32": "float32", "bf16": "bfloat16"}


def _load_model(args, size: int):
    from ..core.config import Config
    from ..obs.visualiser import load_model_from_weights

    cfg = Config(arch=args.arch, use_dwt=args.use_dwt,
                 compute_dtype=_DTYPES[args.compute_dtype])
    return load_model_from_weights(args.weights, cfg, args.arch,
                                   img_size=size, device=args.device)


def main(argv=None):
    p = argparse.ArgumentParser(prog="underwater_image_restoration_torch.eval")
    sub = p.add_subparsers(dest="cmd", required=True)

    def device_flag(sp):
        sp.add_argument("--device", default=None,
                        help="default: the first CUDA device (raises "
                             "without one); 'cpu' runs the plain versions")

    def model_flags(sp):
        sp.add_argument("--weights", required=True,
                        help="a checkpoint directory of the trainer, an "
                             ".npz of JAX flat params or a reference .pth")
        sp.add_argument("-a", "--arch", default="NewBigModel")
        sp.add_argument("--use-dwt", default="Wavelet",
                        help="the New* models' frequency branch: Wavelet "
                             "or Fourier")
        sp.add_argument("--compute-dtype", choices=sorted(_DTYPES),
                        default="bf16")
        device_flag(sp)

    pe = sub.add_parser("pairs", help="UIEB test sweep (eval.ipynb cell 1)")
    model_flags(pe)
    pe.add_argument("--test-raw", required=True)
    pe.add_argument("--test-ref", required=True)
    pe.add_argument("--image-size", type=int, default=1024)
    pe.add_argument("--out-pred", default="test")
    pe.add_argument("--out-ref", default="ref")
    pe.add_argument("--batch", type=int, default=8,
                    help="images per forward")

    pi = sub.add_parser("infer", help="U45 inference (cell 2)")
    model_flags(pi)
    pi.add_argument("--input", required=True)
    pi.add_argument("--out", default="uTest")
    pi.add_argument("--size", type=int, default=256,
                    help="images are resized to size x size (the img_size "
                         "of AST and the New* models)")
    pi.add_argument("--batch", type=int, default=8,
                    help="images per forward")

    pu = sub.add_parser("uiqm", help="UIQM sweep (cell 3)")
    pu.add_argument("--dir", required=True)
    pu.add_argument("--size", type=int, default=256)
    pu.add_argument("--rgb", action="store_true",
                    help="disable the cv2-BGR emulation quirk")

    pl = sub.add_parser("loss-sanity", help="loss(x, x) floor per loss name "
                                            "(src/Loss.ipynb)")
    pl.add_argument("--image", default="")
    pl.add_argument("--size", type=int, default=64)
    pl.add_argument("--vgg-weights", default="")
    device_flag(pl)

    ps = sub.add_parser("ssim-psnr", help="pairs SSIM/PSNR (cell 4)")
    ps.add_argument("--gen", required=True)
    ps.add_argument("--gt", required=True)
    ps.add_argument("--size", type=int, default=256)
    ps.add_argument("--drop", type=int, default=4)
    device_flag(ps)

    args = p.parse_args(argv)
    if args.cmd == "pairs":
        model = _load_model(args, args.image_size)
        return evaluate_pairs(model, args.test_raw, args.test_ref,
                              args.out_pred, args.out_ref, args.image_size,
                              batch_size=args.batch)
    if args.cmd == "infer":
        model = _load_model(args, args.size)
        n = infer_directory(model, args.input, args.out, args.size,
                            args.batch)
        print(f"wrote {n} images to {args.out}")
        return n
    if args.cmd == "uiqm":
        return uiqm_sweep(args.dir, args.size, emulate_cv2=not args.rgb)
    if args.cmd == "loss-sanity":
        return loss_sanity(args.image, args.size, args.vgg_weights,
                           args.device)
    return dir_ssim_psnr(args.gen, args.gt, args.size, args.drop,
                         args.device)


if __name__ == "__main__":
    main()
