"""Offline evaluation and serving of the port (reference ``eval.ipynb``,
``uqim_utils.py``, ``utils.py``): batched inference over uint8 images,
the paired test sweep, UIQM, the u8 metrics and the loss sanity sweep."""
from .evaluate import (
    batched_apply,
    dir_ssim_psnr,
    evaluate_pairs,
    infer_directory,
    loss_sanity,
    run_batched,
    uiqm_sweep,
)
from .metrics import (
    drop_lowest,
    psnr_float_pm1,
    psnr_gray_u8,
    save_img,
    ssim_pair_u8,
    to_gray_u8,
)
from .uiqm import compute_uiqm, getUIQM

__all__ = [
    "batched_apply",
    "compute_uiqm",
    "dir_ssim_psnr",
    "drop_lowest",
    "evaluate_pairs",
    "getUIQM",
    "infer_directory",
    "loss_sanity",
    "psnr_float_pm1",
    "psnr_gray_u8",
    "run_batched",
    "save_img",
    "ssim_pair_u8",
    "to_gray_u8",
    "uiqm_sweep",
]
