"""Serving path of the port: batched inference over uint8 images."""
from .evaluate import batched_apply, infer_directory, run_batched
from .metrics import psnr_float_pm1, save_img

__all__ = ["batched_apply", "infer_directory", "psnr_float_pm1",
           "run_batched", "save_img"]
