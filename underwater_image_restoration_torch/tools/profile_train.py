"""Where the train step's time goes on the GPU: the training twin of
``profile_serving``.

Traces STEPS train steps of a full-width model (SIZE x SIZE, batch BATCH,
bf16 compute over f32 parameters, ``L1withColor``, Adam lr 3e-4 behind the
global-norm clip, seeded weights, ``make_train_step``; SpectralTransformer,
or AST with ``--arch AST``, its DropPath drawing from a seeded generator)
with ``torch.profiler`` and prints device time by kernel group (the port's
forward and backward kernels, cuDNN convolutions and cuBLAS products and
their gradients, FFTs, the optimizer, the rest) beside the wall time, so the
device's idle share shows.  Needs a CUDA GPU:

    python -m underwater_image_restoration_torch.tools.profile_train \
        [--arch AST]
"""
from __future__ import annotations

import argparse

import torch

from ..data import synthetic_pair_batch
from ..losses import LossFunction
from ..models import init_model
from ..train import get_optimizer, make_train_step
from .profile_serving import card, profile

# the train cells' shape (``chip_smoke.py`` trains the same) and the number
# of traced steps
BATCH = 16
SIZE = 256
STEPS = 5
LR = 3e-4


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="SpectralTransformer",
                   choices=("SpectralTransformer", "AST"))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    print(card())
    model = init_model(args.arch, seed=0, compute_dtype=torch.bfloat16,
                       img_size=SIZE)
    opt = get_optimizer("adam", model.parameters(), LR)
    step = make_train_step(
        model, LossFunction("L1withColor"), opt,
        generator=torch.Generator(device="cuda").manual_seed(0))
    raw, ref = synthetic_pair_batch(BATCH, SIZE, seed=0)
    for _ in range(2):
        step(raw, ref)
    torch.cuda.synchronize()
    return profile(lambda: step(raw, ref), STEPS,
                   f"{args.arch} train step, batch {BATCH} at {SIZE}x{SIZE} "
                   "bf16")


if __name__ == "__main__":
    raise SystemExit(main())
