"""Where the train step's time goes on the GPU: the training twin of
``profile_serving``.

Traces STEPS train steps of a full-width model (SIZE x SIZE, batch BATCH,
bf16 compute over f32 parameters, ``L1withColor``, Adam lr 3e-4 behind the
global-norm clip, seeded weights, ``make_train_step``; SpectralTransformer,
AST with ``--arch AST`` or NewModel with ``--arch NewModel`` (``--use-dwt``
Wavelet, the default, or Fourier), their DropPath drawing from a seeded
generator) with ``torch.profiler`` and prints device time by kernel group
(the port's forward and backward kernels, cuDNN convolutions and cuBLAS
products and their gradients, FFTs, the optimizer, the rest) beside the
wall time, so the device's idle share shows.  For AST and NewModel it also
prints the device time inside the window attentions' backwards (a
``record_function`` range around ``WindowAttnFn.backward``), whichever
groups their kernels fall in; with ``--plain-attn-bwd`` that backward
recomputes through the plain version (autograd over (B', heads, N, N) f32
tensors) instead of ``csrc/window_attn_bwd.cu``, so the two shares can be
read side by side.  With ``--steps-per-dispatch K`` (K > 1) Adam is built
capturable and the same model is traced twice, eager single steps, then
calls of the K-step dispatch (``make_train_step(k_steps=K)``: replays of
one CUDA graph of the step), 2K steps each, every time given a step, the
host's time to issue a step among them.  Needs a CUDA GPU:

    python -m underwater_image_restoration_torch.tools.profile_train \
        [--arch AST|NewModel [--use-dwt Wavelet|Fourier] [--plain-attn-bwd]]
        [--steps-per-dispatch K]
"""
from __future__ import annotations

import argparse
import importlib

import numpy as np
import torch

from ..data import synthetic_pair_batch
from ..losses import LossFunction
from ..models import init_model
from ..train import get_optimizer, make_train_step
from .profile_serving import card, profile

_wa = importlib.import_module("underwater_image_restoration_torch.ops."
                              "window_attention")

# the train cells' shape (``chip_smoke.py`` trains the same) and the number
# of traced steps
BATCH = 16
SIZE = 256
STEPS = 5
LR = 3e-4
# the record_function range around each window attention's backward
ATTN_BWD_RANGE = "window attention backward"


def _annotate_attn_backward(plain: bool) -> None:
    """Wrap ``WindowAttnFn.backward`` in ATTN_BWD_RANGE; with ``plain``, its
    kernel is swapped for the plain recompute (a profiling comparison, for
    this process only)."""
    inner = _wa.WindowAttnFn.backward
    if plain:
        _wa.window_attn_bwd = _wa.window_attention_bwd

    def backward(ctx, g):
        with torch.profiler.record_function(ATTN_BWD_RANGE):
            return inner(ctx, g)

    _wa.WindowAttnFn.backward = staticmethod(backward)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="SpectralTransformer",
                   choices=("SpectralTransformer", "AST", "NewModel"))
    p.add_argument("--use-dwt", default="Wavelet",
                   choices=("Wavelet", "Fourier"),
                   help="NewModel's frequency branch")
    p.add_argument("--plain-attn-bwd", action="store_true",
                   help="AST, NewModel: the window attentions' backward "
                        "through the plain recompute instead of its kernel")
    p.add_argument("--steps-per-dispatch", type=int, default=1,
                   help="K > 1: trace eager steps, then the K-step dispatch "
                        "(a CUDA graph of the step replayed K times a call)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    print(card())
    ranges = {}
    if args.arch != "SpectralTransformer":
        _annotate_attn_backward(args.plain_attn_bwd)
        # the kernel backward's launches: the kernel and the dw step, and
        # reduce_rows (the step's only plain reduce_rows_kernel)
        ranges = {ATTN_BWD_RANGE: ("window_attn_bwd kernel and dw step",
                                   "backward row sums")}
    k = args.steps_per_dispatch
    model = init_model(args.arch, seed=0, compute_dtype=torch.bfloat16,
                       img_size=SIZE, use_dwt=args.use_dwt)
    opt = get_optimizer("adam", model.parameters(), LR, capturable=k > 1)
    gen = torch.Generator(device="cuda").manual_seed(0)
    lossfn = LossFunction("L1withColor")
    step = make_train_step(model, lossfn, opt, generator=gen)
    raw, ref = synthetic_pair_batch(BATCH, SIZE, seed=0)
    what = (f"{args.arch}"
            f"{'-' + args.use_dwt if args.arch == 'NewModel' else ''} "
            f"train step, batch {BATCH} at {SIZE}x{SIZE} bf16"
            + (", window attention backward through the plain recompute"
               if args.plain_attn_bwd else ""))
    for _ in range(2):
        step(raw, ref)
    torch.cuda.synchronize()
    if k == 1:
        return profile(lambda: step(raw, ref), STEPS, what, ranges)
    steps = make_train_step(model, lossfn, opt, generator=gen, k_steps=k)
    raw_k, ref_k = np.stack([raw] * k), np.stack([ref] * k)
    for _ in range(2):  # eager, then the capture and its replays
        steps(raw_k, ref_k)
    torch.cuda.synchronize()
    print(f"the K-step dispatch: {steps.captures} capture in "
          f"{steps.capture_seconds[0]:.2f} s")
    rc = profile(lambda: step(raw, ref), 2 * k, what + ", eager", ranges)
    return rc or profile(lambda: steps(raw_k, ref_k), 2,
                         what + f", {k} steps a call (CUDA graph)", ranges,
                         steps=k)


if __name__ == "__main__":
    raise SystemExit(main())
