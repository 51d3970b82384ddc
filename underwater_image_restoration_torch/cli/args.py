"""Argument schema (reference ``args.py:6-279``), the port's own copy of the
JAX package's ``cli/args.py`` ``argument_parser``: the same flag names,
defaults and quirks (``--use-wandb`` is ``store_false``; the ReID leftovers
are accepted and ignored).

Left out: ``--compile-cache``, XLA's compilation cache (the port compiles
only its kernels, cached by a hash of their sources).
``--steps-per-dispatch K`` runs K optimizer steps a call, on CUDA as
replays of a CUDA graph of the step.  ``--mesh-data N``,
``--mesh-context M`` (every arch) and ``--shard-params data|context`` run
under ``torchrun --nproc-per-node N*M`` (data, context and tensor
parallelism, FSDP2; ``core/meshes.py``).  ``--remat`` rematerializes the
models' blocks under ``--remat-policy`` '' (or 'full') or 'dots'
(``ops.layers.make_remat``); the parser keeps the JAX choices, and
``core.config.validate`` refuses 'mxu' and 'mxu+ew', the TPU's alone.
``--no-pallas`` runs the kernels' plain PyTorch versions; ``--use-cpu``
runs on the CPU (the plain versions).
"""
from __future__ import annotations

import argparse


def argument_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter
    )

    # ---- data (reference args.py:14-80) ----
    parser.add_argument("--root", type=str, default="./datasets",
                        help="root path to data directory")
    parser.add_argument("-j", "--workers", default=4, type=int,
                        help="number of data loading workers")
    parser.add_argument("--split-id", type=int, default=0,
                        help="split index (note: 0-based)")
    parser.add_argument("--height", type=int, default=128,
                        help="height of an image")
    parser.add_argument("--width", type=int, default=256,
                        help="width of an image")
    parser.add_argument("--train-sampler", type=str, default="RandomSampler",
                        help="sampler for trainloader")
    parser.add_argument("--random-erase", action="store_true",
                        help="use random erasing for data augmentation")
    parser.add_argument("--color-jitter", action="store_true",
                        help="randomly change the brightness, contrast and saturation")
    parser.add_argument("--color-aug", action="store_true",
                        help="randomly alter the intensities of RGB channels")
    parser.add_argument("--randomPerspective", action="store_true",
                        help="random perspective augmentation")
    parser.add_argument("--randomRotate", action="store_true",
                        help="random rotation augmentation")

    # ---- optimization (reference args.py:84-130) ----
    parser.add_argument("--optim", type=str, default="adam",
                        help="optimization algorithm (see train.optim)")
    parser.add_argument("--lr", default=0.0003, type=float,
                        help="initial learning rate")
    parser.add_argument("--weight-decay", default=5e-04, type=float,
                        help="weight decay")
    parser.add_argument("--momentum", default=0.9, type=float,
                        help="momentum factor for sgd and rmsprop")
    parser.add_argument("--sgd-dampening", default=0, type=float,
                        help="sgd's dampening for momentum")
    parser.add_argument("--sgd-nesterov", action="store_true",
                        help="whether to enable sgd's Nesterov momentum")
    parser.add_argument("--rmsprop-alpha", default=0.99, type=float,
                        help="rmsprop's smoothing constant")
    parser.add_argument("--adam-beta1", default=0.9, type=float,
                        help="exponential decay rate for adam's first moment")
    parser.add_argument("--adam-beta2", default=0.999, type=float,
                        help="exponential decay rate for adam's second moment")

    # ---- training schedule (reference args.py:132-165) ----
    parser.add_argument("--max-epoch", default=60, type=int,
                        help="maximum epochs to run")
    parser.add_argument("--start-epoch", default=0, type=int,
                        help="manual epoch number (useful when restart)")
    parser.add_argument("--train-batch-size", default=2, type=int,
                        help="training batch size")
    parser.add_argument("--test-batch-size", default=1, type=int,
                        help="test batch size")
    parser.add_argument("--lr-scheduler", type=str, default="multi_step",
                        help="learning rate scheduler")
    parser.add_argument("--stepsize", default=[20, 40], nargs="+", type=int,
                        help="stepsize to decay learning rate")
    parser.add_argument("--gamma", default=0.1, type=float,
                        help="learning rate decay")

    # ---- dead ReID flags accepted for parity (reference args.py:170-237) ----
    parser.add_argument("--label-smooth", action="store_true",
                        help=argparse.SUPPRESS)
    parser.add_argument("--margin", type=float, default=0.3,
                        help=argparse.SUPPRESS)
    parser.add_argument("--num-instances", type=int, default=4,
                        help=argparse.SUPPRESS)
    parser.add_argument("--lambda-xent", type=float, default=1,
                        help=argparse.SUPPRESS)
    parser.add_argument("--lambda-htri", type=float, default=1,
                        help=argparse.SUPPRESS)
    parser.add_argument("--test_size", type=int, default=800,
                        help=argparse.SUPPRESS)
    parser.add_argument("--query-remove", type=bool, default=True,
                        help=argparse.SUPPRESS)
    parser.add_argument("--visualize-ranks", action="store_true",
                        help=argparse.SUPPRESS)

    # ---- architecture (reference args.py:201-206) ----
    parser.add_argument("-a", "--arch", type=str, default="SpectralTransformer")
    parser.add_argument("-lossf", "--lossf", type=str, default="L1")
    parser.add_argument("--no-pretrained", action="store_true",
                        help="do not load pretrained weights")
    parser.add_argument("--use-dwt", type=str, default="Fourier",
                        help="frequency transform for New* models: "
                             "Wavelet | Fourier | anything-else = identity")

    # ---- test (reference args.py:211-235) ----
    parser.add_argument("--load-weights", type=str, default="", metavar="PATH",
                        help="load pretrained weights but ignore layers that don't match")
    parser.add_argument("--evaluate", action="store_true", help="evaluate only")
    parser.add_argument("--eval-freq", type=int, default=-1,
                        help="evaluation frequency (set to -1 to test only in the end)")
    parser.add_argument("--start-eval", type=int, default=0,
                        help="start to evaluate after a specific epoch")

    # ---- misc (reference args.py:240-277) ----
    parser.add_argument("--print-freq", type=int, default=10,
                        help="print frequency")
    parser.add_argument("--seed", type=int, default=1, help="manual seed")
    parser.add_argument("--resume", type=str, default="", metavar="PATH",
                        help="resume from a checkpoint")
    parser.add_argument("--save-dir", type=str, default="log",
                        help="path to save log and model weights")
    parser.add_argument("--use-cpu", action="store_true",
                        help="run on the CPU (the kernels' plain versions); "
                             "without it the run needs a CUDA GPU")
    parser.add_argument("--gpu-devices", default="0", type=str,
                        help="device ids (accepted for parity; the port "
                             "runs on the first CUDA device)")
    parser.add_argument("--use-avai-gpus", action="store_true",
                        help="use available devices instead of specified ones")
    parser.add_argument("--use-wandb", default=True, action="store_false",
                        dest="use_wandb",
                        help="disable Weights & Biases logging (enabled by default)")

    # ---- extensions (no reference equivalent) ----
    parser.add_argument("--image-size", type=int, default=1024,
                        help="train/eval resolution (reference hardcodes "
                             "1024^2 in DataLoader.py:14)")
    parser.add_argument("--mesh-data", type=int, default=-1,
                        help="data-parallel ranks, one process each under "
                             "torchrun; -1 = WORLD_SIZE")
    parser.add_argument("--mesh-context", type=int, default=1,
                        help="context-parallel ranks a data index, one "
                             "process each under torchrun: each holds a band "
                             "of the images' rows (every arch)")
    parser.add_argument("--shard-params", type=str, default="",
                        choices=["", "data", "context"],
                        help="parameter sharding: '' (replicated), "
                             "'data' or 'context' (FSDP2 over that dimension "
                             "of the mesh, replicated over the other)")
    parser.add_argument("--compute-dtype", type=str, default="bfloat16",
                        choices=["bfloat16", "float32", "float16"])
    parser.add_argument("--remat", action="store_true",
                        help="rematerialize each block's forward in the "
                             "backward (torch.utils.checkpoint) to fit "
                             "large resolutions")
    parser.add_argument("--remat-policy", type=str, default="",
                        choices=["", "full", "mxu", "mxu+ew", "dots"],
                        help="activation-checkpoint policy with --remat: "
                             "''/'full' recomputes whole blocks (the most "
                             "memory saved); 'dots' keeps the weight "
                             "products' outputs and recomputes the rest; "
                             "'mxu' and 'mxu+ew' are the TPU's alone and "
                             "refused")
    parser.add_argument("--no-pallas", action="store_true",
                        help="run the kernels' plain PyTorch versions "
                             "(use_kernels=False)")
    parser.add_argument("--checkpoint-dir", type=str, default="checkpoints")
    parser.add_argument("--profile-dir", type=str, default="",
                        help="write a torch.profiler chrome trace of the "
                             "training run here when set")
    parser.add_argument("--vgg-weights", type=str, default="",
                        help="VGG16 weights of the perceptual losses: an "
                             ".npz of HWIO kernels (conv<i>.kernel/.bias) "
                             "or a torch.save'd torchvision "
                             "vgg16().features.state_dict()")
    parser.add_argument("--cache-decoded", type=str, default="",
                        help="directory for a decoded-image uint8 memmap "
                             "cache: decode+resize happens once, later "
                             "epochs stream zero-copy (the reference "
                             "re-decodes every epoch)")
    parser.add_argument("--grad-accum", type=int, default=1,
                        help="gradient-accumulation microbatches per "
                             "optimizer step (train-batch-size must divide "
                             "evenly), with per-loss-family scaling, so "
                             "the optimizer sees the full-batch gradient "
                             "(up to DropPath draws: microbatches draw "
                             "one after another) while only one "
                             "microbatch's activations are live")
    parser.add_argument("--steps-per-dispatch", type=int, default=1,
                        help="full optimizer steps a call of the train step: "
                             "on CUDA the first call runs its steps eagerly, "
                             "then one CUDA graph of the whole step "
                             "(forward, loss, backward, clip, update) is "
                             "captured and replayed K times a call, with no "
                             "Python between the replays; over data ranks "
                             "(--mesh-data) the graphs are cut at the step's "
                             "collectives, which run between the replays; "
                             "with --shard-params or --mesh-context > 1 the "
                             "K steps run one after another; the same "
                             "training as K single steps (Adam/AdamW built "
                             "capturable where graphs run)")
    parser.add_argument("--watch-freq", type=int, default=100,
                        help="parameter/gradient histogram logging cadence "
                             "in steps (reference wandb.watch log_freq=100, "
                             "wandb_logger.py:27); 0 disables")
    parser.add_argument("--allow-placeholder-vgg", action="store_true",
                        help="train the perceptual losses on the seeded "
                             "placeholder VGG trunk when no --vgg-weights "
                             "file exists (tests and checks only: it does "
                             "NOT match the reference)")
    parser.add_argument("--train-raw", type=str, default="uw_data/uw_data/train/a",
                        help="train raw dir (hardcoded in reference main.py:52)")
    parser.add_argument("--train-ref", type=str, default="uw_data/uw_data/train/b",
                        help="train reference dir (reference main.py:53)")
    parser.add_argument("--test-raw", type=str, default="uw_data/uw_data/test/a",
                        help="test raw dir (reference main.py:67)")
    parser.add_argument("--test-ref", type=str, default="uw_data/uw_data/test/b",
                        help="test reference dir (reference main.py:68)")
    parser.add_argument("--image-in", type=str, default="image_in/",
                        help="inference input dir (reference main.py:73)")
    parser.add_argument("--image-out", type=str, default="image_out/",
                        help="inference output dir (reference main.py:74)")
    parser.add_argument("--infer-size", type=int, default=256,
                        help="inference resize (reference Visualiser.py:20)")

    return parser
