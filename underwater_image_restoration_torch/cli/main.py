"""Entry point (reference ``main.py:20-94``), the port's counterpart of the
JAX package's ``cli/main.py`` (``main``, ``_run``):

    python -m underwater_image_restoration_torch.cli [--use-cpu] ...

Same control flow: parse args -> log-dir path encoding hyperparams -> tee
stdout into it -> train branch (DataManager + ModelTrainer) or evaluate
branch (load weights, restore every image of ``--image-in`` into
``--image-out``).  The reference's hardcoded data dirs and checkpoint path
(main.py:52-53,67-68,73-75) are flags, defaulting to its literals.  The run
needs a CUDA GPU unless ``--use-cpu`` asks for the CPU (it raises
``CudaUnavailableError`` otherwise); ``--no-pallas`` runs the kernels'
plain PyTorch versions; ``--steps-per-dispatch K`` trains K steps a call
of the train step, on CUDA as replays of one CUDA graph of the step.

Data parallelism and FSDP2 run one process a rank under ``torchrun``:

    torchrun --nproc-per-node N -m underwater_image_restoration_torch.cli \
        --mesh-data N [--shard-params data] ...

and context parallelism (every arch; each rank a band of the
images' rows) with ``--mesh-context M`` (``--nproc-per-node`` the product
of ``--mesh-data`` and ``--mesh-context``, ``--shard-params context`` for
tensor parallelism):

    torchrun --nproc-per-node 2 -m underwater_image_restoration_torch.cli \
        -a AST --mesh-context 2 [--shard-params context] ...

Rank 0 alone writes the tee log (and, in the trainer, the metrics, probe
images and checkpoints); the other ranks print nothing.  The evaluate
branch runs on rank 0.
"""
from __future__ import annotations

import os
import os.path as osp
import sys
import time

import torch

from .._device import resolve_device
from ..core import config as config_lib
from ..data.manager import DataManager
from ..obs.loggers import Logger
from ..obs.visualiser import (
    load_model_from_weights,
    model_apply,
    process_image_using_model,
)
from .args import argument_parser


def main(argv=None):
    parser = argument_parser()
    args = parser.parse_args(argv)
    cfg = config_lib.validate(config_lib.from_namespace(args))

    print(torch.__version__)
    print(args.evaluate)

    # log-dir path encodes hyperparams (reference main.py:32)
    outputdirectory = (
        "logs/" + "/arch-" + str(args.arch) + "/optimizer-" + str(args.optim)
        + "/loss-" + str(args.lossf) + "/maxEpoch-" + str(args.max_epoch)
        + "/lr-" + str(args.lr) + "/batchSize-" + str(args.train_batch_size)
        + "/perspective-" + str(args.randomPerspective)
        + "-rotate-" + str(args.randomRotate)
    )
    args.save_dir = outputdirectory
    cfg = cfg.replace(save_dir=outputdirectory)
    log_name = "log_test.txt" if args.evaluate else "log_train.txt"
    rank = int(os.environ.get("RANK", "0"))  # torchrun's
    if rank != 0 and args.evaluate:
        return
    prev_stdout = sys.stdout
    sys.stdout = (Logger(osp.join(args.save_dir, log_name)) if rank == 0
                  else open(os.devnull, "w"))
    try:
        _run(parser, args, cfg)
    finally:
        sys.stdout.close()
        sys.stdout = prev_stdout
        if torch.distributed.is_available() and \
                torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _run(parser, args, cfg):
    print("==========")
    print("Start time:{}".format(
        time.strftime("%Y-%m-%d %H:%M:%S", time.localtime())))
    print("==========")
    print(f"==========\nArgs:{args}\n==========")

    dev = resolve_device("cpu" if cfg.use_cpu else None)
    print("Device: " + (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                        else "cpu (the kernels' plain versions)"))
    if not args.evaluate:
        print("Initializing image data manager")
        dm = DataManager()
        dm.setDownloadedLocations(args.train_raw, args.train_ref)
        if not dm.use_existing:
            dm.download()  # kagglehub path; raises with guidance if unavailable

        print("Starting training")
        print(f"Raw Data Directory: {dm.raw_dir}")
        print(f"Reference Image Directory: {dm.ref_dir}")
        from ..train.trainer import ModelTrainer

        trainer = ModelTrainer(dm.raw_dir, dm.ref_dir,
                               args.test_raw, args.test_ref)
        trainer.train(cfg, args.arch, args.max_epoch, args.lr)
    else:
        print("Evaluating...")
        if not cfg.use_kernels:  # the trainer says so in the train branch
            print("--no-pallas: the kernels' plain PyTorch versions run")
        input_dir = args.image_in
        output_dir = args.image_out
        model_path = args.load_weights or args.resume
        os.makedirs(output_dir, exist_ok=True)
        os.makedirs(input_dir, exist_ok=True)
        if not model_path:
            parser.error("--evaluate needs --load-weights <checkpoint dir>")

        model = load_model_from_weights(model_path, cfg, args.arch,
                                        img_size=args.infer_size)
        apply = model_apply(model, cfg.use_kernels)
        input_files = os.listdir(input_dir)
        print(f"Number of input images: {len(input_files)}")
        for file in input_files:
            print(f"Processing {file}")
            process_image_using_model(
                apply, os.path.join(input_dir, file), output_dir, file,
                size=args.infer_size,
            )


if __name__ == "__main__":
    main()
