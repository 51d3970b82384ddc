"""Typed configuration mirroring the reference CLI surface, the port's own
copy of the JAX package's ``core/config.py`` (``Config``,
``from_namespace``).

Left out: the TPU-only ``compile_cache`` (XLA's compilation cache; the port
compiles only its kernels, cached under ``build/kernels/``), the unused
``param_dtype`` (parameters are f32) and ``jsonl_metrics`` (the JSONL sink
is always on).  Added: ``use_kernels``, which the
CLI's ``--no-pallas`` turns off to run the kernels' plain PyTorch versions.
``mesh_data``, ``mesh_context`` (every arch) and
``shard_params`` ('data' or 'context') run under ``torchrun``
(``core/meshes.py``); ``remat`` and ``remat_policy`` ('' or 'full',
'dots') rematerialize the models' blocks (``ops.layers.make_remat``);
``steps_per_dispatch`` runs K optimizer steps a call of the train step
(``train.make_train_step``'s ``k_steps``), on CUDA as replays of a CUDA
graph of the step, over data ranks of graphs cut at its collectives, with
sharded parameters or context ranks one step after another
(``train/dispatch.py route``), and ``validate`` refuses any value the port
cannot honour (the TPU policies 'mxu' and 'mxu+ew' among them).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass
class Config:
    # ---- data (reference args.py:14-80) ----
    root: str = "./datasets"
    height: int = 128
    width: int = 256
    workers: int = 4
    train_sampler: str = "RandomSampler"
    split_id: int = 0
    # aug flags (offline in the reference; online ops here)
    random_erase: bool = False
    color_jitter: bool = False
    color_aug: bool = False
    random_perspective: bool = False
    random_rotate: bool = False

    # ---- optimization (reference args.py:84-130) ----
    optim: str = "adam"
    lr: float = 0.0003
    weight_decay: float = 5e-4
    momentum: float = 0.9
    sgd_dampening: float = 0.0
    sgd_nesterov: bool = False
    rmsprop_alpha: float = 0.99
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999

    # ---- training schedule (reference args.py:132-166) ----
    max_epoch: int = 60
    start_epoch: int = 0
    train_batch_size: int = 2
    test_batch_size: int = 1
    lr_scheduler: str = "multi_step"
    stepsize: Sequence[int] = (20, 40)
    gamma: float = 0.1

    # ---- architecture (reference args.py:201-206) ----
    arch: str = "SpectralTransformer"
    lossf: str = "L1"
    no_pretrained: bool = False
    use_dwt: str = "Fourier"  # "Wavelet" | "Fourier" | anything-else = identity

    # ---- test / resume (reference args.py:211-248) ----
    load_weights: str = ""
    evaluate: bool = False
    eval_freq: int = -1
    start_eval: int = 0
    resume: str = ""

    # ---- misc (reference args.py:240-273) ----
    print_freq: int = 10
    seed: int = 1
    save_dir: str = "log"
    use_cpu: bool = False         # the CPU and the plain versions; else CUDA
    gpu_devices: str = "0"        # accepted for parity; the first CUDA device
    use_avai_gpus: bool = False
    use_wandb: bool = True

    # ---- extensions (no reference equivalent) ----
    image_size: int = 1024        # train transform resolution (reference hardcodes 1024²; DataLoader.py:14)
    mesh_data: int = -1           # data-parallel ranks: -1 = WORLD_SIZE
    mesh_context: int = 1         # context-parallel ranks a data index
    shard_params: str = ""        # "" (replicated), "data" or "context" (FSDP2)
    compute_dtype: str = "bfloat16"   # the model's compute dtype; f32 params
    remat: bool = False           # per-block rematerialization
    remat_policy: str = ""        # with remat: ""/"full" recompute all,
    #                               "dots" keeps the weight products
    use_kernels: bool = True      # False: the kernels' plain versions (--no-pallas)
    checkpoint_dir: str = "checkpoints"
    profile_dir: str = ""         # when set, a torch.profiler trace lands here
    vgg_weights: str = ""         # VGG16 weights of the perceptual losses:
    #                               an .npz of HWIO kernels or a torchvision
    #                               vgg16().features state dict
    cache_decoded: str = ""       # when set, decode+resize once into a uint8
    #                               memmap cache dir and stream later epochs
    #                               from it (data/cache.py)
    watch_freq: int = 100         # param/grad histogram cadence in steps
    #                               (reference wandb.watch log_freq=100,
    #                               wandb_logger.py:27); 0 disables
    allow_placeholder_vgg: bool = False  # opt into the random VGG trunk
    grad_accum: int = 1           # microbatches per optimizer step, with
    #                               per-loss-family scaling (make_train_step)
    steps_per_dispatch: int = 1   # full optimizer steps a call of the step:
    #                               on CUDA a CUDA graph of the step (cut at
    #                               the data ranks' collectives), replayed K
    #                               times (make_train_step k_steps)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def from_namespace(ns) -> Config:
    """Build a Config from an argparse namespace produced by cli/args.py."""
    fields = {f.name for f in dataclasses.fields(Config)}
    kv = {}
    for k, v in vars(ns).items():
        k2 = k.replace("-", "_")
        # CLI parity names that differ from dataclass field names
        alias = {
            "randomPerspective": "random_perspective",
            "randomRotate": "random_rotate",
        }.get(k2, k2)
        if alias in fields and v is not None:
            kv[alias] = v
    if getattr(ns, "no_pallas", False):
        kv["use_kernels"] = False
    return Config(**kv)


def compute_dtype_of(cfg: Config):
    """The torch dtype named by ``cfg.compute_dtype``."""
    import torch

    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[cfg.compute_dtype]


def validate(cfg: Config) -> Config:
    """Raise ValueError for a setting the port does not run: context
    parallelism of an image side the context size does not divide (or, for
    SpectralTransformer, not a multiple of 8 or of fewer rows a rank than
    its LN+MDTA halo), more ranks than the process group has (start the run
    under ``torchrun``; ``core.meshes.validate_parallel``), a remat
    policy that ``ops.layers.make_remat`` refuses ('mxu', 'mxu+ew', an
    unknown name) or ``steps_per_dispatch`` below 1.  Any
    ``steps_per_dispatch`` of 1 or more runs with any parallel setting."""
    from ..ops.layers import make_remat
    from .meshes import validate_parallel

    if cfg.steps_per_dispatch < 1:
        raise ValueError(f"steps_per_dispatch={cfg.steps_per_dispatch}: 1 "
                         "or more optimizer steps a dispatch")
    validate_parallel(cfg.mesh_data, cfg.mesh_context, cfg.shard_params,
                      cfg.arch, cfg.image_size)
    make_remat(cfg.remat, cfg.remat_policy or None)
    return cfg
