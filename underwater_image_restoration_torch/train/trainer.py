"""The train step and the training run, counterparts of the JAX package's
``train/trainer.py`` (``normalize_u8``, ``make_train_step``,
``make_watch_step``, ``make_eval_step``, ``ModelTrainer``), on one device
or over the data-parallel ranks of ``core/meshes.py`` (``torchrun``; the
parameters replicated or sharded by FSDP2), with one device's numbers at
the global batch.

A step is uint8 NHWC normalize -> forward (NCHW, the model's compute dtype
over f32 parameters) -> loss in f32 -> backward -> global-norm clip ->
optimizer update, with ``grad_accum`` microbatches as the JAX step scans
them.  The model runs in training mode, as the JAX step always passes
``deterministic=False``: the AST's DropPath draws from the step's
``generator`` (SpectralTransformer has no module whose output depends on the
mode).  On CUDA the blocks' forward and backward run through the
hand-written kernels (``use_kernels=False`` takes their plain versions, as
a reference).  The state is the model and the optimizer, updated in place.

The run (``ModelTrainer.train``, reference ``src/ModelTrainer.py:26-204``):
before each epoch the learning rate of ``multistep_lr`` (its own milestones
1/100/250 and gamma 0.25, not the config's ``stepsize``/``gamma``); every
batch of the train loader through the step, the padded final batch trained
on as the JAX step does; the step's metrics kept on the device and read
once at the epoch's end (a print every ``print_freq`` batches reads one
batch's); parameter and gradient histograms every ``watch_freq`` steps;
validation (loss, PSNR, SSIM as masked sums); the checkpoint of a best epoch
in ``best/`` and ``latest/``, of any other in ``latest/``; the probe image.
``--resume`` restores parameters, optimizer state, epoch, best loss and the
loader's state; the run keeps cuDNN on its deterministic algorithms, so a
resumed run is bit-equal to a straight one.  A loss with components
(``fflMix``) logs them beside the loss.

Under data parallelism each rank steps and validates its data index's rows
of every batch; under context parallelism (every arch) each
context rank of a data index takes the same rows and runs the model on its
band of the images' rows, the output gathered whole for the loss and the
metrics.  Rank 0 alone writes logs, metrics, probe images and checkpoints
(the single-device format; FSDP gathers the full state first), and the
watch histograms are off.

Rematerialization: ``ModelTrainer`` builds the model with ``cfg.remat``
and ``cfg.remat_policy`` (per-block, ``ops.layers.make_remat``);
``make_train_step(remat=True)`` checkpoints the whole forward, for a model
without its own.  ``make_train_step(k_steps=K)`` (``cfg.steps_per_dispatch``)
runs K steps a call, on CUDA as replays of one CUDA graph of the step,
or over data ranks of graphs cut at its collectives (``train/dispatch.py``);
the trainer groups its batches by K as the JAX trainer does, on every
rank.  Not here: the staged first-step compile fallback (a
workaround for the TPU's compiler): a kernel that fails fails the run.
"""
from __future__ import annotations

import inspect
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..core.config import compute_dtype_of, validate
from ..core.meshes import (
    DataParallel,
    default_backend,
    full_state,
    init_data_parallel,
    is_sharded,
    load_full_state,
    parallel_sizes,
    shard_model,
)
from ..data import AugmentConfig, get_dataloaders
from ..losses import COMPONENTS, LossFunction
from ..models import init_model
from ..obs import ExperimentLogger, process_image_using_model
from ..obs.profiler import profile_trace
from ..obs.visualiser import model_apply, prep_image
from ..ops.droppath import RankDraws
from ..ops.layers import make_remat
from ..parallel import gather_replicated
from .checkpoint import CheckpointManager, best_or_latest_params
from .dispatch import (
    GraphedSteps,
    SegmentedSteps,
    describe,
    nchw,
    normalize_u8,
    on_device,
    route,
    stepwise,
)
from .metrics import per_sample_psnr, per_sample_ssim
from .optim import get_optimizer, multistep_lr, set_learning_rate


def _to_nchw(u8, device):
    """uint8 (B, H, W, 3), numpy or tensor -> normalized f32 NCHW on
    ``device`` (the batch crosses to the device as uint8)."""
    return nchw(on_device(u8, device))


def _generator_kwargs(model, generator):
    """``{"generator": generator}`` for a model whose forward takes one (the
    AST's and the New* models' DropPath), else nothing."""
    return ({"generator": generator} if "generator" in
            inspect.signature(model.forward).parameters else {})


def make_train_step(model, lossfn, optimizer, grad_accum: int = 1,
                    use_kernels: bool = True,
                    generator: torch.Generator | None = None,
                    parallel: DataParallel | None = None,
                    remat: bool = False, k_steps: int = 1):
    """``optimizer`` is ``train.optim.get_optimizer``'s (its ``step()``
    clips and returns the pre-clip global norm).  Returns
    ``step(raw_u8, ref_u8) -> {"loss", "grad_norm"}``: one
    optimizer update of ``model`` from uint8 (B, H, W, 3) batches (numpy or
    tensors), the metrics as f32 0-dim tensors on the model's device
    (``grad_norm`` before the clip).  A loss that returns components
    (``fflMix``) adds them under ``losses.COMPONENTS``' names.

    ``k_steps`` > 1 returns ``steps(raw_k, ref_k)`` instead: uint8
    (K, B, H, W, 3) groups (a shorter one, an epoch's remainder, runs as
    many steps), each metric stacked (K,) on the device, the training of K
    calls of the single step.  On CUDA the first call's steps run eagerly
    and the later ones replay one CUDA graph of the step
    (``dispatch.GraphedSteps``), or over data ranks with replicated
    parameters the graphs of the step cut at its collectives, which run
    eagerly between them (``dispatch.SegmentedSteps``); Adam and AdamW are
    built with ``capturable=True``.  On the CPU, and on CUDA with sharded
    parameters or context ranks (whose collectives run inside the
    backward), they run one after another (``dispatch.stepwise``;
    ``dispatch.route`` says which).

    grad_accum > 1 splits the batch into that many microbatches and averages
    their gradients before the one update, with an extra 1/grad_accum for
    the B*C-divided losses (a microbatch's divisor is grad_accum times
    smaller); the Adaptive pair couples the whole batch and is refused.
    Parameters the loss does not reach (q1X1_1, the dead kf half of kv)
    get zero gradients, not None, so that every optimizer updates them as
    optax does (AdamW decays every leaf).

    ``parallel`` (``core.meshes.DataParallel``, n data indices): each
    rank's step takes its data index's rows of the global batch
    (``parallel.rows``), and the update is the one device's at the global
    batch, as the JAX step's over a data mesh: the n data indices'
    microbatches count as n * grad_accum microbatches in the scaling above,
    the gradients are summed over the ranks (one all-reduce; a sharded
    model's reduce-scatter), the Adaptive pair forms its weights from the
    global batch's detached losses (``LossFunction.with_batch_mean``),
    DropPath draws the global batch's decisions and keeps the data index's
    (``ops.droppath.RankDraws``), the clip takes the global norm, and the
    metrics are the global batch's.  Under context parallelism
    (``parallel.cp``, a model built with it) the rank's model takes its band
    of the images' rows and the output is gathered whole
    (``parallel.gather_replicated``, whose backward keeps the rank's rows of
    the cotangent): every context rank computes the data index's loss, its
    gradients are its band's share, and the all-reduce sums them.

    The forward runs in training mode (the model's mode is restored after
    the step).  A model whose ``forward`` takes a ``generator`` (the AST's
    DropPath) gets ``generator``: steps and microbatches draw from it one
    after another (the counterpart of the JAX step's ``fold_in(rng, step)``
    and ``fold_in(rng, i)``, not the same stream); one seed gives the same
    draws with and without the kernels.

    ``remat``: the whole forward is checkpointed (the JAX step's
    ``jax.checkpoint`` of ``model.apply``): the backward runs it again,
    drawing the same DropPath decisions, for a model that does not
    rematerialize its blocks itself (``init_model(remat=True)``)."""
    if grad_accum > 1 and not (lossfn.batch_linear or lossfn.bc_divided):
        raise ValueError(
            f"grad_accum={grad_accum} is not exact for loss "
            f"'{lossfn.loss_name}': its adaptive softmax weights couple the "
            "whole batch, so microbatch accumulation changes the loss. Use "
            "grad_accum=1.")
    dp = parallel or DataParallel()
    if k_steps < 1:
        raise ValueError(f"k_steps={k_steps}: 1 or more steps a call")
    cp = dp.cp if dp.cp.size > 1 else None
    if dp.world > 1 and not (lossfn.batch_linear or lossfn.bc_divided):
        lossfn = lossfn.with_batch_mean(dp.mean)
    params = [p for p in model.parameters() if p.requires_grad]
    sharded = dp.ranks > 1 and is_sharded(params)
    if generator is not None and dp.world > 1:
        generator = RankDraws(generator, dp.rank, dp.world)
    kwargs = _generator_kwargs(model, generator)
    forward = make_remat(remat)(model)
    device = params[0].device
    parts = grad_accum * dp.world
    inv = 1.0 / parts
    if lossfn.bc_divided:
        inv /= parts
    # a sharded model's reduce-scatter averages over the ranks: its losses
    # are scaled by the ranks so that the gradients are summed
    back = inv * dp.ranks if sharded else inv

    def run(x, y):
        """One step from normalized NCHW batches on the device."""
        if cp is not None:
            x = x[:, :, cp.band(x.shape[2])].contiguous()
        b = x.shape[0]
        if b % grad_accum:
            raise ValueError(
                f"train batch {b} not divisible by grad_accum={grad_accum}")
        mb = b // grad_accum
        for p in params:
            p.grad = None
        sums = None  # the loss (and its components), summed
        was_training = model.training
        model.train()
        try:
            for i in range(grad_accum):
                sl = slice(i * mb, (i + 1) * mb)
                out = forward(x[sl], use_kernels, **kwargs)
                if cp is not None:
                    out = gather_replicated(out, cp, 2)
                res = lossfn(out.float(), y[sl])
                res = res if lossfn.returns_components else (res,)
                (res[0] * back if back != 1.0 else res[0]).backward()
                res = [r.detach() for r in res]
                sums = res if sums is None else [a + r for a, r in
                                                 zip(sums, res)]
        finally:
            model.train(was_training)
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if dp.ranks > 1 and not sharded:
            dp.all_reduce_([p.grad for p in params])
        gnorm = optimizer.step()
        if parts > 1:
            sums = [v * inv for v in sums]
        if dp.world > 1:
            sums = list(dp.sum(torch.stack(sums)).unbind())
        return {"loss": sums[0], "grad_norm": gnorm,
                **dict(zip(COMPONENTS, sums[1:]))}

    def step(raw_u8, ref_u8):
        return run(_to_nchw(raw_u8, device), _to_nchw(ref_u8, device))

    if k_steps == 1:
        return step
    how = route(device, dp, is_sharded(params))
    if how == "stepwise":
        return stepwise(step)
    if any(g.get("capturable") is False for g in optimizer.param_groups):
        raise ValueError(
            f"k_steps={k_steps} on CUDA replays the optimizer's update in a "
            "CUDA graph: build Adam/AdamW with get_optimizer(..., "
            "capturable=True), whose step count lives on the device")
    if how == "segments":
        return SegmentedSteps(run, optimizer, params, generator, device,
                              dp)
    return GraphedSteps(run, optimizer, params, generator, device)


def _loss_only(lossfn, pred, truth):
    """The loss without its components (fflMix returns a 6-tuple)."""
    res = lossfn(pred, truth)
    return res[0] if lossfn.returns_components else res


WATCH_BINS = 64


def histograms(tensors: dict, bins: int = WATCH_BINS) -> dict:
    """{name: tensor} -> {name: (counts, edges)} on the tensors' device,
    ``jnp.histogram``'s bins: ``bins`` equal bins over [min, max] (a
    constant tensor's over [v - 0.5, v + 0.5]), the maximum in the last.
    ``torch.histc`` counts (as f32) and ``torch.linspace`` gives the edges;
    the ranges reach the host in one read."""
    flat = {n: t.detach().float().reshape(-1) for n, t in tensors.items()}
    lims = torch.stack([torch.stack(torch.aminmax(f))
                        for f in flat.values()]).tolist()
    out = {}
    for (name, f), (lo, hi) in zip(flat.items(), lims):
        if lo == hi:
            lo, hi = lo - 0.5, hi + 0.5
        out[name] = (torch.histc(f, bins, lo, hi),
                     torch.linspace(lo, hi, bins + 1, device=f.device))
    return out


def make_watch_step(model, lossfn, bins: int = WATCH_BINS,
                    use_kernels: bool = True):
    """``watch(raw_u8, ref_u8, generator=None) -> {name: (counts, edges)}``:
    the reference's ``wandb.watch(model, log="all", log_freq=100)`` channel
    (wandb_logger.py:25-27), histograms of every parameter
    (``parameters/<name>``) and of its gradient (``gradients/<name>``),
    computed on the device.  As in the JAX package the gradient is
    recomputed on the watched batch at the current (post-update)
    parameters, in training mode; ``.grad`` is left alone, a parameter the
    loss does not reach gets a zero gradient, and DropPath draws from
    ``generator`` (the trainer gives each watch its own, seeded from the
    step, so the train step's stream is not consumed)."""
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    params = [p for _, p in named]
    device = params[0].device

    def watch(raw_u8, ref_u8, generator=None):
        x, y = _to_nchw(raw_u8, device), _to_nchw(ref_u8, device)
        was_training = model.training
        model.train()
        try:
            out = model(x, use_kernels, **_generator_kwargs(model, generator))
            loss = _loss_only(lossfn, out.float(), y)
        finally:
            model.train(was_training)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        tensors = {"parameters/" + n: p for n, p in named}
        tensors.update({"gradients/" + n: torch.zeros_like(p) if g is None
                        else g for (n, p), g in zip(named, grads)})
        return histograms(tensors, bins)

    return watch


EVAL_KEYS = ("loss_sum", "psnr_sum", "ssim_sum", "n")


def make_eval_step(model, lossfn, use_kernels: bool = True,
                   parallel: DataParallel | None = None):
    """``step(raw_u8, ref_u8, valid) -> {loss_sum, psnr_sum, ssim_sum, n}``,
    f32 0-dim tensors on the model's device: the model in eval mode, its
    output in f32, every sum masked by ``valid``, so the padding of a short
    final batch contributes nothing (it would otherwise bias the validation
    loss, which chooses the best checkpoint).

    ``loss_sum / n`` is what the reference's validation loop computes on the
    unpadded batch (ModelTrainer.py:132-158): per-sample losses are summed
    for the batch-mean losses, and divided by the valid count as well for
    the B*C-divided family (their divisor is the true batch size).  The
    Adaptive pair's softmax weights couple the whole batch and have no
    per-sample form: its full-batch loss (padding included) times ``n``.

    ``parallel``: the step takes the data index's rows of each batch, and
    its sums over the data indices are the global batch's
    (``validate_loader`` adds them); the B*C family's divisor and the
    Adaptive pair's weights and ``n`` are the global batch's.  Under
    context parallelism the model takes the rank's band of the rows and
    the loss, PSNR and SSIM are computed on the gathered images (alike on
    every context rank)."""
    device = next(model.parameters()).device
    dp = parallel or DataParallel()
    cp = dp.cp if dp.cp.size > 1 else None
    adaptive = not (lossfn.batch_linear or lossfn.bc_divided)
    if dp.world > 1 and adaptive:
        lossfn = lossfn.with_batch_mean(dp.mean)

    @torch.no_grad()
    def step(raw_u8, ref_u8, valid):
        x, y = _to_nchw(raw_u8, device), _to_nchw(ref_u8, device)
        if cp is not None:
            x = x[:, :, cp.band(x.shape[2])].contiguous()
        was_training = model.training
        model.eval()
        try:
            out = model(x, use_kernels)
            if cp is not None:
                out = gather_replicated(out, cp, 2)
            out = out.float()
        finally:
            model.train(was_training)
        v = torch.as_tensor(np.asarray(valid)).to(device, torch.float32)
        n = v.sum()
        if not adaptive:
            per = torch.stack([_loss_only(lossfn, out[i:i + 1], y[i:i + 1])
                               for i in range(out.shape[0])])
            masked = (per * v).sum()
            # the B*C family divides by the global batch's valid count (a
            # rank's own may be 0: its rows all padding)
            loss_sum = masked / dp.sum(n) if lossfn.bc_divided else masked
        elif dp.world > 1:  # the ranks' shares of loss * n
            loss_sum = _loss_only(lossfn, out, y) * dp.sum(n) / dp.world
        else:  # Adaptive*: batch-coupled weights, no exact masking
            loss_sum = _loss_only(lossfn, out, y) * n
        return {"loss_sum": loss_sum,
                "psnr_sum": (per_sample_psnr(y, out) * v).sum(),
                "ssim_sum": (per_sample_ssim(y, out) * v).sum(),
                "n": n}

    return step


def validate_loader(eval_step, loader,
                    parallel: DataParallel | None = None
                    ) -> tuple[float, float, float]:
    """(loss, PSNR, SSIM) averaged over the valid samples of ``loader``:
    the batches' sums stay on the device until the loop ends (summed over
    the data indices in one all-reduce), then are added in batch order in
    Python floats."""
    rows = [torch.stack([r[k] for k in EVAL_KEYS]) for r in
            (eval_step(b.raw, b.ref, b.valid) for b in loader)]
    if rows and parallel is not None and parallel.world > 1:
        rows = [parallel.sum(torch.stack(rows))]
    tot = dict.fromkeys(EVAL_KEYS, 0.0)
    for row in (torch.cat([r.view(-1, len(EVAL_KEYS)) for r in rows])
                .tolist() if rows else []):
        for k, v in zip(EVAL_KEYS, row):
            tot[k] += v
    n = max(1.0, tot["n"])
    return tot["loss_sum"] / n, tot["psnr_sum"] / n, tot["ssim_sum"] / n


def _quiet(*_args, **_kwargs):
    """``print`` of the ranks other than 0."""


def _data_parallel(cfg, device) -> DataParallel:
    """This process's rank of ``cfg``'s parallel run: one device, or the
    process group (joined here unless the caller joined it) over
    ``default_backend``'s backend, ``cfg.mesh_context`` ranks a data
    index."""
    n_data, n_ctx = parallel_sizes(cfg.mesh_data, cfg.mesh_context)
    n = n_data * n_ctx
    if n == 1 and not cfg.shard_params:
        return DataParallel(device=device)
    return init_data_parallel(n, backend=default_backend(device, n),
                              device=device if device.type == "cpu"
                              else None, mesh_context=n_ctx)


def watch_seed(seed: int, step: int) -> int:
    """The seed of the watch at global ``step``'s own generator."""
    return int(np.random.SeedSequence((seed, step)).generate_state(1)[0])


class ModelTrainer:
    """API parity with reference ModelTrainer (ModelTrainer.py:26-33)."""

    def __init__(self, inputDirectory, referenceDirectory,
                 testInputDirectory, testReferenceDirectory):
        self.inputDir = inputDirectory
        self.referenceDir = referenceDirectory
        self.testInputDir = testInputDirectory
        self.testReferenceDir = testReferenceDirectory

    # ------------------------------------------------------------------
    def train(self, config, arch: Optional[str] = None,
              num_epochs: Optional[int] = None,
              learning_rate: Optional[float] = None,
              probe_image: Optional[str] = None,
              on_epoch_end: Optional[Callable] = None):
        """Train ``arch`` (default ``config.arch``) for epochs
        ``config.start_epoch`` (or the resumed epoch + 1) to ``num_epochs``
        on CUDA, or on the CPU with ``config.use_cpu``; without CUDA and
        without it, raises ``CudaUnavailableError``.  Checkpoints go to
        ``<checkpoint_dir>/<run name>/{best,latest}`` (the ``resume``
        directory when resuming), metrics to ``metrics.jsonl`` there.
        ``on_epoch_end(epoch, model, val_loss)`` runs after each epoch.
        cuDNN runs its deterministic algorithms for the run (the prior
        setting is restored on exit).  Returns (model, optimizer)."""
        # a resumed run is bit-equal to a straight one only if every step
        # is reproducible, and cuDNN's default conv weight gradients are not
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            return self._train(config, arch, num_epochs, learning_rate,
                               probe_image, on_epoch_end)
        finally:
            torch.backends.cudnn.deterministic = deterministic

    def _train(self, config, arch, num_epochs, learning_rate, probe_image,
               on_epoch_end):
        cfg = validate(config.replace(arch=arch or config.arch))
        arch = cfg.arch
        num_epochs = num_epochs or cfg.max_epoch
        lr = learning_rate or cfg.lr
        device = resolve_device("cpu" if cfg.use_cpu else None)
        dp = _data_parallel(cfg, device)
        device = dp.device
        say = print if dp.is_main else _quiet
        sharded = bool(cfg.shard_params)
        cp = dp.cp if dp.cp.size > 1 else None

        say(f"Preparing data loaders...batch size{cfg.train_batch_size}")
        augment = AugmentConfig(enabled=(cfg.color_aug or cfg.color_jitter))
        train_loader, test_loader = get_dataloaders(
            self.inputDir, self.referenceDir,
            self.testInputDir, self.testReferenceDir,
            batch_size=cfg.train_batch_size,
            test_batch_size=cfg.test_batch_size,
            num_workers=cfg.workers, image_size=cfg.image_size,
            seed=cfg.seed, augment=augment,
            cache_dir=cfg.cache_decoded or None,
        )
        if dp.world > 1:
            # each rank decodes and steps its data index's rows of every
            # batch (its context ranks the same rows, each its band of them)
            train_loader.rows = dp.rows(cfg.train_batch_size, cfg.grad_accum)
            test_loader.rows = dp.rows(test_loader.batch_size)
        if dp.ranks > 1:
            say(f"Parallel: {dp.world} data x {dp.cp.size} context ranks "
                f"over {dp.backend}"
                + (f", parameters sharded over {cfg.shard_params} (FSDP2)"
                   if sharded else ""))

        say("Initializing model...")
        model = init_model(arch, device=device, seed=cfg.seed,
                           compute_dtype=compute_dtype_of(cfg),
                           img_size=cfg.image_size, use_dwt=cfg.use_dwt,
                           cp=cp, remat=cfg.remat,
                           remat_policy=cfg.remat_policy or None)
        if sharded:
            shard_model(model, dp, cfg.shard_params)
        lossfn = LossFunction(cfg.lossf, vgg_weights=cfg.vgg_weights,
                              allow_placeholder_vgg=cfg.allow_placeholder_vgg)
        k_disp = cfg.steps_per_dispatch
        optimizer = get_optimizer(
            cfg.optim, model.parameters(), lr,
            weight_decay=cfg.weight_decay, momentum=cfg.momentum,
            sgd_nesterov=cfg.sgd_nesterov, rmsprop_alpha=cfg.rmsprop_alpha,
            adam_beta1=cfg.adam_beta1, adam_beta2=cfg.adam_beta2,
            capturable=k_disp > 1 and route(device, dp,
                                            sharded) != "stepwise",
        )
        if not cfg.use_kernels:
            say("use_kernels=False: the kernels' plain PyTorch versions run")

        start_time = time.time()
        run_name = f"{cfg.lossf}-{cfg.lr}-{arch}-{start_time}-{cfg.use_dwt}"
        run_dir = os.path.join(cfg.checkpoint_dir, run_name)
        start_epoch = cfg.start_epoch
        best_loss = float("inf")

        # -- resume (real, unlike reference args.py:242-248) ---------------
        if cfg.resume:
            run_dir = cfg.resume
            restored = CheckpointManager(os.path.join(run_dir, "latest"),
                                         keep_best=False).restore()
            if sharded:
                load_full_state(model, optimizer, restored["params"],
                                restored["opt_state"])
            else:
                model.load_state_dict(restored["params"])
                optimizer.load_state_dict(restored["opt_state"])
            start_epoch = int(restored["epoch"]) + 1
            best_loss = float(restored["extra"].get("best", float("inf")))
            train_loader.load_state_dict(restored["loader"])
            train_loader.epoch = start_epoch
            say(f"Resumed from {run_dir} at epoch {start_epoch}")

        ckpt_best = CheckpointManager(os.path.join(run_dir, "best"),
                                      max_to_keep=1, keep_best=True)
        ckpt_latest = CheckpointManager(os.path.join(run_dir, "latest"),
                                        max_to_keep=1, keep_best=False)
        # rank 0 alone writes logs, metrics, probe images and checkpoints
        explog = (ExperimentLogger(cfg, save_dir=run_dir) if dp.is_main else
                  ExperimentLogger(cfg.replace(use_wandb=False)))
        explog.watch_model(model)  # reference ModelTrainer.py:43-44
        watch_freq = cfg.watch_freq
        if dp.ranks > 1 and explog.watching and watch_freq > 0:
            say("The watch histograms run on one device: off with "
                f"{dp.ranks} ranks")
            watch_freq = 0
        watch_step = (make_watch_step(model, lossfn,
                                      use_kernels=cfg.use_kernels)
                      if explog.watching and watch_freq > 0 else None)
        schedule = multistep_lr(lr)
        # DropPath draws from one generator a train() call, seeded from
        # seed + 1 as the JAX trainer re-creates its step rng (so a resumed
        # run draws a new stream, as there); every rank seeds it alike
        train_step = make_train_step(
            model, lossfn, optimizer, grad_accum=cfg.grad_accum,
            use_kernels=cfg.use_kernels,
            generator=torch.Generator(device).manual_seed(cfg.seed + 1),
            parallel=dp, k_steps=k_disp)
        eval_step = make_eval_step(model, lossfn, use_kernels=cfg.use_kernels,
                                   parallel=dp)

        say(f"Starting training for {num_epochs} epochs...")
        nb = len(train_loader)
        with profile_trace(cfg.profile_dir if dp.is_main else ""):
            for epoch in range(start_epoch, num_epochs):
                set_learning_rate(optimizer, schedule(epoch))
                epoch_metrics = []  # (batch index, device metrics)
                hist_pending = []   # (batch index, device histograms)
                t0 = time.time()
                train_loader.epoch = epoch

                def dispatch(group):
                    """Train on the buffered batches: one step, or with
                    K > 1 one call of the K-step dispatch (a full group or
                    the epoch's remainder); then each batch's metrics (the
                    device slots of the stacked ones), watch and print.  The
                    watch of a grouped batch sees the parameters at the end
                    of its dispatch."""
                    if k_disp == 1:
                        ms = [train_step(group[0].raw, group[0].ref)]
                    else:
                        stacked = train_step(
                            np.stack([b.raw for b in group]),
                            np.stack([b.ref for b in group]))
                        ms = [{k: v[j] for k, v in stacked.items()}
                              for j in range(len(group))]
                    for batch, m in zip(group, ms):
                        # batch.index is the true index (enumerate would
                        # restart at 0 after a mid-epoch resume)
                        bi = batch.index
                        epoch_metrics.append((bi, m))
                        gstep = epoch * nb + bi
                        if watch_step is not None and \
                                gstep % watch_freq == 0:
                            gen = torch.Generator(device).manual_seed(
                                watch_seed(cfg.seed, gstep))
                            hist_pending.append(
                                (bi, watch_step(batch.raw, batch.ref, gen)))
                        if (bi + 1) % max(1, cfg.print_freq) == 0:
                            say(f"Batch {bi + 1}/{nb}, Loss: "
                                f"{float(m['loss']):.6f}, "
                                f"Norm: {float(m['grad_norm']):.6f}")
                    group.clear()

                group = []
                for batch in train_loader:
                    group.append(batch)
                    if len(group) == k_disp:
                        dispatch(group)
                if group:
                    dispatch(group)
                # read the epoch's device scalars once, then emit all sink
                # records in ascending-step order (W&B drops a log whose
                # step is below the run's max step, so histograms interleave
                # with the per-batch metrics)
                keys = [k for k in ("loss",) + COMPONENTS
                        if epoch_metrics and k in epoch_metrics[0][1]]
                rows = (torch.stack([torch.stack([m[k] for k in keys])
                                     for _, m in epoch_metrics]).cpu().numpy()
                        if epoch_metrics else np.zeros((0, 1), np.float32))
                losses = rows[:, 0]
                host_hists = {bi: {k: (c.cpu().numpy(), e.cpu().numpy())
                                   for k, (c, e) in h.items()}
                              for bi, h in hist_pending}
                for (bi, _), row in zip(epoch_metrics, rows):
                    explog.log_train_metrics(
                        explog.format_train_metrics(float(row[0]),
                                                    schedule(epoch)),
                        epoch, bi, nb)
                    for comp, v in zip(keys[1:], row[1:]):
                        explog.log_train_metrics(
                            explog.format_loss_metrics(float(v), comp),
                            epoch, bi, nb)
                    if bi in host_hists:
                        explog.log_histograms(host_hists[bi],
                                              step=epoch * nb + bi)
                avg_epoch_loss = (float(np.mean(losses)) if len(losses)
                                  else float("nan"))
                epoch_time = time.time() - t0
                imgs_per_sec = len(epoch_metrics) * cfg.train_batch_size / max(
                    epoch_time, 1e-9)
                say(f"Epoch {epoch + 1}/{num_epochs} completed in "
                    f"{epoch_time:.2f}s, Avg Loss: {avg_epoch_loss:.6f}, "
                    f"{imgs_per_sec:.1f} img/s")
                explog.log_metrics_per_epoch(
                    {"train/images_per_sec": imgs_per_sec,
                     "train/epoch_loss": avg_epoch_loss}, epoch)

                # -- validation (reference ModelTrainer.py:132-158) ---------
                t_val = time.time()
                avg_val_loss, avg_psnr, avg_ssim = validate_loader(
                    eval_step, test_loader, dp)
                say(f"Validation Loss: {avg_val_loss:.6f} "
                    f"({time.time() - t_val:.3f}s)")
                explog.log_test_metrics(explog.format_test_metrics(
                    avg_val_loss, avg_psnr, avg_ssim, epoch_time),
                    step=(epoch + 1) * nb - 1)

                # -- checkpoint + probe image dump --------------------------
                is_best = avg_val_loss < best_loss
                best_loss = min(best_loss, avg_val_loss)
                if sharded:  # a collective: every rank gathers
                    params, opt_state = full_state(model, optimizer)
                else:
                    params, opt_state = (model.state_dict(),
                                         optimizer.state_dict())
                state = dict(params=params, opt_state=opt_state, epoch=epoch,
                             val_loss=avg_val_loss,
                             loader_state=train_loader.state_dict(),
                             extra={"best": best_loss})
                if dp.is_main:
                    (ckpt_best if is_best else ckpt_latest).save(epoch,
                                                                 **state)
                    if is_best:
                        say(f"Model saved with loss: {avg_val_loss:.6f}")
                        # keep latest in sync so resume always has the
                        # newest
                        ckpt_latest.save(epoch, **state)
                probe = probe_image or os.path.join(self.inputDir,
                                                    "6_img_.png")
                if os.path.exists(probe):
                    apply = model_apply(model, cfg.use_kernels)
                    if dp.is_main:
                        process_image_using_model(
                            apply, probe, run_name,
                            f"Epoch {epoch}_ Best {is_best}", logger=explog)
                    elif sharded or cp is not None:
                        # the forward's collectives need every rank
                        apply(prep_image(probe))
                dp.barrier()  # the checkpoint is on disk for every rank
                if on_epoch_end is not None:
                    on_epoch_end(epoch, model, avg_val_loss)

        if k_disp > 1:
            say(f"steps_per_dispatch {k_disp}: {describe(train_step)}")
        say("Training completed!")
        explog.finish()
        return model, optimizer

    # ------------------------------------------------------------------
    def evaluate(self, config, model_path: str):
        """Reference ModelTrainer.evaluate (:206-259), fixed as the JAX
        package fixes it: (avg PSNR, avg SSIM) over the test directories of
        the checkpoint of least validation loss (else the latest) under
        ``model_path``, the model built in ``config.compute_dtype`` (the
        trainer validates in it, so a best checkpoint gives back the numbers
        logged for its epoch)."""
        cfg = config
        _, test_loader = get_dataloaders(
            self.inputDir, self.referenceDir,
            self.testInputDir, self.testReferenceDir,
            batch_size=cfg.test_batch_size, image_size=cfg.image_size,
        )
        model = init_model(cfg.arch,
                           device=resolve_device("cpu" if cfg.use_cpu
                                                 else None),
                           compute_dtype=compute_dtype_of(cfg),
                           img_size=cfg.image_size, use_dwt=cfg.use_dwt,
                           remat=cfg.remat,
                           remat_policy=cfg.remat_policy or None)
        params, _ = best_or_latest_params(model_path)
        model.load_state_dict(params, strict=True)
        eval_step = make_eval_step(model, LossFunction("L1"),
                                   use_kernels=cfg.use_kernels)
        _, avg_psnr, avg_ssim = validate_loader(eval_step, test_loader)
        print("Evaluation Results:")
        print(f"Average PSNR: {avg_psnr:.2f} dB")
        print(f"Average SSIM: {avg_ssim:.4f}")
        return avg_psnr, avg_ssim
