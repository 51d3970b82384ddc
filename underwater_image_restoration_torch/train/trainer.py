"""The train step, counterpart of the JAX package's ``train/trainer.py``
``normalize_u8`` and ``make_train_step`` (one device, no mesh).

A step is uint8 NHWC normalize -> forward (NCHW, the model's compute dtype
over f32 parameters) -> loss in f32 -> backward -> global-norm clip ->
optimizer update, with ``grad_accum`` microbatches as the JAX step scans
them.  The model runs in training mode, as the JAX step always passes
``deterministic=False``: the AST's DropPath draws from the step's
``generator`` (SpectralTransformer has no module whose output depends on the
mode).  On CUDA the blocks' forward and backward run through the
hand-written kernels (``use_kernels=False`` takes their plain versions, as
a reference).  The state is the model and the optimizer, updated in place.

Not here: the mesh and sharded state (ROADMAP.md queue 13), remat (the
kernels' autograd Functions save only x and the stats), and ``k_steps``
(a workaround for the TPU's remote dispatch).
"""
from __future__ import annotations

import inspect

import numpy as np
import torch


def normalize_u8(u8):
    """uint8 -> f32 in [-1, 1]: u8 / 255 * 2 - 1 (the JAX formula)."""
    return u8.float() / 255.0 * 2.0 - 1.0


def make_train_step(model, lossfn, optimizer, grad_accum: int = 1,
                    use_kernels: bool = True,
                    generator: torch.Generator | None = None):
    """``optimizer`` is ``train.optim.get_optimizer``'s (its ``step()``
    clips and returns the pre-clip global norm).  Returns
    ``step(raw_u8, ref_u8) -> {"loss", "grad_norm"}``: one
    optimizer update of ``model`` from uint8 (B, H, W, 3) batches (numpy or
    tensors), the metrics as f32 0-dim tensors on the model's device
    (``grad_norm`` before the clip).

    grad_accum > 1 splits the batch into that many microbatches and averages
    their gradients before the one update, with an extra 1/grad_accum for
    the B*C-divided losses (a microbatch's divisor is grad_accum times
    smaller); the Adaptive pair couples the whole batch and is refused.
    Parameters the loss does not reach (q1X1_1, the dead kf half of kv)
    get zero gradients, not None, so that every optimizer updates them as
    optax does (AdamW decays every leaf).

    The forward runs in training mode (the model's mode is restored after
    the step).  A model whose ``forward`` takes a ``generator`` (the AST's
    DropPath) gets ``generator``: steps and microbatches draw from it one
    after another (the counterpart of the JAX step's ``fold_in(rng, step)``
    and ``fold_in(rng, i)``, not the same stream); one seed gives the same
    draws with and without the kernels."""
    if grad_accum > 1 and not (lossfn.batch_linear or lossfn.bc_divided):
        raise ValueError(
            f"grad_accum={grad_accum} is not exact for loss "
            f"'{lossfn.loss_name}': its adaptive softmax weights couple the "
            "whole batch, so microbatch accumulation changes the loss. Use "
            "grad_accum=1.")
    params = [p for p in model.parameters() if p.requires_grad]
    kwargs = ({"generator": generator} if "generator" in
              inspect.signature(model.forward).parameters else {})
    device = params[0].device
    inv = 1.0 / grad_accum
    if lossfn.bc_divided:
        inv /= grad_accum

    def to_nchw(u8):
        t = torch.as_tensor(np.ascontiguousarray(u8)).to(device)
        return normalize_u8(t).permute(0, 3, 1, 2).contiguous()

    def step(raw_u8, ref_u8):
        x, y = to_nchw(raw_u8), to_nchw(ref_u8)
        b = x.shape[0]
        if b % grad_accum:
            raise ValueError(
                f"train batch {b} not divisible by grad_accum={grad_accum}")
        mb = b // grad_accum
        for p in params:
            p.grad = None
        loss = torch.zeros((), device=device)
        was_training = model.training
        model.train()
        try:
            for i in range(grad_accum):
                sl = slice(i * mb, (i + 1) * mb)
                li = lossfn(model(x[sl], use_kernels, **kwargs).float(),
                            y[sl])
                (li * inv if grad_accum > 1 else li).backward()
                loss = loss + li.detach()
        finally:
            model.train(was_training)
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        gnorm = optimizer.step()
        return {"loss": loss * inv if grad_accum > 1 else loss,
                "grad_norm": gnorm}

    return step
