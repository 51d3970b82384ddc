"""Optimizers and the learning-rate schedule, counterparts of the JAX
package's ``train/optim.py`` with optax's formulas, not torch's defaults.

``get_optimizer`` chains ``clip_by_global_norm(clip_norm)`` with adam,
adamw, sgd or rmsprop, as the optax chain does:

- the clip scales every gradient by ``clip_norm / ||g||`` once
  ``||g|| >= clip_norm`` (optax divides by ||g|| exactly;
  ``torch.nn.utils.clip_grad_norm_`` adds 1e-6 and scales below the limit
  too);
- ``torch.optim.Adam``, ``AdamW`` and ``SGD`` (momentum, nesterov, no
  dampening) compute optax's updates at these settings, so they are used;
- rmsprop is the port's own: optax puts eps inside the square root,
  ``g * rsqrt(nu + eps)``, scales by the learning rate, and then applies the
  momentum trace to the scaled update (torch's ``RMSprop`` adds eps outside
  the root).

The learning rate lives in ``param_groups`` and is set per epoch by
``set_learning_rate`` (the injected hyperparameter of the JAX package).

``capturable=True`` builds Adam and AdamW with torch's ``capturable``
flag, their step counts on the device, so that a CUDA graph of the train
step replays the update (``make_train_step(k_steps=K)``; the bias
correction is computed on the device, so its rounding differs from the
host's).  Every optimizer reads its learning rate and other
hyperparameters as Python floats, baked into a graph when it is captured:
``hyperparameters`` is what a captured graph depends on, and the train
step captures again when it changes.
"""
from __future__ import annotations

from typing import Sequence

import torch

GRAD_CLIP_NORM = 1.0
DEFAULT_MILESTONES = (1, 100, 250)
DEFAULT_GAMMA = 0.25


def multistep_lr(base_lr: float, milestones: Sequence[int] = DEFAULT_MILESTONES,
                 gamma: float = DEFAULT_GAMMA):
    """lr(epoch) of torch's MultiStepLR stepped at each epoch end:
    base_lr * gamma^(number of milestones <= epoch)."""
    ms = sorted(milestones)

    def lr(epoch: int) -> float:
        return base_lr * gamma ** sum(1 for m in ms if epoch >= m)

    return lr


def _shards(tensors):
    """(local tensors, process group): a sharded model's gradients are
    DTensors (FSDP2), whose local shards over the sharded dimension of
    their mesh together hold every element once (HSDP replicates them over
    the other); others are their own, with no group."""
    try:
        from torch.distributed.tensor import DTensor
    except ImportError:  # a build without torch.distributed
        return list(tensors), None
    if tensors and isinstance(tensors[0], DTensor):
        from ..core.meshes import shard_dim

        t0 = tensors[0]
        return ([t.to_local() for t in tensors],
                t0.device_mesh.get_group(shard_dim(t0)))
    return list(tensors), None


@torch.no_grad()
def global_norm(tensors) -> torch.Tensor:
    """The 2-norm of every element together, in f32 (optax's
    ``global_norm``), from one multi-tensor launch over the list; over the
    ranks' shards for sharded gradients (their sums of squares
    all-reduced)."""
    local, group = _shards(tensors)
    norms = torch._foreach_norm([t.float() for t in local])
    if group is None:
        return torch.linalg.vector_norm(torch.stack(norms))
    import torch.distributed as dist

    sq = torch.stack(norms).square().sum()
    dist.all_reduce(sq, group=group)
    return sq.sqrt()


@torch.no_grad()
def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm``, in place: each g becomes
    ``g * (max_norm / ||g||)`` when ``||g|| >= max_norm`` (optax's
    ``g / ||g|| * max_norm`` to an ulp), with the global norm of sharded
    gradients too.  Returns ||g|| before the clip; no host
    synchronisation."""
    norm = global_norm(grads)
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    torch._foreach_mul_(_shards(grads)[0], scale)
    return norm


class RMSprop(torch.optim.Optimizer):
    """optax.rmsprop(lr, decay, eps, momentum), not centered:
    nu = decay nu + (1 - decay) g^2; u = -lr g rsqrt(nu + eps);
    m = u + momentum m, and the step is m (momentum 0: the step is u)."""

    def __init__(self, params, lr: float, decay: float, eps: float,
                 momentum: float):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps,
                                      momentum=momentum))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["nu"] = torch.zeros_like(p)
                    st["trace"] = torch.zeros_like(p)
                g = p.grad
                nu = st["nu"].mul_(group["decay"]).addcmul_(
                    g, g, value=1 - group["decay"])
                u = g * torch.rsqrt(nu + group["eps"]) * -group["lr"]
                p.add_(st["trace"].mul_(group["momentum"]).add_(u))


class ClippedOptimizer:
    """The optax chain ``clip_by_global_norm(clip_norm) -> optimizer``:
    ``step()`` clips the parameters' gradients (if clip_norm > 0), then
    steps the inner torch optimizer."""

    def __init__(self, inner: torch.optim.Optimizer, clip_norm: float):
        self.inner = inner
        self.clip_norm = clip_norm

    @property
    def param_groups(self):
        return self.inner.param_groups

    def params(self):
        return [p for g in self.param_groups for p in g["params"]]

    def step(self) -> torch.Tensor:
        """Clip, update; returns the gradients' global norm before the
        clip."""
        grads = [p.grad for p in self.params() if p.grad is not None]
        if self.clip_norm and self.clip_norm > 0:
            norm = clip_by_global_norm_(grads, self.clip_norm)
        else:
            norm = global_norm(grads)
        self.inner.step()
        return norm

    def state_dict(self) -> dict:
        """The inner optimizer's state (Adam's step, exp_avg and exp_avg_sq,
        momentum buffers, the learning rates) and ``clip_norm``."""
        return {"inner": self.inner.state_dict(), "clip_norm": self.clip_norm}

    def load_state_dict(self, state: dict):
        """Load a ``state_dict``; the groups keep this optimizer's
        ``capturable`` flag (a checkpoint of a capturable Adam resumes in
        one that is not, and the other way round), with Adam's step counts
        where the flag wants them."""
        inner = state["inner"]
        flags = [g.get("capturable") for g in self.inner.param_groups]
        inner = {**inner, "param_groups": [
            {**g, "capturable": f} if f is not None else g
            for g, f in zip(inner["param_groups"], flags)]}
        self.inner.load_state_dict(inner)
        self.clip_norm = state["clip_norm"]
        for group, flag in zip(self.inner.param_groups, flags):
            if flag is False:  # torch's non-capturable Adam counts on the host
                for p in group["params"]:
                    st = self.inner.state.get(p, {})
                    if torch.is_tensor(st.get("step")):
                        st["step"] = st["step"].cpu()

    def hyperparameters(self) -> tuple:
        """Every group's settings but its parameters (learning rate, betas,
        decay, ...): the Python numbers a CUDA graph of the update bakes
        in."""
        return tuple(tuple(sorted((k, v) for k, v in g.items()
                                  if k != "params"))
                     for g in self.param_groups)


def get_optimizer(optim: str, params, learning_rate: float, *,
                  weight_decay: float = 0.01, momentum: float = 0.9,
                  sgd_dampening: float = 0.0, sgd_nesterov: bool = False,
                  rmsprop_alpha: float = 0.99,
                  adam_beta1: float = 0.9, adam_beta2: float = 0.999,
                  clip_norm: float = GRAD_CLIP_NORM,
                  capturable: bool = False) -> ClippedOptimizer:
    """Gradient clip + optimizer over ``params``, with the JAX package's
    arguments and defaults.  ``sgd_dampening`` is accepted and ignored, as
    there (optax's sgd has no dampening).  ``capturable``: Adam and AdamW
    keep their step counts on the device, for a CUDA graph of the step
    (sgd and rmsprop need nothing)."""
    del sgd_dampening
    params = list(params)
    betas = (adam_beta1, adam_beta2)
    if optim == "adam":
        inner = torch.optim.Adam(params, lr=learning_rate, betas=betas,
                                 eps=1e-8, capturable=capturable)
    elif optim == "adamw":
        inner = torch.optim.AdamW(params, lr=learning_rate, betas=betas,
                                  eps=1e-8, weight_decay=weight_decay,
                                  capturable=capturable)
    elif optim == "sgd":
        inner = torch.optim.SGD(params, lr=learning_rate,
                                momentum=momentum or 0.0,
                                nesterov=bool(momentum) and sgd_nesterov)
    elif optim == "rmsprop":
        inner = RMSprop(params, lr=learning_rate, decay=rmsprop_alpha,
                        eps=1e-8, momentum=momentum)
    else:
        raise ValueError(f"Unsupported optimizer: {optim}")
    return ClippedOptimizer(inner, clip_norm)


def set_learning_rate(optimizer, lr: float):
    """Assign the learning rate of every parameter group."""
    for group in optimizer.param_groups:
        group["lr"] = lr
    return optimizer


def get_learning_rate(optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])
