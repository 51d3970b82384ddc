"""Convolution, dense, elementwise and normalization layers, counterparts of
the JAX package's ``ops/layers.py``.

Parameters are f32; each layer computes in its input's dtype (the JAX
package's ``dtype``), casting the weights to it.  ``Linear`` keeps
``Dense``'s rounding points: the product is accumulated in f32 (f32 math
for f32 inputs; for bf16 inputs PyTorch's bf16 matmul accumulates in f32)
and rounded to the compute dtype once, before the bias is added in that
dtype.  Channel LayerNorm (``layer_norm_channels``) is over dim 1 of NCHW,
token LayerNorm (``layer_norm_last``) over the last dim of (B, L, C); both
keep their statistics and affine in f32 (f64 for f64 inputs, ``wide``).

``make_remat`` is the JAX module's per-block rematerialization: the models
wrap their blocks with it, and the backward recomputes a checkpointed
block's forward instead of keeping its activations.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .droppath import DRAWS, Replay


_CONSTANTS: dict = {}


def constant(values: tuple, device, dtype=torch.float32) -> torch.Tensor:
    """``torch.tensor(values, device=device, dtype=dtype)``, made once a
    (values, device, dtype) and shared, so read-only.  A step captured in a
    CUDA graph cannot copy from the host: its constants are made by the
    eager step before the capture.  One made while a tracer runs
    (``torch.export``'s fake tensors) is not kept."""
    key = (values, str(torch.device(device)), dtype)
    t = _CONSTANTS.get(key)
    if t is None:
        t = torch.tensor(values, device=device, dtype=dtype)
        if type(t) is torch.Tensor:
            _CONSTANTS[key] = t
    return t


def wide(t):
    """``t`` in the dtype the plain versions accumulate in: f32, or f64
    for an f64 tensor (a check in f64 then runs in f64 throughout)."""
    return t.double() if t.dtype == torch.float64 else t.float()


def layer_norm_channels(x, scale, bias, eps: float = 1e-5):
    """LayerNorm over the channel dim of (B, C, H, W): statistics and affine
    in f32 (bf16 mean/var over C=16 would lose ~2 decimal digits), result in
    ``x.dtype``."""
    xf = wide(x)
    mean = xf.mean(dim=1, keepdim=True)
    var = (xf - mean).square().mean(dim=1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    cshape = (1, -1, 1, 1)
    y = y * wide(scale).view(cshape) + wide(bias).view(cshape)
    return y.to(x.dtype)


class LayerNorm(nn.Module):
    """Channel LayerNorm with torch's eps (1e-5) and the reference's
    parameter names (``weight``/``bias``)."""

    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x):
        return layer_norm_channels(x, self.weight, self.bias, self.eps)


def layer_norm_last(x, scale, bias, eps: float = 1e-5):
    """LayerNorm over the last dim (tokens (B, L, C)): statistics and affine
    in f32, result in ``x.dtype``."""
    y = F.layer_norm(x.float(), (x.shape[-1],), scale.float(), bias.float(),
                     eps)
    return y.to(x.dtype)


class TokenLayerNorm(LayerNorm):
    """LayerNorm over the last dim, same parameters as ``LayerNorm``."""

    def forward(self, x):
        return layer_norm_last(x, self.weight, self.bias, self.eps)


class Conv2d(nn.Conv2d):
    """nn.Conv2d whose f32 parameters are cast to the input's dtype."""

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), b, self.stride,
                        self.padding, self.dilation, self.groups)


class ConvTranspose2d(nn.ConvTranspose2d):
    """nn.ConvTranspose2d (weight ``(in, out, kh, kw)``, the reference's
    layout) whose f32 parameters are cast to the input's dtype."""

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv_transpose2d(x, self.weight.to(x.dtype), b, self.stride,
                                  self.padding, self.output_padding,
                                  self.groups, self.dilation)


class Linear(nn.Linear):
    """nn.Linear with ``Dense``'s rounding points: the product rounded to
    x.dtype, then the bias added in x.dtype."""

    def forward(self, x):
        y = F.linear(x, self.weight.to(x.dtype))
        return y if self.bias is None else y + self.bias.to(x.dtype)


def gelu(x):
    """Exact (erf) GELU, torch's nn.GELU default."""
    return F.gelu(x)


def leaky_relu(x, negative_slope: float = 0.01):
    return F.leaky_relu(x, negative_slope)


def l2_normalize(x, dim: int = -1, eps: float = 1e-12):
    """F.normalize(x, dim=dim) written as ``x / sqrt(max(s, eps^2))`` so an
    exactly-zero row has a zero gradient; sums in f32, result in x.dtype."""
    xf = wide(x)
    s = xf.square().sum(dim=dim, keepdim=True)
    return (xf / torch.sqrt(torch.clamp_min(s, eps * eps))).to(x.dtype)


# ---- rematerialization (the JAX module's REMAT_POLICIES and make_remat)

def _dots_saved(ctx, op, *args, **kwargs):
    """The "dots" policy (``jax.checkpoint_policies.
    dots_with_no_batch_dims_saveable``): keep the outputs of the matrix
    products without a batch dimension, the weight products (``Linear`` on
    (B, L, C) tokens reaches ``aten.mm``; with a bias on a matrix,
    ``aten.addmm``), and recompute everything else: the attention's
    ``bmm``, the convolutions, the FFTs and the kernels' custom ops, as the
    JAX policy recomputes a ``pallas_call``."""
    from torch.utils.checkpoint import CheckpointPolicy

    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    from torch.utils.checkpoint import create_selective_checkpoint_contexts

    return create_selective_checkpoint_contexts(_dots_saved)


# Named activation-checkpoint policies: None/"full" recomputes everything
# inside the checkpoint (the most memory saved); "dots" keeps the weight
# products' outputs and recomputes the rest (selective activation
# checkpointing).  The JAX package's "mxu" and "mxu+ew" are not ported.
REMAT_POLICIES = {None: None, "full": None, "dots": _dots_context}
TPU_REMAT_POLICIES = ("mxu", "mxu+ew")


def no_remat(fn):
    """``make_remat(False)``'s transform: ``fn`` itself."""
    return fn


def checkpoint(fn, policy, *args, **kwargs):
    """``fn(*args, **kwargs)`` rematerialized under ``policy`` (a key of
    ``REMAT_POLICIES``): ``torch.utils.checkpoint`` (non-reentrant) keeps
    the tensor arguments and what the policy saves, and the backward runs
    ``fn`` again for the rest.  Where autograd records nothing (no grad
    mode, ``torch.export``) it is ``fn`` alone.

    The DropPath draws among the arguments (a ``torch.Generator``, a
    ``RankDraws`` or an enclosing checkpoint's ``Replay``) reach ``fn`` as
    ``droppath.Replay``s: the forward's scales are recorded and the
    recompute gets them back, so it differentiates the forward that ran,
    and each step advances a generator once.  No generator state is read
    or set (a CUDA graph's capture forbids it), and
    ``torch.utils.checkpoint`` stashes no default generator's state
    (``preserve_rng_state=False``: the port draws only from explicit
    generators, and the CUDA default generator's ``get_state`` raises under
    capture)."""
    from torch.utils.checkpoint import checkpoint as torch_checkpoint
    from torch.utils.checkpoint import noop_context_fn

    if not torch.is_grad_enabled() or torch.compiler.is_exporting():
        return fn(*args, **kwargs)

    def taped(v):
        return Replay(v) if isinstance(v, DRAWS) else v

    args = tuple(taped(a) for a in args)
    kwargs = {k: taped(v) for k, v in kwargs.items()}
    tapes = [v for v in (*args, *kwargs.values()) if isinstance(v, Replay)]
    ran = []

    def run(*a, **k):
        if ran:  # the recompute
            for t in tapes:
                t.rewind()
        ran.append(True)
        return fn(*a, **k)

    return torch_checkpoint(run, *args, use_reentrant=False,
                            preserve_rng_state=False,
                            context_fn=REMAT_POLICIES[policy]
                            or noop_context_fn, **kwargs)


def make_remat(remat: bool, policy: str | None = None):
    """The remat transform the models wrap their blocks with:
    ``make_remat(False)`` is the identity (whatever the policy); otherwise
    ``fn -> (lambda *args, **kwargs: checkpoint(fn, policy, *args,
    **kwargs))`` with ``policy`` None, "full" or "dots" (see
    ``REMAT_POLICIES``)."""
    if not remat:
        return no_remat
    if policy in TPU_REMAT_POLICIES:
        raise ValueError(
            f"remat policy {policy!r} is not ported: the 'mxu' and 'mxu+ew' "
            "policies are TPU-measured negatives (ROADMAP.md ground rules, "
            "'Do not port what the TPU alone needed'); use 'full' or 'dots'")
    if policy not in REMAT_POLICIES:
        raise ValueError(f"Unknown remat policy {policy!r}; one of "
                         f"{list(REMAT_POLICIES)}")

    def transform(fn):
        def rematerialized(*args, **kwargs):
            return checkpoint(fn, policy, *args, **kwargs)

        return rematerialized

    return transform
