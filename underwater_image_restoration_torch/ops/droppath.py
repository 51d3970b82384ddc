"""Stochastic depth, counterpart of the JAX package's ``ops/droppath.py``.

At inference (``eval()``, or a rate of 0) it is the identity.  In training
each call draws one keep decision a sample, Bernoulli(1 - rate), from an
explicit ``torch.Generator`` (the counterpart of the JAX module's
``make_rng("dropout")``): a kept sample's branch is scaled by 1/keep, a
dropped one's is zero.  A training-mode call at a non-zero rate without a
generator raises rather than draw from the global generator.

``sample_scale`` and ``forward`` draw alike (``batch`` uniforms a call), so
a block draws the same numbers whether its branch goes through a fused
kernel (which takes the scale) or through plain ops (``forward``).  The JAX
rng stream cannot be reproduced here: parity with JAX runs at rate 0.

Under data parallelism the train step passes a ``RankDraws`` in the
generator's place: a call on the data index's ``batch`` rows draws the
global batch's ``batch * world`` uniforms and keeps rows
[rank batch, (rank + 1) batch), ``rank`` the data index and ``world`` the
data-parallel size.  Every rank's generator is seeded alike, so n data
indices draw what one device draws at the global batch, and the context
ranks of one data index (which hold bands of the same images) draw the
same decisions.

Under rematerialization (``ops.layers.make_remat``) a checkpointed call
runs twice, its recompute in the backward; the checkpoint hands it a
``Replay`` of each generator, which records the scales the forward draws
and plays them back to the recompute.  The recompute so uses the forward's
numbers and draws nothing: each generator advances once a step, and no
generator state is read or set, which a CUDA graph's capture forbids.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class RankDraws:
    """A generator seeded alike on every rank, with the rank's data index
    ``rank`` of ``world`` data indices: DropPath draws the ``world`` data
    indices' decisions from it and keeps ``rank``'s rows (every context
    rank of a data index keeps the same)."""

    generator: torch.Generator
    rank: int
    world: int


class Replay:
    """The draws of one checkpointed call from ``generator`` (a
    ``torch.Generator``, a ``RankDraws`` or an enclosing call's
    ``Replay``): the forward's DropPath scales are drawn and recorded in
    order; after ``rewind`` the recompute gets the same tensors back in the
    same order."""

    def __init__(self, generator):
        self.generator = generator
        self.draws = []
        self.next = None  # the index of the next draw played back

    def rewind(self):
        self.next = 0

    def scale(self, draw):
        """``draw(generator)``, recorded; in a recompute the recorded
        scale."""
        if self.next is None:
            self.draws.append(draw(self.generator))
            return self.draws[-1]
        self.next += 1
        return self.draws[self.next - 1]


DRAWS = (torch.Generator, RankDraws, Replay)


class DropPath(nn.Module):
    """Per-sample residual-branch dropout (timm's DropPath)."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)

    def sample_scale(self, batch: int,
                     generator: torch.Generator | RankDraws | Replay | None):
        """The per-sample scale a fused kernel applies to its branch (the
        ``s`` of ``ops.ln_leff``): (batch,) f32 of 0 or 1/keep on the
        generator's device, or None where the module is the identity.  A
        ``RankDraws`` gives the data index's rows of the global batch's
        draw, a ``Replay`` the draw it records or plays back."""
        if not self.training or self.rate == 0.0:
            return None
        if generator is None:
            raise ValueError(
                "DropPath in training mode at rate "
                f"{self.rate} draws from an explicit torch.Generator: pass "
                "generator= (make_train_step(..., generator=...)), or call "
                "eval() for inference")
        if isinstance(generator, Replay):
            return generator.scale(lambda g: self.sample_scale(batch, g))
        keep = 1.0 - self.rate
        rank, world = 0, 1
        if isinstance(generator, RankDraws):
            generator, rank, world = (generator.generator, generator.rank,
                                      generator.world)
        u = torch.rand(batch * world, generator=generator,
                       device=generator.device)[rank * batch:
                                                (rank + 1) * batch]
        return (u < keep).float() / keep

    def forward(self, x,
                generator: torch.Generator | RankDraws | Replay | None = None):
        """``x / keep`` (in x's dtype) where a sample is kept, 0 where it is
        dropped; the identity at inference."""
        s = self.sample_scale(x.shape[0], generator)
        if s is None:
            return x
        kept = (s > 0).view((-1,) + (1,) * (x.dim() - 1))
        return torch.where(kept, x / (1.0 - self.rate), torch.zeros_like(x))

    def extra_repr(self) -> str:
        return f"rate={self.rate}"
