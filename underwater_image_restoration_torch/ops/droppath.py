"""Stochastic depth, counterpart of the JAX package's ``ops/droppath.py``.

At inference (``eval()``, or a rate of 0) it is the identity, which is all
the serving path needs.  Training draws one keep mask a sample from an
explicit ``torch.Generator``; that comes with the AST train step
(ROADMAP.md, TPU kernel row 12), so a training-mode call with a non-zero
rate raises rather than drawing from the global generator.
"""
from __future__ import annotations

from torch import nn


class DropPath(nn.Module):
    """Per-sample residual-branch dropout (timm's DropPath)."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)

    def sample_scale(self, batch: int):
        """The per-sample scale a fused kernel applies to its branch (the
        ``s`` of ``ops.ln_leff``): None where the module is the identity."""
        if not self.training or self.rate == 0.0:
            return None
        raise NotImplementedError(
            "DropPath in training mode draws from an explicit generator, "
            "which comes with the AST train step (ROADMAP.md, TPU kernel "
            "row 12); call eval() for inference")

    def forward(self, x):
        """The identity at inference (training raises: ``sample_scale``)."""
        self.sample_scale(x.shape[0])
        return x

    def extra_repr(self) -> str:
        return f"rate={self.rate}"
