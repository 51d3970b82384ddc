"""Model registry of the port (counterpart of
the JAX package's ``models/__init__.py``).  Only
SpectralTransformer is ported so far."""
from __future__ import annotations

import torch

from .._device import resolve_device
from .spectral_transformer import SpectralTransformer

_PENDING = ("AST", "NewModel", "NewBigModel", "NewBigFRFNModel")


def get_names():
    return ["SpectralTransformer"]


def init_model(name: str, *, device=None, seed: int = 0,
               compute_dtype: torch.dtype = torch.float32, **kwargs):
    """Build ``name`` on ``device`` (CUDA unless ``device="cpu"``) with
    torch-default init drawn from ``torch.Generator().manual_seed(seed)``.
    ``kwargs`` go to the model (channels, num_blocks, ...)."""
    if name in _PENDING:
        raise NotImplementedError(
            f"{name} is not ported yet: the AST/New* models and their "
            "kernels are later slices (ROADMAP.md, queue 1)")
    if name != "SpectralTransformer":
        raise KeyError(f"Unknown model: {name}")
    dev = resolve_device(device)
    model = SpectralTransformer(compute_dtype=compute_dtype, device=dev,
                                **kwargs)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model.reset_parameters(gen)
    return model.eval()


__all__ = ["SpectralTransformer", "get_names", "init_model"]
