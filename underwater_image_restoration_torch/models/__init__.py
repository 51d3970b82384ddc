"""Model registry of the port (counterpart of
the JAX package's ``models/__init__.py``): SpectralTransformer, AST and the
New* family."""
from __future__ import annotations

import torch

from .._device import resolve_device
from .ast import AST
from .new_model import NewBigFRFNModel, NewBigModel, NewModel
from .spectral_transformer import SpectralTransformer

_FACTORY = {"SpectralTransformer": SpectralTransformer, "AST": AST,
            "NewModel": NewModel, "NewBigModel": NewBigModel,
            "NewBigFRFNModel": NewBigFRFNModel}
# archs whose window masks and drop-path schedule derive from img_size;
# SpectralTransformer is size-agnostic and drops it, as the JAX registry does
_SIZE_ARCHS = {"AST", "NewModel", "NewBigModel", "NewBigFRFNModel"}
# archs that take use_dwt; the others drop it, as the JAX registry does
_USE_DWT_ARCHS = {"NewModel", "NewBigModel", "NewBigFRFNModel"}


def get_names():
    return list(_FACTORY)


def init_model(name: str, *, device=None, seed: int = 0,
               compute_dtype: torch.dtype = torch.float32, cp=None,
               **kwargs):
    """Build ``name`` on ``device`` (CUDA unless ``device="cpu"``) with its
    reference init drawn from ``torch.Generator().manual_seed(seed)``, in
    eval mode.  ``kwargs`` go to the model (channels, num_blocks, ... for
    SpectralTransformer; img_size, embed_dim, win_size, ... for AST;
    img_size, embed_dim, use_dwt, drop_path_rate for the New* models).
    ``cp`` (``core.meshes.ContextParallel``, every arch): the forward takes
    and gives the rank's band of the images' rows (context parallelism);
    the parameters and the state_dict are the single-device ones."""
    if name not in _FACTORY:
        raise KeyError(f"Unknown model: {name}")
    if cp is not None and cp.size > 1:
        kwargs["cp"] = cp
    if name not in _SIZE_ARCHS:
        kwargs.pop("img_size", None)
    if name not in _USE_DWT_ARCHS:
        kwargs.pop("use_dwt", None)
    dev = resolve_device(device)
    model = _FACTORY[name](compute_dtype=compute_dtype, device=dev, **kwargs)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model.reset_parameters(gen)
    return model.eval()


__all__ = ["AST", "NewBigFRFNModel", "NewBigModel", "NewModel",
           "SpectralTransformer", "get_names", "init_model"]
