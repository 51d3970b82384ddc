"""Model registry of the port (counterpart of
the JAX package's ``models/__init__.py``): SpectralTransformer, AST and the
New* family."""
from __future__ import annotations

import torch
from torch import nn

from .._device import resolve_device
from .ast import AST, trunc_normal_
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
               remat: bool = False, remat_policy=None, **kwargs):
    """Build ``name`` on ``device`` (CUDA unless ``device="cpu"``) with its
    reference init drawn from ``torch.Generator().manual_seed(seed)``, in
    eval mode.  ``kwargs`` go to the model (channels, num_blocks, ... for
    SpectralTransformer; img_size, embed_dim, win_size, ... for AST;
    img_size, embed_dim, use_dwt, drop_path_rate for the New* models).
    ``cp`` (``core.meshes.ContextParallel``, every arch): the forward takes
    and gives the rank's band of the images' rows (context parallelism);
    the parameters and the state_dict are the single-device ones.
    ``remat``/``remat_policy`` (``ops.layers.make_remat``): per-block
    rematerialization; the parameters and their names are unchanged."""
    if name not in _FACTORY:
        raise KeyError(f"Unknown model: {name}")
    if cp is not None and cp.size > 1:
        kwargs["cp"] = cp
    if name not in _SIZE_ARCHS:
        kwargs.pop("img_size", None)
    if name not in _USE_DWT_ARCHS:
        kwargs.pop("use_dwt", None)
    dev = resolve_device(device)
    model = _FACTORY[name](compute_dtype=compute_dtype, device=dev,
                           remat=remat, remat_policy=remat_policy, **kwargs)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model.reset_parameters(gen)
    return model.eval()


@torch.no_grad()
def reinit_linear_trunc_normal(model: nn.Module, generator: torch.Generator,
                               std: float = 0.02) -> nn.Module:
    """Draw every ``nn.Linear`` weight of ``model`` again, N(0, std)
    truncated to [-2 std, 2 std], from ``generator``, and zero its bias:
    AST's ``_init_weights`` pass over nn.Linear (reference AST.py:865-872),
    the counterpart of the JAX registry's function.  The convolutions keep
    their init.  Returns ``model``, changed in place."""
    for m in model.modules():
        if isinstance(m, nn.Linear):
            trunc_normal_(m.weight, generator, std, 2.0 * std)
            if m.bias is not None:
                m.bias.zero_()
    return model


__all__ = ["AST", "NewBigFRFNModel", "NewBigModel", "NewModel",
           "SpectralTransformer", "get_names", "init_model",
           "reinit_linear_trunc_normal"]
