"""Ops of the port: plain PyTorch layers and the two fused SpectralBlock
halves whose CUDA kernels live in ``csrc/``."""
from .attention import channel_attention_core
from .fused_gdfn import ln_gdfn, ln_gdfn_plain
from .fused_mdta import ln_mdta, ln_mdta_plain
from .layers import (
    LayerNorm,
    gelu,
    l2_normalize,
    layer_norm_channels,
    leaky_relu,
)
from .resample import pixel_shuffle, pixel_unshuffle
from .spectral import (
    fft2,
    ifft2,
    safe_abs,
    safe_angle,
    spectral_tile_upsample,
    zero_stuff2x,
)

__all__ = [
    "LayerNorm",
    "channel_attention_core",
    "fft2",
    "gelu",
    "ifft2",
    "l2_normalize",
    "layer_norm_channels",
    "leaky_relu",
    "ln_gdfn",
    "ln_gdfn_plain",
    "ln_mdta",
    "ln_mdta_plain",
    "pixel_shuffle",
    "pixel_unshuffle",
    "safe_abs",
    "safe_angle",
    "spectral_tile_upsample",
    "zero_stuff2x",
]
