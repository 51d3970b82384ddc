"""Ops of the port: plain PyTorch layers, and the fused ops whose CUDA
kernels live in ``csrc/``: the two SpectralBlock halves (LN+MDTA, LN+GDFN),
the AST's LN+LeFF and its window attention; the Haar transforms of the New*
models."""
from .attention import (
    channel_attention_core,
    merge_heads,
    sparse_mix_weights,
    split_heads,
    window_attention_core,
)
from .droppath import DropPath
from .fused_gdfn import ln_gdfn, ln_gdfn_plain
from .fused_leff import ln_leff, ln_leff_plain
from .fused_mdta import ln_mdta, ln_mdta_plain
from .layers import (
    REMAT_POLICIES,
    LayerNorm,
    gelu,
    l2_normalize,
    layer_norm_channels,
    leaky_relu,
    make_remat,
)
from .resample import (
    image_to_tokens,
    pixel_shuffle,
    pixel_unshuffle,
    tokens_to_image,
)
from .wavelets import dwt2d, idwt2d
from .spectral import (
    fft2,
    ifft2,
    inv_mag,
    safe_abs,
    safe_angle,
    spectral_tile_upsample,
    zero_stuff2x,
)
from .window_attention import window_attention, window_attention_plain
from .windows import (
    relative_position_index,
    shift_mask,
    shift_window_mask,
    window_partition,
    window_reverse,
)

__all__ = [
    "DropPath",
    "LayerNorm",
    "REMAT_POLICIES",
    "channel_attention_core",
    "dwt2d",
    "fft2",
    "gelu",
    "idwt2d",
    "ifft2",
    "image_to_tokens",
    "inv_mag",
    "l2_normalize",
    "layer_norm_channels",
    "leaky_relu",
    "ln_gdfn",
    "ln_gdfn_plain",
    "ln_leff",
    "ln_leff_plain",
    "ln_mdta",
    "ln_mdta_plain",
    "make_remat",
    "merge_heads",
    "pixel_shuffle",
    "pixel_unshuffle",
    "relative_position_index",
    "safe_abs",
    "safe_angle",
    "shift_mask",
    "shift_window_mask",
    "sparse_mix_weights",
    "spectral_tile_upsample",
    "split_heads",
    "tokens_to_image",
    "window_attention",
    "window_attention_core",
    "window_attention_plain",
    "window_partition",
    "window_reverse",
    "zero_stuff2x",
]
