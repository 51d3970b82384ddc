"""Context and tensor parallelism of the port, counterparts of the JAX
package's ``parallel/``: the row-sharded (``context``) forward of the
window-attention models (AST and the New* family; halo exchanges, the
distributed FFT, the rank's windows), and ``--shard-params context``
(FSDP2 over the ``context`` dimension).  Data parallelism lives in
``core/meshes.py`` and ``train/trainer.py``."""
from .context import (
    cp_roll2d,
    cp_shift_roll,
    cp_unshift_roll,
    cp_window_attention,
    cp_window_attention_qkv,
    gather_replicated,
    gather_rows,
    halo_exchange,
    halo_rows,
    sharded_fft2,
    sharded_ifft2,
    slice_rows,
    ulysses_window_attention,
)
from .tensor import shard_params_tp

__all__ = [
    "cp_roll2d",
    "cp_shift_roll",
    "cp_unshift_roll",
    "cp_window_attention",
    "cp_window_attention_qkv",
    "gather_replicated",
    "gather_rows",
    "halo_exchange",
    "halo_rows",
    "shard_params_tp",
    "sharded_fft2",
    "sharded_ifft2",
    "slice_rows",
    "ulysses_window_attention",
]
