"""Tensor parallelism (``--shard-params context``), the port's counterpart
of the JAX package's ``parallel/tensor.py``.

The JAX package annotates each kernel with a NamedSharding that splits its
output-feature axis over the ``context`` mesh axis and lets XLA's
partitioner place the gathers.  The port shards the same dim with FSDP2:
``fully_shard`` over the ``context`` dimension of the (``data``,
``context``) mesh, replicated over ``data`` (HSDP), which gathers a block's
parameters for its forward and its backward and reduce-scatters its
gradients.  FSDP2 shards dim 0: the output features of OIHW convs and of
``(out, in)`` Linears, the dim the JAX ``tp_spec_for`` names.  The
optimizer's
state is sharded alike (its tensors follow the parameters), and
``core.meshes.full_state`` / ``load_full_state`` keep the single-device
checkpoint format.
"""
from __future__ import annotations

from ..core.meshes import CONTEXT_AXIS, shard_model


def shard_params_tp(model, dp):
    """``--shard-params context``: the model's parameters sharded over the
    context dimension of ``dp``'s mesh (FSDP2), in place."""
    return shard_model(model, dp, CONTEXT_AXIS)
