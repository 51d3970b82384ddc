"""Ahead-of-time export of the serving forward (``torch.export``), the port's
counterpart of the JAX package's ``tools/export_model.py``.

- ``export_model(arch, state, ...) -> torch.export.ExportedProgram``: the
  deterministic forward (eval mode) of ``arch`` with the parameters of
  ``state`` held in the program, on ``device`` (CUDA unless ``"cpu"``).
  It takes float32 NHWC images in [-1, 1] and returns the model's output
  as float32 NHWC, as the JAX artifact does.  ``batch=None`` exports a
  symbolic batch dimension, so one program serves any batch size (height
  and width stay static: the models are built for one resolution).
- The hand-written kernels are ``torch.library`` custom ops
  (``torch.ops.uir.ln_mdta``, ``ln_gdfn``, ``ln_leff``, ``window_attn``),
  registered when the port is imported.  The exported graph holds them as
  nodes (``custom_op_counts``), so a program exported on the card runs the
  kernels; on the CPU the same nodes run the plain versions.
- ``torch.export.save(program, path)`` writes the program;
  ``load_exported(path)`` gives it back as a callable, after this module
  has imported the port (which registers the ops), so a fresh process
  finds them.

CLI:
    python -m underwater_image_restoration_torch.tools.export_model \\
        -a SpectralTransformer --weights checkpoints/<run>/best --size 256 \\
        --out model.pt2 [--batch 8] [--use-cpu]
"""
from __future__ import annotations

import argparse
import collections
import os
from typing import Optional

import torch
from torch import nn

from .. import ops  # noqa: F401  (registers the custom ops)
from ..core.config import Config, compute_dtype_of
from ..models import init_model

# the namespace of the port's custom ops
OP_NAMESPACE = "uir"
# the largest batch a symbolic-batch program is exported for
MAX_BATCH = 4096


class ServingForward(nn.Module):
    """float32 NHWC images in [-1, 1] -> the model's float32 NHWC output."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, x):
        y = self.model(x.permute(0, 3, 1, 2).contiguous())
        return y.permute(0, 2, 3, 1).float()


def export_module(model: nn.Module, size: int,
                  batch: Optional[int] = None) -> torch.export.ExportedProgram:
    """Export ``model`` (built for ``size`` x ``size`` images) as it stands:
    eval mode, its parameters frozen into the program."""
    model.eval().requires_grad_(False)
    dev = next(model.parameters()).device
    # an example batch of 2 keeps a symbolic batch from specializing on 1
    example = torch.zeros(batch or 2, size, size, 3, device=dev)
    dynamic = (None if batch else
               {"x": {0: torch.export.Dim("batch", min=1, max=MAX_BATCH)}})
    return torch.export.export(ServingForward(model), (example,),
                               dynamic_shapes=dynamic)


def export_model(arch: str, state: dict, size: int = 256,
                 batch: Optional[int] = None, use_dwt: str = "Fourier",
                 compute_dtype: torch.dtype = torch.bfloat16,
                 device=None) -> torch.export.ExportedProgram:
    """Export the deterministic forward of ``arch`` with ``state`` (a
    ``state_dict`` of the port's model) held in the program; ``batch=None``
    exports a symbolic batch dimension."""
    model = init_model(arch, device=device, compute_dtype=compute_dtype,
                       img_size=size, use_dwt=use_dwt)
    model.load_state_dict(state, strict=True)
    return export_module(model, size, batch)


def custom_op_counts(program: torch.export.ExportedProgram
                     ) -> collections.Counter:
    """Nodes of the port's custom ops in the program's graph, by op name
    (``ln_mdta``, ``ln_gdfn``, ``ln_leff``, ``window_attn``)."""
    counts = collections.Counter()
    for node in program.graph.nodes:
        if node.op == "call_function" and isinstance(
                node.target, torch._ops.OpOverload) and \
                node.target.namespace == OP_NAMESPACE:
            counts[node.target._opname] += 1
    return counts


def load_exported(path: str):
    """The program saved at ``path`` as a callable:
    ``fn(images f32 NHWC) -> f32 NHWC`` on the device it was exported on."""
    return torch.export.load(path).module()


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Export the serving forward with torch.export.")
    p.add_argument("-a", "--arch", default="SpectralTransformer")
    p.add_argument("--weights", required=True,
                   help="a checkpoint directory of the port's trainer, an "
                        ".npz of the JAX package's flat parameters or a "
                        "reference .pth (eval.load_model)")
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--batch", type=int, default=0,
                   help="0 = symbolic (any batch at serve time)")
    p.add_argument("--use-dwt", default="Fourier")
    p.add_argument("--compute-dtype", default="bfloat16",
                   choices=("bfloat16", "float32", "float16"))
    p.add_argument("--use-cpu", action="store_true",
                   help="export for the CPU (the kernels' plain versions); "
                        "the default is the CUDA device")
    p.add_argument("--out", required=True)
    a = p.parse_args(argv)

    from ..eval.evaluate import load_model

    model = load_model(a.weights, a.arch, "cpu" if a.use_cpu else None,
                       compute_dtype_of(Config(compute_dtype=a.compute_dtype)),
                       img_size=a.size, use_dwt=a.use_dwt)
    program = export_module(model, a.size, a.batch or None)
    torch.export.save(program, a.out)
    n = sum(custom_op_counts(program).values())
    print(f"wrote {a.out} ({os.path.getsize(a.out) / 1e6:.1f} MB, device="
          f"{'cpu' if a.use_cpu else 'cuda'}, batch="
          f"{'symbolic' if not a.batch else a.batch}, {n} custom-op nodes)")


if __name__ == "__main__":
    main()
