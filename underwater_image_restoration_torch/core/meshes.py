"""Data parallelism and parameter sharding, the port's counterpart of the
JAX package's ``core/meshes.py`` (the ``data`` axis of its mesh).

The JAX package runs one program over a ``Mesh`` and XLA's SPMD partitioner
gives its train step the semantics of one device at the global batch.  The
port runs one process a rank (``torchrun``) and reaches the same numbers
with explicit collectives:

- ``init_data_parallel(world_size, rank, backend, device)`` joins (or
  reuses) the process group and returns a ``DataParallel``: the rank, the
  world, the rank's device and a one-dimensional ``DeviceMesh`` with a
  ``data`` dimension.  Ranks read ``RANK``, ``WORLD_SIZE`` and
  ``LOCAL_RANK`` as ``torchrun`` sets them.  The backend is an argument:
  ``default_backend`` gives ``gloo`` for the CPU and for ranks that share a
  card, ``nccl`` where every rank has a card of its own.
- ``DataParallel.rows(batch, grad_accum)``: the rank's rows of the global
  batch the single-device run takes (rank r takes rows [r B/n, (r+1) B/n),
  microbatch by microbatch), so a run of n ranks is comparable to one rank.
- ``shard_model``: ``--shard-params data`` as FSDP2 (``fully_shard`` of
  every block, then of the model, over the ``data`` dimension; dim 0 of
  each parameter is sharded, the output features of OIHW convs and
  ``(out, in)`` Linears), gradients reduce-scattered.
- ``full_state`` / ``load_full_state``: a sharded model's parameters and
  optimizer state in the single-device checkpoint format, and back
  (gathered and scattered by c10d collectives, which gloo carries on CUDA
  tensors too).

``validate_parallel`` refuses what the port does not run: context and
tensor parallelism (``mesh_context`` != 1, ``shard_params='context'``: the
CP/TP slice of ROADMAP.md queue 1, item 8), and more than one rank without
a process group.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

DATA_AXIS = "data"
CONTEXT_AXIS = "context"


def _dist():
    import torch.distributed as dist

    return dist


def _env_world() -> int:
    """The world size of this process: the initialized group's, else
    ``WORLD_SIZE`` as ``torchrun`` sets it, else 1."""
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def data_parallel_size(mesh_data: int) -> int:
    """``--mesh-data`` resolved: -1 means the world size; any other value
    must equal it (one process a rank)."""
    world = _env_world()
    if mesh_data == -1:
        return world
    if mesh_data != world:
        raise ValueError(
            f"mesh_data={mesh_data}: the port runs one process a data-"
            f"parallel rank, and this process sees a world of {world}. Start "
            f"the run under torchrun: torchrun --nproc-per-node {mesh_data} "
            "-m underwater_image_restoration_torch.cli --mesh-data "
            f"{mesh_data} (data parallelism, ROADMAP.md queue 1, item 8)")
    return mesh_data


def validate_parallel(mesh_data: int, mesh_context: int,
                      shard_params: str) -> None:
    """Raise ValueError for a parallel setting the port does not run."""
    if mesh_context != 1 or shard_params == "context":
        raise ValueError(
            f"mesh_context={mesh_context}, shard_params={shard_params!r}: "
            "context and tensor parallelism are the CP/TP slice of "
            "ROADMAP.md queue 1, item 8 (a row-sharded forward needs a halo "
            "for every op across shard rows: the 3x3 taps inside ln_gdfn, "
            "ln_mdta and ln_leff, the pixel (un)shuffles, the FFT "
            "branches); the port runs mesh_context 1 and shard_params '' or "
            "'data'")
    if shard_params not in ("", DATA_AXIS):
        raise ValueError(f"shard_params={shard_params!r}: '' or 'data' "
                         "(ROADMAP.md queue 1, item 8)")
    data_parallel_size(mesh_data)
    if shard_params == DATA_AXIS and not (
            "WORLD_SIZE" in os.environ or _dist().is_initialized()):
        raise ValueError(
            "shard_params='data' shards the parameters over a process "
            "group: start the run under torchrun (torchrun --nproc-per-node "
            "N -m underwater_image_restoration_torch.cli --mesh-data N "
            "--shard-params data; ROADMAP.md queue 1, item 8)")


def default_backend(device: torch.device, world_size: int) -> str:
    """``gloo`` on the CPU and where ranks share a card (NCCL refuses two
    ranks on one device; gloo all-reduces CUDA tensors through the host),
    ``nccl`` where every rank has a card of its own."""
    if device.type != "cuda":
        return "gloo"
    return "nccl" if torch.cuda.device_count() >= world_size else "gloo"


@dataclasses.dataclass
class DataParallel:
    """A rank of the data-parallel group: ``rank`` of ``world`` on
    ``device`` over ``backend``; ``mesh`` the ``data`` DeviceMesh (None at
    world 1 without a process group)."""

    rank: int = 0
    world: int = 1
    device: torch.device = torch.device("cpu")
    backend: str = ""
    mesh: object = None

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def group(self):
        return None if self.mesh is None else self.mesh.get_group()

    def rows(self, batch: int, grad_accum: int = 1) -> np.ndarray:
        """The rank's rows of a global batch of ``batch``: microbatch i
        (rows [i B/g, (i+1) B/g)) gives rank r its rows
        [i B/g + r B/(g n), i B/g + (r+1) B/(g n)).  At grad_accum 1 that is
        rows [r B/n, (r+1) B/n)."""
        if batch % (grad_accum * self.world):
            raise ValueError(
                f"batch {batch} not divisible by grad_accum*data-parallel = "
                f"{grad_accum}*{self.world}")
        mb, per = batch // grad_accum, batch // (grad_accum * self.world)
        return np.concatenate([np.arange(i * mb + self.rank * per,
                                         i * mb + (self.rank + 1) * per)
                               for i in range(grad_accum)])

    def all_reduce_(self, tensors) -> None:
        """Sum each tensor over the ranks, in place (one collective over a
        flat buffer; nothing at world 1)."""
        tensors = list(tensors)
        if self.world == 1 or not tensors:
            return
        flat = torch.cat([t.reshape(-1) for t in tensors])
        _dist().all_reduce(flat, group=self.group)
        for t, f in zip(tensors, flat.split([t.numel() for t in tensors])):
            t.copy_(f.view_as(t))

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks (a copy)."""
        t = t.clone()
        if self.world > 1:
            _dist().all_reduce(t, group=self.group)
        return t

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` averaged over the ranks (a copy)."""
        return self.sum(t) / self.world if self.world > 1 else t

    def barrier(self) -> None:
        if self.world > 1:
            _dist().barrier(group=self.group)


def init_data_parallel(world_size: Optional[int] = None,
                       rank: Optional[int] = None,
                       backend: Optional[str] = None,
                       device=None) -> DataParallel:
    """Join the data-parallel process group and return this rank's
    ``DataParallel``.  ``world_size`` and ``rank`` default to ``WORLD_SIZE``
    and ``RANK`` (``torchrun``); ``device`` is ``"cpu"`` or CUDA (the
    default: the card ``LOCAL_RANK`` names, modulo the cards there are, so
    ranks may share one); ``backend`` must be given when a group is made
    (``default_backend``).  A group already initialized is reused; at world
    1 without one none is made.  The group meets at ``env://``
    (``MASTER_ADDR``/``MASTER_PORT``, which ``torchrun`` sets)."""
    dist = _dist()
    world = int(world_size if world_size is not None
                else os.environ.get("WORLD_SIZE", "1"))
    rk = int(rank if rank is not None else os.environ.get("RANK", "0"))
    if device is not None and torch.device(device).type == "cpu":
        dev = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            from .._device import resolve_device

            resolve_device(None)  # raises CudaUnavailableError
        local = int(os.environ.get("LOCAL_RANK", rk))
        dev = torch.device("cuda", local % torch.cuda.device_count()) \
            if device is None or torch.device(device).index is None \
            else torch.device(device)
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        if world == 1 and "MASTER_ADDR" not in os.environ:
            return DataParallel(0, 1, dev, "", None)
        if backend is None:
            raise ValueError("init_data_parallel: pass backend= (gloo for the "
                             "CPU or ranks sharing a card, nccl for a card a "
                             "rank; core.meshes.default_backend)")
        dist.init_process_group(backend, init_method="env://",
                                world_size=world, rank=rk)
    else:
        world, rk = dist.get_world_size(), dist.get_rank()
        backend = dist.get_backend()
    from torch.distributed.device_mesh import DeviceMesh

    mesh = DeviceMesh.from_group(dist.group.WORLD, dev.type,
                                 mesh_dim_names=(DATA_AXIS,))
    return DataParallel(rk, world, dev, backend, mesh)


def close_data_parallel(dp: DataParallel) -> None:
    """Leave the process group ``init_data_parallel`` joined."""
    dist = _dist()
    if dp.mesh is not None and dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# parameter sharding (FSDP2)


def _block_types():
    from ..models.ast import ASTTransformerBlock
    from ..models.new_model import DecoderBlock, EncoderBlock
    from ..models.spectral_transformer import SpectralBlock

    return (SpectralBlock, ASTTransformerBlock, EncoderBlock, DecoderBlock)


def shard_model(model: torch.nn.Module, dp: DataParallel) -> torch.nn.Module:
    """FSDP2 over the ``data`` dimension: ``fully_shard`` each block (its
    parameters gathered for its forward and its backward alone), then the
    model (the rest).  The reduce-scatter averages the gradients over the
    ranks (dividing by powers of two at 2 and 4 ranks, exactly): the train
    step scales a sharded model's losses by the world to make it their sum.
    Returns the model, sharded in place."""
    from torch.distributed.fsdp import fully_shard

    if dp.mesh is None:
        raise ValueError("shard_model needs a process group "
                         "(init_data_parallel)")
    blocks = _block_types()
    for m in list(model.modules()):
        if isinstance(m, blocks):
            fully_shard(m, mesh=dp.mesh)
    fully_shard(model, mesh=dp.mesh)
    return model


def is_sharded(params) -> bool:
    """Whether the parameters are DTensors (a sharded model's)."""
    from torch.distributed.tensor import DTensor

    return any(isinstance(p, DTensor) for p in params)


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """The whole of a DTensor sharded on dim 0 over a 1-D mesh (FSDP2's
    layout: rank r holds ``torch.chunk``'s chunk r, or nothing), by one
    ``all_gather_into_tensor`` of the chunks padded to one size; a plain
    tensor as it is.  A collective: every rank of the mesh calls it.  (The
    DTensor's own ``full_tensor`` goes through functional collectives,
    which crash over gloo on CUDA tensors.)"""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(t, DTensor):
        return t
    if tuple(t.placements) != (Shard(0),):
        raise ValueError(f"full_tensor: placements {t.placements}, not "
                         "(Shard(0),)")
    mesh = t.device_mesh
    world, n = mesh.size(), t.shape[0]
    per = -(-n // world)
    local = t.to_local()
    buf = local.new_zeros((per,) + tuple(t.shape[1:]))
    buf[:local.shape[0]] = local
    out = local.new_empty((per * world,) + tuple(t.shape[1:]))
    _dist().all_gather_into_tensor(out, buf, group=mesh.get_group())
    return out[:n]


def _chunk_of(full: torch.Tensor, like) -> torch.Tensor:
    """This rank's chunk of dim 0 of ``full`` as the DTensor ``like`` holds
    it (empty where it holds nothing), on its device."""
    mesh = like.device_mesh
    chunks = full.to(like.device, like.dtype).chunk(mesh.size(), dim=0)
    r = mesh.get_local_rank()
    return chunks[r] if r < len(chunks) else chunks[0][:0]


def full_state(model, optimizer):
    """(parameters, optimizer state) of a sharded model in the
    single-device checkpoint format: the full ``state_dict`` and
    ``ClippedOptimizer.state_dict()`` (the inner optimizer's state keyed by
    parameter index), on the CPU.  A collective: every rank calls it and
    gets them."""
    def full(v):
        return full_tensor(v).detach().cpu() if isinstance(
            v, torch.Tensor) else v

    params = {k: full(v) for k, v in model.state_dict().items()}
    inner = optimizer.inner.state_dict()
    inner["state"] = {i: {k: full(v) for k, v in st.items()}
                      for i, st in inner["state"].items()}
    return params, {"inner": inner, "clip_norm": optimizer.clip_norm}


@torch.no_grad()
def load_full_state(model, optimizer, params: dict, opt_state: dict) -> None:
    """Load a single-device checkpoint's parameters and optimizer state into
    a sharded model and its optimizer: every rank holds the full state and
    keeps its shards."""
    from torch.distributed.tensor import DTensor

    for k, v in model.state_dict().items():
        if isinstance(v, DTensor):
            v.to_local().copy_(_chunk_of(params[k], v))
        else:
            v.copy_(params[k])
    inner, saved = optimizer.inner, opt_state["inner"]
    ps = [p for g in inner.param_groups for p in g["params"]]
    inner.state.clear()
    for i, st in saved["state"].items():
        p = ps[int(i)]
        inner.state[p] = {
            k: DTensor.from_local(_chunk_of(v, p).contiguous(),
                                  p.device_mesh, p.placements,
                                  run_check=False, shape=p.shape,
                                  stride=p.stride())
            if isinstance(p, DTensor) and isinstance(v, torch.Tensor)
            and tuple(v.shape) == tuple(p.shape) else v
            for k, v in st.items()}
    for g, sg in zip(inner.param_groups, saved["param_groups"]):
        g.update({k: v for k, v in sg.items() if k != "params"})
    optimizer.clip_norm = opt_state["clip_norm"]
