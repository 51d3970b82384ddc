"""Data, context and tensor parallelism, the port's counterpart of the JAX
package's ``core/meshes.py`` (its ``("data", "context")`` mesh).

The JAX package runs one program over a ``Mesh`` and XLA's SPMD partitioner
gives its train step the semantics of one device at the global batch.  The
port runs one process a rank (``torchrun``) and reaches the same numbers
with explicit collectives:

- ``init_data_parallel(world_size, rank, backend, device, mesh_context)``
  joins (or reuses) the process group and returns a ``DataParallel``: the
  rank's data index and the data-parallel size, its device and a
  ``DeviceMesh``, one-dimensional (``data``) or, with ``mesh_context`` > 1,
  two-dimensional (``data``, ``context``), and its ``ContextParallel``
  (context index, size and group).  World rank r has data index
  ``r // n_ctx`` and context index ``r % n_ctx`` (the JAX ``make_mesh``'s
  row-major layout).  Ranks read ``RANK``, ``WORLD_SIZE`` and
  ``LOCAL_RANK`` as ``torchrun`` sets them.  The backend is an argument:
  ``default_backend`` gives ``gloo`` for the CPU and for ranks that share a
  card, ``nccl`` where every rank has a card of its own.
- ``DataParallel.rows(batch, grad_accum)``: the rows of the global batch
  that the rank's data index takes (data index d of n takes rows
  [d B/n, (d+1) B/n), microbatch by microbatch), so a run of n data ranks
  is comparable to one rank; the context ranks of one data index take the
  same rows, and each keeps its band of the images' rows
  (``ContextParallel.band``, rows [c H/n_ctx, (c+1) H/n_ctx)).
- ``shard_model``: ``--shard-params data`` or ``context`` as FSDP2
  (``fully_shard`` of every block, then of the model, over that dimension
  of the mesh, replicated over the other (HSDP); dim 0 of each parameter
  is sharded, the output features of OIHW convs and ``(out, in)``
  Linears, the dim the JAX ``tp_spec_for`` shards), gradients
  reduce-scattered.
- ``full_state`` / ``load_full_state``: a sharded model's parameters and
  optimizer state in the single-device checkpoint format, and back
  (gathered and scattered by c10d collectives, which gloo carries on CUDA
  tensors too).
- The collectives of ``DataParallel`` (``all_reduce_``, ``sum``, ``mean``:
  every collective of a data-parallel step with replicated parameters)
  go through one place that two hooks of the rank's ``DataParallel``
  consult: ``record_collectives()`` records each one's kind, dtype and
  size in order (the step's "tape"), and inside ``cut_collectives(cut)``
  each one calls ``cut(kind, tensor, group)`` instead of running, so that
  a CUDA graph capture can end before it and run it eagerly between two
  replays (``train/dispatch.py SegmentedSteps``, which runs it with
  ``all_reduce``).

``validate_parallel`` refuses what the port does not run: an image side
that ``mesh_context`` does not divide, a SpectralTransformer side that is
not a multiple of 8 or leaves a rank fewer rows than LN+MDTA's halo, and
more than one rank without a process group.  Context parallelism runs
every arch (``CONTEXT_ARCHS``): SpectralTransformer, the AST and the New*
family.
"""
from __future__ import annotations

import contextlib
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


def parallel_sizes(mesh_data: int, mesh_context: int = 1):
    """(data-parallel size, context-parallel size) of ``--mesh-data`` and
    ``--mesh-context``: mesh_data -1 means the world size over
    mesh_context; their product must be the world size (one process a
    rank)."""
    world = _env_world()
    if mesh_context < 1:
        raise ValueError(f"mesh_context={mesh_context}: 1 or more")
    n_data = world // mesh_context if mesh_data == -1 else mesh_data
    if n_data * mesh_context != world:
        n = max(1, n_data) * mesh_context
        raise ValueError(
            f"mesh_data={mesh_data}, mesh_context={mesh_context}: the port "
            f"runs one process a rank, and this process sees a world of "
            f"{world}. Start the run under torchrun: torchrun "
            f"--nproc-per-node {n} -m underwater_image_restoration_torch.cli "
            f"--mesh-data {max(1, n_data)} --mesh-context {mesh_context} "
            "(ROADMAP.md queue 1, item 8)")
    return n_data, mesh_context


# the archs whose forward runs row-sharded (``--mesh-context`` > 1)
CONTEXT_ARCHS = ("SpectralTransformer", "AST", "NewModel", "NewBigModel",
                 "NewBigFRFNModel")
# rows of each neighbouring rank's that SpectralTransformer's LN+MDTA reads
# on a band (ops.fused_mdta.MDTA_HALO): a band needs at least as many
SPECTRAL_MIN_ROWS = 2


def validate_parallel(mesh_data: int, mesh_context: int, shard_params: str,
                      arch: Optional[str] = None,
                      image_size: Optional[int] = None) -> None:
    """Raise ValueError for a parallel setting the port does not run."""
    if mesh_context > 1 and arch is not None and arch not in CONTEXT_ARCHS:
        raise ValueError(
            f"mesh_context={mesh_context}: {arch} has no row-sharded "
            f"forward; context parallelism runs {', '.join(CONTEXT_ARCHS)}")
    if mesh_context > 1 and image_size is not None and \
            image_size % mesh_context:
        raise ValueError(
            f"image_size={image_size} not divisible by context-parallel size "
            f"{mesh_context}")
    if mesh_context > 1 and image_size is not None and \
            arch == "SpectralTransformer":
        if image_size % 8:
            raise ValueError(
                f"image_size={image_size}: SpectralTransformer halves the "
                "map three times (its DownSamples), so its side is a "
                "multiple of 8")
        if image_size // mesh_context < SPECTRAL_MIN_ROWS:
            raise ValueError(
                f"image_size={image_size} over context-parallel size "
                f"{mesh_context} gives bands of "
                f"{image_size // mesh_context} row: too few rows a rank for "
                f"SpectralTransformer's LN+MDTA halo of {SPECTRAL_MIN_ROWS} "
                "rows, so no level would run on bands")
    if shard_params not in ("", DATA_AXIS, CONTEXT_AXIS):
        raise ValueError(f"shard_params={shard_params!r}: '', 'data' or "
                         "'context' (ROADMAP.md queue 1, item 8)")
    parallel_sizes(mesh_data, mesh_context)
    if shard_params and not (
            "WORLD_SIZE" in os.environ or _dist().is_initialized()):
        raise ValueError(
            f"shard_params={shard_params!r} shards the parameters over a "
            "process group: start the run under torchrun (torchrun "
            "--nproc-per-node N -m underwater_image_restoration_torch.cli "
            "--mesh-data N --shard-params data, or --mesh-context N "
            "--shard-params context; ROADMAP.md queue 1, item 8)")


def default_backend(device: torch.device, world_size: int) -> str:
    """``gloo`` on the CPU and where ranks share a card (NCCL refuses two
    ranks on one device; gloo all-reduces CUDA tensors through the host),
    ``nccl`` where every rank has a card of its own."""
    if device.type != "cuda":
        return "gloo"
    return "nccl" if torch.cuda.device_count() >= world_size else "gloo"


def all_reduce(tensor: torch.Tensor, group=None) -> None:
    """Sum ``tensor`` over the ranks of ``group`` (None: every rank), in
    place: the collective a cut stands for."""
    _dist().all_reduce(tensor, group=group)


def all_reduce_max(tensor: torch.Tensor) -> None:
    """The element-wise maximum of ``tensor`` over every rank, in place."""
    dist = _dist()
    dist.all_reduce(tensor, op=dist.ReduceOp.MAX)


@dataclasses.dataclass
class ContextParallel:
    """A rank's place on the ``context`` dimension: ``index`` of the
    ``size`` ranks that hold row bands of the same images, their process
    ``group`` (None at size 1).  Rank ``index`` holds rows
    [index H/size, (index+1) H/size) of a map of H rows."""

    index: int = 0
    size: int = 1
    group: object = None

    def band(self, rows: int) -> slice:
        """The rank's rows of ``rows`` (which ``size`` divides)."""
        if rows % self.size:
            raise ValueError(f"{rows} rows not divisible by the context-"
                             f"parallel size {self.size}")
        per = rows // self.size
        return slice(self.index * per, (self.index + 1) * per)


@dataclasses.dataclass
class DataParallel:
    """A rank of the parallel run: data index ``rank`` of ``world`` data
    indices on ``device`` over ``backend``; ``mesh`` the DeviceMesh, ``data``
    or (``data``, ``context``) (None at one rank without a process group);
    ``cp`` the rank's place on the ``context`` dimension."""

    rank: int = 0
    world: int = 1
    device: torch.device = torch.device("cpu")
    backend: str = ""
    mesh: object = None
    cp: ContextParallel = dataclasses.field(default_factory=ContextParallel)
    # the hooks of the collectives: the tape being recorded (a list) and the
    # cut of a capture in progress (a callable), or None
    _tape: Optional[list] = dataclasses.field(default=None, init=False,
                                              repr=False, compare=False)
    _cut: object = dataclasses.field(default=None, init=False, repr=False,
                                     compare=False)

    @property
    def ranks(self) -> int:
        """Processes of the run (data indices times context ranks)."""
        return self.world * self.cp.size

    @property
    def is_main(self) -> bool:
        return self.rank == 0 and self.cp.index == 0

    @property
    def data_mesh(self):
        """The ``data`` dimension of the mesh (None without one)."""
        if self.mesh is None or self.mesh.ndim == 1:
            return self.mesh
        return self.mesh[DATA_AXIS]

    @property
    def group(self):
        """The process group of the rank's data dimension (the ranks of its
        context index)."""
        return None if self.mesh is None else self.data_mesh.get_group()

    def rows(self, batch: int, grad_accum: int = 1) -> np.ndarray:
        """The rows of a global batch of ``batch`` that the rank's data index
        takes (its context ranks take the same): microbatch i (rows
        [i B/g, (i+1) B/g)) gives data index d its rows
        [i B/g + d B/(g n), i B/g + (d+1) B/(g n)).  At grad_accum 1 that is
        rows [d B/n, (d+1) B/n)."""
        if batch % (grad_accum * self.world):
            raise ValueError(
                f"batch {batch} not divisible by grad_accum*data-parallel = "
                f"{grad_accum}*{self.world}")
        mb, per = batch // grad_accum, batch // (grad_accum * self.world)
        return np.concatenate([np.arange(i * mb + self.rank * per,
                                         i * mb + (self.rank + 1) * per)
                               for i in range(grad_accum)])

    def all_reduce_(self, tensors) -> None:
        """Sum each tensor over every rank of the run (the data and the
        context dimension), in place (one collective over a flat buffer;
        nothing at one rank)."""
        tensors = list(tensors)
        if self.ranks == 1 or not tensors:
            return
        flat = torch.cat([t.reshape(-1) for t in tensors])
        self._all_reduce("all_reduce_", flat, None)
        for t, f in zip(tensors, flat.split([t.numel() for t in tensors])):
            t.copy_(f.view_as(t))

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the data indices (a copy)."""
        return self._summed("sum", t)

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` averaged over the data indices (a copy)."""
        return self._summed("mean", t) / self.world if self.world > 1 else t

    def _summed(self, kind: str, t: torch.Tensor) -> torch.Tensor:
        t = t.clone()
        if self.world > 1:
            self._all_reduce(kind, t, self.group)
        return t

    def _all_reduce(self, kind: str, t: torch.Tensor, group) -> None:
        """The one place the collectives pass: recorded on a tape, cut
        from a capture, else run."""
        if self._tape is not None:
            self._tape.append((kind, str(t.dtype).removeprefix("torch."),
                               t.numel()))
        if self._cut is not None:
            self._cut(kind, t, group)
        else:
            all_reduce(t, group)

    @contextlib.contextmanager
    def record_collectives(self):
        """Inside, each collective of this rank's steps appends (kind,
        dtype, numel) to the list this yields, in the order they are
        issued: kind ``all_reduce_`` (the gradients' flat sum), ``sum``
        (the metrics) or ``mean`` (the Adaptive losses' batch means)."""
        prev, self._tape = self._tape, []
        try:
            yield self._tape
        finally:
            self._tape = prev

    @contextlib.contextmanager
    def cut_collectives(self, cut):
        """Inside, each collective of this rank's steps calls ``cut(kind,
        tensor, group)`` in place of the all-reduce of ``tensor`` (in
        place, over ``group``), which the caller runs later
        (``all_reduce``)."""
        prev, self._cut = self._cut, cut
        try:
            yield
        finally:
            self._cut = prev

    def barrier(self) -> None:
        if self.ranks > 1:
            _dist().barrier()


def init_data_parallel(world_size: Optional[int] = None,
                       rank: Optional[int] = None,
                       backend: Optional[str] = None,
                       device=None, mesh_context: int = 1) -> DataParallel:
    """Join the process group and return this rank's ``DataParallel``.
    ``world_size`` and ``rank`` default to ``WORLD_SIZE`` and ``RANK``
    (``torchrun``); ``device`` is ``"cpu"`` or CUDA (the default: the card
    ``LOCAL_RANK`` names, modulo the cards there are, so ranks may share
    one); ``backend`` must be given when a group is made
    (``default_backend``).  ``mesh_context`` ranks share each data index
    (world rank r: data index r // mesh_context, context index
    r % mesh_context).  A group already initialized is reused; at world 1
    without one none is made.  The group meets at ``env://``
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
    if world % mesh_context:
        raise ValueError(f"mesh_context={mesh_context} does not divide the "
                         f"world of {world}")
    from torch.distributed.device_mesh import DeviceMesh

    n_data = world // mesh_context
    if mesh_context == 1:
        mesh = DeviceMesh.from_group(dist.group.WORLD, dev.type,
                                     mesh_dim_names=(DATA_AXIS,))
        cp = ContextParallel()
    else:
        mesh = DeviceMesh(dev.type, torch.arange(world).reshape(
            n_data, mesh_context), mesh_dim_names=(DATA_AXIS, CONTEXT_AXIS))
        cp = ContextParallel(rk % mesh_context, mesh_context,
                             mesh[CONTEXT_AXIS].get_group())
    return DataParallel(rk // mesh_context, n_data, dev, backend, mesh, cp)


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


def _shard_mesh(dp: DataParallel, axis: str):
    """The DeviceMesh FSDP2 shards ``axis`` over: one dimension where the
    other has one rank, else two (the other replicated first, HSDP)."""
    if dp.mesh is None:
        raise ValueError("shard_model needs a process group "
                         "(init_data_parallel)")
    if dp.mesh.ndim == 1:
        if axis != DATA_AXIS:
            raise ValueError(f"shard_model: axis {axis!r} needs "
                             "mesh_context > 1")
        return dp.mesh
    if axis == CONTEXT_AXIS:
        return dp.mesh if dp.world > 1 else dp.mesh[CONTEXT_AXIS]
    if dp.world == 1 or dp.cp.size == 1:
        return dp.mesh[DATA_AXIS]
    from torch.distributed.device_mesh import DeviceMesh

    ranks = torch.arange(dp.ranks).reshape(dp.world, dp.cp.size)
    return DeviceMesh(dp.device.type, ranks.t().contiguous(),
                      mesh_dim_names=(CONTEXT_AXIS, DATA_AXIS))


def shard_model(model: torch.nn.Module, dp: DataParallel,
                axis: str = DATA_AXIS) -> torch.nn.Module:
    """FSDP2 over the ``axis`` dimension (``data`` or ``context``),
    replicated over the other: ``fully_shard`` each block (its parameters
    gathered for its forward and its backward alone), then the model (the
    rest).  The reduce-scatter (and HSDP's all-reduce) averages the
    gradients over every rank (dividing by powers of two at 2 and 4 ranks,
    exactly; gloo refuses the pre-multiplied sum a divide factor of 1
    would take): the train step scales a sharded model's losses by the
    ranks to make it their sum.  Returns the model, sharded in place."""
    from torch.distributed.fsdp import fully_shard

    mesh = _shard_mesh(dp, axis)
    blocks = _block_types()
    for m in list(model.modules()):
        if isinstance(m, blocks):
            fully_shard(m, mesh=mesh)
    fully_shard(model, mesh=mesh)
    return model


def is_sharded(params) -> bool:
    """Whether the parameters are DTensors (a sharded model's)."""
    from torch.distributed.tensor import DTensor

    return any(isinstance(p, DTensor) for p in params)


def shard_dim(t) -> int:
    """The mesh dimension over which the DTensor ``t`` is sharded on its
    dim 0 (FSDP2's layout: ``(Shard(0),)``, or ``(Replicate(), Shard(0))``
    under HSDP)."""
    from torch.distributed.tensor import Replicate, Shard

    dims = [i for i, p in enumerate(t.placements) if p == Shard(0)]
    if len(dims) != 1 or any(p != Replicate() for i, p in
                             enumerate(t.placements) if i != dims[0]):
        raise ValueError(f"placements {t.placements}: one Shard(0), the "
                         "rest Replicate()")
    return dims[0]


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """The whole of a DTensor sharded on dim 0 over one dimension of its
    mesh (FSDP2's layout: rank r of that dimension holds ``torch.chunk``'s
    chunk r, or nothing), by one ``all_gather_into_tensor`` of the chunks
    padded to one size over that dimension's group; a plain tensor as it
    is.  A collective: every rank of the mesh calls it.  (The DTensor's own
    ``full_tensor`` goes through functional collectives, which crash over
    gloo on CUDA tensors.)"""
    from torch.distributed.tensor import DTensor

    if not isinstance(t, DTensor):
        return t
    dim = shard_dim(t)
    mesh = t.device_mesh
    world, n = mesh.size(dim), t.shape[0]
    per = -(-n // world)
    local = t.to_local()
    buf = local.new_zeros((per,) + tuple(t.shape[1:]))
    buf[:local.shape[0]] = local
    out = local.new_empty((per * world,) + tuple(t.shape[1:]))
    _dist().all_gather_into_tensor(out, buf, group=mesh.get_group(dim))
    return out[:n]


def _chunk_of(full: torch.Tensor, like) -> torch.Tensor:
    """This rank's chunk of dim 0 of ``full`` as the DTensor ``like`` holds
    it (empty where it holds nothing), on its device."""
    dim = shard_dim(like)
    mesh = like.device_mesh
    chunks = full.to(like.device, like.dtype).chunk(mesh.size(dim), dim=0)
    r = mesh.get_local_rank(dim)
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
