"""The K-step dispatch, the counterpart of the JAX package's
``make_train_step(k_steps=K)`` (a ``lax.scan`` of K optimizer steps in one
jitted call): one call of the train step runs the steps of a group of
stacked batches, (n, B, H, W, 3) uint8, and returns each metric stacked
(n,) on the device.

On CUDA (``GraphedSteps``) the group crosses to the card once, as uint8,
from pinned memory without waiting for the card, so the host issues a
call while the card still runs the last one.  The first call runs its steps eagerly on a side stream: real steps, which
also build the kernels, run their one-time setup, create the optimizer's
state and pick cuDNN's algorithms and cuFFT's plans.  Then one CUDA graph
of one whole step (normalize, forward, loss, backward with the
``grad_accum`` microbatches unrolled, clip, update) is captured from
static uint8 batch buffers on that stream, and every later step is a copy
of its batch into the buffers, a replay and a copy of the metrics into its
slot: no Python of the model runs between replays.  The graph's memory is
one step's, whatever K.  Capture changes no training state: the optimizer
must be capturable (``get_optimizer(..., capturable=True)``: Adam's step
count on the device), the DropPath generator is registered with the graph,
so that each replay draws what an eager step would and leaves the
generator where it would, and the parameters are updated in place, so the
captured weight prep reads them again at each replay.  The learning rate
and the other hyperparameters are Python numbers baked in at capture: the
step captures again when ``optimizer.hyperparameters()`` changes (one
capture per learning rate of the schedule).  A capture that fails raises;
nothing falls back to eager steps.

Over data-parallel ranks with replicated parameters
(``SegmentedSteps``) the step issues collectives, which a CUDA graph
cannot hold over gloo (ranks sharing a card: gloo carries a CUDA tensor
through the host).  Every one of them is a ``core.meshes.DataParallel``
all-reduce on the issuing thread, outside autograd's engine: the
gradients' flat sum after the backward, the metrics' sum and, for the
Adaptive losses, the batch mean of each microbatch's detached losses
inside the loss.  The step is captured as n + 1 graphs around its n
collectives (``DataParallel.cut_collectives``: a collective ends the graph
being captured and begins the next), all in one memory pool, the tensors
that cross a cut held by the dispatcher; a replay is the graphs in turn,
each collective run eagerly between two of them on the stream they replay
on.  The first call records the collectives' tape (kind, dtype, size, in
order) and checks that every rank issued the same; each capture must cut
at that tape, else it raises.  A capture issues no collective, so the
ranks issue the same collectives whichever captures when.  A gloo
collective on a CUDA tensor waits on the host for the graph before it, so
the host does not run ahead of the card there.  NCCL (a card a rank) takes
the same route.

On the CPU, and where collectives run inside autograd's backward (FSDP2's
reduce-scatter hooks, the context ranks' Functions, the clip's sum of
sharded norms), the steps run one after another (``stepwise``): on the
CPU the plain version of the graph, as the plain ops are the kernels'.
``route(device, parallel, sharded)`` says which a step takes.
"""
from __future__ import annotations

import time
import zlib

import numpy as np
import torch

from ..core import meshes
from ..ops.droppath import RankDraws


def normalize_u8(u8):
    """uint8 -> f32 in [-1, 1]: u8 / 255 * 2 - 1 (the JAX formula)."""
    return u8.float() / 255.0 * 2.0 - 1.0


def nchw(u8):
    """uint8 NHWC on the device -> normalized f32 NCHW."""
    return normalize_u8(u8).permute(0, 3, 1, 2).contiguous()


def on_device(u8, device):
    """uint8, numpy or tensor, on ``device`` (one copy)."""
    return torch.as_tensor(np.ascontiguousarray(u8)).to(device)


def group_on_device(u8, device):
    """uint8 host batches on ``device``: staged in pinned memory and copied
    without a host synchronisation (tensors already on ``device`` stay)."""
    t = (u8 if torch.is_tensor(u8) else torch.as_tensor(
        np.ascontiguousarray(u8)))
    if t.device.type == "cpu":
        t = t.contiguous().pin_memory()
    return t.to(device, non_blocking=True)


def route(device, parallel=None, sharded: bool = False) -> str:
    """How the K steps of a call run on ``device`` for a step over
    ``parallel`` (``core.meshes.DataParallel``, or None for one rank) with
    parameters ``sharded`` or not: ``graph`` (one CUDA graph of the step),
    ``segments`` (CUDA graphs cut at the step's collectives: data ranks
    with replicated parameters) or ``stepwise`` (one after another: the
    CPU, FSDP2, context ranks)."""
    if torch.device(device).type != "cuda" or sharded or (
            parallel is not None and parallel.cp.size > 1):
        return "stepwise"
    return "graph" if parallel is None or parallel.ranks == 1 else "segments"


def stepwise(step):
    """``steps(raw_k, ref_k)``: ``step`` on each batch of the group in
    turn, its metrics stacked (n,)."""

    def steps(raw_k, ref_k):
        ms = [step(raw, ref) for raw, ref in zip(raw_k, ref_k)]
        return {k: torch.stack([m[k] for m in ms]) for k in ms[0]}

    steps.route = "stepwise"
    return steps


def describe(steps) -> str:
    """One line on how the K-step dispatch ran: its route, and the
    captures of a graphed one."""
    if steps.route == "stepwise":
        return ("the steps of a call ran one after another (route "
                "stepwise: the CPU, sharded parameters or context ranks)")
    return (f"{steps.captures} CUDA graph captures of the train step (one a "
            f"learning rate; route {steps.route}, {steps.segments} graphs a "
            f"step), {sum(steps.capture_seconds):.2f} s")


class GraphedSteps:
    """``steps(raw_k, ref_k) -> {name: (n,) f32}`` on CUDA: n optimizer
    steps of ``run(x, y)`` (one step from normalized NCHW batches on the
    device, its metrics as 0-dim tensors), eager in the first call, then
    as replays of one CUDA graph of the step.  ``captures`` counts the
    captures and ``capture_seconds`` holds each one's host time;
    ``segments`` is the graphs a step (one)."""

    route = "graph"
    segments = 1

    def __init__(self, run, optimizer, params, generator, device):
        self.run, self.optimizer, self.params = run, optimizer, params
        self.device = device
        if isinstance(generator, RankDraws):
            generator = generator.generator
        self.generators = ([generator] if isinstance(generator,
                                                     torch.Generator)
                           and generator.device.type == "cuda" else [])
        self.stream = torch.cuda.Stream(device)
        self.raw = self.ref = None  # the static batch buffers
        self.keys = None
        self.warm = False
        self.graph = self.metrics = self.captured_for = None
        self.captures = 0
        self.capture_seconds = []

    def _step(self):
        """One step from the static buffers: the metrics stacked in
        ``keys`` order."""
        m = self.run(nchw(self.raw), nchw(self.ref))
        self.keys = self.keys or tuple(m)
        return torch.stack([m[k] for k in self.keys])

    def _capture(self):
        self.graph = self.metrics = None  # the last graph's pool goes
        for p in self.params:
            p.grad = None
        graph = torch.cuda.CUDAGraph()
        for g in self.generators:
            graph.register_generator_state(g)
        t = time.perf_counter()
        with torch.cuda.graph(graph, stream=self.stream):
            metrics = self._step()
        torch.cuda.synchronize(self.device)
        self.capture_seconds.append(time.perf_counter() - t)
        self.graph, self.metrics = graph, metrics
        self.captured_for = self.optimizer.hyperparameters()
        self.captures += 1

    def replay(self):
        """One step from the static buffers: the metrics land in
        ``metrics``."""
        self.graph.replay()

    def __call__(self, raw_k, ref_k):
        raw_k, ref_k = (group_on_device(raw_k, self.device),
                        group_on_device(ref_k, self.device))
        if self.raw is None:
            self.raw, self.ref = (torch.empty_like(raw_k[0]),
                                  torch.empty_like(ref_k[0]))
        if raw_k.shape[1:] != self.raw.shape or \
                ref_k.shape[1:] != self.ref.shape:
            raise ValueError(
                f"the train step's CUDA graph takes batches of shape "
                f"{tuple(self.raw.shape)}, got {tuple(raw_k.shape[1:])} and "
                f"{tuple(ref_k.shape[1:])}")
        n = raw_k.shape[0]
        if not self.warm:  # the eager steps before the capture
            cur = torch.cuda.current_stream(self.device)
            self.stream.wait_stream(cur)
            with torch.cuda.stream(self.stream):
                rows = []
                for j in range(n):
                    self.raw.copy_(raw_k[j])
                    self.ref.copy_(ref_k[j])
                    rows.append(self._step())
                out = torch.stack(rows, 1)
            cur.wait_stream(self.stream)
            out.record_stream(cur)
            self.warm = True
            return dict(zip(self.keys, out))
        if self.graph is None or \
                self.optimizer.hyperparameters() != self.captured_for:
            self._capture()
        out = torch.empty((len(self.keys), n), device=self.device)
        for j in range(n):
            self.raw.copy_(raw_k[j])
            self.ref.copy_(ref_k[j])
            self.replay()
            out[:, j].copy_(self.metrics)
        return dict(zip(self.keys, out))


class SegmentedSteps(GraphedSteps):
    """``GraphedSteps`` of a data-parallel step with replicated parameters
    over ``parallel`` (the rank's ``core.meshes.DataParallel``, whose
    collectives the step issues): the step is captured as ``segments``
    graphs, one more than its collectives, and a replay runs each
    collective eagerly between two graphs.  ``tape`` is the collectives of
    a step, (kind, dtype, numel) in order, as the first call's first step
    issued them."""

    route = "segments"

    def __init__(self, run, optimizer, params, generator, device, parallel):
        super().__init__(run, optimizer, params, generator, device)
        self.parallel = parallel
        self.tape = None
        self.graphs, self.cuts = [], []
        self.segments = 0

    def _step(self):
        if self.tape is not None:
            return super()._step()
        with self.parallel.record_collectives() as tape:
            metrics = super()._step()
        self.tape = tape
        # every rank must cut at the same collectives: one more collective,
        # on the first call, compares the ranks' tapes
        digest = zlib.crc32(repr(self.tape).encode())
        both = torch.tensor([digest, -digest], dtype=torch.int64,
                            device=self.device)
        meshes.all_reduce_max(both)
        if both.tolist() != [digest, -digest]:
            raise RuntimeError(
                f"the ranks' train steps issue different collectives; this "
                f"rank's: {self.tape}")
        return metrics

    def _capture(self):
        self.graph = self.metrics = None  # the last graphs' pool goes
        self.graphs, self.cuts = [], []
        for p in self.params:
            p.grad = None
        pool = torch.cuda.graph_pool_handle()

        def begin():
            graph = torch.cuda.CUDAGraph()
            for g in self.generators:
                graph.register_generator_state(g)
            graph.capture_begin(pool=pool)
            self.graphs.append(graph)

        def cut(kind, tensor, group):
            self.graphs[-1].capture_end()
            self.cuts.append((kind, tensor, group))
            begin()

        torch.cuda.synchronize(self.device)
        t = time.perf_counter()
        with torch.cuda.stream(self.stream):
            begin()
            try:
                with self.parallel.record_collectives() as tape, \
                        self.parallel.cut_collectives(cut):
                    metrics = self._step()
            finally:
                self.graphs[-1].capture_end()
        torch.cuda.synchronize(self.device)
        self.capture_seconds.append(time.perf_counter() - t)
        if tape != self.tape:
            raise RuntimeError(
                f"the captured step cut at the collectives {tape}, the first "
                f"call's step issued {self.tape}")
        self.graph, self.metrics = self.graphs[0], metrics
        self.segments = len(self.graphs)
        self.captured_for = self.optimizer.hyperparameters()
        self.captures += 1

    def replay(self):
        for graph, cut in zip(self.graphs, self.cuts + [None]):
            graph.replay()
            if cut is not None:
                meshes.all_reduce(cut[1], cut[2])
