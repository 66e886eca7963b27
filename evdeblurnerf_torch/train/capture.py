"""The training step and the eval renders as captured programs.

Counterpart of the JAX package's compiled programs: ``jitted`` in
``evdeblurnerf_tpu/train/step.py:313-383``, which keeps one
``jax.jit(step, donate_argnums=(0,))`` program per key, and the jitted
eval render (``evdeblurnerf_tpu/train/evaluate.py:23-55``,
``evdeblurnerf_tpu/serving.py:140``, ``evdeblurnerf_tpu/train/loop.py:451``).
On a CUDA device each replays a ``torch.cuda.CUDAGraph`` through
:class:`Programs`: one graph per key in a memory pool of its own, whose
first call of a key runs eagerly on the capture stream, whose second call
is captured and then replayed once (a capture runs nothing), and whose
later calls replay. Kernel launch counts (``kernels.LAUNCHES``) move at
each replay by what the capture counted.

**The step.** :class:`CapturedStep` replays a graph of the whole step:
forward, backward, gradient norms, clip, Adam and the repack of the voxel
tables, with kernels K1-K5 launched inside it. There is one graph per key
(:func:`step_key`)::

    (force_naive, events_active, fine_cull, coarse_cull, skip_learn_crf,
     use_pts0_target)

The first four choose what the step renders; the schedule's two booleans
choose the target of the pts0 loss and which parameters take a gradient
(the learned CRF's), and so which Adam states the step updates. The
step's float schedule values and learning rate are device scalars that
the host writes before each replay (``train/step.py::on_device``,
``train/optim.py``), the batches, the event batch and the occupancy grid
are copied into static buffers, the tables are repacked in place
(``models/voxnerf.py::repack_tables``), and the metrics come out as the
graph's own tensors, overwritten by the next step. The first step of a
key is the one that makes the Adam state of the parameters the key
trains: torch makes that state inside ``optimizer.step()``, and made
during a capture it would be zeroed again by every replay. The step's
graphs share one pool (each alone would hold the step's peak), and the
train state's generator is registered with each, so a replay draws what
the eager step would draw from the same generator state.

**The renders.** :class:`CapturedCall` replays a deterministic function
of a few input tensors and of the tensors of some modules (the eval chunk
render, ``train/evaluate.py::build_chunk_renderer``; an artifact's
program, ``serving.ExportedRenderer``; the occupancy refresh,
``train/loop.py``): the inputs are copied into static buffers, one graph
per input shape and matmul precision (a graph holds the GEMM kernels it
was captured with), and the outputs are cloned out of the graph's own
tensors, so a caller may keep them across calls. Before each replay the
host runs the call's ``refresh`` (the fields' ``refresh_tables``, which
repack in place) and compares the data pointers of the modules'
parameters and buffers with those the capture saw: if any moved, the
graph is dropped and captured again, with one logged line. Each
:class:`CapturedCall` has its own pool: its graph's outputs must not sit
in another program's temporaries, which that program's replays would
overwrite.

On the CPU the same code (device scalars, static buffers, repack in
place, clones) runs eagerly at every call: the code the CPU tests hold
against the JAX functions. Eager on the card, by rule, with one logged
line where a render is concerned: a process group (its collectives sit
inside the step and, under tensor parallelism, inside every render;
:func:`group_reason`), ``return_grads`` (only ``build_train_step``
returns gradients), a data-parallel artifact over several devices
(``serving.ExportedRenderer``), and the step configurations of
:data:`EAGER`. A capture or replay that fails raises.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .. import kernels
from ..parallel import mesh
from .step import (ScheduleWeights, build_train_step, on_device,
                   schedule_values)
from .optim import set_lr

# Configurations that run the eager step of train/step.py instead, with
# one logged line: (name, test of the flags, why). Every configuration of
# one process captures today.
EAGER: Tuple[Tuple[str, Callable, str], ...] = ()


def eager_reason(args) -> Optional[str]:
    """The :data:`EAGER` entry that ``args`` fall under, as a line."""
    for name, applies, why in EAGER:
        if applies(args):
            return f"{name}: {why}"
    return None


def group_reason() -> Optional[str]:
    """Why a program of this process runs eagerly on the card: a process
    group, whose collectives a program of one process cannot hold."""
    if dist.is_available() and dist.is_initialized():
        return ("a process group (its collectives sit inside the program; "
                "one rule for data and tensor parallelism)")
    return None


def step_key(sw: ScheduleWeights, force_naive: bool, events_active: bool,
             fine_cull: bool = False, coarse_cull: bool = False) -> tuple:
    """The graph a step replays (module docstring)."""
    return (bool(force_naive), bool(events_active), bool(fine_cull),
            bool(coarse_cull), bool(sw.skip_learn_crf),
            bool(sw.use_pts0_target))


class CudaGraph:
    """One key's CUDA graph in ``pool``, captured on ``stream``, with
    ``generator``'s state registered where one is given. The capture
    refuses what cannot be captured in this thread only: the loop's
    prefetch threads go on staging batches on their own streams
    meanwhile."""

    def __init__(self, pool, stream,
                 generator: Optional[torch.Generator] = None):
        self.graph = torch.cuda.CUDAGraph()
        if generator is not None:
            self.graph.register_generator_state(generator)
        self.pool, self.stream = pool, stream

    def capture(self, fn):
        with torch.cuda.graph(self.graph, pool=self.pool, stream=self.stream,
                              capture_error_mode="thread_local"):
            return fn()

    def replay(self) -> None:
        self.graph.replay()


class _Captured:
    def __init__(self, graph, outputs, launches: Dict[str, int]):
        self.graph, self.outputs, self.launches = graph, outputs, launches

    def replay(self):
        self.graph.replay()
        kernels.add_launches(self.launches)
        return self.outputs


class Programs:
    """Graphs by key in one memory pool (module docstring): a key's first
    call runs ``fn`` eagerly on the capture stream, its second captures
    ``fn`` and replays the graph once, later calls replay it and return
    the graph's own outputs. ``graph_cls(pool, stream, generator)`` is
    what captures: :class:`CudaGraph` once :meth:`setup` found a card;
    None on the CPU, where every call runs ``fn``; a stand-in for
    tests."""

    def __init__(self, graph_cls=None):
        self.graph_cls = graph_cls
        self.graphs: Dict[tuple, _Captured] = {}
        self.warmed = set()
        self.captures = 0
        self.pool = self.stream = None

    def setup(self, device: torch.device) -> None:
        """The pool and capture stream on a CUDA ``device``; nothing on
        another."""
        if device.type != "cuda":
            return
        self.graph_cls = self.graph_cls or CudaGraph
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)

    def _on_stream(self, fn):
        """``fn()`` on the capture stream, ordered after the current
        stream's work and before its next (the warm-up)."""
        if self.stream is None:
            return fn()
        current = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            out = fn()
        current.wait_stream(self.stream)
        return out

    def run(self, key, fn, generator: Optional[torch.Generator] = None):
        captured = self.graphs.get(key)
        if captured is None and self.graph_cls is not None \
                and key in self.warmed:
            graph = self.graph_cls(self.pool, self.stream, generator)
            before = dict(kernels.LAUNCHES)
            outputs = graph.capture(fn)
            self.captures += 1
            captured = self.graphs[key] = _Captured(
                graph, outputs, kernels.take_launches(before))
        if captured is not None:
            return captured.replay()
        out = self._on_stream(fn)
        self.warmed.add(key)
        return out


class CapturedStep:
    """``step(state, batch, ev_batch, sw, force_naive, events_active,
    fine_cull=False, coarse_cull=False, occ_grid=None) -> metrics``, the
    call of ``train/step.py::build_train_step``, on one train state
    (module docstring). ``graph_cls``: :class:`Programs`'."""

    def __init__(self, args, graph_cls=None):
        self.eager_step = build_train_step(args)
        self.update = self.eager_step.update
        self.programs = Programs(graph_cls)
        self.reason = eager_reason(args)
        self.static: Dict[str, torch.Tensor] = {}
        self.values = None          # the schedule's device scalars

    @property
    def graphs(self) -> Dict[tuple, _Captured]:
        return self.programs.graphs

    def _setup(self, device: torch.device) -> None:
        self.values = torch.zeros(len(schedule_values(ScheduleWeights())),
                                  device=device)
        if self.reason is not None:
            print(f"[capture] eager training step, {self.reason}")
            return
        self.programs.setup(device)

    def _stage(self, name: str, src: torch.Tensor) -> torch.Tensor:
        """``src`` copied into the static buffer ``name``, made at its
        first step; a graph reads its inputs there."""
        dst = self.static.get(name)
        if dst is None:
            dst = self.static[name] = torch.empty_like(src)
        elif dst.shape != src.shape or dst.dtype != src.dtype:
            raise ValueError(
                f"captured step: {name} is {tuple(src.shape)} {src.dtype}, "
                f"its static buffer {tuple(dst.shape)} {dst.dtype}")
        dst.copy_(src, non_blocking=True)
        return dst

    def _write_schedule(self, sw: ScheduleWeights) -> None:
        host = torch.tensor(schedule_values(sw), dtype=torch.float32)
        if self.values.device.type == "cuda":
            host = host.pin_memory()
        self.values.copy_(host, non_blocking=True)

    def __call__(self, state, batch, ev_batch, sw: ScheduleWeights,
                 force_naive: bool, events_active: bool,
                 fine_cull: bool = False, coarse_cull: bool = False,
                 occ_grid=None):
        if self.values is None:
            self._setup(next(state.model.parameters()).device)
        if self.reason is not None:
            return self.eager_step(state, batch, ev_batch, sw, force_naive,
                                   events_active, fine_cull, coarse_cull,
                                   occ_grid)
        key = step_key(sw, force_naive, events_active, fine_cull,
                       coarse_cull)
        b = {k: self._stage(f"batch/{k}", v) for k, v in batch.items()}
        e = None
        if events_active:
            e = {k: self._stage(f"events/{k}", v)
                 for k, v in ev_batch.items()}
        occ = self._stage("occ_grid", occ_grid) if coarse_cull else None
        self._write_schedule(sw)
        set_lr(state.optimizer, state.lr_schedule(state.step))
        dsw = on_device(sw, self.values)

        def run():
            metrics = self.update(state, b, e, dsw, force_naive,
                                  events_active, fine_cull, coarse_cull, occ)
            state.model.repack_tables()
            return metrics

        metrics = self.programs.run(key, run, state.generator)
        state.step += 1
        return dict(metrics)


def build_loop_step(args, layout: mesh.Layout = mesh.Layout()):
    """The step the train loop calls: :class:`CapturedStep`, or by rule
    the eager ``build_train_step`` under a process group (its collectives
    sit inside the step). ``return_grads`` exists on the eager step
    alone: a graph frees its gradients inside the step."""
    if group_reason() is not None:
        return build_train_step(args, layout=layout)
    return CapturedStep(args)


def _clone(out):
    if torch.is_tensor(out):
        return out.clone()
    return tuple(o.clone() for o in out)


class CapturedCall:
    """``call(*inputs) -> outputs``: ``fn(*inputs)``, a deterministic
    function (it draws nothing) of float32 ``inputs`` and of the tensors
    of ``modules``, on ``device``, replayed from one graph per input
    shape and matmul precision (``utils/precision.py``; module
    docstring); the outputs, a tensor or a tuple of them,
    are clones. ``refresh`` runs on the host before every call (the
    fields' table repack); ``reason``, when given, runs ``fn`` eagerly at
    every call and is logged once as ``name``'s; ``graph_cls``:
    :class:`Programs`'."""

    def __init__(self, fn: Callable, modules: Sequence[torch.nn.Module],
                 device, name: str, refresh: Optional[Callable] = None,
                 reason: Optional[str] = None, graph_cls=None):
        self.fn = fn
        self.modules = tuple(modules)
        self.device = torch.device(device)
        self.refresh = refresh
        self.name = name
        self.reason = reason
        self.programs = Programs(graph_cls)
        self.programs.setup(self.device)
        self.static: Dict[tuple, Tuple[torch.Tensor, ...]] = {}
        self.pointers: Dict[tuple, list] = {}
        if reason is not None:
            print(f"[capture] eager {name}, {reason}")

    @property
    def graphs(self) -> Dict[tuple, _Captured]:
        return self.programs.graphs

    def _pointers(self) -> list:
        return [t.data_ptr() for m in self.modules
                for t in (*m.parameters(), *m.buffers())]

    @torch.no_grad()
    def eager(self, *inputs):
        """``fn`` on ``inputs`` moved to the device, with no graph: the
        eager reading of the same function."""
        if self.refresh is not None:
            self.refresh()
        return self.fn(*(x.to(self.device, torch.float32) for x in inputs))

    def __call__(self, *inputs):
        if self.reason is not None:
            return self.eager(*inputs)
        # the static buffers are written in inference mode only; the
        # clones are made in the caller's mode
        with torch.inference_mode():
            out = self._run(inputs)
        return _clone(out)

    def _run(self, inputs):
        shapes = tuple(tuple(x.shape) for x in inputs)
        key = (shapes, torch.backends.cuda.matmul.fp32_precision)
        static = self.static.get(shapes)
        if static is None:
            static = self.static[shapes] = tuple(
                torch.empty(k, dtype=torch.float32, device=self.device)
                for k in shapes)
        for dst, src in zip(static, inputs):
            dst.copy_(src)
        if self.refresh is not None:
            self.refresh()
        pointers = self._pointers()
        if key in self.graphs and pointers != self.pointers[key]:
            print(f"[capture] {self.name}: weights moved since the capture "
                  f"of {key}; capturing again")
            del self.graphs[key]
        if key not in self.graphs:
            self.pointers[key] = pointers
        return self.programs.run(key, lambda: self.fn(*static))

    def warm(self, *inputs) -> None:
        """Bring ``inputs``' shape to a held graph: the eager first call
        and the capture (one call on the CPU or under ``reason``)."""
        self(*inputs)
        if self.programs.graph_cls is not None and self.reason is None:
            self(*inputs)

