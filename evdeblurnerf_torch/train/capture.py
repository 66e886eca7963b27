"""The training step as one captured program per gate key.

Counterpart of ``jitted`` in ``evdeblurnerf_tpu/train/step.py:313-383``,
which keeps one ``jax.jit(step, donate_argnums=(0,))`` program per key. On
a CUDA device :class:`CapturedStep` replays a ``torch.cuda.CUDAGraph`` of
the whole step: forward, backward, gradient norms, clip, Adam and the
repack of the voxel tables, with kernels K1-K5 launched inside it. There
is one graph per key (:func:`step_key`)::

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
graph's own tensors, overwritten by the next step.

The first step of a key runs eagerly, on the capture stream: the warm-up
that PyTorch's whole-network capture asks for, and the step that makes
the Adam state of the parameters the key trains. Torch makes that state
inside ``optimizer.step()``; made during a capture, it would be zeroed
again by every replay. The key's next step is captured and then replayed
once, so that it is neither lost nor run twice; later steps replay. The
graphs share one memory pool (each alone would hold the step's peak),
and the train state's generator is registered with each, so a replay
draws what the eager step would draw from the same generator state.
Kernel launch counts (``kernels.LAUNCHES``) move at each replay by what
the capture counted.

On the CPU the same step (device scalars, static buffers, repack in
place) runs eagerly at every call: the step the CPU tests hold against
the JAX step. Eager on the card, by rule: a process group (the step's
collectives, :func:`build_loop_step`) and ``return_grads`` (only
``build_train_step`` returns gradients); and the configurations of
:data:`EAGER`, with one logged line. A capture that fails raises.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

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


def step_key(sw: ScheduleWeights, force_naive: bool, events_active: bool,
             fine_cull: bool = False, coarse_cull: bool = False) -> tuple:
    """The graph a step replays (module docstring)."""
    return (bool(force_naive), bool(events_active), bool(fine_cull),
            bool(coarse_cull), bool(sw.skip_learn_crf),
            bool(sw.use_pts0_target))


class CudaGraph:
    """One key's CUDA graph in the shared ``pool``, captured on
    ``stream``, with ``generator``'s state registered. The capture refuses
    what cannot be captured in this thread only: the loop's prefetch
    threads go on staging batches on their own streams meanwhile."""

    def __init__(self, pool, stream, generator: torch.Generator):
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(generator)
        self.pool, self.stream = pool, stream

    def capture(self, fn):
        with torch.cuda.graph(self.graph, pool=self.pool, stream=self.stream,
                              capture_error_mode="thread_local"):
            return fn()

    def replay(self) -> None:
        self.graph.replay()


class _Captured:
    def __init__(self, graph, metrics: Dict[str, torch.Tensor],
                 launches: Dict[str, int]):
        self.graph, self.metrics, self.launches = graph, metrics, launches

    def replay(self) -> Dict[str, torch.Tensor]:
        self.graph.replay()
        kernels.add_launches(self.launches)
        return dict(self.metrics)


class CapturedStep:
    """``step(state, batch, ev_batch, sw, force_naive, events_active,
    fine_cull=False, coarse_cull=False, occ_grid=None) -> metrics``, the
    call of ``train/step.py::build_train_step``, on one train state
    (module docstring). ``graph_cls(pool, stream, generator)``: what
    captures (:class:`CudaGraph` on a card; None on the CPU, which runs
    every step eagerly; a stand-in for tests)."""

    def __init__(self, args, graph_cls=None):
        self.eager_step = build_train_step(args)
        self.update = self.eager_step.update
        self.graph_cls = graph_cls
        self.reason = eager_reason(args)
        self.graphs: Dict[tuple, _Captured] = {}
        self.warmed = set()
        self.static: Dict[str, torch.Tensor] = {}
        self.values = None          # the schedule's device scalars
        self.pool = self.stream = None

    def _setup(self, device: torch.device) -> None:
        self.values = torch.zeros(len(schedule_values(ScheduleWeights())),
                                  device=device)
        if self.reason is not None:
            print(f"[capture] eager training step, {self.reason}")
            return
        if device.type != "cuda":
            return
        self.graph_cls = self.graph_cls or CudaGraph
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)

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

    def _on_stream(self, fn):
        """``fn()`` on the capture stream, ordered after the current
        stream's work and before its next (the warm-up step)."""
        if self.stream is None:
            return fn()
        current = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            out = fn()
        current.wait_stream(self.stream)
        return out

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

        captured = self.graphs.get(key)
        if captured is None and self.graph_cls is not None \
                and key in self.warmed:
            graph = self.graph_cls(self.pool, self.stream, state.generator)
            before = dict(kernels.LAUNCHES)
            metrics = graph.capture(run)
            captured = self.graphs[key] = _Captured(
                graph, metrics, kernels.take_launches(before))
        if captured is not None:
            metrics = captured.replay()
        else:
            metrics = self._on_stream(run)
            self.warmed.add(key)
        state.step += 1
        return metrics


def build_loop_step(args, layout: mesh.Layout = mesh.Layout()):
    """The step the train loop calls: :class:`CapturedStep`, or by rule
    the eager ``build_train_step`` under a process group (its collectives
    sit inside the step). ``return_grads`` exists on the eager step
    alone: a graph frees its gradients inside the step."""
    if dist.is_available() and dist.is_initialized():
        return build_train_step(args, layout=layout)
    return CapturedStep(args)
