"""Data parallelism over ``torch.distributed``: the process layout, the
rank's rows of a batch, and the three places where a data-parallel step
must see the global batch.

Counterpart of ``evdeblurnerf_tpu/parallel/mesh.py``. There a 1-D device
mesh shards each ray batch on its leading axis and GSPMD inserts the
gradient psums, so a sharded step computes what one device computes on
the global batch. Here one process drives one device and every collective
is written out, so that the data-parallel step equals the one-process
step on the global batch up to the order of its sums:

* the gradients: one flat ``all_reduce`` after the accumulated backward,
  before the norms and the clip (:func:`all_reduce_gradients`);
* the random draws: inside :func:`ray_shard` every draw is made at the
  global shape from the generator all ranks share, and the rank keeps its
  rows (:func:`draw`), as a JAX draw over a sharded global array is the
  one-device draw;
* BatchNorm: inside :func:`ray_shard` a training BatchNorm normalises
  with the statistics of every rank's rows (:func:`batch_norm`), as flax
  BatchNorm over a sharded global array does.

Every loss term is a mean over the rank's rays, so the average of equal
shards is the global mean; a term normalised otherwise (the event loss's
colour weights) takes its denominator from :func:`shard_total`.

:class:`Layout` is the process grid: ``n_data`` ray shards by ``n_model``
table slices (``parallel/tp.py``), the model index minor, as in the JAX
package's 2-D mesh. Without a process group every helper is the plain
one-process path.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Layout:
    """``n_data`` x ``n_model`` ranks; rank ``r`` holds ray shard
    ``r // n_model`` and table slice ``r % n_model``. ``data_group``: the
    ranks of this rank's table slice (its gradients average there);
    ``model_group``: the ranks of its ray shard (the table slices' partial
    features sum there). None where the group has one rank."""

    n_data: int = 1
    n_model: int = 1
    rank: int = 0
    world_group: Optional[object] = None
    data_group: Optional[object] = None
    model_group: Optional[object] = None

    @property
    def world(self) -> int:
        return self.n_data * self.n_model

    @property
    def data_rank(self) -> int:
        return self.rank // self.n_model

    @property
    def model_rank(self) -> int:
        return self.rank % self.n_model


def create_layout(n_model: int = 1) -> Layout:
    """The layout of the process group (one process, no group: the plain
    path). Every rank must call it, in the same order as every other
    collective: it creates the groups."""
    if not (dist.is_available() and dist.is_initialized()):
        if n_model > 1:
            raise ValueError(
                f"--tp_model_parallel={n_model} needs {n_model} processes "
                "(one a card): launch with torchrun --nproc_per_node "
                f"{n_model} or more")
        return Layout()
    world, rank = dist.get_world_size(), dist.get_rank()
    if world % n_model:
        raise ValueError(f"--tp_model_parallel={n_model} must divide the "
                         f"number of processes ({world})")
    n_data = world // n_model
    data_group = model_group = None
    # every rank creates every group, in one order
    for m in range(n_model):
        ranks = [d * n_model + m for d in range(n_data)]
        g = dist.new_group(ranks) if n_data > 1 else None
        if rank in ranks:
            data_group = g
    for d in range(n_data):
        ranks = [d * n_model + m for m in range(n_model)]
        g = dist.new_group(ranks) if n_model > 1 else None
        if rank in ranks:
            model_group = g
    return Layout(n_data, n_model, rank,
                  dist.group.WORLD if world > 1 else None,
                  data_group, model_group)


def pad_to_multiple(n: int, k: int) -> int:
    """``n`` rounded up to a multiple of ``k``: the rays of a held-out
    render are padded to the chunk times the ray shards (ref:
    run_nerf.py:357)."""
    return -(-n // k) * k


def shard_batch(batch: Dict[str, np.ndarray], layout: Layout,
                accum: int = 1) -> Dict[str, np.ndarray]:
    """The rank's rows of a global host batch, which every rank assembled
    alike from the shared seed. With ``accum`` microbatches, of each
    microbatch the rank's share: the step cuts its rows into ``accum``
    equal slices, and slice k of every rank together is the global
    microbatch k, as the JAX step shards each microbatch over the mesh."""
    if layout.n_data == 1:
        return batch
    n, d = layout.n_data, layout.data_rank
    out = {}
    for name, v in batch.items():
        v = np.asarray(v)
        if v.shape[0] % (n * accum):
            raise ValueError(
                f"{name!r} has {v.shape[0]} rows, not a multiple of "
                f"{n} ray shards x grad_accum {accum}")
        m = v.shape[0] // (n * accum)
        out[name] = np.ascontiguousarray(
            v.reshape(accum, n, m, *v.shape[1:])[:, d].reshape(
                accum * m, *v.shape[1:]))
    return out


# (layout, segments) while a training render draws for its ray shard
_SHARD: Optional[tuple] = None


@contextlib.contextmanager
def ray_shard(layout: Layout, segments: int = 1):
    """Within: :func:`draw` and :func:`batch_norm` act for the global
    batch, of which this rank renders its rows. ``segments``: the rows
    rendered are that many global segments' shards one after the other
    (the event render's start rays, then its end rays)."""
    global _SHARD
    prev = _SHARD
    _SHARD = (layout, segments) if layout.n_data > 1 else None
    try:
        yield
    finally:
        _SHARD = prev


def draw(fn, shape, generator, device, dtype=torch.float32) -> torch.Tensor:
    """``fn(shape, generator=, device=, dtype=)`` (``torch.rand`` or
    ``torch.randn``) with rows on the first axis. Inside :func:`ray_shard`
    the draw is made at the global shape and the rank keeps its rows: what
    the one-process step draws for these rays."""
    shape = tuple(shape)
    if _SHARD is None:
        return fn(shape, generator=generator, device=device, dtype=dtype)
    layout, seg = _SHARD
    n, rows = layout.n_data, shape[0]
    full = fn((rows * n,) + shape[1:], generator=generator, device=device,
              dtype=dtype)
    return full.view(seg, n, rows // seg, *shape[1:])[:, layout.data_rank] \
        .reshape(shape)


class _AllReduce(torch.autograd.Function):
    """Sum over ``group`` in the forward (``forward_sum``) or not, and sum
    the cotangents over it in the backward (``backward_sum``) or not."""

    @staticmethod
    def forward(ctx, x, group, forward_sum, backward_sum):
        ctx.group, ctx.backward_sum = group, backward_sum
        if not forward_sum:
            return x.view_as(x)
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        if ctx.backward_sum:
            g = g.clone()
            dist.all_reduce(g, group=ctx.group)
        return g, None, None, None


def all_reduce(x: torch.Tensor, group, reduce_grad: bool) -> torch.Tensor:
    """Differentiable sum of ``x`` over ``group`` (None: ``x``). Backward:
    with ``reduce_grad`` the sum of the cotangents over the group (``x``
    is a part of every rank's loss), else the cotangent itself (every rank
    of the group holds the same loss, which reads the sum)."""
    if group is None:
        return x
    return _AllReduce.apply(x, group, True, reduce_grad)


def shared_input(x: torch.Tensor, group) -> torch.Tensor:
    """``x``, which every rank of ``group`` holds alike and reads for its
    own part of a sum: the backward sums the parts' cotangents over the
    group (the points that every table slice samples)."""
    if group is None:
        return x
    return _AllReduce.apply(x, group, False, True)


def batch_norm(bn: torch.nn.BatchNorm1d, x: torch.Tensor) -> torch.Tensor:
    """``bn(x)`` for x [N, C]. Inside :func:`ray_shard`, when training,
    with the mean and biased variance of every rank's rows (two passes,
    each one ``all_reduce``), differentiable through them, and the running
    statistics updated by the global mean and unbiased variance as
    ``BatchNorm1d`` updates them, so every rank keeps the same buffers."""
    if _SHARD is None or not bn.training:
        return bn(x)
    group = _SHARD[0].data_group
    n_local = torch.tensor([float(x.shape[0])], device=x.device)
    dist.all_reduce(n_local, group=group)
    n = float(n_local)
    mean = all_reduce(x.sum(0), group, True) / n
    xc = x - mean
    var = all_reduce((xc * xc).sum(0), group, True) / n
    with torch.no_grad():
        m = bn.momentum
        bn.running_mean.mul_(1 - m).add_(mean.detach(), alpha=m)
        bn.running_var.mul_(1 - m).add_(var.detach() * (n / (n - 1)),
                                        alpha=m)
        bn.num_batches_tracked.add_(1)
    return xc * torch.rsqrt(var + bn.eps) * bn.weight + bn.bias


def shard_total(layout: Layout):
    """For a loss normalised by a data-dependent total (a weighted mean):
    ``local total -> global total / n_data``, so that the shards' terms
    average to the global weighted mean; None without ray shards."""
    if layout.n_data == 1:
        return None

    def total(local: torch.Tensor) -> torch.Tensor:
        t = local.detach().clone()
        dist.all_reduce(t, group=layout.data_group)
        return t / layout.n_data

    return total


def _flat_all_reduce(tensors, group, scale: float) -> None:
    """Sum ``tensors`` over ``group`` through one flat buffer, in place,
    then multiply by ``scale``."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat.mul_(scale)
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


def all_reduce_gradients(params: Iterable[torch.nn.Parameter],
                         layout: Layout) -> None:
    """Turn each rank's gradients into the gradient of the global batch's
    loss: the mean over the ray shards. A replicated parameter's gradient
    is the same on every table slice of a shard, so its mean over the world
    is that mean. Under tensor parallelism (``parallel/tp.py`` tags the
    parameters) a table slice's gradient averages over its data group, and
    the basis weight's, which each slice fills in its own columns only,
    sums over the slices: the world's mean times ``n_model``. Every rank
    holds gradients for the same parameters (the lazy Adam state depends
    on it)."""
    if layout.world == 1:
        return
    world, sliced = [], []
    for p in params:
        kind = getattr(p, "tp_kind", None)
        (sliced if kind == "slice" else world).append(p)
    _flat_all_reduce([p.grad for p in world], layout.world_group,
                     1.0 / layout.world)
    if layout.n_model > 1:
        for p in world:
            if getattr(p, "tp_kind", None) == "columns":
                p.grad.mul_(layout.n_model)
    if layout.n_data > 1:
        _flat_all_reduce([p.grad for p in sliced], layout.data_group,
                         1.0 / layout.n_data)


def mean_scalars(values: Dict[str, torch.Tensor], layout: Layout
                 ) -> Dict[str, torch.Tensor]:
    """The mean over the ray shards of 0-d tensors, in one ``all_reduce``."""
    if layout.n_data == 1 or not values:
        return values
    names = list(values)
    flat = torch.stack([values[k].float() for k in names])
    dist.all_reduce(flat, group=layout.data_group)
    flat /= layout.n_data
    return dict(zip(names, flat.unbind()))


def gather_rows(local: torch.Tensor, layout: Layout) -> torch.Tensor:
    """The ray shards' ``local`` [B, n, ...] blocks put together into
    [B, n_data * n, ...], shard d at block row d: a zero-filled buffer
    summed by ``all_reduce``, since gloo has no ``all_gather`` of CUDA
    tensors."""
    if layout.n_data == 1:
        return local
    B, n = local.shape[:2]
    full = local.new_zeros((B, layout.n_data, n) + tuple(local.shape[2:]))
    full[:, layout.data_rank] = local
    dist.all_reduce(full, group=layout.data_group)
    return full.reshape((B, layout.n_data * n) + tuple(local.shape[2:]))
