"""Tensor-parallel voxel tables: each rank of a ray shard holds a slice of
every table's components.

Counterpart of ``evdeblurnerf_tpu/parallel/tp.py`` and the sampling of
``evdeblurnerf_tpu/ops/triplane.py::triplane_features_tp``. The tables
(``app_plane.{i}`` [1, C, H, W], ``app_line.{i}`` [1, C, D, 1]) and their
Adam moments are sliced on the component axis, C/k components a rank of
the model group (``mesh.Layout``); everything else is replicated. A
field's :meth:`VoxelNeRF.sample` then runs kernels K4 and K5 on the
rank's slice of every table (``fused_sample.sample_grids``), contracts the
features with the rank's columns of ``basis_mat.weight`` (the basis has no
bias; its columns are segmented per plane) and sums the partial features
over the model group: one ``all_reduce`` in the forward, whose backward
passes the cotangent on unchanged (every rank of the group holds the same
loss, which reads the sum).

What else sharding changes, here and in ``mesh.all_reduce_gradients``:

* the points: every slice samples the same points, so their gradient
  (which reaches the blur kernel through the rays) is the sum of the
  slices' parts (:meth:`TableSlice.points`);
* TV: ``tv_loss_2d``/``tv_loss_1d`` are means over a count that includes
  C, so the tables' TV is the mean of the slices' TVs, and a slice's
  gradient is 1/k of its local one (:meth:`TableSlice.mean`);
* ``basis_mat``'s gradient is filled by each slice in its own columns, so
  it sums over the model group; the MLPs' gradients are the same on every
  slice and are not summed there;
* a table's gradient norm (the clip, ``grads/*``) sums its squares over
  the model group (:func:`model_sum`);
* checkpoints keep the reference's layout: the slices and their moments
  are gathered before the primary writes (:func:`checkpoint_dict`), and a
  restore loads the whole tables, of which each rank keeps its slice.

A field whose component counts do not all divide by k warns and samples
replicated, as in the JAX package. Where the JAX package shards to hold
tables larger than one chip, this slicing is the same capacity layout;
the tables are first built whole on each rank (one generator stream, one
checkpoint format) and sliced before the first step.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from . import mesh


class TableSlice:
    """A voxel field's share of the tables on this rank: component slice
    ``index`` of ``k`` of every table, and the matching ``columns`` of
    ``basis_mat.weight``."""

    def __init__(self, comps, layout: mesh.Layout, device):
        self.k, self.index = layout.n_model, layout.model_rank
        self.group = layout.model_group
        self.comps = tuple(int(c) for c in comps)
        cols, off = [], 0
        for c in self.comps:
            w = c // self.k
            cols.append(torch.arange(off + self.index * w,
                                     off + (self.index + 1) * w))
            off += c
        self.columns = torch.cat(cols).to(device)

    def bounds(self, i: int):
        """The component range of table ``i`` on this rank."""
        w = self.comps[i] // self.k
        return self.index * w, (self.index + 1) * w

    def points(self, xyz: torch.Tensor) -> torch.Tensor:
        """The points every slice samples: their gradient is the sum of
        the slices' parts."""
        return mesh.shared_input(xyz, self.group)

    def contract(self, feats: torch.Tensor, basis: torch.Tensor
                 ) -> torch.Tensor:
        """The basis projection of the whole tables from this slice's
        features [N, sum(C)/k]: its columns, then the sum over the model
        group."""
        return mesh.all_reduce(F.linear(feats, basis[:, self.columns]),
                               self.group, reduce_grad=False)

    def mean(self, local: torch.Tensor) -> torch.Tensor:
        """The mean over the model group of a per-slice mean (the TV);
        a slice's gradient is 1/k of its local one."""
        return mesh.all_reduce(local / self.k, self.group, reduce_grad=False)


def voxel_fields(model) -> List[nn.Module]:
    """The model's voxel fields (none for ``mode=nerf``)."""
    return [f for f in (getattr(model, "mlp_coarse", None),
                        getattr(model, "mlp_fine", None))
            if f is not None and hasattr(f, "app_plane")]


def _slice_param(p: nn.Parameter, lo: int, hi: int) -> nn.Parameter:
    q = nn.Parameter(p.detach()[:, lo:hi].clone())
    q.tp_kind = "slice"
    q.tp_full = tuple(p.shape)
    q.tp_bounds = (lo, hi)
    return q


def shard_state(state, layout: mesh.Layout) -> int:
    """Slice the voxel tables of ``state.model``, and their Adam moments,
    for this rank, in place (:func:`shard_fields`)."""
    return shard_fields(voxel_fields(state.model), layout, state.optimizer)


def shard_fields(fields, layout: mesh.Layout, opt=None) -> int:
    """Slice the tables of the voxel fields ``fields`` (and their moments
    in the optimizer ``opt``) for this rank, in place; tag the sliced
    parameters (``tp_kind`` "slice") and the basis weights ("columns") for
    ``mesh.all_reduce_gradients``. Returns the number of fields sliced."""
    k = layout.n_model
    if k == 1:
        return 0
    sliced = 0
    for field in fields:
        comps = [int(p.shape[1]) for p in field.app_plane]
        if any(c % k for c in comps):
            print(f"WARNING: app_n_comp {tuple(comps)} not divisible by "
                  f"tp_model_parallel={k}; that field samples replicated")
            continue
        ts = TableSlice(comps, layout, field.basis_mat.weight.device)
        for plist in (field.app_plane, field.app_line):
            for i, p in enumerate(plist):
                q = _slice_param(p, *ts.bounds(i))
                if opt is not None:
                    _swap_in_optimizer(opt, p, q)
                plist[i] = q
        field.basis_mat.weight.tp_kind = "columns"
        field.tp = ts
        field.pack_tables()
        sliced += 1
    return sliced


def _swap_in_optimizer(opt, old: nn.Parameter, new: nn.Parameter) -> None:
    lo, hi = new.tp_bounds
    for group in opt.param_groups:
        group["params"] = [new if p is old else p for p in group["params"]]
    st = opt.state.pop(old, None)
    if st:
        opt.state[new] = {
            n: (v[:, lo:hi].clone() if torch.is_tensor(v)
                and v.shape == old.shape else v) for n, v in st.items()}


def gather(t: torch.Tensor, full_shape, bounds, group) -> torch.Tensor:
    """The whole tensor of shape ``full_shape`` from each rank's slice
    ``bounds`` of axis 1: a zero-filled buffer summed over the model group
    (gloo has no ``all_gather`` of CUDA tensors)."""
    full = t.new_zeros(full_shape)
    full[:, bounds[0]:bounds[1]] = t
    dist.all_reduce(full, group=group)
    return full


def model_sum(values: List[torch.Tensor], layout: mesh.Layout
              ) -> List[torch.Tensor]:
    """0-d tensors summed over the model group in one ``all_reduce``."""
    if layout.n_model == 1 or not values:
        return values
    flat = torch.stack(values)
    dist.all_reduce(flat, group=layout.model_group)
    return list(flat.unbind())


def checkpoint_dict(state, layout: mesh.Layout,
                    wandb_id: Optional[str] = None) -> Dict:
    """``train/checkpoint.py::checkpoint_dict`` of the whole model: the
    table slices and their Adam moments gathered into the reference's
    layout. Every rank of the model group must call it (collectives); the
    primary writes the result."""
    from ..train.checkpoint import checkpoint_dict as plain

    ckpt = plain(state, wandb_id)
    group = layout.model_group
    if group is None:
        return ckpt
    names = {p: n for n, p in state.model.named_parameters()}
    order = [p for g in state.optimizer.param_groups for p in g["params"]]
    opt_state = ckpt["optimizer_state_dict"]["state"]
    for idx, p in enumerate(order):
        if getattr(p, "tp_kind", None) != "slice":
            continue
        ckpt["network_state_dict"][names[p]] = gather(
            p.detach(), p.tp_full, p.tp_bounds, group).cpu()
        st = state.optimizer.state.get(p)
        for n, v in (st or {}).items():
            if torch.is_tensor(v) and v.shape == p.shape:
                opt_state[idx][n] = gather(v, p.tp_full, p.tp_bounds,
                                           group).cpu()
    return ckpt


def gather_grads(named_grads: Dict[str, torch.Tensor], model,
                 layout: mesh.Layout) -> Dict[str, torch.Tensor]:
    """Gradients by parameter name with the table slices' gathered into
    whole tables (a comparison against the one-process step)."""
    params = dict(model.named_parameters())
    out = {}
    for n, g in named_grads.items():
        p = params.get(n)
        if p is not None and getattr(p, "tp_kind", None) == "slice":
            g = gather(g, p.tp_full, p.tp_bounds, layout.model_group)
        out[n] = g
    return out
