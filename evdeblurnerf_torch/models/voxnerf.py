"""PDRF coarse-to-fine voxel fields (mode=c2f): eval and training forward.

Counterpart of ``evdeblurnerf_tpu/models/voxnerf.py`` (ref:
networks/pdrf/voxnerf.py): TensoRF-style factored tri-plane/line
appearance grids plus small sigma/color MLPs, with the two heads

* CRR (``composite_feature=True``): composite the geometry features over
  the ray, then run the color MLP once per ray;
* FVR (``composite_feature=False``): per-sample color, then composite.

Parameters carry the reference's names and layouts (``app_plane.{i}``
[1, C, H, W], ``app_line.{i}`` [1, C, D, 1], ``basis_mat``,
``sigma_net.{l}``, ``color_net.{l}``), so a reference
``network_state_dict`` loads strictly. The grids are neighbour-packed into
non-persistent buffers that :meth:`VoxelNeRF.sample` reads through kernel
K4; the packing records each grid's version counter, and :meth:`sample`
repacks whenever a grid has changed since (an optimizer step, a loaded
state dict, any in-place edit), so it never reads tables older than the
grids. The gradient of :meth:`sample` reaches the raw grids through kernel
K5 (``ops/fused_sample.py::sample_grids``).

bf16 tables (``table_bf16``, the JAX package's ``--triplane_bf16``): the
grids are cast to bf16 before packing (packing only copies, so the bits
are those of a cast after it), and one bf16 pack, half the f32 one, serves
both uses. Training reads it through K4's bf16-row form, the gradient
stays the exact f32 one (K5's bf16 form). Renders that do not train
(``is_train`` False: held-out, served, the occupancy refresh's
:meth:`density`) take the bf16 eval chain of
``evdeblurnerf_tpu/models/voxnerf.py:107-112``: the interpolation in bf16
(K4's bf16-compute form), its features widened into ``basis_mat``, and the
double-angle positional encoding; ``eval_f32_interp`` turns the chain off
(the JAX package's ``EVDN_EVAL_F32_INTERP``), leaving bf16 rows with f32
math.

Tensor-parallel tables (``parallel/tp.py``, ``--tp_model_parallel``): a
field whose ``tp`` is set holds a component slice of every grid, samples it
through the same kernels, projects through its columns of ``basis_mat``
and sums the partial features over the model group
(``evdeblurnerf_tpu/models/voxnerf.py:135-158``); its TV is the mean of
the slices' TVs.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..ops import compositing, fused_sample, lane_shuffle, triplane
from .embedding import positional_encoding, positional_encoding_dim
from .layers import ACTIVATIONS, make_linear


def compute_grid_size(aabb_min, aabb_max, n_voxels) -> Tuple[int, int, int]:
    """Voxel count -> integer per-axis grid resolution, computed in float64
    and truncated like torch ``.long()`` (ref: voxnerf.py:86-93)."""
    extent = (np.asarray(aabb_max, np.float64)
              - np.asarray(aabb_min, np.float64))
    voxel_size = float((extent.prod() / n_voxels) ** (1.0 / 3.0))
    return tuple(int(x) for x in (extent / voxel_size))


class VoxelNeRF(nn.Module):
    """One field: the coarse or the fine stage of the c2f model.

    ``in_app_dim`` is the width of the sampled features the sigma net
    reads: ``app_dim`` for the coarse field, coarse plus fine ``app_dim``
    for the fine field, which also reads the coarse grids at its points.
    """

    def __init__(self, aabb, n_voxels: int,
                 app_n_comp: Sequence[int] = (64, 16, 16), app_dim: int = 32,
                 in_app_dim: int | None = None, num_layers: int = 2,
                 hidden_dim: int = 64, geo_feat_dim: int = 15,
                 num_layers_color: int = 3, hidden_dim_color: int = 64,
                 add_bias_color: bool = False, multires: int = 10,
                 multires_views: int = 4, composite_feature: bool = True,
                 rgb_activate: str = "relu", sigma_activate: str = "relu",
                 app_actfn: str = "none", render_rmnearplane: int = 0,
                 table_bf16: bool = False, eval_f32_interp: bool = False,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.table_bf16 = table_bf16
        self.eval_f32_interp = eval_f32_interp
        self.tables_frozen = False
        # this rank's share of the tables under tensor parallelism
        # (parallel/tp.py::TableSlice), None when they are whole
        self.tp = None
        self.register_buffer(
            "aabb", torch.tensor(aabb, dtype=torch.float32, device=device),
            persistent=False)
        self.grid_size = compute_grid_size(aabb[0], aabb[1], n_voxels)
        self.app_dim = app_dim
        self.multires = multires
        self.multires_views = multires_views
        self.composite_feature = composite_feature
        self.rgb_activate = rgb_activate
        self.sigma_activate = sigma_activate
        self.app_actfn = app_actfn
        self.render_rmnearplane = render_rmnearplane

        grid = self.grid_size
        planes, lines = [], []
        for i in range(3):
            m0, m1 = triplane.MAT_MODE[i]
            vec = triplane.VEC_MODE[i]
            shape_p = (1, app_n_comp[i], grid[m1], grid[m0])
            shape_l = (1, app_n_comp[i], grid[vec], 1)
            planes.append(nn.Parameter(0.1 * torch.randn(
                shape_p, generator=generator, device=device)))
            lines.append(nn.Parameter(0.1 * torch.randn(
                shape_l, generator=generator, device=device)))
        self.app_plane = nn.ParameterList(planes)
        self.app_line = nn.ParameterList(lines)
        self.basis_mat = make_linear(sum(app_n_comp), app_dim, "none",
                                     generator, device)

        in_app = app_dim if in_app_dim is None else in_app_dim
        width = in_app + positional_encoding_dim(multires)
        self.sigma_net = nn.ModuleList()
        for l in range(num_layers):
            out = 1 + geo_feat_dim if l == num_layers - 1 else hidden_dim
            self.sigma_net.append(make_linear(width, out, "none", generator,
                                              device))
            width = out
        width = geo_feat_dim + positional_encoding_dim(multires_views)
        self.color_net = nn.ModuleList()
        for l in range(num_layers_color):
            out = 3 if l == num_layers_color - 1 else hidden_dim_color
            self.color_net.append(make_linear(
                width, out, "torch" if add_bias_color else "none", generator,
                device))
            width = out

        self.pack_tables()
        self.register_load_state_dict_post_hook(
            lambda module, incompatible: module.refresh_tables())

    def grids(self):
        """The raw grids as ([C, H, W] x 3 planes, [C, D] x 3 lines), views
        of the ``app_plane`` / ``app_line`` parameters."""
        return ([p[0] for p in self.app_plane],
                [l[0, :, :, 0] for l in self.app_line])

    def _grid_versions(self):
        return tuple(p._version for p in (*self.app_plane, *self.app_line))

    def _packed(self):
        return ([getattr(self, f"packed_plane_{i}", None) for i in range(3)],
                [getattr(self, f"packed_line_{i}", None) for i in range(3)])

    @torch.no_grad()
    def pack_tables(self) -> None:
        """Neighbour-pack the grids into the tables :meth:`sample` reads and
        record the grids' versions. At the paper width this is one pass
        over ~0.5 GB (the fine 64-component plane packs to ~375 MB), half
        that with bf16 tables, whose grids are rounded as they are packed.
        Tables of the right shapes and type are written in place, so they
        keep their addresses (a captured training step reads them there,
        ``train/capture.py``); others (the first packing, another table
        type, sliced grids) are made anew."""
        planes, lines = self.grids()
        dtype = torch.bfloat16 if self.table_bf16 else torch.float32
        shapes = ([(p.shape[1] * p.shape[2], 4 * p.shape[0])
                   for p in planes], [(l.shape[1], 2 * l.shape[0])
                                      for l in lines])
        old = self._packed()
        if all(t is not None and t.dtype == dtype and tuple(t.shape) == s
               for ts, ss in zip(old, shapes) for t, s in zip(ts, ss)):
            _, _, sizes = triplane.pack_grids(planes, lines, out=old)
        else:
            if self.table_bf16:
                planes = [p.to(torch.bfloat16) for p in planes]
                lines = [l.to(torch.bfloat16) for l in lines]
            planes, lines, sizes = triplane.pack_grids(planes, lines)
            for i in range(3):
                self.register_buffer(f"packed_plane_{i}", planes[i],
                                     persistent=False)
                self.register_buffer(f"packed_line_{i}", lines[i],
                                     persistent=False)
        self.table_sizes = sizes
        self._packed_versions = self._grid_versions()

    def refresh_tables(self) -> None:
        """Repack if any grid changed since the last packing (nothing to do
        once the tables are frozen)."""
        if self.tables_frozen:
            return
        if self._grid_versions() != self._packed_versions:
            self.pack_tables()

    def repack_tables(self) -> None:
        """Repack in place whatever the grids' versions say: the captured
        training step's repack, which a replay runs with no host check."""
        if not self.tables_frozen:
            self.pack_tables()

    def freeze_tables(self) -> None:
        """Pack for the last time and drop the raw grids: the field then
        renders from its packed tables alone, with no check of the grids'
        versions, and cannot train. What an exported artifact holds
        (``serving.export_renderer``)."""
        self.refresh_tables()
        self.app_plane = nn.ParameterList()
        self.app_line = nn.ParameterList()
        self.tables_frozen = True

    def normalize_coords(self, pts: torch.Tensor) -> torch.Tensor:
        """World points -> [-1, 1] grid coords (ref: voxnerf.py:203-206)."""
        inv_size = 2.0 / (self.aabb[1] - self.aabb[0])
        return (pts - self.aabb[0]) * inv_size - 1.0

    def eval_bf16(self, is_train: bool) -> bool:
        """Whether a render takes the bf16 eval chain: bf16 tables, not
        training, and the chain not turned off (the one gate of the
        interpolation and the double-angle encoding)."""
        return (self.table_bf16 and not is_train
                and not self.eval_f32_interp)

    def sample(self, pts: torch.Tensor, is_train: bool = True
               ) -> torch.Tensor:
        """World pts [..., 3] -> appearance features [..., app_dim]
        (ref: voxnerf.py:132-151, 203-208): kernel K4 over the packed
        tables, differentiable to the grids and the points (K5); under
        the bf16 eval chain (:meth:`eval_bf16`) K4's bf16-compute form,
        whose bf16 features are widened into ``basis_mat``."""
        self.refresh_tables()
        shape = pts.shape[:-1]
        xyz = self.normalize_coords(pts.reshape(-1, 3)).contiguous()
        if self.tp is not None:
            xyz = self.tp.points(xyz)
        packed = ([getattr(self, f"packed_plane_{i}") for i in range(3)],
                  [getattr(self, f"packed_line_{i}") for i in range(3)],
                  self.table_sizes)
        compute = self.eval_bf16(is_train)
        if compute or self.tables_frozen:
            feats = fused_sample.triplane_features(
                *packed, xyz, compute_bf16=compute).float()
        else:
            feats = fused_sample.sample_grids(*self.grids(), packed, xyz)
        if self.tp is None:
            feats = self.basis_mat(feats)
        else:
            feats = self.tp.contract(feats, self.basis_mat.weight)
        return ACTIVATIONS[self.app_actfn](feats).reshape(*shape,
                                                          self.app_dim)

    def density(self, pts: torch.Tensor) -> torch.Tensor:
        """Raw (pre-activation) sigma [...] at world pts [..., 3]: the sigma
        head of :meth:`forward` without noise, compositing or colour (ref:
        voxnerf.py:210-259; ``evdeblurnerf_tpu/models/voxnerf.py::
        density``), read by the occupancy refresh."""
        fts = self.sample(pts, is_train=False).reshape(-1, self.app_dim)
        pe = positional_encoding(pts.reshape(-1, 3), self.multires,
                                 double_angle=self.eval_bf16(False))
        h = self._mlp(self.sigma_net, torch.cat([fts, pe], -1))
        return h[..., 0].reshape(pts.shape[:-1])

    def _mlp(self, layers: nn.ModuleList, h: torch.Tensor) -> torch.Tensor:
        for l, layer in enumerate(layers):
            h = layer(h)
            if l != len(layers) - 1:
                h = torch.relu(h)
        return h

    def tv_loss_app(self) -> torch.Tensor:
        """(ref: voxnerf.py:126-130); over sliced tables the mean of the
        slices' TVs."""
        tv = triplane.tv_loss_app(*self.grids())
        return tv if self.tp is None else self.tp.mean(tv)

    def forward(self, pts, viewdirs, fts, z_vals, rays_d, noise=None,
                is_train=False, perm=None, inv_perm=None,
                want_features=False):
        """Field evaluation and compositing (ref: voxnerf.py:210-259).

        pts [R, S, 3]; viewdirs [R, 3]; fts [R, S, C] sampled features;
        z_vals [R, S] sorted; rays_d [R, 3]; ``noise`` optional [R, S-1]
        sigma noise. The near-plane mask applies at eval only. With
        ``perm`` [R, S] int32 the per-sample inputs are in an unsorted
        order with ``z_vals[r, i] == z_cat[r, perm[r, i]]``: the field runs
        in that order and only the compositing scalars move, through kernel
        K1 (sigma to depth order, weights back).

        Returns (color [R, 3], depth [R], acc [R], weights [R, S],
        feature): weights in depth order; ``feature`` is the ray-composited
        feature [R, geo_feat_dim] of the CRR head, or, for the FVR head
        when ``want_features``, the per-sample features [R, S,
        geo_feat_dim] in depth order (moved by kernel K2, for AWP), else
        None.
        """
        R, S = pts.shape[0], pts.shape[1]
        # the bf16 eval chain's encoding (the gate of sample())
        da = self.eval_bf16(is_train)
        pe = positional_encoding(pts.reshape(R * S, 3), self.multires,
                                 double_angle=da)
        h = self._mlp(self.sigma_net,
                      torch.cat([fts.reshape(R * S, -1), pe], -1))
        feature = h[..., 1:]
        sigma = h[..., 0].reshape(R, S)
        sigma_act = ACTIVATIONS[self.sigma_activate]

        rm_mask = None
        if not is_train and self.render_rmnearplane > 0:
            rm_mask = compositing.rmnearplane_mask(z_vals,
                                                   self.render_rmnearplane)
        if perm is not None:
            sigma = lane_shuffle.permute_lanes(sigma, perm, inv_perm)
        weights = compositing.compute_weights(
            sigma, z_vals, rays_d, sigma_act, noise=noise,
            rmnearplane_mask=rm_mask)
        weights_cat = weights
        if perm is not None:
            weights_cat = lane_shuffle.permute_lanes(weights, inv_perm, perm)

        out_feature = None
        if self.composite_feature:
            feat_act = ACTIVATIONS[self.rgb_activate](
                feature.reshape(R, S, -1))
            feat_ray = torch.sum(weights_cat[..., None] * feat_act, -2)
            dirs_pe = positional_encoding(viewdirs, self.multires_views,
                                          double_angle=da)
            color = torch.sigmoid(self._mlp(
                self.color_net, torch.cat([feat_ray, dirs_pe], -1)))
            out_feature = feat_ray
        else:
            dirs = viewdirs[:, None, :].expand(R, S, 3).reshape(R * S, 3)
            dirs_pe = positional_encoding(dirs, self.multires_views,
                                          double_angle=da)
            color_s = torch.sigmoid(self._mlp(
                self.color_net, torch.cat([feature, dirs_pe], -1)))
            color_s = ACTIVATIONS[self.rgb_activate](color_s.reshape(R, S, 3))
            color = torch.sum(weights_cat[..., None] * color_s, -2)
            if want_features:
                out_feature = feature.reshape(R, S, -1)
                if perm is not None:
                    # [R, C, S] lane shuffle into depth order (kernel K2)
                    out_feature = lane_shuffle.permute_lanes(
                        out_feature.transpose(1, 2), perm,
                        inv_perm).transpose(1, 2)
        depth = torch.sum(weights * z_vals, -1)
        acc = torch.sum(weights, -1)
        return color, depth, acc, weights, out_feature
