"""Renderer: coarse + fine fields and the per-ray rendering pipeline.

Counterpart of ``evdeblurnerf_tpu/models/renderer.py`` (ref:
networks/renderer.py:14-626): stratified depths, the coarse field,
``sample_pdf`` importance depths, and the fine field over the merged set;
with ``N_importance == 0`` the coarse pass alone (no ``rgb0``,
``mlp_fine`` None). The fields are the c2f PDRF voxel fields
(``mode=c2f``) or the vanilla NeRF MLPs (``mode=nerf``,
``models/nerf_mlp.py``), whose fine pass evaluates the merged depths in
sorted order as the reference does. At eval everything is deterministic;
the training render adds the stratified jitter (``perturb``), the sigma
noise (``raw_noise_std``) and stochastic importance draws, all from one
``torch.Generator`` the caller passes in.

The fine pass evaluates its fields in UNSORTED (stratified ++ importance)
order, as the JAX package does: the coarse-grid features of the stratified
depths are reused, and only the compositing scalars move to depth order
(kernel K1). Pointwise this equals the reference's sort-then-evaluate
(renderer.py:205-213); only the order of the final per-ray sums differs.

Two culls of the JAX package, approximations with no reference
counterpart, both off unless asked for (``RenderConfig``):

* the transmittance fine cull (``fine_cull_capacity`` > 0, training from
  ``--fine_cull_start_iter``, at eval with ``--fine_cull_eval``): the fine
  pass evaluates only the merged samples still visible under the coarse
  transmittance (T > ``fine_cull_eps``), ``S_keep = round(capacity *
  (N_samples + N_importance))`` lanes a ray (at least 8), and samples the
  coarse and fine tables again at the kept depths;
* the occupancy coarse cull (``coarse_cull_capacity`` > 0 and an
  occupancy grid, training only): the coarse pass evaluates only the
  stratified samples in occupied voxels plus a probe floor,
  ``round(capacity * N_samples)`` lanes a ray (at least 8;
  ``ops/occupancy.py``).

Both keep a fixed number of lanes a ray through
:func:`_capacity_select_sorted`. The training draws of one render come
from the caller's generator in this order: the stratified jitter, the
coarse sigma noise at the width the coarse pass evaluates (after the
coarse cull's selection; the JAX package draws at full width and again at
the culled width), the importance draws, the fine sigma noise at the
width the fine pass evaluates.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from ..ops import lane_shuffle, occupancy
from ..parallel import mesh
from ..ops.sample_pdf import sample_pdf, unit_linspace
from ..ops import compositing
from ..utils.rays import get_ndc_rays
from .embedding import positional_encoding, positional_encoding_dim
from .layers import ACTIVATIONS
from .nerf_mlp import NeRFMLP
from .voxnerf import VoxelNeRF


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render/model configuration; fields and defaults mirror the
    JAX package's ``RenderConfig``. ``triplane_bf16``: bf16 tables
    (``models/voxnerf.py``). The TPU-only line matmul is absent: the port's
    line gradients are the exact f32 ones. ``rgb_activate``,
    ``sigma_activate``, ``white_bkgd`` and the ``net*`` widths steer the
    NeRF field only, as in the JAX package."""

    mode: str = "c2f"
    N_samples: int = 64
    N_importance: int = 64
    perturb: float = 1.0
    use_viewdirs: bool = True
    multires: int = 10
    multires_views: int = 4
    raw_noise_std: float = 0.0
    white_bkgd: bool = False
    lindisp: bool = False
    ndc: bool = True
    near: float = 0.0
    far: float = 1.0
    H: int = 0
    W: int = 0
    focal: float = 0.0
    render_rmnearplane: int = 0
    rgb_activate: str = "sigmoid"
    sigma_activate: str = "relu"
    rgb_add_bias: bool = False
    netdepth: int = 8
    netwidth: int = 256
    netdepth_fine: int = 8
    netwidth_fine: int = 256
    aabb: Tuple[Tuple[float, float, float], Tuple[float, float, float]] = (
        (-1.0, -1.0, -1.0), (1.0, 1.0, 1.0))
    coarse_num_layers: int = 2
    coarse_num_layers_color: int = 3
    coarse_hidden_dim: int = 64
    coarse_hidden_dim_color: int = 64
    coarse_app_dim: int = 32
    coarse_app_n_comp: Tuple[int, ...] = (64, 16, 16)
    coarse_n_voxels: int = 16777248
    coarse_app_actfn: str = "none"
    fine_num_layers: int = 2
    fine_num_layers_color: int = 3
    fine_hidden_dim: int = 256
    fine_hidden_dim_color: int = 256
    fine_app_dim: int = 32
    fine_geo_feat_dim: int = 128
    fine_app_n_comp: Tuple[int, ...] = (64, 16, 16)
    fine_n_voxels: int = 134217984
    fine_app_actfn: str = "none"
    triplane_bf16: bool = False
    # the two culls (module docstring); 0 is reference-exact sampling
    fine_cull_capacity: float = 0.0
    fine_cull_eps: float = 1e-3
    coarse_cull_capacity: float = 0.0
    occ_grid_size: int = 64
    occ_eps: float = 1e-4
    occ_dilate: int = 1
    occ_probe_stride: int = 8
    kernel_type: str = "none"
    kernel_feat_cnl: int = 15
    use_awp: bool = False

    @property
    def composite_feature_coarse(self) -> bool:
        return self.kernel_type == "PBE"

    @property
    def extract_feature(self) -> str:
        return "before_linear" if self.use_awp else "after_linear"


def config_from_args(args, aabb, H, W, focal, near, far) -> RenderConfig:
    """Build a RenderConfig from parsed flags and dataset-derived values."""
    return RenderConfig(
        mode=args.mode, N_samples=args.N_samples,
        N_importance=args.N_importance, perturb=args.perturb,
        use_viewdirs=args.use_viewdirs,
        multires=args.multires, multires_views=args.multires_views,
        raw_noise_std=args.raw_noise_std, white_bkgd=args.white_bkgd,
        lindisp=args.lindisp,
        ndc=not args.no_ndc, near=float(near), far=float(far),
        H=int(H), W=int(W), focal=float(focal),
        render_rmnearplane=args.render_rmnearplane,
        rgb_activate=args.rgb_activate, sigma_activate=args.sigma_activate,
        rgb_add_bias=args.rgb_add_bias,
        netdepth=args.netdepth, netwidth=args.netwidth,
        netdepth_fine=args.netdepth_fine, netwidth_fine=args.netwidth_fine,
        aabb=(tuple(float(v) for v in aabb[0]),
              tuple(float(v) for v in aabb[1])),
        coarse_num_layers=args.coarse_num_layers,
        coarse_num_layers_color=args.coarse_num_layers_color,
        coarse_hidden_dim=args.coarse_hidden_dim,
        coarse_hidden_dim_color=args.coarse_hidden_dim_color,
        coarse_app_dim=args.coarse_app_dim,
        coarse_app_n_comp=tuple(args.coarse_app_n_comp or (64, 16, 16)),
        coarse_n_voxels=args.coarse_n_voxels,
        coarse_app_actfn=args.coarse_app_actfn,
        fine_num_layers=args.fine_num_layers,
        fine_num_layers_color=args.fine_num_layers_color,
        fine_hidden_dim=args.fine_hidden_dim,
        fine_hidden_dim_color=args.fine_hidden_dim_color,
        fine_app_dim=args.fine_app_dim,
        fine_geo_feat_dim=args.fine_geo_feat_dim,
        fine_app_n_comp=tuple(args.fine_app_n_comp or (64, 16, 16)),
        fine_n_voxels=args.fine_n_voxels,
        fine_app_actfn=args.fine_app_actfn,
        triplane_bf16=bool(getattr(args, "triplane_bf16", False)),
        fine_cull_capacity=args.fine_cull_capacity or 0.0,
        fine_cull_eps=args.fine_cull_eps,
        coarse_cull_capacity=args.coarse_cull_capacity or 0.0,
        occ_grid_size=args.occ_grid_size, occ_eps=args.occ_eps,
        occ_dilate=args.occ_dilate, occ_probe_stride=args.occ_probe_stride,
        kernel_type=args.kernel_type,
        kernel_feat_cnl=args.kernel_feat_cnl, use_awp=args.kernel_use_awp)


def _capacity_select_sorted(keep_s: torch.Tensor,
                            S_keep: int) -> torch.Tensor:
    """Fixed-capacity selection from a keep mask [R, S] in ascending-depth
    lane order, shared by the two culls (``evdeblurnerf_tpu/models/
    renderer.py::_capacity_select_sorted``).

    The deepest lane is always a survivor, so the compositor's pinned
    last-alpha sample stays the ray's far sample. With more survivors than
    ``S_keep`` the survivors are decimated evenly by depth rank (the
    survivor of rank r is selected iff floor(r*K/n) > floor((r-1)*K/n));
    spare capacity takes first the unselected survivors, then the
    shallowest culled lanes. Returns int64 positions [R, S_keep] into the
    sorted domain, ordered by (priority, depth), not by depth: the key
    ``prio * S + pos`` is unique a lane, so any sort gives the JAX order.
    """
    S_all = keep_s.shape[-1]
    keep_s = keep_s.clone()
    keep_s[..., -1] = True
    rank = torch.cumsum(keep_s.int(), -1)
    n_surv = rank[..., -1:].clamp_min(1)
    sel_s = keep_s & ((rank * S_keep) // n_surv
                      > ((rank - 1) * S_keep) // n_surv)
    # priority 0: decimation-selected survivors; 1: unselected survivors;
    # 2: culled lanes
    prio = torch.where(sel_s, 0, torch.where(keep_s, 1, 2))
    pos = torch.arange(S_all, device=keep_s.device)
    _, order = torch.sort(prio * S_all + pos, -1)
    return order[..., :S_keep]


class Renderer(nn.Module):
    """Coarse and fine fields (``mlp_coarse``, ``mlp_fine``; the latter None
    without an importance pass) and the render of a ray batch.
    ``eval_f32_interp`` turns the bf16 eval chain of bf16 tables off
    (``models/voxnerf.py``), where the JAX package reads the environment
    variable ``EVDN_EVAL_F32_INTERP``."""

    def __init__(self, cfg: RenderConfig,
                 generator: torch.Generator | None = None, device=None,
                 eval_f32_interp: bool = False):
        super().__init__()
        self.cfg = cfg
        if cfg.mode == "nerf":
            pts_ch = positional_encoding_dim(cfg.multires)
            views_ch = positional_encoding_dim(cfg.multires_views)
            common = dict(use_viewdirs=cfg.use_viewdirs,
                          rgb_add_bias=cfg.rgb_add_bias,
                          extract_feature=cfg.extract_feature,
                          generator=generator, device=device)
            self.mlp_coarse = NeRFMLP(pts_ch, views_ch, D=cfg.netdepth,
                                      W=cfg.netwidth, **common)
            self.mlp_fine = (NeRFMLP(pts_ch, views_ch, D=cfg.netdepth_fine,
                                     W=cfg.netwidth_fine, **common)
                             if cfg.N_importance > 0 else None)
            return
        if cfg.mode != "c2f":
            raise ValueError(f"mode {cfg.mode!r}: expected c2f or nerf")
        common = dict(aabb=cfg.aabb, multires=cfg.multires,
                      multires_views=cfg.multires_views,
                      add_bias_color=cfg.rgb_add_bias,
                      render_rmnearplane=cfg.render_rmnearplane,
                      sigma_activate="relu", table_bf16=cfg.triplane_bf16,
                      eval_f32_interp=eval_f32_interp,
                      generator=generator, device=device)
        self.mlp_coarse = VoxelNeRF(
            n_voxels=cfg.coarse_n_voxels, app_n_comp=cfg.coarse_app_n_comp,
            app_dim=cfg.coarse_app_dim, num_layers=cfg.coarse_num_layers,
            hidden_dim=cfg.coarse_hidden_dim,
            geo_feat_dim=cfg.kernel_feat_cnl,
            num_layers_color=cfg.coarse_num_layers_color,
            hidden_dim_color=cfg.coarse_hidden_dim_color,
            composite_feature=cfg.composite_feature_coarse,
            rgb_activate="relu", app_actfn=cfg.coarse_app_actfn, **common)
        self.mlp_fine = None
        if cfg.N_importance > 0:
            self.mlp_fine = VoxelNeRF(
                n_voxels=cfg.fine_n_voxels, app_n_comp=cfg.fine_app_n_comp,
                app_dim=cfg.fine_app_dim,
                in_app_dim=cfg.coarse_app_dim + cfg.fine_app_dim,
                num_layers=cfg.fine_num_layers,
                hidden_dim=cfg.fine_hidden_dim,
                geo_feat_dim=cfg.fine_geo_feat_dim,
                num_layers_color=cfg.fine_num_layers_color,
                hidden_dim_color=cfg.fine_hidden_dim_color,
                composite_feature=False, rgb_activate="none",
                app_actfn=cfg.fine_app_actfn, **common)

    @property
    def device(self) -> torch.device:
        return next(self.mlp_coarse.parameters()).device

    @property
    def feature_dim(self) -> int:
        """Width of the per-sample feature the render hands AWP
        (``depth_feature``): that of the field of the last pass."""
        last = self.mlp_fine if self.mlp_fine is not None else self.mlp_coarse
        if self.cfg.mode == "nerf":
            return last.feature_dim
        return (self.cfg.fine_geo_feat_dim if self.mlp_fine is not None
                else self.cfg.kernel_feat_cnl)

    def refresh_tables(self) -> None:
        """Repack the voxel fields' tables after their grids changed (a
        no-op for the NeRF MLPs, which have none)."""
        if self.cfg.mode == "c2f":
            for field in (self.mlp_coarse, self.mlp_fine):
                if field is not None:
                    field.refresh_tables()

    def repack_tables(self) -> None:
        """Repack the voxel fields' tables in place, unconditionally
        (``VoxelNeRF.repack_tables``: the captured training step's)."""
        if self.cfg.mode == "c2f":
            for field in (self.mlp_coarse, self.mlp_fine):
                if field is not None:
                    field.repack_tables()

    def freeze_tables(self) -> None:
        """Freeze the voxel fields' packed tables and drop their raw grids
        (``VoxelNeRF.freeze_tables``): a renderer that only renders, as an
        exported artifact holds it."""
        if self.cfg.mode == "c2f":
            for field in (self.mlp_coarse, self.mlp_fine):
                if field is not None:
                    field.freeze_tables()

    def _sample_z(self, R: int, device, perturb: float,
                  generator) -> torch.Tensor:
        """Stratified depths [R, N_samples], jittered within their bins
        when ``perturb`` > 0 (ref: renderer.py:163-178)."""
        cfg = self.cfg
        t_vals = unit_linspace(cfg.N_samples, device)
        near = torch.full((R, 1), cfg.near, device=device)
        far = torch.full((R, 1), cfg.far, device=device)
        if not cfg.lindisp:
            z_vals = near * (1.0 - t_vals) + far * t_vals
        else:
            z_vals = 1.0 / (1.0 / near * (1.0 - t_vals) + 1.0 / far * t_vals)
        if perturb > 0.0:
            mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
            upper = torch.cat([mids, z_vals[..., -1:]], -1)
            lower = torch.cat([z_vals[..., :1], mids], -1)
            t_rand = mesh.draw(torch.rand, z_vals.shape, generator, device)
            z_vals = lower + (upper - lower) * t_rand
        return z_vals

    def _noise(self, shape, noise_std: float, generator):
        if noise_std > 0.0:
            return mesh.draw(torch.randn, shape, generator,
                             self.device) * noise_std
        return None

    def _unpack_rays(self, rays: torch.Tensor):
        """[R, 3, 2] packed rays -> (rays_o, rays_d, viewdirs), with viewdir
        normalisation before the NDC projection (ref: renderer.py:399-466)."""
        cfg = self.cfg
        rays_o, rays_d = rays[..., 0], rays[..., 1]
        viewdirs = None
        if cfg.use_viewdirs:
            viewdirs = rays_d / torch.linalg.vector_norm(rays_d, dim=-1,
                                                         keepdim=True)
        if cfg.ndc:
            rays_o, rays_d = get_ndc_rays(cfg.H, cfg.W, cfg.focal, 1.0,
                                          rays_o, rays_d)
        return rays_o, rays_d, viewdirs

    def _coarse_setup(self, rays_o, rays_d, is_train, generator,
                      occ_grid=None):
        """Stratified coarse depths, their world points and the sigma
        noise: the common preamble of :meth:`render_rays` and
        :meth:`coarse_render`. With ``occ_grid`` the occupancy coarse cull
        keeps :meth:`_coarse_cull_select`'s lanes first. Two draws from
        ``generator`` when training: the jitter, then the noise at the
        kept width."""
        cfg = self.cfg
        R = rays_o.shape[0]
        z_vals = self._sample_z(R, rays_o.device,
                                cfg.perturb if is_train else 0.0, generator)
        pts = (rays_o[..., None, :]
               + rays_d[..., None, :] * z_vals[..., :, None])
        if occ_grid is not None:
            z_vals = torch.gather(z_vals, -1,
                                  self._coarse_cull_select(occ_grid, pts))
            pts = (rays_o[..., None, :]
                   + rays_d[..., None, :] * z_vals[..., :, None])
        noise = self._noise((R, z_vals.shape[-1] - 1),
                            cfg.raw_noise_std if is_train else 0.0, generator)
        return z_vals, pts, noise

    def _coarse_cull_grid(self, coarse_cull, occ_grid, is_train):
        """The occupancy grid when the coarse cull applies (a c2f training
        render asked for it, with a grid and a capacity), else None."""
        cfg = self.cfg
        if (coarse_cull and occ_grid is not None and cfg.mode == "c2f"
                and cfg.coarse_cull_capacity > 0.0 and is_train):
            return occ_grid
        return None

    @torch.no_grad()
    def _coarse_cull_select(self, occ_grid, pts):
        """Positions [R, Kc] in ascending depth into the stratified lanes:
        the samples in occupied voxels, every ``occ_probe_stride``-th lane
        (a stale grid is re-observed) and the deepest lane, brought to
        ``Kc`` lanes by :func:`_capacity_select_sorted`
        (``evdeblurnerf_tpu/models/renderer.py::_coarse_cull_select``)."""
        cfg = self.cfg
        Kc = min(cfg.N_samples, max(8, int(round(
            cfg.coarse_cull_capacity * cfg.N_samples))))
        occ = occupancy.lookup_bits(occ_grid,
                                    self.mlp_coarse.normalize_coords(pts))
        probe = (torch.arange(cfg.N_samples, device=pts.device)
                 % max(1, cfg.occ_probe_stride)) == 0
        keep = (occ > 0.5) | probe
        return torch.sort(_capacity_select_sorted(keep, Kc), -1).values

    @torch.no_grad()
    def _cull_select(self, z_cat, z_coarse, weights_coarse):
        """Lane indices [R, S_keep] into ``z_cat`` [R, S_all] (stratified ++
        importance, unsorted) of the samples the fine cull keeps, not in
        depth order (``evdeblurnerf_tpu/models/renderer.py::_cull_select``).

        The coarse transmittance before a sample is ``T(z) = 1 - sum_j
        w_j [z > z_coarse_j]`` over the coarse weights [R, Sc] at the
        sorted coarse depths ``z_coarse``; a sample is kept where T >
        ``fine_cull_eps``. The budget is a fraction of ``N_samples +
        N_importance``, whatever an upstream coarse cull left, so the two
        culls compose. T is the JAX package's masked sum over [R, S_all,
        Sc], in the same order of terms: a cumulative-sum form would round
        otherwise and could flip ``T > eps`` at the threshold.
        """
        cfg = self.cfg
        S_all = z_cat.shape[-1]
        S_keep = min(S_all, max(8, int(round(
            cfg.fine_cull_capacity * (cfg.N_samples + cfg.N_importance)))))
        z_sorted, perm_z, _ = lane_shuffle.sort_with_perm(z_cat)
        occl = torch.where(z_sorted[..., :, None] > z_coarse[..., None, :],
                           weights_coarse[..., None, :], 0.0)
        keep_s = 1.0 - torch.sum(occl, -1) > cfg.fine_cull_eps
        sel_pos = _capacity_select_sorted(keep_s, S_keep)
        return torch.gather(perm_z.long(), -1, sel_pos)

    def _run_nerf_field(self, mlp, pts, viewdirs, z_vals, rays_d, noise,
                        is_train, composite_feature):
        """NeRF field evaluation and compositing over depth-sorted samples
        (ref: networks/nerf.py:74-175): (rgb [R, 3], depth [R], acc [R],
        weights [R, S], feature), the feature composited over the ray
        (``composite_feature``) or per sample [R, S, F], or None."""
        cfg = self.cfg
        R, S = pts.shape[0], pts.shape[1]
        pts_pe = positional_encoding(pts.reshape(R * S, 3), cfg.multires)
        views_pe = None
        if cfg.use_viewdirs:
            views_pe = positional_encoding(
                viewdirs[:, None, :].expand(R, S, 3).reshape(R * S, 3),
                cfg.multires_views)
        raw, feature = mlp(pts_pe, views_pe)
        raw = raw.reshape(R, S, 4)
        rgb = ACTIVATIONS[cfg.rgb_activate](raw[..., :3])
        rm_mask = None
        if not is_train and cfg.render_rmnearplane > 0:
            rm_mask = compositing.rmnearplane_mask(z_vals,
                                                   cfg.render_rmnearplane)
        weights = compositing.compute_weights(
            raw[..., 3], z_vals, rays_d, ACTIVATIONS[cfg.sigma_activate],
            noise=noise, rmnearplane_mask=rm_mask)
        rgb_map, depth_map, acc_map = compositing.composite(
            weights, rgb, z_vals, white_bkgd=cfg.white_bkgd)
        if feature is not None:
            feature = feature.reshape(R, S, -1)
            if composite_feature:
                feature = torch.sum(weights[..., None] * feature, -2)
        return rgb_map, depth_map, acc_map, weights, feature

    def _importance_z(self, z_vals, weights, perturb, generator):
        """``N_importance`` depths drawn from the coarse weights' PDF
        (``sample_pdf``, kernel K3 on the card)."""
        z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        return sample_pdf(z_mid, weights[..., 1:-1], self.cfg.N_importance,
                          det=perturb == 0.0, generator=generator)

    def render_rays(self, rays_o, rays_d, viewdirs, is_train=False,
                    generator=None, want_features=False, fine_cull=False,
                    coarse_cull=False, occ_grid=None):
        """Render of rays [R, 3] (already NDC if applicable).

        ``is_train`` applies the config's ``perturb`` and ``raw_noise_std``
        with draws from ``generator`` (det importance draws when perturb is
        0) and drops the eval-only near-plane mask. ``want_features`` also
        returns the last pass's per-sample features in depth order
        (``depth_feature``, for AWP). ``fine_cull`` turns on the
        transmittance fine cull where the config has a capacity (c2f with
        an importance pass); ``coarse_cull`` with the occupancy grid
        ``occ_grid`` [G*G, G] the occupancy coarse cull (c2f training
        only). Returns a dict with rgb_map/depth_map/acc_map, the last
        pass's weights and sorted z_vals and, with an importance pass, the
        coarse rgb0/depth0/acc0 and ``z_std``, the spread of the importance
        depths.
        """
        cfg = self.cfg
        perturb = cfg.perturb if is_train else 0.0
        noise_std = cfg.raw_noise_std if is_train else 0.0
        z_vals, pts, noise_c = self._coarse_setup(
            rays_o, rays_d, is_train, generator,
            self._coarse_cull_grid(coarse_cull, occ_grid, is_train))
        if cfg.mode == "nerf":
            return self._render_nerf(rays_o, rays_d, viewdirs, z_vals, pts,
                                     noise_c, is_train, perturb, noise_std,
                                     generator, want_features)
        ft_coarse = self.mlp_coarse.sample(pts, is_train)
        rgb0, depth0, acc0, weights, feature = self.mlp_coarse(
            pts, viewdirs, ft_coarse, z_vals, rays_d, noise=noise_c,
            is_train=is_train,
            want_features=want_features and self.mlp_fine is None)
        if self.mlp_fine is None:
            ret = dict(rgb_map=rgb0, depth_map=depth0, acc_map=acc0,
                       weights=weights, z_vals=z_vals)
            if want_features and feature is not None:
                ret["depth_feature"] = feature
            return ret

        R = rays_o.shape[0]
        z_samples = self._importance_z(z_vals, weights, perturb, generator)
        z_cat = torch.cat([z_vals, z_samples], -1)
        if fine_cull and cfg.fine_cull_capacity > 0.0:
            # the kept lanes, their coarse and fine features sampled again
            z_cat = torch.gather(z_cat, -1,
                                 self._cull_select(z_cat, z_vals, weights))
            pts_cat = (rays_o[..., None, :]
                       + rays_d[..., None, :] * z_cat[..., :, None])
            ft_cat = self.mlp_coarse.sample(pts_cat, is_train)
        else:
            pts_new = (rays_o[..., None, :]
                       + rays_d[..., None, :] * z_samples[..., :, None])
            pts_cat = (rays_o[..., None, :]
                       + rays_d[..., None, :] * z_cat[..., :, None])
            ft_cat = torch.cat(
                [ft_coarse, self.mlp_coarse.sample(pts_new, is_train)], 1)
        z_all, perm, inv_perm = lane_shuffle.sort_with_perm(z_cat)
        ft = torch.cat([ft_cat, self.mlp_fine.sample(pts_cat, is_train)], -1)
        noise_f = self._noise((R, z_cat.shape[-1] - 1), noise_std, generator)
        rgb, depth, acc, weights, feature = self.mlp_fine(
            pts_cat, viewdirs, ft, z_all, rays_d, noise=noise_f,
            is_train=is_train, perm=perm, inv_perm=inv_perm,
            want_features=want_features)
        ret = dict(rgb_map=rgb, depth_map=depth, acc_map=acc, rgb0=rgb0,
                   depth0=depth0, acc0=acc0, weights=weights, z_vals=z_all,
                   z_std=torch.std(z_samples, -1, correction=0))
        if feature is not None:
            ret["depth_feature"] = feature
        return ret

    def _render_nerf(self, rays_o, rays_d, viewdirs, z_vals, pts, noise_c,
                     is_train, perturb, noise_std, generator, want_features):
        """The ``mode=nerf`` arm of :meth:`render_rays` (ref:
        renderer.py:129-264): the coarse MLP at the stratified depths, then
        the fine MLP at the sorted union of those and the importance
        depths."""
        cfg = self.cfg
        out = self._run_nerf_field(
            self.mlp_coarse, pts, viewdirs, z_vals, rays_d, noise_c,
            is_train, composite_feature=cfg.composite_feature_coarse)
        ret = {}
        if self.mlp_fine is not None:
            ret.update(rgb0=out[0], depth0=out[1], acc0=out[2])
            z_samples = self._importance_z(z_vals, out[3], perturb,
                                           generator)
            z_vals, _ = torch.sort(torch.cat([z_vals, z_samples], -1), -1)
            pts = (rays_o[..., None, :]
                   + rays_d[..., None, :] * z_vals[..., :, None])
            noise_f = self._noise((rays_o.shape[0], z_vals.shape[-1] - 1),
                                  noise_std, generator)
            out = self._run_nerf_field(self.mlp_fine, pts, viewdirs, z_vals,
                                       rays_d, noise_f, is_train,
                                       composite_feature=False)
            ret["z_std"] = torch.std(z_samples, -1, correction=0)
        rgb, depth, acc, weights, feature = out
        ret.update(rgb_map=rgb, depth_map=depth, acc_map=acc, weights=weights,
                   z_vals=z_vals)
        if want_features and feature is not None:
            ret["depth_feature"] = feature
        return ret

    def render(self, rays: torch.Tensor, is_train=False, generator=None,
               want_features=False, fine_cull=False, coarse_cull=False,
               occ_grid=None):
        """Render rays given as [R, 3, 2] (origin, direction on the last
        axis), applying viewdir normalisation and NDC; the NDC directions
        come back as ``rays_d``. The culls as in :meth:`render_rays`."""
        rays_o, rays_d, viewdirs = self._unpack_rays(rays)
        ret = self.render_rays(rays_o, rays_d, viewdirs, is_train=is_train,
                               generator=generator,
                               want_features=want_features,
                               fine_cull=fine_cull, coarse_cull=coarse_cull,
                               occ_grid=occ_grid)
        ret["rays_d"] = rays_d
        return ret

    def coarse_render(self, rays: torch.Tensor, is_train=False,
                      generator=None, coarse_cull=False, occ_grid=None):
        """One coarse pass over rays [R, 3, 2]: (rgb [R, 3], the coarse
        field's feature). The stage-0 render of the PBE kernel (ref:
        renderer.py:468-592), whose coarse head composites the features
        over the ray: feature [R, F]. The occupancy coarse cull as in
        :meth:`render_rays`."""
        rays_o, rays_d, viewdirs = self._unpack_rays(rays)
        z_vals, pts, noise = self._coarse_setup(
            rays_o, rays_d, is_train, generator,
            self._coarse_cull_grid(coarse_cull, occ_grid, is_train))
        if self.cfg.mode == "nerf":
            rgb, _, _, _, feature = self._run_nerf_field(
                self.mlp_coarse, pts, viewdirs, z_vals, rays_d, noise,
                is_train, composite_feature=self.cfg.composite_feature_coarse)
            return rgb, feature
        rgb, _, _, _, feature = self.mlp_coarse(
            pts, viewdirs, self.mlp_coarse.sample(pts, is_train), z_vals,
            rays_d, noise=noise, is_train=is_train)
        return rgb, feature

    def coarse_sigma_grid(self) -> torch.Tensor:
        """Raw coarse density [G, G, G] at the occupancy grid's voxel
        centres (c2f only): the input of the occupancy refresh
        (``ops/occupancy.py::grid_from_sigma``)."""
        if self.cfg.mode != "c2f":
            raise ValueError("the occupancy grid needs the c2f voxel fields")
        centers = occupancy.voxel_centers(self.cfg.aabb,
                                          self.cfg.occ_grid_size,
                                          self.device)
        return self.mlp_coarse.density(centers)

    def tv_loss(self) -> torch.Tensor:
        """Grid TV regulariser x5 of the voxel fields (ref:
        renderer.py:361-365); zero for the NeRF MLPs."""
        if self.cfg.mode != "c2f":
            return torch.zeros((), device=self.device)
        total = self.mlp_coarse.tv_loss_app()
        if self.mlp_fine is not None:
            total = total + self.mlp_fine.tv_loss_app()
        return total * 5.0
