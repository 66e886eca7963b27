"""Renderer: coarse + fine fields and the per-ray rendering pipeline.

Counterpart of ``evdeblurnerf_tpu/models/renderer.py`` (ref:
networks/renderer.py:14-626) for the c2f model, with both culls off:
stratified depths, the coarse field, ``sample_pdf`` importance depths, and
the fine field over the merged set. At eval everything is deterministic;
the training render adds the stratified jitter (``perturb``), the sigma
noise (``raw_noise_std``) and stochastic importance draws, all from one
``torch.Generator`` the caller passes in.

The fine pass evaluates its fields in UNSORTED (stratified ++ importance)
order, as the JAX package does: the coarse-grid features of the stratified
depths are reused, and only the compositing scalars move to depth order
(kernel K1). Pointwise this equals the reference's sort-then-evaluate
(renderer.py:205-213); only the order of the final per-ray sums differs.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from ..ops import lane_shuffle
from ..ops.sample_pdf import sample_pdf, unit_linspace
from ..utils.rays import get_ndc_rays
from .voxnerf import VoxelNeRF


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render/model configuration; fields and defaults mirror the
    JAX package's ``RenderConfig``. The TPU-only fields (culls, bf16
    tables, line matmul) are absent: :func:`config_from_args` rejects a
    request for what the port does not do yet."""

    mode: str = "c2f"
    N_samples: int = 64
    N_importance: int = 64
    perturb: float = 1.0
    use_viewdirs: bool = True
    multires: int = 10
    multires_views: int = 4
    raw_noise_std: float = 0.0
    lindisp: bool = False
    ndc: bool = True
    near: float = 0.0
    far: float = 1.0
    H: int = 0
    W: int = 0
    focal: float = 0.0
    render_rmnearplane: int = 0
    rgb_add_bias: bool = False
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
    kernel_type: str = "none"
    kernel_feat_cnl: int = 15
    use_awp: bool = False

    @property
    def composite_feature_coarse(self) -> bool:
        return self.kernel_type == "PBE"


def config_from_args(args, aabb, H, W, focal, near, far) -> RenderConfig:
    """Build a RenderConfig from parsed flags and dataset-derived values.

    Raises NotImplementedError for settings the port does not render yet,
    naming the ROADMAP item that adds them, instead of rendering something
    else: ``mode=nerf``, a fine cull at eval, bf16 tables.
    """
    if args.mode != "c2f":
        raise NotImplementedError(
            f"mode={args.mode}: the port renders c2f fields only; the "
            "vanilla-NeRF field is ROADMAP.md queue 1 item 19")
    if (getattr(args, "fine_cull_capacity", 0.0) or 0.0) > 0.0:
        raise NotImplementedError(
            "fine_cull_capacity > 0: the transmittance fine cull is "
            "ROADMAP.md queue 1 item 17; render with --fine_cull_capacity 0")
    if getattr(args, "triplane_bf16", False):
        raise NotImplementedError(
            "triplane_bf16: the port samples f32 tables; bf16 tables are "
            "ROADMAP.md queue 1 item 24; pass --no_triplane_bf16")
    if args.N_importance <= 0:
        raise NotImplementedError(
            "N_importance=0: the port renders coarse-to-fine with an "
            "importance pass; a coarse-only render is not ported yet")
    return RenderConfig(
        mode=args.mode, N_samples=args.N_samples,
        N_importance=args.N_importance, perturb=args.perturb,
        use_viewdirs=args.use_viewdirs,
        multires=args.multires, multires_views=args.multires_views,
        raw_noise_std=args.raw_noise_std, lindisp=args.lindisp,
        ndc=not args.no_ndc, near=float(near), far=float(far),
        H=int(H), W=int(W), focal=float(focal),
        render_rmnearplane=args.render_rmnearplane,
        rgb_add_bias=args.rgb_add_bias,
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
        kernel_type=args.kernel_type,
        kernel_feat_cnl=args.kernel_feat_cnl, use_awp=args.kernel_use_awp)


class Renderer(nn.Module):
    """Coarse and fine c2f fields (``mlp_coarse``, ``mlp_fine``) and the
    eval render of a ray batch."""

    def __init__(self, cfg: RenderConfig,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        if cfg.mode != "c2f" or cfg.N_importance <= 0:
            raise NotImplementedError(
                "the port renders c2f fields with an importance pass only "
                "(ROADMAP.md queue 1 item 19 adds mode=nerf)")
        self.cfg = cfg
        common = dict(aabb=cfg.aabb, multires=cfg.multires,
                      multires_views=cfg.multires_views,
                      add_bias_color=cfg.rgb_add_bias,
                      render_rmnearplane=cfg.render_rmnearplane,
                      sigma_activate="relu", generator=generator,
                      device=device)
        self.mlp_coarse = VoxelNeRF(
            n_voxels=cfg.coarse_n_voxels, app_n_comp=cfg.coarse_app_n_comp,
            app_dim=cfg.coarse_app_dim, num_layers=cfg.coarse_num_layers,
            hidden_dim=cfg.coarse_hidden_dim,
            geo_feat_dim=cfg.kernel_feat_cnl,
            num_layers_color=cfg.coarse_num_layers_color,
            hidden_dim_color=cfg.coarse_hidden_dim_color,
            composite_feature=cfg.composite_feature_coarse,
            rgb_activate="relu", app_actfn=cfg.coarse_app_actfn, **common)
        self.mlp_fine = VoxelNeRF(
            n_voxels=cfg.fine_n_voxels, app_n_comp=cfg.fine_app_n_comp,
            app_dim=cfg.fine_app_dim,
            in_app_dim=cfg.coarse_app_dim + cfg.fine_app_dim,
            num_layers=cfg.fine_num_layers, hidden_dim=cfg.fine_hidden_dim,
            geo_feat_dim=cfg.fine_geo_feat_dim,
            num_layers_color=cfg.fine_num_layers_color,
            hidden_dim_color=cfg.fine_hidden_dim_color,
            composite_feature=False, rgb_activate="none",
            app_actfn=cfg.fine_app_actfn, **common)

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
            t_rand = torch.rand(z_vals.shape, generator=generator,
                                device=device)
            z_vals = lower + (upper - lower) * t_rand
        return z_vals

    def _noise(self, shape, noise_std: float, generator):
        if noise_std > 0.0:
            return torch.randn(shape, generator=generator,
                               device=self.mlp_coarse.aabb.device) * noise_std
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

    def render_rays(self, rays_o, rays_d, viewdirs, is_train=False,
                    generator=None, want_features=False):
        """c2f render of rays [R, 3] (already NDC if applicable).

        ``is_train`` applies the config's ``perturb`` and ``raw_noise_std``
        with draws from ``generator`` (det importance draws when perturb is
        0) and drops the eval-only near-plane mask. ``want_features`` also
        returns the fine field's per-sample features in depth order
        (``depth_feature``, for AWP). Returns a dict with
        rgb_map/depth_map/acc_map, the coarse rgb0/depth0/acc0, the fine
        weights and sorted z_vals.
        """
        cfg = self.cfg
        R = rays_o.shape[0]
        perturb = cfg.perturb if is_train else 0.0
        noise_std = cfg.raw_noise_std if is_train else 0.0
        z_vals = self._sample_z(R, rays_o.device, perturb, generator)
        pts = (rays_o[..., None, :]
               + rays_d[..., None, :] * z_vals[..., :, None])
        noise_c = self._noise((R, cfg.N_samples - 1), noise_std, generator)
        ft_coarse = self.mlp_coarse.sample(pts)
        rgb0, depth0, acc0, weights, _ = self.mlp_coarse(
            pts, viewdirs, ft_coarse, z_vals, rays_d, noise=noise_c,
            is_train=is_train)

        z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        z_samples = sample_pdf(z_mid, weights[..., 1:-1], cfg.N_importance,
                               det=perturb == 0.0, generator=generator)
        z_cat = torch.cat([z_vals, z_samples], -1)
        z_all, perm, inv_perm = lane_shuffle.sort_with_perm(z_cat)
        pts_new = (rays_o[..., None, :]
                   + rays_d[..., None, :] * z_samples[..., :, None])
        pts_cat = (rays_o[..., None, :]
                   + rays_d[..., None, :] * z_cat[..., :, None])
        ft = torch.cat([torch.cat([ft_coarse, self.mlp_coarse.sample(pts_new)],
                                  1),
                        self.mlp_fine.sample(pts_cat)], -1)
        noise_f = self._noise((R, z_cat.shape[-1] - 1), noise_std, generator)
        rgb, depth, acc, weights, feature = self.mlp_fine(
            pts_cat, viewdirs, ft, z_all, rays_d, noise=noise_f,
            is_train=is_train, perm=perm, inv_perm=inv_perm,
            want_features=want_features)
        ret = dict(rgb_map=rgb, depth_map=depth, acc_map=acc, rgb0=rgb0,
                   depth0=depth0, acc0=acc0, weights=weights, z_vals=z_all)
        if feature is not None:
            ret["depth_feature"] = feature
        return ret

    def render(self, rays: torch.Tensor, is_train=False, generator=None,
               want_features=False):
        """Render rays given as [R, 3, 2] (origin, direction on the last
        axis), applying viewdir normalisation and NDC; the NDC directions
        come back as ``rays_d``."""
        rays_o, rays_d, viewdirs = self._unpack_rays(rays)
        ret = self.render_rays(rays_o, rays_d, viewdirs, is_train=is_train,
                               generator=generator,
                               want_features=want_features)
        ret["rays_d"] = rays_d
        return ret

    def tv_loss(self) -> torch.Tensor:
        """Grid TV regulariser x5 (ref: renderer.py:361-365)."""
        return (self.mlp_coarse.tv_loss_app()
                + self.mlp_fine.tv_loss_app()) * 5.0
