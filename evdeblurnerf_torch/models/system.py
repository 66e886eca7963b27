"""Top-level model: the renderer (c2f voxel fields or NeRF MLPs), the blur
kernel (RBK, DSK or PBE) and AWP.

Counterpart of ``evdeblurnerf_tpu/models/system.py::EvDeblurNeRF``. Like
the reference's ``NeRFAll`` (ref: networks/renderer.py:14-626) it holds the
fields directly as ``mlp_coarse`` / ``mlp_fine``, the blur kernel as
``kernelsnet`` (with the view embedding inside it, as
``kernelsnet.view_embed_module`` for RBK and ``kernelsnet.img_embed`` for
DSK and PBE) and AWP as ``awpnet``, so its state dict keys are the
reference's. Built without a :class:`KernelConfig` it is the eval renderer
alone (the serving path).

The random draws of one training forward come from one generator, in
the order the forward runs: for PBE the stage-0 pattern jitter and the
stage-0 coarse render's draws (depth jitter, sigma noise), then the
kernel's pattern jitter (DSK, PBE), then the main render's (depth jitter,
coarse sigma noise, importance draws, fine sigma noise).

The two culls of ``models/renderer.py`` reach every render of a training
forward (the PBE stage-0 pass and the event renders included), as in the
JAX package; :func:`build_occ_grid` refreshes the occupancy grid the
coarse cull reads.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from ..ops import occupancy
from .awp import AdaptiveWeightProposal
from .blur_dsk import DSKBlurModel
from .blur_rbk import RigidBlurringModel
from .embedding import ViewEmbedding, ViewEmbeddingMLP
from .renderer import Renderer, RenderConfig


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """Blur-kernel / AWP configuration (the fields of the JAX package's
    ``KernelConfig``)."""

    kernel_type: str = "none"         # none | DSK | PBE | RBK
    ptnum: int = 5
    # view embedding (ref: run_nerf.py:167-180)
    img_embed_type: str = "param"     # param | param_mlp
    img_embed_init: str = "zero"
    img_embed_cnl: int = 32
    img_mlp_embed: int = 32
    img_mlp_depth: int = 4
    img_mlp_skips: int = 4
    # DSK/PBE (ref: run_nerf.py:183-203)
    hwindow: int = 10
    random_hwindow: float = 0.25
    rand_embed: int = 3
    random_mode: str = "input"
    spatial_embed: int = 0
    depth_embed: int = 0
    num_hidden: int = 3
    num_wide: int = 64
    feat_cnl: int = 15
    shortcut: bool = False
    pattern_init_radius: float = 0.1
    isglobal: bool = False
    global_trans: bool = False
    spatialvariant_trans: bool = False
    # RBK (ref: run_nerf.py:204-215)
    rbk_extra_feat_ch: int = 15
    rbk_se_r_depth: int = 1
    rbk_se_r_width: int = 32
    rbk_se_r_output_ch: int = 3
    rbk_se_v_depth: int = 1
    rbk_se_v_width: int = 32
    rbk_se_v_output_ch: int = 3
    rbk_ccw_depth: int = 1
    rbk_ccw_width: int = 32
    rbk_se_rv_window: float = 0.2
    rbk_use_origin: bool = True
    # AWP (ref: run_nerf.py:221-229)
    use_awp: bool = False
    awp_sam_emb_depth: int = 4
    awp_sam_emb_width: int = 32
    awp_mot_emb_depth: int = 1
    awp_mot_emb_width: int = 32
    awp_ray_dir_freq: int = 2


def kernel_config_from_args(args) -> KernelConfig:
    return KernelConfig(
        kernel_type=("DSK" if args.kernel_type == "kernel"
                     else args.kernel_type),
        ptnum=args.kernel_ptnum,
        img_embed_type=args.kernel_img_embed_type,
        img_embed_init=args.kernel_img_embed_init,
        img_embed_cnl=args.kernel_img_embed,
        img_mlp_embed=args.kernel_img_mlp_embed,
        img_mlp_depth=args.kernel_img_mlp_depth,
        img_mlp_skips=args.kernel_img_mlp_skips,
        hwindow=args.kernel_hwindow,
        random_hwindow=args.kernel_random_hwindow,
        rand_embed=args.kernel_rand_embed,
        random_mode=args.kernel_random_mode,
        spatial_embed=args.kernel_spatial_embed,
        depth_embed=args.kernel_depth_embed,
        num_hidden=args.kernel_num_hidden, num_wide=args.kernel_num_wide,
        feat_cnl=args.kernel_feat_cnl, shortcut=args.kernel_shortcut,
        pattern_init_radius=args.kernel_pattern_init_radius,
        isglobal=args.kernel_isglobal,
        global_trans=args.kernel_global_trans,
        spatialvariant_trans=args.kernel_spatialvariant_trans,
        rbk_extra_feat_ch=args.kernel_rbk_extra_feat_ch,
        rbk_se_r_depth=args.kernel_rbk_se_r_depth,
        rbk_se_r_width=args.kernel_rbk_se_r_width,
        rbk_se_r_output_ch=args.kernel_rbk_se_r_output_ch,
        rbk_se_v_depth=args.kernel_rbk_se_v_depth,
        rbk_se_v_width=args.kernel_rbk_se_v_width,
        rbk_se_v_output_ch=args.kernel_rbk_se_v_output_ch,
        rbk_ccw_depth=args.kernel_rbk_ccw_depth,
        rbk_ccw_width=args.kernel_rbk_ccw_width,
        rbk_se_rv_window=args.kernel_rbk_se_rv_window,
        rbk_use_origin=args.kernel_rbk_use_origin,
        use_awp=args.kernel_use_awp,
        awp_sam_emb_depth=args.kernel_awp_sam_emb_depth,
        awp_sam_emb_width=args.kernel_awp_sam_emb_width,
        awp_mot_emb_depth=args.kernel_awp_mot_emb_depth,
        awp_mot_emb_width=args.kernel_awp_mot_emb_width,
        awp_ray_dir_freq=args.kernel_awp_ray_dir_freq)


class EvDeblurNeRF(Renderer):
    """The c2f renderer with the eval entry point and, given a
    :class:`KernelConfig`, the blur kernel, AWP and the training
    forward."""

    def __init__(self, cfg: RenderConfig, kcfg: Optional[KernelConfig] = None,
                 num_images: int = 0,
                 generator: torch.Generator | None = None, device=None,
                 K=None, eval_f32_interp: bool = False):
        """``K``: the [3, 3] intrinsics the DSK/PBE kernels re-derive their
        rays through; the centred pinhole of ``cfg`` (H, W, focal) when
        None. ``eval_f32_interp``: :class:`Renderer`'s."""
        super().__init__(cfg, generator=generator, device=device,
                         eval_f32_interp=eval_f32_interp)
        self.kcfg = kcfg
        self.kernelsnet = None
        self.awpnet = None
        if K is None:
            K = [[cfg.focal, 0.0, cfg.W / 2], [0.0, cfg.focal, cfg.H / 2],
                 [0.0, 0.0, 1.0]]
        self.register_buffer(
            "K", torch.as_tensor(K, dtype=torch.float32, device=device),
            persistent=False)
        if kcfg is None or kcfg.kernel_type == "none":
            return
        if kcfg.img_embed_type == "param":
            view = ViewEmbedding(num_images, kcfg.img_embed_cnl,
                                 kcfg.img_embed_init, generator, device)
            view_cnl = kcfg.img_embed_cnl
        else:
            view = ViewEmbeddingMLP(
                num_images, kcfg.img_embed_cnl, D=kcfg.img_mlp_depth,
                W=kcfg.img_mlp_embed, skips=(kcfg.img_mlp_skips,),
                init=kcfg.img_embed_init, generator=generator, device=device)
            view_cnl = kcfg.img_mlp_embed
        if kcfg.kernel_type in ("DSK", "PBE"):
            self.kernelsnet = DSKBlurModel(
                view, num_img=num_images, num_pt=kcfg.ptnum,
                kernel_hwindow=kcfg.hwindow, kernel_type=kcfg.kernel_type,
                img_embed_cnl=view_cnl, random_hwindow=kcfg.random_hwindow,
                random_mode=kcfg.random_mode, in_embed=kcfg.rand_embed,
                spatial_embed=kcfg.spatial_embed,
                depth_embed=kcfg.depth_embed, num_hidden=kcfg.num_hidden,
                num_wide=kcfg.num_wide, feat_cnl=kcfg.feat_cnl,
                short_cut=kcfg.shortcut,
                pattern_init_radius=kcfg.pattern_init_radius,
                isglobal=kcfg.isglobal, optim_trans=kcfg.global_trans,
                optim_sv_trans=kcfg.spatialvariant_trans,
                generator=generator, device=device)
        elif kcfg.kernel_type == "RBK":
            self.kernelsnet = RigidBlurringModel(
                view, view_cnl, num_motion=kcfg.ptnum - 1,
                D_r=kcfg.rbk_se_r_depth, W_r=kcfg.rbk_se_r_width,
                D_v=kcfg.rbk_se_v_depth, W_v=kcfg.rbk_se_v_width,
                D_w=kcfg.rbk_ccw_depth, W_w=kcfg.rbk_ccw_width,
                output_ch_r=kcfg.rbk_se_r_output_ch,
                output_ch_v=kcfg.rbk_se_v_output_ch,
                feat_ch=kcfg.rbk_extra_feat_ch,
                rv_window=kcfg.rbk_se_rv_window,
                use_origin=kcfg.rbk_use_origin, generator=generator,
                device=device)
        else:
            raise ValueError(f"kernel_type {kcfg.kernel_type}")
        if kcfg.use_awp:
            if kcfg.kernel_type == "RBK" and not kcfg.rbk_use_origin:
                raise ValueError(
                    "kernel_use_awp requires kernel_rbk_use_origin: the AWP "
                    "head proposes ptnum weights, origin included (ref "
                    "run_nerf.py:224)")
            # ref renderer.py:31: PBE composites the coarse CRR feature,
            # which only exists beside a fine pass
            if kcfg.kernel_type == "PBE" and cfg.N_importance <= 0:
                raise ValueError(
                    "Mixing PBE and AWP is not supported when "
                    "N_importance == 0 (ref renderer.py:31)")
            self.awpnet = AdaptiveWeightProposal(
                num_motion=kcfg.ptnum - 1, input_ch=self.feature_dim,
                view_cnl=view_cnl, D_sam=kcfg.awp_sam_emb_depth,
                W_sam=kcfg.awp_sam_emb_width, D_mot=kcfg.awp_mot_emb_depth,
                W_mot=kcfg.awp_mot_emb_width,
                ray_dir_freq=kcfg.awp_ray_dir_freq, use_origin=True,
                generator=generator, device=device)

    @property
    def view_embed(self) -> torch.nn.Module:
        """The per-image view embedding, which the blur kernel holds under
        the reference's name for its family."""
        net = self.kernelsnet
        return (net.view_embed_module if self.kcfg.kernel_type == "RBK"
                else net.img_embed)

    def train_forward(self, rays: torch.Tensor,
                      rays_info: Optional[Dict[str, torch.Tensor]],
                      force_naive: bool = True, return_pts0_rgb: bool = False,
                      generator: torch.Generator | None = None,
                      with_tv: bool = True, fine_cull: bool = False,
                      coarse_cull: bool = False,
                      occ_grid: Optional[torch.Tensor] = None):
        """The training forward (ref: renderer.py:266-391).

        rays [N, 3, 2]; rays_info holds ``images_idx`` [N] and, for the DSK
        and PBE kernels, ``rays_x``, ``rays_y`` [N] and ``poses`` [N, 3, 4];
        None for the naive event renders. Returns (rgb [N, 3], rgb1 [N, 3]
        (the coarse render; for PBE its mean with the stage-0 render; None
        without an importance pass), other_loss with ``TV`` (the voxel
        fields' only, ``mode=nerf`` has none; left out too where
        ``with_tv`` is off: the event render's caller drops it) and for DSK
        ``align``, other_tensors with ``rgb_awp`` and the pts0 renders).
        ``fine_cull``, ``coarse_cull`` and ``occ_grid`` go to every render
        (``Renderer.render_rays``).
        """
        culls = dict(coarse_cull=coarse_cull, occ_grid=occ_grid)
        other_loss = ({"TV": self.tv_loss()}
                      if with_tv and self.cfg.mode == "c2f" else {})
        other_tensors: Dict[str, torch.Tensor] = {}
        if self.kernelsnet is None or force_naive:
            ret = self.render(rays, is_train=True, generator=generator,
                              fine_cull=fine_cull, **culls)
            rgb, rgb1 = ret["rgb_map"], ret.get("rgb0")
            if return_pts0_rgb:
                other_tensors["stage1_rgb_pts0"] = rgb
                if rgb1 is not None:
                    other_tensors["stage1_rgb1_pts0"] = rgb1
            return rgb, rgb1, other_loss, other_tensors

        kernel_type = self.kcfg.kernel_type
        img_idx = rays_info["images_idx"].reshape(-1)
        img_embed = self.view_embed(img_idx)
        N = rays.shape[0]
        pt_num = self.kernelsnet.num_pt
        align = rgb0_pts = rgb0_stage0 = None
        if kernel_type == "RBK":
            new_rays, weight1 = self.kernelsnet(rays, img_embed)
        else:
            geometry = (self.K, rays_info["rays_x"], rays_info["rays_y"],
                        img_idx, rays_info["poses"], img_embed)
            feats = None
            if kernel_type == "PBE":
                # stage 0: the pattern without features, rendered by the
                # coarse field for its CRR ray features (ref:
                # renderer.py:289-299)
                new_rays0, weight0, _ = self.kernelsnet(
                    *geometry, generator=generator)
                rgb0_flat, feats = self.coarse_render(
                    new_rays0.reshape(-1, 3, 2), is_train=True,
                    generator=generator, **culls)
                rgb0_pts = rgb0_flat.reshape(N, pt_num, 3)
                rgb0_stage0 = torch.sum(rgb0_pts * weight0[..., None], 1)
                feats = feats.reshape(N, pt_num, -1)
            new_rays, weight1, align = self.kernelsnet(
                *geometry, feats=feats, generator=generator)
        ret = self.render(new_rays.reshape(-1, 3, 2), is_train=True,
                          generator=generator,
                          want_features=self.awpnet is not None,
                          fine_cull=fine_cull, **culls)
        rgb_pts = ret["rgb_map"].reshape(N, pt_num, 3)
        rgb1_pts = (ret["rgb0"].reshape(N, pt_num, 3) if "rgb0" in ret
                    else None)
        rgb = torch.sum(rgb_pts * weight1[..., None], 1)
        if self.awpnet is not None:
            ccw = self.awpnet(ret["depth_feature"], ret["z_vals"],
                              ret["rays_d"], img_embed)
            # reference-literal (ref: renderer.py:316-317), a no-op in value
            # and gradient: the weights already sum to 1
            ccw = ccw + ccw * self.awpnet.ccw_fine_scale
            ccw = ccw / torch.sum(ccw, -1, keepdim=True)
            other_tensors["rgb_awp"] = torch.sum(rgb_pts * ccw[..., None], 1)
        rgb1 = None
        if rgb1_pts is not None:
            rgb1 = torch.sum(rgb1_pts * weight1[..., None], 1)
            if kernel_type == "PBE":
                rgb1 = (rgb0_stage0 + rgb1) / 2.0
        if align is not None:
            other_loss["align"] = align.reshape(1, 1)
        other_tensors["stage1_img_embed"] = img_embed
        if return_pts0_rgb:
            if kernel_type == "PBE":
                other_tensors["stage0_rgb_pts0"] = rgb0_pts[:, 0]
            other_tensors["stage1_rgb_pts0"] = rgb_pts[:, 0]
            if rgb1_pts is not None:
                other_tensors["stage1_rgb1_pts0"] = rgb1_pts[:, 0]
        return rgb, rgb1, other_loss, other_tensors

    @torch.inference_mode()
    def render_chunk(self, rays: torch.Tensor, fine_cull: bool = False):
        """Deterministic eval render of a ray chunk [R, 3, 2] (perturb 0, no
        sigma noise, no coarse cull). ``fine_cull``: the transmittance fine
        cull at eval too (``--fine_cull_eval``), deterministic since the
        importance depths are. Returns (rgb [R, 3], depth [R], acc [R])."""
        ret = self.render(rays, fine_cull=fine_cull)
        return ret["rgb_map"], ret["depth_map"], ret["acc_map"]


@torch.no_grad()
def build_occ_grid(model: Renderer) -> torch.Tensor:
    """The occupancy grid [G*G, G] (f32 bits) of the current coarse field:
    its raw density at the voxel centres, thresholded at the alpha of one
    sample interval ``(far - near) / N_samples`` and dilated
    (``evdeblurnerf_tpu/models/system.py::build_occ_grid``). Derived
    state: the loop refreshes it and never checkpoints it."""
    cfg = model.cfg
    delta = (cfg.far - cfg.near) / cfg.N_samples
    return occupancy.grid_from_sigma(model.coarse_sigma_grid(), delta,
                                     cfg.occ_eps, cfg.occ_dilate)
