"""Top-level model: the c2f renderer, the RBK blur kernel and AWP.

Counterpart of ``evdeblurnerf_tpu/models/system.py::EvDeblurNeRF``. Like
the reference's ``NeRFAll`` (ref: networks/renderer.py:14-626) it holds the
fields directly as ``mlp_coarse`` / ``mlp_fine``, the blur kernel as
``kernelsnet`` (with the view embedding inside it, as
``kernelsnet.view_embed_module``) and AWP as ``awpnet``, so its state dict
keys are the reference's. Built without a :class:`KernelConfig` it is the
eval renderer alone (the serving path).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from .awp import AdaptiveWeightProposal
from .blur_rbk import RigidBlurringModel
from .embedding import ViewEmbedding, ViewEmbeddingMLP
from .renderer import Renderer, RenderConfig


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """Blur-kernel / AWP configuration (the RBK and AWP fields of the JAX
    package's ``KernelConfig``)."""

    kernel_type: str = "none"         # none | RBK (DSK, PBE: not ported)
    ptnum: int = 5
    img_embed_type: str = "param"
    img_embed_init: str = "zero"
    img_embed_cnl: int = 32
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
                 generator: torch.Generator | None = None, device=None):
        super().__init__(cfg, generator=generator, device=device)
        self.kcfg = kcfg
        self.kernelsnet = None
        self.awpnet = None
        if kcfg is None or kcfg.kernel_type == "none":
            return
        if kcfg.kernel_type != "RBK":
            raise NotImplementedError(
                f"kernel_type={kcfg.kernel_type}: the port has the RBK blur "
                "kernel only; DSK and PBE are ROADMAP.md queue 1 item 18")
        if kcfg.img_embed_type != "param":
            ViewEmbeddingMLP()
        view = ViewEmbedding(num_images, kcfg.img_embed_cnl,
                             kcfg.img_embed_init, generator, device)
        self.kernelsnet = RigidBlurringModel(
            view, kcfg.img_embed_cnl, num_motion=kcfg.ptnum - 1,
            D_r=kcfg.rbk_se_r_depth, W_r=kcfg.rbk_se_r_width,
            D_v=kcfg.rbk_se_v_depth, W_v=kcfg.rbk_se_v_width,
            D_w=kcfg.rbk_ccw_depth, W_w=kcfg.rbk_ccw_width,
            output_ch_r=kcfg.rbk_se_r_output_ch,
            output_ch_v=kcfg.rbk_se_v_output_ch,
            feat_ch=kcfg.rbk_extra_feat_ch, rv_window=kcfg.rbk_se_rv_window,
            use_origin=kcfg.rbk_use_origin, generator=generator,
            device=device)
        if kcfg.use_awp:
            if not kcfg.rbk_use_origin:
                raise ValueError(
                    "kernel_use_awp requires kernel_rbk_use_origin: the AWP "
                    "head proposes ptnum weights, origin included (ref "
                    "run_nerf.py:224)")
            self.awpnet = AdaptiveWeightProposal(
                num_motion=kcfg.ptnum - 1, input_ch=cfg.fine_geo_feat_dim,
                view_cnl=kcfg.img_embed_cnl, D_sam=kcfg.awp_sam_emb_depth,
                W_sam=kcfg.awp_sam_emb_width, D_mot=kcfg.awp_mot_emb_depth,
                W_mot=kcfg.awp_mot_emb_width,
                ray_dir_freq=kcfg.awp_ray_dir_freq, use_origin=True,
                generator=generator, device=device)

    def train_forward(self, rays: torch.Tensor,
                      rays_info: Optional[Dict[str, torch.Tensor]],
                      force_naive: bool = True, return_pts0_rgb: bool = False,
                      generator: torch.Generator | None = None,
                      with_tv: bool = True):
        """The training forward (ref: renderer.py:266-391).

        rays [N, 3, 2]; rays_info holds ``images_idx`` [N] (the other
        rays_info entries feed only the DSK/PBE kernels), None for the
        naive event renders. Returns (rgb [N, 3], rgb1 [N, 3] (the coarse
        render), other_loss with ``TV`` (unless ``with_tv`` is off: the
        event render's caller drops it), other_tensors with ``rgb_awp`` and
        the pts0 renders).
        """
        other_loss = {"TV": self.tv_loss()} if with_tv else {}
        other_tensors: Dict[str, torch.Tensor] = {}
        if self.kernelsnet is None or force_naive:
            ret = self.render(rays, is_train=True, generator=generator)
            rgb, rgb1 = ret["rgb_map"], ret["rgb0"]
            if return_pts0_rgb:
                other_tensors["stage1_rgb_pts0"] = rgb
                other_tensors["stage1_rgb1_pts0"] = rgb1
            return rgb, rgb1, other_loss, other_tensors

        img_embed = self.kernelsnet.view_embed_module(
            rays_info["images_idx"].reshape(-1))
        N = rays.shape[0]
        pt_num = self.kernelsnet.num_pt
        new_rays, weight1 = self.kernelsnet(rays, img_embed)
        ret = self.render(new_rays.reshape(-1, 3, 2), is_train=True,
                          generator=generator,
                          want_features=self.awpnet is not None)
        rgb_pts = ret["rgb_map"].reshape(N, pt_num, 3)
        rgb1_pts = ret["rgb0"].reshape(N, pt_num, 3)
        rgb = torch.sum(rgb_pts * weight1[..., None], 1)
        if self.awpnet is not None:
            ccw = self.awpnet(ret["depth_feature"], ret["z_vals"],
                              ret["rays_d"], img_embed)
            # reference-literal (ref: renderer.py:316-317), a no-op in value
            # and gradient: the weights already sum to 1
            ccw = ccw + ccw * self.awpnet.ccw_fine_scale
            ccw = ccw / torch.sum(ccw, -1, keepdim=True)
            other_tensors["rgb_awp"] = torch.sum(rgb_pts * ccw[..., None], 1)
        rgb1 = torch.sum(rgb1_pts * weight1[..., None], 1)
        other_tensors["stage1_img_embed"] = img_embed
        if return_pts0_rgb:
            other_tensors["stage1_rgb_pts0"] = rgb_pts[:, 0]
            other_tensors["stage1_rgb1_pts0"] = rgb1_pts[:, 0]
        return rgb, rgb1, other_loss, other_tensors

    @torch.inference_mode()
    def render_chunk(self, rays: torch.Tensor):
        """Deterministic eval render of a ray chunk [R, 3, 2] (perturb 0, no
        sigma noise, no culls). Returns (rgb [R, 3], depth [R], acc [R])."""
        ret = self.render(rays)
        return ret["rgb_map"], ret["depth_map"], ret["acc_map"]
