"""RBK rigid-blurring model (DP-NeRF).

Counterpart of ``evdeblurnerf_tpu/models/blur_rbk.py`` (ref:
networks/dpnerf/blurmodel.py): three branches over [view embedding,
optional per-motion PDRF features] predict per-ray screw-motion parameters
``r``, ``v`` (``num_motion`` each) and sigmoid-normalised composition
weights; each ray is warped by the SE(3) exponential map of every motion.
Parameters carry the reference's names (``kernelsnet.r_branch.0``,
``kernelsnet.r_linear``, ..., ``kernelsnet.view_embed_module.img_embed``).

Reference quirks kept on purpose:

* every branch layer reads the branch INPUT (ref: blurmodel.py:148-158),
  so with depth > 1 only the last layer of a branch matters;
* the ``r``/``v`` heads start near zero through the reference's xavier
  gain ``1e-5 / sqrt((W + out) / 6)``, whose bound is
  ``1e-5 * 6 / (W + out)`` (~1.6e-6 at the defaults), not the 1e-5 its
  comment claims (ref: blurmodel.py:38-45);
* the weight head emits ``num_pt`` weights (``num_motion + 1`` with the
  origin ray, every published config), where the reference hard-codes
  ``num_motion + 1`` (``docs/PARITY.md:293-294``).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..utils import se3
from .layers import make_linear


class RigidBlurringModel(nn.Module):
    """Screw-motion blur kernel: expands each ray into ``num_pt`` rays."""

    def __init__(self, view_embed: nn.Module, view_embed_cnl: int,
                 num_motion: int = 2, D_r: int = 1, W_r: int = 32,
                 D_v: int = 1, W_v: int = 32, D_w: int = 1, W_w: int = 32,
                 output_ch_r: int = 3, output_ch_v: int = 3,
                 feat_ch: int = 15, rv_window: float = 0.2,
                 use_origin: bool = True,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.view_embed_module = view_embed
        self.num_motion = num_motion
        self.rv_window = rv_window
        self.use_origin = use_origin
        self.num_pt = num_motion + 1 if use_origin else num_motion
        self.total_feat_ch = feat_ch * self.num_pt
        width = view_embed_cnl + self.total_feat_ch

        def branch(depth, w):
            return nn.ModuleList(make_linear(width, w, "torch", generator,
                                             device) for _ in range(depth))

        def tiny_head(w, out):
            layer = make_linear(w, out, "torch", generator, device)
            gain = 1e-5 / math.sqrt((w + out) / 6.0)
            bound = gain * math.sqrt(6.0 / (w + out))
            with torch.no_grad():
                layer.weight.uniform_(-bound, bound, generator=generator)
            return layer

        self.r_branch = branch(D_r, W_r)
        self.r_linear = tiny_head(W_r, output_ch_r * num_motion)
        self.v_branch = branch(D_v, W_v)
        self.v_linear = tiny_head(W_v, output_ch_v * num_motion)
        self.w_branch = branch(D_w, W_w)
        self.w_linear = make_linear(W_w, self.num_pt, "torch", generator,
                                    device)

    def rbk_warp(self, rays: torch.Tensor, r: torch.Tensor,
                 v: torch.Tensor) -> torch.Tensor:
        """Warp [N, 3, 2] rays by the per-motion screw transforms (ref:
        blurmodel.py:51-82). Returns [N, num_pt, 3, 2]."""
        N = rays.shape[0]
        # [N, 3 * num_motion] -> [N, num_motion, 3]: motion i takes every
        # num_motion-th column (the reference's reshape)
        rot = r.reshape(N, 3, self.num_motion).transpose(1, 2)
        trans = v.reshape(N, 3, self.num_motion).transpose(1, 2)
        rays_o, rays_d = rays[..., 0], rays[..., 1]
        transform = se3.se3_transform_from_rot_trans(rot, trans)
        warped_o = se3.se3_warp_points(rays_o[:, None, :], transform)
        warped_end = se3.se3_warp_points((rays_o + rays_d)[:, None, :],
                                         transform)
        warped = torch.stack([warped_o, warped_end - warped_o], -1)
        if self.use_origin:
            warped = torch.cat([rays[:, None], warped], 1)
        return warped

    def rbk_warp_pose(self, poses: torch.Tensor, r: torch.Tensor,
                      v: torch.Tensor) -> torch.Tensor:
        """Warp [N, 3, 4] camera poses per motion (ref:
        dpnerf/blurmodel.py:84-110). Returns [N, num_pt, 4, 4]. Uncalled
        upstream too (training warps rays); it applies :meth:`rbk_warp`'s
        screw motion to the camera."""
        N = poses.shape[0]
        rot = r.reshape(N, 3, self.num_motion).transpose(1, 2)
        trans = v.reshape(N, 3, self.num_motion).transpose(1, 2)
        bottom = torch.eye(4, dtype=poses.dtype,
                           device=poses.device)[3:].expand(N, 1, 4)
        poses_h = torch.cat([poses, bottom], 1)
        transform = se3.se3_transform_from_rot_trans(rot, trans)
        warped = se3.se3_warp_pose(poses_h[:, None], transform)
        if self.use_origin:
            warped = torch.cat([poses_h[:, None], warped], 1)
        return warped

    def rbk_weighted_sum(self, rgb, depth, acc, extras, ccw):
        """Compose per-motion outputs, flattened [N * num_pt, ...], with
        [N, num_pt] weights (ref: dpnerf/blurmodel.py:112-127; the
        reference's renderer calls it at renderer.py:327-329, the port's
        training forward composes inline). Returns (rgb, depth, acc,
        extras) reduced over the motions."""
        def reduce(x):
            x = x.reshape(-1, self.num_pt, *x.shape[1:])
            w = ccw.reshape(*ccw.shape, *([1] * (x.dim() - 2)))
            return torch.sum(x * w, 1)

        return (reduce(rgb), reduce(depth), reduce(acc),
                {k: reduce(v) for k, v in extras.items()})

    def forward(self, rays: torch.Tensor, img_embed: torch.Tensor,
                feats: torch.Tensor | None = None):
        """rays [N, 3, 2]; img_embed [N, C_view]; feats [N, total_feat_ch]
        or None. Returns (new_rays [N, num_pt, 3, 2], weight [N, num_pt])
        (ref: blurmodel.py:129-173)."""
        N = rays.shape[0]
        if feats is None:
            feats = rays.new_zeros(N, self.total_feat_ch)
        h_branch = torch.cat([img_embed, feats.reshape(N, -1)], -1)
        h_r = h_v = h_w = h_branch
        for layer in self.r_branch:
            h_r = torch.relu(layer(h_branch))
        for layer in self.v_branch:
            h_v = torch.relu(layer(h_branch))
        for layer in self.w_branch:
            h_w = torch.relu(layer(h_branch))
        r = self.r_linear(h_r) * self.rv_window
        v = self.v_linear(h_v) * self.rv_window
        weight = torch.sigmoid(self.w_linear(h_w))
        weight = weight / (torch.sum(weight, -1, keepdim=True) + 1e-10)
        return self.rbk_warp(rays, r, v), weight
