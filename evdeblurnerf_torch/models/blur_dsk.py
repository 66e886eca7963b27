"""DSK / PBE deformable-sparse-kernel blur model.

Counterpart of ``evdeblurnerf_tpu/models/blur_dsk.py`` (ref:
networks/pdrf/blurmodel.py:9-224): a learnable per-image canonical 2D point
pattern (tanh-bounded by ``kernel_hwindow``, jittered during training), an
MLP over [pattern-position embedding, view embedding, (PBE: stage-0 ray
features), spatial embedding] that predicts per-point pixel offsets,
optional ray-origin translations and softmax weights, and the world rays
re-derived through the intrinsics and the per-ray poses.

Parameters carry the reference's names (``kernelsnet.pattern_pos``,
``kernelsnet.pattern_trans``, ``kernelsnet.linears.{0,2,4}``,
``kernelsnet.linears1.{0,2}``: the ReLUs sit at the odd slots of the two
Sequentials, and the view embedding at ``kernelsnet.img_embed``), so a
reference ``network_state_dict`` loads strictly. The pattern jitter is drawn
from the ``torch.Generator`` the caller passes in.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from .embedding import positional_encoding, positional_encoding_dim


def dsk_linear(in_features: int, out_features: int,
               generator: torch.Generator | None = None,
               device=None) -> nn.Linear:
    """A Linear of the DSK/PBE MLP (ref: utils/misc.py:95-102): xavier-normal
    weight with gain 0.1 for 2- and 3-channel outputs, else 1; zero bias."""
    layer = nn.Linear(in_features, out_features, device=device)
    gain = 0.1 if out_features in (2, 3) else 1.0
    std = gain * math.sqrt(2.0 / (in_features + out_features))
    with torch.no_grad():
        layer.weight.normal_(0.0, std, generator=generator)
        layer.bias.zero_()
    return layer


class DSKBlurModel(nn.Module):
    """DSK ("kernel") / PBE blur kernel: expands each ray into ``num_pt``
    rays through learned pixel offsets of a per-image point pattern."""

    def __init__(self, view_embed: nn.Module, num_img: int, num_pt: int,
                 kernel_hwindow: float, kernel_type: str = "DSK",
                 img_embed_cnl: int = 32, random_hwindow: float = 0.25,
                 random_mode: str = "input", in_embed: int = 3,
                 spatial_embed: int = 0, depth_embed: int = 0,
                 num_hidden: int = 3, num_wide: int = 64, feat_cnl: int = 15,
                 short_cut: bool = False, pattern_init_radius: float = 0.1,
                 isglobal: bool = False, optim_trans: bool = False,
                 optim_sv_trans: bool = False,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        if random_mode not in ("input", "output"):
            raise ValueError(f"kernel_random_mode {random_mode!r}")
        if random_hwindow > 0 and random_mode == "output":
            # the reference accepts the flag and raises at its first forward
            # (ref: pdrf/blurmodel.py:196-197)
            raise NotImplementedError(
                "kernel_random_mode='output' is unimplemented upstream "
                "(ref pdrf/blurmodel.py:196) and here; use 'input'")
        if depth_embed > 0:
            # upstream reads rays_info['ray_depth'], which no caller provides
            raise NotImplementedError(
                "kernel_depth_embed is dead upstream (rays_info['ray_depth'] "
                "is never provided; ref pdrf/blurmodel.py:29,157-161) and "
                "not implemented here")
        if kernel_type not in ("DSK", "PBE"):
            raise ValueError(f"kernel_type {kernel_type!r}")
        self.img_embed = view_embed
        self.num_pt = num_pt
        self.kernel_hwindow = kernel_hwindow
        self.kernel_type = kernel_type
        self.img_embed_cnl = img_embed_cnl
        self.random_hwindow = random_hwindow
        self.in_embed = in_embed
        self.spatial_embed = spatial_embed
        self.feat_cnl = feat_cnl
        self.short_cut = short_cut
        self.isglobal = isglobal
        self.optim_trans = optim_trans
        self.optim_sv_trans = optim_sv_trans

        pattern_num = 1 if isglobal else num_img
        self.pattern_pos = nn.Parameter(pattern_init_radius * torch.randn(
            pattern_num, num_pt, 2, generator=generator, device=device))
        if optim_trans:
            self.pattern_trans = nn.Parameter(torch.zeros(
                pattern_num, num_pt, 2, device=device))

        in_cnl = (positional_encoding_dim(in_embed, 2) if in_embed > 0 else 0)
        in_cnl += img_embed_cnl
        if kernel_type == "PBE":
            in_cnl += feat_cnl
        if spatial_embed > 0:
            in_cnl += positional_encoding_dim(spatial_embed, 2)
        out_cnl = 1 + 2 + 2 if optim_sv_trans else 1 + 2

        # num_hidden ReLU layers, then a 2-layer head (ref:
        # blurmodel.py:96-107)
        hidden, width = [], in_cnl
        for _ in range(num_hidden):
            hidden += [dsk_linear(width, num_wide, generator, device),
                       nn.ReLU()]
            width = num_wide
        self.linears = nn.Sequential(*hidden)
        if short_cut:
            width += in_cnl
        self.linears1 = nn.Sequential(
            dsk_linear(width, num_wide, generator, device), nn.ReLU(),
            dsk_linear(num_wide, out_cnl, generator, device))

    def forward(self, K: torch.Tensor, rays_x: torch.Tensor,
                rays_y: torch.Tensor, img_idx: torch.Tensor,
                poses: torch.Tensor, img_embed: torch.Tensor,
                feats: Optional[torch.Tensor] = None, is_train: bool = True,
                generator: torch.Generator | None = None):
        """K [3, 3] intrinsics; rays_x / rays_y [N] pixel-centre coordinates
        (already + 0.5); img_idx [N]; poses [N, 3, 4] per-ray camera-to-world;
        img_embed [N, C_img]; feats [N, num_pt, feat_cnl] stage-0 ray
        features (PBE only, zeros when None). The pattern jitter (training,
        ``random_hwindow`` > 0) is drawn from ``generator``.

        Returns (new_rays [N, num_pt, 3, 2], weight [N, num_pt], align):
        ``align`` is the point-0 drift term for DSK and None for PBE, which
        pins point 0 to the undeformed ray.
        """
        N, P = rays_x.shape[0], self.num_pt
        img_idx = img_idx.long()
        # the canonical pattern and its jitter (ref: blurmodel.py:121-133)
        pt_pos = (self.pattern_pos.expand(N, P, 2) if self.isglobal
                  else self.pattern_pos[img_idx])
        pt_pos = torch.tanh(pt_pos) * self.kernel_hwindow
        if self.random_hwindow > 0 and is_train:
            pt_pos = pt_pos + self.random_hwindow * torch.randn(
                pt_pos.shape, generator=generator, device=pt_pos.device)
        input_pos = pt_pos
        x = []
        if self.in_embed > 0:
            x.append(positional_encoding(
                pt_pos * (math.pi / self.kernel_hwindow), self.in_embed))
        x.append(img_embed[:, None, :].expand(N, P, self.img_embed_cnl))
        if self.kernel_type == "PBE":
            if feats is None:
                feats = pt_pos.new_zeros(N, P, self.feat_cnl)
            x.append(feats.reshape(N, P, -1))
        if self.spatial_embed > 0:
            # pixel coordinates scaled to [-pi, pi] by the image size
            # 2 * K[., 2] (ref: blurmodel.py:149-155)
            spatialx = rays_x / (2.0 * K[0, 2] / 2 / math.pi) - math.pi
            spatialy = rays_y / (2.0 * K[1, 2] / 2 / math.pi) - math.pi
            spatial = positional_encoding(
                torch.stack([spatialx, spatialy], -1), self.spatial_embed)
            x.append(spatial[:, None, :].expand(N, P, spatial.shape[-1]))
        x = torch.cat(x, -1)

        h = self.linears(x)
        if self.short_cut:
            h = torch.cat([x, h], -1)
        out = self.linears1(h)

        delta_trans = None
        if self.optim_sv_trans:
            delta_trans, delta_pos, weight = (out[..., :2], out[..., 2:4],
                                              out[..., 4])
        else:
            delta_pos, weight = out[..., :2], out[..., 2]
        if self.optim_trans:
            delta_trans = (self.pattern_trans.expand(N, P, 2) if self.isglobal
                           else self.pattern_trans[img_idx])
        if delta_trans is None:
            delta_trans = torch.zeros_like(delta_pos)
        delta_trans = delta_trans * 0.01

        new_rays_xy = delta_pos + input_pos
        if self.kernel_type == "PBE":
            # point 0 is the sharp ray: undeformed, untranslated (ref:
            # blurmodel.py:187-189)
            keep = torch.ones(P, 1, device=out.device)
            keep[0] = 0.0
            new_rays_xy = new_rays_xy * keep
            delta_trans = delta_trans * keep
            align = None
        else:
            # the drift of point 0 (ref: blurmodel.py:192-193)
            align = (new_rays_xy[:, 0, :].abs().mean()
                     + delta_trans[:, 0, :].abs().mean() * 10.0)
        weight = torch.softmax(weight, -1)

        # world rays through K and the per-ray poses (ref:
        # blurmodel.py:199-218)
        rx = (rays_x[:, None] - K[0, 2] + new_rays_xy[..., 0]) / K[0, 0]
        ry = -(rays_y[:, None] - K[1, 2] + new_rays_xy[..., 1]) / K[1, 1]
        dirs = torch.stack([rx - delta_trans[..., 0],
                            ry - delta_trans[..., 1],
                            -torch.ones_like(rx)], -1)          # [N, P, 3]
        rays_d = torch.sum(dirs[..., None, :] * poses[:, None, :3, :3], -1)
        translation = torch.stack([delta_trans[..., 0], delta_trans[..., 1],
                                   torch.zeros_like(rx),
                                   torch.ones_like(rx)], -1)    # [N, P, 4]
        rays_o = torch.sum(translation[..., None, :] * poses[:, None], -1)
        return torch.stack([rays_o, rays_d], -1), weight, align
