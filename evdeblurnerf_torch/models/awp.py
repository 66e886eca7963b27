"""Adaptive Weight Proposal (AWP) and the Motion Aggregation Module (MAM).

Counterpart of ``evdeblurnerf_tpu/models/awp.py`` (ref:
networks/dpnerf/awp.py and mam.py): the fine field's per-sample features
are embedded by a small MLP, integrated per motion, joined with the view
embedding and the ray direction's encoding, run through a motion MLP,
refined by MAM's cross-motion attention, averaged over the motions and
mapped to sigmoid weights normalised per ray.

Parameters carry the reference's names and layouts, so a reference
``network_state_dict`` loads strictly: the 1x1 convolutions of MAM are
``Conv1d``/``Conv2d`` weights [out, in, 1(, 1)], applied here as dense
layers on channels-last tensors; ``MAM.conv`` is the reference's unused
module, kept for strict loading and never run.

Kept from the reference on purpose: ``feature_integration`` runs its
transmittance cumprod over the FEATURE axis (ref: awp.py:70-73), through
the one-pass cumprod backward of ``ops/compositing.py``. The MAM
BatchNorm is torch's ``BatchNorm1d(momentum=0.1, eps=1e-5)``, the
reference's own module: the JAX package's flax ``BatchNorm(momentum=0.9)``
normalises the same way, but its running variance takes the biased batch
variance where torch takes the unbiased one (a factor n / (n - 1) on the
update, n = rays x motions). In a data-parallel step the BatchNorm takes
the statistics of every rank's rays (``parallel/mesh.py::batch_norm``),
as flax BatchNorm over a sharded global batch does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.compositing import CumprodLanes
from ..parallel import mesh
from .embedding import positional_encoding, positional_encoding_dim
from .layers import make_linear


def _dense(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A bias-free 1x1 convolution applied to channels-last ``x``."""
    return F.linear(x, conv.weight.reshape(conv.weight.shape[0], -1))


def _conv1x1(cin: int, cout: int, generator, device) -> nn.Conv1d:
    conv = nn.Conv1d(cin, cout, 1, bias=False, device=device)
    bound = 1.0 / cin ** 0.5
    with torch.no_grad():
        conv.weight.uniform_(-bound, bound, generator=generator)
    return conv


class CorrelationModule(nn.Module):
    """Inter/intra-motion attention (ref: networks/dpnerf/mam.py:13-53).
    x [B, N, C] global motion features, curves [B, N, L, Cc] local
    per-sample features; returns [B, N, C]."""

    def __init__(self, in_channel: int, curve_channel: int = 32,
                 generator=None, device=None):
        super().__init__()
        mid = in_channel // 2
        self.line_conv_att = nn.Conv2d(curve_channel, 1, 1, bias=False,
                                       device=device)
        with torch.no_grad():
            bound = 1.0 / curve_channel ** 0.5
            self.line_conv_att.weight.uniform_(-bound, bound,
                                               generator=generator)
        self.conva = _conv1x1(curve_channel, mid, generator, device)
        self.convb = _conv1x1(curve_channel, mid, generator, device)
        self.convc = _conv1x1(in_channel, mid, generator, device)
        self.convn = _conv1x1(mid, mid, generator, device)
        self.convl = _conv1x1(mid, mid, generator, device)
        self.convd = nn.Sequential(
            _conv1x1(2 * mid, in_channel, generator, device),
            nn.BatchNorm1d(in_channel, eps=1e-5, momentum=0.1,
                           device=device))

    def forward(self, x: torch.Tensor, curves: torch.Tensor) -> torch.Tensor:
        att = _dense(self.line_conv_att, curves)[..., 0]            # [B,N,L]
        inter_w = torch.softmax(att, -1)
        curver_inter = torch.einsum("bnlc,bnl->bnc", curves, inter_w)
        intra_w = torch.softmax(att, -2)
        curves_intra = torch.einsum("bnlc,bnl->blc", curves, intra_w)
        curver_inter = _dense(self.conva, curver_inter)            # [B,N,mid]
        curves_intra = _dense(self.convb, curves_intra)            # [B,L,mid]
        x_logits = _dense(self.convc, x)
        x_inter = torch.softmax(
            torch.einsum("bnm,bkm->bnk", x_logits, curver_inter), -1)
        x_intra = torch.softmax(
            torch.einsum("bnm,blm->bnl", x_logits, curves_intra), -1)
        curver_inter = _dense(self.convn, curver_inter)
        curves_intra = _dense(self.convl, curves_intra)
        x_inter = torch.einsum("bnk,bkm->bnm", x_inter, curver_inter)
        x_intra = torch.einsum("bnl,blm->bnm", x_intra, curves_intra)
        h = _dense(self.convd[0], torch.cat([x_inter, x_intra], -1))
        h = mesh.batch_norm(self.convd[1],
                            h.reshape(-1, h.shape[-1])).reshape(h.shape)
        return F.leaky_relu(x + h, negative_slope=0.2)


class MotionAggregationModule(nn.Module):
    """CorrelationModule behind the local-feature projection (ref:
    networks/dpnerf/mam.py:56-84)."""

    def __init__(self, in_channels: int, local_channels: int,
                 generator=None, device=None):
        super().__init__()
        self.linear = make_linear(local_channels, 32, "torch", generator,
                                  device)
        self.Corr = CorrelationModule(in_channels, 32, generator, device)
        # the reference's unused module, kept for strict loading
        self.conv = nn.Sequential(
            nn.Conv2d(2 * in_channels, in_channels, 1, bias=False,
                      device=device),
            nn.BatchNorm2d(in_channels, device=device))

    def forward(self, x_global: torch.Tensor, x_local: torch.Tensor
                ) -> torch.Tensor:
        """x_global [B, num_pt, C]; x_local [B*num_pt, S, D]."""
        B, num_pt, _ = x_global.shape
        x_local = self.linear(x_local.reshape(B, num_pt, x_local.shape[1], -1))
        return self.Corr(x_global, x_local)


class AdaptiveWeightProposal(nn.Module):
    """DP-NeRF adaptive weight proposal (ref: networks/dpnerf/awp.py:9-117).
    ``ccw_fine_scale`` is the reference's recomposition constant, a no-op
    in value and gradient (``models/system.py``)."""

    ccw_fine_scale = 0.05

    def __init__(self, num_motion: int, input_ch: int, view_cnl: int,
                 D_sam: int = 4, W_sam: int = 32, D_mot: int = 1,
                 W_mot: int = 32, ray_dir_freq: int = 2,
                 use_origin: bool = True, generator=None, device=None):
        super().__init__()
        self.output_ch = num_motion + 1 if use_origin else num_motion
        self.ray_dir_freq = ray_dir_freq
        self.W_sam = W_sam
        self.sample_feature_embed_layer = nn.ModuleList(
            make_linear(input_ch if i == 0 else W_sam, W_sam, "torch",
                        generator, device) for i in range(D_sam))
        width = W_sam + view_cnl + positional_encoding_dim(ray_dir_freq)
        # D_mot + 1 layers (ref: awp.py:41-43 appends D_mot extras)
        self.motion_feature_embed_layer = nn.ModuleList(
            make_linear(width if i == 0 else W_mot, W_mot, "torch",
                        generator, device) for i in range(D_mot + 1))
        self.MAM = MotionAggregationModule(W_mot, W_sam, generator, device)
        self.w_linear = make_linear(W_mot, self.output_ch, "torch",
                                    generator, device)

    @staticmethod
    def feature_integration(feat: torch.Tensor, z_vals: torch.Tensor,
                            rays_d: torch.Tensor) -> torch.Tensor:
        """The reference's "volumetric" feature integration (ref:
        awp.py:49-77), cumprod over the feature axis. feat [N_ray, num_pt,
        S, D]; z_vals [N_ray*num_pt, S]; rays_d [N_ray*num_pt, 3].
        Returns [N_ray, num_pt, D]."""
        N_ray, num_pt, S, D = feat.shape
        feat = feat.reshape(-1, S, D)
        dists = z_vals[..., 1:] - z_vals[..., :-1]
        dists = dists * torch.linalg.vector_norm(rays_d[..., None, :], dim=-1)
        alpha = 1.0 - torch.exp(-feat[..., :-1, :] * dists[..., None])
        alpha = torch.cat([alpha, torch.zeros_like(alpha[:, :1])], -2)
        trans = CumprodLanes.apply(torch.cat(
            [torch.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-10], -2))
        weights = alpha * trans[:, :-1, :]
        return torch.sum(weights * feat, -2).reshape(N_ray, num_pt, D)

    def forward(self, depth_feature: torch.Tensor, z_vals: torch.Tensor,
                rays_d: torch.Tensor, view_feature: torch.Tensor
                ) -> torch.Tensor:
        """depth_feature [N_ray*num_pt, S, C] per-sample fine features in
        depth order; z_vals [N_ray*num_pt, S]; rays_d [N_ray*num_pt, 3]
        (NDC); view_feature [N_ray, C_view]. Returns [N_ray, num_pt]
        weights summing to 1. The BatchNorm follows ``self.training``."""
        num_pt = self.output_ch
        N_ray = depth_feature.shape[0] // num_pt
        S = depth_feature.shape[1]
        viewdirs = rays_d.reshape(N_ray, num_pt, 3)[:, 0, :]
        viewdirs = viewdirs / torch.linalg.vector_norm(viewdirs, dim=-1,
                                                       keepdim=True)
        view_embedded = torch.cat(
            [view_feature, positional_encoding(viewdirs, self.ray_dir_freq)],
            -1)
        h = depth_feature
        for layer in self.sample_feature_embed_layer:
            h = torch.relu(layer(h))
        h_local = h                                      # [N*pt, S, W_sam]
        h = self.feature_integration(h.reshape(N_ray, num_pt, S, self.W_sam),
                                     z_vals, rays_d)
        h = torch.cat([h, view_embedded[:, None, :].expand(
            N_ray, num_pt, view_embedded.shape[-1])], -1)
        for layer in self.motion_feature_embed_layer:
            h = torch.relu(layer(h))
        h = self.MAM(h, h_local)
        w = torch.sigmoid(self.w_linear(torch.mean(h, 1)))
        return w / torch.sum(w, -1, keepdim=True)
