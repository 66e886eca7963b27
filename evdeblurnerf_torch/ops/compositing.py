"""Volumetric alpha compositing (raw -> rgb/depth/acc/weights).

Counterpart of ``evdeblurnerf_tpu/ops/compositing.py`` (ref:
networks/pdrf/voxnerf.py:153-201): density is predicted for the first S-1
samples, the last interval's alpha is pinned to 1, and the transmittance
carries the reference's 1e-10 epsilon. The transmittance cumprod has the
JAX package's one-pass backward (:class:`CumprodLanes`).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


class CumprodLanes(torch.autograd.Function):
    """``cumprod`` along the last axis with a one-pass backward,
    ``d_x[i] = (sum_{j >= i} g[j] * y[j]) / x[i]`` (counterpart of
    ``evdeblurnerf_tpu/ops/compositing.py::_cumprod_lanes``). The factors
    it is used on are strictly positive (``1 - alpha + 1e-10``), so the
    division is safe."""

    @staticmethod
    def forward(ctx, x):
        y = torch.cumprod(x, -1)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        suffix = torch.flip(torch.cumsum(torch.flip(g * y, (-1,)), -1), (-1,))
        return suffix / x


def compute_weights(sigma: torch.Tensor, z_vals: torch.Tensor,
                    rays_d: torch.Tensor,
                    sigma_activate: Callable[[torch.Tensor], torch.Tensor],
                    noise: Optional[torch.Tensor] = None,
                    rmnearplane_mask: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Per-sample compositing weights [R, S].

    sigma: [R, S] raw density logits; z_vals: [R, S]; rays_d: [R, 3]
    (interval lengths are scaled by ``|rays_d|``). ``noise``: optional
    [R, S-1] regularisation noise added before the activation (ref:
    voxnerf.py:174-179). ``rmnearplane_mask``: optional [R, S-1]
    multiplier on the density.
    """
    dists = z_vals[..., 1:] - z_vals[..., :-1]                     # [R, S-1]
    dists = dists * torch.linalg.vector_norm(rays_d[..., None, :], dim=-1)

    raw_sigma = sigma[..., :-1]
    if noise is not None:
        raw_sigma = raw_sigma + noise
    density = sigma_activate(raw_sigma)
    if rmnearplane_mask is not None:
        density = density * rmnearplane_mask

    alpha = 1.0 - torch.exp(-density * dists)                      # [R, S-1]
    alpha = torch.cat([alpha, torch.ones_like(alpha[..., :1])], -1)
    trans = CumprodLanes.apply(
        torch.cat([torch.ones_like(alpha[..., :1]), 1.0 - alpha + 1e-10],
                  -1))[..., :-1]
    return alpha * trans


def composite(weights: torch.Tensor, rgb: torch.Tensor, z_vals: torch.Tensor,
              white_bkgd: bool = False):
    """Integrate per-sample rgb [R, S, C] and depth with precomputed
    weights; returns (rgb_map [R, C], depth_map [R], acc_map [R])."""
    rgb_map = torch.sum(weights[..., None] * rgb, -2)
    depth_map = torch.sum(weights * z_vals, -1)
    acc_map = torch.sum(weights, -1)
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])
    return rgb_map, depth_map, acc_map


def rmnearplane_mask(z_vals: torch.Tensor,
                     render_rmnearplane: int) -> torch.Tensor:
    """Near-plane density mask used at inference (ref: voxnerf.py:181-185):
    zero density where z <= rmnearplane/128."""
    return (z_vals[..., 1:] > (render_rmnearplane / 128.0)).to(z_vals.dtype)
