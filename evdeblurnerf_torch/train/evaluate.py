"""Eval rendering of whole poses through fixed-size ray chunks.

Counterpart of ``evdeblurnerf_tpu/train/evaluate.py::render_poses`` (ref:
networks/renderer.py:594-626 render_path): the rays of all poses form one
stream in pose-major pixel order, cut into chunks of ``chunk`` rays, and
the last chunk is padded by repeating the last ray. Rays are generated on
the device and the results stay there until the end.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from ..utils.rays import get_rays


def pose_rays(poses, H: int, W: int, K, device) -> torch.Tensor:
    """Rays [N*H*W, 3, 2] (origin, direction) of the poses [N, 3, 4].

    Computed in float64 and rounded to float32, as the JAX package's host
    ray generation (``get_rays_np`` with float64 intrinsics) does, so both
    render the same ray floats.
    """
    poses = torch.as_tensor(np.asarray(poses, np.float64), device=device)
    rays = []
    for c2w in poses:
        rays_o, rays_d = get_rays(H, W, K, c2w[:3, :4], dtype=torch.float64)
        rays.append(torch.stack([rays_o.reshape(-1, 3),
                                 rays_d.reshape(-1, 3)], -1))
    return torch.cat(rays, 0).to(torch.float32)


@torch.inference_mode()
def render_poses(chunk_fn: Callable, poses, H: int, W: int, K,
                 chunk: int = 32768, render_factor: int = 0,
                 device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Render each [3, 4] pose; returns (rgbs [N, H, W, 3], depths [N, H, W])
    on ``device``.

    ``chunk_fn(rays [chunk, 3, 2]) -> (rgb, depth, acc)`` renders one chunk.
    ``render_factor > 0`` renders at H/factor x W/factor (fast preview,
    ref: renderer.py:598-601).
    """
    if render_factor > 0:
        H, W = H // render_factor, W // render_factor
        K = np.array(K, np.float64).copy()
        K[:2, :] = K[:2, :] / render_factor
    rays = pose_rays(poses, H, W, K, device)
    n = rays.shape[0]
    pad = -n % chunk
    if pad:
        rays = torch.cat([rays, rays[-1:].expand(pad, 3, 2)], 0)
    rgbs, depths = [], []
    for s in range(0, rays.shape[0], chunk):
        rgb, depth, _ = chunk_fn(rays[s:s + chunk])
        rgbs.append(rgb)
        depths.append(depth)
    n_poses = n // (H * W)
    return (torch.cat(rgbs, 0)[:n].reshape(n_poses, H, W, 3),
            torch.cat(depths, 0)[:n].reshape(n_poses, H, W))
