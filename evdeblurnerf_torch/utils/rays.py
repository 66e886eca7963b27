"""Ray generation and NDC projection.

Counterpart of ``evdeblurnerf_tpu/utils/rays.py`` (ref: utils/rays.py):
OpenGL-style camera (x right, y up, z backward), pixel centres offset by
half a pixel unless ``add_halfpix`` is off. The torch variants run on the
device (eval renders); the numpy variants (``*_np``) feed the data
pipeline, which assembles training batches on the host.
"""

from __future__ import annotations

import numpy as np
import torch

HALF_PIX = 0.5


def get_rays(H: int, W: int, K, c2w: torch.Tensor, add_halfpix: bool = True,
             dtype: torch.dtype = torch.float32):
    """All-pixel rays of one pose [3, 4] (or [4, 4]) on ``c2w``'s device.

    Returns (rays_o, rays_d), each [H, W, 3] in ``dtype``. ``K`` is the
    [3, 3] intrinsics (nested sequence or array of floats).
    """
    halfpix = HALF_PIX if add_halfpix else 0.0
    dev = c2w.device
    j, i = torch.meshgrid(torch.arange(H, dtype=dtype, device=dev),
                          torch.arange(W, dtype=dtype, device=dev),
                          indexing="ij")
    k = [[float(v) for v in row] for row in K]
    dirs = torch.stack([(i + (halfpix - k[0][2])) / k[0][0],
                        -(j + (halfpix - k[1][2])) / k[1][1],
                        -torch.ones_like(i)], -1)
    c2w = c2w.to(dtype)
    rays_d = torch.sum(dirs[..., None, :] * c2w[:3, :3], -1)
    rays_o = c2w[:3, -1].expand(rays_d.shape)
    return rays_o, rays_d


def get_ndc_rays(H: int, W: int, focal: float, near: float,
                 rays_o: torch.Tensor, rays_d: torch.Tensor):
    """Shift rays to the near plane and project to NDC
    (ref: utils/rays.py:104-145)."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    ox_oz = rays_o[..., 0] / rays_o[..., 2]
    oy_oz = rays_o[..., 1] / rays_o[..., 2]

    o0 = -1.0 / (W / (2.0 * focal)) * ox_oz
    o1 = -1.0 / (H / (2.0 * focal)) * oy_oz
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]

    d0 = -1.0 / (W / (2.0 * focal)) * (rays_d[..., 0] / rays_d[..., 2] - ox_oz)
    d1 = -1.0 / (H / (2.0 * focal)) * (rays_d[..., 1] / rays_d[..., 2] - oy_oz)
    d2 = 1.0 - o2
    return torch.stack([o0, o1, o2], -1), torch.stack([d0, d1, d2], -1)


def get_rays_np(H, W, K, c2w, add_halfpix=True):
    """All-pixel rays for one pose (ref: utils/rays.py:8-22).

    Returns (rays_o, rays_d), each [H, W, 3]. Pixel centers offset by 0.5.
    """
    halfpix = HALF_PIX if add_halfpix else 0.0
    i, j = np.meshgrid(np.arange(W, dtype=np.float32),
                       np.arange(H, dtype=np.float32), indexing="xy")
    dirs = np.stack([(i + (halfpix - K[0][2])) / K[0][0],
                     -(j + (halfpix - K[1][2])) / K[1][1],
                     -np.ones_like(i)], -1)
    rays_d = np.sum(dirs[..., None, :] * np.asarray(c2w)[:3, :3], -1)
    rays_o = np.broadcast_to(np.asarray(c2w)[:3, -1], rays_d.shape)
    return rays_o.astype(np.float32), rays_d.astype(np.float32)


def get_rays_pix_np(coords, K, c2ws, add_halfpix=True):
    """Per-pixel rays for per-ray poses (ref: utils/rays.py:39-49).

    coords: [N, 2] (x, y); c2ws: [N, 3, 4] or broadcastable.
    Returns (rays_o, rays_d) each [N, 3].
    """
    halfpix = HALF_PIX if add_halfpix else 0.0
    coords = np.asarray(coords, dtype=np.float32)
    coord_x, coord_y = coords[:, 0], coords[:, 1]
    dirs = np.stack([(coord_x + (halfpix - K[0][2])) / K[0][0],
                     -(coord_y + (halfpix - K[1][2])) / K[1][1],
                     -np.ones_like(coord_x)], -1)
    rays_d = np.sum(dirs[..., None, :] * np.asarray(c2ws)[..., :3, :3], -1)
    rays_o = np.broadcast_to(np.asarray(c2ws)[..., :3, -1], rays_d.shape)
    return rays_o.astype(np.float32), rays_d.astype(np.float32)


def get_ndc_rays_np(H, W, focal, near, rays_o, rays_d):
    """Numpy twin of :func:`get_ndc_rays` for host-side preprocessing."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    ox_oz = rays_o[..., 0] / rays_o[..., 2]
    oy_oz = rays_o[..., 1] / rays_o[..., 2]
    o0 = -1.0 / (W / (2.0 * focal)) * ox_oz
    o1 = -1.0 / (H / (2.0 * focal)) * oy_oz
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]
    d0 = -1.0 / (W / (2.0 * focal)) * (rays_d[..., 0] / rays_d[..., 2] - ox_oz)
    d1 = -1.0 / (H / (2.0 * focal)) * (rays_d[..., 1] / rays_d[..., 2] - oy_oz)
    d2 = 1.0 - o2
    return (np.stack([o0, o1, o2], -1).astype(np.float32),
            np.stack([d0, d1, d2], -1).astype(np.float32))


def get_ray_directions_np(H, W, focal):
    """Camera-frame directions without half-pixel centering, used only for
    AABB estimation (ref: utils/rays.py:52-75)."""
    i, j = np.meshgrid(np.arange(W, dtype=np.float32),
                       np.arange(H, dtype=np.float32), indexing="xy")
    return np.stack([(i - W / 2) / focal, -(j - H / 2) / focal,
                     -np.ones_like(i)], -1)
