"""Ray generation and NDC projection on the device.

Counterpart of ``evdeblurnerf_tpu/utils/rays.py`` (ref: utils/rays.py):
OpenGL-style camera (x right, y up, z backward), pixel centres offset by
half a pixel unless ``add_halfpix`` is off.
"""

from __future__ import annotations

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
