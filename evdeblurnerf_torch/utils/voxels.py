"""Scene AABB estimation from camera poses (host-side numpy).

Used to size the TensoRF tri-plane grids. Mirrors ref: utils/voxels.py:46-79:
only the four image-corner rays of each pose are traced from near to far
(NDC-projected when the scene is forward-facing).
"""

from __future__ import annotations

import numpy as np

from .rays import get_ndc_rays_np, get_ray_directions_np


def get_bbox3d_for_llff(poses, hwf, near=0.0, far=1.0, is_ndc=True):
    """Returns (min_bound [3], max_bound [3]) as float32 numpy arrays."""
    H, W, focal = hwf
    H, W = int(H), int(W)

    directions = get_ray_directions_np(H, W, focal)

    min_bound = np.array([100.0, 100.0, 100.0])
    max_bound = np.array([-100.0, -100.0, -100.0])

    for pose in np.asarray(poses, dtype=np.float32):
        # world rays; directions normalized as in ref: utils/rays.py:92-99
        rays_d = directions @ pose[:3, :3].T
        rays_d = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
        rays_o = np.broadcast_to(pose[:3, -1], rays_d.shape)
        rays_o = rays_o.reshape(-1, 3)
        rays_d = rays_d.reshape(-1, 3)
        if is_ndc:
            rays_o, rays_d = get_ndc_rays_np(H, W, focal, 1.0, rays_o, rays_d)

        for i in (0, W - 1, H * W - W, H * W - 1):
            for t in (near, far):
                pt = rays_o[i] + t * rays_d[i]
                min_bound = np.minimum(min_bound, pt)
                max_bound = np.maximum(max_bound, pt)

    pad = np.array([0.01, 0.01, 0.0001])
    return ((min_bound - pad).astype(np.float32),
            (max_bound + pad).astype(np.float32))
