"""A realistic sample-point stream for locality studies and the tiled
gather's bench: LLFF-style pinhole rays + small SE3 (RBK-like) warps, NDC
projection, stratified depths, Morton-sorted rays.

The port's own copy of the generator the JAX package's bench uses
(``tests/locality_geometry.py``): the same numpy draws in the same order,
so both benches sample the same points. It computes each ray's own pixel
instead of a whole image per ray, which gives the same values.
"""

from __future__ import annotations

import numpy as np

from .rays import get_rays_pix_np


def _morton2(x, y):
    def spread(v):
        v = v.astype(np.uint64)
        v = (v | (v << 16)) & np.uint64(0x0000FFFF0000FFFF)
        v = (v | (v << 8)) & np.uint64(0x00FF00FF00FF00FF)
        v = (v | (v << 4)) & np.uint64(0x0F0F0F0F0F0F0F0F)
        v = (v | (v << 2)) & np.uint64(0x3333333333333333)
        v = (v | (v << 1)) & np.uint64(0x5555555555555555)
        return v
    return spread(x) | (spread(y) << np.uint64(1))


def step_points_xyz(n_rand=1024, ptnum=10, S=128, seed=0,
                    H=480, W=640, focal=500.0):
    """Returns [n_rand*ptnum*S, 3] normalized points in [0, 1], rays
    Morton-sorted by midpoint, samples in ray-major order: the sample
    points of one training step at the paper's batch."""
    rng = np.random.default_rng(seed)
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1.0]])
    n_imgs = 30
    poses = []
    for _ in range(n_imgs):
        a = rng.normal(0, 0.05, 3)
        c, s = np.cos(a), np.sin(a)
        R = (np.array([[1, 0, 0], [0, c[0], -s[0]], [0, s[0], c[0]]])
             @ np.array([[c[1], 0, s[1]], [0, 1, 0], [-s[1], 0, c[1]]]))
        t = rng.normal(0, 0.08, 3) * np.array([1, 1, 0.3])
        poses.append(np.concatenate([R, t[:, None]], 1))
    poses = np.stack(poses)

    img_idx = rng.integers(0, n_imgs, n_rand)
    px = rng.integers(0, W, n_rand)
    py = rng.integers(0, H, n_rand)
    rays_o, rays_d = get_rays_pix_np(np.stack([px, py], -1), K,
                                     poses[img_idx])

    all_o, all_d = [rays_o], [rays_d]
    for _ in range(ptnum - 1):
        ang = rng.normal(0, 0.01, 3)
        Rm = np.eye(3) + np.cross(np.eye(3), ang)
        all_o.append(rays_o + rng.normal(0, 0.01, 3).astype(np.float32))
        all_d.append(rays_d @ Rm.T.astype(np.float32))
    o = np.concatenate(all_o)
    d = np.concatenate(all_d)

    t = -(1.0 + o[:, 2]) / d[:, 2]
    o = o + t[:, None] * d
    o0 = -1.0 / (W / (2.0 * focal)) * o[:, 0] / o[:, 2]
    o1 = -1.0 / (H / (2.0 * focal)) * o[:, 1] / o[:, 2]
    o2 = 1.0 + 2.0 / o[:, 2]
    d0 = (-1.0 / (W / (2.0 * focal))
          * (d[:, 0] / d[:, 2] - o[:, 0] / o[:, 2]))
    d1 = (-1.0 / (H / (2.0 * focal))
          * (d[:, 1] / d[:, 2] - o[:, 1] / o[:, 2]))
    d2 = -2.0 / o[:, 2]
    ndc_o = np.stack([o0, o1, o2], -1)
    ndc_d = np.stack([d0, d1, d2], -1)

    z = np.sort(rng.uniform(0, 1, (o.shape[0], S)).astype(np.float32), 1)
    pts = ndc_o[:, None, :] + ndc_d[:, None, :] * z[..., None]
    aabb_min = np.array([-1.6, -1.7, -1.0])
    aabb_max = np.array([1.7, 1.6, 1.0])
    xyz = np.clip((pts - aabb_min) / (aabb_max - aabb_min), 0, 1)

    mid = xyz[:, S // 2, :]
    code = _morton2((mid[:, 0] * 65535).astype(np.uint32),
                    (mid[:, 1] * 65535).astype(np.uint32))
    order = np.argsort(code)
    return xyz[order].reshape(-1, 3).astype(np.float32)
