"""Occupancy bit-grid for empty-space culling of the coarse pass.

Counterpart of ``evdeblurnerf_tpu/ops/occupancy.py``; no reference
counterpart (the reference evaluates every stratified coarse sample, ref:
networks/renderer.py:183-185). A periodically refreshed ``G^3`` grid of
thresholded coarse alpha, dilated one voxel, marks where the coarse field
has density; the renderer then evaluates the coarse field only at occupied
samples plus an evenly strided probe floor, compacted per ray to a fixed
lane budget (``RenderConfig.coarse_cull_capacity``).

The grid is derived state, a function of the coarse parameters, recomputed
every ``--occ_refresh_every`` steps and on (re)start, never checkpointed.
Its layout is ``[G*G, G]`` as in the JAX package. Everything here is a
plain torch op, as the JAX functions are plain XLA ops: the lookup is a
gather of one value a sample and the refresh one sweep of ``G^3`` points
through the coarse field (kernel K4) every few hundred steps.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def voxel_centers(aabb, grid_size: int, device=None) -> torch.Tensor:
    """World-space centres of a ``G^3`` grid over ``aabb``: [G, G, G, 3],
    axes (ix, iy, iz) as :func:`lookup_bits` reads them."""
    lo = torch.tensor(aabb[0], dtype=torch.float32, device=device)
    hi = torch.tensor(aabb[1], dtype=torch.float32, device=device)
    G = grid_size
    t = (torch.arange(G, dtype=torch.float32, device=device) + 0.5) / G
    axes = [lo[a] + t * (hi[a] - lo[a]) for a in range(3)]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), -1)


def grid_from_sigma(sigma: torch.Tensor, delta: float, eps: float,
                    dilate: int = 1) -> torch.Tensor:
    """Raw coarse density [G, G, G] -> occupancy bits [G*G, G] (f32 0/1).

    ``alpha = 1 - exp(-relu(sigma) * delta) > eps``, then ``dilate``
    rounds of 3^3 max-pooling with stride 1: ``max_pool3d`` pads with
    ``-inf`` as JAX's ``reduce_window`` "SAME" does.
    """
    G = sigma.shape[0]
    alpha = 1.0 - torch.exp(-torch.relu(sigma) * delta)
    occ = (alpha > eps).float()[None, None]
    for _ in range(max(0, dilate)):
        occ = F.max_pool3d(occ, kernel_size=3, stride=1, padding=1)
    return occ[0, 0].reshape(G * G, G)


def lookup_bits(grid: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    """Occupancy bits [...] at normalised coords ``xyz`` [..., 3] in
    [-1, 1] (the voxel fields' ``normalize_coords`` frame). The index is
    ``(xyz + 1) * (G / 2)`` truncated toward zero, then clipped to the
    grid, in the JAX function's float order, so the bits are equal."""
    G = grid.shape[-1]
    idx = torch.clamp(((xyz.reshape(-1, 3) + 1.0) * (0.5 * G)).int(), 0,
                      G - 1).long()
    bits = grid[idx[:, 0] * G + idx[:, 1], idx[:, 2]]
    return bits.reshape(xyz.shape[:-1])


def expected_keep_fraction(occupied_frac: float, probe_stride: int) -> float:
    """Expected fraction of stratified lanes the cull keeps: the occupied
    lanes plus the every-``probe_stride``-th probe floor over the rest
    (the loop's gate arithmetic, on the host)."""
    s = max(1, int(probe_stride))
    return float(occupied_frac) + (1.0 - float(occupied_frac)) / s
