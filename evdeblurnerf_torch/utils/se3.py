"""SE(3) / SO(3) exponential maps.

Counterpart of ``evdeblurnerf_tpu/utils/se3.py`` (Modern Robotics eqns
3.51 / 3.88, ref: utils/rigid_warping.py:5-155), including the
``theta + 1e-10`` normalisation epsilon the RBK blur kernel relies on.
"""

from __future__ import annotations

import torch


def skew(w: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] cross-product matrix
    (ref: utils/rigid_warping.py:112-132)."""
    zeros = torch.zeros_like(w[..., 0])
    row0 = torch.stack([zeros, -w[..., 2], w[..., 1]], -1)
    row1 = torch.stack([w[..., 2], zeros, -w[..., 0]], -1)
    row2 = torch.stack([-w[..., 1], w[..., 0], zeros], -1)
    return torch.stack([row0, row1, row2], -2)


def exp_so3(w: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Rodrigues rotation about the unit axis ``w`` by ``theta``
    (ref: utils/rigid_warping.py:95-110)."""
    W = skew(w)
    theta = theta[..., None, None]
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + torch.sin(theta) * W + (1.0 - torch.cos(theta)) * (W @ W)


def rp_to_se3(R: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(R [..., 3, 3], p [..., 3, 1]) -> homogeneous [..., 4, 4]
    (ref: utils/rigid_warping.py:134-148)."""
    Rp = torch.cat([R, p], -1)
    bottom = torch.zeros_like(Rp[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([Rp, bottom], -2)


def exp_se3(S: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Screw-axis exponential map -> [..., 4, 4]
    (ref: utils/rigid_warping.py:72-93)."""
    w, v = S[..., :3], S[..., 3:]
    W = skew(w)
    R = exp_so3(w, theta)
    theta_ = theta[..., None, None]
    eye = torch.eye(3, dtype=S.dtype, device=S.device).expand(W.shape)
    p = (theta_ * eye + (1.0 - torch.cos(theta_)) * W
         + (theta_ - torch.sin(theta_)) * (W @ W)) @ v[..., None]
    return rp_to_se3(R, p)


def se3_transform_from_rot_trans(rot: torch.Tensor, trans: torch.Tensor,
                                 eps: float = 1.0e-10) -> torch.Tensor:
    """Screw-motion transform from raw (rot, trans) 3-vectors
    (ref: utils/rigid_warping.py:18-30): theta = |rot|, and the axis and
    translation are divided by theta + eps."""
    theta = torch.linalg.vector_norm(rot, dim=-1) + eps
    screw = torch.cat([rot / theta[..., None], trans / theta[..., None]], -1)
    return exp_se3(screw, theta)


def se3_warp_points(pts: torch.Tensor, transform: torch.Tensor
                    ) -> torch.Tensor:
    """Apply [..., 4, 4] transforms to [..., 3] points
    (ref: utils/rigid_warping.py:32-49)."""
    homo = torch.cat([pts, torch.ones_like(pts[..., :1])], -1)
    warped = (transform @ homo[..., None])[..., 0]
    return warped[..., :3] / warped[..., 3:]


def se3_warp_pose(poses: torch.Tensor, transform: torch.Tensor
                  ) -> torch.Tensor:
    """Compose [..., 4, 4] transforms with homogeneous poses (ref:
    utils/rigid_warping.py:51-64)."""
    return transform @ poses
