"""LLFF pose math: averaging, recentering, spherification, render paths,
and a vectorized SLERP+cubic pose interpolator.

Host-side numpy, run once at dataset-build time.

Provenance/parity note: the camera-frame conventions here (viewmatrix
column order, the ``[.1,.2,.3]`` cross-product seed for the sphere basis,
the nearest-point-to-all-view-axes fit) predate the reference — they are
the LLFF -> NeRF-pytorch lineage the reference inherits (ref:
utils/data.py:119-253) — and bit-replay of the exact transforms is a
parity requirement: the recenter/spherify outputs feed ray generation, so
any float deviation shifts every training ray. The host-oracle goldens
(tests/goldens/oracle_host.npz, recorded from the actual reference) pin
the behavior; the code below is organized around explicit replay-state
objects and batch-vectorized path functions rather than the reference's
scalar loops.

Replay protocol: ``recenter_poses`` replays through the average-camera
matrix it returns; ``spherify_poses`` through a :class:`SpherifyState`.
Both are fit ONCE on the frame poses and re-applied verbatim to other pose
sets (event/interpolated poses) so every pose set lands in the same world
frame.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
from scipy.interpolate import interp1d
from scipy.spatial.transform import Rotation, Slerp


def is_pure_rotation_matrix(M: np.ndarray) -> bool:
    """Batched rotation-purity check (ref: utils/data.py:9-31)."""
    if M.shape[-2] != M.shape[-1]:
        return False
    if not np.all(np.isclose(np.linalg.det(M), 1.0)):
        return False
    MT = np.swapaxes(M, -2, -1)
    return bool(np.allclose(MT, np.linalg.inv(M), atol=5e-7))


def normalize(x):
    return x / np.linalg.norm(x)


def _viewmatrix_batch(z, up, pos):
    """[N,3,4] camera-to-world stacks from forward/up-hint/position rows.

    Vectorized Gram-Schmidt; per-row float ops identical to the scalar
    form, so a singleton batch reproduces ``viewmatrix`` bit-for-bit.
    """
    z = np.asarray(z, np.float64)
    up = np.broadcast_to(np.asarray(up, np.float64), z.shape)
    pos = np.asarray(pos, np.float64)
    vec2 = z / np.linalg.norm(z, axis=-1, keepdims=True)
    vec0 = np.cross(up, vec2)
    vec0 = vec0 / np.linalg.norm(vec0, axis=-1, keepdims=True)
    vec1 = np.cross(vec2, vec0)
    vec1 = vec1 / np.linalg.norm(vec1, axis=-1, keepdims=True)
    return np.stack([vec0, vec1, vec2, pos], axis=-1)


def viewmatrix(z, up, pos):
    """Camera-to-world [3,4] from forward z, up hint, position
    (ref: utils/data.py:119-125)."""
    return _viewmatrix_batch(np.asarray(z)[None], np.asarray(up)[None],
                             np.asarray(pos)[None])[0]


def _homogenize(p34):
    """[N,3,4] -> [N,4,4] with a [0,0,0,1] bottom row."""
    bottom = np.broadcast_to(np.eye(4)[-1], (p34.shape[0], 1, 4))
    return np.concatenate([p34, bottom], axis=-2)


def _with_hwf(p34, hwf):
    """Append the shared [3,1] hwf column: [N,3,4] -> [N,3,5]."""
    return np.concatenate(
        [p34, np.broadcast_to(hwf, p34[..., :1].shape)], axis=-1)


def poses_avg(poses):
    """Average pose of an LLFF [N,3,5] pose stack (ref: utils/data.py:128-136)."""
    hwf = poses[0, :3, -1:]
    center = poses[:, :3, 3].mean(0)
    vec2 = normalize(poses[:, :3, 2].sum(0))
    up = poses[:, :3, 1].sum(0)
    return np.concatenate([viewmatrix(vec2, up, center), hwf], 1)


def recenter_poses(poses, c2w=None, return_c2w=False):
    """Recenter poses about their average camera.

    Replay state is the [4,4] average-camera matrix: fit once (``c2w``
    omitted), re-apply to other pose sets by passing it back
    (ref behavior: utils/data.py:167-183; pinned by the host oracle).
    """
    if c2w is None:
        c2w = _homogenize(poses_avg(poses)[None, :3, :4])[0]
    out = poses.copy()
    out[:, :3, :4] = (np.linalg.inv(c2w)
                      @ _homogenize(poses[:, :3, :4]))[:, :3, :4]
    if return_c2w:
        return out, c2w
    return out


class SpherifyState(NamedTuple):
    """Replayable spherification transform.

    Tuple-compatible with the legacy 5-element state (unpack order is the
    field order below). ``up`` is the fit-time up hint, kept for
    introspection; replay uses only ``c2w``/``scale`` (+ the circle
    parameters for render paths).
    """

    c2w: np.ndarray          # [3,4] sphere-frame basis (axes + center)
    up: np.ndarray           # [3] mean offset of cameras from the center
    scale: float             # 1/rms-radius normalization
    rad_circle: float        # render-circle radius (in-plane)
    z_height: float          # render-circle height (centroid z)


def _fit_sphere_basis(poses):
    """Least-squares nearest point to all view axes + an orthobasis with
    the capture's mean-offset direction as its z axis. The ``[.1,.2,.3]``
    seed vector for the in-plane axes is LLFF-lineage (any non-parallel
    vector works; this exact one is required for bit-replay)."""
    rays_d = poses[:, :3, 2:3]
    rays_o = poses[:, :3, 3:4]
    A_i = np.eye(3) - rays_d * np.transpose(rays_d, [0, 2, 1])
    b_i = -A_i @ rays_o
    center = np.squeeze(
        -np.linalg.inv((np.transpose(A_i, [0, 2, 1]) @ A_i).mean(0))
        @ b_i.mean(0))

    up = (poses[:, :3, 3] - center).mean(0)
    vec0 = normalize(up)
    vec1 = normalize(np.cross([0.1, 0.2, 0.3], vec0))
    vec2 = normalize(np.cross(vec0, vec1))
    return np.stack([vec1, vec2, vec0, center], 1), up


def _to_sphere_frame(poses, c2w):
    """Express [N,3,x] poses in the sphere-frame basis: [N,4,4]."""
    return (np.linalg.inv(_homogenize(c2w[None]))
            @ _homogenize(poses[:, :3, :4]))


def spherify_render_circle(state: SpherifyState, hwf, n=120):
    """[n,3,5] circular render path on the fitted sphere
    (ref: utils/data.py:228-246), batched over all angles.

    NOTE the basis convention here is NOT ``viewmatrix``'s: the lineage
    code builds ``vec0 = cross(vec2, up)`` (flipped argument order, so a
    flipped sign) and ``vec1 = cross(vec2, vec0)`` — replicated exactly
    (host-oracle-pinned)."""
    th = np.linspace(0.0, 2.0 * np.pi, n)
    camorigin = np.stack([state.rad_circle * np.cos(th),
                          state.rad_circle * np.sin(th),
                          np.full_like(th, state.z_height)], axis=-1)
    up = np.array([0, 0, -1.0])
    vec2 = camorigin / np.linalg.norm(camorigin, axis=-1, keepdims=True)
    vec0 = np.cross(vec2, up)
    vec0 = vec0 / np.linalg.norm(vec0, axis=-1, keepdims=True)
    vec1 = np.cross(vec2, vec0)
    vec1 = vec1 / np.linalg.norm(vec1, axis=-1, keepdims=True)
    new = np.stack([vec0, vec1, vec2, camorigin], axis=-1)
    return _with_hwf(new, hwf)


def spherify_poses(poses, bds, state: Optional[SpherifyState] = None,
                   return_state=False, render_path=True):
    """Spherify a 360 capture; :class:`SpherifyState` makes the transform
    replayable on other pose sets (ref behavior: utils/data.py:189-253,
    pinned by the host oracle).

    ``render_path=False`` skips building the 120-pose circular render path
    (pure replay — the event-batch pose interpolation calls this per
    prefetched batch and only needs ``poses_reset``)."""
    hwf = poses[0, :3, -1:]
    fit = state is None
    if fit:
        c2w, up = _fit_sphere_basis(poses)
        poses_reset = _to_sphere_frame(poses, c2w)
        rad = np.sqrt(np.mean(np.sum(np.square(poses_reset[:, :3, 3]), -1)))
        sc = 1.0 / rad
        poses_reset[:, :3, 3] *= sc
        bds = bds * sc
        rad *= sc
        zh = np.mean(poses_reset[:, :3, 3], 0)[2]
        radcircle = np.sqrt(rad ** 2 - zh ** 2)
        state = SpherifyState(c2w, up, sc, radcircle, zh)
    else:
        state = SpherifyState(*state)
        poses_reset = _to_sphere_frame(poses, state.c2w)
        poses_reset[:, :3, 3] *= state.scale
        bds = bds * state.scale

    new_poses = (spherify_render_circle(state, hwf) if render_path else None)
    poses_reset = _with_hwf(poses_reset[:, :3, :4], hwf)

    if return_state:
        return poses_reset, new_poses, bds, state
    return poses_reset, new_poses, bds


def render_path_spiral(c2w, up, rads, focal, zdelta, zrate, rots, N):
    """Spiral novel-view path (ref: utils/data.py:139-151), batched over
    all N angles at once. Returns a list of [3,5] poses."""
    rads = np.array(list(rads) + [1.0])
    hwf = c2w[:, 4:5]
    theta = np.linspace(0.0, 2.0 * np.pi * rots, N + 1)[:-1]
    offsets = np.stack([np.cos(theta), -np.sin(theta),
                        -np.sin(theta * zrate), np.ones_like(theta)],
                       axis=-1) * rads
    c = offsets @ c2w[:3, :4].T                              # [N, 3]
    z = c - c2w[:3, :4] @ np.array([0, 0, -focal, 1.0])
    return list(_with_hwf(_viewmatrix_batch(z, up, c), hwf))


def render_path_epi(c2w, up, rads, N):
    """Horizontal EPI sweep path (ref: utils/data.py:154-164), batched.
    Returns a list of [3,5] poses."""
    hwf = c2w[:, 4:5]
    theta = np.linspace(-1, 1, N + 1)[:-1]
    offsets = np.stack([theta, np.zeros_like(theta), np.zeros_like(theta),
                        np.ones_like(theta)], axis=-1) * rads
    c = offsets @ c2w[:3, :4].T                              # [N, 3]
    z = np.broadcast_to(c2w[:3, :4] @ np.array([0, 0, 1, 0.0]), c.shape)
    return list(_with_hwf(_viewmatrix_batch(z, up, c), hwf))


def get_slerp_interpolator(tss, rots, trans):
    """SLERP rotations + cubic translations interpolator factory
    (ref: utils/data.py:34-61).

    Returns ``f(t) -> (rots [N,3,3], trans [N,3])``. Built on scipy for the
    knots; evaluation is fully vectorized so batch queries are cheap.
    """
    rot_interp = Slerp(tss, Rotation.from_matrix(rots))
    trans_interp = interp1d(x=tss, y=trans, axis=0, kind="cubic",
                            bounds_error=True)

    def interpolator(tq):
        tq = np.clip(np.asarray(tq, dtype=np.float64), tss[0], tss[-1])
        return rot_interp(tq).as_matrix(), trans_interp(tq)

    return interpolator
