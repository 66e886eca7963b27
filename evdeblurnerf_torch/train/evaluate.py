"""Eval rendering of whole poses through fixed-size ray chunks, and what
the train loop does with the renders.

Counterpart of ``evdeblurnerf_tpu/train/evaluate.py`` (ref:
networks/renderer.py:594-626 render_path and the test/video blocks of
run_nerf.py:642-734): the rays of all poses form one stream in pose-major
pixel order, cut into chunks of ``chunk`` rays, and the last chunk is
padded by repeating the last ray. Rays are generated on the device and the
results stay there until the end. :func:`apply_crf` puts renders through
the rgb CRF, :func:`depth_colormap` colours a depth map and
:func:`format_test_metrics` formats one line of ``test_metrics.txt``.

Data-parallel renders (``evaluate.py:23-56,78`` of the JAX package): with
a ``layout`` of several ray shards the stream is padded to ``chunk`` times
their number, each rank renders its ``chunk`` rays of every such stretch,
and the outputs are gathered by ``all_reduce`` into a zero-filled buffer
(``parallel/mesh.py::gather_rows``: gloo has no ``all_gather`` of CUDA
tensors), so every rank ends with the whole render.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional, Tuple

import numpy as np
import torch

from ..parallel import mesh
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
                 device=None, layout: mesh.Layout = mesh.Layout()
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Render each [3, 4] pose; returns (rgbs [N, H, W, 3], depths [N, H, W])
    on ``device``.

    ``chunk_fn(rays [chunk, 3, 2]) -> (rgb, depth, acc)`` renders one chunk.
    ``render_factor > 0`` renders at H/factor x W/factor (fast preview,
    ref: renderer.py:598-601). ``layout``: this rank renders its shard of
    every ``chunk`` x ``n_data`` rays (module docstring).
    """
    if render_factor > 0:
        H, W = H // render_factor, W // render_factor
        K = np.array(K, np.float64).copy()
        K[:2, :] = K[:2, :] / render_factor
    rays = pose_rays(poses, H, W, K, device)
    n = rays.shape[0]
    stride = chunk * layout.n_data
    pad = mesh.pad_to_multiple(n, stride) - n
    if pad:
        rays = torch.cat([rays, rays[-1:].expand(pad, 3, 2)], 0)
    first = layout.data_rank * chunk
    outs = []
    for s in range(first, rays.shape[0], stride):
        rgb, depth, _ = chunk_fn(rays[s:s + chunk])
        outs.append(torch.cat([rgb, depth[:, None]], -1))
    out = mesh.gather_rows(torch.stack(outs), layout).reshape(-1, 4)[:n]
    n_poses = n // (H * W)
    return (out[:, :3].reshape(n_poses, H, W, 3),
            out[:, 3].reshape(n_poses, H, W))


@torch.inference_mode()
def apply_crf(crf, rgbs, skip_learn_crf: bool = False) -> np.ndarray:
    """Eval renders [..., 3] through the rgb CRF (ref: run_nerf.py:660),
    on the CRF's device when it has parameters; returns a numpy array.
    ``skip_learn_crf`` leaves a learned head out, as the train step does
    before the learn start."""
    rgbs = torch.as_tensor(rgbs)
    p = next(crf.parameters(), None)
    if p is not None:
        rgbs = rgbs.to(p.device)
    return crf.encode_rgb(rgbs, skip_learn_crf=skip_learn_crf).cpu().numpy()


# OpenCV's COLORMAP_JET as (index, value) breakpoints per channel: linear
# interpolation between them, rounded to nearest, gives its 256 entries
_JET_BREAKPOINTS = {
    "r": ((0, 0), (95, 0), (96, 2), (159, 254), (160, 255), (223, 255),
          (225, 248), (255, 128)),
    "g": ((0, 0), (32, 0), (95, 252), (96, 255), (159, 255), (161, 248),
          (223, 0), (255, 0)),
    "b": ((0, 128), (31, 252), (32, 255), (95, 255), (96, 254), (158, 6),
          (159, 1), (161, 0), (255, 0)),
}


def jet_table() -> np.ndarray:
    """The JET colour table [256, 3] uint8, RGB."""
    i = np.arange(256)
    return np.stack([np.rint(np.interp(i, *zip(*_JET_BREAKPOINTS[c])))
                     for c in "rgb"], -1).astype(np.uint8)


def depth_colormap(depth, near: Optional[float] = None,
                   far: Optional[float] = None) -> np.ndarray:
    """Depth [H, W] -> JET visualisation [H, W, 3] uint8, RGB (ref:
    run_nerf.py:672-676; the values of ``cv2.applyColorMap(...,
    COLORMAP_JET)``, without needing cv2)."""
    d = np.asarray(depth, np.float32)
    lo = np.min(d) if near is None else near
    hi = np.max(d) if far is None else far
    norm = np.clip((d - lo) / max(hi - lo, 1e-8), 0, 1)
    return jet_table()[(norm * 255).astype(np.uint8)]


def format_test_metrics(step: int, metrics: Mapping[str, float],
                      lpips_trunk: Optional[str] = None) -> str:
    """One line of ``test_metrics.txt`` in the JAX package's format
    (``iter 9: mse=0.01234 psnr=19.08765 ssim=0.51234``), which
    ``tools/compare_metrics.py`` parses. ``metrics`` is keyed
    ``test/<name>``."""
    parts = " ".join(f"{k.split('/')[1]}={v:.5f}" for k, v in metrics.items()
                     if k != "test/lpips_trunk_fallback")
    if lpips_trunk is not None:
        parts += f" lpips_trunk={lpips_trunk}"
    return f"iter {step}: {parts}\n"
