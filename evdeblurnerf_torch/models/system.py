"""Top-level model, eval render only.

Counterpart of ``evdeblurnerf_tpu/models/system.py::EvDeblurNeRF``. Like
the reference's ``NeRFAll`` (ref: networks/renderer.py:14-626) it holds the
fields directly as ``mlp_coarse`` / ``mlp_fine``, so its state dict keys
are the reference's. The blur kernel (``kernelsnet``) and AWP
(``awpnet``) come with the training forward.
"""

from __future__ import annotations

import torch

from .renderer import Renderer


class EvDeblurNeRF(Renderer):
    """The c2f renderer with the deterministic eval entry point."""

    @torch.inference_mode()
    def render_chunk(self, rays: torch.Tensor):
        """Deterministic eval render of a ray chunk [R, 3, 2] (perturb 0, no
        sigma noise, no culls). Returns (rgb [R, 3], depth [R], acc [R])."""
        ret = self.render(rays)
        return ret["rgb_map"], ret["depth_map"], ret["acc_map"]
