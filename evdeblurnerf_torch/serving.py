"""Serving entry point of the port: a loaded eval renderer.

Counterpart of ``evdeblurnerf_tpu/serving.py::ServingRenderer``. Where the
JAX package ships an exported ``jax.export`` artifact, the port rebuilds the
model from flags and loads a reference-layout ``network_state_dict`` — the
reference's own render-only flow (ref: run_nerf.py:337-414):

    sd = load_network_state_dict("030000.tar")
    r = build_renderer(args, sd, H, W, K, near, far, aabb, device="cuda")
    rgb, depth, acc = r(rays)                 # one chunk [chunk, 3, 2]
    rgbs, depths = r.render_poses(poses)      # whole poses

The rgb CRF is folded into the chunk output, as in the JAX artifact.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from .config import eval_fine_cull
from .models.renderer import config_from_args
from .models.system import EvDeblurNeRF
from .models.tonemapping import CRF
from .train import evaluate
from .utils.convert import normalize_legacy_network_state_dict

FIELD_PREFIXES = ("mlp_coarse.", "mlp_fine.")
UNUSED_PREFIXES = ("kernelsnet.", "awpnet.")


def load_network_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The ``network_state_dict`` of a reference-format ``*.tar`` checkpoint
    (ref: run_nerf.py:617-638; also what
    ``tools/export_reference_checkpoint.py`` writes), or that of a legacy
    two-network checkpoint of NeRF-mode fields
    (``utils/convert.py::normalize_legacy_network_state_dict``)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    legacy = normalize_legacy_network_state_dict(ckpt)
    return legacy if legacy is not None else ckpt["network_state_dict"]


class ServingRenderer:
    """A model (c2f or NeRF fields) with its weights and rgb CRF, rendering
    ray chunks; ``fine_cull`` renders them with the transmittance fine
    cull (``--fine_cull_eval``)."""

    def __init__(self, model: EvDeblurNeRF, crf: CRF, chunk: int, H: int,
                 W: int, K, unused_keys=(), fine_cull: bool = False):
        self.model = model
        self.fine_cull = bool(fine_cull)
        self.crf = crf
        self.chunk = int(chunk)
        self.H, self.W = int(H), int(W)
        self.K = np.asarray(K, np.float64)
        self.unused_keys = tuple(unused_keys)

    @property
    def device(self) -> torch.device:
        return self.model.device

    @torch.inference_mode()
    def __call__(self, rays: torch.Tensor):
        """rays [chunk, 3, 2] -> (rgb [chunk, 3] through the CRF,
        depth [chunk], acc [chunk])."""
        if tuple(rays.shape) != (self.chunk, 3, 2):
            raise ValueError(f"this renderer takes chunks of shape "
                             f"({self.chunk}, 3, 2); got {tuple(rays.shape)}")
        rgb, depth, acc = self.model.render_chunk(
            rays.to(self.device, torch.float32), fine_cull=self.fine_cull)
        return self.crf(rgb), depth, acc

    def render_poses(self, poses, H: Optional[int] = None,
                     W: Optional[int] = None, K=None,
                     render_factor: int = 0):
        """Render [N, 3, 4] poses -> (rgbs [N, H, W, 3], depths [N, H, W])
        on the model's device; H/W/K default to the renderer's camera."""
        return evaluate.render_poses(
            self, poses, self.H if H is None else int(H),
            self.W if W is None else int(W), self.K if K is None else K,
            chunk=self.chunk, render_factor=render_factor, device=self.device)


def build_renderer(args, state_dict: Mapping[str, torch.Tensor], H: int,
                   W: int, K, near: float, far: float, aabb,
                   device="cuda") -> ServingRenderer:
    """Build the model from flags and load its fields strictly.

    ``state_dict`` is a reference ``network_state_dict``: every
    ``mlp_coarse.*`` / ``mlp_fine.*`` key must match the model exactly.
    ``kernelsnet.*`` / ``awpnet.*`` keys (blur kernel, AWP) are not used
    at render time, as in the reference's render-only mode, and are listed
    in ``unused_keys``; any other key is an error. ``--fine_cull_eval``
    with a ``--fine_cull_capacity`` renders with the fine cull, as the
    JAX package's serving reads the flags.
    """
    fields = {k: v for k, v in state_dict.items()
              if k.startswith(FIELD_PREFIXES)}
    unused = sorted(k for k in state_dict if k.startswith(UNUSED_PREFIXES))
    unknown = sorted(set(state_dict) - set(fields) - set(unused))
    if unknown:
        raise KeyError(f"unexpected network_state_dict keys: {unknown}")
    cfg = config_from_args(args, aabb, H, W, float(K[0][0]), near, far)
    model = EvDeblurNeRF(cfg, device=device)
    model.load_state_dict(fields, strict=True)
    model.eval()
    crf = CRF(args.tone_mapping_type, args.tone_mapping_gamma)
    return ServingRenderer(model, crf, args.chunk, H, W, K, unused,
                           fine_cull=eval_fine_cull(args))
