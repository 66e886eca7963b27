"""The rgb camera response function (CRF) at eval.

Counterpart of ``evdeblurnerf_tpu/models/tonemapping.py::CRF`` for the
rgb head's ``none`` and ``gamma`` modes (ref: networks/tonemapping.py:7-93);
the blender configs render with ``tone_mapping_type = gamma``. The learned
residual-MLP head, the event head and luma conversion come with training.
"""

from __future__ import annotations

import torch
from torch import nn


class CRF(nn.Module):
    """One response-function head: ``none`` (identity) or ``gamma``
    (``x ** (1 / gamma)``)."""

    def __init__(self, map_type: str = "none", gamma: float = 2.2):
        super().__init__()
        if map_type == "learn":
            raise NotImplementedError(
                "learned CRF: ROADMAP.md queue 1 item 12 ports the learn "
                "mode")
        if map_type not in ("none", "gamma"):
            raise ValueError(f"unknown CRF map_type {map_type!r}")
        self.map_type = map_type
        self.gamma = gamma

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.map_type == "gamma":
            return x ** (1.0 / self.gamma)
        return x
