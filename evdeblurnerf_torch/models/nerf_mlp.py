"""Vanilla NeRF MLP field (``mode=nerf``).

Counterpart of ``evdeblurnerf_tpu/models/nerf_mlp.py`` (ref:
networks/nerf.py:7-175): D ReLU layers of width W with the positional
encoding concatenated back after layer 4, then either the alpha, feature
and view-direction heads or, without view directions, one output layer.
The raw output is [rgb(3), sigma(1)] per sample, before activation. The
parameters carry the reference's names (``pts_linears.{i}``,
``views_linears.0``, ``feature_linear``, ``alpha_linear``, ``rgb_linear``,
``output_linear``), so a reference ``network_state_dict`` loads strictly.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .layers import make_linear


class NeRFMLP(nn.Module):
    """``extract_feature`` picks what the field hands AWP: the last trunk
    activation (``before_linear``, AWP's choice) or the feature head
    (``after_linear``)."""

    def __init__(self, in_ch: int, in_ch_views: int, D: int = 8, W: int = 256,
                 skips: Sequence[int] = (4,), use_viewdirs: bool = True,
                 rgb_add_bias: bool = True,
                 extract_feature: str = "after_linear",
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        if extract_feature not in ("before_linear", "after_linear"):
            raise ValueError(f"extract_feature {extract_feature!r}")
        if not use_viewdirs and extract_feature == "after_linear":
            raise ValueError("extract_feature='after_linear' needs the "
                             "view-direction heads (use_viewdirs)")
        self.skips = tuple(skips)
        self.use_viewdirs = use_viewdirs
        self.extract_feature = extract_feature
        self.pts_linears = nn.ModuleList()
        width = in_ch
        for i in range(D):
            self.pts_linears.append(make_linear(width, W, "torch", generator,
                                                device))
            width = W + (in_ch if i in self.skips else 0)
        self.feature_dim = width if extract_feature == "before_linear" else W
        if use_viewdirs:
            self.feature_linear = make_linear(width, W, "torch", generator,
                                              device)
            self.alpha_linear = make_linear(width, 1, "torch", generator,
                                            device)
            self.views_linears = nn.ModuleList([make_linear(
                W + in_ch_views, W // 2, "torch", generator, device)])
            self.rgb_linear = make_linear(
                W // 2, 3, "torch" if rgb_add_bias else "none", generator,
                device)
        else:
            self.output_linear = make_linear(width, 4, "torch", generator,
                                             device)

    def forward(self, pts_embedded: torch.Tensor,
                views_embedded: Optional[torch.Tensor]):
        """pts_embedded [..., in_ch], views_embedded [..., in_ch_views] or
        None. Returns (raw [..., 4], feature [..., feature_dim] or None)
        (ref: networks/nerf.py:131-162)."""
        h = pts_embedded
        for i, layer in enumerate(self.pts_linears):
            h = torch.relu(layer(h))
            if i in self.skips:
                h = torch.cat([pts_embedded, h], -1)
        feature_out = h if self.extract_feature == "before_linear" else None
        if not self.use_viewdirs:
            return self.output_linear(h), feature_out
        alpha = self.alpha_linear(h)
        feature = self.feature_linear(h)
        if self.extract_feature == "after_linear":
            feature_out = feature
        h = torch.relu(self.views_linears[0](
            torch.cat([feature, views_embedded], -1)))
        return torch.cat([self.rgb_linear(h), alpha], -1), feature_out
