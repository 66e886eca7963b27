"""Camera response functions (CRF) and tonemapping.

Counterpart of ``evdeblurnerf_tpu/models/tonemapping.py`` (ref:
networks/tonemapping.py): two CRF heads, rgb and event, each ``none``,
``gamma`` (``x ** (1 / gamma)``) or ``learn``, the residual MLP
``sigmoid(0.1 * MLP([x, extra]) + x)`` applied per channel, plus the luma
conversion of the event head. The learned head's layers carry the
reference's names (``tonemapping_{rgb,event}.linear.{0,2,4,6}``), so a
reference ``crf_state_dict`` loads strictly.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .layers import make_linear

LUMA_WEIGHTS = {
    "rec601": (0.299, 0.587, 0.114),
    "rec709": (0.2126, 0.7152, 0.0722),
}


class CRF(nn.Module):
    """One response-function head (ref: tonemapping.py:7-93)."""

    def __init__(self, map_type: str = "none", gamma: float = 2.2,
                 extra_features: int = 0,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        if map_type not in ("none", "gamma", "learn"):
            raise ValueError(f"unknown CRF map_type {map_type!r}")
        self.map_type = map_type
        self.gamma = gamma
        self.extra_features = extra_features
        if map_type == "learn":
            widths = (1 + extra_features, 16, 16, 16, 1)
            layers = []
            for i in range(4):
                layers.append(make_linear(widths[i], widths[i + 1], "torch",
                                          generator, device))
                if i < 3:
                    layers.append(nn.ReLU())
            self.linear = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor, x_feat: Optional[torch.Tensor] = None,
                skip_learn: bool = False) -> torch.Tensor:
        """x [..., 3] linear radiance -> encoded. ``x_feat``: [N, extra] or
        [N, 3, extra] per-ray conditioning features (the BII cumsums).
        ``skip_learn`` (a Python bool) leaves the learned branch out of the
        graph, so its parameters get no gradient before the learn start."""
        if self.map_type == "gamma":
            x = x ** (1.0 / self.gamma)
        if self.map_type != "learn" or skip_learn:
            return x
        x_in = x.reshape(-1, 1)
        if self.extra_features > 0:
            if x_feat is None:
                # zero features (ref: tonemapping.py:83-86)
                feat = x_in.new_zeros(x_in.shape[0], self.extra_features)
            else:
                feat = x_feat.to(x_in.dtype)
                if feat.dim() != 3:
                    # per-ray features repeated over the 3 channels
                    # (ref: tonemapping.py:76-78)
                    feat = feat[:, None, :].expand(feat.shape[0], 3,
                                                   feat.shape[-1])
                feat = feat.reshape(-1, self.extra_features)
            x_in_feat = torch.cat([x_in, feat], -1)
        else:
            x_in_feat = x_in
        return torch.sigmoid(self.linear(x_in_feat) * 0.1
                             + x_in).reshape(x.shape)


class TonemappingTransform(nn.Module):
    """The rgb and event CRF heads with luma conversion (ref:
    tonemapping.py:96-154)."""

    def __init__(self, map_type_rgb: str = "none",
                 map_type_event: str = "none", gamma: float = 2.2,
                 luma_standard: str = "rec601", extra_features_event: int = 0,
                 extra_features_rgb: int = 0,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        if luma_standard not in (*LUMA_WEIGHTS, "avg"):
            raise ValueError(f"Unknown luma_standard {luma_standard}")
        self.luma_standard = luma_standard
        self.tonemapping_rgb = CRF(map_type_rgb, gamma, extra_features_rgb,
                                   generator, device)
        self.tonemapping_event = CRF(map_type_event, gamma,
                                     extra_features_event, generator, device)

    def encode_rgb(self, x, skip_learn_crf=False, rgb_extra_feat=None):
        return self.tonemapping_rgb(x, rgb_extra_feat, skip_learn_crf)

    def encode_luma(self, x, keep_rgb=False, tonemap_only=False,
                    skip_learn_crf=False, ev_extra_feat=None):
        x = self.tonemapping_event(x, ev_extra_feat, skip_learn_crf)
        if tonemap_only:
            return x
        if self.luma_standard == "avg":
            x = x.mean(-1, keepdim=True)
        else:
            w = LUMA_WEIGHTS[self.luma_standard]
            x = w[0] * x[..., 0:1] + w[1] * x[..., 1:2] + w[2] * x[..., 2:3]
        if keep_rgb:
            x = torch.cat([x] * 3, -1)
        return x


def crf_init_identity(crf: CRF, steps: int = 3000, batch_size: int = 64,
                      lr: float = 1e-2,
                      generator: torch.Generator | None = None) -> None:
    """Pre-fit a learned CRF head to the identity, in place: ``steps`` Adam
    updates at ``lr`` against y = x on batches of ``batch_size`` x 3
    uniform draws from ``generator`` (ref: tonemapping.py:29-57). A head
    that is not ``learn`` is left alone."""
    if crf.map_type != "learn":
        return
    device = next(crf.parameters()).device
    opt = torch.optim.Adam(crf.parameters(), lr=lr)
    for _ in range(steps):
        x = torch.rand(batch_size, 3, generator=generator, device=device)
        loss = torch.mean((crf(x) - x) ** 2)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    # leave no gradient behind for the trainer's first backward to add to
    opt.zero_grad(set_to_none=True)
