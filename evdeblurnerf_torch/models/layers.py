"""Activations and Linear layers with the reference's bias modes.

Counterpart of ``evdeblurnerf_tpu/models/layers.py``. The JAX package
stores Dense kernels [in, out]; here they are ``torch.nn.Linear`` weights
[out, in], the reference's own layout (``utils/convert.py`` transposes).
"""

from __future__ import annotations

import math

import torch
from torch import nn

ACTIVATIONS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "exp": torch.exp,
    "none": lambda x: x,
    "tanh": torch.tanh,
    # (ref: networks/renderer.py:104-106)
    "sigmoid1": lambda x: 1.002 / (torch.exp(-x) + 1) - 0.001,
    "softplus": lambda x: nn.functional.softplus(x - 1),
}


def make_linear(in_features: int, out_features: int, bias_mode: str = "torch",
                generator: torch.Generator | None = None,
                device=None) -> nn.Linear:
    """``nn.Linear`` with torch's default init drawn from ``generator``.

    ``bias_mode``: "torch" (bias ~ U(-1/sqrt(fan_in), +), the torch
    default), "zeros" (bias initialised to 0) or "none" (no bias). The
    weight is U(-1/sqrt(fan_in), +) in every mode, as ``nn.Linear`` draws
    it.
    """
    if bias_mode not in ("torch", "zeros", "none"):
        raise ValueError(f"unknown bias_mode {bias_mode!r}")
    layer = nn.Linear(in_features, out_features, bias=bias_mode != "none",
                      device=device)
    k = 1.0 / math.sqrt(in_features)
    with torch.no_grad():
        layer.weight.uniform_(-k, k, generator=generator)
        if bias_mode == "torch":
            layer.bias.uniform_(-k, k, generator=generator)
        elif bias_mode == "zeros":
            layer.bias.zero_()
    return layer
