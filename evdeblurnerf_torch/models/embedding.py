"""Positional (frequency) encoding.

Counterpart of ``evdeblurnerf_tpu/models/embedding.py::positional_encoding``
in its exact form (ref: networks/embedding.py:65-115): bands 2^0..2^(m-1),
per-band [sin, cos], input first. The JAX package's double-angle variant
serves only its bf16 eval chain and is not ported.
"""

from __future__ import annotations

import torch


def positional_encoding_dim(multires: int, input_dim: int = 3) -> int:
    if multires <= 0:
        return input_dim
    return input_dim * (1 + 2 * multires)


def positional_encoding(x: torch.Tensor, multires: int) -> torch.Tensor:
    """[..., D] -> [..., D*(1+2*multires)] with per-band [sin, cos] order."""
    if multires <= 0:
        return x
    D = x.shape[-1]
    freqs = 2.0 ** torch.arange(multires, dtype=x.dtype, device=x.device)
    scaled = x[..., None, :] * freqs[:, None]                    # [..., m, D]
    sc = torch.stack([torch.sin(scaled), torch.cos(scaled)], -2)  # [.,m,2,D]
    return torch.cat([x, sc.reshape(*x.shape[:-1], 2 * multires * D)], -1)
