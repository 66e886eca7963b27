"""Positional (frequency) encoding and the per-image view embedding.

Counterpart of ``evdeblurnerf_tpu/models/embedding.py``:
:func:`positional_encoding` in its exact form (ref:
networks/embedding.py:65-115): bands 2^0..2^(m-1), per-band [sin, cos],
input first; :class:`ViewEmbedding`, the per-image latent table (ref:
networks/embedding.py:6-32). The JAX package's double-angle encoding serves
only its bf16 eval chain and is not ported; the table-plus-MLP embedding
(``param_mlp``) is not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn


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


class ViewEmbedding(nn.Module):
    """Per-training-image latent code table ``img_embed`` [num_embed,
    embed_dim]; ``init`` is ``zero``, ``normal`` (N(0, 1)) or
    ``linspace`` (every column -1..1 over the images)."""

    def __init__(self, num_embed: int, embed_dim: int, init: str = "zero",
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        table = torch.zeros(num_embed, embed_dim, device=device)
        if init == "normal":
            table.normal_(generator=generator)
        elif init == "linspace":
            table[:] = torch.linspace(-1, 1, num_embed, device=device)[:, None]
        elif init != "zero":
            raise ValueError(f"Unknown init_params: {init}")
        self.img_embed = nn.Parameter(table)

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        return self.img_embed[idx.long()]


class ViewEmbeddingMLP(nn.Module):
    """The table-plus-MLP view embedding (``kernel_img_embed_type
    param_mlp``, ref: networks/embedding.py:35-62): not ported yet."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        raise NotImplementedError(
            "kernel_img_embed_type=param_mlp: the port has the plain "
            "ViewEmbedding table only; ViewEmbeddingMLP is ROADMAP.md queue "
            "1 item 9")
