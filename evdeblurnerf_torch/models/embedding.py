"""Positional (frequency) encoding and the per-image view embedding.

Counterpart of ``evdeblurnerf_tpu/models/embedding.py``:
:func:`positional_encoding` in its exact form (ref:
networks/embedding.py:65-115): bands 2^0..2^(m-1), per-band [sin, cos],
input first; :class:`ViewEmbedding`, the per-image latent table (ref:
networks/embedding.py:6-32); the double-angle form of the encoding serves
the bf16 eval chain (``--triplane_bf16``). :class:`ViewEmbeddingMLP` is
the table followed by a skip-connected MLP (``kernel_img_embed_type
param_mlp``, ref: networks/embedding.py:35-62).
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import make_linear


def positional_encoding_dim(multires: int, input_dim: int = 3) -> int:
    if multires <= 0:
        return input_dim
    return input_dim * (1 + 2 * multires)


def positional_encoding(x: torch.Tensor, multires: int,
                        double_angle: bool = False) -> torch.Tensor:
    """[..., D] -> [..., D*(1+2*multires)] with per-band [sin, cos] order.

    ``double_angle``: sin and cos of the base angle, then the recurrence
    ``sin 2a = 2 sin a cos a``, ``cos 2a = 1 - 2 sin^2 a`` in f32, in the
    JAX package's order of operations
    (``evdeblurnerf_tpu/models/embedding.py:48-57``). Its phase error grows
    about twofold a band (~6e-5 after 10), below bf16's resolution: the
    bf16 eval chain's encoding, not the exact one.
    """
    if multires <= 0:
        return x
    D = x.shape[-1]
    if double_angle:
        s, c = torch.sin(x), torch.cos(x)
        sins, coss = [s], [c]
        for _ in range(multires - 1):
            s, c = 2.0 * s * c, 1.0 - 2.0 * s * s
            sins.append(s)
            coss.append(c)
        # band-major stacks copy whole blocks; one strided copy then puts
        # the bands in the per-point order. Stacking the [..., D] bands
        # along -2 moves D floats at a time: ~21 ms of an eval chunk's
        # device time on an H100 (tools/profile_serve_torch.py, PERF.md)
        bands = torch.stack([torch.stack(sins), torch.stack(coss)], 1)
        out = x.new_empty(*x.shape[:-1], D * (1 + 2 * multires))
        out[..., :D] = x
        out[..., D:].unflatten(-1, (multires, 2, D)).copy_(
            bands.movedim((0, 1), (-3, -2)))
        return out
    else:
        freqs = 2.0 ** torch.arange(multires, dtype=x.dtype, device=x.device)
        scaled = x[..., None, :] * freqs[:, None]                # [..., m, D]
        sc = torch.stack([torch.sin(scaled), torch.cos(scaled)], -2)
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


class ViewEmbeddingMLP(ViewEmbedding):
    """The latent table followed by ``D`` ReLU layers of width ``W``
    (``view_embed_linears``), the table's row concatenated in again after
    every layer whose index is in ``skips`` (ref:
    networks/embedding.py:35-62). As in the reference the table sits flat on
    the module (``img_embed``), beside the layers."""

    def __init__(self, num_embed: int, embed_dim: int, D: int, W: int,
                 skips=(4,), init: str = "zero",
                 generator: torch.Generator | None = None, device=None):
        super().__init__(num_embed, embed_dim, init, generator, device)
        self.skips = tuple(skips)
        layers, width = [], embed_dim
        for i in range(D):
            layers.append(make_linear(width, W, "torch", generator, device))
            width = W + embed_dim if i in self.skips else W
        self.view_embed_linears = nn.ModuleList(layers)
        self.out_channels = width

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        embedded = h = self.img_embed[idx.long()]
        for i, layer in enumerate(self.view_embed_linears):
            h = torch.relu(layer(h))
            if i in self.skips:
                h = torch.cat([embedded, h], -1)
        return h
