"""Hierarchical inverse-CDF sampling along rays.

Counterpart of ``evdeblurnerf_tpu/ops/sample_pdf.py`` (ref:
utils/rays.py:149-193): the same 1e-5 weight epsilon, the ``denom < 1e-5``
rule for degenerate intervals, and the four gathers in one pass through
:func:`..ops.lane_shuffle.cdf_take` (kernel K3 on the card). Uniform draws
come from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import lane_shuffle
from ..parallel import mesh


def unit_linspace(n: int, device=None) -> torch.Tensor:
    """``jnp.linspace(0, 1, n)`` in float32, value for value.

    XLA folds jnp.linspace's ``iota / (n - 1)`` into a multiply by the
    rounded reciprocal, so its entries differ from ``torch.linspace`` (and
    from a true division) by an ulp at many positions — enough to shift
    every stratified depth and flip a ``searchsorted`` bin. The stratified
    depths and the deterministic draws of :func:`sample_pdf` use this form
    so that the port and the JAX package sample the same depths. Made on
    ``device`` with no copy from the host (a captured step may make it).
    """
    if n == 1:
        return torch.zeros(1, dtype=torch.float32, device=device)
    recip = float(np.float32(1) / np.float32(n - 1))
    t = torch.arange(n - 1, dtype=torch.float32, device=device) * recip
    return torch.cat([t, torch.ones(1, dtype=torch.float32, device=device)])


def searchsorted_right(sorted_seq: torch.Tensor,
                       values: torch.Tensor) -> torch.Tensor:
    """Batched ``searchsorted(..., side='right')``: int64 [..., N] =
    #{m : sorted_seq[..., m] <= v}, equal to the JAX package's
    broadcast-compare form, including v equal to the last entry."""
    return torch.searchsorted(sorted_seq.contiguous(), values.contiguous(),
                              right=True)


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, N_samples: int,
               det: bool = False,
               generator: torch.Generator | None = None) -> torch.Tensor:
    """Draw N_samples per ray from the piecewise-constant PDF over ``bins``.

    bins: [R, M] bin positions; weights: [R, M-1] unnormalized bin masses.
    ``det`` draws at :func:`unit_linspace` instead of uniform noise from
    ``generator``. Returns samples [R, N_samples], detached from the graph
    as the JAX package's ``stop_gradient`` and the reference's ``detach()``
    make them (ref: utils/rays.py:188).
    """
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, -1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)   # [R, M]

    shape = cdf.shape[:-1] + (N_samples,)
    if det:
        u = unit_linspace(N_samples, cdf.device).expand(shape).contiguous()
    else:
        u = mesh.draw(torch.rand, shape, generator, cdf.device, cdf.dtype)

    inds = searchsorted_right(cdf, u)
    below = torch.clamp_min(inds - 1, 0).int()
    above = torch.clamp_max(inds, cdf.shape[-1] - 1).int()
    cdf_below, cdf_above, bins_below, bins_above = lane_shuffle.cdf_take(
        cdf.detach(), bins.detach().contiguous(), below, above)

    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return (bins_below + t * (bins_above - bins_below)).detach()
