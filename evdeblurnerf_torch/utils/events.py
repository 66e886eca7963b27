"""The event-generation-model (EGM) loss.

Counterpart of ``evdeblurnerf_tpu/utils/events.py::egm_loss`` (ref:
utils/events.py:260-284). The event loaders of that module are host code
and come with the data layer.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def egm_loss(luma_start: torch.Tensor, luma_end: torch.Tensor,
             bii: torch.Tensor, color_mask: Optional[torch.Tensor] = None,
             color_weight: Optional[Sequence[float]] = None,
             log_eps: float = 1e-5) -> torch.Tensor:
    """Weighted mean of ``(log(L_end + eps) - log(L_start + eps) - bii)^2``
    with ``bii = theta+ * SumP+ + theta- * SumP-`` from the caller.

    luma [N, C]; bii [N]. With a one-hot [N, 3] ``color_mask`` (a colour
    event camera's Bayer pattern) each ray's own channel is taken, weighted
    by ``color_weight[channel]`` when given.
    """
    pred_bii = torch.log(luma_end + log_eps) - torch.log(luma_start + log_eps)
    if color_mask is not None:
        mask = color_mask.to(pred_bii.dtype)
        pred_bii = torch.sum(pred_bii * mask, -1)
        if color_weight is not None:
            cw = torch.as_tensor(color_weight, dtype=pred_bii.dtype,
                                 device=pred_bii.device)
            weight = torch.sum(mask * cw, -1)
        else:
            weight = torch.ones_like(pred_bii)
    else:
        pred_bii = pred_bii.squeeze(-1)
        weight = torch.ones_like(pred_bii)
    sq = (pred_bii - bii) ** 2
    return torch.sum(sq * weight) / torch.sum(weight)
