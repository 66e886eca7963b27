"""Event-stream loading and the event-generation-model (EGM) loss.

Counterpart of ``evdeblurnerf_tpu/utils/events.py``. Host side: HDF5
ingestion with float-coordinate compaction, numpy only (ref:
utils/events.py:11-69). Device side: the EGM loss (ref:
utils/events.py:260-284). The successor-graph and accumulation scans live
in ``ops/events_native.py``.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from .misc import (can_be_int_dtype, convert_unit, possibly_smallest_int,
                   to_flattenvoid)


def load_events_h5(events_path: str, h: int, w: int, coords_decimals=None,
                   optimize_ids: bool = False, events_tms_unit: str = "ns"
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Load an (x, y, t, p) event stream from HDF5 and compact it
    (:func:`compact_events`). Matches ref: utils/events.py:11-69."""
    import h5py

    with h5py.File(events_path, "r") as f:
        events = {k: f[k][:] for k in "xytp"}
    return compact_events(events, h, w, coords_decimals, optimize_ids,
                          events_tms_unit)


def compact_events(events, h: int, w: int, coords_decimals=None,
                   optimize_ids: bool = False, events_tms_unit: str = "ns"
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Everything after the read of an event file: ``events`` maps
    ``x, y, t, p`` to the stream's arrays.

    Float (rectified) coordinates are deduplicated into compact coordinate
    ids; integer coordinates map to flat y*w+x ids unless ``optimize_ids``.
    Timestamps are converted to microseconds and compacted to the smallest
    integer dtype.

    Returns (events [N,3] = (coord_id, t_us, p), zero-event coord ids,
    id_to_coords [num_ids, 2] or flat arange).
    """
    tms_file_scale = convert_unit(events_tms_unit, "us")
    events = dict(events)
    events["x"] = events["x"].astype(np.float32)
    events["y"] = events["y"].astype(np.float32)
    events["t"] = possibly_smallest_int(events["t"] * tms_file_scale)

    zero_pixels = np.ones((h, w), dtype=np.uint8)
    zero_pixels[np.clip(np.round(events["y"]).astype(np.int32), 0, h - 1),
                np.clip(np.round(events["x"]).astype(np.int32), 0, w - 1)] = 0
    zeroev_coords = np.stack(np.where(zero_pixels), axis=-1)[:, ::-1]

    float_coords = (not can_be_int_dtype(events["x"])
                    or not can_be_int_dtype(events["y"]))
    if float_coords and coords_decimals is not None:
        events["x"] = np.around(events["x"], decimals=coords_decimals)
        events["y"] = np.around(events["y"], decimals=coords_decimals)
    ev_coords = np.stack([events["x"], events["y"]], axis=-1)

    num_ev = ev_coords.shape[0]
    # plain concatenation promotes float32 coords + int64 zero-event coords
    # to float64, exactly like ref: utils/events.py:53 — the promotion decides
    # the byte-wise void-unique ordering and therefore the coordinate IDs
    all_coords = np.concatenate([ev_coords, zeroev_coords], 0)

    if optimize_ids or float_coords:
        void_view = to_flattenvoid(all_coords).ravel()
        _, idx, inv_idx = np.unique(void_view, return_index=True,
                                    return_inverse=True)
        id_to_coords = all_coords[idx]
        all_ids = inv_idx.ravel().astype(np.int64)
    else:
        assert can_be_int_dtype(all_coords)
        id_to_coords = np.arange(h * w)
        all_ids = (all_coords[:, 1] * w + all_coords[:, 0]).astype(np.int64)

    ev_ids, noev_ids = all_ids[:num_ev], all_ids[num_ev:]
    # natural promotion, like ref: utils/events.py:68 — when timestamps are
    # fractional (not compacted to int by possibly_smallest_int) the events
    # array stays float64, preserving sub-microsecond event times for pose
    # interpolation; ids/polarities are small ints, exact in float64
    events_arr = np.stack([ev_ids.astype(np.int64),
                           np.asarray(events["t"]),
                           np.asarray(events["p"])], axis=-1)
    if events_arr.dtype != np.float64:
        events_arr = events_arr.astype(np.int64)
    return events_arr, noev_ids, id_to_coords


def egm_loss(luma_start: torch.Tensor, luma_end: torch.Tensor,
             bii: torch.Tensor, color_mask: Optional[torch.Tensor] = None,
             color_weight: Optional[Sequence[float]] = None,
             log_eps: float = 1e-5,
             weight_total: Optional[Callable] = None) -> torch.Tensor:
    """Weighted mean of ``(log(L_end + eps) - log(L_start + eps) - bii)^2``
    with ``bii = theta+ * SumP+ + theta- * SumP-`` from the caller.

    luma [N, C]; bii [N]. With a one-hot [N, 3] ``color_mask`` (a colour
    event camera's Bayer pattern) each ray's own channel is taken, weighted
    by ``color_weight[channel]`` when given. ``weight_total``: the
    denominator from the local sum of weights, for a rank of a
    data-parallel step (``parallel/mesh.py::shard_total``), whose shards'
    sums of colour weights differ.
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
    total = torch.sum(weight)
    if weight_total is not None:
        total = weight_total(total)
    return torch.sum(sq * weight) / total
