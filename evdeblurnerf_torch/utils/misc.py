"""Small host-side helpers: schedules, dtype compaction, unit conversion.

Counterpart of ``evdeblurnerf_tpu/utils/misc.py`` (ref: utils/misc.py), with
numpy only.
"""

from __future__ import annotations

import math

import numpy as np


def to8b(x) -> np.ndarray:
    """[0,1] float image -> uint8 (ref: utils/misc.py:6)."""
    return (255 * np.clip(np.asarray(x), 0, 1)).astype(np.uint8)


def exponential_scale_fine_loss_weight(N_iters, kernel_start_iter, start_ratio,
                                       end_ratio, iter):
    """Exponential coarse-to-fine AWP loss weight (ref: utils/misc.py:9-12)."""
    interval_len = N_iters - kernel_start_iter
    scale = (1.0 / interval_len) * np.log(end_ratio / start_ratio)
    return start_ratio * np.exp(scale * (iter - kernel_start_iter))


def annealing_interpolator(start_value, end_value, end_step, method="linear",
                           start_step=0):
    """Step -> value schedule; linear / cosine / constant.

    Matches ref: utils/misc.py:15-55 exactly, including the linear branch's
    use of the *unshifted* step in the slope term.
    """
    if method == "linear":
        def linear_interpolator(step):
            if step >= end_step:
                return end_value
            if step < start_step:
                return start_value
            slope = (end_value - start_value) / (end_step - start_step)
            return start_value + slope * step
        return linear_interpolator
    if method == "cosine":
        def cosine_interpolator(step):
            if step >= end_step:
                return end_value
            if step < start_step:
                return start_value
            cos_factor = (1 + math.cos(
                math.pi * (step - start_step) / (end_step - start_step))) / 2
            return start_value * cos_factor + end_value * (1 - cos_factor)
        return cosine_interpolator
    if method == "constant":
        return lambda step: start_value
    raise ValueError(f"Unsupported method: {method}")


def is_int_dtype(array) -> bool:
    return np.issubdtype(array.dtype, np.integer)


def is_float_dtype(array) -> bool:
    return np.issubdtype(array.dtype, np.floating)


def can_be_int_dtype(array, intdtype=np.int32) -> bool:
    """True if values are integral (ref: utils/misc.py:66-67)."""
    return is_int_dtype(array) or (
        is_float_dtype(array) and bool(np.all(intdtype(array) == array)))


def smallest_int_dtype(lower, upper):
    for dtype in (np.uint8, np.int8, np.int16, np.int32, np.int64):
        info = np.iinfo(dtype)
        if upper <= info.max and lower >= info.min:
            return dtype
    return None


def possibly_smallest_int(array, round=True):
    """Compact integral float arrays to the smallest int dtype
    (ref: utils/misc.py:79-84)."""
    if can_be_int_dtype(array):
        if round:
            array = np.round(array)
        return array.astype(smallest_int_dtype(array.min(), array.max()))
    return array


def convert_unit(from_unit: str, to_unit: str) -> float:
    """Time-unit scale factor (ref: utils/misc.py:108-110)."""
    powers = {"s": 0, "ms": -3, "us": -6, "ns": -9}
    return 10 ** (powers[from_unit] - powers[to_unit])


def to_flattenvoid(arr: np.ndarray) -> np.ndarray:
    """View a 2D array as 1D void records for row-wise unique
    (ref: utils/misc.py:143-149)."""
    assert arr.ndim == 2
    arr = np.ascontiguousarray(arr)
    return arr.view(np.dtype((np.void, arr.dtype.itemsize * arr.shape[1])))


def unravel_index(indices: np.ndarray, shape) -> np.ndarray:
    """Flat indices -> [N, D] coordinates (ref: utils/misc.py:160-177)."""
    return np.stack(np.unravel_index(np.asarray(indices), shape), axis=-1)


def seed_everything(seed: int):
    """Seed the host RNGs (ref: utils/misc.py:180-195). Every device draw
    of the port comes from the explicit ``torch.Generator`` of the train
    state, so torch's global generator is not touched."""
    import random
    import os

    random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    np.random.seed(seed)
