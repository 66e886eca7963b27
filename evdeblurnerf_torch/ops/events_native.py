"""ctypes bindings for the C++ event-scan kernels, with numpy twins.

Counterpart of ``evdeblurnerf_tpu/ops/events_native.py`` (which replaces the
reference's Numba ``@njit`` host kernels and TorchScript gather, ref:
utils/events.py:72-257). The shared library is built at first use from
``events_cpp/events.cpp`` by one ``g++ -O3 -shared`` call into
``build/evdeblurnerf_torch/`` beside the package (the directory the CUDA
kernels build into), under a name that carries a digest of the source, so
an edited source rebuilds. The numpy twins are fully vectorized
(sort-based) and give identical results: they serve a machine without a
C++ toolchain and are cross-checks in the tests. :func:`backend` says
which of the two this process uses.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_SOURCE = Path(__file__).resolve().parent / "events_cpp" / "events.cpp"
BUILD_DIR = (Path(__file__).resolve().parent.parent.parent / "build"
             / "evdeblurnerf_torch")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
_lib: Optional[ctypes.CDLL] = None
_lib_failed = False

_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode()
                            + _SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libevents_{digest}.so"


def _build() -> Path:
    """Compile the library unless a build of this exact source exists."""
    out = library_path()
    if out.is_file():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(_SOURCE)],
                   check=True, capture_output=True)
    os.replace(tmp, out)        # atomic publish, as kernels/build.py
    return out


def _load_library() -> Optional[ctypes.CDLL]:
    """The loaded library, or None when it cannot be built here (no
    toolchain, read-only tree): the callers then take the numpy twins."""
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    try:
        lib = ctypes.CDLL(str(_build()))
        lib.compute_successor_flat.restype = ctypes.c_int
        lib.compute_successor_flat.argtypes = [
            _i64p, ctypes.c_int64, ctypes.c_int64, _i64p, _i32p, _i64p, _i64p]
        lib.accumulate_events_flat.restype = ctypes.c_int64
        lib.accumulate_events_flat.argtypes = [
            _i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, _i64p]
        lib.gather_successor.restype = ctypes.c_int
        lib.gather_successor.argtypes = [
            _i64p, _i64p, ctypes.c_int64, _i64p, _i64p, ctypes.c_int64,
            _i64p, _i64p, _i64p]
        lib.accumulate_events_at_time_flat.restype = ctypes.c_int
        lib.accumulate_events_at_time_flat.argtypes = [
            _i64p, ctypes.c_int64, ctypes.c_int64, _f64p,
            ctypes.c_int64, _i64p, _i64p, _i64p]
        _lib = lib
    except (OSError, RuntimeError, subprocess.CalledProcessError,
            AttributeError):
        _lib_failed = True
    return _lib


def backend() -> str:
    """``"g++ library"`` or ``"numpy"``: what the event scans run on."""
    return "g++ library" if _load_library() is not None else "numpy"


# ---------------------------------------------------------------------------
# successor graph
# ---------------------------------------------------------------------------

def compute_successor_np(pixel_ids: np.ndarray
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized numpy successor graph (stable sort by pixel id).

    Returns (successor_idx [N] int64, num_successors [N] int32,
    latest_seen [P] int64 = first event idx per pixel,
    first_seen [P] int64 = last event idx per pixel), P = max(id)+1.
    Naming of latest/first follows the reference's reverse-scan semantics
    (ref: utils/events.py:92-120).
    """
    pixel_ids = np.ascontiguousarray(pixel_ids, dtype=np.int64)
    n = pixel_ids.shape[0]
    num_pixels = int(pixel_ids.max()) + 1 if n else 0

    order = np.argsort(pixel_ids, kind="stable")        # groups by pixel,
    sorted_ids = pixel_ids[order]                       # time order within
    successor_sorted = np.empty(n, dtype=np.int64)
    # within each group, the successor is the next element
    same_next = np.empty(n, dtype=bool)
    same_next[:-1] = sorted_ids[1:] == sorted_ids[:-1]
    same_next[-1:] = False
    successor_sorted[same_next] = order[1:][same_next[:-1]]
    successor_sorted[~same_next] = order[~same_next]    # self (no successor)

    successor_idx = np.empty(n, dtype=np.int64)
    successor_idx[order] = successor_sorted

    # num_successors: distance from the end of the group
    group_last = np.nonzero(~same_next)[0]
    counts_sorted = np.empty(n, dtype=np.int32)
    prev_end = -1
    for last in group_last:                              # loops over pixels,
        length = last - prev_end                         # not events
        counts_sorted[prev_end + 1:last + 1] = np.arange(
            length - 1, -1, -1, dtype=np.int32)
        prev_end = last
    num_successors = np.empty(n, dtype=np.int32)
    num_successors[order] = counts_sorted

    latest_seen = np.full(num_pixels, -1, dtype=np.int64)
    first_seen = np.full(num_pixels, -1, dtype=np.int64)
    group_first = np.concatenate([[0], group_last[:-1] + 1]) if n else []
    for gf, gl in zip(group_first, group_last):
        latest_seen[sorted_ids[gf]] = order[gf]
        first_seen[sorted_ids[gf]] = order[gl]
    return successor_idx, num_successors, latest_seen, first_seen


def compute_successor(pixel_ids: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Successor graph over a flat-pixel-id event stream.

    Uses the C++ kernel when available, numpy otherwise. Matches
    ref: utils/events.py:72-120 with flat_xy=True.
    """
    lib = _load_library()
    pixel_ids = np.ascontiguousarray(pixel_ids, dtype=np.int64)
    n = pixel_ids.shape[0]
    num_pixels = int(pixel_ids.max()) + 1 if n else 0
    if lib is None:
        return compute_successor_np(pixel_ids)
    successor_idx = np.empty(n, dtype=np.int64)
    num_successors = np.empty(n, dtype=np.int32)
    latest_seen = np.empty(num_pixels, dtype=np.int64)
    first_seen = np.empty(num_pixels, dtype=np.int64)
    rc = lib.compute_successor_flat(pixel_ids, n, num_pixels, successor_idx,
                                    num_successors, latest_seen, first_seen)
    if rc != 0:
        raise ValueError("compute_successor: pixel id out of range")
    return successor_idx, num_successors, latest_seen, first_seen


# ---------------------------------------------------------------------------
# accumulation
# ---------------------------------------------------------------------------

def accumulate_events_np(events: np.ndarray, n: int) -> np.ndarray:
    """Numpy fallback for count-based accumulation (flat ids).

    events: int64 [N, 3] rows (xy, t, p); groups every n consecutive events
    per pixel, polarity-summed; the first event of each pixel always emits
    (ref: utils/events.py:144-169).
    """
    events = np.asarray(events, dtype=np.int64)
    ids = events[:, 0]
    order = np.argsort(ids, kind="stable")
    sorted_ev = events[order]
    boundaries = np.nonzero(np.diff(sorted_ev[:, 0]))[0] + 1
    out = []
    for grp in np.split(np.arange(events.shape[0]), boundaries):
        ev = sorted_ev[grp]
        pol_cum = np.cumsum(ev[:, 2])
        # emit at positions 0, n, 2n, ... within the group
        emit = np.arange(ev.shape[0]) % n == 0
        idx = np.nonzero(emit)[0]
        pol = pol_cum[idx] - np.concatenate([[0], pol_cum[idx[:-1]]])
        rows = np.stack([ev[idx, 0], ev[idx, 1], pol], -1)
        out.append((rows, order[grp][idx]))
    if not out:
        return np.zeros((0, 3), dtype=np.int64)
    rows = np.concatenate([r for r, _ in out])
    orig_idx = np.concatenate([i for _, i in out])
    return rows[np.argsort(orig_idx, kind="stable")]


def accumulate_events(events: np.ndarray, n: int) -> np.ndarray:
    """Count-based accumulation; C++ when available."""
    lib = _load_library()
    events = np.ascontiguousarray(events, dtype=np.int64)
    if lib is None:
        return accumulate_events_np(events, n)
    num_pixels = int(events[:, 0].max()) + 1 if events.shape[0] else 0
    out = np.empty_like(events)
    num_out = lib.accumulate_events_flat(events, events.shape[0], num_pixels,
                                         n, out)
    if num_out < 0:
        raise ValueError("accumulate_events: pixel id out of range")
    return out[:num_out]


def accumulate_events_at_time(events: np.ndarray, timestamps: np.ndarray,
                              n: int, return_zeroevents: bool = False):
    """Timestamp-grid accumulation (ref: utils/events.py:174-218, flat ids).

    events: [N, 3] (xy, t, p), time-sorted; emits one aggregated event per
    active pixel per sampled interval; optionally the zero-event (inactive)
    pixels. C++ when available, numpy twin otherwise (cross-checked in
    tests/test_events.py). Not used by the training path — offline
    analysis parity, like its upstream counterpart.
    """
    lib = _load_library()
    if lib is not None and hasattr(lib, "accumulate_events_at_time_flat"):
        return _accumulate_events_at_time_cpp(lib, events, timestamps, n,
                                              return_zeroevents)
    return accumulate_events_at_time_np(events, timestamps, n,
                                        return_zeroevents)


def _accumulate_events_at_time_cpp(lib, events, timestamps, n,
                                   return_zeroevents):
    events = np.ascontiguousarray(events, dtype=np.int64)
    sampled = np.ascontiguousarray(np.asarray(timestamps)[::n + 1],
                                   dtype=np.float64)
    num_pixels = int(events[:, 0].max()) + 1 if events.shape[0] else 0
    n_int = max(0, sampled.shape[0] - 1)
    cap = n_int * num_pixels
    out_events = np.empty((cap, 3), dtype=np.int64)
    out_zero = np.empty((cap, 3), dtype=np.int64)
    counts = np.zeros(2, dtype=np.int64)
    rc = lib.accumulate_events_at_time_flat(
        events, events.shape[0], num_pixels, sampled, sampled.shape[0],
        out_events, out_zero, counts)
    if rc != 0:
        raise ValueError("accumulate_events_at_time: pixel id out of range")
    out_events = out_events[:counts[0]].copy()
    out_zero = out_zero[:counts[1]].copy()
    if return_zeroevents:
        return out_events, out_zero
    return out_events


def accumulate_events_at_time_np(events: np.ndarray, timestamps: np.ndarray,
                                 n: int, return_zeroevents: bool = False):
    """Vectorized numpy twin of the C++ kernel above."""
    events = np.asarray(events, dtype=np.int64)
    sampled = np.asarray(timestamps)[::n + 1]
    idx_tms = np.searchsorted(events[:, 1], sampled - 1e-6)
    num_pixels = int(events[:, 0].max()) + 1 if events.shape[0] else 0

    out_events, out_zero = [], []
    for i0, i1, t0, t1 in zip(idx_tms[:-1], idx_tms[1:], sampled[:-1],
                              sampled[1:]):
        accum = np.zeros(num_pixels, dtype=np.int64)
        np.add.at(accum, events[i0:i1, 0], events[i0:i1, 2])
        nnz = np.nonzero(accum)[0]
        zero = np.nonzero(accum == 0)[0]
        out_events.append(np.stack(
            [nnz, np.full_like(nnz, t1), accum[nnz]], -1))
        out_zero.append(np.stack(
            [zero, np.full_like(zero, t0), np.full_like(zero, t1)], -1))
    out_events = (np.concatenate(out_events) if out_events
                  else np.zeros((0, 3), np.int64))
    out_zero = (np.concatenate(out_zero) if out_zero
                else np.zeros((0, 3), np.int64))
    if return_zeroevents:
        return out_events, out_zero
    return out_events


# ---------------------------------------------------------------------------
# k-hop gather
# ---------------------------------------------------------------------------

def gather_successor_np(query_idx, query_hops, successor_map, polarities):
    """Numpy k-hop gather (ref: utils/events.py:221-257)."""
    query_idx = np.asarray(query_idx, dtype=np.int64)
    query_hops = np.asarray(query_hops, dtype=np.int64)
    successor_map = np.asarray(successor_map, dtype=np.int64)
    polarities = np.asarray(polarities, dtype=np.int64)

    max_hops = int(query_hops.max()) if query_hops.size else 0
    out_idx = query_idx.copy()
    out_pos = np.zeros_like(query_idx)
    out_neg = np.zeros_like(query_idx)
    invalid = np.zeros(query_idx.shape[0], dtype=bool)
    n = successor_map.shape[0]
    for h in range(max_hops + 1):
        active = h <= query_hops
        cur = out_idx[active]
        nxt = successor_map[np.clip(cur, 0, n - 1)]
        bad = (cur < 0) | (cur >= n) | (nxt < 0) | (nxt >= n)
        pol = polarities[np.clip(nxt, 0, n - 1)]
        inv_active = invalid[active] | bad
        invalid[active] = inv_active
        out_idx[active] = nxt
        out_pos[active] += np.where(pol > 0, pol, 0)
        out_neg[active] += np.where(pol < 0, pol, 0)
    out_idx[invalid] = -1
    out_pos[invalid] = 0
    out_neg[invalid] = 0
    return out_idx, out_neg, out_pos


def gather_successor(query_idx, query_hops, successor_map, polarities):
    """Follow the successor map ``hops+1`` steps per query, accumulating
    +/- polarity sums. C++ when available.

    Contract: ``hops`` must be < the pixel's remaining chain length (the
    sampler's eligibility filter guarantees this). A chain END is encoded
    as a self-loop, so hops past it silently RE-accumulate the terminal
    event's polarity each extra step — callers must not rely on clamping.
    Out-of-range ``query_idx`` returns the invalid (-1, 0, 0) triple."""
    lib = _load_library()
    if lib is None:
        return gather_successor_np(query_idx, query_hops, successor_map,
                                   polarities)
    query_idx = np.ascontiguousarray(query_idx, dtype=np.int64)
    query_hops = np.ascontiguousarray(query_hops, dtype=np.int64)
    successor_map = np.ascontiguousarray(successor_map, dtype=np.int64)
    polarities = np.ascontiguousarray(polarities, dtype=np.int64)
    q = query_idx.shape[0]
    out_idx = np.empty(q, dtype=np.int64)
    out_neg = np.empty(q, dtype=np.int64)
    out_pos = np.empty(q, dtype=np.int64)
    lib.gather_successor(query_idx, query_hops, q, successor_map, polarities,
                         successor_map.shape[0], out_idx, out_neg, out_pos)
    return out_idx, out_neg, out_pos
