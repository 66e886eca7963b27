"""Event-stream dataset: HDF5 ingest, successor graph, EGM pair sampling,
EDI prior (host side, numpy + C++ scan kernels).

Counterpart of ``evdeblurnerf_tpu/data/events.py`` (ref:
data/loader_events.py), with the same numpy generators from the same seeds.
Differences from the reference by design:

* the successor graph / k-hop gather run through the C++ kernels of
  ``ops/events_native.py`` (replacing Numba / TorchScript);
* pose interpolation is a single vectorized scipy SLERP+cubic call per batch
  in the prefetch thread (the reference pays 8 worker processes for the same
  work, ref: run_nerf.py:86-92);
* the annealing global step is a plain thread-safe counter — there are no
  worker processes to synchronize (ref: data/loader_events.py:75-97 uses a
  multiprocessing.Value).

The event file is read only by :meth:`LLFFEventsDataset.load_events`; a
subclass that overrides it can feed a stream stored another way.
"""

from __future__ import annotations

import os
import threading
from typing import Iterator

import numpy as np

from ..ops.events_native import compute_successor, gather_successor
from ..utils import pose as pose_utils
from ..utils.edi import brightness_increment_image, deblur_double_integral
from ..utils.events import load_events_h5
from ..utils.misc import (annealing_interpolator, can_be_int_dtype,
                          convert_unit, possibly_smallest_int)
from ..utils.rays import get_rays_pix_np


class LLFFEventsDataset:
    """Event stream + interpolated poses for the EGM loss
    (ref: data/loader_events.py:17-326)."""

    def __init__(self, args, basedir, H, W, K, factor=8, recenter=True,
                 bd_factor=0.75, bd_scale=1.0, closest_bds=0.1,
                 furthest_bds=100.0, spherify=False, recenter_partial=None,
                 spherify_partial=None, events_tms_unit="ns",
                 events_tms_files_unit="us", color_events=False):
        self.args = args
        self.basedir = basedir
        self.h, self.w, self.K = H, W, K
        self.factor = factor
        self.bd_scale = bd_scale
        self.bd_factor = bd_factor
        self.closest_bds = closest_bds
        self.furthest_bds = furthest_bds
        self.recenter = recenter
        self.spherify = spherify
        self.recenter_partial = recenter_partial
        self.spherify_partial = spherify_partial
        self.color_events = color_events
        self.events_tms_unit = events_tms_unit
        self.events_tms_files_unit = events_tms_files_unit

        self.event_accumulate_step_range = args.event_accumulate_step_range
        self.event_accumulate_step_range_end = args.event_accumulate_step_range_end

        self._load_event_data()

        self._step_lock = threading.Lock()
        self._global_step = 0
        self.event_accum_min_step = annealing_interpolator(
            self.event_accumulate_step_range[0],
            self.event_accumulate_step_range_end[0],
            args.event_accumulate_step_end,
            args.event_accumulate_step_scheduler)
        self.event_accum_max_step = annealing_interpolator(
            self.event_accumulate_step_range[1],
            self.event_accumulate_step_range_end[1],
            args.event_accumulate_step_end,
            args.event_accumulate_step_scheduler)

        self._rng = np.random.default_rng(args.seed)

    # ------------------------------------------------------------------
    # annealing step counter
    # ------------------------------------------------------------------
    @property
    def global_step(self) -> int:
        return self._global_step

    @global_step.setter
    def global_step(self, value: int):
        with self._step_lock:
            self._global_step = value

    def global_step_plusplus(self) -> int:
        with self._step_lock:
            step = self._global_step
            self._global_step += 1
        return step

    # ------------------------------------------------------------------
    # loading (ref: data/loader_events.py:150-257)
    # ------------------------------------------------------------------
    def _load_event_data(self):
        tms_file_scale = convert_unit(self.events_tms_files_unit, "us")
        tms_arr = np.load(os.path.join(self.basedir, "images_1/timestamps.npz"))
        self.images_poses_timestamps = tms_arr["timestamps"] * tms_file_scale
        self.images_tms_start = tms_arr["timestamps_start"] * tms_file_scale
        self.images_tms_end = tms_arr["timestamps_end"] * tms_file_scale

        all_timestamps = np.load(
            os.path.join(self.basedir, "all_timestamps.npy")
        ).astype(np.float64) * tms_file_scale
        if can_be_int_dtype(all_timestamps) and tms_file_scale == 1:
            all_timestamps = np.load(
                os.path.join(self.basedir, "all_timestamps.npy"))
        all_timestamps = possibly_smallest_int(all_timestamps)
        self.allknown_poses_timestamps = all_timestamps

        all_poses_bounds = np.load(
            os.path.join(self.basedir, "all_poses_bounds.npy"))
        all_poses = all_poses_bounds[:, :-2].reshape(-1, 3, 5)[:, :3, :4]
        assert pose_utils.is_pure_rotation_matrix(all_poses[:, :3, :3])
        self.allknown_poses = all_poses
        self._pose_interp = pose_utils.get_slerp_interpolator(
            np.asarray(all_timestamps, dtype=np.float64),
            all_poses[:, :3, :3], all_poses[:, :3, 3])

        events, zero_coord_ids, id_to_coords = self.load_events()

        tmin, tmax = np.min(all_timestamps), np.max(all_timestamps)
        events = events[(events[:, 1] >= tmin) & (events[:, 1] <= tmax)]

        self.integer_coords = bool(
            np.all(id_to_coords.astype(np.int32) == id_to_coords))
        if id_to_coords.ndim == 1:
            id_to_coords = np.stack(
                [id_to_coords % self.w, id_to_coords // self.w], -1)
        self.id_to_coords = id_to_coords

        if events[:, 2].min() == 0:        # polarity in {0,1} -> {-1,1}
            events[events[:, 2] == 0, 2] = -1
        assert events[:, 2].max() == 1 and events[:, 2].min() == -1

        self.id_to_color_map = (
            self._build_color_map(id_to_coords, zero_coord_ids)
            if self.color_events else None)

        succ_idx, num_successors = self._successor_graph(events)
        # events rows: (coord_id, t, p, successor_idx)
        self.events = np.concatenate(
            [events, succ_idx.reshape(-1, 1)], axis=-1)
        self.events_num_successors = num_successors

        if tuple(self.event_accumulate_step_range) != (0, 0):
            min_step = max(self.event_accumulate_step_range[0],
                           self.event_accumulate_step_range_end[0])
            self.events_with_successor_idx = \
                np.nonzero(num_successors > min_step)[0]
        else:
            self.events_with_successor_idx = np.nonzero(num_successors > 0)[0]

    def load_events(self):
        """(events [N, 3] = (coord_id, t_us, p), zero-event coord ids,
        id_to_coords) of the scene's ``events.h5``."""
        return load_events_h5(
            os.path.join(self.basedir, "events.h5"), self.h, self.w,
            coords_decimals=None, optimize_ids=True,
            events_tms_unit=self.events_tms_unit)

    def _successor_graph(self, events):
        """Load the precomputed sidecar (tools/preprocess_events.py) when it
        matches the loaded stream, else run the C++ scan now."""
        sidecar = os.path.join(self.basedir, "events_successor.npz")
        if os.path.exists(sidecar):
            data = np.load(sidecar)
            if int(data["n_events"]) == events.shape[0]:
                return (np.asarray(data["successor_idx"], np.int64),
                        np.asarray(data["num_successors"], np.int32))
            print(f"[events] stale sidecar {sidecar} "
                  f"({int(data['n_events'])} != {events.shape[0]}), "
                  "recomputing")
        succ_idx, num_successors, _, _ = compute_successor(events[:, 0])
        return succ_idx, num_successors

    def _build_color_map(self, id_to_coords, zero_coord_ids):
        """Bayer RGGB mask per event coordinate id
        (ref: data/loader_events.py:208-236)."""
        color_map = np.zeros([self.h, self.w, 3], dtype=bool)
        color_map[0::2, 0::2, 0] = True    # r
        color_map[0::2, 1::2, 1] = True    # g
        color_map[1::2, 0::2, 1] = True    # g
        color_map[1::2, 1::2, 2] = True    # b

        ev_map_path = os.path.join(self.basedir, "ev_map.npz")
        if self.integer_coords:
            assert not os.path.exists(ev_map_path), \
                "Int coordinates but ev_map.npz found. Coordinates rectified?"
            return color_map[np.int64(id_to_coords[:, 1]),
                             np.int64(id_to_coords[:, 0])]
        assert os.path.exists(ev_map_path), \
            "Float coordinates but no ev_map.npz. Coordinates not rectified?"
        maps = np.load(ev_map_path)
        invmap_x, invmap_y = maps["inv_mapx"], maps["inv_mapy"]
        assert invmap_x.shape == invmap_y.shape == (self.h, self.w)
        # vectorized row-matching of the undistortion map against the
        # deduplicated coordinate table (ref does a python double loop):
        # exact (x, y) pair equality via a sorted structured view +
        # searchsorted; duplicate hits resolve row-major like the loop did
        coords = np.ascontiguousarray(id_to_coords)
        pair_dt = np.dtype([("x", coords.dtype), ("y", coords.dtype)])
        table = coords.view(pair_dt).ravel()
        queries = np.ascontiguousarray(
            np.stack([invmap_x.ravel(), invmap_y.ravel()], axis=1)
            .astype(coords.dtype, copy=False)).view(pair_dt).ravel()
        order = np.argsort(table)
        pos = np.clip(np.searchsorted(table[order], queries),
                      0, table.shape[0] - 1)
        hit = table[order[pos]] == queries
        id_to_color_map = np.zeros([id_to_coords.shape[0], 3], dtype=bool)
        id_to_color_map[order[pos[hit]]] = color_map.reshape(-1, 3)[hit]
        mask = np.ones([id_to_coords.shape[0]], dtype=bool)
        mask[zero_coord_ids] = False
        assert (id_to_color_map[mask].sum(axis=-1) == 1).all()
        return id_to_color_map

    # ------------------------------------------------------------------
    # pose interpolation (ref: data/loader_events.py:133-148)
    # ------------------------------------------------------------------
    def interpolate_poses(self, t) -> np.ndarray:
        rots, trans = self._pose_interp(np.asarray(t, dtype=np.float64))
        int_poses = np.concatenate([rots, trans[..., None]], -1)
        int_poses = np.concatenate(
            [int_poses[..., 1:2], -int_poses[..., 0:1], int_poses[..., 2:]],
            -1).astype(np.float32)
        int_poses[..., :3, 3] *= self.bd_scale
        if self.recenter:
            int_poses = pose_utils.recenter_poses(int_poses,
                                                  c2w=self.recenter_partial)
        if self.spherify:
            bds = np.array([[self.closest_bds, self.furthest_bds]]).repeat(
                int_poses.shape[0], axis=0)
            # render_path=False: this runs per prefetched event batch and
            # only needs the replayed poses, not the 120-pose circle
            int_poses, _, _ = pose_utils.spherify_poses(
                int_poses, bds, state=self.spherify_partial,
                render_path=False)
        return int_poses

    # ------------------------------------------------------------------
    # EDI prior (ref: data/loader_events.py:99-131)
    # ------------------------------------------------------------------
    def compute_edi_prior(self, i_images, images, steps, cpos, cneg):
        images = np.asarray(images)
        img_n, img_h, img_w, _ = images.shape
        tms_start = self.images_tms_start[i_images]
        tms_end = self.images_tms_end[i_images]
        # t == 0 is a valid (rebased) first exposure start; only ordering
        # and non-negativity matter for the searchsorted below
        assert (tms_start < tms_end).all() and (tms_start >= 0).all()

        all_tms = np.concatenate(
            [np.linspace(s, e, steps) for s, e in zip(tms_start, tms_end)])
        ev_tms = self.events[:, 1]
        idx_left = np.searchsorted(ev_tms, all_tms).reshape(img_n, steps)
        idx_right = np.searchsorted(ev_tms, all_tms,
                                    side="right").reshape(img_n, steps)

        priors = []
        for i in range(img_n):
            bii_images = []
            for j in range(steps - 1):
                ev = self.events[idx_left[i, j]:idx_right[i, j + 1]]
                x, y = self.id_to_coords[ev[:, 0].astype(np.int64)].T
                bii = brightness_increment_image(
                    x, y, ev[:, 2], img_w, img_h, cpos, cneg,
                    interpolate=True)
                bii_images.append(np.repeat(bii[..., None], 3, axis=-1))
            bii_images = np.stack(bii_images, axis=0)
            priors.append(deblur_double_integral(images[i], bii_images))
        return np.stack(priors, axis=0)

    # ------------------------------------------------------------------
    # EGM pair sampling (ref: data/loader_events.py:259-304)
    # ------------------------------------------------------------------
    def sample_events(self, events_ids, global_step: int) -> dict:
        events = self.events
        start = events[events_ids]

        min_step = int(self.event_accum_min_step(global_step))
        max_step = int(self.event_accum_max_step(global_step))
        if (min_step, max_step) != (0, 0):
            num_succ = self.events_num_successors[events_ids]
            # uniform hops in [min_step-1, min(max_step, num_succ)-1]
            # (ref: data/loader_events.py:266-268, torch_randint_vec floor)
            hi = np.minimum(max_step, num_succ).astype(np.int64)
            hi = np.maximum(hi, min_step)      # guard degenerate schedules
            hops = self._rng.integers(min_step - 1, hi, endpoint=False,
                                      dtype=np.int64)
            succ_idx, neg_cumsum, pos_cumsum = gather_successor(
                events_ids, hops, events[:, 3], events[:, 2])
            end = events[succ_idx]
        else:
            end = events[start[:, 3].astype(np.int64)]
            pos_mask = end[:, 2] > 0
            pos_cumsum = np.where(pos_mask, end[:, 2], 0)
            neg_cumsum = np.where(~pos_mask, end[:, 2], 0)

        assert (end[:, 0] == start[:, 0]).all()
        poses_start = self.interpolate_poses(start[:, 1])
        poses_end = self.interpolate_poses(end[:, 1])

        coords_ids = start[:, 0].astype(np.int64)
        coords = self.id_to_coords[coords_ids]
        color_map = (self.id_to_color_map[coords_ids]
                     if self.color_events else None)

        ro_s, rd_s = get_rays_pix_np(coords, self.K, poses_start[:, :3, :4],
                                     add_halfpix=self.integer_coords)
        ro_e, rd_e = get_rays_pix_np(coords, self.K, poses_end[:, :3, :4],
                                     add_halfpix=self.integer_coords)

        out = {
            "events_pos_pol_cumsum": pos_cumsum.astype(np.float32),
            "events_neg_pol_cumsum": neg_cumsum.astype(np.float32),
            "events_rays_start": np.stack([ro_s, rd_s], -1),
            "events_rays_end": np.stack([ro_e, rd_e], -1),
            "events_coords_ids": coords_ids,
        }
        if color_map is not None:
            out["events_color_map"] = color_map
        return out

    def __len__(self):
        return self.events_with_successor_idx.shape[0]

    def batch(self, sample_ids) -> dict:
        step = self.global_step_plusplus()
        events_ids = self.events_with_successor_idx[np.asarray(sample_ids)]
        return self.sample_events(events_ids, step)

    __getitem__ = batch


class RandomEventSampler:
    """Epoch-permutation batches over the eligible events."""

    def __init__(self, n_events: int, batch_size: int, seed: int = 0):
        self.n_events = n_events
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)

    def __iter__(self) -> Iterator[np.ndarray]:
        perm = self.rng.permutation(self.n_events)
        for i in range(self.n_events // self.batch_size):
            yield perm[i * self.batch_size:(i + 1) * self.batch_size]
