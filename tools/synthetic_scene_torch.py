"""A synthetic LLFF + events scene for runs of the port on a machine
without an image or HDF5 library.

:func:`write_scene` writes the scene with numpy in the real LLFF + events
layout (``poses_bounds.npy``, ``all_poses_bounds.npy``,
``all_timestamps.npy``, ``images_1/timestamps.npz``), the images and the
events as ``.npz``; :func:`scene_classes` gives the two dataset subclasses
that read those where ``evdeblurnerf_torch.data`` reads PNG and HDF5.
Everything after the read (pose recentering, the bounds, the successor
graph, the EDI prior, the samplers) is the package's. The scene is a shaded
ball before a faint gradient, seen from a camera that slides sideways; the
image size only sets the host's work. Used by ``chip_smoke.py`` and
``tools/profile_loop_torch.py``.
"""

import os

import numpy as np

SCENE_H, SCENE_W, SCENE_FOCAL = 240, 320, 300.0
SCENE_IMAGES, SCENE_POSES_PER_IMAGE = 17, 4     # llffhold 8: 3 test views


def _render_scene_image(c2w, h, w, focal):
    i, j = np.meshgrid(np.arange(w, dtype=np.float32),
                       np.arange(h, dtype=np.float32), indexing="xy")
    dirs = np.stack([(i + 0.5 - w / 2) / focal, -(j + 0.5 - h / 2) / focal,
                     -np.ones_like(i)], -1)
    rays_d = dirs @ c2w[:3, :3].T
    oc = c2w[:3, 3] - np.array([0.0, 0.0, -4.0])
    radius = 1.2
    b = rays_d @ oc
    a = np.sum(rays_d * rays_d, -1)
    disc = b * b - a * (oc @ oc - radius ** 2)
    hit = disc > 0
    t = np.where(hit, (-b - np.sqrt(np.maximum(disc, 0.0))) / a, 0.0)
    normal = (oc + t[..., None] * rays_d) / radius
    shade = np.clip(normal[..., 2] * 0.5 + 0.5, 0, 1)
    img = np.stack([0.08 + 0.02 * i / w, 0.08 * np.ones_like(i),
                    0.10 + 0.02 * j / h], -1)
    ball = np.stack([0.9 * shade, 0.5 * shade + 0.2, 0.3 * shade], -1)
    return np.clip(np.where(hit[..., None], ball, img), 0, 1).astype(
        np.float32)


def write_scene(basedir, threshold, seed=0):
    """Write the scene in the real LLFF + events layout (``poses_bounds.npy``,
    ``all_poses_bounds.npy``, ``all_timestamps.npy``,
    ``images_1/timestamps.npz``), the images and the events as ``.npz``;
    returns the number of events."""
    h, w, focal = SCENE_H, SCENE_W, SCENE_FOCAL
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(basedir, "images_1"))
    n_all = SCENE_IMAGES * SCENE_POSES_PER_IMAGE
    all_t = np.linspace(0.0, 1.0, n_all)
    c2ws = np.zeros((n_all, 3, 4))
    c2ws[:, :3, :3] = np.eye(3)
    c2ws[:, :3, 3] = np.stack([0.6 * all_t - 0.3, 0.05 * np.sin(all_t * 6.0),
                               np.zeros_like(all_t)], -1)
    # the loader's axis swap, inverted, so that loading gives c2ws back
    hwf = np.broadcast_to(np.array([h, w, focal])[:, None], (n_all, 3, 1))
    ondisk = np.concatenate([-c2ws[:, :, 1:2], c2ws[:, :, 0:1],
                             c2ws[:, :, 2:4], hwf], 2)
    rows = np.concatenate([ondisk.reshape(n_all, 15),
                           np.tile([2.0, 7.0], (n_all, 1))], 1)
    np.save(os.path.join(basedir, "all_poses_bounds.npy"), rows)
    t_us = 1000.0 + 1000.0 * np.arange(n_all)
    np.save(os.path.join(basedir, "all_timestamps.npy"), t_us)
    knots = (np.arange(SCENE_IMAGES) * SCENE_POSES_PER_IMAGE
             + SCENE_POSES_PER_IMAGE // 2)
    half = 1000.0 * SCENE_POSES_PER_IMAGE * 0.5 / 2
    np.savez(os.path.join(basedir, "images_1", "timestamps.npz"),
             timestamps=t_us[knots], timestamps_start=t_us[knots] - half,
             timestamps_end=t_us[knots] + half)
    np.save(os.path.join(basedir, "poses_bounds.npy"), rows[knots])
    # blurry frames: the mean of the renders across the exposure
    images = np.stack([np.mean([_render_scene_image(
        c2ws[np.clip(k + d, 0, n_all - 1)], h, w, focal)
        for d in (-1, 0, 1)], 0) for k in knots])
    np.savez(os.path.join(basedir, "images_1", "images.npz"), images=images)

    # events from the log-intensity steps of a dense render sequence
    lum = np.array([0.299, 0.587, 0.114])
    xs, ys, ts, ps = [], [], [], []
    prev_log = prev_t = None
    for tq in np.linspace(t_us[0], t_us[-1], n_all * 4):
        k = np.interp(tq, t_us, np.arange(n_all))
        k0 = min(int(k), n_all - 2)
        c2w = c2ws[k0].copy()
        c2w[:, 3] += (k - k0) * (c2ws[k0 + 1][:, 3] - c2ws[k0][:, 3])
        log_img = np.log(_render_scene_image(c2w, h, w, focal) @ lum + 1e-3)
        if prev_log is not None:
            diff = log_img - prev_log
            count = np.minimum(np.abs(diff) // threshold, 4).astype(np.int64)
            yy, xx = np.nonzero(count)
            reps = count[yy, xx]
            xs.append(np.repeat(xx, reps))
            ys.append(np.repeat(yy, reps))
            ps.append(np.repeat(np.where(diff[yy, xx] > 0, 1, -1), reps))
            ts.append(rng.uniform(prev_t, tq, int(reps.sum())))
        prev_log, prev_t = log_img, tq
    ts = np.concatenate(ts)
    order = np.argsort(ts, kind="stable")
    # event times in ns (the configuration's events_tms_unit), the frames'
    # in us (its events_tms_files_unit)
    np.savez(os.path.join(basedir, "events.npz"),
             x=np.concatenate(xs)[order].astype(np.uint16),
             y=np.concatenate(ys)[order].astype(np.uint16),
             t=ts[order] * 1000.0,
             p=np.concatenate(ps)[order].astype(np.int8))
    return int(ts.shape[0])


def scene_classes():
    """The two dataset subclasses that read the scene's ``.npz`` files
    where the package reads PNG and HDF5; everything after the read is the
    package's."""
    from evdeblurnerf_torch.data import LLFFDataset, LLFFEventsDataset
    from evdeblurnerf_torch.utils.events import compact_events

    class NpzLLFF(LLFFDataset):
        def load_images(self, imgfolder):
            imgs = np.load(os.path.join(self.basedir, imgfolder,
                                        "images.npz"))["images"]
            return imgs, imgs[0].shape

    class NpzEvents(LLFFEventsDataset):
        def load_events(self):
            with np.load(os.path.join(self.basedir, "events.npz")) as f:
                events = {k: f[k] for k in "xytp"}
            return compact_events(events, self.h, self.w, None, True,
                                  self.events_tms_unit)

    return NpzLLFF, NpzEvents
