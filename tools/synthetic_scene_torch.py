"""A synthetic LLFF + events scene for runs of the port on a machine
without an image or HDF5 library.

:func:`write_scene` writes the scene with numpy in the real LLFF + events
layout (``poses_bounds.npy``, ``all_poses_bounds.npy``,
``all_timestamps.npy``, ``images_1/timestamps.npz``), the images and the
events as ``.npz``; :func:`scene_classes` gives the two dataset subclasses
that read those where ``evdeblurnerf_torch.data`` reads PNG and HDF5
(:func:`load_npz_events` reads the events, also for
``tools/preprocess_events_torch.py``).
Everything after the read (pose recentering, the bounds, the successor
graph, the EDI prior, the samplers) is the package's. The scene is a shaded
ball before a faint gradient, seen from a camera that slides sideways; the
image size only sets the host's work. Used by ``chip_smoke.py`` and
``tools/profile_loop_torch.py``.

:func:`write_synthetic_scene` writes, into the same ``.npz`` layout, the
scene of ``tests/synthetic.py::make_synthetic_scene`` (its poses, its
``sphere`` and ``boxes`` geometries, its event simulation and its random
draws), on which the JAX package's held-out quality was recorded; it is a
copy of that numpy code, so it needs neither cv2 nor h5py. The images are
stored as the 8-bit values the PNGs hold, the events as the HDF5 file's
arrays. ``tools/validate_train_torch.py`` trains on it.
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


def _ray_box(rays_o, rays_d, lo, hi):
    """Slab-method ray/AABB hit: (hit mask, t_near, entry-face normal)."""
    inv = 1.0 / np.where(np.abs(rays_d) < 1e-9, 1e-9, rays_d)
    t0 = (lo - rays_o) * inv
    t1 = (hi - rays_o) * inv
    tmin_ax = np.minimum(t0, t1)
    tmax_ax = np.maximum(t0, t1)
    tn = tmin_ax.max(-1)
    tf = tmax_ax.min(-1)
    hit = (tf > np.maximum(tn, 1e-3))
    ax = np.argmax(tmin_ax, axis=-1)
    normal = np.zeros(rays_d.shape)
    idx = np.indices(ax.shape)
    normal[idx[0], idx[1], ax] = -np.sign(rays_d[idx[0], idx[1], ax])
    return hit, tn, normal


def _render_synthetic_image(c2w, h, w, focal, geometry="sphere"):
    """``sphere``: a unit sphere at (0, 0, -4); ``boxes``: two boxes at
    different depths above a checkered ground plane."""
    i, j = np.meshgrid(np.arange(w, dtype=np.float32),
                       np.arange(h, dtype=np.float32), indexing="xy")
    dirs = np.stack([(i + 0.5 - w / 2) / focal,
                     -(j + 0.5 - h / 2) / focal,
                     -np.ones_like(i)], -1)
    rays_d = dirs @ c2w[:3, :3].T
    rays_o = np.broadcast_to(c2w[:3, 3], rays_d.shape).copy()
    img = np.stack([0.08 + 0.02 * i / w, 0.08 * np.ones_like(i),
                    0.10 + 0.02 * j / h], -1)
    light = np.array([0.40824829, 0.81649658, 0.40824829])
    if geometry == "sphere":
        center = np.array([0.0, 0.0, -4.0])
        radius = 1.2
        oc = rays_o - center
        b = np.sum(oc * rays_d, -1)
        c = np.sum(oc * oc, -1) - radius ** 2
        a = np.sum(rays_d * rays_d, -1)
        disc = b * b - a * c
        hit = disc > 0
        t = np.where(hit, (-b - np.sqrt(np.maximum(disc, 0.0))) / a, 0.0)
        pt = rays_o + t[..., None] * rays_d
        normal = (pt - center) / radius
        shade = np.clip(normal[..., 2] * 0.5 + 0.5, 0, 1)
        sphere_col = np.stack([0.9 * shade, 0.5 * shade + 0.2,
                               0.3 * shade], -1)
        img = np.where(hit[..., None], sphere_col, img)
    elif geometry == "boxes":
        t_best = np.full(i.shape, np.inf)
        for lo, hi, base in (
                (np.array([-1.5, -0.9, -4.3]), np.array([-0.3, 0.3, -3.4]),
                 np.array([0.85, 0.35, 0.25])),
                (np.array([0.2, -0.5, -5.6]), np.array([1.4, 0.9, -4.6]),
                 np.array([0.25, 0.55, 0.85]))):
            hit, tn, normal = _ray_box(rays_o, rays_d, lo, hi)
            closer = hit & (tn < t_best)
            shade = np.clip(normal @ light, 0.0, 1.0) * 0.7 + 0.3
            img = np.where(closer[..., None], base * shade[..., None], img)
            t_best = np.where(closer, tn, t_best)
        denom = np.where(np.abs(rays_d[..., 1]) < 1e-9, 1e-9, rays_d[..., 1])
        t_pl = (-1.1 - rays_o[..., 1]) / denom
        pl_hit = (t_pl > 1e-3) & (t_pl < t_best) & (t_pl < 8.0)
        px = rays_o[..., 0] + t_pl * rays_d[..., 0]
        pz = rays_o[..., 2] + t_pl * rays_d[..., 2]
        checker = ((np.floor(px * 1.5) + np.floor(pz * 1.5)) % 2)
        pl_col = np.where(checker[..., None] > 0.5,
                          np.array([0.55, 0.5, 0.45]),
                          np.array([0.35, 0.33, 0.3]))
        fade = np.clip(1.0 - (t_pl - 3.0) / 6.0, 0.3, 1.0)
        img = np.where(pl_hit[..., None], pl_col * fade[..., None], img)
    else:
        raise ValueError(f"unknown synthetic geometry {geometry!r}")
    return np.clip(img, 0.0, 1.0).astype(np.float32)


def write_synthetic_scene(basedir, n_imgs=6, h=96, w=128, focal=None,
                          poses_per_image=4, exposure_frac=0.5,
                          events_threshold=0.2, seed=0,
                          rectified_coords=False, geometry="sphere"):
    """The scene of ``tests/synthetic.py::make_synthetic_scene`` with the
    validation runs' defaults (96 x 128, 6 images, 4 poses an image,
    ``focal = w``, seed 0), written with numpy: ``images_1/images.npz``
    holds the PNGs' 8-bit values over 255, ``events.npz`` the HDF5 file's
    arrays (times in microseconds), ``ev_map.npz`` the rectification map
    when ``rectified_coords``. Returns the number of events."""
    focal = float(w) if focal is None else float(focal)
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(basedir, "images_1"), exist_ok=True)
    n_all = n_imgs * poses_per_image
    all_t = np.linspace(0.0, 1.0, n_all)
    c2ws = np.zeros((n_all, 3, 4))
    c2ws[:, :3, :3] = np.eye(3)
    c2ws[:, :3, 3] = np.stack([0.6 * all_t - 0.3, 0.05 * np.sin(all_t * 6.0),
                               np.zeros_like(all_t)], -1)
    # the loader's axis swap, inverted, so that loading gives c2ws back
    hwf = np.broadcast_to(np.array([h, w, focal], np.float64)[:, None],
                          (n_all, 3, 1))
    ondisk = np.concatenate([-c2ws[:, :, 1:2], c2ws[:, :, 0:1],
                             c2ws[:, :, 2:4], hwf], 2)
    all_rows = np.concatenate([ondisk.reshape(n_all, 15),
                               np.tile([2.0, 7.0], (n_all, 1))], 1)
    np.save(os.path.join(basedir, "all_poses_bounds.npy"), all_rows)
    t_us = (1000.0 + 1000.0 * np.arange(n_all)).astype(np.float64)
    np.save(os.path.join(basedir, "all_timestamps.npy"), t_us)
    knots = np.arange(n_imgs) * poses_per_image + poses_per_image // 2
    half = 1000.0 * poses_per_image * exposure_frac / 2
    np.savez(os.path.join(basedir, "images_1", "timestamps.npz"),
             timestamps=t_us[knots], timestamps_start=t_us[knots] - half,
             timestamps_end=t_us[knots] + half)
    blurry = np.stack([np.mean([_render_synthetic_image(
        c2ws[np.clip(k + d, 0, n_all - 1)], h, w, focal, geometry)
        for d in (-1, 0, 1)], axis=0) for k in knots])
    # what the PNG holds, as the image reader returns it
    images = (blurry * 255).astype(np.uint8).astype(np.float32) / 255.0
    np.savez(os.path.join(basedir, "images_1", "images.npz"), images=images)
    np.save(os.path.join(basedir, "poses_bounds.npy"), all_rows[knots])

    # events from log-intensity differences of a dense render sequence;
    # per pixel with events, in row-major order, up to 4 sorted uniform
    # times: one draw of their total from the generator gives the same
    # numbers as one draw a pixel
    lum_w = np.array([0.299, 0.587, 0.114])
    xs, ys, ts, ps = [], [], [], []
    prev_log = prev_t = None
    for tq in np.linspace(t_us[0], t_us[-1], n_all * 4):
        k = np.interp(tq, t_us, np.arange(n_all))
        k0 = int(np.floor(k))
        frac = k - k0
        c2w = c2ws[k0].copy()
        if k0 + 1 < n_all:
            c2w[:, 3] = (1 - frac) * c2ws[k0][:, 3] + frac * c2ws[k0 + 1][:, 3]
        log_img = np.log(_render_synthetic_image(c2w, h, w, focal, geometry)
                         @ lum_w + 1e-3)
        if prev_log is not None:
            diff = log_img - prev_log
            n_ev = np.floor(np.abs(diff) / events_threshold).astype(np.int64)
            yy, xx = np.nonzero(n_ev)
            reps = np.minimum(n_ev[yy, xx], 4)
            seg = np.repeat(np.arange(reps.shape[0]), reps)
            tt = rng.uniform(prev_t, tq, size=int(reps.sum()))
            ts.append(tt[np.lexsort((tt, seg))])
            xs.append(np.repeat(xx, reps))
            ys.append(np.repeat(yy, reps))
            ps.append(np.repeat(np.where(diff[yy, xx] > 0, 1, -1), reps))
        prev_log, prev_t = log_img, tq
    ts = np.concatenate(ts)
    order = np.argsort(ts, kind="stable")
    xs = np.concatenate(xs).astype(np.float64)[order]
    ys = np.concatenate(ys).astype(np.float64)[order]
    events = dict(t=ts[order], p=np.concatenate(ps)[order].astype(np.int8))
    if rectified_coords:
        # rectified float coordinates and the map that produced them (ref:
        # data/loader_events.py:221-232)
        def rect_x(i, j):
            return (i + 0.25 + 0.001 * j).astype(np.float32)

        def rect_y(i, j):
            return (j + 0.125 + 0.002 * i).astype(np.float32)

        xi = xs.astype(np.int64).astype(np.float64)
        yi = ys.astype(np.int64).astype(np.float64)
        events.update(x=rect_x(xi, yi), y=rect_y(xi, yi))
        ii, jj = np.meshgrid(np.arange(w, dtype=np.float64),
                             np.arange(h, dtype=np.float64), indexing="xy")
        np.savez(os.path.join(basedir, "ev_map.npz"),
                 inv_mapx=rect_x(ii, jj), inv_mapy=rect_y(ii, jj))
    else:
        events.update(x=xs.astype(np.uint16), y=ys.astype(np.uint16))
    np.savez(os.path.join(basedir, "events.npz"), **events)
    return int(ts.shape[0])


def load_npz_events(basedir, h, w, events_tms_unit):
    """The scene's ``events.npz`` as ``load_events_h5`` gives an
    ``events.h5``: (events [N, 3], zero-event coord ids, id_to_coords)."""
    from evdeblurnerf_torch.utils.events import compact_events

    with np.load(os.path.join(basedir, "events.npz")) as f:
        events = {k: f[k] for k in "xytp"}
    return compact_events(events, h, w, None, True, events_tms_unit)


def scene_classes():
    """The two dataset subclasses that read the scene's ``.npz`` files
    where the package reads PNG and HDF5; everything after the read is the
    package's."""
    from evdeblurnerf_torch.data import LLFFDataset, LLFFEventsDataset

    class NpzLLFF(LLFFDataset):
        def load_images(self, imgfolder):
            imgs = np.load(os.path.join(self.basedir, imgfolder,
                                        "images.npz"))["images"]
            return imgs, imgs[0].shape

    class NpzEvents(LLFFEventsDataset):
        def load_events(self):
            return load_npz_events(self.basedir, self.h, self.w,
                                   self.events_tms_unit)

    return NpzLLFF, NpzEvents
