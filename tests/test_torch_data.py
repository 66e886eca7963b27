"""The port's data layer on the CPU: datasets, samplers, pose and bbox
helpers and the EDI prior against the JAX package's on the same synthetic
scene and seeds, and the torch ``Prefetcher``.

Both data layers are numpy, fed by the same generators from the same
seeds, so everything here is held **bitwise** (``assert_array_equal``)
unless a test says otherwise.
"""

import dataclasses
import os
import time

import numpy as np
import pytest
import torch

from evdeblurnerf_torch import config as tconfig
from evdeblurnerf_torch import data as tdata
from evdeblurnerf_torch.ops import events_native as tnative
from evdeblurnerf_torch.utils import edi as tedi
from evdeblurnerf_torch.utils import events as tevents
from evdeblurnerf_torch.utils import misc as tmisc
from evdeblurnerf_torch.utils import pose as tpose
from evdeblurnerf_torch.utils import rays as trays
from evdeblurnerf_torch.utils import voxels as tvoxels
from evdeblurnerf_tpu import config as jconfig
from evdeblurnerf_tpu import data as jdata
from evdeblurnerf_tpu.utils import edi as jedi
from evdeblurnerf_tpu.utils import events as jevents
from evdeblurnerf_tpu.utils import misc as jmisc
from evdeblurnerf_tpu.utils import pose as jpose
from evdeblurnerf_tpu.utils import rays as jrays
from evdeblurnerf_tpu.utils import voxels as jvoxels
from synthetic import make_synthetic_scene

FLAGS = dict(llffhold=3, factor=None, use_viewdirs=True, seed=3,
             events_tms_files_unit="us", events_tms_unit="us",
             use_events=True, use_pts0_prior="edi", pts0_edi_steps=3)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    basedir = tmp_path_factory.mktemp("scene")
    truth = make_synthetic_scene(str(basedir))
    return str(basedir), truth


def _datasets(pkg_config, pkg_data, scene_dir, **overrides):
    args = pkg_config.resolve_event_thresholds(
        pkg_config.default_args(**{**FLAGS, **overrides}))
    llff = pkg_data.LLFFDataset(args, scene_dir, factor=None, recenter=True,
                                bd_factor=0.75, spherify=args.spherify)
    ev = pkg_data.LLFFEventsDataset(
        args, scene_dir, llff.h, llff.w, llff.K, None, recenter=True,
        bd_factor=0.75, bd_scale=llff.scale, closest_bds=llff.closest_bds,
        furthest_bds=llff.furthest_bds, spherify=args.spherify,
        recenter_partial=llff.recenter_partial,
        spherify_partial=llff.spherify_partial, events_tms_unit="us",
        events_tms_files_unit="us")
    return args, llff, ev


@pytest.fixture(scope="module")
def both(scene):
    scene_dir, _ = scene
    return (_datasets(jconfig, jdata, scene_dir),
            _datasets(tconfig, tdata, scene_dir))


def _assert_batches_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_llff_dataset_matches_jax_bitwise(both):
    (_, jl, _), (_, tl, _) = both
    for name in ("images", "poses", "test_images", "test_poses",
                 "render_poses", "K", "i_train", "i_test",
                 "recenter_partial"):
        np.testing.assert_array_equal(getattr(tl, name), getattr(jl, name),
                                      err_msg=name)
    for name in ("scale", "near", "far", "closest_bds", "furthest_bds",
                 "h", "w", "n_imgs", "n_rays"):
        assert getattr(tl, name) == getattr(jl, name), name
    for a, b in zip(tl.bounding_box, jl.bounding_box):
        np.testing.assert_array_equal(a, b)


def test_llff_batches_and_samplers_match_jax_bitwise(both):
    """Both packages draw the same ray batches from the same seed, in the
    random and in the image-batch sampling mode, over two epochs."""
    (jargs, jl, jev), (targs, tl, tev) = both
    for ds, ev, args in ((jl, jev, jargs), (tl, tev, targs)):
        ds.set_pts0_prior(ev.compute_edi_prior(
            ds.i_train, ds.images, args.pts0_edi_steps,
            args.events_threshold_pos, args.events_threshold_neg))
    js = jdata.RandomRaySampler(jl.n_rays, 64, seed=5)
    ts = tdata.RandomRaySampler(tl.n_rays, 64, seed=5)
    n = 0
    for _ in range(2):
        for jid, tid in zip(js, ts):
            np.testing.assert_array_equal(tid, jid)
            if n % 16 == 0:
                _assert_batches_equal(tl.batch(tid), jl.batch(jid))
            n += 1
    assert n == 2 * (jl.n_rays // 64)
    assert "rgbsf_pts0" in tl.batch(tid)
    ji = jdata.ImageBatchSampler(jl.n_imgs, 2, 32, (jl.w, jl.h), seed=7)
    ti = tdata.ImageBatchSampler(tl.n_imgs, 2, 32, (tl.w, tl.h), seed=7)
    for _, jid, tid in zip(range(8), ji, ti):
        np.testing.assert_array_equal(tid, jid)
        _assert_batches_equal(tl.batch(tid), jl.batch(jid))


def test_edi_prior_matches_jax_bitwise(both):
    (jargs, jl, jev), (targs, tl, tev) = both
    want = jev.compute_edi_prior(jl.i_train, jl.images, 3, 0.2, 0.2)
    got = tev.compute_edi_prior(tl.i_train, tl.images, 3, 0.2, 0.2)
    assert got.shape == tl.images.shape
    np.testing.assert_array_equal(got, want)
    rng = np.random.default_rng(0)
    x, y = rng.uniform(0, 31, 200), rng.uniform(0, 23, 200)
    p = rng.choice([-1, 1], 200)
    np.testing.assert_array_equal(
        tedi.brightness_increment_image(x, y, p, 32, 24, 0.2, 0.3,
                                        interpolate=True),
        jedi.brightness_increment_image(x, y, p, 32, 24, 0.2, 0.3,
                                        interpolate=True))


@pytest.mark.parametrize("accumulate", [(0, 0), (1, 3)])
def test_event_batches_and_sampler_match_jax_bitwise(scene, accumulate):
    """Event batches through the successor graph, the k-hop gather (with
    an accumulation range: the datasets' own generators draw the hops),
    SLERP pose interpolation and ray generation."""
    scene_dir, _ = scene
    over = dict(event_accumulate_step_range=list(accumulate),
                event_accumulate_step_range_end=list(accumulate))
    _, _, jev = _datasets(jconfig, jdata, scene_dir, **over)
    _, _, tev = _datasets(tconfig, tdata, scene_dir, **over)
    np.testing.assert_array_equal(tev.events, jev.events)
    np.testing.assert_array_equal(tev.events_num_successors,
                                  jev.events_num_successors)
    np.testing.assert_array_equal(tev.events_with_successor_idx,
                                  jev.events_with_successor_idx)
    assert len(tev) == len(jev) > 64
    js = jdata.RandomEventSampler(len(jev), 64, seed=9)
    ts = tdata.RandomEventSampler(len(tev), 64, seed=9)
    for _, jid, tid in zip(range(6), js, ts):
        np.testing.assert_array_equal(tid, jid)
        _assert_batches_equal(tev.batch(tid), jev.batch(jid))
    assert tev.global_step == jev.global_step == 6


def test_interpolate_poses_and_bbox_match_jax_bitwise(both):
    (_, jl, jev), (_, tl, tev) = both
    t = np.linspace(jev.allknown_poses_timestamps.min(),
                    jev.allknown_poses_timestamps.max(), 37)
    np.testing.assert_array_equal(tev.interpolate_poses(t),
                                  jev.interpolate_poses(t))
    poses = np.concatenate([jl.poses, jl.test_poses])
    hwf = np.array([jl.h, jl.w, jl.K[0][0]])
    for ndc in (True, False):
        for a, b in zip(tvoxels.get_bbox3d_for_llff(poses, hwf, near=0.5,
                                                    far=2.0, is_ndc=ndc),
                        jvoxels.get_bbox3d_for_llff(poses, hwf, near=0.5,
                                                    far=2.0, is_ndc=ndc)):
            np.testing.assert_array_equal(a, b)


def test_pose_helpers_match_jax_bitwise():
    """Recentering, spherification (fit, replay and the per-batch fast
    path), the render paths and the SLERP + cubic interpolator on a ring
    of cameras (the synthetic scene's parallel rig is singular for the
    sphere fit)."""
    poses = []
    for th in np.linspace(0, 2 * np.pi, 7)[:-1]:
        o = np.array([np.cos(th), np.sin(th), 0.3]) * 3.0
        z = o / np.linalg.norm(o)
        x = np.cross(np.array([0, 0, 1.0]), z)
        x /= np.linalg.norm(x)
        poses.append(np.stack([x, np.cross(z, x), z, o], 1))
    poses = np.stack(poses).astype(np.float32)
    hwf = np.broadcast_to(np.array([[32.], [40.], [50.]], np.float32),
                          (poses.shape[0], 3, 1))
    poses = np.concatenate([poses, hwf], -1)
    bds = np.broadcast_to(np.array([[2.0, 6.0]], np.float32),
                          (poses.shape[0], 2)).copy()

    def same(got, want):
        for a, b in zip(got, want):
            if a is None or b is None:
                assert a is b
            elif isinstance(b, np.ndarray):
                np.testing.assert_array_equal(a, b)

    jr, jc = jpose.recenter_poses(poses.copy(), return_c2w=True)
    tr, tc = tpose.recenter_poses(poses.copy(), return_c2w=True)
    same((tr, tc), (jr, jc))
    jout = jpose.spherify_poses(poses, bds.copy(), return_state=True)
    tout = tpose.spherify_poses(poses, bds.copy(), return_state=True)
    same(tout[:3], jout[:3])
    same(tpose.spherify_poses(poses, bds.copy(), state=tout[3],
                              render_path=False),
         jpose.spherify_poses(poses, bds.copy(), state=jout[3],
                              render_path=False))
    c2w, up = jpose.poses_avg(poses), jpose.normalize(poses[:, :3, 1].sum(0))
    np.testing.assert_array_equal(tpose.poses_avg(poses), c2w)
    rads = np.array([0.3, 0.2, 0.1])
    np.testing.assert_array_equal(
        np.array(tpose.render_path_spiral(c2w, up, rads, 4.0, 0.4, zrate=0.5,
                                          rots=2, N=12)),
        np.array(jpose.render_path_spiral(c2w, up, rads, 4.0, 0.4, zrate=0.5,
                                          rots=2, N=12)))
    np.testing.assert_array_equal(
        np.array(tpose.render_path_epi(c2w, up, 0.3, 12)),
        np.array(jpose.render_path_epi(c2w, up, 0.3, 12)))
    tms = np.arange(6) * 10.0
    q = np.linspace(0, 50, 23)
    same(tpose.get_slerp_interpolator(tms, poses[:, :3, :3],
                                      poses[:, :3, 3])(q),
         jpose.get_slerp_interpolator(tms, poses[:, :3, :3],
                                      poses[:, :3, 3])(q))


def test_host_helpers_match_jax_bitwise():
    rng = np.random.default_rng(1)
    K = np.array([[30.0, 0, 16], [0, 30.0, 12], [0, 0, 1]])
    c2w = rng.normal(size=(5, 3, 4))
    coords = rng.integers(0, 24, (5, 2))
    for a, b in zip(trays.get_rays_pix_np(coords, K, c2w),
                    jrays.get_rays_pix_np(coords, K, c2w)):
        np.testing.assert_array_equal(a, b)
    ro, rd = jrays.get_rays_np(24, 32, K, c2w[0])
    for a, b in zip(trays.get_rays_np(24, 32, K, c2w[0]), (ro, rd)):
        np.testing.assert_array_equal(a, b)
    rd[..., 2] = -np.abs(rd[..., 2]) - 0.1
    for a, b in zip(trays.get_ndc_rays_np(24, 32, 30.0, 1.0, ro, rd),
                    jrays.get_ndc_rays_np(24, 32, 30.0, 1.0, ro, rd)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(trays.get_ray_directions_np(6, 8, 30.0),
                                  jrays.get_ray_directions_np(6, 8, 30.0))
    assert trays.HALF_PIX == jrays.HALF_PIX
    for method in ("linear", "cosine", "constant"):
        f = tmisc.annealing_interpolator(0.1, 1.0, 50, method, start_step=5)
        g = jmisc.annealing_interpolator(0.1, 1.0, 50, method, start_step=5)
        assert [f(s) for s in range(0, 60, 7)] == \
            [g(s) for s in range(0, 60, 7)]
    assert tmisc.exponential_scale_fine_loss_weight(101, 10, 0.1, 0.9, 40) \
        == jmisc.exponential_scale_fine_loss_weight(101, 10, 0.1, 0.9, 40)
    x = rng.uniform(-0.2, 1.2, (4, 4, 3))
    np.testing.assert_array_equal(tmisc.to8b(x), jmisc.to8b(x))
    assert tmisc.convert_unit("ns", "us") == jmisc.convert_unit("ns", "us")


def test_event_scans_native_and_numpy_twin(tmp_path, monkeypatch):
    """The g++ successor scan is built into the port's build directory, not
    beside the source, and agrees with its numpy twin; without a compiler
    the twin carries on and ``backend()`` says so."""
    ids = np.random.default_rng(2).integers(0, 40, 500)
    assert tnative.backend() == "g++ library"
    lib = tnative.library_path()
    assert lib.is_file() and lib.parent.name == "evdeblurnerf_torch" \
        and lib.parent.parent.name == "build"
    src_dir = os.path.dirname(tnative._SOURCE)
    assert [f for f in os.listdir(src_dir) if f.endswith(".so")] == []
    for a, b in zip(tnative.compute_successor(ids),
                    tnative.compute_successor_np(ids)):
        np.testing.assert_array_equal(a, b)
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_lib_failed", False)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative.shutil, "which", lambda *_: None)
    monkeypatch.delenv("CXX", raising=False)
    assert tnative.backend() == "numpy"
    for a, b in zip(tnative.compute_successor(ids),
                    tnative.compute_successor_np(ids)):
        np.testing.assert_array_equal(a, b)


def test_load_events_h5_matches_jax(scene):
    scene_dir, _ = scene
    path = os.path.join(scene_dir, "events.h5")
    for a, b in zip(tevents.load_events_h5(path, 24, 32, optimize_ids=True,
                                           events_tms_unit="us"),
                    jevents.load_events_h5(path, 24, 32, optimize_ids=True,
                                           events_tms_unit="us")):
        np.testing.assert_array_equal(a, b)


def test_dataset_read_seams(scene):
    """Images and events are read only by ``load_images`` / ``load_events``:
    subclasses that feed the arrays another way build the same datasets."""
    scene_dir, _ = scene
    _, llff, ev = _datasets(tconfig, tdata, scene_dir)
    import h5py

    with h5py.File(os.path.join(scene_dir, "events.h5"), "r") as f:
        arrays = {k: f[k][:] for k in "xytp"}
    images = np.concatenate([llff.test_images[:1], llff.images[:2],
                             llff.test_images[1:], llff.images[2:]])

    class ArrayLLFF(tdata.LLFFDataset):
        def load_images(self, imgfolder):
            return images, images[0].shape

    class ArrayEvents(tdata.LLFFEventsDataset):
        def load_events(self):
            return tevents.compact_events(arrays, self.h, self.w, None, True,
                                          self.events_tms_unit)

    pkg = dataclasses.make_dataclass("pkg", ["LLFFDataset",
                                             "LLFFEventsDataset"])(
        ArrayLLFF, ArrayEvents)
    _, llff2, ev2 = _datasets(tconfig, pkg, scene_dir)
    np.testing.assert_array_equal(llff2.images, llff.images)
    np.testing.assert_array_equal(ev2.events, ev.events)


# ---------------------------------------------------------------------------
# the torch Prefetcher on the CPU
# ---------------------------------------------------------------------------

def test_prefetcher_keeps_order_and_yields_cpu_tensors():
    count = iter(range(10 ** 6))

    def make():
        i = next(count)
        return {"a": np.full((3,), i, np.float32),
                "b": np.arange(4, dtype=np.int64)[::2] + i}  # not contiguous

    with tdata.Prefetcher(make, buffer_size=2, device="cpu") as pf:
        for i in range(20):
            batch = next(pf)
            assert batch["a"].device.type == "cpu"
            assert batch["a"].dtype == torch.float32
            assert batch["b"].dtype == torch.int64
            assert batch["a"].tolist() == [i] * 3
            assert batch["b"].tolist() == [i, i + 2]
    assert not pf._thread.is_alive()


def test_prefetcher_queue_is_bounded():
    made = []

    def make():
        made.append(len(made))
        return {"a": np.zeros(1, np.float32)}

    pf = tdata.Prefetcher(make, buffer_size=2, device="cpu")
    try:
        deadline = time.time() + 5.0
        while len(made) < 3 and time.time() < deadline:
            time.sleep(0.01)
        time.sleep(0.2)
        # two in the queue and one in the worker's hand, no more
        assert len(made) == 3
        next(pf)
        deadline = time.time() + 5.0
        while len(made) < 4 and time.time() < deadline:
            time.sleep(0.01)
        assert len(made) == 4
    finally:
        pf.close()


def test_prefetcher_reraises_the_workers_exception():
    calls = iter(range(10))

    def make():
        if next(calls) == 2:
            raise KeyError("boom")
        return {"a": np.zeros(1, np.float32)}

    pf = tdata.Prefetcher(make, device="cpu")
    try:
        with pytest.raises(KeyError, match="boom"):
            for _ in range(5):
                next(pf)
    finally:
        pf.close()
    assert not pf._thread.is_alive()


def test_endless_restarts_epochs_and_raises_on_an_empty_one():
    sampler = tdata.RandomRaySampler(10, 4, seed=0)
    it = tdata.endless(lambda: iter(sampler))
    batches = [next(it) for _ in range(5)]        # two per epoch
    assert all(b.shape == (4,) for b in batches)
    # an epoch never repeats a ray
    assert len(set(np.concatenate(batches[:2]).tolist())) == 8
    assert len(set(np.concatenate(batches[2:4]).tolist())) == 8
    with pytest.raises(ValueError, match="no batches"):
        next(tdata.endless(lambda: iter(tdata.RandomRaySampler(3, 4))))
