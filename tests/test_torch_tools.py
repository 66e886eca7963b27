"""The port's command-line tools on the CPU: ``tools/preprocess_events_torch
.py`` against the JAX package's ``tools/preprocess_events.py`` on one
synthetic scene (every array bitwise), its image-header reader against
imageio, the port's loader reading its sidecar in place of a scan,
``tools/eval_cull_ab_torch.py`` held to the port's own exact and culled
renders, and ``tools/train_supervisor.py`` driving ``run_nerf_torch.py``."""

import functools
import os
import runpy
import shlex
import shutil
import subprocess
import sys

import imageio.v2 as imageio
import numpy as np
import pytest
import torch

from evdeblurnerf_torch import config as tconfig
from evdeblurnerf_torch.data import events as tevents
from evdeblurnerf_torch.ops import events_native as tnative
from evdeblurnerf_torch.train import evaluate as tevaluate
from evdeblurnerf_torch.train import loop as tloop
from synthetic import make_synthetic_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")
# what the preprocessing tools write, with the arrays of each file
OUTPUTS = {
    "events_successor.npz": ("successor_idx", "num_successors",
                             "latest_seen", "first_seen", "n_events"),
    "events_accum_2.npy": None,
    "events_accum_t1.npz": ("events", "zero_events"),
}


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    basedir = str(tmp_path_factory.mktemp("scene"))
    make_synthetic_scene(basedir)
    return basedir


@pytest.fixture
def one_torch_thread():
    """The runs here are thousands of tiny operations (the CRF pre-fit
    among them), which gain nothing from torch's thread pool and lose
    minutes to it beside other busy processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tool(name):
    return runpy.run_path(os.path.join(TOOLS, name))


def _arrays(path, keys):
    if keys is None:
        return {"": np.load(path)}
    with np.load(path) as f:
        assert sorted(f.files) == sorted(keys), path
        return {k: f[k] for k in keys}


def test_preprocess_events_matches_the_jax_tool(scene, tmp_path):
    """Both tools on copies of one scene, H x W from its PNGs:
    the sidecar and the two accumulations equal array for array, dtype
    and all."""
    flags = ["--events_tms_unit", "us", "--accumulate", "2",
             "--accumulate_at_time", "1"]
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    shutil.copytree(scene, jax_dir)
    shutil.copytree(scene, port_dir)
    subprocess.run([sys.executable,
                    os.path.join(TOOLS, "preprocess_events.py"), jax_dir,
                    *flags], check=True, capture_output=True, timeout=300)
    _tool("preprocess_events_torch.py")["main"]([port_dir, *flags])
    for name, keys in OUTPUTS.items():
        want = _arrays(os.path.join(jax_dir, name), keys)
        got = _arrays(os.path.join(port_dir, name), keys)
        for k in want:
            assert got[k].dtype == want[k].dtype, (name, k)
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"{name} {k}")
    with np.load(os.path.join(port_dir, "events_successor.npz")) as f:
        assert int(f["n_events"]) == f["successor_idx"].shape[0] > 0


@pytest.mark.parametrize("kind", ["png", "jpeg", "other"])
def test_image_header_gives_what_imageio_reads(scene, tmp_path, kind):
    """H x W from a PNG's IHDR or a JPEG's SOF marker equal imageio's
    shape; any other file raises and names --h/--w."""
    image_hw = _tool("preprocess_events_torch.py")["image_hw"]
    if kind == "png":
        paths = [os.path.join(scene, d, f) for d in ("images_1", "images")
                 for f in sorted(os.listdir(os.path.join(scene, d)))
                 if f.endswith(".png")]
        assert paths
    elif kind == "jpeg":
        rng = np.random.default_rng(0)
        paths = []
        for h, w in ((13, 21), (40, 7)):
            path = str(tmp_path / f"img_{h}x{w}.jpg")
            imageio.imwrite(path, rng.integers(0, 255, (h, w, 3), np.uint8))
            paths.append(path)
    else:
        path = str(tmp_path / "img.bmp")
        with open(path, "wb") as f:
            f.write(b"BM" + bytes(64))
        with pytest.raises(ValueError, match="--h and --w"):
            image_hw(path)
        return
    for path in paths:
        assert image_hw(path) == imageio.imread(path).shape[:2], path


def _events_dataset(scene_dir):
    args = tconfig.resolve_event_thresholds(tconfig.default_args(
        datadir=scene_dir, llffhold=3, factor=None, use_viewdirs=True,
        use_events=True, events_tms_files_unit="us", events_tms_unit="us"))
    return tloop.build_datasets(args)[1]


def test_loader_reads_the_sidecar_in_place_of_a_scan(scene, tmp_path,
                                                     monkeypatch):
    """A port dataset on a scene with the port tool's sidecar, its scan
    made to raise, equals one built by the scan on the same scene."""
    want = _events_dataset(scene)
    copy = str(tmp_path / "scene")
    shutil.copytree(scene, copy)
    _tool("preprocess_events_torch.py")["main"](
        [copy, "--events_tms_unit", "us"])

    def no_scan(_):
        raise AssertionError("the loader scanned the stream")

    monkeypatch.setattr(tevents, "compute_successor", no_scan)
    got = _events_dataset(copy)
    np.testing.assert_array_equal(got.events, want.events)
    np.testing.assert_array_equal(got.events_num_successors,
                                  want.events_num_successors)
    np.testing.assert_array_equal(got.events_with_successor_idx,
                                  want.events_with_successor_idx)
    succ, cnt, _, _ = tnative.compute_successor(got.events[:, 0])
    np.testing.assert_array_equal(got.events[:, 3], succ)
    np.testing.assert_array_equal(got.events_num_successors, cnt)


def test_eval_cull_ab_tool_holds_to_the_port_renders(tmp_path,
                                                     one_torch_thread):
    """``tools/eval_cull_ab_torch.py`` on a 2-step validation run at a
    small size: the culled arm is ``render_chunk(fine_cull=True)`` of the
    restored checkpoint, the exact arm its plain render, both finite and
    apart."""
    scene = ["--scene", str(tmp_path / "scene"), "--logdir",
             str(tmp_path / "logs"), "--h", "32", "--w", "40"]
    small = ["--N_rand", "32", "--N_samples", "8", "--N_importance", "8",
             "--coarse_n_voxels", "4096", "--fine_n_voxels", "8192",
             "--events_N_rand", "32", "--chunk", "2048", "--device", "cpu"]
    _tool("validate_train_torch.py")["main"](
        ["--iters", "2", "--expname", "ab", *scene, *small])
    tool = _tool("eval_cull_ab_torch.py")
    argv = ["--expname", "ab", "--capacity", "0.25", *scene, *small]
    out, renders = tool["compare"](argv)
    assert out["step"] == 2 and out["device"] == "cpu"
    assert out["capacity"] == 0.25 and out["eps"] == 1e-3
    run = tool["restore"](argv)
    assert run.model.cfg.fine_cull_capacity == 0.25
    llff = run.llff
    for arm, chunk_fn in (
            ("full", run.model.render_chunk),
            ("cull", functools.partial(run.model.render_chunk,
                                       fine_cull=True))):
        rgbs, _ = tevaluate.render_poses(chunk_fn, llff.test_poses, llff.h,
                                         llff.w, llff.K,
                                         chunk=run.targs.chunk)
        want = tevaluate.apply_crf(run.crf, rgbs.numpy(), skip_learn_crf=(
            run.step < run.targs.tone_mapping_start_learn_iter))
        np.testing.assert_array_equal(renders[arm], want)
        assert np.isfinite(renders[arm]).all()
        assert np.isfinite(out[arm]["psnr"]) and out[arm]["render_s"] > 0
    assert set(out["delta_cull_minus_full"]) == {
        k for k in out["full"] if k != "launches"}
    pix = out["pixel_abs_diff"]
    assert 0 < pix["p99"] <= pix["max"]
    np.testing.assert_allclose(
        pix["max"], np.abs(renders["cull"].astype(np.float64)
                           - renders["full"]).max())


def test_supervisor_runs_the_port(scene, tmp_path):
    """``tools/train_supervisor.py --cmd '<python> run_nerf_torch.py'``
    runs a 2-step port run on the CPU to its end: rc 0 and the
    checkpoint of the last step."""
    cfg = tmp_path / "tiny.txt"
    flags = dict(
        datadir=scene, basedir=str(tmp_path / "logs"), expname="sup",
        device="cpu", llffhold=3, N_iters=2, N_rand=32, chunk=512,
        N_samples=4, N_importance=4, use_viewdirs=True, multires=4,
        multires_views=2, coarse_n_voxels=4096, fine_n_voxels=8192,
        coarse_app_n_comp="[4, 2, 2]", fine_app_n_comp="[4, 2, 2]",
        coarse_hidden_dim=8, coarse_hidden_dim_color=8, fine_hidden_dim=8,
        fine_hidden_dim_color=8, fine_geo_feat_dim=8, coarse_app_dim=8,
        fine_app_dim=8, kernel_type="none", events_tms_unit="us",
        events_tms_files_unit="us", no_wandb=True, i_testset=10 ** 9,
        i_video=10 ** 9)
    cfg.write_text("".join(f"{k} = {v}\n" for k, v in flags.items())
                   + "factor = None\n")
    cmd = (f"{shlex.quote(sys.executable)} "
           f"{shlex.quote(os.path.join(REPO, 'run_nerf_torch.py'))}")
    proc = subprocess.run(
        [sys.executable, os.path.join(TOOLS, "train_supervisor.py"),
         "--max_restarts", "0", "--cmd", cmd, "--", "--config", str(cfg)],
        cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ckdir = tmp_path / "logs" / "sup" / "checkpoints"
    assert sorted(os.listdir(ckdir)) == ["000002.tar"]
