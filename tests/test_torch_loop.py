"""The port's training run on the CPU: the loop against the JAX package's
on the same data and weights, checkpoints, resume, render-only, and the
loop's output helpers.

Sizes: the 24 x 32 synthetic scene of tests/synthetic.py (32 x 40 where
the loops' LPIPS is compared: AlexNet needs 31 pixels), 4+4 samples,
8-wide fields. Tolerances: per-step ``train/loss`` within 2e-2 relative
of the JAX loop's (the lockstep bound of tests/test_lockstep_train.py)
and within 1e-4 at step 0, where only the forward differs; held-out
metrics within 1e-3; the checkpoint round trip, the JET table and the PNG
writer exactly.
"""

import argparse
import json
import os
import sys

import cv2
import imageio.v2 as imageio
import jax
import numpy as np
import pytest
import torch

from evdeblurnerf_torch import cli as tcli
from evdeblurnerf_torch import config as tconfig
from evdeblurnerf_torch import serving
from evdeblurnerf_torch.train import checkpoint as tckpt
from evdeblurnerf_torch.train import evaluate as tevaluate
from evdeblurnerf_torch.train import loop as tloop
from evdeblurnerf_torch.train import step as tstep
from evdeblurnerf_torch.utils import logger as tlogger
from evdeblurnerf_torch.utils import metrics as tmetrics
from evdeblurnerf_torch.utils.convert import train_checkpoint_from_jax
from evdeblurnerf_tpu import config as jconfig
from evdeblurnerf_tpu.train import evaluate as jevaluate
from evdeblurnerf_tpu.train import loop as jloop
from evdeblurnerf_tpu.utils import checkpoint_convert as cc
from evdeblurnerf_tpu.utils import metrics as jmetrics
from synthetic import make_synthetic_scene

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import compare_metrics  # noqa: E402

N_STEPS = 10
BASE = dict(
    factor=None, llffhold=3, seed=0, N_rand=64, chunk=512, N_samples=4,
    N_importance=4, use_viewdirs=True, multires=4, multires_views=2,
    lrate=5e-3, lrate_decay=10, N_iters=N_STEPS, coarse_n_voxels=4096,
    fine_n_voxels=8192, coarse_app_n_comp=[4, 2, 2],
    fine_app_n_comp=[4, 2, 2], coarse_hidden_dim=8,
    coarse_hidden_dim_color=8, fine_hidden_dim=8, fine_hidden_dim_color=8,
    fine_geo_feat_dim=8, coarse_app_dim=8, fine_app_dim=8,
    # deterministic: no stratified jitter, no sigma noise
    perturb=0.0, raw_noise_std=0.0, kernel_type="none",
    events_tms_unit="us", events_tms_files_unit="us", no_wandb=True,
    i_print=5, i_tensorboard=1, i_weights=10 ** 9, i_testset=10 ** 9,
    i_video=10 ** 9,
    # the exact settings every parity test pins, in both packages
    grad_accum=1, triplane_bf16=False, triplane_line_matmul=False,
    fine_cull_capacity=0.0)
# the full method across its gates: naive until the kernel start at 3, the
# events from 2, the learned event CRF (pre-fitted to the identity) from 5
FULL = dict(
    kernel_type="RBK", kernel_ptnum=3, kernel_rbk_use_origin=True,
    kernel_use_awp=True, kernel_awp_use_coarse_to_fine_opt=True,
    kernel_awp_sam_emb_depth=2, kernel_awp_sam_emb_width=8,
    kernel_awp_mot_emb_width=8, kernel_start_iter=3, kernel_img_embed=8,
    kernel_rbk_extra_feat_ch=0, use_events=True, add_event_egm=True,
    add_event_egm_startiter=2, events_N_rand=64,
    add_event_egm_stages=["stage0", "stage1"], use_pts0_prior="edi",
    pts0_edi_steps=3, tone_mapping_events_type="learn",
    tone_mapping_learn_init_identity=True,
    tone_mapping_events_add_bii="pos-neg",
    event_accumulate_step_range=[1, 3],
    event_accumulate_step_range_end=[1, 3], clip_grads_norm=1.0,
    tone_mapping_start_learn_iter=5)
# the DSK kernel (no jitter) from step 3 with its align term, the EDI prior
# as the pts0 target, and the blur loss held off until after step 5
DSK_PTS0 = dict(
    kernel_type="DSK", kernel_ptnum=3, kernel_start_iter=3,
    kernel_img_embed=8, kernel_num_hidden=1, kernel_num_wide=8,
    kernel_random_hwindow=0.0, kernel_spatial_embed=1,
    kernel_align_weight=0.1, use_events=True, use_pts0_prior="edi",
    pts0_edi_steps=3, blur_loss_after=5, clip_grads_norm=1.0)
VARIANTS = {"naive": {}, "full": FULL, "dsk_pts0": DSK_PTS0}


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    basedir = tmp_path_factory.mktemp("scene")
    truth = make_synthetic_scene(str(basedir))
    return str(basedir), truth


@pytest.fixture(scope="module")
def scene_lpips(tmp_path_factory):
    basedir = tmp_path_factory.mktemp("scene_lpips")
    truth = make_synthetic_scene(str(basedir), h=32, w=40, focal=40.0)
    return str(basedir), truth


def _targs(scene_dir, logdir, expname="torch", **over):
    return tconfig.default_args(datadir=scene_dir, basedir=logdir,
                                expname=expname, device="cpu",
                                **{**BASE, **over})


def _scalars(path):
    out = {}
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            if "value" in rec:
                out.setdefault(rec["tag"], {})[rec["step"]] = rec["value"]
    return out


# ---------------------------------------------------------------------------
# (e) the slice as a whole: the two loops on one init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", list(VARIANTS))
def test_loop_matches_jax_loop(scene_lpips, tmp_path, variant):
    """``evdeblurnerf_tpu.train.loop.train`` and the port's ``train`` run
    the same 10 steps on the same scene and sampler seeds from one JAX
    init, carried across as a step-0 checkpoint the port resumes from."""
    scene_dir, _ = scene_lpips
    log = str(tmp_path)
    flags = {**BASE, **VARIANTS[variant]}
    jargs = jconfig.default_args(datadir=scene_dir, basedir=log,
                                 expname="jax", **flags)
    jloop.train(jargs)

    # the JAX loop's own initial state, rebuilt as the loop builds it
    jargs = jconfig.resolve_event_thresholds(jconfig.default_args(
        datadir=scene_dir, basedir=log, expname="jax_init", **flags))
    llff, _ = jloop.build_datasets(jargs)
    _, _, model, crf = jloop.build_model(jargs, llff)
    state, _ = jloop.build_initial_state(jargs, llff, model, crf)
    state = jax.device_get(state)
    as_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    ckpt = train_checkpoint_from_jax(as_np(state.params),
                                     as_np(state.batch_stats), step=0)
    os.makedirs(os.path.join(log, "torch", "checkpoints"))
    torch.save(ckpt, os.path.join(log, "torch", "checkpoints", "000000.tar"))

    tstate = tloop.train(_targs(scene_dir, log, **VARIANTS[variant]))
    assert tstate.step == N_STEPS

    want = _scalars(os.path.join(log, "jax", "metrics.jsonl"))
    got = _scalars(os.path.join(log, "torch", "metrics.jsonl"))
    steps = sorted(want["train/loss"])
    assert steps == list(range(N_STEPS)) == sorted(got["train/loss"])
    rel = np.array([abs(got["train/loss"][s] - want["train/loss"][s])
                    / abs(want["train/loss"][s]) for s in steps])
    assert rel[0] < 1e-4, rel[0]
    assert rel.max() < 2e-2, (rel.argmax(), rel.max())
    for tag in ("train/psnr", "train/img_loss", "train/tv_loss"):
        np.testing.assert_allclose(
            [got[tag][s] for s in steps], [want[tag][s] for s in steps],
            rtol=2e-2, err_msg=tag)
    # the same scalar tags at the same steps, LPIPS and its fallback-trunk
    # mark included, but for the per-parameter gradient norms (named by
    # flax path there, by the reference's parameter names here) and the
    # learning rate, which only the port logs
    def tags(scalars):
        return {t: sorted(v) for t, v in scalars.items()
                if t != "train/lr"
                and (not t.startswith("train/grads/")
                     or t == "train/grads/total")}

    assert tags(got) == tags(want)
    assert got["test/lpips_trunk_fallback"] == \
        want["test/lpips_trunk_fallback"] == {N_STEPS - 1: 1.0}
    assert "train/pts0_psnr" in got and "train/grads/total" in got
    if variant == "dsk_pts0":
        # while the blur loss waits, the loops print and log the PSNR of
        # the summed pts0 terms; the align term exists from the kernel start
        assert sorted(got["train/align_loss"]) == list(range(3, N_STEPS))
        for tag in ("train/pts0_psnr", "train/pts0_loss"):
            np.testing.assert_allclose(
                [got[tag][s] for s in steps], [want[tag][s] for s in steps],
                rtol=2e-2, err_msg=tag)
        assert got["train/pts0_psnr"][0] != got["train/psnr"][0]
    if variant == "full":
        # the event loss exists exactly from the event start on, and the
        # AWP loss from the kernel start on, in both
        for tag, first in (("train/event_egm", 2),
                           ("train/awp_fine_loss", 3)):
            assert sorted(got[tag]) == sorted(want[tag]) == \
                list(range(first, N_STEPS)), tag

    # held-out metrics: one line each, parsed alike by compare_metrics
    jm = compare_metrics.load(os.path.join(log, "jax"))
    tm = compare_metrics.load(os.path.join(log, "torch"))
    assert list(jm) == list(tm) == [N_STEPS - 1]
    for name in ("mse", "psnr", "ssim", "lpips"):
        assert abs(tm[N_STEPS - 1][name] - jm[N_STEPS - 1][name]) < 1e-3, name
    lines = [open(os.path.join(log, run, "test_metrics.txt")).read()
             for run in ("jax", "torch")]
    assert [ln.split("lpips_trunk=")[1] for ln in lines] == ["fallback\n"] * 2
    assert os.path.exists(os.path.join(
        log, "torch", f"testset_{N_STEPS - 1:06d}", "001.png"))


# ---------------------------------------------------------------------------
# (f) resume and render-only through the CLI, as tests/test_train.py:76-87
# ---------------------------------------------------------------------------

def _argv(scene_dir, logdir, **over):
    argv = []
    for k, v in {**BASE, "datadir": scene_dir, "basedir": logdir,
                 "expname": "run", "device": "cpu", "kernel_type": "none",
                 **over}.items():
        if v is not None:
            argv += [f"--{k}", str(v)]
    return argv


def test_cli_trains_resumes_and_renders(scene, tmp_path):
    scene_dir, _ = scene
    log = str(tmp_path)
    first = tcli.main(_argv(scene_dir, log, N_iters=6, i_weights=4,
                            perturb=1.0, raw_noise_std=1.0))
    assert first.step == 6
    ckdir = os.path.join(log, "run", "checkpoints")
    assert sorted(os.listdir(ckdir)) == ["000005.tar", "000006.tar"]
    expdir = os.path.join(log, "run")
    assert os.path.exists(os.path.join(expdir, "args.txt"))
    lines = open(os.path.join(expdir, "test_metrics.txt")).read().splitlines()
    assert len(lines) == 1 and lines[0].startswith("iter 5: mse=")

    # the second call resumes from the newest checkpoint and trains on
    second = tcli.main(_argv(scene_dir, log, N_iters=9, perturb=1.0,
                             raw_noise_std=1.0))
    assert second.step == 9
    scal = _scalars(os.path.join(expdir, "metrics.jsonl"))
    assert sorted(scal["train/loss"]) == list(range(9))
    lr = tloop.tstate.lr_schedule(5e-3, 10)
    assert scal["train/lr"][6] == lr(6) and scal["train/lr"][8] == lr(8)

    # an uninterrupted run draws what the resumed one drew: the generator
    # state rides in the checkpoint, the numpy samplers restart from the
    # seed in both (the resumed run's batches 6.. are the fresh run's 0..,
    # so only the random stream, not the data, is compared)
    ck = torch.load(os.path.join(ckdir, "000006.tar"), weights_only=True)
    assert ck["generator_device"] == "cpu"
    assert torch.equal(ck["generator_state"], first.generator.get_state())

    # render-only from the final checkpoint equals the last testset render
    tcli.main(_argv(scene_dir, log, render_only=True, render_test=True))
    outdir = os.path.join(expdir, "renderonly_test_000009")
    assert sorted(os.listdir(outdir)) == ["000.png", "001.png", "disp.npy"]
    for name in ("000.png", "001.png"):
        np.testing.assert_array_equal(
            imageio.imread(os.path.join(outdir, name)),
            imageio.imread(os.path.join(expdir, "testset_000008", name)))
    assert np.load(os.path.join(outdir, "disp.npy")).shape == (2, 24, 32)
    # a second render does not overwrite the first
    tcli.main(_argv(scene_dir, log, render_only=True, render_test=True))
    assert os.path.isdir(outdir + "_ver1")


def test_trace_window_writes_one_trace(scene, tmp_path):
    """``--profile_start_step 1 --profile_num_steps 1`` over a 3-step run:
    one Chrome trace in ``<expdir>/profile`` holding the step range; and
    ``--profile_dir`` moves it."""
    scene_dir, _ = scene
    log = str(tmp_path)
    tcli.main(_argv(scene_dir, log, N_iters=3, profile_start_step=1,
                    profile_num_steps=1))
    files = os.listdir(os.path.join(log, "run", "profile"))
    assert files == ["trace_000001.json"]
    with open(os.path.join(log, "run", "profile", files[0])) as f:
        events = json.load(f)["traceEvents"]
    ranges = [e for e in events if e.get("name") == tloop.STEP_RANGE
              and e.get("cat") == "user_annotation"]
    assert len(ranges) == 1
    # a window that outlasts the run is closed and written at its end
    tcli.main(_argv(scene_dir, log, expname="late", N_iters=2,
                    profile_start_step=1, profile_num_steps=5,
                    profile_dir=str(tmp_path / "traces")))
    assert os.listdir(str(tmp_path / "traces")) == ["trace_000001.json"]
    assert not os.path.exists(os.path.join(log, "late", "profile"))


def test_no_reload_and_ft_path(scene, tmp_path):
    scene_dir, _ = scene
    log = str(tmp_path)
    a = tloop.train(_targs(scene_dir, log, expname="a", N_iters=3))
    tar = os.path.join(log, "a", "checkpoints", "000003.tar")
    # --ft_path names one file: its weights and step start another run
    b = tloop.train(_targs(scene_dir, log, expname="b", N_iters=4,
                           ft_path=tar))
    assert b.step == 4
    # --no_reload starts from scratch beside existing checkpoints
    c = tloop.train(_targs(scene_dir, log, expname="a", N_iters=2,
                           no_reload=True))
    assert c.step == 2
    assert a.step == 3
    # ... and where a step's file is already there, it is replaced by this
    # run's: the next auto-resume must not load the earlier run's weights
    d = tloop.train(_targs(scene_dir, log, expname="a", N_iters=3,
                           no_reload=True, lrate=1e-4))
    saved = torch.load(tar, weights_only=True)
    assert saved["global_step"] == 3
    for n, p in d.model.state_dict().items():
        assert torch.equal(saved["network_state_dict"][n], p), n
    assert any(not torch.equal(p, q) for p, q in
               zip(a.model.parameters(), d.model.parameters()))


# ---------------------------------------------------------------------------
# (d) checkpoints
# ---------------------------------------------------------------------------

def _full_state(scene_dir, logdir, steps):
    """A full-method train state after ``steps`` steps, stopped before the
    kernel start (3) and the CRF learn start (5) when ``steps`` is 2."""
    args = _targs(scene_dir, logdir, expname="ck", N_iters=steps, **FULL)
    return args, tloop.train(args)


def test_checkpoint_round_trip(scene, tmp_path):
    """save -> restore gives equal parameters, buffers, Adam moments (and
    none where there were none), step, LR and generator state; and the
    restored state steps exactly as the saved one does."""
    scene_dir, _ = scene
    args, state = _full_state(scene_dir, str(tmp_path), 4)
    ckdir = os.path.join(str(tmp_path), "ck", "checkpoints")
    path = os.path.join(ckdir, "000004.tar")
    assert os.path.exists(path)

    # a fresh state built the way the loop builds it, then restored
    tconfig.resolve_event_thresholds(args)
    llff, ev = tloop.build_datasets(args)
    gen = torch.Generator().manual_seed(123)
    model, crf = tloop.build_model(args, llff, gen, "cpu")
    fresh = tloop.build_initial_state(args, model, crf, gen,
                                      crf_identity_prefit=False)
    assert tckpt.CheckpointManager(ckdir).restore_latest(fresh) == 4
    assert fresh.step == state.step == 4
    assert fresh.lr_schedule(fresh.step) == state.lr_schedule(state.step)
    assert torch.equal(fresh.generator.get_state(),
                       state.generator.get_state())
    for (n, a), (_, b) in zip(state.model.state_dict().items(),
                              fresh.model.state_dict().items()):
        assert torch.equal(a, b), n
    bn = [n for n in state.model.state_dict() if "running_" in n]
    assert bn, "the AWP BatchNorm statistics ride in network_state_dict"
    for (n, a), (_, b) in zip(state.crf.state_dict().items(),
                              fresh.crf.state_dict().items()):
        assert torch.equal(a, b), n

    def adam(st):
        names = [n for n, _ in st.model.named_parameters()] + [
            f"crf.{n}" for n, _ in st.crf.named_parameters()]
        params = [p for g in st.optimizer.param_groups for p in g["params"]]
        assert len(names) == len(params)
        return {n: st.optimizer.state.get(p) for n, p in zip(names, params)}

    want, got = adam(state), adam(fresh)
    assert set(want) == set(got)
    # 4 steps: the fields have taken 4, the blur kernel (from step 3) one,
    # the learned CRF (from step 5) none
    counts = {n: int(s["step"]) if s else 0 for n, s in want.items()}
    assert counts["mlp_fine.app_plane.0"] == 4
    assert {counts[n] for n in counts if n.startswith("kernelsnet.")} == {1}
    assert {counts[n] for n in counts if n.startswith("crf.")} == {0}
    for n, s in want.items():
        if not s:
            assert not got[n], f"{n} came back with an Adam state"
            continue
        assert int(got[n]["step"]) == int(s["step"]), n
        assert torch.equal(got[n]["exp_avg"], s["exp_avg"]), n
        assert torch.equal(got[n]["exp_avg_sq"], s["exp_avg_sq"]), n

    # both take the same next step, across the CRF learn start at 5
    step = tstep.build_train_step(args)
    sw_of = tstep.schedule_weights_fn(args)
    batch = {k: torch.from_numpy(v) for k, v in
             llff.batch(np.arange(64) * 7).items()}
    ev_batch = {k: torch.from_numpy(v) for k, v in
                ev.batch(np.arange(64)).items()}
    for st in (state, fresh):
        for i in (4, 5):
            st.last = step(st, batch, ev_batch, sw_of(i), False, True)
    assert torch.equal(state.last["loss"], fresh.last["loss"])
    for a, b in zip(state.model.parameters(), fresh.model.parameters()):
        assert torch.equal(a, b)
    assert {int(s["step"]) for n, s in adam(fresh).items()
            if n.startswith("crf.") and s} == {1}


def test_checkpoint_converts_and_serves(scene, tmp_path):
    """A port checkpoint is a reference ``*.tar``: its extra top-level
    keys break neither ``tools/convert_reference_checkpoint.py``'s
    functions nor the serving entry point, and the JAX package's exporters
    give its tensors back."""
    scene_dir, _ = scene
    args, state = _full_state(scene_dir, str(tmp_path), 2)
    path = os.path.join(str(tmp_path), "ck", "checkpoints", "000002.tar")
    # as the tool loads it
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    assert set(ckpt) >= {"global_step", "network_state_dict",
                         "crf_state_dict", "optimizer_state_dict", "wandb_id"}
    assert cc.normalize_legacy_network_state_dict(ckpt) is None
    assert int(ckpt["global_step"]) == 2
    net_sd = {k: v.numpy() for k, v in ckpt["network_state_dict"].items()}
    crf_sd = {k: v.numpy() for k, v in ckpt["crf_state_dict"].items()}
    net_flat, stats_flat = cc.convert_network_state_dict(net_sd)
    crf_flat = cc.convert_crf_state_dict(crf_sd)
    assert net_flat and stats_flat and crf_flat
    n_tensors = sum(v.size for v in net_flat.values())
    assert n_tensors == sum(p.numel() for n, p in
                            state.model.named_parameters()
                            if not n.startswith("awpnet.MAM.conv."))

    sd = serving.load_network_state_dict(path)
    llff, _ = tloop.build_datasets(argparse.Namespace(
        **{**args.as_dict(), "use_events": False}))
    renderer = serving.build_renderer(
        args, sd, llff.h, llff.w, llff.K, llff.near, llff.far,
        llff.bounding_box, device="cpu")
    assert renderer.unused_keys
    rgbs, depths = renderer.render_poses(llff.test_poses[:1])
    state.model.eval()
    want, _ = tevaluate.render_poses(state.model.render_chunk,
                                     llff.test_poses[:1], llff.h, llff.w,
                                     llff.K, chunk=args.chunk, device="cpu")
    torch.testing.assert_close(rgbs, want, rtol=0, atol=0)
    assert depths.shape == (1, 24, 32)


def test_checkpoint_manager_files(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path / "ck"))
    assert mgr.latest_step() is None and mgr.latest_path() is None
    for step in (7, 120, 30):
        open(mgr.path(step), "wb").close()
    open(os.path.join(mgr.directory, "000999.tar.123.tmp"), "wb").close()
    assert mgr.steps() == [7, 30, 120]
    assert mgr.latest_path().endswith("000120.tar")
    one = tckpt.CheckpointManager(mgr.path(30))
    assert one.latest_path() == mgr.path(30)
    assert one.directory == mgr.directory


# ---------------------------------------------------------------------------
# (h) what the loop writes
# ---------------------------------------------------------------------------

def test_depth_colormap_is_cv2_jet_exactly():
    lut = cv2.applyColorMap(np.arange(256, dtype=np.uint8)[None],
                            cv2.COLORMAP_JET)[0, :, ::-1]
    np.testing.assert_array_equal(tevaluate.jet_table(), lut)
    d = np.random.default_rng(0).uniform(0.2, 3.0, (24, 32)).astype(np.float32)
    for near, far in ((None, None), (0.5, 2.0)):
        got = tevaluate.depth_colormap(d, near, far)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got,
                                      jevaluate.depth_colormap(d, near, far))


@pytest.mark.parametrize("shape", [(13, 17, 3), (8, 8), (5, 9, 4)])
def test_stdlib_png_writer_reads_back(tmp_path, shape):
    img = np.random.default_rng(1).integers(0, 256, shape).astype(np.uint8)
    path = str(tmp_path / "x.png")
    with open(path, "wb") as f:                # the stdlib writer
        f.write(tlogger._png_bytes(img))
    np.testing.assert_array_equal(imageio.imread(path), img)
    tlogger.write_png(path, img)               # through imageio, here
    np.testing.assert_array_equal(imageio.imread(path), img)
    with pytest.raises(TypeError, match="uint8"):
        tlogger.write_png(path, img.astype(np.float32))


def test_metrics_and_crf_on_renders_match_jax():
    rng = np.random.default_rng(2)
    a = rng.uniform(0, 1, (2, 24, 32, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    for name in ("mse", "psnr", "ssim"):
        assert tmetrics.compute_img_metric(a, b, name) == \
            jmetrics.compute_img_metric(a, b, name), name
    # AlexNet's taps need 31 pixels: no LPIPS on 24 x 32, in both
    assert tmetrics.compute_img_metric(a, b, "lpips") is None
    assert jmetrics.compute_img_metric(a, b, "lpips") is None
    assert tmetrics.lpips_trunk_kind() == jmetrics.lpips_trunk_kind() \
        == "fallback"
    metrics = {"test/mse": 0.0123456, "test/psnr": 19.087654,
               "test/ssim": 0.512345}
    assert tevaluate.format_test_metrics(9, metrics) == \
        "iter 9: mse=0.01235 psnr=19.08765 ssim=0.51235\n"
    metrics.update({"test/lpips": 0.0123456, "test/lpips_trunk_fallback": 1.0})
    assert tevaluate.format_test_metrics(9, metrics, "fallback") == (
        "iter 9: mse=0.01235 psnr=19.08765 ssim=0.51235 lpips=0.01235 "
        "lpips_trunk=fallback\n")

    from evdeblurnerf_torch.models.tonemapping import TonemappingTransform
    crf = TonemappingTransform("gamma", "learn", 2.2,
                               generator=torch.Generator().manual_seed(0))
    out = tevaluate.apply_crf(crf, a)
    assert isinstance(out, np.ndarray)
    np.testing.assert_allclose(out, a ** (1 / 2.2), rtol=1e-6)


def test_logger_streams_scalars_and_images(tmp_path):
    log = tlogger.Logger(str(tmp_path), "exp")
    log.scalars({"train/loss": 0.5, "train/psnr": 10.0}, 3)
    log.image("test/pred_0", np.full((4, 6, 3), 0.5, np.float32), 3)
    log.video("video/rgb", np.zeros((2, 5, 7, 3), np.float32), 3)
    log.histogram("w", np.arange(4.0), 3)
    log.close()
    recs = _scalars(str(tmp_path / "exp" / "metrics.jsonl"))
    assert recs == {"train/loss": {3: 0.5}, "train/psnr": {3: 10.0}}
    img = imageio.imread(str(tmp_path / "exp" / "images"
                             / "test_pred_0_00000003.png"))
    assert img.shape == (4, 6, 3) and (img == 127).all()
    assert os.listdir(str(tmp_path / "exp" / "videos"))
    off = tlogger.Logger(str(tmp_path), "off", enabled=False)
    off.scalar("a", 1.0, 0)
    off.close()
    assert not (tmp_path / "off").exists()
