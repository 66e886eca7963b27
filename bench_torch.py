#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port (``evdeblurnerf_torch``) on one GPU:
the paper's training step, the train loop and the serving render, read in
one process.

The port's counterpart of ``bench.py::run()``: the same model (c2f PDRF,
64+64 samples, grids of 16,777,248 and 134,217,984 voxels, app_n_comp
(64, 16, 16), fine width 256, RBK with 10 rays a pixel and AWP, a learned
event CRF) and the same seeded numpy batch (1,024 x 10 RBK rays plus
2 x 4,096 event rays). The flags are the paper's configuration file
(``PAPER_CONFIG``) through the port's parser, with the blur kernel and the
learned CRF live from step 0, at the exact settings every parity test pins
(``fine_cull_capacity 0``, f32 tables, TF32 off). ``--fine_cull_capacity``
and ``--coarse_cull_capacity`` read the culled path instead, both culls
live from step 0: the step with the occupancy grid of its random weights
built once before timing, as ``bench.py`` builds it (the culled width is a
fixed lane budget, so the grid's content does not change the work), the
loop with its own refreshes, and the served pose with ``--fine_cull_eval``.
``--triplane_bf16`` reads them with bf16 tables (the served pose through
the bf16 eval chain); ``--matmul_precision high`` with the card's float32
products in TF32 (``evdeblurnerf_torch/utils/precision.py``).
Three readings:

* ``step_only``: the captured training step (``train/capture.py``, what
  the train loop runs on the card) on one fixed batch, 3 warm-up steps
  (the first eager, the second captured), then ``iters`` steps between
  two CUDA events; first the same for the eager step of ``train/step.py``
  on the same state, printed on a line of its own and kept under
  ``step_only.eager``;
* ``loop``: the step through ``evdeblurnerf_torch.cli.main`` on the
  numpy scene of ``tools/synthetic_scene_torch.py`` (data, prefetch,
  schedules, every gate open): the time between CUDA events recorded after
  each step call, so host stalls count;
* ``serve``: one 480 x 640 pose through ``serving.build_renderer`` and
  ``render_poses`` in chunks of 32,768 rays, after a one-chunk warm-up; and
  one chunk's device time split by kernel name (``torch.profiler``).

It prints one JSON line: train rays/s and ms/step for step and loop, the
host share (loop against step), eval rays/s, peak GiB, kernel launches a
step, the card's name and power limit, torch and CUDA versions and the
commit. ``chip_smoke.py`` builds its training flags and batch with
:func:`train_args` and :func:`make_train_batch` and times its loop with
:func:`loop_timings`.

Usage, from the root of a checkout (needs one CUDA card and nvcc):
    python3 bench_torch.py [--only step_only|loop|serve] [--iters 10]
                           [--fine_cull_capacity 0.25]
                           [--coarse_cull_capacity 0.25] [--triplane_bf16]
                           [--matmul_precision highest|high|default]
                           [--out FILE]
    python3 bench_torch.py --device cpu --tiny     # the same code, small
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

H, W, FOCAL = 480, 640, 500.0
NEAR, FAR = 0.0, 1.0
AABB = ((-1.6, -1.7, -1.0), (1.7, 1.6, 1.0))
NUM_IMAGES = 30         # bench.py's scene
SEED = 0
# configs/evdeblurnerf_blender/tx_blurfactory_evdeblurnerf_ediprior_evcrf.txt
# (the paper's full method), with the two overrides that make the blur
# kernel and the learned CRF live from step 0 (1200 in the file)
PAPER_CONFIG = ("configs/evdeblurnerf_blender/"
                "tx_blurfactory_evdeblurnerf_ediprior_evcrf.txt")
PAPER_OVERRIDES = dict(kernel_start_iter=0, tone_mapping_start_learn_iter=0)
WARMUP_STEPS = 3
READINGS = ("step_only", "loop", "serve")
# --tiny: the same code at a size for the CPU
TINY = dict(
    N_rand=32, events_N_rand=32, N_samples=8, N_importance=8,
    kernel_ptnum=3, multires=4, multires_views=2, coarse_n_voxels=4096,
    fine_n_voxels=8192, coarse_app_n_comp="[8, 4, 4]",
    fine_app_n_comp="[8, 4, 4]", coarse_hidden_dim=16,
    coarse_hidden_dim_color=16, fine_hidden_dim=16, fine_hidden_dim_color=16,
    fine_geo_feat_dim=16, coarse_app_dim=8, fine_app_dim=8,
    kernel_awp_sam_emb_width=16, kernel_awp_mot_emb_width=16, chunk=16384)
TINY_H, TINY_W, TINY_FOCAL = 48, 64, 50.0


def train_args(**overrides):
    """The paper configuration through the port's parser, with
    ``PAPER_OVERRIDES`` and then ``overrides`` as command-line flags over
    the file, and the event thresholds resolved."""
    from evdeblurnerf_torch import config

    argv = ["--config", os.path.join(REPO, PAPER_CONFIG)]
    for k, v in {**PAPER_OVERRIDES, **overrides}.items():
        argv += [f"--{k}", str(v)]
    return config.resolve_event_thresholds(config.parse_args(argv))


def make_train_batch(dev, n_rand, events_n_rand):
    """bench.py's synthetic batch (numpy seed 0: rays, pixel coordinates,
    image indices, identity poses, targets) plus a uniform EDI-prior target
    ``rgbsf_pts0``, as tensors on ``dev``: (batch, event batch)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)

    def make_rays(n, seed):
        r = np.random.default_rng(seed)
        o = r.normal(size=(n, 3)).astype(np.float32) * 0.05
        d = r.normal(size=(n, 3)).astype(np.float32)
        d[:, 2] = -np.abs(d[:, 2]) - 0.5
        return np.stack([o, d], axis=-1)

    batch = {
        "rays": make_rays(n_rand, 0),
        "rays_x": rng.uniform(0, W, n_rand).astype(np.float32),
        "rays_y": rng.uniform(0, H, n_rand).astype(np.float32),
        "images_idx": rng.integers(0, NUM_IMAGES, n_rand).astype(np.int32),
        "rgbsf": rng.uniform(0, 1, (n_rand, 3)).astype(np.float32),
    }
    ev_batch = {
        "events_rays_start": make_rays(events_n_rand, 1),
        "events_rays_end": make_rays(events_n_rand, 2),
        "events_pos_pol_cumsum":
            rng.integers(0, 3, events_n_rand).astype(np.float32),
        "events_neg_pol_cumsum":
            -rng.integers(0, 3, events_n_rand).astype(np.float32),
    }
    batch["rgbsf_pts0"] = rng.uniform(0, 1, (n_rand, 3)).astype(np.float32)
    batch["poses"] = np.broadcast_to(
        np.concatenate([np.eye(3), np.zeros((3, 1))], -1),
        (n_rand, 3, 4)).astype(np.float32).copy()
    return ({k: torch.from_numpy(v).to(dev) for k, v in batch.items()},
            {k: torch.from_numpy(v).to(dev) for k, v in ev_batch.items()})


def card_line():
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Mark:
    """A point in time on the device's clock (a CUDA event on the current
    stream), or on the host's where there is no card."""

    def __init__(self, on_card):
        import torch

        self.event = None
        if on_card:
            self.event = torch.cuda.Event(enable_timing=True)
            self.event.record()
        self.host = time.perf_counter()

    def ms_until(self, later):
        if self.event is not None:
            return self.event.elapsed_time(later.event)
        return 1e3 * (later.host - self.host)


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def loop_timings(tloop):
    """Times of one ``train`` call, taken from outside the loop: for the
    length of the block the functions that ``train/loop.py`` calls by
    their module names are wrapped. Yields a dict that fills as the run
    goes: host-clock seconds per call of ``build_datasets`` (with the EDI
    prior), ``build_model``, ``build_initial_state`` (with the CRF
    pre-fit), ``run_test_renders`` and ``CheckpointManager.save``;
    ``step_call_s``, the host's seconds inside each call of the train
    step (the device may still be running it); and ``step_marks``, one
    mark per step, recorded on the compute stream after the step's work
    (``a.ms_until(b)`` between two of them is the loop's time on the
    device's own clock, host stalls included)."""
    import torch

    tm = {}

    def timed(fn, key):
        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            tm.setdefault(key, []).append(time.perf_counter() - t0)
            return out
        return wrapper

    def build_loop_step(args, **kw):
        step = timed(saved["build_loop_step"](args, **kw), "step_call_s")

        def marked(*a, **kw):
            out = step(*a, **kw)
            tm.setdefault("step_marks", []).append(
                _Mark(torch.cuda.is_available()
                      and out["loss"].device.type == "cuda"))
            return out
        return marked

    names = ("build_datasets", "build_model", "build_initial_state",
             "run_test_renders", "build_loop_step")
    saved = {n: getattr(tloop, n) for n in names}
    save = tloop.CheckpointManager.save
    try:
        for n in names[:-1]:
            setattr(tloop, n, timed(saved[n], f"{n}_s"))
        tloop.build_loop_step = build_loop_step
        tloop.CheckpointManager.save = timed(save, "checkpoint_s")
        yield tm
    finally:
        for n in names:
            setattr(tloop, n, saved[n])
        tloop.CheckpointManager.save = save


def _time_steps(step, state, batch, ev_batch, sw_of, flags, device, iters):
    """``WARMUP_STEPS`` then ``iters`` timed steps of ``step`` on one
    batch: ms/step between CUDA events, the losses, the launches a timed
    step and the peak over all of them."""
    import torch

    from evdeblurnerf_torch import kernels

    def one():
        # a captured step's metrics are overwritten by the next step
        return step(state, batch, ev_batch, sw_of(state.step), False, True,
                    **flags)["loss"].clone()

    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    losses = [float(one()) for _ in range(WARMUP_STEPS)]
    _sync(device)
    kernels.reset_launches()
    start = _Mark(device.type == "cuda")
    timed = [one() for _ in range(iters)]
    end = _Mark(device.type == "cuda")
    _sync(device)
    ms = start.ms_until(end) / iters
    out = dict(ms_per_step=ms, iters=iters,
               losses=losses + [float(v) for v in timed],
               launches_per_step={k: v / iters
                                  for k, v in kernels.LAUNCHES.items() if v})
    if device.type == "cuda":
        out["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
        out["peak_reserved_gib"] = (torch.cuda.max_memory_reserved(device)
                                    / 2 ** 30)
    return out


def bench_step_only(args, device, iters):
    """The eager step, then the captured step, on one state: each
    ``iters`` steps on one fixed batch after ``WARMUP_STEPS`` (the
    captured step's first is eager, its second captured). The eager
    reading is printed on a line of its own and kept under ``eager``."""
    import torch

    from evdeblurnerf_torch.train import capture
    from evdeblurnerf_torch.train import state as tstate
    from evdeblurnerf_torch.train import step as tstep

    gen = torch.Generator(device=device).manual_seed(SEED)
    model, crf = tstate.build_model(args, AABB, H, W, FOCAL, NEAR, FAR,
                                    NUM_IMAGES, gen, device)
    state = tstate.create_train_state(model, crf, args, gen)
    sw_of = tstep.schedule_weights_fn(args)
    batch, ev_batch = make_train_batch(device, args.N_rand,
                                       args.events_N_rand)
    n_rays = args.N_rand * args.kernel_ptnum + 2 * args.events_N_rand
    flags = dict(fine_cull=(args.fine_cull_capacity or 0.0) > 0,
                 coarse_cull=(args.coarse_cull_capacity or 0.0) > 0)
    if flags["coarse_cull"]:
        from evdeblurnerf_torch.models.system import build_occ_grid

        flags["occ_grid"] = build_occ_grid(model)
    readings = {}
    for name, step in (("eager", tstep.build_train_step(args)),
                       ("captured", capture.CapturedStep(args))):
        r = readings[name] = _time_steps(step, state, batch, ev_batch,
                                         sw_of, flags, device, iters)
        r.update(train_rays_per_s=n_rays / (r["ms_per_step"] / 1e3),
                 rays_per_step=n_rays)
    eager = readings["eager"]
    print(f"step_only eager: {eager['ms_per_step']:.3f} ms/step, "
          f"{eager['train_rays_per_s']:.1f} train rays/s", flush=True)
    return dict(readings["captured"], eager=eager)


def bench_loop(overrides, device, iters):
    """``WARMUP_STEPS + iters + 1`` steps of a fresh run through
    ``cli.main`` on the synthetic scene, every gate open; the time between
    the step marks of the last ``iters`` steps."""
    import torch

    from evdeblurnerf_torch import cli, kernels
    from evdeblurnerf_torch.train import loop as tloop

    synth = _load_tool("synthetic_scene_torch")
    llff_cls, events_cls = synth.scene_classes()
    n_steps = WARMUP_STEPS + iters + 1
    with tempfile.TemporaryDirectory() as tmp:
        scene = os.path.join(tmp, "scene")
        os.makedirs(scene)
        synth.write_scene(scene, train_args().events_threshold, SEED)
        logs = os.path.join(tmp, "logs")
        flags = dict(
            PAPER_OVERRIDES, add_event_egm_startiter=0, datadir=scene,
            basedir=logs, tbdir=logs, expname="bench", no_wandb=True,
            device=str(device), N_iters=n_steps, i_print=10 ** 9,
            i_tensorboard=10 ** 9, i_weights=10 ** 9, i_testset=10 ** 9,
            i_video=10 ** 9, **overrides)
        argv = ["--config", os.path.join(REPO, PAPER_CONFIG)]
        for k, v in flags.items():
            argv += [f"--{k}", str(v)]
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        kernels.reset_launches()
        with loop_timings(tloop) as tm:
            state = cli.main(argv, llff_cls=llff_cls, events_cls=events_cls)
        _sync(device)
    marks = tm["step_marks"]
    if state.step != n_steps or len(marks) != n_steps:
        raise RuntimeError(f"the loop ran {state.step} steps with "
                           f"{len(marks)} marks, expected {n_steps}")
    ms = marks[WARMUP_STEPS].ms_until(marks[-1]) / iters
    args = train_args(**overrides)
    n_rays = args.N_rand * args.kernel_ptnum + 2 * args.events_N_rand
    out = dict(
        ms_per_step=ms, train_rays_per_s=n_rays / (ms / 1e3),
        rays_per_step=n_rays, iters=iters,
        host_ms_in_step_call=1e3 * sum(
            tm["step_call_s"][WARMUP_STEPS + 1:]) / iters,
        setup_s=dict(datasets=tm["build_datasets_s"][0],
                     model=tm["build_model_s"][0],
                     state_with_crf_prefit=tm["build_initial_state_s"][0]),
        launches_per_step={k: v / n_steps
                           for k, v in kernels.LAUNCHES.items() if v})
    if device.type == "cuda":
        out["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
    return out


def bench_serve(args, device, h, w, focal):
    """One ``h`` x ``w`` pose through ``serving.build_renderer`` and
    ``render_poses`` on seeded random weights, after a one-chunk
    warm-up."""
    import numpy as np
    import torch

    from evdeblurnerf_torch import kernels, serving
    from evdeblurnerf_torch.models.renderer import config_from_args
    from evdeblurnerf_torch.models.system import EvDeblurNeRF

    K = [[focal, 0.0, w / 2], [0.0, focal, h / 2], [0.0, 0.0, 1.0]]
    gen = torch.Generator(device=device).manual_seed(SEED)
    model = EvDeblurNeRF(config_from_args(args, AABB, h, w, focal, NEAR, FAR),
                         generator=gen, device=device)
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    del model
    renderer = serving.build_renderer(args, sd, h, w, K, NEAR, FAR, AABB,
                                      device=device)
    pose = np.concatenate([np.eye(3), np.zeros((3, 1))], 1)[None].astype(
        np.float32)
    warm = torch.zeros(args.chunk, 3, 2, device=device)
    warm[:, 2, 1] = -1.0
    renderer(warm)
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launches()
    t0 = time.perf_counter()
    rgbs, depths = renderer.render_poses(pose)
    _sync(device)
    secs = time.perf_counter() - t0
    if not bool(torch.isfinite(rgbs).all() and torch.isfinite(depths).all()):
        raise RuntimeError("non-finite render output")
    out = dict(eval_rays_per_s=h * w / secs, seconds=secs, rays=h * w,
               chunk=args.chunk,
               launches={k: v for k, v in kernels.LAUNCHES.items() if v})
    if device.type == "cuda":
        out["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
        # one chunk's device time, split by the hand-written kernels' names
        # (K4, K1, K3); "other" is PyTorch's own kernels
        from evdeblurnerf_torch.train.evaluate import pose_rays

        rays = pose_rays(pose, h, w, np.asarray(K), device)[:args.chunk] \
            .contiguous()
        out["device_ms_per_chunk"] = _load_tool(
            "timing_torch").device_ms_by_name(
                lambda: renderer(rays),
                ("triplane_fwd", "permute_lanes", "cdf_take"), iters=3,
                warmup=1)
    return out


def _commit():
    try:
        rev = subprocess.run(["git", "-C", REPO, "rev-parse", "HEAD"],
                             capture_output=True, text=True, timeout=30)
    except OSError:
        return None
    return rev.stdout.strip() if rev.returncode == 0 else None


def cull_overrides(fine_cull_capacity=0.0, coarse_cull_capacity=0.0):
    """Flags that turn the culls on from step 0 (module docstring); none
    for capacities of 0, so the readings stay the exact path."""
    out = {}
    if fine_cull_capacity > 0:
        out.update(fine_cull_capacity=fine_cull_capacity,
                   fine_cull_start_iter=0, fine_cull_eval=True)
    if coarse_cull_capacity > 0:
        out.update(coarse_cull_capacity=coarse_cull_capacity,
                   coarse_cull_start_iter=0)
    return out


def run(n_rand=1024, events_n_rand=4096, grad_accum=1, iters=10,
        arg_overrides=None, device="cuda", only=None, tiny=False):
    """Build the paper-scale step and read it ``only`` one way or all three
    (``READINGS``); returns the result dict that :func:`main` prints.
    ``arg_overrides`` are flags over the paper configuration (the culls:
    :func:`cull_overrides`); ``tiny`` runs the ``TINY`` sizes (for
    ``device="cpu"``)."""
    import torch

    sys.path.insert(0, REPO)
    from evdeblurnerf_torch.train.loop import resolve_device

    overrides = dict(N_rand=n_rand, events_N_rand=events_n_rand,
                     grad_accum=grad_accum)
    if tiny:
        overrides.update(TINY)
    overrides.update(arg_overrides or {})
    args = train_args(device=device, **overrides)
    dev = resolve_device(args)     # the card made current, precision set
    result = dict(
        device=dict(platform="gpu" if dev.type == "cuda" else "cpu",
                    kind=(torch.cuda.get_device_name(dev)
                          if dev.type == "cuda" else "cpu")),
        card=card_line() if dev.type == "cuda" else None,
        torch=torch.__version__, cuda=torch.version.cuda, commit=_commit(),
        config=PAPER_CONFIG, overrides={**PAPER_OVERRIDES, **overrides},
        tiny=tiny)
    chosen = READINGS if only is None else (only,)
    if "step_only" in chosen:
        result["step_only"] = bench_step_only(args, dev, iters)
    if "loop" in chosen:
        result["loop"] = bench_loop(overrides, dev, iters)
    if "step_only" in result and "loop" in result:
        step_ms = result["step_only"]["ms_per_step"]
        loop_ms = result["loop"]["ms_per_step"]
        result["host_share"] = (loop_ms - step_ms) / loop_ms
    if "serve" in chosen:
        size = (TINY_H, TINY_W, TINY_FOCAL) if tiny else (H, W, FOCAL)
        result["serve"] = bench_serve(args, dev, *size)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default), cuda:N or cpu")
    ap.add_argument("--only", choices=READINGS, default=None,
                    help="take one reading instead of all three")
    ap.add_argument("--iters", type=int, default=10,
                    help="timed steps of step_only and loop (default 10)")
    ap.add_argument("--n_rand", type=int, default=1024)
    ap.add_argument("--events_n_rand", type=int, default=4096)
    ap.add_argument("--grad_accum", type=int, default=1)
    ap.add_argument("--fine_cull_capacity", type=float, default=0.0,
                    help="read the transmittance fine cull at this "
                         "capacity (default 0: the exact path)")
    ap.add_argument("--coarse_cull_capacity", type=float, default=0.0,
                    help="read the occupancy coarse cull at this capacity "
                         "(default 0)")
    ap.add_argument("--triplane_bf16", action="store_true",
                    help="read the step, loop and serve with bf16 tables "
                         "(the serve through the bf16 eval chain)")
    ap.add_argument("--matmul_precision", default="highest",
                    choices=("highest", "high", "default"),
                    help="the card's float32 products: exact float32 "
                         "('highest', the default) or TF32 ('high' or "
                         "'default')")
    ap.add_argument("--tiny", action="store_true",
                    help="the same code at a small size, for --device cpu")
    ap.add_argument("--out", metavar="FILE", default=None,
                    help="also write the JSON line to FILE")
    opts = ap.parse_args(argv)
    overrides = cull_overrides(opts.fine_cull_capacity,
                               opts.coarse_cull_capacity)
    if opts.triplane_bf16:
        overrides["triplane_bf16"] = True
    overrides["matmul_precision"] = opts.matmul_precision
    result = run(opts.n_rand, opts.events_n_rand, opts.grad_accum,
                 opts.iters, overrides, device=opts.device, only=opts.only,
                 tiny=opts.tiny)
    line = json.dumps(result)
    print(line, flush=True)
    if opts.out:
        with open(opts.out, "w") as f:
            f.write(line + "\n")
    return result


if __name__ == "__main__":
    main()
