#!/usr/bin/env python3
"""The culled eval render against the exact one on one checkpoint of the
PyTorch port: the counterpart of ``tools/eval_cull_ab.py``.

``--fine_cull_eval`` (with a ``--fine_cull_capacity``) takes the
transmittance fine cull into the held-out and served renders. This tool
says what that costs: it restores the newest checkpoint of a
``tools/validate_train_torch.py`` run, renders the held-out views with
the exact fine pass and with the culled pass (``--capacity`` lanes a ray,
``--eps`` transmittance), both through ``render_chunk`` in one process
(``fine_cull=False`` and ``fine_cull=True``), each arm a warm render and
then a timed one (synchronised on the card), and prints one JSON line:
each arm's MSE / PSNR / SSIM / LPIPS, ``render_s`` and kernel launches of
the timed render, the differences (cull minus full), and the pixel
difference between the two renders (mean, p99, max, on [0, 1] radiance
after the CRF).

Usage, from the root of a checkout (on the card unless ``--device cpu``
is among the extra flags; the extra flags are the validation run's):
    python3 tools/validate_train_torch.py --iters 2500 --profile small \\
        --expname exact
    python3 tools/eval_cull_ab_torch.py --expname exact --profile small \\
        [--capacity 0.25] [--eps 1e-3]
"""

import argparse
import json
import os
import sys
import time
from types import SimpleNamespace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

ARMS = (("full", False), ("cull", True))


def restore(argv=None):
    """The validation run's held-out views and its newest checkpoint, with
    the fine cull at ``--capacity`` and ``--eps``: a namespace of ``args``
    (this tool's), ``targs`` (the run's flags), ``device``, ``llff``,
    ``model``, ``crf`` and ``step``."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--capacity", type=float, default=0.25)
    ap.add_argument("--eps", type=float, default=1e-3)
    ap.add_argument("--expname", default="vtrain")
    ap.add_argument("--profile", default="full", choices=["full", "small"])
    from validate_train_torch import (SMALL_PROFILE, add_scene_args,
                                      ensure_scene, make_cli)

    add_scene_args(ap)
    args, extra = ap.parse_known_args(argv)
    ensure_scene(args)

    import torch

    from evdeblurnerf_torch import config
    from evdeblurnerf_torch.train import loop
    from evdeblurnerf_torch.train.checkpoint import CheckpointManager
    from synthetic_scene_torch import scene_classes

    argv_run = make_cli(args, 1)
    argv_run[argv_run.index("--expname") + 1] = args.expname
    if args.profile == "small":
        argv_run += SMALL_PROFILE
    argv_run += ["--fine_cull_capacity", str(args.capacity),
                 "--fine_cull_eps", str(args.eps)]
    targs = config.parse_args(argv_run + extra)
    device = loop.resolve_device(targs)
    llff_cls, _ = scene_classes()
    dargs = config.resolve_event_thresholds(targs)
    dargs.use_events = False
    llff, _ = loop.build_datasets(dargs, llff_cls=llff_cls)
    model, crf = loop.build_model(targs, llff, device=device)
    state = loop.build_initial_state(targs, model, crf,
                                     torch.Generator(device=device),
                                     crf_identity_prefit=False)
    ckdir = os.path.join(args.logdir, args.expname, "checkpoints")
    step = CheckpointManager(ckdir).restore_latest(state)
    if step is None:
        raise SystemExit(f"no checkpoint under {ckdir}")
    model.eval()
    return SimpleNamespace(args=args, targs=targs, device=device, llff=llff,
                           model=model, crf=crf, step=int(step))


def render_views(run, fine_cull):
    """The held-out views through ``render_chunk(fine_cull=...)``, the CRF
    applied as the loop's held-out renders apply it: numpy [N, H, W, 3]."""
    from evdeblurnerf_torch.train import evaluate

    llff = run.llff
    rgbs, _ = evaluate.render_poses(
        lambda rays: run.model.render_chunk(rays, fine_cull=fine_cull),
        llff.test_poses, llff.h, llff.w, llff.K, chunk=run.targs.chunk,
        device=run.device)
    return evaluate.apply_crf(
        run.crf, rgbs.cpu().numpy(),
        skip_learn_crf=run.step < run.targs.tone_mapping_start_learn_iter)


def compare(argv=None):
    """(the JSON record :func:`main` prints, {arm: its render})."""
    import numpy as np
    import torch

    from evdeblurnerf_torch import kernels
    from evdeblurnerf_torch.utils.metrics import compute_img_metric

    run = restore(argv)
    gt = np.asarray(run.llff.test_images)

    def sync():
        if run.device.type == "cuda":
            torch.cuda.synchronize(run.device)

    arms, renders = {}, {}
    for arm, cull in ARMS:
        render_views(run, cull)                 # warm render
        sync()
        kernels.reset_launches()
        t0 = time.perf_counter()
        rgbs = render_views(run, cull)
        sync()
        secs = time.perf_counter() - t0
        renders[arm] = rgbs
        arms[arm] = {name: float(v) for name in ("mse", "psnr", "ssim",
                                                 "lpips")
                     if (v := compute_img_metric(rgbs, gt, metric=name))
                     is not None}
        arms[arm]["render_s"] = secs
        arms[arm]["launches"] = {k: v for k, v in kernels.LAUNCHES.items()
                                 if v}
    pix = np.abs(renders["cull"].astype(np.float64)
                 - renders["full"].astype(np.float64))
    out = {
        "step": run.step, "expname": run.args.expname,
        "capacity": run.args.capacity, "eps": run.args.eps,
        "device": (torch.cuda.get_device_name(run.device)
                   if run.device.type == "cuda" else "cpu"),
        "views": int(gt.shape[0]), "H": int(run.llff.h),
        "W": int(run.llff.w), "full": arms["full"], "cull": arms["cull"],
        "delta_cull_minus_full": {
            k: arms["cull"][k] - arms["full"][k] for k in arms["full"]
            if k != "launches"},
        "pixel_abs_diff": {"mean": float(pix.mean()),
                           "p99": float(np.percentile(pix, 99)),
                           "max": float(pix.max())},
    }
    return out, renders


def main(argv=None):
    out, _ = compare(argv)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
