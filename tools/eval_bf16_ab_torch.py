#!/usr/bin/env python3
"""The bf16 eval chain against f32 on one checkpoint of the PyTorch port:
the counterpart of ``tools/eval_bf16_ab.py``.

A model trained with ``--triplane_bf16`` renders its held-out views
through the bf16 eval chain (``models/voxnerf.py``: the interpolation in
bf16, the double-angle encoding); the reference's eval protocol is f32
end to end (ref: run_nerf.py:642-709). This tool restores ONE checkpoint
of a ``tools/validate_train_torch.py`` run and renders its held-out views
twice, through the chain and with ``eval_f32_interp`` (the chain off: the
same bf16 rows, f32 math, the exact encoding), in one process, and prints
one JSON line: both arms' PSNR / SSIM / LPIPS, their differences, and the
pixel difference between the two renders (mean, p99, max, on [0, 1]
radiance after the CRF).

Usage, from the root of a checkout (on the card unless ``--device cpu``
is among the extra flags; the extra flags are the validation run's,
``--triplane_bf16`` and ``--profile small`` among them):
    python3 tools/validate_train_torch.py --iters 2500 --profile small \\
        --expname bf16 --triplane_bf16
    python3 tools/eval_bf16_ab_torch.py --expname bf16 --profile small \\
        --triplane_bf16
"""

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--expname", default="vtrain")
    ap.add_argument("--profile", default="full", choices=["full", "small"])
    from validate_train_torch import (SMALL_PROFILE, add_scene_args,
                                      ensure_scene, make_cli)

    add_scene_args(ap)
    args, extra = ap.parse_known_args(argv)
    ensure_scene(args)

    import numpy as np
    import torch

    from evdeblurnerf_torch import config
    from evdeblurnerf_torch.models.system import EvDeblurNeRF
    from evdeblurnerf_torch.train import evaluate, loop
    from evdeblurnerf_torch.train.checkpoint import CheckpointManager
    from evdeblurnerf_torch.utils.metrics import compute_img_metric
    from synthetic_scene_torch import scene_classes

    argv_run = make_cli(args, 1)
    argv_run[argv_run.index("--expname") + 1] = args.expname
    if args.profile == "small":
        argv_run += SMALL_PROFILE
    targs = config.parse_args(argv_run + extra)
    if not targs.triplane_bf16:
        raise SystemExit("the run has no bf16 tables: pass --triplane_bf16 "
                         "as it was trained")
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
    gt = np.asarray(llff.test_images)

    fields = {k: v for k, v in model.state_dict().items()
              if k.startswith(("mlp_coarse.", "mlp_fine."))}
    arms, renders = {}, {}
    for arm, f32_interp in (("bf16", False), ("f32", True)):
        field = EvDeblurNeRF(model.cfg, device=device,
                             eval_f32_interp=f32_interp)
        field.load_state_dict(fields, strict=True)
        field.eval()
        assert field.mlp_coarse.eval_bf16(False) is not f32_interp
        rgbs, _ = evaluate.render_poses(field.render_chunk, llff.test_poses,
                                        llff.h, llff.w, llff.K,
                                        chunk=targs.chunk, device=device)
        rgbs = evaluate.apply_crf(
            crf, rgbs.cpu().numpy(),
            skip_learn_crf=step < targs.tone_mapping_start_learn_iter)
        renders[arm] = rgbs
        arms[arm] = {name: float(v) for name in ("mse", "psnr", "ssim",
                                                 "lpips")
                     if (v := compute_img_metric(rgbs, gt, metric=name))
                     is not None}
        del field
    pix = np.abs(renders["bf16"].astype(np.float64)
                 - renders["f32"].astype(np.float64))
    out = {
        "step": int(step), "expname": args.expname,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "views": int(gt.shape[0]), "H": int(llff.h), "W": int(llff.w),
        "bf16": arms["bf16"], "f32": arms["f32"],
        "delta_bf16_minus_f32": {k: arms["bf16"][k] - arms["f32"][k]
                                 for k in arms["bf16"]},
        "pixel_abs_diff": {"mean": float(pix.mean()),
                           "p99": float(np.percentile(pix, 99)),
                           "max": float(pix.max())},
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
