#!/usr/bin/env python3
"""Held-out quality of the PyTorch/CUDA port on the synthetic scene.

The port's copy of ``tools/validate_train.py``: it writes the blur +
events scene of ``tests/synthetic.py::make_synthetic_scene`` (96 x 128, 6
images, 4 poses an image, seed 0) with numpy
(``tools/synthetic_scene_torch.py::write_synthetic_scene``, no cv2 or
h5py), trains the full method (RBK + AWP, or DSK / PBE / none, with the
event loss through the learned event CRF and the gamma rgb CRF) for
``--iters`` iterations through
``evdeblurnerf_torch.cli.main``, and prints the held-out PSNR / SSIM /
LPIPS of ``test_metrics.txt`` with the run's seconds and its median
milliseconds a step.

``--profile small`` adds the matched small profile of the JAX package's
recorded runs (``PERF_NOTES.md:148-152``, ``docs/PARITY.md:54``): 128 rays,
32 + 32 samples, 262,144 / 2,097,152 voxels (the ``SMALL`` sizes of
``tools/bench_reference_cpu.py:45-46``), 256 event rays. The AWP sample
width 64 is in the RBK flag set already.

Usage, from the root of a checkout (the run goes to the card unless
``--device cpu`` is among the extra flags):
    python3 tools/validate_train_torch.py --iters 1000 --profile small \\
        [--kernel rbk|dsk|pbe|none] [--seed 0] [--geometry sphere|boxes] \\
        [--scene DIR] [--logdir DIR] [extra run_nerf flags...]
"""

import argparse
import json
import os
import statistics
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

SMALL_PROFILE = ["--N_rand", "128", "--N_samples", "32",
                 "--N_importance", "32", "--coarse_n_voxels", "262144",
                 "--fine_n_voxels", "2097152", "--events_N_rand", "256"]


def add_scene_args(ap):
    ap.add_argument("--scene", default=None,
                    help="scene directory (default build/vtrain_scene_<geometry>"
                         "[_cdavis] in the checkout; written if absent)")
    ap.add_argument("--logdir", default=os.path.join(REPO, "build",
                                                     "vtrain_logs"))
    ap.add_argument("--h", type=int, default=96)
    ap.add_argument("--w", type=int, default=128)
    ap.add_argument("--n_imgs", type=int, default=6)
    ap.add_argument("--geometry", default="sphere",
                    choices=["sphere", "boxes"])
    ap.add_argument("--cdavis", action="store_true",
                    help="color-DAVIS path: rectified float event coords + "
                         "ev_map, Bayer one-hot color EGM, color-pos-neg "
                         "BII CRF features")
    ap.add_argument("--kernel", default="rbk",
                    choices=["rbk", "dsk", "pbe", "none"],
                    help="rbk = RBK+AWP; dsk/pbe without AWP; none = the "
                         "sharp-frame ablation")


def ensure_scene(args):
    if args.scene is None:
        args.scene = os.path.join(
            REPO, "build", f"vtrain_scene_{args.geometry}"
            + ("_cdavis" if args.cdavis else ""))
    if not os.path.exists(os.path.join(args.scene, "events.npz")):
        from synthetic_scene_torch import write_synthetic_scene

        n = write_synthetic_scene(args.scene, n_imgs=args.n_imgs, h=args.h,
                                  w=args.w, rectified_coords=args.cdavis,
                                  geometry=args.geometry)
        print(f"scene written to {args.scene} ({n} events)", flush=True)


def make_cli(args, iters):
    """The validation run's flag set, flag for flag that of
    ``tools/validate_train.py::make_cli``."""
    cli = [
        "--expname", "vtrain",
        "--basedir", args.logdir,
        "--datadir", args.scene,
        "--dataset_type", "llff",
        "--factor", "1", "--llffhold", "6",
        "--events_tms_unit", "us", "--events_tms_files_unit", "us",
        "--no_wandb",
        "--N_iters", str(iters),
        "--N_rand", "256", "--N_samples", "64", "--N_importance", "64",
        "--mode", "c2f",
        "--coarse_n_voxels", "1000000", "--fine_n_voxels", "8000000",
    ]
    if args.kernel == "rbk":
        cli += [
            "--kernel_type", "RBK", "--kernel_ptnum", "5",
            "--kernel_rbk_use_origin",
            "--kernel_use_awp", "--kernel_img_embed", "32",
            # every published AWP config sets 64; the reference MAM
            # hard-codes Linear(64, 32) (ref networks/dpnerf/mam.py:60)
            "--kernel_awp_sam_emb_width", "64",
        ]
    elif args.kernel in ("dsk", "pbe"):
        cli += ["--kernel_type", args.kernel.upper(), "--kernel_ptnum", "5",
                "--kernel_img_embed", "32"]
    else:
        cli += ["--kernel_type", "none"]
    cli += [
        "--kernel_start_iter", "300",
        "--use_viewdirs",
        "--use_events", "--events_N_rand", "1024", "--add_event_egm",
        "--tone_mapping_events_type", "learn",
        "--tone_mapping_type", "gamma",
        "--i_testset", "500", "--i_print", "100", "--i_weights", "100000",
        "--lrate_decay", "10",
    ]
    if args.cdavis:
        cli += [
            "--event_egm_use_colorevents",
            "--event_egm_use_color_weights", "0.4 0.2 0.4",
            "--event_egm_color_weights_start_iter", "300",
            "--tone_mapping_events_add_bii", "color-pos-neg",
        ]
    return cli


def read_test_metrics(run_dir):
    """{iter: {name: value}} of a run's ``test_metrics.txt`` (the
    ``lpips_trunk`` word kept as a string)."""
    from compare_metrics_torch import load

    return load(run_dir, keep_words=True)


def write_cpu_init(argv_run, path, seed, llff_cls, events_cls):
    """A step-0 checkpoint of the run's model and pre-fitted CRF drawn
    with a CPU generator seeded ``seed``, as the loop draws them."""
    import torch

    from evdeblurnerf_torch import config
    from evdeblurnerf_torch.train import loop as tloop

    args = config.resolve_event_thresholds(
        config.parse_args(argv_run + ["--device", "cpu"]))
    llff, _ = tloop.build_datasets(args, llff_cls, events_cls)
    gen = torch.Generator().manual_seed(seed)
    model, crf = tloop.build_model(args, llff, gen, "cpu")
    tloop.build_initial_state(args, model, crf, gen)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({"global_step": 0, "network_state_dict": model.state_dict(),
                "crf_state_dict": crf.state_dict(),
                "optimizer_state_dict": None, "wandb_id": None}, path)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--profile", default="full", choices=["full", "small"],
                    help="small: the matched small profile of the JAX "
                         "package's recorded runs")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--expname", default="vtrain")
    ap.add_argument("--init_checkpoint", default=None,
                    help="a step-0 checkpoint to start from (e.g. the JAX "
                         "package's initial state, converted): copied into "
                         "the run's checkpoints, which the loop resumes")
    ap.add_argument("--init_device", default=None, choices=["cpu"],
                    help="draw the initial weights (and pre-fit the event "
                         "CRF) with a CPU generator at --seed, then train "
                         "from them as from --init_checkpoint")
    add_scene_args(ap)
    args, extra = ap.parse_known_args(argv)
    ensure_scene(args)

    import bench_torch
    from evdeblurnerf_torch import cli as tcli
    from evdeblurnerf_torch.train import loop as tloop
    from synthetic_scene_torch import scene_classes

    npz_llff, npz_events = scene_classes()
    argv_run = make_cli(args, args.iters)
    argv_run[argv_run.index("--expname") + 1] = args.expname
    argv_run += ["--seed", str(args.seed)]
    if args.profile == "small":
        argv_run += SMALL_PROFILE
    argv_run += extra
    run_dir = os.path.join(args.logdir, args.expname)
    first = os.path.join(run_dir, "checkpoints", "000000.tar")
    if args.init_checkpoint:
        import shutil

        os.makedirs(os.path.dirname(first), exist_ok=True)
        shutil.copyfile(args.init_checkpoint, first)
    elif args.init_device == "cpu":
        write_cpu_init(argv_run, first, args.seed, npz_llff, npz_events)
    t0 = time.perf_counter()
    with bench_torch.loop_timings(tloop) as tm:
        tcli.main(argv_run, llff_cls=npz_llff, events_cls=npz_events)
        marks = tm.get("step_marks", [])
        steps_ms = [a.ms_until(b) for a, b in zip(marks, marks[1:])]
    seconds = time.perf_counter() - t0
    rows = read_test_metrics(run_dir)
    for it, row in sorted(rows.items()):
        print(f"iter {it}: psnr {row.get('psnr')} ssim {row.get('ssim')} "
              f"lpips {row.get('lpips')} lpips_trunk "
              f"{row.get('lpips_trunk')}")
    ckdir = os.path.join(run_dir, "checkpoints")
    last = sorted(os.listdir(ckdir))[-1] if os.path.isdir(ckdir) else None
    print(json.dumps({
        "kernel": args.kernel, "seed": args.seed, "profile": args.profile,
        "init_checkpoint": args.init_checkpoint,
        "init_device": args.init_device,
        "geometry": args.geometry, "iters": args.iters,
        "seconds": seconds,
        "ms_per_step_median": (statistics.median(steps_ms) if steps_ms
                               else None),
        "test": {str(k): v for k, v in sorted(rows.items())},
        "checkpoint": os.path.join(ckdir, last) if last else None}))


if __name__ == "__main__":
    main()
