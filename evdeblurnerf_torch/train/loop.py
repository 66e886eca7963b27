"""The experiment run: the full train / eval / render-only lifecycle.

Counterpart of ``evdeblurnerf_tpu/train/loop.py`` (ref: run_nerf.py:33-780).
Orchestration is host-side python; every per-step computation runs in the
train step (``train/step.py``), fed by background prefetch threads that
assemble the image-ray and event batches and copy them to the device
(``data/pipeline.py``). The loop reads a loss off the device only at the
print and log cadences, so host and card overlap in between.

Dropped against the JAX loop, as TPU mechanism: the device mesh and its
shardings, the batch rounding to the mesh, the compiled-program cache and
multi-host. Not ported yet (``config.check_supported`` raises): the fine
and coarse culls, tensor parallelism, the trace window.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Optional

import numpy as np
import torch

from ..config import (check_supported, resolve_event_thresholds,
                      write_args_txt)
from ..data import (ImageBatchSampler, LLFFDataset, LLFFEventsDataset,
                    Prefetcher, RandomEventSampler, RandomRaySampler, endless)
from ..utils.logger import Logger, write_png
from ..utils.metrics import compute_img_metric, lpips_trunk_kind
from ..utils.misc import (annealing_interpolator,
                          exponential_scale_fine_loss_weight, seed_everything,
                          to8b)
from . import state as tstate
from .checkpoint import CheckpointManager
from .evaluate import (apply_crf, depth_colormap, format_test_metrics,
                       render_poses)
from .step import build_train_step, compute_schedule_weights


# the name of the profiler range around each step (a no-op without a
# profiler), so that a trace can be cut at step boundaries
STEP_RANGE = "train_step"


def resolve_device(args) -> torch.device:
    """The device of ``--device`` (``cuda`` unless the caller asks for the
    CPU). A CUDA device that is not there raises: nothing carries on on
    the CPU because it found no card."""
    device = torch.device(getattr(args, "device", None) or "cuda")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"--device {device} asked for, but torch.cuda.is_available() "
                "is False; pass --device cpu to run on the CPU")
        device = torch.device("cuda", device.index or 0)
        torch.cuda.set_device(device)
        # full float32 products, as every parity bound assumes
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif device.type != "cpu":
        raise ValueError(f"--device {device}: expected cuda, cuda:N or cpu")
    return device


def build_datasets(args, llff_cls=LLFFDataset, events_cls=LLFFEventsDataset):
    """LLFF + optional event dataset + EDI prior (ref: run_nerf.py:52-116).
    ``llff_cls`` / ``events_cls``: subclasses that read a scene stored
    another way (``load_images`` / ``load_events``)."""
    llff = llff_cls(args, args.datadir, args.factor, recenter=True,
                    bd_factor=args.bd_factor, spherify=args.spherify,
                    path_epi=args.render_epi,
                    pose_transform_allknown=args.pose_transform_allknown)
    ev = None
    if args.use_events:
        ev = events_cls(
            args, args.datadir, llff.h, llff.w, llff.K, args.factor,
            recenter=True, bd_factor=args.bd_factor, bd_scale=llff.scale,
            closest_bds=llff.closest_bds, furthest_bds=llff.furthest_bds,
            spherify=args.spherify,
            recenter_partial=llff.recenter_partial,
            spherify_partial=llff.spherify_partial,
            events_tms_unit=args.events_tms_unit,
            events_tms_files_unit=args.events_tms_files_unit,
            color_events=args.event_egm_use_colorevents)
        if args.use_pts0_prior == "edi":
            llff.set_pts0_prior(ev.compute_edi_prior(
                llff.i_train, llff.images, args.pts0_edi_steps,
                args.events_threshold_pos, args.events_threshold_neg))
    return llff, ev


def build_model(args, llff, generator: Optional[torch.Generator] = None,
                device=None):
    """The model and its CRF for a loaded scene (``train/state.py``)."""
    return tstate.build_model(args, llff.bounding_box, llff.h, llff.w,
                              float(llff.K[0][0]), llff.near, llff.far,
                              llff.n_imgs, generator, device, K=llff.K)


def build_initial_state(args, model, crf, generator: torch.Generator,
                        crf_identity_prefit=None) -> tstate.TrainState:
    """Fresh TrainState + optimizer exactly as training constructs them;
    also the template a checkpoint restores into."""
    return tstate.create_train_state(model, crf, args, generator,
                                     crf_identity_prefit=crf_identity_prefit)


def _image_sampler_factory(args, llff):
    # One persistent sampler instance: its np.random.Generator state then
    # advances across epochs (torch RandomSampler semantics) instead of
    # replaying an identical permutation every epoch.
    if args.ray_sampling_mode == "images":
        sampler = ImageBatchSampler(
            llff.n_imgs, args.ray_sampling_images_num, args.N_rand,
            (llff.w, llff.h), seed=args.seed)
    else:
        sampler = RandomRaySampler(llff.n_rays, args.N_rand, seed=args.seed)
    return lambda: iter(sampler)


def _render(args, llff, model, poses, device, render_factor: int = 0):
    """(rgbs [N, H, W, 3], depths [N, H, W]) as numpy, linear radiance."""
    model.eval()
    rgbs, depths = render_poses(model.render_chunk, poses, llff.h, llff.w,
                                llff.K, chunk=args.chunk,
                                render_factor=render_factor, device=device)
    return rgbs.cpu().numpy(), depths.cpu().numpy()


def run_test_renders(args, llff, model, crf, device, step, logger, expdir,
                     skip_learn_crf: bool):
    """Held-out view eval (ref: run_nerf.py:642-709), at the full
    ``--chunk``: chunking is value-invisible."""
    rgbs, depths = _render(args, llff, model, llff.test_poses, device)
    rgbs = apply_crf(crf, rgbs, skip_learn_crf=skip_learn_crf)
    gt = np.asarray(llff.test_images)

    metrics = {}
    for name in ("mse", "psnr", "ssim", "lpips"):
        v = compute_img_metric(rgbs, gt, metric=name)
        if v is not None:
            metrics[f"test/{name}"] = v
    lpips_trunk = lpips_trunk_kind() if "test/lpips" in metrics else None
    logger.scalars(metrics, step)

    testdir = os.path.join(expdir, f"testset_{step:06d}")
    os.makedirs(testdir, exist_ok=True)
    for i in range(rgbs.shape[0]):
        write_png(os.path.join(testdir, f"{i:03d}.png"), to8b(rgbs[i]))
        logger.image(f"test/pred_{i}", rgbs[i], step)
    logger.image("test/gt_0", gt[0], step)
    logger.image("test/depth_0", depth_colormap(depths[0]), step)
    logger.image("test/err_0", np.abs(rgbs[0] - gt[0]).clip(0, 1), step)

    with open(os.path.join(expdir, "test_metrics.txt"), "a") as f:
        f.write(format_test_metrics(step, metrics, lpips_trunk))
    return metrics


def run_video_render(args, llff, model, crf, device, step, logger,
                     skip_learn_crf: bool):
    """Spiral/EPI novel-view video (ref: run_nerf.py:711-734)."""
    rgbs, depths = _render(args, llff, model, llff.render_poses, device,
                           render_factor=args.render_factor)
    rgbs = apply_crf(crf, rgbs, skip_learn_crf=skip_learn_crf)
    logger.video("video/rgb", rgbs, step)
    logger.video("video/disp", np.stack([depth_colormap(d) for d in depths]),
                 step)
    return rgbs, depths


def train(args, max_iters: Optional[int] = None, llff_cls=LLFFDataset,
          events_cls=LLFFEventsDataset):
    """Full training lifecycle; returns the final TrainState (for tests).

    ``max_iters`` bounds the steps of this call; ``llff_cls`` /
    ``events_cls`` as in :func:`build_datasets`."""
    check_supported(args)
    resolve_event_thresholds(args)
    device = resolve_device(args)

    seed_everything(args.seed)
    llff, ev = build_datasets(args, llff_cls, events_cls)

    generator = torch.Generator(device=device).manual_seed(args.seed)
    model, crf = build_model(args, llff, generator, device)

    expdir = os.path.join(args.basedir, args.expname)
    os.makedirs(expdir, exist_ok=True)
    write_args_txt(args, os.path.join(expdir, "args.txt"))
    if args.config and os.path.exists(args.config):
        shutil.copyfile(args.config, os.path.join(expdir, "config.txt"))

    sampler = endless(_image_sampler_factory(args, llff))

    # checkpoint auto-resume (ref: run_nerf.py:276-297)
    ckpt = CheckpointManager(args.ft_path if args.ft_path
                             else os.path.join(expdir, "checkpoints"))
    resume = not args.no_reload and ckpt.latest_path() is not None
    # a restored CRF needs no identity pre-fit
    state = build_initial_state(args, model, crf, generator,
                                crf_identity_prefit=False if resume else None)
    start = 0
    if resume:
        start = ckpt.restore_latest(state)
        print(f"Resumed from step {start}")
        if ev is not None:
            ev.global_step = start

    # W&B run-id persistence for resume (ref: run_nerf.py:292): in the
    # checkpoint, and in a sidecar json as the JAX package keeps it
    wandb_id_path = os.path.join(expdir, "wandb_id.json")
    wandb_id = None
    if start > 0 and os.path.exists(wandb_id_path):
        with open(wandb_id_path) as f:
            wandb_id = json.load(f).get("wandb_id")
    logger = Logger(log_dir=args.tbdir or args.basedir, expname=args.expname,
                    use_wandb=not args.no_wandb and not args.render_only,
                    use_tensorboard=args.use_tensorboard, wandb_id=wandb_id,
                    args=args)
    if logger.wandb_id is not None:
        with open(wandb_id_path, "w") as f:
            json.dump({"wandb_id": logger.wandb_id}, f)

    # ------------------------------------------------------------------
    # render-only (ref: run_nerf.py:337-414)
    # ------------------------------------------------------------------
    if args.render_only:
        poses = llff.test_poses if args.render_test else llff.render_poses
        name = "test" if args.render_test else "path"
        t0 = time.perf_counter()
        rgbs, depths = _render(args, llff, model, poses, device,
                               render_factor=args.render_factor)
        dt = time.perf_counter() - t0
        print(f"  rendered {len(poses)} poses ({rgbs.size // 3} rays) in "
              f"{dt:.2f}s")
        rgbs = apply_crf(crf, rgbs, skip_learn_crf=False)
        outdir = os.path.join(expdir, f"renderonly_{name}_{start:06d}")
        ver = 0
        while os.path.exists(outdir + (f"_ver{ver}" if ver else "")):
            ver += 1
        outdir = outdir + (f"_ver{ver}" if ver else "")
        os.makedirs(outdir)
        for i in range(rgbs.shape[0]):
            write_png(os.path.join(outdir, f"{i:03d}.png"), to8b(rgbs[i]))
        np.save(os.path.join(outdir, "disp.npy"), depths)
        logger.video(f"renderonly/{name}", rgbs, start)
        logger.close()
        return state

    # ------------------------------------------------------------------
    # schedules (ref: run_nerf.py:121-142)
    # ------------------------------------------------------------------
    w_events_egm = annealing_interpolator(
        args.event_egm_weight, args.event_egm_weight_end,
        args.event_egm_weight_steps, args.event_egm_weight_scheduler) \
        if args.use_events else (lambda s: 0.0)
    w_pts0_target = annealing_interpolator(
        args.pts0_target_weight, args.pts0_target_weight_end,
        args.pts0_target_weight_steps, args.pts0_target_weight_scheduler) \
        if args.use_pts0_prior else (lambda s: 0.0)
    kernel_end_warmup_iter = -1
    w_kernel = lambda s: 1.0  # noqa: E731
    if args.kernel_start_warmup_mode != "step":
        kernel_end_warmup_iter = (args.kernel_start_iter
                                  + args.kernel_start_warmup_iters)
        w_kernel = annealing_interpolator(
            0.0, 1.0, kernel_end_warmup_iter, args.kernel_start_warmup_mode,
            start_step=args.kernel_start_iter)

    step_fn = build_train_step(args)

    # prefetch pipelines; the numpy samplers restart from the seed on
    # resume, as in the JAX package
    img_prefetch = Prefetcher(lambda: llff.batch(next(sampler)),
                              device=device)
    ev_prefetch = None
    if args.use_events and args.add_event_egm:
        ev_sampler = RandomEventSampler(len(ev), args.events_N_rand,
                                        seed=args.seed)
        ev_iter = endless(lambda: iter(ev_sampler))
        ev_prefetch = Prefetcher(lambda: ev.batch(next(ev_iter)),
                                 device=device)

    N_iters = args.N_iters if max_iters is None else min(args.N_iters,
                                                         start + max_iters)
    # ref run_nerf.py:417: the flags set only the INITIAL value; the 10k
    # recomputes below hardcode 0.1/0.9 upstream (flag-dead end_ratio quirk)
    fine_loss_weight = args.kernel_awp_fine_loss_start_ratio

    try:
        for i in range(start, N_iters):
            is_last = i == N_iters - 1
            force_naive = i < args.kernel_start_iter
            events_active = bool(
                args.add_event_egm and ev_prefetch is not None
                and (args.add_event_egm_startiter is None
                     or i >= args.add_event_egm_startiter))

            batch = next(img_prefetch)
            ev_batch = next(ev_prefetch) if events_active else None

            # reference-literal recompute (ref run_nerf.py:463-471): runs
            # only once the AWP render exists (kernel active, not the
            # pre-start naive phase), with start/end ratios HARDCODED
            # 0.1/0.9 upstream and an N_iters+1 horizon — quirks
            # replicated for trajectory parity
            if (args.kernel_use_awp and args.kernel_awp_use_coarse_to_fine_opt
                    and not force_naive and i % 10000 == 0):
                fine_loss_weight = exponential_scale_fine_loss_weight(
                    N_iters=args.N_iters + 1,
                    kernel_start_iter=args.kernel_start_iter,
                    start_ratio=0.1, end_ratio=0.9, iter=i)

            sw = compute_schedule_weights(
                args, i, kernel_end_warmup_iter=kernel_end_warmup_iter,
                w_kernel=w_kernel, w_pts0_target=w_pts0_target,
                w_events_egm=w_events_egm,
                fine_loss_weight=fine_loss_weight,
                events_active=events_active)
            with torch.profiler.record_function(STEP_RANGE):
                aux = step_fn(state, batch, ev_batch, sw, force_naive,
                              events_active)

            # the only reads off the device between cadences are below
            if i % args.i_print == 0 or is_last:
                loss = float(aux["loss"])
                psnr = float(aux["psnr"] if i > args.blur_loss_after
                             else aux.get("pts0_psnr", aux["psnr"]))
                print(f"[{args.expname}] iter {i}: loss {loss:.5f} "
                      f"psnr {psnr:.2f}")
            if i % args.i_tensorboard == 0 or is_last:
                scalars = {f"train/{k}": float(v) for k, v in aux.items()
                           if torch.is_tensor(v) and v.dim() == 0}
                scalars["train/lr"] = state.optimizer.param_groups[0]["lr"]
                logger.scalars(scalars, i)

            if (i % args.i_weights == 0 and i > 0) or is_last:
                # keyed by the post-update step count so resume continues
                # exactly where training left off
                ckpt.save(state.step, state, wandb_id=logger.wandb_id)
            if (i % args.i_testset == 0 and i > 0) or is_last:
                run_test_renders(
                    args, llff, model, crf, device, i, logger, expdir,
                    skip_learn_crf=i < args.tone_mapping_start_learn_iter)
            if i % args.i_video == 0 and i > 0:
                run_video_render(
                    args, llff, model, crf, device, i, logger,
                    skip_learn_crf=i < args.tone_mapping_start_learn_iter)
    finally:
        img_prefetch.close()
        if ev_prefetch is not None:
            ev_prefetch.close()
        logger.close()

    return state
