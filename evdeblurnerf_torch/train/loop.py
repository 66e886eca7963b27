"""The experiment run: the full train / eval / render-only lifecycle.

Counterpart of ``evdeblurnerf_tpu/train/loop.py`` (ref: run_nerf.py:33-780).
Orchestration is host-side python; every per-step computation runs in the
train step (``train/step.py``), fed by background prefetch threads that
assemble the image-ray and event batches and copy them to the device
(``data/pipeline.py``). The loop reads a loss off the device only at the
print and log cadences, so host and card overlap in between.

``--profile_start_step`` / ``--profile_num_steps`` open a
``torch.profiler`` window over those steps (the JAX loop's ``jax.profiler``
window) and write it as a Chrome trace to ``--profile_dir`` or
``<expdir>/profile``; each step in it is a ``STEP_RANGE`` range.

The culls run as in the JAX loop: the transmittance fine cull from
``--fine_cull_start_iter`` (and in the held-out renders with
``--fine_cull_eval``); the occupancy coarse cull from
``--coarse_cull_start_iter``, its grid refreshed there, every
``--occ_refresh_every`` steps after and at the first culled step after a
resume (the grid is derived and never checkpointed), engaged only while
the expected kept share of lanes fits ``--occ_gate_margin`` times the
capacity; each refresh logs ``train/occ_frac`` and
``train/coarse_cull_active``.

The parallel paths (``parallel/``): under ``torchrun`` or ``--multihost``
(``cli.py`` joins the process group) each process drives its own card
(``--device cuda`` is ``cuda:<LOCAL_RANK>``; an explicit ``cuda:N``
stays), assembles the global batch from the shared seed and trains on its
rows, the batch rounded to a multiple of the ray shards times
``grad_accum`` (:func:`_round_to_devices`); ``--tp_model_parallel k``
slices the voxel tables over k ranks of each ray shard after any resume.
The held-out renders are data-parallel. The primary process alone writes
``args.txt``, the logs, the checkpoints (under tensor parallelism the
tables gathered first) and the PNGs; a barrier follows each.
Tensor parallelism across hosts is refused before the dataset is built,
as in the JAX package.

On the card each step of a one-process run replays a CUDA graph of the
step, one per gate key (``train/capture.py``, the counterpart of the JAX
package's jitted step); under a process group the step runs eagerly.

Dropped against the JAX loop, as TPU mechanism: the shardings of the
device mesh and the compiled-program cache.
"""

from __future__ import annotations

import functools
import json
import os
import shutil
import time
from typing import Optional

import numpy as np
import torch

from ..config import (PORT_DEFAULTS, check_supported, eval_fine_cull,
                      resolve_event_thresholds, write_args_txt)
from ..data import (ImageBatchSampler, LLFFDataset, LLFFEventsDataset,
                    Prefetcher, RandomEventSampler, RandomRaySampler, endless)
from ..models.system import build_occ_grid
from ..ops.occupancy import expected_keep_fraction
from ..parallel import mesh, multihost, tp
from ..utils.logger import Logger, write_png
from ..utils.metrics import compute_img_metric, lpips_trunk_kind
from ..utils.misc import (annealing_interpolator,
                          exponential_scale_fine_loss_weight, seed_everything,
                          to8b)
from ..utils.precision import set_matmul_precision
from . import state as tstate
from .checkpoint import CheckpointManager
from .evaluate import (apply_crf, depth_colormap, format_test_metrics,
                       render_poses)
from .capture import build_loop_step
from .step import compute_schedule_weights


# the name of the profiler range around each step (a no-op without a
# profiler), so that a trace can be cut at step boundaries
STEP_RANGE = "train_step"


class TraceWindow:
    """The ``torch.profiler`` window of ``--profile_start_step`` over
    ``--profile_num_steps`` steps, written as a Chrome trace
    (``trace_<first step>.json``) into ``directory``."""

    def __init__(self, args, expdir: str, device: torch.device):
        self.first = args.profile_start_step
        self.last = self.first + args.profile_num_steps - 1
        self.directory = args.profile_dir or os.path.join(expdir, "profile")
        self.device = device
        self.prof = None

    def before_step(self, i: int) -> None:
        if self.first >= 0 and i == self.first:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=activities)
            self.prof.start()

    def after_step(self, i: int, loss: torch.Tensor) -> None:
        if self.prof is not None and i >= self.last:
            # the last step's work must be on the device's timeline
            loss.item()
            self.stop()

    def stop(self) -> None:
        """End the window, wherever the run stopped, and write the trace."""
        if self.prof is None:
            return
        self.prof.stop()
        os.makedirs(self.directory, exist_ok=True)
        path = os.path.join(self.directory, f"trace_{self.first:06d}.json")
        self.prof.export_chrome_trace(path)
        self.prof = None
        print(f"profile trace written to {path}")


def resolve_device(args) -> torch.device:
    """The device of ``--device`` (``cuda`` unless the caller asks for the
    CPU): ``cuda`` is this process's card, ``cuda:<LOCAL_RANK>``
    (``parallel/multihost.py::local_device``), an explicit ``cuda:N`` wins.
    A CUDA device that is not there raises: nothing carries on on the CPU
    because it found no card. Sets the card's float32 products to
    ``--matmul_precision`` (``utils/precision.py``; CPU products stay
    exact)."""
    device = multihost.local_device(getattr(args, "device", None) or "cuda")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"--device {device} asked for, but torch.cuda.is_available() "
                "is False; pass --device cpu to run on the CPU")
        torch.cuda.set_device(device)
    elif device.type != "cpu":
        raise ValueError(f"--device {device}: expected cuda, cuda:N or cpu")
    set_matmul_precision(getattr(args, "matmul_precision",
                                 PORT_DEFAULTS["matmul_precision"]))
    return device


def step_gates(args, i: int):
    """(force_naive, events_active, fine_cull, coarse_cull) of step ``i``
    as the loop sets them; the coarse cull also waits for its occupancy
    grid's gate, which the loop reads at each refresh."""
    events = bool(args.use_events and args.add_event_egm)
    return (i < args.kernel_start_iter,
            events and (args.add_event_egm_startiter is None
                        or i >= args.add_event_egm_startiter),
            (args.fine_cull_capacity or 0) > 0
            and i >= args.fine_cull_start_iter,
            (args.coarse_cull_capacity or 0) > 0 and args.mode == "c2f"
            and i >= args.coarse_cull_start_iter)


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


def _round_to_devices(n: int, n_dev: int, name: str,
                      grad_accum: int = 1) -> int:
    """Round the batch so each grad-accum MICROBATCH divides over the ray
    shards (``evdeblurnerf_tpu/train/loop.py:83-99``): the step cuts the
    rank's rows into ``grad_accum`` microbatches, and microbatch k of every
    rank makes the global one, so the quantum is n_dev * grad_accum."""
    quantum = n_dev * max(grad_accum, 1)
    if n % quantum:
        new = max(quantum, (n // quantum) * quantum)
        print(f"[parallel] rounding {name} {n} -> {new} "
              f"(multiple of {n_dev} devices x grad_accum={grad_accum})")
        return new
    return n


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


def _render(args, llff, model, poses, device, render_factor: int = 0,
            layout: mesh.Layout = mesh.Layout()):
    """(rgbs [N, H, W, 3], depths [N, H, W]) as numpy, linear radiance;
    every rank of ``layout`` renders its shard and gets the whole."""
    model.eval()
    chunk_fn = functools.partial(model.render_chunk,
                                 fine_cull=eval_fine_cull(args))
    rgbs, depths = render_poses(chunk_fn, poses, llff.h, llff.w,
                                llff.K, chunk=args.chunk,
                                render_factor=render_factor, device=device,
                                layout=layout)
    return rgbs.cpu().numpy(), depths.cpu().numpy()


def run_test_renders(args, llff, model, crf, device, step, logger, expdir,
                     skip_learn_crf: bool,
                     layout: mesh.Layout = mesh.Layout()):
    """Held-out view eval (ref: run_nerf.py:642-709), at the full
    ``--chunk``: chunking is value-invisible. Every rank renders; the
    primary alone scores and writes. Returns the metrics (None off the
    primary)."""
    rgbs, depths = _render(args, llff, model, llff.test_poses, device,
                           layout=layout)
    if not multihost.is_primary():
        return None
    rgbs = apply_crf(crf, rgbs, skip_learn_crf=skip_learn_crf)
    gt = np.asarray(llff.test_images)

    metrics = {}
    for name in ("mse", "psnr", "ssim", "lpips"):
        v = compute_img_metric(rgbs, gt, metric=name)
        if v is not None:
            metrics[f"test/{name}"] = v
    # fallback-trunk LPIPS is not comparable to published LPIPS(alex): every
    # persisted copy (the scalars and the text file) says so
    lpips_trunk = lpips_trunk_kind() if "test/lpips" in metrics else None
    if lpips_trunk == "fallback":
        metrics["test/lpips_trunk_fallback"] = 1.0
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
                     skip_learn_crf: bool,
                     layout: mesh.Layout = mesh.Layout()):
    """Spiral/EPI novel-view video (ref: run_nerf.py:711-734)."""
    rgbs, depths = _render(args, llff, model, llff.render_poses, device,
                           render_factor=args.render_factor, layout=layout)
    rgbs = apply_crf(crf, rgbs, skip_learn_crf=skip_learn_crf)
    logger.video("video/rgb", rgbs, step)
    logger.video("video/disp", np.stack([depth_colormap(d) for d in depths]),
                 step)
    return rgbs, depths


def train(args, max_iters: Optional[int] = None, llff_cls=LLFFDataset,
          events_cls=LLFFEventsDataset):
    """Full training lifecycle; returns the final TrainState (for tests).

    ``max_iters`` bounds the steps of this call; ``llff_cls`` /
    ``events_cls`` as in :func:`build_datasets`. In a process group
    (``parallel/multihost.py``) every rank calls it."""
    check_supported(args)
    tp_k = max(1, int(getattr(args, "tp_model_parallel", 1) or 1))
    # refused BEFORE the (minutes-long on real data) dataset build, as the
    # JAX loop refuses it (evdeblurnerf_tpu/train/loop.py:252-263)
    if tp_k > 1 and (getattr(args, "multihost", False)
                     or multihost.spans_hosts()):
        raise NotImplementedError(
            "--tp_model_parallel with multi-host training is not supported "
            "(as in the JAX package): train data-parallel across hosts "
            "(the voxel tables replicate), or tensor-parallel on a single "
            "host under torchrun")
    resolve_event_thresholds(args)
    device = resolve_device(args)
    layout = mesh.create_layout(tp_k)
    primary = multihost.is_primary()
    multihost.build_kernels(device)
    ga = args.grad_accum or 1
    args.N_rand = _round_to_devices(args.N_rand, layout.n_data, "N_rand",
                                    grad_accum=ga)
    args.events_N_rand = _round_to_devices(args.events_N_rand, layout.n_data,
                                           "events_N_rand", grad_accum=ga)

    seed_everything(args.seed)
    llff, ev = build_datasets(args, llff_cls, events_cls)

    generator = torch.Generator(device=device).manual_seed(args.seed)
    model, crf = build_model(args, llff, generator, device)

    expdir = os.path.join(args.basedir, args.expname)
    os.makedirs(expdir, exist_ok=True)
    if primary:
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
    # each rank keeps its slice of the whole tables it built or restored
    if tp.shard_state(state, layout) and primary:
        print(f"[parallel] voxel tables sliced over {tp_k} ranks "
              f"({layout.n_data} ray shards)")

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
                    args=args, enabled=primary)
    if logger.wandb_id is not None and primary:
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
                               render_factor=args.render_factor,
                               layout=layout)
        dt = time.perf_counter() - t0
        if not primary:
            logger.close()
            return state
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

    step_fn = build_loop_step(args, layout=layout)

    # prefetch pipelines; the numpy samplers restart from the seed on
    # resume, as in the JAX package; every rank assembles the global batch
    # and keeps its rows
    img_prefetch = Prefetcher(
        lambda: mesh.shard_batch(llff.batch(next(sampler)), layout, ga),
        device=device)
    ev_prefetch = None
    if args.use_events and args.add_event_egm:
        ev_sampler = RandomEventSampler(len(ev), args.events_N_rand,
                                        seed=args.seed)
        ev_iter = endless(lambda: iter(ev_sampler))
        ev_prefetch = Prefetcher(
            lambda: mesh.shard_batch(ev.batch(next(ev_iter)), layout, ga),
            device=device)

    # the occupancy coarse cull: the grid is built at the cull's start and
    # refreshed on its cadence; the gate decides at each refresh
    occ_grid = None
    occ_engaged = False

    N_iters = args.N_iters if max_iters is None else min(args.N_iters,
                                                         start + max_iters)
    # ref run_nerf.py:417: the flags set only the INITIAL value; the 10k
    # recomputes below hardcode 0.1/0.9 upstream (flag-dead end_ratio quirk)
    fine_loss_weight = args.kernel_awp_fine_loss_start_ratio
    trace = TraceWindow(args, expdir, device)

    try:
        for i in range(start, N_iters):
            is_last = i == N_iters - 1
            force_naive, events_active, fine_cull, coarse_cull = \
                step_gates(args, i)
            if coarse_cull and (occ_grid is None
                                or (i - args.coarse_cull_start_iter)
                                % args.occ_refresh_every == 0):
                occ_grid = build_occ_grid(model)
                occ_frac = float(occ_grid.mean())
                margin = args.occ_gate_margin
                occ_engaged = (margin <= 0.0 or expected_keep_fraction(
                    occ_frac, args.occ_probe_stride)
                    <= margin * args.coarse_cull_capacity)
                logger.scalars({"train/occ_frac": occ_frac,
                                "train/coarse_cull_active":
                                    float(occ_engaged)}, i)
            coarse_cull = coarse_cull and occ_engaged

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
            trace.before_step(i)
            with torch.profiler.record_function(STEP_RANGE):
                aux = step_fn(state, batch, ev_batch, sw, force_naive,
                              events_active, fine_cull=fine_cull,
                              coarse_cull=coarse_cull, occ_grid=occ_grid)
            trace.after_step(i, aux["loss"])

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
                # the rate step i took (on the card Adam reads a float32
                # copy of it from the device)
                scalars["train/lr"] = state.lr_schedule(i)
                logger.scalars(scalars, i)

            if (i % args.i_weights == 0 and i > 0) or is_last:
                # keyed by the post-update step count so resume continues
                # exactly where training left off
                # (sliced tables are gathered by every rank of their group)
                if layout.n_model > 1:
                    ckpt_dict = tp.checkpoint_dict(state, layout,
                                                   logger.wandb_id)
                    if primary:
                        ckpt.write(state.step, ckpt_dict)
                elif primary:
                    ckpt.save(state.step, state, wandb_id=logger.wandb_id)
                multihost.barrier()
            if (i % args.i_testset == 0 and i > 0) or is_last:
                run_test_renders(
                    args, llff, model, crf, device, i, logger, expdir,
                    skip_learn_crf=i < args.tone_mapping_start_learn_iter,
                    layout=layout)
                multihost.barrier()
            if i % args.i_video == 0 and i > 0:
                run_video_render(
                    args, llff, model, crf, device, i, logger,
                    skip_learn_crf=i < args.tone_mapping_start_learn_iter,
                    layout=layout)
    finally:
        trace.stop()
        img_prefetch.close()
        if ev_prefetch is not None:
            ev_prefetch.close()
        logger.close()

    return state
