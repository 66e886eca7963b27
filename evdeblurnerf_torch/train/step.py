"""The training step: the loss ladder of the reference train loop, its
backward and the Adam update.

Counterpart of ``evdeblurnerf_tpu/train/step.py`` (ref: run_nerf.py:
423-613). The schedule gates arrive in :class:`ScheduleWeights`, as plain
Python floats and bools, or with the floats as views of one device tensor
(:func:`on_device`, the traced ``ScheduleWeights`` of the JAX step; the
captured step of ``train/capture.py`` reads them so); the unified loss is
the JAX package's:

    loss  = w_img * img_loss                       (ref :451-458)
    loss  = loss * cf + ff * awp_fine_loss         (ref :463-473)
    loss  = A * loss + B * pts0_loss               (ref :475-497)
    loss += TV * tv_w + align * w_align            (ref :499-504)
    loss += egm * w_egm                            (ref :507-591)

The two event renders of the reference (start and end of each event
window) run as one render of twice the batch, with ``force_naive``: no
blur kernel and no AWP there. ``grad_accum`` microbatches add their
gradients, which are then divided by their count; the AWP BatchNorm's
running statistics carry from one microbatch to the next. Only the
model's gradients are clipped, never the CRF's. After the optimizer step
the voxel fields repack their tables (``models/voxnerf.py``). Without an
importance pass (``N_importance 0``) there is no coarse render ``rgb1``:
its image, pts0 and EGM ``stage0`` terms drop out, and ``mode=nerf`` has
no TV term, as in the JAX step. The culls (``fine_cull``, and
``coarse_cull`` with the occupancy grid) reach every render of the step,
the event renders included.

Data parallelism (``parallel/mesh.py``, the ``layout`` of
:func:`build_train_step`): each rank renders its rows of the global batch
with the draws and the BatchNorm statistics of the global batch
(``mesh.ray_shard``), the gradients are averaged over the ray shards
before the norms and the clip, and the logged terms are the global
batch's. Tensor-parallel tables (``parallel/tp.py``) sum a table's
squared gradient over its slices for the norms and the clip.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from ..parallel import mesh, tp
from ..utils.events import egm_loss
from ..utils.misc import annealing_interpolator
from .optim import set_lr


def schedule_weights_fn(args, events_active: bool = True):
    """``i -> ScheduleWeights`` of the train loop (the JAX package's
    ``train/loop.py`` wiring): the EDI-prior and EGM weight schedules, the
    kernel start warmup, and the AWP blend at its start ratio."""
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
            args.kernel_start_iter)
    return lambda i: compute_schedule_weights(
        args, i, kernel_end_warmup_iter=kernel_end_warmup_iter,
        w_kernel=w_kernel, w_pts0_target=w_pts0_target,
        w_events_egm=w_events_egm,
        fine_loss_weight=args.kernel_awp_fine_loss_start_ratio,
        events_active=events_active)


def img2mse(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean((x - y) ** 2)


def mse2psnr(mse: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log10(torch.clamp_min(mse, 1e-10))


@dataclasses.dataclass(frozen=True)
class ScheduleWeights:
    """One step's schedule values; the defaults are the identity gates."""

    w_img: float = 1.0            # 1[i > blur_loss_after]
    loss_a: float = 1.0           # A in loss = A*loss + B*pts0
    w_pts0: float = 0.0           # B
    use_pts0_target: bool = False  # the pts0 loss targets the EDI prior
    cf: float = 1.0               # AWP blend of the base loss
    ff: float = 0.0               # AWP blend of the fine loss
    w_align: float = 0.0          # align weight inside its window, else 0
    w_egm: float = 0.0            # annealed EGM weight
    skip_learn_crf: bool = False  # the CRF is still the identity
    color_weight: Tuple[float, float, float] = (1.0, 1.0, 1.0)


# the float fields of ScheduleWeights in the order of their device tensor
# (on_device); color_weight's three values follow
SCHEDULE_FLOATS = ("w_img", "loss_a", "w_pts0", "cf", "ff", "w_align",
                   "w_egm")


def schedule_values(sw: ScheduleWeights) -> list:
    """The float fields of ``sw`` in the order of :func:`on_device`."""
    return ([float(getattr(sw, n)) for n in SCHEDULE_FLOATS]
            + [float(c) for c in sw.color_weight])


def on_device(sw: ScheduleWeights, values: torch.Tensor) -> ScheduleWeights:
    """``sw`` with each float field a 0-d view of ``values`` (float32,
    holding :func:`schedule_values` of a step) and ``color_weight`` a [3]
    view: a step that reads them reads whatever ``values`` holds when it
    runs. The two booleans stay Python values: they pick what the step
    computes, so the captured step keys its graphs by them."""
    n = len(SCHEDULE_FLOATS)
    return dataclasses.replace(
        sw, color_weight=values[n:n + 3],
        **{name: values[k] for k, name in enumerate(SCHEDULE_FLOATS)})


def compute_schedule_weights(args, i: int, *, kernel_end_warmup_iter: int,
                             w_kernel, w_pts0_target, w_events_egm,
                             fine_loss_weight: float,
                             events_active: bool) -> ScheduleWeights:
    """The reference's per-iteration gate ladder at the 0-based step ``i``
    (ref: run_nerf.py:437-504, 591), as the JAX function computes it."""
    use_pts0 = (args.use_pts0_prior is not None
                and args.pts0_target_start_iter <= i
                < args.pts0_target_end_iter)
    if args.kernel_use_awp and i >= args.kernel_start_iter:
        if args.kernel_awp_use_coarse_to_fine_opt:
            cf, ff = 1.0 - fine_loss_weight, fine_loss_weight
        else:
            cf, ff = 1.0, 1.0
    else:
        cf, ff = 1.0, 0.0
    pts0_active = ((args.kernel_start_warmup_mode != "step"
                    and args.kernel_start_iter <= i < kernel_end_warmup_iter)
                   or use_pts0)
    if pts0_active:
        if use_pts0:
            A = 1.0
            B = 1.0 if i <= args.blur_loss_after else w_pts0_target(i)
        else:
            A = w_kernel(i)
            B = 1.0 - A
    else:
        A, B = 1.0, 0.0
    w_align = (args.kernel_align_weight
               if args.align_start_iter <= i <= args.align_end_iter else 0.0)
    w_egm = float(w_events_egm(i) or 0.0) if events_active else 0.0
    color_weight = (1.0, 1.0, 1.0)
    if (args.event_egm_use_color_weights is not None
            and i > args.event_egm_color_weights_start_iter):
        color_weight = tuple(float(c)
                             for c in args.event_egm_use_color_weights)
    return ScheduleWeights(
        w_img=1.0 if i > args.blur_loss_after else 0.0,
        loss_a=float(A), w_pts0=float(B), use_pts0_target=bool(use_pts0),
        cf=float(cf), ff=float(ff), w_align=float(w_align),
        w_egm=float(w_egm),
        skip_learn_crf=i < args.tone_mapping_start_learn_iter,
        color_weight=color_weight)


def _microbatch(batch: Dict[str, torch.Tensor], k: int, accum: int):
    """The k-th of ``accum`` equal slices of every entry's first axis."""
    out = {}
    for name, v in batch.items():
        if v.shape[0] % accum:
            raise ValueError(f"grad_accum={accum} does not divide the "
                             f"{v.shape[0]} rows of {name!r}")
        m = v.shape[0] // accum
        out[name] = v[k * m:(k + 1) * m]
    return out


def build_train_step(args, return_grads: bool = False,
                     layout: mesh.Layout = mesh.Layout()):
    """Returns ``step(state, batch, ev_batch, sw, force_naive,
    events_active, fine_cull=False, coarse_cull=False, occ_grid=None) ->
    metrics``: one optimizer step of ``state`` (``train/state.py``) on a
    ray batch and, when ``events_active``, an event batch; ``occ_grid`` is
    read only with ``coarse_cull``. ``metrics`` holds detached tensors: ``loss`` (the mean
    over microbatches) and the ladder's terms of the last microbatch, the
    per-parameter gradient norms unless ``no_log_grads_norm``, and with
    ``return_grads`` the raw pre-clip gradients under ``grads``.

    ``layout``: the process layout (``parallel/mesh.py``); the batches
    are then this rank's rows (``mesh.shard_batch``), and the step is the
    one-process step on the global batch, its metrics the global ones.

    ``step.update`` is the step's device work alone (everything but the
    learning rate's setting, the tables' repack and the host's step
    count), which ``train/capture.py`` captures."""
    tv_weight = float(args.kernel_tv_loss_weight)
    thresh_neg = float(args.events_threshold_neg
                       if args.events_threshold_neg is not None
                       else args.events_threshold)
    thresh_pos = float(args.events_threshold_pos
                       if args.events_threshold_pos is not None
                       else args.events_threshold)
    egm_stages = tuple(args.add_event_egm_stages or ())
    if (getattr(args, "add_event_egm", False) and "stage1" not in egm_stages
            and args.N_importance <= 0):
        # 'stage0' supervises the coarse render of the two-pass render,
        # which does not exist with N_importance=0; the reference is as
        # silent here (run_nerf.py:560-564), the JAX step says it
        print("WARNING: --add_event_egm with stages", list(egm_stages),
              "and N_importance=0: no stage matches, the event loss will be "
              "identically zero (add 'stage1' or N_importance>0)")
    add_bii = args.tone_mapping_events_add_bii
    color_events = bool(args.event_egm_use_colorevents)
    clip_norm = args.clip_grads_norm
    accum = max(1, int(getattr(args, "grad_accum", 1) or 1))
    egm_total = mesh.shard_total(layout)

    def ev_extra_feat(ev_batch):
        """CRF conditioning from the BII cumsums (ref: run_nerf.py:521-532)."""
        neg = ev_batch["events_neg_pol_cumsum"]
        pos = ev_batch["events_pos_pol_cumsum"]
        if add_bii == "pos-neg":
            return torch.stack([neg, pos], -1)
        if add_bii == "color-pos-neg":
            cmask = ev_batch["events_color_map"].bool()
            zero = torch.zeros((), dtype=neg.dtype, device=neg.device)
            return torch.stack([torch.where(cmask, neg[:, None], zero),
                                torch.where(cmask, pos[:, None], zero)], -1)
        return None

    def loss_fn(state, batch, ev_batch, sw: ScheduleWeights,
                force_naive: bool, events_active: bool, culls):
        model, crf, gen = state.model, state.crf, state.generator
        aux: Dict[str, torch.Tensor] = {}

        def enc(x):
            return crf.encode_rgb(x, skip_learn_crf=sw.skip_learn_crf)

        # rays_x, rays_y and poses feed the DSK and PBE kernels only
        rays_info = None if force_naive else {
            k: batch[k] for k in ("images_idx", "rays_x", "rays_y", "poses")
            if k in batch}
        with mesh.ray_shard(layout):
            rgb, rgb1, extra_loss, extra_tensor = model.train_forward(
                batch["rays"], rays_info, force_naive, return_pts0_rgb=True,
                generator=gen, **culls)
        target = batch["rgbsf"]
        rgb_e = enc(rgb)
        img_loss = img2mse(rgb_e, target)
        if rgb1 is not None:
            img_loss = img_loss + img2mse(enc(rgb1), target)
        aux["img_loss"] = img_loss
        # the PSNR of the global batch is taken from the global MSE
        aux["_mse"] = img2mse(rgb_e, target)
        aux["psnr"] = mse2psnr(aux["_mse"])
        loss = sw.w_img * img_loss

        if "rgb_awp" in extra_tensor:
            fine_loss = img2mse(enc(extra_tensor["rgb_awp"]), target)
            aux["awp_fine_loss"] = fine_loss
            loss = loss * sw.cf + fine_loss * sw.ff

        pts0_target = target
        if "rgbsf_pts0" in batch and sw.use_pts0_target:
            pts0_target = batch["rgbsf_pts0"]
        pts0_loss = torch.zeros((), device=target.device)
        for name in ("stage0_rgb_pts0", "stage1_rgb_pts0",
                     "stage1_rgb1_pts0"):
            if name in extra_tensor:
                pts0_loss = pts0_loss + img2mse(enc(extra_tensor[name]),
                                                pts0_target)
        aux["pts0_loss"] = pts0_loss
        # reference-literal: the PSNR of a SUM of up to three MSE terms,
        # what the reference prints while i <= blur_loss_after (ref:
        # run_nerf.py:488-489)
        aux["pts0_psnr"] = mse2psnr(pts0_loss)
        loss = sw.loss_a * loss + sw.w_pts0 * pts0_loss

        if "TV" in extra_loss:
            aux["tv_loss"] = torch.mean(extra_loss["TV"])
            loss = loss + aux["tv_loss"] * tv_weight
        if "align" in extra_loss:
            aux["align_loss"] = torch.mean(extra_loss["align"])
            loss = loss + aux["align_loss"] * sw.w_align

        if events_active:
            neg = ev_batch["events_neg_pol_cumsum"]
            pos = ev_batch["events_pos_pol_cumsum"]
            bii = thresh_neg * neg + thresh_pos * pos      # (ref :518-519)
            feat = ev_extra_feat(ev_batch)
            cmask = (ev_batch["events_color_map"].float() if color_events
                     else None)
            ev_rays = torch.cat([ev_batch["events_rays_start"],
                                 ev_batch["events_rays_end"]], 0)
            # the start rays' shard, then the end rays'
            with mesh.ray_shard(layout, segments=2):
                rgb_se, rgb1_se, _, _ = model.train_forward(
                    ev_rays, None, True, generator=gen, with_tv=False,
                    **culls)
            s_rgb, e_rgb = rgb_se.chunk(2)
            s_rgb1, e_rgb1 = ((None, None) if rgb1_se is None
                              else rgb1_se.chunk(2))

            def luma(x):
                return crf.encode_luma(x, tonemap_only=color_events,
                                       skip_learn_crf=sw.skip_learn_crf,
                                       ev_extra_feat=feat)

            egm = torch.zeros((), device=target.device)
            if "stage0" in egm_stages and s_rgb1 is not None:
                egm = egm + egm_loss(luma(s_rgb1), luma(e_rgb1), bii,
                                     color_mask=cmask,
                                     color_weight=sw.color_weight,
                                     weight_total=egm_total)
            if "stage1" in egm_stages:
                egm = egm + egm_loss(luma(s_rgb), luma(e_rgb), bii,
                                     color_mask=cmask,
                                     color_weight=sw.color_weight,
                                     weight_total=egm_total)
            aux["event_egm"] = egm
            loss = loss + egm * sw.w_egm
        aux["loss"] = loss
        return loss, aux

    def update(state, batch, ev_batch, sw: ScheduleWeights,
               force_naive: bool, events_active: bool,
               fine_cull: bool = False, coarse_cull: bool = False,
               occ_grid=None):
        """Forward and backward over the microbatches, the gradient norms,
        the clip and the Adam step at the rate already set, all of it work
        on the device: no host read, no host-side count. The step of
        :func:`build_train_step` and the captured step
        (``train/capture.py``) both run it."""
        model, crf = state.model, state.crf
        culls = dict(fine_cull=fine_cull, coarse_cull=coarse_cull,
                     occ_grid=occ_grid if coarse_cull else None)
        model.train()
        crf.train()
        named = [(n, p) for n, p in model.named_parameters()] + [
            (f"crf.{n}", p) for n, p in crf.named_parameters()]
        loss_sum = 0.0
        for k in range(accum):
            b = batch if accum == 1 else _microbatch(batch, k, accum)
            e = ev_batch
            if events_active and accum > 1:
                e = _microbatch(ev_batch, k, accum)
            loss, aux = loss_fn(state, b, e, sw, force_naive, events_active,
                                culls)
            loss.backward()
            loss_sum = loss_sum + loss.detach()
        live = [(n, p) for n, p in named if p.grad is not None]
        grads = [(n, p.grad) for n, p in live]
        if accum > 1:
            for _, g in grads:
                g.div_(accum)
        mesh.all_reduce_gradients([p for _, p in live], layout)
        # the tables' component slices: their norms sum over the slices
        sliced = [n for n, p in live if getattr(p, "tp_kind", "") == "slice"]
        aux = {k: v.detach() for k, v in aux.items()}
        aux["loss"] = loss_sum / accum
        aux = mesh.mean_scalars(aux, layout)
        mse = aux.pop("_mse")
        if layout.n_data > 1:
            aux["psnr"] = mse2psnr(mse)
            aux["pts0_psnr"] = mse2psnr(aux["pts0_loss"])
        if not getattr(args, "no_log_grads_norm", False):
            norms = {n: torch.linalg.vector_norm(g) for n, g in grads}
            if sliced:
                sq = tp.model_sum([norms[n] ** 2 for n in sliced], layout)
                norms.update(zip(sliced, map(torch.sqrt, sq)))
            aux.update({f"grads/{n}": v for n, v in norms.items()})
            aux["grads/total"] = torch.sqrt(sum(v * v for v in
                                                norms.values()))
        if return_grads:
            aux["grads"] = {n: g.clone() for n, g in grads}
        if clip_norm is not None:
            # clip only the model's gradients (ref: run_nerf.py:596-599)
            nerf = [(n, g) for n, g in grads if not n.startswith("crf.")]
            sq = {n: torch.sum(g * g) for n, g in nerf}
            if sliced:
                sq.update(zip(sliced, tp.model_sum([sq[n] for n in sliced],
                                                   layout)))
            nerf = [g for _, g in nerf]
            gnorm = torch.sqrt(sum(sq.values()))
            scale = torch.clamp_max(clip_norm / (gnorm + 1e-6), 1.0)
            for g in nerf:
                g.mul_(scale)
            aux["grad_norm"] = gnorm
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        return aux

    def step(state, batch, ev_batch, sw: ScheduleWeights, force_naive: bool,
             events_active: bool, fine_cull: bool = False,
             coarse_cull: bool = False, occ_grid=None):
        set_lr(state.optimizer, state.lr_schedule(state.step))
        aux = update(state, batch, ev_batch, sw, force_naive, events_active,
                     fine_cull, coarse_cull, occ_grid)
        state.model.refresh_tables()
        state.step += 1
        return aux

    step.update = update
    return step
