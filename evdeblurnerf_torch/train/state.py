"""Train state: the model, the CRF, their optimizer, the step count and
the random stream.

Counterpart of ``evdeblurnerf_tpu/train/state.py``. The JAX package keeps
one parameter pytree and an optax state; here the modules own their
parameters (and the AWP BatchNorm its running statistics), and one Adam
covers the model and the CRF, as in the reference (ref:
run_nerf.py:242-274).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch import nn

from ..models.renderer import config_from_args
from ..models.system import EvDeblurNeRF, kernel_config_from_args
from ..models.tonemapping import TonemappingTransform, crf_init_identity
from .optim import build_optimizer, lr_schedule


@dataclasses.dataclass
class TrainState:
    model: nn.Module                   # models/system.py::EvDeblurNeRF
    crf: nn.Module                     # TonemappingTransform
    optimizer: torch.optim.Optimizer
    lr_schedule: Callable[[int], float]
    generator: torch.Generator         # every random draw of the step
    step: int = 0


def build_model(args, aabb, H: int, W: int, focal: float, near: float,
                far: float, num_images: int,
                generator: torch.Generator | None = None, device=None,
                K=None):
    """The model and its CRF from flags and the scene's geometry
    (counterpart of the model construction in
    ``evdeblurnerf_tpu/train/loop.py``). ``K``: the scene's [3, 3]
    intrinsics for the DSK/PBE kernels (default: the centred pinhole of H,
    W, focal). Weights are drawn from ``generator``."""
    model = EvDeblurNeRF(config_from_args(args, aabb, H, W, focal, near, far),
                         kernel_config_from_args(args), num_images,
                         generator=generator, device=device, K=K)
    return model, build_crf(args, generator, device)


def build_crf(args, generator: torch.Generator | None = None, device=None):
    """The CRF of the flags, its weights drawn from ``generator``."""
    return TonemappingTransform(
        map_type_rgb=args.tone_mapping_type,
        map_type_event=args.tone_mapping_events_type,
        gamma=args.tone_mapping_gamma,
        extra_features_event=(0 if args.tone_mapping_events_add_bii == "none"
                              else 2),
        generator=generator, device=device)


def create_train_state(model: nn.Module, crf: nn.Module, args,
                       generator: torch.Generator,
                       crf_identity_prefit: bool | None = None,
                       crf_prefit_steps: int = 3000) -> TrainState:
    """Adam over the model and the CRF with the reference's LR rule and
    weight-decay group; with ``crf_identity_prefit`` (default: the
    ``tone_mapping_learn_init_identity`` flag) every learned CRF head is
    first fitted to the identity (ref: tonemapping.py:29-57)."""
    if crf_identity_prefit is None:
        crf_identity_prefit = bool(args.tone_mapping_learn_init_identity)
    if crf_identity_prefit:
        for head in (crf.tonemapping_rgb, crf.tonemapping_event):
            crf_init_identity(head, steps=crf_prefit_steps,
                              generator=generator)
    named = list(model.named_parameters()) + [
        (f"crf.{n}", p) for n, p in crf.named_parameters()]
    optimizer = build_optimizer(named, args.lrate, args.colornet_weightdecay)
    schedule = lr_schedule(args.lrate, args.lrate_decay,
                           args.lrate_warmup_iters, args.lrate_warmup_factor)
    return TrainState(model, crf, optimizer, schedule, generator)
