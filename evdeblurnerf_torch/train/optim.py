"""Adam with the reference's parameter groups and learning-rate rule.

Counterpart of ``evdeblurnerf_tpu/train/optim.py`` (ref:
run_nerf.py:243-274, 603-613): ``torch.optim.Adam(betas=(0.9, 0.999),
eps=1e-8)`` over the model and the CRF, with L2 weight decay (added to the
gradient before the moments, torch's coupled form) on the colour-net
weights only, and the warmup-then-exponential LR rule set before every
step.

torch's own per-parameter lazy state is the reference's: a parameter's
Adam state, and so its bias-correction count, starts at the first step
where its ``.grad`` is not None. The JAX package's ``scale_by_adam_lazy``
emulates exactly this. So gradients are zeroed with ``set_to_none=True``:
a parameter group outside the graph (the learned CRF before its learn
start, the blur kernel before the kernel start) must keep ``grad=None``, or
its first real step would take a later bias correction.

On the card Adam is ``capturable``: its step counts live on the device and
each group's learning rate is a device scalar that :func:`set_lr` fills
before the step, so a CUDA graph of the step (``train/capture.py``) reads
the rate and the counts of each replay. Lazy state is still torch's, made
inside ``step()``: a graph captured before a parameter's first gradient
would re-zero its moments at every replay, so a step is captured only
after the same step ran once eagerly. On the CPU Adam is torch's default
with a float rate.
"""

from __future__ import annotations

import re
from typing import Iterable

import torch

_COLORNET_WEIGHT = re.compile(r"\.color_net\.[0-9]+\.weight$")


def lr_schedule(lrate: float, lrate_decay: int, warmup_iters: float = -1,
                warmup_factor: float = 0.1):
    """step -> learning rate (ref: run_nerf.py:603-613): linear warmup
    from ``lrate * warmup_factor`` over ``warmup_iters`` steps, then
    ``lrate * 0.1 ** (step / (lrate_decay * 1000))``."""
    decay_steps = lrate_decay * 1000

    def schedule(step: int) -> float:
        if warmup_iters and warmup_iters > 0 and step < warmup_iters:
            return lrate * ((1 - warmup_factor) * step / warmup_iters
                            + warmup_factor)
        return lrate * 0.1 ** (step / decay_steps)

    return schedule


def build_optimizer(named_params: Iterable, lrate: float,
                    colornet_weightdecay=None) -> torch.optim.Adam:
    """Adam over ``named_params`` ((name, parameter) pairs, e.g. the
    model's and the CRF's ``named_parameters()``); with
    ``colornet_weightdecay`` the ``*.color_net.<i>.weight`` parameters form
    their own group with that L2 decay (ref: run_nerf.py:244-247)."""
    decay, rest = [], []
    for name, p in named_params:
        (decay if colornet_weightdecay and _COLORNET_WEIGHT.search(
            "." + name) else rest).append(p)
    groups = [{"params": rest, "weight_decay": 0.0}]
    if decay:
        groups.append({"params": decay,
                       "weight_decay": float(colornet_weightdecay)})
    device = rest[0].device if rest else decay[0].device
    on_card = device.type == "cuda"
    optimizer = torch.optim.Adam(groups, lr=lrate, betas=(0.9, 0.999),
                                 eps=1e-8, capturable=on_card)
    if on_card:
        for group in optimizer.param_groups:
            group["lr"] = torch.tensor(float(lrate), device=device)
    return optimizer


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Every group's learning rate to ``lr``: a device scalar is filled in
    place (on its stream, before the step that reads it)."""
    for group in optimizer.param_groups:
        if torch.is_tensor(group["lr"]):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


def load_optimizer_state(optimizer: torch.optim.Optimizer,
                         saved: dict) -> None:
    """``optimizer.load_state_dict(saved)`` keeping this process's
    ``capturable`` setting and device learning rates, whatever device the
    state was saved from: torch then puts the step counts where this
    optimizer keeps them (on the card for a capturable Adam)."""
    lrs = [group["lr"] for group in optimizer.param_groups]
    groups = [dict(s, capturable=g["capturable"])
              for s, g in zip(saved["param_groups"], optimizer.param_groups)]
    optimizer.load_state_dict(dict(saved, param_groups=groups))
    for group, lr in zip(optimizer.param_groups, lrs):
        if torch.is_tensor(lr):
            lr.fill_(float(group["lr"]))
            group["lr"] = lr
