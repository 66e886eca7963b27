"""Checkpoint save / auto-resume in the reference's ``*.tar`` layout.

Counterpart of ``evdeblurnerf_tpu/train/checkpoint.py`` (orbax there). A
checkpoint is one ``torch.save`` file ``{step:06d}.tar`` holding the
reference's dictionary (ref: run_nerf.py:617-638)

    {global_step, network_state_dict, crf_state_dict,
     optimizer_state_dict, wandb_id}

plus ``generator_state`` / ``generator_device``, the state of the train
state's ``torch.Generator``: a resumed run then draws what the
uninterrupted run would have drawn. ``network_state_dict`` is the model's
``state_dict()``: the reference's names, with the AWP BatchNorm's running
statistics. So a port checkpoint loads through
``serving.load_network_state_dict`` / ``build_renderer`` and converts into
the JAX package through ``tools/convert_reference_checkpoint.py``, which
ignore the extra keys.

Semantics as in the reference (ref: run_nerf.py:276-297): periodic saves
keyed by the post-update step, every one kept, newest-step auto-resume
restoring parameters, buffers, the optimizer's moments and step counts and
the step (which fixes the learning rate). A parameter that had no Adam
state yet when the checkpoint was written (the blur kernel before the
kernel start, the learned CRF before its learn start) comes back with
none, so its bias correction still starts at its first gradient.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch

from .optim import load_optimizer_state

_NAME = re.compile(r"^(\d+)\.tar$")


def checkpoint_dict(state, wandb_id: Optional[str] = None) -> dict:
    """The checkpoint of a ``TrainState``, every tensor copied to the CPU."""
    return {
        "global_step": int(state.step),
        "network_state_dict": _to_cpu(dict(state.model.state_dict())),
        "crf_state_dict": _to_cpu(dict(state.crf.state_dict())),
        "optimizer_state_dict": optimizer_state_dict(state.optimizer),
        "wandb_id": wandb_id,
        "generator_state": state.generator.get_state().clone(),
        "generator_device": state.generator.device.type,
    }


def optimizer_state_dict(optimizer) -> dict:
    """The optimizer's state as the reference stores it: tensors on the
    CPU (a capturable Adam's step counts come off the card) and each
    group's learning rate a float (a device scalar on the card)."""
    sd = _to_cpu(optimizer.state_dict())
    for group in sd["param_groups"]:
        if torch.is_tensor(group["lr"]):
            group["lr"] = float(group["lr"])
    return sd


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def load_into_state(ckpt: dict, state) -> int:
    """Restore a checkpoint dictionary into ``state`` in place (strictly:
    every name must match); returns the restored step."""
    state.model.load_state_dict(ckpt["network_state_dict"], strict=True)
    state.crf.load_state_dict(ckpt.get("crf_state_dict", {}), strict=True)
    if ckpt.get("optimizer_state_dict") is not None:
        load_optimizer_state(state.optimizer, ckpt["optimizer_state_dict"])
    gen_state = ckpt.get("generator_state")
    if gen_state is not None:
        if ckpt.get("generator_device") == state.generator.device.type:
            state.generator.set_state(gen_state)
        else:
            # a CPU and a CUDA generator have different states: the run
            # goes on from this process's seed
            print(f"[checkpoint] random stream not restored: saved on "
                  f"{ckpt.get('generator_device')}, resuming on "
                  f"{state.generator.device.type}")
    state.step = int(ckpt["global_step"])
    return state.step


class CheckpointManager:
    """``{step:06d}.tar`` files in ``directory``; ``directory`` may also
    name one ``*.tar`` file (``--ft_path`` as the reference takes it): it
    is then the checkpoint to restore, and saves go beside it."""

    def __init__(self, directory: str):
        directory = os.path.abspath(directory)
        self._file = directory if os.path.isfile(directory) else None
        self.directory = (os.path.dirname(directory) if self._file
                          else directory)
        os.makedirs(self.directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"{int(step):06d}.tar")

    def steps(self):
        found = (_NAME.match(f) for f in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def latest_path(self) -> Optional[str]:
        if self._file:
            return self._file
        step = self.latest_step()
        return None if step is None else self.path(step)

    def save(self, step: int, state, wandb_id: Optional[str] = None) -> str:
        """Write the checkpoint of ``step``; the file appears under its
        name only when it is complete. A file of that step left by an
        earlier run (``--no_reload`` into a used directory) is replaced, so
        the next auto-resume finds this run's weights."""
        return self.write(step, checkpoint_dict(state, wandb_id))

    def write(self, step: int, ckpt: dict) -> str:
        """Write a checkpoint dictionary made elsewhere (the gathered one
        of sliced tables, ``parallel/tp.py::checkpoint_dict``) as
        :meth:`save` writes its own."""
        path = self.path(step)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(ckpt, tmp)
        os.replace(tmp, path)
        return path

    def restore_latest(self, state) -> Optional[int]:
        """Restore the newest checkpoint into ``state``; returns its step,
        or None when there is no checkpoint."""
        path = self.latest_path()
        if path is None:
            return None
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        return load_into_state(ckpt, state)
