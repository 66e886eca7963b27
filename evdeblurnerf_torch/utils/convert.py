"""The weight bridge: JAX package variables -> the port's state dict.

``state_dict_from_jax`` maps the renderer part of the JAX package's
variables (a nested dict of numpy arrays, ``{'params': {'renderer':
{'mlp_coarse': ..., 'mlp_fine': ...}}}``) to the reference-layout
``network_state_dict`` entries the port loads strictly. It mirrors the
field rules of ``evdeblurnerf_tpu/utils/checkpoint_convert.py::
export_network_state_dict`` without importing jax: Dense kernels [in, out]
are transposed to Linear weights [out, in], planes gain a leading batch
axis ([1, C, H, W]) and lines a batch and a width axis ([1, C, D, 1]).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_GRID = re.compile(r"^app_(plane|line)_(\d)$")
_LAYER = re.compile(r"^(basis_mat|sigma_net|color_net)(?:_(\d+))?$")


def state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """``mlp_coarse.*`` / ``mlp_fine.*`` tensors (f32, CPU) from the JAX
    renderer variables. Accepts the whole model's variables or the
    renderer's own ``{'params': {'mlp_coarse': ..., ...}}``; raises on a
    renderer leaf it cannot place."""
    params = variables["params"]
    renderer = params.get("renderer", params)
    sd: Dict[str, torch.Tensor] = {}
    unmapped = []
    for stage in ("mlp_coarse", "mlp_fine"):
        for name, leaf in renderer[stage].items():
            m = _GRID.match(name)
            if m:
                kind, i = m.groups()
                v = np.array(leaf, np.float32)
                v = v[None] if kind == "plane" else v[None, :, :, None]
                sd[f"{stage}.app_{kind}.{i}"] = torch.from_numpy(
                    np.ascontiguousarray(v))
                continue
            m = _LAYER.match(name)
            if m and isinstance(leaf, Mapping):
                mod, idx = m.groups()
                prefix = f"{stage}.{mod}" + (f".{idx}" if idx else "")
                for kb, v in leaf.items():
                    v = np.array(v, np.float32)
                    if kb == "kernel":
                        sd[f"{prefix}.weight"] = torch.from_numpy(
                            np.ascontiguousarray(v.T))
                    elif kb == "bias":
                        sd[f"{prefix}.bias"] = torch.from_numpy(v)
                    else:
                        unmapped.append(f"{stage}/{name}/{kb}")
                continue
            unmapped.append(f"{stage}/{name}")
    if unmapped:
        raise ValueError(f"cannot map renderer leaves: {sorted(unmapped)}")
    return sd
