"""Tri-plane feature sampling through kernel K4 (forward).

Counterpart of ``evdeblurnerf_tpu/ops/fused_sample.py``: the whole
per-point interpolation — texel coordinates, clipped base indices, slot
weights with zeros-padding validity, the 4-slot plane and 2-slot line
sums and plane x line — in one pass. Unlike the Pallas kernel, which
receives rows gathered by six XLA takes, the Hopper kernel
(``csrc/fused_sample.cu``) gathers its own rows from the packed tables.

Semantics are those of ``ops/triplane.py::triplane_features_packed``,
which is the plain twin this wrapper runs for CPU tensors. The backward
(K5) comes with training.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .. import kernels
from .triplane import triplane_features_packed


def triplane_features(packed_planes: Sequence[torch.Tensor],
                      packed_lines: Sequence[torch.Tensor],
                      sizes: Sequence[Tuple[int, int, int]],
                      xyz: torch.Tensor) -> torch.Tensor:
    """Factored features [N, sum(C_i)] f32 at normalised points xyz [N, 3].

    ``packed_planes[i]`` [H_i*W_i, 4C_i] and ``packed_lines[i]``
    [D_i, 2C_i] come from ``ops/triplane.py::pack_grids``, with
    ``sizes[i] = (H_i, W_i, D_i)``. Kernel K4 on CUDA tensors,
    :func:`..ops.triplane.triplane_features_packed` on CPU tensors.
    """
    tables = (*packed_planes, *packed_lines)
    if not kernels.wants_kernel(xyz, *tables):
        return triplane_features_packed(packed_planes, packed_lines, sizes,
                                        xyz)
    if xyz.requires_grad or any(t.requires_grad for t in tables):
        raise NotImplementedError(
            "triplane_features: the K5 backward kernel comes with training "
            "(ROADMAP queue 2, K5)")
    kernels.check_tensor("triplane_features xyz", xyz, torch.float32, 2)
    if xyz.shape[1] != 3:
        raise ValueError(f"triplane_features: xyz must be [N, 3], got "
                         f"{tuple(xyz.shape)}")
    dims = []
    for i in range(3):
        H, W, D = sizes[i]
        plane, line = packed_planes[i], packed_lines[i]
        kernels.check_tensor(f"triplane_features plane {i}", plane,
                             torch.float32, 2)
        kernels.check_tensor(f"triplane_features line {i}", line,
                             torch.float32, 2)
        C = line.shape[1] // 2
        if (min(H, W, D) < 2 or plane.shape != (H * W, 4 * C)
                or line.shape != (D, 2 * C)):
            raise ValueError(
                f"triplane_features: projection {i} has sizes {(H, W, D)}, "
                f"plane {tuple(plane.shape)}, line {tuple(line.shape)}; "
                "expected plane [H*W, 4C], line [D, 2C], every size >= 2")
        dims += [H, W, D, C]
    ctot = sum(dims[3::4])
    out = torch.empty((xyz.shape[0], ctot), dtype=torch.float32,
                      device=xyz.device)
    kernels.launch("triplane_features", xyz.device, xyz.data_ptr(),
                   *(t.data_ptr() for t in tables), out.data_ptr(),
                   xyz.shape[0], *dims)
    return out
