"""Line-table gradient accumulation through kernel K6.

Counterpart of ``evdeblurnerf_tpu/ops/line_matmul.py::line_grad_matmul``:
the VJP of a row gather from a small line table is the reduction

    d_table[d, w] = sum_n [idx_n == d] * g[n, w],

which the TPU computes as a one-hot matmul on the MXU. On CUDA tensors
:func:`line_grad` launches the hand-written kernel of
``csrc/line_matmul.cu`` (block-local shared-memory sums, then one device
atomic per entry and block); on CPU tensors it runs the plain twin.
"""

from __future__ import annotations

import torch

from .. import kernels


def line_grad_plain(idx: torch.Tensor, g: torch.Tensor, D: int
                    ) -> torch.Tensor:
    """Plain version of K6: ``zeros(D, W).index_add_(0, idx, g)``."""
    return torch.zeros(D, g.shape[1], dtype=g.dtype,
                       device=g.device).index_add_(0, idx.long(), g)


def line_grad(idx: torch.Tensor, g: torch.Tensor, D: int) -> torch.Tensor:
    """``[D, W]`` sums of the rows of g [N, W] f32 by their row index idx
    [N] int32 in [0, D). Kernel K6 on CUDA tensors (forward-only: raises
    if ``g`` requires grad), :func:`line_grad_plain` on CPU tensors."""
    if not kernels.wants_kernel(idx, g):
        return line_grad_plain(idx, g, D)
    if torch.is_grad_enabled() and g.requires_grad:
        raise NotImplementedError("line_grad: K6 has no backward kernel")
    kernels.check_tensor("line_grad idx", idx, torch.int32, 1)
    kernels.check_tensor("line_grad g", g, torch.float32, 2)
    if idx.shape[0] != g.shape[0]:
        raise ValueError(f"line_grad: {idx.shape[0]} indices for "
                         f"{g.shape[0]} rows of g")
    if not 0 < D <= 12288:
        raise ValueError(f"line_grad: D={D} rows; the kernel takes 1..12288 "
                         "(one column of the table must fit its 48 KiB tile)")
    out = torch.zeros(D, g.shape[1], dtype=torch.float32, device=g.device)
    kernels.launch("line_grad", g.device, idx.data_ptr(), g.data_ptr(),
                   out.data_ptr(), g.shape[0], D, g.shape[1])
    return out
