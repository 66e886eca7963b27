"""Line-table gradient accumulation through kernel K6.

Counterpart of ``evdeblurnerf_tpu/ops/line_matmul.py::line_grad_matmul``:
the VJP of a row gather from a small line table is the reduction

    d_table[d, w] = sum_n [idx_n == d] * g[n, w],

which the TPU computes as a one-hot matmul on the MXU. On CUDA tensors
:func:`line_grad` launches the hand-written kernel of
``csrc/line_matmul.cu`` (a persistent grid, each block summing its points
into a whole-table tile in shared memory, then one device atomic per
nonzero entry); on CPU tensors it runs the plain twin.
:func:`line_grad_tables` reduces the three line tables of one sampler
backward in a single launch, with the ``pack_line`` VJP folded into the
kernel's flush.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .. import kernels


PRECISIONS = ("highest", "default")


def line_grad_plain(idx: torch.Tensor, g: torch.Tensor, D: int,
                    precision: str = "highest") -> torch.Tensor:
    """Plain version of K6: ``zeros(D, W).index_add_(0, idx, g)``, with a
    spare row that takes the indices outside [0, D) and is dropped; with
    ``precision="default"`` g is rounded to bf16 first."""
    if precision == "default":
        g = g.to(torch.bfloat16).float()
    idx = torch.where((idx >= 0) & (idx < D), idx, D).long()
    return torch.zeros(D + 1, g.shape[1], dtype=g.dtype,
                       device=g.device).index_add_(0, idx, g)[:D]


def pack_line_vjp(d_packed: torch.Tensor) -> torch.Tensor:
    """Gradient of ``ops/triplane.py::pack_line``: packed row d holds
    texels (d, d+1), so d_line[:, d] = d_packed[d, :C] + d_packed[d-1, C:].
    [D, 2C] -> [C, D]."""
    C = d_packed.shape[1] // 2
    d = d_packed[:, :C].clone()
    d[1:] += d_packed[:-1, C:]
    return d.T.contiguous()


def _check_table(name, idx, g, D):
    kernels.check_tensor(f"{name} idx", idx, torch.int32, 1)
    kernels.check_tensor(f"{name} g", g, torch.float32, 2)
    if idx.shape[0] != g.shape[0]:
        raise ValueError(f"{name}: {idx.shape[0]} indices for "
                         f"{g.shape[0]} rows of g")
    if D < 1 or g.shape[1] < 1:
        raise ValueError(f"{name}: D={D} rows of W={g.shape[1]} columns; "
                         "the kernel takes a table of at least 1 x 1")


def line_grad(idx: torch.Tensor, g: torch.Tensor, D: int,
              precision: str = "highest") -> torch.Tensor:
    """``[D, W]`` sums of the rows of g [N, W] f32 by their row index idx
    [N] int32; an index outside [0, D) adds nothing. ``precision``: the
    JAX kernel's two options (``evdeblurnerf_tpu/ops/line_matmul.py:19-23,
    49-53``), "highest" the exact f32 sums, "default" each element of g
    rounded to bf16 before the f32 accumulate; no model path takes
    "default". Kernel K6 on CUDA tensors, any D and W (a table above the
    kernel's shared-memory tile is split inside the launch; forward-only:
    raises if ``g`` requires grad), :func:`line_grad_plain` on CPU
    tensors."""
    if precision not in PRECISIONS:
        raise ValueError(f"line_grad: precision {precision!r}, expected one "
                         f"of {PRECISIONS}")
    if not kernels.wants_kernel(idx, g):
        return line_grad_plain(idx, g, D, precision)
    if torch.is_grad_enabled() and g.requires_grad:
        raise NotImplementedError("line_grad: K6 has no backward kernel")
    _check_table("line_grad", idx, g, D)
    out = torch.zeros(D, g.shape[1], dtype=torch.float32, device=g.device)
    kernels.launch("line_grad", g.device, idx.data_ptr(), g.data_ptr(),
                   out.data_ptr(), g.shape[0], D, g.shape[1],
                   int(precision == "default"))
    return out


def line_grad_tables_plain(idx: Sequence[torch.Tensor],
                           g: Sequence[torch.Tensor], Ds: Sequence[int]
                           ) -> list:
    """Plain version of :func:`line_grad_tables`: :func:`pack_line_vjp` of
    one :func:`line_grad_plain` per table."""
    return [pack_line_vjp(line_grad_plain(i, t, D))
            for i, t, D in zip(idx, g, Ds)]


def line_grad_tables(idx: Sequence[torch.Tensor], g: Sequence[torch.Tensor],
                     Ds: Sequence[int]) -> list:
    """The raw line gradients 3 x [C_i, D_i] of the three line tables of
    one sampler backward (behind the K5 kernels that leave the reduction
    to K6, ``ops/fused_sample.py``): idx 3 x [N] int32 the packed line row each point
    read, g 3 x [N, 2 C_i] f32 the per-point packed row cotangents (rows as
    ``ops/triplane.py::pack_line`` lays them out), Ds the three row
    counts. Equal to :func:`pack_line_vjp` of :func:`line_grad` per table.
    One launch of K6 on CUDA tensors, the pack VJP folded into its flush
    (forward-only), :func:`line_grad_tables_plain` on CPU tensors."""
    if not (len(idx) == len(g) == len(Ds) == 3):
        raise ValueError("line_grad_tables takes three tables")
    if not kernels.wants_kernel(*idx, *g):
        return line_grad_tables_plain(idx, g, Ds)
    if torch.is_grad_enabled() and any(t.requires_grad for t in g):
        raise NotImplementedError("line_grad_tables: K6 has no backward "
                                  "kernel")
    for i in range(3):
        _check_table(f"line_grad_tables[{i}]", idx[i], g[i], Ds[i])
    n = g[0].shape[0]
    if any(t.shape[0] != n for t in g):
        raise ValueError("line_grad_tables: the tables differ in N: "
                         f"{[t.shape[0] for t in g]}")
    Ws = [t.shape[1] for t in g]
    if any(W % 2 for W in Ws):
        raise ValueError("line_grad_tables: packed rows are [2C] wide, got "
                         f"widths {Ws}")
    # one buffer, so one memset; each gradient is a contiguous view of it
    sizes = [W // 2 * D for D, W in zip(Ds, Ws)]
    buf = torch.zeros(sum(sizes), dtype=torch.float32, device=g[0].device)
    out = [t.view(W // 2, D) for t, D, W in zip(buf.split(sizes), Ds, Ws)]
    kernels.launch("line_grad_tables", g[0].device,
                   *(t.data_ptr() for t in (*idx, *g, *out)), n,
                   *(v for D, W in zip(Ds, Ws) for v in (D, W)),
                   counter="line_grad")
    return out
