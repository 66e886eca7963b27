"""Tri-plane feature sampling through kernels K4 (forward) and K5
(backward).

Counterpart of ``evdeblurnerf_tpu/ops/fused_sample.py``: the whole
per-point interpolation — texel coordinates, clipped base indices, slot
weights with zeros-padding validity, the 4-slot plane and 2-slot line
sums and plane x line — in one pass. Unlike the Pallas kernels, which
receive rows gathered by six XLA takes, the Hopper kernels
(``csrc/fused_sample.cu``) gather their own rows from the packed tables,
and K5 adds the plane gradients straight into the raw grids' layout.

:func:`sample_grids` is the differentiable entry point: one
``torch.autograd.Function`` whose inputs are xyz and the RAW grids, so
autograd owns their gradients, while its forward reads the packed tables.
Its forward is :func:`triplane_features` (K4; plain twin
``ops/triplane.py::triplane_features_packed``), its backward
:func:`triplane_features_bwd` (K5, with K6 for the line tables; plain
twin: autograd through ``pack_grids`` and the packed sampler).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .. import kernels
from .line_matmul import line_grad
from .triplane import VEC_MODE, pack_grids, triplane_features_packed


def _check_tables(name, packed_planes, packed_lines, sizes, xyz):
    """Raise unless the tables and points are what K4/K5 read; returns the
    (H, W, D, C) x 3 sizes the kernels take."""
    kernels.check_tensor(f"{name} xyz", xyz, torch.float32, 2)
    if xyz.shape[1] != 3:
        raise ValueError(f"{name}: xyz must be [N, 3], got "
                         f"{tuple(xyz.shape)}")
    dims = []
    for i in range(3):
        H, W, D = sizes[i]
        plane, line = packed_planes[i], packed_lines[i]
        kernels.check_tensor(f"{name} plane {i}", plane, torch.float32, 2)
        kernels.check_tensor(f"{name} line {i}", line, torch.float32, 2)
        C = line.shape[1] // 2
        if (min(H, W, D) < 2 or plane.shape != (H * W, 4 * C)
                or line.shape != (D, 2 * C)):
            raise ValueError(
                f"{name}: projection {i} has sizes {(H, W, D)}, "
                f"plane {tuple(plane.shape)}, line {tuple(line.shape)}; "
                "expected plane [H*W, 4C], line [D, 2C], every size >= 2")
        dims += [H, W, D, C]
    return dims


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
    if torch.is_grad_enabled() and (xyz.requires_grad or any(
            t.requires_grad for t in tables)):
        raise NotImplementedError(
            "triplane_features: K4 is the forward; differentiate through "
            "sample_grids, whose backward is K5")
    dims = _check_tables("triplane_features", packed_planes, packed_lines,
                         sizes, xyz)
    ctot = sum(dims[3::4])
    out = torch.empty((xyz.shape[0], ctot), dtype=torch.float32,
                      device=xyz.device)
    kernels.launch("triplane_features", xyz.device, xyz.data_ptr(),
                   *(t.data_ptr() for t in tables), out.data_ptr(),
                   xyz.shape[0], *dims)
    return out


def line_base_index(xyz: torch.Tensor, sizes) -> list:
    """The packed line row [N] int32 each point reads, per projection:
    ``clip(floor((x + 1) * 0.5 * (D - 1)), 0, D - 2)``, rounded where K4,
    K5 and ``ops/triplane.py::_slot_weights`` round."""
    out = []
    for i in range(3):
        D = sizes[i][2]
        f = (xyz[:, VEC_MODE[i]] + 1.0) * 0.5 * (D - 1)
        out.append(torch.clamp(torch.floor(f), 0, D - 2).int())
    return out


def pack_line_vjp(d_packed: torch.Tensor) -> torch.Tensor:
    """Gradient of ``ops/triplane.py::pack_line``: packed row d holds
    texels (d, d+1), so d_line[:, d] = d_packed[d, :C] + d_packed[d-1, C:].
    [D, 2C] -> [C, D]."""
    C = d_packed.shape[1] // 2
    d = d_packed[:, :C].clone()
    d[1:] += d_packed[:-1, C:]
    return d.T.contiguous()


def triplane_features_bwd_plain(planes, lines, xyz, g):
    """Plain version of K5 (with K6): autograd through ``pack_grids`` and
    the packed sampler. planes 3 x [C, H, W], lines 3 x [C, D], xyz [N, 3],
    g [N, sum(C)]; returns (d_planes, d_lines, d_xyz) in those layouts."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (*planes, *lines, xyz)]
        pp, pl, sizes = pack_grids(leaves[:3], leaves[3:6])
        out = triplane_features_packed(pp, pl, sizes, leaves[6])
        grads = torch.autograd.grad(out, leaves, g)
    return list(grads[:3]), list(grads[3:6]), grads[6]


def triplane_features_bwd(planes, lines, packed, xyz, g):
    """Gradients of the sampled features [N, sum(C)] given their cotangent
    g: (d_planes 3 x [C, H, W], d_lines 3 x [C, D], d_xyz [N, 3]).

    ``planes``/``lines`` are the raw grids and ``packed`` = (packed_planes,
    packed_lines, sizes) the tables packed from them. On CUDA tensors:
    kernel K5 reads the packed tables, adds the plane gradients into
    texel-major [H*W, C] buffers and writes the per-point line-row
    cotangents, which kernel K6 reduces per line row before the pack_line
    VJP. On CPU tensors: :func:`triplane_features_bwd_plain`.
    """
    if not kernels.wants_kernel(xyz, g, *planes, *lines):
        return triplane_features_bwd_plain(planes, lines, xyz, g)
    packed_planes, packed_lines, sizes = packed
    dims = _check_tables("triplane_features_bwd", packed_planes,
                         packed_lines, sizes, xyz)
    Cs = dims[3::4]
    n = xyz.shape[0]
    kernels.check_tensor("triplane_features_bwd g", g, torch.float32, 2)
    if tuple(g.shape) != (n, sum(Cs)):
        raise ValueError(f"triplane_features_bwd: g is {tuple(g.shape)}, "
                         f"expected {(n, sum(Cs))}")
    dev = xyz.device
    d_plane_rows = [torch.zeros(H * W, C, device=dev)
                    for (H, W, _), C in zip(sizes, Cs)]
    d_line_rows = [torch.empty(n, 2 * C, device=dev) for C in Cs]
    d_xyz = torch.empty(n, 3, device=dev)
    kernels.launch("triplane_features_bwd", dev, xyz.data_ptr(),
                   *(t.data_ptr() for t in (*packed_planes, *packed_lines)),
                   g.data_ptr(), *(t.data_ptr() for t in d_plane_rows),
                   *(t.data_ptr() for t in d_line_rows), d_xyz.data_ptr(),
                   n, *dims)
    d_planes = [rows.reshape(H, W, C).permute(2, 0, 1).contiguous()
                for rows, (H, W, _), C in zip(d_plane_rows, sizes, Cs)]
    d_lines = [pack_line_vjp(line_grad(idx, rows, D))
               for idx, rows, (_, _, D) in zip(
                   line_base_index(xyz, sizes), d_line_rows, sizes)]
    return d_planes, d_lines, d_xyz


class _SampleGrids(torch.autograd.Function):
    """K4 forward over the packed tables, K5 backward to the raw grids."""

    @staticmethod
    def forward(ctx, xyz, packed, *grids):
        ctx.packed = packed
        ctx.save_for_backward(xyz, *grids)
        return triplane_features(*packed, xyz)

    @staticmethod
    def backward(ctx, g):
        xyz, *grids = ctx.saved_tensors
        d_planes, d_lines, d_xyz = triplane_features_bwd(
            grids[:3], grids[3:], ctx.packed, xyz, g.contiguous())
        return (d_xyz, None, *d_planes, *d_lines)


def sample_grids(planes: Sequence[torch.Tensor],
                 lines: Sequence[torch.Tensor], packed, xyz: torch.Tensor
                 ) -> torch.Tensor:
    """Differentiable factored features [N, sum(C_i)] at xyz [N, 3].

    ``planes`` 3 x [C, H, W] and ``lines`` 3 x [C, D] are the raw grids
    (views of the parameters); ``packed`` = (packed_planes, packed_lines,
    sizes) must be packed from their current values (``pack_grids``). The
    forward reads the packed tables (K4 or its twin); the gradient reaches
    xyz and the raw grids (K5 and K6, or the plain twin).
    """
    return _SampleGrids.apply(xyz, packed, *planes, *lines)
