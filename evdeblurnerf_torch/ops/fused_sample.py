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
Its forward is :func:`triplane_features` (K4, four channels a lane on
16-byte accesses or, for component counts that are no multiple of 4 and
tables off a 16-byte boundary, one thread an output element; plain twin
``ops/triplane.py::triplane_features_packed``), its backward
:func:`triplane_features_bwd` (K5, which sums the line gradients itself
where the line tables fit a block's shared memory and else hands them to
one launch of K6; plain twin: autograd through ``pack_grids`` and the
packed sampler).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .. import kernels
from .line_matmul import line_grad_tables
from .triplane import VEC_MODE, pack_grids, triplane_features_packed


def _check_tables(name, packed_planes, packed_lines, sizes, xyz,
                  slots=(4, 2)):
    """Raise unless the tables and points are what K4/K5 read; returns the
    (H, W, D, C) x 3 sizes the kernels take. ``slots``: neighbours a plane
    row and a line row hold, (4, 2) packed, (1, 1) unpacked."""
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
        C = line.shape[1] // slots[1]
        if (min(H, W, D) < 2 or plane.shape != (H * W, slots[0] * C)
                or line.shape != (D, slots[1] * C)):
            raise ValueError(
                f"{name}: projection {i} has sizes {(H, W, D)}, "
                f"plane {tuple(plane.shape)}, line {tuple(line.shape)}; "
                f"expected plane [H*W, {slots[0]}C], line [D, {slots[1]}C], "
                "every size >= 2")
        dims += [H, W, D, C]
    return dims


# the forms of kernel K4 (csrc/fused_sample.cu)
K4_SCALAR, K4_FLOAT4, K4_UNPACKED = 0, 1, 2


def _k4_mode(Cs, wide) -> int:
    """Which K4 kernel these shapes take: ``K4_FLOAT4`` (four channels a
    lane, 16-byte loads and stores) when every component count is a
    multiple of 4 and every tensor of ``wide`` (the tables, the output)
    lies on a 16-byte boundary, else ``K4_SCALAR``."""
    if any(C % 4 for C in Cs) or any(t.data_ptr() % 16 for t in wide):
        return K4_SCALAR
    return K4_FLOAT4


def _launch_k4(name, planes, lines, sizes, xyz, slots=(4, 2)):
    tables = (*planes, *lines)
    if torch.is_grad_enabled() and (xyz.requires_grad or any(
            t.requires_grad for t in tables)):
        raise NotImplementedError(
            f"{name}: K4 is the forward; differentiate through "
            "sample_grids, whose backward is K5")
    dims = _check_tables(name, planes, lines, sizes, xyz, slots)
    Cs = dims[3::4]
    out = torch.empty((xyz.shape[0], sum(Cs)), dtype=torch.float32,
                      device=xyz.device)
    mode = _k4_mode(Cs, (*tables, out))
    if slots != (4, 2):
        if mode != K4_FLOAT4:
            raise ValueError(
                f"{name}: the unpacked tables are read by K4's float4 "
                "kernel only: every component count a multiple of 4, every "
                "table on a 16-byte boundary")
        mode = K4_UNPACKED
    kernels.launch("triplane_features", xyz.device, xyz.data_ptr(),
                   *(t.data_ptr() for t in tables), out.data_ptr(),
                   xyz.shape[0], *dims, mode)
    return out


def triplane_features(packed_planes: Sequence[torch.Tensor],
                      packed_lines: Sequence[torch.Tensor],
                      sizes: Sequence[Tuple[int, int, int]],
                      xyz: torch.Tensor) -> torch.Tensor:
    """Factored features [N, sum(C_i)] f32 at normalised points xyz [N, 3].

    ``packed_planes[i]`` [H_i*W_i, 4C_i] and ``packed_lines[i]``
    [D_i, 2C_i] come from ``ops/triplane.py::pack_grids``, with
    ``sizes[i] = (H_i, W_i, D_i)``. Kernel K4 on CUDA tensors, in the form
    :func:`_k4_mode` picks, :func:`..ops.triplane.triplane_features_packed`
    on CPU tensors.
    """
    if not kernels.wants_kernel(xyz, *packed_planes, *packed_lines):
        return triplane_features_packed(packed_planes, packed_lines, sizes,
                                        xyz)
    return _launch_k4("triplane_features", packed_planes, packed_lines,
                      sizes, xyz)


def unpack_grids(planes, lines):
    """Texel-major unpacked tables of raw grids: planes 3 x [C, H, W] ->
    [H*W, C], lines 3 x [C, D] -> [D, C], and the sizes (H, W, D) x 3: the
    layout K5 adds the plane gradients into, a quarter of the packed
    planes' size."""
    rows = [p.permute(1, 2, 0).reshape(-1, p.shape[0]).contiguous()
            for p in planes]
    sizes = [(p.shape[1], p.shape[2], l.shape[1])
             for p, l in zip(planes, lines)]
    return rows, [l.t().contiguous() for l in lines], sizes


def triplane_features_unpacked(plane_rows, line_rows, sizes,
                               xyz: torch.Tensor) -> torch.Tensor:
    """:func:`triplane_features` over the tables of :func:`unpack_grids`:
    K4's float4 kernel reads the four corners of a plane as two segments
    of 2C floats (texels x, x + 1 of rows y and y + 1) and the two line
    rows as one. A measured variant (``tools/bench_kernel_variants_torch.py
    --kernels k4``), on no model path. On CPU tensors: the packed sampler
    over tables packed from these."""
    if not kernels.wants_kernel(xyz, *plane_rows, *line_rows):
        planes = [r.reshape(H, W, -1).permute(2, 0, 1)
                  for r, (H, W, _) in zip(plane_rows, sizes)]
        return triplane_features_packed(
            *pack_grids(planes, [r.t() for r in line_rows]), xyz)
    return _launch_k4("triplane_features_unpacked", plane_rows, line_rows,
                      sizes, xyz, slots=(1, 1))


def line_base_index(xyz: torch.Tensor, sizes) -> list:
    """The packed line row [N] int32 each point reads, per projection:
    ``clip(floor((x + 1) * 0.5 * (D - 1)), 0, D - 2)``, rounded where K4,
    K5 and ``ops/triplane.py::_slot_weights`` round. K5 writes the same
    rows for K6 itself where it does not sum the line gradients on its
    own; this is their plain version."""
    out = []
    for i in range(3):
        D = sizes[i][2]
        f = (xyz[:, VEC_MODE[i]] + 1.0) * 0.5 * (D - 1)
        out.append(torch.clamp(torch.floor(f), 0, D - 2).int())
    return out


# the three forms of kernel K5 (csrc/fused_sample.cu)
K5_SCALAR, K5_FLOAT4, K5_FUSED = 0, 1, 2
# the fused kernel's shared memory: points a pass of a block's loop, and
# floats between the rows of a line tile (kFusedPoints, kTilePad)
K5_FUSED_POINTS, K5_TILE_PAD = 512, 4


def _k5_mode(Cs, Ds, wide, device) -> int:
    """Which K5 kernel these shapes take. ``K5_SCALAR`` unless every
    component count is a multiple of 4 and every tensor of ``wide`` lies
    on a 16-byte boundary; then ``K5_FUSED`` when no count passes 128 and
    the kernel's shared memory (d(xyz) of a pass plus the three line
    tiles, rows four floats apart) fits what a block of ``device`` can opt
    in to, else ``K5_FLOAT4``."""
    if any(C % 4 for C in Cs) or any(t.data_ptr() % 16 for t in wide):
        return K5_SCALAR
    need = 4 * (3 * K5_FUSED_POINTS
                + sum(D * (C + K5_TILE_PAD) for C, D in zip(Cs, Ds)))
    if max(Cs) <= 128 and need <= torch.cuda.get_device_properties(
            device).shared_memory_per_block_optin:
        return K5_FUSED
    return K5_FLOAT4


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
    packed_lines, sizes) the tables packed from them. On CUDA tensors
    kernel K5 reads the packed tables and adds the plane gradients into
    texel-major [H*W, C] buffers, in one of three forms
    (:func:`_k5_mode`): fused, where the three line tables fit the shared
    memory of a block, it sums the raw line gradients itself; else it
    writes the per-point line-row cotangents and the line row of each
    point, from which one launch of kernel K6 sums them (the pack_line VJP
    folded in), four channels a lane or, for component counts that are no
    multiple of 4 or buffers off a 16-byte boundary, one. On CPU tensors:
    :func:`triplane_features_bwd_plain`.
    """
    if not kernels.wants_kernel(xyz, g, *planes, *lines):
        return triplane_features_bwd_plain(planes, lines, xyz, g)
    packed_planes, packed_lines, sizes = packed
    dims = _check_tables("triplane_features_bwd", packed_planes,
                         packed_lines, sizes, xyz)
    Cs, Ds = dims[3::4], dims[2::4]
    n = xyz.shape[0]
    kernels.check_tensor("triplane_features_bwd g", g, torch.float32, 2)
    if tuple(g.shape) != (n, sum(Cs)):
        raise ValueError(f"triplane_features_bwd: g is {tuple(g.shape)}, "
                         f"expected {(n, sum(Cs))}")
    dev = xyz.device
    d_plane_rows = [torch.zeros(H * W, C, device=dev)
                    for (H, W, _), C in zip(sizes, Cs)]
    d_xyz = torch.empty(n, 3, device=dev)
    wide = (*packed_planes, *packed_lines, g, *d_plane_rows)
    mode = _k5_mode(Cs, Ds, wide, dev)
    if mode == K5_FUSED:
        # one buffer, so one memset; each gradient is a contiguous view
        sz = [C * D for C, D in zip(Cs, Ds)]
        buf = torch.zeros(sum(sz), device=dev)
        d_lines = [t.view(C, D) for t, C, D in zip(buf.split(sz), Cs, Ds)]
        line_out, line_rows = d_lines, (buf, buf, buf)      # rows: unused
    else:
        line_out = [torch.empty(n, 2 * C, device=dev) for C in Cs]
        line_rows = list(torch.empty(3, n, dtype=torch.int32, device=dev))
    kernels.launch("triplane_features_bwd", dev,
                   *(t.data_ptr() for t in (xyz, *wide, *line_out,
                                            *line_rows, d_xyz)),
                   n, *dims, mode)
    if mode != K5_FUSED:
        d_lines = line_grad_tables(line_rows, line_out, Ds)
    d_planes = [rows.reshape(H, W, C).permute(2, 0, 1).contiguous()
                for rows, (H, W, _), C in zip(d_plane_rows, sizes, Cs)]
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
