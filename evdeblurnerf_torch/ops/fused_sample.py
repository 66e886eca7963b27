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

bf16 tables (``--triplane_bf16``): the packed tables may be bf16, cast
from the grids before packing. K4 then widens the rows and interpolates in
f32, or, under the bf16 eval chain (``compute_bf16``), runs every
operation in bf16 and writes bf16 features; either way on eight channels
a lane (16-byte loads) where every component count is a multiple of 8,
else as over f32 tables; K5 reads the same bf16 pack
and adds exact f32 gradients into the raw grids. Each form has its own
launch counter (:data:`K4_COUNTERS`, ``triplane_features_bwd_bf16``).

K4 is the custom op ``evdn::triplane_features`` (``kernels.custom_op``):
it launches the kernel on CUDA tensors and runs the plain twin on CPU
tensors, and its fake implementation gives ``torch.export`` the output's
shape, so an exported render holds the op (``serving.export_renderer``).
Outside a trace the wrapper calls the op's implementation directly.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .. import kernels
from .line_matmul import line_grad_tables
from .triplane import (VEC_MODE, pack_grids, round_bf16,
                       triplane_features_packed)


# the element types of the packed tables K4 and K5 read
TABLE_DTYPES = (torch.float32, torch.bfloat16)


def table_dtype(packed_planes, packed_lines) -> torch.dtype:
    """The element type all six packed tables share, f32 or bf16; raises
    on anything else or on a mix."""
    dtypes = {t.dtype for t in (*packed_planes, *packed_lines)}
    if len(dtypes) != 1 or next(iter(dtypes)) not in TABLE_DTYPES:
        raise TypeError("the packed tables must all be float32 or all "
                        f"bfloat16, got {sorted(map(str, dtypes))}")
    return next(iter(dtypes))


def _check_tables(name, packed_planes, packed_lines, sizes, xyz,
                  slots=(4, 2)):
    """Raise unless the tables and points are what K4/K5 read; returns the
    (H, W, D, C) x 3 sizes the kernels take. ``slots``: neighbours a plane
    row and a line row hold, (4, 2) packed, (1, 1) unpacked. The tables
    are f32 or bf16 (:func:`table_dtype`)."""
    kernels.check_tensor(f"{name} xyz", xyz, torch.float32, 2)
    if xyz.shape[1] != 3:
        raise ValueError(f"{name}: xyz must be [N, 3], got "
                         f"{tuple(xyz.shape)}")
    dtype = table_dtype(packed_planes, packed_lines)
    dims = []
    for i in range(3):
        H, W, D = sizes[i]
        plane, line = packed_planes[i], packed_lines[i]
        kernels.check_tensor(f"{name} plane {i}", plane, dtype, 2)
        kernels.check_tensor(f"{name} line {i}", line, dtype, 2)
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


# the forms of kernel K4 (csrc/fused_sample.cu); K4_VEC8: eight channels a
# lane on 16-byte loads, bf16 tables only (:func:`_k4_mode`)
K4_SCALAR, K4_FLOAT4, K4_UNPACKED, K4_VEC8 = 0, 1, 2, 3
# the table types K4 reads: f32; bf16 rows, f32 math and output; bf16 rows,
# math and output (the bf16 eval chain)
K4_F32, K4_BF16, K4_BF16_COMPUTE = 0, 1, 2
# each K4 table type's launch counter
K4_COUNTERS = {K4_F32: "triplane_features",
               K4_BF16: "triplane_features_bf16",
               K4_BF16_COMPUTE: "triplane_features_bf16_compute"}


def _vector_aligned(t: torch.Tensor, vec: int = 4) -> bool:
    """Whether ``t`` lies on the boundary of one vector access of ``vec``
    of its elements, at most 16 bytes: four elements are 16 bytes of f32,
    8 of bf16; eight bf16 are 16 bytes, and eight f32 go out as two
    16-byte stores."""
    return t.data_ptr() % min(16, vec * t.element_size()) == 0


def _k4_mode(Cs, wide) -> int:
    """Which K4 kernel these shapes take, ``wide`` being the tables and
    the output: over bf16 tables ``K4_VEC8`` (eight channels a lane,
    16-byte loads) when every component count is a multiple of 8 and
    every tensor of ``wide`` lies on a 16-byte boundary; else
    ``K4_FLOAT4`` (four channels a lane, 16-byte loads of f32, 8-byte ones
    of bf16) when every component count is a multiple of 4 and every
    tensor lies on a boundary of four elements; else ``K4_SCALAR``."""
    if wide[0].dtype == torch.bfloat16 and not any(C % 8 for C in Cs) and \
            all(_vector_aligned(t, 8) for t in wide):
        return K4_VEC8
    if any(C % 4 for C in Cs) or not all(map(_vector_aligned, wide)):
        return K4_SCALAR
    return K4_FLOAT4


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _launch_k4(name, planes, lines, sizes, xyz, slots=(4, 2),
               compute_bf16=False, mode=None):
    """Launch K4 in the form ``mode``: by default what :func:`_k4_mode`
    picks; ``K4_FLOAT4`` or ``K4_VEC8`` when asked (the bench tool's
    comparison of the two vector forms over bf16 tables)."""
    tables = (*planes, *lines)
    if _needs_grad(xyz, *tables):
        raise NotImplementedError(
            f"{name}: K4 is the forward; differentiate through "
            "sample_grids, whose backward is K5")
    dims = _check_tables(name, planes, lines, sizes, xyz, slots)
    bf16 = planes[0].dtype == torch.bfloat16
    if compute_bf16 and not bf16:
        raise TypeError(f"{name}: the bf16 chain reads bf16 tables")
    ttype = (K4_BF16_COMPUTE if compute_bf16 else K4_BF16) if bf16 \
        else K4_F32
    Cs = dims[3::4]
    out = torch.empty((xyz.shape[0], sum(Cs)),
                      dtype=torch.bfloat16 if compute_bf16 else torch.float32,
                      device=xyz.device)
    if mode is None:
        mode = _k4_mode(Cs, (*tables, out))
    else:
        vec = {K4_FLOAT4: 4, K4_VEC8: 8}.get(mode)
        if vec is None or (vec == 8 and not bf16) or any(
                C % vec for C in Cs) or not all(
                    _vector_aligned(t, vec) for t in (*tables, out)):
            raise ValueError(
                f"{name}: K4 form {mode} takes {vec} channels a lane "
                "(8: bf16 tables only), every component count a multiple "
                "of it, every table and the output on its boundary")
    if slots != (4, 2):
        if mode != K4_FLOAT4 or bf16:
            raise ValueError(
                f"{name}: the unpacked tables are read by K4's float4 "
                "kernel only: f32 tables, every component count a multiple "
                "of 4, every table on a 16-byte boundary")
        mode = K4_UNPACKED
    kernels.launch("triplane_features", xyz.device, xyz.data_ptr(),
                   *(t.data_ptr() for t in tables), out.data_ptr(),
                   xyz.shape[0], *dims, ttype, mode,
                   counter=K4_COUNTERS[ttype])
    return out


def _unflatten(sizes):
    return [tuple(sizes[3 * i:3 * i + 3]) for i in range(3)]


def _k4_impl(xyz: torch.Tensor, planes: list[torch.Tensor],
             lines: list[torch.Tensor], sizes: list[int],
             compute_bf16: bool) -> torch.Tensor:
    sizes = _unflatten(sizes)
    if not kernels.wants_kernel(xyz, *planes, *lines):
        return triplane_features_packed(planes, lines, sizes, xyz,
                                        compute_bf16)
    return _launch_k4("triplane_features", planes, lines, sizes, xyz,
                      compute_bf16=compute_bf16)


def _k4_fake(xyz, planes, lines, sizes, compute_bf16):
    return xyz.new_empty(
        (xyz.shape[0], sum(t.shape[1] // 2 for t in lines)),
        dtype=torch.bfloat16 if compute_bf16 else torch.float32)


_K4_OP = kernels.custom_op("triplane_features", _k4_impl, _k4_fake)


def triplane_features(packed_planes: Sequence[torch.Tensor],
                      packed_lines: Sequence[torch.Tensor],
                      sizes: Sequence[Tuple[int, int, int]],
                      xyz: torch.Tensor,
                      compute_bf16: bool = False) -> torch.Tensor:
    """Factored features [N, sum(C_i)] at normalised points xyz [N, 3].

    ``packed_planes[i]`` [H_i*W_i, 4C_i] and ``packed_lines[i]``
    [D_i, 2C_i] come from ``ops/triplane.py::pack_grids``, with
    ``sizes[i] = (H_i, W_i, D_i)``, all f32 or all bf16. The features are
    f32, or bf16 under the bf16 eval chain (``compute_bf16``, bf16 tables
    only). Kernel K4 on CUDA tensors, in the form :func:`_k4_mode` picks,
    :func:`..ops.triplane.triplane_features_packed` on CPU tensors, both
    through the custom op ``evdn::triplane_features`` under a trace and
    its implementation otherwise. On CPU tensors that
    need a gradient the plain twin runs under autograd (K4 itself is
    forward-only: :func:`sample_grids` differentiates).
    """
    tables = (*packed_planes, *packed_lines)
    if _needs_grad(xyz, *tables):
        if kernels.wants_kernel(xyz, *tables):
            raise NotImplementedError(
                "triplane_features: K4 is the forward; differentiate "
                "through sample_grids, whose backward is K5")
        return triplane_features_packed(packed_planes, packed_lines, sizes,
                                        xyz, compute_bf16)
    return _K4_OP(xyz, list(packed_planes), list(packed_lines),
                  [int(v) for hwd in sizes for v in hwd], bool(compute_bf16))


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
    on a boundary of four of its elements (16 bytes f32, 8 bytes bf16);
    then ``K5_FUSED`` when no count passes 128 and
    the kernel's shared memory (d(xyz) of a pass plus the three line
    tiles, rows four floats apart) fits what a block of ``device`` can opt
    in to, else ``K5_FLOAT4``."""
    if any(C % 4 for C in Cs) or not all(map(_vector_aligned, wide)):
        return K5_SCALAR
    need = 4 * (3 * K5_FUSED_POINTS
                + sum(D * (C + K5_TILE_PAD) for C, D in zip(Cs, Ds)))
    if max(Cs) <= 128 and need <= torch.cuda.get_device_properties(
            device).shared_memory_per_block_optin:
        return K5_FUSED
    return K5_FLOAT4


def triplane_features_bwd_plain(planes, lines, xyz, g, table_bf16=False):
    """Plain version of K5 (with K6): autograd through ``pack_grids`` and
    the packed sampler. planes 3 x [C, H, W], lines 3 x [C, D], xyz [N, 3],
    g [N, sum(C)]; returns (d_planes, d_lines, d_xyz) in those layouts.
    ``table_bf16``: the packed tables rounded to bf16 by
    ``ops/triplane.py::round_bf16``, whose backward passes the gradient on
    unrounded (the exact f32 scatter)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (*planes, *lines, xyz)]
        pp, pl, sizes = pack_grids(leaves[:3], leaves[3:6])
        if table_bf16:
            pp = [round_bf16(t) for t in pp]
            pl = [round_bf16(t) for t in pl]
        out = triplane_features_packed(pp, pl, sizes, leaves[6])
        grads = torch.autograd.grad(out, leaves, g)
    return list(grads[:3]), list(grads[3:6]), grads[6]


def triplane_features_bwd(planes, lines, packed, xyz, g):
    """Gradients of the sampled features [N, sum(C)] given their cotangent
    g: (d_planes 3 x [C, H, W], d_lines 3 x [C, D], d_xyz [N, 3]).

    ``planes``/``lines`` are the raw grids and ``packed`` = (packed_planes,
    packed_lines, sizes) the tables packed from them, f32 or bf16 (the
    gradients are f32 either way). On CUDA tensors
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
    packed_planes, packed_lines, sizes = packed
    bf16 = table_dtype(packed_planes, packed_lines) == torch.bfloat16
    if not kernels.wants_kernel(xyz, g, *planes, *lines):
        return triplane_features_bwd_plain(planes, lines, xyz, g, bf16)
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
                   n, *dims, int(bf16), mode,
                   counter="triplane_features_bwd_bf16" if bf16
                   else "triplane_features_bwd")
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
    xyz and the raw grids (K5 and K6, or the plain twin). The packed
    tables are f32, or bf16 packed from the grids cast to bf16; the
    features are f32 either way. With no gradient to take, K4 alone (no
    autograd node, so ``torch.export`` sees the custom op).
    """
    if not _needs_grad(xyz, *planes, *lines):
        return triplane_features(*packed, xyz)
    return _SampleGrids.apply(xyz, packed, *planes, *lines)
