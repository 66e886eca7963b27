"""TensoRF tri-plane / line factored-grid sampling: the plain versions.

Counterpart of ``evdeblurnerf_tpu/ops/triplane.py`` (ref:
networks/pdrf/voxnerf.py:132-151): bilinear interpolation with
``align_corners=True`` semantics and zeros padding, in two forms:

* unpacked :func:`grid_sample_2d` / :func:`grid_sample_1d` over the raw
  [C, H, W] / [C, D] grids — four (two) row gathers per plane (line);
* neighbour-packed :func:`triplane_features_packed`: each texel's
  (y,x),(y,x+1),(y+1,x),(y+1,x+1) block is one [4C] row of the packed
  plane (lines: (d),(d+1) in a [2C] row), so a point needs one row per
  plane and per line. The packing is done once, when the weights are
  loaded (:func:`pack_grids`).

The packed form is the plain twin of kernel K4
(``ops/fused_sample.py::triplane_features``), which the renderer calls.
It takes f32 or bf16 packed tables (``--triplane_bf16``): bf16 rows are
widened and interpolated in f32, or, under the bf16 eval chain
(``compute_bf16``), every operation of the interpolation runs in bf16, as
``evdeblurnerf_tpu/ops/triplane.py:238-266,323-350`` does.
:func:`round_bf16` is the rounding of the training path's tables, exact in
its backward. The TV regularisers of the grids close the module.
Conventions follow ``torch.nn.functional.grid_sample``: a coordinate pair
(x, y) in [-1, 1] indexes (width, height) = (last, second-to-last) grid
dims.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

# Plane/line axis assignment (ref: voxnerf.py:99-100).
MAT_MODE = ((0, 1), (0, 2), (1, 2))
VEC_MODE = (2, 1, 0)


def grid_sample_2d(plane: torch.Tensor, x: torch.Tensor,
                   y: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of ``plane`` [C, H, W] at (x, y) each [N] in [-1, 1].
    align_corners=True, zeros padding. Returns [N, C]."""
    C, H, W = plane.shape
    fx = (x + 1.0) * 0.5 * (W - 1)
    fy = (y + 1.0) * 0.5 * (H - 1)
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    wx1 = fx - x0
    wy1 = fy - y0
    plane_flat = plane.reshape(C, H * W).T                          # [H*W, C]
    out = 0.0
    for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        xi = x0 + dx
        yi = y0 + dy
        w = (wx1 if dx else 1.0 - wx1) * (wy1 if dy else 1.0 - wy1)
        valid = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        xi_c = torch.clamp(xi, 0, W - 1).long()
        yi_c = torch.clamp(yi, 0, H - 1).long()
        vals = plane_flat[yi_c * W + xi_c]                           # [N, C]
        out = out + (w * valid.to(plane.dtype))[:, None] * vals
    return out


def grid_sample_1d(line: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Linear sample of ``line`` [C, D] at y [N] in [-1, 1] (the
    reference's grid_sample over a [1, C, D, 1] grid with x pinned to 0).
    Returns [N, C]."""
    C, D = line.shape
    fy = (y + 1.0) * 0.5 * (D - 1)
    y0 = torch.floor(fy)
    wy1 = fy - y0
    line_t = line.T                                                  # [D, C]
    out = 0.0
    for dy in (0, 1):
        yi = y0 + dy
        w = wy1 if dy else 1.0 - wy1
        valid = (yi >= 0) & (yi <= D - 1)
        vals = line_t[torch.clamp(yi, 0, D - 1).long()]
        out = out + (w * valid.to(line.dtype))[:, None] * vals
    return out


def triplane_features(planes: Sequence[torch.Tensor],
                      lines: Sequence[torch.Tensor],
                      xyz: torch.Tensor) -> torch.Tensor:
    """Unpacked factored features: concat_i plane_i(xy) * line_i(z).
    planes: 3 x [C_i, H_i, W_i]; lines: 3 x [C_i, D_i]; xyz [N, 3] in
    [-1, 1]. Returns [N, sum(C_i)]."""
    feats = []
    for i in range(3):
        m0, m1 = MAT_MODE[i]
        plane_feat = grid_sample_2d(planes[i], xyz[:, m0], xyz[:, m1])
        line_feat = grid_sample_1d(lines[i], xyz[:, VEC_MODE[i]])
        feats.append(plane_feat * line_feat)
    return torch.cat(feats, -1)


def pack_plane(plane: torch.Tensor) -> torch.Tensor:
    """[C, H, W] -> [H*W, 4C] neighbour-packed rows (zeros past the +x and
    +y edges)."""
    p = plane.permute(1, 2, 0)                                   # [H, W, C]
    p01 = torch.cat([p[:, 1:], torch.zeros_like(p[:, :1])], 1)       # (y, x+1)
    top = torch.cat([p, p01], -1)                               # [H, W, 2C]
    bot = torch.cat([top[1:], torch.zeros_like(top[:1])], 0)         # (y+1, .)
    return torch.cat([top, bot], -1).reshape(p.shape[0] * p.shape[1], -1)


def pack_line(line: torch.Tensor) -> torch.Tensor:
    """[C, D] -> [D, 2C] neighbour-packed rows."""
    p = line.T                                                       # [D, C]
    p1 = torch.cat([p[1:], torch.zeros_like(p[:1])], 0)
    return torch.cat([p, p1], -1)


def pack_plane_into(out: torch.Tensor, plane: torch.Tensor) -> None:
    """:func:`pack_plane` of ``plane`` [C, H, W] written into ``out``
    [H*W, 4C] (f32, or bf16: each value rounded as ``.to()`` rounds it)."""
    C, H, W = plane.shape
    p = plane.permute(1, 2, 0)                                   # [H, W, C]
    o = out.view(H, W, 4, C)
    o[:, :, 0] = p
    o[:, :W - 1, 1] = p[:, 1:]
    o[:, W - 1, 1] = 0
    o[:H - 1, :, 2] = p[1:]
    o[H - 1, :, 2] = 0
    o[:H - 1, :W - 1, 3] = p[1:, 1:]
    o[H - 1, :, 3] = 0
    o[:, W - 1, 3] = 0


def pack_line_into(out: torch.Tensor, line: torch.Tensor) -> None:
    """:func:`pack_line` of ``line`` [C, D] written into ``out`` [D, 2C]."""
    C, D = line.shape
    p = line.T                                                       # [D, C]
    o = out.view(D, 2, C)
    o[:, 0] = p
    o[:D - 1, 1] = p[1:]
    o[D - 1, 1] = 0


def pack_grids(planes: Sequence[torch.Tensor], lines: Sequence[torch.Tensor],
               out=None):
    """Pack the three planes and lines; returns (packed_planes, packed_lines,
    sizes) with ``sizes[i] = (H_i, W_i, D_i)``. ``out``: (packed_planes,
    packed_lines) of those shapes to pack into, in place (what a captured
    training step replays: its tables keep their addresses); their dtype
    is the tables' (bf16 tables take each value rounded)."""
    sizes = tuple((int(planes[i].shape[1]), int(planes[i].shape[2]),
                   int(lines[i].shape[1])) for i in range(3))
    if out is None:
        packed_planes = [pack_plane(p).contiguous() for p in planes]
        packed_lines = [pack_line(l).contiguous() for l in lines]
        return packed_planes, packed_lines, sizes
    for dst, p in zip(out[0], planes):
        pack_plane_into(dst, p)
    for dst, l in zip(out[1], lines):
        pack_line_into(dst, l)
    return list(out[0]), list(out[1]), sizes


class _RoundBF16(torch.autograd.Function):
    """Round to bf16 in the forward, pass the gradient unchanged: the
    JAX package's ``_take_rows_bf16`` custom VJP
    (``evdeblurnerf_tpu/ops/triplane.py:120-143``), whose backward is the
    exact f32 scatter. A bare ``t.to(torch.bfloat16).float()`` would round
    the incoming gradient too, since a cast's backward casts back."""

    @staticmethod
    def forward(ctx, t):
        return t.to(torch.bfloat16).float()

    @staticmethod
    def backward(ctx, g):
        return g


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """f32 ``t`` rounded to bf16 values (ties to even), still f32; its
    gradient is the incoming one, unrounded."""
    return _RoundBF16.apply(t)


def _slot_weights(f: torch.Tensor, size: int):
    """Base row index in [0, size-2] and the two slot weights of coordinate
    f: the tent weights with zeros-padding validity, routed to the slot of
    the packed (base, base+1) pair their texel lands in (see
    ``evdeblurnerf_tpu/ops/triplane.py::_axis_setup``)."""
    f0 = torch.floor(f)
    frac = f - f0
    base = torch.clamp(f0, 0, size - 2)
    valid0 = ((f0 >= 0) & (f0 <= size - 1)).to(f.dtype)
    valid1 = ((f0 + 1 >= 0) & (f0 + 1 <= size - 1)).to(f.dtype)
    w0 = (1.0 - frac) * valid0
    w1 = frac * valid1
    off0 = f0 == base
    return (base.long(), torch.where(off0, w0, w1),
            torch.where(off0, w1, w0))


def _rows(packed: torch.Tensor, idx: torch.Tensor, compute_bf16: bool):
    """Rows ``packed[idx]`` in the type the interpolation runs in: f32
    (bf16 rows widened, exactly), or bf16 under the bf16 chain."""
    rows = packed[idx]
    if compute_bf16:
        if rows.dtype != torch.bfloat16:
            raise TypeError("the bf16 chain reads bf16 tables, got "
                            f"{rows.dtype}")
        return rows
    return rows.float()


def grid_sample_2d_packed(packed: torch.Tensor, H: int, W: int,
                          x: torch.Tensor, y: torch.Tensor,
                          compute_bf16: bool = False) -> torch.Tensor:
    """Bilinear sample from a packed plane [H*W, 4C] (f32 or bf16): one
    row per point. Same weights and validity as :func:`grid_sample_2d`;
    the slot factoring reorders the f32 sums (~1e-6 relative). With
    ``compute_bf16`` the slot weights, products and sums are bf16."""
    C = packed.shape[-1] // 4
    bx, sx0, sx1 = _slot_weights((x + 1.0) * 0.5 * (W - 1), W)
    by, sy0, sy1 = _slot_weights((y + 1.0) * 0.5 * (H - 1), H)
    rows = _rows(packed, by * W + bx, compute_bf16)                # [N, 4C]
    dt = rows.dtype
    return (rows[:, :C] * (sy0 * sx0).to(dt)[:, None]
            + rows[:, C:2 * C] * (sy0 * sx1).to(dt)[:, None]
            + rows[:, 2 * C:3 * C] * (sy1 * sx0).to(dt)[:, None]
            + rows[:, 3 * C:] * (sy1 * sx1).to(dt)[:, None])


def grid_sample_1d_packed(packed: torch.Tensor, D: int, y: torch.Tensor,
                          compute_bf16: bool = False) -> torch.Tensor:
    """Linear sample from a packed line [D, 2C]: one row per point."""
    C = packed.shape[-1] // 2
    b, s0, s1 = _slot_weights((y + 1.0) * 0.5 * (D - 1), D)
    rows = _rows(packed, b, compute_bf16)                          # [N, 2C]
    dt = rows.dtype
    return rows[:, :C] * s0.to(dt)[:, None] + rows[:, C:] * s1.to(dt)[:, None]


def triplane_features_packed(packed_planes: Sequence[torch.Tensor],
                             packed_lines: Sequence[torch.Tensor],
                             sizes: Sequence[Tuple[int, int, int]],
                             xyz: torch.Tensor,
                             compute_bf16: bool = False) -> torch.Tensor:
    """Packed-path equivalent of :func:`triplane_features`, and the plain
    twin of kernel K4 in its three forms. Returns [N, sum(C_i)] f32 from
    f32 or bf16 tables, or bf16 under the bf16 chain (``compute_bf16``:
    bf16 tables, and every product and sum, plane x line and the concat in
    bf16, each rounded where a bf16 tensor operation rounds)."""
    feats = []
    for i in range(3):
        m0, m1 = MAT_MODE[i]
        H, W, D = sizes[i]
        plane_feat = grid_sample_2d_packed(packed_planes[i], H, W,
                                           xyz[:, m0], xyz[:, m1],
                                           compute_bf16)
        line_feat = grid_sample_1d_packed(packed_lines[i], D,
                                          xyz[:, VEC_MODE[i]], compute_bf16)
        feats.append(plane_feat * line_feat)
    return torch.cat(feats, -1)


def tv_loss_2d(x: torch.Tensor) -> torch.Tensor:
    """Total-variation regulariser of a [C, H, W] grid (ref:
    voxnerf.py:306-324 with batch size 1)."""
    C, H, W = x.shape
    count_h = max(C * (H - 1) * W, 1)
    count_w = max(C * H * (W - 1), 1)
    h_tv = torch.sum(torch.square(x[:, 1:, :] - x[:, :-1, :]))
    w_tv = torch.sum(torch.square(x[:, :, 1:] - x[:, :, :-1]))
    return 2.0 * (h_tv / count_h + w_tv / count_w)


def tv_loss_1d(x: torch.Tensor) -> torch.Tensor:
    """TV of a [C, D] line grid: the reference's loss of the [1, C, D, 1]
    line tensor, whose width term is zero."""
    C, D = x.shape
    h_tv = torch.sum(torch.square(x[:, 1:] - x[:, :-1]))
    return 2.0 * (h_tv / max(C * (D - 1), 1))


def tv_loss_app(planes: Sequence[torch.Tensor],
                lines: Sequence[torch.Tensor]) -> torch.Tensor:
    """Grid TV: planes [C, H, W] weighted 1e-2, lines [C, D] 1e-3 (ref:
    voxnerf.py:126-130)."""
    total = 0.0
    for plane, line in zip(planes, lines):
        total = total + tv_loss_2d(plane) * 1e-2 + tv_loss_1d(line) * 1e-3
    return total
