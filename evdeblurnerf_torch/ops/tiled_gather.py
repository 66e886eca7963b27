"""Morton-tiled plane gather for tri-plane sampling (forward prototype),
through kernel K7.

Counterpart of ``evdeblurnerf_tpu/ops/tiled_gather.py``. Instead of four
table-row reads per point, points are taken in groups of ``GROUP = 128``
that lie close together on the plane (the rays are Morton-sorted once per
step), and each group shares one ``TH x TW`` tile of a channels-last plane:

1. :func:`group_origins` centres each group's tile on the group's median
   texel and reports the points whose 2x2 footprint leaves the tile;
2. :func:`tiled_plane_gather` samples every point from its group's tile:
   on CUDA tensors the hand-written kernel of ``csrc/tiled_gather.cu``,
   which reads each point's four texel rows straight through the caches
   (on this card the tile is the spill mask only, and any tile that fits
   the plane runs), on CPU tensors the plain twin
   :func:`tiled_plane_gather_plain`; spilled rows come out zero;
3. :func:`tiled_plane_gather_with_fallback` patches the spilled rows with
   a direct four-corner gather, up to a fixed capacity; more spills than
   that poison the whole output with NaN instead of corrupting it silently.

Like the JAX module it lies on no model path: it is driven by
``tools/bench_tiled_gather_torch.py``. Forward only.
ref: networks/pdrf/voxnerf.py:132-151 (the grid_sample this replaces).
"""

from __future__ import annotations

import torch

from .. import kernels

GROUP = 128


def morton_code_2d(u: torch.Tensor, v: torch.Tensor, bits: int = 16
                   ) -> torch.Tensor:
    """Interleave-bit Morton code of integer coordinates: the JAX
    function's uint32 values, held in int64 (torch's uint32 supports few
    operations)."""
    def spread(x):
        x = x.to(torch.int64) & ((1 << bits) - 1)
        x = (x | (x << 8)) & 0x00FF00FF
        x = (x | (x << 4)) & 0x0F0F0F0F
        x = (x | (x << 2)) & 0x33333333
        x = (x | (x << 1)) & 0x55555555
        return x
    return (spread(u) | (spread(v) << 1)) & 0xFFFFFFFF


def _group_median(x: torch.Tensor) -> torch.Tensor:
    """Median over the last axis of [G, GROUP] that averages the two
    middle values, as ``jnp.median`` does (``torch.median`` takes the
    lower one)."""
    s = torch.sort(x, dim=1)[0]
    return (s[:, GROUP // 2 - 1] + s[:, GROUP // 2]) * 0.5


def group_origins(fu: torch.Tensor, fv: torch.Tensor, H: int, W: int,
                  TH: int, TW: int):
    """Per-group tile origins (oy, ox) [G] int32 from the points' texel
    coordinates [G * GROUP], and the mask [G * GROUP] of points whose 2x2
    footprint lies inside their group's tile.

    The tile is centred on the group's median point — robust to the few
    outliers a Morton-sorted stream still contains — and clamped so that
    [oy:oy+TH, ox:ox+TW] stays in the plane.
    """
    G = fu.shape[0] // GROUP
    u0 = torch.floor(fu).reshape(G, GROUP)
    v0 = torch.floor(fv).reshape(G, GROUP)
    # .to(int32) truncates toward zero before the clamp, as astype does
    ox = torch.clamp((_group_median(u0) - TW // 2).to(torch.int32), 0,
                     max(W - TW, 0))
    oy = torch.clamp((_group_median(v0) - TH // 2).to(torch.int32), 0,
                     max(H - TH, 0))
    in_u = (u0 >= ox[:, None]) & (u0 + 1 <= ox[:, None] + TW - 1)
    in_v = (v0 >= oy[:, None]) & (v0 + 1 <= oy[:, None] + TH - 1)
    return oy, ox, (in_u & in_v).reshape(-1)


def tiled_plane_gather_plain(plane_hwc: torch.Tensor, fu: torch.Tensor,
                             fv: torch.Tensor, oy: torch.Tensor,
                             ox: torch.Tensor, TH: int = 64, TW: int = 64
                             ) -> torch.Tensor:
    """Plain version of K7, with the kernel's arithmetic in the kernel's
    order: local coordinates against the group's origin, the y sums of the
    two columns, then the x sum; zero rows for spilled points. Origins
    are clamped into the plane, as the kernel clamps them."""
    H, W, C = plane_hwc.shape
    oyf = torch.clamp(oy, 0, H - TH).repeat_interleave(GROUP)
    oxf = torch.clamp(ox, 0, W - TW).repeat_interleave(GROUP)
    lu = fu - oxf.to(fu.dtype)
    lv = fv - oyf.to(fv.dtype)
    u0 = torch.floor(lu)
    v0 = torch.floor(lv)
    au = (lu - u0)[:, None]
    av = (lv - v0)[:, None]
    ok = (u0 >= 0) & (u0 + 1 <= TW - 1) & (v0 >= 0) & (v0 + 1 <= TH - 1)
    u0c = torch.clamp(u0, 0, TW - 2).long() + oxf.long()
    v0c = torch.clamp(v0, 0, TH - 2).long() + oyf.long()
    flat = plane_hwc.reshape(H * W, C)
    row = v0c * W + u0c
    wy0, wx0 = 1 - av, 1 - au
    a0 = wy0 * flat[row] + av * flat[row + W]
    a1 = wy0 * flat[row + 1] + av * flat[row + W + 1]
    out = a0 * wx0 + a1 * au
    return torch.where(ok[:, None], out, torch.zeros_like(out))


def tiled_plane_gather(plane_hwc: torch.Tensor, fu: torch.Tensor,
                       fv: torch.Tensor, oy: torch.Tensor, ox: torch.Tensor,
                       TH: int = 64, TW: int = 64) -> torch.Tensor:
    """Bilinear-sample ``plane_hwc`` [H, W, C] f32 at texel coordinates
    (fu, fv) [N] f32, N a multiple of GROUP, with per-group tile origins
    (oy, ox) [N / GROUP] int32, as :func:`group_origins` gives them; an
    origin whose tile would leave the plane is clamped into it.

    Returns [N, C]; rows whose footprint spills the tile are zero (the
    caller patches them via the mask of :func:`group_origins`). Kernel K7
    on CUDA tensors (C must be a multiple of 4 there), the plain twin on
    CPU tensors. No gradient.
    """
    H, W, C = plane_hwc.shape
    N = fu.shape[0]
    if N % GROUP or fv.shape[0] != N:
        raise ValueError(f"tiled_plane_gather: {N} and {fv.shape[0]} "
                         f"coordinates; need equal multiples of {GROUP}")
    G = N // GROUP
    if oy.shape != (G,) or ox.shape != (G,):
        raise ValueError(f"tiled_plane_gather: origins of shape "
                         f"{tuple(oy.shape)}, {tuple(ox.shape)} for {G} "
                         "groups")
    if not (2 <= TH <= H and 2 <= TW <= W):
        raise ValueError(f"tiled_plane_gather: tile {TH}x{TW} does not fit "
                         f"the {H}x{W} plane")
    if not kernels.wants_kernel(plane_hwc, fu, fv, oy, ox):
        return tiled_plane_gather_plain(plane_hwc, fu, fv, oy, ox, TH, TW)
    if torch.is_grad_enabled() and plane_hwc.requires_grad:
        raise NotImplementedError("tiled_plane_gather: K7 is forward-only")
    kernels.check_tensor("tiled_plane_gather plane", plane_hwc,
                         torch.float32, 3)
    kernels.check_tensor("tiled_plane_gather fu", fu, torch.float32, 1)
    kernels.check_tensor("tiled_plane_gather fv", fv, torch.float32, 1)
    kernels.check_tensor("tiled_plane_gather oy", oy, torch.int32, 1)
    kernels.check_tensor("tiled_plane_gather ox", ox, torch.int32, 1)
    if C % 4:
        raise ValueError(f"tiled_plane_gather: C={C}; the kernel moves "
                         "16-byte pieces and takes multiples of 4 channels")
    out = torch.empty(N, C, dtype=torch.float32, device=plane_hwc.device)
    kernels.launch("tiled_plane_gather", plane_hwc.device,
                   plane_hwc.data_ptr(), fu.data_ptr(), fv.data_ptr(),
                   oy.data_ptr(), ox.data_ptr(), out.data_ptr(), G, H, W, C,
                   TH, TW)
    return out


def bilinear_gather(plane_hwc: torch.Tensor, fu: torch.Tensor,
                    fv: torch.Tensor) -> torch.Tensor:
    """Direct four-corner bilinear sample of ``plane_hwc`` [H, W, C] at
    texel coordinates (fu, fv) [N]: the fallback of the spilled rows."""
    H, W, C = plane_hwc.shape
    u0 = torch.clamp(torch.floor(fu), 0, W - 2).long()
    v0 = torch.clamp(torch.floor(fv), 0, H - 2).long()
    au = (fu - u0)[:, None]
    av = (fv - v0)[:, None]
    flat = plane_hwc.reshape(H * W, C)
    row = v0 * W + u0
    return (flat[row] * (1 - au) * (1 - av) + flat[row + 1] * au * (1 - av)
            + flat[row + W] * (1 - au) * av + flat[row + W + 1] * au * av)


def tiled_plane_gather_with_fallback(plane_hwc: torch.Tensor,
                                     fu: torch.Tensor, fv: torch.Tensor,
                                     TH: int = 64, TW: int = 64,
                                     spill_capacity_frac: float = 0.125
                                     ) -> torch.Tensor:
    """Full forward: tiled gather + fixed-capacity direct gather for the
    spilled points. Exact (f32) for every point as long as the spill count
    stays within ``max(GROUP, N * spill_capacity_frac)``; more spills
    poison the output with NaN rather than corrupting it silently.

    The JAX function takes a fixed number of spill slots so that shapes
    stay static. The contract is kept, not the mechanism: the index here is
    capacity-long too and is made without a read off the device; its slots
    past the last spill point at rows inside their tiles, which keep their
    values.
    """
    H, W, C = plane_hwc.shape
    N = fu.shape[0]
    oy, ox, ok = group_origins(fu, fv, H, W, TH, TW)
    out = tiled_plane_gather(plane_hwc, fu, fv, oy, ox, TH=TH, TW=TW)

    cap = min(N, max(GROUP, int(N * spill_capacity_frac)))
    # the first `cap` spilled rows, in order: a stable sort of the mask
    # puts them first without a dynamic shape
    spill_idx = torch.sort(ok.to(torch.uint8), stable=True)[1][:cap]
    vals = bilinear_gather(plane_hwc, fu[spill_idx], fv[spill_idx])
    out[spill_idx] = torch.where(ok[spill_idx, None], out[spill_idx], vals)
    n_spill = torch.sum(~ok)
    poison = torch.where(n_spill <= cap,
                         torch.ones((), device=out.device),
                         torch.full((), float("nan"), device=out.device))
    return out * poison
