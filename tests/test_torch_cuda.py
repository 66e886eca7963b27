"""The hand-written CUDA kernels against their plain PyTorch twins, on the
card. Every test here needs a CUDA device and nvcc and skips elsewhere.

This file imports neither jax nor the JAX package, so it also runs on a
machine without them; there, skip the repo's conftest (which sets up JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Gathers (K1 and K2, forward and backward, and K3) must be bitwise equal to
the plain versions. K4 rounds at the same places as its plain twin (no FMA
contraction) and must equal it bitwise in each of its forms: the float4
kernel, the scalar kernel (forced by a component count that is no multiple
of 4 and by a table off a 16-byte boundary) and the float4 kernel over
unpacked tables. K5 and K6 add with atomics, in an order that
changes from run to run, and K5 contracts its products into FMAs: they are
held to 1e-5 of each gradient's largest magnitude (f32 sums of up to a few
thousand terms per entry in another order), on uniform and on ray-ordered
streams, through K5's fused, float4 and scalar kernels and K6's bulk and
per-entry flushes and its splits along D and W, each forced by shape, and
twice in a row. K7 multiplies and adds where
its plain twin does (no FMA contraction) and must equal it bitwise, with
exact zeros on the spilled rows.

bf16 tables: K4's bf16-row form (f32 math) and its bf16-compute form (the
bf16 eval chain, every operation rounded where the twin's bf16 tensor
operation rounds) must equal their twins bitwise in the vector and the
scalar kernel; K5's bf16 form is held to K5's 1e-5 against the twin's
exact f32 backward; K6's "default" precision (the cotangent rounded to
bf16) to K6's 1e-5 against its twin.

The captured training step (``train/capture.py``), on a tiny paper step:
its replays equal the eager step within K5's 1e-5, its tables are
repacked in place, and Adam's state is made by the eager first step,
outside the capture.
"""

import pytest
import torch

from evdeblurnerf_torch import kernels
from evdeblurnerf_torch.models.renderer import RenderConfig
from evdeblurnerf_torch.models.system import EvDeblurNeRF
from evdeblurnerf_torch.ops import (fused_sample, lane_shuffle, line_matmul,
                                   tiled_gather, triplane)
from evdeblurnerf_torch.utils.precision import set_matmul_precision

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    set_matmul_precision("highest")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("rows,S,S2", [(32768, 128, 128), (1000, 8, 8),
                                       (3, 128, 64), (7, 20000, 5),
                                       (10240, 128, 128), (33, 6, 6),
                                       (5, 10, 10), (10240, 32, 32),
                                       (8192, 32, 32)])
def test_permute_lanes_kernel_is_exact(dev, rows, S, S2):
    g = torch.Generator(device=dev).manual_seed(rows)
    x = torch.randn(rows, S, generator=g, device=dev)
    _, perm, inv = lane_shuffle.sort_with_perm(
        torch.rand(rows, S, generator=g, device=dev))
    perm = perm[:, :S2].contiguous()
    kernels.reset_launches()
    got = lane_shuffle.permute_lanes(x, perm, inv)
    assert kernels.LAUNCHES["permute_lanes"] == 1
    assert torch.equal(got, lane_shuffle.permute_lanes_plain(x, perm))
    if S2 == S:
        assert torch.equal(lane_shuffle.permute_lanes(got, inv, perm), x)
        # the backward: the same kernel by the inverse permutation
        xg = x.clone().requires_grad_()
        cot = torch.randn(rows, S, generator=g, device=dev)
        lane_shuffle.permute_lanes(xg, perm, inv).backward(cot)
        assert kernels.LAUNCHES["permute_lanes_bwd"] == 1
        assert torch.equal(xg.grad,
                           lane_shuffle.permute_lanes_plain(cot, inv))


@pytest.mark.parametrize("rows,C,S", [(10240, 128, 128), (9, 3, 8),
                                      (5, 2, 20000), (10240, 128, 32)])
def test_permute_lanes_3d_kernel_is_exact(dev, rows, C, S):
    g = torch.Generator(device=dev).manual_seed(rows)
    x = torch.randn(rows, C, S, generator=g, device=dev, requires_grad=True)
    _, perm, inv = lane_shuffle.sort_with_perm(
        torch.rand(rows, S, generator=g, device=dev))
    kernels.reset_launches()
    got = lane_shuffle.permute_lanes(x, perm, inv)
    assert kernels.LAUNCHES["permute_lanes_3d"] == 1
    assert torch.equal(got, lane_shuffle.permute_lanes_plain(x.detach(),
                                                             perm))
    cot = torch.randn(rows, C, S, generator=g, device=dev)
    got.backward(cot)
    assert kernels.LAUNCHES["permute_lanes_3d_bwd"] == 1
    assert torch.equal(x.grad, lane_shuffle.permute_lanes_plain(cot, inv))


def test_permute_lanes_bad_index_is_nan(dev):
    x = torch.randn(2, 8, device=dev)
    idx = torch.tensor([[0, 8], [-1, 7]], dtype=torch.int32, device=dev)
    got = lane_shuffle.permute_lanes(x, idx, idx)
    assert got[0, 0] == x[0, 0] and got[1, 1] == x[1, 7]
    assert bool(torch.isnan(got[0, 1])) and bool(torch.isnan(got[1, 0]))


def test_permute_lanes_bad_index_is_nan_on_the_vector_path(dev):
    """Rows of 128 indices are read four at a time: an index outside
    [0, S) in any of the four places gives NaN there and nowhere else."""
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(6, 128, generator=g, device=dev)
    idx = torch.randint(0, 128, (6, 128), generator=g, device=dev,
                        dtype=torch.int32)
    bad = [(0, 0, -1), (1, 5, 128), (2, 126, 1 << 30), (3, 127, -(1 << 31)),
           (5, 64, 128), (5, 67, -5)]
    for r, j, k in bad:
        idx[r, j] = k
    got = lane_shuffle.permute_lanes(x, idx, idx)
    want_nan = torch.zeros(6, 128, dtype=torch.bool, device=dev)
    for r, j, _ in bad:
        want_nan[r, j] = True
    assert torch.equal(torch.isnan(got), want_nan)
    keep = ~want_nan
    want = torch.gather(x, -1, idx.clamp(0, 127).long())
    assert torch.equal(got[keep], want[keep])


def test_wrappers_check_their_inputs(dev):
    x = torch.randn(4, 8, device=dev)
    idx = torch.zeros(4, 8, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        lane_shuffle.permute_lanes(x, idx.T, idx)
    with pytest.raises(TypeError):
        lane_shuffle.permute_lanes(x, idx.long(), idx)
    with pytest.raises(ValueError, match="several devices"):
        lane_shuffle.permute_lanes(x, idx.cpu(), idx.cpu())
    with pytest.raises(NotImplementedError, match="K3"):
        lane_shuffle.cdf_take(x.requires_grad_(), x.detach(), idx, idx)
    with pytest.raises(ValueError, match="D="):
        line_matmul.line_grad(idx[:, 0].contiguous(), x.detach(), 0)


@pytest.mark.parametrize("R,M,Mb,N", [(32768, 63, 63, 64), (17, 5, 5, 5),
                                      (40, 9, 12, 200)])
def test_cdf_take_kernel_is_exact(dev, R, M, Mb, N):
    g = torch.Generator(device=dev).manual_seed(R)
    cdf = torch.rand(R, M, generator=g, device=dev)
    bins = torch.rand(R, Mb, generator=g, device=dev)
    below = torch.randint(0, min(M, Mb), (R, N), generator=g, device=dev,
                          dtype=torch.int32)
    above = torch.randint(0, min(M, Mb), (R, N), generator=g, device=dev,
                          dtype=torch.int32)
    got = lane_shuffle.cdf_take(cdf, bins, below, above)
    want = lane_shuffle.cdf_take_plain(cdf, bins, below, above)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _tables(dev, g, comps, grid):
    planes, lines = [], []
    for i, c in enumerate(comps):
        m0, m1 = triplane.MAT_MODE[i]
        planes.append(torch.randn(c, grid[m1], grid[m0], generator=g,
                                  device=dev))
        lines.append(torch.randn(c, grid[triplane.VEC_MODE[i]], generator=g,
                                 device=dev))
    return planes, lines


def _k4_points(dev, g, n, grid):
    """Uniform points past [-1, 1], the corners, and points exactly on
    texel boundaries of every axis (f == floor(f)), first and last texel
    and one outside among them."""
    xyz = torch.rand(n, 3, generator=g, device=dev) * 2.6 - 1.3
    xyz[:6] = torch.tensor([[1.0, 1.0, 1.0], [-1.0, -1.0, -1.0],
                            [1.0, -1.0, 0.0], [-1.05, 1.05, 0.999],
                            [0.0, 0.0, 0.0], [2.0, -3.0, 1.0]], device=dev)
    m = min(grid) + 2
    for a, size in enumerate(grid):
        xyz[6:6 + m, a] = (torch.arange(-1, m - 1, device=dev)
                           / (size - 1) * 2 - 1)
    return xyz


def _misaligned(t):
    """A contiguous copy of ``t`` that starts 4 bytes off a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 == 4 and out.is_contiguous()
    return out


@pytest.mark.parametrize("comps,grid,n,shift,mode", [
    ((8, 4, 4), (19, 17, 13), 5000, None, fused_sample.K4_FLOAT4),
    ((64, 16, 16), (302, 302, 183), 1 << 20, None, fused_sample.K4_FLOAT4),
    # 6 and 33 lanes' worth of channels: idle lanes, and a second trip
    ((24, 132, 4), (9, 11, 7), 3001, None, fused_sample.K4_FLOAT4),
    ((6, 3, 5), (19, 17, 13), 5000, None, fused_sample.K4_SCALAR),
    # a table off a 16-byte boundary takes the scalar kernel
    ((8, 4, 4), (19, 17, 13), 5000, "plane", fused_sample.K4_SCALAR),
    ((64, 16, 16), (40, 36, 33), 70001, "line", fused_sample.K4_SCALAR)])
def test_triplane_kernel_matches_plain(dev, comps, grid, n, shift, mode):
    """K4 in the form that the shapes, or an unaligned view, force: bitwise
    equal to its plain twin, which rounds at the same places."""
    g = torch.Generator(device=dev).manual_seed(n)
    planes, lines = _tables(dev, g, comps, grid)
    pp, pl, sizes = triplane.pack_grids(planes, lines)
    if shift == "plane":
        pp = [pp[0], _misaligned(pp[1]), pp[2]]
    elif shift == "line":
        pl = [pl[0], pl[1], _misaligned(pl[2])]
    xyz = _k4_points(dev, g, n, grid)
    probe = torch.empty(4, device=dev)
    assert fused_sample._k4_mode(comps, (*pp, *pl, probe)) == mode
    kernels.reset_launches()
    got = fused_sample.triplane_features(pp, pl, sizes, xyz)
    assert kernels.LAUNCHES["triplane_features"] == 1
    want = triplane.triplane_features_packed(pp, pl, sizes, xyz)
    assert got.shape == (n, sum(comps))
    assert torch.equal(got, want)
    # and against the unpacked sampler, which the packing must not change
    unpacked = triplane.triplane_features(planes, [l for l in lines], xyz)
    assert float((got - unpacked).abs().max()) <= 1e-5 * float(
        unpacked.abs().max())


def test_triplane_kernel_forms_agree_bitwise(dev):
    """The float4 kernel, the scalar kernel (forced by an unaligned table)
    and the float4 kernel over texel-major unpacked tables give the same
    bits."""
    g = torch.Generator(device=dev).manual_seed(3)
    grid = (61, 47, 29)
    planes, lines = _tables(dev, g, (64, 16, 16), grid)
    pp, pl, sizes = triplane.pack_grids(planes, lines)
    xyz = _k4_points(dev, g, 200_003, grid)
    wide = fused_sample.triplane_features(pp, pl, sizes, xyz)
    scalar = fused_sample.triplane_features(
        [_misaligned(pp[0]), pp[1], pp[2]], pl, sizes, xyz)
    rows, lrows, usizes = fused_sample.unpack_grids(planes, lines)
    assert list(usizes) == list(sizes)
    unpacked = fused_sample.triplane_features_unpacked(rows, lrows, usizes,
                                                       xyz)
    assert torch.equal(wide, scalar)
    assert torch.equal(wide, unpacked)
    with pytest.raises(ValueError, match="float4"):
        fused_sample.triplane_features_unpacked(
            [_misaligned(rows[0]), rows[1], rows[2]], lrows, usizes, xyz)
    with pytest.raises(NotImplementedError, match="sample_grids"):
        fused_sample.triplane_features(pp, pl, sizes, xyz.requires_grad_())


def test_triplane_kernel_nan_coords_stay_in_bounds(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    planes, lines = _tables(dev, g, (4, 2, 2), (9, 8, 7))
    pp, pl, sizes = triplane.pack_grids(planes, lines)
    xyz = torch.tensor([[float("nan"), 0.0, 0.0], [0.1, 0.2, 0.3]],
                       device=dev)
    got = fused_sample.triplane_features(pp, pl, sizes, xyz)
    torch.cuda.synchronize()
    assert bool(torch.isnan(got[0, :4]).all())
    want = triplane.triplane_features_packed(pp, pl, sizes, xyz[1:])
    assert torch.equal(got[1:], want)


def _line_idx(dev, g, D, n, stream):
    """Row indices [n] int32: uniform, or sorted into long runs as the
    lines that follow x and y see them on a ray-ordered stream."""
    idx = torch.randint(0, D, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    if stream == "runs":
        idx = torch.sort(idx)[0].contiguous()
    idx[:3] = torch.tensor([-1, D, D - 1], device=dev)   # out of range: no-op
    idx[n // 2] = 1 << 30
    return idx


@pytest.mark.parametrize("D,W,n,stream", [
    (366, 128, 1 << 20, "uniform"), (605, 32, 300000, "uniform"),
    (5, 3, 1000, "uniform"),            # W no multiple of 4, one small tile
    (366, 128, 1 << 20, "runs"), (605, 32, 300000, "runs"),
    (183, 128, 655360, "uniform"),      # the coarse 64-component line
    (2000, 64, 200000, "uniform"),      # above the tile: split along D
    (300, 200, 100000, "uniform"),      # split along W: 128 + 72 columns
    (1500, 130, 50000, "runs"),         # split along both
    (7, 70, 5000, "uniform")])          # three columns a lane, six masked
def test_line_grad_kernel_matches_plain(dev, D, W, n, stream):
    g = torch.Generator(device=dev).manual_seed(n)
    idx = _line_idx(dev, g, D, n, stream)
    rows = torch.randn(n, W, generator=g, device=dev)
    kernels.reset_launches()
    got = line_matmul.line_grad(idx, rows, D)
    assert kernels.LAUNCHES["line_grad"] == 1
    keep = (idx >= 0) & (idx < D)
    want = torch.zeros(D, W, device=dev).index_add_(0, idx[keep].long(),
                                                    rows[keep])
    tol = 1e-5 * float(want.abs().max())
    twin = line_matmul.line_grad_plain(idx, rows, D)     # drops them itself
    assert float((twin - want).abs().max()) <= tol
    assert float((got - want).abs().max()) <= tol
    # a second run adds in another order: the same bound holds
    again = line_matmul.line_grad(idx, rows, D)
    assert float((again - want).abs().max()) <= tol


@pytest.mark.parametrize("Ds,Ws,n,stream", [
    ((366, 605, 605), (128, 32, 32), 300000, "uniform"),   # the fine tables
    ((366, 605, 605), (128, 32, 32), 300000, "runs"),
    ((183, 302, 302), (128, 32, 32), 655360, "uniform"),   # the coarse ones
    ((13, 19, 17), (12, 6, 6), 3000, "uniform"),
    ((2000, 9, 40), (64, 2, 200), 20000, "runs")])         # splits, C = 1
def test_line_grad_tables_match_three_calls(dev, Ds, Ws, n, stream):
    """One launch for three tables, the pack VJP folded in, against three
    one-table launches and against the plain twin."""
    g = torch.Generator(device=dev).manual_seed(n + sum(Ws))
    idx = [_line_idx(dev, g, D, n, stream) for D in Ds]
    rows = [torch.randn(n, W, generator=g, device=dev) for W in Ws]
    kernels.reset_launches()
    got = line_matmul.line_grad_tables(idx, rows, Ds)
    assert kernels.LAUNCHES["line_grad"] == 1
    single = [line_matmul.pack_line_vjp(line_matmul.line_grad(i, r, D))
              for i, r, D in zip(idx, rows, Ds)]
    want = line_matmul.line_grad_tables_plain(idx, rows, Ds)
    for a, b, c in zip(got, single, want):
        assert a.shape == b.shape == c.shape and a.is_contiguous()
        tol = 1e-5 * float(c.abs().max())
        assert float((a - c).abs().max()) <= tol
        assert float((a - b).abs().max()) <= 2 * tol


def _clustered(dev, g, groups, H, W, spread, outliers):
    """Texel coordinates of ``groups`` clusters of 128 points, a share
    ``outliers`` of them thrown anywhere on the plane."""
    n = groups * tiled_gather.GROUP
    cu = torch.rand(groups, 1, generator=g, device=dev) * (W - 5) + 2
    cv = torch.rand(groups, 1, generator=g, device=dev) * (H - 5) + 2
    fu = cu + spread * torch.randn(groups, tiled_gather.GROUP, generator=g,
                                   device=dev)
    fv = cv + spread * torch.randn(groups, tiled_gather.GROUP, generator=g,
                                   device=dev)
    far = torch.rand(n, generator=g, device=dev) < outliers
    fu = torch.where(far, torch.rand(n, generator=g, device=dev) * W,
                     fu.reshape(-1))
    fv = torch.where(far, torch.rand(n, generator=g, device=dev) * H,
                     fv.reshape(-1))
    return (fu.clamp(0, W - 1.001).contiguous(),
            fv.clamp(0, H - 1.001).contiguous())


@pytest.mark.parametrize("H,W,C,TH,TW,groups", [
    (512, 512, 64, 64, 64, 512),      # the bench's plane and default tile
    (512, 512, 64, 48, 128, 64),      # the bench's largest tile
    (96, 80, 16, 32, 32, 5), (64, 64, 8, 8, 8, 4),
    (40, 33, 12, 16, 9, 3),           # 3 threads a point, a non-square tile
    (33, 40, 4, 33, 40, 2),           # the tile is the whole plane
    (128, 128, 8, 128, 128, 4)])      # 512 KiB a tile: nothing is staged
def test_tiled_gather_kernel_is_exact(dev, H, W, C, TH, TW, groups):
    g = torch.Generator(device=dev).manual_seed(H * W + C)
    plane = torch.randn(H, W, C, generator=g, device=dev)
    fu, fv = _clustered(dev, g, groups, H, W, spread=TW / 8, outliers=0.05)
    oy, ox, ok = tiled_gather.group_origins(fu, fv, H, W, TH, TW)
    kernels.reset_launches()
    got = tiled_gather.tiled_plane_gather(plane, fu, fv, oy, ox, TH, TW)
    assert kernels.LAUNCHES["tiled_plane_gather"] == 1
    want = tiled_gather.tiled_plane_gather_plain(plane, fu, fv, oy, ox, TH,
                                                 TW)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert bool(ok.any()) and bool((got[~ok] == 0).all())
    direct = tiled_gather.bilinear_gather(plane, fu, fv)
    torch.testing.assert_close(got[ok], direct[ok], rtol=1e-5, atol=1e-5)
    full = tiled_gather.tiled_plane_gather_with_fallback(
        plane, fu, fv, TH, TW, spill_capacity_frac=1.0)
    torch.testing.assert_close(full, direct, rtol=1e-5, atol=1e-5)


def test_tiled_gather_clamps_origins_outside_the_plane(dev):
    """Origins whose tiles would leave the plane: the kernel reads the
    nearest tile inside, as its plain version does, and nothing else."""
    H, W, C, TH, TW, groups = 96, 80, 16, 32, 32, 6
    g = torch.Generator(device=dev).manual_seed(11)
    plane = torch.randn(H, W, C, generator=g, device=dev)
    fu, fv = _clustered(dev, g, groups, H, W, spread=4.0, outliers=0.05)
    oy, ox, _ = tiled_gather.group_origins(fu, fv, H, W, TH, TW)
    oy = oy + torch.tensor([-500, 500, 0, 7, -1, 90], dtype=torch.int32,
                           device=dev)
    ox = ox + torch.tensor([300, -2, -300, 0, 60, 1], dtype=torch.int32,
                           device=dev)
    got = tiled_gather.tiled_plane_gather(plane, fu, fv, oy, ox, TH, TW)
    want = tiled_gather.tiled_plane_gather_plain(plane, fu, fv, oy, ox, TH,
                                                 TW)
    inside = tiled_gather.tiled_plane_gather(
        plane, fu, fv, oy.clamp(0, H - TH), ox.clamp(0, W - TW), TH, TW)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got, inside)


def test_tiled_gather_poisons_and_checks_its_inputs(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    plane = torch.randn(64, 64, 8, generator=g, device=dev)
    n = 4 * tiled_gather.GROUP
    fu = torch.rand(n, generator=g, device=dev) * 62
    fv = torch.rand(n, generator=g, device=dev) * 62
    out = tiled_gather.tiled_plane_gather_with_fallback(
        plane, fu, fv, 8, 8, spill_capacity_frac=0.01)
    assert bool(torch.isnan(out).all())
    oy, ox, _ = tiled_gather.group_origins(fu, fv, 64, 64, 8, 8)
    kernels.reset_launches()
    with pytest.raises(ValueError, match="multiples of 4"):
        tiled_gather.tiled_plane_gather(plane[..., :6].contiguous(), fu, fv,
                                        oy, ox, 8, 8)
    with pytest.raises(TypeError, match="int32"):
        tiled_gather.tiled_plane_gather(plane, fu, fv, oy.long(), ox.long(),
                                        8, 8)
    with pytest.raises(ValueError, match="contiguous"):
        tiled_gather.tiled_plane_gather(plane.transpose(0, 1), fu, fv, oy, ox,
                                        8, 8)
    with pytest.raises(NotImplementedError, match="forward-only"):
        tiled_gather.tiled_plane_gather(plane.clone().requires_grad_(), fu,
                                        fv, oy, ox, 8, 8)
    assert kernels.LAUNCHES["tiled_plane_gather"] == 0


def test_tiled_gather_group_that_spills_whole(dev):
    """A group none of whose points lies in its tile writes 128 rows of
    zeros, and its neighbours are untouched by it."""
    H, W, C, TH, TW = 96, 80, 12, 16, 9
    g = torch.Generator(device=dev).manual_seed(5)
    plane = torch.randn(H, W, C, generator=g, device=dev)
    fu, fv = _clustered(dev, g, 3, H, W, spread=1.0, outliers=0.0)
    oy, ox, ok = tiled_gather.group_origins(fu, fv, H, W, TH, TW)
    # the middle group's tile goes to the far corner from its points
    mid = slice(tiled_gather.GROUP, 2 * tiled_gather.GROUP)
    oy[1] = 0 if float(fv[mid].mean()) > H / 2 else H - TH
    ox[1] = 0 if float(fu[mid].mean()) > W / 2 else W - TW
    got = tiled_gather.tiled_plane_gather(plane, fu, fv, oy, ox, TH, TW)
    want = tiled_gather.tiled_plane_gather_plain(plane, fu, fv, oy, ox, TH,
                                                 TW)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert bool((got[mid] == 0).all())
    assert bool((got[:tiled_gather.GROUP][ok[:tiled_gather.GROUP]] != 0)
                .any())


def _grad_case(dev, g, comps, grid, n, stream="uniform"):
    planes, lines = _tables(dev, g, comps, grid)
    packed = triplane.pack_grids(planes, lines)
    if stream == "rays":
        # ray-major: 64 samples a ray, a ray crosses a few texels of a plane
        rays = n // 64
        o = torch.rand(rays, 1, 3, generator=g, device=dev) * 2.2 - 1.1
        d = torch.randn(rays, 1, 3, generator=g, device=dev) * \
            torch.tensor([0.02, 0.02, 1.0], device=dev)
        t = torch.sort(torch.rand(rays, 64, 1, generator=g, device=dev), 1)[0]
        xyz = (o + d * t).reshape(-1, 3).contiguous()
        n = xyz.shape[0]
    else:
        xyz = torch.rand(n, 3, generator=g, device=dev) * 2.6 - 1.3
    # texel boundaries, the last texel of every axis, points outside
    xyz[:6] = torch.tensor([[1.0, 1.0, 1.0], [-1.0, -1.0, -1.0],
                            [1.0, -1.0, 0.0], [-1.05, 1.05, 0.999],
                            [0.0, 0.0, 0.0], [2.0, -3.0, 1.0]], device=dev)
    cot = torch.randn(n, sum(comps), generator=g, device=dev)
    return planes, lines, packed, xyz, cot


def _assert_grads_close(got, want):
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.parametrize("comps,grid,n,stream,mode", [
    ((8, 4, 4), (19, 17, 13), 5000, "uniform", "fused"),
    ((64, 16, 16), (302, 302, 183), 1 << 20, "uniform", "fused"),
    ((64, 16, 16), (302, 302, 183), 1 << 19, "rays", "fused"),
    ((64, 16, 16), (605, 605, 366), 1 << 19, "rays", "fused"),
    ((12, 4, 20), (19, 17, 13), 5001, "uniform", "fused"),  # 3, 1, 5 lanes
    ((8, 4, 4), (19, 17, 13), 4096, "rays", "fused"),
    ((128, 4, 8), (9, 8, 300), 70000, "rays", "fused"),     # a warp a point
    ((64, 16, 16), (40, 36, 1024), 1 << 18, "uniform", "float4"),  # tables
    ((64, 16, 16), (40, 36, 1024), 1 << 18, "rays", "float4"),  # too large
    ((160, 4, 4), (9, 8, 7), 777, "uniform", "float4"),     # C above 128
    ((6, 3, 5), (19, 17, 13), 5000, "uniform", "scalar"),
    ((6, 3, 5), (19, 17, 13), 4096, "rays", "scalar")])
def test_triplane_bwd_kernel_matches_plain(dev, comps, grid, n, stream, mode):
    """Each of K5's three kernels, forced by shape, against the twin; K6
    launches only behind the two that write the scratch."""
    g = torch.Generator(device=dev).manual_seed(n)
    planes, lines, packed, xyz, cot = _grad_case(dev, g, comps, grid, n,
                                                 stream)
    got_mode = fused_sample._k5_mode(
        comps, [s[2] for s in packed[2]], (*packed[0], *packed[1], cot), dev)
    assert got_mode == dict(scalar=fused_sample.K5_SCALAR,
                            float4=fused_sample.K5_FLOAT4,
                            fused=fused_sample.K5_FUSED)[mode]
    kernels.reset_launches()
    got = fused_sample.triplane_features_bwd(planes, lines, packed, xyz, cot)
    assert kernels.LAUNCHES["triplane_features_bwd"] == 1
    assert kernels.LAUNCHES["line_grad"] == (0 if mode == "fused" else 1)
    want = fused_sample.triplane_features_bwd_plain(planes, lines, xyz, cot)
    want = [*want[0], *want[1], want[2]]
    _assert_grads_close([*got[0], *got[1], got[2]], want)
    # a second run adds in another order: the same bound holds
    again = fused_sample.triplane_features_bwd(planes, lines, packed, xyz,
                                               cot)
    _assert_grads_close([*again[0], *again[1], again[2]], want)


def test_triplane_bwd_scalar_kernel_equals_float4_kernel(dev):
    """A cotangent that starts off a 16-byte boundary sends the same
    shapes through the scalar kernel and K6 instead of the fused float4
    kernel: both agree with the twin."""
    g = torch.Generator(device=dev).manual_seed(3)
    planes, lines, packed, xyz, cot = _grad_case(dev, g, (8, 4, 4),
                                                 (19, 17, 13), 3000)
    shifted = torch.empty(cot.numel() + 1, device=dev)[1:].view_as(cot)
    shifted.copy_(cot)
    assert shifted.data_ptr() % 16 != 0 and shifted.is_contiguous()
    want = fused_sample.triplane_features_bwd_plain(planes, lines, xyz, cot)
    want = [*want[0], *want[1], want[2]]
    for c in (cot, shifted):
        got = fused_sample.triplane_features_bwd(planes, lines, packed, xyz,
                                                 c)
        _assert_grads_close([*got[0], *got[1], got[2]], want)


def test_sample_grids_card_matches_cpu(dev):
    g = torch.Generator(device=dev).manual_seed(7)
    planes, lines, packed, xyz, cot = _grad_case(dev, g, (8, 4, 4),
                                                 (19, 17, 13), 3000)
    results = []
    for device in (dev, torch.device("cpu")):
        leaves = [t.detach().to(device).requires_grad_()
                  for t in (*planes, *lines, xyz)]
        pk = triplane.pack_grids(leaves[:3], leaves[3:6])
        pk = ([t.detach() for t in pk[0]], [t.detach() for t in pk[1]],
              pk[2])
        out = fused_sample.sample_grids(leaves[:3], leaves[3:6], pk,
                                        leaves[6])
        out.backward(cot.to(device))
        results.append([out.detach().cpu()]
                       + [t.grad.cpu() for t in leaves])
    _assert_grads_close(results[0], results[1])


def test_tiny_render_card_matches_cpu_and_uses_every_kernel(dev):
    cfg = RenderConfig(N_samples=16, N_importance=16, multires=4,
                       multires_views=2, H=32, W=40, focal=30.0,
                       aabb=((-1.6, -1.6, -1.0), (1.6, 1.6, 1.0)),
                       coarse_n_voxels=32768, fine_n_voxels=65536,
                       coarse_app_n_comp=(8, 4, 4), fine_app_n_comp=(8, 4, 4),
                       coarse_hidden_dim=16, coarse_hidden_dim_color=16,
                       fine_hidden_dim=32, fine_hidden_dim_color=32,
                       fine_geo_feat_dim=16, coarse_app_dim=8, fine_app_dim=8)
    cpu = EvDeblurNeRF(cfg, generator=torch.Generator().manual_seed(0))
    card = EvDeblurNeRF(cfg, device=dev)
    card.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(1)
    rays = torch.randn(512, 3, 2, generator=g) * torch.tensor([0.05, 1.0])
    rays[:, 2, 1] = -rays[:, 2, 1].abs() - 0.5
    kernels.reset_launches()
    got = card.render_chunk(rays.to(dev))
    assert all(kernels.LAUNCHES[k] > 0 for k in
               ("permute_lanes", "cdf_take", "triplane_features"))
    want = cpu.render_chunk(rays)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5)


def test_tiny_train_step_card_matches_cpu_and_uses_every_kernel(dev):
    """One training step of the paper's method at a tiny width (chip_smoke's
    flags), perturb 0 and no sigma noise: the card's loss (1e-5) and
    gradients against the CPU's plain versions, and every kernel
    launched."""
    _tiny_step_card_vs_cpu(dev, {})


def test_tiny_culled_train_step_card_matches_cpu(dev):
    """The same step with the fine cull (8 of 32 lanes) and the occupancy
    coarse cull (8 of 16 lanes) on the grid of the initial weights, built
    on the CPU and handed to both, the card replaying the CPU's selections
    (``chip_smoke._Selections``): the loss, every kernel launched, at most
    0.1% of the card's own selected positions differing, and the fields'
    gradients at the same limit. The blur kernel's and AWP's gradients are
    left to ``chip_smoke.py`` phase 13, which holds them at the paper's
    width: here, beside grids of a few thousand voxels, their initial
    gradients (1e-13 to 1e-6) are mostly rounding, and with the culls more
    than 1% of all gradient elements lie beyond the limit even with the
    selections replayed."""
    _tiny_step_card_vs_cpu(dev, dict(fine_cull_capacity=0.25,
                                     coarse_cull_capacity=0.5),
                           held=("mlp_coarse.", "mlp_fine."))


def test_tiny_bf16_train_step_card_matches_cpu(dev):
    """The tiny step with bf16 tables: the loss and gradients at the same
    limits, and K4's and K5's bf16 forms launched."""
    _tiny_step_card_vs_cpu(dev, dict(triplane_bf16=True),
                           launched=kernels.BF16_TRAIN_KERNELS)


def _tiny_step_card_vs_cpu(dev, culls, held=("",),
                           launched=kernels.TRAIN_KERNELS):
    import chip_smoke

    from evdeblurnerf_torch.models.system import build_occ_grid
    from evdeblurnerf_torch.train import state as tstate, step as tstep

    flags = dict(culls)
    culls = {k: v for k, v in culls.items() if "cull" in k}
    args = chip_smoke.train_args(
        coarse_n_voxels=4096, fine_n_voxels=8192,
        coarse_app_n_comp=[8, 4, 4], fine_app_n_comp=[8, 4, 4],
        coarse_hidden_dim=16, coarse_hidden_dim_color=16, fine_hidden_dim=32,
        fine_hidden_dim_color=32, fine_geo_feat_dim=16, N_samples=16,
        N_importance=16, perturb=0.0, raw_noise_std=0.0, **flags)
    step = tstep.build_train_step(args, return_grads=True)
    sw = tstep.schedule_weights_fn(args)(1)
    aabb = ((-1.6, -1.7, -1.0), (1.7, 1.6, 1.0))
    sd = grid = None
    selections = chip_smoke._Selections()
    results = []
    for device in (torch.device("cpu"), dev):
        model, crf = tstate.build_model(
            args, aabb, 48, 64, 50.0, 0.0, 1.0, 30,
            torch.Generator().manual_seed(0) if sd is None else None, device)
        if sd is None:   # copies: the CPU step updates its own weights
            sd = [{k: v.clone() for k, v in m.state_dict().items()}
                  for m in (model, crf)]
            if culls:
                grid = build_occ_grid(model)
        model.load_state_dict(sd[0])
        crf.load_state_dict(sd[1])
        if culls:
            selections.attach(model, replay=device.type == "cuda")
        state = tstate.create_train_state(model, crf, args,
                                          torch.Generator(device=device),
                                          crf_identity_prefit=False)
        batch, ev = chip_smoke.make_train_batch(device, 32, 16)
        kernels.reset_launches()
        aux = step(state, batch, ev, sw, False, True,
                   fine_cull=bool(culls), coarse_cull=bool(culls),
                   occ_grid=None if grid is None else grid.to(device))
        if device.type == "cuda":
            assert all(kernels.LAUNCHES[k] > 0
                       for k in launched), kernels.LAUNCHES
        results.append(aux)
    cpu, card = results
    torch.testing.assert_close(card["loss"].cpu(), cpu["loss"], rtol=1e-5,
                               atol=1e-6)
    assert set(card["grads"]) == set(cpu["grads"])
    # held in aggregate, as chip_smoke.py's phase 7 holds the paper step:
    # importance draws in near-empty bins flip between the card's and the
    # CPU's last-bit-different coarse weights and move those rays' samples,
    # and at the init's near-zero motions the screw exponential divides by
    # |r| ~ 1e-6, so single gradients of the blur kernel and AWP amplify
    # rounding; fewer than 1% of all gradient elements may differ by more
    # than 1e-3 of their parameter's largest gradient
    total = beyond = 0
    for name, want in cpu["grads"].items():
        if not name.startswith(held):
            continue
        diff = (card["grads"][name].cpu() - want).abs()
        beyond += int((diff > 1e-3 * float(want.abs().max())).sum())
        total += want.numel()
    assert beyond <= 0.01 * total, (beyond, total)
    if culls:
        assert selections.done() <= 1e-3, (selections.n_diff,
                                           selections.n_pos)


def _misaligned_bf16(t, off=1):
    """A contiguous copy of bf16 ``t`` that starts ``off`` elements past a
    16-byte boundary: 1 puts it 2 bytes off an 8-byte boundary (no vector
    form reads it), 4 on an 8-byte boundary off a 16-byte one (four
    channels a lane read it, eight do not)."""
    buf = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    out = buf[off:off + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 == 2 * off and out.is_contiguous()
    return out


def _bf16_packed(planes, lines):
    return triplane.pack_grids([p.to(torch.bfloat16) for p in planes],
                               [l.to(torch.bfloat16) for l in lines])


@pytest.mark.parametrize("compute", [False, True])
@pytest.mark.parametrize("comps,grid,n,shift,mode", [
    ((8, 4, 4), (19, 17, 13), 5000, None, fused_sample.K4_FLOAT4),
    ((64, 16, 16), (302, 302, 183), 1 << 20, None, fused_sample.K4_VEC8),
    ((24, 132, 4), (9, 11, 7), 3001, None, fused_sample.K4_FLOAT4),
    ((8, 8, 16), (19, 17, 13), 5000, None, fused_sample.K4_VEC8),
    ((6, 3, 5), (19, 17, 13), 5000, None, fused_sample.K4_SCALAR),
    # a table off an 8-byte boundary takes the scalar kernel, one on an
    # 8-byte boundary off a 16-byte one four channels a lane
    ((8, 4, 4), (19, 17, 13), 5000, "plane", fused_sample.K4_SCALAR),
    ((64, 16, 16), (40, 36, 33), 70001, "line", fused_sample.K4_SCALAR),
    ((64, 16, 16), (40, 36, 33), 70001, "plane8", fused_sample.K4_FLOAT4)])
def test_triplane_bf16_kernels_match_plain(dev, comps, grid, n, shift, mode,
                                           compute):
    """K4 over bf16 tables, in the bf16-row form (f32 math and output) and
    the bf16-compute form (the eval chain, bf16 output), each in the
    kernel the shapes or an unaligned view force: bitwise equal to the
    twin, and counted under its own name."""
    g = torch.Generator(device=dev).manual_seed(n + int(compute))
    planes, lines = _tables(dev, g, comps, grid)
    pp, pl, sizes = _bf16_packed(planes, lines)
    if shift == "plane":
        pp = [pp[0], _misaligned_bf16(pp[1]), pp[2]]
    elif shift == "plane8":
        pp = [pp[0], _misaligned_bf16(pp[1], 4), pp[2]]
    elif shift == "line":
        pl = [pl[0], pl[1], _misaligned_bf16(pl[2])]
    xyz = _k4_points(dev, g, n, grid)
    probe = torch.empty(8, device=dev, dtype=torch.bfloat16 if compute
                        else torch.float32)
    assert fused_sample._k4_mode(comps, (*pp, *pl, probe)) == mode
    kernels.reset_launches()
    got = fused_sample.triplane_features(pp, pl, sizes, xyz,
                                         compute_bf16=compute)
    name = ("triplane_features_bf16_compute" if compute
            else "triplane_features_bf16")
    assert kernels.LAUNCHES[name] == 1
    assert kernels.LAUNCHES["triplane_features"] == 0
    want = triplane.triplane_features_packed(pp, pl, sizes, xyz,
                                             compute_bf16=compute)
    assert got.dtype == want.dtype == (torch.bfloat16 if compute
                                       else torch.float32)
    assert got.shape == (n, sum(comps))
    assert torch.equal(got, want)


@pytest.mark.parametrize("compute", [False, True])
@pytest.mark.parametrize("comps,grid,n", [
    ((8, 8, 16), (19, 17, 13), 5000),
    ((64, 16, 16), (302, 302, 183), 1 << 20)])
def test_triplane_bf16_vec8_kernel_matches_plain(dev, comps, grid, n,
                                                 compute):
    """K4's vector kernel on eight channels a lane (16-byte bf16 loads),
    asked for as the bench tool asks: bitwise equal to the twin in both
    bf16 forms; component counts that are no multiple of 8, f32 tables or
    a table off a 16-byte boundary are refused, and four channels a lane
    asked for give the same bits."""
    g = torch.Generator(device=dev).manual_seed(n + int(compute))
    planes, lines = _tables(dev, g, comps, grid)
    pp, pl, sizes = _bf16_packed(planes, lines)
    xyz = _k4_points(dev, g, n, grid)
    got = fused_sample._launch_k4("k4", pp, pl, sizes, xyz,
                                  compute_bf16=compute,
                                  mode=fused_sample.K4_VEC8)
    want = triplane.triplane_features_packed(pp, pl, sizes, xyz,
                                             compute_bf16=compute)
    assert got.dtype == want.dtype
    assert torch.equal(got, want)
    assert torch.equal(fused_sample._launch_k4(
        "k4", pp, pl, sizes, xyz, compute_bf16=compute,
        mode=fused_sample.K4_FLOAT4), want)
    for bad in (dict(pp=[pp[0], _misaligned_bf16(pp[1], 4), pp[2]]),
                dict(pp=[p.float() for p in pp], pl=[l.float() for l in pl])):
        with pytest.raises(ValueError, match="channels a lane"):
            fused_sample._launch_k4("k4", bad.get("pp", pp),
                                    bad.get("pl", pl), sizes, xyz,
                                    mode=fused_sample.K4_VEC8)
    p12, l12, s12 = _bf16_packed(*_tables(dev, g, (12, 8, 8), grid))
    with pytest.raises(ValueError, match="channels a lane"):
        fused_sample._launch_k4("k4", p12, l12, s12, xyz,
                                mode=fused_sample.K4_VEC8)


@pytest.mark.parametrize("comps,grid,n,stream,mode", [
    ((8, 4, 4), (19, 17, 13), 5000, "uniform", "fused"),
    ((64, 16, 16), (302, 302, 183), 1 << 20, "uniform", "fused"),
    ((64, 16, 16), (605, 605, 366), 1 << 19, "rays", "fused"),
    ((12, 4, 20), (19, 17, 13), 5001, "uniform", "fused"),
    ((64, 16, 16), (40, 36, 1024), 1 << 18, "rays", "float4"),
    ((160, 4, 4), (9, 8, 7), 777, "uniform", "float4"),
    ((6, 3, 5), (19, 17, 13), 5000, "uniform", "scalar")])
def test_triplane_bwd_bf16_kernel_matches_plain(dev, comps, grid, n, stream,
                                                mode):
    """K5 over the bf16 pack the forward reads, each kernel forced by
    shape: every gradient within 1e-5 of the twin (autograd through the
    packing, the straight-through bf16 rounding and the sampler), the grid
    gradients exact f32."""
    g = torch.Generator(device=dev).manual_seed(n)
    planes, lines, _, xyz, cot = _grad_case(dev, g, comps, grid, n, stream)
    packed = _bf16_packed(planes, lines)
    assert fused_sample._k5_mode(
        comps, [s[2] for s in packed[2]], (*packed[0], *packed[1], cot),
        dev) == dict(scalar=fused_sample.K5_SCALAR,
                     float4=fused_sample.K5_FLOAT4,
                     fused=fused_sample.K5_FUSED)[mode]
    kernels.reset_launches()
    got = fused_sample.triplane_features_bwd(planes, lines, packed, xyz, cot)
    assert kernels.LAUNCHES["triplane_features_bwd_bf16"] == 1
    assert kernels.LAUNCHES["triplane_features_bwd"] == 0
    want = fused_sample.triplane_features_bwd_plain(planes, lines, xyz, cot,
                                                    table_bf16=True)
    want = [*want[0], *want[1], want[2]]
    got = [*got[0], *got[1], got[2]]
    _assert_grads_close(got, want)
    assert not torch.equal(got[0], got[0].to(torch.bfloat16).float())


@pytest.mark.parametrize("D,W,n", [(366, 128, 1 << 20), (605, 32, 300000),
                                   (2000, 64, 200000), (7, 70, 5000)])
def test_line_grad_default_precision_matches_plain(dev, D, W, n):
    """K6's "default" precision: the cotangent rounded to bf16 as it is
    loaded, summed in f32; within 1e-5 of the twin's largest, and away
    from the "highest" sums."""
    g = torch.Generator(device=dev).manual_seed(n + 1)
    idx = _line_idx(dev, g, D, n, "uniform")
    rows = torch.randn(n, W, generator=g, device=dev)
    kernels.reset_launches()
    got = line_matmul.line_grad(idx, rows, D, precision="default")
    assert kernels.LAUNCHES["line_grad"] == 1
    want = line_matmul.line_grad_plain(idx, rows, D, precision="default")
    tol = 1e-5 * float(want.abs().max())
    assert float((got - want).abs().max()) <= tol
    exact = line_matmul.line_grad_plain(idx, rows, D)
    assert float((exact - want).abs().max()) > tol
    with pytest.raises(ValueError, match="precision"):
        line_matmul.line_grad(idx, rows, D, precision="high")


# ---------------------------------------------------------------------------
# the captured training step (train/capture.py): one graph per key
# ---------------------------------------------------------------------------

CAPTURE_STEPS = 5


def _tiny_capture_run(dev, captured):
    """``CAPTURE_STEPS`` tiny deterministic paper steps (no jitter, no
    sigma noise) from one seeded state on the card, through the eager step
    or the captured one: (state, step, losses, the packed tables' and
    Adam states' addresses after the first step)."""
    import chip_smoke

    from evdeblurnerf_torch.train import capture
    from evdeblurnerf_torch.train import state as tstate
    from evdeblurnerf_torch.train import step as tstep

    args = chip_smoke.train_args(
        coarse_n_voxels=4096, fine_n_voxels=8192,
        coarse_app_n_comp=[8, 4, 4], fine_app_n_comp=[8, 4, 4],
        coarse_hidden_dim=16, coarse_hidden_dim_color=16, fine_hidden_dim=32,
        fine_hidden_dim_color=32, fine_geo_feat_dim=16, N_samples=16,
        N_importance=16, perturb=0.0, raw_noise_std=0.0)
    model, crf = tstate.build_model(
        args, ((-1.6, -1.7, -1.0), (1.7, 1.6, 1.0)), 48, 64, 50.0, 0.0, 1.0,
        30, torch.Generator(device=dev).manual_seed(0), dev)
    state = tstate.create_train_state(
        model, crf, args, torch.Generator(device=dev).manual_seed(1),
        crf_identity_prefit=False)
    step = (capture.CapturedStep(args) if captured
            else tstep.build_train_step(args))
    sw = tstep.schedule_weights_fn(args)
    batch, ev = chip_smoke.make_train_batch(dev, 32, 16)
    losses, ptrs = [], None
    for i in range(CAPTURE_STEPS):
        losses.append(float(step(state, batch, ev, sw(i), False,
                                 True)["loss"]))
        if i == 0:
            ptrs = _capture_addresses(state)
    return state, step, losses, ptrs


def _capture_addresses(state):
    tables = [t.data_ptr() for f in (state.model.mlp_coarse,
                                     state.model.mlp_fine)
              for t in (*f._packed()[0], *f._packed()[1])]
    adam = {id(p): [v.data_ptr() for v in st.values()]
            for p, st in state.optimizer.state.items()}
    return tables, adam


def _weights_beyond(a, b):
    """The share of all model weights of ``b`` beyond 1e-3 of their
    parameter's largest magnitude in ``a``."""
    total = beyond = 0
    with torch.no_grad():
        for p, q in zip(b.model.parameters(), a.model.parameters()):
            scale = max(float(q.abs().max()), 1e-6)
            beyond += int(((p - q).abs() > 1e-3 * scale).sum())
            total += q.numel()
    return beyond / total


def test_captured_step_replay_equals_eager(dev):
    """The captured step (an eager warm-up, a capture replayed once, then
    replays) against the eager step from one state: per-step loss within
    1e-5 relative (K5's atomics), one graph; the weights' share beyond
    1e-3 of their parameter's largest within max(1%, 4 x that of two
    eager runs): Adam's first steps move a weight by about the rate
    whatever the size of its gradient, so the atomics' last bits reach
    some weights whole, in two eager runs as well."""
    eager, _, want, _ = _tiny_capture_run(dev, False)
    again, _, _, _ = _tiny_capture_run(dev, False)
    state, step, got, _ = _tiny_capture_run(dev, True)
    assert len(step.graphs) == 1
    torch.testing.assert_close(torch.tensor(got), torch.tensor(want),
                               rtol=1e-5, atol=1e-7)
    spread = _weights_beyond(eager, again)
    assert _weights_beyond(eager, state) <= max(0.01, 4 * spread), spread


def test_captured_step_repacks_tables_in_place(dev):
    """After the replays the packed tables sit where the first step left
    them and hold a fresh pack of the trained grids, bitwise."""
    state, _, _, (tables, _) = _tiny_capture_run(dev, True)
    now, _ = _capture_addresses(state)
    assert now == tables
    for field in (state.model.mlp_coarse, state.model.mlp_fine):
        planes, lines, _ = triplane.pack_grids(*field.grids())
        for t, want in zip((*field._packed()[0], *field._packed()[1]),
                           (*planes, *lines)):
            assert torch.equal(t, want)


def test_captured_step_makes_adam_state_outside_capture(dev):
    """Adam's state is made by the eager first step and kept: the same
    tensors after the capture and the replays, each count at the number of
    steps (a state made inside the capture would be zeroed by every
    replay and count one)."""
    state, _, _, (_, adam) = _tiny_capture_run(dev, True)
    _, now = _capture_addresses(state)
    assert now == adam and len(adam) > 10
    for st in state.optimizer.state.values():
        assert int(st["step"]) == CAPTURE_STEPS
        assert st["step"].device.type == "cuda"
        assert float(st["exp_avg_sq"].abs().max()) > 0
