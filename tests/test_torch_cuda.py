"""The hand-written CUDA kernels against their plain PyTorch twins, on the
card. Every test here needs a CUDA device and nvcc and skips elsewhere.

This file imports neither jax nor the JAX package, so it also runs on a
machine without them; there, skip the repo's conftest (which sets up JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Gathers (K1, K3) must be bitwise equal to the plain versions. K4 rounds at
the same places as its plain twin (no FMA contraction), so it is held to
1e-6 of the output's largest magnitude and is expected to be exact.
"""

import pytest
import torch

from evdeblurnerf_torch import kernels
from evdeblurnerf_torch.models.renderer import RenderConfig
from evdeblurnerf_torch.models.system import EvDeblurNeRF
from evdeblurnerf_torch.ops import fused_sample, lane_shuffle, triplane

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("rows,S,S2", [(32768, 128, 128), (1000, 8, 8),
                                       (3, 128, 64), (7, 20000, 5)])
def test_permute_lanes_kernel_is_exact(dev, rows, S, S2):
    g = torch.Generator(device=dev).manual_seed(rows)
    x = torch.randn(rows, S, generator=g, device=dev)
    _, perm, inv = lane_shuffle.sort_with_perm(
        torch.rand(rows, S, generator=g, device=dev))
    perm = perm[:, :S2].contiguous()
    kernels.reset_launches()
    got = lane_shuffle.permute_lanes(x, perm)
    assert kernels.LAUNCHES["permute_lanes"] == 1
    assert torch.equal(got, lane_shuffle.permute_lanes_plain(x, perm))
    if S2 == S:
        assert torch.equal(lane_shuffle.permute_lanes(got, inv), x)


def test_permute_lanes_bad_index_is_nan(dev):
    x = torch.randn(2, 8, device=dev)
    idx = torch.tensor([[0, 8], [-1, 7]], dtype=torch.int32, device=dev)
    got = lane_shuffle.permute_lanes(x, idx)
    assert got[0, 0] == x[0, 0] and got[1, 1] == x[1, 7]
    assert bool(torch.isnan(got[0, 1])) and bool(torch.isnan(got[1, 0]))


def test_wrappers_check_their_inputs(dev):
    x = torch.randn(4, 8, device=dev)
    idx = torch.zeros(4, 8, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        lane_shuffle.permute_lanes(x, idx.long())
    with pytest.raises(ValueError, match="contiguous"):
        lane_shuffle.permute_lanes(x.T, idx[:, :4])
    with pytest.raises(NotImplementedError, match="K1"):
        lane_shuffle.permute_lanes(x.requires_grad_(), idx)
    with pytest.raises(ValueError, match="several devices"):
        lane_shuffle.permute_lanes(x.detach(), idx.cpu())


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


@pytest.mark.parametrize("comps,grid,n", [((8, 4, 4), (19, 17, 13), 5000),
                                          ((64, 16, 16), (302, 302, 183),
                                           1 << 20)])
def test_triplane_kernel_matches_plain(dev, comps, grid, n):
    g = torch.Generator(device=dev).manual_seed(n)
    planes, lines = _tables(dev, g, comps, grid)
    pp, pl, sizes = triplane.pack_grids(planes, lines)
    xyz = torch.rand(n, 3, generator=g, device=dev) * 2.6 - 1.3
    xyz[:6] = torch.tensor([[1.0, 1.0, 1.0], [-1.0, -1.0, -1.0],
                            [1.0, -1.0, 0.0], [-1.05, 1.05, 0.999],
                            [0.0, 0.0, 0.0], [2.0, -3.0, 1.0]], device=dev)
    got = fused_sample.triplane_features(pp, pl, sizes, xyz)
    want = triplane.triplane_features_packed(pp, pl, sizes, xyz)
    assert got.shape == (n, sum(comps))
    err = float((got - want).abs().max())
    assert err <= 1e-6 * float(want.abs().max())
    # and against the unpacked sampler, which the packing must not change
    unpacked = triplane.triplane_features(planes, [l for l in lines], xyz)
    assert float((got - unpacked).abs().max()) <= 1e-5 * float(
        unpacked.abs().max())


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
    assert all(kernels.LAUNCHES[k] > 0 for k in kernels.KERNELS)
    want = cpu.render_chunk(rays)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5)
