"""The hand-written CUDA kernels against their plain PyTorch twins, on the
card. Every test here needs a CUDA device and nvcc and skips elsewhere.

This file imports neither jax nor the JAX package, so it also runs on a
machine without them; there, skip the repo's conftest (which sets up JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Gathers (K1 and K2, forward and backward, and K3) must be bitwise equal to
the plain versions. K4 rounds at the same places as its plain twin (no FMA
contraction), so it is held to 1e-6 of the output's largest magnitude and
is expected to be exact. K5 and K6 add with atomics, in an order that
changes from run to run, and K5 contracts its products into FMAs: they are
held to 1e-5 of each gradient's largest magnitude (f32 sums of up to a few
thousand terms per entry in another order).
"""

import pytest
import torch

from evdeblurnerf_torch import kernels
from evdeblurnerf_torch.models.renderer import RenderConfig
from evdeblurnerf_torch.models.system import EvDeblurNeRF
from evdeblurnerf_torch.ops import (fused_sample, lane_shuffle, line_matmul,
                                   triplane)

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
                                      (5, 2, 20000)])
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
        line_matmul.line_grad(idx[:, 0].contiguous(), x.detach(), 20000)


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


@pytest.mark.parametrize("D,W,n", [(366, 128, 1 << 20), (605, 32, 300000),
                                   (5, 3, 1000)])
def test_line_grad_kernel_matches_plain(dev, D, W, n):
    g = torch.Generator(device=dev).manual_seed(n)
    idx = torch.randint(0, D, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    idx[:3] = torch.tensor([-1, D, D - 1], device=dev)   # out of range: no-op
    rows = torch.randn(n, W, generator=g, device=dev)
    kernels.reset_launches()
    got = line_matmul.line_grad(idx, rows, D)
    assert kernels.LAUNCHES["line_grad"] == 1
    keep = (idx >= 0) & (idx < D)
    want = line_matmul.line_grad_plain(idx[keep], rows[keep], D)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def _grad_case(dev, g, comps, grid, n):
    planes, lines = _tables(dev, g, comps, grid)
    packed = triplane.pack_grids(planes, lines)
    xyz = torch.rand(n, 3, generator=g, device=dev) * 2.6 - 1.3
    xyz[:6] = torch.tensor([[1.0, 1.0, 1.0], [-1.0, -1.0, -1.0],
                            [1.0, -1.0, 0.0], [-1.05, 1.05, 0.999],
                            [0.0, 0.0, 0.0], [2.0, -3.0, 1.0]], device=dev)
    cot = torch.randn(n, sum(comps), generator=g, device=dev)
    return planes, lines, packed, xyz, cot


def _assert_grads_close(got, want):
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.parametrize("comps,grid,n", [((8, 4, 4), (19, 17, 13), 5000),
                                          ((64, 16, 16), (302, 302, 183),
                                           1 << 20)])
def test_triplane_bwd_kernel_matches_plain(dev, comps, grid, n):
    g = torch.Generator(device=dev).manual_seed(n)
    planes, lines, packed, xyz, cot = _grad_case(dev, g, comps, grid, n)
    kernels.reset_launches()
    got = fused_sample.triplane_features_bwd(planes, lines, packed, xyz, cot)
    assert kernels.LAUNCHES["triplane_features_bwd"] == 1
    assert kernels.LAUNCHES["line_grad"] == 3
    want = fused_sample.triplane_features_bwd_plain(planes, lines, xyz, cot)
    _assert_grads_close([*got[0], *got[1], got[2]],
                        [*want[0], *want[1], want[2]])


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
    import chip_smoke

    from evdeblurnerf_torch.train import state as tstate, step as tstep

    args = chip_smoke.train_args(
        coarse_n_voxels=4096, fine_n_voxels=8192,
        coarse_app_n_comp=[8, 4, 4], fine_app_n_comp=[8, 4, 4],
        coarse_hidden_dim=16, coarse_hidden_dim_color=16, fine_hidden_dim=32,
        fine_hidden_dim_color=32, fine_geo_feat_dim=16, N_samples=16,
        N_importance=16, perturb=0.0, raw_noise_std=0.0)
    step = tstep.build_train_step(args, return_grads=True)
    sw = tstep.schedule_weights_fn(args)(1)
    aabb = ((-1.6, -1.7, -1.0), (1.7, 1.6, 1.0))
    sd = None
    results = []
    for device in (torch.device("cpu"), dev):
        model, crf = tstate.build_model(
            args, aabb, 48, 64, 50.0, 0.0, 1.0, 30,
            torch.Generator().manual_seed(0) if sd is None else None, device)
        if sd is None:   # copies: the CPU step updates its own weights
            sd = [{k: v.clone() for k, v in m.state_dict().items()}
                  for m in (model, crf)]
        model.load_state_dict(sd[0])
        crf.load_state_dict(sd[1])
        state = tstate.create_train_state(model, crf, args,
                                          torch.Generator(device=device),
                                          crf_identity_prefit=False)
        batch, ev = chip_smoke.make_train_batch(device, 32, 16)
        kernels.reset_launches()
        aux = step(state, batch, ev, sw, False, True)
        if device.type == "cuda":
            assert all(kernels.LAUNCHES[k] > 0 for k in kernels.KERNELS), \
                kernels.LAUNCHES
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
        diff = (card["grads"][name].cpu() - want).abs()
        beyond += int((diff > 1e-3 * float(want.abs().max())).sum())
        total += want.numel()
    assert beyond <= 0.01 * total, (beyond, total)
