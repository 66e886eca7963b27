"""K7 of the port on the CPU: the plain twin of ``tiled_plane_gather``,
``group_origins``, ``morton_code_2d`` and the fallback against the JAX
functions (the Pallas kernel in interpret mode) on the three cases of
tests/test_tiled_gather.py and three of the port's own (groups that are
ray segments, 12 channels under a 16 x 9 tile, a group that spills whole),
and the port's point stream against tests/locality_geometry.py.

Tolerances: 1e-5 on sampled values, as tests/test_tiled_gather.py holds
the JAX kernel to its reference (the one-hot matmul and the four-corner
sum add in another order); tile origins, the spill mask, Morton codes and
the point stream are equal exactly.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evdeblurnerf_torch.ops import tiled_gather as tg
from evdeblurnerf_torch.utils import locality
from evdeblurnerf_tpu.ops import tiled_gather as jtg
from locality_geometry import step_points_xyz as jax_step_points
from test_tiled_gather import _clustered_points, _reference

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _case(name):
    """(plane, fu, fv, TH, TW, capacity) of one case: the three of
    tests/test_tiled_gather.py:38-82 and the port's three."""
    if name == "no_spills":
        rng = np.random.default_rng(0)
        H, W, C = 96, 80, 16
        plane = rng.normal(size=(H, W, C)).astype(np.float32)
        fu, fv = _clustered_points(rng, n_groups=5, H=H, W=W, spread=4.0)
        return plane, fu, fv, 32, 32, 0.125
    if name == "ray_segments":
        # 16 rays of 128 samples: every group is a line segment on the
        # plane, the geometry of the bench's point stream; a 6 x 6 tile
        # cuts the ends off some segments (7% of the points spill)
        rng = np.random.default_rng(4)
        H, W, C = 64, 64, 8
        plane = rng.normal(size=(H, W, C)).astype(np.float32)
        xyz = locality.step_points_xyz(n_rand=8, ptnum=2, S=128)
        fu = (xyz[:, 0] * (W - 1.001)).astype(np.float32)
        fv = (xyz[:, 1] * (H - 1.001)).astype(np.float32)
        return plane, fu, fv, 6, 6, 0.5
    if name == "c12_tile_16x9":
        rng = np.random.default_rng(5)
        H, W, C = 40, 33, 12
        plane = rng.normal(size=(H, W, C)).astype(np.float32)
        fu, fv = _clustered_points(rng, n_groups=3, H=H, W=W, spread=1.5)
        return plane, fu, fv, 16, 9, 0.5
    if name == "whole_group_spills":
        # group 1 is two far clusters of 64: the median lies between them,
        # and so does the tile, which then holds none of the 128 points
        rng = np.random.default_rng(6)
        H, W, C = 64, 64, 8
        plane = rng.normal(size=(H, W, C)).astype(np.float32)
        fu, fv = _clustered_points(rng, n_groups=3, H=H, W=W, spread=1.0)
        fu[tg.GROUP:tg.GROUP + 64] = rng.uniform(3, 8, 64)
        fu[tg.GROUP + 64:2 * tg.GROUP] = rng.uniform(52, 58, 64)
        return plane, fu, fv, 16, 16, 0.5
    if name == "spills":
        rng = np.random.default_rng(1)
        H, W, C = 96, 80, 8
        plane = rng.normal(size=(H, W, C)).astype(np.float32)
        fu, fv = _clustered_points(rng, n_groups=6, H=H, W=W, spread=5.0)
        n = fu.shape[0]
        out_idx = rng.choice(n, n // 20, replace=False)
        fu[out_idx] = rng.uniform(0, W - 1.001, out_idx.size)
        fv[out_idx] = rng.uniform(0, H - 1.001, out_idx.size)
        return plane, fu, fv, 32, 32, 0.125
    rng = np.random.default_rng(2)
    H, W, C = 64, 64, 8
    plane = rng.normal(size=(H, W, C)).astype(np.float32)
    fu = rng.uniform(0, W - 1.001, 4 * tg.GROUP).astype(np.float32)
    fv = rng.uniform(0, H - 1.001, 4 * tg.GROUP).astype(np.float32)
    return plane, fu, fv, 8, 8, 0.01


CASES = ("no_spills", "spills", "over_capacity", "ray_segments",
         "c12_tile_16x9", "whole_group_spills")


@pytest.mark.parametrize("name", CASES)
def test_group_origins_match_jax_exactly(name):
    plane, fu, fv, TH, TW, _ = _case(name)
    H, W, _ = plane.shape
    joy, jox, jok = jtg.group_origins(jnp.asarray(fu), jnp.asarray(fv), H, W,
                                      TH, TW)
    oy, ox, ok = tg.group_origins(torch.from_numpy(fu), torch.from_numpy(fv),
                                  H, W, TH, TW)
    assert oy.dtype == ox.dtype == torch.int32
    np.testing.assert_array_equal(oy.numpy(), np.asarray(joy))
    np.testing.assert_array_equal(ox.numpy(), np.asarray(jox))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    if name == "no_spills":
        assert bool(ok.all())
    elif name == "whole_group_spills":
        assert not bool(ok[tg.GROUP:2 * tg.GROUP].any())
        assert bool(ok[:tg.GROUP].any()) and bool(ok[2 * tg.GROUP:].any())
    else:
        assert not bool(ok.all())
    assert bool(ok.any())


@pytest.mark.parametrize("name", CASES)
def test_twin_matches_jax_kernel_in_interpret_mode(name):
    """The plain twin against the Pallas kernel: 1e-5 on every row, and
    exact zeros on the spilled rows."""
    plane, fu, fv, TH, TW, _ = _case(name)
    H, W, _ = plane.shape
    joy, jox, jok = jtg.group_origins(jnp.asarray(fu), jnp.asarray(fv), H, W,
                                      TH, TW)
    want = np.asarray(jtg.tiled_plane_gather(
        jnp.asarray(plane), jnp.asarray(fu), jnp.asarray(fv), joy, jox,
        TH=TH, TW=TW, interpret=True))
    tfu, tfv = torch.from_numpy(fu), torch.from_numpy(fv)
    oy, ox, ok = tg.group_origins(tfu, tfv, H, W, TH, TW)
    got = tg.tiled_plane_gather(torch.from_numpy(plane), tfu, tfv, oy, ox,
                                TH=TH, TW=TW).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert (got[~ok.numpy()] == 0).all()
    np.testing.assert_allclose(got[ok.numpy()],
                               _reference(plane, fu, fv)[ok.numpy()],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", CASES)
def test_fallback_matches_jax(name):
    """Within capacity the patched output equals the reference bilinear
    sampler and the JAX function's (1e-5); past it both poison with NaN."""
    plane, fu, fv, TH, TW, frac = _case(name)
    want = np.asarray(jtg.tiled_plane_gather_with_fallback(
        jnp.asarray(plane), jnp.asarray(fu), jnp.asarray(fv), TH=TH, TW=TW,
        spill_capacity_frac=frac, interpret=True))
    got = tg.tiled_plane_gather_with_fallback(
        torch.from_numpy(plane), torch.from_numpy(fu), torch.from_numpy(fv),
        TH=TH, TW=TW, spill_capacity_frac=frac).numpy()
    if name == "over_capacity":
        assert np.isnan(want).any() and np.isnan(got).all()
        return
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, _reference(plane, fu, fv), rtol=1e-5,
                               atol=1e-5)


def test_morton_code_matches_jax():
    rng = np.random.default_rng(3)
    u = np.concatenate([[0, 1, 0, 1, 200, 65535],
                        rng.integers(0, 65536, 64)]).astype(np.uint32)
    v = np.concatenate([[0, 0, 1, 1, 200, 65535],
                        rng.integers(0, 65536, 64)]).astype(np.uint32)
    want = np.asarray(jtg.morton_code_2d(jnp.asarray(u), jnp.asarray(v)))
    got = tg.morton_code_2d(torch.from_numpy(u.astype(np.int64)),
                            torch.from_numpy(v.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert got[4] > got[:4].max() and len(set(got[:5].tolist())) == 5


def test_group_median_averages_the_middle_pair():
    """``jnp.median`` over 128 values averages elements 63 and 64 of the
    sorted group; ``torch.median`` would return the lower."""
    x = torch.arange(tg.GROUP, dtype=torch.float32).flip(0)[None]
    assert float(tg._group_median(x)) == 63.5
    assert float(jnp.median(jnp.asarray(x.numpy()), axis=1)[0]) == 63.5


def test_wrapper_checks_its_arguments():
    plane = torch.zeros(16, 16, 4)
    f = torch.zeros(tg.GROUP)
    o = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiples of 128"):
        tg.tiled_plane_gather(plane, f[:5], f[:5], o, o, TH=8, TW=8)
    with pytest.raises(ValueError, match="does not fit"):
        tg.tiled_plane_gather(plane, f, f, o, o, TH=32, TW=8)
    with pytest.raises(ValueError, match="origins"):
        tg.tiled_plane_gather(plane, f, f, o.repeat(2), o, TH=8, TW=8)


def test_origins_outside_the_plane_are_clamped():
    """An origin that ``group_origins`` would never give (its tile leaves
    the plane) reads as the nearest origin inside: no row comes from
    outside the plane."""
    plane, fu, fv, TH, TW, _ = _case("spills")
    H, W, _ = plane.shape
    tp, tfu, tfv = (torch.from_numpy(a) for a in (plane, fu, fv))
    oy, ox, _ = tg.group_origins(tfu, tfv, H, W, TH, TW)
    wild_y = oy + torch.tensor([-500, 500, 0, 7, -1, 90], dtype=torch.int32)
    wild_x = ox + torch.tensor([300, -2, -300, 0, 60, 1], dtype=torch.int32)
    got = tg.tiled_plane_gather(tp, tfu, tfv, wild_y, wild_x, TH=TH, TW=TW)
    want = tg.tiled_plane_gather(tp, tfu, tfv, wild_y.clamp(0, H - TH),
                                 wild_x.clamp(0, W - TW), TH=TH, TW=TW)
    assert torch.equal(got, want)
    # group 2 kept its row origin and group 3 its column origin only
    assert not torch.equal(got, tg.tiled_plane_gather(tp, tfu, tfv, oy, ox,
                                                      TH=TH, TW=TW))


def test_point_stream_matches_locality_geometry():
    """The port's own copy of the bench's point stream gives the points of
    tests/locality_geometry.py exactly (it computes each ray's own pixel
    instead of a whole image per ray)."""
    want = jax_step_points(n_rand=8, ptnum=3, S=16, seed=5)
    got = locality.step_points_xyz(n_rand=8, ptnum=3, S=16, seed=5)
    assert got.dtype == np.float32 and got.shape == (8 * 3 * 16, 3)
    np.testing.assert_array_equal(got, want)


def test_bench_inputs_and_yardsticks_agree_on_the_cpu():
    """tools/bench_tiled_gather_torch.py at a small stream on the CPU: its
    two yardsticks (the packed row take and ``F.grid_sample``) and the
    tiled gather with fallback sample the same values (1e-4: three
    formulations of one bilinear sum in f32, on values of order 1)."""
    spec = importlib.util.spec_from_file_location(
        "bench_tiled_gather_torch",
        os.path.join(REPO, "tools", "bench_tiled_gather_torch.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    plane, fu, fv = bench.make_inputs("cpu", n_rand=8, ptnum=2, S=16)
    assert plane.shape == (512, 512, 64) and fu.shape[0] % tg.GROUP == 0
    row_take, library = bench.yardsticks(plane, fu, fv)
    ref = row_take()
    torch.testing.assert_close(library(), ref, rtol=1e-4, atol=1e-4)
    got = tg.tiled_plane_gather_with_fallback(plane, fu, fv, 64, 64,
                                              spill_capacity_frac=1.0)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
    with pytest.raises(SystemExit, match="CUDA"):
        if not torch.cuda.is_available():
            bench.main([])
        else:
            raise SystemExit("CUDA card present")
