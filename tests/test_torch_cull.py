"""The port's transmittance fine cull and occupancy coarse cull against the
JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both sides; the JAX
functions run as the JAX package's own tests run them on the CPU. Bounds:
the selection (``_capacity_select_sorted``, ``_cull_select``) and the
occupancy functions bitwise; ``build_occ_grid`` bitwise but for voxels
whose alpha lies within 1e-6 of ``occ_eps`` (counted, and held to a few);
culled renders within the repo's 2e-5 rtol/atol; 5 culled training steps
within 2e-5 relative per-step loss; the port's loop against the JAX loop
across both cull start iterations as ``tests/test_torch_loop.py`` holds
them (2e-2 relative per-step loss, 1e-4 at step 0), with the same scalar
tags, ``train/occ_frac`` and ``train/coarse_cull_active`` included.
Mirrors ``tests/test_fine_cull.py``, ``tests/test_occupancy.py`` and
``tests/test_train.py::test_train_coarse_cull_smoke``.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lockstep_common as lc
import oracle_common as oc
from test_torch_loop import BASE, FULL, _scalars, _targs
from evdeblurnerf_torch import config as tconfig
from evdeblurnerf_torch.models import renderer as trenderer
from evdeblurnerf_torch.models.renderer import RenderConfig, Renderer
from evdeblurnerf_torch.models.system import (EvDeblurNeRF, build_occ_grid,
                                              kernel_config_from_args)
from evdeblurnerf_torch.models.tonemapping import TonemappingTransform
from evdeblurnerf_torch.ops import occupancy as tocc
from evdeblurnerf_torch.train import loop as tloop
from evdeblurnerf_torch.train import step as tstep
from evdeblurnerf_torch.train.state import create_train_state
from evdeblurnerf_torch.utils.convert import (state_dict_from_jax,
                                              train_checkpoint_from_jax)
from evdeblurnerf_tpu import config as jconfig
from evdeblurnerf_tpu.models import renderer as jrenderer
from evdeblurnerf_tpu.models import system as jsystem
from evdeblurnerf_tpu.models.system import EvDeblurNeRF as JModel
from evdeblurnerf_tpu.models.system import \
    kernel_config_from_args as jkernel_config
from evdeblurnerf_tpu.models.tonemapping import \
    TonemappingTransform as JTonemapping
from evdeblurnerf_tpu.ops import occupancy as jocc
from evdeblurnerf_tpu.train import loop as jloop
from evdeblurnerf_tpu.train import optim as joptim
from evdeblurnerf_tpu.train import step as jstep
from evdeblurnerf_tpu.train.state import create_train_state as jcreate
from synthetic import make_synthetic_scene

ATOL = RTOL = 2e-5


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_cfg(jcfg):
    return RenderConfig(**{f.name: getattr(jcfg, f.name)
                           for f in dataclasses.fields(RenderConfig)})


# ---------------------------------------------------------------------------
# the selection
# ---------------------------------------------------------------------------

def _keep_mask(case):
    """(keep [R, S] bool, S_keep) of one selection case."""
    rng = np.random.default_rng(case[1] if isinstance(case, tuple) else 0)
    if case == "all_kept":
        return np.ones((6, 32), bool), 8
    if case == "none_kept":
        return np.zeros((6, 32), bool), 8
    if case == "full_capacity":
        return rng.uniform(size=(6, 16)) > 0.5, 16
    if case == "one_lane_budget":
        return rng.uniform(size=(6, 16)) > 0.5, 1
    _, seed, frac, S, K = case
    return rng.uniform(size=(40, S)) < frac, K


SELECT_CASES = ["all_kept", "none_kept", "full_capacity", "one_lane_budget",
                ("random", 0, 0.3, 32, 8), ("random", 1, 0.7, 32, 8),
                ("random", 2, 0.9, 128, 32), ("random", 3, 0.1, 128, 32),
                ("random", 4, 0.5, 64, 16), ("random", 5, 0.25, 96, 24)]


@pytest.mark.parametrize("case", SELECT_CASES, ids=str)
def test_capacity_select_sorted_matches_jax_bitwise(case):
    """Every case of the shared selection (all kept: decimation; none
    kept: the deepest lane and backfill; overflow and underflow at random
    masks; the whole budget; one lane) gives the JAX positions in the JAX
    order."""
    keep, K = _keep_mask(case)
    want = np.asarray(jrenderer._capacity_select_sorted(jnp.asarray(keep), K))
    got = trenderer._capacity_select_sorted(torch.from_numpy(keep), K)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got == keep.shape[1] - 1).any(-1).all() or K == 0


def _small_cfg(**over):
    """The JAX config of tests/test_occupancy.py at 16 + 16 samples."""
    base = dict(mode="c2f", N_samples=16, N_importance=16, perturb=0.0,
                use_viewdirs=True, multires=4, multires_views=2, ndc=True,
                near=0.0, far=1.0, H=oc.H, W=oc.W, focal=oc.FOCAL,
                aabb=oc.AABB, coarse_n_voxels=4096, fine_n_voxels=8192,
                coarse_app_n_comp=(4, 2, 2), fine_app_n_comp=(4, 2, 2),
                coarse_hidden_dim=8, coarse_hidden_dim_color=8,
                fine_hidden_dim=8, fine_hidden_dim_color=8,
                fine_geo_feat_dim=8, coarse_app_dim=8, fine_app_dim=8,
                kernel_feat_cnl=15, raw_noise_std=0.0)
    base.update(over)
    return jrenderer.RenderConfig(**base)


def _rays(n=24, seed=3):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3)).astype(np.float32) * 0.05
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 0.5
    return np.stack([o, d], axis=-1)


@pytest.mark.parametrize("seed,capacity,eps", [
    (0, 0.25, 1e-3), (1, 0.5, 1e-3), (2, 0.25, 0.0), (3, 0.125, 1e-2)])
def test_cull_select_matches_jax_bitwise(seed, capacity, eps):
    """``_cull_select`` on random unsorted depths, sorted coarse depths and
    coarse weights from saturating to transparent rays: the same lane
    indices. No lane has T within an ulp of eps here; where one did, the
    two sums may round apart (module docstring of the renderer)."""
    rng = np.random.default_rng(seed)
    R, Sc, Si = 48, 16, 16
    z_coarse = np.sort(rng.uniform(0, 1, (R, Sc)), -1).astype(np.float32)
    z_cat = np.concatenate([z_coarse, rng.uniform(0, 1, (R, Si))],
                           -1).astype(np.float32)
    w = rng.uniform(0, 1, (R, Sc)) ** 4
    w = (w / w.sum(-1, keepdims=True)
         * rng.uniform(0, 1, (R, 1))).astype(np.float32)
    w[:4] = 0.0                                # empty rays
    w[4:8] = 0.0
    w[4:8, 3] = 1.0                            # an opaque wall
    jcfg = _small_cfg(fine_cull_capacity=capacity, fine_cull_eps=eps)
    jmod = jrenderer.Renderer(jcfg)
    variables = jmod.init(jax.random.PRNGKey(0), jax.random.PRNGKey(1),
                          _rays(2), is_train=False)
    want = np.asarray(jmod.apply(variables, jnp.asarray(z_cat),
                                 jnp.asarray(z_coarse), jnp.asarray(w),
                                 method=jrenderer.Renderer._cull_select))
    got = Renderer(_port_cfg(jcfg))._cull_select(
        torch.from_numpy(z_cat), torch.from_numpy(z_coarse),
        torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy(), want)


def test_cull_select_drops_occluded_keeps_deepest():
    """The selection rule as ``tests/test_fine_cull.py`` pins it: behind an
    opaque wall the samples are culled and the deepest lane kept, spare
    capacity backfills with the shallowest culled lanes; an unsaturated
    ray is decimated evenly by depth rank."""
    jcfg = _small_cfg(N_samples=16, N_importance=0, fine_cull_capacity=0.5)
    z = torch.linspace(0.1, 1.0, 16).expand(2, 16).contiguous()
    w = torch.zeros(2, 16)
    w[0, 4] = 1.0
    w[1] = 1e-5
    sel = Renderer(_port_cfg(jcfg))._cull_select(z, z, w).numpy()
    assert sel.shape == (2, 8)
    assert set(sel[0]) == {0, 1, 2, 3, 4, 15, 5, 6}
    assert set(sel[1]) == {1, 3, 5, 7, 9, 11, 13, 15}


# ---------------------------------------------------------------------------
# the occupancy grid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("G", [4, 16, 64])
def test_voxel_centers_match_jax_bitwise(G):
    np.testing.assert_array_equal(
        tocc.voxel_centers(oc.AABB, G).numpy(),
        np.asarray(jocc.voxel_centers(oc.AABB, G)))


@pytest.mark.parametrize("dilate", [0, 1, 2])
def test_grid_from_sigma_matches_jax_bitwise(dilate):
    rng = np.random.default_rng(dilate)
    G = 16
    sigma = rng.normal(size=(G, G, G)).astype(np.float32) * 3 - 4
    sigma[0, 0, 0] = sigma[G - 1, 3, 7] = 100.0    # corners and faces
    want = np.asarray(jocc.grid_from_sigma(jnp.asarray(sigma), 1 / 64,
                                           1e-4, dilate))
    got = tocc.grid_from_sigma(torch.from_numpy(sigma), 1 / 64, 1e-4, dilate)
    assert got.dtype == torch.float32 and tuple(got.shape) == (G * G, G)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.mean() < 1


def test_lookup_bits_matches_jax_bitwise():
    """At random coords inside and outside [-1, 1], exactly on cell edges
    and at the truncation toward zero of small negatives past -1."""
    rng = np.random.default_rng(5)
    G = 8
    grid = (rng.uniform(size=(G * G, G)) > 0.5).astype(np.float32)
    xyz = rng.uniform(-1.3, 1.3, (3000, 3)).astype(np.float32)
    xyz[:64] = ((np.arange(64) % (2 * G) - G) / G)[:, None]
    xyz[64:70, 0] = [-1.0 - 1e-7, -1.0, 1.0, 1.0 - 1e-7, -1.1, 1.1]
    want = np.asarray(jocc.lookup_bits(jnp.asarray(grid),
                                       jnp.asarray(xyz.reshape(30, 100, 3))))
    got = tocc.lookup_bits(torch.from_numpy(grid),
                           torch.from_numpy(xyz.reshape(30, 100, 3)))
    assert tuple(got.shape) == (30, 100)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("frac,stride", [(0.0, 8), (0.3, 8), (1.0, 1),
                                         (0.55, 0), (0.2, 3)])
def test_expected_keep_fraction_matches_jax(frac, stride):
    assert tocc.expected_keep_fraction(frac, stride) == \
        jocc.expected_keep_fraction(frac, stride)


def _jax_renderer(jcfg, seed=0, dense=0.0):
    """(JAX Renderer, its numpy params) from a seeded init; ``dense``
    scales both fields' density heads, so rays saturate and the fine cull
    has occluded samples to drop."""
    jmod = jrenderer.Renderer(jcfg)
    params = _np_tree(jmod.init(jax.random.PRNGKey(seed),
                                jax.random.PRNGKey(seed + 1), _rays(2),
                                is_train=False)["params"])
    if dense:
        for field in params.values():
            last = f"sigma_net_{jcfg.coarse_num_layers - 1}"
            field[last]["kernel"] = field[last]["kernel"].copy()
            field[last]["kernel"][:, 0] *= dense
    return jmod, params


def _port_renderer(jcfg, params):
    model = EvDeblurNeRF(_port_cfg(jcfg))
    model.load_state_dict(state_dict_from_jax({"params": params}),
                          strict=True)
    return model


@pytest.mark.parametrize("seed,dense", [(0, 0.0), (1, 8.0)])
def test_build_occ_grid_matches_jax(seed, dense):
    """The refresh from converted weights: the density sweep within 2e-5
    and the bits equal but for voxels whose alpha lies within 1e-6 of
    ``occ_eps``, which are counted and held to at most 1% of the grid."""
    jcfg = _small_cfg(occ_grid_size=16)
    jmod, params = _jax_renderer(jcfg, seed, dense)
    model = _port_renderer(jcfg, params)
    jsigma = np.asarray(jmod.apply({"params": params},
                                   method=jrenderer.Renderer.coarse_sigma_grid))
    with torch.no_grad():
        sigma = model.coarse_sigma_grid().numpy()
    np.testing.assert_allclose(sigma, jsigma, rtol=RTOL, atol=ATOL)
    delta = (jcfg.far - jcfg.near) / jcfg.N_samples
    want = np.asarray(jocc.grid_from_sigma(jnp.asarray(jsigma), delta,
                                           jcfg.occ_eps, 0)).reshape(-1)
    got0 = tocc.grid_from_sigma(torch.from_numpy(sigma), delta, jcfg.occ_eps,
                                0).numpy().reshape(-1)
    alpha = 1.0 - np.exp(-np.maximum(jsigma, 0.0) * delta).reshape(-1)
    near = np.abs(alpha - jcfg.occ_eps) <= 1e-6
    differ = got0 != want
    print(f"undilated bits differing: {differ.sum()} of {differ.size}; "
          f"alpha within 1e-6 of occ_eps: {near.sum()}")
    assert not (differ & ~near).any()
    assert near.sum() <= differ.size // 100
    grid = build_occ_grid(model).numpy()
    jgrid = np.asarray(jsystem.build_occ_grid(jmod, {"params": params}))
    if not near.any():
        np.testing.assert_array_equal(grid, jgrid)
    assert 0 < grid.mean() <= 1


# ---------------------------------------------------------------------------
# culled renders against the JAX Renderer
# ---------------------------------------------------------------------------

def _slab_grid(G=16):
    """Occupied where the normalised z lies in [-1, -0.5]: rays that cross
    the slab keep its samples, the others the probe floor."""
    grid3 = np.zeros((G, G, G), np.float32)
    grid3[:, :, : G // 4] = 1.0
    return grid3.reshape(G * G, G)


def _even_depths_jax(key, bins, weights, n, det=False):
    u = (jnp.arange(n, dtype=jnp.float32) + 0.5) / n
    return bins[..., :1] + u * (bins[..., -1:] - bins[..., :1])


def _even_depths_torch(bins, weights, n, det=False, generator=None):
    u = (torch.arange(n, dtype=torch.float32) + 0.5) / n
    return (bins[..., :1] + u * (bins[..., -1:] - bins[..., :1])).detach()


@pytest.fixture
def even_importance(monkeypatch):
    """Both renderers draw their importance depths evenly over the coarse
    bins. ``sample_pdf`` is held on its own in ``test_torch_render.py``;
    here it would blur the comparison: on rays that saturate, its
    degenerate-interval switch (``denom < 1e-5``, ref utils/rays.py:
    149-193) turns on where a bin's CDF rise, a difference of two f32
    values near 1, rounds across 1e-5 on one side only, and moves that
    depth by up to 2e-4 between the two packages."""
    monkeypatch.setattr(jrenderer, "sample_pdf", _even_depths_jax)
    monkeypatch.setattr(trenderer, "sample_pdf", _even_depths_torch)


RENDER_CASES = {
    "fine": dict(cfg=dict(fine_cull_capacity=0.25), fine_cull=True,
                 dense=30.0),
    "fine_transparent": dict(cfg=dict(fine_cull_capacity=0.25),
                             fine_cull=True),
    "fine_half_awp": dict(cfg=dict(fine_cull_capacity=0.5, use_awp=True),
                          fine_cull=True, dense=30.0),
    "coarse_slab": dict(cfg=dict(coarse_cull_capacity=0.5), grid="slab"),
    "coarse_jax_grid": dict(cfg=dict(coarse_cull_capacity=0.5), grid="jax",
                            dense=30.0),
    "both": dict(cfg=dict(fine_cull_capacity=0.25, coarse_cull_capacity=0.5,
                          use_awp=True), fine_cull=True, grid="slab",
                 dense=30.0),
    "both_pbe": dict(cfg=dict(fine_cull_capacity=0.25,
                              coarse_cull_capacity=0.5, kernel_type="PBE"),
                     fine_cull=True, grid="jax", dense=30.0),
}


@pytest.mark.parametrize("case", list(RENDER_CASES))
def test_culled_render_matches_jax(case, even_importance):
    """The culled training render (deterministic: perturb 0, no sigma
    noise) and, with the fine cull, the culled eval render of the JAX
    ``Renderer`` and the port's on one set of weights: every output the
    two share, within 2e-5. The coarse cull reads the same grid on both
    sides (a hand-made slab, or the JAX refresh of these weights); the
    PBE stage-0 ``coarse_render`` culls too. In the saturating cases
    some rays keep fewer survivors than the budget: the backfill then
    brings in lanes past the saturation, which are counted."""
    spec = RENDER_CASES[case]
    jcfg = _small_cfg(**spec["cfg"])
    jmod, params = _jax_renderer(jcfg, dense=spec.get("dense", 0.0))
    model = _port_renderer(jcfg, params)
    grid = None
    if spec.get("grid") == "slab":
        grid = _slab_grid()
    elif spec.get("grid") == "jax":
        grid = np.asarray(jsystem.build_occ_grid(
            jmod, {"params": params}))
        assert 0 < grid.mean() < 1
    rays = _rays(32)
    culls = dict(fine_cull=spec.get("fine_cull", False),
                 coarse_cull=grid is not None)
    for is_train in (True, False):
        want = jmod.apply({"params": params}, jax.random.PRNGKey(0), rays,
                          is_train=is_train, perturb=0.0,
                          occ_grid=None if grid is None else jnp.asarray(grid),
                          method=jrenderer.Renderer.render, **culls)
        with torch.no_grad():
            got = model.render(torch.from_numpy(rays), is_train=is_train,
                               want_features=True,
                               occ_grid=None if grid is None
                               else torch.from_numpy(grid), **culls)
        shared = set(want) & set(got)
        assert {"rgb_map", "depth_map", "acc_map", "weights", "z_vals",
                "rgb0", "z_std"} <= shared
        if culls["fine_cull"]:
            assert got["z_vals"].shape[-1] == max(
                8, round(jcfg.fine_cull_capacity * 32))
            T = 1.0 - torch.cumsum(got["weights"], -1)
            backfill = int((T[:, :-1] <= jcfg.fine_cull_eps).sum())
            print(f"{case} is_train={is_train}: {backfill} kept lanes past "
                  "the saturation")
            assert (backfill > 0) == (spec.get("dense", 0.0) > 0)
        for k in shared:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"{case} {k} {is_train}")
    if grid is not None:
        # the coarse cull is a training cull: the eval render above took
        # the full coarse pass on both sides; the PBE stage-0 pass culls
        want_rgb, want_feat = jmod.apply(
            {"params": params}, jax.random.PRNGKey(0), rays, is_train=True,
            perturb=0.0, coarse_cull=True, occ_grid=jnp.asarray(grid),
            method=jrenderer.Renderer.coarse_render)
        with torch.no_grad():
            got_rgb, got_feat = model.coarse_render(
                torch.from_numpy(rays), is_train=True, coarse_cull=True,
                occ_grid=torch.from_numpy(grid))
        np.testing.assert_allclose(got_rgb.numpy(), np.asarray(want_rgb),
                                   rtol=RTOL, atol=ATOL)
        if jcfg.composite_feature_coarse:
            np.testing.assert_allclose(got_feat.numpy(),
                                       np.asarray(want_feat), rtol=RTOL,
                                       atol=ATOL)


def test_culled_render_with_sample_pdf_matches_jax():
    """The fine-culled render with the real ``sample_pdf``, on weights
    whose importance draws agree between the packages (a seed with no
    ray near the degenerate-interval switch): every output within 2e-5."""
    jcfg = _small_cfg(fine_cull_capacity=0.25)
    jmod, params = _jax_renderer(jcfg, seed=2)
    model = _port_renderer(jcfg, params)
    rays = _rays(32)
    want = jmod.apply({"params": params}, jax.random.PRNGKey(0), rays,
                      is_train=True, perturb=0.0, fine_cull=True,
                      method=jrenderer.Renderer.render)
    with torch.no_grad():
        got = model.render(torch.from_numpy(rays), is_train=True,
                           want_features=True, fine_cull=True)
    for k in set(want) & set(got):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


def test_full_capacity_cull_matches_unculled_render():
    """Fine capacity 1.0 with eps 0 keeps every sample: the culled render
    equals the unculled one to f32 reduction noise, as
    ``tests/test_fine_cull.py:51-76`` holds the JAX one; the flag off at
    call time is the unculled render bitwise."""
    jcfg = _small_cfg(fine_cull_capacity=1.0, fine_cull_eps=0.0)
    _, params = _jax_renderer(jcfg, dense=4.0)
    model = _port_renderer(jcfg, params)
    rays = torch.from_numpy(_rays())
    with torch.no_grad():
        base = model.render(rays, is_train=True)
        cull = model.render(rays, is_train=True, fine_cull=True)
        off = model.render(rays, is_train=True, fine_cull=False)
        eval_cull = model.render_chunk(rays, fine_cull=True)
    for k in ("rgb_map", "depth_map"):
        torch.testing.assert_close(cull[k], base[k], rtol=2e-5, atol=2e-6)
    torch.testing.assert_close(torch.sort(cull["z_vals"], -1).values,
                               torch.sort(base["z_vals"], -1).values,
                               rtol=1e-6, atol=0)
    torch.testing.assert_close(off["rgb_map"], base["rgb_map"], rtol=0,
                               atol=0)
    torch.testing.assert_close(eval_cull[0], model.render_chunk(rays)[0],
                               rtol=2e-5, atol=2e-6)


def test_coarse_capacity_one_all_occupied_is_bitwise_exact():
    """An all-occupied grid at coarse capacity 1.0 keeps every stratified
    lane in order, so with the sigma noise on (one generator, the same
    draws) every output equals the unculled render bitwise: the
    approximation is in the selection alone (``tests/test_occupancy.py``)."""
    jcfg = _small_cfg(coarse_cull_capacity=1.0, raw_noise_std=1.0)
    _, params = _jax_renderer(jcfg)
    model = _port_renderer(jcfg, params)
    rays = torch.from_numpy(_rays(32))
    ones = torch.ones(64 * 64, 64)
    with torch.no_grad():
        cull = model.render(rays, is_train=True, coarse_cull=True,
                            occ_grid=ones,
                            generator=torch.Generator().manual_seed(0))
        ref = model.render(rays, is_train=True,
                           generator=torch.Generator().manual_seed(0))
    for k in ("rgb_map", "depth_map", "acc_map", "weights", "z_vals",
              "rgb0"):
        torch.testing.assert_close(cull[k], ref[k], rtol=0, atol=0)


def test_coarse_cull_is_a_training_cull_and_keeps_its_budget():
    """The eval render ignores the coarse cull; the training render
    evaluates ``round(capacity * N_samples)`` coarse lanes a ray, the
    deepest among them, and the fine pass then takes the full budget of
    importance samples beside them."""
    jcfg = _small_cfg(coarse_cull_capacity=0.5, N_samples=32)
    _, params = _jax_renderer(jcfg)
    model = _port_renderer(jcfg, params)
    rays = torch.from_numpy(_rays(8))
    grid = torch.from_numpy(_slab_grid())
    calls = []
    orig = model._coarse_cull_select

    def spy(occ_grid, pts):
        sel = orig(occ_grid, pts)
        calls.append(sel)
        return sel

    model._coarse_cull_select = spy
    with torch.no_grad():
        ev = model.render(rays, coarse_cull=True, occ_grid=grid)
        tr = model.render(rays, is_train=True, coarse_cull=True,
                          occ_grid=grid)
    assert ev["z_vals"].shape[-1] == 32 + 16
    assert tr["z_vals"].shape[-1] == 16 + 16
    (sel,) = calls
    assert tuple(sel.shape) == (8, 16) and (sel[:, -1] == 31).all()
    assert (torch.diff(sel, dim=-1) > 0).all()


# ---------------------------------------------------------------------------
# culled training steps against the JAX step
# ---------------------------------------------------------------------------

STEP_CASES = {
    "fine": dict(name="rbk_awp", fine=0.25),
    "fine_coarse": dict(name="rbk_awp", fine=0.25, coarse=0.5),
    "pbe_fine_coarse": dict(name="pbe", fine=0.25, coarse=0.5),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_culled_train_steps_match_jax(case):
    """5 steps of the port's step and the JAX step from one JAX init at 16
    + 16 samples (the fine cull keeps 8 of up to 32 lanes, the coarse cull
    8 of 16), with the event loss on both EGM stages and the occupancy
    grid of the JAX refresh of the initial weights: per-step loss within
    2e-5 relative, the first step's terms at the repo's 2e-5."""
    spec = STEP_CASES[case]
    args = oc.make_args({**oc.VARIANTS[spec["name"]], "lrate": lc.LRATE,
                         "lrate_decay": lc.LRATE_DECAY,
                         "kernel_tv_loss_weight": lc.TV_W,
                         "no_log_grads_norm": True, "use_events": True,
                         "add_event_egm": True,
                         "add_event_egm_stages": ["stage0", "stage1"],
                         "events_threshold": lc.EV_THRESH,
                         "events_threshold_pos": lc.EV_THRESH,
                         "events_threshold_neg": lc.EV_THRESH,
                         "fine_cull_capacity": spec["fine"],
                         "coarse_cull_capacity": spec.get("coarse", 0.0)})
    jcfg = dataclasses.replace(
        oc.make_cfg(args), N_samples=16, N_importance=16,
        fine_cull_capacity=spec["fine"],
        coarse_cull_capacity=spec.get("coarse", 0.0), occ_grid_size=16)
    coarse = spec.get("coarse", 0.0) > 0
    batches = lc.make_batches()
    ev_batches = lc.make_ev_batches()
    sw = tstep.ScheduleWeights(w_egm=0.1)
    jsw = jstep.ScheduleWeights(
        w_img=jnp.ones(()), loss_a=jnp.ones(()), w_pts0=jnp.zeros(()),
        use_pts0_target=jnp.zeros((), bool), cf=jnp.ones(()),
        ff=jnp.zeros(()), w_align=jnp.zeros(()), w_egm=jnp.asarray(0.1),
        skip_learn_crf=jnp.zeros((), bool), color_weight=jnp.ones((3,)))

    jmodel = JModel(cfg=jcfg, kcfg=jkernel_config(args),
                    num_images=oc.NUM_IMAGES, K=oc.K)
    tx = joptim.build_optimizer(lc.LRATE, lc.LRATE_DECAY)
    info = {k: batches[0][k] for k in ("images_idx", "rays_x", "rays_y",
                                       "poses")}
    variables = _np_tree(dict(jmodel.init(
        jax.random.PRNGKey(6), jax.random.PRNGKey(7), batches[0]["rays"],
        info, force_naive=False, return_pts0_rgb=True)))
    jstate = jcreate(jmodel, JTonemapping(), tx, jax.random.PRNGKey(5),
                     batches[0]["rays"], info)
    jstate = jstate.replace(
        params={"nerf": jax.tree_util.tree_map(jnp.asarray,
                                               variables["params"]),
                "crf": jstate.params["crf"]},
        batch_stats=jax.tree_util.tree_map(
            jnp.asarray, variables.get("batch_stats", jstate.batch_stats)))
    jstep_fn = jstep.build_train_step(jmodel, JTonemapping(), tx, args)
    grid = None
    if coarse:
        grid = np.asarray(jsystem.build_occ_grid(
            jmodel, {"params": variables["params"]}))
        assert 0 < grid.mean() < 1

    model = EvDeblurNeRF(_port_cfg(jcfg), kernel_config_from_args(args),
                         oc.NUM_IMAGES)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    if coarse:
        np.testing.assert_array_equal(build_occ_grid(model).numpy(), grid)
    state = create_train_state(model, TonemappingTransform(), args,
                               torch.Generator(), crf_identity_prefit=False)
    step = tstep.build_train_step(args)

    def tensors(b):
        return {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in b.items()}

    rel = []
    for i in range(5):
        b, e = batches[i % lc.N_BATCHES], ev_batches[i % lc.N_BATCHES]
        jstate, jaux = jstep_fn(
            jstate, b, e, jax.random.PRNGKey(i), jsw, force_naive=False,
            events_active=True, fine_cull=True, coarse_cull=coarse,
            occ_grid=None if grid is None else jnp.asarray(grid))
        aux = step(state, tensors(b), tensors(e), sw, False, True,
                   fine_cull=True, coarse_cull=coarse,
                   occ_grid=None if grid is None else torch.from_numpy(grid))
        rel.append(abs(float(aux["loss"]) - float(jaux["loss"]))
                   / abs(float(jaux["loss"])))
        if i == 0:
            assert set(aux) == set(jaux)
            for k in ("img_loss", "psnr", "pts0_loss", "event_egm"):
                np.testing.assert_allclose(float(aux[k]), float(jaux[k]),
                                           rtol=RTOL, atol=ATOL, err_msg=k)
    print(f"{case}: per-step relative loss difference {rel}")
    assert max(rel) < 2e-5, rel


# ---------------------------------------------------------------------------
# the flags, the loop and serving
# ---------------------------------------------------------------------------

def test_cull_flags_reach_the_render_config():
    args = tconfig.default_args(
        fine_cull_capacity=0.25, fine_cull_eps=1e-2, coarse_cull_capacity=0.5,
        occ_grid_size=32, occ_eps=1e-3, occ_dilate=2, occ_probe_stride=4)
    tconfig.check_supported(args)
    cfg = trenderer.config_from_args(args, oc.AABB, oc.H, oc.W, oc.FOCAL,
                                     0.0, 1.0)
    jcfg = jrenderer.config_from_args(
        jconfig.default_args(**{k: getattr(args, k) for k in (
            "fine_cull_capacity", "fine_cull_eps", "coarse_cull_capacity",
            "occ_grid_size", "occ_eps", "occ_dilate", "occ_probe_stride")}),
        oc.AABB, oc.H, oc.W, oc.FOCAL, 0.0, 1.0)
    for f in ("fine_cull_capacity", "fine_cull_eps", "coarse_cull_capacity",
              "occ_grid_size", "occ_eps", "occ_dilate", "occ_probe_stride"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert not tconfig.eval_fine_cull(args)
    assert tconfig.eval_fine_cull(tconfig.default_args(
        fine_cull_capacity=0.25, fine_cull_eval=True))
    assert not tconfig.eval_fine_cull(tconfig.default_args(
        fine_cull_eval=True))


LOOP_CULL = dict(N_samples=16, N_importance=16, fine_cull_capacity=0.25,
                 fine_cull_start_iter=4, coarse_cull_capacity=0.5,
                 coarse_cull_start_iter=3, occ_grid_size=16,
                 occ_refresh_every=3, occ_probe_stride=8)
LOOP_VARIANTS = {
    # the full method, the coarse cull forced on at every refresh
    "full_forced": {**FULL, **LOOP_CULL, "occ_gate_margin": 0.0},
    # the naive phase under the budget gate, held-out renders culled
    "gated_eval": {**LOOP_CULL, "occ_gate_margin": 1.0,
                   "fine_cull_eval": True},
}


@pytest.fixture(scope="module")
def cull_scene(tmp_path_factory):
    basedir = tmp_path_factory.mktemp("cull_scene")
    make_synthetic_scene(str(basedir), h=32, w=40, focal=40.0)
    return str(basedir)


@pytest.mark.parametrize("variant", list(LOOP_VARIANTS))
def test_loop_with_culls_matches_jax_loop(cull_scene, tmp_path, variant):
    """``evdeblurnerf_tpu.train.loop.train`` and the port's ``train`` run
    10 steps across ``coarse_cull_start_iter`` 3 and
    ``fine_cull_start_iter`` 4 from one JAX init: the grid refreshed at 3,
    6 and 9 with the same ``train/occ_frac`` and
    ``train/coarse_cull_active``, the same scalar tags at the same steps,
    per-step loss within 2e-2 relative (1e-4 at step 0), held-out metrics
    within 1e-3."""
    log = str(tmp_path)
    flags = {**BASE, **LOOP_VARIANTS[variant]}
    jloop.train(jconfig.default_args(datadir=cull_scene, basedir=log,
                                     expname="jax", **flags))
    jargs = jconfig.resolve_event_thresholds(jconfig.default_args(
        datadir=cull_scene, basedir=log, expname="jax_init", **flags))
    llff, _ = jloop.build_datasets(jargs)
    _, _, model, crf = jloop.build_model(jargs, llff)
    state, _ = jloop.build_initial_state(jargs, llff, model, crf)
    state = jax.device_get(state)
    ckpt = train_checkpoint_from_jax(_np_tree(state.params),
                                     _np_tree(state.batch_stats), step=0)
    os.makedirs(os.path.join(log, "torch", "checkpoints"))
    torch.save(ckpt, os.path.join(log, "torch", "checkpoints", "000000.tar"))
    tstate = tloop.train(_targs(cull_scene, log, **LOOP_VARIANTS[variant]))
    assert tstate.step == 10

    want = _scalars(os.path.join(log, "jax", "metrics.jsonl"))
    got = _scalars(os.path.join(log, "torch", "metrics.jsonl"))
    for tag in ("train/occ_frac", "train/coarse_cull_active"):
        assert sorted(got[tag]) == sorted(want[tag]) == [3, 6, 9], tag
        np.testing.assert_allclose([got[tag][s] for s in (3, 6, 9)],
                                   [want[tag][s] for s in (3, 6, 9)],
                                   rtol=0, atol=2 / 16 ** 3, err_msg=tag)
    if variant == "full_forced":
        assert got["train/coarse_cull_active"] == {3: 1.0, 6: 1.0, 9: 1.0}
    steps = sorted(want["train/loss"])
    assert steps == list(range(10)) == sorted(got["train/loss"])
    rel = np.array([abs(got["train/loss"][s] - want["train/loss"][s])
                    / abs(want["train/loss"][s]) for s in steps])
    print(f"{variant}: per-step relative loss difference {rel}")
    assert rel[0] < 1e-4, rel[0]
    assert rel.max() < 2e-2, (rel.argmax(), rel.max())

    def tags(scalars):
        return {t: sorted(v) for t, v in scalars.items()
                if t != "train/lr"
                and (not t.startswith("train/grads/")
                     or t == "train/grads/total")}

    assert tags(got) == tags(want)
    for name in ("test/mse", "test/psnr", "test/ssim"):
        assert abs(got[name][9] - want[name][9]) < 1e-3, name


def test_bench_torch_culled_tiny_runs_on_the_cpu(monkeypatch):
    """``bench_torch.py --fine_cull_capacity 0.25 --coarse_cull_capacity
    0.5 --device cpu --tiny``: the step reading on the culled path (the
    occupancy grid built once before timing) and the served pose with the
    eval fine cull, finite; without the flags the readings stay exact."""
    import math

    import bench_torch
    from evdeblurnerf_torch.models import system as tsystem

    assert bench_torch.cull_overrides() == {}
    over = bench_torch.cull_overrides(0.25, 0.5)
    assert over["fine_cull_start_iter"] == over["coarse_cull_start_iter"] == 0
    built = []
    monkeypatch.setattr(tsystem, "build_occ_grid",
                        lambda m, _f=build_occ_grid: built.append(m)
                        or _f(m))
    result = bench_torch.run(device="cpu", tiny=True, iters=1,
                             arg_overrides=over, only="step_only")
    assert len(built) == 1
    assert all(math.isfinite(v) for v in result["step_only"]["losses"])
    assert result["overrides"]["fine_cull_capacity"] == 0.25
    culled = []
    monkeypatch.setattr(Renderer, "_cull_select",
                        lambda self, *a, _f=Renderer._cull_select:
                        culled.append(1) or _f(self, *a))
    serve = bench_torch.run(device="cpu", tiny=True, arg_overrides=over,
                            only="serve")["serve"]
    assert serve["eval_rays_per_s"] > 0 and culled
