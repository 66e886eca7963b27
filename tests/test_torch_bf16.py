"""bf16 tables (``--triplane_bf16``) in the port against the JAX package, on
the CPU.

Inputs are made with numpy from a seed and handed to both sides. The JAX
side runs with ``triplane_line_matmul=False`` throughout: with its default
line matmul the JAX package rounds the line cotangent to bf16 too (the
TPU's MXU lookup, ``evdeblurnerf_tpu/ops/triplane.py:23-28,268-320``),
which the port does not carry; its line gradients are the exact f32 ones.
Bounds, each stated where it is held:

* the double-angle encoding within ``2e-6 * 2**(m - 1)``: the exact
  encoding's 2e-6 (``tests/test_torch_render.py``), doubled a band by the
  recurrence;
* bf16 rows (training): the forward within 1e-6 of the features' largest
  magnitude (f32 reordering of the slot sums, as ``tests/
  test_torch_triplane.py``), the gradients of planes, lines and xyz within
  1e-5 of each one's largest, and the grid gradient exact f32, not
  bf16-rounded;
* the bf16 eval chain: the port's twin and the JAX ``compute_bf16`` chain
  within 0.02 of the features' largest magnitude, JAX's own bound for its
  chain (``tests/test_triplane_packed.py:182-200``), the measured value
  printed;
* a whole model: the bf16 training render within the repo's 2e-5; the
  bf16 eval render (exact and fine-culled) within 2e-5 absolute on every
  ray, with the importance depths of every ray within 1e-4 (measured:
  1.8e-7 and 1.2e-7, no ray's depths moved, since the two chains agree
  bitwise on these inputs); the occupancy bits of the bf16 ``density``
  bitwise (measured: 0 of 4096 flips on both grids); 5 training steps
  within 2e-5 relative per-step loss;
* the chain's gate, call by call: every encoding and K4 call of an eval
  render and of the occupancy refresh in its bf16 form, none of a
  training render or under ``eval_f32_interp`` (at these widths the two
  encodings' renders differ by less than the port-vs-JAX noise).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lockstep_common as lc
import oracle_common as oc
from test_torch_cull import _jax_renderer, _port_renderer, _rays, _small_cfg
from evdeblurnerf_torch import config as tconfig, serving
from evdeblurnerf_torch.models import embedding as temb
from evdeblurnerf_torch.models.renderer import RenderConfig
from evdeblurnerf_torch.models.system import (EvDeblurNeRF, build_occ_grid,
                                              kernel_config_from_args)
from evdeblurnerf_torch.models.tonemapping import TonemappingTransform
from evdeblurnerf_torch.ops import fused_sample, triplane as ttp
from evdeblurnerf_torch.train import step as tstep
from evdeblurnerf_torch.train.state import create_train_state
from evdeblurnerf_torch.utils.convert import state_dict_from_jax
from evdeblurnerf_tpu.models import embedding as jemb
from evdeblurnerf_tpu.models import renderer as jrenderer
from evdeblurnerf_tpu.models import system as jsystem
from evdeblurnerf_tpu.models.system import EvDeblurNeRF as JModel
from evdeblurnerf_tpu.models.system import \
    kernel_config_from_args as jkernel_config
from evdeblurnerf_tpu.models.tonemapping import \
    TonemappingTransform as JTonemapping
from evdeblurnerf_tpu.ops import triplane as jtp
from evdeblurnerf_tpu.train import optim as joptim
from evdeblurnerf_tpu.train import step as jstep
from evdeblurnerf_tpu.train.state import create_train_state as jcreate

FWD_REL = 1e-6
GRAD_REL = 1e-5
CHAIN_REL = 0.02
RENDER_TOL = 2e-5
EVAL_CHAIN_TOL = 2e-5
STEP_REL = 2e-5


def _grids(rng, comps=(8, 4, 4), hwd=(17, 19, 13)):
    H, W, D = hwd
    dims = [(comps[0], H, W), (comps[1], D, H), (comps[2], D, W)]
    ldims = [(comps[0], D), (comps[1], W), (comps[2], H)]
    return ([rng.normal(size=s).astype(np.float32) for s in dims],
            [rng.normal(size=s).astype(np.float32) for s in ldims])


def _points(rng, n=777):
    xyz = rng.uniform(-1.3, 1.3, (n, 3)).astype(np.float32)
    edges = np.array([[1.0, 1.0, 1.0], [-1.0, -1.0, -1.0], [1.0, -1.0, 0.0],
                      [-1.05, 1.05, 0.999], [0.0, 0.0, 0.0]], np.float32)
    return np.concatenate([xyz, edges], 0)


def _jax_packed(planes, lines, bf16_first=False):
    cast = (lambda a: jnp.asarray(a).astype(jnp.bfloat16)) if bf16_first \
        else jnp.asarray
    return jtp.pack_grids([cast(p) for p in planes],
                          [cast(l) for l in lines])


def _port_packed_bf16(planes, lines):
    return ttp.pack_grids(
        [torch.from_numpy(p).to(torch.bfloat16) for p in planes],
        [torch.from_numpy(l).to(torch.bfloat16) for l in lines])


@pytest.mark.parametrize("multires", [4, 10])
def test_double_angle_encoding_matches_jax(multires):
    x = np.random.default_rng(0).uniform(-1.5, 1.5, (257, 3)).astype(
        np.float32)
    want = np.asarray(jemb.positional_encoding(jnp.asarray(x), multires,
                                               double_angle=True))
    got = temb.positional_encoding(torch.from_numpy(x), multires,
                                   double_angle=True).numpy()
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    print(f"double-angle m={multires}: max |port - JAX| {err:.3e}")
    assert err <= 2e-6 * 2 ** (multires - 1)
    exact = temb.positional_encoding(torch.from_numpy(x), multires).numpy()
    # the recurrence's phase error stays far below bf16's resolution
    assert float(np.abs(got - exact).max()) < 2 ** -8


def test_bf16_rows_forward_matches_jax():
    """K4's bf16-row form: the twin over bf16 packs (cast before packing)
    against the JAX gather through its bf16 view, and the wrapper (the
    custom op, the twin on the CPU) bitwise equal to the twin."""
    rng = np.random.default_rng(1)
    planes, lines = _grids(rng)
    xyz = _points(rng)
    pp, pl = _jax_packed(planes, lines)
    want = np.asarray(jtp.triplane_features_packed(
        pp, pl, jnp.asarray(xyz), table_bf16=True, line_matmul=False))
    tpp, tpl, sizes = _port_packed_bf16(planes, lines)
    assert all(t.dtype == torch.bfloat16 for t in (*tpp, *tpl))
    twin = ttp.triplane_features_packed(tpp, tpl, sizes,
                                        torch.from_numpy(xyz))
    assert twin.dtype == torch.float32
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(twin.numpy(), want, rtol=0,
                               atol=FWD_REL * scale)
    got = fused_sample.triplane_features(tpp, tpl, sizes,
                                         torch.from_numpy(xyz))
    torch.testing.assert_close(got, twin, rtol=0, atol=0)
    # the rows the interpolation reads are bf16 values: away from f32
    f32 = ttp.triplane_features_packed(
        *ttp.pack_grids([torch.from_numpy(p) for p in planes],
                        [torch.from_numpy(l) for l in lines]),
        torch.from_numpy(xyz))
    assert float((f32 - twin).abs().max()) > 1e-3 * scale


def _jax_grads(planes, lines, xyz, cot):
    def loss(planes, lines, xyz):
        pp, pl = jtp.pack_grids(planes, lines)
        out = jtp.triplane_features_packed(pp, pl, xyz, table_bf16=True,
                                           line_matmul=False)
        return jnp.sum(out * cot)

    return jax.grad(loss, argnums=(0, 1, 2))(
        [jnp.asarray(p) for p in planes], [jnp.asarray(l) for l in lines],
        jnp.asarray(xyz))


def test_bf16_rows_gradients_match_jax_and_stay_f32():
    """K5's bf16-row form: ``sample_grids`` over bf16 packs, backward
    through the twin (autograd with the straight-through rounding), against
    ``jax.grad`` of the JAX packed sampler: planes, lines and xyz within
    1e-5 of each one's largest. The grid gradient is the exact f32
    scatter: it holds values no bf16 can, where a bare cast's backward
    would have rounded it."""
    rng = np.random.default_rng(2)
    planes, lines = _grids(rng)
    xyz = _points(rng)
    cot = rng.normal(size=(xyz.shape[0], 16)).astype(np.float32)
    jg = _jax_grads(planes, lines, xyz, cot)
    want = [*map(np.asarray, jg[0]), *map(np.asarray, jg[1]),
            np.asarray(jg[2])]

    leaves = [torch.from_numpy(t).requires_grad_()
              for t in (*planes, *lines, xyz)]
    packed = _port_packed_bf16(planes, lines)
    out = fused_sample.sample_grids(leaves[:3], leaves[3:6], packed,
                                    leaves[6])
    out.backward(torch.from_numpy(cot))
    got = [t.grad.numpy() for t in leaves]
    for name, a, b in zip(("plane0", "plane1", "plane2", "line0", "line1",
                           "line2", "xyz"), got, want):
        scale = float(np.abs(b).max())
        np.testing.assert_allclose(a, b, rtol=0, atol=GRAD_REL * scale,
                                   err_msg=name)
    for g in got[:6]:
        t = torch.from_numpy(g)
        assert not torch.equal(t, t.to(torch.bfloat16).float())
    # the trap: a cast under autograd rounds the incoming gradient
    naive = torch.from_numpy(planes[0]).requires_grad_()
    (naive.to(torch.bfloat16).float() * torch.from_numpy(
        rng.normal(size=planes[0].shape).astype(np.float32))).sum().backward()
    assert torch.equal(naive.grad, naive.grad.to(torch.bfloat16).float())
    straight = torch.from_numpy(planes[0]).requires_grad_()
    w = torch.from_numpy(rng.normal(size=planes[0].shape).astype(np.float32))
    (ttp.round_bf16(straight) * w).sum().backward()
    torch.testing.assert_close(straight.grad, w, rtol=0, atol=0)


def test_bf16_chain_matches_jax_compute_bf16():
    """K4's bf16-compute form: the twin's chain (rows, slot weights,
    products, sums, plane x line, concat in bf16) against the JAX
    ``compute_bf16`` chain over the same pre-cast packs, within 0.02 of
    the features' largest magnitude; the wrapper equals the twin
    bitwise."""
    rng = np.random.default_rng(3)
    planes, lines = _grids(rng)
    xyz = _points(rng)
    pp, pl = _jax_packed(planes, lines, bf16_first=True)
    want = np.asarray(jtp.triplane_features_packed(
        pp, pl, jnp.asarray(xyz), table_bf16=True, line_matmul=False,
        compute_bf16=True)).astype(np.float32)
    packed = _port_packed_bf16(planes, lines)
    twin = ttp.triplane_features_packed(*packed, torch.from_numpy(xyz),
                                        compute_bf16=True)
    assert twin.dtype == torch.bfloat16
    got = fused_sample.triplane_features(*packed, torch.from_numpy(xyz),
                                         compute_bf16=True)
    assert torch.equal(got, twin)
    scale = float(np.abs(want).max())
    err = float(np.abs(twin.float().numpy() - want).max())
    ref = ttp.triplane_features_packed(*packed, torch.from_numpy(xyz))
    print(f"bf16 chain: max |port - JAX| {err:.3e} = {err / scale:.2e} of "
          f"the largest feature; against the f32 math over the same rows "
          f"{float((twin.float() - ref).abs().max()) / scale:.2e}")
    assert err <= CHAIN_REL * scale
    with pytest.raises(TypeError, match="bf16"):
        fused_sample.triplane_features(
            *ttp.pack_grids([torch.from_numpy(p) for p in planes],
                            [torch.from_numpy(l) for l in lines]),
            torch.from_numpy(xyz), compute_bf16=True)


def test_mixed_table_types_raise():
    rng = np.random.default_rng(4)
    planes, lines = _grids(rng)
    pp, pl, sizes = _port_packed_bf16(planes, lines)
    with pytest.raises(TypeError, match="float32 or all bfloat16"):
        fused_sample.table_dtype([pp[0].float(), pp[1], pp[2]], pl)
    with pytest.raises(TypeError, match="float32 or all bfloat16"):
        fused_sample.table_dtype([p.half() for p in pp], [l.half()
                                                          for l in pl])


# ---------------------------------------------------------------------------
# a whole model
# ---------------------------------------------------------------------------

def _bf16_pair(seed=0, dense=0.0, **over):
    jcfg = _small_cfg(triplane_bf16=True, triplane_line_matmul=False, **over)
    jmod, params = _jax_renderer(jcfg, seed, dense)
    return jcfg, jmod, params, _port_renderer(jcfg, params)


def test_bf16_model_packs_bf16_and_builds_from_flags():
    _, _, _, model = _bf16_pair()
    field = model.mlp_fine
    assert field.table_bf16
    assert all(getattr(field, f"packed_plane_{i}").dtype == torch.bfloat16
               for i in range(3))
    plane = field.app_plane[0]
    assert plane.dtype == torch.float32
    # the pack holds the grid's bf16 bits (cast before packing)
    C = plane.shape[1]
    torch.testing.assert_close(
        field.packed_plane_0[:, :C].float(),
        plane[0].permute(1, 2, 0).reshape(-1, C).to(torch.bfloat16).float(),
        rtol=0, atol=0)
    args = tconfig.default_args(triplane_bf16=True)
    tconfig.check_supported(args)
    assert not tconfig.default_args().triplane_bf16


@pytest.mark.parametrize("fine_cull", [False, True])
def test_bf16_render_matches_jax(fine_cull):
    """The JAX ``Renderer`` with bf16 tables (line matmul off) and the
    port's on one set of weights: the training render (bf16 rows, f32
    math) within 2e-5; the eval render (the bf16 chain, double-angle
    encoding) within 2e-5 on every ray, no ray's importance depths moved
    by more than 1e-4; with ``eval_f32_interp`` the port's eval render equals its
    own bf16-row render with the exact encoding."""
    jcfg, jmod, params, model = _bf16_pair(
        seed=2, fine_cull_capacity=0.25 if fine_cull else 0.0)
    rays = _rays(32)
    culls = dict(fine_cull=fine_cull)
    for is_train in (True, False):
        want = jmod.apply({"params": params}, jax.random.PRNGKey(0), rays,
                          is_train=is_train, perturb=0.0,
                          method=jrenderer.Renderer.render, **culls)
        with torch.no_grad():
            got = model.render(torch.from_numpy(rays), is_train=is_train,
                               **culls)
        keys = ("rgb_map", "depth_map", "acc_map", "rgb0")
        if is_train:
            for k in keys + ("weights", "z_vals"):
                np.testing.assert_allclose(got[k].numpy(),
                                           np.asarray(want[k]),
                                           rtol=RENDER_TOL, atol=RENDER_TOL,
                                           err_msg=k)
            continue
        moved = np.abs(np.sort(got["z_vals"].numpy(), -1)
                       - np.sort(np.asarray(want["z_vals"]), -1)).max(-1) \
            > 1e-4
        worst = max(float(np.abs(got[k].numpy() - np.asarray(want[k])).max())
                    for k in keys)
        print(f"bf16 eval render (fine cull {fine_cull}): max |port - JAX| "
              f"{worst:.3e} on {rays.shape[0]} rays, importance depths "
              f"moved on {int(moved.sum())}")
        assert worst <= EVAL_CHAIN_TOL
        assert not moved.any()
    f32_interp = EvDeblurNeRF(model.cfg, eval_f32_interp=True)
    f32_interp.load_state_dict(model.state_dict())
    with torch.no_grad():
        a = f32_interp.render_chunk(torch.from_numpy(rays), **culls)
        b = f32_interp.render(torch.from_numpy(rays), is_train=True,
                              **culls)
    assert not f32_interp.mlp_coarse.eval_bf16(False)
    # at perturb 0 with no sigma noise and no near-plane mask the eval and
    # training renders differ only by the chain, which is off here
    torch.testing.assert_close(a[0], b["rgb_map"], rtol=0, atol=0)


def test_bf16_chain_gates_encoding_and_interpolation(monkeypatch):
    """Which calls take the bf16 chain: every encoding (double-angle) and
    every K4 call (bf16-compute form) of an eval render and of the
    occupancy refresh; none of a training render, nor of an eval render
    with ``eval_f32_interp``. At these widths the double-angle and exact
    encodings give renders within the port-vs-JAX noise, so the gate is
    held here call by call."""
    from evdeblurnerf_torch.models import voxnerf

    calls = []
    pe, k4 = voxnerf.positional_encoding, fused_sample.triplane_features

    def spy_pe(*a, double_angle=False, **k):
        calls.append(("encoding", double_angle))
        return pe(*a, double_angle=double_angle, **k)

    def spy_k4(*a, compute_bf16=False):
        calls.append(("k4", compute_bf16))
        return k4(*a, compute_bf16=compute_bf16)

    monkeypatch.setattr(voxnerf, "positional_encoding", spy_pe)
    monkeypatch.setattr(fused_sample, "triplane_features", spy_k4)
    _, _, _, model = _bf16_pair(occ_grid_size=8)
    f32_interp = EvDeblurNeRF(model.cfg, eval_f32_interp=True)
    f32_interp.load_state_dict(model.state_dict())
    rays = torch.from_numpy(_rays(8))

    def flags(fn):
        calls.clear()
        with torch.no_grad():
            fn()
        return set(calls)

    chain = {("encoding", True), ("k4", True)}
    plain = {("encoding", False), ("k4", False)}
    assert flags(lambda: model.render(rays, is_train=False)) == chain
    assert flags(lambda: build_occ_grid(model)) == chain
    assert flags(lambda: model.render(rays, is_train=True)) == plain
    assert flags(lambda: f32_interp.render(rays, is_train=False)) == plain


@pytest.mark.parametrize("seed,dense", [(0, 0.0), (1, 8.0)])
def test_bf16_occupancy_bits_match_jax(seed, dense):
    """The occupancy refresh reads ``density`` through the bf16 chain on
    both sides: the grid bitwise (the two chains round at the same places
    on these inputs; a flip would mean they no longer do)."""
    jcfg, jmod, params, model = _bf16_pair(seed, dense, occ_grid_size=16)
    want = np.asarray(jsystem.build_occ_grid(jmod, {"params": params}))
    got = build_occ_grid(model).numpy()
    flips = int((got != want).sum())
    print(f"bf16 occupancy grid (seed {seed}, dense {dense}): {flips} of "
          f"{want.size} bits differ; occupied {float(want.mean()):.3f}")
    assert flips == 0
    assert 0 < got.mean() <= 1


def test_bf16_train_steps_match_jax():
    """5 steps of the port's step and the JAX step with bf16 tables (line
    matmul off) from one JAX init, RBK + AWP with the event loss on both
    EGM stages: per-step relative loss within 2e-5, the first step's terms
    at the repo's 2e-5."""
    args = oc.make_args({**oc.VARIANTS["rbk_awp"], "lrate": lc.LRATE,
                         "lrate_decay": lc.LRATE_DECAY,
                         "kernel_tv_loss_weight": lc.TV_W,
                         "no_log_grads_norm": True, "use_events": True,
                         "add_event_egm": True,
                         "add_event_egm_stages": ["stage0", "stage1"],
                         "events_threshold": lc.EV_THRESH,
                         "events_threshold_pos": lc.EV_THRESH,
                         "events_threshold_neg": lc.EV_THRESH,
                         "triplane_bf16": True})
    jcfg = dataclasses.replace(oc.make_cfg(args), triplane_bf16=True,
                               triplane_line_matmul=False)
    batches, ev_batches = lc.make_batches(), lc.make_ev_batches()
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
    variables = jax.tree_util.tree_map(np.asarray, dict(jmodel.init(
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

    cfg = RenderConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(RenderConfig)})
    assert cfg.triplane_bf16
    model = EvDeblurNeRF(cfg, kernel_config_from_args(args), oc.NUM_IMAGES)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    state = create_train_state(model, TonemappingTransform(), args,
                               torch.Generator(), crf_identity_prefit=False)
    step = tstep.build_train_step(args)

    def tensors(b):
        return {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in b.items()}

    rel = []
    for i in range(5):
        b, e = batches[i % lc.N_BATCHES], ev_batches[i % lc.N_BATCHES]
        jstate, jaux = jstep_fn(jstate, b, e, jax.random.PRNGKey(i), jsw,
                                force_naive=False, events_active=True)
        aux = step(state, tensors(b), tensors(e), sw, False, True)
        rel.append(abs(float(aux["loss"]) - float(jaux["loss"]))
                   / abs(float(jaux["loss"])))
        if i == 0:
            for k in ("img_loss", "psnr", "event_egm"):
                np.testing.assert_allclose(float(aux[k]), float(jaux[k]),
                                           rtol=RENDER_TOL, atol=RENDER_TOL,
                                           err_msg=k)
    print(f"bf16 steps: per-step relative loss difference {rel}")
    assert max(rel) < STEP_REL, rel
    assert all(getattr(model.mlp_fine, f"packed_plane_{i}").dtype
               == torch.bfloat16 for i in range(3))


def test_bf16_serving_renderer_takes_the_chain(tmp_path):
    """``build_renderer`` of a bf16 model serves through the bf16 eval
    chain (as the JAX artifact bakes it in): its chunk equals the model's
    eval render, which differs from the f32-interpolation render."""
    _, _, _, model = _bf16_pair(seed=2)
    sd = {k: v for k, v in model.state_dict().items()}
    args = tconfig.default_args(
        **{k: getattr(model.cfg, k) for k in (
            "N_samples", "N_importance", "multires", "multires_views",
            "coarse_n_voxels", "fine_n_voxels", "coarse_hidden_dim",
            "coarse_hidden_dim_color", "fine_hidden_dim",
            "fine_hidden_dim_color", "fine_geo_feat_dim", "coarse_app_dim",
            "fine_app_dim")},
        coarse_app_n_comp=list(model.cfg.coarse_app_n_comp),
        fine_app_n_comp=list(model.cfg.fine_app_n_comp), chunk=32,
        triplane_bf16=True, kernel_type="none", perturb=0.0,
        use_viewdirs=True)
    r = serving.build_renderer(args, sd, oc.H, oc.W, oc.K, 0.0, 1.0,
                               oc.AABB, device="cpu")
    assert r.model.cfg.triplane_bf16 and r.model.mlp_fine.eval_bf16(False)
    rays = torch.from_numpy(_rays(32))
    rgb, depth, _ = r(rays)
    with torch.no_grad():
        want = model.render_chunk(rays)
    torch.testing.assert_close(depth, want[1], rtol=0, atol=0)
    f32 = EvDeblurNeRF(model.cfg, eval_f32_interp=True)
    f32.load_state_dict(sd)
    with torch.no_grad():
        other = f32.render_chunk(rays)
    assert float((other[1] - depth).abs().max()) > 0


def test_eval_bf16_ab_tool_runs_on_the_cpu(tmp_path):
    """``tools/eval_bf16_ab_torch.py`` on a 2-step bf16 validation run at a
    small size: both arms' metrics, their difference and the pixel
    difference of the two renders, which the chain keeps small."""
    import os
    import runpy

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    scene = ["--scene", str(tmp_path / "scene"), "--logdir",
             str(tmp_path / "logs"), "--h", "32", "--w", "40"]
    small = ["--N_rand", "32", "--N_samples", "8", "--N_importance", "8",
             "--coarse_n_voxels", "4096", "--fine_n_voxels", "8192",
             "--events_N_rand", "32", "--device", "cpu", "--triplane_bf16"]
    tools = os.path.join(repo, "tools")
    runpy.run_path(os.path.join(tools, "validate_train_torch.py"))["main"](
        ["--iters", "2", "--expname", "bf16", *scene, *small])
    out = runpy.run_path(os.path.join(tools, "eval_bf16_ab_torch.py"))[
        "main"](["--expname", "bf16", *scene, *small])
    assert out["step"] == 2 and out["device"] == "cpu"
    for arm in ("bf16", "f32"):
        assert np.isfinite(out[arm]["psnr"])
    assert set(out["delta_bf16_minus_f32"]) == set(out["bf16"])
    assert 0 <= out["pixel_abs_diff"]["p99"] <= out["pixel_abs_diff"]["max"]
    assert out["pixel_abs_diff"]["max"] < 1e-2
