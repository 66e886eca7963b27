"""The port's vanilla-NeRF field (``mode=nerf``) and its renders without an
importance pass (``N_importance 0``), against the JAX package and the
recorded outputs of the original PyTorch code.

Inputs are made with numpy from a seed and handed to both sides. The
whole-model checks run the deterministic oracle variant ``nerf_rbk`` of
tests/oracle_common.py (RBK with 3 points on 16 rays, 2 x 16 NeRF MLPs,
4+4 samples, perturb 0, no sigma noise) on the golden weights. Bounds: the
repo's 2e-5 rtol/atol for forwards, ``atol 5e-4 * scale, rtol 5e-4`` for
gradients (tests/test_reference_parity.py) and 2e-2 relative per-step
loss for training steps (tests/test_lockstep_train.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lockstep_common as lc
import oracle_common as oc
from test_torch_blur_dsk import _info, _nest, _record
from evdeblurnerf_torch import serving
from evdeblurnerf_torch.models.nerf_mlp import NeRFMLP
from evdeblurnerf_torch.models.renderer import RenderConfig, Renderer
from evdeblurnerf_torch.models.system import (EvDeblurNeRF,
                                              kernel_config_from_args)
from evdeblurnerf_torch.models.tonemapping import TonemappingTransform
from evdeblurnerf_torch.train import step as tstep
from evdeblurnerf_torch.train.state import create_train_state
from evdeblurnerf_torch.utils.convert import (
    normalize_legacy_network_state_dict, state_dict_from_jax,
    variables_from_state_dict)
from evdeblurnerf_tpu.models import renderer as jrenderer
from evdeblurnerf_tpu.models.nerf_mlp import NeRFMLP as JNeRFMLP
from evdeblurnerf_tpu.models.system import EvDeblurNeRF as JModel
from evdeblurnerf_tpu.models.system import \
    kernel_config_from_args as jkernel_config
from evdeblurnerf_tpu.models.tonemapping import \
    TonemappingTransform as JTonemapping
from evdeblurnerf_tpu.train import optim as joptim
from evdeblurnerf_tpu.train import step as jstep
from evdeblurnerf_tpu.train.state import create_train_state as jcreate
from evdeblurnerf_tpu.utils import checkpoint_convert as cc

ATOL = RTOL = 2e-5


def _port_cfg(jcfg):
    return RenderConfig(**{f.name: getattr(jcfg, f.name)
                           for f in dataclasses.fields(RenderConfig)})


def _without_fine(variables):
    params = dict(variables["params"])
    params["renderer"] = {k: v for k, v in params["renderer"].items()
                          if k != "mlp_fine"}
    return {**variables, "params": params}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# the MLP alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D,skips,use_viewdirs,extract", [
    (8, (4,), True, "after_linear"), (3, (1,), True, "before_linear"),
    (6, (4,), False, "before_linear"), (2, (1,), False, "before_linear")])
def test_nerf_mlp_matches_jax(D, skips, use_viewdirs, extract):
    """Raw output and feature on one set of weights, with the skip
    (including a skip into the last layer's output) and both heads."""
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(11, 21)).astype(np.float32)
    views = rng.normal(size=(11, 9)).astype(np.float32) if use_viewdirs \
        else None
    jmod = JNeRFMLP(D=D, W=12, skips=skips, use_viewdirs=use_viewdirs,
                    rgb_add_bias=False, extract_feature=extract)
    params = _np_tree(jmod.init(jax.random.PRNGKey(1), pts, views)["params"])
    want_raw, want_feat = jmod.apply({"params": params}, pts, views)
    sd = state_dict_from_jax({"params": {"mlp_coarse": params}})
    tmod = NeRFMLP(21, 9, D=D, W=12, skips=skips, use_viewdirs=use_viewdirs,
                   rgb_add_bias=False, extract_feature=extract)
    tmod.load_state_dict({k[len("mlp_coarse."):]: v for k, v in sd.items()},
                         strict=True)
    raw, feat = tmod(torch.from_numpy(pts),
                     None if views is None else torch.from_numpy(views))
    np.testing.assert_allclose(raw.detach().numpy(), np.asarray(want_raw),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(feat.detach().numpy(), np.asarray(want_feat),
                               rtol=RTOL, atol=ATOL)
    assert feat.shape[-1] == tmod.feature_dim
    if use_viewdirs:
        assert tmod.rgb_linear.bias is None


def test_nerf_mlp_refuses_after_linear_without_viewdirs():
    with pytest.raises(ValueError, match="after_linear"):
        NeRFMLP(21, 9, use_viewdirs=False, extract_feature="after_linear")


# ---------------------------------------------------------------------------
# the oracle variant nerf_rbk: recorded original-PyTorch outputs
# ---------------------------------------------------------------------------

def _oracle_model():
    data = np.load(oc.oracle_path("nerf_rbk"))
    variables = _nest(data, "var/")
    args = oc.make_args(oc.VARIANTS["nerf_rbk"])
    model = EvDeblurNeRF(_port_cfg(oc.make_cfg(args)),
                         kernel_config_from_args(args), oc.NUM_IMAGES)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return data, variables, model.train()


def test_train_forward_and_eval_match_reference_and_jax():
    """Every ``out/*`` key of ``oracle_nerf_rbk.npz``: the training forward
    (no TV term in this mode) and the eval render, against the recording
    and the live JAX model."""
    data, variables, model = _oracle_model()
    rays, info = oc.make_inputs()
    got = _record(model.train_forward(torch.from_numpy(rays), _info(info),
                                      force_naive=False,
                                      return_pts0_rgb=True))
    with torch.inference_mode():
        ret = model.eval().render(torch.from_numpy(rays))
    got.update({f"eval/{k}": ret[k].numpy()
                for k in ("rgb_map", "depth_map", "acc_map", "rgb0")})
    live = oc.run_jax("nerf_rbk", variables)
    keys = [k[len("out/"):] for k in data.files if k.startswith("out/")]
    assert "loss/TV" not in got and "loss/TV" not in live
    assert set(keys) <= set(got) and len(keys) == 8
    for k in keys:
        np.testing.assert_allclose(got[k], data[f"out/{k}"], rtol=RTOL,
                                   atol=ATOL, err_msg=f"{k} vs reference")
        np.testing.assert_allclose(got[k], live[k], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{k} vs JAX")


def test_gradients_match_reference():
    """d(mse)/d(every parameter) of the NeRF MLPs, the RBK kernel and the
    view embedding, against the recorded autograd of the original code."""
    data, variables, model = _oracle_model()
    rays, info = oc.make_inputs()
    rgb, _, other_loss, _ = model.train_forward(
        torch.from_numpy(rays), _info(info), force_naive=False,
        return_pts0_rgb=True)
    assert not other_loss
    target = torch.from_numpy(oc.make_grad_target())
    torch.mean((rgb - target) ** 2).backward()
    ref = state_dict_from_jax({"params": _nest(data, "grad/")["params"]})
    named = dict(model.named_parameters())
    assert set(ref) == set(named) and len(ref) == 37
    for pname, want in ref.items():
        got = named[pname].grad
        if got is None:     # outside this loss's graph: recorded as zeros
            got = torch.zeros_like(named[pname])
        scale = max(float(want.abs().max()), 1e-6)
        np.testing.assert_allclose(got.numpy(), want.numpy(),
                                   atol=5e-4 * scale, rtol=5e-4,
                                   err_msg=f"gradient of {pname}")
    assert float(named["mlp_fine.pts_linears.0.weight"].grad.abs().max()) > 0


def test_nerf_weights_map_both_ways():
    """The golden tree goes to the reference's state dict and back
    unchanged, and the JAX package's exporter names the same keys."""
    _, variables, model = _oracle_model()
    sd = state_dict_from_jax(variables)
    assert set(sd) == set(cc.export_network_state_dict(variables))
    back = variables_from_state_dict(model.state_dict())
    flat = oc.flatten(variables)
    assert set(oc.flatten(back)) == set(flat)
    for k, v in oc.flatten(back).items():
        np.testing.assert_array_equal(v, flat[k], err_msg=k)


# ---------------------------------------------------------------------------
# the live JAX Renderer in mode=nerf and without an importance pass
# ---------------------------------------------------------------------------

RENDER_CASES = {
    "nerf": dict(mode="nerf"),
    "nerf_no_importance": dict(mode="nerf", N_importance=0),
    "nerf_awp_features": dict(mode="nerf", use_awp=True, netdepth=6,
                              netdepth_fine=6, rgb_activate="sigmoid1",
                              sigma_activate="softplus"),
    "nerf_no_viewdirs_white": dict(mode="nerf", use_viewdirs=False,
                                   use_awp=True, white_bkgd=True),
    "nerf_rmnearplane": dict(mode="nerf", render_rmnearplane=40),
    "c2f_no_importance": dict(mode="c2f", N_importance=0),
    "c2f_no_importance_pbe": dict(mode="c2f", N_importance=0,
                                  kernel_type="PBE"),
}


@pytest.mark.parametrize("case", list(RENDER_CASES))
def test_renderer_matches_jax(case):
    """Eval and deterministic training renders of the JAX ``Renderer`` and
    the port's on one set of weights: every output the two share, the
    per-sample features AWP reads included."""
    over = RENDER_CASES[case]
    jcfg = dataclasses.replace(
        oc.make_cfg(oc.make_args(oc.VARIANTS["nerf_rbk"])),
        **{"netdepth": 2, "netwidth": 16, "netdepth_fine": 3,
           "netwidth_fine": 12, **over})
    rays = oc.make_inputs()[0]
    jmod = jrenderer.Renderer(jcfg)
    params = _np_tree(jmod.init(jax.random.PRNGKey(4), jax.random.PRNGKey(5),
                                rays, is_train=False)["params"])
    model = Renderer(_port_cfg(jcfg))
    model.load_state_dict(state_dict_from_jax({"params": params}),
                          strict=True)
    assert (model.mlp_fine is None) == (jcfg.N_importance == 0)
    for is_train in (False, True):
        want = jmod.apply({"params": params}, jax.random.PRNGKey(0), rays,
                          is_train=is_train, perturb=0.0,
                          method=jrenderer.Renderer.render)
        got = model.render(torch.from_numpy(rays), is_train=is_train,
                           want_features=True)
        shared = set(want) & set(got)
        assert {"rgb_map", "depth_map", "acc_map", "weights",
                "z_vals"} <= shared
        assert ("rgb0" in got) == ("rgb0" in want) == \
            ("z_std" in got) == (jcfg.N_importance > 0)
        if jcfg.use_awp or jcfg.mode == "nerf":
            assert "depth_feature" in shared
            assert got["depth_feature"].shape[-1] == model.feature_dim
        for k in shared:
            np.testing.assert_allclose(got[k].detach().numpy(),
                                       np.asarray(want[k]), rtol=RTOL,
                                       atol=ATOL, err_msg=f"{k} {is_train}")
    # the PBE stage-0 pass composites the coarse feature over the ray
    want_rgb, want_feat = jmod.apply(
        {"params": params}, jax.random.PRNGKey(0), rays, is_train=True,
        perturb=0.0, method=jrenderer.Renderer.coarse_render)
    got_rgb, got_feat = model.coarse_render(torch.from_numpy(rays),
                                            is_train=True)
    np.testing.assert_allclose(got_rgb.detach().numpy(),
                               np.asarray(want_rgb), rtol=RTOL, atol=ATOL)
    if jcfg.composite_feature_coarse or jcfg.mode == "nerf":
        np.testing.assert_allclose(got_feat.detach().numpy(),
                                   np.asarray(want_feat), rtol=RTOL,
                                   atol=ATOL)
    np.testing.assert_allclose(
        float(model.tv_loss()),
        float(jmod.apply({"params": params},
                         method=jrenderer.Renderer.tv_loss)), rtol=RTOL)


def test_pbe_awp_without_importance_pass_refused_as_in_jax():
    """PBE's AWP composites the coarse feature beside a fine pass; with
    N_importance 0 both packages refuse the model with one message."""
    args = oc.make_args({**oc.VARIANTS["pbe"], "kernel_use_awp": True,
                         "N_importance": 0})
    jcfg = dataclasses.replace(oc.make_cfg(args), N_importance=0)
    rays, info = oc.make_inputs()
    with pytest.raises(ValueError) as jerr:
        JModel(cfg=jcfg, kcfg=jkernel_config(args), num_images=oc.NUM_IMAGES,
               K=oc.K).init(jax.random.PRNGKey(0), jax.random.PRNGKey(1),
                            rays, info, force_naive=False)
    with pytest.raises(ValueError) as terr:
        EvDeblurNeRF(_port_cfg(jcfg), kernel_config_from_args(args),
                     oc.NUM_IMAGES)
    assert str(terr.value) == str(jerr.value)
    assert "Mixing PBE and AWP is not supported when N_importance == 0" \
        in str(terr.value)


# ---------------------------------------------------------------------------
# training steps against the JAX step
# ---------------------------------------------------------------------------

STEP_CASES = {
    "nerf": dict(name="nerf_rbk"),
    "nerf_no_importance": dict(name="nerf_rbk", N_importance=0),
    # AWP then reads the coarse field's features: weights from a JAX init
    "c2f_no_importance": dict(name="rbk_awp", N_importance=0),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_steps_match_jax(case):
    """5 steps of the port's train step and the JAX step from the golden
    weights, with the event loss on both EGM stages: per-step loss within
    2e-2 relative, the first step's terms and gradients at the repo's
    bounds. ``mode=nerf`` writes no TV term; without an importance pass
    there is no ``rgb1``, so its image, pts0 and EGM ``stage0`` terms drop
    out."""
    over = dict(STEP_CASES[case])
    name = over.pop("name")
    n_imp = over.get("N_importance", oc.N_IMPORTANCE)
    args = oc.make_args({**oc.VARIANTS[name], **over, "lrate": lc.LRATE,
                         "lrate_decay": lc.LRATE_DECAY,
                         "kernel_tv_loss_weight": lc.TV_W,
                         "no_log_grads_norm": True, "use_events": True,
                         "add_event_egm": True,
                         "add_event_egm_stages": ["stage0", "stage1"],
                         "events_threshold": lc.EV_THRESH,
                         "events_threshold_pos": lc.EV_THRESH,
                         "events_threshold_neg": lc.EV_THRESH})
    jcfg = dataclasses.replace(oc.make_cfg(args), N_importance=n_imp)
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
    jcrf = JTonemapping()
    tx = joptim.build_optimizer(lc.LRATE, lc.LRATE_DECAY)
    info = {k: batches[0][k] for k in ("images_idx", "rays_x", "rays_y",
                                       "poses")}
    if jcfg.mode == "c2f":
        variables = _np_tree(dict(jmodel.init(
            jax.random.PRNGKey(6), jax.random.PRNGKey(7), batches[0]["rays"],
            info, force_naive=False, return_pts0_rgb=True)))
    else:
        variables = _nest(np.load(oc.oracle_path(name)), "var/")
        if n_imp == 0:
            variables = _without_fine(variables)
    jstate = jcreate(jmodel, jcrf, tx, jax.random.PRNGKey(5),
                     batches[0]["rays"], info)
    jstate = jstate.replace(
        params={"nerf": jax.tree_util.tree_map(jnp.asarray,
                                               variables["params"]),
                "crf": jstate.params["crf"]},
        batch_stats=jax.tree_util.tree_map(
            jnp.asarray, variables.get("batch_stats", jstate.batch_stats)))
    jstep_fn = jstep.build_train_step(jmodel, jcrf, tx, args,
                                      return_grads=True)

    model = EvDeblurNeRF(_port_cfg(jcfg), kernel_config_from_args(args),
                         oc.NUM_IMAGES)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    state = create_train_state(model, TonemappingTransform(), args,
                               torch.Generator(), crf_identity_prefit=False)
    step = tstep.build_train_step(args, return_grads=True)

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
        if i:
            continue
        assert set(aux) - {"grads"} == set(jaux) - {"grads_tree"}
        assert ("tv_loss" in aux) == (jcfg.mode == "c2f")
        for k in ("img_loss", "psnr", "pts0_loss", "event_egm"):
            np.testing.assert_allclose(float(aux[k]), float(jaux[k]),
                                       rtol=RTOL, atol=ATOL, err_msg=k)
        assert float(aux["event_egm"]) > 0
        want = state_dict_from_jax({"params": jaux["grads_tree"]["nerf"]})
        # a parameter whose whole gradient is below 1e-4 of the step's
        # largest entry (the blur weights' biases behind a near-uniform
        # softmax at a fresh init) is held at that floor, not at its own
        floor = 1e-4 * max(float(w.abs().max()) for w in want.values())
        for pname, w in want.items():
            if pname.startswith("awpnet.MAM.conv.") or pname.endswith(
                    "num_batches_tracked"):
                continue        # synthesised for strict loading
            if pname not in aux["grads"]:
                assert not w.any(), pname
                continue
            scale = max(float(w.abs().max()), floor)
            np.testing.assert_allclose(aux["grads"][pname].numpy(),
                                       w.numpy(), atol=5e-4 * scale,
                                       rtol=5e-4, err_msg=pname)
    assert max(rel) < 2e-2, rel
    print(f"{case}: per-step relative loss difference {rel}")


def test_egm_stage0_without_importance_pass_warns(capsys):
    args = oc.make_args({**oc.VARIANTS["nerf_rbk"], "N_importance": 0,
                         "add_event_egm": True,
                         "add_event_egm_stages": ["stage0"]})
    tstep.build_train_step(args)
    assert "no stage matches" in capsys.readouterr().out
    args = oc.make_args({**oc.VARIANTS["nerf_rbk"], "add_event_egm": True,
                         "add_event_egm_stages": ["stage0"]})
    tstep.build_train_step(args)
    assert "no stage matches" not in capsys.readouterr().out


# ---------------------------------------------------------------------------
# serving and the legacy two-network checkpoints
# ---------------------------------------------------------------------------

def _serve_args(**over):
    return oc.make_args({**oc.VARIANTS["nerf_rbk"], "chunk": 16,
                         "fine_cull_capacity": 0.0, "triplane_bf16": False,
                         **over})


def test_legacy_two_network_checkpoint_loads_strictly(tmp_path):
    """A DP-NeRF-era checkpoint (``network_fn_state_dict`` +
    ``network_fine_state_dict``, the fine one behind ``module.``) is read by
    ``serving.load_network_state_dict`` into the fields' keys, as the JAX
    package's normaliser reads it, and serves what the modern layout
    serves."""
    ora = np.load(oc.os.path.join(oc.GOLDEN_DIR, "oracle_convert.npz"))
    sd = {k[len("net_nerf_rbk/"):]: torch.from_numpy(ora[k])
          for k in ora.files if k.startswith("net_nerf_rbk/")}
    fn = {k[len("mlp_coarse."):]: v for k, v in sd.items()
          if k.startswith("mlp_coarse.")}
    fine = {"module." + k[len("mlp_fine."):]: v for k, v in sd.items()
            if k.startswith("mlp_fine.")}
    legacy = {"network_fn_state_dict": fn, "network_fine_state_dict": fine,
              "global_step": 3}
    want = cc.normalize_legacy_network_state_dict(
        {k: {n: t.numpy() for n, t in v.items()} if isinstance(v, dict)
         else v for k, v in legacy.items()})
    got = normalize_legacy_network_state_dict(legacy)
    assert sorted(got) == sorted(want)
    assert normalize_legacy_network_state_dict({"network_state_dict": sd}) \
        is None
    torch.save(legacy, tmp_path / "legacy.tar")
    loaded = serving.load_network_state_dict(str(tmp_path / "legacy.tar"))
    fields = {k: v for k, v in sd.items() if k.startswith("mlp_")}
    assert sorted(loaded) == sorted(fields)

    args = _serve_args()
    legacy_r = serving.build_renderer(args, loaded, oc.H, oc.W, oc.K, 0.0,
                                      1.0, oc.AABB, "cpu")
    modern_r = serving.build_renderer(args, sd, oc.H, oc.W, oc.K, 0.0, 1.0,
                                      oc.AABB, "cpu")
    assert legacy_r.unused_keys == () and modern_r.unused_keys
    rays = torch.from_numpy(oc.make_inputs()[0])
    for a, b in zip(legacy_r(rays), modern_r(rays)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_serving_renders_nerf_mode_as_the_jax_eval():
    """``build_renderer`` on the golden NeRF fields: a chunk equals the JAX
    model's eval render, and whole poses render."""
    data = np.load(oc.oracle_path("nerf_rbk"))
    sd = state_dict_from_jax(_nest(data, "var/"))
    r = serving.build_renderer(_serve_args(), sd, oc.H, oc.W, oc.K, 0.0, 1.0,
                               oc.AABB, "cpu")
    assert r.model.cfg.mode == "nerf" and r.device.type == "cpu"
    rgb, depth, acc = r(torch.from_numpy(oc.make_inputs()[0]))
    np.testing.assert_allclose(rgb.numpy(), data["out/eval/rgb_map"],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(depth.numpy(), data["out/eval/depth_map"],
                               rtol=RTOL, atol=ATOL)
    pose = np.concatenate([np.eye(3), np.zeros((3, 1))], 1)[None]
    rgbs, depths = r.render_poses(pose, H=8, W=10, K=np.array(
        [[12.0, 0, 5], [0, 12.0, 4], [0, 0, 1]]))
    assert rgbs.shape == (1, 8, 10, 3) and bool(torch.isfinite(rgbs).all())
