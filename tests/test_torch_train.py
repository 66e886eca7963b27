"""The port's training step, piece by piece and as a whole, against the JAX
package and the recorded outputs of the original PyTorch code.

Inputs are made with numpy from a seed and handed to both sides. The
whole-model checks run the deterministic oracle variant ``rbk_awp`` of
tests/oracle_common.py (16 rays x 3 motions, 4+4 samples, perturb 0, no
sigma noise) on the golden weights. Bounds: the repo's own 2e-5
rtol/atol for forwards and its ``atol 5e-4 * scale, rtol 5e-4`` for
gradients (tests/test_reference_parity.py), 2e-2 relative per-step loss
for the lockstep replays (tests/test_lockstep_train.py), unless a test
states another.
"""

import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import lockstep_common as lc
import oracle_common as oc
from evdeblurnerf_torch import config as tconfig
from evdeblurnerf_torch.models.blur_rbk import RigidBlurringModel
from evdeblurnerf_torch.models.embedding import ViewEmbedding
from evdeblurnerf_torch.models.renderer import RenderConfig
from evdeblurnerf_torch.models.system import (EvDeblurNeRF,
                                              kernel_config_from_args)
from evdeblurnerf_torch.models.tonemapping import (CRF, TonemappingTransform,
                                                   crf_init_identity)
from evdeblurnerf_torch.ops.compositing import CumprodLanes
from evdeblurnerf_torch.ops.triplane import pack_grids
from evdeblurnerf_torch.train import optim as toptim
from evdeblurnerf_torch.train import step as tstep
from evdeblurnerf_torch.train.state import create_train_state
from evdeblurnerf_torch.utils import se3 as tse3
from evdeblurnerf_torch.utils.convert import (crf_state_dict_from_jax,
                                              state_dict_from_jax)
from evdeblurnerf_torch.utils.events import egm_loss
from evdeblurnerf_tpu import config as jconfig
from evdeblurnerf_tpu.models import awp as jawp
from evdeblurnerf_tpu.models.blur_rbk import \
    RigidBlurringModel as JRigidBlurringModel
from evdeblurnerf_tpu.models.tonemapping import \
    TonemappingTransform as JTonemapping
from evdeblurnerf_tpu.ops import compositing as jcomp
from evdeblurnerf_tpu.train import optim as joptim
from evdeblurnerf_tpu.train import step as jstep
from evdeblurnerf_tpu.utils import se3 as jse3
from evdeblurnerf_tpu.utils.misc import annealing_interpolator

ATOL = RTOL = 2e-5
TRAIN_KEYS = ("rgb", "rgb1", "loss/TV", "tensor/rgb_awp",
              "tensor/stage1_rgb_pts0", "tensor/stage1_rgb1_pts0")


def _nest(data, prefix):
    """Nested dict of the ``prefix``-keyed keystr leaves of an npz."""
    tree = {}
    for k in data.files:
        if k.startswith(prefix):
            *path, leaf = re.findall(r"\['([^']+)'\]", k[len(prefix):])
            node = tree
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = data[k]
    return tree


def _model(variables, args=None):
    args = args or oc.make_args(oc.VARIANTS["rbk_awp"])
    jcfg = oc.make_cfg(args)
    cfg = RenderConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(RenderConfig)})
    model = EvDeblurNeRF(cfg, kernel_config_from_args(args), oc.NUM_IMAGES)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model.train()


def _train_forward(model):
    rays, info = oc.make_inputs()
    return model.train_forward(
        torch.from_numpy(rays),
        {"images_idx": torch.from_numpy(info["images_idx"])},
        force_naive=False, return_pts0_rgb=True)


def _record(out):
    rgb, rgb1, loss, tensors = out
    rec = {"rgb": rgb, "rgb1": rgb1, "loss/TV": loss["TV"]}
    rec.update({f"tensor/{k}": v for k, v in tensors.items()})
    return {k: v.detach().numpy() for k, v in rec.items()}


# ---------------------------------------------------------------------------
# the training forward and its gradients on the oracle variant
# ---------------------------------------------------------------------------

def test_train_forward_matches_reference_and_jax():
    data = np.load(oc.oracle_path("rbk_awp"))
    variables = _nest(data, "var/")
    got = _record(_train_forward(_model(variables)))
    live = oc.run_jax("rbk_awp", variables)
    for k in TRAIN_KEYS:
        np.testing.assert_allclose(got[k], data[f"out/{k}"], rtol=RTOL,
                                   atol=ATOL, err_msg=f"{k} vs reference")
        np.testing.assert_allclose(got[k], live[k], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{k} vs JAX")


def test_gradients_match_reference():
    """d(mse + TV)/d(every parameter), the loss of
    tests/oracle_common.py::run_jax_grads, against the recorded autograd of
    the original code."""
    data = np.load(oc.oracle_path("rbk_awp"))
    variables = _nest(data, "var/")
    model = _model(variables)
    rgb, _, other_loss, _ = _train_forward(model)
    target = torch.from_numpy(oc.make_grad_target())
    loss = torch.mean((rgb - target) ** 2) + sum(
        torch.sum(v) for v in other_loss.values())
    loss.backward()
    ref = state_dict_from_jax({"params": _nest(data, "grad/")["params"]})
    named = dict(model.named_parameters())
    checked = 0
    for name, want in ref.items():
        # the never-run MAM.conv and the BatchNorm counters have none
        if name.startswith("awpnet.MAM.conv.") or name not in named:
            assert name.startswith("awpnet.MAM.conv.") or name.endswith(
                "num_batches_tracked")
            continue
        # outside the graph of this loss (the coarse MLPs feed only the
        # detached importance draws, AWP only rgb_awp): no gradient, which
        # the reference records as zeros
        got = named[name].grad
        if got is None:
            got = torch.zeros_like(named[name])
        scale = max(float(want.abs().max()), 1e-6)
        np.testing.assert_allclose(got.numpy(), want.numpy(),
                                   atol=5e-4 * scale, rtol=5e-4,
                                   err_msg=f"gradient of {name}")
        checked += 1
    assert checked == sum(1 for n in named if not n.startswith(
        "awpnet.MAM.conv."))


def test_awp_batchnorm_statistics_match_jax():
    """One train-mode AWP forward updates the MAM BatchNorm statistics as
    flax does, up to torch's unbiased running variance: flax adds
    0.1 * var_biased, torch 0.1 * var_biased * n / (n - 1). Eval mode reads
    the running statistics."""
    data = np.load(oc.oracle_path("rbk_awp"))
    variables = _nest(data, "var/")
    model = _model(variables)
    rng = np.random.default_rng(3)
    R, S = 48, 8
    feat = rng.uniform(0, 1, (R, S, 8)).astype(np.float32)
    z = np.sort(rng.uniform(0, 1, (R, S)), -1).astype(np.float32)
    rays_d = rng.normal(size=(R, 3)).astype(np.float32)
    view = rng.normal(size=(R // 3, 8)).astype(np.float32)
    jmod = jawp.AdaptiveWeightProposal(num_motion=2, D_sam=2, W_sam=64,
                                       D_mot=1, W_mot=32)
    jvars = {"params": variables["params"]["awpnet"],
             "batch_stats": variables["batch_stats"]["awpnet"]}
    want, new = jmod.apply(jvars, feat, z, rays_d, view, is_train=True,
                           mutable=["batch_stats"])
    bn = model.awpnet.MAM.Corr.convd[1]
    var0 = bn.running_var.clone()
    got = model.awpnet(*map(torch.from_numpy, (feat, z, rays_d, view)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    stats = new["batch_stats"]["MAM"]["Corr"]["convd_bn"]
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(stats["mean"]), rtol=1e-5,
                               atol=1e-6)
    n = R
    var_biased = (np.asarray(stats["var"]) - 0.9 * var0.numpy()) / 0.1
    np.testing.assert_allclose(
        bn.running_var.numpy(),
        0.9 * var0.numpy() + 0.1 * var_biased * n / (n - 1), rtol=1e-5,
        atol=1e-6)
    model.awpnet.eval()
    want_eval = jmod.apply(jvars, feat, z, rays_d, view, is_train=False)
    jvars["batch_stats"] = {"MAM": {"Corr": {"convd_bn": {
        "mean": bn.running_mean.numpy(), "var": bn.running_var.numpy()}}}}
    want_eval = jmod.apply(jvars, feat, z, rays_d, view, is_train=False)
    got_eval = model.awpnet(*map(torch.from_numpy, (feat, z, rays_d, view)))
    np.testing.assert_allclose(got_eval.detach().numpy(),
                               np.asarray(want_eval), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# parts
# ---------------------------------------------------------------------------

def test_cumprod_backward_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.uniform(1e-3, 1.0, (7, 5, 33)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    _, vjp = jax.vjp(jcomp._cumprod_lanes, jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    xt = torch.from_numpy(x).requires_grad_()
    y = CumprodLanes.apply(xt)
    np.testing.assert_allclose(y.detach().numpy(),
                               np.cumprod(x, -1), rtol=1e-5, atol=1e-7)
    y.backward(torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-5, atol=1e-6)
    # and the compositing weights with sigma noise, value and gradient
    sigma = rng.normal(size=(16, 9)).astype(np.float32) * 3
    z = np.sort(rng.uniform(0, 1, (16, 9)), -1).astype(np.float32)
    rays_d = rng.normal(size=(16, 3)).astype(np.float32)
    noise = rng.normal(size=(16, 8)).astype(np.float32)

    def jloss(s):
        return jnp.sum(jcomp.compute_weights(
            s, jnp.asarray(z), jnp.asarray(rays_d), jax.nn.relu,
            noise=jnp.asarray(noise)) ** 2)

    from evdeblurnerf_torch.ops import compositing as tcomp
    st = torch.from_numpy(sigma).requires_grad_()
    w = tcomp.compute_weights(st, torch.from_numpy(z),
                              torch.from_numpy(rays_d), torch.relu,
                              noise=torch.from_numpy(noise))
    (w ** 2).sum().backward()
    np.testing.assert_allclose(float((w ** 2).sum().detach()),
                               float(jloss(jnp.asarray(sigma))), rtol=RTOL)
    np.testing.assert_allclose(st.grad.numpy(),
                               np.asarray(jax.grad(jloss)(jnp.asarray(sigma))),
                               rtol=1e-4, atol=1e-6)


def test_se3_and_rbk_warp_match_jax():
    rng = np.random.default_rng(5)
    rot = rng.normal(size=(11, 4, 3)).astype(np.float32) * 0.3
    trans = rng.normal(size=(11, 4, 3)).astype(np.float32) * 0.3
    rot[0, 0] = 0.0                          # the theta + eps path
    want = np.asarray(jse3.se3_transform_from_rot_trans(jnp.asarray(rot),
                                                        jnp.asarray(trans)))
    got = tse3.se3_transform_from_rot_trans(torch.from_numpy(rot),
                                            torch.from_numpy(trans))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    pts = rng.normal(size=(11, 4, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tse3.se3_warp_points(torch.from_numpy(pts), got).numpy(),
        np.asarray(jse3.se3_warp_points(jnp.asarray(pts), jnp.asarray(want))),
        rtol=1e-5, atol=1e-6)

    # the whole kernel: branches, weights and the ray warp
    rays = oc.make_inputs()[0]
    embed = rng.normal(size=(oc.N, 8)).astype(np.float32)
    jmod = JRigidBlurringModel(view_embed_cnl=8, num_motion=4, feat_ch=0,
                               rv_window=0.2)
    jvars = jmod.init(jax.random.PRNGKey(3), rays, embed)
    # make the motions large enough to matter
    jvars = jax.tree_util.tree_map(lambda v: v * 3e4 if v.ndim == 2 and
                                   v.shape[1] == 12 else v, jvars)
    want_rays, want_w, _ = jmod.apply(jvars, rays, embed)
    sd = state_dict_from_jax({"params": {"kernelnet": jvars["params"]}})
    tmod = RigidBlurringModel(ViewEmbedding(1, 8), 8, num_motion=4,
                              feat_ch=0, rv_window=0.2)
    tmod.load_state_dict({**{k[len("kernelsnet."):]: v
                             for k, v in sd.items()},
                          "view_embed_module.img_embed": torch.zeros(1, 8)})
    got_rays, got_w = tmod(torch.from_numpy(rays), torch.from_numpy(embed))
    assert float(np.abs(np.asarray(want_rays)[:, 1:] - rays[:, None]).max()) \
        > 1e-3
    np.testing.assert_allclose(got_rays.detach().numpy(),
                               np.asarray(want_rays), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_w.detach().numpy(), np.asarray(want_w),
                               rtol=1e-5, atol=1e-7)


def test_rbk_head_init_bound():
    """The reference's inverted xavier gain: bound 1e-5 * 6 / (W + out)."""
    m = RigidBlurringModel(ViewEmbedding(2, 32), 32, num_motion=9,
                           generator=torch.Generator().manual_seed(0))
    bound = 1e-5 * 6 / (32 + 27)
    for layer in (m.r_linear, m.v_linear):
        top = float(layer.weight.detach().abs().max())
        assert 0.8 * bound < top <= bound
    assert m.w_linear.out_features == 10


def test_crf_and_egm_match_reference():
    data = np.load(oc.GOLDEN_DIR + "/oracle_components.npz")
    crf = TonemappingTransform("gamma", "learn", 2.2, "rec601",
                               extra_features_event=2)
    crf.load_state_dict(crf_state_dict_from_jax(
        _nest(data, "var/")["params"]), strict=True)
    x, feat = map(torch.from_numpy, oc.make_crf_inputs())
    with torch.no_grad():
        got = {
            "encode_rgb": crf.encode_rgb(x),
            "encode_luma": crf.encode_luma(x, ev_extra_feat=feat),
            "encode_luma_nofeat": crf.encode_luma(x),
            "encode_luma_tonemap_only": crf.encode_luma(
                x, ev_extra_feat=feat, tonemap_only=True),
            "encode_luma_skip": crf.encode_luma(x, skip_learn_crf=True),
        }
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), data[f"crf/{k}"], rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    ls, le, bii, mask, cw, ms, me = map(torch.from_numpy,
                                        oc.make_egm_inputs())
    for k, v in {"mono": egm_loss(ms, me, bii),
                 "color": egm_loss(ls, le, bii, color_mask=mask),
                 "color_weighted": egm_loss(ls, le, bii, color_mask=mask,
                                            color_weight=cw)}.items():
        np.testing.assert_allclose(float(v), data[f"egm/{k}"], rtol=RTOL,
                                   atol=ATOL, err_msg=k)


def test_crf_identity_prefit_and_skip():
    crf = CRF("learn", extra_features=2,
              generator=torch.Generator().manual_seed(0))
    x = torch.rand(256, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        before = float((crf(x) - x).abs().mean())
    crf_init_identity(crf, steps=1000,
                      generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        after = float((crf(x) - x).abs().mean())
    assert after < 0.02 and after < 0.2 * before, (before, after)
    # before the learn start the learned branch is not in the graph
    y = crf(x.requires_grad_(), skip_learn=True)
    y.sum().backward()
    assert all(p.grad is None for p in crf.parameters())


@pytest.mark.parametrize("path", [
    "configs/evdeblurnerf_blender/tx_blurfactory_evdeblurnerf_ediprior_evcrf"
    ".txt",
    "configs/evdeblurnerf_cdavis/tx_blurbatteries_evdeblurnerf_ediprior_"
    "evcrf_color.txt"])
def test_schedule_weights_match_jax(path):
    args = jconfig.parse_args(["--config", path])
    jconfig.resolve_event_thresholds(args)
    kw = dict(
        kernel_end_warmup_iter=-1, w_kernel=lambda s: 1.0,
        w_pts0_target=annealing_interpolator(
            args.pts0_target_weight, args.pts0_target_weight_end,
            args.pts0_target_weight_steps, args.pts0_target_weight_scheduler),
        w_events_egm=annealing_interpolator(
            args.event_egm_weight, args.event_egm_weight_end,
            args.event_egm_weight_steps, args.event_egm_weight_scheduler),
        fine_loss_weight=0.1, events_active=True)
    port = tstep.schedule_weights_fn(args)
    for i in (0, 1200, 1201, 10000):
        want = jstep.compute_schedule_weights(args, i, **kw)
        got = port(i)
        for f in dataclasses.fields(tstep.ScheduleWeights):
            np.testing.assert_allclose(
                np.asarray(getattr(got, f.name), np.float64),
                np.asarray(getattr(want, f.name), np.float64), rtol=1e-6,
                err_msg=f"{f.name} at step {i}")


def test_adam_and_lr_rule_match_jax():
    """5 steps of the port's Adam + LR rule against build_optimizer, with
    the colour-net decay group and a parameter that joins at step 3 (its
    gradient None before, zeros on the JAX side)."""
    rng = np.random.default_rng(6)
    init = {"a": rng.normal(size=(3, 4)), "b": rng.normal(size=(5,)),
            "w": rng.normal(size=(2, 3))}
    init = {k: v.astype(np.float32) for k, v in init.items()}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in init.items()} for _ in range(5)]
    jtree = {"a": init["a"], "b": init["b"],
             "mlp": {"color_net_0": {"kernel": init["w"]}}}
    tx = joptim.build_optimizer(5e-3, 10, warmup_iters=3, warmup_factor=0.1,
                                colornet_weightdecay=0.3, params=jtree)
    jparams = jax.tree_util.tree_map(jnp.asarray, jtree)
    opt_state = tx.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in init.items()}
    opt = toptim.build_optimizer(
        [("a", tparams["a"]), ("b", tparams["b"]),
         ("mlp.color_net.0.weight", tparams["w"])], 5e-3,
        colornet_weightdecay=0.3)
    schedule = toptim.lr_schedule(5e-3, 10, 3, 0.1)
    for i, g in enumerate(grads):
        late = i < 3
        jg = {"a": g["a"], "b": np.zeros_like(g["b"]) if late else g["b"],
              "mlp": {"color_net_0": {"kernel": g["w"]}}}
        updates, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray,
                                                              jg),
                                       opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in tparams.items():
            p.grad = None if (k == "b" and late) else torch.from_numpy(g[k])
        toptim.set_lr(opt, schedule(i))
        opt.step()
        for k, want in (("a", jparams["a"]), ("b", jparams["b"]),
                        ("w", jparams["mlp"]["color_net_0"]["kernel"])):
            np.testing.assert_allclose(tparams[k].detach().numpy(),
                                       np.asarray(want), rtol=1e-5,
                                       atol=1e-7, err_msg=f"{k} step {i}")


def test_chip_smoke_train_flags_are_the_paper_config():
    """chip_smoke.py parses the paper configuration through the port's own
    parser, through bench_torch.py: what ``chip_smoke.train_args()``
    returns equals the JAX package's parse of the same file with the two
    overrides, flag by flag, apart from PORT_DEFAULTS (grad_accum among
    them) and the port's own ``device``."""
    import bench_torch
    import chip_smoke

    argv = ["--config", bench_torch.PAPER_CONFIG]
    for k, v in bench_torch.PAPER_OVERRIDES.items():
        argv += [f"--{k}", str(v)]
    want = jconfig.resolve_event_thresholds(
        jconfig.parse_args(argv)).as_dict()
    got = chip_smoke.train_args().as_dict()
    assert got.pop("device") == "cuda"
    assert os.path.samefile(got.pop("config"), want.pop("config"))
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == tconfig.PORT_DEFAULTS.get(k, v), k
    assert got["kernel_start_iter"] == 0 and got["kernel_ptnum"] == 10
    assert got["events_threshold_pos"] == got["events_threshold"] == 0.2
    assert chip_smoke.train_args().grad_accum == \
        tconfig.PORT_DEFAULTS["grad_accum"]
    assert chip_smoke.train_args(perturb=0.0).perturb == 0.0
    assert chip_smoke.train_args().as_dict() == \
        bench_torch.train_args().as_dict()
    # one maker of the bench batch, with what the DSK/PBE kernels read
    batch, ev = chip_smoke.make_train_batch("cpu", 8, 4)
    assert set(batch) == {"rays", "rays_x", "rays_y", "images_idx", "poses",
                          "rgbsf", "rgbsf_pts0"}
    assert batch["poses"].shape == (8, 3, 4) and len(ev) == 4


def test_port_defaults_pin_grad_accum():
    """The port trains the paper step with ``grad_accum`` from
    PORT_DEFAULTS (the decision and its measurement: PERF.md), unless a
    flag sets it."""
    assert tconfig.PORT_DEFAULTS["grad_accum"] == 1
    assert tconfig.parse_args([]).grad_accum == 1
    assert tconfig.parse_args(["--grad_accum", "4"]).grad_accum == 4


# ---------------------------------------------------------------------------
# lockstep replays of the recorded reference trajectories
# ---------------------------------------------------------------------------

def _tensors(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _replay(path, args, crf, n_steps, sw_fn, ev_batches=None):
    data = np.load(path)
    init = _nest(data, "init/")
    model = _model({"params": init["params"],
                    "batch_stats": init["batch_stats"]}, args)
    if "crf" in init:
        crf.load_state_dict(crf_state_dict_from_jax(init["crf"]),
                            strict=True)
    state = create_train_state(model, crf, args, torch.Generator(),
                               crf_identity_prefit=False)
    step = tstep.build_train_step(args)
    batches = [_tensors(b) for b in lc.make_batches()]
    evs = [_tensors(b) for b in ev_batches] if ev_batches else None
    losses = []
    for i in range(n_steps):
        aux = step(state, batches[i % lc.N_BATCHES],
                   evs[i % lc.N_BATCHES] if evs else None, sw_fn(i),
                   force_naive=False, events_active=evs is not None)
        losses.append(float(aux["loss"]))
    # the optimizer's in-place updates reached the tables sample() reads
    for field in (model.mlp_coarse, model.mlp_fine):
        planes, lines, _ = pack_grids(*field.grids())
        assert torch.equal(field.packed_plane_0, planes[0])
        assert torch.equal(field.packed_line_2, lines[2])
    ref = data["losses_ref"][:n_steps]
    rel = np.abs(np.asarray(losses) - ref) / np.maximum(ref, 1e-12)
    return rel


def test_lockstep_replay_matches_reference():
    sw = tstep.ScheduleWeights(cf=1.0 - lc.FINE_LOSS_WEIGHT,
                               ff=lc.FINE_LOSS_WEIGHT)
    rel = _replay(lc.golden_path(), lc.lockstep_args(),
                  TonemappingTransform("none", "none"), 10, lambda i: sw)
    assert rel.max() < 2e-2, f"max rel {rel.max():.2e} at {rel.argmax()}"


def test_lockstep_replay_events_matches_reference():
    """25 steps of the events-on recording: EGM on stage0 + stage1, colour
    events, 'color-pos-neg' BII, the learned event CRF whose learn start
    (step 20) the replay crosses."""
    args = lc.lockstep_ev_args()
    jconfig.resolve_event_thresholds(args)
    w_egm = annealing_interpolator(
        args.event_egm_weight, args.event_egm_weight_end,
        args.event_egm_weight_steps, args.event_egm_weight_scheduler)

    def sw_fn(i):
        return tstep.compute_schedule_weights(
            args, i, kernel_end_warmup_iter=-1, w_kernel=lambda s: 1.0,
            w_pts0_target=lambda s: 0.0, w_events_egm=w_egm,
            fine_loss_weight=lc.FINE_LOSS_WEIGHT, events_active=True)

    crf = TonemappingTransform("none", "learn", 2.2, "rec601",
                               extra_features_event=2)
    rel = _replay(lc.golden_path_ev(), args, crf, 25, sw_fn,
                  lc.make_ev_batches())
    assert rel.max() < 2e-2, f"max rel {rel.max():.2e} at {rel.argmax()}"
    assert rel[lc.CRF_LEARN_START - 1] < 2e-2
    assert rel[lc.CRF_LEARN_START + 1] < 2e-2


@pytest.mark.parametrize("luma,keep_rgb", [("rec709", False), ("avg", True)])
def test_luma_modes_match_jax(luma, keep_rgb):
    data = np.load(oc.GOLDEN_DIR + "/oracle_components.npz")
    params = _nest(data, "var/")["params"]
    jmod = JTonemapping(map_type_rgb="gamma", map_type_event="learn",
                        luma_standard=luma, extra_features_event=2)
    crf = TonemappingTransform("gamma", "learn", 2.2, luma,
                               extra_features_event=2)
    crf.load_state_dict(crf_state_dict_from_jax(params), strict=True)
    x, feat = oc.make_crf_inputs()
    want = jmod.apply({"params": params}, x, mode="encode_luma",
                      ev_extra_feat=feat, keep_rgb=keep_rgb)
    with torch.no_grad():
        got = crf.encode_luma(torch.from_numpy(x), keep_rgb=keep_rgb,
                              ev_extra_feat=torch.from_numpy(feat))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_stochastic_render_is_seeded_and_jitters_within_bins():
    """The training render's random streams (stratified jitter, sigma
    noise, importance draws) come from the one generator: the same seed
    gives the same render, another seed another one; jittered depths stay
    inside their stratified bins and cover them uniformly."""
    data = np.load(oc.oracle_path("rbk_awp"))
    model = _model(_nest(data, "var/"))
    model.cfg = dataclasses.replace(model.cfg, perturb=1.0,
                                    raw_noise_std=1.0)
    rays = torch.from_numpy(oc.make_inputs()[0])
    outs = [model.render(rays, is_train=True,
                         generator=torch.Generator().manual_seed(s))
            for s in (7, 7, 8)]
    assert torch.equal(outs[0]["rgb_map"], outs[1]["rgb_map"])
    assert torch.equal(outs[0]["z_vals"], outs[1]["z_vals"])
    assert not torch.equal(outs[0]["z_vals"], outs[2]["z_vals"])

    t = torch.linspace(0, 1, 4)
    mids = 0.5 * (t[1:] + t[:-1])
    lower, upper = torch.cat([t[:1], mids]), torch.cat([mids, t[-1:]])
    z = model._sample_z(20000, "cpu", 1.0, torch.Generator().manual_seed(1))
    assert bool(((z >= lower) & (z <= upper)).all())
    frac = (z - lower) / (upper - lower)
    assert abs(float(frac.mean()) - 0.5) < 0.01
    assert abs(float(frac.var()) - 1 / 12) < 0.005


def test_grad_accum_step_matches_jax():
    """One step at grad_accum 2 (two microbatches of the lockstep batch,
    the AWP BatchNorm statistics carried from the first to the second): the
    logged loss is the mean of the microbatches' and the gradients their
    mean, against the JAX step's (gradient bound 5e-4 * scale); the
    running mean chains as flax's does."""
    from evdeblurnerf_tpu.models.tonemapping import \
        TonemappingTransform as JTonemapping
    from evdeblurnerf_tpu.train.state import create_train_state as jcreate

    data = np.load(lc.golden_path())
    init = _nest(data, "init/")
    args = oc.make_args({**oc.VARIANTS["rbk_awp"], "grad_accum": 2,
                         "lrate": lc.LRATE, "lrate_decay": lc.LRATE_DECAY,
                         "kernel_tv_loss_weight": lc.TV_W,
                         "no_log_grads_norm": True})
    batch = lc.make_batches()[0]
    sw = tstep.ScheduleWeights(cf=0.9, ff=0.1)

    jmodel = oc.build_model("rbk_awp")
    jcrf = JTonemapping()
    tx = joptim.build_optimizer(lc.LRATE, lc.LRATE_DECAY)
    info = {k: batch[k] for k in ("images_idx", "rays_x", "rays_y", "poses")}
    jstate = jcreate(jmodel, jcrf, tx, jax.random.PRNGKey(5), batch["rays"],
                     info)
    jstate = jstate.replace(
        params={"nerf": jax.tree_util.tree_map(jnp.asarray, init["params"]),
                "crf": jstate.params["crf"]},
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           init["batch_stats"]))
    jsw = lc.make_schedule_weights()
    jstep_fn = jstep.build_train_step(jmodel, jcrf, tx, args,
                                      return_grads=True)
    jstate, jaux = jstep_fn(jstate, batch, None, jax.random.PRNGKey(0), jsw,
                            force_naive=False, events_active=False)

    model = _model({"params": init["params"],
                    "batch_stats": init["batch_stats"]}, args)
    state = create_train_state(model, TonemappingTransform(), args,
                               torch.Generator(), crf_identity_prefit=False)
    aux = tstep.build_train_step(args, return_grads=True)(
        state, _tensors(batch), None, sw, False, False)
    np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]),
                               rtol=RTOL)
    want = state_dict_from_jax({"params": jaux["grads_tree"]["nerf"]})
    for name, w in want.items():
        if name.startswith("awpnet.MAM.conv.") or name not in aux["grads"]:
            continue
        scale = max(float(w.abs().max()), 1e-6)
        np.testing.assert_allclose(aux["grads"][name].numpy(), w.numpy(),
                                   atol=5e-4 * scale, rtol=5e-4,
                                   err_msg=name)
    mean = jstate.batch_stats["awpnet"]["MAM"]["Corr"]["convd_bn"]["mean"]
    np.testing.assert_allclose(
        model.awpnet.MAM.Corr.convd[1].running_mean.numpy(),
        np.asarray(mean), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the DSK and PBE training step against the JAX step from one init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,n_steps", [("pbe", 5), ("dsk", 3)])
def test_dsk_pbe_train_steps_match_jax(name, n_steps):
    """Steps of the port's train step and the JAX step from the golden
    weights of the oracle variant, on the lockstep batches with an EDI-prior
    target: the pts0 loss on (three terms for PBE, with the stage-0 render's)
    and, for DSK, the align term at weight 0.1. Per-step loss within 2e-2
    relative, the lockstep bound (measured: 3.2e-7 at most); the
    ladder's terms of the first step and its gradients at the repo's
    bounds."""
    from evdeblurnerf_tpu.train.state import create_train_state as jcreate

    data = np.load(oc.oracle_path(name))
    variables = _nest(data, "var/")
    args = oc.make_args({**oc.VARIANTS[name], "lrate": lc.LRATE,
                         "lrate_decay": lc.LRATE_DECAY,
                         "kernel_tv_loss_weight": lc.TV_W,
                         "kernel_align_weight": 0.1,
                         "no_log_grads_norm": True})
    rng = np.random.default_rng(41)
    batches = [dict(b, rgbsf_pts0=rng.uniform(0, 1, (oc.N, 3)).astype(
        np.float32)) for b in lc.make_batches()]
    sw = tstep.ScheduleWeights(w_pts0=0.5, use_pts0_target=True, w_align=0.1)
    jsw = jstep.ScheduleWeights(
        w_img=jnp.ones(()), loss_a=jnp.ones(()), w_pts0=jnp.asarray(0.5),
        use_pts0_target=jnp.ones((), bool), cf=jnp.ones(()),
        ff=jnp.zeros(()), w_align=jnp.asarray(0.1), w_egm=jnp.zeros(()),
        skip_learn_crf=jnp.zeros((), bool), color_weight=jnp.ones((3,)))

    jmodel = oc.build_model(name)
    jcrf = JTonemapping()
    tx = joptim.build_optimizer(lc.LRATE, lc.LRATE_DECAY)
    info = {k: batches[0][k] for k in ("images_idx", "rays_x", "rays_y",
                                       "poses")}
    jstate = jcreate(jmodel, jcrf, tx, jax.random.PRNGKey(5),
                     batches[0]["rays"], info)
    jstate = jstate.replace(
        params={"nerf": jax.tree_util.tree_map(jnp.asarray,
                                               variables["params"]),
                "crf": jstate.params["crf"]})
    jstep_fn = jstep.build_train_step(jmodel, jcrf, tx, args,
                                      return_grads=True)

    model = _model(variables, args)
    state = create_train_state(model, TonemappingTransform(), args,
                               torch.Generator(), crf_identity_prefit=False)
    step = tstep.build_train_step(args, return_grads=True)
    rel = []
    for i in range(n_steps):
        b = batches[i % lc.N_BATCHES]
        jstate, jaux = jstep_fn(jstate, b, None, jax.random.PRNGKey(i), jsw,
                                force_naive=False, events_active=False)
        aux = step(state, _tensors(b), None, sw, False, False)
        rel.append(abs(float(aux["loss"]) - float(jaux["loss"]))
                   / abs(float(jaux["loss"])))
        if i:
            continue
        terms = ["img_loss", "psnr", "pts0_loss", "pts0_psnr", "tv_loss"]
        terms += ["align_loss"] if name == "dsk" else []
        for k in terms:
            np.testing.assert_allclose(float(aux[k]), float(jaux[k]),
                                       rtol=RTOL, atol=ATOL, err_msg=k)
        assert ("align_loss" in aux) == ("align_loss" in jaux) == \
            (name == "dsk")
        if name == "dsk":
            assert float(aux["align_loss"]) > 0
        want = state_dict_from_jax({"params": jaux["grads_tree"]["nerf"]})
        assert set(want) == set(aux["grads"])
        for pname, w in want.items():
            scale = max(float(w.abs().max()), 1e-6)
            np.testing.assert_allclose(aux["grads"][pname].numpy(),
                                       w.numpy(), atol=5e-4 * scale,
                                       rtol=5e-4, err_msg=pname)
    assert max(rel) < 2e-2, rel
    print(f"{name}: per-step relative loss difference {rel}")
    # both kernels sit in the optimizer's one group beside the fields
    groups = state.optimizer.param_groups
    assert any(p is model.kernelsnet.pattern_pos for p in groups[0]["params"])
    assert int(state.optimizer.state[model.kernelsnet.pattern_pos]["step"]) \
        == n_steps
