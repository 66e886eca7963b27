"""The parallel paths of the PyTorch port (``evdeblurnerf_torch/parallel``)
on the CPU, against the JAX package and against the port's own
one-process step.

Ranks are processes of ``tools/parallel_check_torch.py`` joined over gloo
(they import only the port); the one-process result comes from the same
tool's :func:`run` in this process. The step is the one of
``tests/test_parallel.py::_run_one_step`` (RBK ptnum 3 + AWP with its
BatchNorm, the event loss over both EGM stages through the learned CRF,
32 rays), whose JAX test holds 8 devices to 1. Bounds: against the JAX
single-device step at ``perturb 0`` the repo's 2e-5 on the loss and
``5e-4 * scale`` on each gradient; against the port's one-process step
(``perturb 1``: every draw made at the global shape) ``test_parallel``'s
own, loss rtol 1e-6 and gradients ``1e-2 * scale``; tensor-parallel
sampling against ``VoxelNeRF.sample`` 1e-5 in values and gradients
(``test_parallel.py:239-282``).
"""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_parallel import _make_batches, _setup
from evdeblurnerf_torch import config as tconfig
from evdeblurnerf_torch.models.renderer import RenderConfig
from evdeblurnerf_torch.models.system import (build_occ_grid,
                                              kernel_config_from_args)
from evdeblurnerf_torch.parallel import mesh
from evdeblurnerf_torch.train import step as tstep
from evdeblurnerf_torch.utils.convert import (crf_state_dict_from_jax,
                                              state_dict_from_jax)
from evdeblurnerf_torch.utils.misc import annealing_interpolator

TOOL = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools", "parallel_check_torch.py")
_spec = importlib.util.spec_from_file_location("parallel_check_torch", TOOL)
pc = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(pc)

K = ((60.0, 0.0, 40.0), (0.0, 60.0, 32.0), (0.0, 0.0, 1.0))
CPU = torch.device("cpu")


def _port_args(jargs, **over):
    """The port's flags equal to the JAX flags ``jargs`` of ``_setup``."""
    values = {f.name: getattr(jargs, f.name) for f in tconfig.FLAG_SPEC
              if f.name != "device" and hasattr(jargs, f.name)}
    values.update(over)
    return tconfig.default_args(**values)


def _setup_dict(cull=False, coarse=False, perturb=1.0, **over):
    """The setup of ``parallel_check_torch.run`` for ``_setup``'s step:
    its flags and model configuration, the batch of ``_make_batches`` and
    the schedule of ``_run_one_step``."""
    jargs, jmodel, _ = _setup(cull=cull, coarse=coarse)
    args = _port_args(jargs, perturb=perturb, tone_mapping_type="none",
                      **over)
    cfg = RenderConfig(**{
        f.name: getattr(jmodel.cfg, f.name)
        for f in dataclasses.fields(RenderConfig)})
    cfg = dataclasses.replace(cfg, perturb=perturb)
    batch, ev_batch = _make_batches()
    sw = tstep.compute_schedule_weights(
        args, 0, kernel_end_warmup_iter=-1, w_kernel=lambda s: 1.0,
        w_pts0_target=lambda s: 0.0,
        w_events_egm=annealing_interpolator(1.0, 1.0, None, "constant"),
        fine_loss_weight=0.1, events_active=True)
    setup = dict(cfg=cfg, kcfg=kernel_config_from_args(args), num_images=4,
                 K=K, args=args, seed=0, batch=batch, ev_batch=ev_batch,
                 sw=sw, force_naive=False, events_active=True,
                 fine_cull=cull, coarse_cull=coarse)
    if coarse:
        setup["occ_grid"] = build_occ_grid(
            pc.build_state(setup, CPU).model).numpy()
    return setup


def _spawn(tmp_path, setup, world, tp=1):
    path = str(tmp_path / "setup.pt")
    torch.save(setup, path)
    return pc.spawn(path, str(tmp_path / "out.pt"), world, tp=tp,
                    timeout=300)


def _assert_step_close(got, want, loss_rtol, grad_atol, grad_rtol):
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=loss_rtol,
                               atol=1e-7)
    assert set(got["grads"]) == set(want["grads"])
    for name, w in want["grads"].items():
        w = w.numpy()
        scale = max(float(np.abs(w).max()), 1e-5)
        np.testing.assert_allclose(got["grads"][name].numpy(), w,
                                   rtol=grad_rtol, atol=grad_atol * scale,
                                   err_msg=f"gradient of {name}")


# ---------------------------------------------------------------------------
# data parallelism
# ---------------------------------------------------------------------------

def _color_events(setup):
    """The event loss over a colour event camera with per-channel weights:
    each ray's one-hot channel, so the shards' sums of weights differ and
    the weighted mean needs the global denominator."""
    rng = np.random.default_rng(5)
    n = setup["ev_batch"]["events_rays_start"].shape[0]
    setup["ev_batch"]["events_color_map"] = np.eye(3, dtype=np.float32)[
        rng.integers(0, 3, n)]
    setup["sw"] = dataclasses.replace(setup["sw"],
                                      color_weight=(0.2, 1.0, 3.0))
    return setup


@pytest.mark.parametrize("cull,coarse,color", [
    (False, False, False), (True, False, False), (True, True, False),
    (False, False, True)],
    ids=["exact", "fine_cull", "both_culls", "color_weights"])
def test_dp_step_matches_one_process(tmp_path, cull, coarse, color):
    """Two ranks of 16 rays against the one-process step on the 32 rays,
    with ``perturb 1`` and the sigma noise of the event render drawn at
    the global shape; the culls as in ``test_parallel``'s culled cases
    (16 + 16 samples, keep 8); the colour-weighted event loss. The logged
    terms are the global batch's."""
    setup = _setup_dict(cull=cull, coarse=coarse,
                        **(dict(event_egm_use_colorevents=True)
                           if color else {}))
    if color:
        setup = _color_events(setup)
    want, _ = pc.run(setup, CPU, mesh.Layout())
    got, records = _spawn(tmp_path, setup, 2)
    assert np.isfinite(want["loss"])
    _assert_step_close(got, want, 1e-6, 1e-2, 5e-3)
    for k in ("psnr", "img_loss", "event_egm", "pts0_loss", "grads/total"):
        np.testing.assert_allclose(got["aux"][k], want["aux"][k], rtol=1e-5,
                                   err_msg=k)
    assert [r["rank"] for r in records] == [0, 1]
    assert all(r["jax_modules"] == [] for r in records)


def test_dp_step_matches_jax_single_device(tmp_path):
    """The 2-rank step from the JAX package's initial weights (converted by
    ``utils/convert.py``) at ``perturb 0`` against the JAX single-device
    step of ``_run_one_step``'s model: loss within 2e-5 relative, every
    gradient within ``5e-4 * scale``, the AWP BatchNorm's global batch
    statistics included."""
    from evdeblurnerf_tpu.train import step as jstep
    from evdeblurnerf_tpu.train.optim import build_optimizer
    from evdeblurnerf_tpu.train.state import create_train_state

    jargs, jmodel, jcrf = _setup()
    jargs.perturb = 0.0
    jmodel = jmodel.clone(cfg=dataclasses.replace(jmodel.cfg, perturb=0.0))
    batch, ev_batch = _make_batches()
    tx = build_optimizer(jargs.lrate, jargs.lrate_decay)
    info = {k: batch[k] for k in ("images_idx", "rays_x", "rays_y", "poses")}
    jstate = create_train_state(jmodel, jcrf, tx, jax.random.PRNGKey(0),
                                batch["rays"], info)
    jsw = jstep.compute_schedule_weights(
        jargs, 0, kernel_end_warmup_iter=-1, w_kernel=lambda s: 1.0,
        w_pts0_target=lambda s: 0.0,
        w_events_egm=annealing_interpolator(1.0, 1.0, None, "constant"),
        fine_loss_weight=0.1, events_active=True)
    variables = jax.tree_util.tree_map(np.asarray, {
        "params": jstate.params["nerf"],
        "batch_stats": jstate.batch_stats})
    crf_params = jax.tree_util.tree_map(np.asarray, jstate.params["crf"])
    step_fn = jstep.build_train_step(jmodel, jcrf, tx, jargs,
                                     return_grads=True)
    _, jaux = step_fn(jstate, batch, ev_batch, jax.random.PRNGKey(0), jsw,
                      force_naive=False, events_active=True)

    setup = _setup_dict(perturb=0.0)
    setup["model_sd"] = state_dict_from_jax(variables)
    setup["crf_sd"] = crf_state_dict_from_jax(crf_params)
    got, _ = _spawn(tmp_path, setup, 2)
    jgrads = jax.tree_util.tree_map(np.asarray, jaux["grads_tree"])
    want = {"loss": float(jaux["loss"]), "grads": {
        **state_dict_from_jax({"params": jgrads["nerf"]}),
        **{f"crf.{n}": v for n, v in
           crf_state_dict_from_jax(jgrads["crf"]).items()}}}
    # the reference's unused MAM module has no gradient in the port
    want["grads"] = {n: v for n, v in want["grads"].items()
                     if n in got["grads"]}
    assert len(want["grads"]) > 30
    _assert_step_close(got, want, 2e-5, 5e-4, 5e-4)


def test_batch_sharding_and_draws_follow_the_global_batch():
    """``shard_batch`` gives each rank, of every grad-accum microbatch, its
    block of rows, and ``draw`` inside ``ray_shard`` keeps the rank's rows
    of the global draw, the event render's two segments each in turn."""
    n_data = 2
    batch = {"rays": np.arange(16 * 3).reshape(16, 3)}
    layouts = [mesh.Layout(n_data=n_data, rank=r) for r in range(n_data)]
    rows = [mesh.shard_batch(batch, lt, accum=2)["rays"][:, 0] // 3
            for lt in layouts]
    np.testing.assert_array_equal(rows[0], [0, 1, 2, 3, 8, 9, 10, 11])
    np.testing.assert_array_equal(rows[1], [4, 5, 6, 7, 12, 13, 14, 15])
    full = torch.rand((8, 5), generator=torch.Generator().manual_seed(3))
    for lt in layouts:
        with mesh.ray_shard(lt, segments=2):
            got = mesh.draw(torch.rand, (4, 5),
                            torch.Generator().manual_seed(3), CPU)
        r = lt.data_rank
        np.testing.assert_array_equal(
            got.numpy(), torch.cat([full[2 * r:2 * r + 2],
                                    full[4 + 2 * r:4 + 2 * r + 2]]).numpy())


# ---------------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------------

def test_tp_sample_matches_jax_voxelnerf(tmp_path):
    """``VoxelNeRF.sample`` with its (16, 4, 4) tables sliced over 2 ranks
    (K4/K5's plain twins on each rank's (8, 2, 2) slice, its columns of the
    basis, one ``all_reduce``) against the JAX ``VoxelNeRF.sample`` at the
    same weights: values and the gradients of the tables, the basis and
    the points within 1e-5."""
    from evdeblurnerf_tpu.models.voxnerf import VoxelNeRF as JVoxelNeRF

    aabb = ((-1.5,) * 3, (1.5,) * 3)
    jm = JVoxelNeRF(aabb=aabb, n_voxels=4096, app_n_comp=(16, 4, 4),
                    app_dim=8)
    pts = np.asarray(np.random.default_rng(0).uniform(-1, 1, (64, 8, 3)),
                     np.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(pts),
                     method=JVoxelNeRF.sample)["params"]

    def loss(p, x):
        return jnp.sum(jm.apply({"params": p}, x,
                                method=JVoxelNeRF.sample) ** 2)

    want = np.asarray(jm.apply({"params": params}, jnp.asarray(pts),
                               method=JVoxelNeRF.sample))
    jg_p, jg_x = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(pts))
    strip = len("mlp_coarse.")
    sd = state_dict_from_jax({"params": {"mlp_coarse": params}})
    spec = {"field": dict(aabb=aabb, n_voxels=4096, app_n_comp=(16, 4, 4),
                          app_dim=8),
            "sd": {k[strip:]: v for k, v in sd.items()}, "pts": pts}
    got, _ = _spawn(tmp_path, {"sample": spec}, 2, tp=2)
    np.testing.assert_allclose(got["feats"].numpy(), want, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got["pts_grad"].numpy(), np.asarray(jg_x),
                               rtol=1e-5, atol=1e-5)
    jg = state_dict_from_jax({"params": {"mlp_coarse": jg_p}})
    assert len(jg) == 7
    for k, w in jg.items():
        w = w.numpy()
        scale = max(float(np.abs(w).max()), 1e-6)
        np.testing.assert_allclose(got["grads"][k[strip:]].numpy(), w,
                                   rtol=1e-5, atol=1e-5 * scale, err_msg=k)


@pytest.mark.parametrize("world,tp", [(2, 2), pytest.param(
    4, 2, marks=pytest.mark.slow)], ids=["tp1x2", "tp2x2"])
def test_tp_step_matches_one_process(tmp_path, world, tp):
    """The step with the (4, 2, 2) tables sliced over ``tp`` ranks of each
    of ``world / tp`` ray shards against the one-process step, at
    ``test_parallel``'s bounds: the TV a mean over the slices, the basis
    gradient summed over them, the table norms of the clip and the logged
    ``grads/*`` over the whole tables. Then the gathered checkpoint of the
    sliced state loads in one process and renders what the sliced model
    rendered. The logged norms and TV within 1e-3 relative (1e-8
    absolute)."""
    from evdeblurnerf_torch.train.checkpoint import load_into_state

    setup = _setup_dict(no_log_grads_norm=False, clip_grads_norm=0.05)
    setup["checkpoint"] = str(tmp_path / "tp.tar")
    setup["render_rays"] = 8
    want, _ = pc.run(setup, CPU, mesh.Layout())
    got, _ = _spawn(tmp_path, setup, world, tp=tp)
    _assert_step_close(got, want, 1e-6, 1e-2, 5e-3)
    # a table's norm taken over its slice alone is off by ~30%; the AWP's
    # gradients of ~1e-6 differ at 1e-5 in another order of the ray shards'
    # sums (tp2x2), and a gradient that is zero but for rounding (MAM's
    # linear bias, ~1e-11) is held by the floor, 1e-3 of test_parallel's
    # 1e-5
    norms = [k for k in want["aux"] if k.startswith("grads/")]
    assert "grads/mlp_fine.app_plane.0" in norms
    for k in norms + ["grad_norm", "tv_loss"]:
        np.testing.assert_allclose(got["aux"][k], want["aux"][k], rtol=1e-3,
                                   atol=1e-8, err_msg=k)

    one = pc.build_state(setup, CPU)
    ckpt = torch.load(setup["checkpoint"], weights_only=True)
    load_into_state(ckpt, one)
    assert one.step == 1
    one.model.eval()
    rays = torch.as_tensor(setup["batch"]["rays"][:8])
    with torch.inference_mode():
        rgb, depth, _ = one.model.render_chunk(rays)
    np.testing.assert_allclose(rgb.numpy(), got["render_rgb"].numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(depth.numpy(), got["render_depth"].numpy(),
                               rtol=1e-5, atol=1e-6)
    # the Adam moments went into the reference layout, whole
    plane = one.model.mlp_fine.app_plane[0]
    moments = one.optimizer.state[plane]
    assert moments["exp_avg"].shape == plane.shape
    assert float(moments["exp_avg_sq"].min()) >= 0


def test_tp_field_not_divisible_stays_replicated(capsys):
    """A field whose component counts do not divide by k warns and keeps
    its whole tables, as in the JAX package."""
    from evdeblurnerf_torch.models.voxnerf import VoxelNeRF
    from evdeblurnerf_torch.parallel import tp

    field = VoxelNeRF(((-1.5,) * 3, (1.5,) * 3), n_voxels=4096,
                      app_n_comp=(6, 3, 3), app_dim=8)
    shape = tuple(field.app_plane[0].shape)
    assert tp.shard_fields([field], mesh.Layout(n_model=2)) == 0
    assert "samples replicated" in capsys.readouterr().out
    assert field.tp is None and tuple(field.app_plane[0].shape) == shape


@pytest.mark.parametrize("world,tp", [(2, 1), (2, 2)], ids=["dp2", "tp2"])
def test_parallel_render_matches_one_process(tmp_path, world, tp):
    """Two poses rendered through ``train/evaluate.py::render_poses`` by two
    ranks, each its chunk of every 2 x 64 rays gathered (``dp2``), or both
    all rays over sliced tables (``tp2``), against one process: rgb and
    depth within 1e-5."""
    jargs, jmodel, _ = _setup()
    cfg = RenderConfig(**{f.name: getattr(jmodel.cfg, f.name)
                          for f in dataclasses.fields(RenderConfig)})
    poses = np.stack([np.concatenate([np.eye(3), [[0.0], [0.0], [s]]], 1)
                      for s in (0.0, 0.1)]).astype(np.float32)
    setup = dict(cfg=cfg, seed=3, render=dict(poses=poses, H=12, W=10, K=K,
                                              chunk=64))
    want, _ = pc.run(setup, CPU, mesh.Layout())
    got, records = _spawn(tmp_path, setup, world, tp=tp)
    assert tuple(got["rgb"].shape) == (2, 12, 10, 3)
    for k in ("rgb", "depth"):
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
