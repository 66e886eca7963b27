"""The port's eval render, piece by piece and as a whole, vs the JAX package
and the recorded outputs of the original PyTorch code.

Inputs are made with numpy from a seed and handed to both sides; the whole
slice runs the deterministic oracle variants of tests/oracle_common.py
(16 rays, 4+4 samples, perturb 0, no noise) on the golden weights. Bound:
the repo's own 2e-5 rtol/atol (tests/test_reference_parity.py), unless a
test states a tighter one.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle_common as oc
from evdeblurnerf_torch import config as tconfig, serving
from evdeblurnerf_torch.models import embedding as temb
from evdeblurnerf_torch.models.renderer import RenderConfig, config_from_args
from evdeblurnerf_torch.models.system import EvDeblurNeRF
from evdeblurnerf_torch.models.tonemapping import CRF
from evdeblurnerf_torch.ops import compositing as tcomp
from evdeblurnerf_torch.ops import sample_pdf as tpdf
from evdeblurnerf_torch.train import evaluate as teval
from evdeblurnerf_torch.utils import rays as trays
from evdeblurnerf_torch.utils.convert import state_dict_from_jax
from evdeblurnerf_tpu.models import embedding as jemb
from evdeblurnerf_tpu.ops import compositing as jcomp
from evdeblurnerf_tpu.ops import sample_pdf as jpdf
from evdeblurnerf_tpu.train import evaluate as jeval
from evdeblurnerf_tpu.utils import checkpoint_convert, rays as jrays

ATOL = RTOL = 2e-5
EVAL_KEYS = ("rgb_map", "depth_map", "acc_map", "rgb0")


@pytest.mark.parametrize("n", [1, 4, 5, 8, 63, 64, 128])
def test_unit_linspace_matches_jnp(n):
    np.testing.assert_array_equal(tpdf.unit_linspace(n).numpy(),
                                  np.asarray(jnp.linspace(0.0, 1.0, n)))


@pytest.mark.parametrize("multires", [2, 4, 10])
def test_positional_encoding_matches_jax(multires):
    x = np.random.default_rng(0).uniform(-1.5, 1.5, (257, 3)).astype(
        np.float32)
    want = np.asarray(jemb.positional_encoding(jnp.asarray(x), multires))
    got = temb.positional_encoding(torch.from_numpy(x), multires).numpy()
    assert got.shape == want.shape
    # sin/cos of the two libraries differ by an ulp or two of the argument
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def test_weights_and_composite_match_jax():
    rng = np.random.default_rng(1)
    R, S = 64, 16
    sigma = rng.normal(size=(R, S)).astype(np.float32) * 3
    z = np.sort(rng.uniform(0, 1, (R, S)), -1).astype(np.float32)
    rays_d = rng.normal(size=(R, 3)).astype(np.float32)
    rgb = rng.uniform(0, 1, (R, S, 3)).astype(np.float32)
    mask = np.array(jcomp.rmnearplane_mask(jnp.asarray(z), 30))
    np.testing.assert_array_equal(
        tcomp.rmnearplane_mask(torch.from_numpy(z), 30).numpy(), mask)
    w_j = jcomp.compute_weights(jnp.asarray(sigma), jnp.asarray(z),
                                jnp.asarray(rays_d), jax.nn.relu,
                                rmnearplane_mask=jnp.asarray(mask))
    w_t = tcomp.compute_weights(torch.from_numpy(sigma), torch.from_numpy(z),
                                torch.from_numpy(rays_d), torch.relu,
                                rmnearplane_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=RTOL,
                               atol=ATOL)
    for got, want in zip(
            tcomp.composite(w_t, torch.from_numpy(rgb), torch.from_numpy(z),
                            white_bkgd=True),
            jcomp.composite(w_j, jnp.asarray(rgb), jnp.asarray(z),
                            white_bkgd=True)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)


def test_sample_pdf_det_matches_jax_and_reference():
    data = np.load(oc.GOLDEN_DIR + "/oracle_components.npz")
    bins, weights = oc.make_pdf_inputs()
    got = tpdf.sample_pdf(torch.from_numpy(bins), torch.from_numpy(weights),
                          5, det=True).numpy()
    np.testing.assert_allclose(got, data["pdf/det"], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, oc.run_jax_pdf()["det"], rtol=RTOL,
                               atol=ATOL)

    # the eval-render shape: 63 bins (62 masses), 64 draws
    rng = np.random.default_rng(2)
    bins = np.sort(rng.uniform(0, 1, (128, 63)), -1).astype(np.float32)
    weights = rng.uniform(0, 1, (128, 62)).astype(np.float32)
    weights[3] = 0.0
    want = np.asarray(jpdf.sample_pdf(jax.random.PRNGKey(0),
                                      jnp.asarray(bins),
                                      jnp.asarray(weights), 64, det=True))
    got = tpdf.sample_pdf(torch.from_numpy(bins), torch.from_numpy(weights),
                          64, det=True).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_sample_pdf_draws_from_generator():
    bins = torch.linspace(0, 1, 9).expand(4, 9).contiguous()
    weights = torch.ones(4, 8)
    draw = [tpdf.sample_pdf(bins, weights, 16,
                            generator=torch.Generator().manual_seed(3))
            for _ in range(2)]
    torch.testing.assert_close(draw[0], draw[1], rtol=0, atol=0)
    # a uniform pdf maps u to itself
    u = torch.rand(4, 16, generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(draw[0], u, rtol=1e-5, atol=1e-5)


def test_searchsorted_right_matches_broadcast_compare():
    rng = np.random.default_rng(4)
    cdf = np.concatenate([np.zeros((32, 1)), np.cumsum(
        rng.uniform(0, 1, (32, 12)), -1)], -1).astype(np.float32)
    cdf /= cdf[:, -1:]
    u = rng.uniform(0, 1, (32, 20)).astype(np.float32)
    u[:, 0], u[:, 1], u[:, 2] = 0.0, 1.0, cdf[:, 5]   # both ends, an edge
    want = np.asarray(jpdf.searchsorted_right(jnp.asarray(cdf),
                                              jnp.asarray(u)))
    got = tpdf.searchsorted_right(torch.from_numpy(cdf), torch.from_numpy(u))
    np.testing.assert_array_equal(got.numpy(), want)


def test_rays_match_jax():
    rng = np.random.default_rng(5)
    c2w = np.concatenate([np.linalg.qr(rng.normal(size=(3, 3)))[0],
                          rng.normal(size=(3, 1))], 1).astype(np.float32)
    K = np.array([[40.0, 0, 12.5], [0, 40.0, 9.5], [0, 0, 1]])
    o_np, d_np = jrays.get_rays_np(19, 25, K, c2w)
    o_t, d_t = trays.get_rays(19, 25, K, torch.from_numpy(c2w).double(),
                              dtype=torch.float64)
    np.testing.assert_array_equal(o_t.float().numpy(), o_np)
    np.testing.assert_allclose(d_t.float().numpy(), d_np, rtol=0, atol=1e-7)

    rays_o, rays_d = oc.make_inputs()[0][..., 0], oc.make_inputs()[0][..., 1]
    want = jrays.get_ndc_rays(64, 80, 60.0, 1.0, jnp.asarray(rays_o),
                              jnp.asarray(rays_d))
    got = trays.get_ndc_rays(64, 80, 60.0, 1.0, torch.from_numpy(rays_o),
                             torch.from_numpy(rays_d))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


# ---------------------------------------------------------------------------
# the whole slice on the oracle variants
# ---------------------------------------------------------------------------

def _golden(name):
    """(variables, recorded eval outputs) of one oracle variant; the
    variables are nested straight from the recorded keystr paths, which
    spares a full JAX init of the training model."""
    data = np.load(oc.oracle_path(name))
    variables = {}
    for k in data.files:
        if k.startswith("var/"):
            *path, leaf = re.findall(r"\['([^']+)'\]", k[len("var/"):])
            node = variables
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = data[k]
    ref = {k[len("out/eval/"):]: data[k] for k in data.files
           if k.startswith("out/eval/")}
    return variables, ref


def _port_model(name, variables):
    jcfg = oc.make_cfg(oc.make_args(oc.VARIANTS[name]))
    cfg = RenderConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(RenderConfig)})
    model = EvDeblurNeRF(cfg)
    # the eval renderer: its fields, as serving loads them
    model.load_state_dict({k: v for k, v in state_dict_from_jax(
        variables).items() if k.startswith("mlp_")}, strict=True)
    return model


@pytest.mark.parametrize("name", ["rbk_awp", "dsk", "pbe"])
def test_eval_render_matches_jax_and_reference(name):
    variables, ref = _golden(name)
    model = _port_model(name, variables)
    rays = oc.make_inputs()[0]
    with torch.inference_mode():
        ret = model.render(torch.from_numpy(rays))
    for k in EVAL_KEYS:
        np.testing.assert_allclose(
            ret[k].numpy(), ref[k], rtol=RTOL, atol=ATOL,
            err_msg=f"{name}: {k} diverged from the PyTorch reference")

    jmodel = oc.build_model(name)
    jout = jmodel.apply(variables, jnp.asarray(rays),
                        method=jmodel.render_chunk)
    with torch.inference_mode():
        tout = model.render_chunk(torch.from_numpy(rays))
    for got, want in zip(tout, jout):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("render_factor", [0, 2])
def test_render_poses_matches_jax(render_factor):
    variables, _ = _golden("rbk_awp")
    model = _port_model("rbk_awp", variables)
    jmodel = oc.build_model("rbk_awp")
    rng = np.random.default_rng(6)
    poses = np.stack([np.concatenate(
        [np.linalg.qr(np.eye(3) + 0.1 * rng.normal(size=(3, 3)))[0],
         0.05 * rng.normal(size=(3, 1))], 1) for _ in range(2)]).astype(
        np.float32)
    # 120 rays (30 at factor 2): chunks of 50 (7) leave a padded last chunk
    H, W = 6, 10
    chunk = 7 if render_factor else 50
    K = np.array([[8.0, 0, W / 2], [0, 8.0, H / 2], [0, 0, 1]])
    want = jeval.render_poses(variables, jeval.build_chunk_renderer(jmodel),
                              poses, H, W, K, chunk=chunk,
                              render_factor=render_factor)
    got = teval.render_poses(model.render_chunk, poses, H, W, K, chunk=chunk,
                             render_factor=render_factor)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# serving entry point and flags
# ---------------------------------------------------------------------------

def _serve_args(name, **extra):
    jcfg = oc.make_cfg(oc.make_args(oc.VARIANTS[name]))
    flags = dict(
        mode="c2f", N_samples=jcfg.N_samples, N_importance=jcfg.N_importance,
        use_viewdirs=True, multires=jcfg.multires,
        multires_views=jcfg.multires_views, kernel_type=jcfg.kernel_type,
        coarse_n_voxels=jcfg.coarse_n_voxels,
        fine_n_voxels=jcfg.fine_n_voxels,
        coarse_app_n_comp=list(jcfg.coarse_app_n_comp),
        fine_app_n_comp=list(jcfg.fine_app_n_comp),
        coarse_hidden_dim=8, coarse_hidden_dim_color=8, fine_hidden_dim=8,
        fine_hidden_dim_color=8, fine_geo_feat_dim=8, coarse_app_dim=8,
        fine_app_dim=8, chunk=16, tone_mapping_type="gamma")
    flags.update(extra)
    return tconfig.default_args(**flags)


def test_build_renderer_from_reference_state_dict():
    variables, _ = _golden("rbk_awp")
    # a whole reference network_state_dict: fields + blur kernel + AWP
    sd = {k: torch.from_numpy(np.array(v)) for k, v in
          checkpoint_convert.export_network_state_dict(variables).items()}
    assert any(k.startswith("kernelsnet.") for k in sd)
    r = serving.build_renderer(_serve_args("rbk_awp"), sd, oc.H, oc.W, oc.K,
                               0.0, 1.0, oc.AABB, device="cpu")
    assert r.unused_keys and all(k.startswith(("kernelsnet.", "awpnet."))
                                 for k in r.unused_keys)
    assert len(r.unused_keys) == sum(
        not k.startswith(("mlp_coarse.", "mlp_fine.")) for k in sd)
    rays = torch.from_numpy(oc.make_inputs()[0])
    rgb, depth, acc = r(rays)
    ref_rgb, ref_depth, ref_acc = _port_model(
        "rbk_awp", variables).render_chunk(rays)
    torch.testing.assert_close(rgb, ref_rgb ** (1 / 2.2), rtol=0, atol=0)
    torch.testing.assert_close(depth, ref_depth, rtol=0, atol=0)
    torch.testing.assert_close(acc, ref_acc, rtol=0, atol=0)
    with pytest.raises(ValueError, match="chunks of shape"):
        r(rays[:8])

    with pytest.raises(KeyError, match="unexpected"):
        serving.build_renderer(_serve_args("rbk_awp"), {**sd, "extra.w": rays},
                               oc.H, oc.W, oc.K, 0.0, 1.0, oc.AABB, "cpu")
    missing = {k: v for k, v in sd.items() if k != "mlp_fine.basis_mat.weight"}
    with pytest.raises(RuntimeError, match="Missing key"):
        serving.build_renderer(_serve_args("rbk_awp"), missing, oc.H, oc.W,
                               oc.K, 0.0, 1.0, oc.AABB, "cpu")


def test_load_network_state_dict_reads_reference_tar(tmp_path):
    sd = {"mlp_coarse.basis_mat.weight": torch.ones(2, 3)}
    torch.save({"global_step": 7, "network_state_dict": sd,
                "optimizer_state_dict": {}, "wandb_id": "x"},
               tmp_path / "007.tar")
    got = serving.load_network_state_dict(str(tmp_path / "007.tar"))
    assert set(got) == set(sd)
    torch.testing.assert_close(got["mlp_coarse.basis_mat.weight"],
                               sd["mlp_coarse.basis_mat.weight"])


@pytest.mark.parametrize("flag,value,match", [
    ("triplane_bf16", True, "triplane_bf16"),
])
def test_unported_settings_raise(flag, value, match):
    """A setting the port once refused here now builds: ``--triplane_bf16``
    reaches the render config (``match``, the field it sets) and the model
    packs bf16 tables."""
    args = _serve_args("rbk_awp", **{flag: value})
    cfg = config_from_args(args, oc.AABB, oc.H, oc.W, oc.FOCAL, 0.0, 1.0)
    assert getattr(cfg, match) is value
    model = EvDeblurNeRF(cfg)
    assert model.mlp_coarse.packed_plane_0.dtype == torch.bfloat16


def test_learned_crf_raises():
    """The learned head builds now (its parity is in test_torch_train.py);
    an unknown response function still raises."""
    assert isinstance(CRF("learn").linear, torch.nn.Sequential)
    with pytest.raises(ValueError, match="map_type"):
        CRF("curve")
    x = torch.rand(5, 3)
    torch.testing.assert_close(CRF("gamma", 2.2)(x), x ** (1 / 2.2))
    torch.testing.assert_close(CRF("none")(x), x)


def test_port_flag_defaults(tmp_path):
    args = tconfig.parse_args([])
    assert (args.triplane_bf16, args.triplane_line_matmul,
            args.fine_cull_capacity) == (False, False, 0.0)
    assert tconfig.default_args().triplane_bf16 is False
    args = tconfig.parse_args(["--fine_cull_capacity", "0.25"])
    assert args.fine_cull_capacity == 0.25 and not args.triplane_bf16
    cfg = tmp_path / "exp.txt"
    cfg.write_text("expname = x\ntriplane_bf16 = True\n")
    args = tconfig.parse_args(["--config", str(cfg)])
    assert args.triplane_bf16 is True and args.fine_cull_capacity == 0.0
