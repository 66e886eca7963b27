"""The port's DSK and PBE blur kernels, the table-plus-MLP view embedding
and the PBE stage-0 coarse render, against the JAX package and the recorded
outputs of the original PyTorch code.

Inputs are made with numpy from a seed and handed to both sides. The
whole-model checks run the deterministic oracle variants ``dsk`` (with
``spatial_embed 2``) and ``pbe`` of tests/oracle_common.py (16 rays x 3
points, 4+4 samples, perturb 0, no pattern jitter, no sigma noise) on the
golden weights. The ``forward_*.npz`` recordings were taken with the
stratified jitter, the stochastic importance draws and the pattern jitter
on; there the port is fed the JAX package's own draws, made from the
recording's key, in the order the port asks for them. Bounds: the repo's 2e-5
rtol/atol for forwards and ``atol 5e-4 * scale, rtol 5e-4`` for gradients
(tests/test_reference_parity.py).
"""

import dataclasses
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle_common as oc
import test_golden_forward as gf
from evdeblurnerf_torch.models.blur_dsk import DSKBlurModel, dsk_linear
from evdeblurnerf_torch.models.embedding import (ViewEmbedding,
                                                 ViewEmbeddingMLP)
from evdeblurnerf_torch.models.renderer import RenderConfig
from evdeblurnerf_torch.models.system import (EvDeblurNeRF,
                                              kernel_config_from_args)
from evdeblurnerf_torch.utils.convert import state_dict_from_jax
from evdeblurnerf_tpu.models.blur_dsk import DSKBlurModel as JDSKBlurModel
from evdeblurnerf_tpu.models.embedding import \
    ViewEmbeddingMLP as JViewEmbeddingMLP

ATOL = RTOL = 2e-5
N, P, IMGS = 24, 4, 5
K = np.array([[60.0, 0.0, 40.0], [0.0, 55.0, 32.0], [0.0, 0.0, 1.0]],
             np.float32)


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


def _port_model(jcfg, args, variables, K=oc.K):
    cfg = RenderConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(RenderConfig)})
    model = EvDeblurNeRF(cfg, kernel_config_from_args(args), oc.NUM_IMAGES,
                         K=K)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model.train()


def _oracle_model(name, variables):
    args = oc.make_args(oc.VARIANTS[name])
    return _port_model(oc.make_cfg(args), args, variables)


def _info(info):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in info.items()}


def _record(out):
    rgb, rgb1, loss, tensors = out
    rec = {"rgb": rgb, "rgb1": rgb1}
    rec.update({f"loss/{k}": v for k, v in loss.items()})
    rec.update({f"tensor/{k}": v for k, v in tensors.items()})
    return {k: v.detach().numpy() for k, v in rec.items()}


# ---------------------------------------------------------------------------
# the kernel module and the view embedding against the live JAX modules
# ---------------------------------------------------------------------------

def _kernel_inputs():
    rng = np.random.default_rng(12)
    poses = np.stack([np.concatenate(
        [np.linalg.qr(np.eye(3) + 0.2 * rng.normal(size=(3, 3)))[0],
         0.3 * rng.normal(size=(3, 1))], 1) for _ in range(N)])
    return dict(
        rays_x=rng.uniform(0, 80, N).astype(np.float32),
        rays_y=rng.uniform(0, 64, N).astype(np.float32),
        img_idx=rng.integers(0, IMGS, N).astype(np.int32),
        poses=poses.astype(np.float32),
        img_embed=rng.normal(size=(N, 8)).astype(np.float32),
        feats=rng.normal(size=(N, P, 15)).astype(np.float32))


MODULE_VARIANTS = {
    "dsk_spatial2": dict(kernel_type="DSK", spatial_embed=2),
    "pbe_feats": dict(kernel_type="PBE"),
    "dsk_global_trans": dict(kernel_type="DSK", isglobal=True,
                             optim_trans=True, in_embed=0),
    "pbe_sv_trans_shortcut": dict(kernel_type="PBE", optim_sv_trans=True,
                                  short_cut=True, spatial_embed=1),
}


@pytest.mark.parametrize("variant", list(MODULE_VARIANTS))
def test_dsk_module_matches_jax(variant):
    """``DSKBlurModel`` with jitter 0 on one set of weights: the expanded
    rays, the weights and the align term within 2e-5 of the JAX module's,
    with per-ray poses that rotate and translate."""
    kw = dict(num_img=IMGS, num_pt=P, kernel_hwindow=10, img_embed_cnl=8,
              random_hwindow=0.0, num_hidden=2, num_wide=16,
              **MODULE_VARIANTS[variant])
    x = _kernel_inputs()
    is_pbe = kw["kernel_type"] == "PBE"
    jmod = JDSKBlurModel(**kw)
    jargs = (jax.random.PRNGKey(0), jnp.asarray(K), x["rays_x"], x["rays_y"],
             x["img_idx"], x["poses"], x["img_embed"])
    jkw = dict(feats=jnp.asarray(x["feats"])) if is_pbe else {}
    params = jmod.init(jax.random.PRNGKey(3), *jargs, **jkw)["params"]
    rng = np.random.default_rng(13)
    # offsets, translations and weights large enough to matter
    params = jax.tree_util.tree_map(np.asarray, params)
    params["linears1_1"]["kernel"] = params["linears1_1"]["kernel"] * 30
    params["pattern_pos"] = rng.normal(size=params["pattern_pos"].shape) \
        .astype(np.float32)
    if "pattern_trans" in params:
        params["pattern_trans"] = rng.normal(
            size=params["pattern_trans"].shape).astype(np.float32) * 20
    want_rays, want_w, want_align = jmod.apply({"params": params}, *jargs,
                                               **jkw)

    sd = state_dict_from_jax({"params": {"kernelnet": params}})
    tmod = DSKBlurModel(ViewEmbedding(IMGS, 8), **kw)
    tmod.load_state_dict({**{k[len("kernelsnet."):]: v
                             for k, v in sd.items()},
                          "img_embed.img_embed": torch.zeros(IMGS, 8)},
                         strict=True)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    got_rays, got_w, got_align = tmod(
        torch.from_numpy(K), t["rays_x"], t["rays_y"], t["img_idx"],
        t["poses"], t["img_embed"], feats=t["feats"] if is_pbe else None)
    assert got_rays.shape == (N, P, 3, 2)
    np.testing.assert_allclose(got_rays.detach().numpy(),
                               np.asarray(want_rays), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_w.detach().numpy(), np.asarray(want_w),
                               rtol=RTOL, atol=ATOL)
    if is_pbe:
        assert got_align is None and want_align is None
        # point 0 is the undeformed ray through the pixel
        centre = torch.stack([(t["rays_x"] - K[0, 2]) / K[0, 0],
                              -(t["rays_y"] - K[1, 2]) / K[1, 1],
                              -torch.ones(N)], -1)
        want_d = torch.sum(centre[:, None, :] * t["poses"][:, :3, :3], -1)
        torch.testing.assert_close(got_rays[:, 0, :, 1], want_d)
        torch.testing.assert_close(got_rays[:, 0, :, 0], t["poses"][:, :, 3])
    else:
        assert float(got_align.detach()) > 1e-3
        np.testing.assert_allclose(float(got_align.detach()), float(want_align),
                                   rtol=RTOL)
    # the offsets moved the other points
    assert float((got_rays[:, 1:, :, 1] - got_rays[:, :1, :, 1]).abs()
                 .max()) > 1e-2


def test_pattern_jitter_is_drawn_from_the_generator():
    """The jitter comes from the generator handed in: the same seed gives
    the same rays, another seed others; it has the spread of
    ``random_hwindow`` on the pattern positions, moves DSK's align term,
    and is off at eval."""
    x = {k: torch.from_numpy(v) for k, v in _kernel_inputs().items()}
    mod = DSKBlurModel(ViewEmbedding(IMGS, 8), IMGS, P, 10, "DSK", 8,
                       random_hwindow=0.25, num_hidden=1, num_wide=8,
                       generator=torch.Generator().manual_seed(0))
    args = (torch.from_numpy(K), x["rays_x"], x["rays_y"], x["img_idx"],
            x["poses"], x["img_embed"])

    def run(seed, **kw):
        return mod(*args, generator=torch.Generator().manual_seed(seed),
                   **kw)

    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a[0], b[0]) and torch.equal(a[2], b[2])
    assert not torch.equal(a[0], c[0]) and not torch.equal(a[2], c[2])
    still = [run(s, is_train=False) for s in (1, 2)]
    assert torch.equal(still[0][0], still[1][0])
    # zero the MLP: the rays then differ from the eval ones by the jitter
    # alone, whose pixel offsets go through 1 / focal
    with torch.no_grad():
        mod.linears1[2].weight.zero_()
    big = {k: v.repeat(200, *[1] * (v.dim() - 1)) for k, v in x.items()}
    big["poses"] = torch.eye(3, 4).expand(N * 200, 3, 4)
    bargs = (torch.from_numpy(K), big["rays_x"], big["rays_y"],
             big["img_idx"], big["poses"], big["img_embed"])
    jit = mod(*bargs, generator=torch.Generator().manual_seed(5))[0]
    ref = mod(*bargs, is_train=False)[0]
    dx = (jit - ref)[..., 0, 1] * K[0, 0]
    assert abs(float(dx.std()) - 0.25) < 0.01 and abs(float(dx.mean())) < 0.01


def test_dsk_refusals_and_init():
    view = ViewEmbedding(IMGS, 8)
    with pytest.raises(NotImplementedError, match="random_mode"):
        DSKBlurModel(view, IMGS, P, 10, random_mode="output")
    with pytest.raises(NotImplementedError, match="depth_embed"):
        DSKBlurModel(view, IMGS, P, 10, depth_embed=2)
    with pytest.raises(ValueError, match="kernel_type"):
        DSKBlurModel(view, IMGS, P, 10, kernel_type="RBK")
    # 'output' is accepted while there is no jitter to apply, as in JAX
    DSKBlurModel(view, IMGS, P, 10, random_mode="output", random_hwindow=0.0)

    g = torch.Generator().manual_seed(0)
    wide, head = dsk_linear(256, 256, g), dsk_linear(256, 3, g)
    assert abs(float(wide.weight.std()) / math.sqrt(2 / 512) - 1) < 0.02
    assert abs(float(head.weight.std())
               / (0.1 * math.sqrt(2 / 259)) - 1) < 0.1
    assert not wide.bias.any() and not head.bias.any()
    mod = DSKBlurModel(view, 400, 5, 10, "PBE", 8, pattern_init_radius=0.1,
                       optim_trans=True, optim_sv_trans=True, generator=g)
    assert abs(float(mod.pattern_pos.std()) - 0.1) < 0.01
    assert not mod.pattern_trans.any()
    assert mod.linears1[2].out_features == 5
    assert [n for n, _ in mod.named_parameters()
            if not n.startswith("img_embed.")] == [
        "pattern_pos", "pattern_trans", "linears.0.weight", "linears.0.bias",
        "linears.2.weight", "linears.2.bias", "linears.4.weight",
        "linears.4.bias", "linears1.0.weight", "linears1.0.bias",
        "linears1.2.weight", "linears1.2.bias"]


@pytest.mark.parametrize("D,skips", [(3, (1,)), (4, (4,)), (2, (1,))])
def test_view_embedding_mlp_matches_jax(D, skips):
    jmod = JViewEmbeddingMLP(num_embed=IMGS, embed_dim=6, D=D, W=7,
                             skips=skips, init_params="normal")
    idx = np.array([0, 4, 2, 2, 1], np.int32)
    params = jmod.init(jax.random.PRNGKey(2), idx)["params"]
    want = np.asarray(jmod.apply({"params": params}, idx))
    sd = state_dict_from_jax({"params": {"view_embed": jax.tree_util.tree_map(
        np.asarray, params)}})
    tmod = ViewEmbeddingMLP(IMGS, 6, D=D, W=7, skips=skips)
    tmod.load_state_dict({k[len("kernelsnet.img_embed."):]: v
                          for k, v in sd.items()}, strict=True)
    got = tmod(torch.from_numpy(idx))
    assert got.shape == want.shape == (5, tmod.out_channels)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=ATOL)


# ---------------------------------------------------------------------------
# the PBE stage-0 render and the training forward on the oracle variants
# ---------------------------------------------------------------------------

def test_coarse_render_matches_jax():
    data = np.load(oc.oracle_path("pbe"))
    variables = _nest(data, "var/")
    model = _oracle_model("pbe", variables)
    jmodel = oc.build_model("pbe")
    rays = oc.make_inputs()[0]
    for is_train in (False, True):
        want_rgb, want_feat = jmodel.apply(
            variables, jax.random.PRNGKey(0), jnp.asarray(rays),
            is_train=is_train, perturb=0.0,
            method=lambda m, k, r, **kw: m.renderer.coarse_render(k, r, **kw))
        got_rgb, got_feat = model.coarse_render(torch.from_numpy(rays),
                                                is_train=is_train)
        assert got_feat.shape == (oc.N, 15)
        np.testing.assert_allclose(got_rgb.detach().numpy(),
                                   np.asarray(want_rgb), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got_feat.detach().numpy(),
                                   np.asarray(want_feat), rtol=RTOL,
                                   atol=ATOL)
    # the eval render's coarse colour is the same pass
    np.testing.assert_allclose(got_rgb.detach().numpy(),
                               data["out/eval/rgb0"], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["dsk", "pbe"])
def test_train_forward_matches_reference_and_jax(name):
    data = np.load(oc.oracle_path(name))
    variables = _nest(data, "var/")
    rays, info = oc.make_inputs()
    got = _record(_oracle_model(name, variables).train_forward(
        torch.from_numpy(rays), _info(info), force_naive=False,
        return_pts0_rgb=True))
    live = oc.run_jax(name, variables)
    keys = [k[len("out/"):] for k in data.files
            if k.startswith("out/") and not k.startswith("out/eval/")]
    assert ("loss/align" in keys) == (name == "dsk")
    assert ("tensor/stage0_rgb_pts0" in keys) == (name == "pbe")
    for k in keys:
        np.testing.assert_allclose(got[k], data[f"out/{k}"], rtol=RTOL,
                                   atol=ATOL, err_msg=f"{k} vs reference")
        np.testing.assert_allclose(got[k], live[k], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{k} vs JAX")


@pytest.mark.parametrize("name", ["dsk", "pbe"])
def test_gradients_match_reference(name):
    """d(mse + TV + align)/d(every parameter), the loss of
    tests/oracle_common.py::run_jax_grads, against the recorded autograd of
    the original code: through ``tanh * hwindow`` into ``pattern_pos`` and,
    for PBE, through the stage-0 features into the coarse field."""
    data = np.load(oc.oracle_path(name))
    variables = _nest(data, "var/")
    model = _oracle_model(name, variables)
    rays, info = oc.make_inputs()
    rgb, _, other_loss, _ = model.train_forward(
        torch.from_numpy(rays), _info(info), force_naive=False,
        return_pts0_rgb=True)
    target = torch.from_numpy(oc.make_grad_target())
    loss = torch.mean((rgb - target) ** 2) + sum(
        torch.sum(v) for v in other_loss.values())
    loss.backward()
    ref = state_dict_from_jax({"params": _nest(data, "grad/")["params"]})
    named = dict(model.named_parameters())
    assert set(ref) == set(named) and len(ref) == 36
    for pname, want in ref.items():
        got = named[pname].grad
        if got is None:     # outside this loss's graph: recorded as zeros
            got = torch.zeros_like(named[pname])
        scale = max(float(want.abs().max()), 1e-6)
        np.testing.assert_allclose(got.numpy(), want.numpy(),
                                   atol=5e-4 * scale, rtol=5e-4,
                                   err_msg=f"gradient of {pname}")
    assert float(named["kernelsnet.pattern_pos"].grad.abs().max()) > 0
    if name == "pbe":
        assert float(named["mlp_coarse.sigma_net.1.weight"].grad.abs()
                     .max()) > 0


class _JaxDraws:
    """Stands in for ``torch.rand`` / ``torch.randn``: hands out, in order,
    arrays drawn beforehand with ``jax.random``, and checks each request's
    kind and shape against what was prepared."""

    def __init__(self, draws):
        self.draws = list(draws)

    def _next(self, kind, shape):
        want_kind, arr = self.draws.pop(0)
        assert (kind, tuple(shape)) == (want_kind, arr.shape)
        return torch.from_numpy(np.array(arr))

    def rand(self, shape, **kw):
        return self._next("uniform", shape)

    def randn(self, shape, **kw):
        return self._next("normal", shape)


def _jax_draws(name):
    """The random arrays of one stochastic ``train_forward`` of the JAX
    model from the recording's key, in the port's order of draws."""
    R, S = gf.N * 3, 4
    k_kernel, k_stage0_jit, k_stage0_rnd, k_render = jax.random.split(
        jax.random.PRNGKey(42), 4)
    k_strat, k_pdf, _, _ = jax.random.split(k_render, 4)
    jitter = (gf.N, 3, 2)
    draws = []
    if name == "pbe":
        draws += [("normal", jax.random.normal(k_stage0_jit, jitter)),
                  ("uniform", jax.random.uniform(
                      jax.random.split(k_stage0_rnd)[0], (R, S)))]
    if name != "rbk_awp":
        draws.append(("normal", jax.random.normal(k_kernel, jitter)))
    draws += [("uniform", jax.random.uniform(k_strat, (R, S))),
              ("uniform", jax.random.uniform(k_pdf, (R, S)))]
    return [(kind, np.asarray(a)) for kind, a in draws]


@pytest.mark.parametrize("name", sorted(gf.VARIANTS))
def test_forward_goldens_with_the_jax_draws(name, monkeypatch):
    """Every key of ``forward_<name>.npz``: the stochastic training forward
    (stratified jitter, stochastic importance draws, pattern jitter 0.25)
    on the JAX package's own random numbers, and the eval render."""
    data = np.load(gf._golden_path(name))
    variables = _nest(data, "var/")
    args = gf._make_args(gf.VARIANTS[name])
    jcfg = gf._make_cfg(args.kernel_type, args.kernel_use_awp)
    model = _port_model(jcfg, args, variables, K=gf.K)
    rays, info = gf._make_inputs()
    feed = _JaxDraws(_jax_draws(name))
    monkeypatch.setattr(torch, "rand", feed.rand)
    monkeypatch.setattr(torch, "randn", feed.randn)
    got = _record(model.train_forward(torch.from_numpy(rays), _info(info),
                                      force_naive=False,
                                      return_pts0_rgb=True))
    monkeypatch.undo()
    assert not feed.draws
    with torch.inference_mode():
        ret = model.eval().render(torch.from_numpy(rays))
    got.update({"eval/rgb_map": ret["rgb_map"].numpy(),
                "eval/depth_map": ret["depth_map"].numpy(),
                "eval/rgb0": ret["rgb0"].numpy()})
    keys = [k[len("out/"):] for k in data.files if k.startswith("out/")]
    assert set(keys) == set(got)
    for k in keys:
        np.testing.assert_allclose(got[k], data[f"out/{k}"], rtol=RTOL,
                                   atol=ATOL, err_msg=k)


def test_param_mlp_tree_loads_strictly_and_matches_jax():
    """A DSK model with the table-plus-MLP view embedding and learned
    translations: the flax tree loads with ``strict=True`` and the
    deterministic training forward matches the JAX model's."""
    over = dict(oc.VARIANTS["dsk"], kernel_img_embed_type="param_mlp",
                kernel_img_mlp_embed=12, kernel_img_mlp_depth=2,
                kernel_img_mlp_skips=0, kernel_img_embed_init="normal",
                kernel_spatialvariant_trans=True, kernel_shortcut=True)
    args = oc.make_args(over)
    jcfg = oc.make_cfg(args)
    from evdeblurnerf_tpu.models.system import EvDeblurNeRF as JModel
    from evdeblurnerf_tpu.models.system import \
        kernel_config_from_args as jkernel_config

    jmodel = JModel(cfg=jcfg, kcfg=jkernel_config(args),
                    num_images=oc.NUM_IMAGES, K=oc.K)
    rays, info = oc.make_inputs()
    variables = jmodel.init(jax.random.PRNGKey(5), jax.random.PRNGKey(6),
                            rays, info, force_naive=False,
                            return_pts0_rgb=True)
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    want = jmodel.apply(variables, jax.random.PRNGKey(0), rays, info,
                        force_naive=False, return_pts0_rgb=True)
    model = _port_model(jcfg, args, variables)
    assert "kernelsnet.img_embed.view_embed_linears.1.weight" in dict(
        model.named_parameters())
    got = model.train_forward(torch.from_numpy(rays), _info(info),
                              force_naive=False, return_pts0_rgb=True)
    np.testing.assert_allclose(got[0].detach().numpy(), np.asarray(want[0]),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[2]["align"].detach().numpy(),
                               np.asarray(want[2]["align"]), rtol=RTOL,
                               atol=ATOL)
