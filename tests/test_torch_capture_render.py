"""The captured eval render (``train/evaluate.py::build_chunk_renderer``,
``serving.ExportedRenderer``, ``train/loop.py::build_occ_refresh``) on the
CPU.

On the CPU the chunk renderer runs its capture-ready code eagerly: the
rays staged in a static buffer, the tables refreshed, the outputs cloned.
``render_poses`` through it must equal ``render_poses`` through
``render_chunk`` bitwise, and the JAX package's ``render_poses`` through
its jitted ``build_chunk_renderer`` within the repo's oracle bound, 2e-5
rtol/atol (``tests/test_reference_parity.py:25-26``), for the exact
render, the fine cull and the bf16 eval chain, on the golden weights of
the RBK+AWP oracle variant (``tests/oracle_common.py``, 16 rays, 4+4
samples).

A stand-in graph then plays the card's part: its capture records the
closure and keeps the outputs it computed as the graph's own tensors,
and its replay re-runs the closure and writes into those tensors,
counting no launch (a replay runs no Python). With it: rays are staged,
outputs are clones, a grid changed in place is rendered, a moved
parameter recaptures once with one logged line, launch counts move by
the captured counts at each replay, the process-group rule and a
k > 1 artifact run eagerly with one logged line, the artifact and the
occupancy refresh capture, and the train loop renders every cadence with
one graph.
"""

import dataclasses
import functools
import os

import imageio.v2 as imageio
import numpy as np
import pytest
import torch

import oracle_common as oc
from test_torch_render import _golden
from evdeblurnerf_torch import config as tconfig
from evdeblurnerf_torch import kernels, serving
from evdeblurnerf_torch.models.renderer import RenderConfig
from evdeblurnerf_torch.models.system import EvDeblurNeRF, build_occ_grid
from evdeblurnerf_torch.models.tonemapping import CRF
from evdeblurnerf_torch.models.voxnerf import VoxelNeRF
from evdeblurnerf_torch.train import capture
from evdeblurnerf_torch.train import evaluate as teval
from evdeblurnerf_torch.train import loop as tloop
from evdeblurnerf_torch.utils.convert import state_dict_from_jax
from evdeblurnerf_torch.utils.misc import to8b
from evdeblurnerf_tpu.models.system import EvDeblurNeRF as JModel
from evdeblurnerf_tpu.models.system import \
    kernel_config_from_args as jkernel_config
from evdeblurnerf_tpu.train import evaluate as jeval
from synthetic import make_synthetic_scene

ATOL = RTOL = 2e-5
CASES = {
    "exact": (dict(), False),
    "fine_cull": (dict(fine_cull_capacity=0.25), True),
    "bf16_chain": (dict(triplane_bf16=True, triplane_line_matmul=False),
                   False),
}
CHUNK = 16


def _poses(n=2, seed=6):
    rng = np.random.default_rng(seed)
    return np.stack([np.concatenate(
        [np.linalg.qr(np.eye(3) + 0.1 * rng.normal(size=(3, 3)))[0],
         0.05 * rng.normal(size=(3, 1))], 1) for _ in range(n)]).astype(
        np.float32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_render_poses_through_chunk_renderer_matches_eager_and_jax(case):
    """``render_poses`` through the chunk renderer: bitwise the port's
    eager ``render_chunk``, and within 2e-5 of the JAX package's
    ``render_poses`` through its jitted chunk renderer, on one set of
    weights (120 rays in chunks of 50, the last padded)."""
    over, fine_cull = CASES[case]
    args = oc.make_args(oc.VARIANTS["rbk_awp"])
    jcfg = dataclasses.replace(oc.make_cfg(args), **over)
    variables, _ = _golden("rbk_awp")
    jmodel = JModel(cfg=jcfg, kcfg=jkernel_config(args),
                    num_images=oc.NUM_IMAGES, K=oc.K)
    model = EvDeblurNeRF(RenderConfig(**{
        f.name: getattr(jcfg, f.name)
        for f in dataclasses.fields(RenderConfig)}))
    model.load_state_dict({k: v for k, v in state_dict_from_jax(
        variables).items() if k.startswith("mlp_")}, strict=True)
    assert model.mlp_fine.eval_bf16(False) is (case == "bf16_chain")
    H, W, chunk = 6, 10, 50
    K = np.array([[8.0, 0, W / 2], [0, 8.0, H / 2], [0, 0, 1]])
    poses = _poses()
    want = jeval.render_poses(
        variables, jeval.build_chunk_renderer(jmodel, fine_cull=fine_cull),
        poses, H, W, K, chunk=chunk)
    eager = teval.render_poses(
        functools.partial(model.render_chunk, fine_cull=fine_cull), poses,
        H, W, K, chunk=chunk)
    got = teval.render_poses(
        teval.build_chunk_renderer(model, fine_cull=fine_cull), poses, H, W,
        K, chunk=chunk)
    for g, e, w in zip(got, eager, want):
        assert torch.equal(g, e)
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# a replaying stand-in graph
# ---------------------------------------------------------------------------

def _tensors(out):
    return [out] if torch.is_tensor(out) else list(out)


class _ReplayingGraph:
    """A graph on the CPU (module docstring): the capture runs the closure
    once and keeps its outputs as the graph's tensors; a replay runs it
    again, writes into them, and runs none of the host's code: the launch
    counts stay as they were, and the fields do not repack their tables
    (what the renderer's own refresh must do before a replay)."""

    made = []

    def __init__(self, pool, stream, generator):
        assert generator is None, "an eval render registers no generator"
        self.fn = self.outputs = None
        self.replays = 0
        _ReplayingGraph.made.append(self)

    def capture(self, fn):
        self.fn = fn
        self.outputs = fn()
        return self.outputs

    def replay(self):
        before = dict(kernels.LAUNCHES)
        # nor does it run the fields' host check of their grids
        refresh = VoxelNeRF.refresh_tables
        VoxelNeRF.refresh_tables = lambda field: None
        try:
            new = self.fn()
        finally:
            VoxelNeRF.refresh_tables = refresh
        kernels.LAUNCHES.update(before)
        for dst, src in zip(_tensors(self.outputs), _tensors(new)):
            dst.copy_(src)
        self.replays += 1


@pytest.fixture
def graphs():
    _ReplayingGraph.made.clear()
    kernels.reset_launches()
    yield _ReplayingGraph.made
    _ReplayingGraph.made.clear()
    kernels.reset_launches()


def _model(seed=0, **over):
    cfg = dict(N_samples=8, N_importance=8, multires=4, multires_views=2,
               H=32, W=40, focal=30.0,
               aabb=((-1.6, -1.6, -1.0), (1.6, 1.6, 1.0)),
               coarse_n_voxels=4096, fine_n_voxels=8192,
               coarse_app_n_comp=(8, 4, 4), fine_app_n_comp=(8, 4, 4),
               coarse_hidden_dim=16, coarse_hidden_dim_color=16,
               fine_hidden_dim=16, fine_hidden_dim_color=16,
               fine_geo_feat_dim=16, coarse_app_dim=8, fine_app_dim=8,
               occ_grid_size=8)
    cfg.update(over)
    return EvDeblurNeRF(RenderConfig(**cfg),
                        generator=torch.Generator().manual_seed(seed)).eval()


def _rays(n=CHUNK, seed=7):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3)).astype(np.float32) * 0.05
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 0.5
    return torch.from_numpy(np.stack([o, d], axis=-1))


def _equal(got, want):
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_rays_are_staged_and_outputs_are_clones(graphs):
    """The first call renders eagerly, the second captures and replays;
    every later chunk is a replay on the rays staged for it, and a chunk
    kept by the caller is not overwritten by the next."""
    model = _model()
    r = teval.build_chunk_renderer(model, graph_cls=_ReplayingGraph)
    a, b = _rays(seed=7), _rays(seed=8)
    kept = [r(a), r(b), r(a), r(b)]
    assert len(graphs) == 1 and graphs[0].replays == 3
    want_a, want_b = model.render_chunk(a), model.render_chunk(b)
    for got, want in zip(kept, (want_a, want_b, want_a, want_b)):
        _equal(got, want)
    assert not torch.equal(want_a[0], want_b[0])
    graph_rgb = graphs[0].outputs[0]
    assert all(out[0].data_ptr() != graph_rgb.data_ptr() for out in kept)


def test_weights_changed_in_place_are_rendered(graphs, capsys):
    """A grid changed in place (repacked by the renderer's refresh, or by
    the caller) and an MLP weight changed in place are what the next
    replay renders: equal to a fresh eager render, with no second
    capture."""
    model = _model()
    r = teval.build_chunk_renderer(model, graph_cls=_ReplayingGraph)
    rays = _rays()
    r(rays), r(rays)
    with torch.no_grad():
        model.mlp_fine.app_plane[0].add_(0.5)
    _equal(r(rays), model.render_chunk(rays))
    with torch.no_grad():
        model.mlp_coarse.app_line[1].mul_(1.5)
        model.mlp_fine.basis_mat.weight.mul_(1.1)
    model.repack_tables()
    got = r(rays)
    fresh = _model()
    fresh.load_state_dict(model.state_dict())
    _equal(got, fresh.render_chunk(rays))
    assert len(graphs) == 1 and graphs[0].replays == 3
    assert "capturing again" not in capsys.readouterr().out


def test_moved_parameter_recaptures_once(graphs, capsys):
    """A parameter whose storage moved (a load that replaces it) drops the
    graph: one new capture, one logged line, and the render of the new
    weights."""
    model = _model()
    r = teval.build_chunk_renderer(model, graph_cls=_ReplayingGraph)
    rays = _rays()
    r(rays), r(rays)
    w = model.mlp_fine.basis_mat.weight
    w.data = w.data * 0.5
    got = [r(rays), r(rays)]
    assert len(graphs) == 2
    for out in got:
        _equal(out, model.render_chunk(rays))
    assert capsys.readouterr().out.count(
        "[capture] eval chunk render: weights moved since the capture") == 1


def test_launch_counts_move_by_captured_counts(graphs):
    """A chunk that counts launches as the wrappers do on a card (2 of K1,
    1 of K3, 3 of K4): the eager first call counts them, the capture
    counts nothing, each replay counts what the capture counted."""
    r = teval.build_chunk_renderer(_model(), graph_cls=_ReplayingGraph)
    chunk = r.fn

    def counting(rays):
        kernels.LAUNCHES["permute_lanes"] += 2
        kernels.LAUNCHES["cdf_take"] += 1
        kernels.LAUNCHES["triplane_features"] += 3
        return chunk(rays)

    r.fn = counting
    seen = []
    for _ in range(4):
        r(_rays())
        seen.append(tuple(kernels.LAUNCHES[k] for k in
                          ("permute_lanes", "cdf_take", "triplane_features")))
    assert seen == [(2, 1, 3), (4, 2, 6), (6, 3, 9), (8, 4, 12)]
    (graph,) = r.graphs.values()
    assert graph.launches == {
        "permute_lanes": 2, "cdf_take": 1, "triplane_features": 3}


def test_process_group_renders_eagerly(graphs, capsys, monkeypatch):
    """Under a process group the chunk renderer and the occupancy refresh
    run eagerly, each said once, and capture nothing."""
    monkeypatch.setattr(capture.dist, "is_initialized", lambda: True)
    model = _model()
    r = teval.build_chunk_renderer(model, graph_cls=_ReplayingGraph)
    occ = tloop.build_occ_refresh(model, graph_cls=_ReplayingGraph)
    rays = _rays()
    for _ in range(3):
        _equal(r(rays), model.render_chunk(rays))
        assert torch.equal(occ(), build_occ_grid(model))
    assert not graphs and not r.graphs and not r.static
    out = capsys.readouterr().out
    for name in ("eval chunk render", "occupancy refresh"):
        assert out.count(f"[capture] eager {name}, a process group") == 1


def test_serving_renderer_folds_the_crf_into_its_graph(graphs):
    """``ServingRenderer.warm`` brings it to one held graph; its chunks,
    the gamma CRF folded in, equal the eager chunk and the CRF applied
    after ``render_chunk``."""
    model = _model()
    crf = CRF("gamma", 2.2)
    r = serving.ServingRenderer(model, crf, CHUNK, 4, 4, np.eye(3),
                                graph_cls=_ReplayingGraph)
    r.warm()
    assert len(graphs) == 1
    rays = _rays()
    got = r(rays)
    _equal(got, r.eager(rays))
    rgb, depth, acc = model.render_chunk(rays)
    _equal(got, (crf(rgb), depth, acc))
    with pytest.raises(ValueError, match="chunks of shape"):
        r(rays[:8])


def _artifact(model, crf, **kw):
    return serving.export_renderer(model, chunk=CHUNK, crf=crf, **kw)


def test_artifact_captures_its_program_and_k2_runs_eagerly(
        graphs, capsys, monkeypatch):
    """A 1-device artifact's chunk replays one graph of its program's
    call, equal to the program run eagerly; a 2-device artifact (both
    replicas on the CPU) renders eagerly, said once, within the export
    tests' 1e-6 of the 1-device one."""
    model, crf = _model(seed=3), CRF("gamma", 2.2)
    exported, header = _artifact(model, crf)
    r = serving.ExportedRenderer(exported, header, graph_cls=_ReplayingGraph)
    r.warm()
    rays = _rays()
    kept = r(rays)
    _equal(kept, r.eager(rays))
    r(_rays(seed=9))
    _equal(kept, r.eager(rays))
    assert len(graphs) == 1 and graphs[0].replays == 3

    monkeypatch.setattr(serving, "device_count", lambda kind: 2)
    exported, header = _artifact(model, crf, devices=2)
    monkeypatch.undo()
    dp = serving.ExportedRenderer(exported, header, devices=["cpu", "cpu"],
                                  graph_cls=_ReplayingGraph)
    dp.warm()
    for _ in range(2):
        got = dp(rays)
        _equal(got, dp.eager(rays))
        # half a chunk a replica: the export tests' 1e-6
        for a, b in zip(got, kept):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    assert len(graphs) == 1 and not dp._render.graphs
    assert capsys.readouterr().out.count(
        "[capture] eager artifact render, a data-parallel artifact over 2 "
        "devices") == 1


def test_occupancy_refresh_replays_the_current_grid(graphs):
    """The occupancy refresh, a program of no inputs, replays one graph:
    the grid of the weights as they are, equal to ``build_occ_grid``
    bitwise, also after the coarse grids and sigma head changed in
    place."""
    model = _model()
    occ = tloop.build_occ_refresh(model, graph_cls=_ReplayingGraph)
    first = occ()
    for _ in range(2):
        assert torch.equal(occ(), build_occ_grid(model))
    with torch.no_grad():
        for p in model.mlp_coarse.app_plane:
            p.mul_(-3.0)
        model.mlp_coarse.sigma_net[-1].weight.mul_(0.0)     # empty space
    got = occ()
    assert torch.equal(got, build_occ_grid(model))
    assert not torch.equal(got, first)
    assert len(graphs) == 1 and graphs[0].replays == 3


def test_loop_renders_every_cadence_with_one_graph(graphs, tmp_path,
                                                   monkeypatch, capsys):
    """The train loop keeps one chunk renderer across cadences: two
    testset renders with steps between them replay one graph (the steps
    update the weights in place, so nothing recaptures), and the second
    render's images are those of an eager render of the trained
    weights."""
    scene = str(tmp_path / "scene")
    make_synthetic_scene(scene)
    made = []

    def stand_in(build):
        def wrapped(*a, **kw):
            made.append(build(*a, graph_cls=_ReplayingGraph, **kw))
            return made[-1]
        return wrapped

    monkeypatch.setattr(tloop, "build_chunk_renderer",
                        stand_in(tloop.build_chunk_renderer))
    args = tconfig.default_args(
        datadir=scene, basedir=str(tmp_path / "logs"), expname="run",
        device="cpu", factor=None, llffhold=3, seed=0, N_rand=64, chunk=512,
        N_samples=4, N_importance=4, use_viewdirs=True, multires=4,
        multires_views=2, N_iters=6, coarse_n_voxels=4096,
        fine_n_voxels=8192, coarse_app_n_comp=[4, 2, 2],
        fine_app_n_comp=[4, 2, 2], coarse_hidden_dim=8,
        coarse_hidden_dim_color=8, fine_hidden_dim=8,
        fine_hidden_dim_color=8, fine_geo_feat_dim=8, coarse_app_dim=8,
        fine_app_dim=8, perturb=0.0, raw_noise_std=0.0, kernel_type="none",
        events_tms_unit="us", events_tms_files_unit="us", no_wandb=True,
        i_print=10 ** 9, i_tensorboard=10 ** 9, i_weights=10 ** 9,
        i_testset=2, i_video=10 ** 9)
    state = tloop.train(args)
    (r,) = made
    assert len(graphs) == 1 and len(r.graphs) == 1
    assert "capturing again" not in capsys.readouterr().out
    llff, _ = tloop.build_datasets(args)
    rgbs, _ = teval.render_poses(state.model.render_chunk, llff.test_poses,
                                 llff.h, llff.w, llff.K, chunk=args.chunk)
    rgbs = teval.apply_crf(state.crf, rgbs, skip_learn_crf=(
        5 < args.tone_mapping_start_learn_iter))
    last = os.path.join(args.basedir, "run", "testset_000005")
    for i, rgb in enumerate(rgbs):
        np.testing.assert_array_equal(
            imageio.imread(os.path.join(last, f"{i:03d}.png")), to8b(rgb))
    lines = open(os.path.join(args.basedir, "run", "test_metrics.txt")) \
        .read().splitlines()
    assert [ln.split(":")[0] for ln in lines] == ["iter 2", "iter 4",
                                                   "iter 5"]
