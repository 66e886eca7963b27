"""The port's exported serving artifact (``evdeblurnerf_torch/serving.py``):
the eval render traced by ``torch.export`` with the weights in the
program, reloaded without model code; mirrors ``tests/test_export.py``.

The artifact must reproduce the live renderer through a save/load round
trip within 1e-6 (the JAX package's bound for its own artifact; on the CPU
the two run the same operations, so they agree exactly). Inputs are made
with numpy from a seed.
"""

import json
import os
import runpy
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_loop import _argv
from evdeblurnerf_torch import cli as tcli, config as tconfig, serving
from evdeblurnerf_torch.models.renderer import RenderConfig
from evdeblurnerf_torch.models.system import EvDeblurNeRF
from evdeblurnerf_torch.models.tonemapping import TonemappingTransform
from evdeblurnerf_torch.train import evaluate as teval, loop as tloop
from evdeblurnerf_torch.train.checkpoint import CheckpointManager
from synthetic import make_synthetic_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK = 16
TOL = 1e-6
H, W = 8, 10
K = [[12.0, 0.0, 5.0], [0.0, 12.0, 4.0], [0.0, 0.0, 1.0]]
META = {"H": H, "W": W, "K": K}


def _model(seed=0, **over):
    cfg = dict(N_samples=8, N_importance=8, multires=4, multires_views=2,
               H=32, W=40, focal=30.0,
               aabb=((-1.6, -1.6, -1.0), (1.6, 1.6, 1.0)),
               coarse_n_voxels=4096, fine_n_voxels=8192,
               coarse_app_n_comp=(8, 4, 4), fine_app_n_comp=(8, 4, 4),
               coarse_hidden_dim=16, coarse_hidden_dim_color=16,
               fine_hidden_dim=16, fine_hidden_dim_color=16,
               fine_geo_feat_dim=16, coarse_app_dim=8, fine_app_dim=8)
    cfg.update(over)
    return EvDeblurNeRF(RenderConfig(**cfg),
                        generator=torch.Generator().manual_seed(seed)).eval()


def _crf():
    return TonemappingTransform(map_type_rgb="gamma", gamma=2.2)


def _rays(n=CHUNK, seed=7):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3)).astype(np.float32) * 0.05
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 0.5
    return torch.from_numpy(np.stack([o, d], axis=-1))


def _live(model, rays, crf=None, fine_cull=False):
    with torch.no_grad():
        return serving.make_render_fn(model, crf, fine_cull=fine_cull)(rays)


def _export(model, path, crf=None, fine_cull=False, **meta):
    exported, header = serving.export_renderer(
        model, chunk=CHUNK, crf=crf, fine_cull=fine_cull,
        meta={**META, **meta})
    serving.save_renderer(str(path), exported, header)
    return serving.load_renderer(str(path))


def _close(got, want):
    for name, a, b in zip(("rgb", "depth", "acc"), got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=TOL, atol=TOL,
                                   err_msg=name)


def test_export_roundtrip_matches_live(tmp_path):
    model, crf = _model(), _crf()
    rays = _rays()
    live = _live(model, rays, crf)
    r = _export(model, tmp_path / "scene.evdnpt", crf)
    assert r.chunk == CHUNK
    assert r.meta["crf_folded"] and r.meta["H"] == H
    assert r.meta["tables"] == "packed" and not r.meta["triplane_bf16"]
    assert r.meta["device"] == "cpu"
    assert r.meta["torch_version"] == torch.__version__
    _close(r(rays), live)
    # the CRF changed the rgb (a fold that is no identity)
    plain = _live(model, rays)
    assert float((plain[0] - live[0]).abs().max()) > 1e-3
    # the program calls the kernels' custom ops and holds the packed
    # tables, not the raw grids
    targets = {str(n.target) for n in r._exported.graph.nodes
               if n.op == "call_function"}
    assert {"evdn.triplane_features.default", "evdn.cdf_take.default",
            "evdn.permute_lanes.default"} <= targets
    names = set(r._exported.state_dict) | set(r._exported.constants)
    assert not any(".app_plane" in n or ".app_line" in n for n in names)
    assert any("packed_plane_0" in n for n in names)
    # exporting froze a copy: the live model still trains
    assert not model.mlp_fine.tables_frozen
    assert len(list(model.mlp_fine.app_plane)) == 3


def _jax_artifact(path):
    """A real artifact of the JAX package (tests/test_export.py's model)."""
    import jax

    from test_golden_forward import _build_model, _make_inputs
    from evdeblurnerf_tpu import serving as jserving

    model = _build_model("dsk")
    rays, info = _make_inputs()
    variables = model.init(jax.random.PRNGKey(0), jax.random.PRNGKey(1),
                           rays, info)
    exported, meta = jserving.export_renderer(model, variables, chunk=CHUNK)
    jserving.save_renderer(str(path), exported, meta)
    return jserving


def test_artifact_validation(tmp_path):
    r = _export(_model(), tmp_path / "a.evdnpt")
    with pytest.raises(ValueError, match="fixed chunks"):
        r(torch.zeros(CHUNK + 1, 3, 2))

    bad = tmp_path / "bad.evdnpt"
    bad.write_bytes(b"NOTANART" + b"\x00" * 32)
    with pytest.raises(ValueError, match="bad magic"):
        serving.load_renderer(str(bad))

    newer = tmp_path / "new.evdnpt"
    head = json.dumps({"format_version": 999, "chunk": CHUNK}).encode()
    newer.write_bytes(serving.MAGIC + struct.pack("<Q", len(head)) + head)
    with pytest.raises(ValueError, match="newer"):
        serving.load_renderer(str(newer))

    # each package refuses the other's artifact: the port names the JAX
    # package, the JAX loader reads a magic that is not its own
    jpath = tmp_path / "jax.evdnsrv"
    jserving = _jax_artifact(jpath)
    with pytest.raises(ValueError, match="JAX package.*evdeblurnerf_tpu"):
        serving.load_renderer(str(jpath))
    with pytest.raises(ValueError, match="bad magic b'EVDNPTS1'"):
        jserving.load_renderer(str(tmp_path / "a.evdnpt"))


def test_render_poses_via_artifact(tmp_path):
    """Whole poses through the artifact reproduce the live renderer's
    pipelined pose render (``train/evaluate.py``), the last chunk padded."""
    model, crf = _model(), _crf()
    pose = np.concatenate([np.eye(3), np.array([[0.02], [0.01], [0.03]])],
                          axis=1).astype(np.float32)[None]
    live_fn = serving.make_render_fn(model, crf)
    with torch.no_grad():
        want_rgb, want_depth = teval.render_poses(live_fn, pose, H, W,
                                                  np.asarray(K), chunk=CHUNK)
    r = _export(model, tmp_path / "p.evdnpt", crf)
    got_rgb, got_depth = r.render_poses(pose)
    assert tuple(got_rgb.shape) == (1, H, W, 3)
    np.testing.assert_allclose(got_rgb.numpy(), want_rgb.numpy(), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(got_depth.numpy(), want_depth.numpy(),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("bf16", [False, True])
def test_bf16_and_fine_cull_artifacts(tmp_path, bf16):
    """A bf16 model's artifact carries its bf16 eval chain (named in the
    header, its render the live bf16 eval render, not the
    f32-interpolation one); a fine-cull artifact renders the culled eval
    render (``--fine_cull_eval``)."""
    model, crf = _model(seed=1, triplane_bf16=bf16,
                        fine_cull_capacity=0.25), _crf()
    rays = _rays()
    r = _export(model, tmp_path / "b.evdnpt", crf)
    assert r.meta["triplane_bf16"] is bf16
    assert r.meta["eval_bf16_chain"] is bf16 and not r.meta["fine_cull"]
    _close(r(rays), _live(model, rays, crf))
    culled = _export(model, tmp_path / "c.evdnpt", crf, fine_cull=True)
    assert culled.meta["fine_cull"]
    want = _live(model, rays, crf, fine_cull=True)
    _close(culled(rays), want)
    assert float((want[1] - _live(model, rays, crf)[1]).abs().max()) > 0
    if bf16:
        f32 = EvDeblurNeRF(model.cfg, eval_f32_interp=True).eval()
        f32.load_state_dict(model.state_dict())
        other = _live(f32, rays, crf)
        assert float((other[1] - r(rays)[1]).abs().max()) > 0
        packed = {n: t for n, t in r._exported.constants.items()
                  if "packed_" in n}
        packed.update({n: t for n, t in r._exported.state_dict.items()
                       if "packed_" in n})
        assert packed and all(t.dtype == torch.bfloat16
                              for t in packed.values())


def test_export_over_several_devices_raises_item_22(tmp_path):
    """An export over more devices than the process has raises the JAX
    package's ``ValueError`` (``evdeblurnerf_tpu/serving.py:244-249``);
    one CPU is one device."""
    with pytest.raises(ValueError, match="export requested 2 devices but "
                       "this process has 1"):
        serving.export_renderer(_model(), chunk=CHUNK, devices=2)
    with pytest.raises(ValueError, match="export requested 2 devices"):
        tcli.export_main(["--out", str(tmp_path / "x.evdnpt"),
                          "--export_devices", "2", "--device", "cpu"])


def test_data_parallel_artifact_splits_chunks_over_replicas(tmp_path,
                                                            monkeypatch):
    """A 2-device artifact renders half a chunk a replica; loaded with its
    replicas on two devices (here both the CPU) it renders what the live
    renderer renders, and a process with fewer devices refuses it."""
    model, crf = _model(), _crf()
    rays = _rays()
    live = _live(model, rays, crf)
    monkeypatch.setattr(serving, "device_count", lambda kind: 2)
    exported, header = serving.export_renderer(model, chunk=CHUNK, crf=crf,
                                               meta=META, devices=2)
    assert header["devices"] == 2 and header["chunk"] == CHUNK
    path = str(tmp_path / "dp.evdnpt")
    serving.save_renderer(path, exported, header)
    monkeypatch.undo()
    with pytest.raises(ValueError, match="exported for 2 devices; this "
                       "process has 1"):
        serving.load_renderer(path)
    with open(path, "rb") as f:
        f.read(len(serving.MAGIC))
        (n,) = struct.unpack("<Q", f.read(8))
        meta = json.loads(f.read(n))
        program = torch.export.load(f)
    r = serving.ExportedRenderer(program, meta, devices=["cpu", "cpu"])
    _close(r(rays), live)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A 2-step CPU run of ``run_nerf_torch.py`` on the synthetic scene,
    its checkpoint at step 2 (the CRF's learn start at 1: the export folds
    the CRF with its learned head in, as the loop's renders would)."""
    base = tmp_path_factory.mktemp("export_run")
    scene_dir = str(base / "scene")
    os.makedirs(scene_dir)
    make_synthetic_scene(scene_dir)
    log = str(base / "logs")
    argv = _argv(scene_dir, log, N_iters=2, i_weights=2,
                 tone_mapping_type="gamma",
                 tone_mapping_start_learn_iter=1)
    old = sys.argv
    sys.argv = ["run_nerf_torch.py", *argv]
    try:
        runpy.run_path(os.path.join(REPO, "run_nerf_torch.py"),
                       run_name="__main__")
    finally:
        sys.argv = old
    return argv, log


def test_export_experiment_end_to_end(trained, tmp_path):
    """``evdn-export-torch`` (``tools/export_renderer_torch.py``) on the
    trained run: the artifact's test-pose render against the live model
    restored from the same checkpoint, its CRF applied as the loop applies
    it, within 1e-6."""
    argv, log = trained
    out = str(tmp_path / "exp.evdnpt")
    tool = runpy.run_path(os.path.join(REPO, "tools",
                                       "export_renderer_torch.py"))
    meta = tool["main"](["--out", out, "--export_chunk", "64", *argv])
    assert meta["step"] == 2 and meta["expname"] == "run"
    assert meta["crf_folded"] and not meta["skip_learn_crf"]
    assert meta["bytes"] == os.path.getsize(out)

    args = tconfig.parse_args(argv)
    llff, _ = tloop.build_datasets(args)
    model, crf = tloop.build_model(args, llff)
    state = tloop.build_initial_state(args, model, crf, torch.Generator(),
                                      crf_identity_prefit=False)
    step = CheckpointManager(os.path.join(log, "run", "checkpoints")
                             ).restore_latest(state)
    assert step == 2
    r = serving.load_renderer(out)
    pose = np.asarray(llff.test_poses)[:1, :3, :4]
    got_rgb, _ = r.render_poses(pose)
    assert tuple(got_rgb.shape) == (1, meta["H"], meta["W"], 3)
    assert bool(torch.isfinite(got_rgb).all())
    model.eval()
    live_rgb, _ = teval.render_poses(model.render_chunk, pose, llff.h,
                                     llff.w, llff.K, chunk=64)
    live_rgb = teval.apply_crf(crf, live_rgb, skip_learn_crf=False)
    np.testing.assert_allclose(got_rgb.numpy(), live_rgb, rtol=TOL,
                               atol=TOL)


def test_bench_serving_tool(tmp_path):
    """``tools/bench_serving_torch.py`` measures a tiny artifact and
    reports its numbers as one JSON line."""
    path = tmp_path / "scene.evdnpt"
    _export(_model(), path, _crf())
    tool = runpy.run_path(os.path.join(REPO, "tools",
                                       "bench_serving_torch.py"))
    res = tool["run"](str(path), calls=5, in_flight=2, warmup=1)
    assert res["chunk"] == CHUNK and res["device"] == "cpu"
    assert res["load_s"] > 0 and res["first_call_s"] > 0
    assert res["latency_p50_ms"] <= res["latency_p99_ms"]
    assert res["throughput_rays_per_sec"] > 0
    assert res["bytes"] == os.path.getsize(path)
    json.dumps(res)


def test_artifact_loads_without_model_code(tmp_path):
    """A fresh process loads and serves the artifact having imported no
    module of ``evdeblurnerf_torch.models`` (nor jax), and renders what
    this process's live model renders."""
    model, crf = _model(seed=2), _crf()
    rays = _rays()
    path = tmp_path / "fresh.evdnpt"
    _export(model, path, crf)
    np.save(tmp_path / "rays.npy", rays.numpy())
    code = (
        "import sys, numpy as np, torch\n"
        "from evdeblurnerf_torch import serving\n"
        f"r = serving.load_renderer({str(path)!r})\n"
        f"rays = torch.from_numpy(np.load({str(tmp_path / 'rays.npy')!r}))\n"
        "rgb, depth, acc = r(rays)\n"
        f"np.save({str(tmp_path / 'rgb.npy')!r}, rgb.numpy())\n"
        "bad = sorted(m for m in sys.modules if m.startswith("
        "('evdeblurnerf_torch.models', 'jax', 'evdeblurnerf_tpu')))\n"
        "print('LOADED', bad)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(tmp_path), timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED []" in out.stdout, out.stdout
    np.testing.assert_allclose(np.load(tmp_path / "rgb.npy"),
                               _live(model, rays, crf)[0].numpy(), rtol=TOL,
                               atol=TOL)
