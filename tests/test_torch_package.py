"""The port as a package: jax-free import and render, its own flag table
against the JAX package's, its CUDA sources, and no silent fallback when
the kernels cannot be built."""

import glob
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import evdeblurnerf_torch
from evdeblurnerf_torch import kernels
from evdeblurnerf_torch.kernels import build
from evdeblurnerf_torch import config as tconfig
from evdeblurnerf_torch.ops import (fused_sample, lane_shuffle, line_matmul,
                                   tiled_gather, triplane)
from evdeblurnerf_tpu import config as jconfig

PKG = Path(evdeblurnerf_torch.__file__).parent
REPO = PKG.parent

_RENDER_ON_CPU = """
import sys
import torch
from evdeblurnerf_torch import kernels
from evdeblurnerf_torch.models.renderer import RenderConfig
from evdeblurnerf_torch.models.system import EvDeblurNeRF

cfg = RenderConfig(N_samples=4, N_importance=4, multires=2, multires_views=1,
                   H=8, W=8, focal=8.0, coarse_n_voxels=512,
                   fine_n_voxels=1000, coarse_app_n_comp=(2, 1, 1),
                   fine_app_n_comp=(2, 1, 1), coarse_hidden_dim=4,
                   coarse_hidden_dim_color=4, fine_hidden_dim=4,
                   fine_hidden_dim_color=4, fine_geo_feat_dim=4,
                   coarse_app_dim=4, fine_app_dim=4, kernel_feat_cnl=3)
model = EvDeblurNeRF(cfg, generator=torch.Generator().manual_seed(0))
g = torch.Generator().manual_seed(1)
rays = torch.randn(16, 3, 2, generator=g)
rays[:, 2, 1] = -rays[:, 2, 1].abs() - 0.5
rgb, depth, acc = model.render_chunk(rays)
assert rgb.shape == (16, 3) and bool(torch.isfinite(rgb).all())
assert all(v == 0 for v in kernels.LAUNCHES.values())
loaded = [m for m in sys.modules if m.split(".")[0] in
          ("jax", "jaxlib", "flax", "evdeblurnerf_tpu")]
assert not loaded, loaded
print("ok")
"""


_TRAIN_ON_CPU = """
import sys
import torch
import chip_smoke
from evdeblurnerf_torch import kernels
from evdeblurnerf_torch.train import state as tstate, step as tstep

args = chip_smoke.train_args(
    coarse_n_voxels=512, fine_n_voxels=1000, coarse_app_n_comp=[2, 1, 1],
    fine_app_n_comp=[2, 1, 1], coarse_hidden_dim=4, coarse_hidden_dim_color=4,
    fine_hidden_dim=4, fine_hidden_dim_color=4, fine_geo_feat_dim=4,
    N_samples=4, N_importance=4, kernel_ptnum=3)
model, crf = tstate.build_model(args, chip_smoke.AABB, 8, 8, 8.0, 0.0, 1.0, 4,
                                torch.Generator().manual_seed(0))
state = tstate.create_train_state(model, crf, args,
                                  torch.Generator().manual_seed(1),
                                  crf_prefit_steps=5)
batch, ev = chip_smoke.make_train_batch(torch.device("cpu"), 8, 4)
batch["images_idx"] %= 4
aux = tstep.build_train_step(args)(state, batch, ev,
                                   tstep.schedule_weights_fn(args)(0),
                                   False, True)
assert bool(torch.isfinite(aux["loss"])) and state.step == 1
assert all(v == 0 for v in kernels.LAUNCHES.values())
loaded = [m for m in sys.modules if m.split(".")[0] in
          ("jax", "jaxlib", "flax", "optax", "evdeblurnerf_tpu")]
assert not loaded, loaded
print("ok")
"""


def test_cpu_train_step_loads_no_jax():
    """A training step of the paper's method at a tiny width, on the CPU,
    through chip_smoke's flags: nothing of jax, flax, optax or the JAX
    package is imported."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _TRAIN_ON_CPU], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_import_and_cpu_render_load_no_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _RENDER_ON_CPU], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


_PARSE_ONLY = """
import sys
import evdeblurnerf_torch
import evdeblurnerf_torch.config
import evdeblurnerf_torch.cli
import evdeblurnerf_torch.train.loop
from evdeblurnerf_torch.config import parse_args
args = parse_args(["--config", sys.argv[1], "--N_rand", "64"])
assert args.N_rand == 64 and args.kernel_type == "RBK"
loaded = [m for m in sys.modules if m.split(".")[0] in
          ("jax", "jaxlib", "flax", "optax", "orbax", "evdeblurnerf_tpu")]
assert not loaded, loaded
print("ok")
"""

CONFIG_FILES = sorted(glob.glob(str(REPO / "configs" / "**" / "*.txt"),
                                recursive=True))
COMMAND_LINES = [
    [],
    ["--N_rand", "256", "--kernel_type", "RBK", "--use_events"],
    ["--coarse_app_n_comp", "[8, 4, 4]", "--fine_app_n_comp", "8", "4", "4",
     "--event_accumulate_step_range", "1", "3", "--no_ndc"],
    ["--expname=x", "--lrate", "1e-3", "--ft_path", "none",
     "--add_event_egm_stages", "stage0", "stage1", "--tone_mapping_type",
     "gamma", "--use_pts0_prior", "edi"],
    ["--compilation_cache_dir", "none", "--matmul_precision", "highest",
     "--remat", "--grad_accum", "4", "--triplane_line_matmul", "True",
     "--fine_cull_capacity", "0.25", "--tp_model_parallel", "2",
     "--multihost", "--triplane_bf16", "--profile_start_step", "3"],
]


def _assert_same_flags(argv):
    """The port's parse equals the JAX package's, apart from the flags in
    PORT_DEFAULTS that neither the file nor the command line sets, and the
    port's own ``--device``."""
    targs = tconfig.parse_args(argv).as_dict()
    jargs = jconfig.parse_args(argv).as_dict()
    given = set(jconfig._parse_cli(argv))
    if jargs.get("config"):
        given |= set(jconfig.parse_config_file(jargs["config"]))
    assert targs.pop("device") == "cuda"
    assert set(targs) == set(jargs)
    for key, want in jargs.items():
        if key in tconfig.PORT_DEFAULTS and key not in given:
            want = tconfig.PORT_DEFAULTS[key]
        assert targs[key] == want, key


@pytest.mark.parametrize("path", CONFIG_FILES,
                         ids=[os.path.relpath(p, REPO) for p in CONFIG_FILES])
def test_config_files_parse_as_in_the_jax_package(path):
    assert CONFIG_FILES, "no config files found"
    _assert_same_flags(["--config", path])


@pytest.mark.parametrize("argv", COMMAND_LINES,
                         ids=[f"cli{i}" for i in range(len(COMMAND_LINES))])
def test_command_lines_parse_as_in_the_jax_package(argv):
    _assert_same_flags(argv)
    _assert_same_flags(["--config", CONFIG_FILES[0], *argv])


def test_default_args_and_args_txt_match_the_jax_package(tmp_path):
    over = dict(N_rand=32, kernel_type="RBK", fine_app_n_comp="[4, 2, 2]")
    targs = tconfig.default_args(**over).as_dict()
    jargs = jconfig.default_args(**over, **tconfig.PORT_DEFAULTS).as_dict()
    assert targs.pop("device") == "cuda"
    assert targs == jargs
    with pytest.raises(ValueError, match="unknown flag"):
        tconfig.default_args(no_such_flag=1)
    with pytest.raises(ValueError, match="divisible"):
        tconfig.parse_args(["--N_rand", "10", "--grad_accum", "4"])
    args = tconfig.resolve_event_thresholds(tconfig.default_args(
        events_threshold=0.3))
    assert args.events_threshold_pos == args.events_threshold_neg == 0.3
    tconfig.write_args_txt(args, str(tmp_path / "args.txt"))
    assert "events_threshold_pos = 0.3" in (tmp_path / "args.txt").read_text()


@pytest.mark.parametrize("flags,item", [
    (dict(fine_cull_capacity=0.25), 17), (dict(coarse_cull_capacity=0.5), 20),
    (dict(tp_model_parallel=2), 22), (dict(multihost=True), 22),
    (dict(triplane_bf16=True), 24), (dict(mode="nerf"), 19),
    (dict(profile_start_step=0), 15)])
def test_unported_settings_raise_with_their_item(flags, item):
    """A flag that asks for what the port does not do yet parses, and the
    loop refuses it naming its ROADMAP queue-1 item; flags that only steer
    TPU mechanisms are accepted and ignored."""
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        tconfig.check_supported(tconfig.default_args(**flags))
    tconfig.check_supported(tconfig.default_args(
        compilation_cache_dir="none", matmul_precision="highest", remat=True,
        triplane_line_matmul=True))


def test_parse_and_loop_import_load_no_jax():
    """Importing the package, its config, CLI and train loop and parsing
    the paper config leaves nothing of jax, flax, optax, orbax or the JAX
    package in ``sys.modules``."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _PARSE_ONLY,
                           CONFIG_FILES[0]], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_cli_selects_the_card_and_fails_loudly_without_one(tmp_path):
    """Without ``--device`` the entry point asks for the card; where there
    is none it raises before it touches the data, and does not carry on
    on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    from evdeblurnerf_torch import cli

    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["--datadir", str(tmp_path / "nowhere"), "--basedir",
                  str(tmp_path), "--expname", "x", "--no_wandb"])
    assert not (tmp_path / "x").exists()


def test_no_module_imports_jax():
    """No module of the port, nor its root scripts, imports jax, flax or
    anything of the JAX package."""
    files = [*PKG.rglob("*.py"), REPO / "chip_smoke.py",
             REPO / "bench_torch.py", REPO / "run_nerf_torch.py",
             *(REPO / "tools").glob("*_torch.py")]
    for path in files:
        text = path.read_text()
        assert not re.search(
            r"^\s*(import|from)\s+(jax|flax|optax|orbax|evdeblurnerf_tpu)\b",
            text, re.M), path


@pytest.fixture
def one_torch_thread():
    """Thousands of tiny operations (the CRF pre-fit) gain nothing from
    torch's thread pool and lose minutes to it beside other busy
    processes."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_bench_torch_tiny_runs_on_the_cpu(tmp_path, one_torch_thread):
    """``python3 bench_torch.py --device cpu --tiny``: the three readings
    through the same code at a small size; the JSON line has its keys, the
    losses are finite, and no BENCHMARK.json appears."""
    import json
    import math

    import bench_torch

    out = tmp_path / "bench.json"
    result = bench_torch.main(["--device", "cpu", "--tiny", "--iters", "2",
                               "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(result))
    assert result["device"] == {"platform": "cpu", "kind": "cpu"}
    assert result["card"] is None and result["tiny"] is True
    assert {"torch", "cuda", "commit", "config", "overrides",
            "host_share"} <= set(result)
    for reading in ("step_only", "loop"):
        r = result[reading]
        assert r["rays_per_step"] == 32 * 3 + 2 * 32 and r["iters"] == 2
        assert r["ms_per_step"] > 0 and math.isfinite(r["train_rays_per_s"])
        assert r["launches_per_step"] == {}     # no kernel runs on the CPU
    losses = result["step_only"]["losses"]
    assert len(losses) == bench_torch.WARMUP_STEPS + 2
    assert all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]
    assert result["serve"]["rays"] == bench_torch.TINY_H * bench_torch.TINY_W
    assert result["serve"]["eval_rays_per_s"] > 0
    assert not (REPO / "BENCHMARK.json").exists()
    only = bench_torch.run(device="cpu", tiny=True, iters=1, only="serve")
    assert "serve" in only and "step_only" not in only and "loop" not in only


@pytest.mark.parametrize("kernel_type", ["DSK", "PBE"])
def test_dsk_and_pbe_build_through_the_flags(kernel_type):
    """``--kernel_type DSK|PBE`` reaches the model: nothing refuses it, the
    kernel's parameters carry the reference's names and sit in the
    optimizer."""
    from evdeblurnerf_torch.models.blur_dsk import DSKBlurModel
    from evdeblurnerf_torch.train import state as tstate

    args = tconfig.default_args(
        kernel_type=kernel_type, kernel_ptnum=3, N_samples=4, N_importance=4,
        coarse_n_voxels=512, fine_n_voxels=512, coarse_app_n_comp=[4, 2, 2],
        fine_app_n_comp=[4, 2, 2], kernel_img_embed_type="param_mlp",
        kernel_img_mlp_depth=2, kernel_img_mlp_embed=6)
    tconfig.check_supported(args)
    model, crf = tstate.build_model(args, ((-1, -1, -1), (1, 1, 1)), 8, 10,
                                    9.0, 0.0, 1.0, 3,
                                    torch.Generator().manual_seed(0), "cpu")
    assert isinstance(model.kernelsnet, DSKBlurModel)
    assert model.kernelsnet.kernel_type == kernel_type
    names = {n for n, _ in model.named_parameters()}
    assert {"kernelsnet.pattern_pos", "kernelsnet.linears.0.weight",
            "kernelsnet.linears1.2.bias", "kernelsnet.img_embed.img_embed",
            "kernelsnet.img_embed.view_embed_linears.1.weight"} <= names
    assert model.mlp_coarse.composite_feature == (kernel_type == "PBE")
    torch.testing.assert_close(
        model.K, torch.tensor([[9.0, 0, 5.0], [0, 9.0, 4.0], [0, 0, 1.0]]))
    state = tstate.create_train_state(model, crf, args, torch.Generator(),
                                      crf_identity_prefit=False)
    held = {id(p) for g in state.optimizer.param_groups for p in g["params"]}
    assert all(id(p) in held for p in model.kernelsnet.parameters())


def test_cuda_sources_exist_with_their_notes():
    names = {p.name for p in build.sources()}
    assert {"common.cuh", "lane_shuffle.cu", "fused_sample.cu",
            "line_matmul.cu", "tiled_gather.cu", "api.cu"} <= names
    for src, replaced in (("lane_shuffle.cu", "_take2d_kernel"),
                          ("lane_shuffle.cu", "_take3d_kernel"),
                          ("lane_shuffle.cu", "_cdf_kernel"),
                          ("fused_sample.cu", "_fwd_kernel"),
                          ("fused_sample.cu", "_bwd_kernel"),
                          ("line_matmul.cu", "_grad_kernel"),
                          ("tiled_gather.cu", "tiled_gather.py::_kernel")):
        text = (build.CSRC_DIR / src).read_text()
        assert replaced in text and "Bound:" in text
    for sig in build.SIGNATURES:
        assert any(f"EVDN_API int {sig}(" in p.read_text()
                   for p in build.sources())
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


@pytest.fixture
def no_nvcc(monkeypatch, tmp_path):
    """A machine without the CUDA toolkit and without a built library."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(build, "DEFAULT_CUDA_HOME", tmp_path / "no-cuda")
    monkeypatch.setattr(build.shutil, "which", lambda *_: None)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_lib", None)


def test_build_without_nvcc_names_it(no_nvcc):
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build()
    with pytest.raises(RuntimeError, match="nvcc"):
        build.load()


def _tiny_tables():
    planes = [torch.randn(2, 4, 5), torch.randn(1, 3, 4), torch.randn(1, 3, 5)]
    lines = [torch.randn(2, 3), torch.randn(1, 5), torch.randn(1, 4)]
    return triplane.pack_grids(planes, lines)


@pytest.mark.parametrize("op", ["permute_lanes", "permute_lanes_3d",
                                "cdf_take", "triplane_features",
                                "triplane_features_bwd", "line_grad",
                                "tiled_plane_gather"])
def test_kernel_path_raises_without_fallback(no_nvcc, monkeypatch, op):
    """When a wrapper takes the kernel path and the kernel cannot be
    built, the error reaches the caller: no wrapper catches it and carries
    on with the plain version, and no launch is counted."""
    monkeypatch.setattr(kernels, "wants_kernel", lambda *t: True)
    kernels.reset_launches()
    x = torch.randn(4, 8)
    idx = torch.arange(8, dtype=torch.int32).expand(4, 8).contiguous()
    with pytest.raises(RuntimeError, match="nvcc"):
        if op == "permute_lanes":
            lane_shuffle.permute_lanes(x, idx, idx)
        elif op == "permute_lanes_3d":
            lane_shuffle.permute_lanes(x[:, None], idx, idx)
        elif op == "cdf_take":
            lane_shuffle.cdf_take(x, x, idx, idx)
        elif op == "line_grad":
            line_matmul.line_grad(idx[0], x.T.contiguous(), 8)
        elif op == "tiled_plane_gather":
            f = torch.rand(tiled_gather.GROUP) * 6
            o = torch.zeros(1, dtype=torch.int32)
            tiled_gather.tiled_plane_gather(torch.randn(8, 8, 4), f, f, o, o,
                                            TH=8, TW=8)
        else:
            pp, pl, sizes = _tiny_tables()
            xyz = torch.rand(6, 3) * 2 - 1
            if op == "triplane_features":
                fused_sample.triplane_features(pp, pl, sizes, xyz)
            else:
                planes = [p[:, :p.shape[1] // 4].T.reshape(-1, h, w)
                          for p, (h, w, _) in zip(pp, sizes)]
                lines = [l[:, :l.shape[1] // 2].T for l in pl]
                fused_sample.triplane_features_bwd(
                    planes, lines, (pp, pl, sizes), xyz, torch.rand(6, 4))
    assert kernels.LAUNCHES[op] == 0


def test_wants_kernel_dispatch():
    cpu = torch.zeros(2)
    assert kernels.wants_kernel(cpu, cpu) is False
    with pytest.raises(ValueError, match="no kernel"):
        kernels.wants_kernel(torch.zeros(2, device="meta"))
