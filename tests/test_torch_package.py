"""The port as a package: jax-free import and render, its CUDA sources, and
no silent fallback when the kernels cannot be built."""

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
from evdeblurnerf_torch.ops import (fused_sample, lane_shuffle, line_matmul,
                                   triplane)

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


def test_no_module_imports_jax():
    for path in PKG.rglob("*.py"):
        text = path.read_text()
        assert not re.search(r"^\s*(import|from)\s+(jax|flax)\b", text,
                             re.M), path


def test_cuda_sources_exist_with_their_notes():
    names = {p.name for p in build.sources()}
    assert {"common.cuh", "lane_shuffle.cu", "fused_sample.cu",
            "line_matmul.cu", "api.cu"} <= names
    for src, replaced in (("lane_shuffle.cu", "_take2d_kernel"),
                          ("lane_shuffle.cu", "_take3d_kernel"),
                          ("lane_shuffle.cu", "_cdf_kernel"),
                          ("fused_sample.cu", "_fwd_kernel"),
                          ("fused_sample.cu", "_bwd_kernel"),
                          ("line_matmul.cu", "_grad_kernel")):
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
                                "triplane_features_bwd", "line_grad"])
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
