"""``--matmul_precision`` in the port (``evdeblurnerf_torch/utils/precision
.py``): each name's per-backend settings, the CPU's backend untouched, the
port's default and a config file's value reaching the resolver through
``resolve_device``, a CPU step that no setting changes, exports after every
setting, and no other place in the port that sets TF32."""

import os
import re
from pathlib import Path

import pytest
import torch

import bench_torch
from evdeblurnerf_torch import config as tconfig
from evdeblurnerf_torch.train import loop as tloop
from evdeblurnerf_torch.train import state as tstate
from evdeblurnerf_torch.train import step as tstep
from evdeblurnerf_torch.utils import precision

REPO = Path(__file__).resolve().parent.parent
NAMES = ("highest", "high", "default")
MAPPED = {"highest": "ieee", "high": "tf32", "default": "tf32"}


def _cpu_settings():
    b = torch.backends
    return (b.mkldnn.matmul.fp32_precision, b.mkldnn.conv.fp32_precision,
            b.fp32_precision)


@pytest.fixture(autouse=True)
def highest_after():
    """Leave the process as every entry point of the port leaves it by
    default."""
    yield
    precision.set_matmul_precision("highest")


@pytest.mark.parametrize("name", NAMES)
def test_names_map_onto_the_cuda_backends_only(name):
    cpu = _cpu_settings()
    assert precision.set_matmul_precision(name) == MAPPED[name]
    assert torch.backends.cuda.matmul.fp32_precision == MAPPED[name]
    assert torch.backends.cudnn.conv.fp32_precision == MAPPED[name]
    assert _cpu_settings() == cpu
    with pytest.raises(ValueError, match="matmul_precision"):
        precision.set_matmul_precision("medium")


@pytest.mark.parametrize("name", NAMES)
def test_export_runs_after_each_setting(name):
    """``torch.export`` reads cuDNN's process-wide TF32 switch, which
    refuses to be read while it disagrees with the per-operation
    settings: the resolver keeps the two agreeing."""
    precision.set_matmul_precision(name)
    lin = torch.nn.Linear(3, 2)
    x = torch.randn(4, 3)
    exported = torch.export.export(lin, (x,))
    torch.testing.assert_close(exported.module()(x), lin(x), rtol=0, atol=0)


def test_port_default_and_a_config_file_reach_the_resolver(tmp_path):
    assert tconfig.PORT_DEFAULTS["matmul_precision"] == "highest"
    assert tconfig.default_args().matmul_precision == "highest"
    assert tconfig.parse_args([]).matmul_precision == "highest"
    cfg = tmp_path / "exp.txt"
    cfg.write_text("matmul_precision = high\n")
    args = tconfig.parse_args(["--config", str(cfg), "--device", "cpu"])
    assert args.matmul_precision == "high"
    cpu = _cpu_settings()
    assert tloop.resolve_device(args) == torch.device("cpu")
    assert torch.backends.cuda.matmul.fp32_precision == "tf32"
    assert torch.backends.cudnn.conv.fp32_precision == "tf32"
    assert _cpu_settings() == cpu
    tloop.resolve_device(tconfig.parse_args(["--device", "cpu"]))
    assert torch.backends.cuda.matmul.fp32_precision == "ieee"
    assert torch.backends.cudnn.conv.fp32_precision == "ieee"


def _one_step(name):
    """Loss and parameters after one step of bench_torch's tiny step on the
    CPU at ``--matmul_precision name``."""
    args = bench_torch.train_args(device="cpu", matmul_precision=name,
                                  **bench_torch.TINY)
    device = tloop.resolve_device(args)
    torch.manual_seed(0)        # the modules that draw from the global RNG
    gen = torch.Generator(device=device).manual_seed(0)
    model, crf = tstate.build_model(
        args, bench_torch.AABB, bench_torch.TINY_H, bench_torch.TINY_W,
        bench_torch.TINY_FOCAL, bench_torch.NEAR, bench_torch.FAR,
        bench_torch.NUM_IMAGES, gen, device)
    state = tstate.create_train_state(model, crf, args, gen,
                                      crf_identity_prefit=False)
    batch, ev_batch = bench_torch.make_train_batch(device, args.N_rand,
                                                   args.events_N_rand)
    sw = tstep.schedule_weights_fn(args)(state.step)
    out = tstep.build_train_step(args)(state, batch, ev_batch, sw, False,
                                       True)
    return out["loss"], {k: v.detach().clone()
                         for k, v in model.state_dict().items()}


@pytest.fixture
def one_torch_thread():
    """A tiny step is many small operations, which gain nothing from
    torch's thread pool beside other busy processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_cpu_step_is_the_same_under_every_setting(one_torch_thread):
    loss, params = _one_step("highest")
    for name in ("high", "default"):
        other_loss, other = _one_step(name)
        assert torch.equal(other_loss, loss), name
        assert other.keys() == params.keys()
        for k, v in params.items():
            assert torch.equal(other[k], v), (name, k)


def test_no_other_place_sets_tf32():
    """The resolver is the one place that touches TF32: no legacy switch
    anywhere else in the port, its root scripts, its tools or its tests.
    The resolver sets cuDNN's once (module docstring of
    ``utils/precision.py``)."""
    # written so that this line does not match itself
    legacy = re.compile(r"allow[_]tf32")
    files = [*(REPO / "evdeblurnerf_torch").rglob("*.py"),
             REPO / "chip_smoke.py", REPO / "bench_torch.py",
             REPO / "run_nerf_torch.py", *(REPO / "tools").glob("*_torch.py"),
             *(REPO / "tests").glob("test_torch_*.py")]
    resolver = REPO / "evdeblurnerf_torch" / "utils" / "precision.py"
    found = {os.path.relpath(p, REPO): len(legacy.findall(p.read_text()))
             for p in files}
    assert found.pop(os.path.relpath(resolver, REPO)) == 1
    assert not {p: n for p, n in found.items() if n}
