"""Multi-process runs of the PyTorch port through its entry point
(``run_nerf_torch.py`` -> ``cli.main`` -> ``train/loop.py::train``) on
the CPU, the counterpart of ``tests/test_multihost.py``.

The ranks are processes launched as ``torchrun`` launches them
(``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``) with ``--device cpu``, so they join over gloo. Each
assembles the global batch from the shared seed and trains on its rows;
the primary alone writes; the held-out renders are data-parallel. The
two-process run is held to the one-process run of the same flags, its
checkpoint is rendered by one process, and a data-parallel render equals
the one-process render of the same checkpoint.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_loop import BASE, FULL, _scalars
from evdeblurnerf_torch import cli as tcli
from evdeblurnerf_torch import config as tconfig
from evdeblurnerf_torch.parallel import mesh, multihost
from evdeblurnerf_torch.train import loop as tloop
from synthetic import make_synthetic_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
from parallel_check_torch import free_port  # noqa: E402


def _argv(flags):
    """Command-line flags of a dict of flag values."""
    argv = []
    for k, v in flags.items():
        if isinstance(v, bool):
            assert v or not getattr(tconfig.default_args(), k), k
            argv += [f"--{k}"] if v else []
        elif isinstance(v, (list, tuple)):
            argv += [f"--{k}", *map(str, v)]
        else:
            argv += [f"--{k}", "none" if v is None else str(v)]
    return argv


def _launch(argv, world, timeout=600):
    """``world`` ranks of ``run_nerf_torch.py argv`` as torchrun starts
    them; returns their outputs, raising if one fails."""
    port = str(free_port())
    procs = []
    for r in range(world):
        env = {**os.environ, "MASTER_ADDR": "localhost", "MASTER_PORT": port,
               "WORLD_SIZE": str(world), "RANK": str(r),
               "LOCAL_RANK": str(r), "LOCAL_WORLD_SIZE": str(world)}
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(REPO, "run_nerf_torch.py"),
             *argv], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return logs


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    basedir = tmp_path_factory.mktemp("scene")
    make_synthetic_scene(str(basedir))
    return str(basedir)


def _flags(scene, logdir, expname, **over):
    return {"datadir": scene, "basedir": str(logdir), "expname": expname,
            "device": "cpu", **BASE, **over}


def _render_only(scene, logdir, expname, world, **over):
    """``--render_only --render_test`` of the run's newest checkpoint by
    ``world`` processes; returns the depths it wrote."""
    argv = _argv(_flags(scene, logdir, expname, **over)) + [
        "--render_only", "--render_test"]
    if world == 1:
        tcli.main(argv)
    else:
        _launch(argv, world)
    expdir = os.path.join(logdir, expname)
    outs = sorted(d for d in os.listdir(expdir)
                  if d.startswith("renderonly_test_"))
    return np.load(os.path.join(expdir, outs[-1], "disp.npy"))


def test_dp_render_only_matches_one_process(scene, tmp_path):
    """Two ranks render the held-out poses of a checkpoint data-parallel
    through ``cli.main`` (each its shard of every 512 x 2 rays, gathered):
    the depths equal the one-process render's, and only the primary
    wrote."""
    tcli.main(_argv(_flags(scene, tmp_path, "run", N_iters=2)))
    one = _render_only(scene, str(tmp_path), "run", 1)
    two = _render_only(scene, str(tmp_path), "run", 2)
    np.testing.assert_allclose(two, one, rtol=1e-5, atol=1e-6)
    outs = [d for d in os.listdir(tmp_path / "run")
            if d.startswith("renderonly_test_")]
    assert len(outs) == 2


@pytest.mark.slow
def test_two_process_run_matches_one_process(scene, tmp_path):
    """The paper's loss ladder (RBK + AWP, the EDI prior, the event loss,
    the learned CRF, the clip) with ``perturb 1`` and sigma noise over 4
    steps by two ranks against one process: the logged loss at every step
    within 1e-4 relative, one ``args.txt`` and one ``test_metrics.txt``
    line, the checkpoint of step 4 rendered by one process equal to the
    data-parallel held-out render of the run."""
    over = dict(FULL, N_iters=4, i_weights=2, perturb=1.0,
                raw_noise_std=1.0)
    tcli.main(_argv(_flags(scene, tmp_path, "one", **over)))
    logs = _launch(_argv(_flags(scene, tmp_path, "two", **over)), 2)
    assert "RANDOM SEED" in logs[0] and "RANDOM SEED" not in logs[1]
    one = _scalars(tmp_path / "one" / "metrics.jsonl")
    two = _scalars(tmp_path / "two" / "metrics.jsonl")
    assert sorted(two) == sorted(one)
    rel = {step: abs(two["train/loss"][step] - v) / abs(v)
           for step, v in one["train/loss"].items()}
    print("per-step relative loss difference, 2 ranks vs 1:", rel)
    assert max(rel.values()) < 1e-4, rel
    with open(tmp_path / "two" / "test_metrics.txt") as f:
        assert len(f.readlines()) == 1
    ckpts = sorted(os.listdir(tmp_path / "two" / "checkpoints"))
    # keyed by the post-update step: after i = 2 and after the last step
    assert ckpts == ["000003.tar", "000004.tar"]
    # the run's own render (PNG) against one process's render of its
    # checkpoint
    dp = _render_only(scene, str(tmp_path), "two", 2, **over)
    single = _render_only(scene, str(tmp_path), "two", 1, **over)
    np.testing.assert_allclose(dp, single, rtol=1e-5, atol=1e-6)


def test_tp_multihost_rejected_before_the_dataset(tmp_path, monkeypatch):
    """``--tp_model_parallel`` across hosts is refused as in the JAX
    package, before the dataset (which does not exist here) is read: with
    ``--multihost``, and for a process group that spans hosts."""
    args = dict(basedir=str(tmp_path), expname="tpmh", device="cpu",
                datadir=str(tmp_path / "nonexistent"), tp_model_parallel=2)
    with pytest.raises(NotImplementedError, match="tp_model_parallel"):
        tloop.train(tconfig.default_args(multihost=True, **args))
    monkeypatch.setattr(multihost, "spans_hosts", lambda: True)
    with pytest.raises(NotImplementedError, match="tp_model_parallel"):
        tloop.train(tconfig.default_args(**args))
    # one process cannot hold a slice of two
    monkeypatch.setattr(multihost, "spans_hosts", lambda: False)
    with pytest.raises(ValueError, match="needs 2 processes"):
        tloop.train(tconfig.default_args(**args))


def test_singleprocess_helpers_degenerate(monkeypatch):
    """Without a process group every helper is the plain path."""
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert multihost.is_primary() and not multihost.is_multiprocess()
    assert not multihost.spans_hosts()
    assert not multihost.wants_process_group()
    assert multihost.wants_process_group(multihost=True)
    multihost.barrier()
    assert multihost.local_device("cuda") == torch.device("cuda", 0)
    assert multihost.local_device("cuda:3") == torch.device("cuda", 3)
    monkeypatch.setenv("LOCAL_RANK", "2")
    assert multihost.local_device("cuda") == torch.device("cuda", 2)
    assert multihost.local_device("cpu") == torch.device("cpu")
    assert multihost.backend_for("cpu") == "gloo"
    assert multihost.backend_for("cuda") == "nccl"

    layout = mesh.create_layout()
    assert layout == mesh.Layout() and layout.world == 1
    batch = {"rays": np.arange(48, dtype=np.float32).reshape(16, 3)}
    assert mesh.shard_batch(batch, layout, accum=2) is batch
    with mesh.ray_shard(layout):
        a = mesh.draw(torch.rand, (4, 3), torch.Generator().manual_seed(1),
                      "cpu")
    np.testing.assert_array_equal(
        a, torch.rand((4, 3), generator=torch.Generator().manual_seed(1)))
    bn = torch.nn.BatchNorm1d(3)
    x = torch.randn(8, 3, generator=torch.Generator().manual_seed(2))
    with mesh.ray_shard(layout):
        y = mesh.batch_norm(bn, x)
    np.testing.assert_array_equal(y.detach(), torch.nn.BatchNorm1d(3)(x)
                                  .detach())
    x = torch.ones(3, requires_grad=True)
    assert mesh.all_reduce(x, None, True) is x
    assert mesh.shared_input(x, None) is x
    p = torch.nn.Parameter(torch.ones(2))
    p.grad = torch.full((2,), 3.0)
    mesh.all_reduce_gradients([p], layout)
    assert p.grad.tolist() == [3.0, 3.0]
    vals = {"loss": torch.tensor(2.0)}
    assert mesh.mean_scalars(vals, layout) is vals
    rows = torch.zeros(2, 5, 4)
    assert mesh.gather_rows(rows, layout) is rows
    assert mesh.shard_total(layout) is None
    assert mesh.pad_to_multiple(10, 4) == 12


def test_batch_rounding_keeps_microbatch_divisible():
    """The rounding quantum is n_dev * grad_accum, as in the JAX loop
    (``tests/test_parallel.py::test_batch_rounding_keeps_microbatch_
    divisible``)."""
    n = tloop._round_to_devices(1032, 8, "N_rand", grad_accum=2)
    assert n % (8 * 2) == 0 and (n // 2) % 8 == 0 and n == 1024
    assert tloop._round_to_devices(1024, 8, "N_rand", grad_accum=2) == 1024
    assert tloop._round_to_devices(3, 8, "N_rand", grad_accum=2) == 16
