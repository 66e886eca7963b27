"""The port's held-out-quality tools: the numpy writer of the validation
scene (``tools/synthetic_scene_torch.py::write_synthetic_scene``), the
validation run's flags (``tools/validate_train_torch.py``), the metrics
table (``tools/compare_metrics_torch.py``) and, marked slow, the port's
loop against the JAX loop on the validation scene at the matched small
profile.

The writer is held to ``tests/synthetic.py::make_synthetic_scene``
through the datasets, bitwise: the same images after 8-bit rounding, the
same event arrays.
"""

import os
import sys

import numpy as np
import pytest

from evdeblurnerf_torch.data import LLFFDataset, LLFFEventsDataset
from evdeblurnerf_torch import config as tconfig
from synthetic import make_synthetic_scene

TOOLS = os.path.join(os.path.dirname(__file__), "..", "tools")
sys.path.insert(0, TOOLS)
import compare_metrics  # noqa: E402
import collapse_rate_torch as crt  # noqa: E402
import compare_metrics_torch as cmt  # noqa: E402
import synthetic_scene_torch as sst  # noqa: E402
import validate_train  # noqa: E402
import validate_train_torch as vtt  # noqa: E402


def _datasets(scene, llff_cls, events_cls):
    args = tconfig.default_args(datadir=scene, factor=1, llffhold=6,
                                use_events=True, events_tms_unit="us",
                                events_tms_files_unit="us")
    llff = llff_cls(args, scene, 1)
    ev = events_cls(args, scene, llff.h, llff.w, llff.K, 1,
                    bd_scale=llff.scale, closest_bds=llff.closest_bds,
                    furthest_bds=llff.furthest_bds,
                    recenter_partial=llff.recenter_partial,
                    spherify_partial=llff.spherify_partial,
                    events_tms_unit="us", events_tms_files_unit="us")
    return llff, ev


@pytest.mark.parametrize("geometry,rectified", [
    ("sphere", False), ("boxes", False), ("sphere", True)])
def test_scene_writer_loads_as_make_synthetic_scene(tmp_path, geometry,
                                                    rectified):
    """At 24 x 32: what the port's datasets load from the numpy scene
    equals what they load from ``make_synthetic_scene``'s PNG and HDF5
    files (images, poses, bounds, and every array of the event set)."""
    a, b = str(tmp_path / "png_h5"), str(tmp_path / "npz")
    make_synthetic_scene(a, h=24, w=32, focal=32.0, seed=0,
                         geometry=geometry, rectified_coords=rectified)
    n = sst.write_synthetic_scene(b, h=24, w=32, geometry=geometry,
                                  rectified_coords=rectified)
    assert n > 100
    la, ea = _datasets(a, LLFFDataset, LLFFEventsDataset)
    lb, eb = _datasets(b, *sst.scene_classes())
    np.testing.assert_array_equal(la.images, lb.images)
    for name in ("poses", "bds", "test_poses", "render_poses"):
        if hasattr(la, name):
            np.testing.assert_array_equal(getattr(la, name),
                                          getattr(lb, name), err_msg=name)
    arrays = [k for k, v in vars(ea).items() if isinstance(v, np.ndarray)]
    assert "events" in arrays or len(arrays) > 3
    for k in arrays:
        np.testing.assert_array_equal(getattr(ea, k), getattr(eb, k),
                                      err_msg=k)
    assert len(ea) == len(eb)


@pytest.mark.parametrize("kernel,cdavis", [
    ("rbk", False), ("dsk", False), ("pbe", False), ("none", False),
    ("rbk", True)])
def test_validation_flags_are_the_jax_tools(kernel, cdavis):
    """``make_cli`` gives the JAX tool's flag list, word for word; the
    small profile adds exactly the matched profile's values."""
    import argparse

    ns = argparse.Namespace(logdir="L", scene="S", kernel=kernel,
                            cdavis=cdavis)
    assert vtt.make_cli(ns, 1000) == validate_train.make_cli(ns, 1000)
    args = tconfig.parse_args(vtt.make_cli(ns, 1000) + vtt.SMALL_PROFILE)
    assert (args.N_rand, args.N_samples, args.N_importance,
            args.coarse_n_voxels, args.fine_n_voxels, args.events_N_rand) \
        == (128, 32, 32, 64 ** 3, 128 ** 3, 256)


def test_validation_tool_runs_and_starts_from_a_given_state(tmp_path,
                                                            capsys):
    """Two iterations of the tool on the CPU at a small size: it writes the
    scene, draws the initial state with the CPU generator, resumes from it,
    writes LPIPS with its trunk, and a second run from that state as
    ``--init_checkpoint`` logs the same losses."""
    import json

    small = ["--device", "cpu", "--N_rand", "16", "--events_N_rand", "16",
             "--N_samples", "4", "--N_importance", "4",
             "--coarse_n_voxels", "4096", "--fine_n_voxels", "8192",
             "--tone_mapping_events_type", "none", "--i_print", "1"]
    common = ["--iters", "2", "--profile", "small", "--h", "32", "--w", "40",
              "--scene", str(tmp_path / "scene"), "--logdir", str(tmp_path)]
    vtt.main(common + ["--expname", "a", "--init_device", "cpu"] + small)
    first = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    first_state = tmp_path / "a" / "checkpoints" / "000000.tar"
    assert first["init_device"] == "cpu" and first_state.exists()
    assert first["test"]["1"]["lpips_trunk"] == "fallback"
    assert first["checkpoint"].endswith("000002.tar")
    vtt.main(common + ["--expname", "b", "--init_checkpoint",
                       str(first_state)] + small)
    capsys.readouterr()

    def losses(run):
        with open(tmp_path / run / "metrics.jsonl") as f:
            return [r["value"] for r in map(json.loads, f)
                    if r.get("tag") == "train/loss"]

    assert len(losses("a")) == 2 and losses("a") == losses("b")


# ---------------------------------------------------------------------------
# the metrics table and its three repairs
# ---------------------------------------------------------------------------

def _run(tmp_path, name, text):
    d = tmp_path / name
    d.mkdir()
    (d / "test_metrics.txt").write_text(text)
    return str(d)


FULL = ("iter 500: mse=0.01000 psnr=25.00000 ssim=0.80000 lpips=0.05000 "
        "lpips_trunk=fallback\n"
        "iter 999: mse=0.00500 psnr=28.00000 ssim=0.90000 lpips=0.03000 "
        "lpips_trunk=fallback\n")


def test_compare_metrics_reads_as_the_original(tmp_path, capsys):
    a = _run(tmp_path, "a", FULL)
    b = _run(tmp_path, "b", FULL.replace("28.00000", "28.50000"))
    assert cmt.load(a) == compare_metrics.load(a)
    assert cmt.load(a, keep_words=True)[999]["lpips_trunk"] == "fallback"
    assert cmt.main([a, b]) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 3 and out[2].split()[-2] == "+0.500"


def test_compare_metrics_without_lpips(tmp_path, capsys):
    """The original raises KeyError where a run wrote no lpips; the copy
    prints n/a."""
    a = _run(tmp_path, "a", FULL)
    b = _run(tmp_path, "b", "iter 999: mse=0.00500 psnr=28.10000 "
                            "ssim=0.90000\n")
    with pytest.raises(KeyError):
        ra, rb = compare_metrics.load(a)[999], compare_metrics.load(b)[999]
        f"{ra['lpips']} {rb['lpips']}"
    assert cmt.main([a, b]) == 0
    row = capsys.readouterr().out.splitlines()[1]
    assert "n/a" in row and row.split()[-2] == "+0.100"


def test_compare_metrics_keeps_nan(tmp_path, capsys):
    """The original's number pattern drops ``nan`` without a word; the copy
    reads it and warns."""
    a = _run(tmp_path, "a", FULL)
    b = _run(tmp_path, "b", FULL.replace("psnr=28.00000", "psnr=nan"))
    assert "psnr" not in compare_metrics.load(b)[999]
    assert np.isnan(cmt.load(b)[999]["psnr"])
    assert cmt.main([a, b]) == 0
    captured = capsys.readouterr()
    assert "nan" in captured.out.splitlines()[2]
    assert "logged nan" in captured.err


def test_compare_metrics_missing_file_and_no_shared_iterations(tmp_path,
                                                              capsys):
    a = _run(tmp_path, "a", FULL)
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError, match="test_metrics.txt"):
        cmt.load(str(empty))
    assert cmt.main([a, str(empty)]) == 2
    assert "no test_metrics.txt" in capsys.readouterr().err
    c = _run(tmp_path, "c", "iter 250: mse=0.01 psnr=20.0 ssim=0.7\n")
    assert cmt.main([a, c]) == 1
    captured = capsys.readouterr()
    assert "share no held-out iteration" in captured.err and not captured.out


@pytest.mark.parametrize("a_hit,a_n,b_hit,b_n", [
    (5, 12, 3, 12), (7, 16, 3, 14), (0, 6, 6, 6), (12, 12, 0, 12),
    (1, 8, 5, 6), (0, 4, 0, 4), (3, 10, 3, 10)])
def test_fisher_exact_matches_scipy(a_hit, a_n, b_hit, b_n):
    from scipy.stats import fisher_exact

    want = fisher_exact([[a_hit, a_n - a_hit], [b_hit, b_n - b_hit]]).pvalue
    assert crt.fisher_exact_two_sided(a_hit, a_n, b_hit,
                                      b_n) == pytest.approx(want, rel=1e-9)


def test_collapse_rate_classifies_runs(tmp_path, capsys):
    """Each run's PSNR at the first held-out row at or past ``at - 1``
    (499 of a 500-iteration run, 500 of a 1000-iteration one), a collapse
    below the threshold, the two counts and Fisher's p in the JSON line."""
    import json

    rows = {"p0": [(499, 15.4)], "p1": [(499, 24.8)],
            "j0": [(250, 10.0), (500, 26.5), (999, 30.4)],
            "j1": [(500, 19.99), (999, 14.0)]}
    for name, its in rows.items():
        os.makedirs(tmp_path / name)
        (tmp_path / name / "test_metrics.txt").write_text("".join(
            f"iter {it}: mse=0.1 psnr={p} ssim=0.9 lpips=0.01 "
            "lpips_trunk=fallback\n" for it, p in its))
    crt.main(["--a", str(tmp_path / "p0"), str(tmp_path / "p1"),
              "--b", str(tmp_path / "j0"), str(tmp_path / "j1")])
    out = capsys.readouterr().out.splitlines()
    assert out[0].endswith("collapsed") and not out[1].endswith("collapsed")
    assert "iter 500" in out[2] and out[3].endswith("collapsed")
    got = json.loads(out[-1])
    assert (got["a_collapsed"], got["b_collapsed"]) == (1, 1)
    assert got["fisher_p_two_sided"] == pytest.approx(1.0)
    with pytest.raises(SystemExit, match="no held-out row"):
        crt.psnr_at(str(tmp_path / "p0"), 1000)


# ---------------------------------------------------------------------------
# the two loops on the validation scene (slow: minutes on the CPU)
# ---------------------------------------------------------------------------

def _validation_argv(tmp_path, kernel, seed, steps, every):
    """The validation scene written at ``tmp_path / "scene"`` and the
    run's flags at the matched small profile, exact settings pinned."""
    scene = str(tmp_path / "scene")
    make_synthetic_scene(scene, n_imgs=6, h=96, w=128, focal=128.0,
                         poses_per_image=4, seed=0)
    import argparse

    ns = argparse.Namespace(logdir=str(tmp_path), scene=scene,
                            kernel=kernel, cdavis=False)
    return vtt.make_cli(ns, steps) + vtt.SMALL_PROFILE + [
        "--seed", str(seed), "--i_testset", str(every), "--i_print",
        str(max(1, steps // 10)), "--i_tensorboard", "1",
        "--grad_accum", "1", "--triplane_bf16", "False",
        "--triplane_line_matmul", "False", "--fine_cull_capacity", "0"]


def _jax_initial_checkpoint(argv, path):
    """The JAX loop's initial state for ``argv``, rebuilt as the loop
    builds it and written at ``path`` as a step-0 checkpoint of the
    port."""
    import jax
    import torch

    from evdeblurnerf_torch.utils.convert import train_checkpoint_from_jax
    from evdeblurnerf_tpu import config as jconfig
    from evdeblurnerf_tpu.train import loop as jloop

    jargs = jconfig.resolve_event_thresholds(
        jconfig.parse_args(argv + ["--expname", "jax_init"]))
    llff, _ = jloop.build_datasets(jargs)
    _, _, model, crf = jloop.build_model(jargs, llff)
    state, _ = jloop.build_initial_state(jargs, llff, model, crf)
    state = jax.device_get(state)
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(train_checkpoint_from_jax(as_np(state.params),
                                         as_np(state.batch_stats), step=0),
               path)


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(12))
def test_export_jax_initial_state(tmp_path, seed):
    """The JAX package's RBK+AWP initial state at ``seed`` on the
    validation scene, written as ``jax_init_rbk_seed<seed>.tar`` into
    ``EVDN_VALIDATION_INIT_OUT`` (else ``tmp_path``) without training
    either loop, for ``tools/validate_train_torch.py --init_checkpoint``
    on the card. The checkpoint loads strictly into the port's model."""
    import torch

    from evdeblurnerf_torch.train import loop as tloop

    argv = _validation_argv(tmp_path, "rbk", seed, 500, 500)
    out = os.environ.get("EVDN_VALIDATION_INIT_OUT") or str(tmp_path)
    path = os.path.join(out, f"jax_init_rbk_seed{seed}.tar")
    _jax_initial_checkpoint(argv, path)
    args = tconfig.resolve_event_thresholds(tconfig.parse_args(
        argv + ["--expname", "x", "--device", "cpu"]))
    llff, _ = tloop.build_datasets(args)
    model, crf = tloop.build_model(args, llff, torch.Generator(), "cpu")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(ckpt["network_state_dict"], strict=True)
    assert ckpt["global_step"] == 0


@pytest.mark.slow
@pytest.mark.parametrize("kernel,seed", [("rbk", 0), ("rbk", 1), ("dsk", 0),
                                         ("pbe", 0), ("rbk", 2), ("rbk", 3)])
def test_validation_loop_matches_jax_loop(tmp_path, kernel, seed):
    """The JAX loop and the port's loop on the validation scene at the
    matched small profile (the blur kernel from step 300, RBK with AWP,
    events and the learned event CRF, the gamma rgb CRF), the four runs the
    JAX package recorded and two more seeds, from its own initial state at
    ``seed``, carried
    across as a step-0 checkpoint the port resumes
    from. ``EVDN_VALIDATION_STEPS`` steps (default 50), held-out renders
    every ``EVDN_VALIDATION_TESTSET`` steps (default 25): per-step loss
    within 2e-2 relative, the lockstep bound, and held-out PSNR within
    0.5 dB. Prints both curves. With ``EVDN_VALIDATION_INIT_OUT`` set, the
    JAX initial state is also written there as
    ``jax_init_<kernel>_seed<seed>.tar``."""
    import json

    from evdeblurnerf_torch import cli as tcli
    from evdeblurnerf_tpu import config as jconfig
    from evdeblurnerf_tpu.train import loop as jloop

    steps = int(os.environ.get("EVDN_VALIDATION_STEPS", "50"))
    every = int(os.environ.get("EVDN_VALIDATION_TESTSET", "25"))
    argv = _validation_argv(tmp_path, kernel, seed, steps, every)
    jloop.train(jconfig.parse_args(argv + ["--expname", "jax"]))

    ckdir = tmp_path / "torch" / "checkpoints"
    _jax_initial_checkpoint(argv, str(ckdir / "000000.tar"))
    if os.environ.get("EVDN_VALIDATION_INIT_OUT"):
        # the JAX package's initial state, for a card run of the port
        # (tools/validate_train_torch.py --init_checkpoint)
        import shutil

        out = os.environ["EVDN_VALIDATION_INIT_OUT"]
        os.makedirs(out, exist_ok=True)
        shutil.copyfile(str(ckdir / "000000.tar"),
                        os.path.join(out, f"jax_init_{kernel}_seed{seed}.tar"))
    tcli.main(argv + ["--expname", "torch", "--device", "cpu"])

    def scalars(run):
        out = {}
        with open(tmp_path / run / "metrics.jsonl") as f:
            for line in f:
                rec = json.loads(line)
                if "value" in rec:
                    out.setdefault(rec["tag"], {})[rec["step"]] = rec["value"]
        return out

    want, got = scalars("jax"), scalars("torch")
    rel = [abs(got["train/loss"][s] - want["train/loss"][s])
           / abs(want["train/loss"][s]) for s in range(steps)]
    print(f"{kernel} seed {seed}: largest per-step relative loss difference "
          f"{max(rel):.3e} at step {int(np.argmax(rel))}")
    for s in range(0, steps, max(1, steps // 10)):
        print(f"  step {s}: loss jax {want['train/loss'][s]:.6f} "
              f"port {got['train/loss'][s]:.6f}")
    jm = cmt.load(str(tmp_path / "jax"))
    tm = cmt.load(str(tmp_path / "torch"))
    for it in sorted(jm):
        print(f"  held-out @{it}: psnr jax {jm[it]['psnr']:.3f} port "
              f"{tm[it]['psnr']:.3f}")
    assert sorted(jm) == sorted(tm)
    assert max(rel[:50]) < 2e-2, rel
    for it in jm:
        assert abs(jm[it]["psnr"] - tm[it]["psnr"]) < 0.5, it
