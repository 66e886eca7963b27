"""The port's LPIPS (``evdeblurnerf_torch/models/lpips.py``) and its use in
the metrics, against the JAX package's ``evdeblurnerf_tpu/models/lpips.py``
on the same weights and images.

Bounds: rtol 1e-4, atol 1e-6 on distances, the bound of
tests/test_lpips.py:58-68, and the JAX package's golden value of the
default scorer (tests/test_lpips.py:82-95) within rtol 1e-4.
"""

import filecmp
import os

import numpy as np
import pytest
import torch

from evdeblurnerf_torch.models import lpips as tlpips
from evdeblurnerf_torch.utils import metrics as tmetrics
from evdeblurnerf_tpu.models import lpips as jlpips
from evdeblurnerf_tpu.utils import metrics as jmetrics

GOLDEN_DEFAULT_DISTANCE = 0.158411905169487   # tests/test_lpips.py


def _heads(rng):
    return {f"lin{i}_w": rng.uniform(0, 0.1, (1, tlpips._ALEX[i][0], 1, 1))
            .astype(np.float32) for i in range(5)}


@pytest.mark.parametrize("shape", [(2, 3, 67, 73), (1, 3, 31, 40)])
def test_distance_matches_jax(shape):
    """One trunk and one set of heads in both packages; odd sizes stress
    the stride-4 convolution and the pools."""
    rng = np.random.default_rng(3)
    weights = tlpips.default_trunk(seed=1)
    weights.update(_heads(rng))
    im1 = rng.uniform(-1, 1, shape).astype(np.float32)
    im2 = rng.uniform(-1, 1, shape).astype(np.float32)
    want = np.asarray(jlpips.lpips_distance(weights, im1, im2))
    got = tlpips.lpips_distance(
        {k: torch.from_numpy(v) for k, v in weights.items()},
        torch.from_numpy(im1), torch.from_numpy(im2)).numpy()
    assert got.shape == (shape[0],) and (got > 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_default_trunk_draws_as_jax():
    for seed in (0, 1):
        want = jlpips.default_trunk(seed)
        got = tlpips.default_trunk(seed)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_vendored_heads_are_the_jax_packages_bytes():
    assert filecmp.cmp(tlpips._VENDORED_LIN, jlpips._VENDORED_LIN,
                       shallow=False)


def test_default_scorer_golden_value_and_identity():
    scorer = tlpips.LPIPSScorer.from_default()
    assert scorer.pretrained_trunk is False
    h = np.linspace(0, 1, 64, dtype=np.float32)
    im1 = np.stack(np.broadcast_arrays(h[:, None], h[None, :],
                                       h[:, None] * h[None, :]), -1)
    im2 = im1[::-1].copy()
    d = scorer(im1 * 2 - 1, im2 * 2 - 1)
    np.testing.assert_allclose(d, GOLDEN_DEFAULT_DISTANCE, rtol=1e-4)
    im = np.random.default_rng(5).uniform(-1, 1, (48, 48, 3)).astype(
        np.float32)
    assert abs(scorer(im, im)) < 1e-6


def test_fallback_warns_once(monkeypatch):
    monkeypatch.setattr(tlpips.LPIPSScorer, "_warned", False)
    monkeypatch.delenv("EVDEBLURNERF_LPIPS_WEIGHTS", raising=False)
    with pytest.warns(UserWarning, match="NOT comparable"):
        tlpips.LPIPSScorer.from_default()
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tlpips.LPIPSScorer.from_default()


def test_img_metric_and_trunk_kind_match_jax():
    """``compute_img_metric("lpips")`` gives the JAX package's number on
    images of 31 pixels and more, None on smaller ones, as there."""
    rng = np.random.default_rng(2)
    a = rng.uniform(0, 1, (2, 40, 52, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    got = tmetrics.compute_img_metric(a, b, "lpips")
    want = jmetrics.compute_img_metric(a, b, "lpips")
    assert got is not None and got > 0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    assert tmetrics.compute_img_metric(a[:, :24], b[:, :24], "lpips") is None
    assert tmetrics.lpips_trunk_kind() == jmetrics.lpips_trunk_kind() \
        == "fallback"


def test_env_bundle_and_conversion(tmp_path, monkeypatch):
    """A torchvision-layout AlexNet checkpoint converts to the same bundle
    in both packages; named by ``EVDEBLURNERF_LPIPS_WEIGHTS`` it is the
    scorer's trunk, reported as pretrained."""
    g = torch.Generator().manual_seed(0)
    alex, in_ch = {}, 3
    for cid, (out_ch, k, _, _) in zip([0, 3, 6, 8, 10], tlpips._ALEX):
        alex[f"features.{cid}.weight"] = 0.05 * torch.randn(
            out_ch, in_ch, k, k, generator=g)
        alex[f"features.{cid}.bias"] = 0.01 * torch.randn(out_ch, generator=g)
        in_ch = out_ch
    pth = str(tmp_path / "alexnet-owt-00000000.pth")
    torch.save(alex, pth)
    tlpips.convert_torch_weights(pth, None, str(tmp_path / "t.npz"))
    jlpips.convert_torch_weights(pth, None, str(tmp_path / "j.npz"))
    t, j = np.load(tmp_path / "t.npz"), np.load(tmp_path / "j.npz")
    assert sorted(t.files) == sorted(j.files)
    for k in t.files:
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)

    monkeypatch.setenv("EVDEBLURNERF_LPIPS_WEIGHTS", str(tmp_path / "t.npz"))
    scorer = tlpips.LPIPSScorer.from_default()
    assert scorer.pretrained_trunk is True
    jscorer = jlpips.LPIPSScorer.from_default()
    rng = np.random.default_rng(4)
    im1, im2 = rng.uniform(-1, 1, (2, 45, 50, 3)).astype(np.float32)
    np.testing.assert_allclose(scorer(im1, im2), jscorer(im1, im2),
                               rtol=1e-4, atol=1e-6)
    # a torch-hub cache holds no file of the standard name here
    monkeypatch.setenv("TORCH_HOME", str(tmp_path / "hub_home"))
    assert tlpips.LPIPSScorer.from_torch_cache() is None
    assert os.path.exists(tlpips._VENDORED_LIN)
