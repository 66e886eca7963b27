"""LPIPS (v0.1, AlexNet trunk) in PyTorch.

Counterpart of ``evdeblurnerf_tpu/models/lpips.py`` (ref:
networks/lpips/lpips.py:140, networks/lpips/pretrained_networks.py):
AlexNet feature taps -> channel-unit normalisation -> learned 1x1 linear
heads -> spatial mean -> sum. LPIPS is an evaluation metric, not a kernel
of the training or serving path, so it runs on library convolutions
(``F.conv2d`` / ``F.max_pool2d``). The learned v0.1 heads are the port's
own copy of the vendored file (``lpips_weights/alex_lin_v0.1.npz``); the
ImageNet AlexNet trunk is not in the repository, so
:meth:`LPIPSScorer.from_default` falls back to the deterministic
fixed-seed trunk of :func:`default_trunk` (the same draws as the JAX
package's, so both score alike) and warns once.

npz keys: ``conv{i}_w`` [out, in, kh, kw], ``conv{i}_b`` for the five
AlexNet convolutions, ``lin{i}_w`` [1, C_i, 1, 1] for the heads.
:func:`convert_torch_weights` builds the npz from torchvision's
``alexnet-*.pth`` plus an LPIPS ``alex.pth`` head file.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

# input normalisation (LPIPS ScalingLayer constants)
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

# AlexNet conv trunk: (out, kernel, stride, pad), max-pool after layers 0, 1
_ALEX = [(64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1),
         (256, 3, 1, 1), (256, 3, 1, 1)]
_POOL_AFTER = {0, 1}

_VENDORED_LIN = os.path.join(os.path.dirname(__file__), "lpips_weights",
                             "alex_lin_v0.1.npz")
_FULL_BUNDLE = os.path.join(os.path.dirname(__file__), "lpips_weights",
                            "alex_full.npz")


def _normalize_tensor(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return x / (torch.sqrt(torch.sum(x * x, 1, keepdim=True)) + eps)


def lpips_distance(weights: dict, im1: torch.Tensor,
                   im2: torch.Tensor) -> torch.Tensor:
    """im1/im2: [B, 3, H, W] in [-1, 1]; ``weights`` tensors on their
    device. Returns the [B] distances."""
    shift = torch.as_tensor(_SHIFT, device=im1.device).view(1, 3, 1, 1)
    scale = torch.as_tensor(_SCALE, device=im1.device).view(1, 3, 1, 1)

    def taps(x):
        h = (x - shift) / scale
        outs = []
        for i, (_, _, stride, pad) in enumerate(_ALEX):
            h = torch.relu(F.conv2d(h, weights[f"conv{i}_w"],
                                    weights[f"conv{i}_b"], stride=stride,
                                    padding=pad))
            outs.append(h)
            if i in _POOL_AFTER:
                h = F.max_pool2d(h, kernel_size=3, stride=2)
        return outs

    f1, f2 = taps(im1), taps(im2)
    total = torch.zeros(im1.shape[0], device=im1.device)
    for i in range(len(_ALEX)):
        d = (_normalize_tensor(f1[i]) - _normalize_tensor(f2[i])) ** 2
        lin = weights[f"lin{i}_w"].reshape(1, -1, 1, 1)
        total = total + torch.mean(torch.sum(d * lin, 1), (1, 2))
    return total


def default_trunk(seed: int = 0) -> dict:
    """Deterministic He-initialised AlexNet trunk weights, drawn from
    ``np.random.default_rng(seed)`` in the JAX package's order. The
    ImageNet trunk the reference downloads through torchvision (ref:
    networks/lpips/pretrained_networks.py:47-56) is not in the repository;
    LPIPS over fixed random conv features is reproducible, but its values
    are NOT comparable to published LPIPS(alex) numbers. An ImageNet
    bundle at ``lpips_weights/alex_full.npz``, or named by
    ``EVDEBLURNERF_LPIPS_WEIGHTS`` (built with
    :func:`convert_torch_weights`), restores published semantics."""
    rng = np.random.default_rng(seed)
    out = {}
    in_ch = 3
    for i, (out_ch, k, _, _) in enumerate(_ALEX):
        std = np.sqrt(2.0 / (in_ch * k * k))
        out[f"conv{i}_w"] = rng.normal(
            0.0, std, (out_ch, in_ch, k, k)).astype(np.float32)
        out[f"conv{i}_b"] = np.zeros((out_ch,), np.float32)
        in_ch = out_ch
    return out


class LPIPSScorer:
    """An LPIPS distance with its weights on ``device``; call it on two
    [H, W, 3] images in [-1, 1]."""

    _warned = False

    def __init__(self, weights: dict, pretrained_trunk: bool = True,
                 device="cpu"):
        self.device = torch.device(device)
        self.weights = {k: torch.as_tensor(np.asarray(v, np.float32),
                                           device=self.device)
                        for k, v in weights.items()}
        self.pretrained_trunk = pretrained_trunk

    @classmethod
    def from_npz(cls, path: str, device="cpu") -> "LPIPSScorer":
        with np.load(path) as f:
            return cls(dict(f), device=device)

    @classmethod
    def from_env(cls, device="cpu") -> Optional["LPIPSScorer"]:
        path = os.environ.get("EVDEBLURNERF_LPIPS_WEIGHTS")
        if path and os.path.exists(path):
            return cls.from_npz(path, device)
        return None

    @classmethod
    def from_torch_cache(cls, device="cpu") -> Optional["LPIPSScorer"]:
        """Probe the torch-hub cache for an ImageNet AlexNet checkpoint
        (``alexnet-owt-<sha8>.pth``), verify its filename's SHA-256 prefix,
        and convert it (with the vendored heads, or the torch-format head
        file named by ``EVDEBLURNERF_LPIPS_LIN_PTH``) into the full
        bundle."""
        import glob
        import hashlib
        import re
        import warnings

        hub = os.environ.get(
            "TORCH_HOME", os.path.join(os.path.expanduser("~"), ".cache",
                                       "torch"))
        for cand in sorted(glob.glob(os.path.join(
                hub, "hub", "checkpoints", "alexnet-owt-*.pth"))):
            m = re.search(r"alexnet-owt-([0-9a-f]{8})\.pth$",
                          os.path.basename(cand))
            if not m:
                warnings.warn(
                    f"torch-hub cache file {cand} lacks the standard "
                    "sha256-prefix filename; skipping it")
                continue
            h = hashlib.sha256()
            with open(cand, "rb") as f:
                for chunk in iter(lambda: f.read(1 << 20), b""):
                    h.update(chunk)
            if not h.hexdigest().startswith(m.group(1)):
                warnings.warn(f"torch-hub AlexNet at {cand} fails its "
                              "filename sha256 prefix; ignoring it")
                continue
            lin = os.environ.get("EVDEBLURNERF_LPIPS_LIN_PTH") or None
            if lin is not None and not os.path.exists(lin):
                lin = None
            try:
                convert_torch_weights(cand, lin, _FULL_BUNDLE)
                return cls.from_npz(_FULL_BUNDLE, device)
            except Exception as exc:    # a bad file must not stop the next
                warnings.warn(f"found a torch-hub AlexNet at {cand} but "
                              f"converting it failed ({exc}); trying the "
                              "next candidate")
        return None

    @classmethod
    def from_default(cls, device="cpu") -> "LPIPSScorer":
        """Always usable: the ``EVDEBLURNERF_LPIPS_WEIGHTS`` bundle, else the
        package's full bundle, else a torch-hub AlexNet converted, else the
        deterministic trunk with the vendored heads (warned once)."""
        scorer = cls.from_env(device)
        if scorer is not None:
            return scorer
        if os.path.exists(_FULL_BUNDLE):
            return cls.from_npz(_FULL_BUNDLE, device)
        scorer = cls.from_torch_cache(device)
        if scorer is not None:
            return scorer
        weights = default_trunk()
        with np.load(_VENDORED_LIN) as f:
            weights.update(dict(f))
        if not cls._warned:
            cls._warned = True
            import warnings

            warnings.warn(
                "LPIPS: no ImageNet AlexNet trunk available; using a "
                "deterministic fixed-seed trunk with the vendored LPIPS v0.1 "
                "lin heads. Distances are reproducible but NOT comparable to "
                "published LPIPS(alex) numbers. See "
                "evdeblurnerf_torch/models/lpips.py:default_trunk.",
                stacklevel=2)
        return cls(weights, pretrained_trunk=False, device=device)

    @torch.no_grad()
    def __call__(self, im1, im2) -> float:
        """im1/im2: [H, W, 3] in [-1, 1] (numpy or tensors)."""
        def nchw(im):
            return torch.as_tensor(np.asarray(im, np.float32)).permute(
                2, 0, 1)[None].to(self.device)

        return float(lpips_distance(self.weights, nchw(im1), nchw(im2))[0])


def convert_torch_weights(alexnet_pth: str, lin_pth: Optional[str],
                          out_npz: str) -> None:
    """Build the npz bundle from torchvision's AlexNet checkpoint and an
    LPIPS head file (``lin_pth``, torch format, e.g. the reference's
    ``networks/lpips/weights/v0.1/alex.pth``), or the vendored heads when
    ``lin_pth`` is None."""
    alex = torch.load(alexnet_pth, map_location="cpu")
    out = {}
    for i, cid in enumerate([0, 3, 6, 8, 10]):   # alexnet.features indices
        out[f"conv{i}_w"] = alex[f"features.{cid}.weight"].numpy()
        out[f"conv{i}_b"] = alex[f"features.{cid}.bias"].numpy()
    if lin_pth is None:
        with np.load(_VENDORED_LIN) as f:
            out.update(dict(f))
    else:
        lin = torch.load(lin_pth, map_location="cpu")
        for i in range(5):
            out[f"lin{i}_w"] = lin[f"lin{i}.model.1.weight"].numpy()
    np.savez(out_npz, **out)
