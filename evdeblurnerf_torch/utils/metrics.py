"""Image metrics: MSE / PSNR / SSIM / LPIPS.

Counterpart of ``evdeblurnerf_tpu/utils/metrics.py`` (ref:
utils/metrics.py:18-100): inputs in [0, 1] are mapped to [-1, 1], an
optional relative ``margin`` crops borders, masks restrict PSNR/SSIM to
valid pixels. SSIM follows skimage with ``data_range=2.0`` (the [-1, 1]
range older skimage assumed implicitly for float inputs). LPIPS runs through
``models/lpips.py``'s default scorer on the device it is asked for (the
CPU unless the caller names the run's device, as the training loop does);
``None`` means "metric unavailable" (no scorer could be built, or an image
under 31 pixels).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

img2mse = lambda x, y: np.mean((np.asarray(x) - np.asarray(y)) ** 2)  # noqa: E731
mse2psnr = lambda x: -10.0 * np.log10(np.maximum(x, 1e-10))           # noqa: E731


def structural_similarity(im1: np.ndarray, im2: np.ndarray,
                          data_range: float = 2.0, win_size: int = 7,
                          K1: float = 0.01, K2: float = 0.03):
    """SSIM (Wang et al. 2004) with skimage's defaults — uniform ``win_size``
    filter, sample covariance normalization — so values match the reference's
    ``skimage.metrics.structural_similarity`` call (this image does not ship
    skimage). Channels are averaged as skimage's multichannel mode does.

    im1/im2: [H, W, C] or [H, W]. Returns (mean_ssim, ssim_map).
    """
    from scipy.ndimage import uniform_filter

    im1 = np.asarray(im1, np.float64)
    im2 = np.asarray(im2, np.float64)
    if im1.ndim == 3:
        per_channel = [structural_similarity(im1[..., c], im2[..., c],
                                             data_range, win_size, K1, K2)
                       for c in range(im1.shape[-1])]
        mean = float(np.mean([m for m, _ in per_channel]))
        return mean, np.stack([m for _, m in per_channel], -1)

    NP = win_size ** im1.ndim
    cov_norm = NP / (NP - 1)
    filt = lambda x: uniform_filter(x, size=win_size)   # noqa: E731
    ux, uy = filt(im1), filt(im2)
    uxx, uyy, uxy = filt(im1 * im1), filt(im2 * im2), filt(im1 * im2)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    C1 = (K1 * data_range) ** 2
    C2 = (K2 * data_range) ** 2
    A1, A2 = 2 * ux * uy + C1, 2 * vxy + C2
    B1, B2 = ux ** 2 + uy ** 2 + C1, vx + vy + C2
    S = (A1 * A2) / (B1 * B2)

    # skimage crops the filter-invalid border from the mean
    pad = (win_size - 1) // 2
    interior = S[pad:-pad, pad:-pad] if pad else S
    return float(interior.mean()), S


# the default scorer of each device (its str()), None where building failed
_lpips_scorers: dict = {}


def _get_lpips(device="cpu"):
    key = str(device)
    if key not in _lpips_scorers:
        try:
            from ..models.lpips import LPIPSScorer

            # always usable: an ImageNet bundle, else the documented
            # deterministic-trunk fallback (warns once)
            _lpips_scorers[key] = LPIPSScorer.from_default(device)
        except Exception:
            _lpips_scorers[key] = None
    return _lpips_scorers[key]


def lpips_trunk_kind(device="cpu") -> Optional[str]:
    """Which AlexNet trunk the LPIPS scorer runs on: ``"pretrained"``
    (ImageNet weights, published-comparable LPIPS(alex)), ``"fallback"``
    (the deterministic fixed-seed trunk: self-consistent, NOT comparable to
    published numbers) or ``None`` (no scorer). Whoever persists lpips
    values records this beside them."""
    scorer = _get_lpips(device)
    if scorer is None:
        return None
    return "pretrained" if scorer.pretrained_trunk else "fallback"


def compute_img_metric(im1, im2, metric: str = "mse", margin: float = 0,
                       mask: Optional[np.ndarray] = None, device="cpu"):
    """im1/im2: [H, W, 3] or [B, H, W, 3] in [0, 1]. Returns a python float
    (averaged over the batch), or None for lpips without a scorer or on
    images under 31 pixels. ``device``: where LPIPS's AlexNet runs."""
    im1 = np.asarray(im1, np.float32)
    im2 = np.asarray(im2, np.float32)
    if im1.ndim == 3:
        im1, im2 = im1[None], im2[None]
        if mask is not None and mask.ndim == 3:
            mask = mask[None]
    im1 = np.clip(im1 * 2 - 1, -1, 1)
    im2 = np.clip(im2 * 2 - 1, -1, 1)

    b, h, w, _ = im1.shape
    if margin > 0:
        mh, mw = int(h * margin) + 1, int(w * margin) + 1
        im1 = im1[:, mh:h - mh, mw:w - mw]
        im2 = im2[:, mh:h - mh, mw:w - mw]
        if mask is not None:
            mask = mask[:, mh:h - mh, mw:w - mw]
    if mask is not None and mask.ndim == 3:
        mask = mask[..., None]
    if mask is not None and mask.shape[-1] == 1:
        mask = np.broadcast_to(mask, mask.shape[:-1] + (3,))

    values = []
    for i in range(b):
        a, c = im1[i], im2[i]
        if metric in ("mse", "psnr"):
            if mask is not None:
                a = a * mask[i]
                c = c * mask[i]
            mse = np.mean((a - c) ** 2)
            if metric == "mse":
                v = mse
            else:
                v = 10 * np.log10(4.0 / mse)   # peak-signal for range 2
                if mask is not None:
                    hei, wid, _ = a.shape
                    v = v - 10 * np.log10(hei * wid / mask[i, ..., 0].sum())
        elif metric == "ssim":
            v, ssim_map = structural_similarity(a, c, data_range=2.0)
            if mask is not None:
                v = (ssim_map * mask[i]).sum() / mask[i].sum()
        elif metric == "lpips":
            scorer = _get_lpips(device)
            if scorer is None:
                return None
            if min(a.shape[0], a.shape[1]) < 31:
                # AlexNet's stride chain leaves the fifth tap empty below
                # 31 px and the distance NaN (so does the reference's,
                # networks/lpips/lpips.py:118-134)
                return None
            v = scorer(a, c)
        else:
            raise RuntimeError(f"metric {metric} not recognized")
        values.append(float(v))
    return sum(values) / len(values)
