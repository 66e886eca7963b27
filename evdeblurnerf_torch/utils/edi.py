"""Event double integral (EDI) deblurring prior.

Host-side numpy preprocessing run once at dataset build (behavioral parity
with ref: utils/edi.py, pinned by tests/goldens/oracle_host.npz): bilinear-
splat brightness-increment images per sub-exposure interval, then
``sharp = (2N+1) * blurry / sum_i exp(inner_integral_i)``.

Implementation is vectorized over the full event set: the splat stacks all
four bilinear corners into one ``np.add.at``; the inner double integral is
an exclusive cumsum re-centred at its midpoint (the reference's 2N partial
re-sums collapse to ``S - S[N]``).
"""

from __future__ import annotations

import numpy as np


def interpolate_subpixel(x, y, v, w, h, image=None):
    """Bilinear splat of values ``v`` at float coords (x, y) into [h, w]
    (behavior pinned vs ref utils/edi.py:7-41 by the host oracle).

    All four tent corners are splatted in ONE ``np.add.at`` over the
    stacked [4, N] corner arrays (corner-major flattening preserves the
    reference's corner-pass accumulation order bit-for-bit).
    """
    image = image if image is not None else np.zeros((h, w), dtype=np.float32)
    x = np.asarray(x)
    y = np.asarray(y)
    v = np.asarray(v)
    if x.size == 0:
        return image

    xf, xc = np.floor(x), np.ceil(x)
    yf, yc = np.floor(y), np.ceil(y)
    # corner order (xf,yf), (xf,yc), (xc,yf), (xc,yc) — the reference's
    # product((floor, ceil), (floor, ceil)) iteration order
    xs = np.stack([xf, xf, xc, xc])
    ys = np.stack([yf, yc, yf, yc])
    # integer coords contribute once (the floor corner only): a ceil corner
    # is valid only where ceil(x) != x. Out-of-frame high coords drop.
    # NOTE deliberately NO >= 0 check, exactly like the reference
    # (ref utils/edi.py:31-33): slightly negative rectified coords floor to
    # -1 and np.add.at wraps them onto the far edge. The EDI host-oracle
    # parity test pins this — do not "fix" unilaterally.
    ceil_ok_x = xc != x
    ceil_ok_y = yc != y
    true_ = np.ones_like(ceil_ok_x)
    valid = (np.stack([true_, true_, ceil_ok_x, ceil_ok_x])
             & np.stack([true_, ceil_ok_y, true_, ceil_ok_y])
             & (xs < w) & (ys < h))

    # tent weight: 1 - |corner - coord| (non-negative by construction on
    # valid corners; clamp matches the reference's k_b)
    wgt = (np.maximum(0, 1 - np.abs(xs - x)) * np.maximum(0, 1 - np.abs(ys - y))
           * v)
    sel = valid.reshape(-1)
    np.add.at(image,
              (ys.reshape(-1)[sel].astype(np.int64),
               xs.reshape(-1)[sel].astype(np.int64)),
              wgt.reshape(-1)[sel])
    return image


def brightness_increment_image(x, y, p, w, h, c_pos, c_neg, interpolate=True,
                               color_events=False):
    """BII = c_pos * splat(+events) - c_neg * splat(-events)
    (ref: utils/edi.py:44-70). ``color_events`` demosaics the per-polarity
    count images from the Bayer pattern first."""
    assert c_pos is not None and c_neg is not None
    image_pos = np.zeros((h, w), dtype=np.float32)
    image_neg = np.zeros((h, w), dtype=np.float32)
    vals = np.ones([np.asarray(x).shape[0]], dtype=np.float32)

    pos = np.asarray(p) > 0
    neg = ~pos
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)

    if interpolate:
        image_pos = interpolate_subpixel(x[pos], y[pos], vals[pos], w, h,
                                         image_pos)
        image_neg = interpolate_subpixel(x[neg], y[neg], vals[neg], w, h,
                                         image_neg)
    else:
        np.add.at(image_pos, (y[pos].astype(np.int64), x[pos].astype(np.int64)),
                  vals[pos])
        np.add.at(image_neg, (y[neg].astype(np.int64), x[neg].astype(np.int64)),
                  vals[neg])

    if color_events:
        import cv2
        image_pos = cv2.cvtColor(image_pos.astype(np.uint8),
                                 cv2.COLOR_BayerBG2BGR)
        image_neg = cv2.cvtColor(image_neg.astype(np.uint8),
                                 cv2.COLOR_BayerBG2BGR)

    return image_pos.astype(np.float32) * c_pos - image_neg.astype(np.float32) * c_neg


def inner_double_integral(bii):
    """Stack of integrated log-brightness offsets across the exposure
    (ref semantics: utils/edi.py:73-88). bii: [2N, ...]; returns [2N+1, ...].

    The reference's per-index partial sums (``-sum(bii[i:N])`` below the
    midpoint, ``+sum(bii[N:N+1+i])`` above) are all differences of one
    exclusive prefix sum: with ``S[k] = sum(bii[:k])`` the whole stack is
    ``S - S[N]`` (f64 accumulation, cast back to the input dtype).
    """
    bii = np.asarray(bii)
    assert bii.shape[0] % 2 == 0
    N = bii.shape[0] // 2
    S = np.concatenate([np.zeros_like(bii[:1], dtype=np.float64),
                        np.cumsum(bii, axis=0, dtype=np.float64)], axis=0)
    return (S - S[N]).astype(bii.dtype)


def deblur_double_integral(blurry, bii):
    """EDI deblur: sharp = (2N+1) * blurry / sum(exp(inner integrals))
    (ref: utils/edi.py:91-95)."""
    N = bii.shape[0] // 2
    images = inner_double_integral(bii)
    return (2 * N + 1) * blurry / np.exp(images).sum(axis=0)


def slowmo_double_integral(sharp, bii):
    """Re-blur a sharp frame to each sub-exposure instant
    (ref: utils/edi.py:98-104)."""
    images = inner_double_integral(bii)
    return [sharp * np.exp(im) for im in list(images)]
