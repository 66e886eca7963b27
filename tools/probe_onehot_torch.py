#!/usr/bin/env python3
"""One-hot contraction probe of the PyTorch/CUDA port: the counterpart of
``tools/probe_onehot.py``, with its cases.

Kernel K9 (``evdeblurnerf_torch/ops/probe_onehot.py::onehot_lerp``) builds
a two-corner tent-weight one-hot of K columns for each of N = 1,048,576
points in registers and contracts it with a [K, 64] tile on the tensor
cores by ``wgmma`` (f32 tiles as three TF32 products), the tile packed
once into its swizzled shared-memory image and streamed to clusters of
two blocks, for K = 256, 1024 and 4096 and tiles in bf16 and f32: the
cost a point of the one-hot build and the contraction, against the row
gather it would replace, ``F.embedding_bag`` over the two rows a point
selects with their two weights (one PyTorch call; over a bf16 tile it
returns bf16).
The JAX tool's block height (256 or 1024 points) is the TPU's and is
dropped. Each case's output is held to the plain twin (within 1e-6 of the
largest magnitude), and its inputs are drawn with
``np.random.default_rng(0)``: the first corners uniform in [0, K - 1),
the fractions in [0, 1), the tile standard normal.

On the card a time is the mean of CUDA events over calls queued back to
back, beside the kernels' own device time from ``torch.profiler`` (CUPTI,
by kernel name; ``tools/timing_torch.py::device_ms_by_name``): the pack
of the tile and the contraction, printed first unless the profiler kept
no whole trace (then "not measured"); on the CPU the host clock. Per case
it prints ms and ns a point with the gather's time beside, the share of
the bound (``probe_onehot.bound``: bytes over 3.35 TB/s or 2 N K C
operations over the tensor cores' rate, the larger), and the bytes of
the packed tile the call reads from L2 (``probe_onehot.l2_tile_bytes``):
their time at the device-memory rate of 3.35 TB/s, which the L2 exceeds,
beside a third of the operations bound, and the rate at which the call
read them; then one JSON line.

    python3 tools/probe_onehot_torch.py [--iters 3] [--tiny]
        [--device cuda|cpu]

``--tiny`` runs N = 4096 points; the probe runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

TOOLS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TOOLS)
for _path in (REPO, TOOLS):
    if _path not in sys.path:
        sys.path.insert(0, _path)

import timing_torch  # noqa: E402

N_POINTS = 1_048_576
TINY_N = 4096
TILE_ROWS = (256, 1024, 4096)
CHANNELS = 64
DTYPES = ("bf16", "f32")
REL_TOL = 1e-6      # of the twin's largest magnitude


def draw_case(rng, N, K, C, dt):
    """(idx [N] int32, frac [N] f32, tile [K, C] f32 values) of one case."""
    idx = rng.integers(0, K - 1, N).astype(np.int32)
    frac = rng.uniform(0, 1, N).astype(np.float32)
    tile = rng.normal(size=(K, C)).astype(np.float32)
    return idx, frac, tile


DEVICE_PARTS = ("onehot_pack", "onehot_kernel")     # the kernels a call runs


def probe_case(N, K, dt, rng, device, ms, iters):
    """K9 on one tile size and type; returns the case's record."""
    import torch
    import torch.nn.functional as F

    from evdeblurnerf_torch.ops import probe_onehot as po

    idx_np, frac_np, tile_np = draw_case(rng, N, K, CHANNELS, dt)
    idx = torch.from_numpy(idx_np).to(device)
    frac = torch.from_numpy(frac_np).to(device)
    tile = torch.from_numpy(tile_np).to(
        device, torch.bfloat16 if dt == "bf16" else torch.float32)
    got = po.onehot_lerp(idx, frac, tile)
    want = po.onehot_lerp_plain(idx, frac, tile)
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    del got, want
    rec = dict(max_abs_err=err, scale=scale, held=err <= REL_TOL * scale,
               **po.bound(N, K, CHANNELS, dt == "bf16"),
               l2_tile_bytes=po.l2_tile_bytes(N, K, CHANNELS, dt == "bf16"))

    def kernel():
        return po.onehot_lerp(idx, frac, tile)

    corners = torch.stack([idx, idx + 1], 1)
    weights = torch.stack([1.0 - frac, frac], 1).to(tile.dtype)
    rec["ms"] = ms(kernel)
    rec["library_ms"] = ms(lambda: F.embedding_bag(
        corners, tile, per_sample_weights=weights, mode="sum"))
    t, note = rec["ms"], ""
    if device.type == "cuda":
        try:
            parts = timing_torch.device_ms_by_name(
                kernel, DEVICE_PARTS, iters=iters, warmup=1)
            rec["device_ms_parts"] = {k: parts[k] for k in DEVICE_PARTS}
            t = rec["device_ms"] = sum(rec["device_ms_parts"].values())
            note = (f", pack {parts['onehot_pack']:.4f} ms, contraction "
                    f"{parts['onehot_kernel']:.4f} ms")
        except RuntimeError:    # the profiler kept no whole trace
            rec["device_ms"] = None
            note = ", device time not measured"
    rec["ns_per_pt"] = t / N * 1e6
    card = ""
    if device.type == "cuda":    # the bound and L2 are the card's
        rec["share_of_bound"] = rec["bound_ms"] / t
        rec["l2_tile_ms_at_hbm"] = 1e3 * rec["l2_tile_bytes"] / \
            po.HBM_BYTES_PER_S
        card = (f"; bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}), "
                f"{100 * rec['share_of_bound']:.1f}% of it; tile read from "
                f"L2 {rec['l2_tile_bytes'] / 1e9:.3f} GB at "
                f"{rec['l2_tile_bytes'] / (t * 1e-3) / 1e12:.2f} TB/s, "
                f"{rec['l2_tile_ms_at_hbm']:.4f} ms at 3.35 TB/s against a "
                f"third of the operations bound "
                f"{rec['operations_ms'] / 3:.4f} ms")
    print(f"K={K:5d} C={CHANNELS} {dt:4s}: {t:7.4f} ms for {N} pts "
          f"({rec['ns_per_pt']:6.3f} ns/pt{note}); back to back "
          f"{rec['ms']:.4f} "
          f"ms; embedding_bag {rec['library_ms']:.4f} ms "
          f"({rec['library_ms'] / N * 1e6:6.3f} ns/pt){card}; max |kernel - "
          f"twin| {err:.2e} of {scale:.3f}", flush=True)
    return rec


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--tiny", action="store_true", help=f"N = {TINY_N}")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import torch

    from evdeblurnerf_torch import kernels
    from evdeblurnerf_torch.utils.precision import set_matmul_precision

    # the twin's f32 product exact on the card, as the port's default
    set_matmul_precision("highest")
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("probe_onehot_torch: no CUDA card "
                             "(torch.cuda.is_available() is False); "
                             "--device cpu runs the plain twin")
        device = torch.device("cuda", torch.cuda.current_device()
                              if device.index is None else device.index)
        where = timing_torch.card_line()
    else:
        where = "cpu"
    N = TINY_N if args.tiny else N_POINTS
    rng = np.random.default_rng(0)

    def ms(fn):
        return timing_torch.mean_ms(fn, device, args.iters)

    print(f"probe_onehot_torch: N={N} points, C={CHANNELS}, device={where}",
          flush=True)
    result = dict(tool="probe_onehot_torch", device=where, N=N, C=CHANNELS,
                  cases={})
    for K in TILE_ROWS:
        for dt in DTYPES:
            result["cases"][f"{dt}/K={K}"] = probe_case(
                N, K, dt, rng, device, ms, args.iters)
    result["launches"] = {name: kernels.LAUNCHES[name]
                          for name in ("onehot_lerp", "onehot_lerp_bf16")}
    print(json.dumps(result), flush=True)
    broken = [c for c, r in result["cases"].items() if not r["held"]]
    if broken:
        raise SystemExit(f"probe_onehot_torch: beyond {REL_TOL} of the "
                         f"twin's largest magnitude at {', '.join(broken)}")
    return result


if __name__ == "__main__":
    main()
