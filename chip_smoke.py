#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``evdeblurnerf_torch``) on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card and the CUDA toolkit (``nvcc``), and exits non-zero, printing no
result, when either is missing or any check fails. Phases, one line each:

1. environment: torch/CUDA versions, the card's name and power limit,
   TF32 off;
2. build of the hand-written kernels from ``evdeblurnerf_torch/csrc``;
3. each kernel against its plain PyTorch version on the card, at the
   shapes the eval render gives it: K1 ``permute_lanes`` [32768, 128] and
   K3 ``cdf_take`` (R=32768, M=63, N=64) must be bitwise equal; K4
   ``triplane_features`` at N=2,097,152 on coarse- and fine-size packed
   tables within 1e-6 of the plain output's largest magnitude (both round
   at the same places; the bound leaves room for the plain version's
   fused elementwise kernels). Times are CUDA-event means after warm-up,
   taken in the order plain, kernel, kernel, plain;
4. the serving path at the paper width (the model of ``bench.py``: 64+64
   samples, 16.8M/134M-voxel grids, app_n_comp (64, 16, 16), fine width
   256): seeded random weights saved as a reference ``*.tar``, loaded
   through ``serving.build_renderer``, two 480x640 poses rendered through
   ``render_poses`` in chunks of 32,768 rays; outputs finite, rgb in
   [0, 1], depth in [near, far]; every kernel launched;
5. card against CPU on the same weights: 1,024 rays rendered through the
   kernels on the card and through the plain versions on the CPU.

The line before the last holds one JSON object with each kernel's numbers;
the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

H, W, FOCAL = 480, 640, 500.0
NEAR, FAR = 0.0, 1.0
AABB = ((-1.6, -1.7, -1.0), (1.7, 1.6, 1.0))
CHUNK = 32768
SEED = 0
# the flags serving.build_renderer reads, at the bench.py model
SERVE_FLAGS = dict(
    mode="c2f", N_samples=64, N_importance=64, use_viewdirs=True,
    multires=10, multires_views=4, lindisp=False, no_ndc=False,
    render_rmnearplane=0, rgb_add_bias=False, fine_cull_capacity=0.0,
    triplane_bf16=False,
    coarse_num_layers=2, coarse_num_layers_color=3, coarse_hidden_dim=64,
    coarse_hidden_dim_color=64, coarse_app_dim=32,
    coarse_app_n_comp=[64, 16, 16], coarse_n_voxels=16777248,
    coarse_app_actfn="none",
    fine_num_layers=2, fine_num_layers_color=3, fine_hidden_dim=256,
    fine_hidden_dim_color=256, fine_app_dim=32, fine_geo_feat_dim=128,
    fine_app_n_comp=[64, 16, 16], fine_n_voxels=134217984,
    fine_app_actfn="none",
    kernel_type="RBK", kernel_feat_cnl=15,
    tone_mapping_type="gamma", tone_mapping_gamma=2.2, chunk=CHUNK)
K4_POINTS = 2_097_152
K4_REL_TOL = 1e-6
CPU_RAYS = 1024
CPU_TOL = 1e-4          # per-ray |card - CPU| on rgb, depth and acc
CPU_MAX_SHARE = 0.01    # share of rays allowed beyond CPU_TOL
RANGE_SLACK = 1e-5      # f32 rounding of sum(weights) * z past [near, far]


class Failed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise Failed(msg)


def cuda_ms(fn, iters=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def ab_ms(plain, kernel):
    """(kernel ms, plain ms), each the mean of two runs taken in the order
    plain, kernel, kernel, plain."""
    p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(kernel), cuda_ms(kernel), \
        cuda_ms(plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


def phase_environment():
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[1 env] python {sys.version.split()[0]}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s), TF32 off")
    print(card)
    return card


def phase_build():
    from evdeblurnerf_torch.kernels import build

    t0 = time.perf_counter()
    path = build.build()
    build.load()
    secs = time.perf_counter() - t0
    log = path.with_suffix(".log").read_text()
    spills = [l.strip() for l in log.splitlines()
              if "spill" in l and not l.strip().startswith("0 bytes")]
    print(f"[2 build] {path.name} in {secs:.1f} s (nvcc "
          f"{build.find_nvcc()}); ptxas spills: "
          + (" | ".join(spills) if spills else "none")
          + f"; full nvcc output in {path.with_suffix('.log')}")
    return secs


def phase_kernels(dev):
    import torch

    from evdeblurnerf_torch.ops import fused_sample, lane_shuffle, triplane
    from evdeblurnerf_torch.ops.sample_pdf import (searchsorted_right,
                                                   unit_linspace)
    from evdeblurnerf_torch.models.voxnerf import compute_grid_size

    g = torch.Generator(device=dev).manual_seed(SEED)
    results = {}

    # K1: sigma to depth order and weights back, as the fine pass moves them
    R, S = CHUNK, 128
    x = torch.randn(R, S, generator=g, device=dev)
    depths = torch.rand(R, S, generator=g, device=dev)
    _, perm, inv_perm = lane_shuffle.sort_with_perm(depths)
    out = lane_shuffle.permute_lanes(x, perm)
    ref = lane_shuffle.permute_lanes_plain(x, perm)
    back = lane_shuffle.permute_lanes(out, inv_perm)
    torch.cuda.synchronize()
    check(torch.equal(out, ref), "K1 permute_lanes differs from its plain "
          "version")
    check(torch.equal(back, x), "K1 by the inverse permutation does not "
          "restore x")
    ms, plain_ms = ab_ms(lambda: lane_shuffle.permute_lanes_plain(x, perm),
                         lambda: lane_shuffle.permute_lanes(x, perm))
    results["permute_lanes"] = dict(
        route="cuda", source="evdeblurnerf_torch/csrc/lane_shuffle.cu",
        replaces="evdeblurnerf_tpu/ops/lane_shuffle.py:137",
        max_abs_err=float((out - ref).abs().max()), ms=ms, plain_ms=plain_ms)

    # K3: the four gathers of sample_pdf at R=32768, M=63, N=64
    M, N = 63, 64
    w = torch.rand(R, M - 1, generator=g, device=dev) + 1e-5
    cdf = torch.cumsum(w / w.sum(-1, keepdim=True), -1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], -1).contiguous()
    bins = torch.sort(torch.rand(R, M, generator=g, device=dev), -1)[0]
    u = unit_linspace(N, dev).expand(R, N).contiguous()
    inds = searchsorted_right(cdf, u)
    below = torch.clamp_min(inds - 1, 0).int()
    above = torch.clamp_max(inds, M - 1).int()
    outs = lane_shuffle.cdf_take(cdf, bins, below, above)
    refs = lane_shuffle.cdf_take_plain(cdf, bins, below, above)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(outs, refs)),
          "K3 cdf_take differs from its plain version")
    ms, plain_ms = ab_ms(
        lambda: lane_shuffle.cdf_take_plain(cdf, bins, below, above),
        lambda: lane_shuffle.cdf_take(cdf, bins, below, above))
    results["cdf_take"] = dict(
        route="cuda", source="evdeblurnerf_torch/csrc/lane_shuffle.cu",
        replaces="evdeblurnerf_tpu/ops/lane_shuffle.py:259",
        max_abs_err=max(float((a - b).abs().max())
                        for a, b in zip(outs, refs)),
        ms=ms, plain_ms=plain_ms)

    # K4 on coarse- and fine-size tables; points reach past [-1, 1] so the
    # zeros-padding and clip rules run, as they do for rays leaving the aabb
    xyz = (torch.rand(K4_POINTS, 3, generator=g, device=dev) * 2.2 - 1.1)
    k4 = dict(route="cuda", source="evdeblurnerf_torch/csrc/fused_sample.cu",
              replaces="evdeblurnerf_tpu/ops/fused_sample.py:92",
              max_abs_err=0.0)
    for label, n_vox in (("coarse", SERVE_FLAGS["coarse_n_voxels"]),
                         ("fine", SERVE_FLAGS["fine_n_voxels"])):
        grid = compute_grid_size(AABB[0], AABB[1], n_vox)
        planes, lines = [], []
        for i, c in enumerate((64, 16, 16)):
            m0, m1 = triplane.MAT_MODE[i]
            planes.append(0.1 * torch.randn(c, grid[m1], grid[m0],
                                            generator=g, device=dev))
            lines.append(0.1 * torch.randn(c, grid[triplane.VEC_MODE[i]],
                                           generator=g, device=dev))
        pp, pl, sizes = triplane.pack_grids(planes, lines)
        del planes, lines
        got = fused_sample.triplane_features(pp, pl, sizes, xyz)
        want = triplane.triplane_features_packed(pp, pl, sizes, xyz)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"K4 {label}: non-finite")
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        check(err <= K4_REL_TOL * scale,
              f"K4 {label}: max |kernel - plain| {err:.3e} exceeds "
              f"{K4_REL_TOL} x {scale:.3e}")
        del got, want
        ms, plain_ms = ab_ms(
            lambda: triplane.triplane_features_packed(pp, pl, sizes, xyz),
            lambda: fused_sample.triplane_features(pp, pl, sizes, xyz))
        k4["max_abs_err"] = max(k4["max_abs_err"], err)
        k4[f"ms_{label}"], k4[f"plain_ms_{label}"] = ms, plain_ms
        k4[f"grid_{label}"] = list(grid)
        del pp, pl
        torch.cuda.empty_cache()
    k4["ms"], k4["plain_ms"] = k4["ms_fine"], k4["plain_ms_fine"]
    results["triplane_features"] = k4
    for name, r in results.items():
        print(f"[3 kernel] {name}: max_abs_err {r['max_abs_err']:.3e}, "
              f"kernel {r['ms']:.4f} ms vs plain {r['plain_ms']:.4f} ms"
              + (f" (coarse tables: {r['ms_coarse']:.4f} vs "
                 f"{r['plain_ms_coarse']:.4f} ms)" if "ms_coarse" in r
                 else ""))
    return results


def make_poses():
    import numpy as np

    poses = []
    for k, (yaw, shift) in enumerate(((0.0, 0.0), (0.05, 0.03))):
        c, s = np.cos(yaw), np.sin(yaw)
        rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        poses.append(np.concatenate([rot, [[shift], [-shift], [0.0]]], 1))
    return np.asarray(poses, np.float32)


def phase_serving(dev, card):
    import torch

    from evdeblurnerf_torch import kernels, serving
    from evdeblurnerf_torch.models.renderer import config_from_args
    from evdeblurnerf_torch.models.system import EvDeblurNeRF

    args = argparse.Namespace(**SERVE_FLAGS)
    K = [[FOCAL, 0.0, W / 2], [0.0, FOCAL, H / 2], [0.0, 0.0, 1.0]]
    cfg = config_from_args(args, AABB, H, W, FOCAL, NEAR, FAR)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = EvDeblurNeRF(cfg, generator=gen, device=dev)
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    del model
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "000000.tar")
        torch.save({"global_step": 0, "network_state_dict": sd}, path)
        loaded = serving.load_network_state_dict(path)
    renderer = serving.build_renderer(args, loaded, H, W, K, NEAR, FAR, AABB,
                                      device=dev)
    poses = make_poses()

    # warm-up: one chunk, so the timed run holds no first-call set-up
    warm = torch.zeros(CHUNK, 3, 2, device=dev)
    warm[:, 2, 1] = -1.0
    renderer(warm)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    rgbs, depths = renderer.render_poses(poses)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    n_rays = len(poses) * H * W
    check(tuple(rgbs.shape) == (len(poses), H, W, 3)
          and tuple(depths.shape) == (len(poses), H, W),
          f"render shapes {tuple(rgbs.shape)}, {tuple(depths.shape)}")
    check(bool(torch.isfinite(rgbs).all() and torch.isfinite(depths).all()),
          "non-finite render output")
    check(float(rgbs.min()) >= 0.0 and float(rgbs.max()) <= 1.0,
          f"rgb outside [0, 1]: [{float(rgbs.min())}, {float(rgbs.max())}]")
    check(float(depths.min()) >= NEAR - RANGE_SLACK
          and float(depths.max()) <= FAR + RANGE_SLACK,
          f"depth outside [{NEAR}, {FAR}]: [{float(depths.min())}, "
          f"{float(depths.max())}]")
    for name in kernels.KERNELS:
        check(launches[name] > 0, f"kernel {name} never launched on the "
              "serving path")
    rate = n_rays / secs
    print(f"[4 serve] {len(poses)} poses {H}x{W} ({n_rays} rays, chunk "
          f"{CHUNK}) in {secs:.3f} s = {rate:.1f} eval rays/s on {card}; "
          f"peak {peak_gib:.2f} GiB; launches {launches}; depth "
          f"[{float(depths.min()):.4f}, {float(depths.max()):.4f}]")
    return renderer, loaded, launches, dict(rays_per_s=rate, seconds=secs,
                                            peak_gib=peak_gib)


def phase_card_vs_cpu(dev, renderer, sd):
    import torch

    from evdeblurnerf_torch import serving
    from evdeblurnerf_torch.train.evaluate import pose_rays

    args = argparse.Namespace(**SERVE_FLAGS)
    K = renderer.K
    rays = pose_rays(make_poses()[:1], H, W, K, dev)
    rays = rays[torch.linspace(0, rays.shape[0] - 1, CPU_RAYS,
                               device=dev).long()]
    cpu = serving.build_renderer(args, sd, H, W, K, NEAR, FAR, AABB,
                                 device="cpu")
    with torch.inference_mode():
        card = renderer.model.render(rays)
        host = cpu.model.render(rays.cpu())
    diff = torch.zeros(CPU_RAYS)
    for key in ("rgb_map", "depth_map", "acc_map"):
        d = (card[key].cpu() - host[key]).abs()
        diff = torch.maximum(diff, d.reshape(CPU_RAYS, -1).max(-1)[0])
    # inverse-CDF sampling moves a draw in a bin of pdf p by dCDF / p bin
    # widths, so last-bit differences of the coarse weights (GEMM order,
    # exp) shift importance depths in near-empty bins; count those rays
    flips = (card["z_vals"].cpu() - host["z_vals"]).abs().max(-1)[0] > 1e-4
    beyond = float((diff > CPU_TOL).float().mean())
    print(f"[5 card vs cpu] {CPU_RAYS} rays: max |diff| "
          f"{float(diff.max()):.3e}, share beyond {CPU_TOL}: {beyond:.4f}; "
          f"rays whose importance depths moved > 1e-4: {int(flips.sum())}")
    check(beyond <= CPU_MAX_SHARE,
          f"{beyond:.4f} of rays differ by more than {CPU_TOL}")
    return dict(max_abs_diff=float(diff.max()), share_beyond=beyond,
                flips=int(flips.sum()))


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "evdeblurnerf_torch")):
        print(f"chip_smoke: no evdeblurnerf_torch package beside {__file__}; "
              "run it from the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        card = phase_environment()
        dev = torch.device("cuda", 0)
        phase_build()
        kernel_results = phase_kernels(dev)
        renderer, sd, launches, _ = phase_serving(dev, card)
        phase_card_vs_cpu(dev, renderer, sd)
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    for name, r in kernel_results.items():
        r["launches"] = launches[name]
    print(json.dumps({"kernels": [dict(name=n, **r) for n, r in
                                  kernel_results.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
