#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``evdeblurnerf_torch``) on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card and the CUDA toolkit (``nvcc``), and exits non-zero, printing no
result, when either is missing or any check fails. It imports nothing of
jax and nothing of the JAX package. Phases, one line each (phase 3 one
per kernel):

1. environment: torch/CUDA versions, the card's name and power limit,
   TF32 off;
2. build of the hand-written kernels from ``evdeblurnerf_torch/csrc``;
3. each kernel against its plain PyTorch version on the card, at the
   shapes the paper's training step gives it (K1 also at the eval
   chunk's): K1 ``permute_lanes`` forward and backward, K2
   ``permute_lanes_3d`` forward and backward, and K3 ``cdf_take`` must be
   bitwise equal; K4 ``triplane_features`` at N=2,097,152 on coarse- and
   fine-size packed tables within 1e-6 of the plain output's largest
   magnitude (both round at the same places); K5 ``triplane_features_bwd``
   (with K6 for the line tables) at the same N, every gradient within 1e-5
   of its largest magnitude against autograd of the plain sampler, and K6
   ``line_grad`` at the fine line table within 1e-5 (atomics add in
   another order, run to run). Times are CUDA-event means after warm-up,
   taken in the order plain, kernel, kernel, plain;
4. the serving path at the paper width (the model of ``bench.py``: 64+64
   samples, 16.8M/134M-voxel grids, app_n_comp (64, 16, 16), fine width
   256): seeded random weights saved as a reference ``*.tar``, loaded
   through ``serving.build_renderer``, one 480x640 pose rendered through
   ``render_poses`` in chunks of 32,768 rays; outputs finite, rgb in
   [0, 1], depth in [near, far]; every eval kernel launched;
5. card against CPU on the same weights: 1,024 rays rendered through the
   kernels on the card and through the plain versions on the CPU;
6. the training path at full width: the paper's full method
   (``configs/evdeblurnerf_blender/tx_blurfactory_evdeblurnerf_ediprior_
   evcrf.txt``: RBK with 10 rays per pixel, AWP, the EDI prior, EGM on
   stage0 and stage1 through a learned event CRF with pos-neg BII, an rgb
   gamma CRF, sigma noise 1) with the kernel and the CRF learning from
   step 0, seeded random weights, and one synthetic batch of 1024 x 10 +
   2 x 4096 = 18,432 rays; 2 warm-up and 5 timed steps through
   ``train/step.py``; every loss finite, every parameter group updated,
   every kernel launched forward and backward;
7. card against CPU, one training step at the same width on 64 x 10 +
   2 x 64 rays with perturb 0 and no sigma noise: the loss and every
   parameter's gradient through the kernels on the card and through the
   plain versions on the CPU.

The line before the last holds one JSON object with each kernel's numbers;
the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import math
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
    perturb=1.0, raw_noise_std=1.0, kernel_use_awp=True,
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
# the flags the training path reads: the values of configs/
# evdeblurnerf_blender/tx_blurfactory_evdeblurnerf_ediprior_evcrf.txt (the
# paper's full method), the flag table's defaults for the flags that file
# leaves unset, and the two overrides that make the blur kernel and the
# learned CRF live from step 0 (kernel_start_iter and
# tone_mapping_start_learn_iter, 1200 in the file). Kept here rather than
# parsed, so that this script loads nothing of the JAX package, whose flag
# table evdeblurnerf_torch.config reads; tests/test_torch_train.py pins it
# against that parse.
PAPER_CONFIG = ("configs/evdeblurnerf_blender/"
                "tx_blurfactory_evdeblurnerf_ediprior_evcrf.txt")
PAPER_OVERRIDES = dict(kernel_start_iter=0, tone_mapping_start_learn_iter=0)
TRAIN_FLAGS = dict(
    N_rand=1024, events_N_rand=4096, N_importance=64, N_samples=64,
    add_event_egm_stages=["stage0", "stage1"], align_end_iter=1e10,
    align_start_iter=0, blur_loss_after=0, clip_grads_norm=None,
    coarse_app_actfn="none", coarse_app_dim=32, coarse_app_n_comp=[64, 16, 16],
    coarse_hidden_dim=64, coarse_hidden_dim_color=64,
    coarse_n_voxels=16777248, coarse_num_layers=2, coarse_num_layers_color=3,
    colornet_weightdecay=None, event_egm_use_color_weights=None,
    event_egm_use_colorevents=False, event_egm_weight=0.1,
    event_egm_weight_end=1.0, event_egm_weight_scheduler="constant",
    event_egm_weight_steps=None, events_threshold=0.2,
    events_threshold_neg=0.2, events_threshold_pos=0.2,
    fine_app_actfn="none", fine_app_dim=32, fine_app_n_comp=[64, 16, 16],
    fine_cull_capacity=0.0, fine_geo_feat_dim=128, fine_hidden_dim=256,
    fine_hidden_dim_color=256, fine_n_voxels=134217984, fine_num_layers=2,
    fine_num_layers_color=3, kernel_align_weight=0.0,
    kernel_awp_fine_loss_start_ratio=0.1, kernel_awp_mot_emb_depth=1,
    kernel_awp_mot_emb_width=32, kernel_awp_ray_dir_freq=2,
    kernel_awp_sam_emb_depth=4, kernel_awp_sam_emb_width=64,
    kernel_awp_use_coarse_to_fine_opt=True, kernel_feat_cnl=15,
    kernel_img_embed=32, kernel_img_embed_init="zero",
    kernel_img_embed_type="param", kernel_ptnum=10, kernel_rbk_ccw_depth=1,
    kernel_rbk_ccw_width=32, kernel_rbk_extra_feat_ch=0,
    kernel_rbk_se_r_depth=1, kernel_rbk_se_r_output_ch=3,
    kernel_rbk_se_r_width=32, kernel_rbk_se_rv_window=0.1,
    kernel_rbk_se_v_depth=1, kernel_rbk_se_v_output_ch=3,
    kernel_rbk_se_v_width=32, kernel_rbk_use_origin=True,
    kernel_start_iter=0, kernel_start_warmup_iters=1,
    kernel_start_warmup_mode="step", kernel_tv_loss_weight=1.0,
    kernel_type="RBK", kernel_use_awp=True, lindisp=False, lrate=0.005,
    lrate_decay=10, lrate_warmup_factor=0.1, lrate_warmup_iters=-1,
    mode="c2f", multires=10, multires_views=4, no_log_grads_norm=False,
    no_ndc=False, perturb=1.0, pts0_target_end_iter=9999999,
    pts0_target_start_iter=0, pts0_target_weight=0.01,
    pts0_target_weight_end=1e-05, pts0_target_weight_scheduler="cosine",
    pts0_target_weight_steps=10000, raw_noise_std=1.0, render_rmnearplane=0,
    rgb_add_bias=False, tone_mapping_events_add_bii="pos-neg",
    tone_mapping_events_type="learn", tone_mapping_gamma=2.2,
    tone_mapping_learn_init_identity=True, tone_mapping_start_learn_iter=0,
    tone_mapping_type="gamma", triplane_bf16=False, use_events=True,
    use_pts0_prior="edi", use_viewdirs=True)
NUM_IMAGES = 30         # bench.py's scene
TRAIN_WARMUP, TRAIN_STEPS = 2, 5
AB_RAYS, AB_EV_RAYS = 64, 64
K4_POINTS = 2_097_152
K4_REL_TOL = 1e-6
GRAD_REL_TOL = 1e-5     # K5 and K6: atomics sum in another order
TRAIN_RAYS, TRAIN_SAMPLES = 10240, 128   # the image render's fine pass
# phase 7: the card's training-step gradients against the CPU's; a
# gradient element is "beyond" when it differs by more than TRAIN_GRAD_TOL
# of its parameter's largest gradient magnitude. Inverse-CDF bin flips
# (phase 5) move a few rays' fine samples, and those rays' grid texels,
# so a small share beyond is expected and reported, not hidden
TRAIN_LOSS_TOL = 1e-4
TRAIN_GRAD_TOL = 1e-3
TRAIN_GRAD_MAX_SHARE = 1e-2
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


def _kernel_entry(source, replaces, err, ms, plain_ms, **extra):
    return dict(route="cuda", source=f"evdeblurnerf_torch/csrc/{source}",
                replaces=replaces, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, **extra)


def _paper_grids(dev, g, n_vox):
    """Random f32 grids ([C, H, W] planes, [C, D] lines) at a paper grid."""
    from evdeblurnerf_torch.models.voxnerf import compute_grid_size
    from evdeblurnerf_torch.ops import triplane

    grid = compute_grid_size(AABB[0], AABB[1], n_vox)
    planes, lines = [], []
    for i, c in enumerate((64, 16, 16)):
        m0, m1 = triplane.MAT_MODE[i]
        planes.append(0.1 * torch_randn(dev, g, c, grid[m1], grid[m0]))
        lines.append(0.1 * torch_randn(dev, g, c,
                                       grid[triplane.VEC_MODE[i]]))
    return grid, planes, lines


def torch_randn(dev, g, *shape):
    import torch

    return torch.randn(*shape, generator=g, device=dev)


def phase_kernels(dev):
    import torch

    from evdeblurnerf_torch.ops import (fused_sample, lane_shuffle,
                                       line_matmul, triplane)
    from evdeblurnerf_torch.models.voxnerf import compute_grid_size
    from evdeblurnerf_torch.ops.sample_pdf import (searchsorted_right,
                                                   unit_linspace)

    g = torch.Generator(device=dev).manual_seed(SEED)
    results = {}
    take = lane_shuffle.permute_lanes_plain

    # K1, forward at the eval chunk and forward + backward at the paper
    # step's image render: sigma into depth order, weights back
    for R, S in ((CHUNK, 128), (TRAIN_RAYS, TRAIN_SAMPLES)):
        x = torch_randn(dev, g, R, S)
        _, perm, inv = lane_shuffle.sort_with_perm(
            torch.rand(R, S, generator=g, device=dev))
        out = lane_shuffle.permute_lanes(x, perm, inv)
        check(torch.equal(out, take(x, perm)),
              f"K1 permute_lanes [{R}, {S}] differs from its plain version")
    ms, plain_ms = ab_ms(lambda: take(x, perm),
                         lambda: lane_shuffle.permute_lanes(x, perm, inv))
    results["permute_lanes"] = _kernel_entry(
        "lane_shuffle.cu", "evdeblurnerf_tpu/ops/lane_shuffle.py:137", 0.0,
        ms, plain_ms)
    xg = x.clone().requires_grad_()
    cot = torch_randn(dev, g, R, S)
    lane_shuffle.permute_lanes(xg, perm, inv).backward(cot)
    check(torch.equal(xg.grad, take(cot, inv)),
          "K1 backward differs from the plain gather by the inverse")
    # the backward's launch: the same kernel by the inverse permutation
    ms, plain_ms = ab_ms(lambda: take(cot, inv),
                         lambda: lane_shuffle._take(cot, inv, True))
    results["permute_lanes_bwd"] = _kernel_entry(
        "lane_shuffle.cu", "evdeblurnerf_tpu/ops/lane_shuffle.py:137", 0.0,
        ms, plain_ms)
    del x, xg, cot

    # K2: AWP's per-sample features [R, C, S] into depth order, and back
    C = 128
    x3 = torch_randn(dev, g, TRAIN_RAYS, C, TRAIN_SAMPLES).requires_grad_()
    out3 = lane_shuffle.permute_lanes(x3, perm, inv)
    check(torch.equal(out3, take(x3.detach(), perm)),
          "K2 permute_lanes_3d differs from its plain version")
    cot3 = torch_randn(dev, g, TRAIN_RAYS, C, TRAIN_SAMPLES)
    out3.backward(cot3)
    check(torch.equal(x3.grad, take(cot3, inv)),
          "K2 backward differs from the plain gather by the inverse")
    x3 = x3.detach()
    ms, plain_ms = ab_ms(lambda: take(x3, perm),
                         lambda: lane_shuffle._take(x3, perm, False))
    results["permute_lanes_3d"] = _kernel_entry(
        "lane_shuffle.cu", "evdeblurnerf_tpu/ops/lane_shuffle.py:166", 0.0,
        ms, plain_ms)
    ms, plain_ms = ab_ms(lambda: take(cot3, inv),
                         lambda: lane_shuffle._take(cot3, inv, True))
    results["permute_lanes_3d_bwd"] = _kernel_entry(
        "lane_shuffle.cu", "evdeblurnerf_tpu/ops/lane_shuffle.py:166", 0.0,
        ms, plain_ms)
    del x3, out3, cot3
    torch.cuda.empty_cache()

    # K3: the four gathers of sample_pdf at R=32768, M=63, N=64
    R, M, N = CHUNK, 63, 64
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
    results["cdf_take"] = _kernel_entry(
        "lane_shuffle.cu", "evdeblurnerf_tpu/ops/lane_shuffle.py:259",
        max(float((a - b).abs().max()) for a, b in zip(outs, refs)), ms,
        plain_ms)

    # K4 forward and K5 backward on coarse- and fine-size tables; points
    # reach past [-1, 1] so the zeros-padding and clip rules run, as they
    # do for rays leaving the aabb
    xyz = torch.rand(K4_POINTS, 3, generator=g, device=dev) * 2.2 - 1.1
    cot = torch_randn(dev, g, K4_POINTS, 96)
    k4 = _kernel_entry("fused_sample.cu",
                       "evdeblurnerf_tpu/ops/fused_sample.py:92", 0.0, 0, 0)
    k5 = _kernel_entry("fused_sample.cu",
                       "evdeblurnerf_tpu/ops/fused_sample.py:112", 0.0, 0, 0,
                       max_rel_err=0.0)
    for label, n_vox in (("coarse", TRAIN_FLAGS["coarse_n_voxels"]),
                         ("fine", TRAIN_FLAGS["fine_n_voxels"])):
        grid, planes, lines = _paper_grids(dev, g, n_vox)
        packed = triplane.pack_grids(planes, lines)
        got = fused_sample.triplane_features(*packed, xyz)
        want = triplane.triplane_features_packed(*packed, xyz)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"K4 {label}: non-finite")
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        check(err <= K4_REL_TOL * scale,
              f"K4 {label}: max |kernel - plain| {err:.3e} exceeds "
              f"{K4_REL_TOL} x {scale:.3e}")
        del got, want
        ms, plain_ms = ab_ms(
            lambda: triplane.triplane_features_packed(*packed, xyz),
            lambda: fused_sample.triplane_features(*packed, xyz))
        k4["max_abs_err"] = max(k4["max_abs_err"], err)
        k4[f"ms_{label}"], k4[f"plain_ms_{label}"] = ms, plain_ms
        k4[f"grid_{label}"] = list(grid)

        got = fused_sample.triplane_features_bwd(planes, lines, packed, xyz,
                                                 cot)
        got = [*got[0], *got[1], got[2]]
        # the plain twin: autograd of pack_grids + the packed sampler; its
        # time is the backward alone, over a graph built once
        leaves = [t.clone().requires_grad_()
                  for t in (*planes, *lines, xyz)]
        pk = triplane.pack_grids(leaves[:3], leaves[3:6])
        feats = triplane.triplane_features_packed(*pk, leaves[6])
        want = torch.autograd.grad(feats, leaves, cot, retain_graph=True)
        for name, a, b in zip(("plane0", "plane1", "plane2", "line0",
                               "line1", "line2", "xyz"), got, want):
            err = float((a - b).abs().max())
            scale = float(b.abs().max())
            check(err <= GRAD_REL_TOL * scale,
                  f"K5 {label} d_{name}: max |kernel - plain| {err:.3e} "
                  f"exceeds {GRAD_REL_TOL} x {scale:.3e}")
            k5["max_abs_err"] = max(k5["max_abs_err"], err)
            k5["max_rel_err"] = max(k5["max_rel_err"], err / scale)
        del got, want
        ms, plain_ms = ab_ms(
            lambda: torch.autograd.grad(feats, leaves, cot,
                                        retain_graph=True),
            lambda: fused_sample.triplane_features_bwd(planes, lines, packed,
                                                       xyz, cot))
        k5[f"ms_{label}"], k5[f"plain_ms_{label}"] = ms, plain_ms
        del feats, leaves, pk, packed, planes, lines
        torch.cuda.empty_cache()
    k4["ms"], k4["plain_ms"] = k4["ms_fine"], k4["plain_ms_fine"]
    k5["ms"], k5["plain_ms"] = k5["ms_fine"], k5["plain_ms_fine"]
    results["triplane_features"] = k4
    results["triplane_features_bwd"] = k5
    del xyz, cot

    # K6 at the fine 64-component line table: D = 366 rows of 2C = 128
    D = compute_grid_size(AABB[0], AABB[1],
                          TRAIN_FLAGS["fine_n_voxels"])[2]
    idx = torch.randint(0, D, (K4_POINTS,), generator=g, device=dev,
                        dtype=torch.int32)
    rows = torch_randn(dev, g, K4_POINTS, 128)
    got = line_matmul.line_grad(idx, rows, D)
    want = line_matmul.line_grad_plain(idx, rows, D)
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    check(err <= GRAD_REL_TOL * scale,
          f"K6 line_grad: max |kernel - plain| {err:.3e} exceeds "
          f"{GRAD_REL_TOL} x {scale:.3e}")
    ms, plain_ms = ab_ms(lambda: line_matmul.line_grad_plain(idx, rows, D),
                         lambda: line_matmul.line_grad(idx, rows, D))
    results["line_grad"] = _kernel_entry(
        "line_matmul.cu", "evdeblurnerf_tpu/ops/line_matmul.py:39", err,
        ms, plain_ms, max_rel_err=err / scale)
    del rows, got, want
    torch.cuda.empty_cache()

    for name, r in results.items():
        print(f"[3 kernel] {name}: max_abs_err {r['max_abs_err']:.3e}, "
              f"kernel {r['ms']:.4f} ms vs plain {r['plain_ms']:.4f} ms"
              + (f" (coarse tables: {r['ms_coarse']:.4f} vs "
                 f"{r['plain_ms_coarse']:.4f} ms)" if "ms_coarse" in r
                 else ""))
    return results


SERVE_KERNELS = ("permute_lanes", "cdf_take", "triplane_features")


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
    poses = make_poses()[:1]

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
    for name in SERVE_KERNELS:
        check(launches[name] > 0, f"kernel {name} never launched on the "
              "serving path")
    rate = n_rays / secs
    print(f"[4 serve] {len(poses)} pose {H}x{W} ({n_rays} rays, chunk "
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


def train_args(**overrides):
    from evdeblurnerf_torch.config import PORT_DEFAULTS

    return argparse.Namespace(**{**TRAIN_FLAGS, "grad_accum":
                                 PORT_DEFAULTS["grad_accum"], **overrides})


def make_train_batch(dev, n_rand, events_n_rand):
    """bench.py's synthetic batch (numpy seed 0) plus a uniform EDI-prior
    target ``rgbsf_pts0``, as tensors on ``dev``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)

    def make_rays(n, seed):
        r = np.random.default_rng(seed)
        o = r.normal(size=(n, 3)).astype(np.float32) * 0.05
        d = r.normal(size=(n, 3)).astype(np.float32)
        d[:, 2] = -np.abs(d[:, 2]) - 0.5
        return np.stack([o, d], axis=-1)

    batch = {
        "rays": make_rays(n_rand, 0),
        "rays_x": rng.uniform(0, W, n_rand).astype(np.float32),
        "rays_y": rng.uniform(0, H, n_rand).astype(np.float32),
        "images_idx": rng.integers(0, NUM_IMAGES, n_rand).astype(np.int32),
        "rgbsf": rng.uniform(0, 1, (n_rand, 3)).astype(np.float32),
    }
    ev_batch = {
        "events_rays_start": make_rays(events_n_rand, 1),
        "events_rays_end": make_rays(events_n_rand, 2),
        "events_pos_pol_cumsum":
            rng.integers(0, 3, events_n_rand).astype(np.float32),
        "events_neg_pol_cumsum":
            -rng.integers(0, 3, events_n_rand).astype(np.float32),
    }
    batch["rgbsf_pts0"] = rng.uniform(0, 1, (n_rand, 3)).astype(np.float32)
    return ({k: torch.from_numpy(v).to(dev) for k, v in batch.items()},
            {k: torch.from_numpy(v).to(dev) for k, v in ev_batch.items()})


def _param_group(name):
    if name.startswith("crf."):
        return "event CRF"
    if name.startswith(("kernelsnet.", "awpnet.")):
        return name.split(".")[0]
    return "grids" if ".app_" in name else "field MLPs"


def phase_train(dev, card):
    import torch

    from evdeblurnerf_torch import kernels
    from evdeblurnerf_torch.train import state as tstate
    from evdeblurnerf_torch.train import step as tstep

    check(torch.cuda.is_available(), "the training phase needs a CUDA card")
    args = train_args()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model, crf = tstate.build_model(args, AABB, H, W, FOCAL, NEAR, FAR,
                                    NUM_IMAGES, gen, dev)
    t0 = time.perf_counter()
    state = tstate.create_train_state(model, crf, args, gen)
    prefit_s = time.perf_counter() - t0
    step = tstep.build_train_step(args)
    sw_of = tstep.schedule_weights_fn(args)
    batch, ev_batch = make_train_batch(dev, args.N_rand, args.events_N_rand)
    n_rays = (batch["rays"].shape[0] * args.kernel_ptnum
              + 2 * ev_batch["events_rays_start"].shape[0])
    named = dict(model.named_parameters())
    named.update({f"crf.{n}": p for n, p in crf.named_parameters()})
    before = {n: p.detach().clone() for n, p in named.items()}

    losses = []
    for i in range(TRAIN_WARMUP):
        losses.append(float(step(state, batch, ev_batch, sw_of(state.step),
                                 False, True)["loss"]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    timed = [step(state, batch, ev_batch, sw_of(state.step), False, True)
             ["loss"] for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    losses += [float(v) for v in timed]
    check(all(math.isfinite(v) for v in losses), f"non-finite loss: {losses}")
    for name in kernels.KERNELS:
        check(launches[name] > 0, f"kernel {name} never launched on the "
              "training path")
    changed = {}
    for n, p in named.items():
        changed.setdefault(_param_group(n), []).append(
            not torch.equal(before[n], p.detach()))
    for group, flags in changed.items():
        check(any(flags), f"no parameter of {group} changed in "
              f"{TRAIN_WARMUP + TRAIN_STEPS} steps")
    rate = n_rays * TRAIN_STEPS / secs
    print(f"[6 train] paper step ({PAPER_CONFIG}, kernel and CRF live from "
          f"step 0, grad_accum {args.grad_accum}): {n_rays} rays/step, "
          f"{TRAIN_STEPS} steps in {secs:.3f} s = {rate:.1f} train rays/s "
          f"({1e3 * secs / TRAIN_STEPS:.1f} ms/step) on {card}; peak "
          f"{peak_gib:.2f} GiB; CRF identity pre-fit {prefit_s:.1f} s; "
          f"losses {[round(v, 6) for v in losses]}; parameters changed "
          f"{ {g: f'{sum(f)}/{len(f)}' for g, f in changed.items()} }; "
          f"launches {launches}")
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    crf_sd = {k: v.detach().cpu() for k, v in crf.state_dict().items()}
    del state, model, crf, before, named
    torch.cuda.empty_cache()
    return launches, sd, crf_sd, dict(
        rays_per_s=rate, seconds=secs, peak_gib=peak_gib, losses=losses,
        rays_per_step=n_rays)


def phase_train_card_vs_cpu(dev, sd, crf_sd):
    import torch

    from evdeblurnerf_torch.train import state as tstate
    from evdeblurnerf_torch.train import step as tstep

    args = train_args(perturb=0.0, raw_noise_std=0.0, no_log_grads_norm=True)
    step = tstep.build_train_step(args, return_grads=True)
    sw = tstep.schedule_weights_fn(args)(1)
    out = []
    for device in (dev, torch.device("cpu")):
        model, crf = tstate.build_model(args, AABB, H, W, FOCAL, NEAR, FAR,
                                        NUM_IMAGES, device=device)
        model.load_state_dict(sd)
        crf.load_state_dict(crf_sd)
        state = tstate.create_train_state(model, crf, args,
                                          torch.Generator(device=device),
                                          crf_identity_prefit=False)
        batch, ev_batch = make_train_batch(device, AB_RAYS, AB_EV_RAYS)
        aux = step(state, batch, ev_batch, sw, False, True)
        out.append((float(aux["loss"]),
                    {n: g.cpu() for n, g in aux["grads"].items()}))
        del state, model, crf, aux
        torch.cuda.empty_cache()
    (loss_card, g_card), (loss_cpu, g_cpu) = out
    check(set(g_card) == set(g_cpu), "card and CPU differ in which "
          "parameters have a gradient")
    rel_loss = abs(loss_card - loss_cpu) / abs(loss_cpu)
    rel, total, beyond = {}, 0, 0
    for n in g_cpu:
        a, b = g_card[n], g_cpu[n]
        scale = float(b.abs().max()) or 1.0
        rel[n] = float((a - b).abs().max()) / scale
        total += b.numel()
        beyond += int(((a - b).abs() > TRAIN_GRAD_TOL * scale).sum())
    share = beyond / total
    worst = max(rel.values())
    top = sorted(rel.items(), key=lambda kv: -kv[1])[:4]
    print(f"[7 train card vs cpu] {AB_RAYS}x{TRAIN_FLAGS['kernel_ptnum']} + "
          f"2x{AB_EV_RAYS} rays, perturb 0, no sigma noise: loss "
          f"{loss_card:.7g} vs {loss_cpu:.7g} (rel {rel_loss:.2e}); over "
          f"{len(g_cpu)} parameters, max |card - cpu| / max|cpu| "
          f"{worst:.2e}, share of gradient elements beyond "
          f"{TRAIN_GRAD_TOL} x max|cpu|: {share:.2e} ({beyond} of {total}); "
          f"largest: {', '.join(f'{n} {v:.2e}' for n, v in top)}")
    check(rel_loss <= TRAIN_LOSS_TOL,
          f"loss differs by {rel_loss:.2e} relative")
    check(share <= TRAIN_GRAD_MAX_SHARE,
          f"{share:.2e} of gradient elements beyond {TRAIN_GRAD_TOL}")
    return dict(rel_loss=rel_loss, max_rel_grad=worst, share_beyond=share)


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
        renderer, sd, serve_launches, _ = phase_serving(dev, card)
        phase_card_vs_cpu(dev, renderer, sd)
        del renderer, sd
        torch.cuda.empty_cache()
        train_launches, sd, crf_sd, _ = phase_train(dev, card)
        phase_train_card_vs_cpu(dev, sd, crf_sd)
        loaded = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                         "evdeblurnerf_tpu")]
        check(not loaded, f"the port loaded {sorted(loaded)}")
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    for name, r in kernel_results.items():
        r["launches"] = train_launches[name]
        if name in SERVE_KERNELS:
            r["launches_serve"] = serve_launches[name]
    print(json.dumps({"kernels": [dict(name=n, **r) for n, r in
                                  kernel_results.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
