#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``evdeblurnerf_torch``) on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card and the CUDA toolkit (``nvcc``), and exits non-zero, printing no
result, when either is missing or any check fails. It imports nothing of
jax and nothing of the JAX package. Its training flags, batch and loop
timer are ``bench_torch.py``'s. Phases, one line each (phase 3 one per
kernel and case, phase 8 a few):

1. environment: torch/CUDA versions, the card's name and power limit,
   TF32 off;
2. build of the hand-written kernels from ``evdeblurnerf_torch/csrc``;
3. each kernel against its plain PyTorch version on the card, at the
   shapes the paper's training step gives it (K1 also at the eval
   chunk's): K1 ``permute_lanes`` forward and backward, K2
   ``permute_lanes_3d`` forward and backward, and K3 ``cdf_take`` must be
   bitwise equal; K4 ``triplane_features`` bitwise equal to its plain
   version (both round at the same places) in its float4 form and in its
   scalar form (forced by a table off a 16-byte boundary), at N=2,097,152
   uniform points on coarse- and fine-size packed tables, at the step's
   launch sizes, on the ray-ordered stream of one step and at an eval
   chunk's two launch sizes on Morton-sorted rays, each with the kernel's
   device time, the plain version's time, the bound and the two traffic
   floors of the packed tables; K5 ``triplane_features_bwd``
   (with K6 for the line tables) every gradient within 1e-5 of its largest
   magnitude against autograd of the plain sampler, at that N, at the
   step's own launch sizes (1,310,720 points on the fine tables, 655,360
   on the coarse) and on the ray-ordered stream of one step
   (``utils/locality.py::step_points_xyz``), and K6 ``line_grad`` alone on
   the fine and coarse line tables with uniform and ray-ordered row
   indices within 1e-5, and on its path: at the paper's tables K5's fused
   kernel sums the line gradients in shared memory, so K6 is driven by a
   sampler backward over a line of 1024 rows, which that kernel cannot
   hold, with the launches counted there (atomics add in
   another order, run to run); K7 ``tiled_plane_gather`` at its bench's
   shapes (a 512 x 512 x 64 plane, the 1,310,720 sample points of one
   step, tiles 32x32, 64x64 and 48x128): rows inside their tile bitwise
   equal to the plain version's (the bound is 1e-6 of the largest
   magnitude), spilled rows exactly zero, the fallback within 1e-5 of a
   direct bilinear gather, NaN when the spills pass the capacity. Times
   (``ms``, ``plain_ms``, ``library_ms``) are CUDA-event means after
   warm-up over calls queued back to back, taken in the order plain,
   kernel, kernel, plain; beside them the time of the one PyTorch call
   that computes the same function, where there is one (``torch.gather``,
   ``index_add_``, ``F.grid_sample``), and the least time the card could
   take (bytes over 3.35 TB/s or operations over 67 TFLOP/s f32). A kernel
   of a few microseconds (K1, K3) finishes before the host has queued the
   next call, so its back-to-back time follows the host; for these, and
   for their yardsticks, two more numbers: ``device_ms``, the kernel's own
   duration on the device (the sum of its CUPTI durations from
   ``torch.profiler`` over 50 calls, its tensors warm in L2),
   ``device_cold_ms``, the same after an L2 flush before every call, and
   ``host_us_per_call``, the wall time of the Python call with no
   synchronise (``tools/timing_torch.py``). K5's ``ms`` is its wrapper's,
   which launches K5's kernel, PyTorch glue and, for tables too large for
   the fused kernel, one K6 kernel: for every
   K5 and K6 case the kernel's own ``device_ms`` (CUPTI durations summed
   by kernel name) stands beside the wrapper's ``ms``, the bound at that
   shape and, for K6, ``index_add_``'s time
   (``tools/bench_kernel_variants_torch.py`` holds K4's, K5's and K6's
   cases and timers);
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
   every kernel of the step launched forward and backward;
7. card against CPU, one training step at the same width on 64 x 10 +
   2 x 64 rays with perturb 0 and no sigma noise: the loss and every
   parameter's gradient through the kernels on the card and through the
   plain versions on the CPU;
8. a training run through the CLI path (``evdeblurnerf_torch.cli.main``)
   at the same full width, on a synthetic LLFF + events scene written with
   numpy into a temporary directory and read through two small dataset
   subclasses (``tools/synthetic_scene_torch.py``; the card machine has
   no image or HDF5 library): train across the kernel start, the event start and the CRF
   learn start with a checkpoint mid-run and the testset render at the
   last step; auto-resume from the newest checkpoint and train on; then
   ``--render_only --render_test``. Every logged loss finite, the resumed
   run at the saved step and learning rate, one ``test_metrics.txt`` line
   per testset render, the render-only images equal to the last testset
   render's, the checkpoint loadable through ``serving.build_renderer``,
   every training kernel launched, and the prefetcher's card batches
   equal to the CPU's;
9. K7's own path, ``tools/bench_tiled_gather_torch.py``, run through its
   entry point;
10. the PBE training step at full width: the paper's grids and widths with
    ``kernel_type PBE``, 5 pattern points in a window of 10 pixels, 1,024
    rays, 64+64 samples, the EDI-prior pts0 target on, events off, on the
    bench batch (its pixel coordinates and poses); 2 warm-up and 5 timed
    steps; the loss finite and falling, K1, K3, K4 and K5 launched,
    non-zero gradients on ``kernelsnet.pattern_pos`` and on the coarse
    grids. Then one DSK step with ``kernel_align_weight 0.1`` and a
    non-zero align term, and one PBE step at a small size on the card and
    on the CPU from one state dict, losses within 1e-5 relative;
11. ``bench_torch.run()`` for ``step_only`` with 5 timed steps: its ms/step
    within 5% of phase 6's (a reading beyond that is taken again, three
    times in all: the step follows the shared host).

The line before the last holds one JSON object with each kernel's numbers;
the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import functools
import glob
import importlib.util
import json
import math
import os
import struct
import subprocess
import sys
import tempfile
import time
import zlib

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
# the training path's flags and batch are bench_torch.py's (the paper's
# configuration file with the blur kernel and the learned CRF live from
# step 0): train_args() and make_train_batch() below
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA's data sheet
F32_FLOPS_PER_S = 67e12       # float32 outside the tensor cores
NUM_IMAGES = 30         # bench.py's scene
TRAIN_WARMUP, TRAIN_STEPS = 2, 5
AB_RAYS, AB_EV_RAYS = 64, 64
PBE_FLAGS = dict(kernel_type="PBE", kernel_ptnum=5, kernel_hwindow=10,
                 kernel_use_awp=False, use_events=False, add_event_egm=False)
PBE_CPU_TOL = 1e-5      # phase 10: the small PBE step's loss, card vs CPU
BENCH_STEP_TOL = 0.05   # phase 11: bench_torch's step against phase 6's
BENCH_STEP_TRIES = 3
# K6's path: a sampler backward whose 64-component line (grid z) is too
# tall for K5 to reduce in shared memory (1024 x 68 floats = 272 KiB)
K6_PATH_GRID, K6_PATH_POINTS = (40, 36, 1024), 262_144
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
    """tools/timing_torch.py::cuda_ms."""
    return _load_tool("timing_torch").cuda_ms(fn, iters, warmup)


def device_and_host(fn):
    """tools/timing_torch.py::device_and_host: (device ms with a warm L2,
    device ms after an L2 flush, host microseconds per call)."""
    return _timed(_load_tool("timing_torch").device_and_host, fn)


def _timed(timer, *args):
    """``timer(*args)``; a trace that stayed empty fails the run by name."""
    try:
        return timer(*args)
    except RuntimeError as e:
        raise Failed(str(e)) from e


def small_kernel_times(entry, suffix="", **fns):
    """Adds ``device_ms``, ``device_cold_ms`` and ``host_us_per_call``
    (:func:`device_and_host`) to a kernel's record: plainly named for
    ``kernel=``, with the prefix ``library_`` or ``plain_`` for those
    yardsticks."""
    for role, fn in fns.items():
        prefix = "" if role == "kernel" else f"{role}_"
        (entry[f"{prefix}device_ms{suffix}"],
         entry[f"{prefix}device_cold_ms{suffix}"],
         entry[f"{prefix}host_us_per_call{suffix}"]) = device_and_host(fn)


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


def _kernel_entry(source, replaces, err, ms, plain_ms, nbytes=0, flops=0,
                  library_ms=None, **extra):
    """One kernel's record. ``nbytes``: what the function must move at
    these inputs (each input read once, each output written once; of a
    table that is gathered from, no more than the rows the points can
    touch); ``flops``: its float32 operations. The bound is the larger of
    the two over the card's published rates."""
    entry = dict(route="cuda", source=f"evdeblurnerf_torch/csrc/{source}",
                 replaces=replaces, max_abs_err=err, ms=ms,
                 plain_ms=plain_ms, library_ms=library_ms, **extra)
    return _set_bound(entry, nbytes, flops)


def _set_bound(entry, nbytes, flops):
    by_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    by_ops = 1e3 * flops / F32_FLOPS_PER_S
    entry.update(bound_ms=max(by_bytes, by_ops), bytes=int(nbytes),
                 flops=int(flops),
                 bound_by="bytes" if by_bytes >= by_ops else "operations")
    return entry


def _touched_bytes(grid, n_points, corners):
    """Bytes of a [C, ...] f32 grid that ``n_points`` samples of
    ``corners`` cells each need: every point's cells over all channels,
    and no more than the whole grid."""
    return 4 * min(grid.numel(), n_points * corners * grid.shape[0])


def torch_randn(dev, g, *shape):
    import torch

    return torch.randn(*shape, generator=g, device=dev)


def phase_kernels(dev):
    import torch

    from evdeblurnerf_torch.ops import (fused_sample, lane_shuffle,
                                       line_matmul, triplane)
    from evdeblurnerf_torch.ops.sample_pdf import (searchsorted_right,
                                                   unit_linspace)

    g = torch.Generator(device=dev).manual_seed(SEED)
    results = {}
    take = lane_shuffle.permute_lanes_plain

    # K1, forward and backward: at the eval chunk (keys with the suffix
    # "_eval") and at the paper step's image render, where sigma goes into
    # depth order and the weights come back. Both are a few microseconds on
    # the device, so device_ms and host_us_per_call stand beside the
    # back-to-back time
    k1 = {name: _kernel_entry(
        "lane_shuffle.cu", "evdeblurnerf_tpu/ops/lane_shuffle.py:137", 0.0,
        0, 0) for name in ("permute_lanes", "permute_lanes_bwd")}

    def k1_bytes(R, S):
        # x and the index read, the output written: 3 arrays of R * S words
        return 3 * 4 * R * S

    for (R, S), suffix in (((CHUNK, 128), "_eval"),
                           ((TRAIN_RAYS, TRAIN_SAMPLES), "")):
        x = torch_randn(dev, g, R, S)
        _, perm, inv = lane_shuffle.sort_with_perm(
            torch.rand(R, S, generator=g, device=dev))
        out = lane_shuffle.permute_lanes(x, perm, inv)
        check(torch.equal(out, take(x, perm)),
              f"K1 permute_lanes [{R}, {S}] differs from its plain version")
        xg = x.clone().requires_grad_()
        cot = torch_randn(dev, g, R, S)
        lane_shuffle.permute_lanes(xg, perm, inv).backward(cot)
        check(torch.equal(xg.grad, take(cot, inv)),
              f"K1 backward [{R}, {S}] differs from the plain gather by the "
              "inverse")
        perm64, inv64 = perm.long(), inv.long()
        # the backward's launch: the same kernel by the inverse permutation
        for name, fns in (
                ("permute_lanes", dict(
                    plain=lambda: take(x, perm),
                    kernel=lambda: lane_shuffle.permute_lanes(x, perm, inv),
                    library=lambda: torch.gather(x, -1, perm64))),
                ("permute_lanes_bwd", dict(
                    plain=lambda: take(cot, inv),
                    kernel=lambda: lane_shuffle._take(cot, inv, True),
                    library=lambda: torch.gather(cot, -1, inv64)))):
            e = k1[name]
            e[f"ms{suffix}"], e[f"plain_ms{suffix}"] = ab_ms(fns["plain"],
                                                             fns["kernel"])
            e[f"library_ms{suffix}"] = cuda_ms(fns["library"])
            small_kernel_times(e, suffix, **fns)
            e[f"bound_ms{suffix}"] = 1e3 * k1_bytes(R, S) / HBM_BYTES_PER_S
            e[f"shape{suffix}"] = [R, S]
        del x, xg, cot, out
    for e in k1.values():
        _set_bound(e, k1_bytes(TRAIN_RAYS, TRAIN_SAMPLES), 0)
    results.update(k1)

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
    # x read and the output written ([R, C, S]), one index per ray sample
    k2_bytes = 4 * (2 * TRAIN_RAYS * C * TRAIN_SAMPLES
                    + TRAIN_RAYS * TRAIN_SAMPLES)
    perm3 = perm64[:, None, :].expand(-1, C, -1)
    results["permute_lanes_3d"] = _kernel_entry(
        "lane_shuffle.cu", "evdeblurnerf_tpu/ops/lane_shuffle.py:166", 0.0,
        ms, plain_ms, k2_bytes,
        library_ms=cuda_ms(lambda: torch.gather(x3, -1, perm3)))
    ms, plain_ms = ab_ms(lambda: take(cot3, inv),
                         lambda: lane_shuffle._take(cot3, inv, True))
    inv3 = inv64[:, None, :].expand(-1, C, -1)
    results["permute_lanes_3d_bwd"] = _kernel_entry(
        "lane_shuffle.cu", "evdeblurnerf_tpu/ops/lane_shuffle.py:166", 0.0,
        ms, plain_ms, k2_bytes,
        library_ms=cuda_ms(lambda: torch.gather(cot3, -1, inv3)))
    del x3, out3, cot3, perm3, inv3
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
        plain_ms,
        # cdf and bins [R, M], two indices and four outputs [R, N]
        4 * R * (2 * M + 6 * N))
    small_kernel_times(
        results["cdf_take"],
        kernel=lambda: lane_shuffle.cdf_take(cdf, bins, below, above),
        plain=lambda: lane_shuffle.cdf_take_plain(cdf, bins, below, above))

    # K4 forward and K5 backward (with K6 for the line tables) at the cases
    # of tools/bench_kernel_variants_torch.py: 2,097,152 uniform points on
    # the coarse and fine tables, the step's own launch sizes, the
    # ray-ordered stream of one step and, for K4, an eval chunk's launches
    bench = _load_tool("bench_kernel_variants_torch")
    timing = _load_tool("timing_torch")
    paper = train_args()
    check(bench.N_VOXELS == dict(coarse=paper.coarse_n_voxels,
                                 fine=paper.fine_n_voxels)
          and list(bench.N_COMP) == list(paper.fine_app_n_comp)
          and bench.AABB == AABB,
          "tools/bench_kernel_variants_torch.py is not at the paper's tables")

    def sampler_bytes(planes, lines, n):
        # xyz and the touched table cells read, [N, 96] read or written (the
        # neighbour-packed tables hold each cell several times; the
        # function's data is the raw grids, so those cap the count)
        n_ch = sum(p.shape[0] for p in planes)
        return (4 * n * (3 + n_ch)
                + sum(_touched_bytes(p, n, 4) for p in planes)
                + sum(_touched_bytes(ln, n, 2) for ln in lines)), n_ch

    # K4: ms is the back-to-back time of the wrapper, device_ms the kernel's
    # own; both forms of the kernel bitwise equal to the plain version. Per
    # point and channel 4 + 2 slot products, their sums and plane x line
    k4 = _kernel_entry(
        "fused_sample.cu", "evdeblurnerf_tpu/ops/fused_sample.py:92", 0.0, 0,
        0, cases={},
        floors="packed-table traffic over the card's memory rate, xyz read "
        "and the output written once: floor_distinct_ms counts every "
        "distinct packed row once (an unbounded cache), "
        "floor_every_point_ms every point's plane rows (no cache: what "
        "uniform points on tables far above the L2 pay) and the distinct "
        "line rows")
    for case, (label, n, stream) in bench.K4_CASES.items():
        planes, lines, packed, xyz = bench.k4_inputs(dev, g, case)
        k4_bytes, n_ch = sampler_bytes(planes, lines, n)
        del planes, lines
        want = triplane.triplane_features_packed(*packed, xyz)
        got = fused_sample.triplane_features(*packed, xyz)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"K4 {case}: non-finite")
        err = float((got - want).abs().max())
        check(torch.equal(got, want), f"K4 {case}: the float4 kernel "
              f"differs from the plain version by {err:.3e}")
        del got
        # the scalar form: the same tables with plane 1 moved 4 bytes off
        # its 16-byte boundary
        pp, pl, sizes = packed
        buf = torch.empty(pp[1].numel() + 1, device=dev)
        shifted = buf[1:].view(pp[1].shape).copy_(pp[1])
        off = ([pp[0], shifted, pp[2]], pl, sizes)
        check(fused_sample._k4_mode(bench.N_COMP, (*pp, *pl))
              == fused_sample.K4_FLOAT4
              and fused_sample._k4_mode(bench.N_COMP, (*off[0], *pl))
              == fused_sample.K4_SCALAR, "K4's wrapper chose the wrong form")
        got = fused_sample.triplane_features(*off, xyz)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"K4 {case}: the scalar kernel "
              "differs from the plain version")
        del got, want
        rec = _timed(bench.time_k4, timing, packed, xyz)
        rec["scalar_device_ms"] = _timed(
            timing.device_ms_by_name,
            lambda: fused_sample.triplane_features(*off, xyz),
            (bench.K4_KERNEL,))[bench.K4_KERNEL]
        del off, shifted, buf
        rec["plain_ms"] = cuda_ms(
            lambda: triplane.triplane_features_packed(*packed, xyz), 3, 1)
        traffic = bench.k4_traffic(packed, xyz)
        rec.update(tables=label, points=n, stream=stream, max_abs_err=err,
                   bytes=k4_bytes, bound_ms=1e3 * k4_bytes / HBM_BYTES_PER_S,
                   floor_distinct_ms=1e3 * traffic["distinct"]
                   / HBM_BYTES_PER_S,
                   floor_every_point_ms=1e3 * traffic["every_point"]
                   / HBM_BYTES_PER_S)
        if case.startswith("bench_"):
            rec["ms"], rec["plain_ms"] = ab_ms(
                lambda: triplane.triplane_features_packed(*packed, xyz),
                lambda: fused_sample.triplane_features(*packed, xyz))
            k4[f"ms_{label}"] = rec["ms"]
            k4[f"plain_ms_{label}"] = rec["plain_ms"]
        if case == "bench_fine":
            k4.update(ms=rec["ms"], plain_ms=rec["plain_ms"],
                      device_ms=rec["device_ms"])
            _set_bound(k4, k4_bytes, 11 * n_ch * n)
        k4["cases"][case] = rec
        del packed, pp, pl, xyz
        torch.cuda.empty_cache()
    results["triplane_features"] = k4

    # K5: the wrapper triplane_features_bwd launches K5's kernel, one K6
    # kernel and PyTorch glue, so its back-to-back ms is split by kernel
    # name
    k5 = _kernel_entry(
        "fused_sample.cu", "evdeblurnerf_tpu/ops/fused_sample.py:112", 0.0, 0,
        0, max_rel_err=0.0, cases={},
        ms_is="the wrapper ops/fused_sample.py::triplane_features_bwd back "
        "to back: torch.zeros of the three plane gradients and of the line "
        "gradients, K5's kernel (device_ms; at these tables the fused one, "
        "which sums the line gradients itself, so k6_device_ms is 0) and "
        "three permute().contiguous() to [C, H, W]; glue_device_ms is the "
        "PyTorch part")
    for case, (label, n, stream) in bench.K5_CASES.items():
        planes, lines, packed, xyz, cot = bench.k5_inputs(dev, g, case)
        # K5 reads xyz, the cells and the cotangent, and writes the three
        # plane gradients, the three [C, D] line gradients and d(xyz);
        # the per-point line-row cotangents between it and K6 are scratch
        k5_bytes, n_ch = sampler_bytes(planes, lines, n)
        k5_bytes += (4 * sum(p.numel() for p in planes)
                     + 4 * sum(ln.numel() for ln in lines) + 4 * n * 3)
        k5_flops = 40 * n_ch * n
        at_bench = case.startswith("bench_")

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
        rel = 0.0
        for name, a, b in zip(("plane0", "plane1", "plane2", "line0",
                               "line1", "line2", "xyz"), got, want):
            err = float((a - b).abs().max())
            scale = float(b.abs().max())
            check(err <= GRAD_REL_TOL * scale,
                  f"K5 {case} d_{name}: max |kernel - plain| {err:.3e} "
                  f"exceeds {GRAD_REL_TOL} x {scale:.3e}")
            k5["max_abs_err"] = max(k5["max_abs_err"], err)
            rel = max(rel, err / scale)
        k5["max_rel_err"] = max(k5["max_rel_err"], rel)
        del got, want
        rec = _timed(bench.time_k5, timing, planes, lines, packed, xyz, cot)
        rec.update(tables=label, points=n, stream=stream, max_rel_err=rel,
                   bound_ms=1e3 * k5_bytes / HBM_BYTES_PER_S, bytes=k5_bytes)
        if at_bench:
            rec["ms"], rec["plain_ms"] = ab_ms(
                lambda: torch.autograd.grad(feats, leaves, cot,
                                            retain_graph=True),
                lambda: fused_sample.triplane_features_bwd(
                    planes, lines, packed, xyz, cot))
            k5[f"ms_{label}"] = rec["ms"]
            k5[f"plain_ms_{label}"] = rec["plain_ms"]
        if case == "bench_fine":
            k5.update({k: rec[k] for k in ("ms", "plain_ms", "device_ms",
                                           "k6_device_ms",
                                           "glue_device_ms")})
            _set_bound(k5, k5_bytes, k5_flops)
        k5["cases"][case] = rec
        del feats, leaves, pk, packed, planes, lines, xyz, cot
        torch.cuda.empty_cache()
    results["triplane_features_bwd"] = k5

    # K6 alone, one table a launch, at the fine and coarse 64-component
    # line tables (D rows of 2C = 128) and the fine 16-component one (32
    # wide), row indices uniform or those of the ray-ordered stream
    k6 = _kernel_entry("line_matmul.cu",
                       "evdeblurnerf_tpu/ops/line_matmul.py:39", 0.0, 0, 0,
                       max_rel_err=0.0, cases={})
    for case in bench.K6_CASES:
        idx, rows, D = bench.k6_inputs(dev, g, case)
        n, W = rows.shape
        got = line_matmul.line_grad(idx, rows, D)
        want = line_matmul.line_grad_plain(idx, rows, D)
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        check(err <= GRAD_REL_TOL * scale,
              f"K6 line_grad {case}: max |kernel - plain| {err:.3e} exceeds "
              f"{GRAD_REL_TOL} x {scale:.3e}")
        del got, want
        k6["max_abs_err"] = max(k6["max_abs_err"], err)
        k6["max_rel_err"] = max(k6["max_rel_err"], err / scale)
        rec = _timed(bench.time_k6, timing, idx, rows, D)
        # the index and g [N, W] read, the [D, W] table written; one add
        # per element of g
        k6_bytes = 4 * (n * (W + 1) + D * W)
        rec.update(D=D, W=W, points=n, stream=bench.K6_CASES[case][3],
                   max_rel_err=err / scale, bytes=k6_bytes,
                   bound_ms=1e3 * k6_bytes / HBM_BYTES_PER_S)
        if case == "bench":
            rec["ms"], rec["plain_ms"] = ab_ms(
                lambda: line_matmul.line_grad_plain(idx, rows, D),
                lambda: line_matmul.line_grad(idx, rows, D))
            k6.update({k: rec[k] for k in ("ms", "plain_ms", "device_ms",
                                           "library_ms")})
            _set_bound(k6, k6_bytes, n * W)
        k6["cases"][case] = rec
        del idx, rows
        torch.cuda.empty_cache()
    # K6 on a path. The paper's line tables fit the shared memory of K5's
    # fused kernel, so no training step launches K6; a sampler backward
    # over a 64-component line of 1024 rows does (K4 forward, K5's float4
    # kernel with scratch, then K6 for the three tables)
    from evdeblurnerf_torch import kernels

    planes, lines = [], []
    for i, c in enumerate(bench.N_COMP):
        m0, m1 = triplane.MAT_MODE[i]
        planes.append(0.1 * torch_randn(dev, g, c, K6_PATH_GRID[m1],
                                        K6_PATH_GRID[m0]))
        lines.append(0.1 * torch_randn(
            dev, g, c, K6_PATH_GRID[triplane.VEC_MODE[i]]))
    xyz = bench.sample_points(dev, g, K6_PATH_POINTS, "uniform")
    cot = torch_randn(dev, g, K6_PATH_POINTS, sum(bench.N_COMP))
    leaves = [t.clone().requires_grad_() for t in (*planes, *lines, xyz)]
    with torch.no_grad():
        packed = triplane.pack_grids(leaves[:3], leaves[3:6])
    kernels.reset_launches()
    fused_sample.sample_grids(leaves[:3], leaves[3:6], packed,
                              leaves[6]).backward(cot)
    torch.cuda.synchronize()
    path = dict(kernels.LAUNCHES)
    check(path["triplane_features"] == 1
          and path["triplane_features_bwd"] == 1 and path["line_grad"] == 1,
          f"the tall-table sampler backward launched {path}")
    want = fused_sample.triplane_features_bwd_plain(planes, lines, xyz, cot)
    for name, a, b in zip(("plane0", "plane1", "plane2", "line0", "line1",
                           "line2", "xyz"), [t.grad for t in leaves],
                          [*want[0], *want[1], want[2]]):
        err = float((a - b).abs().max())
        scale = float(b.abs().max())
        check(err <= GRAD_REL_TOL * scale,
              f"K5 + K6 tall tables d_{name}: max |kernel - plain| "
              f"{err:.3e} exceeds {GRAD_REL_TOL} x {scale:.3e}")
        k6["max_rel_err"] = max(k6["max_rel_err"], err / scale)
    k6.update(path_launches=path["line_grad"],
              path=f"sample_grids backward, {K6_PATH_POINTS} points, grid "
              f"{list(K6_PATH_GRID)}: line tables above the shared memory "
              "of K5's fused kernel")
    del planes, lines, leaves, packed, xyz, cot, want
    torch.cuda.empty_cache()
    results["line_grad"] = k6
    results["tiled_plane_gather"] = kernel_tiled_gather(dev)

    for name, r in results.items():
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        print(f"[3 kernel] {name}: max_abs_err {r['max_abs_err']:.3e}, "
              f"kernel {r['ms']:.4f} ms vs plain {r['plain_ms']:.4f} ms"
              + (f" (coarse tables: {r['ms_coarse']:.4f} vs "
                 f"{r['plain_ms_coarse']:.4f} ms)" if "ms_coarse" in r
                 else "")
              + f"; library call {lib}; bound {r['bound_ms']:.4f} ms by "
              f"{r['bound_by']} ({r['bytes']} bytes, {r['flops']} flops)")
        for suffix in ("", "_eval"):
            if f"device_cold_ms{suffix}" in r:
                print(f"[3 kernel] {name}{suffix}: " + _small_line(r, suffix))
        for case, c in r.get("cases", {}).items():
            print(f"[3 kernel] {name} {case}: " + _case_line(c))
    return results


_STREAMS = dict(uniform="uniform", rays="ray-ordered",
                eval_rays="ray-ordered (eval chunk)")


def _case_line(c):
    """One K4, K5 or K6 case: the wrapper's back-to-back ms beside the
    kernel's own device ms, the bound and the library call."""
    if "floor_distinct_ms" in c:       # K4
        return (f"{c['points']} {_STREAMS[c['stream']]} points, "
                f"{c['tables']} tables: kernel device {c['device_ms']:.4f} ms "
                f"(scalar form {c['scalar_device_ms']:.4f} ms), back to back "
                f"{c['ms']:.4f} ms, plain {c['plain_ms']:.4f} ms; library "
                f"call none; bound {c['bound_ms']:.4f} ms ({c['bytes']} "
                f"bytes); packed-table traffic floors: distinct rows "
                f"{c['floor_distinct_ms']:.4f} ms, every point's rows "
                f"{c['floor_every_point_ms']:.4f} ms; both forms bitwise "
                "equal to the plain version")
    if "tables" in c:       # K5
        return (f"{c['points']} {_STREAMS[c['stream']]} points, "
                f"{c['tables']} tables: "
                f"wrapper {c['ms']:.4f} ms = K5 kernel device "
                f"{c['device_ms']:.4f} ms + K6 kernel device "
                f"{c['k6_device_ms']:.4f} ms + PyTorch glue device "
                f"{c['glue_device_ms']:.4f} ms (+ gaps); library call none; "
                f"bound {c['bound_ms']:.4f} ms ({c['bytes']} bytes); max rel "
                f"err {c['max_rel_err']:.2e}")
    return (f"D = {c['D']}, W = {c['W']}, {c['points']} "
            f"{_STREAMS[c['stream']]} indices: wrapper {c['ms']:.4f} ms, kernel device "
            f"{c['device_ms']:.4f} ms, library call (index_add_) "
            f"{c['library_ms']:.4f} ms, bound {c['bound_ms']:.4f} ms "
            f"({c['bytes']} bytes); max rel err {c['max_rel_err']:.2e}")


def _small_line(r, suffix):
    """The device-time reading of one microsecond-scale kernel record."""
    parts = []
    if f"shape{suffix}" in r:
        parts.append(f"shape {r[f'shape{suffix}']}, back to back "
                     f"{r[f'ms{suffix}']:.4f} ms vs library "
                     f"{r[f'library_ms{suffix}']:.4f} ms, bound "
                     f"{r[f'bound_ms{suffix}']:.4f} ms")
    for role in ("kernel", "library", "plain"):
        prefix = "" if role == "kernel" else f"{role}_"
        if f"{prefix}device_ms{suffix}" in r:
            parts.append(
                f"{role} device {r[f'{prefix}device_ms{suffix}']:.4f} ms "
                f"(L2 flushed before each call: "
                f"{r[f'{prefix}device_cold_ms{suffix}']:.4f} ms), host {r[f'{prefix}host_us_per_call{suffix}']:.1f} us/call")
    return "; ".join(parts)


K7_TILES = ((32, 32), (64, 64), (48, 128))
K7_REL_TOL = 1e-6        # rows inside their tile, of the largest magnitude
K7_FALLBACK_TOL = 1e-5   # the patched output against a direct gather


@functools.cache
def _load_tool(name):
    """``tools/<name>.py`` as a module, loaded once."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _load_bench():
    """tools/bench_tiled_gather_torch.py: K7's entry point."""
    return _load_tool("bench_tiled_gather_torch")


def kernel_tiled_gather(dev):
    """K7 at its bench's shapes, against its plain twin, the fallback's
    direct gather and the two yardsticks."""
    import torch

    from evdeblurnerf_torch.ops import tiled_gather as tg

    bench = _load_bench()
    plane, fu, fv = bench.make_inputs(dev)
    H, W, C = plane.shape
    N = fu.shape[0]
    row_take, library = bench.yardsticks(plane, fu, fv)
    direct = tg.bilinear_gather(plane, fu, fv)
    entry = _kernel_entry(
        "tiled_gather.cu", "evdeblurnerf_tpu/ops/tiled_gather.py:70", 0.0, 0,
        0,
        # the plane (no more than four rows a point), the coordinates and
        # the origins read, [N, C] written; 6 products and 3 sums a channel
        4 * (min(plane.numel(), 4 * N * C) + 2 * N + 2 * N // tg.GROUP
             + N * C), 9 * N * C,
        library_ms=cuda_ms(library), row_take_ms=cuda_ms(row_take),
        points=N, plane=[H, W, C])
    for TH, TW in K7_TILES:
        tag = f"{TH}x{TW}"
        oy, ox, ok = tg.group_origins(fu, fv, H, W, TH, TW)
        got = tg.tiled_plane_gather(plane, fu, fv, oy, ox, TH, TW)
        want = tg.tiled_plane_gather_plain(plane, fu, fv, oy, ox, TH, TW)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        check(err <= K7_REL_TOL * scale,
              f"K7 {tag}: max |kernel - plain| {err:.3e} exceeds "
              f"{K7_REL_TOL} x {scale:.3e}")
        check(bool((got[~ok] == 0).all()),
              f"K7 {tag}: a spilled row is not zero")
        check(float((got[ok] - direct[ok]).abs().max())
              <= K7_FALLBACK_TOL * scale,
              f"K7 {tag}: rows inside their tile differ from the direct "
              "bilinear gather")
        spill = 1.0 - float(ok.float().mean())
        # the default capacity (an eighth of the points) unless this tile
        # spills more: then twice its spill share
        frac = min(1.0, max(0.125, 2 * spill))
        patched = tg.tiled_plane_gather_with_fallback(
            plane, fu, fv, TH, TW, spill_capacity_frac=frac)
        fb_err = float((patched - direct).abs().max())
        check(fb_err <= K7_FALLBACK_TOL * scale,
              f"K7 {tag}: fallback differs from the direct gather by "
              f"{fb_err:.3e}")
        bitwise = bool(torch.equal(got, want))
        del patched, want, got
        ms, plain_ms = ab_ms(
            lambda: tg.tiled_plane_gather_plain(plane, fu, fv, oy, ox, TH,
                                                TW),
            lambda: tg.tiled_plane_gather(plane, fu, fv, oy, ox, TH, TW))
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        entry[f"ms_{tag}"], entry[f"plain_ms_{tag}"] = ms, plain_ms
        entry[f"spill_{tag}"] = spill
        entry[f"bitwise_{tag}"] = bitwise
        entry[f"fallback_err_{tag}"] = fb_err
    # more spills than the capacity poison the output: 8x8 tiles spill
    # most of the stream, far past max(GROUP, N / 1000) rows
    poisoned = tg.tiled_plane_gather_with_fallback(
        plane, fu, fv, 8, 8, spill_capacity_frac=1e-3)
    check(bool(torch.isnan(poisoned).all()),
          "K7: over-capacity spills did not poison the output with NaN")
    entry["ms"], entry["plain_ms"] = entry["ms_64x64"], entry["plain_ms_64x64"]
    print("[3 kernel] tiled_plane_gather tiles: " + "; ".join(
        f"{TH}x{TW} kernel {entry[f'ms_{TH}x{TW}']:.3f} ms vs plain "
        f"{entry[f'plain_ms_{TH}x{TW}']:.3f} ms, spill "
        f"{100 * entry[f'spill_{TH}x{TW}']:.2f}%, bitwise "
        f"{entry[f'bitwise_{TH}x{TW}']}, fallback max err "
        f"{entry[f'fallback_err_{TH}x{TW}']:.2e}" for TH, TW in K7_TILES)
        + f"; packed row take {entry['row_take_ms']:.3f} ms; over-capacity "
        "case all NaN")
    return entry


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


@functools.cache
def _bench_torch():
    """``bench_torch.py`` beside this file, as a module."""
    spec = importlib.util.spec_from_file_location(
        "bench_torch", os.path.join(REPO, "bench_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def train_args(**overrides):
    """bench_torch.py::train_args: the paper configuration through the
    port's parser, kernel and CRF live from step 0, then ``overrides``."""
    return _bench_torch().train_args(**overrides)


def make_train_batch(dev, n_rand, events_n_rand):
    """bench_torch.py::make_train_batch."""
    return _bench_torch().make_train_batch(dev, n_rand, events_n_rand)


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
    for name in kernels.TRAIN_KERNELS:
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
    print(f"[6 train] paper step ({_bench_torch().PAPER_CONFIG}, kernel and CRF live from "
          f"step 0, grad_accum {args.grad_accum}): {n_rays} rays/step, "
          f"{TRAIN_STEPS} steps in {secs:.3f} s = {rate:.1f} train rays/s "
          f"({1e3 * secs / TRAIN_STEPS:.1f} ms/step) on {card}; peak "
          f"{peak_gib:.2f} GiB; CRF identity pre-fit {prefit_s:.1f} s; "
          f"losses {[round(v, 6) for v in losses]}; parameters changed "
          f"{ {g: f'{sum(f)}/{len(f)}' for g, f in changed.items()} }; "
          f"launches {launches}; launches per step "
          f"{ {k: v / TRAIN_STEPS for k, v in launches.items() if v} }")
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
    print(f"[7 train card vs cpu] {AB_RAYS}x{args.kernel_ptnum} + "
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


# ---------------------------------------------------------------------------
# phase 8: a training run through the CLI path
# ---------------------------------------------------------------------------
# the scene is tools/synthetic_scene_torch.py's; its image size only sets
# host work, the model and the batch are the paper configuration's
LOOP_STEPS_A, LOOP_STEPS_B = 24, 12
LOOP_GATES = dict(kernel_start_iter=4, add_event_egm_startiter=8,
                  tone_mapping_start_learn_iter=12)
LOOP_CKPT_EVERY = 16
LOOP_WARMUP_B = 2        # resumed steps left out of the timed window


def _read_png(path):
    """An 8-bit RGB PNG as [H, W, 3] uint8: through imageio where it is
    installed, else decoded here, which takes the unfiltered scanlines
    that the package's stdlib writer emits."""
    import numpy as np

    try:
        import imageio.v2 as imageio
    except ImportError:
        pass
    else:
        return np.asarray(imageio.imread(path))
    data = open(path, "rb").read()
    check(data[:8] == b"\x89PNG\r\n\x1a\n", f"{path}: not a PNG")
    pos, idat, shape = 8, b"", None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h, depth, colour = struct.unpack(">IIBB", body[:10])
            check((depth, colour) == (8, 2), f"{path}: not 8-bit RGB")
            shape = (h, w)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    h, w = shape
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    check(bool((raw[:, 0] == 0).all()), f"{path}: filtered scanlines")
    return raw[:, 1:].reshape(h, w, 3)


def _metric_stream(path, first_line=0):
    """({tag: [(step, value)]}, number of lines) of a ``metrics.jsonl``
    from line ``first_line`` on."""
    out, n = {}, 0
    with open(path) as f:
        for n, line in enumerate(f, 1):
            if n > first_line:
                rec = json.loads(line)
                if "value" in rec:
                    out.setdefault(rec["tag"], []).append(
                        (rec["step"], rec["value"]))
    return out, n


def phase_loop(dev, card, step_only):
    """Phase 8 (module docstring). ``step_only``: phase 6's figures."""
    import numpy as np
    import torch

    from evdeblurnerf_torch import cli, kernels, serving
    from evdeblurnerf_torch.data import (Prefetcher, RandomEventSampler,
                                         RandomRaySampler)
    from evdeblurnerf_torch.ops import events_native
    from evdeblurnerf_torch.train import loop as tloop
    from evdeblurnerf_torch.train.optim import lr_schedule

    synth = _load_tool("synthetic_scene_torch")
    llff_cls, events_cls = synth.scene_classes()
    with tempfile.TemporaryDirectory() as tmp:
        scene = os.path.join(tmp, "scene")
        os.makedirs(scene)
        t0 = time.perf_counter()
        n_events = synth.write_scene(scene, train_args().events_threshold,
                                     SEED)
        scene_s = time.perf_counter() - t0

        def flags(**extra):
            logs = os.path.join(tmp, "logs")
            merged = dict(datadir=scene, basedir=logs, tbdir=logs,
                          expname="loop", no_wandb=True, i_video=10 ** 9,
                          **extra)
            argv = ["--config", os.path.join(REPO,
                                             _bench_torch().PAPER_CONFIG)]
            for k, v in merged.items():
                argv += [f"--{k}", str(v)]
            return argv

        # the datasets once by hand: their build times, and the card's
        # batches against the CPU's on the same sampler seeds
        from evdeblurnerf_torch import config

        args = config.resolve_event_thresholds(config.parse_args(flags()))
        t0 = time.perf_counter()
        no_prior = argparse.Namespace(**{**vars(args), "use_pts0_prior": None})
        llff, ev = tloop.build_datasets(no_prior, llff_cls, events_cls)
        data_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        llff.set_pts0_prior(ev.compute_edi_prior(
            llff.i_train, llff.images, args.pts0_edi_steps,
            args.events_threshold_pos, args.events_threshold_neg))
        edi_s = time.perf_counter() - t0
        check(len(ev) >= args.events_N_rand,
              f"the scene has {len(ev)} events with a successor, fewer than "
              f"one batch of {args.events_N_rand}")

        def batches(device, n=3):
            rays = iter(RandomRaySampler(llff.n_rays, args.N_rand, seed=SEED))
            evs = iter(RandomEventSampler(len(ev), args.events_N_rand,
                                          seed=SEED))
            with Prefetcher(lambda: llff.batch(next(rays)),
                            device=device) as a, \
                    Prefetcher(lambda: ev.batch(next(evs)),
                               device=device) as b:
                return [({k: v.cpu() for k, v in next(a).items()},
                         {k: v.cpu() for k, v in next(b).items()})
                        for _ in range(n)]

        for (img_c, ev_c), (img_h, ev_h) in zip(batches(dev),
                                                batches("cpu")):
            for got, want in ((img_c, img_h), (ev_c, ev_h)):
                check(set(got) == set(want) and all(
                    torch.equal(got[k], want[k]) for k in want),
                    "a prefetched card batch differs from the CPU batch")
        aabb = np.asarray(llff.bounding_box).tolist()
        del llff, ev
        print(f"[8 loop] scene {synth.SCENE_IMAGES} images "
              f"{synth.SCENE_H}x{synth.SCENE_W}, "
              f"{n_events} events written in {scene_s:.1f} s; dataset build "
              f"{data_s:.2f} s, EDI prior {edi_s:.2f} s (event scans on "
              f"{events_native.backend()}); 3 prefetched card batches equal "
              "the CPU's")

        expdir = os.path.join(tmp, "logs", "loop")
        jsonl = os.path.join(expdir, "metrics.jsonl")
        kw = dict(llff_cls=llff_cls, events_cls=events_cls)
        # (a) train across the three gates, checkpoint mid-run, testset
        # render at the last step
        kernels.reset_launches()
        with _bench_torch().loop_timings(tloop) as tm_a:
            state = cli.main(flags(N_iters=LOOP_STEPS_A, i_print=4,
                                   i_tensorboard=4, i_weights=LOOP_CKPT_EVERY,
                                   i_testset=10 ** 9, **LOOP_GATES), **kw)
        launches_a = dict(kernels.LAUNCHES)
        check(state.step == LOOP_STEPS_A, f"run (a) ended at {state.step}")
        for name in kernels.TRAIN_KERNELS:
            check(launches_a[name] > 0, f"kernel {name} never launched in "
                  "the training run")
        ckpts = sorted(os.listdir(os.path.join(expdir, "checkpoints")))
        check(ckpts == [f"{LOOP_CKPT_EVERY + 1:06d}.tar",
                        f"{LOOP_STEPS_A:06d}.tar"], f"checkpoints {ckpts}")
        stream_a, lines_a = _metric_stream(jsonl)
        losses = stream_a["train/loss"]
        check([s for s, _ in losses] == [*range(0, LOOP_STEPS_A, 4),
                                         LOOP_STEPS_A - 1],
              f"logged steps {[s for s, _ in losses]}")
        # the Adam state across the gates: the learned CRF head has none
        # before its learn start, so its count lags the fields'
        opt_steps = sorted({int(s["step"]) for s in
                            state.optimizer.state.values()})
        check(opt_steps[-1] == LOOP_STEPS_A and opt_steps[0]
              == LOOP_STEPS_A - LOOP_GATES["tone_mapping_start_learn_iter"],
              f"Adam step counts {opt_steps}")
        del state
        torch.cuda.empty_cache()

        # (b) auto-resume from the newest checkpoint, train on; the only
        # reads off the device are at the first and the last step
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        with _bench_torch().loop_timings(tloop) as tm_b:
            state = cli.main(flags(N_iters=LOOP_STEPS_A + LOOP_STEPS_B,
                                   i_print=10 ** 9,
                                   i_tensorboard=LOOP_STEPS_A,
                                   i_weights=10 ** 9, i_testset=10 ** 9,
                                   **LOOP_GATES), **kw)
        torch.cuda.synchronize()
        launches_b = dict(kernels.LAUNCHES)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        check(state.step == LOOP_STEPS_A + LOOP_STEPS_B,
              f"run (b) ended at {state.step}")
        stream_b, _ = _metric_stream(jsonl, lines_a)
        first_step, first_lr = stream_b["train/lr"][0]
        want_lr = lr_schedule(args.lrate, args.lrate_decay,
                              args.lrate_warmup_iters,
                              args.lrate_warmup_factor)(LOOP_STEPS_A)
        check(first_step == LOOP_STEPS_A and first_lr == want_lr,
              f"resumed at step {first_step} with lr {first_lr}; saved step "
              f"{LOOP_STEPS_A}, lr {want_lr}")
        losses += stream_b["train/loss"]
        check(all(math.isfinite(v) for _, v in losses),
              f"non-finite loss: {losses}")
        marks = tm_b["step_marks"]
        check(len(marks) == LOOP_STEPS_B, f"{len(marks)} step marks")
        timed = LOOP_STEPS_B - 1 - LOOP_WARMUP_B
        loop_ms = marks[LOOP_WARMUP_B].ms_until(marks[-1]) / timed
        host_ms = 1e3 * sum(tm_b["step_call_s"][LOOP_WARMUP_B + 1:]) / timed
        del state
        torch.cuda.empty_cache()

        # (c) render-only from the final checkpoint
        cli.main(flags(render_only=True, render_test=True, **LOOP_GATES),
                 **kw)
        last = LOOP_STEPS_A + LOOP_STEPS_B
        lines = open(os.path.join(expdir, "test_metrics.txt")).read() \
            .splitlines()
        check(len(lines) == 2 and all(
            line.startswith(f"iter {s}: mse=") and " psnr=" in line
            and " ssim=" in line for line, s in
            zip(lines, (LOOP_STEPS_A - 1, last - 1))),
            f"test_metrics.txt: {lines}")
        tests = sorted(glob.glob(os.path.join(
            expdir, f"testset_{last - 1:06d}", "*.png")))
        renders = sorted(glob.glob(os.path.join(
            expdir, f"renderonly_test_{last:06d}", "*.png")))
        check(len(tests) == len(renders) == 3,
              f"{len(tests)} testset and {len(renders)} render-only images")
        for a, b in zip(tests, renders):
            check(bool((_read_png(a) == _read_png(b)).all()),
                  f"{os.path.basename(b)}: the render-only image differs "
                  "from the last testset render")

        # the checkpoint through the serving entry point
        sd = serving.load_network_state_dict(os.path.join(
            expdir, "checkpoints", f"{last:06d}.tar"))
        h, w, focal = synth.SCENE_H, synth.SCENE_W, synth.SCENE_FOCAL
        K = [[focal, 0.0, w / 2], [0.0, focal, h / 2], [0.0, 0.0, 1.0]]
        renderer = serving.build_renderer(args, sd, h, w, K, 0.0, 1.0, aabb,
                                          device=dev)
        check(len(renderer.unused_keys) > 0, "no blur-kernel keys in the "
              "checkpoint")
        del renderer, sd
        torch.cuda.empty_cache()

    rays = step_only["rays_per_step"]
    rate = rays / (loop_ms / 1e3)
    step_ms = 1e3 * step_only["seconds"] / TRAIN_STEPS
    print(f"[8 loop] {_bench_torch().PAPER_CONFIG} through cli.main on {card}: (a) "
          f"{LOOP_STEPS_A} steps across {LOOP_GATES}, checkpoints {ckpts}, "
          f"testset render; (b) resumed at step {first_step} with lr "
          f"{first_lr:.6g}, {LOOP_STEPS_B} steps; (c) render-only images "
          f"equal the last testset render's; losses "
          f"{[(s, round(v, 5)) for s, v in losses]}; Adam step counts "
          f"{opt_steps}")
    print(f"[8 loop] through the loop: {loop_ms:.1f} ms/step = {rate:.1f} "
          f"train rays/s over {timed} steps of run (b) on the device's "
          f"clock (step only, phase 6: {step_ms:.1f} ms/step, "
          f"{step_only['rays_per_s']:.1f} rays/s; host share "
          f"{100 * (loop_ms - step_ms) / loop_ms:.1f}%); host time inside the "
          f"step call {host_ms:.1f} ms/step; peak {peak_gib:.2f} GiB; "
          f"seconds: datasets {tm_a['build_datasets_s'][0]:.2f}, model "
          f"{tm_a['build_model_s'][0]:.2f}, state with the CRF pre-fit "
          f"{tm_a['build_initial_state_s'][0]:.2f}, checkpoint save "
          f"{[round(v, 2) for v in tm_a['checkpoint_s']]}, testset render "
          f"{[round(v, 2) for v in tm_a['run_test_renders_s']]}; launches "
          f"in (b) "
          f"{launches_b}")
    return launches_b, dict(loop_ms=loop_ms, rays_per_s=rate,
                            peak_gib=peak_gib, host_ms=host_ms)


def phase_bench_entry():
    """Phase 9: K7's own path through its entry point; returns its launch
    count on that path."""
    from evdeblurnerf_torch import kernels

    bench = _load_bench()
    kernels.reset_launches()
    print("[9 bench_tiled_gather_torch]")
    bench.main(["--iters", "3"])
    n = kernels.LAUNCHES["tiled_plane_gather"]
    check(n > 0, "kernel tiled_plane_gather never launched on its bench "
          "entry point")
    return n


def _train_state(args, device, h, w, focal, num_images, gen=None, sd=None):
    """(model, state) for ``args`` on ``device``, without the CRF pre-fit;
    weights drawn from ``gen`` or loaded from the state dict ``sd``."""
    import torch

    from evdeblurnerf_torch.train import state as tstate

    model, crf = tstate.build_model(args, AABB, h, w, focal, NEAR, FAR,
                                    num_images, gen, device)
    if sd is not None:
        model.load_state_dict(sd)
    return model, tstate.create_train_state(
        model, crf, args, gen or torch.Generator(device=device),
        crf_identity_prefit=False)


def phase_pbe(dev, card):
    """Phase 10 (module docstring): the PBE training step at full width,
    one DSK step, and a small PBE step on the card against the CPU."""
    import torch

    from evdeblurnerf_torch import kernels
    from evdeblurnerf_torch.train import step as tstep

    args = train_args(**PBE_FLAGS)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model, state = _train_state(args, dev, H, W, FOCAL, NUM_IMAGES, gen)
    step = tstep.build_train_step(args)
    sw_of = tstep.schedule_weights_fn(args, events_active=False)
    batch, _ = make_train_batch(dev, args.N_rand, args.events_N_rand)
    check(sw_of(1).use_pts0_target and sw_of(1).w_pts0 > 0
          and sw_of(1).w_img == 1.0,
          "the EDI-prior pts0 target is off in the PBE step")

    def one(fn=step):
        return fn(state, batch, None, sw_of(state.step), False, False)

    losses = [float(one()["loss"]) for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    timed = [one()["loss"] for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    losses += [float(v) for v in timed]
    check(all(math.isfinite(v) for v in losses), f"non-finite loss: {losses}")
    # step 0 has another ladder (blur_loss_after 0: the pts0 terms alone)
    check(losses[-1] < losses[1], f"the PBE loss did not fall: {losses}")
    for name in ("permute_lanes", "permute_lanes_bwd", "cdf_take",
                 "triplane_features", "triplane_features_bwd"):
        check(launches[name] > 0, f"kernel {name} never launched in the PBE "
              "step")
    # one more step for its gradients: through tanh * hwindow into the
    # pattern, and through the stage-0 features into the coarse field
    aux = one(tstep.build_train_step(args, return_grads=True))
    gmax = {n: float(g.abs().max()) for n, g in aux["grads"].items()
            if n == "kernelsnet.pattern_pos"
            or n.startswith(("mlp_coarse.app_plane", "mlp_coarse.app_line"))}
    check(len(gmax) == 7 and all(v > 0 for v in gmax.values()),
          f"zero or missing gradients in the PBE step: {gmax}")
    check(float(aux["pts0_loss"]) > 0, "the PBE step's pts0 loss is off")
    # rendered rays: every pattern point through stage 0 (coarse only) and
    # through the c2f render
    n_rays = args.N_rand * args.kernel_ptnum * 2
    rate = n_rays * TRAIN_STEPS / secs
    print(f"[10 pbe] PBE step at the paper's width (ptnum "
          f"{args.kernel_ptnum}, hwindow {args.kernel_hwindow}, "
          f"{args.N_rand} rays, EDI-prior pts0 target on, events off): "
          f"{TRAIN_STEPS} steps in {secs:.3f} s = "
          f"{1e3 * secs / TRAIN_STEPS:.1f} ms/step, {rate:.1f} train rays/s "
          f"counting {args.N_rand} x {args.kernel_ptnum} x 2 stages as "
          f"rendered rays, on {card}; peak {peak_gib:.2f} GiB; losses "
          f"{[round(v, 6) for v in losses]}; launches per step "
          f"{ {k: v / TRAIN_STEPS for k, v in launches.items() if v} }; "
          f"largest |gradient| {gmax}")
    pbe = dict(ms_per_step=1e3 * secs / TRAIN_STEPS, rays_per_s=rate,
               peak_gib=peak_gib, losses=losses, launches=launches)
    del model, state, aux, batch
    torch.cuda.empty_cache()

    # one DSK step with the align term
    args = train_args(**{**PBE_FLAGS, "kernel_type": "DSK",
                         "kernel_align_weight": 0.1})
    model, state = _train_state(args, dev, H, W, FOCAL, NUM_IMAGES, gen)
    batch, _ = make_train_batch(dev, args.N_rand, args.events_N_rand)
    sw = tstep.schedule_weights_fn(args, events_active=False)(0)
    aux = tstep.build_train_step(args)(state, batch, None, sw, False, False)
    align = float(aux["align_loss"])
    check(sw.w_align == 0.1 and math.isfinite(align) and align > 0
          and math.isfinite(float(aux["loss"])),
          f"DSK step: align {align}, weight {sw.w_align}, loss "
          f"{float(aux['loss'])}")
    print(f"[10 pbe] one DSK step at the same width, kernel_align_weight "
          f"0.1: loss {float(aux['loss']):.6f}, align {align:.6f}")
    del model, state, aux, batch
    torch.cuda.empty_cache()

    # the PBE step at a small size, card against CPU from one state dict
    bt = _bench_torch()
    args = train_args(**{**bt.TINY, **PBE_FLAGS, "perturb": 0.0,
                         "raw_noise_std": 0.0, "kernel_random_hwindow": 0.0})
    size = (bt.TINY_H, bt.TINY_W, bt.TINY_FOCAL)
    sw = tstep.schedule_weights_fn(args, events_active=False)(0)
    sd, out = None, []
    for device in (dev, torch.device("cpu")):
        model, state = _train_state(
            args, device, *size, NUM_IMAGES,
            torch.Generator(device=dev).manual_seed(SEED) if sd is None
            else None, sd)
        if sd is None:
            sd = {k: v.detach().cpu().clone()
                  for k, v in model.state_dict().items()}
        batch, _ = make_train_batch(device, args.N_rand, args.events_N_rand)
        out.append(float(tstep.build_train_step(args)(
            state, batch, None, sw, False, False)["loss"]))
        del model, state
    rel = abs(out[0] - out[1]) / abs(out[1])
    print(f"[10 pbe] small PBE step ({args.N_rand} rays x "
          f"{args.kernel_ptnum}, {args.N_samples}+{args.N_importance} "
          f"samples), card vs CPU from one state dict: loss {out[0]:.7g} vs "
          f"{out[1]:.7g} (rel {rel:.2e})")
    check(rel <= PBE_CPU_TOL, f"the small PBE step's loss differs by "
          f"{rel:.2e} relative between card and CPU")
    pbe["small_rel_loss"] = rel
    return pbe


def phase_bench_torch(step_only):
    """Phase 11: ``bench_torch.run()`` for ``step_only``, against phase
    6's time for the same step. The step is bound by the host's dispatch
    and the host's cores are shared, so a reading beyond the bound is taken
    again, ``BENCH_STEP_TRIES`` times in all; every reading is printed."""
    want = 1e3 * step_only["seconds"] / TRAIN_STEPS
    readings = []
    for _ in range(BENCH_STEP_TRIES):
        result = _bench_torch().run(iters=TRAIN_STEPS, only="step_only")
        readings.append(result["step_only"]["ms_per_step"])
        rel = abs(readings[-1] - want) / want
        if rel <= BENCH_STEP_TOL:
            break
    print(f"[11 bench_torch] step_only {readings[-1]:.1f} ms/step, "
          f"{result['step_only']['train_rays_per_s']:.1f} train rays/s, peak "
          f"{result['step_only']['peak_gib']:.2f} GiB on {result['card']} "
          f"(phase 6: {want:.1f} ms/step; differ by {100 * rel:.1f}%; "
          f"readings {[round(v, 1) for v in readings]})")
    check(rel <= BENCH_STEP_TOL, f"bench_torch's step_only readings "
          f"{readings} ms are not within {100 * BENCH_STEP_TOL:.0f}% of "
          f"phase 6's {want:.1f}")
    return result


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
    if not (os.path.isdir(os.path.join(REPO, "evdeblurnerf_torch"))
            and os.path.isfile(os.path.join(REPO, "bench_torch.py"))):
        print("chip_smoke: no evdeblurnerf_torch package and bench_torch.py "
              f"beside {__file__}; run it from the root of a checkout",
              file=sys.stderr)
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
        train_launches, sd, crf_sd, step_only = phase_train(dev, card)
        phase_train_card_vs_cpu(dev, sd, crf_sd)
        del sd, crf_sd
        loop_launches, _ = phase_loop(dev, card, step_only)
        bench_launches = phase_bench_entry()
        phase_pbe(dev, card)
        phase_bench_torch(step_only)
        loaded = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                         "evdeblurnerf_tpu")]
        check(not loaded, f"the port loaded {sorted(loaded)}")
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    # launches: of the training kernels in phase 6's timed steps, of K7 on
    # its bench entry point, of K6 on its tall-table sampler backward;
    # beside them the counts of the other paths
    # K6 on its own path in phase 3, since the paper's step needs it not
    for name, r in kernel_results.items():
        r["launches"] = (bench_launches if name == "tiled_plane_gather"
                         else r.pop("path_launches") if "path_launches" in r
                         else train_launches[name])
        r["launches_loop"] = loop_launches[name]
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
