#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``evdeblurnerf_torch``) on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card and the CUDA toolkit (``nvcc``), and exits non-zero, printing no
result, when either is missing or any check fails. It imports nothing of
jax and nothing of the JAX package. Its training flags, batch and loop
timer are ``bench_torch.py``'s. Phases, one line each (phase 3 one per
kernel and case, phase 8 a few):

1. environment: torch/CUDA versions, the card's name and power limit,
   ``--matmul_precision highest`` through the port's resolver
   (``utils/precision.py``: cuBLAS and cuDNN ``"ieee"``, TF32 off);
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
   cases and timers); and K4 (bitwise) and K5 (1e-5), each over f32 and
   over bf16 rows, on one rank's component slice of the fine tables under
   tensor parallelism, (32, 8, 8) at 2 ranks and (16, 4, 4) at 4, at the
   step's fine launch (cases ``tp2_step_fine``, ``tp4_step_fine``, with
   the form each takes);
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
11. ``bench_torch.run()`` for ``step_only`` with 5 timed steps: its eager
    reading's ms/step within 5% of phase 6's (a reading beyond that is
    taken again, three times in all: the step follows the shared host),
    its captured reading (the step the loop runs) printed beside it;
12. the vanilla-NeRF field (``mode=nerf``) and what came with it: 2 warm-up
    and 5 timed training steps at the reference's NeRF width (8 x 256
    coarse and fine MLPs, the paper configuration's RBK with 5 rays a
    pixel and AWP on 1,024 rays, 64+64 samples, EGM on 2 x 1,024 event
    rays through the learned event CRF), every loss finite and no TV term,
    every parameter group updated, K3 launched (its launches a step
    printed with ms/step and peak memory); one serving chunk of 32,768
    rays through ``serving.build_renderer`` in ``mode=nerf`` at that width,
    and its render of 1,024 rays on the card against the CPU's with phase
    5's limits; LPIPS on one 480x640 pair, card against CPU within 1e-4
    relative; a two-step run through ``cli.main`` with
    ``--profile_start_step 0 --profile_num_steps 2`` that leaves a Chrome
    trace holding the step range and device activity; a 30-iteration run of
    ``tools/validate_train_torch.py --profile small`` with a finite held-out
    PSNR and ``lpips_trunk=fallback`` in its ``test_metrics.txt``;
13. the fine cull and the occupancy coarse cull: (a) the paper step at full
    width with the fine cull 0.25 (32 of 128 fine lanes) and the coarse
    cull 0.25 (16 of 64 coarse lanes) on the occupancy grid of its
    weights, and the exact step on the same state, 2 warm-up steps each,
    then blocks of 5 in turns (exact, culled, culled, exact): ms/step,
    peak GiB, device ms a step split by kernel name, the occupancy
    refresh's ms, the culled launches a step, every loss finite and every
    training kernel launched; (b) phase 7's step with the two culls on the
    occupancy grid of phase 6's weights, card vs CPU: the card replays the
    CPU's selections, so the loss and gradients are held to phase 7's
    limits, and at most 0.1% of the card's own selected positions may
    differ from the CPU's; (c) one 480x640 pose through
    ``serving.build_renderer`` with ``--fine_cull_eval``, beside the exact
    render of the same weights; (d) an 8-step run through ``cli.main`` (the
    validation tool's small profile) across the coarse start at 3 and the
    fine start at 4, with ``train/occ_frac`` and
    ``train/coarse_cull_active`` logged at every refresh;
14. bf16 tables (``--triplane_bf16``): (a) K4's bf16-row form at 2,097,152
    uniform points and at the step's 1,310,720 ray-ordered points, and its
    bf16-compute form (the bf16 eval chain) at an eval chunk's 4,194,304
    points, each in its vector kernel (eight channels a lane) and its
    scalar kernel bitwise equal to its plain version, and K5's bf16 form at the step's launch sizes (1,310,720
    fine and 655,360 coarse points, uniform) and on the ray-ordered
    stream, every gradient within 1e-5 of the plain version's largest (the
    grid gradient exact f32, not bf16-rounded), each with its times,
    bound and traffic floors; (b) the paper step with bf16 tables and with
    f32 ones on one state (the tables repacked from the same grids), 2
    warm-up steps each, then blocks of 5 in turns (f32, bf16, bf16, f32):
    ms/step, peak GiB, device ms a step split by kernel name, the bf16
    launches a step (K4's and K5's bf16 forms, not their f32 ones); (c)
    phase 7's step with bf16 tables and the two culls of phase 13 (the JAX
    package's default training path) card vs CPU, the card replaying the
    CPU's selections, at phase 7's limits; (d) one 480x640 pose through
    ``serving.build_renderer`` with ``--triplane_bf16`` (the bf16 eval
    chain) beside the f32 render of phase 4's weights: eval rays/s, peak
    and the largest and p99 pixel difference;
15. the exported serving artifact: phase 4's model exported at the paper
    width (``serving.export_renderer``, chunk 32,768, the gamma CRF folded,
    packed tables) into ``build/chip_smoke/``, loaded in a fresh process
    that imports no module of ``evdeblurnerf_torch.models`` and renders
    one chunk through the kernels, held against the live renderer on the
    same rays (at most 1% of rays beyond 1e-5, the rest printed), one
    480x640 pose through the artifact and the live renderer in turns
    (eval rays/s), the file's size, load and first-call seconds, and the
    line of ``tools/bench_serving_torch.py``;
16. the parallel paths (``evdeblurnerf_torch/parallel``): (a)
    ``cli.main`` at phase 8's settings for 8 steps, twice plainly and
    once as rank 0 of a world of 1 under torchrun's variables, which joins
    NCCL, its losses within four times what the two plain runs differ by
    (K5's atomics), at least phase 7's loss bound; (b) data
    parallelism 2 x 1 and (c) tensor parallelism 1 x 2 (K4/K5 on (32, 8,
    8) slices), each two processes of ``tools/parallel_check_torch.py`` on
    this one card over gloo (NCCL refuses two ranks on one device), the
    paper step on the bench's global batch from phase 6's weights against
    the one-process step at phase 7's limits, every training kernel
    launched on every rank, ms/step and peak memory a rank (two ranks
    share one card: no scaling figure); (e) the checkpoint the TP ranks
    gathered, loaded in one process, renders what the TP model rendered
    (at most 1% of rays beyond 1e-5); (d) one 480x640 pose rendered
    data-parallel over 2 ranks against phase 4's render (the same bound).
    ``launches_parallel`` of every kernel is its count over the ranks of
    (b) and (c)'s compared steps;
17. ``--matmul_precision``: (a) each name through the resolver, read back
    through the per-backend settings (``highest`` ``"ieee"``, ``high`` and
    ``default`` ``"tf32"``), the CPU's oneDNN settings untouched; (b) the
    paper step at full width from phase 6's weights and batch at
    ``highest`` and at ``high``: two steps from one state at each (and at
    ``highest`` twice, the spread of K5's atomics), the losses relative to
    ``highest``; then 2 warm-up steps each and blocks of 5 in turns
    (highest, high, high, highest) on one state: ms/step, peak GiB, device
    ms a step split into GEMMs (cuBLAS kernel names) and the rest, every
    training kernel launched at ``high`` (``launches_precision_high``);
    (c) one 480x640 pose through ``serving.build_renderer`` at both:
    eval rays/s, device ms a chunk split the same way, the largest and p99
    pixel difference. ``high`` has no bound against ``highest`` beyond
    finite losses and renders: TF32 changes results by design;
18. the two tools: (a) ``tools/preprocess_events_torch.py`` on phase 8's
    scene (``--h/--w`` and the reader of its ``events.npz``), then phase
    8's dataset loads the sidecar with no scan (``compute_successor``
    counted), its successor graph equal to a fresh scan's; (b)
    ``tools/eval_cull_ab_torch.py`` at capacity 0.25 on the checkpoint of
    a 30-iteration validation run (phase 12's size): both arms finite,
    each within 1e-6 of ``render_chunk(fine_cull=...)`` of the restored
    checkpoint, K1, K3 and K4 launched in both (``launches_cull_ab``: the
    culled arm's). The script's wall time is printed before and after
    these two phases;
19. the captured training step (``train/capture.py``): (a) from phase 6's
    state and one generator state, 12 paper steps across the key change
    (the blur kernel's and the learned CRF's start brought to step 5), the
    eager step twice and the captured step: per-step loss within
    ``max(4 x spread, 1e-4)`` relative of the eager step's, spread being
    the two eager runs' difference (K5's atomics), the parameters after
    the window at phase 7's gradient limits, two graphs, the peak with
    both held; (b) one more replay under ``torch.profiler``: the launches
    of K1-K6 on the device by kernel name equal the eager step's counted
    launches, the graph's captured counts and what the replay adds to
    ``LAUNCHES`` (``launches_captured``: (a)'s captured run); (c) the
    exact, culled and bf16 paper steps, eager and captured on one state in
    turns: ms/step and peak; (d) DSK, PBE, ``mode=nerf`` and
    ``grad_accum 2`` at a small width, captured (one graph) or named eager
    by ``train/capture.py::EAGER``, 4 losses within phase 7's loss limit
    of the eager step's; (e) ``cli.main`` at the validation tool's small
    profile across the same key change with a checkpoint, then resumed:
    both keys captured, the resumed run's key captured again, the loss
    finite and falling.

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
    render_rmnearplane=0, rgb_add_bias=False, triplane_bf16=False,
    # the two culls off (phase 13 turns them on through train_args)
    fine_cull_capacity=0.0, fine_cull_eps=1e-3, coarse_cull_capacity=0.0,
    occ_grid_size=64, occ_eps=1e-4, occ_dilate=1, occ_probe_stride=8,
    coarse_num_layers=2, coarse_num_layers_color=3, coarse_hidden_dim=64,
    coarse_hidden_dim_color=64, coarse_app_dim=32,
    coarse_app_n_comp=[64, 16, 16], coarse_n_voxels=16777248,
    coarse_app_actfn="none",
    fine_num_layers=2, fine_num_layers_color=3, fine_hidden_dim=256,
    fine_hidden_dim_color=256, fine_app_dim=32, fine_geo_feat_dim=128,
    fine_app_n_comp=[64, 16, 16], fine_n_voxels=134217984,
    fine_app_actfn="none",
    kernel_type="RBK", kernel_feat_cnl=15,
    tone_mapping_type="gamma", tone_mapping_gamma=2.2, chunk=CHUNK,
    # the NeRF field's flags, unread by the c2f fields
    white_bkgd=False, rgb_activate="sigmoid", sigma_activate="relu",
    netdepth=8, netwidth=256, netdepth_fine=8, netwidth_fine=256)
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
# phase 12: the reference's NeRF width (configs of the DP-NeRF family)
NERF_FLAGS = dict(mode="nerf", netdepth=8, netwidth=256, netdepth_fine=8,
                  netwidth_fine=256, kernel_ptnum=5, N_rand=1024,
                  events_N_rand=1024, N_samples=64, N_importance=64)
LPIPS_TOL = 1e-4        # phase 12: LPIPS card vs CPU, relative
VALIDATE_ITERS = 30
BENCH_STEP_TOL = 0.05   # phase 11: bench_torch's step against phase 6's
BENCH_STEP_TRIES = 3
# K6's path: a sampler backward whose 64-component line (grid z) is too
# tall for K5 to reduce in shared memory (1024 x 68 floats = 272 KiB)
K6_PATH_GRID, K6_PATH_POINTS = (40, 36, 1024), 262_144
GRAD_REL_TOL = 1e-5     # K5 and K6: atomics sum in another order
TRAIN_RAYS, TRAIN_SAMPLES = 10240, 128   # the image render's fine pass
# phase 13: the culls of the JAX package's default training path, the fine
# cull at its JAX default and the occupancy coarse cull at the capacity of
# the JAX package's boxes-scene screen
CULL_FLAGS = dict(fine_cull_capacity=0.25, coarse_cull_capacity=0.25)
CULL_SAMPLES = 32       # round(0.25 * (64 + 64)) lanes the fine pass keeps
CULL_POS_MAX_SHARE = 1e-3   # selected positions card vs CPU
CULL_RUN_STEPS = 8      # the cli.main run across both start iterations
CULL_RUN_FLAGS = dict(kernel_start_iter=0, fine_cull_capacity=0.25,
                      fine_cull_start_iter=4, coarse_cull_capacity=0.5,
                      coarse_cull_start_iter=3, occ_refresh_every=2,
                      occ_gate_margin=0.0)
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
    from evdeblurnerf_torch.utils.precision import set_matmul_precision

    mode = set_matmul_precision("highest")
    print(f"[1 env] python {sys.version.split()[0]}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s), --matmul_precision "
          f"highest (cuBLAS and cuDNN {mode!r}: TF32 off)")
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
                           ((TRAIN_RAYS, CULL_SAMPLES), "_cull"),
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

    # K2: AWP's per-sample features [R, C, S] into depth order, and back;
    # first at the fine cull's kept width (phase 13), then at the full one
    C = 128
    _, perm_c, inv_c = lane_shuffle.sort_with_perm(
        torch.rand(TRAIN_RAYS, CULL_SAMPLES, generator=g, device=dev))
    x3 = torch_randn(dev, g, TRAIN_RAYS, C, CULL_SAMPLES).requires_grad_()
    out3 = lane_shuffle.permute_lanes(x3, perm_c, inv_c)
    cot3 = torch_randn(dev, g, TRAIN_RAYS, C, CULL_SAMPLES)
    out3.backward(cot3)
    check(torch.equal(out3, take(x3.detach(), perm_c))
          and torch.equal(x3.grad, take(cot3, inv_c)),
          f"K2 at [{TRAIN_RAYS}, {C}, {CULL_SAMPLES}] differs from its plain "
          "version")
    x3 = x3.detach()
    k2_cull = {}
    for name, (arg, idx, bwd) in (("permute_lanes_3d", (x3, perm_c, False)),
                                  ("permute_lanes_3d_bwd",
                                   (cot3, inv_c, True))):
        idx3 = idx.long()[:, None, :].expand(-1, C, -1)
        ms, plain_ms = ab_ms(lambda: take(arg, idx),
                             lambda: lane_shuffle._take(arg, idx, bwd))
        k2_cull[name] = dict(
            ms_cull=ms, plain_ms_cull=plain_ms,
            library_ms_cull=cuda_ms(lambda: torch.gather(arg, -1, idx3)),
            bound_ms_cull=1e3 * 4 * (2 * TRAIN_RAYS * C * CULL_SAMPLES
                                     + TRAIN_RAYS * CULL_SAMPLES)
            / HBM_BYTES_PER_S,
            shape_cull=[TRAIN_RAYS, C, CULL_SAMPLES])
    del x3, out3, cot3
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
    for name, extra in k2_cull.items():
        results[name].update(extra)
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
    # the library call: one torch.gather of the stacked (cdf, bins) by the
    # stacked (below, above), [2, 2, R, N]; the two stacks it needs are
    # timed apart (stack_ms)
    def stacks():
        return (torch.stack((cdf, bins))[:, None].expand(2, 2, R, M),
                torch.stack((below, above)).long()[None].expand(2, 2, R, N))

    src, idx = stacks()
    lib = torch.gather(src, -1, idx)
    check(all(torch.equal(lib[i, j], refs[2 * i + j]) for i in range(2)
              for j in range(2)), "K3's library call differs from its plain "
          "version")
    results["cdf_take"] = _kernel_entry(
        "lane_shuffle.cu", "evdeblurnerf_tpu/ops/lane_shuffle.py:259",
        max(float((a - b).abs().max()) for a, b in zip(outs, refs)), ms,
        plain_ms,
        # cdf and bins [R, M], two indices and four outputs [R, N]
        4 * R * (2 * M + 6 * N),
        library_ms=cuda_ms(lambda: torch.gather(src, -1, idx)),
        library_is="torch.gather of torch.stack((cdf, bins)) by "
        "torch.stack((below, above)), the stacks made beforehand",
        stack_ms=cuda_ms(stacks))
    small_kernel_times(
        results["cdf_take"],
        kernel=lambda: lane_shuffle.cdf_take(cdf, bins, below, above),
        plain=lambda: lane_shuffle.cdf_take_plain(cdf, bins, below, above),
        library=lambda: torch.gather(src, -1, idx))
    del src, idx, lib

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
        off = ([pp[0], _shifted(pp[1]), pp[2]], pl, sizes)
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
        del off
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
        if case == "bench":
            # the "default" precision: g rounded to bf16 before the sums
            got = line_matmul.line_grad(idx, rows, D, precision="default")
            want = line_matmul.line_grad_plain(idx, rows, D, "default")
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            check(err <= GRAD_REL_TOL * scale,
                  f"K6 line_grad precision default: max |kernel - plain| "
                  f"{err:.3e} exceeds {GRAD_REL_TOL} x {scale:.3e}")
            ms, plain_ms = ab_ms(
                lambda: line_matmul.line_grad_plain(idx, rows, D, "default"),
                lambda: line_matmul.line_grad(idx, rows, D, "default"))
            k6["cases"]["bench_default"] = dict(
                rec, precision="default", max_rel_err=err / scale, ms=ms,
                plain_ms=plain_ms, device_ms=_timed(
                    timing.device_ms_by_name,
                    lambda: line_matmul.line_grad(idx, rows, D, "default"),
                    (bench.K6_KERNEL,))[bench.K6_KERNEL])
            k6["max_rel_err"] = max(k6["max_rel_err"], err / scale)
            del got, want
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
    return (f"D = {c['D']}, W = {c['W']}, "
            f"precision {c.get('precision', 'highest')}, {c['points']} "
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
                                            peak_gib=peak_gib,
                                            rgbs=rgbs.cpu(),
                                            depths=depths.cpu())


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


class _Selections:
    """The culls' selections of one step, recorded on the CPU and replayed
    on the card: the card computes its own, counts the positions that
    differ from the CPU's, and goes on with the CPU's, so both sides take
    the same samples and differ only by the kernels' rounding."""

    def __init__(self):
        self.picks, self.replay, self.n_pos, self.n_diff = [], None, 0, 0

    def attach(self, model, replay: bool):
        self.replay = iter(self.picks) if replay else None
        for name in ("_cull_select", "_coarse_cull_select"):
            setattr(model, name, functools.partial(
                self._select, name, getattr(model, name)))

    def _select(self, name, select, *a):
        sel = select(*a)
        if self.replay is None:
            self.picks.append((name, sel.cpu()))
            return sel
        want_name, want = next(self.replay, (None, None))
        check(want_name == name and want.shape == sel.shape,
              f"card and CPU made different selections ({name})")
        self.n_pos += want.numel()
        self.n_diff += int((sel.cpu() != want).sum())
        return want.to(sel.device)

    def done(self):
        check(self.picks and next(self.replay, None) is None,
              "the card made fewer selections than the CPU")
        return self.n_diff / self.n_pos


def phase_train_card_vs_cpu(dev, sd, crf_sd, culls=None, flags=None,
                            label=None):
    """Phase 7: one training step card vs CPU from phase 6's weights. With
    ``culls`` (phase 13 (b)) the step takes the fine and coarse culls on
    the occupancy grid of those weights, built on the CPU and handed to
    both; the card replays the CPU's selections (:class:`_Selections`).
    ``flags``: more flags of the step (phase 14: bf16 tables), ``label``
    the printed line's prefix."""
    import torch

    from evdeblurnerf_torch.models.system import build_occ_grid
    from evdeblurnerf_torch.train import state as tstate
    from evdeblurnerf_torch.train import step as tstep

    args = train_args(perturb=0.0, raw_noise_std=0.0, no_log_grads_norm=True,
                      **(culls or {}), **(flags or {}))
    step = tstep.build_train_step(args, return_grads=True)
    sw = tstep.schedule_weights_fn(args)(1)
    selections = _Selections()
    grid = None
    out = []
    for device in (torch.device("cpu"), dev):
        model, crf = tstate.build_model(args, AABB, H, W, FOCAL, NEAR, FAR,
                                        NUM_IMAGES, device=device)
        model.load_state_dict(sd)
        crf.load_state_dict(crf_sd)
        if culls:
            if grid is None:
                grid = build_occ_grid(model)
            selections.attach(model, replay=device.type == "cuda")
        state = tstate.create_train_state(model, crf, args,
                                          torch.Generator(device=device),
                                          crf_identity_prefit=False)
        batch, ev_batch = make_train_batch(device, AB_RAYS, AB_EV_RAYS)
        aux = step(state, batch, ev_batch, sw, False, True,
                   fine_cull=bool(culls), coarse_cull=bool(culls),
                   occ_grid=None if grid is None else grid.to(device))
        out.append((float(aux["loss"]),
                    {n: g.cpu() for n, g in aux["grads"].items()}))
        del state, model, crf, aux
        torch.cuda.empty_cache()
    (loss_cpu, g_cpu), (loss_card, g_card) = out
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
    label = label or "[7 train card vs cpu]"
    result = dict(rel_loss=rel_loss, max_rel_grad=worst, share_beyond=share)
    if culls:
        result["pos_share_differing"] = selections.done()
        label = (f"{label if flags else '[13 cull]'} culled step (fine "
                 f"{args.fine_cull_capacity}, "
                 f"coarse {args.coarse_cull_capacity}, occupied share "
                 f"{float(grid.mean()):.4f}), the card replaying the CPU's "
                 f"selections, of whose {selections.n_pos} positions the "
                 f"card's own differ at {selections.n_diff} "
                 f"({result['pos_share_differing']:.2e});")
    print(f"{label} {AB_RAYS}x{args.kernel_ptnum} + "
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
    if culls:
        check(result["pos_share_differing"] <= CULL_POS_MAX_SHARE,
              f"{selections.n_diff} of {selections.n_pos} selected positions "
              "differ between card and CPU")
    return result


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
    """Phase 11: ``bench_torch.run()`` for ``step_only``: its eager
    reading against phase 6's time for the same (eager) step, its captured
    reading beside it. The eager step is bound by the host's dispatch and
    the host's cores are shared, so a reading beyond the bound is taken
    again, ``BENCH_STEP_TRIES`` times in all; every reading is printed."""
    want = 1e3 * step_only["seconds"] / TRAIN_STEPS
    readings = []
    for _ in range(BENCH_STEP_TRIES):
        result = _bench_torch().run(iters=TRAIN_STEPS, only="step_only")
        readings.append(result["step_only"]["eager"]["ms_per_step"])
        rel = abs(readings[-1] - want) / want
        if rel <= BENCH_STEP_TOL:
            break
    got = result["step_only"]
    print(f"[11 bench_torch] step_only eager {readings[-1]:.1f} ms/step, "
          f"{got['eager']['train_rays_per_s']:.1f} train rays/s, peak "
          f"{got['eager']['peak_gib']:.2f} GiB on {result['card']} "
          f"(phase 6: {want:.1f} ms/step; differ by {100 * rel:.1f}%; "
          f"readings {[round(v, 1) for v in readings]}); captured "
          f"{got['ms_per_step']:.1f} ms/step, {got['train_rays_per_s']:.1f} "
          f"train rays/s, peak {got['peak_gib']:.2f} GiB")
    check(rel <= BENCH_STEP_TOL, f"bench_torch's eager step_only readings "
          f"{readings} ms are not within {100 * BENCH_STEP_TOL:.0f}% of "
          f"phase 6's {want:.1f}")
    check(all(math.isfinite(v) for v in got["losses"]),
          f"bench_torch's captured losses {got['losses']}")
    return result


def _nerf_train(dev, card):
    """Phase 12, training: ``mode=nerf`` steps at the reference's width."""
    import torch

    from evdeblurnerf_torch import kernels
    from evdeblurnerf_torch.train import step as tstep

    args = train_args(**NERF_FLAGS)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model, state = _train_state(args, dev, H, W, FOCAL, NUM_IMAGES, gen)
    step = tstep.build_train_step(args)
    sw_of = tstep.schedule_weights_fn(args)
    batch, ev_batch = make_train_batch(dev, args.N_rand, args.events_N_rand)
    named = dict(model.named_parameters())
    before = {n: p.detach().clone() for n, p in named.items()}

    def one():
        return step(state, batch, ev_batch, sw_of(state.step), False, True)

    auxes = [one() for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    auxes += [one() for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(a["loss"]) for a in auxes]
    check(all(math.isfinite(v) for v in losses), f"non-finite loss: {losses}")
    check(all("tv_loss" not in a and float(a["event_egm"]) > 0
              for a in auxes), "mode=nerf step: a TV term, or no event loss")
    check(launches["cdf_take"] > 0, "K3 never launched in the mode=nerf step")
    changed = {}
    for n, p in named.items():
        changed.setdefault(_param_group(n), []).append(
            not torch.equal(before[n], p.detach()))
    for group, flags in changed.items():
        check(any(flags), f"no parameter of {group} changed in the mode=nerf "
              "steps")
    ms = 1e3 * secs / TRAIN_STEPS
    per_step = {k: v / TRAIN_STEPS for k, v in launches.items() if v}
    n_rays = args.N_rand * args.kernel_ptnum + 2 * args.events_N_rand
    print(f"[12 nerf] mode=nerf step ({args.netdepth}x{args.netwidth} and "
          f"{args.netdepth_fine}x{args.netwidth_fine} MLPs, RBK ptnum "
          f"{args.kernel_ptnum}, AWP {args.kernel_use_awp}, {args.N_rand} "
          f"rays, {args.N_samples}+{args.N_importance} samples, 2 x "
          f"{args.events_N_rand} event rays, learned event CRF): "
          f"{TRAIN_STEPS} steps in {secs:.3f} s = {ms:.1f} ms/step, "
          f"{n_rays * TRAIN_STEPS / secs:.1f} train rays/s on {card}; peak "
          f"{peak_gib:.2f} GiB; losses {[round(v, 6) for v in losses]}; "
          f"launches per step {per_step} (K3 {per_step.get('cdf_take', 0):g}); "
          f"parameters changed "
          f"{ {g: f'{sum(f)}/{len(f)}' for g, f in changed.items()} }")
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    del model, state, before, named, auxes
    torch.cuda.empty_cache()
    return args, sd, launches, dict(ms_per_step=ms, peak_gib=peak_gib,
                                    losses=losses, launches=launches)


def _nerf_serve(dev, args, sd):
    """Phase 12, serving: one chunk in ``mode=nerf``, and card vs CPU."""
    import torch

    from evdeblurnerf_torch import kernels, serving
    from evdeblurnerf_torch.train.evaluate import pose_rays

    K = [[FOCAL, 0.0, W / 2], [0.0, FOCAL, H / 2], [0.0, 0.0, 1.0]]
    args.chunk = CHUNK
    renderer = serving.build_renderer(args, sd, H, W, K, NEAR, FAR, AABB,
                                      device=dev)
    rays = pose_rays(make_poses()[:1], H, W, K, dev)[:CHUNK]
    renderer(rays)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    rgb, depth, acc = renderer(rays)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    check(bool(torch.isfinite(rgb).all() and torch.isfinite(depth).all()),
          "non-finite mode=nerf render")
    check(launches.get("cdf_take", 0) > 0,
          "K3 never launched in the mode=nerf serving chunk")
    sub = rays[torch.linspace(0, CHUNK - 1, CPU_RAYS, device=dev).long()]
    cpu = serving.build_renderer(args, sd, H, W, K, NEAR, FAR, AABB,
                                 device="cpu")
    with torch.inference_mode():
        card = renderer.model.render(sub)
        host = cpu.model.render(sub.cpu())
    diff = torch.zeros(CPU_RAYS)
    for key in ("rgb_map", "depth_map", "acc_map"):
        d = (card[key].cpu() - host[key]).abs()
        diff = torch.maximum(diff, d.reshape(CPU_RAYS, -1).max(-1)[0])
    beyond = float((diff > CPU_TOL).float().mean())
    print(f"[12 nerf] serving chunk of {CHUNK} rays in mode=nerf: "
          f"{1e3 * secs:.1f} ms = {CHUNK / secs:.1f} eval rays/s, launches "
          f"{launches}; card vs CPU on {CPU_RAYS} rays: max |diff| "
          f"{float(diff.max()):.3e}, share beyond {CPU_TOL}: {beyond:.4f}")
    check(beyond <= CPU_MAX_SHARE,
          f"mode=nerf: {beyond:.4f} of rays differ by more than {CPU_TOL}")
    del renderer, cpu
    torch.cuda.empty_cache()
    return dict(chunk_ms=1e3 * secs, share_beyond=beyond,
                max_abs_diff=float(diff.max()))


def _lpips_card_vs_cpu(dev):
    """Phase 12, LPIPS: one 480x640 pair on the card and on the CPU."""
    import numpy as np
    import torch

    from evdeblurnerf_torch.models.lpips import LPIPSScorer

    rng = np.random.default_rng(SEED)
    a = rng.uniform(-1, 1, (H, W, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.2, a.shape), -1, 1).astype(np.float32)
    card_scorer = LPIPSScorer.from_default(device=dev)
    card_scorer(a, b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    on_card = card_scorer(a, b)
    card_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    on_cpu = LPIPSScorer.from_default()(a, b)
    cpu_ms = 1e3 * (time.perf_counter() - t0)
    rel = abs(on_card - on_cpu) / abs(on_cpu)
    print(f"[12 nerf] LPIPS ({'pretrained' if card_scorer.pretrained_trunk else 'fallback'} "
          f"trunk) on one {H}x{W} pair: card {on_card:.7f} in {card_ms:.1f} "
          f"ms, CPU {on_cpu:.7f} in {cpu_ms:.1f} ms (rel {rel:.2e})")
    check(math.isfinite(on_card) and on_card > 0 and rel <= LPIPS_TOL,
          f"LPIPS card {on_card} vs CPU {on_cpu}")
    return rel


def _trace_and_validate(dev, tmp):
    """Phase 12: the trace window through ``cli.main``, and a short run of
    ``tools/validate_train_torch.py``."""
    from evdeblurnerf_torch import cli

    vtt = _load_tool("validate_train_torch")
    sst = _load_tool("synthetic_scene_torch")
    scene = os.path.join(tmp, "vscene")
    sst.write_synthetic_scene(scene)
    llff_cls, events_cls = sst.scene_classes()
    ns = argparse.Namespace(logdir=tmp, scene=scene, kernel="rbk",
                            cdavis=False)
    argv = vtt.make_cli(ns, 2) + vtt.SMALL_PROFILE + [
        "--expname", "trace", "--profile_start_step", "0",
        "--profile_num_steps", "2", "--tone_mapping_events_type", "none",
        "--device", str(dev)]
    t0 = time.perf_counter()
    cli.main(argv, llff_cls=llff_cls, events_cls=events_cls)
    traces = glob.glob(os.path.join(tmp, "trace", "profile", "*.json"))
    check(len(traces) == 1, f"trace window: files {traces}")
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    # the host's ranges (the device's copies are gpu_user_annotation)
    ranges = [e for e in events if e.get("name") == "train_step"
              and e.get("cat") == "user_annotation"]
    on_device = [e for e in events if e.get("cat") == "kernel"]
    print(f"[12 nerf] trace window, 2 steps through cli.main in "
          f"{time.perf_counter() - t0:.1f} s: {traces[0]} "
          f"({os.path.getsize(traces[0])} bytes, {len(ranges)} step ranges, "
          f"{len(on_device)} device kernels)")
    check(len(ranges) == 2 and on_device,
          f"trace window: {len(ranges)} step ranges, {len(on_device)} "
          "device kernels")

    t0 = time.perf_counter()
    vtt.main(["--iters", str(VALIDATE_ITERS), "--profile", "small",
              "--scene", scene, "--logdir", tmp, "--expname", "validate",
              "--device", str(dev)])
    secs = time.perf_counter() - t0
    with open(os.path.join(tmp, "validate", "test_metrics.txt")) as f:
        lines = f.read().splitlines()
    row = vtt.read_test_metrics(os.path.join(tmp, "validate"))
    last = row[max(row)]
    print(f"[12 nerf] tools/validate_train_torch.py --profile small, "
          f"{VALIDATE_ITERS} iterations in {secs:.1f} s: {lines[-1]}")
    check(len(lines) == 1 and math.isfinite(last["psnr"])
          and last.get("lpips_trunk") == "fallback",
          f"validation run wrote {lines}")
    return last


def phase_nerf(dev, card):
    """Phase 12 (module docstring)."""
    args, sd, launches, train = _nerf_train(dev, card)
    serve = _nerf_serve(dev, args, sd)
    lpips_rel = _lpips_card_vs_cpu(dev)
    with tempfile.TemporaryDirectory() as tmp:
        validate = _trace_and_validate(dev, tmp)
    return launches, dict(train=train, serve=serve, lpips_rel=lpips_rel,
                          validate=validate)

# ---------------------------------------------------------------------------
# phase 13: the fine cull and the occupancy coarse cull
# ---------------------------------------------------------------------------

def _culled_paper_step(dev, card, timing):
    """Phase 13 (a): the exact and the culled paper step on one state, in
    turns (exact, culled, culled, exact), with the occupancy refresh
    before the culled blocks. Returns the culled blocks' launches."""
    import torch

    from evdeblurnerf_torch import kernels
    from evdeblurnerf_torch.models.system import build_occ_grid
    from evdeblurnerf_torch.ops.occupancy import expected_keep_fraction
    from evdeblurnerf_torch.train import step as tstep

    args = train_args(**CULL_FLAGS)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model, state = _train_state(args, dev, H, W, FOCAL, NUM_IMAGES, gen)
    step = tstep.build_train_step(args)
    sw_of = tstep.schedule_weights_fn(args)
    batch, ev_batch = make_train_batch(dev, args.N_rand, args.events_N_rand)
    n_rays = args.N_rand * args.kernel_ptnum + 2 * args.events_N_rand
    grid = build_occ_grid(model)
    refresh_ms = cuda_ms(lambda: build_occ_grid(model), iters=5, warmup=1)
    occ_frac = float(grid.mean())

    def one(culled):
        return step(state, batch, ev_batch, sw_of(state.step), False, True,
                    fine_cull=culled, coarse_cull=culled, occ_grid=grid)

    losses = {True: [], False: []}
    for culled in (False, True):
        losses[culled] += [float(one(culled)["loss"])
                           for _ in range(TRAIN_WARMUP)]
    ms = {True: [], False: []}
    peak_gib = launches = None
    for culled in (False, True, True, False):
        torch.cuda.synchronize()
        if culled and launches is None:
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launches()
        t0 = time.perf_counter()
        timed = [one(culled)["loss"] for _ in range(TRAIN_STEPS)]
        torch.cuda.synchronize()
        ms[culled].append(1e3 * (time.perf_counter() - t0) / TRAIN_STEPS)
        if culled and launches is None:
            launches = dict(kernels.LAUNCHES)
            peak_gib = torch.cuda.max_memory_allocated() / 2**30
        losses[culled] += [float(v) for v in timed]
    names = ("permute_lanes_3d", "permute_lanes", "cdf_take",
             "triplane_fwd", "triplane_bwd")
    device_ms = {c: timing.device_ms_by_name(lambda: one(c), names, iters=2,
                                             warmup=0)
                 for c in (False, True)}
    for culled, vals in losses.items():
        check(all(math.isfinite(v) for v in vals),
              f"non-finite loss (culled {culled}): {vals}")
    for name in kernels.TRAIN_KERNELS:
        check(launches[name] > 0, f"kernel {name} never launched on the "
              "culled training step")
    per_step = {k: v / TRAIN_STEPS for k, v in launches.items() if v}
    total = {c: sum(d.values()) for c, d in device_ms.items()}
    keep = expected_keep_fraction(occ_frac, args.occ_probe_stride)
    print(f"[13 cull] paper step with the fine cull {args.fine_cull_capacity}"
          f" ({CULL_SAMPLES} of 128 fine lanes) and the coarse cull "
          f"{args.coarse_cull_capacity} ({round(args.coarse_cull_capacity * 64)}"
          f" of 64 coarse lanes; occupancy grid {args.occ_grid_size}^3 of "
          f"the random weights, occupied share {occ_frac:.4f}, expected kept "
          f"share {keep:.4f}) on {card}, {TRAIN_STEPS} steps a block, in "
          f"turns: culled {[round(v, 1) for v in ms[True]]} ms/step, exact "
          f"{[round(v, 1) for v in ms[False]]} ms/step; culled "
          f"{n_rays * 1e3 / min(ms[True]):.1f} train rays/s; peak "
          f"{peak_gib:.2f} GiB (culled block); device ms/step culled "
          f"{total[True]:.2f} {_round(device_ms[True])}, exact "
          f"{total[False]:.2f} {_round(device_ms[False])}; occupancy refresh "
          f"{refresh_ms:.3f} ms; culled launches per step {per_step}; losses "
          f"culled {[round(v, 6) for v in losses[True]]}, exact "
          f"{[round(v, 6) for v in losses[False]]}")
    del state, model
    torch.cuda.empty_cache()
    return launches, dict(ms_per_step=ms, peak_gib=peak_gib,
                          device_ms_per_step=total, refresh_ms=refresh_ms,
                          occ_frac=occ_frac)


def _round(d):
    return {k: round(v, 3) for k, v in d.items()}


def _culled_serve(dev, card):
    """Phase 13 (c): one 480x640 pose through ``serving.build_renderer``
    with ``--fine_cull_eval``, beside the exact render of the same
    weights, both through ``bench_torch.bench_serve``."""
    out = {}
    for name, extra in (("exact", {}),
                        ("culled", dict(fine_cull_capacity=0.25,
                                        fine_cull_eval=True))):
        args = train_args(chunk=CHUNK, **extra)
        out[name] = _bench_torch().bench_serve(args, dev, H, W, FOCAL)
    for k in ("permute_lanes", "cdf_take", "triplane_features"):
        check(out["culled"]["launches"].get(k, 0) > 0,
              f"kernel {k} never launched in the culled serving render")
    print(f"[13 cull] one {H}x{W} pose with --fine_cull_eval "
          f"({CULL_SAMPLES} of 128 fine lanes) on {card}: "
          f"{out['culled']['eval_rays_per_s']:.1f} eval rays/s, peak "
          f"{out['culled']['peak_gib']:.2f} GiB, device ms a chunk "
          f"{_round(out['culled']['device_ms_per_chunk'])}; exact, same "
          f"call: {out['exact']['eval_rays_per_s']:.1f} eval rays/s, device "
          f"ms a chunk {_round(out['exact']['device_ms_per_chunk'])}; culled "
          f"launches {out['culled']['launches']}")
    return out


def _culled_run(dev, tmp):
    """Phase 13 (d): a short run through ``cli.main`` (the validation tool
    at its small profile) across both cull start iterations, the grid
    refreshed at the coarse start and every 2 steps after."""
    from evdeblurnerf_torch import kernels

    vtt = _load_tool("validate_train_torch")
    sst = _load_tool("synthetic_scene_torch")
    scene = os.path.join(tmp, "cscene")
    sst.write_synthetic_scene(scene)
    argv = ["--iters", str(CULL_RUN_STEPS), "--profile", "small", "--scene",
            scene, "--logdir", tmp, "--expname", "cull", "--device",
            str(dev), "--i_tensorboard", "1"]
    for k, v in CULL_RUN_FLAGS.items():
        argv += [f"--{k}", str(v)]
    kernels.reset_launches()
    t0 = time.perf_counter()
    vtt.main(argv)
    secs = time.perf_counter() - t0
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    stream, _ = _metric_stream(os.path.join(tmp, "cull", "metrics.jsonl"))
    start = CULL_RUN_FLAGS["coarse_cull_start_iter"]
    want = list(range(start, CULL_RUN_STEPS,
                      CULL_RUN_FLAGS["occ_refresh_every"]))
    frac = stream.get("train/occ_frac", [])
    active = stream.get("train/coarse_cull_active", [])
    losses = stream.get("train/loss", [])
    print(f"[13 cull] cli.main, {CULL_RUN_STEPS} steps across the coarse "
          f"start {start} and the fine start "
          f"{CULL_RUN_FLAGS['fine_cull_start_iter']} in {secs:.1f} s: "
          f"train/occ_frac {frac}, train/coarse_cull_active {active}, losses "
          f"{[(s, round(v, 5)) for s, v in losses]}, launches {launches}")
    check([s for s, _ in frac] == want and [s for s, _ in active] == want,
          f"occupancy scalars at {[s for s, _ in frac]}, expected {want}")
    check(all(v == 1.0 for _, v in active) and all(
        0.0 <= v <= 1.0 for _, v in frac), "occupancy scalars out of range")
    check(len(losses) == CULL_RUN_STEPS
          and all(math.isfinite(v) for _, v in losses),
          f"culled run losses {losses}")
    for name in kernels.TRAIN_KERNELS:
        check(launches.get(name, 0) > 0, f"kernel {name} never launched in "
              "the culled run")
    return dict(seconds=secs, occ_frac=frac)


def phase_cull(dev, card, sd, crf_sd):
    """Phase 13 (module docstring), (b) on phase 6's weights."""
    timing = _load_tool("timing_torch")
    launches, step = _culled_paper_step(dev, card, timing)
    ab = phase_train_card_vs_cpu(dev, sd, crf_sd, culls=CULL_FLAGS)
    serve = _culled_serve(dev, card)
    with tempfile.TemporaryDirectory() as tmp:
        run = _culled_run(dev, tmp)
    return launches, dict(step=step, card_vs_cpu=ab, serve=serve, run=run)


# ---------------------------------------------------------------------------
# phase 14: bf16 tables (--triplane_bf16)
# ---------------------------------------------------------------------------

BF16_FLAGS = dict(triplane_bf16=True)
# K4's and K5's bf16 forms, case (bench_kernel_variants_torch.py's) and the
# table types each reads
BF16_K4_CASES = (("triplane_features_bf16", "bench_fine", False),
                 ("triplane_features_bf16", "rays_fine", False),
                 ("triplane_features_bf16_compute", "eval_fine", True))
BF16_K5_CASES = ("step_fine", "step_coarse", "rays_fine")


def _bf16_packed(planes, lines):
    import torch

    from evdeblurnerf_torch.ops import triplane

    return triplane.pack_grids([p.to(torch.bfloat16) for p in planes],
                               [l.to(torch.bfloat16) for l in lines])


def _bf16_kernels(dev, g, bench, timing):
    """Phase 14 (a): K4's two bf16 forms bitwise against their twins and
    K5's bf16 form within 1e-5, each with its times and bound; returns
    their kernel records (the launches are the main path's, set later)."""
    import torch

    from evdeblurnerf_torch.ops import fused_sample, triplane

    records = {}
    for name, case, compute in BF16_K4_CASES:
        planes, lines, f32_packed, xyz = bench.k4_inputs(dev, g, case)
        del f32_packed
        n = xyz.shape[0]
        n_ch = sum(p.shape[0] for p in planes)
        # xyz read, the touched bf16 cells, the output written (f32, or
        # bf16 under the chain)
        nbytes = (4 * n * 3 + (2 if compute else 4) * n * n_ch
                  + sum(_touched_bytes(p, n, 4) for p in planes) // 2
                  + sum(_touched_bytes(ln, n, 2) for ln in lines) // 2)
        packed = _bf16_packed(planes, lines)
        del planes, lines

        def kernel():
            return fused_sample.triplane_features(*packed, xyz,
                                                  compute_bf16=compute)

        def plain():
            return triplane.triplane_features_packed(*packed, xyz,
                                                     compute_bf16=compute)

        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        check(torch.equal(got, want) and got.dtype == (
            torch.bfloat16 if compute else torch.float32),
              f"K4 {name} {case}: differs from its plain version by "
              f"{err:.3e}")
        pp, pl, sizes = packed
        off = ([pp[0], _shifted(pp[1]), pp[2]], pl, sizes)
        check(fused_sample._k4_mode(bench.N_COMP, (*pp, *pl, got))
              == fused_sample.K4_VEC8
              and fused_sample._k4_mode(bench.N_COMP, (*off[0], *pl))
              == fused_sample.K4_SCALAR, f"K4 {name}: the wrong form")
        scalar = fused_sample.triplane_features(*off, xyz,
                                                compute_bf16=compute)
        check(torch.equal(scalar, want),
              f"K4 {name} {case}: the scalar kernel differs from the plain "
              "version")
        del got, want, scalar
        ms, plain_ms = ab_ms(plain, kernel)
        traffic = bench.k4_traffic(packed, xyz, 2 if compute else 4)
        rec = dict(tables="fine", points=n, stream=bench.K4_CASES[case][2],
                   max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   device_ms=_timed(timing.device_ms_by_name, kernel,
                                    (bench.K4_KERNEL,))[bench.K4_KERNEL],
                   scalar_device_ms=_timed(
                       timing.device_ms_by_name,
                       lambda: fused_sample.triplane_features(
                           *off, xyz, compute_bf16=compute),
                       (bench.K4_KERNEL,))[bench.K4_KERNEL],
                   bytes=nbytes, bound_ms=1e3 * nbytes / HBM_BYTES_PER_S,
                   floor_distinct_ms=1e3 * traffic["distinct"]
                   / HBM_BYTES_PER_S,
                   floor_every_point_ms=1e3 * traffic["every_point"]
                   / HBM_BYTES_PER_S)
        if name not in records:
            records[name] = _kernel_entry(
                "fused_sample.cu", "evdeblurnerf_tpu/ops/fused_sample.py:92",
                err, ms, plain_ms, nbytes, 11 * n_ch * n, cases={},
                device_ms=rec["device_ms"],
                tables="bf16 rows, f32 math and output" if not compute
                else "bf16 rows, math and output (the bf16 eval chain)")
        records[name]["cases"][case] = rec
        records[name]["max_abs_err"] = max(records[name]["max_abs_err"], err)
        del packed, off, pp, pl, xyz
        torch.cuda.empty_cache()

    k5 = None
    for case in BF16_K5_CASES:
        planes, lines, f32_packed, xyz, cot = bench.k5_inputs(dev, g, case)
        del f32_packed
        n = xyz.shape[0]
        n_ch = sum(p.shape[0] for p in planes)
        # xyz, the touched bf16 cells and the cotangent read; the f32 plane
        # and line gradients and d(xyz) written
        nbytes = (4 * n * (3 + n_ch)
                  + sum(_touched_bytes(p, n, 4) for p in planes) // 2
                  + sum(_touched_bytes(ln, n, 2) for ln in lines) // 2
                  + 4 * sum(p.numel() for p in planes)
                  + 4 * sum(ln.numel() for ln in lines) + 4 * n * 3)
        packed = _bf16_packed(planes, lines)

        def kernel():
            return fused_sample.triplane_features_bwd(planes, lines, packed,
                                                      xyz, cot)

        got = kernel()
        got = [*got[0], *got[1], got[2]]
        leaves = [t.clone().requires_grad_() for t in (*planes, *lines, xyz)]
        pk = triplane.pack_grids(leaves[:3], leaves[3:6])
        pk = ([triplane.round_bf16(t) for t in pk[0]],
              [triplane.round_bf16(t) for t in pk[1]], pk[2])
        feats = triplane.triplane_features_packed(*pk, leaves[6])
        want = torch.autograd.grad(feats, leaves, cot, retain_graph=True)
        rel = err = 0.0
        for gname, a, b in zip(("plane0", "plane1", "plane2", "line0",
                                "line1", "line2", "xyz"), got, want):
            e = float((a - b).abs().max())
            scale = float(b.abs().max())
            check(e <= GRAD_REL_TOL * scale,
                  f"K5 bf16 {case} d_{gname}: max |kernel - plain| {e:.3e} "
                  f"exceeds {GRAD_REL_TOL} x {scale:.3e}")
            err, rel = max(err, e), max(rel, e / scale)
        check(not torch.equal(got[0], got[0].to(torch.bfloat16).float()),
              "K5 bf16: the plane gradient is bf16-rounded")
        del got, want
        ms, plain_ms = ab_ms(
            lambda: torch.autograd.grad(feats, leaves, cot,
                                        retain_graph=True), kernel)
        parts = _timed(timing.device_ms_by_name, kernel,
                       (bench.K5_KERNEL, bench.K6_KERNEL))
        rec = dict(tables=bench.K5_CASES[case][0], points=n,
                   stream=bench.K5_CASES[case][2], max_rel_err=rel, ms=ms,
                   plain_ms=plain_ms, device_ms=parts[bench.K5_KERNEL],
                   k6_device_ms=parts[bench.K6_KERNEL],
                   glue_device_ms=parts["other"], bytes=nbytes,
                   bound_ms=1e3 * nbytes / HBM_BYTES_PER_S)
        if k5 is None:
            k5 = _kernel_entry(
                "fused_sample.cu", "evdeblurnerf_tpu/ops/fused_sample.py:112",
                err, ms, plain_ms, nbytes, 40 * n_ch * n, cases={},
                max_rel_err=rel, device_ms=rec["device_ms"],
                tables="bf16 rows; f32 cotangent and gradients")
        k5["cases"][case] = rec
        k5["max_abs_err"] = max(k5["max_abs_err"], err)
        k5["max_rel_err"] = max(k5["max_rel_err"], rel)
        del feats, leaves, pk, packed, planes, lines, xyz, cot
        torch.cuda.empty_cache()
    records["triplane_features_bwd_bf16"] = k5
    for name, r in records.items():
        for case, c in r["cases"].items():
            print(f"[14 bf16] {name} {case}: " + _case_line(c))
    return records


def _shifted(t):
    """A contiguous copy of ``t`` one element off its vector boundary."""
    import torch

    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def _set_tables(model, bf16):
    """The voxel fields' tables to bf16 or f32, repacked from the same
    grids: one state, two table types."""
    for field in (model.mlp_coarse, model.mlp_fine):
        field.table_bf16 = bf16
        field.pack_tables()


def _bf16_paper_step(dev, card, timing):
    """Phase 14 (b): the paper step with bf16 tables and with f32 ones on
    one state, in turns (f32, bf16, bf16, f32); returns the bf16 blocks'
    launches."""
    import torch

    from evdeblurnerf_torch import kernels
    from evdeblurnerf_torch.train import step as tstep

    args = train_args(**BF16_FLAGS)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model, state = _train_state(args, dev, H, W, FOCAL, NUM_IMAGES, gen)
    step = tstep.build_train_step(args)
    sw_of = tstep.schedule_weights_fn(args)
    batch, ev_batch = make_train_batch(dev, args.N_rand, args.events_N_rand)
    n_rays = args.N_rand * args.kernel_ptnum + 2 * args.events_N_rand

    def one():
        return step(state, batch, ev_batch, sw_of(state.step), False, True)

    losses = {True: [], False: []}
    for bf16 in (False, True):
        _set_tables(model, bf16)
        losses[bf16] += [float(one()["loss"]) for _ in range(TRAIN_WARMUP)]
    ms = {True: [], False: []}
    peak = {}
    launches = None
    for bf16 in (False, True, True, False):
        _set_tables(model, bf16)
        torch.cuda.synchronize()
        first = bf16 not in peak
        if first:
            torch.cuda.reset_peak_memory_stats()
        if bf16 and launches is None:
            kernels.reset_launches()
        t0 = time.perf_counter()
        timed = [one()["loss"] for _ in range(TRAIN_STEPS)]
        torch.cuda.synchronize()
        ms[bf16].append(1e3 * (time.perf_counter() - t0) / TRAIN_STEPS)
        if first:
            peak[bf16] = torch.cuda.max_memory_allocated() / 2**30
        if bf16 and launches is None:
            launches = dict(kernels.LAUNCHES)
        losses[bf16] += [float(v) for v in timed]
    names = ("permute_lanes_3d", "permute_lanes", "cdf_take",
             "triplane_fwd", "triplane_bwd")
    device_ms = {}
    for bf16 in (False, True):
        _set_tables(model, bf16)
        device_ms[bf16] = _timed(timing.device_ms_by_name, one, names, 2, 0)
    for bf16, vals in losses.items():
        check(all(math.isfinite(v) for v in vals),
              f"non-finite loss (bf16 {bf16}): {vals}")
    for name in kernels.BF16_TRAIN_KERNELS:
        check(launches[name] > 0, f"kernel {name} never launched on the "
              "bf16 training step")
    check(launches["triplane_features"] == 0
          and launches["triplane_features_bwd"] == 0,
          f"the bf16 step launched the f32 forms: {launches}")
    per_step = {k: v / TRAIN_STEPS for k, v in launches.items() if v}
    total = {b: sum(d.values()) for b, d in device_ms.items()}
    print(f"[14 bf16] paper step with bf16 tables on {card}, "
          f"{TRAIN_STEPS} steps a block, in turns with the f32 tables on "
          f"one state: bf16 {[round(v, 1) for v in ms[True]]} ms/step, f32 "
          f"{[round(v, 1) for v in ms[False]]} ms/step; bf16 "
          f"{n_rays * 1e3 / min(ms[True]):.1f} train rays/s; peak bf16 "
          f"{peak[True]:.2f} GiB, f32 {peak[False]:.2f} GiB; device ms/step "
          f"bf16 {total[True]:.2f} {_round(device_ms[True])}, f32 "
          f"{total[False]:.2f} {_round(device_ms[False])}; bf16 launches "
          f"per step {per_step}; losses bf16 "
          f"{[round(v, 6) for v in losses[True]]}, f32 "
          f"{[round(v, 6) for v in losses[False]]}")
    del state, model
    torch.cuda.empty_cache()
    return launches, dict(ms_per_step=ms, peak_gib=peak,
                          device_ms_per_step=total)


def _bf16_serve(dev, card, sd):
    """Phase 14 (d): one 480x640 pose through ``serving.build_renderer``
    with the bf16 eval chain and with f32 tables, same weights (phase 4's):
    eval rays/s and the largest pixel difference. Returns the bf16
    render's launches."""
    import torch

    from evdeblurnerf_torch import kernels, serving

    K = [[FOCAL, 0.0, W / 2], [0.0, FOCAL, H / 2], [0.0, 0.0, 1.0]]
    pose = make_poses()[:1]
    out, rgbs = {}, {}
    for name, bf16 in (("f32", False), ("bf16", True)):
        args = argparse.Namespace(**dict(SERVE_FLAGS, triplane_bf16=bf16))
        r = serving.build_renderer(args, sd, H, W, K, NEAR, FAR, AABB,
                                   device=dev)
        check(r.model.mlp_fine.eval_bf16(False) is bf16,
              f"the {name} renderer's eval chain")
        warm = torch.zeros(CHUNK, 3, 2, device=dev)
        warm[:, 2, 1] = -1.0
        r(warm)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        rgb, depth = r.render_poses(pose)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        out[name] = dict(eval_rays_per_s=H * W / secs,
                         peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                         launches={k: v for k, v in kernels.LAUNCHES.items()
                                   if v})
        check(bool(torch.isfinite(rgb).all() and torch.isfinite(depth).all()),
              f"non-finite {name} render")
        rgbs[name] = rgb
        del r
        torch.cuda.empty_cache()
    check(out["bf16"]["launches"].get("triplane_features_bf16_compute", 0) > 0
          and "triplane_features" not in out["bf16"]["launches"],
          f"the bf16 render launched {out['bf16']['launches']}")
    diff = (rgbs["bf16"] - rgbs["f32"]).abs()
    out["pixel_max_diff"] = float(diff.max())
    out["pixel_p99_diff"] = float(torch.quantile(
        diff.reshape(-1)[::7].float(), 0.99))
    print(f"[14 bf16] one {H}x{W} pose through the bf16 eval chain on "
          f"{card}: {out['bf16']['eval_rays_per_s']:.1f} eval rays/s, peak "
          f"{out['bf16']['peak_gib']:.2f} GiB, launches "
          f"{out['bf16']['launches']}; f32 tables, same weights and call: "
          f"{out['f32']['eval_rays_per_s']:.1f} eval rays/s, peak "
          f"{out['f32']['peak_gib']:.2f} GiB; rgb |bf16 - f32| max "
          f"{out['pixel_max_diff']:.3e}, p99 {out['pixel_p99_diff']:.3e}")
    return out["bf16"]["launches"], out


def phase_bf16(dev, card, sd_serve, sd, crf_sd):
    """Phase 14 (module docstring): the kernels, the step, the step card
    vs CPU (bf16 tables and the two culls, the card replaying the CPU's
    selections) on phase 6's weights, and the served pose on phase 4's."""
    import torch

    timing = _load_tool("timing_torch")
    bench = _load_tool("bench_kernel_variants_torch")
    g = torch.Generator(device=dev).manual_seed(SEED + 14)
    records = _bf16_kernels(dev, g, bench, timing)
    step_launches, step = _bf16_paper_step(dev, card, timing)
    ab = phase_train_card_vs_cpu(dev, sd, crf_sd, culls=CULL_FLAGS,
                                 flags=BF16_FLAGS,
                                 label="[14 bf16] bf16 tables,")
    serve_launches, serve = _bf16_serve(dev, card, sd_serve)
    for name, r in records.items():
        r["launches"] = (serve_launches.get(name, 0)
                         if name == "triplane_features_bf16_compute"
                         else step_launches[name])
        check(r["launches"] > 0, f"{name} never launched on its path")
    return records, dict(step=step, card_vs_cpu=ab, serve=serve)


# ---------------------------------------------------------------------------
# phase 15: the exported serving artifact
# ---------------------------------------------------------------------------

EXPORT_DIR = os.path.join(REPO, "build", "chip_smoke")
EXPORT_TOL = 1e-5       # artifact vs live, per ray; the share beyond it is
                        # held to CPU_MAX_SHARE

_LOAD_CHILD = r"""
import json, sys, time
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
from evdeblurnerf_torch import kernels, serving
t0 = time.perf_counter()
r = serving.load_renderer(sys.argv[2])
load_s = time.perf_counter() - t0
rays = torch.from_numpy(np.load(sys.argv[3])).to(r.device)
kernels.reset_launches()
t0 = time.perf_counter()
rgb, depth, acc = r(rays)
torch.cuda.synchronize()
first_s = time.perf_counter() - t0
np.savez(sys.argv[4], rgb=rgb.cpu().numpy(), depth=depth.cpu().numpy(),
         acc=acc.cpu().numpy())
bad = sorted(m for m in sys.modules if m.startswith(
    ("evdeblurnerf_torch.models", "jax", "evdeblurnerf_tpu")))
print(json.dumps(dict(load_s=load_s, first_call_s=first_s, modules=bad,
                      launches={k: v for k, v in kernels.LAUNCHES.items()
                                if v})))
"""


def phase_export(dev, card, sd):
    """Phase 15 (module docstring)."""
    import numpy as np
    import torch

    from evdeblurnerf_torch import kernels, serving
    from evdeblurnerf_torch.train.evaluate import pose_rays

    os.makedirs(EXPORT_DIR, exist_ok=True)
    path = os.path.join(EXPORT_DIR, "serve.evdnpt")
    args = argparse.Namespace(**SERVE_FLAGS)
    K = [[FOCAL, 0.0, W / 2], [0.0, FOCAL, H / 2], [0.0, 0.0, 1.0]]
    live = serving.build_renderer(args, sd, H, W, K, NEAR, FAR, AABB,
                                  device=dev)
    t0 = time.perf_counter()
    exported, meta = serving.export_renderer(
        live.model, chunk=CHUNK, crf=live.crf,
        meta={"H": H, "W": W, "K": K, "near": NEAR, "far": FAR,
              "expname": "chip_smoke", "step": 0})
    export_s = time.perf_counter() - t0
    size = serving.save_renderer(path, exported, meta)
    del exported
    torch.cuda.empty_cache()
    pose = make_poses()[:1]
    rays = pose_rays(pose, H, W, K, dev)[:CHUNK].contiguous()
    rays_path = os.path.join(EXPORT_DIR, "rays.npy")
    out_path = os.path.join(EXPORT_DIR, "artifact_out.npz")
    np.save(rays_path, rays.cpu().numpy())
    child = subprocess.run(
        [sys.executable, "-c", _LOAD_CHILD, REPO, path, rays_path, out_path],
        capture_output=True, text=True, timeout=600)
    check(child.returncode == 0,
          f"loading the artifact in a fresh process failed: "
          f"{child.stderr[-3000:]}")
    fresh = json.loads(child.stdout.strip().splitlines()[-1])
    check(fresh["modules"] == [], f"the loader imported {fresh['modules']}")
    check(all(fresh["launches"].get(k, 0) > 0 for k in SERVE_KERNELS),
          f"the artifact launched {fresh['launches']}")
    got = np.load(out_path)
    want = live(rays)
    diff = np.zeros(CHUNK)
    for name, w in zip(("rgb", "depth", "acc"), want):
        d = np.abs(got[name] - w.cpu().numpy()).reshape(CHUNK, -1)
        diff = np.maximum(diff, d.max(-1))
    exact = bool((diff == 0).all())
    beyond = float((diff > EXPORT_TOL).mean())
    check(beyond <= CPU_MAX_SHARE,
          f"{beyond:.4f} of the artifact's rays differ from the live "
          f"renderer's by more than {EXPORT_TOL}")
    # a whole pose through the artifact (in this process) and the live
    # renderer, in turns
    r = serving.load_renderer(path)
    r(rays)
    rates = {"artifact": [], "live": []}
    kernels.reset_launches()
    launches = None
    for name in ("live", "artifact", "artifact", "live"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rgbs, _ = (r.render_poses(pose) if name == "artifact"
                   else live.render_poses(pose))
        torch.cuda.synchronize()
        rates[name].append(H * W / (time.perf_counter() - t0))
        if name == "artifact" and launches is None:
            launches = dict(kernels.LAUNCHES)
        kernels.reset_launches()
        del rgbs
    del r, live
    torch.cuda.empty_cache()
    bench = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "bench_serving_torch.py"),
         "--artifact", path, "--calls", "20"], capture_output=True,
        text=True, timeout=600)
    check(bench.returncode == 0,
          f"tools/bench_serving_torch.py failed: {bench.stderr[-3000:]}")
    bench_line = json.loads(bench.stdout.strip().splitlines()[-1])
    print(f"[15 export] the serve model at the paper width exported "
          f"(chunk {CHUNK}, {meta['tables']} tables, CRF folded) in "
          f"{export_s:.1f} s to {os.path.relpath(path, REPO)}, "
          f"{size} bytes; a fresh process loaded it in "
          f"{fresh['load_s']:.2f} s with no model module, first call "
          f"{fresh['first_call_s']:.2f} s, launches {fresh['launches']}; "
          f"against the live renderer on {CHUNK} rays: "
          f"{'bitwise equal' if exact else 'max |diff| %.3e' % diff.max()}, "
          f"share beyond {EXPORT_TOL}: {beyond:.4f}; one {H}x{W} pose on "
          f"{card}: artifact {[round(v, 1) for v in rates['artifact']]} "
          f"eval rays/s, live {[round(v, 1) for v in rates['live']]}")
    print(f"[15 export] tools/bench_serving_torch.py: "
          f"{json.dumps(bench_line)}")
    return launches, dict(bytes=size, export_s=export_s, fresh=fresh,
                          exact=exact, max_abs_diff=float(diff.max()),
                          rates=rates, bench=bench_line)


# ---------------------------------------------------------------------------
# phase 3 (tensor-parallel widths) and phase 16: the parallel paths
# ---------------------------------------------------------------------------
# K4 and K5 on one rank's component slice of the paper's fine tables at
# the step's fine launch: k ranks a ray shard hold (64, 16, 16) / k
TP_WIDTHS = (2, 4)
TP_CASE = "step_fine"
PAR_RANKS = 2           # (b)-(e): two ranks on one card, over gloo
PAR_TIME_STEPS = 3      # (b), (c): steps a rank times after the compared one
PAR_RENDER_RAYS = 4096  # (e): rays rendered by the TP model and by one process
PAR_CLI_STEPS = 8       # (a): steps of each cli.main run
PAR_CLI_GATES = dict(kernel_start_iter=2, add_event_egm_startiter=4,
                     tone_mapping_start_learn_iter=6)
PAR_RAY_TOL = 1e-5      # (d), (e): per-ray |diff| on rgb and depth
PAR_RAY_MAX_SHARE = 0.01


def _tp_width_kernels(dev, g, bench, timing):
    """Phase 3, tensor-parallel widths: K4 (f32 and bf16 rows) bitwise and
    K5 (f32 and bf16 rows) within 1e-5 against their twins on a rank's
    slice of the fine tables, (32, 8, 8) at k = 2 and (16, 4, 4) at k = 4,
    with the form each takes, its times and bound. Returns {kernel name:
    {case: record}}."""
    import torch

    from evdeblurnerf_torch.ops import fused_sample, triplane

    planes0, lines0, packed0, xyz, cot0 = bench.k5_inputs(dev, g, TP_CASE)
    del packed0
    n = xyz.shape[0]
    out = {}
    for k in TP_WIDTHS:
        planes = [p[:p.shape[0] // k].contiguous() for p in planes0]
        lines = [ln[:ln.shape[0] // k].contiguous() for ln in lines0]
        Cs = [p.shape[0] for p in planes]
        Ds = [ln.shape[1] for ln in lines]
        n_ch = sum(Cs)
        cot = cot0[:, :n_ch].contiguous()
        touched = (sum(_touched_bytes(p, n, 4) for p in planes)
                   + sum(_touched_bytes(ln, n, 2) for ln in lines))
        grads_bytes = 4 * (sum(p.numel() for p in planes)
                           + sum(ln.numel() for ln in lines) + 3 * n)
        case = f"tp{k}_{TP_CASE}"
        for bf16 in (False, True):
            packed = (_bf16_packed(planes, lines) if bf16
                      else triplane.pack_grids(planes, lines))
            wide = (*packed[0], *packed[1])
            # K4: xyz, the touched cells and the output
            k4_bytes = (4 * n * (3 + n_ch)
                        + (touched // 2 if bf16 else touched))

            def k4():
                return fused_sample.triplane_features(*packed, xyz)

            def k4_plain():
                return triplane.triplane_features_packed(*packed, xyz)

            got, want = k4(), k4_plain()
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            check(torch.equal(got, want), f"K4 {case} (bf16 rows {bf16}, "
                  f"C {Cs}): differs from its plain version by {err:.3e}")
            mode = fused_sample._k4_mode(Cs, (*wide, got))
            del got, want
            rec = _timed(bench.time_k4, timing, packed, xyz)
            rec.update(tables=f"fine, components {Cs}", points=n,
                       stream="uniform", max_abs_err=err,
                       form={fused_sample.K4_SCALAR: "scalar",
                             fused_sample.K4_FLOAT4: "float4",
                             fused_sample.K4_VEC8: "vec8"}[mode],
                       plain_ms=cuda_ms(k4_plain, 3, 1), bytes=k4_bytes,
                       bound_ms=1e3 * k4_bytes / HBM_BYTES_PER_S)
            name = ("triplane_features_bf16" if bf16
                    else "triplane_features")
            out.setdefault(name, {})[case] = rec
            # K5: xyz, the touched cells and the cotangent read, the
            # gradients written
            k5_bytes = 4 * n * (3 + n_ch) + (touched // 2 if bf16
                                             else touched) + grads_bytes
            got = fused_sample.triplane_features_bwd(planes, lines, packed,
                                                     xyz, cot)
            got = [*got[0], *got[1], got[2]]
            leaves = [t.clone().requires_grad_()
                      for t in (*planes, *lines, xyz)]
            pk = triplane.pack_grids(leaves[:3], leaves[3:6])
            if bf16:
                pk = ([triplane.round_bf16(t) for t in pk[0]],
                      [triplane.round_bf16(t) for t in pk[1]], pk[2])
            feats = triplane.triplane_features_packed(*pk, leaves[6])
            want = torch.autograd.grad(feats, leaves, cot, retain_graph=True)
            rel = 0.0
            for gname, a, b in zip(("plane0", "plane1", "plane2", "line0",
                                    "line1", "line2", "xyz"), got, want):
                e = float((a - b).abs().max())
                scale = float(b.abs().max())
                check(e <= GRAD_REL_TOL * scale,
                      f"K5 {case} (bf16 rows {bf16}) d_{gname}: max |kernel "
                      f"- plain| {e:.3e} exceeds {GRAD_REL_TOL} x "
                      f"{scale:.3e}")
                rel = max(rel, e / scale)
            mode = fused_sample._k5_mode(Cs, Ds, (*wide, cot), dev)
            del got, want
            rec = _timed(bench.time_k5, timing, planes, lines, packed, xyz,
                         cot)
            rec.update(tables=f"fine, components {Cs}", points=n,
                       stream="uniform", max_rel_err=rel,
                       form={fused_sample.K5_SCALAR: "scalar",
                             fused_sample.K5_FLOAT4: "float4",
                             fused_sample.K5_FUSED: "fused"}[mode],
                       plain_ms=cuda_ms(lambda: torch.autograd.grad(
                           feats, leaves, cot, retain_graph=True), 3, 1),
                       bytes=k5_bytes,
                       bound_ms=1e3 * k5_bytes / HBM_BYTES_PER_S)
            name = ("triplane_features_bwd_bf16" if bf16
                    else "triplane_features_bwd")
            out.setdefault(name, {})[case] = rec
            del feats, leaves, pk, packed, wide
            torch.cuda.empty_cache()
        del planes, lines, cot
    del planes0, lines0, xyz, cot0
    torch.cuda.empty_cache()
    for name, cases in out.items():
        for case, c in cases.items():
            err = (f"max rel err {c['max_rel_err']:.2e}" if "max_rel_err" in c
                   else "bitwise equal to the plain version")
            print(f"[3 kernel] {name} {case}: {c['points']} uniform points, "
                  f"{c['tables']}, {c['form']} form: kernel device "
                  f"{c['device_ms']:.4f} ms, back to back {c['ms']:.4f} ms, "
                  f"plain {c['plain_ms']:.4f} ms; library call none; bound "
                  f"{c['bound_ms']:.4f} ms ({c['bytes']} bytes); {err}")
    return out


def _numpy_batch(batch):
    return None if batch is None else {k: v.cpu().numpy()
                                      for k, v in batch.items()}


def _par_step_check(label, got, want):
    """(b), (c): a parallel step against the one-process step at phase 7's
    card-vs-CPU limits; returns (loss rel, share beyond, the parameters
    of the largest max |diff| / max |one process|)."""
    check(set(got["grads"]) == set(want["grads"]),
          f"{label}: the ranks and one process differ in which parameters "
          "have a gradient")
    rel_loss = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    total = beyond = 0
    rel = {}
    for n, b in want["grads"].items():
        a = got["grads"][n]
        scale = float(b.abs().max()) or 1.0
        rel[n] = float((a - b).abs().max()) / scale
        total += b.numel()
        beyond += int(((a - b).abs() > TRAIN_GRAD_TOL * scale).sum())
    share = beyond / total
    check(rel_loss <= TRAIN_LOSS_TOL,
          f"{label}: loss differs by {rel_loss:.2e} relative")
    check(share <= TRAIN_GRAD_MAX_SHARE,
          f"{label}: {share:.2e} of gradient elements beyond "
          f"{TRAIN_GRAD_TOL}")
    return rel_loss, share, sorted(rel.items(), key=lambda kv: -kv[1])[:3]


def _ray_share(rgb_a, depth_a, rgb_b, depth_b):
    """(largest per-ray |diff| over rgb and depth, share beyond
    PAR_RAY_TOL)."""
    import torch

    d = torch.maximum((rgb_a - rgb_b).abs().reshape(-1, 3).max(-1)[0],
                      (depth_a - depth_b).abs().reshape(-1))
    return float(d.max()), float((d > PAR_RAY_TOL).float().mean())


def _par_launches(label, records):
    """Each rank's launches of the compared step; every training kernel
    must have run on every rank."""
    from evdeblurnerf_torch import kernels

    for r in records:
        check(not r["jax_modules"], f"{label}: rank {r['rank']} loaded "
              f"{r['jax_modules']}")
        for name in kernels.TRAIN_KERNELS:
            check(r["launches"][name] > 0, f"{label}: kernel {name} never "
                  f"launched on rank {r['rank']}")
    return {name: sum(r["launches"][name] for r in records)
            for name in kernels.KERNELS}


def _par_cli(dev, tmp):
    """Phase 16 (a): cli.main at phase 8's settings (the paper config on
    the synthetic scene) twice plainly in this process and once as rank 0
    of a world of 1 under torchrun's variables, which joins NCCL; the
    NCCL run's logged losses must lie within what plain runs differ by:
    K5's atomics let each run drift by ~1e-5 relative over these steps, of
    which the two plain runs give one sample, so the largest relative
    difference from the first plain run is held to four times theirs, and
    at least to phase 7's loss bound."""
    from evdeblurnerf_torch import cli

    synth = _load_tool("synthetic_scene_torch")
    llff_cls, events_cls = synth.scene_classes()
    scene = os.path.join(tmp, "scene")
    os.makedirs(scene)
    synth.write_scene(scene, train_args().events_threshold, SEED)
    logs = os.path.join(tmp, "logs")

    def argv(expname):
        merged = dict(datadir=scene, basedir=logs, tbdir=logs,
                      expname=expname, no_wandb=True, i_video=10 ** 9,
                      device=dev.type, N_iters=PAR_CLI_STEPS,
                      i_print=10 ** 9,
                      i_tensorboard=1, i_weights=10 ** 9, i_testset=10 ** 9,
                      **PAR_CLI_GATES)
        out = ["--config", os.path.join(REPO, _bench_torch().PAPER_CONFIG)]
        for k, v in merged.items():
            out += [f"--{k}", str(v)]
        return out

    for name in ("plain_a", "plain_b"):
        cli.main(argv(name), llff_cls=llff_cls, events_cls=events_cls)
    code = (
        "import importlib.util, sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "spec = importlib.util.spec_from_file_location('s', "
        f"{os.path.join(REPO, 'tools', 'synthetic_scene_torch.py')!r})\n"
        "s = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(s)\n"
        "import torch.distributed as dist\n"
        "from evdeblurnerf_torch import cli\n"
        "from evdeblurnerf_torch.parallel import multihost\n"
        f"multihost.initialize(device={dev.type!r})\n"
        "print('backend', dist.get_backend(), 'world',"
        " dist.get_world_size(), flush=True)\n"
        "llff, ev = s.scene_classes()\n"
        "cli.main(sys.argv[1:], llff_cls=llff, events_cls=ev)\n")
    pc = _load_tool("parallel_check_torch")
    env = {**os.environ, "RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "LOCAL_WORLD_SIZE": "1", "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(pc.free_port())}
    proc = subprocess.run([sys.executable, "-c", code, *argv("nccl")],
                          env=env, capture_output=True, text=True,
                          timeout=900)
    check(proc.returncode == 0, "the NCCL world-1 run failed:\n"
          + (proc.stdout + proc.stderr)[-3000:])
    backend = "nccl" if dev.type == "cuda" else "gloo"
    check(f"backend {backend} world 1" in proc.stdout,
          f"the world-1 run did not join {backend}: {proc.stdout[:500]}")
    runs = {}
    for name in ("plain_a", "plain_b", "nccl"):
        stream, _ = _metric_stream(os.path.join(logs, name, "metrics.jsonl"))
        runs[name] = dict(stream["train/loss"])
    steps = sorted(runs["plain_a"])
    check(steps == list(range(PAR_CLI_STEPS)) and all(
        sorted(runs[n]) == steps for n in runs),
        f"logged steps {[sorted(r) for r in runs.values()]}")

    def rel(a, b):
        return max(abs(runs[a][s] - runs[b][s]) / abs(runs[b][s])
                   for s in steps)

    spread, nccl = rel("plain_b", "plain_a"), rel("nccl", "plain_a")
    bound = max(4 * spread, TRAIN_LOSS_TOL)
    print(f"[16 parallel] (a) cli.main, {PAR_CLI_STEPS} steps of "
          f"{_bench_torch().PAPER_CONFIG} across {PAR_CLI_GATES}: NCCL world "
          f"1 vs plain, largest relative loss difference {nccl:.3e}; two "
          f"plain runs {spread:.3e}; losses plain "
          f"{[round(runs['plain_a'][s], 6) for s in steps]}, NCCL "
          f"{[round(runs['nccl'][s], 6) for s in steps]}")
    check(nccl <= bound, f"the NCCL world-1 run's losses differ from the "
          f"plain run's by {nccl:.3e}, beyond {bound:.3e}")
    return dict(nccl_rel=nccl, plain_spread=spread)


def phase_parallel(dev, card, sd, crf_sd, sd_serve, serve):
    """Phase 16 (module docstring): returns the parallel steps' launches
    (summed over the ranks of (b) and (c)) and the figures."""
    import torch

    from evdeblurnerf_torch.models.renderer import config_from_args
    from evdeblurnerf_torch.models.system import kernel_config_from_args
    from evdeblurnerf_torch.models.tonemapping import CRF
    from evdeblurnerf_torch.parallel import mesh
    from evdeblurnerf_torch.train import step as tstep
    from evdeblurnerf_torch.train.checkpoint import load_into_state

    pc = _load_tool("parallel_check_torch")
    note = "two ranks share one card: no scaling figure"
    with tempfile.TemporaryDirectory() as tmp:
        figures = dict(cli=_par_cli(dev, tmp))
        torch.cuda.empty_cache()

        args = train_args()
        batch, ev_batch = make_train_batch("cpu", args.N_rand,
                                           args.events_N_rand)
        n_rays = (args.N_rand * args.kernel_ptnum + 2 * args.events_N_rand)
        setup = dict(cfg=config_from_args(args, AABB, H, W, FOCAL, NEAR, FAR),
                     kcfg=kernel_config_from_args(args),
                     num_images=NUM_IMAGES, args=args, seed=SEED,
                     model_sd=sd, crf_sd=crf_sd,
                     batch=_numpy_batch(batch), ev_batch=_numpy_batch(ev_batch),
                     sw=tstep.schedule_weights_fn(args)(1), force_naive=False,
                     events_active=True, time_steps=PAR_TIME_STEPS)
        runs = {}
        for label, tp, extra in (
                ("(b) DP 2x1", 1, {}),
                ("(c) TP 1x2", 2, dict(
                    checkpoint=os.path.join(tmp, "tp.tar"),
                    render_rays=PAR_RENDER_RAYS))):
            path = os.path.join(tmp, f"setup_tp{tp}.pt")
            torch.save(dict(setup, **extra), path)
            t0 = time.perf_counter()
            got, records = pc.spawn(path, os.path.join(tmp, f"out{tp}.pt"),
                                    PAR_RANKS, tp=tp, device=str(dev),
                                    backend="gloo", timeout=900)
            runs[label] = (got, records, time.perf_counter() - t0)
        torch.cuda.empty_cache()
        want, _ = pc.run(setup, dev, mesh.Layout())
        torch.cuda.empty_cache()
        launches = dict.fromkeys(runs["(b) DP 2x1"][1][0]["launches"], 0)
        for label, (got, records, secs) in runs.items():
            rel_loss, share, worst = _par_step_check(label, got, want)
            per_rank = _par_launches(label, records)
            for name, v in per_rank.items():
                launches[name] += v
            figures[label] = dict(rel_loss=rel_loss, share_beyond=share,
                                  ms_per_step=[r["ms_per_step"]
                                               for r in records],
                                  peak_gib=[r.get("peak_gib", 0.0) for r in records])
            print(f"[16 parallel] {label} over gloo on {card}, "
                  f"{PAR_RANKS} processes on {dev}, the paper step on the "
                  f"global batch of {n_rays} rays from phase 6's weights: "
                  f"loss {got['loss']:.7g} vs one process {want['loss']:.7g} "
                  f"(rel {rel_loss:.2e}); max |diff| / max|one process| "
                  f"largest at {', '.join(f'{n} {v:.2e}' for n, v in worst)}"
                  f", share of gradient elements beyond "
                  f"{TRAIN_GRAD_TOL} x max: {share:.2e}; per rank "
                  f"ms/step {[round(r['ms_per_step'], 1) for r in records]}, "
                  f"peak GiB {[round(r.get('peak_gib', 0.0), 2) for r in records]} "
                  f"({note}); launches a rank "
                  f"{[{k: v for k, v in r['launches'].items() if v} for r in records]}; "
                  f"ranks' wall {secs:.1f} s")

        # (e) the TP checkpoint in one process
        got_tp = runs["(c) TP 1x2"][0]
        one = pc.build_state({k: v for k, v in setup.items()
                              if k not in ("model_sd", "crf_sd")}, dev)
        load_into_state(torch.load(os.path.join(tmp, "tp.tar"),
                                   map_location="cpu", weights_only=True),
                        one)
        check(one.step == 1, f"the TP checkpoint is at step {one.step}")
        plane = one.model.mlp_fine.app_plane[0]
        check(one.optimizer.state[plane]["exp_avg"].shape == plane.shape,
              "the TP checkpoint's Adam moments are not whole")
        one.model.eval()
        rays = torch.as_tensor(setup["batch"]["rays"][:PAR_RENDER_RAYS]) \
            .to(dev)
        with torch.inference_mode():
            rgb, depth, _ = one.model.render_chunk(rays)
        worst, share = _ray_share(rgb.cpu(), depth.cpu(),
                                  got_tp["render_rgb"], got_tp["render_depth"])
        del one, rgb, depth
        torch.cuda.empty_cache()
        figures["(e)"] = dict(max_abs_diff=worst, share_beyond=share)
        print(f"[16 parallel] (e) the TP run's gathered checkpoint loaded in "
              f"one process renders {PAR_RENDER_RAYS} of the batch's rays: "
              f"max |diff| {worst:.3e} against the TP model's render, share "
              f"beyond {PAR_RAY_TOL}: {share:.4f}")
        check(share <= PAR_RAY_MAX_SHARE, f"(e): {share:.4f} of rays differ "
              f"by more than {PAR_RAY_TOL}")

        # (d) one pose, data-parallel, against phase 4's render
        sargs = argparse.Namespace(**SERVE_FLAGS)
        K = [[FOCAL, 0.0, W / 2], [0.0, FOCAL, H / 2], [0.0, 0.0, 1.0]]
        path = os.path.join(tmp, "setup_render.pt")
        torch.save(dict(cfg=config_from_args(sargs, AABB, H, W, FOCAL, NEAR,
                                             FAR), model_sd=sd_serve,
                        render=dict(poses=make_poses()[:1], H=H, W=W, K=K,
                                    chunk=CHUNK)), path)
        got, records = pc.spawn(path, os.path.join(tmp, "out_render.pt"),
                                PAR_RANKS, device=str(dev), backend="gloo",
                                timeout=900)
        rgb = CRF(sargs.tone_mapping_type, sargs.tone_mapping_gamma)(
            got["rgb"])
        worst, share = _ray_share(rgb, got["depth"], serve["rgbs"],
                                  serve["depths"])
        for r in records:
            for name in SERVE_KERNELS:
                check(r["launches"][name] > 0, f"(d): kernel {name} never "
                      f"launched on rank {r['rank']}")
        figures["(d)"] = dict(max_abs_diff=worst, share_beyond=share,
                              render_s=[r["render_s"] for r in records])
        print(f"[16 parallel] (d) one {H}x{W} pose data-parallel over "
              f"{PAR_RANKS} ranks (chunk {CHUNK} a rank) against phase 4's "
              f"render: max |diff| {worst:.3e}, share beyond {PAR_RAY_TOL}: "
              f"{share:.4f}; seconds a rank "
              f"{[round(r['render_s'], 2) for r in records]} ({note})")
        check(share <= PAR_RAY_MAX_SHARE, f"(d): {share:.4f} of rays differ "
              f"by more than {PAR_RAY_TOL}")
    return launches, figures


# ---------------------------------------------------------------------------
# phase 17: --matmul_precision
# ---------------------------------------------------------------------------

PRECISION_NAMES = ("highest", "high", "default")
# words of the kernel names of cuBLAS (its nvjet and xmma GEMMs, its
# split-K reduction), cuBLASLt and CUTLASS; no kernel of the port carries
# one
GEMM_WORDS = ("gemm", "gemv", "xmma", "nvjet", "splitkreduce", "cutlass",
              "cublas")


def _gemm_split(timing, fn, iters=2):
    """Device ms a call of ``fn`` split into GEMMs (cuBLAS kernel names)
    and the rest (the port's kernels, PyTorch's others, copies), with the
    three largest kernels of each by name."""
    acts = timing._device_activities(fn, iters)
    check(acts, "torch.profiler recorded no device activity")
    by_name = {True: {}, False: {}}
    for name, us in acts:
        part = by_name[any(w in name.lower() for w in GEMM_WORDS)]
        part[name] = part.get(name, 0.0) + us / iters / 1e3

    def top(part):
        return [(n[:60], round(ms, 3)) for n, ms in
                sorted(part.items(), key=lambda kv: -kv[1])[:3]]

    return dict(gemm_ms=sum(by_name[True].values()),
                other_ms=sum(by_name[False].values()),
                top_gemms=top(by_name[True]), top_other=top(by_name[False]))


def _precision_readback():
    """Phase 17 (a): each name through the resolver, read back through
    the per-backend settings; the CPU's backend untouched."""
    import torch

    from evdeblurnerf_torch.utils import precision

    b = torch.backends
    cpu = (b.mkldnn.matmul.fp32_precision, b.mkldnn.conv.fp32_precision,
           b.fp32_precision)
    got = {}
    for name in (*PRECISION_NAMES, "highest"):
        mode = precision.set_matmul_precision(name)
        got[name] = (b.cuda.matmul.fp32_precision,
                     b.cudnn.conv.fp32_precision)
        check(got[name] == (precision.FP32_PRECISION[name],) * 2
              and mode == precision.FP32_PRECISION[name],
              f"--matmul_precision {name}: cuBLAS, cuDNN read back "
              f"{got[name]}, mapped {mode!r}")
        now = (b.mkldnn.matmul.fp32_precision, b.mkldnn.conv.fp32_precision,
               b.fp32_precision)
        check(now == cpu, f"--matmul_precision {name} moved the CPU's "
              f"backend: {cpu} -> {now}")
    print(f"[17 precision] torch {torch.__version__}: (cuBLAS matmul, cuDNN "
          f"conv) read back {got}; the CPU's oneDNN matmul, conv and the "
          f"generic setting {cpu} untouched")
    return got


def _sd_state(args, dev, sd, crf_sd):
    """(model, state) of phase 6's weights and CRF, its draws from SEED."""
    import torch

    from evdeblurnerf_torch.train import state as tstate

    model, crf = tstate.build_model(args, AABB, H, W, FOCAL, NEAR, FAR,
                                    NUM_IMAGES, device=dev)
    model.load_state_dict(sd)
    crf.load_state_dict(crf_sd)
    return model, tstate.create_train_state(
        model, crf, args, torch.Generator(device=dev).manual_seed(SEED),
        crf_identity_prefit=False)


def _precision_step(dev, card, sd, crf_sd, timing):
    """Phase 17 (b): the paper step at highest and at high; returns the
    high blocks' launches."""
    import torch

    from evdeblurnerf_torch import kernels
    from evdeblurnerf_torch.train import step as tstep
    from evdeblurnerf_torch.utils.precision import set_matmul_precision

    args = train_args()
    step = tstep.build_train_step(args)
    sw_of = tstep.schedule_weights_fn(args)
    batch, ev_batch = make_train_batch(dev, args.N_rand, args.events_N_rand)
    n_rays = args.N_rand * args.kernel_ptnum + 2 * args.events_N_rand

    # two steps from one state at each setting, highest twice: the spread
    # of K5's atomics beside TF32's difference
    two = {}
    for label, name in (("highest", "highest"), ("highest again", "highest"),
                        ("high", "high")):
        set_matmul_precision(name)
        model, state = _sd_state(args, dev, sd, crf_sd)
        two[label] = [float(step(state, batch, ev_batch, sw_of(state.step),
                                 False, True)["loss"]) for _ in range(2)]
        del model, state
        torch.cuda.empty_cache()
    rel = {label: [abs(a - b) / abs(b) for a, b in zip(v, two["highest"])]
           for label, v in two.items() if label != "highest"}

    model, state = _sd_state(args, dev, sd, crf_sd)

    def one():
        return step(state, batch, ev_batch, sw_of(state.step), False, True)

    losses = {n: [] for n in ("highest", "high")}
    for name in losses:
        set_matmul_precision(name)
        losses[name] += [float(one()["loss"]) for _ in range(TRAIN_WARMUP)]
    ms = {n: [] for n in losses}
    peak, launches = {}, None
    for name in ("highest", "high", "high", "highest"):
        set_matmul_precision(name)
        torch.cuda.synchronize()
        first = name not in peak
        if first:
            torch.cuda.reset_peak_memory_stats()
        if name == "high" and launches is None:
            kernels.reset_launches()
        t0 = time.perf_counter()
        timed = [one()["loss"] for _ in range(TRAIN_STEPS)]
        torch.cuda.synchronize()
        ms[name].append(1e3 * (time.perf_counter() - t0) / TRAIN_STEPS)
        if first:
            peak[name] = torch.cuda.max_memory_allocated() / 2**30
        if name == "high" and launches is None:
            launches = dict(kernels.LAUNCHES)
        losses[name] += [float(v) for v in timed]
    split = {}
    for name in losses:
        set_matmul_precision(name)
        split[name] = _gemm_split(timing, one)
    set_matmul_precision("highest")
    for name, vals in {**losses, **two}.items():
        check(all(math.isfinite(v) for v in vals),
              f"non-finite loss ({name}): {vals}")
    for name in kernels.TRAIN_KERNELS:
        check(launches[name] > 0, f"kernel {name} never launched on the "
              "step at --matmul_precision high")
    print(f"[17 precision] paper step on {card}, {TRAIN_STEPS} steps a "
          f"block in turns on one state: highest "
          f"{[round(v, 1) for v in ms['highest']]} ms/step, high "
          f"{[round(v, 1) for v in ms['high']]} ms/step; high "
          f"{n_rays * 1e3 / min(ms['high']):.1f} train rays/s (highest "
          f"{n_rays * 1e3 / min(ms['highest']):.1f}); peak highest "
          f"{peak['highest']:.2f} GiB, high {peak['high']:.2f} GiB; device "
          f"ms/step highest GEMMs {split['highest']['gemm_ms']:.2f} + rest "
          f"{split['highest']['other_ms']:.2f}, high GEMMs "
          f"{split['high']['gemm_ms']:.2f} + rest "
          f"{split['high']['other_ms']:.2f}; largest GEMMs highest "
          f"{split['highest']['top_gemms']}, high {split['high']['top_gemms']}"
          f"; largest other kernels highest {split['highest']['top_other']}"
          f"; launches per step at high "
          f"{ {k: v / TRAIN_STEPS for k, v in launches.items() if v} }")
    print(f"[17 precision] two steps from phase 6's state: losses {two}; "
          f"relative to highest {rel} (steps 1, 2)")
    del state, model
    torch.cuda.empty_cache()
    return launches, dict(ms_per_step=ms, peak_gib=peak, device_ms=split,
                          two_steps=two, rel_loss=rel)


def _precision_serve(dev, card, sd, timing):
    """Phase 17 (c): one 480x640 pose through ``serving.build_renderer`` at
    highest and at high, same weights (phase 4's): eval rays/s, device ms
    a chunk split into GEMMs and the rest, the pixel differences."""
    import numpy as np
    import torch

    from evdeblurnerf_torch import kernels, serving
    from evdeblurnerf_torch.train.evaluate import pose_rays
    from evdeblurnerf_torch.utils.precision import set_matmul_precision

    K = [[FOCAL, 0.0, W / 2], [0.0, FOCAL, H / 2], [0.0, 0.0, 1.0]]
    pose = make_poses()[:1]
    r = serving.build_renderer(argparse.Namespace(**SERVE_FLAGS), sd, H, W,
                               K, NEAR, FAR, AABB, device=dev)
    rays = pose_rays(pose, H, W, np.asarray(K), dev)[:CHUNK].contiguous()
    out, rgbs = {}, {}
    for name in ("highest", "high"):
        set_matmul_precision(name)
        r(rays)
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        rgb, depth = r.render_poses(pose)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        out[name] = dict(eval_rays_per_s=H * W / secs,
                         launches={k: v for k, v in kernels.LAUNCHES.items()
                                   if v},
                         **_gemm_split(timing, lambda: r(rays)))
        check(bool(torch.isfinite(rgb).all() and torch.isfinite(depth).all()),
              f"non-finite render at --matmul_precision {name}")
        for k in SERVE_KERNELS:
            check(out[name]["launches"].get(k, 0) > 0, f"kernel {k} never "
                  f"launched in the render at --matmul_precision {name}")
        rgbs[name] = rgb
    set_matmul_precision("highest")
    diff = (rgbs["high"] - rgbs["highest"]).abs()
    out["pixel_max_diff"] = float(diff.max())
    out["pixel_p99_diff"] = float(torch.quantile(
        diff.reshape(-1)[::7].float(), 0.99))
    print(f"[17 precision] one {H}x{W} pose on {card}: highest "
          f"{out['highest']['eval_rays_per_s']:.1f} eval rays/s, high "
          f"{out['high']['eval_rays_per_s']:.1f}; device ms a chunk highest "
          f"GEMMs {out['highest']['gemm_ms']:.2f} + rest "
          f"{out['highest']['other_ms']:.2f}, high GEMMs "
          f"{out['high']['gemm_ms']:.2f} + rest {out['high']['other_ms']:.2f}"
          f"; rgb |high - highest| max {out['pixel_max_diff']:.3e}, p99 "
          f"{out['pixel_p99_diff']:.3e}")
    del r
    torch.cuda.empty_cache()
    return out


def phase_precision(dev, card, sd_serve, sd, crf_sd):
    """Phase 17 (module docstring): returns the high step's launches and
    the figures."""
    timing = _load_tool("timing_torch")
    readback = _precision_readback()
    launches, step = _precision_step(dev, card, sd, crf_sd, timing)
    serve = _precision_serve(dev, card, sd_serve, timing)
    return launches, dict(readback=readback, step=step, serve=serve)


# ---------------------------------------------------------------------------
# phase 18: tools/preprocess_events_torch.py, tools/eval_cull_ab_torch.py
# ---------------------------------------------------------------------------

CULL_AB_TOL = 1e-6      # (b): an arm against the port's own render


def _preprocess_events(tmp):
    """Phase 18 (a): the sidecar of ``tools/preprocess_events_torch.py``
    on phase 8's scene, read by phase 8's dataset in place of a scan."""
    import numpy as np

    from evdeblurnerf_torch import config
    from evdeblurnerf_torch.data import events as devents
    from evdeblurnerf_torch.ops import events_native
    from evdeblurnerf_torch.train import loop as tloop

    synth = _load_tool("synthetic_scene_torch")
    tool = _load_tool("preprocess_events_torch")
    scene = os.path.join(tmp, "scene")
    os.makedirs(scene)
    synth.write_scene(scene, train_args().events_threshold, SEED)
    args = config.resolve_event_thresholds(config.parse_args(
        ["--config", os.path.join(REPO, _bench_torch().PAPER_CONFIG),
         "--datadir", scene]))
    args.use_pts0_prior = None
    t0 = time.perf_counter()
    tool.main([scene, "--h", str(synth.SCENE_H), "--w", str(synth.SCENE_W),
               "--events_tms_unit", args.events_tms_unit,
               "--accumulate", "2", "--accumulate_at_time", "1"],
              load_events=synth.load_npz_events)
    tool_s = time.perf_counter() - t0
    scans = []
    scan = devents.compute_successor

    def counted(ids):
        scans.append(len(ids))
        return scan(ids)

    devents.compute_successor = counted
    try:
        t0 = time.perf_counter()
        _, ev = tloop.build_datasets(args, *synth.scene_classes())
        load_s = time.perf_counter() - t0
    finally:
        devents.compute_successor = scan
    t0 = time.perf_counter()
    succ, cnt, _, _ = events_native.compute_successor(ev.events[:, 0])
    scan_s = time.perf_counter() - t0
    with np.load(os.path.join(scene, "events_successor.npz")) as f:
        n_events = int(f["n_events"])
    print(f"[18 tools] tools/preprocess_events_torch.py on phase 8's scene "
          f"({n_events} events after the pose-range filter) in {tool_s:.2f} "
          f"s; the dataset read its sidecar ({len(scans)} scans) in "
          f"{load_s:.2f} s; a fresh scan {scan_s:.3f} s")
    check(not scans, f"the dataset scanned the stream {len(scans)} times "
          "beside the sidecar")
    check(n_events == ev.events.shape[0], f"sidecar of {n_events} events, "
          f"stream of {ev.events.shape[0]}")
    check(np.array_equal(ev.events[:, 3], succ)
          and np.array_equal(ev.events_num_successors, cnt),
          "the sidecar's successor graph differs from a fresh scan's")
    return dict(tool_s=tool_s, load_s=load_s, scan_s=scan_s,
                n_events=n_events)


def _cull_ab(dev, tmp):
    """Phase 18 (b): ``tools/eval_cull_ab_torch.py`` on the checkpoint of a
    run of phase 12's validation size; returns the culled arm's
    launches."""
    from evdeblurnerf_torch.train import evaluate

    vtt = _load_tool("validate_train_torch")
    tool = _load_tool("eval_cull_ab_torch")
    common = ["--profile", "small", "--scene", os.path.join(tmp, "vscene"),
              "--logdir", tmp, "--expname", "cull_ab", "--device", str(dev)]
    t0 = time.perf_counter()
    vtt.main(["--iters", str(VALIDATE_ITERS), *common])
    train_s = time.perf_counter() - t0
    argv = ["--capacity", "0.25", *common]
    out, renders = tool.compare(argv)
    run = tool.restore(argv)
    own = {}
    for arm, cull in tool.ARMS:
        rgbs, _ = evaluate.render_poses(
            functools.partial(run.model.render_chunk, fine_cull=cull),
            run.llff.test_poses, run.llff.h, run.llff.w, run.llff.K,
            chunk=run.targs.chunk, device=run.device)
        want = evaluate.apply_crf(run.crf, rgbs.cpu().numpy(), skip_learn_crf=(
            run.step < run.targs.tone_mapping_start_learn_iter))
        own[arm] = float(abs(renders[arm] - want).max())
    print(f"[18 tools] tools/eval_cull_ab_torch.py at capacity "
          f"{out['capacity']} on a {VALIDATE_ITERS}-iteration validation run "
          f"(trained in {train_s:.1f} s): {json.dumps(out)}; each arm "
          f"against render_chunk(fine_cull=...) of the restored checkpoint, "
          f"max |diff| {own}")
    for arm, _ in tool.ARMS:
        check(math.isfinite(out[arm]["psnr"]) and out[arm]["render_s"] > 0,
              f"the {arm} arm: {out[arm]}")
        check(own[arm] <= CULL_AB_TOL, f"the {arm} arm differs from the "
              f"port's render by {own[arm]}")
        for k in SERVE_KERNELS:
            check(out[arm]["launches"].get(k, 0) > 0,
                  f"kernel {k} never launched in the {arm} arm")
    return out["cull"]["launches"], dict(train_s=train_s, ab=out, own=own)


def phase_tools(dev):
    """Phase 18 (module docstring): returns the culled arm's launches."""
    with tempfile.TemporaryDirectory() as tmp:
        events = _preprocess_events(tmp)
        launches, ab = _cull_ab(dev, tmp)
    return launches, dict(preprocess=events, cull_ab=ab)


# ---------------------------------------------------------------------------
# phase 19: the captured training step (train/capture.py)
# ---------------------------------------------------------------------------
# (a): from phase 6's weights, across the key change of the paper
# configuration (the blur kernel's and the learned CRF's start, 1200 in the
# file) brought to step 5
CAPTURE_GATES = dict(kernel_start_iter=5, tone_mapping_start_learn_iter=5)
CAPTURE_STEPS = 12
# (b): the kernels' names on the device and the counters they launch under
KERNEL_NAMES = (
    (("permute_lanes_vec", "permute_lanes_scalar"),
     ("permute_lanes", "permute_lanes_bwd")),
    (("permute_lanes_3d",), ("permute_lanes_3d", "permute_lanes_3d_bwd")),
    (("cdf_take",), ("cdf_take",)),
    (("triplane_fwd",), ("triplane_features", "triplane_features_bf16",
                         "triplane_features_bf16_compute")),
    (("triplane_bwd",), ("triplane_features_bwd",
                         "triplane_features_bwd_bf16")),
    (("line_grad",), ("line_grad",)),
)
# (d): the other blur kernels, the NeRF field and microbatches, at
# bench_torch.py's TINY width
CAPTURE_VARIANTS = {
    "DSK": dict(kernel_type="DSK", kernel_use_awp=False),
    "PBE": dict(kernel_type="PBE", kernel_use_awp=False, kernel_hwindow=10),
    "mode=nerf": dict(mode="nerf", netdepth=2, netwidth=32, netdepth_fine=2,
                      netwidth_fine=32),
    "grad_accum 2": dict(grad_accum=2),
}
CAPTURE_SMALL_STEPS = 4
# (e): cli.main at the validation tool's small profile, then resumed
CAPTURE_RUN_ITERS = (16, 24)
CAPTURE_RUN_FLAGS = dict(kernel_start_iter=6, tone_mapping_start_learn_iter=6,
                         i_weights=8, i_tensorboard=1, i_print=100)


def _device_kernel_counts(fn):
    """Launches of ``fn`` on the device by kernel, from a ``torch.profiler``
    trace: ``{counter names: count}`` over :data:`KERNEL_NAMES`."""
    acts = _load_tool("timing_torch")._device_activities(fn, 1)
    return ({counters: sum(1 for n, _ in acts if any(k in n for k in names))
             for names, counters in KERNEL_NAMES}, len(acts))


def _grouped(launches):
    return {counters: sum(launches.get(c, 0) for c in counters)
            for _, counters in KERNEL_NAMES}


def _param_share(a, b):
    """The share of all parameter elements of ``b`` beyond
    ``TRAIN_GRAD_TOL`` of their parameter's largest magnitude in ``a``
    (phase 7's aggregate over the gradients, here over the weights)."""
    total = beyond = 0
    for n, x in a.items():
        scale = max(float(x.abs().max()), 1e-12)
        beyond += int(((b[n] - x).abs() > TRAIN_GRAD_TOL * scale).sum())
        total += x.numel()
    return beyond / total


def _capture_window(dev, card, sd, crf_sd):
    """Phase 19 (a), (b): the eager step twice and the captured step from
    phase 6's state and one generator state over ``CAPTURE_STEPS`` steps
    across the key change; then one replay under the profiler. Returns
    the captured run's launches."""
    import torch

    from evdeblurnerf_torch import kernels
    from evdeblurnerf_torch.train import capture
    from evdeblurnerf_torch.train import step as tstep

    args = train_args(**CAPTURE_GATES)
    batch, ev_batch = make_train_batch(dev, args.N_rand, args.events_N_rand)
    sw_of = tstep.schedule_weights_fn(args)
    out = {}
    for run in ("eager", "eager again", "captured"):
        model, state = _sd_state(args, dev, sd, crf_sd)
        captured = run == "captured"
        step = (capture.CapturedStep(args) if captured
                else tstep.build_train_step(args))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        losses, last = [], None
        for i in range(CAPTURE_STEPS):
            if i == CAPTURE_STEPS - 1:
                last = dict(kernels.LAUNCHES)
            losses.append(step(state, batch, ev_batch, sw_of(i),
                               i < args.kernel_start_iter, True)["loss"]
                          .clone())
        torch.cuda.synchronize()
        r = out[run] = dict(
            losses=[float(v) for v in losses],
            launches=dict(kernels.LAUNCHES),
            last_step={k: kernels.LAUNCHES[k] - last[k] for k in last},
            peak_gib=torch.cuda.max_memory_allocated() / 2**30,
            peak_reserved_gib=torch.cuda.max_memory_reserved() / 2**30,
            params={n: p.detach().clone() for n, p in
                    [*model.named_parameters(),
                     *((f"crf.{n}", p) for n, p in
                       state.crf.named_parameters())]})
        if captured:
            r["keys"] = list(step.graphs)
            key = capture.step_key(sw_of(CAPTURE_STEPS), False, True)
            r["delta"] = step.graphs[key].launches
            before = dict(kernels.LAUNCHES)
            r["profiled"], r["activities"] = _device_kernel_counts(
                lambda: step(state, batch, ev_batch, sw_of(state.step),
                             False, True))
            r["replay_launches"] = {k: kernels.LAUNCHES[k] - before[k]
                                    for k in before}
        del model, state, step
        torch.cuda.empty_cache()
    a, b, c = out["eager"], out["eager again"], out["captured"]
    rel = lambda x, y: [abs(p - q) / abs(q) for p, q in zip(x, y)]  # noqa
    spread = max(rel(b["losses"], a["losses"]))
    got = max(rel(c["losses"], a["losses"]))
    bound = max(4 * spread, 1e-4)
    share = _param_share(a["params"], c["params"])
    share_eager = _param_share(a["params"], b["params"])
    eager_step = _grouped(a["last_step"])
    profiled = c["profiled"]
    delta = _grouped(c["delta"])
    per_replay = _grouped(c["replay_launches"])
    names = {cs: cs[0] for _, cs in KERNEL_NAMES}
    print(f"[19 capture] (a) paper step from phase 6's state, "
          f"{CAPTURE_STEPS} steps across the key change at step "
          f"{args.kernel_start_iter} on {card}: losses eager "
          f"{[round(v, 6) for v in a['losses']]}, captured "
          f"{[round(v, 6) for v in c['losses']]}; largest per-step relative "
          f"difference captured {got:.3e}, eager twice {spread:.3e} (bound "
          f"{bound:.1e}); share of parameter elements beyond "
          f"{TRAIN_GRAD_TOL} of their parameter's largest: captured "
          f"{share:.2e}, eager twice {share_eager:.2e} "
          f"(bound {TRAIN_GRAD_MAX_SHARE}); graphs {c['keys']}; peak with "
          f"both graphs held {c['peak_gib']:.2f} GiB allocated, "
          f"{c['peak_reserved_gib']:.2f} GiB reserved (eager "
          f"{a['peak_gib']:.2f}, {a['peak_reserved_gib']:.2f})")
    print(f"[19 capture] (b) one replay under the profiler: kernels by name "
          f"{ {names[k]: v for k, v in profiled.items()} } of "
          f"{c['activities']} device activities; the eager step's launches "
          f"{ {names[k]: v for k, v in eager_step.items()} }; the graph's "
          f"counts {c['delta']}, added by the replay "
          f"{ {names[k]: v for k, v in per_replay.items()} }")
    check(all(math.isfinite(v) for r in out.values() for v in r["losses"]),
          "non-finite loss in the capture window")
    check(len(c["keys"]) == 2, f"graphs {c['keys']}, expected 2 keys")
    check(got <= bound, f"captured losses {got:.3e} from the eager ones, "
          f"bound {bound:.1e}")
    check(share <= TRAIN_GRAD_MAX_SHARE, f"parameters after the window: "
          f"{share:.2e} of elements beyond {TRAIN_GRAD_TOL}")
    check(profiled == eager_step == delta == per_replay,
          f"kernel launches of one replay on the device {profiled}, of the "
          f"eager step {eager_step}, of the graph {delta}, counted by the "
          f"replay {per_replay}")
    for name in kernels.TRAIN_KERNELS:
        check(c["launches"].get(name, 0) > 0 and c["delta"].get(name, 0) > 0,
              f"kernel {name} not launched inside the captured step")
    return c["launches"], dict(rel=got, spread=spread, param_share=share,
                               peak_gib=c["peak_gib"],
                               peak_reserved_gib=c["peak_reserved_gib"])


def _capture_turns(dev, card, sd, crf_sd):
    """Phase 19 (c): the exact, culled and bf16 paper steps, eager and
    captured on one state each, in turns (eager, captured, captured,
    eager) of ``TRAIN_STEPS`` steps."""
    import torch

    from evdeblurnerf_torch.models.system import build_occ_grid
    from evdeblurnerf_torch.train import capture
    from evdeblurnerf_torch.train import step as tstep

    out = {}
    for label, flags in (("exact", {}), ("culled", CULL_FLAGS),
                         ("bf16", dict(triplane_bf16=True))):
        args = train_args(**flags)
        model, state = _sd_state(args, dev, sd, crf_sd)
        batch, ev_batch = make_train_batch(dev, args.N_rand,
                                           args.events_N_rand)
        sw_of = tstep.schedule_weights_fn(args)
        kw = {}
        if label == "culled":
            kw = dict(fine_cull=True, coarse_cull=True,
                      occ_grid=build_occ_grid(model))
        steps = dict(eager=tstep.build_train_step(args),
                     captured=capture.CapturedStep(args))

        def block(name, n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                loss = steps[name](state, batch, ev_batch,
                                   sw_of(state.step), False, True,
                                   **kw)["loss"]
            torch.cuda.synchronize()
            check(math.isfinite(float(loss)), f"{label} {name}: loss {loss}")
            return 1e3 * (time.perf_counter() - t0) / n

        torch.cuda.reset_peak_memory_stats()
        for name in steps:
            block(name, TRAIN_WARMUP)
        ms = {n: [] for n in steps}
        for name in ("eager", "captured", "captured", "eager"):
            ms[name].append(block(name, TRAIN_STEPS))
        out[label] = dict(ms=ms, peak_gib=torch.cuda.max_memory_allocated()
                          / 2**30)
        del model, state, steps
        torch.cuda.empty_cache()
    print(f"[19 capture] (c) in turns on one state, {TRAIN_STEPS} steps a "
          f"block, ms/step on {card}: "
          + "; ".join(f"{k} eager {[round(v, 2) for v in r['ms']['eager']]} "
                      f"captured {[round(v, 2) for v in r['ms']['captured']]}"
                      f" (peak {r['peak_gib']:.2f} GiB)"
                      for k, r in out.items()))
    return out


def _capture_variants(dev):
    """Phase 19 (d): DSK, PBE, ``mode=nerf`` and two microbatches, small:
    captured (or named eager by ``train/capture.py::EAGER``), their losses
    against the eager step's from one state."""
    import torch

    from evdeblurnerf_torch.train import capture
    from evdeblurnerf_torch.train import state as tstate
    from evdeblurnerf_torch.train import step as tstep

    out = {}
    for label, flags in CAPTURE_VARIANTS.items():
        args = train_args(**_bench_torch().TINY, **flags)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        model, crf = tstate.build_model(args, AABB, H, W, FOCAL, NEAR, FAR,
                                        NUM_IMAGES, gen, dev)
        sd = {k: v.clone() for k, v in model.state_dict().items()}
        crf_sd = {k: v.clone() for k, v in crf.state_dict().items()}
        batch, ev_batch = make_train_batch(dev, args.N_rand,
                                           args.events_N_rand)
        sw_of = tstep.schedule_weights_fn(args)
        losses, graphs = {}, None
        for name in ("eager", "captured"):
            model, state = _sd_state(args, dev, sd, crf_sd)
            step = (capture.CapturedStep(args) if name == "captured"
                    else tstep.build_train_step(args))
            losses[name] = [float(step(state, batch, ev_batch,
                                       sw_of(state.step), False, True)
                                  ["loss"])
                            for _ in range(CAPTURE_SMALL_STEPS)]
            if name == "captured":
                graphs = len(step.graphs)
        reason = capture.eager_reason(args)
        rel = max(abs(a - b) / abs(a) for a, b in
                  zip(losses["eager"], losses["captured"]))
        out[label] = dict(graphs=graphs, eager_reason=reason, rel=rel)
        check(reason is not None or graphs == 1,
              f"{label}: {graphs} graphs and no eager entry")
        check(rel <= TRAIN_LOSS_TOL, f"{label}: captured losses "
              f"{losses['captured']} against eager {losses['eager']}")
    print(f"[19 capture] (d) small steps, {CAPTURE_SMALL_STEPS} each, "
          f"captured against eager from one state: "
          + "; ".join(f"{k}: " + (f"eager by the table ({r['eager_reason']})"
                                  if r["eager_reason"] else
                                  f"{r['graphs']} graph, loss rel "
                                  f"{r['rel']:.2e}")
                      for k, r in out.items()))
    return out


def _capture_run(dev, tmp):
    """Phase 19 (e): ``cli.main`` at the validation tool's small profile:
    a run that captures both keys and checkpoints, then its resumption,
    which captures again; the loss finite and falling."""
    from evdeblurnerf_torch.train import loop as tloop

    vtt = _load_tool("validate_train_torch")
    sst = _load_tool("synthetic_scene_torch")
    scene = os.path.join(tmp, "capscene")
    sst.write_synthetic_scene(scene)
    made = []
    build = tloop.build_loop_step

    def recording(*a, **kw):
        made.append(build(*a, **kw))
        return made[-1]

    tloop.build_loop_step = recording
    try:
        for iters in CAPTURE_RUN_ITERS:
            argv = ["--iters", str(iters), "--profile", "small", "--scene",
                    scene, "--logdir", tmp, "--expname", "capture",
                    "--device", str(dev)]
            for k, v in CAPTURE_RUN_FLAGS.items():
                argv += [f"--{k}", str(v)]
            vtt.main(argv)
    finally:
        tloop.build_loop_step = build
    stream, _ = _metric_stream(os.path.join(tmp, "capture", "metrics.jsonl"))
    losses = [v for _, v in stream.get("train/loss", [])]
    steps = [s for s, _ in stream.get("train/loss", [])]
    graphs = [sorted(s.graphs) for s in made]
    head, tail = losses[:4], losses[-4:]
    print(f"[19 capture] (e) cli.main {CAPTURE_RUN_ITERS[0]} steps, then "
          f"resumed to {CAPTURE_RUN_ITERS[1]}: graphs of each run {graphs}; "
          f"losses {[round(v, 5) for v in losses]}")
    check(steps == list(range(CAPTURE_RUN_ITERS[1])),
          f"logged steps {steps}")
    check(len(graphs) == 2 and len(graphs[0]) == 2 and len(graphs[1]) == 1,
          f"graphs of the two runs {graphs}: expected both keys, then the "
          "resumed run's one")
    check(all(math.isfinite(v) for v in losses), f"losses {losses}")
    check(sum(tail) < sum(head), f"the loss did not fall: {losses}")
    return dict(losses=losses, graphs=graphs)


def phase_capture(dev, card, sd, crf_sd):
    """Phase 19 (module docstring). Returns the launches of (a)'s captured
    run."""
    launches, window = _capture_window(dev, card, sd, crf_sd)
    turns = _capture_turns(dev, card, sd, crf_sd)
    variants = _capture_variants(dev)
    with tempfile.TemporaryDirectory() as tmp:
        run = _capture_run(dev, tmp)
    return launches, dict(window=window, turns=turns, variants=variants,
                          run=run)


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
    start = time.perf_counter()
    try:
        card = phase_environment()
        dev = torch.device("cuda", 0)
        phase_build()
        kernel_results = phase_kernels(dev)
        tp_cases = _tp_width_kernels(
            dev, torch.Generator(device=dev).manual_seed(SEED + 16),
            _load_tool("bench_kernel_variants_torch"),
            _load_tool("timing_torch"))
        for name in ("triplane_features", "triplane_features_bwd"):
            kernel_results[name]["cases"].update(tp_cases.pop(name))
        renderer, sd_serve, serve_launches, served = phase_serving(dev, card)
        phase_card_vs_cpu(dev, renderer, sd_serve)
        del renderer
        torch.cuda.empty_cache()
        train_launches, sd, crf_sd, step_only = phase_train(dev, card)
        phase_train_card_vs_cpu(dev, sd, crf_sd)
        loop_launches, _ = phase_loop(dev, card, step_only)
        bench_launches = phase_bench_entry()
        phase_pbe(dev, card)
        phase_bench_torch(step_only)
        nerf_launches, _ = phase_nerf(dev, card)
        cull_launches, _ = phase_cull(dev, card, sd, crf_sd)
        bf16_records, _ = phase_bf16(dev, card, sd_serve, sd, crf_sd)
        for name, cases in tp_cases.items():
            bf16_records[name]["cases"].update(cases)
        export_launches, _ = phase_export(dev, card, sd_serve)
        parallel_launches, _ = phase_parallel(dev, card, sd, crf_sd,
                                              sd_serve, served)
        print(f"[17 precision] script wall time before phases 17-18: "
              f"{time.perf_counter() - start:.1f} s")
        precision_launches, _ = phase_precision(dev, card, sd_serve, sd,
                                                crf_sd)
        cull_ab_launches, _ = phase_tools(dev)
        print(f"[18 tools] script wall time after phases 17-18: "
              f"{time.perf_counter() - start:.1f} s")
        capture_launches, _ = phase_capture(dev, card, sd, crf_sd)
        print(f"[19 capture] script wall time after phase 19: "
              f"{time.perf_counter() - start:.1f} s")
        del sd, crf_sd, sd_serve, served
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
        r["launches_nerf"] = nerf_launches[name]
        r["launches_cull"] = cull_launches[name]
        if name in SERVE_KERNELS:
            r["launches_serve"] = serve_launches[name]
            r["launches_export"] = export_launches[name]
    # the bf16 forms: launches of phase 14's bf16 step, or of its bf16
    # served pose for the eval chain's form
    kernel_results.update(bf16_records)
    # the parallel paths: the launches of phase 16's compared steps, (b)
    # and (c), summed over their ranks; phase 17's TF32 step blocks and
    # phase 18's culled A/B arm; phase 19's captured window (the kernels
    # launched inside its graphs, counted at each replay)
    for name, r in kernel_results.items():
        r["launches_parallel"] = parallel_launches.get(name, 0)
        r["launches_precision_high"] = precision_launches.get(name, 0)
        r["launches_cull_ab"] = cull_ab_launches.get(name, 0)
        r["launches_captured"] = capture_launches.get(name, 0)
    print(json.dumps({"kernels": [dict(name=n, **r) for n, r in
                                  kernel_results.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
