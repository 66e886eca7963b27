#!/usr/bin/env python
"""GPU timing: kernels K7 (``tiled_plane_gather``), K1 (``permute_lanes``),
K4 (``triplane_features``), K5 (``triplane_features_bwd``) and K6
(``line_grad``) of the PyTorch/CUDA port, from the checkout this file lies in or from another one, so that two
versions of the sources can be timed on one card, one after the other.

It imports ``evdeblurnerf_torch`` from the checkout at ``--checkout DIR``
(default: this one), builds that checkout's kernels and calls them through
their Python wrappers: K7 at its bench's shapes
(``tools/bench_tiled_gather_torch.py``) and tiles, K1 forward at the eval
chunk [32768, 128] and the paper step's [10240, 128], with ``torch.gather``
beside it. Per kernel it prints the device time from ``torch.profiler``
with a warm L2 and after an L2 flush, the host's microseconds per call and
the back-to-back CUDA-event time (``tools/timing_torch.py``).

K5 and K6 (``--kernels k5,k6``) run at the paper's tables (``K5_CASES``,
``K6_CASES``): 2,097,152 uniformly random points, the training step's own
launch sizes (1,310,720 points on the fine tables, 655,360 on the coarse
ones) and the ray-ordered stream of one step
(``evdeblurnerf_torch/utils/locality.py::step_points_xyz``: 10,240 rays of
128 samples, neighbouring points in neighbouring texels). The wrapper
``triplane_features_bwd`` launches K5, PyTorch glue (memsets, the permutes
of the plane gradients) and, where K5 does not sum the line gradients
itself, K6, so beside its back-to-back time the device time is split by
kernel name (K5's kernel, K6's kernels, the rest).
K4 (``--kernels k4``) runs at ``K4_CASES``: K5's cases and an eval chunk's
launches (32,768 Morton-sorted rays of 64 samples on the coarse tables and
of 128 on the fine ones). Beside the kernel's device time stand two traffic
floors of the packed tables over the card's memory rate: every distinct
packed row once (what an unbounded cache would leave) and every point's
plane rows (what no cache at all would cost), each with xyz read and the
[N, 96] output written once. ``--k4-unpacked`` times the same cases
through ``triplane_features_unpacked``, K4's float4 kernel over texel-major
unpacked tables, a quarter of the packed planes' size. ``--k4-bf16``
times the same cases over bf16 tables, in the bf16-row form (f32 output)
and the bf16 eval chain's form (bf16 output), each in K4's two vector
kernels: four channels a lane on 8-byte loads and eight on 16-byte loads,
with whether the two agree bitwise.
``chip_smoke.py`` takes its K4, K5 and K6 inputs and times from here.

Another version is another directory: an earlier commit unpacked with
``git archive <commit> evdeblurnerf_torch | tar -x -C build/parent``, or a
copy of the package with one source edited. Run the versions alternately
(parent, change, change, parent) and compare only times taken on the same
card in one go.

Usage (needs one CUDA card and nvcc), from the root of a checkout:
    python tools/bench_kernel_variants_torch.py
    python tools/bench_kernel_variants_torch.py --checkout build/parent
    python tools/bench_kernel_variants_torch.py --kernels k5,k6
    python tools/bench_kernel_variants_torch.py --kernels k4 --k4-unpacked
    python tools/bench_kernel_variants_torch.py --kernels k4 --k4-bf16
"""

import argparse
import importlib.util
import os
import subprocess
import sys

TOOLS = os.path.dirname(os.path.abspath(__file__))
K1_SHAPES = ((32768, 128), (10240, 128))
# the paper configuration's grids (configs/evdeblurnerf_blender/
# tx_blurfactory_evdeblurnerf_ediprior_evcrf.txt) in bench.py's box
AABB = ((-1.6, -1.7, -1.0), (1.7, 1.6, 1.0))
N_VOXELS = dict(coarse=16777248, fine=134217984)
N_COMP = (64, 16, 16)
BENCH_POINTS = 2_097_152
STEP_RAYS, STEP_PTNUM, STEP_SAMPLES = 1024, 10, 128     # the fine RBK launch
STEP_FINE_POINTS = STEP_RAYS * STEP_PTNUM * STEP_SAMPLES    # 1,310,720
STEP_COARSE_POINTS = STEP_FINE_POINTS // 2                  # 64 samples
# label: (tables, points, stream)
K5_CASES = dict(
    bench_fine=("fine", BENCH_POINTS, "uniform"),
    bench_coarse=("coarse", BENCH_POINTS, "uniform"),
    step_fine=("fine", STEP_FINE_POINTS, "uniform"),
    step_coarse=("coarse", STEP_COARSE_POINTS, "uniform"),
    rays_fine=("fine", STEP_FINE_POINTS, "rays"))
# label: (tables, projection whose line table it is, points, stream); the
# table is that projection's packed line: D rows of 2C columns
K6_CASES = dict(
    bench=("fine", 0, BENCH_POINTS, "uniform"),
    step_fine=("fine", 0, STEP_FINE_POINTS, "uniform"),
    step_coarse=("coarse", 0, STEP_COARSE_POINTS, "uniform"),
    rays_fine=("fine", 0, STEP_FINE_POINTS, "rays"),
    rays_fine_narrow=("fine", 1, STEP_FINE_POINTS, "rays"))
EVAL_RAYS = 32768                                        # one eval chunk
# label: (tables, points, stream)
K4_CASES = dict(
    K5_CASES,
    eval_coarse=("coarse", EVAL_RAYS * 64, "eval_rays"),
    eval_fine=("fine", EVAL_RAYS * 128, "eval_rays"))
# in the kernels' names
K4_KERNEL, K5_KERNEL, K6_KERNEL = "triplane_fwd", "triplane_bwd", "line_grad"
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA's data sheet


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def paper_grids(dev, g, tables):
    """Random f32 grids ([C, H, W] planes, [C, D] lines) at the paper's
    ``tables`` ("coarse" or "fine"); returns (grid size, planes, lines)."""
    import torch

    from evdeblurnerf_torch.models.voxnerf import compute_grid_size
    from evdeblurnerf_torch.ops import triplane

    grid = compute_grid_size(AABB[0], AABB[1], N_VOXELS[tables])
    planes, lines = [], []
    for i, c in enumerate(N_COMP):
        m0, m1 = triplane.MAT_MODE[i]
        planes.append(0.1 * torch.randn(c, grid[m1], grid[m0], generator=g,
                                        device=dev))
        lines.append(0.1 * torch.randn(c, grid[triplane.VEC_MODE[i]],
                                       generator=g, device=dev))
    return grid, planes, lines


def sample_points(dev, g, n, stream):
    """[n, 3] points: "uniform" reaches past [-1, 1], so the zeros-padding
    and clip rules run, as they do for rays leaving the box; "rays" is the
    ray-ordered stream of one training step's fine RBK launch and
    "eval_rays" that of one eval chunk (``EVAL_RAYS`` rays of n / EVAL_RAYS
    samples), mapped from [0, 1] to [-1, 1]."""
    import torch

    if stream == "uniform":
        return torch.rand(n, 3, generator=g, device=dev) * 2.2 - 1.1
    from evdeblurnerf_torch.utils.locality import step_points_xyz

    if stream == "eval_rays":
        xyz = step_points_xyz(EVAL_RAYS, 1, n // EVAL_RAYS)
    else:
        xyz = step_points_xyz(STEP_RAYS, STEP_PTNUM, STEP_SAMPLES)
    if xyz.shape[0] != n:
        raise ValueError(f"the step's stream has {xyz.shape[0]} points, "
                         f"not {n}")
    return (torch.from_numpy(xyz).to(dev) * 2.0 - 1.0).contiguous()


def k5_inputs(dev, g, case):
    """(planes, lines, packed, xyz, cotangent) of one ``K5_CASES`` entry."""
    import torch

    from evdeblurnerf_torch.ops import triplane

    tables, n, stream = K5_CASES[case]
    _, planes, lines = paper_grids(dev, g, tables)
    xyz = sample_points(dev, g, n, stream)
    cot = torch.randn(n, sum(N_COMP), generator=g, device=dev)
    return planes, lines, triplane.pack_grids(planes, lines), xyz, cot


def k4_inputs(dev, g, case):
    """(planes, lines, packed, xyz) of one ``K4_CASES`` entry."""
    from evdeblurnerf_torch.ops import triplane

    tables, n, stream = K4_CASES[case]
    _, planes, lines = paper_grids(dev, g, tables)
    xyz = sample_points(dev, g, n, stream)
    return planes, lines, triplane.pack_grids(planes, lines), xyz


def k4_traffic(packed, xyz, out_bytes=4):
    """Bytes K4 moves over the packed tables (f32 or bf16) at these points,
    two ways:
    ``distinct`` counts every packed row that some point reads once (what
    an unbounded cache would leave), ``every_point`` every point's three
    plane rows (no cache at all: uniform points on tables far above the L2)
    and the distinct line rows (the line tables, 200 KB, stay cached); both
    add xyz read and the output written once (``out_bytes`` an element:
    4 f32, 2 under the bf16 eval chain)."""
    import torch

    from evdeblurnerf_torch.ops import triplane

    planes, lines, sizes = packed
    n = xyz.shape[0]
    fixed = n * (4 * 3 + out_bytes * sum(ln.shape[1] // 2 for ln in lines))
    distinct = every = 0

    def base(col, size):
        f = (xyz[:, col] + 1.0) * 0.5 * (size - 1)
        return torch.clamp(torch.floor(f), 0, size - 2).long()

    for i, (H, W, D) in enumerate(sizes):
        m0, m1 = triplane.MAT_MODE[i]
        texel = base(m1, H) * W + base(m0, W)
        row = base(triplane.VEC_MODE[i], D)
        prow = planes[i].element_size() * planes[i].shape[1]
        lrow = lines[i].element_size() * lines[i].shape[1]
        line_bytes = int(torch.unique(row).numel()) * lrow
        distinct += int(torch.unique(texel).numel()) * prow + line_bytes
        every += n * prow + line_bytes
    return dict(distinct=fixed + distinct, every_point=fixed + every)


def time_k4(timing, packed, xyz, unpacked=None):
    """K4 back to back and its kernel's own device ms; ``unpacked``
    (tables of ``fused_sample.unpack_grids``) times the float4 kernel over
    those instead of the packed ones."""
    from evdeblurnerf_torch.ops import fused_sample

    if unpacked is None:
        def call():
            return fused_sample.triplane_features(*packed, xyz)
    else:
        def call():
            return fused_sample.triplane_features_unpacked(*unpacked, xyz)

    return dict(ms=timing.cuda_ms(call, iters=10, warmup=2),
                device_ms=timing.device_ms_by_name(
                    call, (K4_KERNEL,))[K4_KERNEL])


def time_k4_bf16(timing, packed, xyz, compute_bf16):
    """K4 over bf16 tables (``packed``) in its two vector kernels, four
    channels a lane (``vec4``, 8-byte loads) and eight (``vec8``, 16-byte
    loads): each one's back-to-back ms and kernel device ms, and whether
    their outputs are bitwise equal."""
    import torch

    from evdeblurnerf_torch.ops import fused_sample

    times, outs = {}, []
    for label, mode in (("vec4", fused_sample.K4_FLOAT4),
                        ("vec8", fused_sample.K4_VEC8)):
        def call(mode=mode):
            return fused_sample._launch_k4(
                "triplane_features", *packed, xyz,
                compute_bf16=compute_bf16, mode=mode)

        outs.append(call())
        times[label] = dict(
            ms=timing.cuda_ms(call, iters=10, warmup=2),
            device_ms=timing.device_ms_by_name(
                call, (K4_KERNEL,))[K4_KERNEL])
    times["bitwise"] = bool(torch.equal(*outs))
    return times


def k6_inputs(dev, g, case):
    """(idx [N] int32, rows [N, 2C], D) of one ``K6_CASES`` entry: uniform
    row indices, or the packed line rows that the ray-ordered points
    read."""
    import torch

    from evdeblurnerf_torch.models.voxnerf import compute_grid_size
    from evdeblurnerf_torch.ops import fused_sample, triplane

    tables, proj, n, stream = K6_CASES[case]
    grid = compute_grid_size(AABB[0], AABB[1], N_VOXELS[tables])
    D = int(grid[triplane.VEC_MODE[proj]])
    if stream == "uniform":
        idx = torch.randint(0, D, (n,), generator=g, device=dev,
                            dtype=torch.int32)
    else:
        sizes = [(2, 2, int(grid[triplane.VEC_MODE[i]])) for i in range(3)]
        idx = fused_sample.line_base_index(
            sample_points(dev, g, n, stream), sizes)[proj].contiguous()
    rows = torch.randn(n, 2 * N_COMP[proj], generator=g, device=dev)
    return idx, rows, D


def time_k5(timing, planes, lines, packed, xyz, cot):
    """The wrapper's back-to-back ms and its device ms split into K5's
    kernel, K6's kernels and the rest."""
    from evdeblurnerf_torch.ops import fused_sample

    def call():
        return fused_sample.triplane_features_bwd(planes, lines, packed, xyz,
                                                  cot)

    parts = timing.device_ms_by_name(call, (K5_KERNEL, K6_KERNEL))
    return dict(ms=timing.cuda_ms(call, iters=10, warmup=2),
                device_ms=parts[K5_KERNEL], k6_device_ms=parts[K6_KERNEL],
                glue_device_ms=parts["other"])


def time_k6(timing, idx, rows, D):
    """``line_grad`` back to back, its kernel alone (without the memset of
    the output), and the one PyTorch call for the function."""
    import torch

    from evdeblurnerf_torch.ops import line_matmul

    def call():
        return line_matmul.line_grad(idx, rows, D)

    idx64 = idx.clamp(0, D - 1).long()
    W = rows.shape[1]
    return dict(
        ms=timing.cuda_ms(call),
        device_ms=timing.device_ms_by_name(call, (K6_KERNEL,))[K6_KERNEL],
        library_ms=timing.cuda_ms(lambda: torch.zeros(
            D, W, device=rows.device).index_add_(0, idx64, rows)))


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--checkout", metavar="DIR", default=os.path.dirname(TOOLS),
                    help="the directory that holds the evdeblurnerf_torch "
                    "to time (default: this checkout)")
    ap.add_argument("--kernels", default="k7,k1",
                    help="comma-separated choice of k7, k1, k4, k5, k6 "
                    "(default: k7,k1)")
    ap.add_argument("--k4-unpacked", action="store_true",
                    help="time K4 over texel-major unpacked tables as well")
    ap.add_argument("--k4-bf16", action="store_true",
                    help="time K4 over bf16 tables as well, four and eight "
                    "channels a lane")
    ap.add_argument("--skip-k7", action="store_true",
                    help="leave K7 out of the choice")
    opts = ap.parse_args(argv)
    chosen = set(opts.kernels.lower().split(","))
    if chosen - {"k7", "k1", "k4", "k5", "k6"}:
        ap.error(f"--kernels takes k7, k1, k4, k5, k6, got {opts.kernels}")
    if opts.skip_k7:
        chosen.discard("k7")

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_kernel_variants_torch: needs a CUDA card "
                         "(torch.cuda.is_available() is False)")
    timing = _load("timing_torch")
    bench = _load("bench_tiled_gather_torch")
    checkout = os.path.abspath(opts.checkout)
    sys.path.insert(0, checkout)        # ahead of what bench put there
    from evdeblurnerf_torch.ops import lane_shuffle
    from evdeblurnerf_torch.ops import tiled_gather as tg

    if not os.path.abspath(tg.__file__).startswith(checkout + os.sep):
        raise SystemExit(f"evdeblurnerf_torch came from {tg.__file__}, not "
                         f"from {checkout}")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}; evdeblurnerf_torch of {checkout}", flush=True)

    if "k7" in chosen:
        plane, fu, fv = bench.make_inputs(dev)
        H, W, C = plane.shape
        for TH, TW in bench.TILES:
            oy, ox, _ = tg.group_origins(fu, fv, H, W, TH, TW)
            device_ms, _, _ = timing.device_and_host(
                lambda: tg.tiled_plane_gather(plane, fu, fv, oy, ox, TH, TW),
                iters=20)
            print(f"K7 {TH}x{TW} (plane {H}x{W}x{C}, N = {fu.shape[0]}): "
                  f"device {device_ms:.4f} ms", flush=True)
        del plane, fu, fv
        torch.cuda.empty_cache()

    g = torch.Generator(device=dev).manual_seed(0)
    for case in K4_CASES if "k4" in chosen else ():
        from evdeblurnerf_torch.ops import fused_sample, triplane

        planes, lines, packed, xyz = k4_inputs(dev, g, case)
        t = time_k4(timing, packed, xyz)
        floors = {k: 1e3 * v / HBM_BYTES_PER_S
                  for k, v in k4_traffic(packed, xyz).items()}
        line = (f"K4 {case} {K4_CASES[case]}: back to back {t['ms']:.4f} ms, "
                f"kernel device {t['device_ms']:.4f} ms; packed-table "
                f"traffic floors: distinct rows {floors['distinct']:.4f} ms, "
                f"every point's rows {floors['every_point']:.4f} ms")
        if opts.k4_unpacked:
            del packed
            u = time_k4(timing, None, xyz,
                        fused_sample.unpack_grids(planes, lines))
            line += (f"; unpacked tables: back to back {u['ms']:.4f} ms, "
                     f"kernel device {u['device_ms']:.4f} ms")
        print(line, flush=True)
        if opts.k4_bf16:
            packed = triplane.pack_grids(
                [p.to(torch.bfloat16) for p in planes],
                [ln.to(torch.bfloat16) for ln in lines])
            for compute in (False, True):
                t = time_k4_bf16(timing, packed, xyz, compute)
                print(f"K4 bf16 {'chain' if compute else 'rows'} {case}: "
                      + "; ".join(
                          f"{k} back to back {t[k]['ms']:.4f} ms, kernel "
                          f"device {t[k]['device_ms']:.4f} ms"
                          for k in ("vec4", "vec8"))
                      + f"; bitwise equal: {t['bitwise']}", flush=True)
            del packed
        del planes, lines, xyz
        torch.cuda.empty_cache()
    for case in K5_CASES if "k5" in chosen else ():
        t = time_k5(timing, *k5_inputs(dev, g, case))
        print(f"K5 {case} {K5_CASES[case]}: wrapper back to back "
              f"{t['ms']:.4f} ms; device: K5 kernel {t['device_ms']:.4f} ms, "
              f"K6 kernels {t['k6_device_ms']:.4f} ms, glue "
              f"{t['glue_device_ms']:.4f} ms", flush=True)
        torch.cuda.empty_cache()
    for case in K6_CASES if "k6" in chosen else ():
        idx, rows, D = k6_inputs(dev, g, case)
        t = time_k6(timing, idx, rows, D)
        print(f"K6 {case} (D = {D}, W = {rows.shape[1]}, N = "
              f"{rows.shape[0]}, {K6_CASES[case][3]}): back to back "
              f"{t['ms']:.4f} ms, kernel device {t['device_ms']:.4f} ms, "
              f"index_add_ {t['library_ms']:.4f} ms", flush=True)
        del idx, rows
        torch.cuda.empty_cache()
    for R, S in K1_SHAPES if "k1" in chosen else ():
        x = torch.randn(R, S, generator=g, device=dev)
        _, perm, inv = lane_shuffle.sort_with_perm(
            torch.rand(R, S, generator=g, device=dev))
        perm64 = perm.long()
        for label, fn in (
                ("K1 permute_lanes", lambda: lane_shuffle.permute_lanes(
                    x, perm, inv)),
                ("torch.gather", lambda: torch.gather(x, -1, perm64))):
            device_ms, cold_ms, host_us = timing.device_and_host(fn)
            print(f"{label} [{R}, {S}]: device {device_ms:.4f} ms, L2 "
                  f"flushed {cold_ms:.4f} ms, host {host_us:.1f} us/call, "
                  f"back to back {timing.cuda_ms(fn):.4f} ms", flush=True)


if __name__ == "__main__":
    main()
