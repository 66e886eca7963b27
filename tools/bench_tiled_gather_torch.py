#!/usr/bin/env python
"""GPU timing: the tiled plane gather (kernel K7 of the PyTorch/CUDA port)
against the packed row take at paper scale.

Counterpart of ``tools/bench_tiled_gather.py``. Realistic point stream:
LLFF-style pinhole rays + RBK-ish warps, NDC, stratified depths,
Morton-sorted rays (``evdeblurnerf_torch/utils/locality.py``). One
projection (XY, C = 64) of a 512 x 512 plane; no channel padding (the JAX
bench pads to 128 channels for the TPU's lanes). Per tile shape it prints
the spill share, the kernel's time against its plain PyTorch twin
(CUDA-event means in the order plain, kernel, kernel, plain) and the
largest difference from the packed row take on the points inside their
tiles; before that the times of the two yardsticks, the packed row take
(``ops/triplane.py``) and ``F.grid_sample``.

Usage (needs one CUDA card and nvcc):
    python tools/bench_tiled_gather_torch.py [--n_rand 1024] [--iters 10]
"""

import argparse
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

TILES = ((32, 32), (64, 64), (48, 128))
PLANE_HW, CHANNELS = 512, 64


def cuda_ms(fn, iters=10, warmup=2):
    """Mean milliseconds of ``fn`` over ``iters`` runs between CUDA events."""
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


def make_inputs(device, n_rand=1024, ptnum=10, S=128, seed=0):
    """(plane [H, W, C], fu, fv [N]) on ``device``: the bench's random
    plane and the step's point stream in texel coordinates, N cut to a
    multiple of the group size."""
    import numpy as np
    import torch

    from evdeblurnerf_torch.ops.tiled_gather import GROUP
    from evdeblurnerf_torch.utils.locality import step_points_xyz

    xyz = step_points_xyz(n_rand=n_rand, ptnum=ptnum, S=S, seed=seed)
    xyz = xyz[:(xyz.shape[0] // GROUP) * GROUP]
    rng = np.random.default_rng(0)
    plane = rng.normal(size=(PLANE_HW, PLANE_HW, CHANNELS)).astype(np.float32)
    fu = (xyz[:, 0] * (PLANE_HW - 1)).astype(np.float32)
    fv = (xyz[:, 1] * (PLANE_HW - 1)).astype(np.float32)
    return (torch.from_numpy(plane).to(device),
            torch.from_numpy(fu).to(device), torch.from_numpy(fv).to(device))


def yardsticks(plane, fu, fv):
    """(packed row take, ``F.grid_sample``) as zero-argument callables
    returning [N, C]; the packing and the layout change happen once,
    outside them."""
    import torch
    import torch.nn.functional as F

    from evdeblurnerf_torch.ops import triplane

    H, W, C = plane.shape
    x = fu / (W - 1) * 2 - 1
    y = fv / (H - 1) * 2 - 1
    plane_chw = plane.permute(2, 0, 1).contiguous()
    packed = triplane.pack_plane(plane_chw).contiguous()
    grid = torch.stack([x, y], -1)[None, None]             # [1, 1, N, 2]

    def row_take():
        return triplane.grid_sample_2d_packed(packed, H, W, x, y)

    def library():
        return F.grid_sample(plane_chw[None], grid, mode="bilinear",
                             padding_mode="zeros",
                             align_corners=True)[0, :, 0].T

    return row_take, library


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n_rand", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=10)
    cli = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_tiled_gather_torch: needs a CUDA card "
                         "(torch.cuda.is_available() is False)")
    from evdeblurnerf_torch import kernels
    from evdeblurnerf_torch.ops import tiled_gather as tg

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    plane, fu, fv = make_inputs(dev, n_rand=cli.n_rand)
    N = fu.shape[0]
    print(f"card: {card}; N = {N} points, plane {PLANE_HW}x{PLANE_HW}x"
          f"{CHANNELS} f32", flush=True)

    row_take, library = yardsticks(plane, fu, fv)
    ref = row_take()
    t_take = cuda_ms(row_take, cli.iters)
    t_lib = cuda_ms(library, cli.iters)
    lib_err = float((library() - ref).abs().max())
    print(f"packed row-take: {t_take:.3f} ms ({t_take / N * 1e6:.2f} ns/pt)")
    print(f"F.grid_sample:   {t_lib:.3f} ms ({t_lib / N * 1e6:.2f} ns/pt), "
          f"max |diff| from the row take {lib_err:.2e}", flush=True)

    for TH, TW in TILES:
        oy, ox, ok = tg.group_origins(fu, fv, PLANE_HW, PLANE_HW, TH, TW)
        spill = 1.0 - float(ok.float().mean())

        def plain():
            return tg.tiled_plane_gather_plain(plane, fu, fv, oy, ox, TH, TW)

        def kernel():
            return tg.tiled_plane_gather(plane, fu, fv, oy, ox, TH, TW)

        out = kernel()
        err = float((out[ok] - ref[ok]).abs().max())
        vs_twin = float((out - plain()).abs().max())
        p1, k1, k2, p2 = (cuda_ms(plain, cli.iters), cuda_ms(kernel, cli.iters),
                          cuda_ms(kernel, cli.iters), cuda_ms(plain, cli.iters))
        t = (k1 + k2) / 2
        print(f"tiled {TH}x{TW}: {t:.3f} ms ({t / N * 1e6:.2f} ns/pt), plain "
              f"twin {(p1 + p2) / 2:.3f} ms, spill {spill * 100:.2f}%, "
              f"max|err| vs row take {err:.2e}, vs twin {vs_twin:.2e}",
              flush=True)
    print(f"launches: {kernels.LAUNCHES['tiled_plane_gather']}")


if __name__ == "__main__":
    main()
