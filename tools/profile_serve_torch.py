#!/usr/bin/env python
"""Where one H100 spends an eval chunk of the PyTorch port, with f32 tables
and through the bf16 eval chain (``--triplane_bf16``), on the same weights:
each chunk's device time by kernel name, largest first, from
``torch.profiler`` (``tools/timing_torch.py``).

The model is ``bench_torch.py``'s serve model (the paper configuration's
fields, seeded random weights) behind ``serving.build_renderer``; the
chunk is the first 32,768 rays of a 480 x 640 pose.

Usage (needs one CUDA card and nvcc), from the root of a checkout:
    python tools/profile_serve_torch.py [--iters 3] [--top 15]
"""

import argparse
import collections
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--top", type=int, default=15)
    opts = ap.parse_args(argv)

    import numpy as np
    import torch

    import bench_torch
    import timing_torch
    from evdeblurnerf_torch import serving
    from evdeblurnerf_torch.models.renderer import config_from_args
    from evdeblurnerf_torch.models.system import EvDeblurNeRF
    from evdeblurnerf_torch.train.evaluate import pose_rays
    from evdeblurnerf_torch.utils.precision import set_matmul_precision

    if not torch.cuda.is_available():
        raise SystemExit("profile_serve_torch: needs a CUDA card")
    dev = torch.device("cuda", 0)
    h, w, focal = bench_torch.H, bench_torch.W, bench_torch.FOCAL
    K = [[focal, 0.0, w / 2], [0.0, focal, h / 2], [0.0, 0.0, 1.0]]
    args = bench_torch.train_args(chunk=32768)
    set_matmul_precision(args.matmul_precision)
    gen = torch.Generator(device=dev).manual_seed(bench_torch.SEED)
    model = EvDeblurNeRF(config_from_args(args, bench_torch.AABB, h, w, focal,
                                          bench_torch.NEAR, bench_torch.FAR),
                         generator=gen, device=dev)
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    del model
    pose = np.concatenate([np.eye(3), np.zeros((3, 1))], 1)[None]
    rays = pose_rays(pose, h, w, np.asarray(K), dev)[:args.chunk] \
        .contiguous()
    out = {"card": bench_torch.card_line()}
    for name, bf16 in (("f32", False), ("bf16_chain", True)):
        r = serving.build_renderer(
            bench_torch.train_args(chunk=32768, triplane_bf16=bf16), sd, h,
            w, K, bench_torch.NEAR, bench_torch.FAR, bench_torch.AABB,
            device=dev)
        for _ in range(2):
            r(rays)
        by_name = collections.defaultdict(lambda: [0.0, 0])
        for kname, us in timing_torch._device_activities(
                lambda: r(rays), opts.iters):
            by_name[kname][0] += us / opts.iters / 1e3
            by_name[kname][1] += 1
        total = sum(v[0] for v in by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:opts.top]
        print(f"{name}: {total:.2f} device ms a chunk")
        for kname, (ms, n) in top:
            print(f"  {ms:8.3f} ms  {n // opts.iters:4d}x  {kname[:110]}")
        out[name] = dict(device_ms=total,
                         top=[(k[:110], ms, n // opts.iters)
                              for k, (ms, n) in top])
        del r
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
