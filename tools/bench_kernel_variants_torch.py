#!/usr/bin/env python
"""GPU timing: kernels K7 (``tiled_plane_gather``) and K1
(``permute_lanes``) of the PyTorch/CUDA port, from the checkout this file
lies in or from another one, so that two versions of the sources can be
timed on one card, one after the other.

It imports ``evdeblurnerf_torch`` from the checkout at ``--checkout DIR``
(default: this one), builds that checkout's kernels and calls them through
their Python wrappers: K7 at its bench's shapes
(``tools/bench_tiled_gather_torch.py``) and tiles, K1 forward at the eval
chunk [32768, 128] and the paper step's [10240, 128], with ``torch.gather``
beside it. Per kernel it prints the device time from ``torch.profiler``
with a warm L2 and after an L2 flush, the host's microseconds per call and
the back-to-back CUDA-event time (``tools/timing_torch.py``).

Another version is another directory: an earlier commit unpacked with
``git archive <commit> evdeblurnerf_torch | tar -x -C build/parent``, or a
copy of the package with one source edited. Run the versions alternately
(parent, change, change, parent) and compare only times taken on the same
card in one go.

Usage (needs one CUDA card and nvcc), from the root of a checkout:
    python tools/bench_kernel_variants_torch.py
    python tools/bench_kernel_variants_torch.py --checkout build/parent
"""

import argparse
import importlib.util
import os
import subprocess
import sys

TOOLS = os.path.dirname(os.path.abspath(__file__))
K1_SHAPES = ((32768, 128), (10240, 128))


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--checkout", metavar="DIR", default=os.path.dirname(TOOLS),
                    help="the directory that holds the evdeblurnerf_torch "
                    "to time (default: this checkout)")
    ap.add_argument("--skip-k7", action="store_true",
                    help="time K1 and torch.gather only")
    opts = ap.parse_args(argv)

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

    if not opts.skip_k7:
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
    for R, S in K1_SHAPES:
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
