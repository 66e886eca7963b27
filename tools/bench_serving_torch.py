#!/usr/bin/env python
"""Latency and throughput of an exported render artifact of the PyTorch
port (``evdeblurnerf_torch/serving.py``); the counterpart of
``tools/bench_serving.py``.

- **latency**: wall time of one synchronous chunk render (call -> result
  on the host), p50/p90/p99 over ``--calls`` calls: what an online request
  pays. A chunk replays the artifact's CUDA graph on a card
  (``serving.ExportedRenderer``); the same readings of the eager call on
  the same renderer are kept under ``eager``, taken first;
- **throughput**: rays/s with ``--in_flight`` chunks queued ahead of the
  host's wait (the offline and video-render regime, the pipeline of
  ``train/evaluate.py``);
- **load and first call**: reading the artifact (``torch.export.load``)
  and the first chunk (the kernels' build and load on a fresh machine,
  the allocator's warm-up): the cold start a replica pays once.

Prints ONE JSON line, with the device it ran on. Usage::

    python tools/export_renderer_torch.py --config ... --out scene.evdnpt
    python tools/bench_serving_torch.py --artifact scene.evdnpt
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def make_rays(n: int, seed: int = 0) -> np.ndarray:
    """[n, 3, 2] f32 rays near the origin looking down -z, from a seed."""
    r = np.random.default_rng(seed)
    o = r.normal(size=(n, 3)).astype(np.float32) * 0.05
    d = r.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 0.5
    return np.stack([o, d], axis=-1)


def readings(call, rays, calls: int, in_flight: int, sync) -> dict:
    """Latency p50/p90/p99 and throughput of ``call`` on ``rays``."""
    # latency: a synchronous call with its result on the host
    lat = []
    for _ in range(calls):
        t0 = time.perf_counter()
        rgb, depth, _ = call(rays)
        rgb.cpu(), depth.cpu()
        lat.append(time.perf_counter() - t0)
    lat = np.asarray(lat)

    # throughput: at most ``in_flight`` chunks queued before the host waits
    sync()
    t0 = time.perf_counter()
    pending = []
    for _ in range(calls):
        rgb, depth, _ = call(rays)
        pending.append((rgb, depth))
        while len(pending) > max(in_flight, 0):
            a, b = pending.pop(0)
            a.cpu(), b.cpu()
    for a, b in pending:
        a.cpu(), b.cpu()
    sync()
    thr_dt = (time.perf_counter() - t0) / calls
    return {
        "latency_p50_ms": float(np.percentile(lat, 50)) * 1e3,
        "latency_p90_ms": float(np.percentile(lat, 90)) * 1e3,
        "latency_p99_ms": float(np.percentile(lat, 99)) * 1e3,
        "throughput_rays_per_sec": rays.shape[0] / thr_dt,
    }


def run(artifact: str, calls: int = 30, in_flight: int = 4,
        warmup: int = 3) -> dict:
    """Measure one artifact; returns the result dict."""
    import torch

    from evdeblurnerf_torch import serving

    def sync():
        if r.device.type == "cuda":
            torch.cuda.synchronize(r.device)

    t0 = time.perf_counter()
    r = serving.load_renderer(artifact)
    load_s = time.perf_counter() - t0

    rays = torch.from_numpy(make_rays(r.chunk)).to(r.device)
    t0 = time.perf_counter()
    r(rays)[0].cpu()
    first_call_s = time.perf_counter() - t0
    # the second call captures the graph the later ones replay
    for _ in range(max(warmup - 1, 0)):
        r(rays)[0].cpu()

    eager = readings(r.eager, rays, calls, in_flight, sync)
    return {
        "artifact": artifact,
        "chunk": r.chunk,
        "device": (torch.cuda.get_device_name(r.device)
                   if r.device.type == "cuda" else "cpu"),
        "bytes": os.path.getsize(artifact),
        "load_s": load_s,
        "first_call_s": first_call_s,
        **readings(r, rays, calls, in_flight, sync),
        "eager": eager,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--artifact", required=True)
    ap.add_argument("--calls", type=int, default=30)
    ap.add_argument("--in_flight", type=int, default=4)
    args = ap.parse_args(argv)
    res = run(args.artifact, calls=args.calls, in_flight=args.in_flight)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
