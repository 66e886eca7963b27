#!/usr/bin/env python
"""Where one H100 spends a training step *through the loop*: the device's
busy and idle share and its largest kernels, from a ``torch.profiler``
trace of the port's train loop at the paper width.

It writes the synthetic scene of ``tools/synthetic_scene_torch.py``, trains
three steps through ``evdeblurnerf_torch.cli.main`` with every schedule gate open (blur kernel,
events and the learned CRF live) to leave a checkpoint, then resumes and
profiles ``--steps`` more. The window runs from the start of the third
profiled step to the start of the last one (the loop marks each step with
a ``train_step`` range), so it holds neither the warm-up nor the last
step's logging, checkpoint and testset render. Tracing slows the host, so
the window's time per step is printed beside the untraced figure of
``chip_smoke.py`` phase 8 rather than in its place.

Usage (needs one CUDA card and nvcc), from the root of a checkout:
    python tools/profile_loop_torch.py [--steps 8] [--top 12]
"""

import argparse
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

PAPER_CONFIG = ("configs/evdeblurnerf_blender/"
                "tx_blurfactory_evdeblurnerf_ediprior_evcrf.txt")
WARMUP_STEPS = 3          # trained before the profiled run, unprofiled
SKIP = 2                  # profiled steps left out of the window
GATES_OPEN = dict(kernel_start_iter=0, add_event_egm_startiter=0,
                  tone_mapping_start_learn_iter=0)


def busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--top", type=int, default=12)
    opts = ap.parse_args(argv)

    import torch
    from torch.autograd import DeviceType

    if not torch.cuda.is_available():
        raise SystemExit("profile_loop_torch: needs a CUDA card "
                         "(torch.cuda.is_available() is False)")
    import synthetic_scene_torch as synth
    from evdeblurnerf_torch import cli, config
    from evdeblurnerf_torch.train.loop import STEP_RANGE

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    llff_cls, events_cls = synth.scene_classes()
    paper = ["--config", os.path.join(REPO, PAPER_CONFIG)]
    with tempfile.TemporaryDirectory() as tmp:
        scene = os.path.join(tmp, "scene")
        os.makedirs(scene)
        synth.write_scene(scene, config.parse_args(paper).events_threshold)
        logs = os.path.join(tmp, "logs")

        def run(n_iters):
            flags = dict(datadir=scene, basedir=logs, tbdir=logs,
                         expname="profile", no_wandb=True, N_iters=n_iters,
                         i_print=10 ** 9, i_tensorboard=10 ** 9,
                         i_weights=10 ** 9, i_testset=10 ** 9,
                         i_video=10 ** 9, **GATES_OPEN)
            argv = list(paper)
            for k, v in flags.items():
                argv += [f"--{k}", str(v)]
            return cli.main(argv, llff_cls=llff_cls, events_cls=events_cls)

        run(WARMUP_STEPS)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            run(WARMUP_STEPS + opts.steps)
            torch.cuda.synchronize()

    events = prof.events()
    steps = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.name == STEP_RANGE
                   and e.device_type == DeviceType.CPU)
    if len(steps) != opts.steps:
        raise SystemExit(f"found {len(steps)} '{STEP_RANGE}' ranges, "
                         f"expected {opts.steps}")
    t0, t1 = steps[SKIP][0], steps[-1][0]
    n = opts.steps - 1 - SKIP
    by_name, spans = {}, []
    for e in events:
        # kernels and copies only: the step range shows on the device's
        # timeline too, as an annotation
        if (e.device_type != DeviceType.CUDA or e.name == STEP_RANGE
                or getattr(e, "is_user_annotation", False)):
            continue
        s, t = max(e.time_range.start, t0), min(e.time_range.end, t1)
        if t <= s:
            continue
        spans.append((s, t))
        tot = by_name.setdefault(e.name, [0.0, 0])
        tot[0] += t - s
        tot[1] += 1
    if not spans:
        raise SystemExit("the trace holds no device activity in the window")
    window = t1 - t0
    busy = busy_us(spans)
    host = sum(e - s for s, e in steps[SKIP:-1])
    print(f"card: {card}")
    print(f"window: {n} steps, {window / n / 1e3:.1f} ms/step while traced; "
          f"device busy {100 * busy / window:.1f}%, idle "
          f"{100 * (1 - busy / window):.1f}%; {len(spans) / n:.0f} device "
          f"activities per step; the host is inside the step call "
          f"{100 * host / window:.1f}% of the window")
    print(f"largest device activities, ms per step (count per step):")
    for name, (us, cnt) in sorted(by_name.items(),
                                  key=lambda kv: -kv[1][0])[:opts.top]:
        print(f"  {us / n / 1e3:8.3f}  ({cnt / n:6.1f})  {name[:100]}")


if __name__ == "__main__":
    main()
