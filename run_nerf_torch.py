#!/usr/bin/env python
"""Experiment entry point of the PyTorch/CUDA port (the counterpart of
``run_nerf.py``, which drives the JAX package).

Usage:
    python run_nerf_torch.py --config configs/<exp>.txt [--flag value ...]

Trains on the first CUDA device, each step a replay of the captured
training step (one CUDA graph per gate key, ``train/capture.py``),
checkpoints to
``<basedir>/<expname>/checkpoints/{step:06d}.tar``, resumes from the newest
one, renders the held-out views at the ``--i_testset`` cadence, and with
``--render_only`` renders from the newest checkpoint. ``--device cpu``
runs on the CPU.
"""

from evdeblurnerf_torch.cli import main

if __name__ == "__main__":
    main()
