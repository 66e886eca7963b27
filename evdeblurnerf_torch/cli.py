"""Console entry points (``evdn-train-torch``, ``evdn-export-torch``; also
``python run_nerf_torch.py`` and ``python tools/export_renderer_torch.py``).

Counterpart of ``evdeblurnerf_tpu/cli.py``: the reference-compatible flag
surface and config files (``config.py``), the lifecycle in
``train/loop.py``, the serving export in ``serving.py``. A run goes to the
card unless ``--device cpu`` is given; ``--render_only`` renders from the
newest checkpoint. Under ``torchrun`` (``WORLD_SIZE`` in the environment)
or with ``--multihost`` (the ``EVDN_*`` variables) the process first joins
the process group (``parallel/multihost.py``), and only the primary
process prints.
"""

from __future__ import annotations

import os


def main(argv=None, **dataset_classes):
    """Parse ``argv`` (default: the command line) and run the lifecycle;
    returns the final train state. ``dataset_classes`` (``llff_cls``,
    ``events_cls``: subclasses that read a scene stored another way) go
    to ``train.loop.train``."""
    import sys

    from .config import parse_args
    from .parallel import multihost
    from .train.loop import train

    args = parse_args(argv)
    joined = multihost.wants_process_group(args.multihost)
    if joined:
        # before anything touches the card
        multihost.initialize(device=args.device)
        if not multihost.is_primary():
            sys.stdout = open(os.devnull, "w")    # side-effect-free workers
    print("RANDOM SEED", args.seed)
    try:
        return train(args, **dataset_classes)
    finally:
        if joined:
            multihost.shutdown()


def export_main(argv=None) -> dict:
    """``evdn-export-torch``: a trained experiment -> one serving artifact
    (the eval render traced by ``torch.export``, the weights held in the
    program; see :mod:`evdeblurnerf_torch.serving`). Returns its header."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="evdn-export-torch",
        description="Export a trained experiment of the PyTorch port as a "
                    "serving artifact for the device of --device (the card "
                    "unless --device cpu). The remaining flags are the "
                    "experiment's, e.g. --config configs/exp.txt.")
    ap.add_argument("--out", required=True, help="output artifact path")
    ap.add_argument("--export_chunk", type=int, default=32768,
                    help="the fixed rays-per-call chunk of the program")
    ap.add_argument("--export_devices", type=int, default=1,
                    help="export data-parallel over this many devices "
                         "(rays split; the artifact then needs this many "
                         "devices at serving time)")
    cli, rest = ap.parse_known_args(argv)

    from . import config, serving

    args = config.parse_args(rest)
    meta = serving.export_experiment(args, cli.out, chunk=cli.export_chunk,
                                     devices=cli.export_devices)
    print(f"wrote {cli.out} ({os.path.getsize(cli.out) / 1e6:.1f} MB, "
          f"step={meta['step']}, chunk={cli.export_chunk}, "
          f"device={meta['device']}, devices={meta['devices']}, "
          f"tables={meta['tables']}, "
          f"triplane_bf16={meta['triplane_bf16']})")
    return meta


if __name__ == "__main__":
    main()
