"""Console entry points (``evdn-train-torch``, ``evdn-export-torch``; also
``python run_nerf_torch.py`` and ``python tools/export_renderer_torch.py``).

Counterpart of ``evdeblurnerf_tpu/cli.py``: the reference-compatible flag
surface and config files (``config.py``), the lifecycle in
``train/loop.py``, the serving export in ``serving.py``. A run goes to the
card unless ``--device cpu`` is given; ``--render_only`` renders from the
newest checkpoint.
"""

from __future__ import annotations

import os


def main(argv=None, **dataset_classes):
    """Parse ``argv`` (default: the command line) and run the lifecycle;
    returns the final train state. ``dataset_classes`` (``llff_cls``,
    ``events_cls``: subclasses that read a scene stored another way) go
    to ``train.loop.train``."""
    from .config import parse_args
    from .train.loop import train

    args = parse_args(argv)
    print("RANDOM SEED", args.seed)
    return train(args, **dataset_classes)


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
                    help="devices to export over, data-parallel; only 1 is "
                         "ported (more is ROADMAP queue 1 item 22)")
    cli, rest = ap.parse_known_args(argv)

    from . import config, serving

    args = config.parse_args(rest)
    meta = serving.export_experiment(args, cli.out, chunk=cli.export_chunk,
                                     devices=cli.export_devices)
    print(f"wrote {cli.out} ({os.path.getsize(cli.out) / 1e6:.1f} MB, "
          f"step={meta['step']}, chunk={cli.export_chunk}, "
          f"device={meta['device']}, tables={meta['tables']}, "
          f"triplane_bf16={meta['triplane_bf16']})")
    return meta


if __name__ == "__main__":
    main()
