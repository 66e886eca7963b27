"""Console entry point (``evdn-train-torch``; also ``python
run_nerf_torch.py``).

Counterpart of ``evdeblurnerf_tpu/cli.py::main``: the reference-compatible
flag surface and config files (``config.py``), the lifecycle in
``train/loop.py``. The run goes to the card unless ``--device cpu`` is
given. The render-only export entry point of the JAX package has no
counterpart yet (ROADMAP queue 1 item 23); ``--render_only`` renders from
the newest checkpoint.
"""

from __future__ import annotations


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


if __name__ == "__main__":
    main()
