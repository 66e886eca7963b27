"""Flags of the port: the JAX package's parser with the port's defaults.

The flag surface and config-file format are those of
``evdeblurnerf_tpu/config.py`` (stdlib only, no jax). Flags whose JAX
defaults were chosen for the TPU default differently here: f32 tables and
reference-exact sampling (``triplane_bf16``, ``triplane_line_matmul`` and
``fine_cull_capacity`` off), and ``grad_accum`` 1: the paper step at
``grad_accum 1`` fits one H100's 80 GB with room to spare (PERF.md), so
it needs no microbatches. A value set on the command line or in the
config file wins over either default.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

PORT_DEFAULTS = {
    "triplane_bf16": False,
    "triplane_line_matmul": False,
    "fine_cull_capacity": 0.0,
    "grad_accum": 1,
}


def default_args(**overrides):
    """Programmatic Args with the port's defaults."""
    from evdeblurnerf_tpu import config as _config

    return _config.default_args(**{**PORT_DEFAULTS, **overrides})


def parse_args(argv: Optional[Sequence[str]] = None):
    """Parse CLI flags over an optional ``--config`` file, as the JAX
    package does, then apply the port's defaults to the flags neither
    sets. The flag table is read when this is called, so importing this
    module (for ``PORT_DEFAULTS``) loads nothing of the JAX package."""
    from evdeblurnerf_tpu import config as _config

    argv = list(sys.argv[1:] if argv is None else argv)
    args = _config.parse_args(argv)
    given = set(_config._parse_cli(argv))
    if getattr(args, "config", None):
        given |= set(_config.parse_config_file(args.config))
    for key, value in PORT_DEFAULTS.items():
        if key not in given:
            setattr(args, key, value)
    return args
