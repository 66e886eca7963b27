"""The precision of the card's float32 products: ``--matmul_precision``.

Counterpart of the JAX loop's ``jax_default_matmul_precision`` update
(``evdeblurnerf_tpu/train/loop.py:246-250``). :func:`set_matmul_precision`
is the one place that sets it; the entry points reach it through
``train/loop.py::resolve_device``. Each name maps onto PyTorch's
per-backend settings:

    name       cuBLAS matmul, cuDNN conv
    highest    "ieee"    exact float32 (the port's default)
    high       "tf32"    TF32 tensor cores
    default    "tf32"

The JAX flag's ``default`` means bf16 passes on the TPU. CUDA has no bf16
mode for float32 operands (``torch.backends.cuda.matmul.fp32_precision =
"bf16"`` is refused), and TF32 is what XLA takes for float32 dots at JAX's
default precision on an Ampere-or-later card.

The CPU's backend (``torch.backends.mkldnn``) is never touched, nor is the
process-wide ``torch.set_float32_matmul_precision``, which also moves
oneDNN's float32 matmuls (to bf16 for ``"medium"``): CPU runs stay exact
whatever the flag says.

cuDNN keeps an older process-wide TF32 switch beside its per-operation
settings, and PyTorch refuses to read that switch while the two disagree.
``torch.export`` reads it (``torch.backends.cudnn.set_flags``), so a
per-operation setting made alone would make every later export raise: the
switch is set first, to the same mode, then the convolutions' setting.
cuBLAS's older switch has no reader on the port's paths and is left alone
(read after a ``"tf32"`` set through the per-backend setting, it raises).
"""

from __future__ import annotations

import torch

FP32_PRECISION = {"highest": "ieee", "high": "tf32", "default": "tf32"}


def set_matmul_precision(name: str) -> str:
    """Set the card's float32 matmuls and convolutions to ``name``, one of
    :data:`FP32_PRECISION` (module docstring); returns the backend mode,
    ``"ieee"`` or ``"tf32"``."""
    if name not in FP32_PRECISION:
        raise ValueError(f"--matmul_precision {name!r}: expected one of "
                         f"{sorted(FP32_PRECISION)}")
    mode = FP32_PRECISION[name]
    torch.backends.cuda.matmul.fp32_precision = mode
    torch.backends.cudnn.allow_tf32 = mode == "tf32"
    torch.backends.cudnn.conv.fp32_precision = mode
    return mode
