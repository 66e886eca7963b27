"""Hand-written Hopper kernels: device dispatch, launch and launch counts.

Each kernel has a wrapper in the op module that owns it, with its plain
PyTorch twin beside it:

* ``ops/lane_shuffle.py``: K1 ``permute_lanes`` and its backward launch,
  K2 ``permute_lanes_3d`` forward and backward, K3 ``cdf_take``;
* ``ops/fused_sample.py``: K4 ``triplane_features`` and K5
  ``triplane_features_bwd``;
* ``ops/line_matmul.py``: K6 ``line_grad``.

The wrapper asks :func:`wants_kernel`:

* tensors on the CPU take the plain version;
* tensors on a CUDA device launch the kernel through :func:`launch`, which
  raises on a build or launch error — nothing falls back to the plain
  version;
* anything else raises.

:data:`LAUNCHES` counts the launches of each kernel, so a run can show that
its main path went through the kernels (``chip_smoke.py`` zeroes the
counts with :func:`reset_launches` before it renders and reads them after).
Counterpart of the dispatch in ``evdeblurnerf_tpu/ops/lane_shuffle.py``
(``use_pallas``/``_take_impl``), without the TPU's shard_map wrapper and
environment switches.
"""

from __future__ import annotations

import torch

from . import build

# launch counters; a backward launch counts apart from its forward, also
# where it runs the same kernel (K1 and K2 backward are the forward kernel
# launched with the inverse permutation)
KERNELS = ("permute_lanes", "permute_lanes_bwd", "permute_lanes_3d",
           "permute_lanes_3d_bwd", "cdf_take", "triplane_features",
           "triplane_features_bwd", "line_grad")
LAUNCHES = dict.fromkeys(KERNELS, 0)


def reset_launches() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


def wants_kernel(*tensors: torch.Tensor) -> bool:
    """False for CPU tensors (plain version), True for CUDA tensors (the
    kernel). Raises for tensors on several devices or on another device
    type."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError("kernel inputs lie on several devices: "
                         + ", ".join(sorted(map(str, devices))))
    (device,) = devices
    if device.type == "cpu":
        return False
    if device.type == "cuda":
        return True
    raise ValueError(f"no kernel and no plain version for device {device}")


def launch(name: str, device: torch.device, *args,
           counter: str | None = None) -> None:
    """Run ``evdn_<name>`` of the kernel library on the current stream of
    ``device`` and count the launch under ``counter`` (default ``name``).
    ``args`` are the C arguments before the trailing (device index,
    stream) pair: tensors' ``data_ptr()`` for pointers, Python ints for
    sizes. Does not synchronise."""
    lib = build.load()
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = getattr(lib, f"evdn_{name}")(*args, device.index, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} "
                           f"({lib.evdn_error_string(rc).decode()})")
    LAUNCHES[counter or name] += 1


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                 ndim: int) -> None:
    """Raise unless ``t`` has the dtype, rank and contiguity a kernel
    reads it with."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
