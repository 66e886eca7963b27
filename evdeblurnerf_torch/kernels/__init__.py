"""Hand-written Hopper kernels: device dispatch, launch and launch counts.

Each kernel has a wrapper in the op module that owns it, with its plain
PyTorch twin beside it:

* ``ops/lane_shuffle.py``: K1 ``permute_lanes`` and its backward launch,
  K2 ``permute_lanes_3d`` forward and backward, K3 ``cdf_take``;
* ``ops/fused_sample.py``: K4 ``triplane_features`` (two kernels, chosen
  by shape and alignment, each over f32 tables, bf16 tables, or bf16
  tables under the bf16 eval chain) and K5 ``triplane_features_bwd``
  (three kernels, chosen by shape, each over f32 or bf16 tables);
* ``ops/line_matmul.py``: K6 ``line_grad`` (precision "highest" or
  "default") and ``line_grad_tables`` (three tables in one launch, counted
  as one ``line_grad``);
* ``ops/tiled_gather.py``: K7 ``tiled_plane_gather``.

The wrapper asks :func:`wants_kernel`:

* tensors on the CPU take the plain version;
* tensors on a CUDA device launch the kernel through :func:`launch`, which
  raises on a build or launch error — nothing falls back to the plain
  version;
* anything else raises.

:data:`LAUNCHES` counts the launches of each kernel, so a run can show that
its main path went through the kernels (``chip_smoke.py`` zeroes the
counts with :func:`reset_launches` before it renders and reads them after).
A replayed CUDA graph runs no Python: the captured training step
(``train/capture.py``) takes the counts its capture added as the graph's
own (:func:`take_launches`, a capture launches nothing) and adds them at
each replay (:func:`add_launches`).
The render path's kernels (K1's forward, K3, K4 in its three table
types) are also custom ops of the dispatcher, ``evdn::<name>``
(:func:`custom_op`): each launches its kernel or runs its plain twin as
:func:`wants_kernel` says, and a fake implementation gives shapes, so
``torch.export`` traces a render into a program that calls them
(``serving.export_renderer``); loading such a program needs the op
modules imported, nothing else of the package. Outside a trace the
wrappers call the same implementation directly, without the dispatcher.

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
           "triplane_features_bwd", "line_grad", "tiled_plane_gather",
           "triplane_features_bf16", "triplane_features_bf16_compute",
           "triplane_features_bwd_bf16")
# what one training step launches over f32 tables. K6 runs only behind a
# K5 whose line tables pass a block's shared memory (the paper's fit, so K5
# sums them itself); K7 lies on no model path and runs from its own entry
# point, tools/bench_tiled_gather_torch.py
TRAIN_KERNELS = KERNELS[:7]
# what one training step launches over bf16 tables (--triplane_bf16)
BF16_TRAIN_KERNELS = KERNELS[:5] + ("triplane_features_bf16",
                                    "triplane_features_bwd_bf16")
LAUNCHES = dict.fromkeys(KERNELS, 0)


def reset_launches() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


def take_launches(before: dict) -> dict:
    """The counts added since ``before`` (a copy of :data:`LAUNCHES`),
    taken back out of :data:`LAUNCHES`: a capture's launches, which ran
    nothing."""
    delta = {k: LAUNCHES[k] - before[k] for k in KERNELS
             if LAUNCHES[k] != before[k]}
    LAUNCHES.update(before)
    return delta


def add_launches(delta: dict) -> None:
    """Count one replay of a graph whose capture took ``delta``."""
    for name, n in delta.items():
        LAUNCHES[name] += n


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
    fn = build.ENTRY.get(name)
    if fn is None:      # the first launch of this process builds and loads
        build.load()
        fn = build.ENTRY[name]
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = fn(*args, device.index, stream)
    if rc != 0:
        raise RuntimeError(
            f"{name}: CUDA error {rc} "
            f"({build.load().evdn_error_string(rc).decode()})")
    LAUNCHES[counter or name] += 1


def custom_op(name: str, impl, fake):
    """Register the dispatcher op ``evdn::<name>``. ``impl``, whose type
    annotations give the schema, serves every device and chooses as every
    wrapper does: the kernel where :func:`wants_kernel` says so, else the
    plain version; ``fake`` gives the outputs' shapes under tracing.

    Returns a function of the op's arguments that calls the op while
    ``torch.export`` (or ``torch.compile``) traces, so the traced program
    holds it, and ``impl`` itself otherwise: the dispatcher's round trip
    costs the host tens of microseconds a call, which an eager step or
    render need not pay. Inputs are not mutated; outputs are new
    tensors."""
    op = torch.library.custom_op(f"evdn::{name}", impl, mutates_args=())
    op.register_fake(fake)

    def call(*args):
        if torch.compiler.is_compiling():
            return op(*args)
        return impl(*args)

    return call


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
