"""Multi-process execution: the process group, the primary process, and
each process's card.

Counterpart of ``evdeblurnerf_tpu/parallel/multihost.py``. One process
drives one card. :func:`initialize` joins the process group from the
environment: the JAX package's ``EVDN_COORDINATOR`` (``host:port``),
``EVDN_NUM_PROCESSES`` and ``EVDN_PROCESS_ID`` (``--multihost``, one
process a host), or ``torchrun``'s ``MASTER_ADDR``/``MASTER_PORT``,
``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK``. The backend is NCCL for a
run on the card and gloo for one on the CPU; a caller may name another
(gloo for two ranks that share one card, which NCCL refuses:
``tools/parallel_check_torch.py``).

Batches are replicated-deterministic, as in the JAX package: every rank
assembles the same global batch from the same seed and keeps its rows
(``mesh.shard_batch``), with no exchange of data; the gradient
``all_reduce`` is the only traffic of a step. Side effects (``args.txt``,
logs, checkpoints, PNGs) belong to the primary process, followed by a
:func:`barrier`. Without a process group every helper is the plain
one-process path.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return None if value in (None, "") else int(value)


def wants_process_group(multihost: bool = False) -> bool:
    """Whether this process is one of a group: ``--multihost`` or a
    launcher's ``WORLD_SIZE`` in the environment."""
    return bool(multihost) or _env_int("WORLD_SIZE") is not None


def backend_for(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "gloo" if torch.device(device or "cuda").type == "cpu" else "nccl"


def initialize(device="cuda", coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> None:
    """Join the process group (idempotent) before anything touches the
    card. Arguments left None come from ``EVDN_*``, else from
    ``torchrun``'s variables. Under NCCL the process's card
    (:func:`local_device`) becomes the current one first."""
    if dist.is_initialized():
        return
    coordinator = coordinator or os.environ.get("EVDN_COORDINATOR")
    if num_processes is None:
        num_processes = _env_int("EVDN_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("EVDN_PROCESS_ID")
    if coordinator is None:
        addr = os.environ.get("MASTER_ADDR", "localhost")
        port = os.environ.get("MASTER_PORT")
        if port is None:
            raise RuntimeError(
                "no process group to join: set EVDN_COORDINATOR, "
                "EVDN_NUM_PROCESSES and EVDN_PROCESS_ID, or launch with "
                "torchrun (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK)")
        coordinator = f"{addr}:{port}"
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE") or 1
    if process_id is None:
        process_id = _env_int("RANK") or 0
    backend = backend or backend_for(device)
    if backend == "nccl":
        torch.cuda.set_device(local_device(device))
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(minutes=30))
    # every rank is in: the communicator is up before the first step
    dist.barrier()


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def is_multiprocess() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def is_primary() -> bool:
    """True on the process that owns host-side side effects."""
    return not dist.is_initialized() or dist.get_rank() == 0


def local_rank() -> int:
    """This process's index on its host (``LOCAL_RANK``; 0 for the
    ``EVDN_*`` launch, one process a host)."""
    return _env_int("LOCAL_RANK") or 0


def spans_hosts() -> bool:
    """Whether the process group spans more than one host: more processes
    than ``torchrun``'s ``LOCAL_WORLD_SIZE`` (the ``EVDN_*`` launch runs
    one process a host)."""
    if not is_multiprocess():
        return False
    local = _env_int("LOCAL_WORLD_SIZE") or 1
    return dist.get_world_size() > local


def local_device(spec="cuda") -> torch.device:
    """The device of ``--device``: ``cuda`` is this process's card,
    ``cuda:<LOCAL_RANK>``; an explicit ``cuda:N`` or ``cpu`` is kept (two
    ranks may share one card)."""
    device = torch.device(spec or "cuda")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", local_rank())
    return device


def barrier() -> None:
    if is_multiprocess():
        dist.barrier()


def build_kernels(device: torch.device) -> None:
    """Build the kernel library once a host: local rank 0 runs nvcc while
    the other ranks wait, then every rank finds the finished file
    (``kernels/build.py`` publishes it atomically)."""
    if device.type != "cuda":
        return
    from ..kernels import build

    if local_rank() == 0:
        build.build()
    barrier()
