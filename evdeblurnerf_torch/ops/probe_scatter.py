"""Row placement at dynamic offsets, through kernel K8.

Counterpart of the Pallas probe ``tools/probe_scatter.py::_dma_kernel``
(``pallas_row_dma``), which measured the floor of placing rows at arbitrary
offsets by run length. :func:`place_rows` places the ``N / G`` runs of
``G`` contiguous rows of ``rows`` [N, W] at the G-aligned row offsets
``offsets`` [N / G] of a new [K, W] output: on CUDA tensors the
hand-written kernel of ``csrc/probe_scatter.cu``, on CPU tensors the plain
twin :func:`place_rows_plain`.

The TPU's constraints are not carried over (4096 rows a grid step, the
offsets padded per step to a 1024-aligned SMEM slice, 128 lanes): the
port takes flat offsets and needs only ``N % G == 0``, ``K % G == 0``,
offsets that are multiples of ``G`` inside ``[0, K - G]`` and ``W % 4 ==
0``. The output is allocated with ``torch.empty``, as the Pallas output is
never initialised, so rows no run targets are undefined. Where runs
collide, each destination holds one whole run aimed at it, never a mix
(:func:`runs_match` checks that rule); the kernel and the twin both leave
the run of the highest index there, as a loop over the runs in order does
(the Pallas kernel in interpret mode).

Like the JAX probe it lies on no model path: it is driven by
``tools/probe_scatter_torch.py``. No gradient.
"""

from __future__ import annotations

import torch

from .. import kernels


def _check(rows: torch.Tensor, offsets: torch.Tensor, K: int, group: int
           ) -> None:
    """Raise unless the shapes and types are ones K8 takes."""
    if rows.dtype != torch.float32 or rows.dim() != 2:
        raise TypeError(f"place_rows: rows must be [N, W] float32, got "
                        f"{rows.dtype} {tuple(rows.shape)}")
    if offsets.dtype != torch.int32 or offsets.dim() != 1:
        raise TypeError(f"place_rows: offsets must be [N / G] int32, got "
                        f"{offsets.dtype} {tuple(offsets.shape)}")
    N, W = rows.shape
    if group < 1 or N % group or K <= 0 or K % group:
        raise ValueError(f"place_rows: N = {N} and K = {K} must be positive "
                         f"multiples of the run length G = {group}")
    if offsets.shape[0] != N // group:
        raise ValueError(f"place_rows: {offsets.shape[0]} offsets for "
                         f"{N // group} runs")
    if W % 4:
        raise ValueError(f"place_rows: W = {W}; the kernel moves 16-byte "
                         "pieces and takes multiples of 4 columns")


def place_rows_plain(rows: torch.Tensor, offsets: torch.Tensor, K: int,
                     group: int) -> torch.Tensor:
    """Plain version of K8: one indexed assignment of the runs that win
    their destination (the highest index aimed at it). An assignment with
    repeated indices would leave undefined which run lands, and on the CPU
    its threads split a row, leaving a mix of runs in it."""
    W = rows.shape[1]
    dst = offsets.long() // group
    runs = torch.arange(dst.shape[0], device=dst.device)
    last = torch.full((K // group,), -1, dtype=torch.long,
                      device=dst.device).scatter_reduce_(0, dst, runs, "amax")
    keep = last[dst] == runs
    out = torch.empty(K, W, dtype=rows.dtype, device=rows.device)
    out.view(K // group, group, W)[dst[keep]] = rows.view(-1, group, W)[keep]
    return out


def place_rows(rows: torch.Tensor, offsets: torch.Tensor, K: int,
               group: int) -> torch.Tensor:
    """Place run ``r``, rows ``[r*G, (r+1)*G)`` of ``rows`` [N, W] f32, at
    rows ``[offsets[r], offsets[r] + G)`` of a new [K, W] f32 output; rows
    no run targets are undefined. Kernel K8 on CUDA tensors, the plain twin
    on CPU tensors. Raises on a wrong type or rank, on sizes that are no
    multiples of ``G`` (or ``W`` of 4), and on offsets that are no
    multiples of ``G`` or leave the output (on the card the kernel counts
    them, copies such runs nowhere, and the wrapper raises after the
    launch: one synchronisation a call)."""
    _check(rows, offsets, K, group)
    if not kernels.wants_kernel(rows, offsets):
        bad = int(((offsets % group != 0) | (offsets < 0)
                   | (offsets > K - group)).sum())
        if bad:
            raise ValueError(f"place_rows: {bad} offsets are no multiple of "
                             f"{group} or leave the {K} output rows")
        return place_rows_plain(rows, offsets, K, group)
    kernels.check_tensor("place_rows rows", rows, torch.float32, 2)
    kernels.check_tensor("place_rows offsets", offsets, torch.int32, 1)
    N, W = rows.shape
    out = torch.empty(K, W, dtype=torch.float32, device=rows.device)
    # the winning run of each destination and, last, the refused offsets
    scratch = torch.empty(K // group + 1, dtype=torch.int32,
                          device=rows.device)
    kernels.launch("place_rows", rows.device, rows.data_ptr(),
                   offsets.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                   N // group, group, K // group, W)
    bad = int(scratch[-1])
    if bad:
        raise ValueError(f"place_rows: {bad} offsets are no multiple of "
                         f"{group} or leave the {K} output rows")
    return out


# an H100 SXM's device-memory rate (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12


def bound(landing: int, runs: int, group: int, W: int) -> dict:
    """The least time the card could take for a call that places ``runs``
    runs of ``group`` rows of ``W`` floats, of which ``landing`` land: the
    landing runs read and written and every offset read, over the memory
    rate (``bytes``, ``bound_ms``)."""
    nbytes = 2 * landing * group * W * 4 + runs * 4
    return dict(bytes=nbytes, bound_ms=1e3 * nbytes / HBM_BYTES_PER_S)


def written_runs(offsets: torch.Tensor, K: int, group: int) -> torch.Tensor:
    """[K / G] bool: the destination runs some run is aimed at."""
    mask = torch.zeros(K // group, dtype=torch.bool, device=offsets.device)
    mask[offsets.long() // group] = True
    return mask


def runs_match(out: torch.Tensor, rows: torch.Tensor, offsets: torch.Tensor,
               group: int) -> torch.Tensor:
    """[K / G] bool: which destination runs of ``out`` [K, W] hold, bit for
    bit, one of the runs of ``rows`` aimed at them. The placement contract
    holds where this equals :func:`written_runs`."""
    W = rows.shape[1]
    dst = offsets.long() // group
    got = out.view(torch.int32).reshape(-1, group * W)
    src = rows.view(torch.int32).reshape(-1, group * W)
    hits = torch.zeros(got.shape[0], dtype=torch.int32, device=out.device)
    hits.index_add_(0, dst, (got[dst] == src).all(1).to(torch.int32))
    return hits > 0
