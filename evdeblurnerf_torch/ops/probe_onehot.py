"""One-hot tent contraction, through kernel K9.

Counterpart of the Pallas probe ``tools/probe_onehot.py::make_kernel``
(``run``), which asked whether building a [rows, K] tent-weight one-hot
and contracting it with a resident [K, C] tile on the matrix unit beats a
row gather; its answer on the TPU retired the Morton-tiled MXU design.
:func:`onehot_lerp` computes ``out[n, :] = sum_k w[n, k] * tile[k, :]``
with ``w[n, k] = [k = idx[n]] * cast(1 - frac[n]) + [k = idx[n] + 1] *
cast(frac[n])``, the one-hot built in the tile's type (bf16 or f32) and
contracted with f32 accumulation: on CUDA tensors the hand-written kernel
of ``csrc/probe_onehot.cu`` (the one-hot built in registers, the product by
``wgmma`` on the tensor cores, the tile packed once into the swizzled
shared-memory image of :func:`plan`; f32 by three TF32 products, never
one), on CPU tensors the plain twin :func:`onehot_lerp_plain`. The TPU's
block height ``blk`` is dropped: the kernel picks its own rows a block.

Like the JAX probe it lies on no model path: it is driven by
``tools/probe_onehot_torch.py``. No gradient.
"""

from __future__ import annotations

import torch

from .. import kernels

# the widths the kernel is built for
CHANNELS = (16, 32, 64, 128)
# one-hot elements the plain version builds at a time
PLAIN_CHUNK_ELEMS = 1 << 26
# the kernel's geometry (csrc/probe_onehot.cu, Plan): blocks a cluster
# sharing each stage of the tile, bytes a swizzled row, the least bytes a
# stage
CLUSTER = 2
SWIZZLE_BYTES = 128
STAGE_TARGET = 8192
# an H100 SXM's published rates (NVIDIA's data sheet): device memory, dense
# bf16 on the tensor cores, and f32 as three TF32 products at 495 TFLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
TF32X3_FLOPS_PER_S = 495e12 / 3


def plan(K: int, C: int, bf16: bool) -> dict:
    """The kernel's geometry for a [K, C] tile, the twin of ``Plan`` in
    ``csrc/probe_onehot.cu``: ``stage_k`` tile rows a stage of the ring,
    ``stages`` stages a pass over the tile (K padded with zero rows),
    ``packed_bytes`` of the tile's shared-memory image (f32: TF32 hi and lo
    planes), ``rows`` a block a pass and ``cluster_rows`` a cluster's."""
    elem, planes = (2, 1) if bf16 else (4, 2)
    atom_bytes = C * SWIZZLE_BYTES * planes
    atoms = max(1, STAGE_TARGET // atom_bytes)
    stage_k = atoms * SWIZZLE_BYTES // elem
    stages = -(-K // stage_k)
    # consumer warpgroups of a block, m64 tiles of rows each
    groups = 3 if bf16 else 2
    tiles = {16: 4, 32: 3, 64: 2, 128: 1}[C]
    rows = groups * tiles * 64
    return dict(stage_k=stage_k, stages=stages,
                packed_bytes=stages * atoms * atom_bytes, rows=rows,
                cluster_rows=CLUSTER * rows)


def l2_tile_bytes(N: int, K: int, C: int, bf16: bool) -> int:
    """Bytes of the packed tile a call of the kernel reads from L2: one
    pass over it for each cluster's group of rows."""
    p = plan(K, C, bf16)
    return -(-N // p["cluster_rows"]) * p["packed_bytes"]


def bound(N: int, K: int, C: int, bf16: bool) -> dict:
    """The least time the card could take for a call: ``bytes`` (idx and
    frac read, the [N, C] f32 output written, the tile read once) over
    the memory rate, ``flops`` (2 N K C, the whole one-hot contracted)
    over the tensor cores' rate for the tile's type, the larger as
    ``bound_ms`` and which one as ``bound_by``."""
    nbytes = N * (8 + 4 * C) + K * C * (2 if bf16 else 4)
    flops = 2 * N * K * C
    by_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    by_ops = 1e3 * flops / (BF16_FLOPS_PER_S if bf16 else TF32X3_FLOPS_PER_S)
    return dict(bytes=nbytes, flops=flops, bound_ms=max(by_bytes, by_ops),
                bytes_ms=by_bytes, operations_ms=by_ops,
                bound_by="bytes" if by_bytes >= by_ops else "operations")


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's split of f32 ``x`` into TF32 ``hi = tf32(x)`` and ``lo =
    tf32(x - hi)``, each rounded to 10 mantissa bits, to nearest with ties
    away from zero (``cvt.rna.tf32.f32``); for finite values."""
    def rna(v):
        bits = v.contiguous().view(torch.int32)
        # add half of the dropped 13 bits' unit to the magnitude, then
        # clear them: ties round away from zero
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)

    hi = rna(x)
    return hi, rna(x - hi)


def _check(idx: torch.Tensor, frac: torch.Tensor, tile: torch.Tensor
           ) -> None:
    """Raise unless the shapes and types are ones K9 takes."""
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise TypeError(f"onehot_lerp: idx must be [N] int32, got "
                        f"{idx.dtype} {tuple(idx.shape)}")
    if frac.dtype != torch.float32 or frac.shape != idx.shape:
        raise TypeError(f"onehot_lerp: frac must be [{idx.shape[0]}] "
                        f"float32, got {frac.dtype} {tuple(frac.shape)}")
    if tile.dtype not in (torch.float32, torch.bfloat16) or tile.dim() != 2:
        raise TypeError(f"onehot_lerp: tile must be [K, C] float32 or "
                        f"bfloat16, got {tile.dtype} {tuple(tile.shape)}")
    K, C = tile.shape
    if K < 2 or C not in CHANNELS:
        raise ValueError(f"onehot_lerp: tile [{K}, {C}]; needs K >= 2 and C "
                         f"one of {CHANNELS}")


def onehot_lerp_plain(idx: torch.Tensor, frac: torch.Tensor,
                      tile: torch.Tensor) -> torch.Tensor:
    """Plain version of K9: the one-hot built as ``make_kernel`` builds it,
    ``(1.0 - f)`` and ``f`` cast to the tile's type, then ``w.float() @
    tile.float()`` (a bf16 product would round its output to bf16), over
    ``PLAIN_CHUNK_ELEMS`` one-hot elements at a time. On the card the
    product follows the matmul precision (exact at ``highest``)."""
    K, C = tile.shape
    dt = tile.dtype
    iota = torch.arange(K, device=tile.device)
    t32 = tile.float()
    out = torch.empty(idx.shape[0], C, dtype=torch.float32,
                      device=tile.device)
    step = max(1, PLAIN_CHUNK_ELEMS // K)
    for s in range(0, idx.shape[0], step):
        i = idx[s:s + step, None].long()
        f = frac[s:s + step, None]
        w = ((iota == i).to(dt) * (1.0 - f).to(dt)
             + (iota == i + 1).to(dt) * f.to(dt))
        out[s:s + step] = w.float() @ t32
    return out


def onehot_lerp(idx: torch.Tensor, frac: torch.Tensor, tile: torch.Tensor
                ) -> torch.Tensor:
    """``out [N, C] f32`` of the two-corner tent one-hot of ``idx`` [N]
    int32 (in ``[0, K - 1)``) and ``frac`` [N] f32 contracted with ``tile``
    [K, C] bf16 or f32, C one of :data:`CHANNELS`. Kernel K9 on CUDA tensors
    (counted as ``onehot_lerp`` or ``onehot_lerp_bf16`` by the tile's
    type), the plain twin on CPU tensors."""
    _check(idx, frac, tile)
    if not kernels.wants_kernel(idx, frac, tile):
        return onehot_lerp_plain(idx, frac, tile)
    kernels.check_tensor("onehot_lerp idx", idx, torch.int32, 1)
    kernels.check_tensor("onehot_lerp frac", frac, torch.float32, 1)
    kernels.check_tensor("onehot_lerp tile", tile, tile.dtype, 2)
    K, C = tile.shape
    bf16 = tile.dtype == torch.bfloat16
    packed = torch.empty(plan(K, C, bf16)["packed_bytes"], dtype=torch.uint8,
                         device=tile.device)
    out = torch.empty(idx.shape[0], C, dtype=torch.float32,
                      device=tile.device)
    kernels.launch("onehot_lerp", tile.device, idx.data_ptr(),
                   frac.data_ptr(), tile.data_ptr(), packed.data_ptr(),
                   packed.numel(), out.data_ptr(), idx.shape[0], K, C,
                   int(bf16), counter="onehot_lerp_bf16" if bf16 else None)
    return out
