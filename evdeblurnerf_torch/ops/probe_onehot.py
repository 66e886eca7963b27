"""One-hot tent contraction, through kernel K9.

Counterpart of the Pallas probe ``tools/probe_onehot.py::make_kernel``
(``run``), which asked whether building a [rows, K] tent-weight one-hot
and contracting it with a resident [K, C] tile on the matrix unit beats a
row gather; its answer on the TPU retired the Morton-tiled MXU design.
:func:`onehot_lerp` computes ``out[n, :] = sum_k w[n, k] * tile[k, :]``
with ``w[n, k] = [k = idx[n]] * cast(1 - frac[n]) + [k = idx[n] + 1] *
cast(frac[n])``, the one-hot built in the tile's type (bf16 or f32) and
contracted with f32 accumulation: on CUDA tensors the hand-written kernel
of ``csrc/probe_onehot.cu`` (the one-hot built in registers, the product
on the tensor cores; f32 by three TF32 products, never one), on CPU
tensors the plain twin :func:`onehot_lerp_plain`. The TPU's block height
``blk`` is dropped: the kernel picks its own rows a block.

Like the JAX probe it lies on no model path: it is driven by
``tools/probe_onehot_torch.py``. No gradient.
"""

from __future__ import annotations

import torch

from .. import kernels

# the widths the kernel is built for (C / 8 tiles of eight columns, even)
CHANNELS = (16, 32, 64, 128)
# one-hot elements the plain version builds at a time
PLAIN_CHUNK_ELEMS = 1 << 26


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
    if tile.data_ptr() % 16:
        raise ValueError("onehot_lerp: the tile must start on a 16-byte "
                         "boundary (the kernel copies 16-byte pieces)")
    K, C = tile.shape
    bf16 = tile.dtype == torch.bfloat16
    out = torch.empty(idx.shape[0], C, dtype=torch.float32,
                      device=tile.device)
    kernels.launch("onehot_lerp", tile.device, idx.data_ptr(),
                   frac.data_ptr(), tile.data_ptr(), out.data_ptr(),
                   idx.shape[0], K, C, int(bf16),
                   counter="onehot_lerp_bf16" if bf16 else None)
    return out
