"""Per-ray sample reordering and the inverse-CDF gathers.

Counterpart of ``evdeblurnerf_tpu/ops/lane_shuffle.py``. The c2f renderer
keeps per-sample tensors in UNSORTED (stratified ++ importance) order and
moves only the compositing scalars between orders:

* :func:`permute_lanes` (kernel K1) — ``out[r, j] = x[r, idx[r, j]]``;
* :func:`cdf_take` (kernel K3) — the four gathers of ``sample_pdf``;
* :func:`sort_with_perm` — a stable sort plus the inverse permutation.

On CUDA tensors the wrappers launch the hand-written kernels of
``csrc/lane_shuffle.cu``; on CPU tensors they run the plain twins below.
Both kernels are forward-only in this package: the backward of K1 (the
same gather by the inverse permutation) comes with training.
"""

from __future__ import annotations

import torch

from .. import kernels


def permute_lanes_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of K1: ``torch.gather`` along the last axis."""
    return torch.gather(x, -1, idx.long())


def permute_lanes(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """``out[r, i] = x[r, perm[r, i]]`` for x [R, S] f32, perm [R, S2]
    int32 with entries in [0, S).

    Kernel K1 on CUDA tensors (forward only: raises if ``x`` requires
    grad; the JAX function's VJP, the same gather by the inverse
    permutation, comes with training), :func:`permute_lanes_plain` on CPU
    tensors.
    """
    if not kernels.wants_kernel(x, perm):
        return permute_lanes_plain(x, perm)
    if x.requires_grad:
        raise NotImplementedError(
            "permute_lanes: the K1 backward launch comes with training "
            "(ROADMAP queue 2, K1)")
    kernels.check_tensor("permute_lanes x", x, torch.float32, 2)
    kernels.check_tensor("permute_lanes perm", perm, torch.int32, 2)
    if perm.shape[0] != x.shape[0]:
        raise ValueError(f"permute_lanes: {x.shape[0]} rows of x, "
                         f"{perm.shape[0]} rows of indices")
    out = torch.empty(perm.shape, dtype=x.dtype, device=x.device)
    kernels.launch("permute_lanes", x.device, x.data_ptr(), perm.data_ptr(),
                   out.data_ptr(), x.shape[0], x.shape[1], perm.shape[1])
    return out


def sort_with_perm(keys: torch.Tensor):
    """Sort ``keys`` [R, S] ascending along the last axis.

    Returns (sorted, perm, inv_perm) with ``sorted[r, i] == keys[r,
    perm[r, i]]`` and ``perm[r, inv_perm[r, i]] == i``, both int32. The
    sort is stable, as ``lax.sort`` is, so tied depths (a stratified and an
    importance sample at the same z) keep their concatenation order.
    """
    sorted_keys, perm = torch.sort(keys, dim=-1, stable=True)
    iota = torch.arange(keys.shape[-1], device=keys.device).expand_as(perm)
    inv_perm = torch.empty_like(perm).scatter_(-1, perm, iota)
    return sorted_keys, perm.int(), inv_perm.int()


def cdf_take_plain(cdf, bins, below, above):
    """Plain version of K3: four ``torch.gather`` along the last axis."""
    below, above = below.long(), above.long()
    return (torch.gather(cdf, -1, below), torch.gather(cdf, -1, above),
            torch.gather(bins, -1, below), torch.gather(bins, -1, above))


def cdf_take(cdf: torch.Tensor, bins: torch.Tensor, below: torch.Tensor,
             above: torch.Tensor):
    """The four gathers of inverse-CDF sampling in one pass.

    cdf [R, M] and bins [R, Mb] f32; below/above [R, N] int32. Returns
    (cdf[below], cdf[above], bins[below], bins[above]), each [R, N].
    Forward-only, like the JAX kernel, whose caller stop-gradients the
    result. Kernel K3 on CUDA tensors, :func:`cdf_take_plain` on CPU ones.
    """
    if not kernels.wants_kernel(cdf, bins, below, above):
        return cdf_take_plain(cdf, bins, below, above)
    for name, t in (("cdf", cdf), ("bins", bins)):
        kernels.check_tensor(f"cdf_take {name}", t, torch.float32, 2)
    for name, t in (("below", below), ("above", above)):
        kernels.check_tensor(f"cdf_take {name}", t, torch.int32, 2)
    R = cdf.shape[0]
    if bins.shape[0] != R or below.shape != above.shape or below.shape[0] != R:
        raise ValueError(
            f"cdf_take: shapes cdf {tuple(cdf.shape)}, bins "
            f"{tuple(bins.shape)}, below {tuple(below.shape)}, above "
            f"{tuple(above.shape)} do not share their rows")
    outs = [torch.empty(below.shape, dtype=cdf.dtype, device=cdf.device)
            for _ in range(4)]
    kernels.launch("cdf_take", cdf.device, cdf.data_ptr(), bins.data_ptr(),
                   below.data_ptr(), above.data_ptr(),
                   *(o.data_ptr() for o in outs),
                   R, cdf.shape[1], bins.shape[1], below.shape[1])
    return tuple(outs)
