"""Per-ray sample reordering and the inverse-CDF gathers.

Counterpart of ``evdeblurnerf_tpu/ops/lane_shuffle.py``. The c2f renderer
keeps per-sample tensors in UNSORTED (stratified ++ importance) order and
moves only the compositing scalars between orders:

* :func:`permute_lanes` — ``out[r, j] = x[r, perm[r, j]]`` for x [R, S]
  (kernel K1) or [R, C, S] (kernel K2), differentiable: its gradient is
  the same gather by the inverse permutation (the same kernel, counted as
  its backward launch);
* :func:`cdf_take` (kernel K3) — the four gathers of ``sample_pdf``,
  forward-only;
* :func:`sort_with_perm` — a stable sort plus the inverse permutation.

On CUDA tensors the wrappers launch the hand-written kernels of
``csrc/lane_shuffle.cu``; on CPU tensors they run the plain twins below.
K1's forward and K3 go through the custom ops ``evdn::permute_lanes`` and
``evdn::cdf_take`` (``kernels.custom_op``) under a trace, which an
exported render calls, and their implementations directly otherwise.
"""

from __future__ import annotations

import torch

from .. import kernels


def permute_lanes_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of K1 and K2: ``torch.gather`` along the last axis,
    the index shared by every channel of a 3-D ``x``."""
    idx = idx.long()
    if x.dim() == 3:
        idx = idx[:, None, :].expand(x.shape[0], x.shape[1], idx.shape[1])
    return torch.gather(x, -1, idx)


def _take(x: torch.Tensor, idx: torch.Tensor, backward: bool) -> torch.Tensor:
    """One gather ``x[..., idx]``: K1 (2-D) or K2 (3-D) on CUDA tensors,
    counted as a backward launch when ``backward``; the plain version on
    CPU tensors. K1's forward goes through ``evdn::permute_lanes``."""
    if x.dim() == 2 and not backward and not (
            torch.is_grad_enabled() and x.requires_grad):
        return _K1_OP(x, idx)
    if not kernels.wants_kernel(x, idx):
        return permute_lanes_plain(x, idx)
    return _launch_take(x, idx, backward)


def _launch_take(x, idx, backward):
    ndim = x.dim()
    if ndim not in (2, 3):
        raise ValueError(f"permute_lanes: x must be [R, S] or [R, C, S], got "
                         f"{tuple(x.shape)}")
    x = x.contiguous()
    kernels.check_tensor("permute_lanes x", x, torch.float32, ndim)
    kernels.check_tensor("permute_lanes perm", idx, torch.int32, 2)
    if idx.shape[0] != x.shape[0]:
        raise ValueError(f"permute_lanes: {x.shape[0]} rows of x, "
                         f"{idx.shape[0]} rows of indices")
    out = torch.empty((*x.shape[:-1], idx.shape[1]), dtype=x.dtype,
                      device=x.device)
    if ndim == 2:
        name = "permute_lanes"
        sizes = (x.shape[0], x.shape[1], idx.shape[1])
    else:
        name = "permute_lanes_3d"
        sizes = (x.shape[0], x.shape[1], x.shape[2], idx.shape[1])
    kernels.launch(name, x.device, x.data_ptr(), idx.data_ptr(),
                   out.data_ptr(), *sizes,
                   counter=f"{name}_bwd" if backward else name)
    return out


def _k1_impl(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    if not kernels.wants_kernel(x, idx):
        return permute_lanes_plain(x, idx)
    return _launch_take(x, idx, backward=False)


def _k1_fake(x, idx):
    return x.new_empty((x.shape[0], idx.shape[1]))


_K1_OP = kernels.custom_op("permute_lanes", _k1_impl, _k1_fake)


class _PermuteLanes(torch.autograd.Function):
    """The gather by ``perm``; its VJP is the gather by ``inv_perm``
    (``evdeblurnerf_tpu/ops/lane_shuffle.py:219-240``)."""

    @staticmethod
    def forward(ctx, x, perm, inv_perm):
        ctx.save_for_backward(inv_perm)
        return _take(x, perm, backward=False)

    @staticmethod
    def backward(ctx, g):
        (inv_perm,) = ctx.saved_tensors
        return _take(g.contiguous(), inv_perm, backward=True), None, None


def permute_lanes(x: torch.Tensor, perm: torch.Tensor,
                  inv_perm: torch.Tensor) -> torch.Tensor:
    """``out[r, ..., i] = x[r, ..., perm[r, i]]`` for x [R, S] or [R, C, S]
    f32, with perm and inv_perm [R, S] int32 a permutation and its inverse
    (``perm[r, inv_perm[r, i]] == i``); the gradient is the gather by
    ``inv_perm``.

    Kernel K1 (2-D) or K2 (3-D) on CUDA tensors, forward and backward;
    :func:`permute_lanes_plain` on CPU tensors.
    """
    if not torch.is_grad_enabled() or not x.requires_grad:
        return _take(x, perm, backward=False)
    return _PermuteLanes.apply(x, perm, inv_perm)


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
    result. Kernel K3 on CUDA tensors (raises if asked for a gradient),
    :func:`cdf_take_plain` on CPU ones.
    """
    on_card = kernels.wants_kernel(cdf, bins, below, above)
    if torch.is_grad_enabled() and (cdf.requires_grad or bins.requires_grad):
        if not on_card:
            return cdf_take_plain(cdf, bins, below, above)
        raise NotImplementedError(
            "cdf_take: K3 is forward-only; pass detached cdf and bins, as "
            "sample_pdf does")
    return _K3_OP(cdf, bins, below, above)


def _k3_impl(cdf: torch.Tensor, bins: torch.Tensor, below: torch.Tensor,
             above: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                        torch.Tensor]:
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


def _k3_fake(cdf, bins, below, above):
    return tuple(cdf.new_empty(below.shape) for _ in range(4))


_K3_OP = kernels.custom_op("cdf_take", _k3_impl, _k3_fake)
