"""Port's lane shuffles (K1, K2 and K3 plain twins and the gradients of
permute_lanes, sort_with_perm) vs the JAX package on the same numpy
inputs.

The JAX side runs its Pallas kernels in interpret mode on the CPU, as its
own tests do. Gathers and sorts are exact, so every comparison is bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evdeblurnerf_torch import kernels
from evdeblurnerf_torch.ops import lane_shuffle as tls
from evdeblurnerf_tpu.ops import lane_shuffle as jls


@pytest.mark.parametrize("rows,S,S2", [(37, 8, 8), (1030, 128, 128),
                                       (300, 128, 64), (5, 8, 3),
                                       (3, 128, 64), (5, 10, 10)])
def test_permute_lanes_matches_pallas_k1(rows, S, S2):
    rng = np.random.default_rng(rows + S)
    x = rng.normal(size=(rows, S)).astype(np.float32)
    full = np.argsort(rng.uniform(size=(rows, S)), -1).astype(np.int32)
    inv = np.argsort(full, -1).astype(np.int32)
    idx = np.ascontiguousarray(full[:, :S2])
    want = np.asarray(jls._lane_take_2d(jnp.asarray(x), jnp.asarray(idx),
                                        interpret=True))
    got = tls.permute_lanes(torch.from_numpy(x), torch.from_numpy(idx),
                            torch.from_numpy(inv))
    np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_wrappers_launch_nothing():
    kernels.reset_launches()
    x = torch.randn(4, 8)
    _, perm, inv = tls.sort_with_perm(torch.rand(4, 8))
    tls.permute_lanes(x.requires_grad_(), perm, inv).sum().backward()
    tls.permute_lanes(torch.randn(4, 3, 8), perm, inv)
    tls.cdf_take(x.detach(), x.detach(), perm, inv)
    assert all(v == 0 for v in kernels.LAUNCHES.values())


def _cdf_inputs(rng, R, M, N):
    w = rng.uniform(0, 1, (R, M - 1)).astype(np.float32) + 1e-5
    cdf = np.cumsum(w / w.sum(-1, keepdims=True), -1, dtype=np.float32)
    cdf = np.concatenate([np.zeros((R, 1), np.float32), cdf], -1)
    bins = np.sort(rng.uniform(0, 1, (R, M)), -1).astype(np.float32)
    u = rng.uniform(0, 1, (R, N)).astype(np.float32)
    inds = (cdf[:, None, :] <= u[:, :, None]).sum(-1)
    below = np.maximum(inds - 1, 0).astype(np.int32)
    above = np.minimum(inds, M - 1).astype(np.int32)
    return cdf, bins, below, above


@pytest.mark.parametrize("R,M,N", [(300, 63, 64), (17, 5, 5)])
def test_cdf_take_matches_pallas_k3(R, M, N):
    rng = np.random.default_rng(R)
    cdf, bins, below, above = _cdf_inputs(rng, R, M, N)
    want = jls.cdf_take(*map(jnp.asarray, (cdf, bins, below, above)),
                        interpret=True)
    got = tls.cdf_take(*map(torch.from_numpy, (cdf, bins, below, above)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("ties", [False, True])
def test_sort_with_perm_matches_jax(ties):
    rng = np.random.default_rng(7)
    if ties:   # stratified and importance depths can coincide
        keys = rng.integers(0, 6, (40, 128)).astype(np.float32)
    else:
        keys = rng.uniform(0, 1, (40, 128)).astype(np.float32)
    want = [np.asarray(a) for a in jls.sort_with_perm(jnp.asarray(keys))]
    got = [a.numpy() for a in tls.sort_with_perm(torch.from_numpy(keys))]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[1].dtype == got[2].dtype == np.int32


@pytest.mark.parametrize("rows,C,S", [(20, 5, 128), (9, 3, 16)])
def test_permute_lanes_3d_and_gradient_match_pallas_k2(rows, C, S):
    """K2's plain twin against the Pallas kernel in interpret mode, and its
    gradient (the gather by the inverse permutation) against jax.vjp of
    the JAX permute_lanes: both exact."""
    rng = np.random.default_rng(rows * C)
    x = rng.normal(size=(rows, C, S)).astype(np.float32)
    g = rng.normal(size=(rows, C, S)).astype(np.float32)
    perm = np.argsort(rng.uniform(size=(rows, S)), -1).astype(np.int32)
    inv = np.argsort(perm, -1).astype(np.int32)
    want = np.asarray(jls._lane_take_3d(jnp.asarray(x), jnp.asarray(perm),
                                        interpret=True))
    _, vjp = jax.vjp(lambda v: jls.permute_lanes(v, jnp.asarray(perm),
                                                 jnp.asarray(inv)),
                     jnp.asarray(x))
    want_g = np.asarray(vjp(jnp.asarray(g))[0])
    xt = torch.from_numpy(x).requires_grad_()
    got = tls.permute_lanes(xt, torch.from_numpy(perm), torch.from_numpy(inv))
    np.testing.assert_array_equal(got.detach().numpy(), want)
    got.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(xt.grad.numpy(), want_g)


def test_permute_lanes_2d_gradient_matches_jax():
    rng = np.random.default_rng(8)
    x = rng.normal(size=(33, 128)).astype(np.float32)
    g = rng.normal(size=(33, 128)).astype(np.float32)
    perm = np.argsort(rng.uniform(size=(33, 128)), -1).astype(np.int32)
    inv = np.argsort(perm, -1).astype(np.int32)
    _, vjp = jax.vjp(lambda v: jls.permute_lanes(v, jnp.asarray(perm),
                                                 jnp.asarray(inv)),
                     jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    tls.permute_lanes(xt, torch.from_numpy(perm),
                      torch.from_numpy(inv)).backward(torch.from_numpy(g))
    np.testing.assert_array_equal(xt.grad.numpy(),
                                  np.asarray(vjp(jnp.asarray(g))[0]))
