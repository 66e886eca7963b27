"""Port's tri-plane sampling (packing, plain samplers, the K4 wrapper on
the CPU) vs the JAX package on the same numpy grids and points.

The JAX fused sampler runs its Pallas kernel K4 in interpret mode on the
CPU. Tolerance: 1e-6 relative to the features' largest magnitude, the
bound the JAX package holds its own fused-vs-XLA comparison to
(ops/fused_sample.py:28-31): the packed slot factoring reorders f32 sums.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from evdeblurnerf_torch.ops import fused_sample, triplane as ttp
from evdeblurnerf_tpu.ops import fused_sample as jfs, triplane as jtp

REL = 1e-6


def _grids(rng, comps=(8, 4, 4), hwd=(17, 19, 13)):
    H, W, D = hwd
    dims = [(comps[0], H, W), (comps[1], D, H), (comps[2], D, W)]
    ldims = [(comps[0], D), (comps[1], W), (comps[2], H)]
    planes = [rng.normal(size=s).astype(np.float32) for s in dims]
    lines = [rng.normal(size=s).astype(np.float32) for s in ldims]
    return planes, lines


def _points(rng, n=777):
    """Uniform points reaching past [-1, 1], plus the edges: exactly +-1
    (the last texel of every axis) and points just outside."""
    xyz = rng.uniform(-1.3, 1.3, (n, 3)).astype(np.float32)
    edges = np.array([[1.0, 1.0, 1.0], [-1.0, -1.0, -1.0], [1.0, -1.0, 0.0],
                      [1.0 + 1e-6, 0.5, -1.0 - 1e-6], [-1.05, 1.05, 0.999],
                      [0.0, 0.0, 0.0]], np.float32)
    return np.concatenate([xyz, edges], 0)


def _close(got, want):
    scale = max(float(np.max(np.abs(want))), 1e-12)
    np.testing.assert_allclose(got, want, rtol=0, atol=REL * scale)


def test_pack_matches_jax():
    rng = np.random.default_rng(0)
    planes, lines = _grids(rng)
    for p in planes:
        np.testing.assert_array_equal(
            ttp.pack_plane(torch.from_numpy(p)).numpy(),
            np.asarray(jtp.pack_plane(jnp.asarray(p))))
    for l in lines:
        np.testing.assert_array_equal(
            ttp.pack_line(torch.from_numpy(l)).numpy(),
            np.asarray(jtp.pack_line(jnp.asarray(l))))


@pytest.mark.parametrize("seed", [1, 2])
def test_packed_sampler_matches_jax_fused_and_unpacked(seed):
    rng = np.random.default_rng(seed)
    planes, lines = _grids(rng)
    xyz = _points(rng)
    pp, pl, sizes = ttp.pack_grids([torch.from_numpy(p) for p in planes],
                                   [torch.from_numpy(l) for l in lines])
    got = ttp.triplane_features_packed(pp, pl, sizes,
                                       torch.from_numpy(xyz)).numpy()
    jp = [jnp.asarray(p) for p in planes]
    jl = [jnp.asarray(l) for l in lines]
    # K4 in Pallas interpret mode
    _close(got, np.asarray(jfs.fused_triplane_features(jp, jl,
                                                       jnp.asarray(xyz))))
    _close(got, np.asarray(jtp.triplane_features(jp, jl, jnp.asarray(xyz))))
    # the wrapper of K4 runs exactly the plain twin on CPU tensors
    np.testing.assert_array_equal(
        fused_sample.triplane_features(pp, pl, sizes,
                                       torch.from_numpy(xyz)).numpy(), got)


def test_unpacked_sampler_matches_jax_and_grid_sample():
    rng = np.random.default_rng(3)
    planes, lines = _grids(rng)
    xyz = _points(rng)
    tp_ = [torch.from_numpy(p) for p in planes]
    tl = [torch.from_numpy(l) for l in lines]
    got = ttp.triplane_features(tp_, tl, torch.from_numpy(xyz)).numpy()
    _close(got, np.asarray(jtp.triplane_features(
        [jnp.asarray(p) for p in planes], [jnp.asarray(l) for l in lines],
        jnp.asarray(xyz))))
    # the reference's own lookup (ref: voxnerf.py:132-151)
    x = torch.from_numpy(xyz)
    feats = []
    for i in range(3):
        m0, m1 = ttp.MAT_MODE[i]
        coord = torch.stack([x[:, m0], x[:, m1]], -1)[None, :, None]
        pf = F.grid_sample(tp_[i][None], coord, align_corners=True)
        lcoord = torch.stack([torch.zeros_like(x[:, 0]),
                              x[:, ttp.VEC_MODE[i]]], -1)[None, :, None]
        lf = F.grid_sample(tl[i][None, :, :, None], lcoord,
                           align_corners=True)
        feats.append((pf * lf)[0, :, :, 0].T)
    _close(got, torch.cat(feats, -1).numpy())
