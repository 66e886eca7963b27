"""Port's tri-plane sampling (packing, plain samplers, the K4/K5/K6 wrappers
on the CPU, the field's tables and gradients) vs the JAX package on the
same numpy grids and points.

The JAX fused sampler runs its Pallas kernel K4 in interpret mode on the
CPU. Tolerance: 1e-6 relative to the features' largest magnitude, the
bound the JAX package holds its own fused-vs-XLA comparison to
(ops/fused_sample.py:28-31): the packed slot factoring reorders f32 sums.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from evdeblurnerf_torch.models.voxnerf import VoxelNeRF
from evdeblurnerf_torch.ops import fused_sample, line_matmul, triplane as ttp
from evdeblurnerf_torch.utils.convert import state_dict_from_jax
from evdeblurnerf_tpu.models.voxnerf import VoxelNeRF as JVoxelNeRF
from evdeblurnerf_tpu.ops import fused_sample as jfs, triplane as jtp
from evdeblurnerf_tpu.ops import line_matmul as jlm

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


# ---------------------------------------------------------------------------
# gradients: K5 (sample_grids) and K6 (line_grad) twins, the field's tables
# ---------------------------------------------------------------------------

def test_sample_grids_vjp_matches_jax_fused_k5():
    """The sampler's autograd.Function on CPU tensors (K4 and K5 plain
    twins) against jax.vjp of the fused sampler, whose backward runs the
    Pallas kernel K5 in interpret mode: d_planes, d_lines and d_xyz within
    1e-5 of each gradient's largest magnitude, with points past [-1, 1]
    and on the last texel of every axis."""
    rng = np.random.default_rng(4)
    planes, lines = _grids(rng)
    xyz = _points(rng)
    g = rng.normal(size=(xyz.shape[0], 16)).astype(np.float32)
    out, vjp = jax.vjp(jfs.fused_triplane_features,
                       [jnp.asarray(p) for p in planes],
                       [jnp.asarray(l) for l in lines], jnp.asarray(xyz))
    want = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(t).requires_grad_()
              for t in (*planes, *lines, xyz)]
    with torch.no_grad():
        packed = ttp.pack_grids(leaves[:3], leaves[3:6])
    got = fused_sample.sample_grids(leaves[:3], leaves[3:6], packed,
                                    leaves[6])
    _close(got.detach().numpy(), np.asarray(out))
    got.backward(torch.from_numpy(g))
    for t, w in zip(leaves, [*want[0], *want[1], want[2]]):
        scale = max(float(np.max(np.abs(w))), 1e-12)
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5 * scale)


@pytest.mark.parametrize("D,W,n", [(11, 8, 3000), (366, 32, 2500)])
def test_line_grad_matches_pallas_k6(D, W, n):
    rng = np.random.default_rng(D)
    idx = rng.integers(0, D, n).astype(np.int32)
    g = rng.normal(size=(n, W)).astype(np.float32)
    want = np.asarray(jlm.line_grad_matmul(jnp.asarray(idx), jnp.asarray(g),
                                           D, interpret=True))
    got = line_matmul.line_grad(torch.from_numpy(idx), torch.from_numpy(g),
                                D).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * float(np.abs(want).max()))


def _field(seed=0):
    return VoxelNeRF(((-1.6, -1.6, -1.0), (1.6, 1.6, 1.0)), n_voxels=4096,
                     app_n_comp=(4, 2, 2), app_dim=8,
                     generator=torch.Generator().manual_seed(seed))


def test_sample_follows_inplace_grid_updates():
    """The packed tables never lag the grids: after an in-place update
    sample() equals a freshly built field with the same weights."""
    m = _field()
    pts = torch.from_numpy(_points(np.random.default_rng(5), 300) * 1.5)
    before = m.sample(pts)
    with torch.no_grad():
        m.app_plane[0].mul_(3)
        m.app_line[2].add_(0.5)
    after = m.sample(pts)
    assert not torch.equal(before, after)
    fresh = _field(seed=1)
    fresh.load_state_dict(m.state_dict())
    assert torch.equal(after, fresh.sample(pts))


def test_sample_gradients_match_jax_voxelnerf():
    """sample(pts).sum().backward() reaches every grid, the basis and the
    points, equal to jax.grad of the JAX VoxelNeRF.sample at the same
    weights (rtol/atol 1e-5)."""
    aabb = ((-1.6, -1.6, -1.0), (1.6, 1.6, 1.0))
    jm = JVoxelNeRF(aabb=aabb, n_voxels=4096, app_n_comp=(4, 2, 2),
                    app_dim=8)
    pts = (_points(np.random.default_rng(6), 300) * 1.5).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(pts),
                     method=JVoxelNeRF.sample)["params"]

    def jsum(p, x):
        return jnp.sum(jm.apply({"params": p}, x, method=JVoxelNeRF.sample))

    jg_p, jg_x = jax.grad(jsum, argnums=(0, 1))(params, jnp.asarray(pts))
    m = _field()
    sd = state_dict_from_jax({"params": {"mlp_coarse": params}})
    m.load_state_dict({k[len("mlp_coarse."):]: v for k, v in sd.items()},
                      strict=False)
    x = torch.from_numpy(pts).requires_grad_()
    m.sample(x).sum().backward()
    jg = state_dict_from_jax({"params": {"mlp_coarse": jg_p}})
    named = dict(m.named_parameters())
    assert len(jg) == 7
    for k, want in jg.items():
        np.testing.assert_allclose(
            named[k[len("mlp_coarse."):]].grad.numpy(), want.numpy(),
            rtol=1e-5, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg_x), rtol=1e-5,
                               atol=1e-5)
