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


def _off_boundary(t):
    """A contiguous copy of ``t`` that starts 4 bytes off a 16-byte
    boundary."""
    base = torch.empty(t.numel() + 8, dtype=t.dtype)
    start = next(i for i in range(1, 8)
                 if (base.data_ptr() + 4 * i) % 16 == 4)
    out = base[start:start + t.numel()].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("comps,shift,want", [
    ((8, 4, 4), None, fused_sample.K4_FLOAT4),
    ((64, 16, 16), None, fused_sample.K4_FLOAT4),
    ((132, 4, 24), None, fused_sample.K4_FLOAT4),
    ((6, 3, 5), None, fused_sample.K4_SCALAR),
    ((8, 4, 2), None, fused_sample.K4_SCALAR),
    ((8, 4, 4), "plane", fused_sample.K4_SCALAR),
    ((8, 4, 4), "line", fused_sample.K4_SCALAR)])
def test_k4_wrapper_chooses_its_form(comps, shift, want):
    """The float4 kernel wants every component count a multiple of 4 and
    every table on a 16-byte boundary; anything else takes the scalar
    kernel."""
    rng = np.random.default_rng(5)
    planes, lines = _grids(rng, comps)
    pp, pl, _ = ttp.pack_grids([torch.from_numpy(p) for p in planes],
                               [torch.from_numpy(l) for l in lines])
    pp = [t.clone() for t in pp]
    assert all(t.data_ptr() % 16 == 0 for t in (*pp, *pl))
    if shift == "plane":
        pp[2] = _off_boundary(pp[2])
    elif shift == "line":
        pl[0] = _off_boundary(pl[0])
    assert fused_sample._k4_mode(comps, (*pp, *pl)) == want


def _bf16_off_boundary(t, nbytes):
    """A contiguous bf16 copy of ``t`` that starts ``nbytes`` past a
    16-byte boundary."""
    base = torch.empty(t.numel() + 16, dtype=torch.bfloat16)
    start = next(i for i in range(16)
                 if (base.data_ptr() + 2 * i) % 16 == nbytes)
    out = base[start:start + t.numel()].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("comps,shift,want", [
    ((64, 16, 16), None, fused_sample.K4_VEC8),
    ((8, 8, 16), None, fused_sample.K4_VEC8),
    ((8, 4, 4), None, fused_sample.K4_FLOAT4),
    ((132, 4, 24), None, fused_sample.K4_FLOAT4),
    ((6, 3, 5), None, fused_sample.K4_SCALAR),
    ((64, 16, 16), ("plane", 8), fused_sample.K4_FLOAT4),
    ((64, 16, 16), ("line", 8), fused_sample.K4_FLOAT4),
    ((64, 16, 16), ("plane", 2), fused_sample.K4_SCALAR),
    ((8, 4, 4), ("line", 4), fused_sample.K4_SCALAR)])
def test_k4_wrapper_chooses_its_bf16_form(comps, shift, want):
    """Over bf16 tables the vector kernel on eight channels a lane wants
    every component count a multiple of 8 and every table on a 16-byte
    boundary; else four channels a lane want multiples of 4 and an 8-byte
    boundary; else the scalar kernel."""
    rng = np.random.default_rng(6)
    planes, lines = _grids(rng, comps)
    pp, pl, _ = ttp.pack_grids(
        [torch.from_numpy(p).to(torch.bfloat16) for p in planes],
        [torch.from_numpy(l).to(torch.bfloat16) for l in lines])
    pp, pl = [_bf16_off_boundary(t, 0) for t in pp], \
        [_bf16_off_boundary(t, 0) for t in pl]
    if shift is not None:
        which, nbytes = shift
        if which == "plane":
            pp[1] = _bf16_off_boundary(pp[1], nbytes)
        else:
            pl[2] = _bf16_off_boundary(pl[2], nbytes)
    assert fused_sample._k4_mode(comps, (*pp, *pl)) == want


@pytest.mark.parametrize("comps", [(8, 4, 4), (6, 3, 5)])
def test_k4_twin_on_texel_boundaries_and_outside(comps):
    """K4's plain twin, through the wrapper on CPU tensors, at points
    exactly on texel boundaries of every axis and on and outside [-1, 1],
    against the JAX kernel in interpret mode; the wrapper over unpacked
    texel-major tables gives the same bits."""
    rng = np.random.default_rng(6)
    planes, lines = _grids(rng, comps)
    xyz = np.concatenate([_boundary_points(), _points(rng, 50)], 0)
    tp_ = [torch.from_numpy(p) for p in planes]
    tl = [torch.from_numpy(l) for l in lines]
    pp, pl, sizes = ttp.pack_grids(tp_, tl)
    got = fused_sample.triplane_features(pp, pl, sizes,
                                         torch.from_numpy(xyz))
    assert bool(torch.isfinite(got).all())
    _close(got.numpy(), np.asarray(jfs.fused_triplane_features(
        [jnp.asarray(p) for p in planes], [jnp.asarray(l) for l in lines],
        jnp.asarray(xyz))))
    rows, lrows, usizes = fused_sample.unpack_grids(tp_, tl)
    assert list(usizes) == list(sizes)
    assert [tuple(r.shape) for r in rows] == [
        (H * W, c) for (H, W, _), c in zip(sizes, comps)]
    assert torch.equal(fused_sample.triplane_features_unpacked(
        rows, lrows, usizes, torch.from_numpy(xyz)), got)
    # a point far outside reads zeros on every projection
    far = fused_sample.triplane_features(
        pp, pl, sizes, torch.tensor([[3.0, -3.0, 5.0]]))
    assert not far.any()


# ---------------------------------------------------------------------------
# gradients: K5 (sample_grids) and K6 (line_grad) twins, the field's tables
# ---------------------------------------------------------------------------

def _ray_points(rng, rays=40, S=32):
    """Ray-major points: the S samples of a ray cross a few texels of
    every plane, so neighbouring points repeat their texels, and the rays
    start and end outside [-1, 1]."""
    o = rng.uniform(-1.1, 1.1, (rays, 1, 3))
    d = rng.normal(size=(rays, 1, 3)) * np.array([0.05, 0.05, 1.0])
    t = np.sort(rng.uniform(0, 1, (rays, S, 1)), 1)
    return (o + d * t).reshape(-1, 3).astype(np.float32)


def _boundary_points(hwd=(17, 19, 13)):
    """Points exactly on texel boundaries of every axis (f == floor(f),
    the first and the last texel among them), on and outside [-1, 1]."""
    H, W, D = hwd
    axes = [np.arange(-1, n + 1, dtype=np.float64) / (n - 1) * 2 - 1
            for n in (W, H, D)]
    n = max(len(a) for a in axes)
    cols = [np.resize(a, n) for a in axes]
    pts = [np.stack(cols, -1), np.stack([cols[0][::-1], cols[1], cols[2]], -1),
           np.stack([cols[0], cols[1][::-1], cols[2][::-1]], -1)]
    return np.concatenate(pts, 0).astype(np.float32)


@pytest.mark.parametrize("comps,points", [
    ((8, 4, 4), "edges"), ((8, 4, 4), "rays"), ((8, 4, 4), "boundaries"),
    ((6, 3, 5), "edges"), ((6, 3, 5), "rays"), ((12, 4, 20), "boundaries")])
def test_sample_grids_vjp_matches_jax_fused_k5(comps, points):
    """The sampler's autograd.Function on CPU tensors (K4 and K5 plain
    twins) against jax.vjp of the fused sampler, whose backward runs the
    Pallas kernel K5 in interpret mode: d_planes, d_lines and d_xyz within
    1e-5 of each gradient's largest magnitude, with points past [-1, 1]
    and on the last texel of every axis, ray-ordered points that repeat
    their texels, points on texel boundaries, and component counts that
    are no multiple of 4."""
    rng = np.random.default_rng(4)
    planes, lines = _grids(rng, comps)
    xyz = {"edges": _points, "rays": _ray_points}[points](rng) \
        if points != "boundaries" else _boundary_points()
    g = rng.normal(size=(xyz.shape[0], sum(comps))).astype(np.float32)
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


def test_line_base_index_is_the_row_the_sampler_reads():
    """``line_base_index`` (the plain version of the rows K5 hands to K6)
    equals the JAX sampler's clipped base index on every axis, texel
    boundaries and points outside [-1, 1] included."""
    xyz = np.concatenate([_boundary_points(), _points(
        np.random.default_rng(9))], 0)
    sizes = [(17, 19, 13), (13, 17, 19), (13, 19, 17)]
    got = fused_sample.line_base_index(torch.from_numpy(xyz), sizes)
    for i, rows in enumerate(got):
        D = sizes[i][2]
        f = (jnp.asarray(xyz[:, ttp.VEC_MODE[i]]) + 1.0) * 0.5 * (D - 1)
        want = np.asarray(jnp.clip(jnp.floor(f), 0, D - 2).astype(jnp.int32))
        assert rows.dtype == torch.int32
        np.testing.assert_array_equal(rows.numpy(), want)


def _line_idx(rng, D, n, stream):
    idx = rng.integers(0, D, n).astype(np.int32)
    if stream == "runs":            # sorted: runs of n / D equal rows
        idx = np.sort(idx)
    elif stream == "outside":       # a third of the indices outside [0, D)
        idx[::3] = rng.choice([-1, -D, D, D + 7, 1 << 30], len(idx[::3]))
    return idx


_K6_CASES = [
    pytest.param(11, 8, 3000, "uniform", id="11-8-3000"),
    pytest.param(366, 32, 2500, "uniform", id="366-32-2500"),
    (366, 128, 5000, "runs"), (50, 16, 3000, "outside"),
    (13, 6, 2000, "uniform"),       # W no multiple of 4
    (2000, 32, 3000, "runs")]       # D x W above a 227 KB tile


def _line_grad_both(D, W, n, stream, precision):
    rng = np.random.default_rng(D)
    idx = _line_idx(rng, D, n, stream)
    g = rng.normal(size=(n, W)).astype(np.float32)
    want = np.asarray(jlm.line_grad_matmul(jnp.asarray(idx), jnp.asarray(g),
                                           D, precision=precision,
                                           interpret=True))
    got = line_matmul.line_grad(torch.from_numpy(idx), torch.from_numpy(g),
                                D, precision).numpy()
    exact = line_matmul.line_grad_plain(torch.from_numpy(idx),
                                        torch.from_numpy(g), D).numpy()
    return got, want, exact


@pytest.mark.parametrize("D,W,n,stream", _K6_CASES)
def test_line_grad_matches_pallas_k6(D, W, n, stream):
    got, want, _ = _line_grad_both(D, W, n, stream, "highest")
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * float(np.abs(want).max()))


@pytest.mark.parametrize("D,W,n,stream", _K6_CASES)
def test_line_grad_default_precision_matches_pallas_k6(D, W, n, stream):
    """``precision="default"``: both sides round g to bf16 and sum the
    rounded values in f32, so they differ by f32 summation order only,
    within the same 1e-6 of the largest sum as "highest"; and the rounding
    shows (the sums are not the exact f32 ones)."""
    got, want, exact = _line_grad_both(D, W, n, stream, "default")
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * float(np.abs(want).max()))
    assert np.abs(got - exact).max() > 1e-4 * np.abs(exact).max()


@pytest.mark.parametrize("Ds,Ws,n,stream", [
    ((13, 19, 17), (16, 8, 8), 3000, "uniform"),
    ((366, 605, 605), (128, 32, 32), 2048, "runs"),
    ((9, 2000, 5), (6, 32, 2), 1500, "outside")])
def test_line_grad_tables_match_three_pallas_k6_calls(Ds, Ws, n, stream):
    """The three-table entry (raw [C, D] line gradients) against three
    one-table calls of the port and of the JAX kernel (interpret mode),
    each followed by the VJP of ``pack_line``."""
    rng = np.random.default_rng(n)
    idx = [_line_idx(rng, D, n, stream) for D in Ds]
    g = [rng.normal(size=(n, W)).astype(np.float32) for W in Ws]
    tidx = [torch.from_numpy(i) for i in idx]
    tg = [torch.from_numpy(t) for t in g]
    got = line_matmul.line_grad_tables(tidx, tg, Ds)
    for i in range(3):
        C = Ws[i] // 2
        want = jlm.line_grad_matmul(jnp.asarray(idx[i]), jnp.asarray(g[i]),
                                    Ds[i], interpret=True)
        want = jax.vjp(jtp.pack_line, jnp.zeros((C, Ds[i])))[1](want)[0]
        ours = line_matmul.pack_line_vjp(
            line_matmul.line_grad(tidx[i], tg[i], Ds[i]))
        assert got[i].shape == (C, Ds[i])
        np.testing.assert_array_equal(got[i].numpy(), ours.numpy())
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want), rtol=0,
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
