"""The RBK kernel's pose warp and weighted sum (``rbk_warp_pose``,
``rbk_weighted_sum``), the surfaces the reference defines beside the ray
warp, against the JAX package's functions on the same inputs and against
the ray warp and a hand-written composition, as tests/test_blur.py:160-247
holds the JAX ones. Bound: 2e-5 rtol/atol (1e-5 / 1e-6 for the sum, as
there)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evdeblurnerf_torch.models.blur_rbk import RigidBlurringModel
from evdeblurnerf_torch.models.embedding import ViewEmbedding
from evdeblurnerf_tpu.models.blur_rbk import \
    RigidBlurringModel as JRigidBlurringModel

N = 5


def _models(use_origin):
    jmod = JRigidBlurringModel(view_embed_cnl=8, num_motion=2, feat_ch=0,
                               use_origin=use_origin)
    jbound = jmod.bind(jmod.init(jax.random.PRNGKey(0), jnp.zeros((N, 3, 2)),
                                 jnp.zeros((N, 8))))
    tmod = RigidBlurringModel(ViewEmbedding(4, 8), 8, num_motion=2,
                              feat_ch=0, use_origin=use_origin)
    return jbound, tmod


def _poses(rng):
    out = []
    for _ in range(N):
        q = rng.normal(size=4)
        w, x, y, z = q / np.linalg.norm(q)
        R = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
        out.append(np.concatenate([R, rng.normal(size=(3, 1))], 1))
    return np.stack(out).astype(np.float32)


@pytest.mark.parametrize("use_origin", [True, False])
def test_rbk_warp_pose_matches_jax_and_the_ray_warp(use_origin):
    """The warped poses equal the JAX package's, and the rays they cast
    are the rays ``rbk_warp`` warps directly."""
    rng = np.random.default_rng(3)
    poses = _poses(rng)
    r = rng.normal(size=(N, 6)).astype(np.float32) * 0.1
    v = rng.normal(size=(N, 6)).astype(np.float32) * 0.1
    dirs_cam = rng.normal(size=(N, 3)).astype(np.float32)
    jbound, tmod = _models(use_origin)

    t = {k: torch.from_numpy(a) for k, a in
         dict(poses=poses, r=r, v=v, dirs=dirs_cam).items()}
    got = tmod.rbk_warp_pose(t["poses"], t["r"], t["v"])
    assert got.shape == (N, tmod.num_pt, 4, 4)
    want = jbound.rbk_warp_pose(jnp.asarray(poses), jnp.asarray(r),
                                jnp.asarray(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)

    rays_o = t["poses"][:, :, 3]
    rays_d = torch.einsum("nij,nj->ni", t["poses"][:, :, :3], t["dirs"])
    warped = tmod.rbk_warp(torch.stack([rays_o, rays_d], -1), t["r"], t["v"])
    torch.testing.assert_close(warped[..., 0], got[:, :, :3, 3], rtol=2e-5,
                               atol=2e-5)
    torch.testing.assert_close(
        warped[..., 1], torch.einsum("npij,nj->npi", got[:, :, :3, :3],
                                     t["dirs"]), rtol=2e-5, atol=2e-5)


def test_rbk_weighted_sum_matches_jax_and_the_composition():
    rng = np.random.default_rng(4)
    jbound, tmod = _models(True)
    P = tmod.num_pt
    ccw = rng.dirichlet(np.ones(P), size=N).astype(np.float32)
    rgb = rng.normal(size=(N * P, 3)).astype(np.float32)
    depth = rng.normal(size=(N * P,)).astype(np.float32)
    acc = rng.normal(size=(N * P,)).astype(np.float32)
    extras = {"f": rng.normal(size=(N * P, 4, 2)).astype(np.float32)}
    got = tmod.rbk_weighted_sum(
        torch.from_numpy(rgb), torch.from_numpy(depth), torch.from_numpy(acc),
        {k: torch.from_numpy(a) for k, a in extras.items()},
        torch.from_numpy(ccw))
    want = jbound.rbk_weighted_sum(
        jnp.asarray(rgb), jnp.asarray(depth), jnp.asarray(acc),
        {k: jnp.asarray(a) for k, a in extras.items()}, jnp.asarray(ccw))
    manual = ((rgb.reshape(N, P, 3) * ccw[..., None]).sum(1),
              (depth.reshape(N, P) * ccw).sum(1),
              (acc.reshape(N, P) * ccw).sum(1),
              {"f": (extras["f"].reshape(N, P, 4, 2)
                     * ccw[..., None, None]).sum(1)})
    for g, w, m in zip(got[:3], want[:3], manual[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(g.numpy(), m, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[3]["f"].numpy(), np.asarray(want[3]["f"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[3]["f"].numpy(), manual[3]["f"],
                               rtol=1e-5, atol=1e-6)
