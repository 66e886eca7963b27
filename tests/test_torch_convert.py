"""The weight bridge: JAX variables -> the port's reference-layout state
dict, against the JAX package's own exporter on a live JAX init."""

import jax
import numpy as np
import pytest
import torch

import oracle_common as oc
from evdeblurnerf_torch.models.renderer import RenderConfig
from evdeblurnerf_torch.models.system import EvDeblurNeRF
from evdeblurnerf_torch.utils.convert import state_dict_from_jax
from evdeblurnerf_tpu.models.renderer import Renderer
from evdeblurnerf_tpu.utils.checkpoint_convert import \
    export_network_state_dict

FIELDS = [f for f in RenderConfig.__dataclass_fields__]


@pytest.mark.parametrize("name,rgb_add_bias", [("rbk_awp", False),
                                               ("pbe", True)])
def test_state_dict_from_jax_matches_exporter(name, rgb_add_bias):
    jcfg = oc.make_cfg(oc.make_args(oc.VARIANTS[name]))
    jcfg = jcfg.__class__(**{**jcfg.__dict__, "rgb_add_bias": rgb_add_bias})
    rays = oc.make_inputs()[0]
    renderer_vars = Renderer(jcfg).init(jax.random.PRNGKey(1),
                                        jax.random.PRNGKey(2), rays,
                                        is_train=False)
    variables = {"params": {"renderer": renderer_vars["params"]}}
    want = export_network_state_dict(variables)
    got = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, variables))
    assert set(got) == {k for k in want if k.startswith("mlp_")}
    for k, v in got.items():
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    assert any(k.endswith(".bias") for k in got) == rgb_add_bias

    model = EvDeblurNeRF(RenderConfig(**{f: getattr(jcfg, f)
                                         for f in FIELDS}))
    model.load_state_dict(got, strict=True)
    # the packed tables follow the loaded grids
    plane = got["mlp_fine.app_plane.0"][0]
    C = plane.shape[0]
    torch.testing.assert_close(model.mlp_fine.packed_plane_0[:, :C],
                               plane.reshape(C, -1).T)


def test_state_dict_from_jax_rejects_unknown_leaves():
    variables = {"params": {"renderer": {
        "mlp_coarse": {"app_plane_0": np.zeros((2, 3, 3), np.float32),
                       "mystery": np.zeros(3, np.float32)},
        "mlp_fine": {}}}}
    with pytest.raises(ValueError, match="mystery"):
        state_dict_from_jax(variables)
