"""The weight bridge: JAX variables -> the port's reference-layout state
dict, against the JAX package's own exporter on a live JAX init."""

import re

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


@pytest.mark.parametrize("name", ["dsk", "pbe"])
def test_dsk_and_pbe_trees_load_strictly(name):
    """A whole DSK or PBE flax tree (fields, ``kernelnet``, ``view_embed``)
    maps to what the JAX package's exporter writes and loads into the
    port's model with ``strict=True``, every parameter of the port
    covered."""
    import dataclasses

    from evdeblurnerf_torch.models.system import kernel_config_from_args

    # the recorded tree of the oracle variant: no live init needed
    data = np.load(oc.oracle_path(name))
    variables = {}
    for k in data.files:
        if k.startswith("var/"):
            *path, leaf = re.findall(r"\['([^']+)'\]", k[len("var/"):])
            node = variables
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = data[k]
    want = export_network_state_dict(variables)
    got = state_dict_from_jax(variables)
    assert set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    assert {"kernelsnet.pattern_pos", "kernelsnet.img_embed.img_embed",
            "kernelsnet.linears.4.weight",
            "kernelsnet.linears1.2.bias"} <= set(got)
    args = oc.make_args(oc.VARIANTS[name])
    jcfg = oc.make_cfg(args)
    model = EvDeblurNeRF(
        RenderConfig(**{f.name: getattr(jcfg, f.name)
                        for f in dataclasses.fields(RenderConfig)}),
        kernel_config_from_args(args), oc.NUM_IMAGES, K=oc.K)
    model.load_state_dict(got, strict=True)
    assert set(got) == {n for n, _ in model.named_parameters()}
    # Flax Dense [in, out] against torch Linear [out, in]
    kernel = variables["params"]["kernelnet"]["linears_0"]["kernel"]
    assert tuple(model.kernelsnet.linears[0].weight.shape) == kernel.shape[::-1]
    torch.testing.assert_close(model.kernelsnet.linears[0].weight,
                               torch.from_numpy(kernel.T.copy()))


def test_pattern_trans_maps_to_its_reference_name():
    leaf = np.arange(12, dtype=np.float32).reshape(1, 6, 2)
    sd = state_dict_from_jax({"params": {"kernelnet": {
        "pattern_pos": leaf, "pattern_trans": leaf + 1}}})
    assert set(sd) == {"kernelsnet.pattern_pos", "kernelsnet.pattern_trans"}
    np.testing.assert_array_equal(sd["kernelsnet.pattern_trans"].numpy(),
                                  leaf + 1)


def test_state_dict_from_jax_rejects_unknown_leaves():
    variables = {"params": {"renderer": {
        "mlp_coarse": {"app_plane_0": np.zeros((2, 3, 3), np.float32),
                       "mystery": np.zeros(3, np.float32)},
        "mlp_fine": {}}}}
    with pytest.raises(ValueError, match="mystery"):
        state_dict_from_jax(variables)
