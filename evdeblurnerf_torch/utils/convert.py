"""The weight bridge: JAX package variables -> the port's state dicts.

:func:`state_dict_from_jax` maps the JAX package's model variables (a
nested dict of numpy arrays, ``{'params': {...}, 'batch_stats': {...}}``)
to the reference-layout ``network_state_dict`` the port loads strictly,
and :func:`crf_state_dict_from_jax` the CRF parameters to the reference's
``crf_state_dict``. They mirror
``evdeblurnerf_tpu/utils/checkpoint_convert.py::export_network_state_dict``
(``:259``) and ``export_crf_state_dict`` (``:417``) without importing jax:
Dense kernels [in, out] become Linear weights [out, in] (1x1 convolutions
gain their trailing unit axes), planes gain a leading batch axis
([1, C, H, W]) and lines a batch and a width axis ([1, C, D, 1]), the MAM
BatchNorm's statistics become ``running_mean``/``running_var``, and the
reference's never-run ``awpnet.MAM.conv`` and the BatchNorm step counters
are synthesised so strict loading succeeds.
:func:`train_checkpoint_from_jax` puts both into the dictionary that
``train/checkpoint.py`` resumes from, so a JAX train state's weights start
a run of the port. :func:`variables_from_state_dict` maps back: a port (or
reference) ``network_state_dict`` to the JAX package's nested parameter
tree, as numpy. :func:`normalize_legacy_network_state_dict` reads the
two-network checkpoints of the DP-NeRF era (NeRF-mode fields).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_FIELD = re.compile(r"^params/renderer/mlp_(coarse|fine)/(.+)$")
_GRID = re.compile(r"^app_(plane|line)_(\d)$")
_LAYER = re.compile(r"^(\w+?)(?:_(\d+))?/(kernel|bias)$")


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _wb(kb: str) -> str:
    return "weight" if kb == "kernel" else "bias"


def _linear(kb: str, v: np.ndarray) -> np.ndarray:
    return v.T if kb == "kernel" else v


def _map_leaf(key: str, v: np.ndarray, ve: str):
    """(state-dict name, tensor) of one flattened JAX leaf, or None."""
    m = _FIELD.match(key)
    if m:
        stage, rest = m.groups()
        g = _GRID.match(rest)
        if g:
            kind, i = g.groups()
            return (f"mlp_{stage}.app_{kind}.{i}",
                    v[None] if kind == "plane" else v[None, :, :, None])
        m = _LAYER.match(rest)
        if m:
            mod, i, kb = m.groups()
            if mod in ("pts_linear", "views_linear"):
                mod += "s"
            name = f"mlp_{stage}.{mod}" + (f".{i}" if i is not None else "")
            return f"{name}.{_wb(kb)}", _linear(kb, v)
        return None
    if key in ("params/view_embed/img_embed",
               "params/view_embed/table/img_embed"):
        return f"kernelsnet.{ve}.img_embed", v
    m = re.match(r"^params/view_embed/linear_(\d+)/(kernel|bias)$", key)
    if m:
        i, kb = m.groups()
        return (f"kernelsnet.{ve}.view_embed_linears.{i}.{_wb(kb)}",
                _linear(kb, v))
    m = re.match(r"^params/kernelnet/([rvw])_(?:branch_(\d+)|linear)/"
                 r"(kernel|bias)$", key)
    if m:
        b, i, kb = m.groups()
        name = (f"kernelsnet.{b}_branch.{i}" if i is not None
                else f"kernelsnet.{b}_linear")
        return f"{name}.{_wb(kb)}", _linear(kb, v)
    m = re.match(r"^params/kernelnet/(pattern_pos|pattern_trans)$", key)
    if m:
        return f"kernelsnet.{m.group(1)}", v
    m = re.match(r"^params/kernelnet/(linears1?)_(\d+)/(kernel|bias)$", key)
    if m:
        # torch Sequential interleaves ReLUs: dense rank j -> index 2j
        seq, j, kb = m.groups()
        return f"kernelsnet.{seq}.{2 * int(j)}.{_wb(kb)}", _linear(kb, v)
    m = re.match(r"^params/awpnet/(sample|motion)_feature_embed_(\d+)/"
                 r"(kernel|bias)$", key)
    if m:
        kind, i, kb = m.groups()
        return (f"awpnet.{kind}_feature_embed_layer.{i}.{_wb(kb)}",
                _linear(kb, v))
    m = re.match(r"^params/awpnet/(w_linear|MAM/linear)/(kernel|bias)$", key)
    if m:
        mod, kb = m.groups()
        return f"awpnet.{mod.replace('/', '.')}.{_wb(kb)}", _linear(kb, v)
    m = re.match(r"^params/awpnet/MAM/Corr/(conva|convb|convc|convn|convl)/"
                 r"kernel$", key)
    if m:
        return f"awpnet.MAM.Corr.{m.group(1)}.weight", v.T[..., None]
    if key == "params/awpnet/MAM/Corr/convd/kernel":
        return "awpnet.MAM.Corr.convd.0.weight", v.T[..., None]
    m = re.match(r"^params/awpnet/MAM/Corr/convd_bn/(scale|bias)$", key)
    if m:
        return (f"awpnet.MAM.Corr.convd.1."
                f"{'weight' if m.group(1) == 'scale' else 'bias'}", v)
    m = re.match(r"^batch_stats/awpnet/MAM/Corr/convd_bn/(mean|var)$", key)
    if m:
        return f"awpnet.MAM.Corr.convd.1.running_{m.group(1)}", v
    if key == "params/awpnet/MAM/Corr/line_conv_att/kernel":
        return "awpnet.MAM.Corr.line_conv_att.weight", v.T[..., None, None]
    return None


def state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The reference ``network_state_dict`` (f32 CPU tensors) of the JAX
    model variables: fields, blur kernel and view embedding, AWP/MAM with
    the BatchNorm statistics. Accepts the whole model's variables, the
    renderer's own ``{'params': {'mlp_coarse': ..., ...}}``, or either
    without ``batch_stats``; raises on a leaf it cannot place."""
    params = variables["params"]
    if "mlp_coarse" in params or "mlp_fine" in params:
        params = {"renderer": params}
    flat = _flatten({"params": params,
                     "batch_stats": variables.get("batch_stats", {})})
    is_rbk = any(k.startswith(("params/kernelnet/r_branch_",
                               "params/kernelnet/r_linear")) for k in flat)
    ve = "view_embed_module" if is_rbk else "img_embed"
    sd: Dict[str, np.ndarray] = {}
    unmapped = []
    for key, v in flat.items():
        hit = _map_leaf(key, v, ve)
        if hit is None:
            unmapped.append(key)
        else:
            sd[hit[0]] = hit[1]
    if unmapped:
        raise ValueError(f"cannot map model leaves: {sorted(unmapped)}")
    if "awpnet.w_linear.weight" in sd:
        c = sd["awpnet.w_linear.weight"].shape[1]            # W_mot
        sd.update({
            "awpnet.MAM.Corr.convd.1.num_batches_tracked": np.asarray(0),
            "awpnet.MAM.conv.0.weight": np.zeros((c, 2 * c, 1, 1)),
            "awpnet.MAM.conv.1.weight": np.ones(c),
            "awpnet.MAM.conv.1.bias": np.zeros(c),
            "awpnet.MAM.conv.1.running_mean": np.zeros(c),
            "awpnet.MAM.conv.1.running_var": np.ones(c),
            "awpnet.MAM.conv.1.num_batches_tracked": np.asarray(0)})
    return {k: torch.from_numpy(np.array(
        v, np.int64 if k.endswith("num_batches_tracked") else np.float32))
        for k, v in sd.items()}


def crf_state_dict_from_jax(crf_params: Mapping) -> Dict[str, torch.Tensor]:
    """The reference ``crf_state_dict`` of the JAX CRF parameters
    (``{'tonemapping_rgb': ..., 'tonemapping_event': ...}``, learned heads
    only): ``linear_j`` is the Sequential's ``linear.{2j}`` (ReLUs sit at
    the odd slots)."""
    sd = {}
    unmapped = []
    for key, v in _flatten(crf_params).items():
        m = re.match(r"^tonemapping_(rgb|event)/linear_(\d+)/(kernel|bias)$",
                     key)
        if not m:
            unmapped.append(key)
            continue
        head, j, kb = m.groups()
        sd[f"tonemapping_{head}.linear.{2 * int(j)}.{_wb(kb)}"] = \
            torch.from_numpy(np.array(_linear(kb, v), np.float32))
    if unmapped:
        raise ValueError(f"cannot map CRF leaves: {sorted(unmapped)}")
    return sd


def _unmap_key(name: str, v: np.ndarray):
    """(JAX leaf path as a tuple, array) of one state-dict entry, or None
    for the entries strict loading needs but the JAX tree does not hold
    (``awpnet.MAM.conv.*``, BatchNorm step counters): the inverse of
    :func:`_map_leaf`."""
    if name.startswith("awpnet.MAM.conv.") or name.endswith(
            "num_batches_tracked"):
        return None

    def kb(wb):
        return "kernel" if wb == "weight" else "bias"

    def lin(wb, v):
        return v.T if wb == "weight" else v

    m = re.match(r"^mlp_(coarse|fine)\.app_(plane|line)\.(\d)$", name)
    if m:
        stage, kind, i = m.groups()
        return (("params", "renderer", f"mlp_{stage}", f"app_{kind}_{i}"),
                v[0] if kind == "plane" else v[0, :, :, 0])
    m = re.match(r"^mlp_(coarse|fine)\.(\w+?)(?:s?\.(\d+))?\.(weight|bias)$",
                 name)
    if m:
        stage, mod, i, wb = m.groups()
        leaf = mod if i is None else f"{mod}_{i}"
        return (("params", "renderer", f"mlp_{stage}", leaf, kb(wb)),
                lin(wb, v))
    m = re.match(r"^kernelsnet\.(?:view_embed_module|img_embed)\."
                 r"(img_embed|view_embed_linears\.(\d+)\.(weight|bias))$",
                 name)
    if m:
        if m.group(2) is None:
            return ("params", "view_embed", "img_embed"), v
        return (("params", "view_embed", f"linear_{m.group(2)}",
                 kb(m.group(3))), lin(m.group(3), v))
    m = re.match(r"^kernelsnet\.([rvw])_(?:branch\.(\d+)|linear)\."
                 r"(weight|bias)$", name)
    if m:
        b, i, wb = m.groups()
        leaf = f"{b}_branch_{i}" if i is not None else f"{b}_linear"
        return ("params", "kernelnet", leaf, kb(wb)), lin(wb, v)
    m = re.match(r"^kernelsnet\.(pattern_pos|pattern_trans)$", name)
    if m:
        return ("params", "kernelnet", m.group(1)), v
    m = re.match(r"^kernelsnet\.(linears1?)\.(\d+)\.(weight|bias)$", name)
    if m:
        seq, j, wb = m.groups()
        return (("params", "kernelnet", f"{seq}_{int(j) // 2}", kb(wb)),
                lin(wb, v))
    m = re.match(r"^awpnet\.(sample|motion)_feature_embed_layer\.(\d+)\."
                 r"(weight|bias)$", name)
    if m:
        kind, i, wb = m.groups()
        return (("params", "awpnet", f"{kind}_feature_embed_{i}", kb(wb)),
                lin(wb, v))
    m = re.match(r"^awpnet\.(w_linear|MAM\.linear)\.(weight|bias)$", name)
    if m:
        mod, wb = m.groups()
        return ("params", "awpnet", *mod.split("."), kb(wb)), lin(wb, v)
    m = re.match(r"^awpnet\.MAM\.Corr\.(conva|convb|convc|convn|convl|"
                 r"convd\.0|line_conv_att)\.weight$", name)
    if m:
        conv = "convd" if m.group(1) == "convd.0" else m.group(1)
        return (("params", "awpnet", "MAM", "Corr", conv, "kernel"),
                v.reshape(v.shape[0], v.shape[1]).T)
    m = re.match(r"^awpnet\.MAM\.Corr\.convd\.1\.(weight|bias|running_mean|"
                 r"running_var)$", name)
    if m:
        leaf = {"weight": "scale", "bias": "bias", "running_mean": "mean",
                "running_var": "var"}[m.group(1)]
        col = "batch_stats" if leaf in ("mean", "var") else "params"
        return (col, "awpnet", "MAM", "Corr", "convd_bn", leaf), v
    raise ValueError(f"cannot map state-dict entry {name!r}")


def variables_from_state_dict(sd: Mapping[str, torch.Tensor]) -> Dict:
    """The JAX package's model variables (``{'params': ..., 'batch_stats':
    ...}``, nested dicts of numpy arrays) of a reference-layout
    ``network_state_dict``: c2f or NeRF fields, blur kernel, view embedding
    and AWP. ``state_dict_from_jax`` of the result gives ``sd`` back."""
    out: Dict = {"params": {}}
    for name, t in sd.items():
        hit = _unmap_key(name, t.detach().cpu().numpy())
        if hit is None:
            continue
        path, v = hit
        node = out
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = np.ascontiguousarray(v, np.float32)
    return out


def normalize_legacy_network_state_dict(ckpt: Mapping):
    """The ``network_state_dict`` of a legacy two-network checkpoint (the
    deblur-nerf / DP-NeRF era: ``network_fn_state_dict`` for the coarse
    MLP and ``network_fine_state_dict`` for the fine one, keys possibly
    behind DataParallel's ``module.``), as the reference's
    ``smart_load_state_dict`` means it (ref: utils/misc.py:196-214, whose
    ``lstrip("module.")`` strips a character set where the prefix is
    meant; the prefix is stripped here). None when ``ckpt`` is not such a
    checkpoint. The counterpart of
    ``evdeblurnerf_tpu/utils/checkpoint_convert.py``'s function."""
    if "network_fn_state_dict" not in ckpt:
        return None

    def strip(k):
        return k[len("module."):] if k.startswith("module.") else k

    out = {f"mlp_coarse.{strip(k)}": v
           for k, v in ckpt["network_fn_state_dict"].items()}
    out.update({f"mlp_fine.{strip(k)}": v
                for k, v in ckpt.get("network_fine_state_dict", {}).items()})
    return out


def train_checkpoint_from_jax(params: Mapping, batch_stats: Mapping = None,
                              step: int = 0) -> Dict[str, object]:
    """A checkpoint in the layout of ``train/checkpoint.py`` from the
    fields of a JAX ``TrainState`` pulled to the host as numpy trees:
    ``params = {'nerf': ..., 'crf': ...}`` and the BatchNorm statistics
    ``batch_stats``. The optimizer starts fresh (Adam moments do not carry
    across frameworks) and the random stream from the resuming process's
    seed. ``torch.save`` it as ``{step:06d}.tar`` into a run's checkpoint
    directory and the port's loop resumes from it."""
    variables = {"params": params["nerf"], "batch_stats": batch_stats or {}}
    return {
        "global_step": int(step),
        "network_state_dict": state_dict_from_jax(variables),
        "crf_state_dict": crf_state_dict_from_jax(params.get("crf", {})),
        "optimizer_state_dict": None,
        "wandb_id": None,
    }
