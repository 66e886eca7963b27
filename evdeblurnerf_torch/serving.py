"""Serving entry points of the port: the live eval renderer and the exported
serving artifact.

Counterpart of ``evdeblurnerf_tpu/serving.py``. Two ways to serve:

* **live** (:func:`build_renderer`): the model is rebuilt from flags and a
  reference-layout ``network_state_dict`` is loaded, the reference's own
  render-only flow (ref: run_nerf.py:337-414)::

      sd = load_network_state_dict("030000.tar")
      r = build_renderer(args, sd, H, W, K, near, far, aabb, device="cuda")
      rgb, depth, acc = r(rays)                 # one chunk [chunk, 3, 2]
      rgbs, depths = r.render_poses(poses)      # whole poses

* **exported** (:func:`export_renderer`, :func:`save_renderer`,
  :func:`load_renderer`): the eval render of one fixed chunk shape,
  ``models/system.py::render_chunk`` with the rgb CRF folded in, traced
  by ``torch.export`` into an ``ExportedProgram`` that holds the weights
  (the fields' packed tables, not their raw grids: ``freeze_tables``) and
  calls the kernels through their custom ops ``evdn::permute_lanes``,
  ``evdn::cdf_take`` and ``evdn::triplane_features`` (``kernels/``).
  Loading needs torch and those ops, no model code, config or
  checkpoint: no module of ``evdeblurnerf_torch.models`` is imported::

      exported, meta = export_renderer(model, chunk=32768, crf=crf,
                                       meta={"H": H, "W": W, "K": K})
      save_renderer("scene.evdnpt", exported, meta)
      r = load_renderer("scene.evdnpt")
      rgb, depth, acc = r(rays)
      rgbs, depths = r.render_poses(poses)

  ``evdn-export-torch`` (``cli.export_main``, also
  ``tools/export_renderer_torch.py``) exports a trained experiment;
  ``tools/bench_serving_torch.py`` measures an artifact.

File layout (one file), the JAX package's::

    8 bytes   magic  b"EVDNPTS1" (the JAX package's artifacts: b"EVDNSRV1")
    8 bytes   little-endian uint64: JSON header length
    N bytes   UTF-8 JSON header (chunk, camera, device, torch version, ...)
    rest      the ``torch.export.save`` bytes of the program

A bf16 model (``--triplane_bf16``) is exported, like the JAX artifact,
with its bf16 eval chain baked in. The rgb CRF is folded into the chunk
output in both ways of serving.

On a card both renderers replay one CUDA graph per chunk shape, the
counterpart of the JAX package's jitted chunk renderer and jitted
``exported.call`` (``train/capture.py::CapturedCall``): the first chunk
renders eagerly, the second is captured, later ones replay; ``warm()``
brings a renderer there, ``eager(rays)`` renders a chunk with no graph.
On the CPU every chunk renders eagerly.

A data-parallel artifact (``--export_devices k``,
``evdeblurnerf_tpu/serving.py:240-249``) records k: its program renders
``chunk / k`` rays, and the loader places a replica on each of the first
k devices of the artifact's type and splits every chunk over them (the
outputs gathered on the first). Exporting or loading it in a process with
fewer than k devices raises ``ValueError``, with the JAX package's
messages.
"""

from __future__ import annotations

import copy
import io
import json
import os
import struct
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from .config import eval_fine_cull
from .train import evaluate
from .train.capture import CapturedCall
from .utils.convert import normalize_legacy_network_state_dict

FIELD_PREFIXES = ("mlp_coarse.", "mlp_fine.")
UNUSED_PREFIXES = ("kernelsnet.", "awpnet.")

MAGIC = b"EVDNPTS1"
JAX_MAGIC = b"EVDNSRV1"      # evdeblurnerf_tpu/serving.py's
FORMAT_VERSION = 1


def load_network_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The ``network_state_dict`` of a reference-format ``*.tar`` checkpoint
    (ref: run_nerf.py:617-638; also what
    ``tools/export_reference_checkpoint.py`` writes), or that of a legacy
    two-network checkpoint of NeRF-mode fields
    (``utils/convert.py::normalize_legacy_network_state_dict``)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    legacy = normalize_legacy_network_state_dict(ckpt)
    return legacy if legacy is not None else ckpt["network_state_dict"]


class ServingRenderer:
    """A model (c2f or NeRF fields) with its weights and rgb CRF, rendering
    ray chunks; ``fine_cull`` renders them with the transmittance fine
    cull (``--fine_cull_eval``). A chunk goes through
    ``train/evaluate.py::build_chunk_renderer`` with the CRF folded in: on
    a card one CUDA graph, replayed (``graph_cls``: a stand-in for
    tests)."""

    def __init__(self, model, crf, chunk: int, H: int, W: int, K,
                 unused_keys=(), fine_cull: bool = False, graph_cls=None):
        self.model = model
        self.fine_cull = bool(fine_cull)
        self.crf = crf
        self.chunk = int(chunk)
        self.H, self.W = int(H), int(W)
        self.K = np.asarray(K, np.float64)
        self.unused_keys = tuple(unused_keys)
        self._render = evaluate.build_chunk_renderer(
            model, self.fine_cull, crf=crf, graph_cls=graph_cls)

    @property
    def device(self) -> torch.device:
        return self.model.device

    def _check(self, rays) -> None:
        if tuple(rays.shape) != (self.chunk, 3, 2):
            raise ValueError(f"this renderer takes chunks of shape "
                             f"({self.chunk}, 3, 2); got {tuple(rays.shape)}")

    def __call__(self, rays: torch.Tensor):
        """rays [chunk, 3, 2] -> (rgb [chunk, 3] through the CRF,
        depth [chunk], acc [chunk])."""
        self._check(rays)
        return self._render(rays)

    def eager(self, rays: torch.Tensor):
        """The same chunk rendered eagerly, with no graph."""
        self._check(rays)
        return self._render.eager(rays)

    def warm(self) -> None:
        """Bring the renderer to its held graph (the eager first call,
        then the capture)."""
        self._render.warm(evaluate.blank_rays(self.chunk, self.device))

    def render_poses(self, poses, H: Optional[int] = None,
                     W: Optional[int] = None, K=None,
                     render_factor: int = 0):
        """Render [N, 3, 4] poses -> (rgbs [N, H, W, 3], depths [N, H, W])
        on the model's device; H/W/K default to the renderer's camera."""
        return evaluate.render_poses(
            self, poses, self.H if H is None else int(H),
            self.W if W is None else int(W), self.K if K is None else K,
            chunk=self.chunk, render_factor=render_factor, device=self.device)


def build_renderer(args, state_dict: Mapping[str, torch.Tensor], H: int,
                   W: int, K, near: float, far: float, aabb,
                   device="cuda") -> ServingRenderer:
    """Build the model from flags and load its fields strictly.

    ``state_dict`` is a reference ``network_state_dict``: every
    ``mlp_coarse.*`` / ``mlp_fine.*`` key must match the model exactly.
    ``kernelsnet.*`` / ``awpnet.*`` keys (blur kernel, AWP) are not used
    at render time, as in the reference's render-only mode, and are listed
    in ``unused_keys``; any other key is an error. ``--fine_cull_eval``
    with a ``--fine_cull_capacity`` renders with the fine cull, as the
    JAX package's serving reads the flags; ``--triplane_bf16`` renders
    through the bf16 eval chain, as the JAX artifact does.
    """
    from .models.renderer import config_from_args
    from .models.system import EvDeblurNeRF
    from .models.tonemapping import CRF

    fields = {k: v for k, v in state_dict.items()
              if k.startswith(FIELD_PREFIXES)}
    unused = sorted(k for k in state_dict if k.startswith(UNUSED_PREFIXES))
    unknown = sorted(set(state_dict) - set(fields) - set(unused))
    if unknown:
        raise KeyError(f"unexpected network_state_dict keys: {unknown}")
    cfg = config_from_args(args, aabb, H, W, float(K[0][0]), near, far)
    model = EvDeblurNeRF(cfg, device=device)
    model.load_state_dict(fields, strict=True)
    model.eval()
    crf = CRF(args.tone_mapping_type, args.tone_mapping_gamma)
    return ServingRenderer(model, crf, args.chunk, H, W, K, unused,
                           fine_cull=eval_fine_cull(args))


# ---------------------------------------------------------------------------
# the exported artifact
# ---------------------------------------------------------------------------

class RenderProgram(nn.Module):
    """``rays [chunk, 3, 2] -> (rgb [chunk, 3], depth, acc)``: the
    deterministic eval render of ``model`` (``render_chunk``: perturb 0, no
    sigma noise, no coarse cull; the fine cull with ``fine_cull``) with the
    rgb CRF folded in (pointwise, so equal to the reference's CRF after the
    chunked render, ref: run_nerf.py:660); ``skip_learn_crf`` leaves a
    learned head out, as the train loop's renders before its learn start
    do."""

    def __init__(self, model: nn.Module, crf: Optional[nn.Module] = None,
                 skip_learn_crf: bool = False, fine_cull: bool = False):
        super().__init__()
        self.model = model
        self.crf = crf
        self.skip_learn_crf = bool(skip_learn_crf)
        self.fine_cull = bool(fine_cull)

    def forward(self, rays: torch.Tensor):
        ret = self.model.render(rays, fine_cull=self.fine_cull)
        rgb = ret["rgb_map"]
        if self.crf is not None:
            rgb = evaluate.encode_rgb(self.crf, rgb, self.skip_learn_crf)
        return rgb, ret["depth_map"], ret["acc_map"]


def make_render_fn(model, crf=None, skip_learn_crf: bool = False,
                   fine_cull: bool = False) -> RenderProgram:
    """The live counterpart of an artifact: a :class:`RenderProgram` over
    ``model`` itself (its tables refreshed as it trains on), to call under
    ``torch.no_grad()``."""
    return RenderProgram(model, crf, skip_learn_crf, fine_cull).eval()


def device_count(kind: str) -> int:
    """The devices of type ``kind`` this process has (one CPU)."""
    return torch.cuda.device_count() if kind == "cuda" else 1


def _check_devices(kind: str, devices: int, chunk: int) -> None:
    """Refuse an export over more devices than the process has (the JAX
    package's check) or a chunk that does not divide over them."""
    if devices > 1:
        avail = device_count(kind)
        if avail < devices:
            raise ValueError(
                f"export requested {devices} devices but this process has "
                f"{avail} — the artifact would silently shard differently "
                "than asked")
        if chunk % devices:
            raise ValueError(f"chunk={chunk} must divide over the "
                             f"{devices}-device mesh")


def export_renderer(model, chunk: int = 32768, crf=None,
                    skip_learn_crf: bool = False, meta: Optional[dict] = None,
                    fine_cull: bool = False, devices: int = 1):
    """Trace the eval render of one ``[chunk, 3, 2]`` f32 ray chunk with
    ``torch.export``; returns ``(exported, header)``.

    The program renders on the device ``model`` lies on and holds a frozen
    copy of its weights: the fields' packed tables (bf16 ones for a bf16
    model, its eval chain baked in) and MLPs, not the raw grids. ``meta``
    entries (H, W, K, near, far, expname, step) are merged into the header,
    so a loader can make camera rays without a config file.
    ``devices > 1``: a data-parallel artifact, whose program renders
    ``chunk / devices`` rays on each of that many devices (module
    docstring)."""
    device = model.device
    _check_devices(device.type, devices, chunk)
    frozen = copy.deepcopy(model).eval()
    frozen.freeze_tables()
    program = RenderProgram(frozen, crf, skip_learn_crf, fine_cull).eval()
    rays = torch.zeros(int(chunk) // devices, 3, 2, device=device)
    rays[:, 2, 1] = -1.0
    with torch.no_grad():
        exported = torch.export.export(program, (rays,), strict=False)
    cfg = frozen.cfg
    bf16 = bool(getattr(cfg, "triplane_bf16", False))
    header = {
        "format_version": FORMAT_VERSION,
        "chunk": int(chunk),
        "devices": int(devices),
        "device": device.type,
        "device_name": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
        "torch_version": torch.__version__,
        "crf_folded": crf is not None,
        "skip_learn_crf": bool(skip_learn_crf),
        "fine_cull": bool(fine_cull),
        "triplane_bf16": bf16,
        "eval_bf16_chain": bool(bf16 and cfg.mode == "c2f"
                                and frozen.mlp_coarse.eval_bf16(False)),
        "tables": "packed" if cfg.mode == "c2f" else "none",
    }
    header.update(meta or {})
    return exported, header


def save_renderer(path: str, exported, meta: dict) -> int:
    """Write the artifact file; returns its size in bytes."""
    payload = io.BytesIO()
    torch.export.save(exported, payload)
    head = json.dumps(meta).encode("utf-8")
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        f.write(payload.getbuffer())
    os.replace(tmp, path)
    return os.path.getsize(path)


class ExportedRenderer:
    """A loaded artifact: callable on one ray chunk, plus whole poses in
    chunks (``train/evaluate.py::render_poses``). A data-parallel
    artifact's replicas go to ``devices`` (default: the first ``k`` of the
    artifact's device type, k recorded at export; fewer raise).

    A 1-device artifact's chunk replays one CUDA graph of the program's
    call on a card (``train/capture.py::CapturedCall``, the counterpart of
    ``jax.jit(exported.call)``, ``evdeblurnerf_tpu/serving.py:140``): its
    weights are frozen, so the data pointers are the only check before a
    replay. A k > 1 artifact renders eagerly, said once: its chunk spans k
    devices. ``graph_cls``: a stand-in graph for tests."""

    def __init__(self, exported, meta: dict, devices=None, graph_cls=None):
        self._exported = exported
        self.meta = dict(meta)
        self.chunk = int(meta["chunk"])
        k = int(meta.get("devices", 1))
        kind = torch.device(meta.get("device", "cpu")).type
        if devices is None and k > 1:
            avail = device_count(kind)
            if avail < k:
                raise ValueError(f"artifact was exported for {k} devices; "
                                 f"this process has {avail}")
            devices = [torch.device(kind, i) for i in range(k)]
        if devices is None:
            self.devices = [torch.device(kind)]
            self._modules = [exported.module()]
        else:
            from torch.export.passes import move_to_device_pass

            if len(devices) != k:
                raise ValueError(f"artifact was exported for {k} devices; "
                                 f"{len(devices)} given")
            self.devices = [torch.device(d) for d in devices]
            self._modules = [move_to_device_pass(exported, d).module()
                             for d in self.devices]
        self.device = self.devices[0]
        reason = (f"a data-parallel artifact over {k} devices (its chunk "
                  "spans them)" if k > 1 else None)
        self._render = CapturedCall(self._split, self._modules, self.device,
                                    "artifact render", reason=reason,
                                    graph_cls=graph_cls)

    def _split(self, rays):
        # each replica queues its share on its own device before any
        # output is gathered
        outs = [m(part.to(d, torch.float32)) for m, d, part in
                zip(self._modules, self.devices,
                    torch.as_tensor(rays).chunk(len(self._modules)))]
        return tuple(torch.cat([o[j].to(self.device) for o in outs])
                     for j in range(len(outs[0])))

    def _check(self, rays) -> None:
        if tuple(rays.shape) != (self.chunk, 3, 2):
            raise ValueError(
                f"this artifact renders fixed chunks of shape ({self.chunk}, "
                f"3, 2); got {tuple(rays.shape)}: pad, or export again with "
                "another --export_chunk")

    def __call__(self, rays):
        self._check(rays)
        return self._render(torch.as_tensor(rays))

    def eager(self, rays):
        """The same chunk through the program's modules, with no graph."""
        self._check(rays)
        return self._render.eager(torch.as_tensor(rays))

    def warm(self) -> None:
        """Bring the artifact to its held graph (the eager first call,
        then the capture)."""
        self._render.warm(evaluate.blank_rays(self.chunk, self.device))

    def render_poses(self, poses, H: Optional[int] = None,
                     W: Optional[int] = None, K=None,
                     render_factor: int = 0):
        """Render [N, 3, 4] poses -> (rgbs [N, H, W, 3], depths [N, H, W])
        on the artifact's device; H/W/K default to the values recorded at
        export time."""
        H = int(H if H is not None else self.meta["H"])
        W = int(W if W is not None else self.meta["W"])
        K = np.asarray(K if K is not None else self.meta["K"], np.float64)
        return evaluate.render_poses(self, poses, H, W, K, chunk=self.chunk,
                                     render_factor=render_factor,
                                     device=self.device)


def load_renderer(path: str) -> ExportedRenderer:
    """Read an artifact of :func:`save_renderer`. Raises ``ValueError`` on
    a bad magic (naming the JAX package for one of its artifacts) or a
    format newer than this loader's."""
    with open(path, "rb") as f:
        magic = f.read(len(MAGIC))
        if magic == JAX_MAGIC:
            raise ValueError(
                f"{path} is a serving artifact of the JAX package "
                "(evdeblurnerf_tpu); load it with "
                "evdeblurnerf_tpu.serving.load_renderer")
        if magic != MAGIC:
            raise ValueError(f"{path} is not a serving artifact of "
                             f"evdeblurnerf_torch (bad magic {magic!r})")
        (head_len,) = struct.unpack("<Q", f.read(8))
        meta = json.loads(f.read(head_len).decode("utf-8"))
        payload = f.read()
    if meta.get("format_version", 0) > FORMAT_VERSION:
        raise ValueError(
            f"artifact format v{meta['format_version']} is newer than this "
            f"loader (v{FORMAT_VERSION})")
    # the program calls these modules' custom ops (evdn::*)
    from .ops import fused_sample, lane_shuffle  # noqa: F401

    return ExportedRenderer(torch.export.load(io.BytesIO(payload)), meta)


def export_experiment(args, out_path: str, chunk: int = 32768,
                      devices: int = 1) -> dict:
    """Config + checkpoint directory -> one artifact on disk; returns its
    header.

    Rebuilds the model as training does (the flags and the scene's camera
    and bounding box; the event stream is not read), restores the newest
    checkpoint of ``--ft_path`` or ``<basedir>/<expname>/checkpoints``,
    folds the rgb CRF (its learned head left out while the checkpoint's
    step is before ``--tone_mapping_start_learn_iter``, as the train loop's
    renders do), takes the fine cull with ``--fine_cull_eval`` and a
    ``--fine_cull_capacity`` (``evdeblurnerf_tpu/serving.py:257-263``), and
    writes the artifact, data-parallel over ``devices``. Used by
    ``evdn-export-torch``."""
    from . import config
    from .train import loop
    from .train.checkpoint import CheckpointManager

    args = config.resolve_event_thresholds(copy.copy(args))
    config.check_supported(args)
    device = loop.resolve_device(args)
    _check_devices(device.type, devices, chunk)
    dargs = copy.copy(args)
    dargs.use_events = False
    llff, _ = loop.build_datasets(dargs)
    model, crf = loop.build_model(args, llff, device=device)
    state = loop.build_initial_state(args, model, crf,
                                     torch.Generator(device=device),
                                     crf_identity_prefit=False)
    ckpt_dir = (args.ft_path if args.ft_path
                else os.path.join(args.basedir, args.expname, "checkpoints"))
    step = CheckpointManager(ckpt_dir).restore_latest(state)
    if step is None:
        raise FileNotFoundError(f"no checkpoint found under {ckpt_dir}")
    exported, meta = export_renderer(
        model, chunk=chunk, crf=crf, fine_cull=eval_fine_cull(args),
        devices=devices,
        skip_learn_crf=step < args.tone_mapping_start_learn_iter,
        meta={"H": int(llff.h), "W": int(llff.w),
              "K": np.asarray(llff.K, np.float64).tolist(),
              "near": float(llff.near), "far": float(llff.far),
              "expname": args.expname, "step": int(step)})
    meta["bytes"] = save_renderer(out_path, exported, meta)
    return meta
