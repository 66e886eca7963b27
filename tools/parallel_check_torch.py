#!/usr/bin/env python3
"""One training step (or one render) of the PyTorch port on a process
group, for holding the parallel paths to the one-process path.

    python3 tools/parallel_check_torch.py SETUP OUT --rank R --world N \\
        --port P [--tp K] [--device cpu|cuda|cuda:N] [--backend gloo|nccl]

``SETUP`` is a ``torch.save`` of a dict (:func:`run` lists its keys): the
model's configuration, a seed or weights, the global batch and the step's
schedule. Each of the ``N`` ranks builds the same state, takes its rows
of the batch (``parallel/mesh.py::shard_batch``), slices the voxel tables
over ``K`` ranks of each ray shard (``parallel/tp.py``) and runs the step;
rank 0 writes the loss, the logged terms and the gradients (the table
slices gathered) to ``OUT``, and every rank writes ``OUT.rank<R>.json``
with its kernel launches of the step, ms/step, peak memory and any module
of jax or of the JAX package it loaded (none). A caller
runs :func:`run` in its own process with no process group for the
one-process result on the same inputs. :func:`spawn` starts the ranks
and waits for them. The ranks join over gloo on the CPU, and on the card
over NCCL unless ``--backend gloo`` (two ranks that share one card).
Imports only the port.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def build_model(setup, device):
    """The model of ``cfg``/``kcfg`` drawn from ``seed`` on ``device``
    (its generator returned beside it), or loaded from ``model_sd``."""
    import torch

    from evdeblurnerf_torch.models.system import EvDeblurNeRF

    gen = torch.Generator(device=device).manual_seed(setup.get("seed", 0))
    model = EvDeblurNeRF(setup["cfg"], setup.get("kcfg"),
                         setup.get("num_images", 1), generator=gen,
                         device=device, K=setup.get("K"))
    if "model_sd" in setup:
        model.load_state_dict(setup["model_sd"], strict=True)
    return model, gen


def build_state(setup, device):
    """The TrainState of ``setup``: :func:`build_model` and the CRF of the
    flags (loaded from ``crf_sd`` with ``model_sd``)."""
    from evdeblurnerf_torch.train.state import build_crf, create_train_state

    model, gen = build_model(setup, device)
    crf = build_crf(setup["args"], gen, device)
    if "crf_sd" in setup:
        crf.load_state_dict(setup["crf_sd"], strict=True)
    return create_train_state(model, crf, setup["args"], gen,
                              crf_identity_prefit=False)


def _tensors(batch, device):
    import numpy as np
    import torch

    if batch is None:
        return None
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(setup, device, layout):
    """This rank's part of the check. ``setup`` keys: ``cfg``, ``kcfg``,
    ``num_images``, ``args`` and optionally ``K``, ``seed``, ``model_sd``,
    ``crf_sd`` (:func:`build_state`; a render needs ``cfg`` and the
    weights only); then either ``render`` (a dict of
    ``poses``, ``H``, ``W``, ``K``, ``chunk``: one data-parallel render of
    the poses, no step) or the step's ``batch``, ``ev_batch``, ``sw``,
    ``force_naive``, ``events_active``, ``fine_cull``, ``coarse_cull``,
    ``occ_grid`` (global, numpy), with ``time_steps`` (more steps timed
    after the compared one), ``checkpoint`` (a path: the checkpoint after
    the step, written by rank 0) and ``render_rays`` (after the step, the
    eval render of the batch's first rays). Returns the result dict and
    this rank's record."""
    import torch

    from evdeblurnerf_torch import kernels
    from evdeblurnerf_torch.parallel import mesh, tp
    from evdeblurnerf_torch.train import evaluate
    from evdeblurnerf_torch.train import step as tstep

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    if "sample" in setup:
        return _sample(setup["sample"], device, layout), {"rank": layout.rank}
    out, record = {}, {"rank": layout.rank}
    if "render" in setup:
        r = setup["render"]
        model, _ = build_model(setup, device)
        tp.shard_fields(tp.voxel_fields(model), layout)
        model.eval()
        kernels.reset_launches()
        t0 = time.perf_counter()
        rgb, depth = evaluate.render_poses(
            model.render_chunk, r["poses"], r["H"], r["W"], r["K"],
            chunk=r["chunk"], device=device, layout=layout)
        _sync(device)
        record["render_s"] = time.perf_counter() - t0
        record["launches"] = dict(kernels.LAUNCHES)
        out["rgb"], out["depth"] = rgb.cpu(), depth.cpu()
    else:
        state = build_state(setup, device)
        tp.shard_state(state, layout)
        model = state.model
        args = setup["args"]
        accum = max(1, int(getattr(args, "grad_accum", 1) or 1))
        step = tstep.build_train_step(args, return_grads=True, layout=layout)
        batch = _tensors(mesh.shard_batch(setup["batch"], layout, accum),
                         device)
        ev = setup.get("ev_batch")
        ev = None if ev is None else _tensors(
            mesh.shard_batch(ev, layout, accum), device)
        occ = setup.get("occ_grid")
        occ = None if occ is None else torch.as_tensor(occ).to(device)

        def one():
            return step(state, batch, ev, setup["sw"], setup["force_naive"],
                        setup["events_active"],
                        fine_cull=setup.get("fine_cull", False),
                        coarse_cull=setup.get("coarse_cull", False),
                        occ_grid=occ)

        kernels.reset_launches()
        aux = one()
        _sync(device)
        record["launches"] = dict(kernels.LAUNCHES)
        grads = tp.gather_grads(aux.pop("grads"), model, layout)
        out["loss"] = float(aux["loss"])
        out["aux"] = {k: float(v) for k, v in aux.items()
                      if torch.is_tensor(v) and v.dim() == 0}
        out["grads"] = {k: v.cpu() for k, v in grads.items()}
        if setup.get("checkpoint"):
            ckpt = tp.checkpoint_dict(state, layout)
            if layout.rank == 0:
                torch.save(ckpt, setup["checkpoint"])
        n = setup.get("render_rays", 0)
        if n:
            rays = torch.as_tensor(setup["batch"]["rays"][:n]).to(device)
            model.eval()
            with torch.inference_mode():
                rgb, depth, _ = model.render_chunk(rays)
            out["render_rgb"], out["render_depth"] = rgb.cpu(), depth.cpu()
            model.train()
        steps = int(setup.get("time_steps", 0))
        if steps:
            _sync(device)
            t0 = time.perf_counter()
            for _ in range(steps):
                one()
            _sync(device)
            record["ms_per_step"] = 1e3 * (time.perf_counter() - t0) / steps
    if device.type == "cuda":
        record["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    return out, record


def _sample(spec, device, layout):
    """``VoxelNeRF(**spec["field"])`` with the weights ``spec["sd"]``, its
    tables sliced over the model group: the features at ``spec["pts"]``
    and the gradients of their sum of squares (the slices gathered)."""
    import torch

    from evdeblurnerf_torch.models.voxnerf import VoxelNeRF
    from evdeblurnerf_torch.parallel import mesh, tp

    field = VoxelNeRF(**spec["field"], device=device)
    field.load_state_dict(spec["sd"], strict=False)
    tp.shard_fields([field], layout)
    pts = torch.as_tensor(spec["pts"]).to(device).requires_grad_()
    feats = field.sample(pts, is_train=True)
    (feats ** 2).sum().backward()
    live = [(n, p) for n, p in field.named_parameters() if p.grad is not None]
    mesh.all_reduce_gradients([p for _, p in live], layout)
    grads = {n: p.grad for n, p in live}
    grads = tp.gather_grads(grads, field, layout)
    return {"feats": feats.detach().cpu(), "pts_grad": pts.grad.cpu(),
            "grads": {n: g.cpu() for n, g in grads.items()}}


def spawn(setup_path: str, out_path: str, world: int, tp: int = 1,
          device: str = "cpu", backend: str | None = None,
          timeout: float = 600.0, env: dict | None = None):
    """Run the ``world`` ranks of this script on ``setup_path`` and wait;
    returns (rank 0's result, every rank's record). Raises with the
    ranks' output if one fails; every process started is ended."""
    import torch

    port = free_port()
    cmd = [sys.executable, os.path.abspath(__file__), setup_path, out_path,
           "--world", str(world), "--port", str(port), "--tp", str(tp),
           "--device", device]
    if backend:
        cmd += ["--backend", backend]
    procs = [subprocess.Popen(cmd + ["--rank", str(r)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              env={**os.environ, **(env or {})})
             for r in range(world)]
    logs = []
    try:
        deadline = time.monotonic() + timeout
        for p in procs:
            logs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [(r, p.returncode) for r, p in enumerate(procs)
              if p.returncode != 0]
    if failed:
        raise RuntimeError(
            f"parallel_check_torch: ranks {failed} failed:\n" + "\n".join(
                f"--- rank {r}:\n{log[-3000:]}" for r, log in
                enumerate(logs)))
    records = []
    for r in range(world):
        with open(f"{out_path}.rank{r}.json") as f:
            records.append(json.load(f))
    return torch.load(out_path, weights_only=False), records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("setup")
    ap.add_argument("out")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--backend", default=None)
    a = ap.parse_args(argv)

    import torch

    from evdeblurnerf_torch.parallel import mesh, multihost
    from evdeblurnerf_torch.utils.precision import set_matmul_precision

    multihost.initialize(device=a.device,
                         coordinator=f"localhost:{a.port}",
                         num_processes=a.world, process_id=a.rank,
                         backend=a.backend)
    try:
        device = multihost.local_device(a.device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        multihost.build_kernels(device)
        layout = mesh.create_layout(a.tp)
        setup = torch.load(a.setup, weights_only=False)
        set_matmul_precision(getattr(setup.get("args"), "matmul_precision",
                                     "highest"))
        out, record = run(setup, device, layout)
        # the ranks run the port alone
        record["jax_modules"] = sorted(
            m for m in sys.modules if m.split(".")[0]
            in ("jax", "jaxlib", "flax", "evdeblurnerf_tpu"))
        if a.rank == 0:
            torch.save(out, a.out)
        with open(f"{a.out}.rank{a.rank}.json", "w") as f:
            json.dump(record, f)
        multihost.barrier()
    finally:
        multihost.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
