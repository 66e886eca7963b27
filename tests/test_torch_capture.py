"""The captured training step (``evdeblurnerf_torch/train/capture.py``) on
the CPU.

On the CPU :class:`CapturedStep` runs its capture-ready step eagerly: the
schedule's floats as views of one device tensor, the batches copied into
static buffers, the tables repacked in place. Over a window of steps that
crosses every change of the graphs' key (the event loss's start, the
blur kernel's, the EDI-prior target's, the learned CRF's and the two
culls'), it must equal the eager step of ``train/step.py`` bitwise:
metrics, parameters, Adam's moments and counts, the BatchNorm statistics;
and both are held against the JAX ``build_train_step`` over the same
window at the bounds of ``tests/test_torch_train.py`` (per-step loss
within 2e-2 relative, the first step's terms at 2e-5). The in-place pack
equals a fresh pack bitwise at unchanged addresses, f32 and bf16; the
paper configuration's 30,000 steps cross exactly two keys; and launch
counts move by a graph's captured counts at each replay (a stand-in graph
on the CPU).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lockstep_common as lc
import oracle_common as oc
from evdeblurnerf_torch import config as tconfig
from evdeblurnerf_torch import kernels
from evdeblurnerf_torch.models.renderer import RenderConfig
from evdeblurnerf_torch.models.system import (EvDeblurNeRF, build_occ_grid,
                                              kernel_config_from_args)
from evdeblurnerf_torch.models.tonemapping import TonemappingTransform
from evdeblurnerf_torch.models.voxnerf import VoxelNeRF
from evdeblurnerf_torch.ops import triplane
from evdeblurnerf_torch.train import capture
from evdeblurnerf_torch.train import loop as tloop
from evdeblurnerf_torch.train import step as tstep
from evdeblurnerf_torch.train.state import create_train_state
from evdeblurnerf_torch.utils.convert import (crf_state_dict_from_jax,
                                              state_dict_from_jax)
from evdeblurnerf_tpu.models.system import EvDeblurNeRF as JModel
from evdeblurnerf_tpu.models.system import \
    kernel_config_from_args as jkernel_config
from evdeblurnerf_tpu.models.tonemapping import \
    TonemappingTransform as JTonemapping
from evdeblurnerf_tpu.train import optim as joptim
from evdeblurnerf_tpu.train import step as jstep
from evdeblurnerf_tpu.train.state import create_train_state as jcreate

ATOL = RTOL = 2e-5
LOSS_RTOL = 2e-2
# one change of the key a step: events, kernel, EDI-prior target, CRF
# learn start, fine cull, coarse cull (0-based step of each start)
STARTS = dict(add_event_egm_startiter=1, kernel_start_iter=2,
              pts0_target_start_iter=3, tone_mapping_start_learn_iter=4,
              fine_cull_start_iter=5, coarse_cull_start_iter=6)
WINDOW = 8
SAMPLES = 16


def _args():
    """The events-on lockstep flags (colour events, 'color-pos-neg' BII,
    the learned event CRF, colour weights) with the EDI-prior target, the
    two culls and the starts of :data:`STARTS`."""
    args = lc.lockstep_ev_args()
    for k, v in dict(
            STARTS, N_samples=SAMPLES, N_importance=SAMPLES,
            use_pts0_prior="edi", pts0_target_weight=0.5,
            pts0_target_weight_end=0.1, pts0_target_weight_steps=10,
            event_egm_color_weights_start_iter=3,
            fine_cull_capacity=0.25, coarse_cull_capacity=0.5,
            occ_grid_size=16, occ_gate_margin=0.0).items():
        setattr(args, k, v)
    tconfig.resolve_event_thresholds(args)
    return args


def _jcfg(args):
    return dataclasses.replace(
        oc.make_cfg(args), N_samples=SAMPLES, N_importance=SAMPLES,
        fine_cull_capacity=args.fine_cull_capacity,
        coarse_cull_capacity=args.coarse_cull_capacity, occ_grid_size=16)


def _batches():
    rng = np.random.default_rng(29)
    batches = [dict(b, rgbsf_pts0=rng.uniform(0, 1, (oc.N, 3)).astype(
        np.float32)) for b in lc.make_batches()]
    return batches, lc.make_ev_batches()


def _tensors(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
            b.items()}


def _jax_init(args, batch):
    """The JAX model, state and step from one seeded init, and that init
    as the port's state dicts."""
    jmodel = JModel(cfg=_jcfg(args), kcfg=jkernel_config(args),
                    num_images=oc.NUM_IMAGES, K=oc.K)
    jcrf = JTonemapping(map_type_rgb="none", map_type_event="learn",
                        extra_features_event=2)
    tx = joptim.build_optimizer(args.lrate, args.lrate_decay)
    info = {k: batch[k] for k in ("images_idx", "rays_x", "rays_y",
                                  "poses")}
    jstate = jcreate(jmodel, jcrf, tx, jax.random.PRNGKey(5), batch["rays"],
                     info)
    variables = jax.tree_util.tree_map(np.asarray, {
        "params": jstate.params["nerf"], "batch_stats": jstate.batch_stats})
    crf_sd = crf_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jstate.params["crf"]))
    return (jstate, jstep.build_train_step(jmodel, jcrf, tx, args),
            state_dict_from_jax(variables), crf_sd)


def _port_state(args, sd=None, crf_sd=None):
    """The port's train state at the JAX init's weights, or at its own
    seeded draws without them."""
    jcfg = _jcfg(args)
    gen = torch.Generator().manual_seed(0)
    model = EvDeblurNeRF(RenderConfig(**{
        f.name: getattr(jcfg, f.name)
        for f in dataclasses.fields(RenderConfig)}),
        kernel_config_from_args(args), oc.NUM_IMAGES, generator=gen)
    crf = TonemappingTransform("none", "learn", 2.2, "rec601",
                               extra_features_event=2, generator=gen)
    if sd is not None:
        model.load_state_dict(sd, strict=True)
        crf.load_state_dict(crf_sd, strict=True)
    return create_train_state(model, crf, args, torch.Generator(),
                              crf_identity_prefit=False)


def _run(step, state, args, batches, ev_batches, grid):
    """The window through ``step`` with the loop's gates and schedule:
    (metrics of each step, the key of each step)."""
    sw_of = tstep.schedule_weights_fn(args)
    out, keys = [], []
    for i in range(WINDOW):
        force_naive, events, fine, coarse = tloop.step_gates(args, i)
        sw = sw_of(i) if events else tstep.schedule_weights_fn(
            args, events_active=False)(i)
        keys.append(capture.step_key(sw, force_naive, events, fine, coarse))
        b = _tensors(batches[i % lc.N_BATCHES])
        e = _tensors(ev_batches[i % lc.N_BATCHES]) if events else None
        aux = step(state, b, e, sw, force_naive, events, fine_cull=fine,
                   coarse_cull=coarse, occ_grid=grid if coarse else None)
        out.append({k: v.clone() for k, v in aux.items()})
    return out, keys


def _packed(model):
    return [t for f in (model.mlp_coarse, model.mlp_fine)
            for t in (*f._packed()[0], *f._packed()[1])]


@pytest.fixture(scope="module")
def window():
    args = _args()
    batches, ev_batches = _batches()
    jstate, jstep_fn, sd, crf_sd = _jax_init(args, batches[0])
    eager = _port_state(args, sd, crf_sd)
    grid = build_occ_grid(eager.model)
    assert 0 < float(grid.mean()) < 1
    ready = _port_state(args, sd, crf_sd)
    ptrs = [t.data_ptr() for t in _packed(ready.model)]
    got_eager, keys = _run(tstep.build_train_step(args), eager, args,
                           batches, ev_batches, grid)
    got_ready, keys_ready = _run(capture.CapturedStep(args), ready, args,
                                 batches, ev_batches, grid)
    assert keys_ready == keys
    assert [t.data_ptr() for t in _packed(ready.model)] == ptrs
    # host copies: a JAX step donates the state it is given
    return dict(args=args, batches=batches, ev_batches=ev_batches,
                jstate=jax.tree_util.tree_map(np.asarray, jstate),
                jstep_fn=jstep_fn, grid=grid, keys=keys,
                eager=eager, ready=ready, got_eager=got_eager,
                got_ready=got_ready)


def test_window_crosses_every_key_change(window):
    """Each step of the window after the first changes one element of
    the key, and every element changes once."""
    keys = window["keys"]
    flips = [[j for j in range(6) if a[j] != b[j]]
             for a, b in zip(keys, keys[1:])]
    assert flips == [[1], [0], [5], [4], [2], [3], []], keys


def test_capture_ready_step_equals_eager_step_bitwise(window):
    """Metrics of every step, then parameters, buffers (the AWP
    BatchNorm's statistics), Adam's moments and counts: bitwise."""
    for i, (a, b) in enumerate(zip(window["got_eager"],
                                   window["got_ready"])):
        assert set(a) == set(b), i
        for k in a:
            assert torch.equal(a[k], b[k]), (i, k, a[k], b[k])
    eager, ready = window["eager"], window["ready"]
    assert eager.step == ready.step == WINDOW
    for mod_a, mod_b in ((eager.model, ready.model),
                         (eager.crf, ready.crf)):
        sa, sb = mod_a.state_dict(), mod_b.state_dict()
        assert set(sa) == set(sb)
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k
    opt_a, opt_b = eager.optimizer, ready.optimizer
    params_a = [p for g in opt_a.param_groups for p in g["params"]]
    params_b = [p for g in opt_b.param_groups for p in g["params"]]
    with_state = 0
    for pa, pb in zip(params_a, params_b):
        sa, sb = opt_a.state.get(pa, {}), opt_b.state.get(pb, {})
        assert set(sa) == set(sb)
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k
        with_state += bool(sa)
    assert 0 < with_state <= len(params_a)
    # lazy state: the CRF's count starts at its learn start
    crf_p = next(ready.crf.parameters())
    assert int(opt_b.state[crf_p]["step"]) == \
        WINDOW - STARTS["tone_mapping_start_learn_iter"]
    # the tables the last repack wrote are those of the last weights
    for field in (ready.model.mlp_coarse, ready.model.mlp_fine):
        planes, lines, _ = triplane.pack_grids(*field.grids())
        for t, want in zip((*field._packed()[0], *field._packed()[1]),
                           (*planes, *lines)):
            assert torch.equal(t, want)


@pytest.mark.parametrize("n_steps", [
    2, pytest.param(WINDOW, marks=pytest.mark.slow)])
def test_window_matches_jax_step(window, n_steps):
    """The window's first ``n_steps`` against the JAX step from the same
    init, fed the same schedule values and occupancy grid: per-step loss
    within 2e-2 relative, the first step's terms within 2e-5. The whole
    window compiles five JAX programs (~70 s on the CPU): slow; the first
    two steps (two programs, the event loss's start) run in Tier-1."""
    jstate = jax.tree_util.tree_map(jnp.asarray, window["jstate"])
    jstep_fn = window["jstep_fn"]
    args = window["args"]
    grid = jnp.asarray(window["grid"].numpy())
    rel = []
    for i, got in enumerate(window["got_ready"][:n_steps]):
        force_naive, events, fine, coarse = tloop.step_gates(args, i)
        sw = tstep.schedule_weights_fn(args, events_active=events)(i)
        jsw = jstep.ScheduleWeights(
            **{n: jnp.asarray(getattr(sw, n), jnp.float32)
               for n in tstep.SCHEDULE_FLOATS},
            use_pts0_target=jnp.asarray(sw.use_pts0_target),
            skip_learn_crf=jnp.asarray(sw.skip_learn_crf),
            color_weight=jnp.asarray(sw.color_weight, jnp.float32))
        e = window["ev_batches"][i % lc.N_BATCHES] if events else None
        jstate, jaux = jstep_fn(
            jstate, window["batches"][i % lc.N_BATCHES], e,
            jax.random.PRNGKey(i), jsw, force_naive=force_naive,
            events_active=events, fine_cull=fine, coarse_cull=coarse,
            occ_grid=grid if coarse else None)
        want = float(jaux["loss"])
        rel.append(abs(float(got["loss"]) - want) / abs(want))
        if i == 0:
            assert set(got) == set(jaux)
            for k in ("img_loss", "psnr", "pts0_loss", "tv_loss"):
                np.testing.assert_allclose(float(got[k]), float(jaux[k]),
                                           rtol=RTOL, atol=ATOL, err_msg=k)
    print(f"per-step relative loss difference against JAX: {rel}")
    assert max(rel) < LOSS_RTOL, rel


@pytest.mark.parametrize("bf16", [False, True])
def test_in_place_pack_equals_fresh_pack(bf16):
    """``pack_grids(out=...)`` writes into the tables at their addresses,
    bitwise what a fresh pack of the (rounded) grids makes; a field whose
    grids moved renders after ``repack_tables`` what a field built on those
    grids renders."""
    g = torch.Generator().manual_seed(3)
    kw = dict(aabb=oc.AABB, n_voxels=4096, app_n_comp=(4, 2, 2), app_dim=8,
              hidden_dim=8, hidden_dim_color=8, geo_feat_dim=8,
              table_bf16=bf16)
    field = VoxelNeRF(generator=g, **kw)
    ptrs = [t.data_ptr() for t in (*field._packed()[0],
                                   *field._packed()[1])]
    with torch.no_grad():
        for p in (*field.app_plane, *field.app_line):
            p.add_(torch.randn(p.shape, generator=g))
    field.repack_tables()
    planes, lines = field.grids()
    if bf16:
        planes = [p.to(torch.bfloat16) for p in planes]
        lines = [l.to(torch.bfloat16) for l in lines]
    want_p, want_l, sizes = triplane.pack_grids(planes, lines)
    got = (*field._packed()[0], *field._packed()[1])
    assert [t.data_ptr() for t in got] == ptrs
    for t, w in zip(got, (*want_p, *want_l)):
        assert t.dtype == w.dtype and torch.equal(t, w)
    assert field.table_sizes == sizes
    fresh = VoxelNeRF(generator=torch.Generator().manual_seed(3), **kw)
    fresh.load_state_dict(field.state_dict())
    pts = torch.rand((64, 3), generator=g) * 2.4 - 1.2
    assert torch.equal(field.sample(pts), fresh.sample(pts))


def test_paper_config_crosses_two_keys():
    """The paper's configuration over its 30,000 steps, gated as the loop
    gates them: two keys, the second from step 1200 (the blur kernel's
    and the learned CRF's start), the EDI-prior target and the events on
    throughout."""
    args = tconfig.resolve_event_thresholds(tconfig.parse_args(
        ["--config", "configs/evdeblurnerf_blender/"
         "tx_blurfactory_evdeblurnerf_ediprior_evcrf.txt"]))
    sw_of = tstep.schedule_weights_fn(args)
    keys = {}
    for i in range(args.N_iters):
        force_naive, events, fine, coarse = tloop.step_gates(args, i)
        keys.setdefault(capture.step_key(sw_of(i), force_naive, events,
                                         fine, coarse), i)
    assert keys == {(True, True, False, False, True, True): 0,
                    (False, True, False, False, False, True): 1200}


class _StandInGraph:
    """A graph on the CPU: its capture runs the step once (the stand-in
    for recording it) and a replay runs nothing."""

    made = []

    def __init__(self, pool, stream, generator):
        _StandInGraph.made.append(self)
        self.replays = 0

    def capture(self, fn):
        return fn()

    def replay(self):
        self.replays += 1


def test_launch_counts_move_by_captured_counts(monkeypatch):
    """A step that counts launches (two of K3, one of K4 a step, as a
    kernel wrapper counts them): its eager warm-up counts them; its
    capture counts nothing; each replay, the first right after the
    capture included, counts what the capture counted."""
    args = _args()
    step = capture.CapturedStep(args, graph_cls=_StandInGraph)
    update = step.update

    def counting(*a, **kw):
        kernels.LAUNCHES["cdf_take"] += 2
        kernels.LAUNCHES["triplane_features"] += 1
        return update(*a, **kw)

    step.update = counting
    batches, _ = _batches()
    state = _port_state(args)
    sw = tstep.ScheduleWeights()
    _StandInGraph.made.clear()
    kernels.reset_launches()
    seen = []
    for i in range(4):
        step(state, _tensors(batches[i]), None, sw, True, False)
        seen.append((kernels.LAUNCHES["cdf_take"],
                     kernels.LAUNCHES["triplane_features"]))
    assert seen == [(2, 1), (4, 2), (6, 3), (8, 4)]
    (graph,) = _StandInGraph.made
    assert graph.replays == 3
    assert step.graphs[capture.step_key(sw, True, False)].launches == {
        "cdf_take": 2, "triplane_features": 1}
    assert state.step == 4
    kernels.reset_launches()


def test_eager_table_runs_the_eager_step(monkeypatch, capsys):
    """A configuration that ``capture.EAGER`` names runs the eager step of
    ``train/step.py``, said once in the log: no static buffer, no graph."""
    monkeypatch.setattr(capture, "EAGER", (
        ("every configuration", lambda args: True, "a test's entry"),))
    args = _args()
    step = capture.CapturedStep(args, graph_cls=_StandInGraph)
    state = _port_state(args)
    batches, _ = _batches()
    _StandInGraph.made.clear()
    for i in range(3):
        step(state, _tensors(batches[i]), None, tstep.ScheduleWeights(),
             True, False)
    assert not _StandInGraph.made and not step.graphs and not step.static
    assert state.step == 3
    assert capsys.readouterr().out.count(
        "[capture] eager training step, every configuration: a test's "
        "entry") == 1
