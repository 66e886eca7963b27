"""K8 and K9 of the port on the CPU: the plain twins of ``place_rows`` and
``onehot_lerp`` against the two Pallas probes in interpret mode
(``tools/probe_scatter.py::_dma_kernel``, ``tools/probe_onehot.py::
make_kernel``), the wrappers' checks, the two probe tools at their tiny
sizes, and the rank tool's device default.

The JAX tools time their kernels and return no output, so each test builds
the tool's ``pl.pallas_call`` from its kernel, with the tool's specs and
``interpret=True``. Tolerances: K8 moves bits, so written rows are equal
bitwise; rows no run targets are undefined on both sides (NaN in interpret
mode, ``torch.empty`` in the port) and not compared. K9 over a bf16 tile
multiplies bf16 values exactly in f32 and adds two products, so it is
bitwise; over an f32 tile the two sides round the products and their sum
in other orders: within 1e-6 of the largest magnitude.
"""

import functools
import importlib.util
import inspect
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from evdeblurnerf_torch import kernels
from evdeblurnerf_torch.ops import probe_onehot as po
from evdeblurnerf_torch.ops import probe_scatter as ps

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")
GROUPS = (1, 8, 64, 512)
# the JAX tool's grid step and its SMEM padding of the offsets
ROWS_PER_BLOCK = 4096
K9_F32_REL_TOL = 1e-6
TINY_K = 4096       # the scatter tool's --tiny output rows


def _tool(name):
    """``tools/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.cache
def _jax_tool(name):
    return _tool(name)


def _pallas_place(offsets, rows, K, group):
    """``probe_scatter.pallas_row_dma``'s call in interpret mode: the flat
    offsets padded per grid step, as the tool pads them."""
    N, W = rows.shape
    n_blocks = N // ROWS_PER_BLOCK
    per_block = ROWS_PER_BLOCK // group
    pad = -(-per_block // 1024) * 1024
    padded = np.pad(offsets.reshape(n_blocks, per_block),
                    ((0, 0), (0, pad - per_block))).reshape(-1)
    fn = pl.pallas_call(
        functools.partial(_jax_tool("probe_scatter")._dma_kernel,
                          rows_per_block=ROWS_PER_BLOCK, group=group),
        grid=(n_blocks,),
        in_specs=[pl.BlockSpec((pad,), lambda i: (i,),
                               memory_space=pltpu.SMEM),
                  pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec(memory_space=pl.ANY),
        scratch_shapes=[pltpu.SemaphoreType.DMA((8,))],
        out_shape=jax.ShapeDtypeStruct((K, W), jnp.float32),
        interpret=True,
        compiler_params=pltpu.CompilerParams(
            dimension_semantics=("arbitrary",)))
    return np.asarray(fn(jnp.asarray(padded), jnp.asarray(rows)))


@pytest.mark.parametrize("draw", ["permutation", "colliding"])
@pytest.mark.parametrize("group", GROUPS)
def test_place_rows_twin_matches_pallas(group, draw):
    """Written rows bitwise equal to the Pallas kernel's, the same set of
    them, and each destination one whole run aimed at it; collision-free
    offsets (a permutation of the destination runs) and the JAX tool's
    colliding draw."""
    N, K, W = 8192, 16384, 128
    rng = np.random.default_rng(group)
    if draw == "permutation":
        offs = (rng.permutation(K // group)[:N // group] * group).astype(
            np.int32)
    else:
        offs = np.asarray(rng.integers(0, (K - group) // group, N // group),
                          np.int32) * group
    rows = rng.normal(size=(N, W)).astype(np.float32)
    want = _pallas_place(offs, rows, K, group)
    offsets, rows_t = torch.from_numpy(offs), torch.from_numpy(rows)
    got = ps.place_rows(rows_t, offsets, K, group)
    written = ps.written_runs(offsets, K, group)
    rows_written = written.repeat_interleave(group).numpy()
    # the Pallas kernel leaves rows no run targets uninitialised (NaN here)
    assert np.array_equal(~np.isnan(want).any(1), rows_written)
    np.testing.assert_array_equal(got.numpy()[rows_written],
                                  want[rows_written])
    assert torch.equal(ps.runs_match(got, rows_t, offsets, group), written)
    assert torch.equal(
        ps.runs_match(torch.from_numpy(want.copy()), rows_t, offsets, group),
        written)
    if draw == "colliding":
        assert int(written.sum()) < N // group      # runs did collide


@pytest.mark.parametrize("dt", ["bf16", "f32"])
@pytest.mark.parametrize("K", [256, 1024])
def test_onehot_twin_matches_pallas(K, dt):
    """The twin against ``probe_onehot.make_kernel`` in interpret mode on
    two blocks of 256 points, C = 64."""
    blk, nb, C = 256, 2, 64
    rng = np.random.default_rng(K)
    idx = rng.integers(0, K - 1, (nb, blk, 1)).astype(np.int32)
    frac = rng.uniform(0, 1, (nb, blk, 1)).astype(np.float32)
    tile = rng.normal(size=(K, C)).astype(np.float32)
    jdt = jnp.bfloat16 if dt == "bf16" else jnp.float32
    fn = pl.pallas_call(
        _jax_tool("probe_onehot").make_kernel(K, C, jdt, blk),
        grid=(nb,),
        in_specs=[pl.BlockSpec((1, blk, 1), lambda b: (b, 0, 0)),
                  pl.BlockSpec((1, blk, 1), lambda b: (b, 0, 0)),
                  pl.BlockSpec((K, C), lambda b: (0, 0))],
        out_specs=pl.BlockSpec((blk, C), lambda b: (b, 0)),
        out_shape=jax.ShapeDtypeStruct((nb * blk, C), jnp.float32),
        interpret=True)
    want = np.asarray(fn(jnp.asarray(idx), jnp.asarray(frac),
                         jnp.asarray(tile, jdt)))
    ttile = torch.from_numpy(tile)
    if dt == "bf16":
        ttile = ttile.to(torch.bfloat16)
    got = po.onehot_lerp(torch.from_numpy(idx.reshape(-1)),
                         torch.from_numpy(frac.reshape(-1)), ttile).numpy()
    if dt == "bf16":
        np.testing.assert_array_equal(got, want)
    else:
        scale = float(np.abs(want).max())
        assert float(np.abs(got - want).max()) <= K9_F32_REL_TOL * scale


def test_onehot_twin_chunks_alike(monkeypatch):
    """The twin builds its one-hot a chunk of rows at a time: a chunk
    boundary inside the points changes no bit."""
    rng = np.random.default_rng(3)
    K, N = 64, 1000
    idx = torch.from_numpy(rng.integers(0, K - 1, N).astype(np.int32))
    frac = torch.from_numpy(rng.uniform(0, 1, N).astype(np.float32))
    tile = torch.from_numpy(rng.normal(size=(K, 32)).astype(np.float32))
    whole = po.onehot_lerp_plain(idx, frac, tile)
    monkeypatch.setattr(po, "PLAIN_CHUNK_ELEMS", K * 7)
    assert torch.equal(po.onehot_lerp_plain(idx, frac, tile), whole)


def test_wrappers_take_the_twin_on_the_cpu():
    """CPU tensors run the twins and count no launch."""
    before = dict(kernels.LAUNCHES)
    rows = torch.randn(64, 8)
    # runs 0 and 3 collide at row 24; rows 32-39 are no run's
    offsets = torch.tensor([24, 0, 8, 24, 56, 40, 16, 48], dtype=torch.int32)
    got = ps.place_rows(rows, offsets, 64, 8)
    written = ps.written_runs(offsets, 64, 8).repeat_interleave(8)
    assert int(written.sum()) == 56
    assert torch.equal(got[written],
                       ps.place_rows_plain(rows, offsets, 64, 8)[written])
    assert torch.equal(got[24:32], rows[24:32])
    idx = torch.tensor([0, 5, 14], dtype=torch.int32)
    frac = torch.tensor([0.25, 0.5, 1.0])
    tile = torch.randn(16, 16)
    got = po.onehot_lerp(idx, frac, tile)
    want = torch.stack([0.75 * tile[0] + 0.25 * tile[1],
                        0.5 * tile[5] + 0.5 * tile[6], tile[15]])
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    assert dict(kernels.LAUNCHES) == before


def test_place_rows_twin_keeps_the_last_run():
    """Colliding runs: the run of the highest index lands, whole."""
    rows = torch.arange(4 * 8, dtype=torch.float32).reshape(8, 4)
    offsets = torch.tensor([2, 0, 2, 2], dtype=torch.int32)
    out = ps.place_rows(rows, offsets, 4, 2)
    assert torch.equal(out[0:2], rows[2:4])
    assert torch.equal(out[2:4], rows[6:8])


@pytest.mark.parametrize("case", [
    "rows_f64", "rows_1d", "offsets_i64", "n_not_multiple", "k_not_multiple",
    "w_not_multiple_of_4", "offsets_count", "offset_unaligned",
    "offset_negative", "offset_past_end"])
def test_place_rows_raises(case):
    rows = torch.randn(32, 8)
    offsets = torch.tensor([0, 8, 16, 24], dtype=torch.int32)
    K, G = 64, 8
    if case == "rows_f64":
        rows = rows.double()
    elif case == "rows_1d":
        rows = rows.reshape(-1)
    elif case == "offsets_i64":
        offsets = offsets.long()
    elif case == "n_not_multiple":
        rows = torch.randn(30, 8)
    elif case == "k_not_multiple":
        K = 60
    elif case == "w_not_multiple_of_4":
        rows = torch.randn(32, 6)
    elif case == "offsets_count":
        offsets = offsets[:3]
    elif case == "offset_unaligned":
        offsets[1] = 9
    elif case == "offset_negative":
        offsets[1] = -8
    else:
        offsets[1] = 64
    with pytest.raises((TypeError, ValueError)):
        ps.place_rows(rows, offsets, K, G)


@pytest.mark.parametrize("case", [
    "idx_i64", "idx_2d", "frac_f64", "frac_length", "tile_f16", "tile_1d",
    "channels", "one_row"])
def test_onehot_lerp_raises(case):
    idx = torch.tensor([0, 1, 2], dtype=torch.int32)
    frac = torch.rand(3)
    tile = torch.randn(8, 32)
    if case == "idx_i64":
        idx = idx.long()
    elif case == "idx_2d":
        idx = idx[:, None]
    elif case == "frac_f64":
        frac = frac.double()
    elif case == "frac_length":
        frac = frac[:2]
    elif case == "tile_f16":
        tile = tile.half()
    elif case == "tile_1d":
        tile = tile[0]
    elif case == "channels":
        tile = torch.randn(8, 24)
    else:
        tile = torch.randn(1, 32)
    with pytest.raises((TypeError, ValueError)):
        po.onehot_lerp(idx, frac, tile)


def test_scatter_tool_draws_as_the_jax_tool(monkeypatch, capsys):
    """The port's tool and the JAX tool, both at their tiny size with the
    baselines, leave the generator in the same state: the same draws in
    the same order, so the same offsets. Timing is stubbed out on the JAX
    side (its kernels run once, in interpret mode)."""
    jtool = _tool("probe_scatter")
    made = []
    real = np.random.default_rng

    def recording_rng(seed):
        made.append(real(seed))
        return made[-1]

    monkeypatch.setattr(np.random, "default_rng", recording_rng)
    monkeypatch.setattr(jtool, "timed", lambda fn, *a, iters=5: (
        jtool._sync(fn(*a)), 1.0)[1])
    monkeypatch.setattr(sys, "argv", ["probe_scatter.py", "--interpret"])
    jtool.main()
    _tool("probe_scatter_torch").main(["--device", "cpu", "--tiny",
                                       "--iters", "1"])
    capsys.readouterr()
    assert len(made) == 2
    assert made[0].bit_generator.state == made[1].bit_generator.state


@pytest.mark.parametrize("name", ["probe_scatter_torch",
                                  "probe_onehot_torch"])
def test_probe_tool_runs_on_the_cpu(name, capsys):
    """Each probe tool at its tiny size on the CPU: the placement rule and
    the twin's bound hold in every case, no kernel launches, one JSON
    line last; without ``--device`` it asks for the card."""
    import json

    tool = _tool(name)
    assert tool.parse_args([]).device == "cuda"
    result = tool.main(["--device", "cpu", "--tiny", "--iters", "1"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == json.loads(json.dumps(result))
    assert result["device"] == "cpu"
    if name == "probe_scatter_torch":
        assert sorted(result["cases"], key=int) == [str(g) for g in GROUPS]
        assert all(c["collision_rule"] for c in result["cases"].values())
        for group, case in result["cases"].items():
            perm, coll = case["permutation"], case["colliding"]
            # every run lands on the permutation, at most one a
            # destination on the JAX tool's draw; each bound counts those
            assert perm["written_runs"] == perm["runs"]
            assert coll["written_runs"] <= TINY_K // int(group)
            for rec in (perm, coll):
                assert rec["bytes"] == (2 * rec["written_runs"] * int(group)
                                        * 128 * 4 + rec["runs"] * 4)
            assert perm["library_ms"] is not None
            assert coll["library_ms"] is None
        assert set(result["baselines"]) == {"64", "256"}
        assert result["launches"] == 0
    else:
        assert len(result["cases"]) == 6
        assert all(c["held"] for c in result["cases"].values())
        assert result["launches"] == {"onehot_lerp": 0,
                                      "onehot_lerp_bf16": 0}


def test_device_ms_by_name_reads_a_trace_that_lost_records(monkeypatch):
    """``tools/timing_torch.py::device_ms_by_name`` reads each kernel name
    as its mean duration times its launches a call: a whole trace reads
    the sum over the calls, and one that lost records (the profiler's
    fault that read K9 at 7.63 for a 9.50 ms kernel) reads the same."""
    timing = _tool("timing_torch")
    whole = [("place_rows_claim", 1.0), ("place_rows_copy", 7.0),
             ("Memset (Device)", 0.5)] * 10 + [("onehot_f32", 9.5e3)] * 10
    lost = [a for i, a in enumerate(whole) if i not in (0, 4, 31, 35)]
    for trace in (whole, lost):
        monkeypatch.setattr(timing, "_device_activities",
                            lambda fn, iters, trace=trace: trace)
        got = timing.device_ms_by_name(lambda: None,
                                       ("place_rows", "onehot"), iters=10)
        assert got == pytest.approx({"place_rows": 8e-3, "onehot": 9.5,
                                     "other": 0.5e-3})


@pytest.mark.parametrize("counts, kept", [
    ((4,), 4), ((0, 0, 4), 4), ((0, 0, 0, 0, 0), 0), ((3, 3), 3),
    ((0, 3, 5, 5), 5), ((1, 3, 5, 7, 9), 9)])
def test_device_activities_pads_its_window_after_a_bad_trace(
        monkeypatch, counts, kept):
    """``tools/timing_torch.py::_device_activities`` holds idle time at
    both ends of the profiler's window, inside it, so that device records
    whose timestamps stray from the host's clock stay in. A trace of two
    calls that kept no record or an odd count is taken again with five
    times the padding, until a whole trace, a count that repeats (the
    calls' own), or ``PROFILE_ATTEMPTS``, and then the longest is
    returned. ``counts``: the records each attempt keeps."""
    import torch.profiler
    from torch.autograd import DeviceType

    timing = _tool("timing_torch")
    log = []

    class Event:
        def __init__(self, name):
            self.name, self.device_type = name, DeviceType.CUDA
            self.time_range = type("Range", (), dict(start=0.0, end=2.0))

    class FakeProfile:
        def __init__(self, activities):
            self.attempt = log.count("enter")

        def __enter__(self):
            log.append("enter")
            return self

        def __exit__(self, *exc):
            log.append("exit")
            return False

        def events(self):
            return [Event("k")] * counts[self.attempt]

    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(timing.time, "sleep", log.append)
    got = timing._device_activities(lambda: log.append("call"), 2)
    tried = len(counts)
    assert tried <= timing.PROFILE_ATTEMPTS
    one = ["enter", "pad", "call", "call", "pad", "exit"]
    assert [("pad" if isinstance(e, float) else e) for e in log] == \
        one * tried
    pads = [e for e in log if isinstance(e, float)]
    assert pads == [timing.PROFILE_PAD_S * 5 ** (i // 2)
                    for i in range(2 * tried)]
    assert got == [("k", 2.0)] * kept


def test_parallel_check_defaults_to_the_card():
    """``tools/parallel_check_torch.py`` runs its ranks on the card unless
    the caller asks for the CPU: ``main``'s ``--device`` and ``spawn``'s
    ``device`` both default to ``cuda``."""
    pc = _tool("parallel_check_torch")
    args = pc.parse_args(["setup.pt", "out.pt", "--rank", "0", "--world",
                          "1", "--port", "1"])
    assert args.device == "cuda"
    assert inspect.signature(pc.spawn).parameters["device"].default == "cuda"


def test_probe_files_import_no_jax_tool():
    """The port's probe modules and tools import neither jax nor the JAX
    package nor the JAX probes they replace."""
    files = [os.path.join(REPO, "evdeblurnerf_torch", "ops", f)
             for f in ("probe_scatter.py", "probe_onehot.py")]
    files += [os.path.join(TOOLS, f) for f in ("probe_scatter_torch.py",
                                               "probe_onehot_torch.py")]
    for path in files:
        with open(path) as f:
            text = f.read()
        assert not re.search(
            r"^\s*(import|from)\s+(jax|evdeblurnerf_tpu|probe_scatter|"
            r"probe_onehot|tools\.probe_scatter|tools\.probe_onehot)\b",
            text, re.M), path


def test_variant_bench_cases_are_the_probes():
    """``tools/bench_kernel_variants_torch.py --kernels k8,k9`` times the
    probes' own cases, so that two checkouts read in one call compare
    what the tools report."""
    bench = _tool("bench_kernel_variants_torch")
    scatter = _tool("probe_scatter_torch")
    onehot = _tool("probe_onehot_torch")
    defaults = scatter.parse_args([])
    assert (bench.K8_N, bench.K8_K, bench.K8_W) == (defaults.n, defaults.k,
                                                    scatter.PROBE_W)
    assert bench.K8_CASES == tuple((g, d) for g in scatter.GROUPS
                                   for d in ("colliding", "permutation"))
    assert (bench.K9_N, bench.K9_C) == (onehot.N_POINTS, onehot.CHANNELS)
    assert bench.K9_CASES == tuple((K, dt) for K in onehot.TILE_ROWS
                                   for dt in onehot.DTYPES)


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("C", po.CHANNELS)
def test_onehot_plan_pads_whole_stages(C, bf16):
    """The kernel's geometry (the twin of ``Plan`` in
    ``csrc/probe_onehot.cu``): the packed tile is whole stages of 128-byte
    swizzled rows, at least K rows, one plane a bf16 tile and two (TF32 hi,
    lo) an f32 one; rows a block in whole m64 tiles; the L2 bytes one pass
    over the packed tile a cluster's group of rows."""
    elem, planes = (2, 1) if bf16 else (4, 2)
    for K in (2, 63, 64, 65, 256, 1000, 4096):
        p = po.plan(K, C, bf16)
        assert p["stage_k"] * elem % po.SWIZZLE_BYTES == 0
        assert p["stages"] * p["stage_k"] >= K > (p["stages"] - 1) * \
            p["stage_k"]
        assert p["packed_bytes"] == p["stages"] * p["stage_k"] * C * elem * \
            planes
        assert p["packed_bytes"] // p["stages"] >= po.STAGE_TARGET
        assert p["rows"] % 64 == 0
        assert p["cluster_rows"] == po.CLUSTER * p["rows"]
        N = 3 * p["cluster_rows"] + 1
        assert po.l2_tile_bytes(N, K, C, bf16) == 4 * p["packed_bytes"]


def test_probe_bounds_are_the_recorded_ones():
    """The bounds the tools and ``chip_smoke.py`` hold the probes to, at
    the probes' default sizes (bytes over 3.35 TB/s, K9's operations over
    989 TFLOP/s in bf16 and 495 / 3 in f32, the larger)."""
    expect = {(256, True): (0.0826, "bytes"), (1024, True): (0.1390,
                                                             "operations"),
              (4096, True): (0.5559, "operations"),
              (256, False): (0.2082, "operations"),
              (1024, False): (0.8330, "operations"),
              (4096, False): (3.3319, "operations")}
    for (K, bf16), (ms, by) in expect.items():
        b = po.bound(1_048_576, K, 64, bf16)
        assert b["flops"] == 2 * 1_048_576 * K * 64
        assert round(b["bound_ms"], 4) == ms and b["bound_by"] == by
    perm = ps.bound(2_359_296, 2_359_296, 1, 128)
    assert perm["bytes"] == 2 * 2_359_296 * 512 + 2_359_296 * 4
    assert round(perm["bound_ms"], 4) == 0.7240
    assert round(ps.bound(262_104, 2_359_296, 1, 128)["bound_ms"], 4) == \
        0.0829


def test_tf32_split_rounds_to_nearest_ties_away():
    """The kernel's TF32 split of an f32 value: hi keeps 10 mantissa bits,
    rounded to nearest with ties away from zero (``cvt.rna``), lo the
    rest rounded the same way."""
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2 ** -23,
                      3.0, -0.0], dtype=torch.float32)
    hi, lo = po.tf32_split(x)
    assert hi.tolist() == [1 + ulp, -(1 + ulp), 1.0, 3.0, 0.0]
    g = torch.Generator().manual_seed(0)
    v = torch.randn(100_000, generator=g) * 10 ** torch.randint(
        -3, 4, (100_000,), generator=g).float()
    hi, lo = po.tf32_split(v)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    assert ((v - hi).abs() <= v.abs() * 2.0 ** -11).all()
    assert ((v.double() - hi.double() - lo.double()).abs()
            <= v.abs().double() * 2.0 ** -21).all()


def test_three_tf32_products_hold_the_f32_bound():
    """The f32 kernel's arithmetic, three TF32 products a product (lo*hi +
    hi*lo + hi*hi, exact in the tensor core's products), stays within the
    1e-6 of the largest magnitude that the card holds K9 to, at the
    probe's tile width and a K of its cases."""
    rng = np.random.default_rng(0)
    N, K, C = 4096, 1024, 64
    idx = torch.from_numpy(rng.integers(0, K - 1, N).astype(np.int32))
    frac = torch.from_numpy(rng.uniform(0, 1, N).astype(np.float32))
    tile = torch.from_numpy(rng.normal(size=(K, C)).astype(np.float32))
    want = po.onehot_lerp_plain(idx, frac, tile).double()
    t_hi, t_lo = (p.double() for p in po.tf32_split(tile))
    got = torch.zeros(N, C, dtype=torch.float64)
    for corner, w in ((idx, 1.0 - frac), (idx + 1, frac)):
        w_hi, w_lo = (p.double()[:, None] for p in po.tf32_split(w))
        rows_hi, rows_lo = t_hi[corner.long()], t_lo[corner.long()]
        got += w_lo * rows_hi + w_hi * rows_lo + w_hi * rows_hi
    assert float((got - want).abs().max()) <= \
        K9_F32_REL_TOL * float(want.abs().max())
