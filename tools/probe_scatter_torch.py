#!/usr/bin/env python3
"""Row-placement floor probes of the PyTorch/CUDA port: the counterpart of
``tools/probe_scatter.py``, with its arguments and its cases.

A. Baselines, the counterparts of the JAX tool's XLA operations, at row
   widths 64 and 256 on random and sorted indices: scatter-add
   (``torch.zeros(K, W).index_add_``), scatter-set (``index_put_``), the
   gather (``index_select``), and ``torch.argsort`` of the keys that any
   sorted-target scheme must pay.
B/C. Kernel K8 (``evdeblurnerf_torch/ops/probe_scatter.py::place_rows``),
   runs of G = 1, 8, 64 and 512 contiguous rows of width 128 placed at
   G-aligned dynamic offsets: the cost of placing a row, by run length,
   on two draws of the same runs. "colliding" is the JAX tool's: offsets
   into K rows, about nine runs a destination at the default size, of
   which only the last lands. "permutation" places every run, at a
   permutation of the N / G destinations of an N-row output: there every
   run is the function's work and ``index_copy_`` (one PyTorch call)
   computes the same function. Each draw's output is held to the
   placement rule (every destination holds, bit for bit, one run aimed at
   it; ``runs_match``); beside the kernel's time stand its plain twin's,
   ``index_copy_``'s on the permutation, and the bound
   (``probe_scatter.bound``: the bytes of the runs that land, read and
   written, and of the offsets over 3.35 TB/s) with the share of it the
   kernels reach on the card. Runs of fewer than 8 rows are copied 32 to a
   warp, longer ones a warp a run (``csrc/probe_scatter.cu``); the copy's
   device time sums whichever ran.

The data are drawn as the JAX tool draws them, with
``np.random.default_rng(0)`` in the same order (A's rows, keys and table
per width, then per G the offsets ``rng.integers(0, (K - G) // G, N // G)
* G`` and the rows), so the colliding draw places the JAX tool's runs at
its offsets; the permutation comes from ``torch.randperm`` seeded with G,
apart from those draws. On the card a time is the mean of CUDA events
over calls queued back to back and, for K8, its kernels' own device time
from ``torch.profiler`` (CUPTI, by kernel name;
``tools/timing_torch.py::device_ms_by_name``), which leaves out the
wrapper's one synchronisation a call (it reads the count of refused
offsets), and is the time printed first unless the profiler kept no whole
trace (then "not measured"); on the CPU the host clock. It prints the JAX
tool's lines (ns/row over the N rows, GB/s of the bytes that land), then
one JSON line.

    python3 tools/probe_scatter_torch.py [--n 2359296] [--k 262144]
        [--skip-xla] [--iters 5] [--tiny] [--device cuda|cpu]

``--tiny`` (N = 8192, K = 4096) takes the place of the JAX tool's
``--interpret``; the probe runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

TOOLS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TOOLS)
for _path in (REPO, TOOLS):
    if _path not in sys.path:
        sys.path.insert(0, _path)

import timing_torch  # noqa: E402

BASELINE_WIDTHS = (64, 256)
GROUPS = (1, 8, 64, 512)
PROBE_W = 128
TINY_N, TINY_K = 8192, 4096


def draw_case(rng, N, K, W, group):
    """(offsets [N / G] int32, rows [N, W] f32) as the JAX tool's
    ``pallas_row_dma`` draws them."""
    offs = np.asarray(rng.integers(0, (K - group) // group, N // group),
                      np.int32) * group
    rows = rng.normal(size=(N, W)).astype(np.float32)
    return offs, rows


def baselines(N, K, W, rng, device, ms):
    """A: the JAX tool's ``xla_baselines`` with PyTorch's operations;
    returns {name: ms}."""
    import torch

    rows = torch.from_numpy(
        rng.normal(size=(N, W)).astype(np.float32)).to(device)
    keys = torch.from_numpy(rng.integers(0, K, N).astype(np.int32)).to(
        device)
    idx_r = keys.long()
    idx_s = torch.sort(idx_r)[0]
    table = torch.from_numpy(
        rng.normal(size=(K, W)).astype(np.float32)).to(device)

    def zeros():
        return torch.zeros(K, W, dtype=torch.float32, device=device)

    res = {
        "scatter_add/random": ms(lambda: zeros().index_add_(0, idx_r, rows)),
        "scatter_add/sorted": ms(lambda: zeros().index_add_(0, idx_s, rows)),
        "scatter_set/random": ms(lambda: zeros().index_put_((idx_r,), rows)),
        "gather/random": ms(lambda: table.index_select(0, idx_r)),
        "argsort_keys": ms(lambda: torch.argsort(keys)),
    }
    for name, t in res.items():
        print(f"  A[{name}] W={W}: {t:7.2f} ms  ({t / N * 1e6:6.2f} ns/row)",
              flush=True)
    return res


KERNEL_PARTS = ("place_rows_claim", "place_rows_copy")


def _device_ms(kernel, iters):
    """{part: ms} of a call of ``kernel`` on the device: the claim launch
    and the copy (``KERNEL_PARTS``), or None where the profiler recorded
    nothing."""
    try:
        split = timing_torch.device_ms_by_name(kernel, KERNEL_PARTS,
                                               iters=iters, warmup=1)
    except RuntimeError as e:
        print(f"  (device time not measured: {e})", flush=True)
        return None
    return {part: split[part] for part in KERNEL_PARTS}


def time_draw(rows, offsets, K, group, device, ms, iters, library):
    """One draw's placement held to the rule and timed; returns its
    record. ``library``: whether ``index_copy_`` computes the same
    function here (no two runs share a destination)."""
    import torch

    from evdeblurnerf_torch.ops import probe_scatter as ps

    N = rows.shape[0]
    out = ps.place_rows(rows, offsets, K, group)
    written = ps.written_runs(offsets, K, group)
    held = bool(torch.equal(ps.runs_match(out, rows, offsets, group),
                            written))
    del out
    landing = int(written.sum())
    rec = dict(runs=N // group, written_runs=landing, collision_rule=held,
               **ps.bound(landing, N // group, group, PROBE_W))

    def kernel():
        return ps.place_rows(rows, offsets, K, group)

    rec["ms"] = ms(kernel)
    rec["plain_ms"] = ms(lambda: ps.place_rows_plain(rows, offsets, K,
                                                     group))
    rec["library_ms"] = None
    if library:
        dst = offsets.long() // group
        runs3 = rows.view(-1, group, PROBE_W)
        lib_out = torch.empty(K // group, group, PROBE_W, device=device)
        rec["library_ms"] = ms(lambda: lib_out.index_copy_(0, dst, runs3))
        del lib_out
    parts = _device_ms(kernel, iters) if device.type == "cuda" else None
    rec["device_ms"] = None if parts is None else sum(parts.values())
    rec["device_ms_parts"] = parts
    t = rec["ms"] if rec["device_ms"] is None else rec["device_ms"]
    rec["ns_per_row"] = t / N * 1e6
    # the bytes the function moves: the runs that land, and the offsets
    rec["gb_per_s"] = rec["bytes"] / (t * 1e-3) / 1e9
    if device.type == "cuda":
        rec["share_of_bound"] = rec["bound_ms"] / t
    return rec


def note(rec, device):
    """What the printed time is: the kernels' own split into the claim
    and the copy, or no device time."""
    parts = rec["device_ms_parts"]
    if parts is not None:
        return (f"; claim {parts['place_rows_claim']:.3f} ms, copy "
                f"{parts['place_rows_copy']:.3f} ms")
    return ", device time not measured" if device.type == "cuda" else ""


def probe_case(N, K, group, rng, device, ms, iters):
    """B/C: K8 at runs of ``group`` rows, on the JAX tool's draw into K
    rows (colliding: only a destination's last run lands) and on a
    permutation of the same runs into N rows (every run lands); returns
    {draw: record, "collision_rule": both held}."""
    import torch

    offs, rows_np = draw_case(rng, N, K, PROBE_W, group)
    rows = torch.from_numpy(rows_np).to(device)
    del rows_np
    perm = torch.randperm(N // group, generator=torch.Generator()
                          .manual_seed(group)).to(torch.int32) * group
    case = {}
    for draw, offsets, out_rows in (
            ("colliding", torch.from_numpy(offs), K),
            ("permutation", perm, N)):
        rec = time_draw(rows, offsets.to(device), out_rows, group, device,
                        ms, iters, library=draw == "permutation")
        case[draw] = rec
        t = rec["ms"] if rec["device_ms"] is None else rec["device_ms"]
        lib = ("" if rec["library_ms"] is None
               else f", index_copy_ {rec['library_ms']:.3f} ms")
        print(f"  B/C[group={group:4d}] W={PROBE_W} {draw}: {t:7.2f} ms "
              f"({rec['ns_per_row']:6.2f} ns/row, {rec['gb_per_s']:6.1f} "
              f"GB/s of the runs that land"
              f"{note(rec, device)}); "
              f"back to back {rec['ms']:.3f} ms, plain {rec['plain_ms']:.3f} "
              f"ms{lib}, bound {rec['bound_ms']:.4f} ms"
              + (f" ({100 * rec['share_of_bound']:.1f}% of it)"
                 if "share_of_bound" in rec else "") + "; "
              f"{rec['written_runs']} of {out_rows // group} destination "
              f"runs written, collision rule "
              f"{'held' if rec['collision_rule'] else 'BROKEN'}",
              flush=True)
    case["collision_rule"] = all(case[d]["collision_rule"]
                                 for d in ("colliding", "permutation"))
    return case


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=2359296)   # fine-pass rows
    ap.add_argument("--k", type=int, default=262144)    # a 512^2 plane
    ap.add_argument("--skip-xla", action="store_true",
                    help="skip the A baselines, as the JAX tool's flag")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--tiny", action="store_true",
                    help=f"N = {TINY_N}, K = {TINY_K}")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import torch

    from evdeblurnerf_torch import kernels

    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("probe_scatter_torch: no CUDA card "
                             "(torch.cuda.is_available() is False); "
                             "--device cpu runs the plain twin")
        device = torch.device("cuda", torch.cuda.current_device()
                              if device.index is None else device.index)
        where = timing_torch.card_line()
    else:
        where = "cpu"
    N, K = (TINY_N, TINY_K) if args.tiny else (args.n, args.k)
    rng = np.random.default_rng(0)

    def ms(fn):
        return timing_torch.mean_ms(fn, device, args.iters)

    print(f"probe_scatter_torch: N={N} rows, K={K} table rows, device="
          f"{where}", flush=True)
    result = dict(tool="probe_scatter_torch", device=where, N=N, K=K,
                  W=PROBE_W, baselines={}, cases={})
    if not args.skip_xla:
        for W in BASELINE_WIDTHS:
            result["baselines"][str(W)] = baselines(N, K, W, rng, device, ms)
    for group in GROUPS:
        result["cases"][str(group)] = probe_case(N, K, group, rng, device,
                                                 ms, args.iters)
    result["launches"] = kernels.LAUNCHES["place_rows"]
    print(json.dumps(result), flush=True)
    broken = [g for g, c in result["cases"].items()
              if not c["collision_rule"]]
    if broken:
        raise SystemExit(f"probe_scatter_torch: the placement rule broke at "
                         f"G = {', '.join(broken)}")
    return result


if __name__ == "__main__":
    main()
