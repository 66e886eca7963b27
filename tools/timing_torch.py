"""Timers for code on a CUDA card, shared by ``chip_smoke.py`` and
``tools/bench_kernel_variants_torch.py`` (each loads this file by its path)
and the probes ``tools/probe_{scatter,onehot}_torch.py`` (which import it).

:func:`cuda_ms` is the usual CUDA-event mean over calls queued back to
back. A kernel of a few microseconds finishes before the host has queued
the next call, so that mean follows the host; :func:`device_and_host`
reads such a kernel's own duration on the device, with its inputs warm in
L2 and after an L2 flush, and the host's cost per call apart.
:func:`device_ms_by_name` splits the device time of a call that launches
several kernels by kernel name.
"""

import time

L2_FLUSH_BYTES = 256 * 2 ** 20      # five times the H100's 50 MB L2
HBM_BYTES_PER_S = 3.35e12           # H100 SXM, NVIDIA's data sheet


def cuda_ms(fn, iters=20, warmup=3):
    """Mean milliseconds of ``fn`` over ``iters`` calls between two CUDA
    events, after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def mean_ms(fn, device, iters=20, warmup=1):
    """:func:`cuda_ms` on a CUDA ``device``; elsewhere the host clock's
    mean over ``iters`` calls after ``warmup``, a CPU run's time."""
    if device.type == "cuda":
        return cuda_ms(fn, iters, warmup)
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def card_line():
    """The card's name and power limit, as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them."""
    import subprocess

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


PROFILE_ATTEMPTS = 5
PROFILE_PAD_S = 0.02    # idle time at each end of a trace's window, x5 a retry


def _device_activities(fn, iters, between=None):
    """(name, microseconds) of every device activity of ``iters`` calls of
    ``fn`` as ``torch.profiler`` (CUPTI) records them; ``between`` runs
    before every call.

    The profiler keeps only device records that fall inside its window on
    the host's clock, and on the H100 machines the records' timestamps
    stray from that clock by milliseconds now and then (a kernel read as
    starting before its launch): a window that ends with the last kernel
    then loses the records at its edges, or all of them when the calls are
    short. So the window holds ``PROFILE_PAD_S`` of idle time before the
    first call and after the calls have synchronised. ``fn`` launches the
    same work on every call, so a whole trace holds a multiple of
    ``iters`` records: a trace that is empty or holds another number is
    taken again with five times the padding, ``PROFILE_ATTEMPTS`` times in
    all, each retry reported on stderr. A count that a retry repeats is
    the calls' own (some calls launch a little more work once) and is
    kept; else the longest trace is returned."""
    import sys

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    best = []
    for attempt in range(PROFILE_ATTEMPTS):
        pad = PROFILE_PAD_S * 5 ** attempt
        if attempt:
            print(f"timing_torch: a trace of {iters} calls kept {len(acts)} "
                  f"device records; attempt {attempt + 1} of "
                  f"{PROFILE_ATTEMPTS} with {pad:.2f} s of padding",
                  file=sys.stderr, flush=True)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            for _ in range(iters):
                if between is not None:
                    between()
                fn()
            torch.cuda.synchronize()
            time.sleep(pad)
        acts = [(e.name, e.time_range.end - e.time_range.start)
                for e in prof.events()
                if e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)]
        repeated = bool(acts) and len(acts) == len(best)
        if len(acts) > len(best):
            best = acts
        if acts and (len(acts) % iters == 0 or repeated):
            break
    return best


def _kernel_durations_us(fn, iters, between=None):
    """Durations in microseconds of the kernels of ``iters`` calls of
    ``fn``, memory copies and memsets left out."""
    return [us for name, us in _device_activities(fn, iters, between)
            if not name.startswith(("Memcpy", "Memset"))]


def device_ms_by_name(fn, names, iters=10, warmup=2):
    """Device milliseconds per call of ``fn``, split by kernel: ``{key:
    ms}`` with one key per entry of ``names`` (the device activities whose
    name contains it) and ``"other"`` for the rest of the call's device
    work (memsets, copies, PyTorch's own kernels). For a call that
    launches several kernels, whose parts the CUDA-event time of the whole
    call cannot tell apart, and for a kernel of a few microseconds, whose
    CUDA-event time follows the host.

    Each distinct activity name counts its mean duration times the times
    it occurs a call: its records in a trace of ``iters`` calls over
    ``iters``, rounded up. A whole trace reads the sum over the calls
    divided by ``iters``; a trace that lost fewer than ``iters`` records
    of a name (:func:`_device_activities` returns the longest of its
    attempts when none was whole) still reads that name's time, where the
    sum would read low."""
    for _ in range(warmup):
        fn()
    acts = _device_activities(fn, iters)
    if not acts:
        raise RuntimeError("torch.profiler recorded no device activity")
    by_name = {}
    for name, us in acts:
        by_name.setdefault(name, []).append(us)
    out = dict.fromkeys((*names, "other"), 0.0)
    for name, durations in by_name.items():
        key = next((k for k in names if k in name), "other")
        per_call = -(-len(durations) // iters)
        out[key] += sum(durations) / len(durations) * per_call / 1e3
    return out


def device_and_host(fn, iters=50, warmup=5):
    """(device ms, device ms from a cold L2, host microseconds per call)
    of ``fn``, whose device work must be kernels only (no memory copy).

    Device: the kernel durations of ``iters`` calls from
    ``torch.profiler``, their mean times the kernels a call; the calls
    run back to back on the same tensors, so at sizes under the L2's the
    inputs are served from it. Cold: the same with a device-to-device copy of
    ``L2_FLUSH_BYTES`` before every call, which leaves nothing of the
    call's tensors in L2; the copy's own time is not counted. Host: the
    wall time of the Python call with no synchronise, per call over
    ``iters`` untraced calls on an idle device: the median of five such
    batches, since the machine's cores are shared."""
    import torch

    for _ in range(warmup):
        fn()
    batches = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        batches.append(1e6 * (time.perf_counter() - t0) / iters)
    host_us = sorted(batches)[2]
    warm = _kernel_durations_us(fn, iters)
    if not warm:
        raise RuntimeError("torch.profiler recorded no device activity")
    src = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    cold = _kernel_durations_us(fn, iters, between=lambda: dst.copy_(src))
    # the profiler now and then drops records, so the two counts may
    # differ; a flush that ran as a kernel adds iters to the flushed run
    if len(cold) - len(warm) >= iters // 2:
        raise RuntimeError(
            f"the flushed run recorded {len(cold)} kernels, the warm run "
            f"{len(warm)}: the L2 flush is not a plain memory copy here")
    per_call = max(1, round(len(warm) / iters))

    def ms(durations):      # mean kernel x kernels a call
        return sum(durations) / len(durations) * per_call / 1e3

    return ms(warm), ms(cold), host_us
