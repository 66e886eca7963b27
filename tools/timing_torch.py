"""Timers for code on a CUDA card, shared by ``chip_smoke.py`` and
``tools/bench_kernel_variants_torch.py`` (each loads this file by its path).

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


PROFILE_ATTEMPTS = 3


def _device_activities(fn, iters, between=None):
    """(name, microseconds) of every device activity of ``iters`` calls of
    ``fn`` as ``torch.profiler`` (CUPTI) records them; ``between`` runs
    before every call. A trace now and then loses records, all of them or
    a part (seen on the first trace of a process, while CUPTI attaches).
    ``fn`` launches the same work on every call, so a whole trace holds a
    multiple of ``iters`` records: a trace that is empty or holds another
    number is taken again, ``PROFILE_ATTEMPTS`` times in all, and then the
    longest one is returned."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    best = []
    for _ in range(PROFILE_ATTEMPTS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                if between is not None:
                    between()
                fn()
            torch.cuda.synchronize()
        acts = [(e.name, e.time_range.end - e.time_range.start)
                for e in prof.events()
                if e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)]
        if len(acts) > len(best):
            best = acts
        if acts and len(acts) % iters == 0:
            break
    return best


def _kernel_durations_us(fn, iters, between=None):
    """Durations in microseconds of the kernels of ``iters`` calls of
    ``fn``, memory copies and memsets left out."""
    return [us for name, us in _device_activities(fn, iters, between)
            if not name.startswith(("Memcpy", "Memset"))]


def device_ms_by_name(fn, names, iters=10, warmup=2):
    """Device milliseconds per call of ``fn``, split by kernel: ``{key:
    ms}`` with one key per entry of ``names`` (the durations of every
    device activity whose name contains it, summed over ``iters`` traced
    calls and divided by ``iters``) and ``"other"`` for the rest of the
    call's device work (memsets, copies, PyTorch's own kernels). For a
    call that launches several kernels, whose parts the CUDA-event time
    of the whole call cannot tell apart."""
    for _ in range(warmup):
        fn()
    out = dict.fromkeys((*names, "other"), 0.0)
    acts = _device_activities(fn, iters)
    if not acts:
        raise RuntimeError("torch.profiler recorded no device activity")
    for name, us in acts:
        key = next((k for k in names if k in name), "other")
        out[key] += us / iters / 1e3
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
