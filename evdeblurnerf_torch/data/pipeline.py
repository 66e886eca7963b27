"""Host->device input pipeline: endless samplers + threaded prefetch.

Counterpart of ``evdeblurnerf_tpu/data/pipeline.py`` (which replaces the
reference's DataLoader worker processes + pin_memory +
``.cuda(non_blocking=True)``, ref: run_nerf.py:86-108, data/loader.py:16-22).
Batch assembly here is pure vectorized numpy (dataset ``batch()``), cheap
enough that one background thread that stages the next batches ahead of
time keeps the card fed; the train loop never blocks on host batch
construction.

On a CUDA device the worker stages every array of a batch in pinned host
memory and copies it with ``non_blocking=True`` on a side stream of its
own; the consumer's stream waits on the event recorded after the copies
before it reads the tensors. Two lifetimes need care with a side stream:

* a pinned buffer must not be reused before its copy finished — torch's
  caching host allocator holds a freed pinned block back until the copies
  that read it are done;
* a device tensor allocated on the side stream must not be handed back to
  the allocator while the consumer's stream still reads it —
  ``Tensor.record_stream`` tells the allocator of that second stream.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch


def endless(sampler_factory: Callable[[], Iterator]):
    """Loop a (re-created) epoch sampler forever (ref: data/loader.py:16-22).

    ``sampler_factory``: zero-arg callable returning a fresh epoch iterator.
    """
    while True:
        it = sampler_factory()
        if it is None:
            yield None
            continue
        produced = False
        for x in it:
            produced = True
            yield x
        if not produced:
            # an empty epoch would otherwise busy-spin this loop forever
            # with the consumer blocked (e.g. batch size > dataset size)
            raise ValueError(
                "epoch sampler produced no batches — is the batch size "
                "(N_rand / events_N_rand) larger than the dataset?")


class Prefetcher:
    """Background-thread batch prefetcher with device placement.

    ``make_batch``: zero-arg callable assembling the next host batch (a
    dict of numpy arrays). ``next()`` returns a dict of tensors on
    ``device``; on a CUDA device they are already copied or in flight, and
    the current stream has been told to wait for them. At most
    ``buffer_size`` batches wait in the queue. An exception in the worker
    is re-raised by ``next()``; ``close()`` stops the worker.
    """

    def __init__(self, make_batch: Callable[[], dict], buffer_size: int = 2,
                 device="cpu"):
        self._make_batch = make_batch
        self._device = torch.device(device)
        self._on_card = self._device.type == "cuda"
        # made here, not in the worker: a failure to reach the card shows
        # in the caller
        self._stream = (torch.cuda.Stream(self._device) if self._on_card
                        else None)
        self._queue: "queue.Queue" = queue.Queue(maxsize=buffer_size)
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _place(self, batch: Dict[str, np.ndarray]):
        host = {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in batch.items()}
        if not self._on_card:
            return host, None
        with torch.cuda.stream(self._stream):
            out = {k: v.pin_memory().to(self._device, non_blocking=True)
                   for k, v in host.items()}
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return out, ready

    def _worker(self):
        try:
            while not self._stop.is_set():
                item = self._place(self._make_batch())
                while not self._stop.is_set():
                    try:
                        self._queue.put(item, timeout=0.5)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:   # surfaced on the consumer side
            self._error = e

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        while True:
            if self._error is not None:
                raise self._error
            try:
                batch, ready = self._queue.get(timeout=1.0)
                break
            except queue.Empty:
                if not self._thread.is_alive() and self._error is None:
                    raise StopIteration
                continue
        if ready is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(ready)
            for v in batch.values():
                v.record_stream(stream)
        return batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
