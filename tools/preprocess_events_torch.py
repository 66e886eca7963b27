#!/usr/bin/env python3
"""Offline event-stream preprocessing for the PyTorch port: the counterpart
of ``tools/preprocess_events.py``, with the same arguments, steps and
output files.

It builds the per-pixel successor graph ahead of training and writes it as
the ``events_successor.npz`` sidecar beside the event file
(``successor_idx``, ``num_successors``, ``latest_seen``, ``first_seen``,
``n_events``); the port's loader (``evdeblurnerf_torch/data/events.py``)
reads it in place of the start-up scan when its ``n_events`` matches the
stream it loaded. Optionally it writes the polarity accumulations:
count-based every N (``events_accum_{N}.npy``) and on the grid of every
N+1 image timestamps (``events_accum_t{N}.npz``: ``events``,
``zero_events``; ref: utils/events.py:123-218, utilities the reference
defines but never calls in training). The events are filtered to the
known-pose time range of ``all_timestamps.npy``, as the loader filters
them.

It imports the port alone, neither jax nor an image library: H x W come
from ``--h/--w`` or from the header of the scene's first image (a PNG's
IHDR or a JPEG's SOF marker). The event stream is read by one function,
:func:`load_events_file` (``events.h5`` through h5py, imported only
there); :func:`main` takes another in its place, as the dataset's
``load_events`` seam does, for a stream stored another way.

    python3 tools/preprocess_events_torch.py <scene_dir> [--h H --w W]
        [--events_tms_unit ns|us] [--accumulate N] [--accumulate_at_time N]
"""

from __future__ import annotations

import argparse
import os
import struct
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from evdeblurnerf_torch.ops.events_native import (  # noqa: E402
    accumulate_events, accumulate_events_at_time, backend, compute_successor)
from evdeblurnerf_torch.utils.events import load_events_h5  # noqa: E402

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# JPEG start-of-frame markers (every SOFn but DHT C4, JPG C8 and DAC CC)
JPEG_SOF = {0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB,
            0xCD, 0xCE, 0xCF}


def image_hw(path: str):
    """(H, W) from the header of a PNG or JPEG file; anything else raises
    and names ``--h/--w``."""
    with open(path, "rb") as f:
        head = f.read(24)
        if head[:8] == PNG_SIGNATURE and head[12:16] == b"IHDR":
            w, h = struct.unpack(">II", head[16:24])
            return h, w
        if head[:2] == b"\xff\xd8":
            f.seek(2)
            while True:
                byte = f.read(1)
                if not byte:
                    break
                if byte != b"\xff":
                    continue
                marker = f.read(1)
                while marker == b"\xff":        # fill bytes
                    marker = f.read(1)
                if not marker:
                    break
                code = marker[0]
                if code == 0x01 or 0xD0 <= code <= 0xD9:
                    continue                    # markers with no segment
                (length,) = struct.unpack(">H", f.read(2))
                if code in JPEG_SOF:
                    h, w = struct.unpack(">xHH", f.read(5))
                    return h, w
                f.seek(length - 2, os.SEEK_CUR)
    raise ValueError(f"cannot read the size of {path} from its header (a "
                     "PNG or JPEG file); pass --h and --w")


def infer_hw(basedir: str):
    """(H, W) of the scene's first image in ``images_1/`` (else
    ``images/``)."""
    imgdir = os.path.join(basedir, "images_1")
    if not os.path.isdir(imgdir):
        imgdir = os.path.join(basedir, "images")
    f = next(f for f in sorted(os.listdir(imgdir))
             if f.lower().endswith(("png", "jpg", "jpeg")))
    return image_hw(os.path.join(imgdir, f))


def load_events_file(scene_dir: str, h: int, w: int, events_tms_unit: str):
    """(events [N, 3] = (coord_id, t_us, p), zero-event coord ids,
    id_to_coords) of the scene's ``events.h5``, as the loader reads it."""
    return load_events_h5(os.path.join(scene_dir, "events.h5"), h, w,
                          optimize_ids=True, events_tms_unit=events_tms_unit)


def main(argv=None, load_events=load_events_file):
    """Run the tool on ``argv``; ``load_events(scene_dir, h, w,
    events_tms_unit)`` reads the stream (:func:`load_events_file`)."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("scene_dir")
    p.add_argument("--h", type=int, default=None)
    p.add_argument("--w", type=int, default=None)
    p.add_argument("--events_tms_unit", default="ns", choices=["ns", "us"])
    p.add_argument("--accumulate", type=int, default=0,
                   help="also write count-based accumulation (every N)")
    p.add_argument("--accumulate_at_time", type=int, default=0,
                   help="also write timestamp-grid accumulation (every N+1 "
                        "image timestamps)")
    args = p.parse_args(argv)

    h, w = (args.h, args.w) if args.h and args.w else infer_hw(args.scene_dir)
    print(f"scene {args.scene_dir} ({h}x{w}); event scans: {backend()}")

    events, _, id_to_coords = load_events(args.scene_dir, h, w,
                                          args.events_tms_unit)
    # same known-pose time filter the loader applies
    # (ref: data/loader_events.py:193); the timestamp files are in us, the
    # loader's internal unit
    tms_path = os.path.join(args.scene_dir, "all_timestamps.npy")
    if os.path.exists(tms_path):
        all_t = np.load(tms_path).astype(np.float64)
        events = events[(events[:, 1] >= all_t.min())
                        & (events[:, 1] <= all_t.max())]
    print(f"loaded {events.shape[0]} events (pose-range filtered), "
          f"{id_to_coords.shape[0] if id_to_coords.ndim == 2 else h * w} "
          f"coordinate ids")

    succ, num_succ, latest, first = compute_successor(events[:, 0])
    out = os.path.join(args.scene_dir, "events_successor.npz")
    np.savez_compressed(out, successor_idx=succ, num_successors=num_succ,
                        latest_seen=latest, first_seen=first,
                        n_events=events.shape[0])
    print(f"wrote {out}")

    if args.accumulate > 0:
        acc = accumulate_events(events, args.accumulate)
        np.save(os.path.join(args.scene_dir,
                             f"events_accum_{args.accumulate}.npy"), acc)
        print(f"wrote count-accumulation ({acc.shape[0]} rows)")
    if args.accumulate_at_time > 0:
        tms = np.load(tms_path)
        acc, zero = accumulate_events_at_time(
            events, np.sort(tms.astype(np.float64)),
            args.accumulate_at_time, return_zeroevents=True)
        np.savez(os.path.join(
            args.scene_dir,
            f"events_accum_t{args.accumulate_at_time}.npz"),
            events=acc, zero_events=zero)
        print(f"wrote time-grid accumulation ({acc.shape[0]} rows)")


if __name__ == "__main__":
    main()
