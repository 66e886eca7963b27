"""Observability: scalar/image/video/histogram logging facade.

Counterpart of ``evdeblurnerf_tpu/utils/logger.py`` (the reference's W&B +
TensorboardX facade, ref: utils/logger.py:9-67), offline-first: a JSONL
metrics stream is always written (machine-readable regression log, the
analog of the reference's ``test_metrics.txt``), tensorboard and wandb
attach when importable, images dump as PNG and videos as mp4
(imageio-ffmpeg) or PNG frame dirs. Every PNG goes through
:func:`write_png`, which needs no image library.
"""

from __future__ import annotations

import json
import os
import struct
import time
import zlib
from typing import Optional

import numpy as np

from .misc import to8b


def _png_bytes(img8: np.ndarray) -> bytes:
    """An 8-bit RGB (or grey) image as a PNG file, with the stdlib only:
    unfiltered scanlines, one zlib stream."""
    img8 = np.ascontiguousarray(img8)
    if img8.ndim == 2:
        img8 = img8[..., None]
    h, w, c = img8.shape
    colour_type = {1: 0, 3: 2, 4: 6}[c]
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          img8.reshape(h, w * c)], 1).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour_type,
                                         0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def write_png(path: str, img8: np.ndarray):
    """Write a uint8 [H, W, 3] (or [H, W]) image as PNG: through imageio
    where it is installed, else with the stdlib writer — the decoded
    pixels are the same either way."""
    img8 = np.asarray(img8)
    if img8.dtype != np.uint8:
        raise TypeError(f"write_png takes uint8, got {img8.dtype}")
    try:
        import imageio.v2 as imageio
    except ImportError:
        with open(path, "wb") as f:
            f.write(_png_bytes(img8))
    else:
        imageio.imwrite(path, img8)


class Logger:
    def __init__(self, log_dir: str, expname: str, use_wandb: bool = False,
                 use_tensorboard: bool = False, wandb_id: Optional[str] = None,
                 args=None, enabled: bool = True):
        """``enabled=False`` turns every write into a no-op."""
        self.enabled = enabled
        self.expname = expname
        self.dir = os.path.join(log_dir or ".", expname)
        self._t0 = time.time()
        self._tb = None
        self._wandb = None
        self._jsonl = None
        if not enabled:
            return
        os.makedirs(self.dir, exist_ok=True)
        self._jsonl = open(os.path.join(self.dir, "metrics.jsonl"), "a")

        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(self.dir)
            except Exception:
                try:
                    from tensorboardX import SummaryWriter

                    self._tb = SummaryWriter(self.dir)
                except Exception:
                    self._tb = None

        self._wandb = None
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb.init(
                    project="evdeblurnerf_torch", name=expname, id=wandb_id,
                    resume="allow", config=vars(args) if args else None)
            except Exception:
                self._wandb = None

    @property
    def wandb_id(self) -> Optional[str]:
        return self._wandb.id if self._wandb is not None else None

    def scalar(self, tag: str, value, step: int):
        if not self.enabled:
            return
        rec = {"tag": tag, "value": float(value), "step": int(step),
               "t": round(time.time() - self._t0, 3)}
        self._jsonl.write(json.dumps(rec) + "\n")
        # line-flushed so metrics.jsonl is tail -f-able as an external
        # liveness signal
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)
        if self._wandb is not None:
            self._wandb.log({tag: float(value)}, step=step)

    def scalars(self, values: dict, step: int):
        for tag, value in values.items():
            self.scalar(tag, value, step)

    def image(self, tag: str, img: np.ndarray, step: int):
        """img: [H, W, 3] float in [0,1] or uint8."""
        if not self.enabled:
            return
        img8 = np.asarray(img)
        if img8.dtype != np.uint8:
            img8 = to8b(img8)
        d = os.path.join(self.dir, "images")
        os.makedirs(d, exist_ok=True)
        safe = tag.replace("/", "_")
        write_png(os.path.join(d, f"{safe}_{step:08d}.png"), img8)
        if self._tb is not None:
            self._tb.add_image(tag, img8, step, dataformats="HWC")

    def video(self, tag: str, frames: np.ndarray, step: int, fps: int = 30):
        """frames: [T, H, W, 3]; pads to even dims for ffmpeg
        (ref: utils/logger.py video path)."""
        if not self.enabled:
            return
        frames8 = np.asarray(frames)
        if frames8.dtype != np.uint8:
            frames8 = to8b(frames8)
        t, h, w = frames8.shape[:3]
        if h % 2 or w % 2:
            frames8 = np.pad(frames8,
                             [(0, 0), (0, h % 2), (0, w % 2), (0, 0)])
        d = os.path.join(self.dir, "videos")
        os.makedirs(d, exist_ok=True)
        safe = tag.replace("/", "_")
        path = os.path.join(d, f"{safe}_{step:08d}.mp4")
        try:
            import imageio.v2 as imageio

            imageio.mimwrite(path, frames8, fps=fps, quality=8)
        except Exception as e:
            if not getattr(Logger, "_warned_no_mp4", False):
                Logger._warned_no_mp4 = True
                print(f"[logger] mp4 encode unavailable ({type(e).__name__}:"
                      f" {str(e)[:120]}); writing PNG frame dirs instead")
            framedir = path[:-4]
            os.makedirs(framedir, exist_ok=True)
            for i, fr in enumerate(frames8):
                write_png(os.path.join(framedir, f"{i:04d}.png"), fr)

    def histogram(self, tag: str, values, step: int):
        if not self.enabled:
            return
        values = np.asarray(values).ravel()
        rec = {"tag": tag + "/hist", "step": int(step),
               "mean": float(values.mean()), "std": float(values.std()),
               "min": float(values.min()), "max": float(values.max())}
        self._jsonl.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            self._tb.add_histogram(tag, values, step)

    def flush(self):
        if self._jsonl is not None:
            self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self):
        self.flush()
        if self._jsonl is not None:
            self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()
