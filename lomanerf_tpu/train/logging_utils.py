"""Metrics + image logging.

The reference logs scalar loss to wandb and saves matplotlib triptychs
(target / prediction / loss-or-PSNR curve) to ``logs_2d|logs_3d/*.png``
(fit_img.py:545-558, train_nerf.py:686-700).  Here: target | prediction
PNGs written with the standard library alone, the curves as a JSONL metrics
stream (always on), and wandb only if installed.
"""

from __future__ import annotations

import json
import os
import struct
import time
import zlib
from typing import Optional

import numpy as np

try:
    import wandb as _wandb

    _HAVE_WANDB = True
except ImportError:  # pragma: no cover
    _HAVE_WANDB = False


class MetricsLogger:
    """JSONL (+ optional wandb) metrics stream.

    Multi-host: only process 0 writes (``primary_only``, default on) —
    every other process gets a no-op logger, so SPMD drivers can log
    unconditionally without N hosts racing on one file."""

    def __init__(self, log_dir: str, project: Optional[str] = None,
                 use_wandb: bool = False, primary_only: bool = True):
        from lomanerf_tpu.parallel import is_primary

        self.active = is_primary() or not primary_only
        self.log_dir = log_dir
        self._f = None
        self._wandb = None
        if not self.active:
            return
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        if use_wandb and _HAVE_WANDB:  # pragma: no cover
            self._wandb = _wandb
            self._wandb.init(project=project or "lomanerf-tpu")

    def log(self, step: int, **metrics) -> None:
        if not self.active:
            return
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._wandb is not None:  # pragma: no cover
            self._wandb.log(metrics, step=step)

    def log_image(self, step: int, key: str, image) -> None:
        """Forward a rendered figure/array/path to wandb (the reference
        logs its triptych figures, train_nerf.py:710 / fit_img.py:557);
        no-op without wandb or on non-primary processes."""
        if not self.active or self._wandb is None:  # pragma: no cover
            return
        self._wandb.log({key: self._wandb.Image(image)},
                        step=step)  # pragma: no cover

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
        if self._wandb is not None:  # pragma: no cover
            self._wandb.finish()


def write_png(path: str, image: np.ndarray) -> None:
    """Write an (H, W, 3) image with values in [0, 1] as an 8-bit RGB PNG."""
    rgb = (np.clip(np.asarray(image, np.float32), 0.0, 1.0) * 255.0 + 0.5
           ).astype(np.uint8)
    h, w, _ = rgb.shape
    # each scanline starts with filter type 0 (none)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)],
                         axis=1).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def save_comparison(path: str, target: np.ndarray,
                    prediction: np.ndarray) -> None:
    """Target | prediction side by side, like the reference's log images
    (its third panel, the metric curve, is in metrics.jsonl)."""
    write_png(path, np.concatenate(
        [np.asarray(target), np.asarray(prediction)], axis=1))
