"""Metrics for TensorBoard and a jsonl file (port of
``dctn_tpu/train/tb_logging.py``): scalars and histograms of the per-batch
loss, regularizer and probabilities of the true class, annotated image
grids of a batch (a red/green bar whose green share is the probability of
the true class, and blue dots for the label), and the ConvSBS strings'
implied-tensor mean and std through the TT statistics.

``MetricsWriter`` always writes ``metrics.jsonl``, one line per record in
the JAX package's format, and writes TensorBoard events beside it only
where ``torch.utils.tensorboard`` imports (it needs the ``tensorboard``
package, which a machine may lack: the jsonl file is then the record).
Its lines are buffered and written out by ``flush`` (the runners call it
at the end of each logging hook) and ``close``: where a file write is a
slow system call, a line's flush costs milliseconds, and a log writes
hundreds of lines.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, Sequence

import numpy as np

logger = logging.getLogger(__name__)


class MetricsWriter:
    """Scalars, histograms and images → metrics.jsonl, and TensorBoard
    events where available (tb_logging.py:30-88)."""

    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir)
            except Exception as e:  # tensorboard is optional
                logger.info("tensorboard unavailable (%s); using jsonl only", e)

    def _line(self, record: Dict[str, Any]) -> None:
        self._jsonl.write(json.dumps(record) + "\n")

    def flush(self) -> None:
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._line({"tag": tag, "value": float(value), "step": step})
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def add_histogram(self, tag: str, values: np.ndarray, step: int) -> None:
        values = np.asarray(values).ravel()
        self._line({
            "tag": tag, "step": step,
            "hist_mean": float(values.mean()), "hist_std": float(values.std()),
            "hist_min": float(values.min()), "hist_max": float(values.max()),
        })
        if self._tb is not None:
            self._tb.add_histogram(tag, values, step)

    def add_image(self, tag: str, image_chw: np.ndarray, step: int) -> None:
        image_chw = np.asarray(image_chw)
        self._line({"tag": tag, "step": step, "image_shape": list(image_chw.shape)})
        if self._tb is not None:
            self._tb.add_image(tag, image_chw, step)

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


# ---------------------------------------------------------------------------
# image annotation (tb_logging.py:91-148)


def add_good_bad_bar(image_hw: np.ndarray, prob_of_correct: float) -> np.ndarray:
    """A green/red bar of two columns on the right: its green share, from
    the bottom, is the probability given to the true class. (H, W) in
    [0, 1] → (3, H, W+2) RGB."""
    h, w = image_hw.shape
    rgb = np.broadcast_to(image_hw, (3, h, w)).copy()
    bar = np.zeros((3, h, 2), dtype=rgb.dtype)
    green_rows = int(round(np.clip(prob_of_correct, 0.0, 1.0) * h))
    if green_rows:
        bar[1, h - green_rows :, :] = 1.0
    if green_rows < h:
        bar[0, : h - green_rows, :] = 1.0
    return np.concatenate([rgb, bar], axis=2)


def add_y_dots(image_3hw: np.ndarray, label: int) -> np.ndarray:
    """The class index as label+1 blue dots along the top row."""
    out = image_3hw.copy()
    for i in range(label + 1):
        col = 2 * i
        if col < out.shape[2]:
            out[:, 0, col] = (0.0, 0.0, 1.0)
    return out


def make_image_grid(images: Sequence[np.ndarray], nrow: int = 8, pad: int = 1) -> np.ndarray:
    """(3, H, W) images tiled into one (3, H', W') grid, zero padding."""
    c, h, w = images[0].shape
    nrows = -(-len(images) // nrow)
    grid = np.zeros((c, nrows * (h + pad) + pad, nrow * (w + pad) + pad), images[0].dtype)
    for i, img in enumerate(images):
        r, col = divmod(i, nrow)
        y, x = pad + r * (h + pad), pad + col * (w + pad)
        grid[:, y : y + h, x : x + w] = img
    return grid


def log_batch_images(
    writer: MetricsWriter,
    raw_images: np.ndarray,  # (B, H, W) images before φ, in [0, 1]
    probs_of_true: np.ndarray,  # (B,)
    labels: np.ndarray,  # (B,)
    step: int,
    tag: str = "batch",
) -> None:
    processed = [
        add_y_dots(add_good_bad_bar(img, p), int(lbl))
        for img, p, lbl in zip(raw_images, probs_of_true, labels)
    ]
    writer.add_image(tag, make_image_grid(processed), step)


# ---------------------------------------------------------------------------
# ConvSBS TT statistics (tb_logging.py:151-162)


def log_conv_sbs_tt_statistics(
    writer: MetricsWriter,
    specs_and_cores: Dict[str, Any],  # name -> (SBSSpecString, cores)
    step: int,
) -> None:
    from ..ops import sbs

    for name, (spec, cores) in specs_and_cores.items():
        writer.add_scalar(f"{name}/tt_mean", float(sbs.tt_mean(spec, cores)), step)
        writer.add_scalar(f"{name}/tt_std", float(sbs.tt_std(spec, cores, unbiased=True)), step)
