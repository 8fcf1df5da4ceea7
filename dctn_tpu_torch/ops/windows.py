"""Sliding-window views by shifted slicing (port of ``dctn_tpu/ops/windows.py``).

Every kernel position (δh, δw) is a sliced view of the input,
``x[c, :, δh : δh+H', δw : δw+W', :]``; the K²·C views are the rank-one
factors of every K×K window at once. Input layout: (C, B, H, W, Q).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..utils.pos2d import Pos2D, raster_positions
from .rank_one import RankOneTensorsBatch


def out_spatial(height: int, width: int, kernel_size: int) -> Tuple[int, int]:
    """Output spatial dims of a K×K sliding window with stride 1, no padding."""
    return height - kernel_size + 1, width - kernel_size + 1


def window_views_at_positions(x, positions: Sequence[Pos2D]) -> Tuple[torch.Tensor, ...]:
    """For each position, then each channel, the shifted view of ``x``
    ((C, B, H, W, Q), or a sequence of C (B, H, W, Q) tensors): len(positions)·C
    views of (B, H', W', Q), H' = H - max_h, W' = W - max_w (windows.py:29-53)."""
    if min(p.h for p in positions) != 0 or min(p.w for p in positions) != 0:
        raise ValueError("positions must start at (0, 0)")
    max_h = max(p.h for p in positions)
    max_w = max(p.w for p in positions)
    _, height, width, _ = x[0].shape
    out_h, out_w = height - max_h, width - max_w
    return tuple(
        x[c][:, pos.h : pos.h + out_h, pos.w : pos.w + out_w, :]
        for pos in positions
        for c in range(len(x))
    )


def window_views(x: torch.Tensor, kernel_size: int) -> Tuple[torch.Tensor, ...]:
    """The K²·C shifted views of ``x`` (C, B, H, W, Q), each (B, H', W', Q),
    position-major and channel-minor (windows.py:29-53)."""
    return window_views_at_positions(x, raster_positions(kernel_size))


def make_windows(x: torch.Tensor, kernel_size: int) -> RankOneTensorsBatch:
    """The K²·C views stacked as a batch of rank-one tensors, (K²·C, B, H', W',
    Q) with factors_dim 0 and coordinates_dim 4 (windows.py:56-68)."""
    return RankOneTensorsBatch(
        torch.stack(window_views(x, kernel_size), dim=0), factors_dim=0, coordinates_dim=4
    )
