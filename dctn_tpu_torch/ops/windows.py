"""Sliding-window views by shifted slicing (port of ``dctn_tpu/ops/windows.py``).

Every kernel position (δh, δw) is a sliced view of the input,
``x[c, :, δh : δh+H', δw : δw+W', :]``; the K²·C views are the rank-one
factors of every K×K window at once. Input layout: (C, B, H, W, Q).
"""

from __future__ import annotations

from typing import Tuple

import torch


def out_spatial(height: int, width: int, kernel_size: int) -> Tuple[int, int]:
    """Output spatial dims of a K×K sliding window with stride 1, no padding."""
    return height - kernel_size + 1, width - kernel_size + 1


def window_views(x: torch.Tensor, kernel_size: int) -> Tuple[torch.Tensor, ...]:
    """The K²·C shifted views of ``x`` (C, B, H, W, Q), each (B, H', W', Q),
    position-major and channel-minor (windows.py:29-53)."""
    num_channels, _, height, width, _ = x.shape
    out_h, out_w = out_spatial(height, width, kernel_size)
    return tuple(
        x[c, :, dh : dh + out_h, dw : dw + out_w, :]
        for dh in range(kernel_size)
        for dw in range(kernel_size)
        for c in range(num_channels)
    )
