"""Quantum feature maps: pixel intensity → small feature vector (port of
``dctn_tpu/data/feature_maps.py``).

The default map sends x ∈ [0, 1] to φ(x) = (2·sin²(πx/2), 2·cos²(πx/2)),
giving each coordinate μ²+σ²≈1 after the ν window scaling. Host-side numpy,
applied once per split.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import numpy as np

PhiMap = Tuple[Callable[[np.ndarray], np.ndarray], ...]

phi_cos_sin_squared_1: PhiMap = (
    lambda x: 2.0 * np.sin(x * math.pi / 2.0) ** 2,
    lambda x: 2.0 * np.cos(x * math.pi / 2.0) ** 2,
)


def apply_feature_map(x: np.ndarray, phi: PhiMap = phi_cos_sin_squared_1) -> np.ndarray:
    """``x``: (N, H, W) floats in [0, 1] → (1, N, H, W, len(phi)), the
    channel-leading quantum layout used everywhere downstream."""
    stacked = np.stack([phi_i(x) for phi_i in phi], axis=3)
    return stacked[None].astype(x.dtype, copy=False)
