"""A probabilistic multilinear classifier trained in log space (port of
``experiments/log_space_classifier.py``; reference
``small_experiments/tiny_mnist_probabilistic_multilinear_classifier.py``).

Images are pooled 28×28 → 7×7, each of the 49 pixels mapped to
φ' = log(sin²(πx/2), cos²(πx/2)) (clipped at 1e-6 before the log), and for
each class log p(x, c) = Σ_pixels log(w_{c,pixel} · φ_pixel), every factor
a log-space product, so every intermediate stays a log-probability.

Two forms of the same function: ``log_joint``, 49 products of (B, 2) ×
(2, C), one per pixel, summed in pixel order (the experiment's scan, as a
Python loop); and ``log_joint_fused``, ONE product of the dense (B, 49·2)
features with the (49·2, 49·C) block-diagonal weight matrix, −inf off the
blocks (exact zeros after the exponential), then the per-pixel factors
summed. ``lme`` picks the product: ``ops.logmatmulexp`` (the plain max-shift
form) or ``kernels.logmatmulexp_kernels.logmatmulexp_kernel`` (K13).
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from ..ops.logmatmulexp import logmatmulexp

DOWN = 4  # 28 → 7, 49 pixels
NUM_PIXELS = 49
NUM_CLASSES = 10
LR = 3e-2  # Adam (train.optimizers.make_optimizer: optax.adam's β and ε)

LogMatMulExpFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def features(x: torch.Tensor) -> torch.Tensor:
    """(B, 28, 28) → log-features (B, 49, 2)."""
    b = x.shape[0]
    pooled = x.reshape(b, 7, DOWN, 7, DOWN).mean(dim=(2, 4))
    phi = torch.stack(
        (torch.sin(pooled * math.pi / 2) ** 2, torch.cos(pooled * math.pi / 2) ** 2), dim=-1
    )
    return torch.log(torch.clamp(phi, min=1e-6)).reshape(b, NUM_PIXELS, 2)


def log_joint(log_w: torch.Tensor, log_feats: torch.Tensor,
              lme: LogMatMulExpFn = logmatmulexp) -> torch.Tensor:
    """log p(x, c) (B, C) from per-pixel per-class log-weights ``log_w``
    (P, C, 2) and log-features (B, P, 2): per pixel lme((B, 2), (2, C)),
    added in pixel order from zeros, as the experiment's ``lax.scan``."""
    out = torch.zeros((log_feats.shape[0], log_w.shape[1]), dtype=log_feats.dtype,
                      device=log_feats.device)
    for p in range(log_w.shape[0]):
        out = out + lme(log_feats[:, p], log_w[p].T)
    return out


def block_diagonal(log_w: torch.Tensor) -> torch.Tensor:
    """(P, C, Q) log-weights → the (P·Q, P·C) log-space block-diagonal
    matrix, entry (p·Q + q, p·C + c) = log_w[p, c, q] and −inf off the
    blocks; differentiable in ``log_w``."""
    p, c, q = log_w.shape
    ii = torch.arange(p, device=log_w.device)[:, None, None]
    rows = (ii * q + torch.arange(q, device=log_w.device)[None, None, :]).expand(p, c, q)
    cols = (ii * c + torch.arange(c, device=log_w.device)[None, :, None]).expand(p, c, q)
    lb = torch.full((p * q, p * c), -math.inf, dtype=log_w.dtype, device=log_w.device)
    return lb.index_put((rows, cols), log_w)


def log_joint_fused(log_w: torch.Tensor, log_feats: torch.Tensor,
                    lme: LogMatMulExpFn) -> torch.Tensor:
    """The same log p(x, c) as ONE log-space product: the features flatten
    densely (the weight's −inf off-blocks already zero the cross-pixel
    terms), (B, P·Q) × (P·Q, P·C) → (B, P·C), then the P factors of each
    class summed."""
    b, p, q = log_feats.shape
    out = lme(log_feats.reshape(b, p * q), block_diagonal(log_w))
    return out.reshape(b, p, log_w.shape[1]).sum(dim=1)


def init_log_w(generator: torch.Generator, dtype=torch.float32) -> torch.Tensor:
    """Weights uniform on [0.3, 1.0), their logs: (49, 10, 2)."""
    w = torch.rand((NUM_PIXELS, NUM_CLASSES, 2), generator=generator, dtype=dtype)
    return torch.log(0.3 + 0.7 * w)


def accuracy(joint: torch.Tensor, y: torch.Tensor) -> float:
    """Share of rows whose largest log-joint is the label's."""
    return float((torch.argmax(joint, dim=1) == y).to(torch.float32).mean())
