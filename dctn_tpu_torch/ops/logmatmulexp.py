"""Numerically stable log-space matrix multiplication (port of
``dctn_tpu/ops/logmatmulexp.py``, reference ``dctn/logmatmulexp.py``).

logmatmulexp(A, B) = log(exp(A) @ exp(B)), computed with the max-shift
identity

    log(exp(A) @ exp(B)) = a_max + b_max + log(exp(A - a_max) @ exp(B - b_max))

with row maxima of A and column maxima of B, so the inner work is one
matrix product of exponentials whose arguments are all ≤ 0. A row or
column with no finite maximum (all −inf) takes the shift 0, so its
exponentials are exact zeros and its output −inf, never NaN.

These are plain PyTorch, differentiable by autograd, in any float dtype
(float64 on the CPU for the parity tests). The fused CUDA kernel (K13) is
``kernels/logmatmulexp_kernels.py``.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


def max_shifts(log_a: torch.Tensor, log_b: torch.Tensor):
    """Row maxima of ``log_a`` (Θ, 1) and column maxima of ``log_b`` (1, I),
    a non-finite maximum replaced by 0 (logmatmulexp.py:39-42)."""
    a_max = torch.amax(log_a, dim=1, keepdim=True)
    b_max = torch.amax(log_b, dim=0, keepdim=True)
    zero = torch.zeros((), dtype=a_max.dtype, device=a_max.device)
    return (torch.where(torch.isfinite(a_max), a_max, zero),
            torch.where(torch.isfinite(b_max), b_max, zero))


def logmatmulexp(log_a: torch.Tensor, log_b: torch.Tensor) -> torch.Tensor:
    """log(exp(log_a) @ exp(log_b)), stable: log_a (Θ, R), log_b (R, I) →
    (Θ, I) in ``torch.promote_types`` of the two. −inf entries (zero
    probabilities) are handled as logsumexp handles them."""
    if log_a.ndim != 2 or log_b.ndim != 2 or log_a.shape[1] != log_b.shape[0]:
        raise ValueError(f"logmatmulexp of {tuple(log_a.shape)} and {tuple(log_b.shape)}")
    dtype = torch.promote_types(log_a.dtype, log_b.dtype)
    log_a, log_b = log_a.to(dtype), log_b.to(dtype)
    return logmatmulexp_shifted(log_a, log_b, *max_shifts(log_a, log_b))


def logmatmulexp_shifted(
    log_a: torch.Tensor, log_b: torch.Tensor, a_max: torch.Tensor, b_max: torch.Tensor
) -> torch.Tensor:
    """log(exp(log_a − a_max) @ exp(log_b − b_max)) + a_max + b_max with the
    shifts given, (Θ, 1) and (1, I): the max-shift arithmetic, the
    exponentials materialized."""
    return torch.log(torch.exp(log_a - a_max) @ torch.exp(log_b - b_max)) + a_max + b_max


def logmatmulexp_lowmem(log_a: torch.Tensor, log_b: torch.Tensor) -> torch.Tensor:
    """The same, with the exponentials recomputed in the backward pass
    instead of kept (``torch.utils.checkpoint``, as the reference's
    logmatmulexp.py:17-22)."""
    return checkpoint(logmatmulexp, log_a, log_b, use_reentrant=False)


def logmatmulexp_reference(log_a: torch.Tensor, log_b: torch.Tensor) -> torch.Tensor:
    """The broadcast + logsumexp form (the reference's algorithm,
    logmatmulexp.py:5-14): O(Θ·R·I) memory, the numerical oracle."""
    return torch.logsumexp(log_a[:, :, None] + log_b[None, :, :], dim=1)
