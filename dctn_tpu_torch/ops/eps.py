"""EPS — the Entangled Plaquette State patch contraction (port of
``dctn_tpu/ops/eps.py``).

Given a dense core of shape ``(Q,)*(K²·C) + (O,)`` and an input of shape
``(C, B, H, W, Q)``, contract the core with every K×K window of rank-one
feature vectors, giving ``(B, H-K+1, W-K+1, O)``. The forward splits the
window's factors in two: u = Khatri-Rao of the first n1 factors, v of the
rest, t = u @ core.reshape(Q^n1, Q^n2·O), out = Σ_b v[b]·t[b, o].

The split helpers must pick the same n1 as the JAX package: the fast (cmt)
parameter layout's shape depends on it, and checkpoints and parity tests
compare those matrices one-to-one. ``_split_cost`` is therefore the JAX
package's TPU cost model, kept as it is; a cost model for Hopper tiles is
later work (the split is exact, so any n1 gives the same numbers).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from .windows import window_views


def eps_shape(
    kernel_size: int, in_num_channels: int, in_size: int, out_size: int
) -> Tuple[int, ...]:
    """Shape an EPS core with these parameters must have."""
    return (in_size,) * (kernel_size**2 * in_num_channels) + (out_size,)


def total_in_dim_size(kernel_size: int, in_num_channels: int, in_size: int) -> int:
    return in_size ** (in_num_channels * kernel_size**2)


def _infer_kernel_size(core: torch.Tensor, num_channels: int) -> int:
    k = math.isqrt((core.ndim - 1) // num_channels)
    if k * k * num_channels != core.ndim - 1:
        raise ValueError(
            f"core ndim {core.ndim} incompatible with {num_channels} channels"
        )
    return k


def khatri_rao(factors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Row-wise Kronecker product over the last axis, the FIRST factor
    slowest-varying (row-major), matching a row-major reshape of the core's
    leading dims."""
    out = factors[0]
    for f in factors[1:]:
        out = (out[..., :, None] * f[..., None, :]).reshape(*out.shape[:-1], -1)
    return out


# The JAX package's ratio of TPU vector to matrix-unit cost; it only ranks
# splits (see the module docstring for why it is kept).
_VPU_MXU_RATIO = 64


def split_candidates(n: int, q: int) -> list:
    """Legal matmul splits for an n-factor layer: every 1 ≤ n1 ≤ n, even
    only when factor pairs will be merged (q == 2, even n)."""
    merge_pairs = q == 2 and n % 2 == 0
    return [n1 for n1 in range(1, n + 1) if not (merge_pairs and n1 % 2)]


def _split_cost(n: int, q: int, out_size: int, n1: int) -> float:
    a, b = q**n1, q ** (n - n1)
    pad_a = -(-a // 128) * 128
    mxu = 2 * pad_a * b * out_size
    vpu = 4.0 / 3.0 * (a + b) + out_size * b + a
    return mxu + _VPU_MXU_RATIO * vpu


def _balanced_split(n: int, q: int, out_size: int) -> int:
    """How many factors go in the matmul (u) half: the JAX package's pick
    (eps.py:97-118), the lowest-cost candidate, ties to the smaller n1."""
    return min(
        split_candidates(n, q),
        key=lambda n1: (_split_cost(n, q, out_size, n1), n1),
    )


def eps(core: torch.Tensor, x: torch.Tensor, split: Optional[int] = None) -> torch.Tensor:
    """Contract an EPS ``core`` (Q,)*(K²·C) + (O,) with all K×K windows of
    ``x`` (C, B, H, W, Q), giving (B, H', W', O). The plain reference-layout
    forward (eps.py:339-364) without autograd glue: plain torch ops, any
    device, any float dtype."""
    num_channels, _, _, _, in_size = x.shape
    kernel_size = _infer_kernel_size(core, num_channels)
    n = kernel_size**2 * num_channels
    if core.shape[:-1] != (in_size,) * n:
        raise ValueError(f"core shape {tuple(core.shape)} does not fit input Q={in_size}")
    out_size = core.shape[-1]
    n1 = split if split is not None else _balanced_split(n, in_size, out_size)
    n1 = max(1, min(n, n1))
    views = window_views(x, kernel_size)
    u = khatri_rao(views[:n1])  # (B, H', W', Q^n1)
    t = u @ core.reshape(in_size**n1, in_size ** (n - n1) * out_size)
    if n1 == n:
        return t
    v = khatri_rao(views[n1:])  # (B, H', W', Q^n2)
    t = t.reshape(*t.shape[:-1], in_size ** (n - n1), out_size)
    return torch.sum(v[..., :, None] * t, dim=-2)


# ---------------------------------------------------------------------------
# EPS algebra (the composition inner product and its regularizer)


def contract_on_input_dims(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Matricized AᵀB over the shared input dims: (O_a, O_b) (eps.py:394-397)."""
    return a.reshape(-1, a.shape[-1]).T @ b.reshape(-1, b.shape[-1])


def inner_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Flattened dot product of two equal-shape EPS cores (eps.py:400-403)."""
    if a.shape != b.shape:
        raise ValueError(f"inner_product of cores shaped {tuple(a.shape)} and {tuple(b.shape)}")
    return torch.dot(a.reshape(-1), b.reshape(-1))


def kron_power(x: torch.Tensor, k: int) -> torch.Tensor:
    """k-fold Kronecker power of a matrix, row-major index pairing:
    result[(i₁…i_k), (j₁…j_k)] = ∏ x[i_m, j_m] (eps.py:406-416)."""
    s, t = x.shape
    out = torch.ones((1, 1), dtype=x.dtype, device=x.device)
    for _ in range(k):
        out = (out[:, None, :, None] * x[None, :, None, :]).reshape(
            out.shape[0] * s, out.shape[1] * t
        )
    return out


def absorb_on_input_dims(b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Contract the matrix ``x`` (old_in, new_in) into every input dim of
    the EPS core ``b``: result[j₁…jₙ, o] = Σ_{i₁…iₙ} b[i₁…iₙ, o] ∏ₖ x[iₖ, jₖ]
    (eps.py:419-451): the input dims in two halves, each half's Kronecker
    power of ``x`` applied as one matrix product, as the JAX package does."""
    n = b.ndim - 1
    s, t = x.shape
    o = b.shape[-1]
    n1 = (n + 1) // 2
    n2 = n - n1
    step1 = kron_power(x, n1).T @ b.reshape(s**n1, s**n2 * o)  # (t^n1, s^n2·o)
    if n2 == 0:
        return step1.reshape((t,) * n + (o,))
    step1 = step1.reshape(t**n1, s**n2, o)
    out = torch.einsum("abo,bc->aco", step1, kron_power(x, n2))
    return out.reshape((t,) * n + (o,))


def make_eps_unit_theoretical_output_std(
    generator: torch.Generator,
    kernel_size: int,
    in_num_channels: int,
    in_size: int,
    out_size: int,
    dtype: torch.dtype = torch.float32,
    device="cpu",
) -> torch.Tensor:
    """randn · (Q^(C·K²))^(-1/2): keeps the output std at 1 when the input
    coordinates have μ²+σ²=1 (eps.py:473-485). Drawn on the generator's
    device, then moved to ``device``."""
    std = total_in_dim_size(kernel_size, in_num_channels, in_size) ** -0.5
    shape = eps_shape(kernel_size, in_num_channels, in_size, out_size)
    core = torch.randn(shape, generator=generator, dtype=dtype, device=generator.device)
    return (core * std).to(device)
