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

``eps`` is differentiable: by default through ``EPSContract``, the JAX
package's hand-written backward (``_eps_contract_fwd/_bwd``) as a
``torch.autograd.Function`` that saves what the JAX custom VJP saves (the
transposed views, the Khatri-Rao prefixes of both halves and t); with
``custom_vjp=False`` through autograd of the staged forward. Its products
are ``torch.matmul``, on any device: the runners' ``xla`` backend (the JAX
package's XLA einsums and matmuls, which no Pallas kernel replaces). With
``compute_dtype=torch.bfloat16`` their operands are rounded to bf16 where
the JAX package casts them (``_maybe``, eps.py:182-272 and :343-364) and
multiplied in float32, which sums the exact bf16 products in float32.
``eps_one_by_one`` is the sequential-absorption oracle.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from ..kernels.eps_kernels import (
    KERNELS,
    EPSKernels,
    _core_to_cmt_k,
    _kernel_dims,
    _round,
    eps_apply_t_cmt,
    kernels_take_split,
    objective_name,
    operand_dtype,
    plan_call,
)
from ..utils import fallbacks
from .windows import out_spatial, window_views


def eps_shape(
    kernel_size: int, in_num_channels: int, in_size: int, out_size: int
) -> Tuple[int, ...]:
    """Shape an EPS core with these parameters must have."""
    return (in_size,) * (kernel_size**2 * in_num_channels) + (out_size,)


def is_eps(a) -> bool:
    """Whether ``a`` plausibly is an EPS core, judging by shape (eps.py:53)."""
    return a.ndim >= 2 and all(s == a.shape[0] for s in a.shape[:-1])


def matrix_shape(core) -> Tuple[int, int]:
    """(out_size, total_in_size) of the matricized core (eps.py:56-59)."""
    assert is_eps(core)
    return core.shape[-1], math.prod(core.shape[:-1])


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


def _kr_prefixes_t(factors_t: Sequence[torch.Tensor]):
    """Prefix Khatri-Rao products in the transposed layout: factors (q, N) →
    [(q₁, N), (q₁q₂, N), …], factor 1 slowest-varying (eps.py:137-149)."""
    prods = [factors_t[0]]
    for f in factors_t[1:]:
        p = prods[-1]
        prods.append((p[:, None, :] * f[None, :, :]).reshape(-1, p.shape[-1]))
    return prods


def _kr_chain_bwd_t(factors_t, prefixes_t, d_prod_t):
    """Cotangents of every (q, N) factor of a transposed Khatri-Rao chain, by
    the suffix sweep (eps.py:152-166)."""
    d_factors = [None] * len(factors_t)
    d = d_prod_t
    for k in range(len(factors_t) - 1, 0, -1):
        d3 = d.reshape(-1, factors_t[k].shape[0], d.shape[-1])  # (prod_{<k}, q_k, N)
        d_factors[k] = torch.sum(d3 * prefixes_t[k - 1][:, None, :], dim=0)
        d = torch.sum(d3 * factors_t[k][None, :, :], dim=1)
    d_factors[0] = d
    return d_factors


class EPSContract(torch.autograd.Function):
    """out[n, o] = Σ_{a,b} u[a,n]·v[b,n]·core[a,b,o] over the window views,
    in the transposed (features, N) layout, with the JAX package's explicit
    backward (``_eps_contract_fwd/_bwd``, eps.py:182-276): it saves the
    core, the transposed views, the prefixes of both Khatri-Rao halves and
    t, and computes d_core = u·(v ⊗ g)ᵀ, d_u = core·(v ⊗ g), d_v = Σ_o t·g,
    then the suffix sweeps to each view's cotangent. ``md`` bf16 rounds the
    products' operands as ``_eps_contract_fwd/_bwd`` do: cm and u in the
    forward (not v), u, cm and kr2 (g when n1 = n) in the backward, whose
    d_v reads the float32 t."""

    @staticmethod
    def forward(ctx, core, n1, md, *views):
        n = len(views)
        in_size = views[0].shape[-1]
        out_size = core.shape[-1]
        b, hp, wp, _ = views[0].shape
        npix = b * hp * wp
        views_t = tuple(v.reshape(npix, in_size).T for v in views)  # (Q, N)
        u_prefixes = _kr_prefixes_t(views_t[:n1])
        cm = core.reshape(in_size**n1, in_size ** (n - n1) * out_size)
        t_t = _round(cm, md).T @ _round(u_prefixes[-1], md)  # (Q^n2·O, N)
        ctx.dims = (n, n1, (b, hp, wp))
        ctx.md = md
        if n1 == n:
            ctx.save_for_backward(core, *views_t, *u_prefixes)
            return t_t.T.reshape(b, hp, wp, out_size)
        v_prefixes = _kr_prefixes_t(views_t[n1:])
        t3 = t_t.reshape(in_size ** (n - n1), out_size, npix)
        out_t = torch.sum(v_prefixes[-1][:, None, :] * t3, dim=0)  # (O, N)
        ctx.save_for_backward(core, *views_t, *u_prefixes, *v_prefixes, t3)
        return out_t.T.reshape(b, hp, wp, out_size)

    @staticmethod
    def backward(ctx, g):
        n, n1, (b, hp, wp) = ctx.dims
        md = ctx.md
        # saved: the core, the n views, the n1 u prefixes, then (unless
        # n1 == n) the n - n1 v prefixes and t3
        core, *rest = ctx.saved_tensors
        views_t, u_prefixes = rest[:n], rest[n : n + n1]
        in_size = views_t[0].shape[0]
        out_size = core.shape[-1]
        npix = views_t[0].shape[-1]
        u_t = _round(u_prefixes[-1], md)
        cm = _round(core.reshape(in_size**n1, in_size ** (n - n1) * out_size), md)
        g_t = g.reshape(npix, out_size).T  # (O, N)
        # the input's cotangents only where the views need them (a first
        # layer's input does not)
        need_views = any(ctx.needs_input_grad[3:])
        if n1 == n:
            g_m = _round(g_t, md)
            d_cm = u_t @ g_m.T  # (Q^n1, O)
            if not need_views:
                return (d_cm.reshape(core.shape), None, None, *([None] * n))
            d_u = cm @ g_m  # (Q^n1, N)
            d_views_t = _kr_chain_bwd_t(views_t, u_prefixes, d_u)
        else:
            v_prefixes, t3 = rest[n + n1 : -1], rest[-1]
            kr2 = _round((v_prefixes[-1][:, None, :] * g_t[None, :, :]).reshape(-1, npix), md)
            d_cm = u_t @ kr2.T  # (Q^n1, Q^n2·O)
            if not need_views:
                return (d_cm.reshape(core.shape), None, None, *([None] * n))
            d_u = cm @ kr2  # (Q^n1, N)
            d_v = torch.sum(t3 * g_t[None, :, :], dim=1)  # (Q^n2, N)
            d_views_t = _kr_chain_bwd_t(views_t[:n1], u_prefixes, d_u) + _kr_chain_bwd_t(
                views_t[n1:], v_prefixes, d_v
            )
        d_views = tuple(d.T.reshape(b, hp, wp, in_size) for d in d_views_t)
        return (d_cm.reshape(core.shape), None, None, *d_views)


def _record_fallback(n: int, n1: int, q: int, o: int, core, x) -> None:
    """The plain path in place of the kernels, said once per layer shape
    (eps.py:331-338, in the port's words)."""
    fallbacks.record(
        f"EPS layer (n={n}, n1={n1}, q={q}, o={o}, dtype={core.dtype}/{x.dtype}) outside "
        "the kernels' plans or non-f32 — running the plain path (torch.matmul; shrink the "
        "layer or its split)"
    )


def eps(
    core: torch.Tensor, x: torch.Tensor, split: Optional[int] = None, custom_vjp: bool = True,
    backend: str = "xla", compute_dtype=None, kernels: EPSKernels = KERNELS,
) -> torch.Tensor:
    """Contract an EPS ``core`` (Q,)*(K²·C) + (O,) with all K×K windows of
    ``x`` (C, B, H, W, Q), giving (B, H', W', O): the reference-layout
    operator (eps.py:278-364). Differentiable in ``core`` and ``x``.

    ``backend="xla"`` (the default): plain torch ops on any device and float
    dtype, through ``EPSContract`` (the JAX package's backward), or with
    ``custom_vjp=False`` through autograd of the staged forward.
    ``backend="pallas"`` (eps.py:308-338): the core turned into its cmt
    (``_core_to_cmt_k``, differentiable) and the layer run by
    ``eps_apply_t_cmt`` with ``kernels``: K1 (with t where the backward
    reads it), then ``eps_dcore`` and the d_views kernel, on a CUDA tensor;
    their plain versions on a CPU one. Its split is the same
    ``_balanced_split`` of this core's O (a sharded core's local O), as the
    fast layout's; the split is exact, so either route gives the same
    numbers. Where the kernels do not take the layer at this call's pixel
    count and objective (``kernels_take_split``: serving under no grad,
    else training), or the core or input is not float32, the layer takes
    the xla path and the fallback is recorded (``utils.fallbacks``), on any
    device alike: a decision made before any launch.

    ``compute_dtype``: None (float32) or ``torch.bfloat16``, the operands of
    every product rounded to bf16 and summed in float32 (eps.py:292-293):
    on the xla backend where the JAX package casts them, on the pallas
    backend the kernels' bf16 mode."""
    md = operand_dtype(compute_dtype)
    num_channels, _, _, _, in_size = x.shape
    kernel_size = _infer_kernel_size(core, num_channels)
    n = kernel_size**2 * num_channels
    if core.shape[:-1] != (in_size,) * n:
        raise ValueError(f"core shape {tuple(core.shape)} does not fit input Q={in_size}")
    out_size = core.shape[-1]
    n1 = split if split is not None else _balanced_split(n, in_size, out_size)
    n1 = max(1, min(n, n1))
    if backend == "pallas":
        n1, merge_pairs = plan_call(num_channels, in_size, kernel_size, n1)
        layer_index = 1 if x.requires_grad else 0
        train = torch.is_grad_enabled() and (core.requires_grad or x.requires_grad)
        hp, wp = out_spatial(x.shape[2], x.shape[3], kernel_size)
        if (core.dtype == torch.float32 and x.dtype == torch.float32
                and kernels_take_split(num_channels, in_size, kernel_size, n1, out_size,
                                       x.shape[1] * hp * wp, layer_index,
                                       objective_name(not train, None, compute_dtype),
                                       compute_dtype)):
            _, q_k, n1_k = _kernel_dims(num_channels, in_size, kernel_size, n1, merge_pairs)
            outT = eps_apply_t_cmt(
                _core_to_cmt_k(core, n1_k, q_k), x.permute(0, 4, 2, 3, 1), out_size,
                kernel_size, n1, merge_pairs, layer_index=layer_index, kernels=kernels,
                mm_dtype=compute_dtype,
            )
            return outT.permute(3, 1, 2, 0)
        _record_fallback(n, n1, in_size, out_size, core, x)
    elif backend != "xla":
        raise ValueError(f"eps backend is xla or pallas, not {backend!r}")
    views = window_views(x, kernel_size)
    if custom_vjp:
        return EPSContract.apply(core, n1, md, *views)
    u = _round(khatri_rao(views[:n1]), md)  # (B, H', W', Q^n1)
    t = u @ _round(core.reshape(in_size**n1, in_size ** (n - n1) * out_size), md)
    if n1 == n:
        return t
    v = _round(khatri_rao(views[n1:]), md)  # (B, H', W', Q^n2)
    t = t.reshape(*t.shape[:-1], in_size ** (n - n1), out_size)
    return torch.sum(v[..., :, None] * t, dim=-2)


def eps_one_by_one(core: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Absorb one window factor at a time (the oracle, eps.py:367-388):
    memory-light, K²·C small contractions."""
    num_channels, batch, height, width, in_size = x.shape
    kernel_size = _infer_kernel_size(core, num_channels)
    if core.shape[:-1] != (in_size,) * (kernel_size**2 * num_channels):
        raise ValueError(f"core shape {tuple(core.shape)} does not fit input Q={in_size}")
    intermediate = None
    for view in window_views(x, kernel_size):
        if intermediate is None:
            intermediate = torch.tensordot(view, core, dims=([3], [0]))
        else:
            intermediate = torch.einsum("bhwi,bhwi...->bhw...", view, intermediate)
    out_h, out_w = out_spatial(height, width, kernel_size)
    assert tuple(intermediate.shape) == (batch, out_h, out_w, core.shape[-1])
    return intermediate


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


# ---------------------------------------------------------------------------
# dataset-scale application


def transform_in_slices(
    core: torch.Tensor, x: torch.Tensor, batch_size: int = 128, plain: bool = False
) -> torch.Tensor:
    """Apply the EPS ``core`` to a whole dataset ``x`` (C, N, H, W, Q) in
    slices of ``batch_size`` images, without gradients: (1, N, H', W', O)
    (eps.py:454-470). On a CUDA tensor each slice runs the forward kernel
    (K1, ``eps_apply_t_cmt`` on the core's cmt), as training does, where
    K1 takes the layer; on the CPU, with ``plain`` (the runners' xla
    backend), or for a layer outside K1's plan (recorded as a fallback),
    the reference-layout ``eps``."""
    num_channels, n_total, _, _, in_size = x.shape
    kernel_size = _infer_kernel_size(core, num_channels)
    out_size = core.shape[-1]
    n = kernel_size**2 * num_channels
    n1, merge_pairs = plan_call(
        num_channels, in_size, kernel_size, _balanced_split(n, in_size, out_size)
    )
    kernel = not plain and x.device.type != "cpu"
    if kernel and not (core.dtype == torch.float32 and x.dtype == torch.float32
                       and kernels_take_split(num_channels, in_size, kernel_size, n1, out_size,
                                              None, 0, "serve-f32")):
        _record_fallback(n, n1, in_size, out_size, core, x)
        kernel = False
    if not kernel:
        def apply(xs):
            return eps(core, xs)
    else:
        _, q_k, n1_k = _kernel_dims(num_channels, in_size, kernel_size, n1, merge_pairs)
        cmt = _core_to_cmt_k(core, n1_k, q_k)

        def apply(xs):
            outT = eps_apply_t_cmt(
                cmt, xs.permute(0, 4, 2, 3, 1), out_size, kernel_size, n1, merge_pairs,
                layer_index=0,
            )
            return outT.permute(3, 1, 2, 0)

    with torch.no_grad():
        pieces = [apply(x[:, s : s + batch_size]) for s in range(0, n_total, batch_size)]
    return torch.cat(pieces, dim=0)[None]


# ---------------------------------------------------------------------------
# initializers


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


def draw_unit_normal_core(
    generator: torch.Generator,
    kernel_size: int,
    in_num_channels: int,
    in_size: int,
    out_size: int,
    dtype: torch.dtype = torch.float32,
    device="cpu",
) -> torch.Tensor:
    """A core of standard normal entries, drawn on the generator's device,
    then moved to ``device``: the draw of the empirical init
    (eps.py:488-503), which ``scale_to_unit_empirical_output_std`` scales."""
    shape = eps_shape(kernel_size, in_num_channels, in_size, out_size)
    core = torch.randn(shape, generator=generator, dtype=dtype, device=generator.device)
    return core.to(device)


def scale_to_unit_empirical_output_std(
    core: torch.Tensor, x: torch.Tensor, batch_size: int = 128, plain: bool = False
) -> torch.Tensor:
    """``core`` rescaled by 1/std of its output on ``x`` (C, N, H, W, Q), so
    that the empirical output std is 1 (eps.py:504-527): the population
    (biased) std, each slice's sum and sum of squares taken on the device in
    the run's precision (float64 for a float64 run) and added up in float64
    on the host, with one transfer at the end. ``plain`` as in
    ``transform_in_slices``."""
    sums = []
    count = 0
    for out in transform_in_slices(core, x.to(core.dtype), batch_size, plain)[0].split(batch_size):
        acc = torch.float64 if out.dtype == torch.float64 else torch.float32
        sums.append(torch.stack((out.sum(dtype=acc), (out.to(acc) ** 2).sum())).double())
        count += out.numel()
    total_sum = total_sumsq = 0.0
    for s, ss in torch.stack(sums).cpu().tolist():
        total_sum += s
        total_sumsq += ss
    mean = total_sum / count
    inv_std = (total_sumsq / count - mean**2) ** -0.5
    return core * inv_std
