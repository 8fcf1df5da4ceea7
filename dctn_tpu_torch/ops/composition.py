"""Algebra on a composition of EPS cores (port of the part of
``dctn_tpu/ops/composition.py`` that serving and training need): the
composition's inner product, in the reference layout and on the fast (cmt)
layout, and the unit-theoretical-output-std initializer."""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from ..kernels.eps_kernels import _kernel_dims
from . import eps as eps_mod


def inner_product(
    epses1: Sequence[torch.Tensor], epses2: Sequence[torch.Tensor]
) -> torch.Tensor:
    """The tensor-network inner product of two compositions of EPS cores
    (composition.py:31-47): corresponding cores share shapes. Each step
    absorbs the first pair's contraction over their input dims into the next
    core of the first composition."""
    if len(epses1) != len(epses2):
        raise ValueError(f"compositions of {len(epses1)} and {len(epses2)} cores")
    epses1, epses2 = tuple(epses1), tuple(epses2)
    if len(epses1) == 1:
        return eps_mod.inner_product(epses1[0], epses2[0])
    x = eps_mod.contract_on_input_dims(epses1[0], epses2[0])  # (out_a, out_k)
    new_d = eps_mod.absorb_on_input_dims(epses1[1], x)
    return inner_product((new_d,) + epses1[2:], epses2[1:])


def inner_product_cmt(cmts: Sequence[torch.Tensor], plans) -> torch.Tensor:
    """``inner_product(epses, epses)`` on the fast (cmt) layout, with no
    N-D core formed (composition.py:50-108): with W_k the layer-k cmt as
    (O_k, B_k, A_k) and M_k the (O_k, O_k) Gram matrix of the composition
    cut after layer k,

        M_1[o, o'] = Σ_{b,a} W[o,b,a]·W[o',b,a]
        M_{k+1}    = Σ W·(M_k^{⊗n} on every input leg of W)·W,

    the A legs through one (Z, A)×(A, A) product, the B legs through one
    batched product; a merged factor pair (a q = 2 layer) takes M⊗M.
    Returns trace(M_L) = ‖e_1 ∘ … ∘ e_L‖². Small matrix products outside any
    kernel, left to ``torch.matmul`` as the JAX package leaves them to XLA."""
    m_prev = None
    for w, p in zip(cmts, plans):
        n_k, q_k, n1_k = _kernel_dims(p["c"], p["q"], p["kernel_size"], p["n1"], p["merge_pairs"])
        n2_k = n_k - n1_k
        o = p["out_size"]
        a_dim, b_dim = q_k**n1_k, q_k**n2_k
        w3 = w.reshape(o, b_dim, a_dim)
        if m_prev is None:
            m_prev = torch.einsum("oba,pba->op", w3, w3)
            continue
        legs = 2 if p["merge_pairs"] else 1
        y3 = (w @ eps_mod.kron_power(m_prev, n1_k * legs)).reshape(o, b_dim, a_dim)
        if n2_k:
            # (o, A, B'): the contracted B leg lands last
            ym = torch.einsum("oba,bc->oac", y3, eps_mod.kron_power(m_prev, n2_k * legs))
            m_prev = torch.einsum("oba,pab->op", w3, ym)
        else:
            m_prev = torch.einsum("oba,pba->op", w3, y3)
    return torch.trace(m_prev)


def specs_to_full_specs(
    epses_specs: Sequence[Tuple[int, int]], initial_in_size: int
) -> Tuple[Dict[str, int], ...]:
    """(kernel_size, out_size) pairs → full per-layer shape specs; each
    layer's in_size is the previous layer's out_size."""
    in_sizes = (initial_in_size,) + tuple(o for _, o in epses_specs)[:-1]
    return tuple(
        {"kernel_size": k, "in_num_channels": 1, "in_size": i, "out_size": o}
        for (k, o), i in zip(epses_specs, in_sizes)
    )


def make_unit_theoretical_output_std(
    generator: torch.Generator,
    epses_specs: Sequence[Tuple[int, int]],
    initial_in_size: int,
    dtype: torch.dtype = torch.float32,
    device="cpu",
) -> Tuple[torch.Tensor, ...]:
    """One unit-theoretical-output-std core per layer (composition.py:153),
    drawn in layer order from ``generator``."""
    return tuple(
        eps_mod.make_eps_unit_theoretical_output_std(
            generator, dtype=dtype, device=device, **spec
        )
        for spec in specs_to_full_specs(epses_specs, initial_in_size)
    )
