"""Algebra on a composition of EPS cores (port of
``dctn_tpu/ops/composition.py``): the composition's inner product, in the
reference layout and on the fast (cmt) layout, its sequential application
to an input, the per-core Frobenius norms, and the three initialization
families (theoretical and empirical unit output std, manually chosen)."""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels.eps_kernels import _kernel_dims
from ..utils.misc import (
    FromFileInit,
    OneTensorInit,
    ZeroCenteredNormalInit,
    ZeroCenteredUniformInit,
)
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


def contract_with_input(epses: Sequence[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Apply each core in turn, the singleton channel dim put back between
    layers (composition.py:131-140): ``x`` (C, B, H, W, Q) → (B, H', W',
    Q_out). The plain reference-layout ``eps``."""
    intermediate = x
    for core in epses[:-1]:
        intermediate = eps_mod.eps(core, intermediate)[None]
    return eps_mod.eps(epses[-1], intermediate)


def epswise_squared_fro_norm(epses: Sequence[torch.Tensor]) -> torch.Tensor:
    """Σ‖core‖²_F over the composition (composition.py:143-146)."""
    return sum(torch.sum(core**2) for core in epses)


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


def make_unit_empirical_output_std(
    generator: Optional[torch.Generator],
    epses_specs: Sequence[Tuple[int, int]],
    x: torch.Tensor,
    dtype: torch.dtype = torch.float32,
    batch_size: int = 128,
    unit_cores: Optional[Sequence[torch.Tensor]] = None,
    plain: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """The data-dependent init (composition.py:167-186): per layer, a
    unit-normal core rescaled so that its output on the init subset has std
    1, then the subset transformed by the scaled core into the next layer's
    input. ``x`` (C, N, H, W, Q) on the device the cores are made on. The
    unit-normal cores are drawn from ``generator`` in layer order, unless
    ``unit_cores`` gives them (the JAX package's draws, in the tests).
    ``plain`` pushes the subset through the reference-layout ``eps`` also
    on a card (``eps.transform_in_slices``)."""
    epses = []
    x = x.to(dtype)
    for i, (kernel_size, out_size) in enumerate(epses_specs):
        num_channels, _, _, _, in_size = x.shape
        if unit_cores is None:
            core = eps_mod.draw_unit_normal_core(
                generator, kernel_size, num_channels, in_size, out_size, dtype, x.device
            )
        else:
            core = unit_cores[i].to(x.device, dtype)
        core = eps_mod.scale_to_unit_empirical_output_std(core, x, batch_size, plain)
        x = eps_mod.transform_in_slices(core, x, batch_size, plain)
        epses.append(core)
    return tuple(epses)


def make_manually_chosen(
    generator: torch.Generator,
    epses_specs: Sequence[Tuple[int, int]],
    initializations: Sequence[OneTensorInit],
    initial_in_size: int,
    dtype: torch.dtype = torch.float32,
    device="cpu",
) -> Tuple[torch.Tensor, ...]:
    """Per-core normal, uniform or from-file init (composition.py:189-219),
    drawn in layer order from ``generator`` on its device, then moved to
    ``device``. A file is an ``np.save`` of the core in the reference
    layout."""
    if len(epses_specs) != len(initializations):
        raise ValueError(f"{len(initializations)} inits for {len(epses_specs)} cores")
    cores = []
    for spec, init in zip(specs_to_full_specs(epses_specs, initial_in_size), initializations):
        shape = eps_mod.eps_shape(**spec)
        kw = {"generator": generator, "dtype": dtype, "device": generator.device}
        if isinstance(init, ZeroCenteredNormalInit):
            core = torch.randn(shape, **kw) * init.std
        elif isinstance(init, ZeroCenteredUniformInit):
            core = (torch.rand(shape, **kw) * 2.0 - 1.0) * init.maximum
        elif isinstance(init, FromFileInit):
            core = torch.as_tensor(np.load(init.path), dtype=dtype)
            if tuple(core.shape) != shape:
                raise ValueError(f"{init.path}: core shape {tuple(core.shape)}, the model needs {shape}")
        else:
            raise ValueError(f"unknown initialization {init!r}")
        cores.append(core.to(device))
    return tuple(cores)
