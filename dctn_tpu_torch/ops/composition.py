"""Initializers of a composition of EPS cores (port of the part of
``dctn_tpu/ops/composition.py`` that the serving path needs)."""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from . import eps as eps_mod


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
