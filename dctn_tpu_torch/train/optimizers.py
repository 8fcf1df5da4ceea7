"""Optimizers, with the reference's torch semantics (port of
``dctn_tpu/train/optimizers.py``).

The reference trains with ``torch.optim.Adam`` / ``SGD``, whose
``weight_decay`` adds wd·param to the gradient BEFORE the moment updates:
classic L2 regularization, not decoupled AdamW. The JAX package chains
``optax.add_decayed_weights`` ahead of ``scale_by_adam`` to match it; here
the torch optimizers are that reference itself.
"""

from __future__ import annotations

from typing import Iterable

import torch


def make_optimizer(
    name: str, params: Iterable[torch.Tensor], lr: float, weight_decay: float = 0.0
) -> torch.optim.Optimizer:
    """``"adam"`` (β = (0.9, 0.999), ε = 1e-8) or ``"sgd"`` over ``params``."""
    name = name.lower()
    if name == "adam":
        return torch.optim.Adam(
            params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay
        )
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr, weight_decay=weight_decay)
    raise ValueError(f"unknown optimizer {name!r}")
