"""The training step over the fast (cmt) parameter layout (port of
``make_fast_train_step`` and ``make_gather_batch``, ``dctn_tpu/train/step.py``).

The JAX step is one jitted function of (params, optimizer state, batch);
here the model and the optimizer hold that state, and the step runs
eagerly: forward through the EPS kernels, cross-entropy plus the epswise
regularizer, backward through the kernels' ``autograd.Function``, optimizer
update. Batches are gathered on the device from the resident split.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ..kernels.eps_kernels import KERNELS, EPSKernels
from ..models.eps_plus_linear import EPSesPlusLinear, epswise_l2_regularizer_fast


def make_fast_train_step(
    model: EPSesPlusLinear,
    optimizer: torch.optim.Optimizer,
    reg_type: str = "epswise",
    reg_coeff: float = 0.0,
    *,
    kernels: EPSKernels = KERNELS,
    frozen_eps_indices: Sequence[int] = (),
    with_probs: bool = False,
    grad_accum_steps: int = 1,
    qat: Optional[str] = None,
):
    """Returns ``step(xb, yb) → {"loss", "ce", "reg_term"}`` (0-d tensors on
    the model's device, not synchronised), which trains ``model`` one step
    with ``optimizer`` (built over ``model.parameters()``): loss = mean
    cross-entropy + ``reg_coeff``·epswise L2 (train/step.py:208-310, the
    ``grad_accum_steps == 1`` branch). ``xb`` is (C, B, H, W, Q₀), ``yb``
    (B,) class indices. ``kernels`` runs the EPS layers' contractions.

    The options of the JAX step that belong to later slices are refused."""
    later = {
        "reg_type='epses_composition'": reg_type == "epses_composition",
        "frozen_eps_indices": bool(frozen_eps_indices),
        "with_probs": with_probs,
        "grad_accum_steps > 1": grad_accum_steps != 1,
    }
    for option, given in later.items():
        if given:
            raise ValueError(
                f"{option} is not ported yet: it comes with the runner and the "
                "rest of the training stack (ROADMAP slice 3)"
            )
    if qat is not None:
        raise ValueError(f"qat={qat!r} is not ported yet: it comes with int8 and QAT (ROADMAP slice 5)")
    if reg_type != "epswise":
        raise ValueError(f"unknown reg_type {reg_type!r}")

    def step(xb: torch.Tensor, yb: torch.Tensor):
        optimizer.zero_grad(set_to_none=True)
        logits = model(xb, kernels=kernels)
        ce = F.cross_entropy(logits, yb)
        if reg_coeff != 0.0:
            reg = epswise_l2_regularizer_fast(model.fast_params())
        else:
            reg = torch.zeros((), dtype=logits.dtype, device=logits.device)
        loss = ce + reg_coeff * reg
        loss.backward()
        optimizer.step()
        return {"loss": loss.detach(), "ce": ce.detach(), "reg_term": reg.detach()}

    return step


def make_gather_batch(x_full: torch.Tensor, y_full: torch.Tensor):
    """Device-side batch gather from the resident split: ``idx`` (B,) →
    (x_full[:, idx], y_full[idx]). The split stays on its device; pass
    ``idx`` on that device too to keep the host out of the loop."""

    def gather(idx):
        idx = torch.as_tensor(idx, device=x_full.device)
        return x_full.index_select(1, idx), y_full.index_select(0, idx)

    return gather
