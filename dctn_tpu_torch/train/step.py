"""The training step over the fast (cmt) parameter layout (port of
``make_fast_train_step``, ``grad_accum_scan``, ``_hoist_reg`` and
``make_gather_batch``, ``dctn_tpu/train/step.py``).

The JAX step is one jitted function of (params, optimizer state, batch);
here the model and the optimizer hold that state, and the step runs
eagerly: forward through the EPS kernels (in int8 with ``qat="int8"``),
cross-entropy, backward through the kernels' ``autograd.Function``, the
regularizer, optimizer update. With gradient accumulation the batch runs as
contiguous microbatches, each forward and backward on its own, so a large
batch's activations (and each layer's saved t) are a microbatch's. Batches
are gathered on the device from the resident split.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ..kernels.eps_kernels import KERNELS, EPSKernels
from ..kernels.eps_q8_kernels import QAT_KERNELS
from ..models.eps_plus_linear import (
    EPSesPlusLinear,
    EPSesPlusLinearConfig,
    epses_composition_l2_regularizer_fast,
    epswise_l2_regularizer_fast,
    saved_t_capped_layers,
)

REG_TYPES = ("epswise", "epses_composition")


def make_fast_train_step(
    model: EPSesPlusLinear,
    optimizer: torch.optim.Optimizer,
    reg_type: str = "epswise",
    reg_coeff: float = 0.0,
    *,
    kernels: Optional[EPSKernels] = None,
    frozen_eps_indices: Sequence[int] = (),
    with_probs: bool = False,
    grad_accum_steps: int = 1,
    qat: Optional[str] = None,
):
    """Returns ``step(xb, yb) → {"loss", "ce", "reg_term"}`` (0-d tensors on
    the model's device, not synchronised), which trains ``model`` one step
    with ``optimizer`` (built over ``model.parameters()``): loss = mean
    cross-entropy + ``reg_coeff``·reg (train/step.py:208-310). ``xb`` is
    (C, B, H, W, Q₀), ``yb`` (B,) class indices. ``reg_type`` is
    ``"epswise"`` (the L2 of every core and of the classifier's weights) or
    ``"epses_composition"`` (the classifier's L2 + the composition's squared
    norm, ``composition.inner_product_cmt``).

    ``grad_accum_steps`` splits the batch, which it must divide, into that
    many contiguous microbatches in batch order (``grad_accum_scan``; 1 is
    the whole batch): each runs the cross-entropy alone, forward and
    backward, and the gradients are summed and then averaged; the
    regularizer's value and gradient are added once afterwards
    (``_hoist_reg``). ``loss`` and ``ce`` are then the microbatches' mean. A layer whose t is over the saved-t cap
    at the whole batch can save it again at a microbatch
    (``resolve_auto_grad_accum``).

    ``kernels`` runs the EPS layers' contractions, ``KERNELS`` by default.
    ``qat="int8"`` picks ``QAT_KERNELS`` instead (the JAX step's
    ``forward_fast_q8train``): each EPS layer's forward in int8 W8A8 on the
    live f32 cores, with straight-through gradients, so the numerics of int8
    serving, not the f32 trajectory. A caller that passes its own bundle
    (``eps_q8_kernels.QAT_PLAIN`` for the plain QAT path) passes no ``qat``.

    The options of the JAX step that are not ported yet are refused."""
    later = {
        "frozen_eps_indices": bool(frozen_eps_indices),
        "with_probs": with_probs,
        "parameter dropout (dropout_p < 1)": model.cfg.dropout_p < 1.0,
    }
    for option, given in later.items():
        if given:
            raise ValueError(
                f"{option} is not ported yet: it comes with the next slice of the "
                "port, the rest of the EPS family and the runner (ROADMAP.md)"
            )
    if grad_accum_steps < 1:
        raise ValueError(f"grad_accum_steps must be at least 1, got {grad_accum_steps}")
    if qat not in (None, "int8"):
        raise ValueError(f"unsupported qat mode {qat!r}")
    if reg_type not in REG_TYPES:
        raise ValueError(f"unknown reg_type {reg_type!r}")
    if kernels is None:
        kernels = KERNELS if qat is None else QAT_KERNELS
    elif qat is not None:
        raise ValueError("qat picks the kernel bundle: pass qat or kernels, not both")

    def reg_fn():
        fast = model.fast_params()
        if reg_type == "epswise":
            return epswise_l2_regularizer_fast(fast)
        return epses_composition_l2_regularizer_fast(fast, model.plans)

    def ce_of(xs, ys):
        return F.cross_entropy(model(xs, kernels=kernels), ys)

    def step(xb: torch.Tensor, yb: torch.Tensor):
        optimizer.zero_grad(set_to_none=True)
        batch = yb.shape[0]
        if batch % grad_accum_steps:
            raise ValueError(
                f"grad_accum_steps={grad_accum_steps} does not divide the batch of {batch}"
            )
        mb = batch // grad_accum_steps
        ce_sum = None
        for i in range(grad_accum_steps):
            ce_i = ce_of(xb[:, i * mb : (i + 1) * mb], yb[i * mb : (i + 1) * mb])
            ce_i.backward()  # adds into each parameter's .grad
            ce_i = ce_i.detach()
            ce_sum = ce_i if ce_sum is None else ce_sum + ce_i
        ce = ce_sum
        if grad_accum_steps > 1:
            inv = 1.0 / grad_accum_steps
            for p in model.parameters():
                p.grad.mul_(inv)
            ce = ce_sum * inv
        if reg_coeff != 0.0:
            reg = reg_fn()
            (reg_coeff * reg).backward()
        else:
            reg = torch.zeros((), dtype=ce.dtype, device=ce.device)
        loss = ce + reg_coeff * reg.detach()
        optimizer.step()
        return {"loss": loss.detach(), "ce": ce.detach(), "reg_term": reg.detach()}

    return step


def resolve_auto_grad_accum(cfg: EPSesPlusLinearConfig, plans, batch: int) -> int:
    """``grad_accum_steps="auto"``: the smallest power of two that divides
    ``batch`` and at which no EPS layer's saved-t backward is held back by
    the cap on t (``saved_t_capped_layers``); 1 when none is. Ported from
    the JAX runner's ``_resolve_auto_grad_accum`` (cli/runner.py:75-95), on
    the port's float32 t: where the TPU's bf16 t fits at twice the
    microbatch, the port may pick twice the steps."""
    s = 1
    while s <= batch:
        if batch % s == 0 and not saved_t_capped_layers(cfg, plans, batch // s):
            return s
        s *= 2
    return 1


def make_gather_batch(x_full: torch.Tensor, y_full: torch.Tensor):
    """Device-side batch gather from the resident split: ``idx`` (B,) →
    (x_full[:, idx], y_full[idx]). The split stays on its device; pass
    ``idx`` on that device too to keep the host out of the loop."""

    def gather(idx):
        idx = torch.as_tensor(idx, device=x_full.device)
        return x_full.index_select(1, idx), y_full.index_select(0, idx)

    return gather
