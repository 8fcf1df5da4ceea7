"""The training steps (port of ``make_fast_train_step``,
``make_train_step``, ``grad_accum_scan``, ``_hoist_reg`` and
``make_gather_batch``, ``dctn_tpu/train/step.py``): over the fast (cmt)
parameter layout through the EPS kernels, and over the reference layout
through the plain ``eps`` (the runners' xla backend).

The JAX step is one jitted function of (params, optimizer state, batch);
here the model and the optimizer hold that state, and the step runs
eagerly: parameter dropout's masks, forward through the EPS kernels (in
int8 with ``qat="int8"``), cross-entropy, backward through the kernels'
``autograd.Function``, the regularizer, frozen cores' gradients set to 0,
optimizer update. With gradient accumulation the batch runs as contiguous
microbatches, each forward and backward on its own, so a large batch's
activations (and each layer's saved t) are a microbatch's. Batches are
gathered on the device from the resident split.

``with_probs`` adds each sample's probability of its true class to the
metrics (``probs_of_true_class``, a device tensor in batch order, gathered
over the microbatches): it is computed from the detached logits, so the
update is the same bits with or without it, and nothing is read back.
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
    EPSesPlusLinearReference,
    draw_dropout_masks,
    eps_plus_linear_forward,
    eps_plus_linear_forward_fast,
    epses_composition_l2_regularizer,
    epses_composition_l2_regularizer_fast,
    epswise_l2_regularizer,
    epswise_l2_regularizer_fast,
    saved_t_capped_layers,
)

REG_TYPES = ("epswise", "epses_composition")
# the regularizers on the reference layout, by --reg-type (train/step.py:26-29)
REGULARIZERS = {
    "epswise": epswise_l2_regularizer,
    "epses_composition": epses_composition_l2_regularizer,
}


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
    collective=None,
    pixel_scale: int = 1,
):
    """Returns ``step(xb, yb, generator=None, masks=None) → {"loss", "ce",
    "reg_term"}`` (0-d tensors on the model's device, not synchronised),
    which trains ``model`` one step with ``optimizer`` (built over
    ``model.parameters()``): loss = mean cross-entropy + ``reg_coeff``·reg
    (train/step.py:208-310). ``xb`` is (C, B, H, W, Q₀), ``yb`` (B,) class
    indices. ``reg_type`` is ``"epswise"`` (the L2 of every core and of the
    classifier's weights) or ``"epses_composition"`` (the classifier's L2 +
    the composition's squared norm, ``composition.inner_product_cmt``).

    ``grad_accum_steps`` splits the batch, which it must divide, into that
    many contiguous microbatches in batch order (``grad_accum_scan``; 1 is
    the whole batch): each runs the cross-entropy alone, forward and
    backward, and the gradients are summed and then averaged; the
    regularizer's value and gradient are added once afterwards
    (``_hoist_reg``). ``loss`` and ``ce`` are then the microbatches' mean. A layer whose t is over the saved-t cap
    at the whole batch can save it again at a microbatch
    (``resolve_auto_grad_accum``).

    Parameter dropout (``model.cfg.dropout_p`` < 1) draws each
    microbatch's masks from ``generator`` (``draw_dropout_masks``, on the
    model's device), or takes them from ``masks``: one tuple of
    reference-shape masks per microbatch. The forward runs on the dropped
    cores, the gradient is the undropped cores'.

    ``frozen_eps_indices`` name cores that do not train: the forward takes
    them detached, so their ``eps_dcore`` is never launched (a frozen layer
    after a trained one still computes its input's cotangent), and their
    gradient is set to 0 before the update, as the JAX step zeros it
    (``mask_frozen``, train/step.py:264-270): with weight decay the
    optimizer still moves them by the decay alone.

    ``kernels`` runs the EPS layers' contractions, ``KERNELS`` by default.
    ``qat="int8"`` picks ``QAT_KERNELS`` instead (the JAX step's
    ``forward_fast_q8train``): each EPS layer's forward in int8 W8A8 on the
    live f32 cores (after dropout), with straight-through gradients, so the
    numerics of int8 serving, not the f32 trajectory. A caller that passes
    its own bundle (``eps_q8_kernels.QAT_PLAIN`` for the plain QAT path)
    passes no ``qat``. The model's ``cfg.compute_dtype`` is every EPS
    layer's operand dtype (bf16 runs the kernels' bf16 mode); under ``qat``
    a bf16 one is the JAX bf16 QAT step's: the int8 forward on the float32
    cores, its saved t stored in bf16, the backward in the bf16 mode.

    ``with_probs`` adds ``probs_of_true_class`` (see the module docstring).

    ``collective`` and ``pixel_scale`` make it one rank's step of the
    data-parallel step (``parallel.data_parallel``): see
    ``_accumulating_step``, and ``eps_apply_t_cmt`` for ``pixel_scale``."""
    frozen = frozenset(frozen_eps_indices)
    n_layers = len(model.cmts)
    if any(not 0 <= i < n_layers for i in frozen):
        raise ValueError(f"frozen_eps_indices {sorted(frozen)} outside the model's {n_layers} cores")
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
    cfg, plans = model.cfg, model.plans

    def reg_fn():
        fast = model.fast_params()
        if reg_type == "epswise":
            return epswise_l2_regularizer_fast(fast)
        return epses_composition_l2_regularizer_fast(fast, plans)

    def logits_of(xs, masks_i):
        fast = model.fast_params()
        if frozen:
            fast = {**fast, "epses_cmt": tuple(
                c.detach() if i in frozen else c for i, c in enumerate(fast["epses_cmt"])
            )}
        return eps_plus_linear_forward_fast(fast, xs, cfg, plans, kernels=kernels, masks=masks_i,
                                            pixel_scale=pixel_scale)

    def zero_frozen():
        for i in frozen:
            model.cmts[i].grad = torch.zeros_like(model.cmts[i])

    return _accumulating_step(model, optimizer, logits_of, reg_fn, reg_coeff, grad_accum_steps,
                              with_probs, plans, cfg.dropout_p, zero_frozen, collective)


def _accumulating_step(model, optimizer, logits_of, reg_fn, reg_coeff, grad_accum_steps,
                       with_probs, plans, dropout_p, zero_frozen, collective=None):
    """The step both layouts share: per microbatch its dropout masks, the
    forward (``logits_of(xs, masks)``), cross-entropy and backward; the
    gradients averaged, the regularizer once (``_hoist_reg``), frozen cores'
    gradients zeroed (``zero_frozen``), the update.

    With a ``collective`` (``parallel.data_parallel.GradAllReduce``) it is
    one rank's step of the data-parallel step: after the local
    accumulation, ``collective.mean(params, ce)`` averages the
    cross-entropy's gradients and the cross-entropy over the ranks in one
    all-reduce; the regularizer, identical on every rank, is added after it,
    and ``collective.gather`` concatenates the ranks' probabilities. A
    collective with ``reg_inside`` (``parallel.collectives.GridGradReduce``,
    the tensor- and spatial-parallel steps) takes the regularizer's
    gradient into its reduction: ``reg_fn`` then gives each rank's local
    form of it, whose value is the whole regularizer."""
    dropout = dropout_p < 1.0

    def step(xb: torch.Tensor, yb: torch.Tensor, generator=None, masks=None):
        if dropout and generator is None and masks is None:
            raise ValueError("parameter dropout (dropout_p < 1) needs a generator or masks")
        optimizer.zero_grad(set_to_none=True)
        batch = yb.shape[0]
        if batch % grad_accum_steps:
            raise ValueError(
                f"grad_accum_steps={grad_accum_steps} does not divide the batch of {batch}"
            )
        mb = batch // grad_accum_steps
        ce_sum = None
        probs = []
        for i in range(grad_accum_steps):
            masks_i = None
            if dropout:
                masks_i = masks[i] if masks is not None else draw_dropout_masks(
                    plans, dropout_p, generator
                )
            ys = yb[i * mb : (i + 1) * mb]
            logits = logits_of(xb[:, i * mb : (i + 1) * mb], masks_i)
            ce_i = F.cross_entropy(logits, ys)
            ce_i.backward()  # adds into each parameter's .grad
            if with_probs:
                probs.append(torch.exp(-F.cross_entropy(logits.detach(), ys, reduction="none")))
            ce_i = ce_i.detach()
            ce_sum = ce_i if ce_sum is None else ce_sum + ce_i
        ce = ce_sum
        if grad_accum_steps > 1:
            inv = 1.0 / grad_accum_steps
            for p in model.parameters():
                if p.grad is not None:
                    p.grad.mul_(inv)
            ce = ce_sum * inv
        reg_inside = getattr(collective, "reg_inside", False)
        if collective is not None and not reg_inside:
            ce = collective.mean(list(model.parameters()), ce)
        if reg_coeff != 0.0:
            reg = reg_fn()
            (reg_coeff * reg).backward()
        else:
            reg = torch.zeros((), dtype=ce.dtype, device=ce.device)
        if reg_inside:
            ce = collective.mean(list(model.parameters()), ce)
        zero_frozen()
        loss = ce + reg_coeff * reg.detach()
        optimizer.step()
        metrics = {"loss": loss.detach(), "ce": ce.detach(), "reg_term": reg.detach()}
        if with_probs:
            probs = torch.cat(probs)
            metrics["probs_of_true_class"] = (
                probs if collective is None else collective.gather(probs))
        return metrics

    return step


def make_train_step(
    model: EPSesPlusLinearReference,
    optimizer: torch.optim.Optimizer,
    reg_type: str = "epses_composition",
    reg_coeff: float = 0.0,
    *,
    frozen_eps_indices: Sequence[int] = (),
    with_probs: bool = False,
    grad_accum_steps: int = 1,
    collective=None,
):
    """The step over the reference layout (``make_train_step``,
    train/step.py:116-206): ``model`` holds the cores as
    (Q,)*(K²·C) + (O,) tensors and every layer runs through ``eps`` on
    ``model.backend``: ``"xla"``, the plain path (its products
    ``torch.matmul``, its backward ``EPSContract``), the runners' xla
    backend; ``"pallas"``, the kernels where they take a layer (a model
    without a fast layout, ``FastLayoutUnavailable``). Returns the same ``step``
    as ``make_fast_train_step``, with the same options: dropout masks drawn
    over the reference shapes from the step's generator, frozen cores
    detached with their gradients zeroed, accumulation in contiguous
    microbatches with the regularizer added once, ``with_probs``, and a
    data-parallel rank's ``collective``."""
    frozen = frozenset(frozen_eps_indices)
    n_layers = len(model.cores)
    if any(not 0 <= i < n_layers for i in frozen):
        raise ValueError(f"frozen_eps_indices {sorted(frozen)} outside the model's {n_layers} cores")
    if grad_accum_steps < 1:
        raise ValueError(f"grad_accum_steps must be at least 1, got {grad_accum_steps}")
    if reg_type not in REG_TYPES:
        raise ValueError(f"unknown reg_type {reg_type!r}")
    cfg = model.cfg
    plans = tuple({"core_shape": tuple(c.shape)} for c in model.cores)

    def reg_fn():
        return REGULARIZERS[reg_type](model.reference_params())

    def logits_of(xs, masks_i):
        params = model.reference_params()
        if frozen:
            params = {**params, "epses": tuple(
                c.detach() if i in frozen else c for i, c in enumerate(params["epses"])
            )}
        return eps_plus_linear_forward(params, xs, cfg, masks=masks_i, backend=model.backend)

    def zero_frozen():
        for i in frozen:
            model.cores[i].grad = torch.zeros_like(model.cores[i])

    return _accumulating_step(model, optimizer, logits_of, reg_fn, reg_coeff, grad_accum_steps,
                              with_probs, plans, cfg.dropout_p, zero_frozen, collective)


def resolve_auto_grad_accum(cfg: EPSesPlusLinearConfig, plans, batch: int) -> int:
    """``grad_accum_steps="auto"``: the smallest power of two that divides
    ``batch`` and at which no EPS layer's saved-t backward is held back by
    the cap on t (``saved_t_capped_layers``); 1 when none is. Ported from
    the JAX runner's ``_resolve_auto_grad_accum`` (cli/runner.py:75-95),
    with t counted in its storage dtype: bf16 under ``cfg.compute_dtype``
    bf16, which picks what the JAX runner picks on the TPU (2 for the deep
    model at batch 2048), float32 otherwise (4 there)."""
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
