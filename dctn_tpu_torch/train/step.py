"""The training step over the fast (cmt) parameter layout (port of
``make_fast_train_step`` and ``make_gather_batch``, ``dctn_tpu/train/step.py``).

The JAX step is one jitted function of (params, optimizer state, batch);
here the model and the optimizer hold that state, and the step runs
eagerly: forward through the EPS kernels (in int8 with ``qat="int8"``),
cross-entropy plus the epswise regularizer, backward through the kernels'
``autograd.Function``, optimizer update. Batches are gathered on the device
from the resident split.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ..kernels.eps_kernels import KERNELS, EPSKernels
from ..kernels.eps_q8_kernels import QAT_KERNELS
from ..models.eps_plus_linear import EPSesPlusLinear, epswise_l2_regularizer_fast


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
    cross-entropy + ``reg_coeff``·epswise L2 (train/step.py:208-310, the
    ``grad_accum_steps == 1`` branch). ``xb`` is (C, B, H, W, Q₀), ``yb``
    (B,) class indices.

    ``kernels`` runs the EPS layers' contractions, ``KERNELS`` by default.
    ``qat="int8"`` picks ``QAT_KERNELS`` instead (the JAX step's
    ``forward_fast_q8train``): each EPS layer's forward in int8 W8A8 on the
    live f32 cores, with straight-through gradients, so the numerics of int8
    serving, not the f32 trajectory. A caller that passes its own bundle
    (``eps_q8_kernels.QAT_PLAIN`` for the plain QAT path) passes no ``qat``.

    The options of the JAX step that belong to later slices are refused."""
    later = {
        "reg_type='epses_composition'": reg_type == "epses_composition",
        "frozen_eps_indices": bool(frozen_eps_indices),
        "with_probs": with_probs,
        "grad_accum_steps > 1": grad_accum_steps != 1,
        "parameter dropout (dropout_p < 1)": model.cfg.dropout_p < 1.0,
    }
    for option, given in later.items():
        if given:
            raise ValueError(
                f"{option} is not ported yet: it comes with the runner and the "
                "rest of the training stack (ROADMAP slice 3)"
            )
    if qat not in (None, "int8"):
        raise ValueError(f"unsupported qat mode {qat!r}")
    if reg_type != "epswise":
        raise ValueError(f"unknown reg_type {reg_type!r}")
    if kernels is None:
        kernels = KERNELS if qat is None else QAT_KERNELS
    elif qat is not None:
        raise ValueError("qat picks the kernel bundle: pass qat or kernels, not both")

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
