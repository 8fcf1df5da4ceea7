"""Spatial parallelism (SP) for EPSesPlusLinear (port of
``dctn_tpu/parallel/spatial_parallel.py``): the image HEIGHT sharded over
the ``space`` axis of a ``(data, space, model)`` grid of ranks
(``mesh.GridMesh``) whose model axis has one rank, with one halo exchange
per EPS layer, composable with the data axis. It is for images whose
activations one card cannot hold: an EPS layer's Khatri-Rao vectors and its
t grow with B·H·W.

As in JAX:

- the input (C, B, H, W, Q) is zero-padded at the bottom to P·Hl rows, Hl =
  ⌈H/P⌉, and space rank d holds rows [d·Hl, (d+1)·Hl) (``sp_shard_batch``,
  ``sp_shard_split``). Before each layer a rank receives the first K−1 rows
  of the next rank's block (``collectives.with_halo``; the last rank zeros,
  the bottom padding) and runs the layer on the slab of Hl+K−1 rows, which
  gives Hl rows: every layer keeps Hl rows a rank;
- validity is positional: after layer i the valid global rows are H −
  Σ_{j≤i}(K_j−1), and a row is valid iff its window touches only valid
  rows, so the garbage rows at the global bottom (finite: zeros in, a
  polynomial out) never reach a valid one;
- the classifier masks by construction: the reference weight (rows (h, w,
  o)) is zero-padded along h to P·Hl rows and each rank contracts its own
  h-slice, so garbage rows meet zero weights; the partial logits are summed
  over ``space``.

Gradients (``collectives.GridGradReduce``): the cores and the classifier's
weight see only this rank's windows and rows, so their gradients are
summed over ``space``, then averaged over ``data``; the bias enters after
the logits' sum and is whole on every rank. The regularizer (of the
replicated parameters) enters each rank's loss divided by P, so that the
sum counts it once. Dropout masks are the one-device masks (the same
generator on every rank).

The fast (cmt) layout runs the kernels on each slab (``sp_fast_forward``),
the f32 path planning each layer's backward on the slab's own pixels, as
JAX's ``plan_pallas_call`` does; under QAT (K8/K9) the saved-t arm is
decided on the global shapes (the whole valid height, every data rank's
batch), so that every rank and one card take the same STE backward. Both
layouts run in ``cfg.compute_dtype``'s operands (spatial_parallel.py:211,
:367-377): bf16 is the kernels' bf16 mode on each slab (the plain ``eps``'s
rounding on the xla backend), as on one card.

Constraint: K−1 ≤ Hl for every layer (a halo comes from one neighbour):
``sp_check_config`` refuses the rest.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.eps_kernels import KERNELS, eps_apply_t_cmt
from ..kernels.eps_q8_kernels import QAT_KERNELS
from ..models.eps_plus_linear import (
    EPSesPlusLinearConfig,
    dropout_cmts,
    dropout_epses,
    epses_composition_l2_regularizer_fast,
    epswise_l2_regularizer_fast,
)
from ..ops import eps as eps_mod
from ..train.evaluation import score_sharded
from ..train.step import REG_TYPES, REGULARIZERS, _accumulating_step
from .collectives import GridGradReduce, grad_scaled, psum_value_only, with_halo
from .data_parallel import ShardedSplit, shard_split


def sp_local_rows(image_size: int, n_space: int) -> int:
    """Rows a rank holds: Hl = ⌈H/P⌉ (the input is bottom-padded to P·Hl)."""
    return -(-image_size // n_space)


def sp_check_config(cfg: EPSesPlusLinearConfig, n_space: int) -> int:
    """The single-hop halo constraint (a layer's K−1 rows come from one
    neighbour); returns Hl."""
    hl = sp_local_rows(cfg.image_size, n_space)
    for k, _ in cfg.epses_specs:
        if k - 1 > hl:
            raise ValueError(
                f"spatial axis {n_space} too large: kernel {k} needs a "
                f"{k - 1}-row halo but each device holds only {hl} rows"
            )
    return hl


def pad_rows(x, n_space: int, row_axis: int = 2):
    """Zero-pad the height axis (numpy or torch) to a multiple of the
    space axis's size."""
    pad = (-x.shape[row_axis]) % n_space
    if pad == 0:
        return x
    if isinstance(x, torch.Tensor):
        widths = [0, 0] * (x.ndim - 1 - row_axis) + [0, pad]
        return F.pad(x, widths)
    widths = [(0, 0)] * x.ndim
    widths[row_axis] = (0, pad)
    return np.pad(x, widths)


def sp_row_block(x, mesh, row_axis: int = 2):
    """This space rank's block of the rows of ``x`` (numpy or torch)
    bottom-padded to a multiple of the space axis's size."""
    n, j = mesh.size("space"), mesh.index("space")
    x = pad_rows(x, n, row_axis)
    hl = x.shape[row_axis] // n
    idx = [slice(None)] * x.ndim
    idx[row_axis] = slice(j * hl, (j + 1) * hl)
    return x[tuple(idx)]


def sp_shard_batch(mesh, x, y=None):
    """A global batch (C, B, H, W, Q) → this rank's part, on its device:
    its data shard of the images (B / n_data of them) and its space block
    of their bottom-padded rows; with ``y`` (B,) also its labels."""
    b = x.shape[1] // mesh.n_data
    lo = mesh.data_index * b
    xs = sp_row_block(x[:, lo : lo + b], mesh)
    xs = torch.as_tensor(np.ascontiguousarray(xs) if isinstance(xs, np.ndarray) else
                         xs.contiguous(), device=mesh.device)
    if y is None:
        return xs
    return xs, torch.as_tensor(y[lo : lo + b], device=mesh.device)


def sp_shard_split(mesh, x: np.ndarray, y: np.ndarray) -> ShardedSplit:
    """A split (C, N, H, W, Q) sharded as ``shard_split`` shards it over the
    data axis, each sample's rows padded and cut to this rank's space
    block."""
    return shard_split(mesh, np.ascontiguousarray(sp_row_block(x, mesh)), y)


# ---------------------------------------------------------------------------
# forward


def _classifier_weight(w, cfg: EPSesPlusLinearConfig, mesh, hl: int, *inner):
    """This rank's h-slice of the classifier's weight, the weight reshaped to
    (V, *inner, classes) and zero-padded along h to P·Hl rows (Hl: the rows
    a rank's features have; V itself on a space axis of one rank)."""
    v = cfg.pre_linear_image_size
    w4 = w.reshape(v, *inner, cfg.num_classes)
    w4 = F.pad(w4, [0, 0] * (w4.ndim - 1) + [0, mesh.size("space") * hl - v])
    j = mesh.index("space")
    return w4[j * hl : (j + 1) * hl]


def sp_forward(params, x: torch.Tensor, cfg: EPSesPlusLinearConfig, mesh, masks=None,
               backend: str = "xla") -> torch.Tensor:
    """One rank's SP forward over the reference layout (``_sp_forward_local``):
    ``x`` (C, B, Hl, W, Q₀), this rank's rows → the whole logits (B,
    classes). ``masks`` apply parameter dropout; ``backend`` is
    ``ops.eps``'s."""
    sp_check_config(cfg, mesh.size("space"))
    epses = params["epses"]
    if masks is not None:
        epses = dropout_epses(epses, cfg.dropout_p, masks)
    h = x
    for core in epses:
        k = eps_mod._infer_kernel_size(core, h.shape[0])
        h = eps_mod.eps(core, with_halo(h, k, mesh, row_axis=2), backend=backend,
                        compute_dtype=cfg.compute_dtype)[None]
    feats = h[0]  # (B, Hl, W', O)
    b, hl, wl, o = feats.shape
    w_loc = _classifier_weight(params["linear"]["w"], cfg, mesh, hl, wl * o)
    partial = feats.reshape(b, hl * wl * o) @ w_loc.reshape(hl * wl * o, cfg.num_classes)
    return psum_value_only(partial, mesh, "space") + params["linear"]["b"]


def sp_fast_forward(fast, x: torch.Tensor, cfg: EPSesPlusLinearConfig, plans, mesh, masks=None,
                    qat: Optional[str] = None) -> torch.Tensor:
    """One rank's SP forward over the fast (cmt) layout
    (``_sp_fast_forward_local``): each layer's kernels on the slab of
    Hl+K−1 rows, in the transposed batch-minor layout (the halo moves rows,
    a middle dim); ``qat="int8"`` the W8A8 forward, its saved-t arm decided
    on the valid global height and every data rank's batch."""
    sp_check_config(cfg, mesh.size("space"))
    cmts = fast["epses_cmt"]
    if masks is not None:
        cmts = dropout_cmts(cmts, plans, cfg.dropout_p, masks)
    kernels = KERNELS if qat is None else QAT_KERNELS
    b, ww = x.shape[1], x.shape[3]
    hg = cfg.image_size  # the valid global height, for the QAT save decision
    xT = x.permute(0, 4, 2, 3, 1)  # (C, Q, Hl, W, B)
    outT = None
    for i, (cmt, p) in enumerate(zip(cmts, plans)):
        k, out_size = p["kernel_size"], p["out_size"]
        xT = with_halo(xT, k, mesh, row_axis=2)
        ww, hg = ww - k + 1, hg - k + 1
        outT = eps_apply_t_cmt(
            cmt, xT, out_size, k, p["n1"], p["merge_pairs"], layer_index=i, kernels=kernels,
            save_shapes=None if qat is None else (out_size, b * mesh.size("data") * hg * ww),
            mm_dtype=cfg.compute_dtype,
        )
        xT = outT[None]
    o, hl, wl, b2 = outT.shape
    w_loc = _classifier_weight(fast["linear"]["w"], cfg, mesh, hl, wl, o)
    partial = torch.tensordot(outT.reshape(o, hl * wl, b2),
                              w_loc.reshape(hl * wl, o, cfg.num_classes), dims=([0, 1], [1, 0]))
    return psum_value_only(partial, mesh, "space") + fast["linear"]["b"]


# ---------------------------------------------------------------------------
# training steps


def _sp_step(model, optimizer, reg_coeff, frozen_eps_indices, with_probs, grad_accum_steps,
             mesh, logits_of, reg_fn, cores, plans):
    frozen = frozenset(frozen_eps_indices)
    if any(not 0 <= i < len(cores) for i in frozen):
        raise ValueError(f"frozen_eps_indices {sorted(frozen)} outside the model's {len(cores)} cores")
    if grad_accum_steps < 1:
        raise ValueError(f"grad_accum_steps must be at least 1, got {grad_accum_steps}")
    sp_check_config(model.cfg, mesh.size("space"))

    def detached(ts):
        return tuple(c.detach() if i in frozen else c for i, c in enumerate(ts))

    def zero_frozen():
        for i in frozen:
            cores[i].grad = torch.zeros_like(cores[i])

    return _accumulating_step(
        model, optimizer, lambda xs, m: logits_of(detached, xs, m),
        lambda: grad_scaled(reg_fn(), 1.0 / mesh.size("space")), reg_coeff, grad_accum_steps,
        with_probs, plans, model.cfg.dropout_p, zero_frozen,
        # every leaf but the bias summed over space
        GridGradReduce(mesh, [(p, "space") for p in list(cores) + [model.linear_w]]))


def make_sp_train_step(
    model, optimizer: torch.optim.Optimizer, mesh, reg_type: str = "epses_composition",
    reg_coeff: float = 0.0, *, frozen_eps_indices: Sequence[int] = (), with_probs: bool = False,
    grad_accum_steps: int = 1, backend: str = "xla",
):
    """One rank's SP step over the reference layout (``make_sp_train_step``,
    spatial_parallel.py:220-318) of an ``EPSesPlusLinearReference`` (the
    parameters replicated): ``step(xb, yb, generator=None, masks=None)`` on
    this rank's rows of its data shard → metrics as the one-device step's
    (``loss``, ``ce`` the data ranks' mean, ``probs_of_true_class``
    gathered over ``data``). ``backend`` runs the layers (``ops.eps``)."""
    if reg_type not in REG_TYPES:
        raise ValueError(f"unknown reg_type {reg_type!r}")
    cfg = model.cfg
    plans = tuple({"core_shape": tuple(c.shape)} for c in model.cores)

    def logits_of(detached, xs, masks):
        params = model.reference_params()
        return sp_forward({**params, "epses": detached(params["epses"])}, xs, cfg, mesh, masks,
                          backend)

    return _sp_step(model, optimizer, reg_coeff, frozen_eps_indices, with_probs,
                    grad_accum_steps, mesh, logits_of,
                    lambda: REGULARIZERS[reg_type](model.reference_params()), model.cores, plans)


def make_sp_fast_train_step(
    model, optimizer: torch.optim.Optimizer, mesh, reg_type: str = "epswise",
    reg_coeff: float = 0.0, *, frozen_eps_indices: Sequence[int] = (), with_probs: bool = False,
    grad_accum_steps: int = 1, qat: Optional[str] = None,
):
    """One rank's SP step over the fast (cmt) layout of an
    ``EPSesPlusLinear`` (``make_sp_fast_train_step``,
    spatial_parallel.py:397-490): the kernels on each slab, ``qat="int8"``
    the W8A8 forward; the reduction of ``make_sp_train_step``."""
    if qat not in (None, "int8"):
        raise ValueError(f"unsupported qat mode {qat!r}")
    if reg_type not in REG_TYPES:
        raise ValueError(f"unknown reg_type {reg_type!r}")
    cfg, plans = model.cfg, model.plans

    def logits_of(detached, xs, masks):
        fast = model.fast_params()
        return sp_fast_forward({**fast, "epses_cmt": detached(fast["epses_cmt"])}, xs, cfg,
                               plans, mesh, masks, qat)

    def reg_fn():
        fast = model.fast_params()
        if reg_type == "epswise":
            return epswise_l2_regularizer_fast(fast)
        return epses_composition_l2_regularizer_fast(fast, plans)

    return _sp_step(model, optimizer, reg_coeff, frozen_eps_indices, with_probs,
                    grad_accum_steps, mesh, logits_of, reg_fn, model.cmts, plans)


# ---------------------------------------------------------------------------
# evaluation and inference


def make_sp_forward(cfg: EPSesPlusLinearConfig, mesh, fast_plans=None, qat: Optional[str] = None,
                    backend: str = "xla"):
    """``forward(params, x_rows) → logits`` without gradients
    (``make_sp_forward``): the fast layout's with ``fast_plans`` (and the
    QAT forward with ``qat="int8"``), else the reference layout's through
    ``backend``."""
    if qat not in (None, "int8"):
        raise ValueError(f"unsupported qat mode {qat!r}")

    def forward(params, x):
        with torch.no_grad():
            if fast_plans is not None:
                return sp_fast_forward(params, x, cfg, fast_plans, mesh, qat=qat)
            return sp_forward(params, x, cfg, mesh, backend=backend)

    return forward


def make_sp_score_fn(cfg: EPSesPlusLinearConfig, mesh, batch_size: int, fast_plans=None,
                     qat: Optional[str] = None, backend: str = "xla"):
    """``score(params, split) → (mean_ce, acc)`` over an ``sp_shard_split``
    (``make_sp_score_fn``, spatial_parallel.py:529): each data row scans its
    shard in padded batches (the logits' sum over ``space`` inside), then
    one all-reduce over ``data``."""
    forward = make_sp_forward(cfg, mesh, fast_plans, qat, backend)
    return lambda params, split: score_sharded(lambda xb: forward(params, xb), split, batch_size)
