"""SP×TP for EPSesPlusLinear (port of ``dctn_tpu/parallel/sp_tp.py``): one
``(data, space, model)`` grid of ranks (``mesh.GridMesh``), the batch
sharded over ``data``, the image height over ``space`` (one halo exchange
per EPS layer, ``spatial_parallel``'s) and the last core's output dim and
the classifier over ``model`` (``tensor_parallel``'s last-core layout), at
the same time. It is for a model that is wide and high-resolution at once.

The parameters are the TP shards (``make_tp_params`` /
``make_tp_fast_params`` on the grid's model axis; ``TPModel``,
``TPFastModel``), replicated over ``space`` and ``data``; their merges
gather over ``model`` only. Each rank holds the rows of its space
coordinate of its data shard's images (``sp_tp_shard_batch``: bottom-padded
to n_space·Hl rows, replicated over ``model``).

As in JAX (sp_tp.py:12-45):

- forward: before every layer the K−1-row halo over the space line
  (``collectives.with_halo``; its neighbour is the rank at space coordinate
  s + 1 of this rank's line, n_model ranks on), then the layer; the last
  core on this rank's O-slice. The classifier's ``w3`` (H'·W', O_loc,
  classes) is zero-padded along h and sliced by the space coordinate, so
  each rank contracts a disjoint (h-range × O-slice) block and one
  value-only sum over the ``(space, model)`` plane rebuilds the logits; the
  bias enters after it;
- dropout: whole-shape masks from the generator seeded alike on every rank,
  the last core's sliced to its O range (its cmt's row block), so SP×TP
  at p < 1 is the one-device training's (sp_tp.py:26-30);
- gradients (``collectives.GridGradReduce``, ``_reduce_grads``
  sp_tp.py:164-181): the early, replicated cores summed over ``(space,
  model)`` (each rank holds the part through its rows and its O-slice); the
  last core's O-slice and ``w3`` over ``space`` only (exact per model
  shard, partial over rows); the bias not at all; then everything, with the
  cross-entropy, averaged over ``data``. The regularizer is TP's per-model-
  shard part (``tp_local_regularizer``, its value whole) with its gradient
  divided by n_space (``grad_scaled``), so that the sums count it once.

The fast (cmt) layout runs the kernels on each rank's slab in the
transposed batch-minor layout, the last layer at ``out_size`` O / n_model
on its cmt row block; f32 plans each layer's backward on the slab's own
pixels, and ``qat="int8"`` (K8/K9) decides the saved-t arm on the whole O
and the global valid pixels (``save_shapes``), so every rank and one card
take the same STE backward. Both layouts run in ``cfg.compute_dtype``'s
operands (sp_tp.py:159, :338-349), bf16 as on one card.

Scope: last-core TP only. ``--tp-shard-all`` with ``--space-devices`` is
refused by the runner, as in JAX (runner.py:477-486): its inter-layer
gathers would interleave with the per-layer halos.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..kernels.eps_kernels import KERNELS, eps_apply_t_cmt
from ..kernels.eps_q8_kernels import QAT_KERNELS
from ..models.eps_plus_linear import EPSesPlusLinearConfig
from ..ops import eps as eps_mod
from ..train.evaluation import score_sharded
from .collectives import grad_scaled, psum_value_only, with_halo
from .spatial_parallel import _classifier_weight, sp_check_config, sp_shard_batch
from .tensor_parallel import (
    TPFastModel,
    TPModel,
    _local_mask_cmts,
    _local_mask_epses,
    _step,
    check_model_axis,
    tp_fast_local_regularizer,
    tp_local_regularizer,
)

# the logits' partial sums run over both axes beside data
PLANE = ("space", "model")


def sp_tp_check_config(cfg: EPSesPlusLinearConfig, n_space: int, n_model: int) -> int:
    """The grid's two constraints: the model axis divides the last core's
    O, and every halo fits one neighbour's rows; returns Hl."""
    check_model_axis(cfg, n_model)
    return sp_check_config(cfg, n_space)


# ``sp_tp_shard_batch`` (sp_tp.py:90-103): SP's cut reads only the data and
# space coordinates, so the ranks of a model line take the same part
sp_tp_shard_batch = sp_shard_batch


def _reduce_table(cores, w3):
    """``_reduce_grads``' axes per leaf: the early cores over the plane, the
    last core's O-slice and ``w3`` over ``space``."""
    return [(c, PLANE) for c in cores[:-1]] + [(cores[-1], "space"), (w3, "space")]


def _partial_logits(feats: torch.Tensor, w3: torch.Tensor, cfg, mesh) -> torch.Tensor:
    """feats (O_loc, Hl, W', B), batch-minor → this rank's partial logits
    (B, classes) over its h-range and O-slice of ``w3``
    (``_sp_tp_classifier``, sp_tp.py:106-121)."""
    o_loc, hl, wl, b = feats.shape
    w_loc = _classifier_weight(w3, cfg, mesh, hl, wl, o_loc)  # (Hl, W', O_loc, classes)
    return torch.tensordot(feats.reshape(o_loc, hl * wl, b),
                           w_loc.reshape(hl * wl, o_loc, cfg.num_classes), dims=([0, 1], [1, 0]))


def sp_tp_forward(params3, x: torch.Tensor, cfg: EPSesPlusLinearConfig, mesh, masks=None,
                  backend: str = "xla") -> torch.Tensor:
    """One rank's SP×TP forward over the reference layout
    (``_sp_tp_forward_local``, sp_tp.py:124-161): ``x`` (C, B, Hl, W, Q₀),
    its rows of its data shard → the whole logits (B, classes). ``masks``
    (one per core, whole shape) apply parameter dropout; ``backend`` is
    ``ops.eps``'s."""
    sp_check_config(cfg, mesh.size("space"))
    epses = params3["epses"]
    if masks is not None:
        epses = _local_mask_epses(epses, masks, mesh, cfg.dropout_p)
    h = x
    for core in epses:
        k = eps_mod._infer_kernel_size(core, h.shape[0])
        h = eps_mod.eps(core, with_halo(h, k, mesh, row_axis=2), backend=backend,
                        compute_dtype=cfg.compute_dtype)[None]
    feats = h[0].permute(3, 1, 2, 0)  # (O_loc, Hl, W', B)
    partial = _partial_logits(feats, params3["linear"]["w3"], cfg, mesh)
    return psum_value_only(partial, mesh, PLANE) + params3["linear"]["b"]


def sp_tp_fast_forward(fast3, x: torch.Tensor, cfg: EPSesPlusLinearConfig, plans, mesh,
                       masks=None, qat: Optional[str] = None) -> torch.Tensor:
    """One rank's SP×TP forward over the fast (cmt) layout
    (``_sp_tp_fast_forward_local``, sp_tp.py:274-368): each layer's kernels
    on the slab of Hl+K−1 rows in the transposed batch-minor layout (the
    halo moves rows, a middle dim), the last at O / n_model on its cmt row
    block; ``qat="int8"`` the W8A8 forward, its saved-t arm decided on the
    whole O and the valid global pixels of every data rank."""
    sp_check_config(cfg, mesh.size("space"))
    cmts = fast3["epses_cmt"]
    n = len(cmts)
    if masks is not None:
        cmts = _local_mask_cmts(cmts, plans, masks, mesh, cfg.dropout_p)
    kernels = KERNELS if qat is None else QAT_KERNELS
    b, ww = x.shape[1], x.shape[3]
    hg = cfg.image_size  # the valid global height, for the QAT save decision
    xT = x.permute(0, 4, 2, 3, 1)  # (C, Q, Hl, W, B)
    outT = None
    for i, (cmt, p) in enumerate(zip(cmts, plans)):
        k, out_full = p["kernel_size"], p["out_size"]
        o_i = out_full // mesh.size("model") if i == n - 1 else out_full
        xT = with_halo(xT, k, mesh, row_axis=2)
        ww, hg = ww - k + 1, hg - k + 1
        outT = eps_apply_t_cmt(
            cmt, xT, o_i, k, p["n1"], p["merge_pairs"], layer_index=i, kernels=kernels,
            save_shapes=None if qat is None else (out_full, b * mesh.size("data") * hg * ww),
            mm_dtype=cfg.compute_dtype,
        )
        xT = outT[None]
    partial = _partial_logits(outT, fast3["linear"]["w3"], cfg, mesh)
    return psum_value_only(partial, mesh, PLANE) + fast3["linear"]["b"]


# ---------------------------------------------------------------------------
# training steps


def make_sp_tp_train_step(
    model: TPModel, optimizer: torch.optim.Optimizer, reg_type: str = "epses_composition",
    reg_coeff: float = 0.0, *, frozen_eps_indices: Sequence[int] = (), with_probs: bool = False,
    grad_accum_steps: int = 1, backend: str = "xla",
):
    """One rank's SP×TP step over the reference layout
    (``make_sp_tp_train_step``, sp_tp.py:184-271) of a ``TPModel`` on the
    grid (last core sharded): ``step(xb, yb, generator=None, masks=None)``
    on this rank's rows of its data shard → metrics (``loss`` and ``ce`` the
    data ranks' mean, ``reg_term`` the whole regularizer,
    ``probs_of_true_class`` gathered over ``data``). Frozen cores,
    accumulation and probabilities as in the one-device step."""
    if model.shard_all:
        raise ValueError("SP x TP shards the last core only (no --tp-shard-all)")
    cfg, mesh = model.cfg, model.mesh
    sp_tp_check_config(cfg, mesh.size("space"), mesh.size("model"))

    def logits_of(detached, xs, masks):
        p3 = model.params3()
        return sp_tp_forward({**p3, "epses": detached(p3["epses"])}, xs, cfg, mesh, masks,
                             backend)

    return _step(model, optimizer, reg_type, reg_coeff, frozen_eps_indices, with_probs,
                 grad_accum_steps, logits_of,
                 lambda: grad_scaled(tp_local_regularizer(model.params3(), reg_type, mesh),
                                     1.0 / mesh.size("space")),
                 model.cores, _reduce_table(list(model.cores), model.linear_w3))


def make_sp_tp_fast_train_step(
    model: TPFastModel, optimizer: torch.optim.Optimizer, reg_type: str = "epswise",
    reg_coeff: float = 0.0, *, frozen_eps_indices: Sequence[int] = (), with_probs: bool = False,
    grad_accum_steps: int = 1, qat: Optional[str] = None,
):
    """One rank's SP×TP step over the fast (cmt) layout of a ``TPFastModel``
    (``make_sp_tp_fast_train_step``, sp_tp.py:371-458): the kernels on each
    slab, the last layer on its row block, ``qat="int8"`` the W8A8 forward;
    the reduction of ``make_sp_tp_train_step``."""
    if qat not in (None, "int8"):
        raise ValueError(f"unsupported qat mode {qat!r}")
    cfg, mesh, plans = model.cfg, model.mesh, model.plans
    sp_tp_check_config(cfg, mesh.size("space"), mesh.size("model"))

    def logits_of(detached, xs, masks):
        f3 = model.fast_params3()
        return sp_tp_fast_forward({**f3, "epses_cmt": detached(f3["epses_cmt"])}, xs, cfg,
                                  plans, mesh, masks, qat)

    return _step(model, optimizer, reg_type, reg_coeff, frozen_eps_indices, with_probs,
                 grad_accum_steps, logits_of,
                 lambda: grad_scaled(tp_fast_local_regularizer(model.fast_params3(), plans,
                                                               reg_type, mesh),
                                     1.0 / mesh.size("space")),
                 model.cmts, _reduce_table(list(model.cmts), model.linear_w3))


# ---------------------------------------------------------------------------
# evaluation and inference


def make_sp_tp_forward(cfg: EPSesPlusLinearConfig, mesh, fast_plans=None,
                       qat: Optional[str] = None, backend: str = "xla"):
    """``forward(params3, x_rows) → logits`` without gradients
    (``make_sp_tp_forward``, sp_tp.py:461-498): the fast layout's with
    ``fast_plans`` (the QAT forward with ``qat="int8"``), else the
    reference layout's through ``backend``."""
    if qat not in (None, "int8"):
        raise ValueError(f"unsupported qat mode {qat!r}")
    sp_tp_check_config(cfg, mesh.size("space"), mesh.size("model"))

    def forward(params3, x):
        with torch.no_grad():
            if fast_plans is not None:
                return sp_tp_fast_forward(params3, x, cfg, fast_plans, mesh, qat=qat)
            return sp_tp_forward(params3, x, cfg, mesh, backend=backend)

    return forward


def make_sp_tp_score_fn(cfg: EPSesPlusLinearConfig, mesh, batch_size: int, fast_plans=None,
                        qat: Optional[str] = None, backend: str = "xla"):
    """``score(params3, split) → (mean_ce, acc)`` over an
    ``sp_shard_split`` (``make_sp_tp_score_fn``, sp_tp.py:501-565): each
    data shard scanned in padded batches (the plane's logits sum inside),
    then one all-reduce over ``data``; under ``qat="int8"`` the quantized
    forward."""
    forward = make_sp_tp_forward(cfg, mesh, fast_plans, qat, backend)
    return lambda params3, split: score_sharded(lambda xb: forward(params3, xb), split,
                                                batch_size)
