"""Tensor parallelism for EPSesPlusLinear (port of
``dctn_tpu/parallel/tensor_parallel.py``): the EPS cores' output dims and
the classifier's rows sharded over the ``model`` axis of a ``(data, space,
model)`` grid of ranks (``mesh.GridMesh``) whose space axis has one rank,
composable with the data axis. The parameter layout and its merges also
serve SP×TP (``sp_tp``), on the model axis of its grid.

Two layouts of the reference parameters, as in JAX:

- ``shard_all=False`` (the default): only the LAST core is sharded on O.
  Each model rank computes its O-slice of the features and its rows of the
  classifier; one sum over the model group rebuilds the logits.
- ``shard_all=True``: every core's O is sharded; each rank computes its
  layer's O-slice, and an ``all_gather`` over ``model`` rebuilds the whole
  activation between layers (its backward a reduce-scatter,
  ``collectives.gather_along``). With ``backend="pallas"`` every layer runs
  through the kernels (``ops.eps``'s kernel route on the local core), as
  the JAX runner does for ``--tp-shard-all`` (runner.py:663-667).

And the fast (cmt) layout, last core only (``make_tp_fast_params``): the
cmt's rows are output-major, so a model shard of O is a contiguous block of
the last cmt's rows, and the last layer runs the kernels with
``out_size = O / n_model`` on it. Under QAT every layer runs the W8A8
forward (K8, then K9); weights quantize per row, so a row block quantizes
as the same rows of the whole core, and the saved-t arm is decided on the
whole O and the global batch (``save_shapes``), so that every rank and one
card take the same STE backward. ``cfg.compute_dtype`` is every layer's
operand dtype on every rank, as on one card (tensor_parallel.py:219,
:484-495): bf16 runs the kernels' bf16 mode (under QAT: the int8 forward
with a bf16 t, the bf16 backward) at the shard's shapes, and the plain
``eps``'s rounding on the xla backend.

The classifier's weight is kept as ``w3`` (H'·W', O, classes): the
reference's rows are ordered (h, w, o) with o fastest, so an O-shard of
``w`` would be strided; of ``w3`` it is contiguous. ``make_tp_*params``
take the reference (or fast) parameters, numpy (``interop.params_from_numpy``)
or torch, and return this rank's shard; ``merge_tp_*params`` gather the
model group's shards back to the layout one device holds (every rank of
the group must call).

Gradients (``collectives.GridGradReduce``): a sharded leaf's gradient is
exact locally (the gathers carry their transposes) and is only averaged
over ``data``; a replicated core (the early cores in last-only mode) holds
on each model rank only the part routed through that rank's O-slice, so it
is summed over ``model`` first. The bias enters after the logits' sum: its
gradient is whole on every rank. The regularizer is each rank's part
(``tp_local_regularizer``): replicated terms divided by the model axis's
size, so that the sum over ``model`` counts them once.

Parameter dropout: each core's mask is drawn over its WHOLE shape from a
generator seeded the same on every rank, then a sharded core takes its O
range (its cmt's row block), so every rank sees one mask realization and
TP training with dropout is the single-device training's.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..kernels.eps_kernels import KERNELS, _core_to_cmt_k, eps_apply_t_cmt
from ..kernels.eps_q8_kernels import QAT_KERNELS
from ..models.eps_plus_linear import EPSesPlusLinearConfig, _plan_dims, reference_params_from_fast
from ..ops import composition
from ..ops import eps as eps_mod
from ..train.evaluation import score_sharded
from ..train.step import REG_TYPES, _accumulating_step
from .collectives import GridGradReduce, gather_along, psum_value_only


def _torch_tree(params, device):
    """Reference or fast parameters, numpy or torch, as torch tensors on
    ``device``."""
    from ..interop import params_from_numpy

    leaves = params["epses_cmt"] if "epses_cmt" in params else params["epses"]
    if isinstance(leaves[0], np.ndarray):
        if "epses_cmt" in params:
            return {"epses_cmt": tuple(torch.as_tensor(c, device=device) for c in leaves),
                    "linear": {k: torch.as_tensor(v, device=device)
                               for k, v in params["linear"].items()}}
        return params_from_numpy(params, device)
    key = "epses_cmt" if "epses_cmt" in params else "epses"
    return {key: tuple(c.to(device) for c in leaves),
            "linear": {k: v.to(device) for k, v in params["linear"].items()}}


def check_model_axis(cfg: EPSesPlusLinearConfig, n_model: int, shard_all: bool = False) -> None:
    """Every sharded core's O must divide by the model axis
    (``make_tp_params``, tensor_parallel.py:88-92)."""
    specs = cfg.epses_specs if shard_all else cfg.epses_specs[-1:]
    for _, o in specs:
        if o % n_model:
            raise ValueError(f"output dim {o} not divisible by model axis {n_model}")


def _o_slice(o: int, mesh) -> slice:
    o_loc = o // mesh.size("model")
    return slice(mesh.index("model") * o_loc, (mesh.index("model") + 1) * o_loc)


def _sharded(i: int, n_eps: int, shard_all: bool) -> bool:
    return shard_all or i == n_eps - 1


def make_tp_params(params, cfg: EPSesPlusLinearConfig, mesh, shard_all: bool = False):
    """Reference parameters → this rank's TP shard ``{"epses": (…), "linear":
    {"w3", "b"}}`` on the rank's device: the last core (every core with
    ``shard_all``) and ``w3`` sliced on O."""
    check_model_axis(cfg, mesh.size("model"), shard_all)
    params = _torch_tree(params, mesh.device)
    epses = params["epses"]
    n = len(epses)
    o = epses[-1].shape[-1]
    hw = cfg.pre_linear_image_size**2
    w3 = params["linear"]["w"].reshape(hw, o, cfg.num_classes)
    return {
        "epses": tuple(c[..., _o_slice(c.shape[-1], mesh)].contiguous()
                       if _sharded(i, n, shard_all) else c for i, c in enumerate(epses)),
        "linear": {"w3": w3[:, _o_slice(o, mesh)].contiguous(), "b": params["linear"]["b"]},
    }


@torch.no_grad()
def merge_tp_params(params3, cfg: EPSesPlusLinearConfig, mesh, shard_all: bool = False):
    """This model group's TP shards → the reference parameters (every rank
    of the group must call)."""
    epses = params3["epses"]
    n = len(epses)

    def full(t, dim):
        return mesh.gather_cat(t.detach(), "model", dim)

    return {
        "epses": tuple(full(c, c.ndim - 1) if _sharded(i, n, shard_all) else c.detach()
                       for i, c in enumerate(epses)),
        "linear": {"w": full(params3["linear"]["w3"], 1).reshape(-1, cfg.num_classes),
                   "b": params3["linear"]["b"].detach()},
    }


def make_tp_fast_params(fast, cfg: EPSesPlusLinearConfig, mesh):
    """Fast (cmt) parameters → this rank's TP-fast shard ``{"epses_cmt":
    (…), "linear": {"w3", "b"}}``: the last cmt's row block and ``w3``'s O
    slice; the early cmts replicated."""
    check_model_axis(cfg, mesh.size("model"))
    fast = _torch_tree(fast, mesh.device)
    cmts = fast["epses_cmt"]
    o = cfg.epses_specs[-1][1]
    hw = cfg.pre_linear_image_size**2
    w3 = fast["linear"]["w"].reshape(hw, o, cfg.num_classes)
    rows = cmts[-1].shape[0] // mesh.size("model")
    last = cmts[-1][mesh.index("model") * rows : (mesh.index("model") + 1) * rows].contiguous()
    return {"epses_cmt": tuple(cmts[:-1]) + (last,),
            "linear": {"w3": w3[:, _o_slice(o, mesh)].contiguous(), "b": fast["linear"]["b"]}}


@torch.no_grad()
def merge_tp_fast_params(fast3, cfg: EPSesPlusLinearConfig, mesh):
    """This model group's TP-fast shards → the fast (cmt) parameters."""
    cmts = [c.detach() for c in fast3["epses_cmt"]]
    w3 = fast3["linear"]["w3"].detach()
    cmts[-1] = mesh.gather_cat(cmts[-1], "model", 0)
    w3 = mesh.gather_cat(w3, "model", 1)
    return {"epses_cmt": tuple(cmts),
            "linear": {"w": w3.reshape(-1, cfg.num_classes), "b": fast3["linear"]["b"].detach()}}


class TPModel(nn.Module):
    """This rank's shard of the model in the reference layout (``cores``:
    the sharded ones on their O range; ``linear_w3``, ``linear_b``); it owns
    copies of the tensors it is given."""

    def __init__(self, params3, cfg: EPSesPlusLinearConfig, mesh, shard_all: bool = False):
        super().__init__()
        self.cfg, self.mesh, self.shard_all = cfg, mesh, shard_all

        def param(t):
            return nn.Parameter(t.detach().clone())

        self.cores = nn.ParameterList(param(c) for c in params3["epses"])
        self.linear_w3 = param(params3["linear"]["w3"])
        self.linear_b = param(params3["linear"]["b"])
        # the whole cores' shapes, for the dropout masks
        self.plans = tuple({"core_shape": tuple(c.shape[:-1]) + (o,)}
                           for c, (_, o) in zip(self.cores, cfg.epses_specs))

    def params3(self):
        return {"epses": tuple(self.cores), "linear": {"w3": self.linear_w3, "b": self.linear_b}}

    def shards(self):
        """(train-state key, parameter, its sharded dim or None) of each
        parameter."""
        n = len(self.cores)
        return [(f"epses/{i}", c, c.ndim - 1 if _sharded(i, n, self.shard_all) else None)
                for i, c in enumerate(self.cores)] + [
            ("linear/w", self.linear_w3, 1), ("linear/b", self.linear_b, None)]


class TPFastModel(nn.Module):
    """This rank's shard of the model in the fast (cmt) layout (``cmts``: the
    last one its row block; ``linear_w3``, ``linear_b``); ``plans`` are the
    whole model's."""

    def __init__(self, fast3, plans, cfg: EPSesPlusLinearConfig, mesh):
        super().__init__()
        self.cfg, self.plans, self.mesh = cfg, plans, mesh

        def param(t):
            return nn.Parameter(t.detach().clone())

        self.cmts = nn.ParameterList(param(c) for c in fast3["epses_cmt"])
        self.linear_w3 = param(fast3["linear"]["w3"])
        self.linear_b = param(fast3["linear"]["b"])

    def fast_params3(self):
        return {"epses_cmt": tuple(self.cmts),
                "linear": {"w3": self.linear_w3, "b": self.linear_b}}

    def shards(self):
        """(train-state key, parameter, its sharded dim or None) of each
        parameter."""
        n = len(self.cmts)
        return [(f"epses_cmt/{i}", c, 0 if i == n - 1 else None)
                for i, c in enumerate(self.cmts)] + [
            ("linear/w", self.linear_w3, 1), ("linear/b", self.linear_b, None)]


# ---------------------------------------------------------------------------
# forward


def _classifier(h_loc: torch.Tensor, linear, mesh) -> torch.Tensor:
    """h_loc (B, H', W', O_local) → logits: this rank's partial logits over
    its O-slice of ``w3``, summed over the model group, plus the bias."""
    b, hp, wp, o = h_loc.shape
    partial = torch.einsum("bpo,poc->bc", h_loc.reshape(b, hp * wp, o), linear["w3"])
    return psum_value_only(partial, mesh, "model") + linear["b"]


def _local_mask_epses(epses, masks, mesh, p: float, shard_all: bool = False):
    """Dropout on the TP shard: each whole-shape mask, a sharded core's
    sliced to its O range."""
    n = len(epses)
    return tuple(
        c * (m.to(c.device, c.dtype)[..., _o_slice(m.shape[-1], mesh)]
             if _sharded(i, n, shard_all) else m.to(c.device, c.dtype)) / p
        for i, (c, m) in enumerate(zip(epses, masks)))


def tp_forward(params3, x: torch.Tensor, cfg: EPSesPlusLinearConfig, mesh,
               shard_all: bool = False, masks=None, backend: str = "xla") -> torch.Tensor:
    """One rank's TP forward (``_tp_forward_local``): ``x`` (C, B, H, W, Q₀)
    of its data shard → the whole logits (B, classes). ``masks`` (one per
    core, whole reference shape) apply parameter dropout; ``backend`` is
    ``ops.eps``'s."""
    epses = params3["epses"]
    n = len(epses)
    if masks is not None:
        epses = _local_mask_epses(epses, masks, mesh, cfg.dropout_p, shard_all)
    h = x
    for i, core in enumerate(epses):
        h = eps_mod.eps(core, h, backend=backend, compute_dtype=cfg.compute_dtype)
        if shard_all and i < n - 1:
            h = gather_along(h, h.ndim - 1, mesh, "model")  # the whole Q for the next layer
        h = h[None]
    return _classifier(h[0], params3["linear"], mesh)


def _local_mask_cmts(cmts, plans, masks, mesh, p: float):
    """Dropout on the TP-fast shard: each whole-shape mask permuted to cmt,
    the last one's row block taken."""
    out = []
    for i, (cmt, plan, mask) in enumerate(zip(cmts, plans, masks)):
        _, q_k, n1_k = _plan_dims(plan)
        mask_cmt = _core_to_cmt_k(mask.to(cmt.device), n1_k, q_k).to(cmt.dtype)
        if i == len(cmts) - 1 and mesh.size("model") > 1:
            rows = cmt.shape[0]
            mask_cmt = mask_cmt[mesh.index("model") * rows : (mesh.index("model") + 1) * rows]
        out.append(cmt * mask_cmt / p)
    return tuple(out)


def tp_fast_forward(fast3, x: torch.Tensor, cfg: EPSesPlusLinearConfig, plans, mesh,
                    masks=None, qat: Optional[str] = None) -> torch.Tensor:
    """One rank's TP-fast forward (``_tp_fast_forward_local``): the early
    layers whole, the last on its cmt row block with ``out_size`` O /
    n_model, then the partial logits summed over ``model``. ``qat="int8"``
    runs every layer's W8A8 forward (K8/K9), its saved-t arm decided on the
    whole O and the global batch."""
    cmts = fast3["epses_cmt"]
    n = len(cmts)
    if masks is not None:
        cmts = _local_mask_cmts(cmts, plans, masks, mesh, cfg.dropout_p)
    kernels = KERNELS if qat is None else QAT_KERNELS
    b, hh, ww = x.shape[1], x.shape[2], x.shape[3]
    xT = x.permute(0, 4, 2, 3, 1)
    outT = None
    for i, (cmt, p) in enumerate(zip(cmts, plans)):
        k, out_full = p["kernel_size"], p["out_size"]
        o_i = out_full // mesh.size("model") if i == n - 1 else out_full
        hh, ww = hh - k + 1, ww - k + 1
        outT = eps_apply_t_cmt(
            cmt, xT, o_i, k, p["n1"], p["merge_pairs"], layer_index=i, kernels=kernels,
            save_shapes=None if qat is None else (out_full, b * hh * ww * mesh.size("data")),
            mm_dtype=cfg.compute_dtype,
        )
        xT = outT[None]
    o_loc, hp, wp, b2 = outT.shape
    partial = torch.tensordot(outT.reshape(o_loc, hp * wp, b2), fast3["linear"]["w3"],
                              dims=([0, 1], [1, 0]))
    return psum_value_only(partial, mesh, "model") + fast3["linear"]["b"]


# ---------------------------------------------------------------------------
# regularizers: each rank's part, whose sum over the model group is the
# whole regularizer (its value is the whole one: ``psum_value_only``)


def tp_local_regularizer(params3, reg_type: str, mesh, shard_all: bool = False):
    """``_local_regularizer`` (tensor_parallel.py:232-259): epswise, the
    O-sliced norms whole and the replicated ones divided by the model
    axis's size; the composition's recursion on whole early cores (gathered
    under ``shard_all``), its last contraction over the local O."""
    epses = params3["epses"]
    w3 = params3["linear"]["w3"]
    n_model = mesh.size("model")
    if reg_type == "epswise":
        if shard_all:
            part = torch.sum(w3**2) + sum(torch.sum(c**2) for c in epses)
        else:  # summed in the one-device order (its bits on a model axis of 1)
            part = torch.sum(w3**2) + (sum(torch.sum(c**2) for c in epses[:-1]) / n_model
                                       + torch.sum(epses[-1] ** 2))
    else:
        if shard_all:
            epses = (tuple(gather_along(c, c.ndim - 1, mesh, "model") for c in epses[:-1])
                     + (epses[-1],))
        part = torch.sum(w3**2) + composition.inner_product(epses, epses)
    return psum_value_only(part, mesh, "model")


def tp_fast_local_regularizer(fast3, plans, reg_type: str, mesh):
    """``_tp_fast_local_regularizer`` (tensor_parallel.py:510-536): epswise
    as above on the cmts; the composition gathers the last cmt (its
    transpose a reduce-scatter) and divides the whole inner product by the
    model axis's size."""
    cmts = fast3["epses_cmt"]
    w3 = fast3["linear"]["w3"]
    n_model = mesh.size("model")
    if reg_type == "epswise":  # summed in the one-device order
        part = torch.sum(w3**2) + (sum(torch.sum(c**2) for c in cmts[:-1]) / n_model
                                   + torch.sum(cmts[-1] ** 2))
    else:
        full = tuple(cmts[:-1]) + (gather_along(cmts[-1], 0, mesh, "model"),)
        part = torch.sum(w3**2) + composition.inner_product_cmt(full, plans) / n_model
    return psum_value_only(part, mesh, "model")


# ---------------------------------------------------------------------------
# training steps


def _step(model, optimizer, reg_type, reg_coeff, frozen_eps_indices, with_probs,
          grad_accum_steps, logits_of, reg_fn, cores, table):
    frozen = frozenset(frozen_eps_indices)
    if any(not 0 <= i < len(cores) for i in frozen):
        raise ValueError(f"frozen_eps_indices {sorted(frozen)} outside the model's {len(cores)} cores")
    if grad_accum_steps < 1:
        raise ValueError(f"grad_accum_steps must be at least 1, got {grad_accum_steps}")
    if reg_type not in REG_TYPES:
        raise ValueError(f"unknown reg_type {reg_type!r}")

    def detached(ts):
        return tuple(c.detach() if i in frozen else c for i, c in enumerate(ts))

    def zero_frozen():
        for i in frozen:
            cores[i].grad = torch.zeros_like(cores[i])

    return _accumulating_step(
        model, optimizer, lambda xs, m: logits_of(detached, xs, m), reg_fn, reg_coeff,
        grad_accum_steps, with_probs, model.plans, model.cfg.dropout_p, zero_frozen,
        GridGradReduce(model.mesh, table))


def make_tp_train_step(
    model: TPModel, optimizer: torch.optim.Optimizer, reg_type: str = "epses_composition",
    reg_coeff: float = 0.0, *, frozen_eps_indices: Sequence[int] = (), with_probs: bool = False,
    grad_accum_steps: int = 1, backend: str = "xla",
):
    """One rank's TP step over the reference layout (``make_tp_train_step``,
    tensor_parallel.py:262-378): ``step(xb, yb, generator=None, masks=None)``
    on this rank's data shard of the batch → metrics (``loss`` and ``ce``
    the data ranks' mean, ``reg_term`` the whole regularizer,
    ``probs_of_true_class`` gathered over ``data``). ``backend`` runs the
    layers (``ops.eps``: xla, or the kernels with pallas). Frozen cores,
    accumulation and probabilities as in the one-device step."""
    cfg, mesh, shard_all = model.cfg, model.mesh, model.shard_all

    def logits_of(detached, xs, masks):
        p3 = model.params3()
        return tp_forward({**p3, "epses": detached(p3["epses"])}, xs, cfg, mesh, shard_all,
                          masks, backend)

    # the replicated cores' gradients summed over model (none with shard_all)
    table = [] if shard_all else [(c, "model") for c in model.cores[:-1]]
    return _step(model, optimizer, reg_type, reg_coeff, frozen_eps_indices, with_probs,
                 grad_accum_steps, logits_of,
                 lambda: tp_local_regularizer(model.params3(), reg_type, mesh, shard_all),
                 model.cores, table)


def make_tp_fast_train_step(
    model: TPFastModel, optimizer: torch.optim.Optimizer, reg_type: str = "epswise",
    reg_coeff: float = 0.0, *, frozen_eps_indices: Sequence[int] = (), with_probs: bool = False,
    grad_accum_steps: int = 1, qat: Optional[str] = None,
):
    """One rank's TP step over the fast (cmt) layout, last core sharded
    (``make_tp_fast_train_step``, tensor_parallel.py:539-637): the kernels
    at the shard's shapes, ``qat="int8"`` the W8A8 forward; the reduction of
    ``make_tp_train_step``."""
    if qat not in (None, "int8"):
        raise ValueError(f"unsupported qat mode {qat!r}")
    cfg, mesh, plans = model.cfg, model.mesh, model.plans

    def logits_of(detached, xs, masks):
        f3 = model.fast_params3()
        return tp_fast_forward({**f3, "epses_cmt": detached(f3["epses_cmt"])}, xs, cfg, plans,
                               mesh, masks, qat)

    return _step(model, optimizer, reg_type, reg_coeff, frozen_eps_indices, with_probs,
                 grad_accum_steps, logits_of,
                 lambda: tp_fast_local_regularizer(model.fast_params3(), plans, reg_type, mesh),
                 model.cmts, [(c, "model") for c in model.cmts[:-1]])


# ---------------------------------------------------------------------------
# evaluation and inference


def make_tp_forward(cfg: EPSesPlusLinearConfig, mesh, shard_all: bool = False,
                    backend: str = "xla"):
    """``forward(params3, x) → logits`` without gradients (``make_tp_forward``)."""

    def forward(params3, x):
        with torch.no_grad():
            return tp_forward(params3, x, cfg, mesh, shard_all, backend=backend)

    return forward


def make_tp_fast_forward(cfg: EPSesPlusLinearConfig, plans, mesh, qat: Optional[str] = None):
    """``forward(fast3, x) → logits`` without gradients, f32 or the QAT
    (int8) forward."""

    def forward(fast3, x):
        with torch.no_grad():
            return tp_fast_forward(fast3, x, cfg, plans, mesh, qat=qat)

    return forward


def make_tp_score_fn(cfg: EPSesPlusLinearConfig, mesh, batch_size: int, shard_all: bool = False,
                     backend: str = "xla"):
    """``score(params3, split) → (mean_ce, acc)`` over a ``ShardedSplit``
    sharded on the data axis (``make_tp_score_fn``, tensor_parallel.py:690):
    each data row scans its shard in padded batches (the logits' sum over
    ``model`` inside), then one all-reduce over ``data``."""
    forward = make_tp_forward(cfg, mesh, shard_all, backend)
    return lambda params3, split: score_sharded(lambda xb: forward(params3, xb), split,
                                                batch_size)


def make_tp_fast_score_fn(cfg: EPSesPlusLinearConfig, plans, mesh, batch_size: int,
                          qat: Optional[str] = None):
    """The same over the TP-fast layout (``make_tp_fast_score_fn``); under
    ``qat="int8"`` it scores the quantized forward."""
    forward = make_tp_fast_forward(cfg, plans, mesh, qat)
    return lambda fast3, split: score_sharded(lambda xb: forward(fast3, xb), split, batch_size)


# ---------------------------------------------------------------------------
# train states: the model group's shards gathered, in the layout one device
# holds, so that one file resumes on one device or on any model axis


def _full(t: torch.Tensor, dim, mesh) -> torch.Tensor:
    t = t.detach()
    return t if dim is None else mesh.gather_cat(t, "model", dim)


def tp_train_state_arrays(model, optimizer, step: int, generator=None, seed: int = 0):
    """The train state of a TP model and its optimizer, gathered over the
    model group into the arrays ``train.train_state_arrays`` writes for the
    whole model (every rank of the group must call; rank 0 writes)."""
    from ..train.checkpoint import _opt_prefix, jax_key_data

    classes = model.cfg.num_classes
    prefix = _opt_prefix(optimizer)
    out, count = {}, 0
    for key, p, dim in model.shards():
        def whole(t):
            t = _full(t, dim, model.mesh)
            return t.reshape(-1, classes) if key == "linear/w" else t

        out[f"params/{key}"] = whole(p)
        if prefix is not None:
            st = optimizer.state.get(p, {})
            out[f"{prefix}/mu/{key}"] = whole(st.get("exp_avg", torch.zeros_like(p)))
            out[f"{prefix}/nu/{key}"] = whole(st.get("exp_avg_sq", torch.zeros_like(p)))
            count = int(st["step"]) if "step" in st else count
    if prefix is not None:
        out[f"{prefix}/count"] = np.int32(count)
    out["step"] = np.int64(step)
    out["rng"] = jax_key_data(seed)
    fast = isinstance(model, TPFastModel)
    out["param_layout"] = np.int32(1 if fast else 0)
    if fast:
        out["eps_splits"] = np.asarray([p["n1"] for p in model.plans], np.int32)
    if generator is not None:
        out["generator_state"] = generator.get_state()
    return out


def load_tp_train_state(filename: str, model, optimizer, plans, generator=None) -> int:
    """Restores a TP model's shard, its optimizer's and the generator's
    state from a train state of the whole model (``tp_train_state_arrays``
    or one device's); returns its step. As in the JAX runner
    (runner.py:1319-1330), a file in the other parameter layout, or under
    other splits, is refused here: no layout conversion under TP."""
    from ..models.eps_plus_linear import EPSesPlusLinear, EPSesPlusLinearReference
    from ..train.checkpoint import _opt_prefix, _param_names, load_train_state

    fast = isinstance(model, TPFastModel)
    with np.load(filename) as data:
        saved_fast = bool(data["param_layout"]) if "param_layout" in data.files else False
        splits = [int(s) for s in data["eps_splits"]] if "eps_splits" in data.files else None
    ours = [p["n1"] for p in plans]
    if saved_fast != fast or (fast and splits != ours):
        saved = "fast (cmt)" if saved_fast else "reference"
        raise ValueError(
            f"it was saved in the {saved} parameter layout (splits {splits}), and this "
            f"tensor-parallel run trains the {'fast (cmt)' if fast else 'reference'} one "
            f"(splits {ours if fast else None}): tensor parallelism converts no layout "
            "(resume with matching backend options)")
    cfg, mesh = model.cfg, model.mesh
    # the whole model on the CPU, loaded as one device loads it, then sliced
    zeros = {"linear": {"w": torch.zeros(cfg.linear_in_features, cfg.num_classes),
                        "b": torch.zeros(cfg.num_classes)}}
    if fast:
        cmts = []
        for p in plans:
            n_k, q_k, n1_k = _plan_dims(p)
            cmts.append(torch.zeros(p["out_size"] * q_k ** (n_k - n1_k), q_k**n1_k))
        whole = EPSesPlusLinear({"epses_cmt": tuple(cmts), **zeros}, plans, cfg)
    else:
        whole = EPSesPlusLinearReference(
            {"epses": tuple(torch.zeros(p["core_shape"]) for p in model.plans), **zeros}, cfg)
    prefix = _opt_prefix(optimizer)
    whole_opt = type(optimizer)(whole.parameters(), **{
        k: v for k, v in optimizer.defaults.items() if k in ("lr", "weight_decay")})
    step = load_train_state(filename, whole, whole_opt, cfg, plans, generator)
    o, classes = cfg.epses_specs[-1][1], cfg.num_classes
    hw = cfg.pre_linear_image_size**2

    def local(t, dim, key):
        if key == "linear/w":
            t = t.reshape(hw, o, classes)
        if dim is None or mesh.size("model") == 1:
            return t.to(mesh.device)
        size = t.shape[dim] // mesh.size("model")
        return t.narrow(dim, mesh.index("model") * size, size).contiguous().to(mesh.device)

    order = [q for group in optimizer.param_groups for q in group["params"]]
    sd = optimizer.state_dict()
    sd["state"] = {}
    with torch.no_grad():
        whole_params = dict(_param_names(whole))
        for key, p, dim in model.shards():
            q = whole_params[key]
            p.copy_(local(q, dim, key))
            if prefix is not None:
                st = whole_opt.state[q]
                sd["state"][next(i for i, r in enumerate(order) if r is p)] = {
                    "step": st["step"].clone(), "exp_avg": local(st["exp_avg"], dim, key),
                    "exp_avg_sq": local(st["exp_avg_sq"], dim, key)}
    if prefix is not None:
        optimizer.load_state_dict(sd)
    return step


def tp_reference_params(model) -> dict:
    """The whole reference-layout parameters of a TP model (every rank of
    the model group must call): the checkpoints' layout."""
    if isinstance(model, TPFastModel):
        return reference_params_from_fast(merge_tp_fast_params(model.fast_params3(), model.cfg,
                                                               model.mesh), model.cfg, model.plans)
    return merge_tp_params(model.params3(), model.cfg, model.mesh, model.shard_all)
