"""EPSesPlusLinear — N EPS layers followed by a linear classifier (port of
``dctn_tpu/models/eps_plus_linear.py``: the forward for serving and
training, the epswise and composition regularizers, and which layers the
saved-t cap holds back at a batch size).

Parameters come in two layouts, as in the JAX package:

- the reference layout, ``{"epses": (core_0, …), "linear": {"w": (in, 10),
  "b": (10,)}}``, which checkpoints use;
- the fast layout, each core matricized to the kernel's (Z, A) "cmt" matrix
  (``fast_params_from_reference``), which the serving forward runs on.

``EPSesPlusLinear`` is the ``nn.Module`` that holds the fast layout on one
device; its parameters require gradients, and serving runs it under
``torch.inference_mode``; with ``eps_q8_kernels.QAT_KERNELS`` it is the
quantization-aware training forward. ``EPSesPlusLinearQ8`` holds the int8
serving parameters (``forward_fast_q8``). Only the
"unit_theoretical_output_std" init is ported; the other two inits and
parameter dropout come with a later slice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch
from torch import nn

from ..kernels.eps_kernels import (
    KERNELS,
    EPSKernels,
    _core_to_cmt_k,
    _kernel_dims,
    eps_apply_t_cmt,
    plan_backward,
    plan_call,
)
from ..kernels.eps_q8_kernels import eps_apply_t_q8, eps_fwd_q8, quantize_reference_params
from ..ops import composition
from ..ops import eps as eps_mod

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class EPSesPlusLinearConfig:
    epses_specs: Tuple[Tuple[int, int], ...]  # ((K, Q_out), ...)
    image_size: int = 28
    q0: int = 2
    num_classes: int = 10
    dtype: torch.dtype = torch.float32
    # parameter dropout's keep probability (eps_plus_linear.py's dropout_p);
    # make_fast_train_step refuses p < 1 until _dropout_cmts is ported
    dropout_p: float = 1.0

    @property
    def pre_linear_image_size(self) -> int:
        ks = tuple(k for k, _ in self.epses_specs)
        return self.image_size - sum(ks) + len(ks)

    @property
    def linear_in_features(self) -> int:
        return self.pre_linear_image_size**2 * self.epses_specs[-1][1]


# ---------------------------------------------------------------------------
# initialization


def _init_linear(
    generator: torch.Generator, cfg: EPSesPlusLinearConfig, device="cpu"
) -> Dict[str, torch.Tensor]:
    """w = randn·in^(-1/2)/4, b ~ U(-in^(-1/2), in^(-1/2))
    (eps_plus_linear.py:73-107, default branch)."""
    n_in, n_out = cfg.linear_in_features, cfg.num_classes
    kw = {"generator": generator, "dtype": cfg.dtype, "device": generator.device}
    w = torch.randn((n_in, n_out), **kw) * (n_in**-0.5 / 4.0)
    b_max = n_in**-0.5
    b = (torch.rand((n_out,), **kw) * 2.0 - 1.0) * b_max
    return {"w": w.to(device), "b": b.to(device)}


def init_eps_plus_linear(
    generator: torch.Generator,
    cfg: EPSesPlusLinearConfig,
    initialization: str = "unit_theoretical_output_std",
    device="cpu",
) -> Params:
    """The reference-layout parameters, drawn from ``generator`` (cores in
    layer order, then the linear layer)."""
    if initialization != "unit_theoretical_output_std":
        raise ValueError(
            f"initialization {initialization!r} is not ported yet; only "
            "'unit_theoretical_output_std' is"
        )
    epses = composition.make_unit_theoretical_output_std(
        generator, cfg.epses_specs, cfg.q0, cfg.dtype, device
    )
    return {"epses": epses, "linear": _init_linear(generator, cfg, device)}


# ---------------------------------------------------------------------------
# forward


def _transposed_classifier(outT: torch.Tensor, linear) -> torch.Tensor:
    """logits[b, cls] = Σ_{p,o} outT[o,p,b]·W[(p,o),cls]: W's rows are ordered
    (h, w, o) row-major, the reference layout, so the batch-minor features
    contract without a transpose."""
    o, hp, wp, b = outT.shape
    w_lin = linear["w"].reshape(hp * wp, o, -1)
    logits = torch.tensordot(outT.reshape(o, hp * wp, b), w_lin, dims=([0, 1], [1, 0]))
    return logits + linear["b"]


def eps_plus_linear_forward(params: Params, x: torch.Tensor, cfg: EPSesPlusLinearConfig):
    """Reference-layout forward, plain: ``x`` (C, B, H, W, Q₀) → logits
    (B, num_classes)."""
    del cfg  # the layer shapes come from the cores
    intermediate = x
    for core in params["epses"]:
        intermediate = eps_mod.eps(core, intermediate)[None]
    h = intermediate[0]  # (B, H', W', Q_out)
    return h.reshape(h.shape[0], -1) @ params["linear"]["w"] + params["linear"]["b"]


# ---------------------------------------------------------------------------
# fast (cmt) parameter layout


def fast_layer_plans(cfg: EPSesPlusLinearConfig, in_channels: int = 1):
    """Per-layer plan of the fast layout, independent of the batch size:
    (kernel_size, n1, merge_pairs, out_size, core_shape, c, q) per layer, with
    the JAX package's split and pair merge."""
    c, q = in_channels, cfg.q0
    plans = []
    for kernel_size, out_size in cfg.epses_specs:
        n = kernel_size**2 * c
        n1, merge_pairs = plan_call(c, q, kernel_size, eps_mod._balanced_split(n, q, out_size))
        plans.append(
            {
                "kernel_size": kernel_size,
                "n1": n1,
                "merge_pairs": merge_pairs,
                "out_size": out_size,
                "core_shape": (q,) * n + (out_size,),
                "c": c,
                "q": q,
            }
        )
        c, q = 1, out_size
    return tuple(plans)


def _plan_dims(p):
    return _kernel_dims(p["c"], p["q"], p["kernel_size"], p["n1"], p["merge_pairs"])


def saved_t_capped_layers(cfg: EPSesPlusLinearConfig, plans, microbatch: int):
    """Indices of the EPS layers whose saved-t backward is held back only
    by the cap on t's size (``plan_backward``'s ``SAVE_T_MAX_BYTES``) at
    this microbatch: they would save t at a smaller one
    (eps_plus_linear.py:364-383, on the port's rule, whose t is float32;
    the JAX package counts t in its matmul dtype, bf16 on the TPU). Layer 0
    never saves t. Non-empty means gradient accumulation would bring the
    saved-t backward back (the large-batch recipe, docs/performance.md)."""
    h = cfg.image_size
    capped = []
    for i, p in enumerate(plans):
        h = h - p["kernel_size"] + 1
        n_k, q_k, n1_k = _plan_dims(p)
        arm = plan_backward(i, n_k, n1_k, q_k, p["out_size"], microbatch * h * h)
        if arm == "recompute" and plan_backward(i, n_k, n1_k, q_k, p["out_size"], 1) == "saved_t":
            capped.append(i)
    return capped


def fast_params_from_reference(params: Params, cfg: EPSesPlusLinearConfig):
    """Reference parameters → (fast parameters, plans): each core matricized
    to the kernel's (Z, A) layout."""
    k0 = cfg.epses_specs[0][0]
    plans = fast_layer_plans(cfg, (params["epses"][0].ndim - 1) // (k0 * k0))
    cmts = []
    for core, p in zip(params["epses"], plans):
        _, q_k, n1_k = _plan_dims(p)
        cmts.append(_core_to_cmt_k(core, n1_k, q_k))
    return {"epses_cmt": tuple(cmts), "linear": dict(params["linear"])}, plans


def reference_params_from_fast(fast, cfg: EPSesPlusLinearConfig, plans) -> Params:
    """Inverse of ``fast_params_from_reference`` (exact: pure transposes)."""
    del cfg
    cores = []
    for cmt, p in zip(fast["epses_cmt"], plans):
        _, q_k, n1_k = _plan_dims(p)
        shape = p["core_shape"]
        o, a = shape[-1], q_k**n1_k
        btot = math.prod(shape[:-1]) // a
        cores.append(cmt.reshape(o, btot, a).permute(2, 1, 0).reshape(shape))
    return {"epses": tuple(cores), "linear": dict(fast["linear"])}


def eps_plus_linear_forward_fast(
    fast, x: torch.Tensor, cfg: EPSesPlusLinearConfig, plans,
    kernels: EPSKernels = KERNELS,
) -> torch.Tensor:
    """The forward over fast parameters (eps_plus_linear.py:455-503, without
    dropout), all in the transposed batch-minor layout: one input relayout,
    then each layer's ``outT[None]`` is the next layer's ``xT``. ``x``
    (C, B, H, W, Q₀) → (B, num_classes); differentiable in the parameters.
    ``kernels`` runs each layer's contractions (see ``eps_apply_t_cmt``)."""
    del cfg
    xT = x.permute(0, 4, 2, 3, 1)  # the only input relayout
    outT = None
    for i, (cmt, p) in enumerate(zip(fast["epses_cmt"], plans)):
        outT = eps_apply_t_cmt(
            cmt, xT, p["out_size"], p["kernel_size"], p["n1"], p["merge_pairs"],
            layer_index=i, kernels=kernels,
        )
        xT = outT[None]
    return _transposed_classifier(outT, fast["linear"])


def forward_fast_q8(
    qparams, x: torch.Tensor, cfg: EPSesPlusLinearConfig, plans, fwd=eps_fwd_q8
) -> torch.Tensor:
    """The int8 (W8A8) serving forward (``forward_fast_q8``,
    eps_pallas_q8.py:425) over ``quantize_fast_params``' output, in the
    transposed batch-minor layout of ``eps_plus_linear_forward_fast``, whose
    plans it shares: ``x`` (C, B, H, W, Q₀) → (B, num_classes). Inference
    only. ``fwd`` runs each layer (``eps_fwd_q8``, or its plain version)."""
    del cfg
    xT = x.permute(0, 4, 2, 3, 1)
    outT = None
    for wq, sw, p in zip(qparams["epses_q"], qparams["epses_scale"], plans):
        outT = eps_apply_t_q8(
            wq, sw, xT, p["out_size"], p["kernel_size"], p["n1"], p["merge_pairs"], fwd=fwd
        )
        xT = outT[None]
    return _transposed_classifier(outT, qparams["linear"])


def epses_composition_l2_regularizer(params: Params) -> torch.Tensor:
    """Σ w² + ‖e_1 ∘ … ∘ e_L‖², the composition L2 on the reference layout
    (eps_plus_linear.py:516-519)."""
    return torch.sum(params["linear"]["w"] ** 2) + composition.inner_product(
        params["epses"], params["epses"]
    )


def epses_composition_l2_regularizer_fast(fast, plans) -> torch.Tensor:
    """The same on the fast layout, through ``composition.inner_product_cmt``
    (the ``epses_composition`` branch of ``make_fast_reg_fn``,
    train/step.py:32-50): no N-D core is formed."""
    return torch.sum(fast["linear"]["w"] ** 2) + composition.inner_product_cmt(
        fast["epses_cmt"], plans
    )


def epswise_l2_regularizer_fast(fast) -> torch.Tensor:
    """Σ w² + Σ_cores Σ cmt²: the epswise L2 (eps_plus_linear.py:510-513)
    on the fast layout, exact since it does not depend on the order of a
    core's entries (train/step.py:41-45)."""
    return torch.sum(fast["linear"]["w"] ** 2) + sum(
        torch.sum(c**2) for c in fast["epses_cmt"]
    )


class EPSesPlusLinear(nn.Module):
    """The model in the fast layout on one device, for training and (under
    ``torch.inference_mode``) serving. It owns copies of the tensors it is
    given, so training it leaves them as they were."""

    def __init__(self, fast, plans, cfg: EPSesPlusLinearConfig):
        super().__init__()
        self.cfg = cfg
        self.plans = plans

        def param(t):
            return nn.Parameter(t.detach().clone())

        self.cmts = nn.ParameterList(param(c) for c in fast["epses_cmt"])
        self.linear_w = param(fast["linear"]["w"])
        self.linear_b = param(fast["linear"]["b"])

    @classmethod
    def from_reference(
        cls, params: Params, cfg: EPSesPlusLinearConfig, device=None
    ) -> "EPSesPlusLinear":
        """Matricize reference-layout ``params`` and place them on
        ``device`` (default: where ``params`` lie)."""
        model = cls(*fast_params_from_reference(params, cfg), cfg=cfg)
        return model if device is None else model.to(device)

    def fast_params(self):
        return {
            "epses_cmt": tuple(self.cmts),
            "linear": {"w": self.linear_w, "b": self.linear_b},
        }

    def forward(self, x: torch.Tensor, kernels: EPSKernels = KERNELS) -> torch.Tensor:
        return eps_plus_linear_forward_fast(
            self.fast_params(), x, self.cfg, self.plans, kernels=kernels
        )


class EPSesPlusLinearQ8(nn.Module):
    """The int8 serving model on one device: each core quantized once, at
    construction, to int8 ``wq_i`` and its f32 per-row scales ``sw_i``
    (buffers, ``quantize_fast_params``); the classifier stays f32. Inference
    only: run it under ``torch.inference_mode``."""

    def __init__(self, qparams, plans, cfg: EPSesPlusLinearConfig):
        super().__init__()
        self.cfg = cfg
        self.plans = plans
        self.layers = len(plans)
        for i, (wq, sw) in enumerate(zip(qparams["epses_q"], qparams["epses_scale"])):
            self.register_buffer(f"wq_{i}", wq.detach().clone())
            self.register_buffer(f"sw_{i}", sw.detach().clone())
        self.register_buffer("linear_w", qparams["linear"]["w"].detach().clone())
        self.register_buffer("linear_b", qparams["linear"]["b"].detach().clone())

    @classmethod
    def from_reference(
        cls, params: Params, cfg: EPSesPlusLinearConfig, device=None
    ) -> "EPSesPlusLinearQ8":
        """Matricize and quantize reference-layout ``params`` where they lie,
        then place the model on ``device`` (default: there)."""
        model = cls(*quantize_reference_params(params, cfg), cfg)
        return model if device is None else model.to(device)

    def qparams(self):
        return {
            "epses_q": tuple(getattr(self, f"wq_{i}") for i in range(self.layers)),
            "epses_scale": tuple(getattr(self, f"sw_{i}") for i in range(self.layers)),
            "linear": {"w": self.linear_w, "b": self.linear_b},
        }

    def forward(self, x: torch.Tensor, fwd=eps_fwd_q8) -> torch.Tensor:
        return forward_fast_q8(self.qparams(), x, self.cfg, self.plans, fwd=fwd)
