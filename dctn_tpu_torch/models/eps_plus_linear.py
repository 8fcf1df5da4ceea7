"""EPSesPlusLinear — N EPS layers followed by a linear classifier (port of
``dctn_tpu/models/eps_plus_linear.py``: the three init families, the
forward for serving and training with parameter dropout, the epswise and
composition regularizers, the intermediate-representation statistics, and
which layers the saved-t cap holds back at a batch size).

Parameters come in two layouts, as in the JAX package:

- the reference layout, ``{"epses": (core_0, …), "linear": {"w": (in, 10),
  "b": (10,)}}``, which checkpoints use;
- the fast layout, each core matricized to the kernel's (Z, A) "cmt" matrix
  (``fast_params_from_reference``), which the forward runs on.

``EPSesPlusLinear`` is the ``nn.Module`` that holds the fast layout on one
device; its parameters require gradients, and serving runs it under
``torch.inference_mode``; with ``eps_q8_kernels.QAT_KERNELS`` it is the
quantization-aware training forward. ``EPSesPlusLinearReference`` holds
the reference layout, whose forward (``eps_plus_linear_forward``) runs the
plain ``eps`` with its backward: the runners' xla backend.
``EPSesPlusLinearQ8`` holds the int8 serving parameters
(``forward_fast_q8``).

Parameter dropout keeps each component of a core with probability p and
scales the kept ones by 1/p. Its masks are drawn over the reference core
shape and permuted to cmt (``dropout_cmts``, eps_plus_linear.py:431), so a
mask bit lands on the same core component in either layout; the draw comes
from a ``torch.Generator`` (``draw_dropout_masks``) or, to hold the port
against the JAX package, the masks are passed in.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Any, Dict, Optional, Sequence, Tuple

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
from ..ops.windows import make_windows
from ..utils.misc import OneTensorInit, ZeroCenteredNormalInit, ZeroCenteredUniformInit

logger = logging.getLogger(__name__)

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class EPSesPlusLinearConfig:
    epses_specs: Tuple[Tuple[int, int], ...]  # ((K, Q_out), ...)
    image_size: int = 28
    q0: int = 2
    num_classes: int = 10
    dtype: torch.dtype = torch.float32
    dropout_p: float = 1.0  # the probability of KEEPING a core component

    def __post_init__(self):
        if not 0.0 < self.dropout_p <= 1.0:
            raise ValueError(f"dropout_p must be in (0, 1], got {self.dropout_p}")

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
    generator: torch.Generator,
    cfg: EPSesPlusLinearConfig,
    device="cpu",
    weight_init: Optional[OneTensorInit] = None,
    bias_init: Optional[OneTensorInit] = None,
) -> Dict[str, torch.Tensor]:
    """By default w = randn·in^(-1/2)/4, b ~ U(-in^(-1/2), in^(-1/2))
    (eps_plus_linear.py:73-107), or the manually chosen distributions."""
    n_in, n_out = cfg.linear_in_features, cfg.num_classes
    kw = {"generator": generator, "dtype": cfg.dtype, "device": generator.device}

    def draw(shape, init):
        if isinstance(init, ZeroCenteredNormalInit):
            return torch.randn(shape, **kw) * init.std
        if isinstance(init, ZeroCenteredUniformInit):
            return (torch.rand(shape, **kw) * 2.0 - 1.0) * init.maximum
        raise ValueError(f"unsupported linear init {init!r}")

    w = draw((n_in, n_out), weight_init or ZeroCenteredNormalInit(n_in**-0.5 / 4.0))
    b = draw((n_out,), bias_init or ZeroCenteredUniformInit(n_in**-0.5))
    return {"w": w.to(device), "b": b.to(device)}


def init_eps_plus_linear(
    generator: torch.Generator,
    cfg: EPSesPlusLinearConfig,
    initialization: str = "unit_theoretical_output_std",
    device="cpu",
    *,
    init_input: Optional[torch.Tensor] = None,
    init_batch_size: int = 128,
    eps_inits: Optional[Sequence[OneTensorInit]] = None,
    linear_weight_init: Optional[OneTensorInit] = None,
    linear_bias_init: Optional[OneTensorInit] = None,
    plain: bool = False,
) -> Params:
    """The reference-layout parameters on ``device``, the cores and then the
    linear layer drawn from ``generator`` (eps_plus_linear.py:110-150).
    ``initialization``:

    - ``"unit_theoretical_output_std"``: randn·(Q^(C·K²))^(-1/2) per core;
    - ``"unit_empirical_output_std"``: per layer, a unit-normal core rescaled
      to output std 1 on ``init_input`` (C, N, H, W, Q), pushed through the
      layers in slices of ``init_batch_size`` on its device (through the
      forward kernel on a card, unless ``plain``);
    - ``"manual"``: ``eps_inits`` per core, and ``linear_weight_init`` /
      ``linear_bias_init`` for the classifier.
    """
    if initialization == "unit_empirical_output_std":
        if init_input is None or init_input.shape[2] != cfg.image_size:
            raise ValueError("the empirical init needs init_input of the model's image size")
        epses = composition.make_unit_empirical_output_std(
            generator, cfg.epses_specs, init_input, cfg.dtype, init_batch_size, plain=plain
        )
        epses = tuple(c.to(device) for c in epses)
    elif initialization == "unit_theoretical_output_std":
        epses = composition.make_unit_theoretical_output_std(
            generator, cfg.epses_specs, cfg.q0, cfg.dtype, device
        )
    elif initialization == "manual":
        if eps_inits is None:
            raise ValueError("the manual init needs eps_inits")
        epses = composition.make_manually_chosen(
            generator, cfg.epses_specs, eps_inits, cfg.q0, cfg.dtype, device
        )
    else:
        raise ValueError(f"unknown initialization {initialization!r}")
    linear = _init_linear(generator, cfg, device, linear_weight_init, linear_bias_init)
    return {"epses": tuple(epses), "linear": linear}


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


def dropout_epses(epses, p: float, masks) -> Tuple[torch.Tensor, ...]:
    """Parameter dropout on the reference layout (``_dropout_epses``,
    eps_plus_linear.py:156-165): core·mask/p, differentiable in the core."""
    return tuple(core * mask.to(core.device, core.dtype) / p for core, mask in zip(epses, masks))


def eps_plus_linear_forward(
    params: Params, x: torch.Tensor, cfg: EPSesPlusLinearConfig, masks=None
):
    """Reference-layout forward through the plain ``eps`` (its products
    ``torch.matmul``; differentiable through ``eps``'s backward): ``x``
    (C, B, H, W, Q₀) → logits (B, num_classes) (eps_plus_linear.py:248-293,
    the xla backend). ``masks`` (one per core) applies parameter dropout
    with ``cfg.dropout_p``."""
    epses = params["epses"]
    if masks is not None:
        epses = dropout_epses(epses, cfg.dropout_p, masks)
    intermediate = x
    for core in epses:
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


def legacy_split_plans(plans):
    """``plans`` with each layer's n1 that of the split rule before the
    JAX package's third round (the smallest n1 ≥ ⌈n/2⌉ with q^n1 ≥ 128,
    nudged even where factor pairs merge; eps_plus_linear.py:297-316): the
    cmt layout of fast train states saved with no ``eps_splits`` tag."""
    out = []
    for p in plans:
        n = p["kernel_size"] ** 2 * p["c"]
        q = p["q"]
        n1 = math.ceil(n / 2)
        while q**n1 < 128 and n1 < n:
            n1 += 1
        if p["merge_pairs"] and n1 % 2 == 1:
            n1 += 1 if n1 + 1 <= n else -1
        out.append({**p, "n1": n1})
    return tuple(out)


def fast_params_from_reference(params: Params, cfg: EPSesPlusLinearConfig, plans=None):
    """Reference parameters → (fast parameters, plans): each core matricized
    to the kernel's (Z, A) layout. Explicit ``plans`` matricize under other
    splits (a train state saved under another split rule)."""
    if plans is None:
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


def draw_dropout_masks(plans, p: float, generator: torch.Generator) -> Tuple[torch.Tensor, ...]:
    """One keep-mask per core, Bernoulli(p) over its reference shape, drawn
    in layer order on the generator's device."""
    return tuple(
        torch.rand(plan["core_shape"], generator=generator, device=generator.device) < p
        for plan in plans
    )


def dropout_cmts(cmts, plans, p: float, masks) -> Tuple[torch.Tensor, ...]:
    """Parameter dropout on the fast layout (``_dropout_cmts``,
    eps_plus_linear.py:431-452): each reference-shape mask permuted to cmt,
    then cmt·mask/p. Differentiable in the undropped cmt."""
    out = []
    for cmt, plan, mask in zip(cmts, plans, masks):
        _, q_k, n1_k = _plan_dims(plan)
        mask_cmt = _core_to_cmt_k(mask.to(cmt.device), n1_k, q_k).to(cmt.dtype)
        out.append(cmt * mask_cmt / p)
    return tuple(out)


def eps_plus_linear_forward_fast(
    fast, x: torch.Tensor, cfg: EPSesPlusLinearConfig, plans,
    kernels: EPSKernels = KERNELS, masks=None, pixel_scale: int = 1,
) -> torch.Tensor:
    """The forward over fast parameters (eps_plus_linear.py:455-503), all in
    the transposed batch-minor layout: one input relayout, then each
    layer's ``outT[None]`` is the next layer's ``xT``. ``x`` (C, B, H, W,
    Q₀) → (B, num_classes); differentiable in the parameters. ``kernels``
    runs each layer's contractions (see ``eps_apply_t_cmt``). ``masks``
    (one per core, reference shape) applies parameter dropout with
    ``cfg.dropout_p``: a training forward passes them, an eval none.
    ``pixel_scale`` is ``eps_apply_t_cmt``'s (the data-parallel QAT step's
    rank count)."""
    cmts = fast["epses_cmt"]
    if masks is not None:
        cmts = dropout_cmts(cmts, plans, cfg.dropout_p, masks)
    xT = x.permute(0, 4, 2, 3, 1)  # the only input relayout
    outT = None
    for i, (cmt, p) in enumerate(zip(cmts, plans)):
        outT = eps_apply_t_cmt(
            cmt, xT, p["out_size"], p["kernel_size"], p["n1"], p["merge_pairs"],
            layer_index=i, kernels=kernels, pixel_scale=pixel_scale,
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


def epswise_l2_regularizer(params: Params) -> torch.Tensor:
    """Σ w² + Σ‖core‖², the epswise L2 on the reference layout
    (eps_plus_linear.py:510-513)."""
    return torch.sum(params["linear"]["w"] ** 2) + composition.epswise_squared_fro_norm(
        params["epses"]
    )


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


def intermediate_reps_stats(
    params: Params, x: torch.Tensor, cfg: EPSesPlusLinearConfig, batch_size: int = 128,
    plain: bool = False,
) -> Dict[str, Dict[str, float]]:
    """μ, σ and μ²+σ² of every intermediate representation x_n, of the
    window batches w_n (as rank-one tensors, never densified) and of the
    classifier's output with and without bias, on ``x`` (C, N, H, W, Q)
    without dropout (eps_plus_linear.py:526-569). Each layer runs over
    ``x`` in slices of ``batch_size`` (``transform_in_slices``: the forward
    kernel on a card, unless ``plain``). Logs a line per statistic and
    returns them."""
    del cfg
    stats: Dict[str, Dict[str, float]] = {}

    def one(name: str, mu: float, sigma: float, extra: str = "") -> None:
        stats[name] = {"mean": mu, "std": sigma, "second_moment": mu**2 + sigma**2}
        logger.info("%s: μ=%.7e, σ=%.7e, μ²+σ²=%.7e%s", name, mu, sigma, mu**2 + sigma**2, extra)

    for n, core in enumerate(params["epses"]):
        one(f"x_{n}", float(x.mean()), float(x.std(correction=0)), f", shape={tuple(x.shape)}")
        w = make_windows(x, eps_mod._infer_kernel_size(core, x.shape[0]))
        one(f"w_{n}", float(w.mean_over_batch()), float(w.std_over_batch(unbiased=False)))
        del w
        x = eps_mod.transform_in_slices(core, x, batch_size, plain)
    flat = x[0].reshape(x.shape[1], -1)
    one(f"x_{len(params['epses'])}", float(flat.mean()), float(flat.std(correction=0)))
    no_bias = flat @ params["linear"]["w"]
    one("output_of_linear_without_bias", float(no_bias.mean()), float(no_bias.std(correction=0)))
    with_bias = no_bias + params["linear"]["b"]
    one("output_of_linear_with_bias", float(with_bias.mean()), float(with_bias.std(correction=0)))
    return stats


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
        cls, params: Params, cfg: EPSesPlusLinearConfig, device=None, plans=None
    ) -> "EPSesPlusLinear":
        """Matricize reference-layout ``params`` under ``plans`` (default:
        ``fast_layer_plans``' splits) and place them on ``device`` (default:
        where ``params`` lie)."""
        model = cls(*fast_params_from_reference(params, cfg, plans), cfg=cfg)
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


class EPSesPlusLinearReference(nn.Module):
    """The model in the reference layout on one device, for the runners'
    ``xla`` backend: every core as its (Q,)*(K²·C) + (O,) tensor, the layers
    through the plain ``eps`` (``eps_plus_linear_forward``). It owns copies
    of the tensors it is given."""

    def __init__(self, params: Params, cfg: EPSesPlusLinearConfig):
        super().__init__()
        self.cfg = cfg

        def param(t):
            return nn.Parameter(t.detach().clone())

        self.cores = nn.ParameterList(param(c) for c in params["epses"])
        self.linear_w = param(params["linear"]["w"])
        self.linear_b = param(params["linear"]["b"])

    def reference_params(self) -> Params:
        return {"epses": tuple(self.cores), "linear": {"w": self.linear_w, "b": self.linear_b}}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return eps_plus_linear_forward(self.reference_params(), x, self.cfg)


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
        cls, params: Params, cfg: EPSesPlusLinearConfig, device=None, plans=None
    ) -> "EPSesPlusLinearQ8":
        """Matricize (under ``plans``, default ``fast_layer_plans``' splits)
        and quantize reference-layout ``params`` where they lie, then place
        the model on ``device`` (default: there)."""
        model = cls(*quantize_reference_params(params, cfg, plans), cfg)
        return model if device is None else model.to(device)

    def qparams(self):
        return {
            "epses_q": tuple(getattr(self, f"wq_{i}") for i in range(self.layers)),
            "epses_scale": tuple(getattr(self, f"sw_{i}") for i in range(self.layers)),
            "linear": {"w": self.linear_w, "b": self.linear_b},
        }

    def forward(self, x: torch.Tensor, fwd=eps_fwd_q8) -> torch.Tensor:
        return forward_fast_q8(self.qparams(), x, self.cfg, self.plans, fwd=fwd)
