"""The legacy ConvSBS MNIST model family (port of
``dctn_tpu/models/conv_sbs_model.py``, reference ``mnist.py:169-284``).

A stack of ManyConvSBS layers over 3×3 patches. The first
``num_sbs_layers - 1`` layers each run TWO strings whose cores visit the grid
in two snake orders (the middle core carries out-dim 2); their outputs are
the 2 input channels of the next layer. The last layer is ONE string whose
middle core emits ``num_labels``; the logits are its mean over the remaining
spatial positions.

Two forwards: ``conv_sbs_model_forward_t``, the batch-minor pipeline of
``_pallas_model_forward`` (conv_sbs_model.py:147-193), every string through
``kernels.sbs_kernels.conv_sbs_t`` (the CUDA kernels on a CUDA tensor, their
plain versions on the CPU); and ``conv_sbs_model_forward``, the plain
reference-layout forward (:196-210). ``ConvSBSModel`` holds the parameters
under the reference's ``state_dict`` names
(``conv_sbses.{l}.strings.{s}.cores.{c}``).
"""

from __future__ import annotations

import dataclasses
import functools
import logging
from typing import Callable, Optional, Sequence, Tuple

import torch
from torch import nn

from ..kernels.sbs_kernels import KERNELS, SBSKernels, conv_sbs_t, sbs_supported
from ..ops import sbs
from ..ops.windows import make_windows
from ..utils.pos2d import Pos2D

logger = logging.getLogger(__name__)

NUM_LABELS = 10

# The two snake orders of the reference's 3×3 strings (mnist.py:190-216); the
# middle core carries the out dim.
SNAKE_ROW_MAJOR = (
    Pos2D(0, 0), Pos2D(0, 1), Pos2D(0, 2), Pos2D(1, 2), Pos2D(1, 1),
    Pos2D(1, 0), Pos2D(2, 0), Pos2D(2, 1), Pos2D(2, 2),
)
SNAKE_COL_MAJOR = (
    Pos2D(0, 0), Pos2D(1, 0), Pos2D(2, 0), Pos2D(2, 1), Pos2D(1, 1),
    Pos2D(0, 1), Pos2D(0, 2), Pos2D(1, 2), Pos2D(2, 2),
)


def snake_cores_spec(positions: Sequence[Pos2D], middle_out: int) -> Tuple[sbs.SBSSpecCore, ...]:
    return tuple(sbs.SBSSpecCore(p, middle_out if p == Pos2D(1, 1) else 1) for p in positions)


@dataclasses.dataclass(frozen=True)
class ConvSBSModelConfig:
    num_sbs_layers: int
    bond_dim_size: int
    trace_edge: bool = False
    cos_sin_squared: bool = False
    input_multiplier: float = 1.0
    num_labels: int = NUM_LABELS
    # per layer, the strings' fold as ``(mcut, mim)`` (``conv_sbs_t``'s
    # merge position and family), or None for ``conv_sbs_t``'s own pick;
    # layers past the tuple take their own pick too. Measured by
    # ``train.autotune.autotune_conv_sbs``.
    kernel_tuning: tuple = ()

    def __post_init__(self):
        assert self.num_sbs_layers >= 2

    def layer_specs(self) -> Tuple[Tuple[sbs.SBSSpecString, ...], ...]:
        two_string = (snake_cores_spec(SNAKE_ROW_MAJOR, 2), snake_cores_spec(SNAKE_COL_MAJOR, 2))
        final = (snake_cores_spec(SNAKE_ROW_MAJOR, self.num_labels),)
        return tuple(
            sbs.make_many_specs(
                1 if i == 0 else 2, 2, self.bond_dim_size, self.trace_edge,
                final if i == self.num_sbs_layers - 1 else two_string,
            )
            for i in range(self.num_sbs_layers)
        )


# tuple over layers of tuple over strings of tuple of core tensors
ConvSBSModelParams = Tuple[Tuple[sbs.SBSCores, ...], ...]


def init_conv_sbs_model(
    generator: torch.Generator, cfg: ConvSBSModelConfig,
    init_fn: Callable[..., sbs.SBSCores] = sbs.init_khrulkov_normal,
    dtype=torch.float32, **init_kwargs,
) -> ConvSBSModelParams:
    """Every string's cores from ``init_fn``, drawn from ``generator`` layer
    by layer and string by string."""
    return tuple(
        tuple(init_fn(generator, spec, dtype=dtype, **init_kwargs) for spec in layer)
        for layer in cfg.layer_specs()
    )


def batch_to_quantum(x: torch.Tensor, cos_sin_squared: bool, multiplier: float) -> torch.Tensor:
    """(B, H, W) pixels → (1, B, H, W, 2) quantum features (mnist.py:132-141:
    sin and cos, with no factor 2, squared only with cos_sin_squared)."""
    if cos_sin_squared:
        q = torch.stack((torch.sin(x) ** 2, torch.cos(x) ** 2), dim=-1)
    else:
        q = torch.stack((torch.sin(x), torch.cos(x)), dim=-1)
    return (q * multiplier)[None]


def calc_std_of_coordinates_of_windows(
    x: torch.Tensor, kernel_size: int, cos_sin_squared: bool, multiplier: float = 1.0
) -> torch.Tensor:
    """Std over the window rank-one-tensor batch of a quantumized pixel
    batch (mnist.py:144-166), which sets the input multiplier."""
    q = batch_to_quantum(x, cos_sin_squared, multiplier)
    return make_windows(q, kernel_size).std_over_batch()


@functools.lru_cache(maxsize=None)
def check_kernel_scope(
    cfg: ConvSBSModelConfig, on_cuda: bool = True
) -> Tuple[Tuple[sbs.SBSSpecString, ...], ...]:
    """The model's layer specs, once per config and device type. On CUDA it
    raises unless the kernels take every string; on the CPU the kernels'
    plain versions take any spec, as the JAX package's XLA fold does."""
    specs = cfg.layer_specs()
    for li, layer in enumerate(specs if on_cuda else ()):
        for spec in layer:
            if not sbs_supported(spec)[2]:
                raise ValueError(
                    f"layer {li}: ConvSBS string with bonds {spec.bond_sizes} and "
                    f"{spec.in_num_channels} channels is outside the kernels' scope "
                    "(ROADMAP Queue 1 item 16, ConvSBS kernel scope)"
                )
    return specs


def _quantum_t(x: torch.Tensor, cfg: ConvSBSModelConfig) -> torch.Tensor:
    """(B, H, W) pixels → the batch-minor (1, 2, H, W, B) quantum input."""
    xb = x.permute(1, 2, 0)
    if cfg.cos_sin_squared:
        q = torch.stack((torch.sin(xb) ** 2, torch.cos(xb) ** 2), dim=0)
    else:
        q = torch.stack((torch.sin(xb), torch.cos(xb)), dim=0)
    return (q * cfg.input_multiplier)[None]


def _layer_t(layer_spec, layer_params, xT, kernels, tune=None):
    """Each string of one layer through ``conv_sbs_t``, at the layer's
    ``kernel_tuning`` entry ``tune`` = (mcut, mim) where there is one."""
    mcut, mim = tune if tune else (None, None)
    return [conv_sbs_t(s, cores, xT, mim=mim, mcut=mcut, kernels=kernels)
            for s, cores in zip(layer_spec, layer_params)]


def layer_tuning(cfg: "ConvSBSModelConfig", li: int):
    """Layer ``li``'s ``(mcut, mim)`` from ``cfg.kernel_tuning``, or None."""
    return cfg.kernel_tuning[li] if li < len(cfg.kernel_tuning) else None


def conv_sbs_model_forward_t(
    params: ConvSBSModelParams, cfg: ConvSBSModelConfig, x: torch.Tensor,
    kernels: SBSKernels = KERNELS,
) -> torch.Tensor:
    """(B, H, W) pixels → (B, num_labels) logits through the batch-minor
    pipeline: the quantum map straight into (1, 2, H, W, B), every string
    through ``conv_sbs_t``, the strings' outputs stacked as the next layer's
    channels, the mean over the (10, H', W', B) map's spatial dims."""
    xT = _quantum_t(x, cfg)
    for li, (layer_spec, layer_params) in enumerate(zip(check_kernel_scope(cfg, xT.is_cuda),
                                                        params)):
        outsT = _layer_t(layer_spec, layer_params, xT, kernels, layer_tuning(cfg, li))
        xT = torch.stack(outsT, dim=0)
    return outsT[0].mean(dim=(1, 2)).T


def conv_sbs_model_forward(
    params: ConvSBSModelParams, cfg: ConvSBSModelConfig, x: torch.Tensor
) -> torch.Tensor:
    """The plain reference-layout forward (conv_sbs_model.py:196-210): the
    quantum map, each layer's strings through ``sbs.conv_sbs`` with their
    outputs stacked as channels, the mean over spatial dims."""
    intermediate = batch_to_quantum(x, cfg.cos_sin_squared, cfg.input_multiplier)
    for layer_spec, layer_params in zip(cfg.layer_specs(), params):
        outs = sbs.many_conv_sbs(layer_spec, layer_params, intermediate)
        intermediate = torch.stack(outs, dim=0)
    return outs[0].mean(dim=(1, 2))


@torch.no_grad()
def scale_layers_using_batch(
    params: ConvSBSModelParams, cfg: ConvSBSModelConfig, x: torch.Tensor,
    kernels: SBSKernels = KERNELS,
) -> ConvSBSModelParams:
    """Data-dependent rescaling (mnist.py:265-284): layer by layer, divide
    each string (the factor spread over its cores) by the Bessel-corrected
    std of its output on the batch, as torch's ``.std()`` is, then run the
    layer again with the scaled cores before the next. Through the
    batch-minor pipeline; returns new params."""
    xT = _quantum_t(x, cfg)
    new_params = []
    for layer_spec, layer_params in zip(check_kernel_scope(cfg, xT.is_cuda), params):
        scaled = []
        for spec, cores, out in zip(layer_spec, layer_params,
                                    _layer_t(layer_spec, layer_params, xT, kernels)):
            std = float(torch.std(out))
            if std != 0.0:
                scaled.append(sbs.multiply_by_scalar(spec, cores, 1.0 / std))
                logger.info("Divided a ConvSBS by %s", std)
            else:
                scaled.append(tuple(cores))
                logger.warning("std == 0.0, not scaling")
        new_params.append(tuple(scaled))
        xT = torch.stack(_layer_t(layer_spec, scaled, xT, kernels), dim=0)
    return tuple(new_params)


def make_warmup_lr_schedule(
    warmup_num_epochs: int, steps_per_epoch: int = 1,
    warmup_initial_multiplier: float = 1e-20,
) -> Callable[[int], float]:
    """The legacy runner's exponential warmup (mnist.py:489-499) as the
    per-step multiplier of ``torch.optim.lr_scheduler.LambdaLR``: during the
    first W epochs m^((W - epoch)/W), m the initial multiplier, then 1. In
    Python floats (f64), as the JAX schedule computes it under x64."""

    def multiplier(step: int) -> float:
        epoch = step // max(steps_per_epoch, 1)
        frac = min(max((warmup_num_epochs - epoch) / max(warmup_num_epochs, 1), 0.0), 1.0)
        return warmup_initial_multiplier**frac

    return multiplier


def make_legacy_optimizer(
    optimizer_type: str, params, learning_rate: float, momentum: float = 0.0,
    rmsprop_alpha: float = 0.99, weight_decay: float = 0.0,
) -> torch.optim.Optimizer:
    """``torch.optim.SGD`` or ``RMSprop`` with momentum and weight decay
    forwarded (mnist.py:464-478). The JAX package's ``make_legacy_optimizer``
    emulates exactly these semantics: RMSprop's eps outside the square root,
    the current lr applied to the whole momentum buffer, weight decay added
    to the raw gradient."""
    if optimizer_type == "sgd":
        return torch.optim.SGD(params, lr=learning_rate, momentum=momentum,
                               weight_decay=weight_decay)
    if optimizer_type == "rmsprop":
        return torch.optim.RMSprop(params, lr=learning_rate, alpha=rmsprop_alpha,
                                   momentum=momentum, weight_decay=weight_decay)
    raise ValueError(f"unknown optimizer_type: {optimizer_type}")


class _String(nn.Module):
    def __init__(self, cores):
        super().__init__()
        self.cores = nn.ParameterList([nn.Parameter(c) for c in cores])


class _ManyConvSBS(nn.Module):
    def __init__(self, strings):
        super().__init__()
        self.strings = nn.ModuleList([_String(s) for s in strings])


class ConvSBSModel(nn.Module):
    """The model's cores as parameters, named as the reference's
    ``DCTNMnistModel`` names them (``conv_sbses.{l}.strings.{s}.cores.{c}``),
    so its ``state_dict`` loads there and back. ``forward`` is
    ``conv_sbs_model_forward_t``."""

    def __init__(self, params: ConvSBSModelParams, cfg: ConvSBSModelConfig,
                 device=None, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        self.conv_sbses = nn.ModuleList([
            _ManyConvSBS([[torch.as_tensor(c, dtype=dtype, device=device).detach().clone()
                           for c in string] for string in layer])
            for layer in params
        ])

    def params(self) -> ConvSBSModelParams:
        return tuple(
            tuple(tuple(string.cores) for string in layer.strings) for layer in self.conv_sbses
        )

    def forward(self, x: torch.Tensor, kernels: SBSKernels = KERNELS) -> torch.Tensor:
        return conv_sbs_model_forward_t(self.params(), self.cfg, x, kernels)
