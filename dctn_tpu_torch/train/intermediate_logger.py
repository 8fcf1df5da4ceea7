"""Named intermediate outputs on a schedule: transforms, scalars and
histograms of each layer's output (port of
``dctn_tpu/train/intermediate_logger.py``; reference
``base_intermediate_outputs_logger.py``).

Each model family has a function ``(params, x) → {module name: output}``
that runs one forward and returns every layer's output; the logger takes
each output to the host once and writes every transform of it through
``MetricsWriter``, under ``{prefix}_{transform}/{module}``. The EPS model's
function over the fast layout runs each layer through ``eps_apply_t_cmt``
(the forward kernel K1 on a card), the ConvSBS model's through
``conv_sbs_t`` (K10); the outputs come back in the JAX package's
``(B, H', W', O)`` layout so that they compare one to one.
"""

from __future__ import annotations

import enum
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .checkpoint import _to_numpy, flatten_tree
from .tb_logging import MetricsWriter


class RecordType(enum.Enum):
    SCALAR = enum.auto()
    HISTOGRAM = enum.auto()


# (name, record type, transform), the transform on the host copy
LoggerTransform = Tuple[str, RecordType, Callable[[np.ndarray], np.ndarray]]


def _np_softmax_rows(x: np.ndarray) -> np.ndarray:
    shifted = np.exp(x - x.max(axis=1, keepdims=True))
    return shifted / shifted.sum(axis=1, keepdims=True)


log_dumb_mean_of_abs: LoggerTransform = (
    "dumb_mean_of_abs", RecordType.SCALAR, lambda x: np.mean(np.abs(x)))
log_dumb_max_of_abs: LoggerTransform = (
    "dumb_max_of_abs", RecordType.SCALAR, lambda x: np.max(np.abs(x)))
log_dumb_min_of_abs: LoggerTransform = (
    "dumb_min_of_abs", RecordType.SCALAR, lambda x: np.min(np.abs(x)))
log_dumb_max: LoggerTransform = ("dumb_max", RecordType.SCALAR, np.max)
log_dumb_mean: LoggerTransform = ("dumb_mean", RecordType.SCALAR, np.mean)
log_dumb_min: LoggerTransform = ("dumb_min", RecordType.SCALAR, np.min)
log_dumb_std: LoggerTransform = ("dumb_std", RecordType.SCALAR, np.std)
log_dumb_histogram: LoggerTransform = ("dumb", RecordType.HISTOGRAM, lambda x: x)
log_logits_as_probabilities: LoggerTransform = (
    "logits_as_probabilities", RecordType.HISTOGRAM, _np_softmax_rows,
)

DEFAULT_TRANSFORMS: Tuple[LoggerTransform, ...] = (
    log_dumb_mean,
    log_dumb_std,
    log_dumb_mean_of_abs,
    log_dumb_max_of_abs,
    log_dumb_histogram,
)


def log_named_outputs(
    writer: MetricsWriter,
    named_outputs: Mapping[str, torch.Tensor],
    step: int,
    transforms: Sequence[LoggerTransform] = DEFAULT_TRANSFORMS,
    tag_prefix: str = "intermediate",
    module_filter: Optional[Callable[[str], bool]] = None,
) -> None:
    """Every (transform × module) record, tagged
    ``{tag_prefix}_{transform}/{module}`` (intermediate_logger.py:73-100):
    one copy to the host per module, the transforms on that copy."""
    for module_name, arr in named_outputs.items():
        if module_filter is not None and not module_filter(module_name):
            continue
        host = _to_numpy(arr)
        for name, record_type, transform in transforms:
            tag = f"{tag_prefix}_{name}/{module_name}"
            value = np.asarray(transform(host))
            if record_type is RecordType.SCALAR:
                writer.add_scalar(tag, float(value), step)
            else:
                writer.add_histogram(tag, value, step)


# ---------------------------------------------------------------------------
# the named-outputs functions of the two model families


def eps_plus_linear_named_outputs(params, x: torch.Tensor, cfg) -> Dict[str, torch.Tensor]:
    """{eps_0, …, eps_{n-1}, linear} over reference-layout ``params``: each
    EPS layer's output through the plain ``eps`` in ``cfg.compute_dtype``'s
    operands, and the logits (intermediate_logger.py:103-117)."""
    from ..ops import eps as eps_mod

    named: Dict[str, torch.Tensor] = {}
    intermediate = x
    for i, core in enumerate(params["epses"]):
        out = eps_mod.eps(core, intermediate, compute_dtype=cfg.compute_dtype)
        named[f"eps_{i}"] = out
        intermediate = out[None]
    h = intermediate[0]
    named["linear"] = h.reshape(h.shape[0], -1) @ params["linear"]["w"] + params["linear"]["b"]
    return named


def eps_plus_linear_named_outputs_fast(fast, x: torch.Tensor, cfg, plans) -> Dict[str, torch.Tensor]:
    """The same over fast-layout parameters: each layer through
    ``eps_apply_t_cmt`` (K1 without t on a card, its plain version on the
    CPU) in ``cfg.compute_dtype``'s operands, its batch-minor output relaid
    to (B, H', W', O)."""
    from ..kernels.eps_kernels import eps_apply_t_cmt
    from ..models.eps_plus_linear import _transposed_classifier

    named: Dict[str, torch.Tensor] = {}
    xT = x.permute(0, 4, 2, 3, 1)
    outT = None
    for i, (cmt, p) in enumerate(zip(fast["epses_cmt"], plans)):
        outT = eps_apply_t_cmt(
            cmt, xT, p["out_size"], p["kernel_size"], p["n1"], p["merge_pairs"],
            layer_index=i, mm_dtype=cfg.compute_dtype,
        )
        named[f"eps_{i}"] = outT.permute(3, 1, 2, 0)
        xT = outT[None]
    named["linear"] = _transposed_classifier(outT, fast["linear"])
    return named


def conv_sbs_model_named_outputs(params, cfg, images: torch.Tensor) -> Dict[str, torch.Tensor]:
    """{layer{i}.string{j}, logits} of the legacy ConvSBS model
    (intermediate_logger.py:120-135): every string through ``conv_sbs_t``
    (K10 on a card), its output relaid to (B, H', W', O)."""
    from ..models.conv_sbs_model import _layer_t, _quantum_t, model_kernels

    xT = _quantum_t(images, cfg)
    named: Dict[str, torch.Tensor] = {}
    outsT = None
    specs, kernels = model_kernels(cfg)
    for i, (layer_spec, layer_params) in enumerate(zip(specs, params)):
        outsT = _layer_t(layer_spec, layer_params, xT, kernels)
        for j, outT in enumerate(outsT):
            named[f"layer{i}.string{j}"] = outT.permute(3, 1, 2, 0)
        xT = torch.stack(outsT, dim=0)
    named["logits"] = outsT[0].mean(dim=(1, 2)).T
    return named


# ---------------------------------------------------------------------------
# parameter and gradient histograms (mnist.py:535-536)


def _host_leaves(tree) -> Dict[str, np.ndarray]:
    """The tree's leaves on the host by path, tensors of one device and
    dtype taken across in one copy (a copy waits for the card)."""
    leaves = flatten_tree(tree)
    values = list(leaves.values())
    if not all(isinstance(v, torch.Tensor) for v in values) or len(
            {(v.device, v.dtype) for v in values}) != 1:
        return {k: _to_numpy(v) for k, v in leaves.items()}
    flat = _to_numpy(torch.cat([v.detach().reshape(-1) for v in values]))
    out, at = {}, 0
    for (name, v) in leaves.items():
        out[name] = flat[at : at + v.numel()].reshape(tuple(v.shape))
        at += v.numel()
    return out


def log_tree_histograms(writer: MetricsWriter, tree, step: int, tag_prefix: str) -> None:
    """A histogram and μ/σ scalars per leaf of a parameter or gradient tree,
    named by its path as ``flatten_tree`` gives it (the JAX package's
    ``_leaf_name``: dict keys sorted, sequence items by index)."""
    for name, host in _host_leaves(tree).items():
        writer.add_histogram(f"{tag_prefix}/{name}", host, step)
        writer.add_scalar(f"{tag_prefix}_mean/{name}", float(host.mean()), step)
        writer.add_scalar(f"{tag_prefix}_std/{name}", float(host.std()), step)
