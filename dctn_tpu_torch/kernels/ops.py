"""The serving forwards of K1, K8 and K10 as registered PyTorch operators,
so that a ``torch.export`` graph holds them as nodes.

The wrappers launch their kernels through ``ctypes`` on ``data_ptr()``,
which ``torch.export``'s fake tensors cannot trace through. Each operator
below (``torch.library.custom_op`` in the ``dctn_tpu_torch`` namespace) has
a fake implementation that gives only its output's shape and dtype, and a
real one that is the wrapper itself: on a CUDA tensor the hand-written
kernel, counted in the wrapper's launch counter; on a CPU tensor its plain
version. A loaded artifact therefore launches the same kernels, through the
same counters, as eager serving.

- ``dctn_tpu_torch::eps_fwd(views_t, cmt, n1, out_size)``: K1 without t
  (``eps_kernels.eps_fwd``);
- ``dctn_tpu_torch::eps_fwd_q8(views_t, wq, sw, n1, out_size)``: K8 without
  t (``eps_q8_kernels.eps_fwd_q8``);
- ``dctn_tpu_torch::sbs_fwd(views_t, cores, olr, mcut)``: one ConvSBS
  string's fold, K10 or K12's forward (``sbs_kernels.sbs_fwd``); ``olr`` is
  the string's (o, l, r) triples flattened, since an operator's schema takes
  no tuple of tuples.

They carry no autograd: they are the serving forward only. ``OP_KERNELS``
(``EPSesPlusLinear.forward(x, kernels=)``), ``eps_fwd_q8`` itself
(``EPSesPlusLinearQ8.forward(x, fwd=)``) and ``OP_SBS_KERNELS``
(``ConvSBSModel.forward(x, kernels=)``) are what ``cli/export.py`` traces
the models with; eager serving keeps calling the wrappers.
Importing this module registers the operators; ``export.load_artifact``
imports it before ``torch.export.load``, because a graph that names an
unregistered operator cannot be loaded.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch

from . import eps_kernels, eps_q8_kernels, sbs_kernels

NAMESPACE = "dctn_tpu_torch"


@torch.library.custom_op(f"{NAMESPACE}::eps_fwd", mutates_args=())
def eps_fwd(views_t: torch.Tensor, cmt: torch.Tensor, n1: int, out_size: int) -> torch.Tensor:
    return eps_kernels.eps_fwd(views_t, cmt, n1, out_size)


@eps_fwd.register_fake
def _(views_t, cmt, n1, out_size):
    return views_t.new_empty((out_size, views_t.shape[2]))


@torch.library.custom_op(f"{NAMESPACE}::eps_fwd_q8", mutates_args=())
def eps_fwd_q8(
    views_t: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor, n1: int, out_size: int
) -> torch.Tensor:
    return eps_q8_kernels.eps_fwd_q8(views_t, wq, sw, n1, out_size)


@eps_fwd_q8.register_fake
def _(views_t, wq, sw, n1, out_size):
    return views_t.new_empty((out_size, views_t.shape[2]))


@torch.library.custom_op(f"{NAMESPACE}::sbs_fwd", mutates_args=())
def sbs_fwd(
    views_t: torch.Tensor, cores: List[torch.Tensor], olr: List[int], mcut: Optional[int]
) -> torch.Tensor:
    triples = tuple(tuple(olr[i : i + 3]) for i in range(0, len(olr), 3))
    return sbs_kernels.sbs_fwd(views_t, cores, triples, mcut).contiguous()


@sbs_fwd.register_fake
def _(views_t, cores, olr, mcut):
    return views_t.new_empty((math.prod(olr[0::3]), views_t.shape[2]))


def _sbs_fwd_op(views_t, cores_lro, olr, mcut):
    """``SBSKernels.fwd``'s signature over the operator."""
    return sbs_fwd(views_t, list(cores_lro), [v for triple in olr for v in triple], mcut)


# the serving bundles: the forward through the operator; the backward
# entries are the wrappers', for completeness (an operator has no autograd)
OP_KERNELS = eps_kernels.EPSKernels(
    eps_fwd, eps_kernels.eps_dcore, eps_kernels.eps_dviews_t, eps_kernels.eps_dviews_recompute
)
OP_SBS_KERNELS = sbs_kernels.SBSKernels(_sbs_fwd_op, sbs_kernels.sbs_bwd)
